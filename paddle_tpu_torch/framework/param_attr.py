"""``ParamAttr`` — the counterpart of ``paddle_tpu/framework/param_attr.py``:
a parameter's name, initializer, learning-rate scale, regularizer and
trainability, read by ``Layer.create_parameter``."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
