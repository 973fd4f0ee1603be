"""Normalization layers — the counterpart of
``paddle_tpu/nn/layers/norm.py``'s ``LayerNorm``, ``RMSNorm`` and the batch
norms (with their running buffers ``_mean`` and ``_variance``); the other
classes wait for ROADMAP.md Queue A step 12b."""
from __future__ import annotations

import torch

from ...core import device as device_mod
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[num_features],
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None
        dev = device_mod.current_torch_device()
        self.register_buffer("_mean", torch.zeros(
            [num_features], dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            [num_features], dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


BatchNorm = _BatchNormBase


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=self.normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=self.normalized_shape,
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
