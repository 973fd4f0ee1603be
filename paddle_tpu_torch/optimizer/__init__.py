"""``paddle.optimizer``: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adagrad``, ``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb``, ``LBFGS`` and
the LR schedulers (``optimizer.lr``)."""
from . import lr
from .lbfgs import LBFGS
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LBFGS", "lr"]
