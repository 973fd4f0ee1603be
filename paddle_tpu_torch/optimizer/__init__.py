"""``paddle.optimizer``: ``SGD``, ``Momentum``, ``Adam``, ``AdamW`` and the
LR schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
