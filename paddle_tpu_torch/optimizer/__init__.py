"""The optimizers of the LLaMA training path (``paddle_tpu.optimizer``'s
``Optimizer``, ``Adam``, ``AdamW``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
