"""The parts of ``paddle_tpu.nn`` that the LLaMA training path uses."""
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
