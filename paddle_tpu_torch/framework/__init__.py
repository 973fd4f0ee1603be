from .param_attr import ParamAttr
from . import io

__all__ = ["ParamAttr", "io"]
