"""Weight-decay regularizers — the counterpart of
``paddle_tpu/regularizer.py``: a regularizer is a callable
``penalty_grad = reg(param)`` with a ``coeff``; an optimizer adds it to
the gradient before the update (as ``weight_decay=`` or a parameter's
``ParamAttr(regularizer=...)``, which takes precedence)."""
import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """``coeff * sign(p)`` added to the gradient."""

    def __call__(self, param):
        return self._coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """``coeff * p`` added to the gradient (a bare float ``weight_decay``
    is ``L2Decay(float)``)."""

    def __call__(self, param):
        return self._coeff * param
