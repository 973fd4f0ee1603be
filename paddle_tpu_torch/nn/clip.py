"""Gradient clipping — the counterpart of ``paddle_tpu/nn/clip.py``:
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
``clip_grad_norm_``.

A clip object is attached to an optimizer (``grad_clip=...``) and applied
to its ``(param, grad)`` list before the update. The hybrid-parallel norm
hook (``group_norm_fn``) waits for ROADMAP.md Queue A step 13.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(norm, 1e-12), 1)``,
    ``norm`` its own float32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        norm = torch.sqrt(torch.sum(torch.square(g.float())))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g.float() * scale).to(g.dtype)

    def __call__(self, params_grads):
        return [(p, None if g is None else self._clip_one(g))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-12), 1)``,
    ``norm`` the float32 global L2 norm over all gradients. Each gradient
    is multiplied in float32 and cast back to its own dtype, as the
    reference does. The norm and the scale stay on the device. (The
    reference's ``group_name`` and ``auto_skip_clip`` change nothing
    there, so the port does not take them.)"""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def _global_norm_sq(grads):
        return sum(torch.sum(torch.square(g.float())) for g in grads)

    def _scale(self, sq):
        norm = torch.sqrt(sq)
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                           max=1.0)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        scale = self._scale(self._global_norm_sq(grads))
        return [(p, g if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place by ``min(max_norm / max(total,
    1e-6), 1)``, ``total`` the float32 L2 norm over all of them; returns
    ``total``."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.tensor(0.0)
    total = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                           for p in params))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.grad = (p.grad * scale).to(p.grad.dtype)
    return total
