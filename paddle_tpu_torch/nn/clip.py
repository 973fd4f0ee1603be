"""Gradient clipping — the counterpart of ``paddle_tpu/nn/clip.py``'s
``ClipGradByGlobalNorm`` (``:59-99``), the clip of the training path.

A clip object is attached to an optimizer (``grad_clip=...``) and applied
to its ``(param, grad)`` list before the update. The other clips of the
JAX module and the hybrid-parallel norm hook are not ported (ROADMAP
Queue A step 12).
"""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
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
