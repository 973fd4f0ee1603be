"""Attention dispatcher for model internals, ``[batch, seq, heads, dim]``.

The counterpart of ``paddle_tpu/kernels/flash_attention.py``'s
``attention``/``_ref_attention``. There the Pallas kernel takes over at
S >= 512 on a TPU, a tuning choice of that chip; here a CUDA tensor goes
through the flash kernel at every S, and only a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, causal=True):
    """q [B, S, H, D]; k/v [B, S, Hk, D]: the flash kernel on CUDA, the
    plain version on CPU."""
    if q.device.type == "cpu":
        return _ref_attention(q, k, v, causal)
    from .flash import flash_attention
    return flash_attention(q, k, v, causal=causal)


def _ref_logits(q, k, causal):
    """fp32 scaled scores ``[B, H, Sq, Sk]`` with the causal mask at -1e30
    (GQA by repeating kv heads)."""
    H, D = q.shape[2], q.shape[3]
    Sq, Sk, Hk = q.shape[1], k.shape[1], k.shape[2]
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril()[None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits


def _ref_attention(q, k, v, causal):
    """Plain attention: the same ops and cast points as the JAX
    ``_ref_attention`` (fp32 scores, softmax, probabilities cast to
    ``q.dtype`` before the PV product)."""
    H, Hk = q.shape[2], k.shape[2]
    if Hk != H:
        v = v.repeat_interleave(H // Hk, dim=2)
    probs = torch.softmax(_ref_logits(q, k, causal), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ref_lse(q, k, causal):
    """Log-sum-exp of the masked scores per query row, ``[B, H, S]``."""
    return torch.logsumexp(_ref_logits(q, k, causal), dim=-1)
