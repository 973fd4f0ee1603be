"""Flash attention: causal attention over ``[B, S, H, D]`` with a tiled
online softmax, emitting the log-sum-exp per query row, and its backward.

Replaces ``paddle_tpu/kernels/pallas_flash.py``:

- the forward ``_fwd_kernel`` (``pallas_call`` at ``:159`` in
  ``_flash_fwd``) — ``paddle_tpu_torch/csrc/flash.cu``. Bound on the
  H100: operations (the causal product; 0.139 ms at B=4, S=2048, 32 heads
  of 128). bf16 runs on the tensor cores: one warpgroup per (batch*head,
  64-row query tile), 64-key K/V tiles through a two-stage ``cp.async``
  ring of swizzled shared tiles, ``S = Q K^T`` and ``P V`` as ``wgmma``
  with P taken from registers, the online softmax on the accumulators.
  float32 runs the CUDA-core kernel (32-key tiles, fp32 FMAs). Both visit
  no causal tile past the diagonal, mask the tail past S, and index the
  KV head for GQA (K/V never repeated);
- the backward ``_dkv_kernel`` and ``_dq_kernel`` (``pallas_call`` at
  ``:335`` and ``:365`` in ``_flash_bwd``) — two kernels in
  ``paddle_tpu_torch/csrc/flash_bwd.cu``. Bound: operations (four
  products per causal pair for dK/dV, three for dQ; 0.278 and 0.209 ms
  at the shape above). ``flash_bwd_dkv`` runs one block per (batch, KV
  head, 64-key tile) and walks the query tiles from the diagonal to S,
  looping over the KV head's group of query heads inside the block, so
  GQA's dK/dV sum over the group without atomics and is the same bits on
  every run; in bf16 its four products are ``mma.sync.m16n8k16`` on the
  tensor cores over the transposed scores, P^T and dS^T feeding dV and dK
  from registers, in float32 fp32 FMAs on the CUDA cores.
  ``flash_bwd_dq`` runs one block per (batch*head, 64-row query tile),
  with Q and dO resident, and walks the key tiles up to the diagonal; in
  bf16 its three products are ``mma.sync.m16n8k16`` (S = Q K^T and
  dP = dO V^T, then dS from registers as the A operand of dQ += dS K), in
  float32 fp32 FMAs on the CUDA cores;
- the ``jax.custom_vjp`` that ties them together — :class:`FlashAttention`,
  a ``torch.autograd.Function``.

The input type alone picks a kernel: there is no fallback between them.

The fused-RoPE mode (``rope=`` in the JAX kernels) is not ported
(ROADMAP Queue B item 7).

Every wrapper takes the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from ..flags import get_flag
from ._launch import check_cuda, check_head_dim, launch
from .flash_attention import _ref_attention, _ref_logits, _ref_lse


#: head dims the flash kernels take
HEAD_DIMS = (64, 128)


def _check_shapes(name, q, k, v):
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    check_head_dim(name, D, HEAD_DIMS)
    return B, S, H, Hk, D


def _on_cuda(name, q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    return True


# ------------------------------------------------------------------ forward
def flash_attention_fwd(q, k, v, causal=True):
    """``(out [B, S, H, D], lse [B, H, S] float32)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. k/v are
    ``[B, S, Hk, D]`` with ``H % Hk == 0``."""
    if not _on_cuda("flash_attention_fwd", q):
        return _ref_attention(q, k, v, causal), _ref_lse(q, k, causal)
    B, S, H, Hk, D = _check_shapes("flash", q, k, v)
    code = check_cuda("flash", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch("flash", q, k, v, out, lse, B, S, H, Hk, D, int(bool(causal)),
           code)
    return out, lse


# ----------------------------------------------------------------- backward
def attention_delta(o, do):
    """``delta = sum(dO * O)`` over D in float32, ``[B, H, S]`` — the one
    jnp op of ``_flash_bwd`` outside its kernels (``pallas_flash.py:315``),
    laid out like the LSE."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _scores_grad(q, k, v, lse, delta, do, causal):
    """Plain P and dS ``[B, H, Sq, Sk]`` (float32) of one backward:
    ``P = exp(S*scale - lse)`` under the causal mask and
    ``dS = P * (dO V^T - delta) * scale``. Also returns K repeated to the
    query heads (GQA)."""
    H, D = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    s = _ref_logits(q, k, causal)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(D))
    return p, ds, k


def _group_sum(x, Hk):
    """``[B, S, H, D]`` float32 per query head -> ``[B, S, Hk, D]``, summed
    over each KV head's group (the adjoint of repeating K/V)."""
    B, S, H, D = x.shape
    return x.reshape(B, S, Hk, H // Hk, D).sum(3) if H != Hk else x


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True):
    """Plain version of ``_dkv_kernel``: ``(dk, dv)`` ``[B, S, Hk, D]``.
    Same cast points: P is rounded to ``do.dtype`` before ``P^T dO``
    (``pallas_flash.py:228``), dS to ``q.dtype`` before ``dS^T Q``
    (:237); products accumulate in float32. Under GQA each KV head's
    dK/dV is the float32 sum over its query heads, rounded once."""
    p, ds, _ = _scores_grad(q, k, v, lse, delta, do, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    Hk = k.shape[2]
    return _group_sum(dk, Hk).to(k.dtype), _group_sum(dv, Hk).to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=True):
    """Plain version of ``_dq_kernel``: ``dq [B, S, H, D]``, with dS
    rounded to ``k.dtype`` before ``dS K`` (``pallas_flash.py:299``)."""
    _, ds, kr = _scores_grad(q, k, v, lse, delta, do, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr.float())
    return dq.to(q.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True):
    """The plain flash backward, straight from the formula (not autograd):
    ``(dq [B, S, H, D], dk, dv [B, S, Hk, D])`` from the forward's inputs,
    its output ``o`` and ``lse [B, H, S]``, and the output gradient."""
    delta = attention_delta(o, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal), dk, dv


def _check_bwd(name, q, k, v, do, lse, delta):
    B, S, H, Hk, D = _check_shapes(name, q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 "
                             f"[{B}, {H}, {S}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    code = check_cuda(name, (q, k, v, do))
    check_cuda(name, (lse, delta))
    return B, S, H, Hk, D, code


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True):
    """``(dk, dv)`` of one flash backward: the ``flash_bwd_dkv`` kernel
    for CUDA tensors, :func:`flash_bwd_dkv_reference` for CPU tensors."""
    if not _on_cuda("flash_bwd_dkv", q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    B, S, H, Hk, D, code = _check_bwd("flash_bwd_dkv", q, k, v, do, lse,
                                      delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    launch("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv, B, S, H, Hk, D,
           int(bool(causal)), code)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True):
    """``dq`` of one flash backward: the ``flash_bwd_dq`` kernel for CUDA
    tensors, :func:`flash_bwd_dq_reference` for CPU tensors."""
    if not _on_cuda("flash_bwd_dq", q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    B, S, H, Hk, D, code = _check_bwd("flash_bwd_dq", q, k, v, do, lse,
                                      delta)
    dq = torch.empty_like(q)
    launch("flash_bwd_dq", q, k, v, do, lse, delta, dq, B, S, H, Hk, D,
           int(bool(causal)), code)
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, causal=True):
    """``(dq, dk, dv)``: delta as one torch op, then the two backward
    kernels (CUDA tensors) or their plain versions (CPU tensors)."""
    delta = attention_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


# ------------------------------------------------------------ autograd op
class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its hand-written backward — the
    counterpart of the ``jax.custom_vjp`` ``_flash``
    (``pallas_flash.py:388-406``). ``use_kernels=False`` runs the plain
    forward and the plain backward on any device (the A/B switch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, use_kernels):
        if use_kernels:
            o, lse = flash_attention_fwd(q, k, v, causal)
        else:
            o, lse = _ref_attention(q, k, v, causal), _ref_lse(q, k, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.use_kernels = causal, use_kernels
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand an expanded or strided gradient; the kernels
        # take contiguous tensors only
        do = do.contiguous()
        bwd = flash_attention_bwd if ctx.use_kernels \
            else flash_attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True):
    """Flash attention output, differentiable through the backward
    kernels. The kernels run on CUDA tensors while
    ``FLAGS_use_cuda_kernels`` is on; the plain versions run on CPU
    tensors, or on any device with the flag off."""
    return FlashAttention.apply(q, k, v, bool(causal),
                                bool(get_flag("FLAGS_use_cuda_kernels")))
