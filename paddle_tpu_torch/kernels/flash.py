"""Flash attention: causal attention over ``[B, S, H, D]`` with a tiled
online softmax, emitting the log-sum-exp per query row, and its backward.

Replaces ``paddle_tpu/kernels/pallas_flash.py``:

- the forward ``_fwd_kernel`` (``pallas_call`` at ``:159`` in
  ``_flash_fwd``) — ``paddle_tpu_torch/csrc/flash.cu``. Bound on the
  H100: operations (the causal product; 0.139 ms at B=4, S=2048, 32 heads
  of 128). bf16 and fp16 run on the tensor cores (one template over the
  16-bit type: P rounded to it): one warpgroup per (batch*head,
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
  every run; in bf16 and fp16 its four products are ``mma.sync.m16n8k16`` on the
  tensor cores over the transposed scores, P^T and dS^T feeding dV and dK
  from registers, in float32 fp32 FMAs on the CUDA cores.
  ``flash_bwd_dq`` runs one block per (batch*head, 64-row query tile),
  with Q and dO resident, and walks the key tiles up to the diagonal; in
  bf16 and fp16 its three products are ``mma.sync.m16n8k16`` (S = Q K^T and
  dP = dO V^T, then dS from registers as the A operand of dQ += dS K), in
  float32 fp32 FMAs on the CUDA cores;
- the ``jax.custom_vjp`` ops that tie them together, ``_flash`` and the
  fused-RoPE ``_flash_rope`` (``:388-432``) — :class:`FlashAttention`, a
  ``torch.autograd.Function``, and the reference's head-major entry
  ``flash_attention_bhsd`` (``:463``).

The input type alone picks a kernel: there is no fallback between them.

**Layouts.** The kernels take element strides for the batch, sequence
and head dimensions (D contiguous): one set for Q, O, dO and dQ, one for
K, V, dK and dV. So ``[B, S, H, D]`` memory and head-major ``[B, H, S,
D]`` memory run the same kernel bodies; LSE and delta stay ``[B, H, S]``
float32.

**Fused RoPE** (``rope=(sin, cos)``, the reference's ``_rope_block``
and ``_rope_t_block``, ``:46`` and ``:55``): the entries take UN-rotated
Q and K and the ``[S, D]`` float32 tables. Forward and backward each
rotate Q and K once: :func:`rope_qk`, one launch of the ``rope_qk``
kernel (``paddle_tpu_torch/csrc/rope_qk.cu``, bit for bit
:func:`rope_rotate`, rounded to the input type as ``_rope_block``
rounds), writes rotated copies that the kernels read —
:func:`flash_attention_fwd` before its kernel, :func:`flash_attention_bwd`
once for the pair, a standalone :func:`flash_bwd_dkv` or
:func:`flash_bwd_dq` once for itself. The copies live for one call:
:class:`FlashAttention` saves the un-rotated pair, as the reference's
``_flash_rope_fwd_rule`` does. The backward kernels apply the adjoint
rotation to the float32 dQ and dK accumulators before their one
rounding, so the gradients are those of the un-rotated inputs. Under GQA
the adjoint applies once, to each KV head's float32 sum over its group.
The tables get no gradient.

Every wrapper takes the plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from ..flags import get_flag
from ._launch import check_head_dim, dtype_code, launch
from .flash_attention import _ref_attention, _ref_logits, _ref_lse


def _check_shapes(name, q, k, v):
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    check_head_dim(name, D)
    return B, S, H, Hk, D


def _on_cuda(name, q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    return True


def _kernel_name(name, rope, causal=True):
    """The launch counter of kernel ``name`` in this mode: ``[rope]`` for
    the fused-RoPE mode, ``:full`` for the non-causal one."""
    return (f"{name}[rope]" if rope is not None else name) + \
        ("" if causal else ":full")


# --------------------------------------------------------------- the rope
def _rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)


def rope_rotate(x, sin, cos):
    """Neox rotation of ``x`` (``[B, S, H, D]``, any strides) by the
    ``[S, D]`` float32 tables, computed in float32 and rounded to
    ``x.dtype`` — the plain version of the kernels' prologue, the
    counterpart of ``_rope_block`` (``pallas_flash.py:46``)."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x * c + _rotate_half(x) * s).to(x.dtype)


def rope_adjoint(y, sin, cos):
    """The transpose of :func:`rope_rotate` on a float32 gradient ``y``
    (``[B, S, H, D]``): ``y * cos + R^T(y * sin)`` with ``R^T([z1, z2]) =
    [z2, -z1]`` — the counterpart of ``_rope_t_block``
    (``pallas_flash.py:55``). Stays float32: the caller rounds once."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    z = y * s
    d = y.shape[-1]
    return y * c + torch.cat([z[..., d // 2:], -z[..., :d // 2]], dim=-1)


def _rotated(q, k, rope):
    if rope is None:
        return q, k
    return rope_rotate(q, *rope), rope_rotate(k, *rope)


def _tables(rope, S, D, device):
    """The ``(sin, cos)`` tables as contiguous float32 ``[S, D]`` on
    ``device`` (None stays None)."""
    if rope is None:
        return None
    sin, cos = (torch.as_tensor(t).to(device=device, dtype=torch.float32)
                .contiguous() for t in rope)
    if sin.shape != (S, D) or cos.shape != (S, D):
        raise ValueError(f"rope tables must be [{S}, {D}], got "
                         f"{tuple(sin.shape)} and {tuple(cos.shape)}")
    return sin, cos


# ------------------------------------------------------------- the layout
def _layout(x):
    """``x`` ([B, S, H, D]) as the kernels read it: unchanged where its
    memory is ``[B, S, H, D]`` or ``[B, H, S, D]`` (a head-major tensor
    seen through ``transpose(1, 2)``), else a contiguous copy."""
    if x.is_contiguous() or x.transpose(1, 2).is_contiguous():
        return x
    return x.contiguous()


def _like(x, ref):
    """``x`` in the memory layout of ``ref`` (the kernels read one set of
    strides for Q, O and dO, one for K and V)."""
    if x.stride() == ref.stride():
        return x
    return torch.empty_like(ref).copy_(x)


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def _check_kernel_inputs(name, data, floats=()):
    """What the flash kernels read: ``data`` on one CUDA device, one float
    dtype, D contiguous, 16-byte aligned rows (16-byte loads);
    ``floats`` (LSE, delta, rope tables) float32 and contiguous. Returns
    the dtype code."""
    dev = data[0].device
    vec = 16 // data[0].element_size()
    for t in data:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != data[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {data[0].dtype} and "
                            f"{t.dtype}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous in D and "
                             f"16-byte aligned, got strides {t.stride()}")
    for t in floats:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: LSE, delta and rope tables must be "
                             f"contiguous float32 on {dev}")
    return dtype_code(data[0])


def _rope_args(tables):
    return (None, None) if tables is None else tables


# ---------------------------------------------------- the rope pre-pass
def rope_qk(q, k, sin, cos):
    """``(rope_rotate(q), rope_rotate(k))``: one launch of the ``rope_qk``
    kernel for CUDA tensors (new tensors with q's and k's strides), the
    plain :func:`rope_rotate` for CPU tensors — the rotation pre-pass of
    the forward and of the backward. q ``[B, S, H, D]``, k ``[B, S, Hk, D]`` in either layout
    (``_layout``), tables ``[S, D]``."""
    if not _on_cuda("rope_qk", q):
        return _rotated(q, k, (sin, cos))
    B, S, H, D = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"rope_qk: q {tuple(q.shape)} k {tuple(k.shape)}")
    check_head_dim("rope_qk", D)
    q, k = _layout(q), _layout(k)
    tables = _tables((sin, cos), S, D, q.device)
    return _launch_rope_qk(q, k, tables,
                           _check_kernel_inputs("rope_qk", (q, k), tables))


def _launch_rope_qk(q, k, tables, code):
    """One ``rope_qk`` launch on checked operands."""
    B, S, H, D = q.shape
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    launch("rope_qk", q, k, qr, kr, *tables, B, S, H, k.shape[2], D,
           *_strides(q), *_strides(k), code)
    return qr, kr


# ------------------------------------------------------------------ forward
def flash_attention_reference(q, k, v, causal=True, rope=None):
    """The plain forward: ``(out, lse)``, Q and K rotated first when
    ``rope=(sin, cos)`` is given."""
    q, k = _rotated(q, k, rope)
    return _ref_attention(q, k, v, causal), _ref_lse(q, k, causal)


def flash_attention_fwd(q, k, v, causal=True, rope=None):
    """``(out [B, S, H, D], lse [B, H, S] float32)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. k/v are
    ``[B, S, Hk, D]`` with ``H % Hk == 0``; any of the two layouts
    (``_layout``); ``out`` takes q's layout. ``rope=(sin, cos)`` takes
    un-rotated q and k: one :func:`rope_qk` pre-pass rotates them, then
    the forward reads the rotated pair."""
    if not _on_cuda("flash_attention_fwd", q):
        if rope is not None:
            q, k = rope_qk(q, k, *rope)
        return flash_attention_reference(q, k, v, causal)
    B, S, H, Hk, D = _check_shapes("flash", q, k, v)
    q, k = _layout(q), _layout(k)
    v = _like(v, k)
    tables = _tables(rope, S, D, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    code = _check_kernel_inputs("flash", (q, k, v, out),
                                (lse,) + (tables or ()))
    if tables is not None:
        q, k = _launch_rope_qk(q, k, tables, code)
    launch("flash", q, k, v, out, lse, B, S, H, Hk, D, *_strides(q),
           *_strides(k), int(bool(causal)), code,
           count_as=_kernel_name("flash", rope, causal))
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


def _dkv_rotated(qr, kr, v, do, lse, delta, causal, rope):
    """dK/dV from Q and K rotated beforehand (or un-rotated, rope None);
    with ``rope`` the adjoint on the float32 dK sum."""
    p, ds, _ = _scores_grad(qr, kr, v, lse, delta, do, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(qr.dtype).float(), qr.float())
    Hk = kr.shape[2]
    dk = _group_sum(dk, Hk)
    if rope is not None:
        dk = rope_adjoint(dk, *rope)
    return dk.to(kr.dtype), _group_sum(dv, Hk).to(v.dtype)


def _dq_rotated(qr, kr, v, do, lse, delta, causal, rope):
    """dQ from Q and K rotated beforehand; with ``rope`` the adjoint on
    the float32 dQ."""
    _, ds, krep = _scores_grad(qr, kr, v, lse, delta, do, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(kr.dtype).float(),
                      krep.float())
    if rope is not None:
        dq = rope_adjoint(dq, *rope)
    return dq.to(qr.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True, rope=None):
    """Plain version of ``_dkv_kernel``: ``(dk, dv)`` ``[B, S, Hk, D]``.
    Same cast points: P is rounded to ``do.dtype`` before ``P^T dO``
    (``pallas_flash.py:228``), dS to ``q.dtype`` before ``dS^T Q``
    (:237); products accumulate in float32. Under GQA each KV head's
    dK/dV is the float32 sum over its query heads, rounded once. With
    ``rope``: Q and K rotated first, and the adjoint rotation applied to
    the float32 dK sum before that one rounding (:243-244)."""
    return _dkv_rotated(*_rotated(q, k, rope), v, do, lse, delta, causal,
                        rope)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=True, rope=None):
    """Plain version of ``_dq_kernel``: ``dq [B, S, H, D]``, with dS
    rounded to ``k.dtype`` before ``dS K`` (``pallas_flash.py:299``); with
    ``rope`` the adjoint rotation of the float32 dQ before its one
    rounding (:305-306)."""
    return _dq_rotated(*_rotated(q, k, rope), v, do, lse, delta, causal,
                       rope)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                  rope=None):
    """The plain flash backward, straight from the formula (not autograd):
    ``(dq [B, S, H, D], dk, dv [B, S, Hk, D])`` from the forward's inputs,
    its output ``o`` and ``lse [B, H, S]``, and the output gradient."""
    delta = attention_delta(o, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, rope)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, rope),
            dk, dv)


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
    return B, S, H, Hk, D


def _bwd_operands(name, q, k, v, do, lse, delta, rope):
    """Shapes checked, the operands in the kernels' layouts (dO in Q's,
    V in K's) — with ``rope``, Q and K rotated by one ``rope_qk`` launch
    —, the tables, and the dtype code."""
    B, S, H, Hk, D = _check_bwd(name, q, k, v, do, lse, delta)
    q, k = _layout(q), _layout(k)
    v, do = _like(v, k), _like(do, q)
    tables = _tables(rope, S, D, q.device)
    code = _check_kernel_inputs(name, (q, k, v, do),
                                (lse, delta) + (tables or ()))
    if tables is not None:
        q, k = _launch_rope_qk(q, k, tables, code)
    return (B, S, H, Hk, D), (q, k, v, do), tables, code


def _launch_dkv(dims, ops, tables, code, lse, delta, causal):
    q, k, v, do = ops
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    launch("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv,
           *_rope_args(tables), *dims, *_strides(q), *_strides(k),
           int(bool(causal)), code,
           count_as=_kernel_name("flash_bwd_dkv", tables, causal))
    return dk, dv


def _launch_dq(dims, ops, tables, code, lse, delta, causal):
    q, k, v, do = ops
    dq = torch.empty_like(q)
    launch("flash_bwd_dq", q, k, v, do, lse, delta, dq, *_rope_args(tables),
           *dims, *_strides(q), *_strides(k), int(bool(causal)), code,
           count_as=_kernel_name("flash_bwd_dq", tables, causal))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, rope=None):
    """``(dk, dv)`` of one flash backward, in k's layout: the
    ``flash_bwd_dkv`` kernel for CUDA tensors (after its own ``rope_qk``
    pre-pass with ``rope``), :func:`flash_bwd_dkv_reference` for CPU
    tensors."""
    if not _on_cuda("flash_bwd_dkv", q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       rope)
    return _launch_dkv(*_bwd_operands("flash_bwd_dkv", q, k, v, do, lse,
                                      delta, rope), lse, delta, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, rope=None):
    """``dq`` of one flash backward, in q's layout: the ``flash_bwd_dq``
    kernel for CUDA tensors (after its own ``rope_qk`` pre-pass with
    ``rope``), :func:`flash_bwd_dq_reference` for CPU tensors."""
    if not _on_cuda("flash_bwd_dq", q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, rope)
    return _launch_dq(*_bwd_operands("flash_bwd_dq", q, k, v, do, lse,
                                     delta, rope), lse, delta, causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, rope=None):
    """``(dq, dk, dv)``: delta as one torch op; with ``rope``, Q and K
    rotated once for both kernels (:func:`rope_qk`: its kernel for CUDA
    tensors, :func:`rope_rotate` for CPU tensors); then the two backward
    kernels (CUDA tensors) or their plain versions (CPU tensors) on the
    rotated pair, each applying the adjoint to its float32 dK or dQ."""
    delta = attention_delta(o, do)
    if not _on_cuda("flash_attention_bwd", q):
        rot = _rotated(q, k, rope) + (v, do, lse, delta, causal, rope)
        dk, dv = _dkv_rotated(*rot)
        return _dq_rotated(*rot), dk, dv
    args = _bwd_operands("flash_attention_bwd", q, k, v, do, lse, delta,
                         rope)
    dk, dv = _launch_dkv(*args, lse, delta, causal)
    return _launch_dq(*args, lse, delta, causal), dk, dv


# ------------------------------------------------------------ autograd op
class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its hand-written backward — the
    counterpart of the ``jax.custom_vjp`` ops ``_flash`` and
    ``_flash_rope`` (``pallas_flash.py:388-432``). With tables
    (``sin``, ``cos`` not None) Q and K arrive un-rotated and are saved so
    (the reference's residuals, :422); the tables get no gradient.
    ``use_kernels=False`` runs the plain forward and the plain backward on
    any device (the A/B switch)."""

    @staticmethod
    def forward(ctx, q, k, v, sin, cos, causal, use_kernels):
        rope = None if sin is None else (sin, cos)
        fwd = flash_attention_fwd if use_kernels \
            else flash_attention_reference
        o, lse = fwd(q, k, v, causal, rope)
        ctx.save_for_backward(q, k, v, o, lse,
                              *(() if rope is None else rope))
        ctx.causal, ctx.use_kernels = causal, use_kernels
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *rope = ctx.saved_tensors
        # autograd may hand an expanded or strided gradient; the kernels
        # read dO in q's layout
        do = _like(do, o)
        bwd = flash_attention_bwd if ctx.use_kernels \
            else flash_attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal,
                         tuple(rope) if rope else None)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, rope=None):
    """Flash attention output over ``[B, S, H, D]`` (k/v ``[B, S, Hk,
    D]``), differentiable through the backward kernels; ``rope=(sin,
    cos)`` rotates Q and K in the forward's and the backward's one
    pre-pass each (:func:`rope_qk`). The kernels run on CUDA tensors
    while ``FLAGS_use_cuda_kernels`` is on; the plain versions run on CPU
    tensors, or on any device with the flag off."""
    sin, cos = (None, None) if rope is None else rope
    use_kernels = bool(get_flag("FLAGS_use_cuda_kernels"))
    return FlashAttention.apply(q, k, v, sin, cos, bool(causal),
                                use_kernels)


def _check_block(name, value):
    if isinstance(value, bool) or int(value) != value or value < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


def flash_attention_bhsd(q, k, v, causal=True, block_q=1024, block_k=1024,
                         rope=None):
    """The reference's head-major entry (``pallas_flash.py:463``): q/k/v
    ``[BH, S, D]`` (heads folded into the batch, k/v as many heads as q),
    or ``[B, H, S, D]`` with k/v ``[B, Hk, S, D]`` (GQA indexes the KV
    head; K/V are never repeated). The kernels read the head-major
    tensors through their strides. ``rope=(sin, cos)`` (``[S, D]``
    float32) rotates un-rotated Q and K once a forward and once a
    backward (:func:`rope_qk`) and returns the gradients of the
    un-rotated inputs. ``block_q``/``block_k`` are
    the Pallas tile sizes, validated and otherwise unused: the port's
    tiles are fixed at 64 rows by 64 keys (ROADMAP Queue B item 6)."""
    _check_block("block_q", block_q)
    _check_block("block_k", block_k)
    if q.dim() == 3:
        if k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"folded [BH, S, D]: q {tuple(q.shape)} k "
                             f"{tuple(k.shape)} v {tuple(v.shape)}")
        return flash_attention_bhsd(q[:, None], k[:, None], v[:, None],
                                    causal, block_q, block_k, rope)[:, 0]
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, rope=rope)
    return o.transpose(1, 2)
