"""Prefill, unified ragged step and dense-slot decode for the LLaMA
serving path, in PyTorch.

The port of these programs of ``paddle_tpu/serving/decode.py``:

- :func:`_prefill_impl` — one admission group's full-prompt forward,
  returning per-layer K/V ``[L, G, S_pad, Hkv, D]``, the first sampled
  token and the advanced key;
- :func:`_ragged_step_impl` — THE unified serving step: tick 0 runs a
  packed buffer of variable-length spans (decode rows of 1, prefill
  chunks of n) through :func:`_packed_span_forward`, samples one token
  per slot from its span's last position (:func:`_span_last_sample`),
  then up to ``n_steps - 1`` decode ticks of :func:`_fused_decode_tick`
  (scanned layer by layer, or with ``fused`` one fused-tick kernel
  launch each);
- :func:`_decode_steps_impl` — the dense-slot engine's ``n_steps``
  decode ticks over a :class:`~.kv_cache.SlotKVCache`;
- :func:`_suffix_prefill_impl` / :func:`_paged_suffix_prefill_impl` —
  prefill of only the UNCOVERED suffix of prompts whose leading blocks a
  prefix-cache hit installed (dense: into the slot; paged: through the
  block table, the shared prefix read and never written); the paged one
  is also the two-program engine's chunked-prefill program;
- :func:`_paged_decode_steps_impl` — the two-program engine's
  (``ragged_step=False``) ``n_steps`` decode ticks through the tables;
- :func:`_multitick_step_impl` — the multi-tick step (``decode_ticks >
  1``): tick 0 as in the unified step, then a tail of ``n_ticks - 1``
  ticks under an on-device alive mask (``serving/graphs.py``: one
  captured CUDA graph a tick on a card);
- :func:`_spec_verify_impl` — the speculative step (``spec_decode``):
  the packed forward of tick 0 over draft-extended verify spans and
  prefill chunks, then ``spec_len`` samples a row along the key walk.

What changes from JAX to PyTorch:

- ``lax.scan`` over the stacked layers becomes a Python loop indexing the
  stacked weights; PyTorch runs eagerly, so there is no jit.
- Pool writes are IN PLACE (``index_put_`` on the layer's pool slice),
  where JAX scattered functionally with ``.at[].set`` and donated the
  old pool. The programs return the same pool tensors they were given.
- JAX computes every write coordinate on the device and lets
  ``mode="drop"`` discard the sentinel ones. Here the coordinates come
  from host metadata the engine already holds (tables, positions,
  lengths — the fused ticks advance lengths deterministically), so the
  dead rows are dropped on the host and only live rows reach
  ``index_put_``, which would fault on a sentinel index.
- PRNG keys stay on the host as int64 tensors holding uint32 values
  (``core/random.py``); only a sampling draw moves its keys to the
  logits' device (the multi-tick tail uploads its whole key walk once).
- The suffix programs' attention is plain PyTorch (a gather through the
  table, then matmuls), as the JAX programs compute it with
  ``jnp.einsum`` outside any Pallas kernel.
- The model's parameters are trainable, so both programs run under
  ``torch.inference_mode()``: serving records no autograd graph.

Quantized serving rides every program, as in the reference:

- ``quantize_weights`` (:func:`quantize_decode_params`): each projection
  weight is an int8 ``(q, scale)`` pair, dequantized one layer at a time
  in the program (:func:`_dq_layer`); the lm head by :func:`_dq_head`;
- ``quantize_activations`` (``a8``): nothing dequantizes; every
  projection input is quantized per row at run time and multiplied with
  the int8 weight in int8 x int8 with int32 accumulation
  (:func:`_a8_apply`, ``torch._int_mm``: exact, as JAX's int32 dot is);
- a quantized pool (``kv_dtype``) arrives as one ``(data, scale)`` pair a
  side (``PagedKVCache.kv_args``): appends quantize on write
  (:func:`_kv_write`), the attention kernels (or their plain versions)
  take the scale planes, and the suffix programs gather narrow rows and
  apply the scales after the dots.

Every program's layers run through one stack, :func:`layer_stack`: per
layer RMSNorm, QKV, the program's own ``core`` (RoPE, the K/V write and
the attention), O-proj and SwiGLU. The programs take their parameters
and pool sides as per-shard lists, a shard's head counts and
``tp_reduce``: one shard and ``tp.one_shard`` without tensor
parallelism, ``tp`` shards and the engine's reduction under the engine's
``tp`` (``serving/tp.py``). The stack runs the shards in lockstep up to
each half-layer's partial sum and reduces; what follows the last layer
runs once, on shard 0's copy.

``FLAGS_use_cuda_kernels`` (``paddle_tpu_torch.flags``) selects the
attention (and the fused tick) at every call: on, the kernel wrappers
(the hand-written CUDA kernels for CUDA tensors, their plain versions
for CPU tensors); off, the plain versions on any device — the A/B
switch. Each program's ``decode_attn`` (the model config's
``decode_attention``, which the engine passes) does the same per
program: ``"pallas"`` follows the flag, ``"jnp"`` takes the plain
versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as prng
from ..flags import get_flag
from ..kernels.decode import decode_attention, decode_attention_reference
from ..kernels.flash_attention import _ref_attention
from ..kernels.flash_attention import attention as _attention
from ..kernels.fused_decode_tick import (fused_decode_tick,
                                         fused_decode_tick_reference)
from ..kernels.paged_decode import (paged_decode_attention,
                                    paged_decode_attention_reference)
from ..kernels.ragged_attention import (ragged_attention_reference,
                                        ragged_paged_attention)
from ..models.llama import (STACK_KEYS, _apply_rope, _qkv_bshd, _rms,
                            _rope_tables, _rotate_half, _swiglu_raw)
from ..quantization import quantize_collective_int8, quantize_weight_int8
from . import graphs
from .graphs import decode_layers, sample_rows_dev, sampling_args
from .kv_cache import quantize_kv_rows, quantize_kv_rows_fp8, store_view
from .tp import one_shard

NEG_INF = -1e30


def _attn_fns(decode_attn="pallas"):
    """(prefill, paged decode, ragged, dense decode) attention and the
    fused tick: the kernel wrappers while ``FLAGS_use_cuda_kernels`` is
    on and ``decode_attn`` is ``"pallas"``, else the plain versions."""
    if get_flag("FLAGS_use_cuda_kernels") and decode_attn == "pallas":
        return (_attention, paged_decode_attention, ragged_paged_attention,
                decode_attention, fused_decode_tick)
    return (_ref_attention, paged_decode_attention_reference,
            ragged_attention_reference, decode_attention_reference,
            fused_decode_tick_reference)


#: the projection weights ``quantize_weights=True`` converts; norms and
#: the embedding gather stay full precision
_WEIGHT_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _head(params, tied):
    """The dense lm head ``[H, V]`` (the embedding transposed when
    tied)."""
    return params["lm_head"].T if tied else params["lm_head"]


def _layer(params, l):
    return tuple(params[k][l] if not isinstance(params[k], tuple)
                 else (params[k][0][l], params[k][1][l])
                 for k in STACK_KEYS)


# ------------------------------------------------ the shared layer stack
def _embed(params, ids):
    """Every shard's copy of the embedded tokens (the residual stream each
    shard carries)."""
    return [p["embed"][ids.to(p["embed"].device)] for p in params]


def layer_stack(params, x, n_layers, core, *, nh, nkv, hd, eps, a8=False,
                tp_reduce=one_shard):
    """THE layer stack of every serving program: per layer RMSNorm → QKV
    → ``core(l, q, k, v, s)`` (RoPE, the program's K/V write and its
    attention on shard ``s``, returning ``[..., nh, hd]``) → O-proj →
    SwiGLU, on the residual stream. int8 weight pairs dequantize a layer
    at a time, or with ``a8`` run int8 x int8.

    ``params`` is the list of shard dicts, ``x`` every shard's copy of the
    stream ``[..., hidden]`` and ``nh``/``nkv`` a shard's head counts. Each
    half of a layer runs shard by shard up to its partial sum — the
    row-sharded ``wo`` and ``w_down`` products; under ``a8`` each shard
    quantizes its own input rows, as ``shard_map`` does — then
    ``tp_reduce`` hands every shard its reduced copy for the residual add
    (one shard: its own). Returns shard 0's copy of the stream after the
    last layer, where the math that follows is replicated."""
    for l in range(n_layers):
        lws = [_dq_layer(_layer(p, l), x[0].dtype, a8) for p in params]
        parts = []
        for s, (lwq, lwk, lwv, lwo, _g, _u, _d, lin, _p) in enumerate(lws):
            q, k, v = _qkv_proj(_rms(x[s], lin, eps), lwq, lwk, lwv, nh,
                                nkv, hd)
            attn = core(l, q, k, v, s)
            parts.append(_o_proj(attn.reshape(*x[s].shape[:-1], nh * hd),
                                 lwo))
        x = [xs + r for xs, r in zip(x, tp_reduce(parts))]
        parts = [_swiglu_proj(_rms(x[s], lw[8], eps), *lw[4:7])
                 for s, lw in enumerate(lws)]
        x = [xs + r for xs, r in zip(x, tp_reduce(parts))]
    return x[0]


# ----------------------------------------------- int8 weight-only decode
def quantize_decode_params(params, tied):
    """The decode parameters in int8 weight-only form (the engine's
    ``quantize_weights=True``): each projection weight becomes a ``(q
    int8, scale float32)`` pair by :func:`quantize_weight_int8` over its
    contraction axis (one scale an output column); the lm head over its
    contraction axis in the orientation it is used in (a tied head runs
    ``embed.T``, so its scales lie along the embedding's rows). A stacked
    weight converts a layer at a time (the same bits: each layer's
    columns have their own scales), so the float32 temporaries stay one
    layer's size."""
    out = dict(params)
    with torch.no_grad():
        for k in _WEIGHT_QUANT_KEYS:
            w = params[k]
            q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
            sc = torch.empty((w.shape[0], 1, w.shape[2]),
                             dtype=torch.float32, device=w.device)
            for l in range(w.shape[0]):
                q[l], sc[l] = quantize_weight_int8(w[l], reduce_axis=0)
            out[k] = (q, sc)
        out["lm_head"] = quantize_weight_int8(params["lm_head"].detach(),
                                              reduce_axis=1 if tied else 0)
    return out


def _dq(w, dt):
    """Dequantize one int8 ``(q, scale)`` pair to ``dt`` (``float(q) *
    scale`` in float32, rounded once to ``dt``: one elementwise kernel
    writing ``dt``, no float32 copy); a dense weight passes through."""
    if isinstance(w, tuple):
        q, sc = w
        return torch.mul(q, sc, out=torch.empty(q.shape, dtype=dt,
                                                device=q.device))
    return w


def _dq_layer(lp, dt, a8=False):
    """One layer's weights for its body: the 7 projection entries
    dequantized (one layer materialises at a time), the rest untouched.
    Under ``a8`` nothing dequantizes: the pairs go to the int8 x int8
    projections."""
    if a8:
        return lp
    return tuple(_dq(w, dt) for w in lp[:7]) + tuple(lp[7:])


def _dq_head(params, tied, dt, a8=False):
    """The lm head ``[H, V]`` for the logits product: dequantized, then
    transposed when tied (its scales lie along the stored orientation).
    Under ``a8`` the int8 pair, oriented: a tied pair transposes data and
    scales."""
    head = params["lm_head"]
    if a8 and isinstance(head, tuple):
        q, sc = head
        return (q.T.contiguous(), sc.T.contiguous()) if tied else (q, sc)
    head = _dq(head, dt)
    return head.T if tied else head


# --------------------------------------------- int8 x int8 activation path
def quantize_act_rows(x):
    """Per-row int8 quantization of an activation (absmax over the last
    axis): ``(q int8, scale float32 [..., 1])``."""
    return quantize_collective_int8(x)


def _int8_mm(a, b):
    """``a [M, K] @ b [K, N]`` in int8 with int32 accumulation, exact.
    ``torch._int_mm`` on a card wants more than 16 rows and K, N
    multiples of 8: short ``a`` is padded with zero rows (exact), and the
    padding's rows are dropped."""
    M = a.shape[0]
    if a.device.type == "cuda":
        if a.shape[1] % 8 or b.shape[1] % 8:
            raise NotImplementedError(
                f"int8 x int8 projection: K {a.shape[1]} and N "
                f"{b.shape[1]} must be multiples of 8 on a card")
        if M <= 16:
            a = torch.cat([a, a.new_zeros(17 - M, a.shape[1])])
        return torch._int_mm(a.contiguous(), b.contiguous())[:M]
    return torch._int_mm(a.contiguous(), b.contiguous())


def _a8_apply(qx, sx, w):
    """One int8 x int8 projection: quantized activations ``(qx, sx)``
    against an int8 ``(q, scale)`` weight, int32 accumulation, then the
    rescale ``acc * sx * scale``. Returns float32."""
    qw, sw = w
    lead = qx.shape[:-1]
    acc = _int8_mm(qx.reshape(-1, qx.shape[-1]), qw)
    acc = acc.reshape(*lead, qw.shape[-1])
    return acc.float() * sx * sw.reshape(-1)


def _a8_dot(x, w):
    """Quantize ``x`` per row and run one int8 x int8 projection."""
    qx, sx = quantize_act_rows(x)
    return _a8_apply(qx, sx, w).to(x.dtype)


def _qkv_proj(hn, lwq, lwk, lwv, nh, nkv, hd):
    """The QKV projections: ``_qkv_bshd`` on dense weights; under a8 the
    input quantizes once per row and feeds three int8 x int8 products."""
    if isinstance(lwq, tuple):
        B, S = hn.shape[0], hn.shape[1]
        dt = hn.dtype
        qx, sx = quantize_act_rows(hn)
        q = _a8_apply(qx, sx, lwq).to(dt).reshape(B, S, nh, hd)
        k = _a8_apply(qx, sx, lwk).to(dt).reshape(B, S, nkv, hd)
        v = _a8_apply(qx, sx, lwv).to(dt).reshape(B, S, nkv, hd)
        return q, k, v
    return _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)


def _swiglu_proj(hn, lg, lu, ld):
    """The SwiGLU MLP: ``_swiglu_raw`` on dense weights; under a8 gate and
    up share one activation quantization and down re-quantizes the gated
    product (float32 between them, as in the reference)."""
    if isinstance(lg, tuple):
        qx, sx = quantize_act_rows(hn)
        g = torch.nn.functional.silu(_a8_apply(qx, sx, lg))
        u = _a8_apply(qx, sx, lu)
        return _a8_dot(g * u, ld).to(hn.dtype)
    return _swiglu_raw(hn, lg, lu, ld)


def _o_proj(attn2, lwo):
    """The attention output projection ``[..., nh*hd] @ wo``."""
    if isinstance(lwo, tuple):
        return _a8_dot(attn2, lwo)
    return attn2 @ lwo


def _head_logits(last_h, head):
    """The lm-head product ``[B, H] @ head`` (under a8 the pair arrives
    oriented from :func:`_dq_head`)."""
    if isinstance(head, tuple):
        return _a8_dot(last_h, head)
    return last_h @ head


# --------------------------------------------------- the pool's two forms
# A pool side is a list of shards; a quantized shard is one ``(data,
# scale)`` pair. These helpers are the only places the programs see the
# difference.
def _kv_data(pool):
    """The storage tensor of a pool side's shard 0 (shapes and dtype)."""
    side = pool[0]
    return side[0] if isinstance(side, tuple) else side


def _kv_layer(pool, l):
    """Layer ``l``'s slice of a pool side (data and scales alike)."""
    if isinstance(pool, tuple):
        return pool[0][l], pool[1][l]
    return pool[l]


def _kv_attn_args(pool_k, pool_v):
    """``(k, v, k_scale, v_scale)`` of one layer's pool sides, the scales
    None on a full-precision pool."""
    if isinstance(pool_k, tuple):
        return pool_k[0], pool_v[0], pool_k[1], pool_v[1]
    return pool_k, pool_v, None, None


def _kv_write(pool_l, phys, row, x):
    """Write K/V rows ``x [n, Hkv, D]`` into one layer's pool slice at
    ``(phys, row)``, in place, quantizing on write on a quantized pool:
    int8 writes the data and the per-row scales at the same coordinates,
    fp8 the saturating cast alone (its per-block planes are never
    written). The caller passes live rows only (the port's form of JAX's
    drop-mode scatter, module docstring)."""
    if not phys.numel():
        return
    if isinstance(pool_l, tuple):
        data, sc = pool_l
        if data.dtype == torch.float8_e4m3fn:
            store_view(data)[phys, row] = store_view(quantize_kv_rows_fp8(x))
            return
        q, s = quantize_kv_rows(x)
        data[phys, row] = q
        sc[phys, row] = s
        return
    pool_l[phys, row] = x


def _paged_attend(fn, q, pk_l, pv_l, tables, lengths):
    """Paged decode attention ``fn`` over one layer's pool sides."""
    kd, vd, ks, vs = _kv_attn_args(pk_l, pv_l)
    return fn(q, kd, vd, tables, lengths, k_scale=ks, v_scale=vs)


def _gather_blocks(t, idx):
    """``t[idx]`` (a float8 tensor through its uint8 view)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8)[idx].view(torch.float8_e4m3fn)
    return t[idx]


def _kv_gather_rows(pool_l, rd, shape4):
    """Each row's logical cache through its table ``rd [G, nblk]`` (the
    suffix programs), reshaped to ``shape4 = (G, s_rows, Hkv, D)``. A
    quantized pool's rows stay in their narrow type and its scales come
    back apart, as ``[G, s_rows, Hkv]`` (fp8's per-block planes broadcast
    over each block's rows), for the rescale after the dots. Returns
    ``(rows, scale_rows or None)``."""
    if isinstance(pool_l, tuple):
        data, sc = pool_l
        rows = _gather_blocks(data, rd).reshape(shape4)
        if sc.dim() == 2:                 # fp8 per-block [nb, Hkv]
            srows = sc[rd].repeat_interleave(shape4[1] // rd.shape[1], dim=1)
        else:                             # int8 per-row [nb, bs, Hkv]
            srows = sc[rd].reshape(shape4[:-1])
        return rows, srows
    return pool_l[rd].reshape(shape4), None


def _row_scale_bhqk(srows, grp):
    """Gathered per-row scales ``[G, s, Hkv]`` as the ``[G, H, 1, s]``
    factor of the suffix attention's ``bhqk`` logits or probabilities
    (query head h reads its KV group's scale)."""
    sf = srows.repeat_interleave(grp, dim=2) if grp > 1 else srows
    return sf.permute(0, 2, 1)[:, :, None, :]


def _apply_rope_grid(x, sin_p, cos_p):
    """Rope with a different position per (row, column).
    x: [G, S, H, D]; sin_p/cos_p: [G, S, D]."""
    return (x * cos_p[:, :, None, :]
            + _rotate_half(x) * sin_p[:, :, None, :]).to(x.dtype)


def _host(x, dtype=np.int64):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def _keys_host(keys):
    """Keys as a CPU int64 tensor ``[R, 2]`` of uint32 values (the fused
    tick kernel returns them as the int32 bits of the uint32 values)."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype == torch.int32:
            return keys.cpu().to(torch.int64) & 0xFFFFFFFF
        return keys.cpu().to(torch.int64)
    return torch.from_numpy(np.asarray(keys, np.int64).copy())


def sample_rows(logits, keys, temps, top_ks):
    """Per-row sampling: greedy where ``temps <= 0``, else top-k
    temperature sampling with a per-row Gumbel-max draw under its key.

    logits [B, V] on any device; keys [B, 2] (host); temps [B] float and
    top_ks [B] int as numpy (``top_k <= 0`` = no filter). The JAX
    version's ``lax.cond`` is a host branch here: an all-greedy batch
    never pays the sort and the draw. Greedy takes the FIRST maximal
    index, as ``jnp.argmax`` does. Returns [B] int64 on the logits'
    device (the arithmetic is ``graphs.sample_rows_dev``'s)."""
    args = sampling_args(temps, top_ks, logits.shape[-1], logits.device)
    if args is None:
        return torch.argmax(logits, dim=-1)
    return sample_rows_dev(logits, _keys_host(keys).to(logits.device), args)


def _split_rows(keys):
    """One ``jax.random.split`` per row: ``(carry [R, 2], draw [R, 2])``."""
    both = prng.split(_keys_host(keys))
    return both[:, 0], both[:, 1]


# ------------------------------------------------------------------ prefill
@torch.inference_mode()
def _prefill_impl(params, ids, lengths, keys, temps, top_ks, *, nh, nkv, hd,
                  eps, theta, tied, decode_attn="pallas", a8=False,
                  tp_reduce=one_shard):
    """Batched cold prefill: ids [G, S_pad] right-padded prompts, lengths
    [G] real token counts, per-row keys/temps/top_ks (host arrays).

    Returns ``(pk, pv, tok0, keys')``: pk/pv one ``[L, G, S_pad, Hkv,
    D]`` tensor a shard, its heads, as the pool it is written into
    (padding positions hold garbage the cache write never installs), tok0
    ``[G]`` on the device, keys' ``[G, 2]`` on the host."""
    attn_fn = _attn_fns(decode_attn)[0]
    embed = params[0]["embed"]
    dev = embed.device
    ids = torch.as_tensor(_host(ids)).to(dev)
    G, S = ids.shape
    L = params[0]["input_ln"].shape[0]
    sin, cos = _rope_tables(S, hd, theta, device=dev)
    kv = [([], []) for _ in params]

    def core(l, q, k, v, s):
        q = _apply_rope(q, sin, cos)
        k = _apply_rope(k, sin, cos)
        kv[s][0].append(k)
        kv[s][1].append(v)
        return attn_fn(q, k, v, causal=True)

    h = layer_stack(params, _embed(params, ids), L, core, nh=nh, nkv=nkv,
                    hd=hd, eps=eps, a8=a8, tp_reduce=tp_reduce)
    last_idx = torch.as_tensor(_host(lengths) - 1).to(dev)
    last = h[torch.arange(G, device=dev), last_idx]           # [G, H]
    last_h = _rms(last, params[0]["final_norm"], eps)
    logits = _head_logits(last_h, _dq_head(params[0], tied, embed.dtype, a8))
    carry, draw = _split_rows(keys)
    tok0 = sample_rows(logits, draw, temps, top_ks)
    return ([torch.stack(k) for k, _ in kv], [torch.stack(v) for _, v in kv],
            tok0, carry)


# ------------------------------------------------------ unified ragged step
def _fused_decode_tick(params, head, tables, tables_dev, sin, cos, tok,
                       pool_k, pool_v, lens, kys, app_mask, temps, top_ks,
                       *, nh, nkv, hd, eps, fused=False, attn=None,
                       return_logits=False, decode_attn="pallas", a8=False,
                       tp_reduce=one_shard):
    """ONE decode tick over all rows: embed the last tokens, per layer
    RMSNorm → QKV → RoPE at each row's length → append K/V through the
    tables (rows with ``app_mask == 0`` or past capacity do not append) →
    paged attention over ``lens + app_mask`` → O-proj → SwiGLU; then the
    final norm, the lm head, one key split and one sample per row.

    tok [R] on the device; tables [R, mb] numpy (and ``tables_dev``, the
    same as an int32 device tensor); lens/app_mask [R] numpy; kys [R, 2]
    host keys; ``params`` and the pool sides per-shard lists. Returns
    ``(next_tok, pool_k, pool_v, keys')`` (and the logits with
    ``return_logits``); the caller advances ``lens`` by ``app_mask``.

    ``fused=True`` (the engine's ``fused_tick`` knob) hands the whole
    tick to ``kernels/fused_decode_tick.py``: ONE kernel launch on CUDA
    tensors (its plain version, this scanned tick, on CPU tensors or with
    ``FLAGS_use_cuda_kernels`` off). ``attn`` overrides the paged
    attention of the scanned tick (the fused tick's plain version passes
    the plain one).

    Under ``a8`` the tick is always the scanned one: the fused kernel has
    no int8 x int8 projection, and the reference routes an a8 tick to its
    scanned oracle the same way (``pallas_fused_decode_tick.py``'s
    dispatch), so this is the reference's routing, not a fallback. The
    same holds under tensor parallelism: the reference takes its Pallas
    tick only when ``tp_reduce is None``, so a sharded fused tick is the
    scanned tick, shard by shard through paged decode."""
    if fused and not a8 and len(params) == 1:
        out = _attn_fns(decode_attn)[4](
            params[0], head, tables, tables_dev, sin, cos, tok, pool_k[0],
            pool_v[0], lens, kys, app_mask, temps, top_ks, nh=nh, nkv=nkv,
            hd=hd, eps=eps, return_logits=return_logits)
        return (out[0], [out[1]], [out[2]]) + tuple(out[3:])
    paged_fn = attn or _attn_fns(decode_attn)[1]
    dev = tok.device
    R = tok.shape[0]
    nb, bs = _kv_data(pool_k).shape[1], _kv_data(pool_k).shape[2]
    mb = tables.shape[1]
    s_tot = mb * bs
    lens = np.asarray(lens, np.int64)
    app_mask = np.asarray(app_mask, np.int64)
    # append coordinates (host): masked rows, rows past capacity and
    # unmapped table entries do not write
    bi = np.minimum(lens // bs, mb - 1)
    phys = tables[np.arange(R), bi].astype(np.int64)
    live = (app_mask > 0) & (lens < s_tot) & (phys < nb)
    rows_w = torch.from_numpy(np.flatnonzero(live)).to(dev)
    phys_w = torch.from_numpy(phys[live]).to(dev)
    prow_w = torch.from_numpy((lens % bs)[live]).to(dev)
    pidx = torch.from_numpy(np.clip(lens, 0, s_tot - 1)).to(dev)
    sin_r, cos_r = sin[pidx], cos[pidx]
    att_len = torch.from_numpy((lens + app_mask).astype(np.int32)).to(dev)

    def write(l, k, v, s):
        _kv_write(_kv_layer(pool_k[s], l), phys_w, prow_w, k[rows_w])
        _kv_write(_kv_layer(pool_v[s], l), phys_w, prow_w, v[rows_w])

    h = decode_layers(
        params, _embed(params, tok[:, None]), sin_r, cos_r,
        _kv_data(pool_k).shape[0], write,
        lambda l, q, s: _paged_attend(paged_fn, q, _kv_layer(pool_k[s], l),
                                      _kv_layer(pool_v[s], l), tables_dev,
                                      att_len),
        nh=nh, nkv=nkv, hd=hd, eps=eps, a8=a8, tp_reduce=tp_reduce)
    last_h = _rms(h[:, 0], params[0]["final_norm"], eps)
    logits = _head_logits(last_h, head)
    carry, draw = _split_rows(kys)
    nxt = sample_rows(logits, draw, temps, top_ks)
    if return_logits:
        return nxt, pool_k, pool_v, carry, logits.float()
    return nxt, pool_k, pool_v, carry


def _span_last_sample(params, head, x, qstart, qlen, keys, temps, top_ks,
                      eps):
    """Tick 0's per-slot sample from its span's LAST packed position
    (decode rows: the one token; chunk rows: the chunk end). Returns
    ``(tok0 [R] device, keys' [R, 2] host)`` after one split per row."""
    T = x.shape[1]
    last_idx = np.clip(_host(qstart) + _host(qlen) - 1, 0, T - 1)
    last = x[0, torch.from_numpy(last_idx).to(x.device)]    # [R, H]
    last_h = _rms(last, params[0]["final_norm"], eps)
    logits = _head_logits(last_h, head)
    carry, draw = _split_rows(keys)
    return sample_rows(logits, draw, temps, top_ks), carry


def _packed_span_forward(params, pool_k, pool_v, tables, tables_dev, ids,
                         seg, pos, qstart, qlen, kvlen, sin, cos, *, nh,
                         nkv, hd, eps, decode_attn="pallas", a8=False,
                         tp_reduce=one_shard):
    """ONE forward pass over a packed buffer of variable-length query
    spans through the block tables (tick 0 of the unified step). K/V of
    every live packed token is written through its slot's table at its
    logical position — dead rows (``seg == R``), positions past the
    logical capacity and unmapped table entries do not write — then
    attention runs through the ragged kernel (or its plain version), once
    a shard on its heads and its pool. Returns ``(x [1, T, H], pool_k,
    pool_v)``."""
    ragged_fn = _attn_fns(decode_attn)[2]
    dev = params[0]["embed"].device
    R, mb = tables.shape
    nb, bs = _kv_data(pool_k).shape[1], _kv_data(pool_k).shape[2]
    s_tot = mb * bs
    seg = _host(seg)
    pos = _host(pos)
    live_tok = seg < R
    seg_c = np.minimum(seg, R - 1)
    bi = np.minimum(pos // bs, mb - 1)
    phys0 = tables[seg_c, bi].astype(np.int64)
    live = live_tok & (pos < s_tot) & (phys0 < nb)
    rows_w = torch.from_numpy(np.flatnonzero(live)).to(dev)
    phys_w = torch.from_numpy(phys0[live]).to(dev)
    prow_w = torch.from_numpy((pos % bs)[live]).to(dev)
    pidx = torch.from_numpy(np.clip(pos, 0, s_tot - 1)).to(dev)
    sin_p, cos_p = sin[pidx][None], cos[pidx][None]         # [1, T, D]
    span = [torch.from_numpy(_host(a, np.int32)).to(dev)
            for a in (qstart, qlen, kvlen)]

    def core(l, q, k, v, s):
        q = _apply_rope_grid(q, sin_p, cos_p)
        k = _apply_rope_grid(k, sin_p, cos_p)
        pk_l = _kv_layer(pool_k[s], l)
        pv_l = _kv_layer(pool_v[s], l)
        _kv_write(pk_l, phys_w, prow_w, k[0, rows_w])
        _kv_write(pv_l, phys_w, prow_w, v[0, rows_w])
        kd, vd, ks, vs = _kv_attn_args(pk_l, pv_l)
        return ragged_fn(q[0], kd, vd, tables_dev, *span, k_scale=ks,
                         v_scale=vs)

    x = layer_stack(params, _embed(params, torch.as_tensor(
        _host(ids)).to(dev)[None]), _kv_data(pool_k).shape[0], core, nh=nh,
        nkv=nkv, hd=hd, eps=eps, a8=a8, tp_reduce=tp_reduce)
    return x, pool_k, pool_v


@torch.inference_mode()
def _ragged_step_impl(params, pool_k, pool_v, tables, ids, seg, pos,
                      qstart, qlen, kvlen, dec_mask, keys, temps, top_ks,
                      *, n_steps, nh, nkv, hd, eps, theta, tied,
                      fused=False, decode_attn="pallas", a8=False,
                      tp_reduce=one_shard):
    """THE unified serving step: one call that advances every slot's span
    — decode rows (span 1) and prefill chunks (span n) — through the same
    block tables.

    Packed layout (host arrays; shapes depend only on ``(num_slots,
    token_budget)``): ids/seg/pos [T] (``seg == R`` marks a dead packed
    row), qstart/qlen/kvlen [R] span metadata (``qlen == 0`` = idle
    slot), dec_mask [R] (1 = a running decode row whose tail-tick
    appends are real), keys [R, 2], temps [R], top_ks [R].

    Tick 0 runs the packed buffer through :func:`_packed_span_forward`
    and samples one token per slot from its span's last position; ticks
    ``1..n_steps-1`` are :func:`_fused_decode_tick` over the decode rows
    (with ``fused``, one fused-tick kernel launch each).

    Returns ``(pool_k, pool_v, toks [n_steps, R] (device), keys_t0,
    keys_fin)``: the pools are the given tensors, updated in place;
    ``toks[0]``/``keys_t0`` are tick 0's sample and advanced keys (what a
    final chunk row adopts), ``keys_fin`` the post-tail keys decode rows
    adopt (host int64 ``[R, 2]`` each).

    ``params`` and the pool sides are per-shard lists and ``nh``/``nkv`` a
    shard's heads: every layer loop runs its shards in lockstep
    (:func:`layer_stack`); the rest is replicated and runs once."""
    rp = params[0]
    dev = rp["embed"].device
    tables = _host(tables)
    s_tot = tables.shape[1] * _kv_data(pool_k).shape[2]
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    head = _dq_head(rp, tied, rp["embed"].dtype, a8)
    tables_dev = torch.from_numpy(tables.astype(np.int32)).to(dev)
    # ----------------------------------- tick 0 (shared packed forward)
    x, pool_k, pool_v = _packed_span_forward(
        params, pool_k, pool_v, tables, tables_dev, ids, seg, pos, qstart,
        qlen, kvlen, sin, cos, nh=nh, nkv=nkv, hd=hd, eps=eps,
        decode_attn=decode_attn, a8=a8, tp_reduce=tp_reduce)
    tok0, keys_t0 = _span_last_sample(params, head, x, qstart, qlen, keys,
                                      temps, top_ks, eps)
    # ------------------------------------------- fused tail (pure decode)
    dec_mask = _host(dec_mask)
    lens = np.where(dec_mask > 0, _host(kvlen), 0)
    toks, tok, kys = [tok0], tok0, keys_t0
    for _ in range(n_steps - 1):
        tok, pool_k, pool_v, kys = _fused_decode_tick(
            params, head, tables, tables_dev, sin, cos, tok, pool_k,
            pool_v, lens, kys, dec_mask, temps, top_ks, nh=nh, nkv=nkv,
            hd=hd, eps=eps, fused=fused, decode_attn=decode_attn, a8=a8,
            tp_reduce=tp_reduce)
        lens = lens + dec_mask
        toks.append(tok)
    return pool_k, pool_v, torch.stack(toks), keys_t0, _keys_host(kys)


# ------------------------------------------------- speculative verify step
@torch.inference_mode()
def _spec_verify_impl(params, pool_k, pool_v, tables, ids, seg, pos,
                      qstart, qlen, kvlen, sample_start, keys, temps,
                      top_ks, *, spec_len, nh, nkv, hd, eps, theta, tied,
                      decode_attn="pallas", a8=False, tp_reduce=one_shard):
    """THE speculative serving step: one call that scores every slot's
    draft-extended span — a verify row packs ``[last_token, d_1 .. d_k]``
    at positions ``len .. len+k``, a prefill chunk its prompt slice, both
    writing K/V through the block tables as tick 0 of
    :func:`_ragged_step_impl` does (the same :func:`_packed_span_forward`;
    a verify span of 2..k+1 rows is a chunk span to the ragged kernel) —
    then samples ``spec_len`` consecutive positions per row under the
    split-per-token key walk.

    Packed layout as in :func:`_ragged_step_impl`, plus ``sample_start``
    [R]: the packed row a row's walk starts at — a verify row its span
    START (position j scores the token after input j), a chunk row its
    span END (only its sample 0 is ever adopted). Reads clamp inside the
    span, so short spans repeat their last position and the host ignores
    the surplus.

    Walk step j: split every row's key, sample position j's logits with
    ``both[:, 1]``, carry ``both[:, 0]`` — ``spec_len`` sequential decode
    ticks' keys, so an accepted token was sampled with the key and logits
    sequential decode would have used.

    Returns ``(pool_k, pool_v, toks [spec_len, R] (device), keys_walk
    [spec_len, R, 2] (host))``: the pools updated in place; ``keys_walk[j]``
    each row's key after ``j + 1`` splits (a row that emits m tokens adopts
    ``keys_walk[m - 1]``)."""
    rp = params[0]
    dev = rp["embed"].device
    tables = _host(tables)
    R = tables.shape[0]
    s_tot = tables.shape[1] * _kv_data(pool_k).shape[2]
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    head = _dq_head(rp, tied, rp["embed"].dtype, a8)
    tables_dev = torch.from_numpy(tables.astype(np.int32)).to(dev)
    x, pool_k, pool_v = _packed_span_forward(
        params, pool_k, pool_v, tables, tables_dev, ids, seg, pos, qstart,
        qlen, kvlen, sin, cos, nh=nh, nkv=nkv, hd=hd, eps=eps,
        decode_attn=decode_attn, a8=a8, tp_reduce=tp_reduce)
    # spec_len consecutive packed rows from sample_start, clamped inside
    # the row's span (idle rows clamp to row 0: never read)
    T = x.shape[1]
    qs, ql = _host(qstart), _host(qlen)
    span_end = np.clip(qs + np.maximum(ql, 1) - 1, 0, T - 1)
    idx = np.clip(_host(sample_start)[:, None] + np.arange(spec_len)[None],
                  qs[:, None], span_end[:, None])            # [R, S]
    hsel = x[0, torch.from_numpy(idx.reshape(-1)).to(dev)]   # [R*S, H]
    logits = _head_logits(_rms(hsel, rp["final_norm"], eps), head)
    logits = logits.reshape(R, spec_len, -1)
    toks, walk, kys = [], [], keys
    for j in range(spec_len):
        kys, draw = _split_rows(kys)
        toks.append(sample_rows(logits[:, j], draw, temps, top_ks))
        walk.append(kys)
    return pool_k, pool_v, torch.stack(toks), torch.stack(walk)


# ------------------------------------------------------ dense-slot decode
@torch.inference_mode()
def _decode_steps_impl(params, cache_k, cache_v, tokens, lengths, keys,
                       temps, top_ks, *, n_steps, nh, nkv, hd, eps, theta,
                       tied, decode_attn="pallas"):
    """``n_steps`` single-token decode ticks over every slot of the dense
    cache (the ``paged_attn=False`` engine's program).

    cache_k/cache_v [L, B, S_max, Hkv, D] (written in place); tokens [B]
    each slot's last token; lengths [B] valid rows per slot; keys [B, 2],
    temps [B], top_ks [B] (host). Each tick appends each row's K/V at its
    own length — a row at ``S_max`` drops its write, as JAX's scatter
    does — then attends over ``lengths + 1`` through
    :func:`~paddle_tpu_torch.kernels.decode.decode_attention` (its plain
    version while ``FLAGS_use_cuda_kernels`` is off), then the final norm,
    the lm head, one key split and one sample per row.

    Returns ``(toks [n_steps, B] (device), cache_k, cache_v, keys' [B, 2]
    (host))``."""
    dense_fn = _attn_fns(decode_attn)[3]
    embed = params[0]["embed"]
    dev = embed.device
    s_max = cache_k.shape[2]
    sin, cos = _rope_tables(s_max, hd, theta, device=dev)
    head = _dq_head(params[0], tied, embed.dtype)
    tok = torch.as_tensor(_host(tokens)).to(dev)
    lens = _host(lengths)
    kys = keys
    toks = []
    for _ in range(n_steps):
        rows = np.flatnonzero(lens < s_max)
        rows_w = torch.from_numpy(rows).to(dev)
        pos_w = torch.from_numpy(lens[rows]).to(dev)
        pidx = torch.from_numpy(np.clip(lens, 0, s_max - 1)).to(dev)
        sin_r, cos_r = sin[pidx], cos[pidx]
        att_len = torch.from_numpy((lens + 1).astype(np.int32)).to(dev)

        def write(l, k, v, s, rows=rows, rows_w=rows_w, pos_w=pos_w):
            if rows.size:
                cache_k[l, rows_w, pos_w] = k[rows_w]
                cache_v[l, rows_w, pos_w] = v[rows_w]

        h = decode_layers(
            params, _embed(params, tok[:, None]), sin_r, cos_r,
            cache_k.shape[0], write,
            lambda l, q, s, att_len=att_len: dense_fn(q, cache_k[l],
                                                      cache_v[l], att_len),
            nh=nh, nkv=nkv, hd=hd, eps=eps)
        last_h = _rms(h[:, 0], params[0]["final_norm"], eps)
        logits = last_h @ head
        kys, draw = _split_rows(kys)
        tok = sample_rows(logits, draw, temps, top_ks)
        toks.append(tok)
        lens = lens + 1
    return torch.stack(toks), cache_k, cache_v, kys


# ------------------------------------------------------------ suffix prefill
def _suffix_attention(q, kc, vc, pos, valid_to, nkv, ksr=None, vsr=None):
    """The suffix programs' attention (plain PyTorch, as the JAX programs
    compute it with ``jnp.einsum`` outside any kernel): query column i of
    row g sits at global position ``pos[g, i]`` and sees cache rows
    ``r <= pos``; rows at or past ``valid_to[g]`` may hold another
    sequence's garbage and are zeroed out of PV (0 * NaN = NaN).

    q [G, S, nh, D]; kc/vc [G, s_rows, Hkv, D] each row's logical cache
    after this call's writes; pos [G, S] and valid_to [G] on q's device.
    Returns [G, S, nh, D]. The logits are float32 ``[G, nh, S, s_rows]``:
    the peak of the program.

    The callers gather ``s_rows`` = the rows up to the last one any live
    row's query can see (:func:`_visible_rows`), not the whole cache: every
    row past it is masked for every live row, so its exp is an exact 0 in
    the softmax and it adds exact zeros to PV — the same values as JAX's
    attention over the full table, without paying for it on a long
    cache.

    A quantized pool's rows arrive narrow, with their scales ``ksr`` /
    ``vsr [G, s_rows, Hkv]``: the K scales multiply the logits after the
    dot, the V scales the probabilities after the softmax, as the
    reference's suffix program does."""
    nh, D = q.shape[2], q.shape[3]
    grp = nh // nkv
    kc, vc = kc.to(q.dtype), vc.to(q.dtype)      # int8 / e4m3: exact
    kf = kc.repeat_interleave(grp, dim=2) if grp > 1 else kc
    vf = vc.repeat_interleave(grp, dim=2) if grp > 1 else vc
    rows = torch.arange(kc.shape[1], device=q.device)
    mask = (rows[None, None, :] <= pos[:, :, None])[:, None]  # [G,1,S,s]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kf.float()) * (1.0 / (D ** 0.5))
    if ksr is not None:
        logits = logits * _row_scale_bhqk(ksr, grp)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    if vsr is not None:
        probs = probs * _row_scale_bhqk(vsr, grp)
    row_valid = rows[None, :] < valid_to[:, None]
    vf = torch.where(row_valid[:, :, None, None], vf, torch.zeros_like(vf))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), vf)


def _visible_rows(prefix, S, live, cap, unit):
    """Cache rows the suffix attention gathers: up to the last position a
    live row's query sits at (``prefix + S`` at most), rounded up to
    ``unit`` and capped at ``cap``. Padding rows (``live`` False) carry a
    fully covered prefix and see whatever is gathered."""
    vis = int((prefix + S)[live].max()) if live.any() else cap
    return min(-(-vis // unit) * unit, cap)


def _suffix_forward(params, ids, sin_p, cos_p, n_layers, write, gather,
                    pos, valid_to, suffix_lens, keys, temps, top_ks, *, nh,
                    nkv, hd, eps, tied, a8=False, tp_reduce=one_shard):
    """The suffix programs' shared forward: per layer RMSNorm → QKV →
    RoPE at each column's position → ``write(l, k, v, s)`` (``[G, S,
    Hkv, D]`` into the caller's cache; ``s`` the shard) →
    ``gather(l, s)`` (each row's visible cache after the writes, and its
    scales or None) → :func:`_suffix_attention` → O-proj → SwiGLU; then
    each row's sample from its last real suffix column, after one key
    split. Returns ``(tok0 [G] device, keys' [G, 2] host)``."""
    G = ids.shape[0]

    def core(l, q, k, v, s):
        q = _apply_rope_grid(q, sin_p, cos_p)
        k = _apply_rope_grid(k, sin_p, cos_p)
        write(l, k, v, s)
        (kc, ksr), (vc, vsr) = gather(l, s)
        return _suffix_attention(q, kc, vc, pos, valid_to, nkv, ksr, vsr)

    x = layer_stack(params, _embed(params, ids), n_layers, core, nh=nh,
                    nkv=nkv, hd=hd, eps=eps, a8=a8, tp_reduce=tp_reduce)
    rp = params[0]
    last = x[torch.arange(G, device=x.device),
             torch.from_numpy(_host(suffix_lens) - 1).to(x.device)]
    logits = _head_logits(_rms(last, rp["final_norm"], eps),
                          _dq_head(rp, tied, x.dtype, a8))
    carry, draw = _split_rows(keys)
    return sample_rows(logits, draw, temps, top_ks), carry


@torch.inference_mode()
def _suffix_prefill_impl(params, cache_k, cache_v, slots, prefix_lens, ids,
                         suffix_lens, keys, temps, top_ks, *, nh, nkv, hd,
                         eps, theta, tied, decode_attn="pallas"):
    """Prefill only the UNCOVERED suffix of prompts whose leading rows a
    prefix-cache hit copied into their slots (the dense engine).

    ids [G, S_pad] right-padded suffix ids; prefix_lens [G] rows already
    valid in each row's slot; suffix_lens [G] real suffix lengths; slots
    [G] slot indices (padding rows carry ``num_slots``: nothing of theirs
    is written). Column i of row g lives at position ``prefix_lens[g] +
    i``: its K/V is written into the slot there (every column of a live
    row whose position fits the cache, padding included, as JAX's scatter
    does; rows past the length are masked until decode overwrites them)
    and its query attends rows ``0..pos``. Returns ``(cache_k, cache_v,
    tok0, keys')``, the caches written in place."""
    dev = params[0]["embed"].device
    ids = torch.as_tensor(_host(ids)).to(dev)
    G, S = ids.shape
    num_slots, s_max = cache_k.shape[1], cache_k.shape[2]
    sin, cos = _rope_tables(s_max, hd, theta, device=dev)
    slots = _host(slots)
    prefix = _host(prefix_lens)
    pos = prefix[:, None] + np.arange(S)[None, :]
    pidx = torch.from_numpy(np.clip(pos, 0, s_max - 1)).to(dev)
    sin_p, cos_p = sin[pidx], cos[pidx]                     # [G, S, D]
    gi, ci = np.nonzero((slots < num_slots)[:, None] & (pos < s_max))
    w_slot = torch.from_numpy(slots[gi]).to(dev)
    w_pos = torch.from_numpy(pos[gi, ci]).to(dev)
    w_g, w_c = torch.from_numpy(gi).to(dev), torch.from_numpy(ci).to(dev)
    # padding rows read the last slot (harmless) and write nothing
    rd = torch.from_numpy(np.minimum(slots, num_slots - 1)).to(dev)
    vis = _visible_rows(prefix, S, slots < num_slots, s_max, 1)

    def write(l, k, v, s):
        if gi.size:
            cache_k[l, w_slot, w_pos] = k[w_g, w_c]
            cache_v[l, w_slot, w_pos] = v[w_g, w_c]

    tok0, carry = _suffix_forward(
        params, ids, sin_p, cos_p, cache_k.shape[0], write,
        lambda l, s: ((cache_k[l, rd, :vis], None),
                      (cache_v[l, rd, :vis], None)),
        torch.from_numpy(pos).to(dev), torch.from_numpy(prefix + S).to(dev),
        suffix_lens, keys, temps, top_ks, nh=nh, nkv=nkv, hd=hd, eps=eps,
        tied=tied)
    return cache_k, cache_v, tok0, carry


@torch.inference_mode()
def _paged_suffix_prefill_impl(params, pool_k, pool_v, tables, prefix_lens,
                               ids, suffix_lens, keys, temps, top_ks, *,
                               nh, nkv, hd, eps, theta, tied,
                               decode_attn="pallas", a8=False,
                               tp_reduce=one_shard):
    """The suffix prefill through per-row block tables (the paged engine's
    prefix hits, and the two-program engine's chunked-prefill program: a
    chunk is a "suffix" whose ``prefix_lens`` is the host resume offset).

    tables [G, max_blocks] (sentinel ``num_blocks`` marks unmapped
    entries and padding rows). Column i of row g lands at logical
    position ``prefix_lens[g] + i``, physical ``(tables[g, pos // bs], pos
    % bs)`` — a block the row owns privately, since the covered prefix is
    block-aligned. Only real columns (``i < suffix_lens[g]``) of mapped
    entries are written; the shared prefix blocks are read through the
    same table and never written. Returns ``(pool_k, pool_v, tok0,
    keys')``, the pools written in place. On a quantized pool the suffix
    rows quantize on write and the attention reads the narrow rows, the
    scales applied after the dots (:func:`_kv_gather_rows`). Every shard
    writes and reads its own pool."""
    dev = params[0]["embed"].device
    ids = torch.as_tensor(_host(ids)).to(dev)
    G, S = ids.shape
    nb, bs = _kv_data(pool_k).shape[1], _kv_data(pool_k).shape[2]
    tables = _host(tables)
    mb = tables.shape[1]
    s_tot = mb * bs
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    prefix = _host(prefix_lens)
    pos = prefix[:, None] + np.arange(S)[None, :]
    pidx = torch.from_numpy(np.clip(pos, 0, s_tot - 1)).to(dev)
    sin_p, cos_p = sin[pidx], cos[pidx]
    bi = np.minimum(pos // bs, mb - 1)
    phys = np.take_along_axis(tables, bi, axis=1)
    phys = np.where(np.arange(S)[None, :] < _host(suffix_lens)[:, None],
                    phys, nb)
    gi, ci = np.nonzero(phys < nb)
    w_phys = torch.from_numpy(phys[gi, ci]).to(dev)
    w_row = torch.from_numpy((pos % bs)[gi, ci]).to(dev)
    w_g, w_c = torch.from_numpy(gi).to(dev), torch.from_numpy(ci).to(dev)
    vis = _visible_rows(prefix, S, prefix < s_tot, s_tot, bs)
    rd = torch.from_numpy(np.clip(tables[:, :vis // bs], 0, nb - 1)).to(dev)
    shape = (G, vis) + tuple(_kv_data(pool_k).shape[3:])

    def write(l, k, v, s):
        _kv_write(_kv_layer(pool_k[s], l), w_phys, w_row, k[w_g, w_c])
        _kv_write(_kv_layer(pool_v[s], l), w_phys, w_row, v[w_g, w_c])

    tok0, carry = _suffix_forward(
        params, ids, sin_p, cos_p, _kv_data(pool_k).shape[0], write,
        lambda l, s: (
            _kv_gather_rows(_kv_layer(pool_k[s], l), rd, shape),
            _kv_gather_rows(_kv_layer(pool_v[s], l), rd, shape)),
        torch.from_numpy(pos).to(dev), torch.from_numpy(prefix + S).to(dev),
        suffix_lens, keys, temps, top_ks, nh=nh, nkv=nkv, hd=hd, eps=eps,
        tied=tied, a8=a8, tp_reduce=tp_reduce)
    return pool_k, pool_v, tok0, carry


# ------------------------------------------------------- paged decode step
@torch.inference_mode()
def _paged_decode_steps_impl(params, pool_k, pool_v, tables, tokens,
                             lengths, keys, temps, top_ks, *, n_steps, nh,
                             nkv, hd, eps, theta, tied, decode_attn="pallas"):
    """``n_steps`` single-token ticks over every slot of the paged pool
    (the two-program engine's decode program), on the paged decode
    kernel (its plain version while ``FLAGS_use_cuda_kernels`` is off).

    tables [B, max_blocks] (sentinel tables on free slots drop their
    appends); tokens/lengths/keys/temps/top_ks as in
    :func:`_decode_steps_impl`. The engine pre-grows every running slot's
    table to cover ``lengths + n_steps`` rows, and hands a mid-prefill
    slot a length past the capacity, so its append drops. Each tick is
    :func:`_fused_decode_tick` with every row appending. Returns ``(toks
    [n_steps, B] (device), pool_k, pool_v, keys' [B, 2] (host))``."""
    dev = params[0]["embed"].device
    tables = _host(tables)
    s_tot = tables.shape[1] * _kv_data(pool_k).shape[2]
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    head = _dq_head(params[0], tied, params[0]["embed"].dtype)
    tables_dev = torch.from_numpy(tables.astype(np.int32)).to(dev)
    tok = torch.as_tensor(_host(tokens)).to(dev)
    lens = _host(lengths)
    every = np.ones_like(lens)
    kys = keys
    toks = []
    for _ in range(n_steps):
        tok, pool_k, pool_v, kys = _fused_decode_tick(
            params, head, tables, tables_dev, sin, cos, tok, pool_k, pool_v,
            lens, kys, every, temps, top_ks, nh=nh, nkv=nkv, hd=hd, eps=eps,
            decode_attn=decode_attn)
        toks.append(tok)
        lens = lens + 1
    return torch.stack(toks), pool_k, pool_v, _keys_host(kys)


# ------------------------------------------------------- multi-tick decode
def _key_walk(keys_t0, max_ticks, n):
    """The tail's key walk on the host (``core/random.py``, bit for bit
    jax's): ``walk[t]`` the key after tick t, ``draws[t]`` tick t's
    sampling key, for t < n. Every row splits every tick, dead or alive,
    so the walk does not depend on the tokens."""
    R = keys_t0.shape[0]
    walk = np.zeros((max_ticks, R, 2), np.int64)
    draws = np.zeros((max_ticks, R, 2), np.int64)
    walk[0] = keys_t0.numpy()
    k = keys_t0
    for t in range(1, n):
        k, draw = _split_rows(k)
        walk[t], draws[t] = k.numpy(), draw.numpy()
    return walk, draws


@torch.inference_mode()
def _multitick_step_impl(params, pool_k, pool_v, tables, ids, seg, pos,
                         qstart, qlen, kvlen, dec_mask, keys, temps, top_ks,
                         eos_ids, budgets, n_ticks, *, max_ticks, nh, nkv,
                         hd, eps, theta, tied, fused=False,
                         decode_attn="pallas", a8=False, tp_reduce=one_shard,
                         tail=None):
    """THE multi-tick serving step: the unified step with the host out of
    the per-token loop.

    Tick 0 is :func:`_ragged_step_impl`'s packed forward verbatim (with
    ``fused``, when every span is a decode row, the fused tick instead: a
    host branch where JAX has ``lax.cond``). The tail then runs ``n_ticks
    - 1`` decode ticks under an on-device alive mask: a row retires on
    its EOS (``eos_ids``, -1 for none) or when its budget (``budgets`` =
    tokens it may still emit) is spent, as the host's ``_maybe_finish``
    would — a retired row's appends drop and its length freezes — so the
    host's trim after the step cuts exactly where the device stopped.

    The tail is :func:`.graphs.tail_tick` replayed from a captured CUDA
    graph on a card (``tail``, the engine's :class:`.graphs.TailGraphs`,
    with ``FLAGS_cuda_graph_tail`` on), eagerly elsewhere; with ``fused``
    and the kernels on a card, one fused-tick launch a tick with the
    alive state on the device. The tail always runs all ``n_ticks - 1``
    ticks: an early exit would need a sync a tick. After the step's ONE
    device-to-host copy, ``ticks_run`` is what JAX's ``while_loop``
    counts: 1 plus the tail ticks at whose start some row was alive.

    Returns ``(pool_k, pool_v, toks [max_ticks, R], keys_walk [max_ticks,
    R, 2], ticks_run)``: host tensors, row t the tokens and keys after
    tick t, rows from ``ticks_run`` on zero (the reference's contract).

    Under tensor parallelism (more than one shard) the graph captures the
    whole sharded tick: every shard's kernels and the reductions. A fused
    engine's ticks are then the scanned tick (:func:`_fused_decode_tick`),
    as in the reference."""
    rp = params[0]
    dev = rp["embed"].device
    tables = _host(tables)
    R, mb = tables.shape
    nb, bs = _kv_data(pool_k).shape[1], _kv_data(pool_k).shape[2]
    s_tot = mb * bs
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    head = _dq_head(rp, tied, rp["embed"].dtype, a8)
    tables_dev = torch.from_numpy(tables.astype(np.int32)).to(dev)
    dec, kv = _host(dec_mask), _host(kvlen)
    qs, ql = _host(qstart), _host(qlen)
    n = int(n_ticks)
    # ----------------------------------- tick 0 (shared packed forward)
    if fused and not ((ql > 0) & (dec == 0)).any():
        # no chunk row: tick 0 is the fused tick over the decode rows
        tok_in = torch.from_numpy(
            _host(ids)[np.maximum(qs + ql - 1, 0)]).to(dev)
        tok0, pool_k, pool_v, keys_t0 = _fused_decode_tick(
            params, head, tables, tables_dev, sin, cos, tok_in, pool_k,
            pool_v, np.where(dec > 0, kv - 1, 0), keys, dec, temps, top_ks,
            nh=nh, nkv=nkv, hd=hd, eps=eps, fused=True,
            decode_attn=decode_attn, a8=a8, tp_reduce=tp_reduce)
        keys_t0 = _keys_host(keys_t0)
    else:
        x, pool_k, pool_v = _packed_span_forward(
            params, pool_k, pool_v, tables, tables_dev, ids, seg, pos,
            qstart, qlen, kvlen, sin, cos, nh=nh, nkv=nkv, hd=hd, eps=eps,
            decode_attn=decode_attn, a8=a8, tp_reduce=tp_reduce)
        tok0, keys_t0 = _span_last_sample(params, head, x, qstart, qlen,
                                          keys, temps, top_ks, eps)
    # --------------------------------- tail (alive-masked, n_ticks - 1)
    lens0 = np.where(dec > 0, kv, 0)
    eos, bud = _host(eos_ids), _host(budgets)
    walk, draws = _key_walk(keys_t0, max_ticks, n)
    parts = [tok0]
    if n > 1:
        alive0 = (torch.from_numpy(dec > 0).to(dev)
                  & (tok0 != torch.from_numpy(eos).to(dev))
                  & torch.from_numpy(bud > 1).to(dev))
        kernels = get_flag("FLAGS_use_cuda_kernels") \
            and decode_attn == "pallas"
        if fused and not a8 and len(params) == 1 and kernels \
                and dev.type == "cuda":
            toks, hist, kw = _fused_tail(
                params, head, tables, tables_dev, sin, cos, tok0, pool_k,
                pool_v, lens0, keys_t0, alive0, eos, bud, temps, top_ks, n,
                nh=nh, nkv=nkv, hd=hd, eps=eps)
            if tail is not None:
                tail.ticks += n - 1
            parts += [toks, hist, kw]
        else:
            parts += _scanned_tail(
                params, head, pool_k, pool_v, tables, tables_dev, sin, cos,
                tok0, lens0, dec, eos, bud, draws, alive0, temps, top_ks, n,
                max_ticks, tail, nh=nh, nkv=nkv, hd=hd, eps=eps,
                paged_fn=_attn_fns(decode_attn)[1], kernels=kernels, a8=a8,
                tp_reduce=tp_reduce)
    # ------------------------------------ the step's one device→host copy
    host = torch.cat([p.reshape(-1).long() for p in parts]).cpu().numpy()
    toks_h = np.zeros((max_ticks, R), np.int64)
    toks_h[:n] = host[:n * R].reshape(n, R)
    alive_any = host[n * R:(2 * n - 1) * R].reshape(n - 1, R).any(axis=1)
    if len(parts) == 4:                 # the fused tail: the kernel's keys
        walk[1:n] = host[(2 * n - 1) * R:].reshape(n - 1, R, 2) & 0xFFFFFFFF
    ticks_run = 1 + int(alive_any.sum())
    toks_h[ticks_run:] = 0
    walk[ticks_run:] = 0
    return (pool_k, pool_v, torch.from_numpy(toks_h),
            torch.from_numpy(walk), ticks_run)


def _scanned_tail(params, head, pool_k, pool_v, tables, tables_dev, sin, cos,
                  tok0, lens0, dec, eos, bud, draws, alive0, temps, top_ks,
                  n, max_ticks, tail, *, nh, nkv, hd, eps, paged_fn,
                  kernels, a8=False, tp_reduce=one_shard):
    """``n - 1`` ticks of :func:`.graphs.tail_tick`: on the engine's
    captured graph (``tail`` on a card with ``FLAGS_cuda_graph_tail``),
    else eagerly. Returns device ``[toks [n-1, R], alive at each tick's
    start [n-1, R]]``."""
    dev = tok0.device
    R, mb = tables.shape
    data = _kv_data(pool_k)
    nb, bs = data.shape[1], data.shape[2]
    greedy = not (np.asarray(temps, np.float32) > 0).any()
    key = (R, mb, str(data.dtype), greedy, kernels, max_ticks,
           data.data_ptr(), a8)

    def make():
        return graphs.TailState(R, mb, max_ticks, sin, cos, greedy, dev)

    st = tail.state(key, make) if tail is not None else make()
    block, row = graphs.trash_coord(tables, nb, bs, lens0, dec, n)
    meta = np.concatenate([lens0, eos, bud, [block * bs + row],
                           draws.reshape(-1)]).astype(np.int64)
    V = params[0]["embed"].shape[0]
    st.load(tok0, tables_dev, torch.from_numpy(meta).to(dev),
            sampling_args(temps, top_ks, V, dev), alive0)

    def tick():
        graphs.tail_tick(params, head, pool_k, pool_v, st, nh=nh, nkv=nkv,
                         hd=hd, eps=eps, paged_fn=paged_fn, a8=a8,
                         tp_reduce=tp_reduce)

    if tail is not None:
        tail.run(key, n - 1, tick, graph=graphs.use_graph(dev))
    else:
        for _ in range(n - 1):
            tick()
    return [st.toks[1:n], st.alive_hist[1:n]]


def _fused_tail(params, head, tables, tables_dev, sin, cos, tok0, pool_k,
                pool_v, lens0, keys_t0, alive0, eos, bud, temps, top_ks, n,
                *, nh, nkv, hd, eps):
    """The fused engine's tail on a card: ``n - 1`` fused-tick launches,
    the lengths, alive mask, last tokens and keys kept on the device (the
    kernel splits each row's key itself). Returns device ``(toks [n-1, R],
    alive at each tick's start [n-1, R], keys after each tick [n-1, R,
    2])``."""
    dev = tok0.device
    lens = torch.from_numpy(lens0).to(dev)
    eos_d = torch.from_numpy(eos).to(dev)
    bud_d = torch.from_numpy(bud).to(dev)
    tk_d = torch.from_numpy(np.asarray(top_ks, np.int32)).to(dev)
    tp_d = torch.from_numpy(np.asarray(temps, np.float32)).to(dev)
    tok, alive, kys = tok0, alive0, keys_t0
    (p,), (pk,), (pv,) = params, pool_k, pool_v      # one shard
    toks, hist, kw = [], [], []
    for t in range(1, n):
        tok, pk, pv, kys = fused_decode_tick(
            p, head, tables, tables_dev, sin, cos, tok, pk, pv, lens, kys,
            alive, tp_d, tk_d, nh=nh, nkv=nkv, hd=hd, eps=eps)
        hist.append(alive)
        toks.append(tok)
        kw.append(kys)
        lens = lens + alive
        alive = alive & (tok != eos_d) & (t + 1 < bud_d)
    return torch.stack(toks), torch.stack(hist), torch.stack(kw)
