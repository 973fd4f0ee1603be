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
  decode ticks over a :class:`~.kv_cache.SlotKVCache`.

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
  logits' device.
- The model's parameters are trainable, so both programs run under
  ``torch.inference_mode()``: serving records no autograd graph.

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


# The projections are plain matmuls on dense weights — the dense branches
# of the JAX package's ``_qkv_proj``/``_swiglu_proj``/``_o_proj``/
# ``_head_logits`` (``models.llama._qkv_bshd`` / ``_swiglu_raw`` and
# ``x @ w``); the quantized branches are not ported yet.
def _head(params, tied):
    return params["lm_head"].T if tied else params["lm_head"]


def _layer(params, l):
    return tuple(params[k][l] for k in STACK_KEYS)


def _kv_write(pool_l, phys, row, x):
    """Write K/V rows ``x [n, Hkv, D]`` into one layer's pool slice at
    ``(phys, row)``, in place. The caller passes live rows only (the
    port's form of JAX's drop-mode scatter, module docstring)."""
    if phys.numel():
        pool_l[phys, row] = x


def _apply_rope_rows(x, sin_p, cos_p):
    """Rope with a different position per batch row (ragged decode).
    x: [B, 1, H, D]; sin_p/cos_p: [B, D] taken at each row's position."""
    return (x * cos_p[:, None, None, :]
            + _rotate_half(x) * sin_p[:, None, None, :]).to(x.dtype)


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
    device."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0.0).any():
        return greedy
    dev = logits.device
    V = logits.shape[-1]
    t = torch.from_numpy(np.maximum(temps, np.float32(1e-6))).to(dev)
    lg = logits.float() / t[:, None]
    tk = np.asarray(top_ks, np.int64)
    k_eff = np.clip(np.where(tk <= 0, V, tk), 1, V)
    srt = torch.sort(lg, dim=-1).values      # ascending: kth = srt[V - k]
    kth = torch.gather(srt, 1, torch.from_numpy(V - k_eff).to(dev)[:, None])
    lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    sampled = prng.categorical(_keys_host(keys).to(dev), lg)
    return torch.where(torch.from_numpy(temps > 0.0).to(dev), sampled,
                       greedy)


def _split_rows(keys):
    """One ``jax.random.split`` per row: ``(carry [R, 2], draw [R, 2])``."""
    both = prng.split(_keys_host(keys))
    return both[:, 0], both[:, 1]


# ------------------------------------------------------------------ prefill
@torch.inference_mode()
def _prefill_impl(params, ids, lengths, keys, temps, top_ks, *, nh, nkv, hd,
                  eps, theta, tied, decode_attn="pallas"):
    """Batched cold prefill: ids [G, S_pad] right-padded prompts, lengths
    [G] real token counts, per-row keys/temps/top_ks (host arrays).

    Returns ``(pk, pv, tok0, keys')``: pk/pv ``[L, G, S_pad, Hkv, D]``
    (padding positions hold garbage the cache write never installs),
    tok0 ``[G]`` on the device, keys' ``[G, 2]`` on the host."""
    attn_fn = _attn_fns(decode_attn)[0]
    embed = params["embed"]
    dev = embed.device
    ids = torch.as_tensor(_host(ids)).to(dev)
    G, S = ids.shape
    L = params["wq"].shape[0]
    sin, cos = _rope_tables(S, hd, theta, device=dev)
    h = embed[ids]
    pk, pv = [], []
    for l in range(L):
        lwq, lwk, lwv, lwo, lg, lu, ld, lin, lpost = _layer(params, l)
        hn = _rms(h, lin, eps)
        q, k, v = _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)
        q = _apply_rope(q, sin, cos)
        k = _apply_rope(k, sin, cos)
        attn = attn_fn(q, k, v, causal=True)
        h = h + attn.reshape(G, S, nh * hd) @ lwo
        h = h + _swiglu_raw(_rms(h, lpost, eps), lg, lu, ld)
        pk.append(k)
        pv.append(v)
    last_idx = torch.as_tensor(_host(lengths) - 1).to(dev)
    last = h[torch.arange(G, device=dev), last_idx]           # [G, H]
    last_h = _rms(last, params["final_norm"], eps)
    logits = last_h @ _head(params, tied)
    carry, draw = _split_rows(keys)
    tok0 = sample_rows(logits, draw, temps, top_ks)
    return torch.stack(pk), torch.stack(pv), tok0, carry


# ------------------------------------------------------ unified ragged step
def _fused_decode_tick(params, head, tables, tables_dev, sin, cos, tok,
                       pool_k, pool_v, lens, kys, app_mask, temps, top_ks,
                       *, nh, nkv, hd, eps, fused=False, attn=None,
                       return_logits=False, decode_attn="pallas"):
    """ONE decode tick over all rows: embed the last tokens, per layer
    RMSNorm → QKV → RoPE at each row's length → append K/V through the
    tables (rows with ``app_mask == 0`` or past capacity do not append) →
    paged attention over ``lens + app_mask`` → O-proj → SwiGLU; then the
    final norm, the lm head, one key split and one sample per row.

    tok [R] on the device; tables [R, mb] numpy (and ``tables_dev``, the
    same as an int32 device tensor); lens/app_mask [R] numpy; kys [R, 2]
    host keys. Returns ``(next_tok, pool_k, pool_v, keys')`` (and the
    logits with ``return_logits``); the caller advances ``lens`` by
    ``app_mask``.

    ``fused=True`` (the engine's ``fused_tick`` knob) hands the whole
    tick to ``kernels/fused_decode_tick.py``: ONE kernel launch on CUDA
    tensors (its plain version, this scanned tick, on CPU tensors or with
    ``FLAGS_use_cuda_kernels`` off). ``attn`` overrides the paged
    attention of the scanned tick (the fused tick's plain version passes
    the plain one)."""
    if fused:
        return _attn_fns(decode_attn)[4](
            params, head, tables, tables_dev, sin, cos, tok, pool_k, pool_v,
            lens, kys, app_mask, temps, top_ks, nh=nh, nkv=nkv, hd=hd,
            eps=eps, return_logits=return_logits)
    paged_fn = attn or _attn_fns(decode_attn)[1]
    dev = tok.device
    R = tok.shape[0]
    nb, bs = pool_k.shape[1], pool_k.shape[2]
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
    h = params["embed"][tok[:, None]]                       # [R, 1, H]
    for l in range(pool_k.shape[0]):
        lwq, lwk, lwv, lwo, lg, lu, ld, lin, lpost = _layer(params, l)
        hn = _rms(h, lin, eps)
        q, k, v = _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)
        q = _apply_rope_rows(q, sin_r, cos_r)
        k = _apply_rope_rows(k, sin_r, cos_r)
        _kv_write(pool_k[l], phys_w, prow_w, k[rows_w, 0])
        _kv_write(pool_v[l], phys_w, prow_w, v[rows_w, 0])
        attn = paged_fn(q[:, 0], pool_k[l], pool_v[l], tables_dev, att_len)
        h = h + attn.reshape(R, 1, nh * hd) @ lwo
        h = h + _swiglu_raw(_rms(h, lpost, eps), lg, lu, ld)
    last_h = _rms(h[:, 0], params["final_norm"], eps)
    logits = last_h @ head
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
    last_h = _rms(last, params["final_norm"], eps)
    logits = last_h @ head
    carry, draw = _split_rows(keys)
    return sample_rows(logits, draw, temps, top_ks), carry


def _packed_span_forward(params, pool_k, pool_v, tables, tables_dev, ids,
                         seg, pos, qstart, qlen, kvlen, sin, cos, *, nh,
                         nkv, hd, eps, decode_attn="pallas"):
    """ONE forward pass over a packed buffer of variable-length query
    spans through the block tables (tick 0 of the unified step). K/V of
    every live packed token is written through its slot's table at its
    logical position — dead rows (``seg == R``), positions past the
    logical capacity and unmapped table entries do not write — then
    attention runs through the ragged kernel (or its plain version).
    Returns ``(x [1, T, H], pool_k, pool_v)``."""
    ragged_fn = _attn_fns(decode_attn)[2]
    dev = params["embed"].device
    R, mb = tables.shape
    nb, bs = pool_k.shape[1], pool_k.shape[2]
    s_tot = mb * bs
    seg = _host(seg)
    pos = _host(pos)
    T = seg.shape[0]
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
    x = params["embed"][torch.as_tensor(_host(ids)).to(dev)[None]]
    for l in range(pool_k.shape[0]):
        lwq, lwk, lwv, lwo, lg, lu, ld, lin, lpost = _layer(params, l)
        hn = _rms(x, lin, eps)
        q, k, v = _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)
        q = _apply_rope_grid(q, sin_p, cos_p)
        k = _apply_rope_grid(k, sin_p, cos_p)
        _kv_write(pool_k[l], phys_w, prow_w, k[0, rows_w])
        _kv_write(pool_v[l], phys_w, prow_w, v[0, rows_w])
        attn = ragged_fn(q[0], pool_k[l], pool_v[l], tables_dev, *span)
        x = x + attn.reshape(1, T, nh * hd) @ lwo
        x = x + _swiglu_raw(_rms(x, lpost, eps), lg, lu, ld)
    return x, pool_k, pool_v


@torch.inference_mode()
def _ragged_step_impl(params, pool_k, pool_v, tables, ids, seg, pos,
                      qstart, qlen, kvlen, dec_mask, keys, temps, top_ks,
                      *, n_steps, nh, nkv, hd, eps, theta, tied,
                      fused=False, decode_attn="pallas"):
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
    adopt (host int64 ``[R, 2]`` each)."""
    dev = params["embed"].device
    tables = _host(tables)
    s_tot = tables.shape[1] * pool_k.shape[2]
    sin, cos = _rope_tables(s_tot, hd, theta, device=dev)
    head = _head(params, tied)
    tables_dev = torch.from_numpy(tables.astype(np.int32)).to(dev)
    # ----------------------------------- tick 0 (shared packed forward)
    x, pool_k, pool_v = _packed_span_forward(
        params, pool_k, pool_v, tables, tables_dev, ids, seg, pos, qstart,
        qlen, kvlen, sin, cos, nh=nh, nkv=nkv, hd=hd, eps=eps,
        decode_attn=decode_attn)
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
            hd=hd, eps=eps, fused=fused, decode_attn=decode_attn)
        lens = lens + dec_mask
        toks.append(tok)
    return pool_k, pool_v, torch.stack(toks), keys_t0, _keys_host(kys)


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
    embed = params["embed"]
    dev = embed.device
    B = cache_k.shape[1]
    s_max = cache_k.shape[2]
    sin, cos = _rope_tables(s_max, hd, theta, device=dev)
    head = _head(params, tied)
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
        h = embed[tok[:, None]]                               # [B, 1, H]
        for l in range(cache_k.shape[0]):
            lwq, lwk, lwv, lwo, lg, lu, ld, lin, lpost = _layer(params, l)
            hn = _rms(h, lin, eps)
            q, k, v = _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)
            q = _apply_rope_rows(q, sin_r, cos_r)
            k = _apply_rope_rows(k, sin_r, cos_r)
            if rows.size:
                cache_k[l, rows_w, pos_w] = k[rows_w, 0]
                cache_v[l, rows_w, pos_w] = v[rows_w, 0]
            attn = dense_fn(q[:, 0], cache_k[l], cache_v[l], att_len)
            h = h + attn.reshape(B, 1, nh * hd) @ lwo
            h = h + _swiglu_raw(_rms(h, lpost, eps), lg, lu, ld)
        last_h = _rms(h[:, 0], params["final_norm"], eps)
        logits = last_h @ head
        kys, draw = _split_rows(kys)
        tok = sample_rows(logits, draw, temps, top_ks)
        toks.append(tok)
        lens = lens + 1
    return torch.stack(toks), cache_k, cache_v, kys
