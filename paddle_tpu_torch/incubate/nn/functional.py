"""Fused functional ops — the counterpart of
``paddle_tpu/incubate/nn/functional.py`` (Paddle's
``python/paddle/incubate/nn/functional/``).

Each is plain torch, as the JAX functions are jnp, with the same cast
points: the fused RoPE (neox halves or GPT-J pairs), the bias + dropout +
residual + LayerNorm epilogue (its mask one key of the key walk, so one
``seed`` gives the JAX package's mask; the norm in float32, cast back
before the scale and bias), the norms, linears, the attention and
feed-forward blocks, the variable-length attention and the one-token
``masked_multihead_attention`` over a ``[2, B, H, S_max, D]`` cache,
which it writes in place and returns, as Paddle's op updates
``cache_kv``. The flash entries and ``swiglu`` are ``nn.functional``'s
own functions: the port keeps one implementation of each.
"""
from __future__ import annotations

import math

import torch

from ...core import random as random_mod
from ...nn import functional as F
from ...nn.functional import (_where0, flash_attention,  # noqa: F401
                              flash_attn_qkvpacked, flash_attn_unpadded,
                              swiglu)
from ...ops import einsum, matmul, reshape
from ...ops._op import op

_NEG = -1e30


@op
def _rope_impl(q, k, v, sin, cos, use_neox):
    def rot(x):
        if use_neox:
            # neox style: rotate halves
            d = x.shape[-1]
            x1, x2 = x[..., : d // 2], x[..., d // 2:]
            rotated = torch.cat([-x2, x1], dim=-1)
        else:
            # GPT-J interleaved style
            x1, x2 = x[..., 0::2], x[..., 1::2]
            rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
        return x * cos + rotated * sin
    outs = tuple(rot(t) for t in (q, k, v) if t is not None)
    return outs if len(outs) > 1 else outs[0]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE over ``[batch, seq, heads, head_dim]`` q (and k, v). Without
    ``sin``/``cos`` the float32 tables are built for ``seq`` positions;
    2-D ``[seq, head_dim]`` tables broadcast; ``position_ids`` ``[B, S]``
    gathers their rows. Returns a 3-tuple, ``None`` for absent inputs."""
    if sin is None or cos is None:
        seq, dim = q.shape[1], q.shape[-1]
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=q.device) / dim))
        t = torch.arange(seq, dtype=torch.float32, device=q.device)
        freqs = torch.outer(t, inv)
        emb = (torch.cat([freqs, freqs], dim=-1) if use_neox_rotary_style
               else torch.repeat_interleave(freqs, 2, dim=-1))
        sin_v = torch.sin(emb)[None, :, None, :]
        cos_v = torch.cos(emb)[None, :, None, :]
    else:
        sin_v, cos_v = sin, cos
        if sin_v.dim() == 2:
            sin_v = sin_v[None, :, None, :]
            cos_v = cos_v[None, :, None, :]
    if position_ids is not None:
        pid = torch.as_tensor(position_ids, device=sin_v.device).long()
        sin_v = sin_v[0, :, 0][pid][:, :, None, :]
        cos_v = cos_v[0, :, 0][pid][:, :, None, :]
    outs = _rope_impl(q, k, v, sin_v, cos_v, use_neox_rotary_style)
    if sum(x is not None for x in (q, k, v)) == 1:
        return outs, None, None
    return tuple(list(outs) + [None] * (3 - len(outs)))


@op
def _fused_bias_dropout_residual_layer_norm(x, residual, bias, ln_scale,
                                            ln_bias, key, dropout_rate,
                                            ln_epsilon):
    h = x if bias is None else x + bias
    if key is not None:
        h = F._dropout_impl.raw_fn(h, key, dropout_rate, True)
    h = residual + h
    # the bodies of registered ops: one op casts once under AMP
    return F.layer_norm.raw_fn(h, h.shape[-1], ln_scale, ln_bias,
                               ln_epsilon)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """``LayerNorm(residual + dropout(x + bias))``, Paddle's fused
    epilogue; in training the mask takes one key of the key walk."""
    key = (random_mod.next_key() if training and dropout_rate > 0
           else None)
    return _fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_scale, ln_bias, key, float(dropout_rate),
        float(ln_epsilon))


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kwargs):
    out = F.rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis=1,
                     **kwargs):
    shape = tuple(x.shape[begin_norm_axis:])
    return F.layer_norm(x, shape, norm_weight, norm_bias, epsilon)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    out = matmul(x, weight, transpose_y=transpose_weight)
    if bias is not None:
        out = out + bias
    return out


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    out = matmul(x, y, transpose_x=trans_x, transpose_y=trans_y) + bias
    return getattr(F, activation)(out)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train"):
    return F.dropout(x, p=p, training=training, mode=mode) + y


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    out = matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    return out if bias is None else out + bias


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None):
    """The fused attention block: (pre-LN ->) qkv (weight ``[3, H, D,
    hidden]``) -> attention -> out projection -> bias + dropout +
    residual (-> post-LN)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention(cache_kv=...) decode path: use "
            "masked_multihead_attention (single-token) or the "
            "FusedMultiTransformer layer's cache plumbing")
    residual = x
    hidden = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, [hidden], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    qkv = einsum("bsh,tndh->bstnd", x, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        training=training)
    b, s = out.shape[0], out.shape[1]
    out = F.linear(reshape(out, [b, s, hidden]), linear_weight, None)
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [hidden], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1,
                      add_residual=True, name=None):
    """The fused feed-forward block: (pre-LN ->) linear1 -> activation ->
    dropout -> linear2 -> dropout (+ residual, -> post-LN)."""
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, [d], ln1_scale, ln1_bias, ln1_epsilon)
    h = F.linear(x, linear1_weight, linear1_bias)
    h = F.dropout(getattr(F, activation)(h), dropout1_rate,
                  training=training, mode=mode)
    h = F.linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, dropout2_rate, training=training, mode=mode)
    if add_residual:
        h = residual + h
    if not pre_layer_norm:
        h = F.layer_norm(h, [d], ln2_scale, ln2_bias, ln2_epsilon)
    return h


@op(name="incubate.varlen_mem_efficient_attention")
def _varlen_attention(q, k, v, qlen, klen, mask, scale, causal):
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qlen = qlen.reshape(B)     # Paddle documents a [batch, 1] shape
    klen = klen.reshape(B)
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sc
    neg = torch.full((), _NEG, dtype=logits.dtype, device=q.device)
    kv_valid = torch.arange(Sk, device=q.device)[None, None, None, :] \
        < klen[:, None, None, None]
    logits = torch.where(kv_valid, logits, neg)
    if causal:
        cm = torch.arange(Sq, device=q.device)[:, None] \
            >= torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(cm[None, None], logits, neg)
    if mask is not None:
        logits = logits + mask
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    q_valid = torch.arange(Sq, device=q.device)[None, None, :, None] \
        < qlen[:, None, None, None]
    return _where0(q_valid, out)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0,
                                               name=None):
    """Attention over ``[B, H, S, D]`` with per-row valid lengths
    (``[B]`` or ``[B, 1]``): keys past a row's length and, with
    ``causal``, future keys masked with -1e30 in float32 scores; query
    rows past the row's length are zero."""
    dev = query.device
    return _varlen_attention(query, key, value,
                             torch.as_tensor(seq_lens, device=dev),
                             torch.as_tensor(kv_seq_lens, device=dev), mask,
                             scale, bool(causal))


@op(name="incubate.masked_multihead_attention")
def _masked_mha(x, cache, mask, seq_lens):
    _, B, H, S_max, D = cache.shape
    qkv = x.reshape(B, 3, H, D)
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    step = seq_lens.reshape(B).long()
    bidx = torch.arange(B, device=x.device)
    # this step's k and v at each row's own position, in place
    with torch.no_grad():
        cache[0, bidx, :, step] = k_new.detach().to(cache.dtype)
        cache[1, bidx, :, step] = v_new.detach().to(cache.dtype)
    rows = torch.arange(S_max, device=x.device)
    kc, vc = cache[0], cache[1]
    if torch.is_grad_enabled() and x.requires_grad:
        # read the written rows through the new values, so gradients
        # reach them as through the JAX op's functional update
        here = (rows[None, :] == step[:, None])[:, None, :, None]
        kc = torch.where(here, k_new[:, :, None, :].to(kc.dtype), kc)
        vc = torch.where(here, v_new[:, :, None, :].to(vc.dtype), vc)
    valid = rows[None, None, :] <= step[:, None, None]
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kc.float()) \
        / math.sqrt(D)
    logits = torch.where(valid, logits, torch.full(
        (), _NEG, dtype=logits.dtype, device=x.device))
    if mask is not None:
        logits = logits + mask.reshape(B, 1, -1)[:, :, :S_max]
    p = torch.softmax(logits, dim=-1).to(vc.dtype)
    out = torch.einsum("bhs,bhsd->bhd", p, vc)
    return out.reshape(B, H * D), cache


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0, name=None):
    """One-token decode attention against a growing cache (Paddle's
    masked_multihead_attention op). ``x`` ``[B, 3*H*D]`` is this step's
    fused qkv projection, ``cache_kv`` ``[2, B, H, S_max, D]``. Each row
    writes its k and v at its own ``sequence_lengths`` entry, in place,
    and attends the rows up to it. Returns ``(out [B, H*D], cache_kv)``.
    Only the unquantized path exists (``out_scale`` must stay -1), as in
    the JAX package, which also ignores ``bias``."""
    if out_scale != -1:
        raise NotImplementedError(
            "masked_multihead_attention: quantized output path not "
            "implemented (out_scale must be -1)")
    if sequence_lengths is None:
        raise ValueError(
            "masked_multihead_attention needs sequence_lengths ([B] or "
            "[B, 1] current cache fill per row) — without it every step "
            "would overwrite cache slot 0")
    if rotary_tensor is not None or rotary_emb_dims:
        raise NotImplementedError(
            "masked_multihead_attention: fused rotary path not wired; "
            "apply fused_rotary_position_embedding before the qkv pack")
    return _masked_mha(x, cache_kv, src_mask,
                       torch.as_tensor(sequence_lengths, device=x.device))
