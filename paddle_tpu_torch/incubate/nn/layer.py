"""Fused transformer layers — the counterpart of
``paddle_tpu/incubate/nn/layer.py`` (Paddle's
``incubate/nn/layer/fused_transformer.py``): ``FusedMultiHeadAttention``,
``FusedFeedForward`` and ``FusedMultiTransformer``, with the JAX
package's parameter names, shapes and initializers, so one ``seed``
gives its weights.

``FusedMultiTransformer`` keeps every layer's parameters stacked on a
leading layer dim and runs the layers in one loop. Its KV cache ``[L, 2,
B, S_max, Hkv, D]`` is written in place at ``time_step`` and returned, as
Paddle's fused op updates its ``CacheKVs``. A one-token decode step
(``Sq == 1``, ``time_step`` given, no mask) with
``decode_attention="pallas"`` reads each layer's cache in place through
the dense decode kernel (``kernels/decode.py``: ``csrc/decode.cu`` on
CUDA tensors, its plain version on CPU tensors; the plain version on any
device while ``FLAGS_use_cuda_kernels`` is off); that path is
inference-only, as the reference's. ``decode_attention="jnp"`` (and every
other call) is the masked softmax in torch, differentiable.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ... import nn
from ...flags import get_flag
from ...kernels import decode as kdecode
from ...nn import functional as F
from ...ops import einsum, reshape
from ...ops._op import op
from . import functional as IF


class FusedMultiHeadAttention(nn.Layer):
    """Pre- or post-LN attention with the fused epilogue: LN -> qkv ->
    attention -> out projection -> bias + dropout + residual (+ LN)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        one = nn.initializer.Constant(1.0)
        # the fused qkv weight's layout [3, H, D, hidden] (Paddle's)
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr)
        self.qkv_bias = self.create_parameter(
            [3, num_heads, self.head_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr)
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr, default_initializer=one)
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr, default_initializer=one)
        self.ln_bias = self.create_parameter([embed_dim], attr=ln_bias_attr,
                                             is_bias=True)

    def forward(self, x, attn_mask=None, cache=None):
        residual = x
        if self.normalize_before:
            x = F.layer_norm(x, [self.embed_dim], self.pre_ln_scale,
                             self.pre_ln_bias, self.epsilon)
        qkv = einsum("bsh,tndh->bstnd", x, self.qkv_weight) + self.qkv_bias
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = F.linear(reshape(out, [b, s, self.embed_dim]),
                       self.linear_weight, None)
        if self.normalize_before:
            return residual + F.dropout(out + self.linear_bias,
                                        self.dropout_rate,
                                        training=self.training)
        return IF.fused_bias_dropout_residual_layer_norm(
            out, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon,
            training=self.training)


class FusedFeedForward(nn.Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.dropout_rate = dropout_rate
        self.act_dropout = (act_dropout_rate if act_dropout_rate is not None
                            else dropout_rate)
        self.activation = activation
        self.linear1 = nn.Linear(d_model, dim_feedforward,
                                 weight_attr=linear1_weight_attr,
                                 bias_attr=linear1_bias_attr)
        self.linear2 = nn.Linear(dim_feedforward, d_model,
                                 weight_attr=linear2_weight_attr,
                                 bias_attr=linear2_bias_attr)
        self.norm = nn.LayerNorm(d_model, epsilon)

    def forward(self, src):
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        src = F.dropout(getattr(F, self.activation)(self.linear1(src)),
                        self.act_dropout, training=self.training)
        src = residual + F.dropout(self.linear2(src), self.dropout_rate,
                                   training=self.training)
        if not self.normalize_before:
            src = self.norm(src)
        return src


#: the stacked parameters, in the order the stack takes them
STACK = ("ln_scale", "ln_bias", "qkv_weight", "qkv_bias", "linear_weight",
         "linear_bias", "ffn_ln_scale", "ffn_ln_bias", "ffn1_weight",
         "ffn1_bias", "ffn2_weight", "ffn2_bias")
#: the stack's activations: ``gelu`` is ``jax.nn.gelu``'s default, the
#: tanh approximation (FusedFeedForward's ``F.gelu`` is the exact one)
_ACT = {"gelu": lambda x: TF.gelu(x, approximate="tanh"),
        "relu": torch.relu, "silu": TF.silu}


class FusedMultiTransformer(nn.Layer):
    """The whole pre-LN stack for generation (Paddle's
    ``fused_multi_transformer_op``): every layer's parameters stacked on
    a leading layer dim, the KV cache appended in place, GQA through
    ``kv_num_heads``.

    ``forward(src, attn_mask=None, caches=None, time_step=None)`` returns
    the hidden states, and with ``caches`` ``(hidden, caches)``: a
    prefill writes its ``Sq`` rows at ``time_step`` (0), a decode step
    its one row at ``time_step``, and attention reads rows ``[:time_step +
    Sq]``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, dropout_rate=0.0,
                 activation="gelu", normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 kv_num_heads=None, name=None, decode_attention="pallas"):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN, as "
                             "Paddle's fused op")
        # "pallas": single-token decode through the dense decode kernel;
        # "jnp": the masked softmax (the JAX package's two values)
        if decode_attention not in ("pallas", "jnp"):
            raise ValueError(f"decode_attention must be 'pallas' or "
                             f"'jnp', got {decode_attention!r}")
        if activation not in _ACT:
            raise ValueError(f"activation must be one of {sorted(_ACT)}, "
                             f"got {activation!r}")
        self.decode_attention = decode_attention
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) if qkv_weight_attrs else 1
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        # GQA: kv_num_heads < num_heads shares each KV head across
        # num_heads // kv_num_heads query heads
        self.kv_num_heads = kv_num_heads if kv_num_heads else num_heads
        if num_heads % self.kv_num_heads:
            raise ValueError(f"num_heads {num_heads} is not a multiple of "
                             f"kv_num_heads {self.kv_num_heads}")
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.activation = activation
        self.epsilon = epsilon
        L, H, D, E, FF = (num_layers, num_heads, self.head_dim, embed_dim,
                          dim_feedforward)
        Hkv = self.kv_num_heads
        mk = self.create_parameter
        one = nn.initializer.Constant(1.0)
        self.ln_scale = mk([L, E], default_initializer=one)
        self.ln_bias = mk([L, E], is_bias=True)
        # packed q|k|v on the head dim: [L, H + 2*Hkv, D, E]
        self.qkv_weight = mk([L, H + 2 * Hkv, D, E])
        self.qkv_bias = mk([L, H + 2 * Hkv, D], is_bias=True)
        self.linear_weight = mk([L, E, E])
        self.linear_bias = mk([L, E], is_bias=True)
        self.ffn_ln_scale = mk([L, E], default_initializer=one)
        self.ffn_ln_bias = mk([L, E], is_bias=True)
        self.ffn1_weight = mk([L, E, FF])
        self.ffn1_bias = mk([L, FF], is_bias=True)
        self.ffn2_weight = mk([L, FF, E])
        self.ffn2_bias = mk([L, E], is_bias=True)

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                **kwargs):
        return _fmt_forward(
            src, attn_mask, caches, *(getattr(self, n) for n in STACK),
            heads=(self.num_heads, self.kv_num_heads, self.head_dim),
            act=self.activation, eps=self.epsilon,
            time_step=None if time_step is None else int(time_step),
            decode_attn=self.decode_attention)


def _ln(v, scale, bias, eps):
    """LayerNorm in float32, cast back before the scale and bias: the
    body of ``F.layer_norm`` (the stack is one op: its body calls no
    other registered op)."""
    return F.layer_norm.raw_fn(v, v.shape[-1], scale, bias, eps)


def _masked_attention(q, k, v, mask, H, Hkv, D, out_dtype):
    """The masked softmax over ``[B, S, heads, D]``: KV heads repeated
    for GQA, float32 scores, the causal ``tril(k=Sk-Sq)`` with -1e30, the
    additive mask, probabilities in ``out_dtype``."""
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    Sq, Sk = q.shape[1], k.shape[1]
    causal = torch.ones(Sq, Sk, dtype=torch.bool,
                        device=q.device).tril(diagonal=Sk - Sq)
    logits = torch.where(causal[None, None], logits, torch.full(
        (), -1e30, dtype=logits.dtype, device=q.device))
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))
    return attn.reshape(attn.shape[0], attn.shape[1], H * D)


@op(name="fused_multi_transformer")
def _fmt_forward(x, mask, cache, ln_scale, ln_bias, qkv_weight, qkv_bias,
                 linear_weight, linear_bias, ffn_ln_scale, ffn_ln_bias,
                 ffn1_weight, ffn1_bias, ffn2_weight, ffn2_bias, *, heads,
                 act, eps, time_step, decode_attn):
    """The stack's layer loop; ``cache`` ``[L, 2, B, S_max, Hkv, D]``
    (written in place at ``time_step``) or None."""
    H, Hkv, D = heads
    B, Sq = x.shape[0], x.shape[1]
    if cache is not None and time_step is not None \
            and time_step + Sq > cache.shape[3]:
        raise ValueError(f"time_step {time_step} + {Sq} rows past the "
                         f"cache's {cache.shape[3]}")
    decode_one = (cache is not None and time_step is not None and Sq == 1
                  and mask is None and decode_attn == "pallas")
    if decode_one:
        lens = torch.full((B,), time_step + 1, dtype=torch.int32,
                          device=x.device)
        decode = (kdecode.decode_attention
                  if get_flag("FLAGS_use_cuda_kernels")
                  else kdecode.decode_attention_reference)
    h = x
    for li in range(qkv_weight.shape[0]):
        residual = h
        hn = _ln(h, ln_scale[li], ln_bias[li], eps)
        qkv = torch.einsum("bse,nde->bsnd", hn, qkv_weight[li]) \
            + qkv_bias[li]
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
        if cache is not None and time_step is not None:
            ck, cv = cache[li, 0], cache[li, 1]
            with torch.no_grad():
                ck[:, time_step:time_step + Sq] = k
                cv[:, time_step:time_step + Sq] = v
            if not decode_one:
                # the window [:time_step + Sq], differentiable in k and v
                k = torch.cat([ck[:, :time_step], k.to(ck.dtype)], dim=1)
                v = torch.cat([cv[:, :time_step], v.to(cv.dtype)], dim=1)
        if decode_one:
            # the layer's cache views read in place, lengths time_step + 1
            attn = decode(q[:, 0].contiguous(), ck, cv, lens)
            attn = attn.to(h.dtype).reshape(B, 1, H * D)
        else:
            attn = _masked_attention(q, k, v, mask, H, Hkv, D, h.dtype)
        h = residual + torch.matmul(attn, linear_weight[li]) \
            + linear_bias[li]
        residual = h
        ff = torch.matmul(_ln(h, ffn_ln_scale[li], ffn_ln_bias[li], eps),
                          ffn1_weight[li]) + ffn1_bias[li]
        h = residual + torch.matmul(_ACT[act](ff), ffn2_weight[li]) \
            + ffn2_bias[li]
    return h if cache is None else (h, cache)
