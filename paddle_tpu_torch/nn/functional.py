"""``nn.functional`` — the part of ``paddle_tpu/nn/functional.py`` that the
port's layers and GPT use, and the attention entries: activations,
``linear`` (Paddle's ``[in, out]`` weight), ``embedding``, dropout, the
norms, the losses, ``scaled_dot_product_attention`` (plain, as the JAX
``_sdpa``) and ``flash_attention`` on the port's flash kernels.

Every function is registered under the JAX package's dispatch name
(``_cross_entropy_impl``, ``_batch_norm_train``, ``_dropout_impl``,
``_sdpa`` …), so ``amp.auto_cast`` casts its inputs as the JAX package
does. Random masks draw one ``next_key()`` a call, as JAX does, and hash
on the tensor's device: the same seed and order of draws give JAX's
masks bit for bit. The rest of the JAX module (conv, pooling, rnn …)
waits for ROADMAP.md Queue A step 12b.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ..flags import get_flag
from ..kernels.flash import flash_attention as _flash
from ..kernels.flash_attention import _ref_attention
from ..ops._op import op
from ..ops.creation import zeros_like
from ..ops.manipulation import unsqueeze
from ..ops.math import scale


def _where0(mask, v):
    return torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


# ----------------------------------------------------------------- activations
@op
def relu(x):
    return torch.relu(x)


@op
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@op
def gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@op
def sigmoid(x):
    return torch.sigmoid(x)


@op
def silu(x):
    return x * torch.sigmoid(x)


swish = silu


@op
def tanh(x):
    return torch.tanh(x)


@op
def softplus(x, beta=1.0, threshold=20.0):
    safe = torch.clamp(x * beta, max=threshold)
    return torch.where(x * beta > threshold, x,
                       torch.log1p(torch.exp(safe)) / beta)


@op
def softsign(x):
    return x / (torch.abs(x) + 1)


@op
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@op
def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


@op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op
def celu(x, alpha=1.0):
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


@op
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@op
def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@op
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@op
def hardshrink(x, threshold=0.5):
    return _where0(torch.abs(x) > threshold, x)


@op
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       _where0(x < -threshold, x + threshold))


@op
def tanhshrink(x):
    return x - torch.tanh(x)


@op
def mish(x):
    return x * torch.tanh(TF.softplus(x))


@op
def prelu(x, weight, data_format="NCHW"):
    w = weight
    if w.dim() == 1 and w.shape[0] > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@op
def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True):
    if training:
        a = random_mod.uniform_shaped(random_mod.next_key(), tuple(x.shape),
                                      lower, upper, x.device).to(x.dtype)
    else:
        a = (lower + upper) / 2
    return torch.where(x >= 0, x, a * x)


@op
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op
def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(dtype_mod.to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


@op
def log_softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(dtype_mod.to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


@op
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x,
                       torch.tensor(value, dtype=x.dtype, device=x.device))


@op
def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


@op
def swiglu(x, y=None):
    """``silu(x) * y`` (the LLaMA MLP; the JAX package's
    ``incubate.nn.functional.swiglu``); with ``y`` None, ``x`` is split
    in two along its last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return x * torch.sigmoid(x) * y


# ----------------------------------------------------------------- linear/embed
@op
def linear(x, weight, bias=None):
    """``x @ weight + bias`` on Paddle's ``[in, out]`` weight, read as it
    is stored (no transposed copy)."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


@op
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight``; the ``padding_idx`` rows get no gradient."""
    return TF.embedding(x, weight, padding_idx=padding_idx)


@op
def one_hot(x, num_classes):
    ar = torch.arange(num_classes, device=x.device)
    return (x[..., None] == ar).to(dtype_mod.get_default_dtype())


# ----------------------------------------------------------------- dropout
def _mask(key, keep, shape, device):
    return random_mod.bernoulli(key, keep, shape, device)


@op
def _dropout_impl(x, key, p, upscale):
    keep = 1.0 - p
    mask = _mask(key, keep, tuple(x.shape), x.device)
    return _where0(mask, x / keep if upscale else x).to(x.dtype)


@op
def _dropout_axis(x, key, p, mask_shape, upscale):
    keep = 1.0 - p
    mask = _mask(key, keep, mask_shape, x.device)
    return _where0(mask, x / keep if upscale else x).to(x.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return scale(x, scale=1.0 - p)
        return x
    if p == 1.0:
        return zeros_like(x)
    if axis is not None:
        shape = list(x.shape)
        axes = [axis] if isinstance(axis, int) else list(axis)
        for i in range(len(shape)):
            if i not in axes:
                shape[i] = 1
        return _dropout_axis(x, random_mod.next_key(), p, tuple(shape),
                             mode == "upscale_in_train")
    return _dropout_impl(x, random_mod.next_key(), float(p),
                         mode == "upscale_in_train")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


# ----------------------------------------------------------------- norms
def _rsqrt(v, eps):
    return torch.rsqrt(v + eps)


@op
def _batch_norm_train(x, mean, var, weight, bias, momentum, epsilon, axes,
                      bshape):
    batch_mean = torch.mean(x, dim=axes)
    batch_var = torch.var(x, dim=axes, correction=0)
    new_mean = momentum * mean + (1 - momentum) * batch_mean
    new_var = momentum * var + (1 - momentum) * batch_var
    out = (x - batch_mean.reshape(bshape)) * _rsqrt(
        batch_var.reshape(bshape), epsilon)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out.to(x.dtype), new_mean, new_var


@op
def _batch_norm_eval(x, mean, var, weight, bias, epsilon, bshape):
    out = (x - mean.reshape(bshape)) * _rsqrt(var.reshape(bshape), epsilon)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out.to(x.dtype)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm; in training the running statistics are updated in
    place (``momentum * running + (1 - momentum) * batch``)."""
    nd = x.dim()
    ch_axis = 1 if data_format.startswith("NC") else nd - 1
    axes = tuple(i for i in range(nd) if i != ch_axis)
    bshape = tuple(x.shape[ch_axis] if i == ch_axis else 1
                   for i in range(nd))
    use_stats = use_global_stats if use_global_stats is not None \
        else not training
    if use_stats:
        return _batch_norm_eval(x, running_mean, running_var, weight, bias,
                                float(epsilon), bshape)
    out, new_mean, new_var = _batch_norm_train(
        x, running_mean, running_var, weight, bias, float(momentum),
        float(epsilon), axes, bshape)
    with torch.no_grad():
        running_mean.copy_(new_mean)
        running_var.copy_(new_var)
    return out


@op
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalized over the trailing ``normalized_shape`` dims in float32,
    rounded to ``x``'s type, then scaled and shifted in that type."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) * _rsqrt(var, epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op
def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=axis, keepdim=True)
    out = (xf * _rsqrt(ms, epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


# ----------------------------------------------------------------- losses
def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@op
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@op
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@op
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@op
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    neg_abs = -torch.abs(logit)
    loss = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(neg_abs))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * label + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    mask = label != ignore_index
    safe = torch.where(mask, label, torch.zeros_like(label))
    loss = -torch.gather(input, -1, safe[..., None])[..., 0]
    if weight is not None:
        loss = loss * weight[safe]
    loss = _where0(mask, loss)
    if reduction == "mean":
        denom = torch.sum(weight[safe] * mask) if weight is not None \
            else torch.sum(mask)
        return torch.sum(loss) / torch.clamp(denom, min=1)
    return _reduce(loss, reduction)


@op
def kl_div(input, label, reduction="mean"):
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    return _reduce(loss, reduction)


@op
def _cross_entropy_impl(input, label, weight, ignore_index, reduction,
                        soft_label, axis, use_softmax, label_smoothing):
    if use_softmax:
        logp = torch.log_softmax(input.float(), dim=axis)
    else:
        logp = torch.log(torch.clamp(input.float(), min=1e-12))
    nclass = input.shape[axis]
    mask = safe = None
    if soft_label:
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        loss = -torch.sum(soft * logp, dim=axis)
    else:
        lbl = label
        if lbl.dim() == logp.dim():
            lbl = lbl.squeeze(axis)
        mask = lbl != ignore_index
        safe = torch.where(mask, lbl, torch.zeros_like(lbl))
        picked = torch.gather(logp, axis, safe.unsqueeze(axis)) \
            .squeeze(axis)
        if label_smoothing > 0:
            loss = -(1 - label_smoothing) * picked \
                - label_smoothing * torch.mean(logp, dim=axis)
        else:
            loss = -picked
        if weight is not None:
            loss = loss * weight[safe]
        loss = _where0(mask, loss)
    if reduction == "mean":
        if mask is not None:
            denom = torch.sum(weight[safe] * mask) if weight is not None \
                else torch.sum(mask)
            return torch.sum(loss) / torch.clamp(denom, min=1)
        return torch.mean(loss)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy in float32, hard labels (``ignore_index``
    rows masked out of the sum and the mean's count) or ``soft_label``
    distributions; ``weight`` per class; ``label_smoothing``."""
    return _cross_entropy_impl(input, label, weight, ignore_index,
                               reduction, soft_label, axis, use_softmax,
                               label_smoothing)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


# ----------------------------------------------------------------- attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Plain attention over ``[batch, seq, heads, head_dim]`` (the JAX
    ``_sdpa``): float32 scores, a causal mask aligned to the top left,
    ``attn_mask`` (bool keeps, float adds), softmax, probabilities in the
    query's type, dropout on the probabilities (one key a call)."""
    dk = random_mod.next_key() if (dropout_p and training) else None
    return _sdpa(query, key, value, attn_mask, float(dropout_p),
                 bool(is_causal), bool(training), dk)


@op
def _sdpa(q, k, v, attn_mask, dropout_p, is_causal, training, drop_key):
    D = q.shape[-1]
    Sq, Sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(D))
    if is_causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p and training and drop_key is not None:
        keep_p = 1.0 - dropout_p
        m = _mask(drop_key, keep_p, tuple(probs.shape), q.device)
        probs = _where0(m, probs / keep_p).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


@op
def _flash_impl(q, k, v, causal):
    """One flash attention: the port's flash forward and backward
    kernels (``kernels/flash.py`` ``flash_attention``: the kernels on a
    CUDA tensor while ``FLAGS_use_cuda_kernels`` is on, the plain versions
    on a CPU tensor), causal or not. The kernels take one length for
    queries and keys: at ``Sq != Sk`` (a shape rule, no launch) the plain
    ``_ref_attention`` runs, as the JAX package's ``_flash_impl`` does
    there off a TPU. The kernels take float32 and bfloat16: a float16
    input that would reach them raises before any launch (ROADMAP.md
    Queue C 8)."""
    if q.shape[1] != k.shape[1]:
        return _ref_attention(q, k, v, causal)
    if q.dtype == torch.float16 and q.device.type == "cuda" \
            and get_flag("FLAGS_use_cuda_kernels"):
        raise NotImplementedError(
            "F.flash_attention: the flash kernels take float32 and "
            "bfloat16, not float16; see ROADMAP.md Queue C 8")
    return _flash(q, k, v, causal=causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Paddle's ``F.flash_attention`` over ``[b, s, h, d]`` (k/v may have
    fewer heads: GQA); returns ``(out, None)``. With ``dropout > 0`` in
    training it is :func:`scaled_dot_product_attention` (dropout needs
    the probabilities), as in the reference; otherwise the flash kernels
    (:func:`_flash_impl`)."""
    if dropout and training:
        out = scaled_dot_product_attention(query, key, value,
                                           dropout_p=dropout,
                                           is_causal=causal,
                                           training=training)
    else:
        out = _flash_impl(query, key, value, bool(causal))
    return out, None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """Packed QKV ``[batch, seq, 3, heads, head_dim]``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_unpadded(*args, **kwargs):
    raise NotImplementedError(
        "flash_attn_unpadded (segment masks) is not ported; see ROADMAP.md "
        "Queue A step 12b")
