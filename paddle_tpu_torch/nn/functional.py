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
masks bit for bit. The spatial part — convolutions, pools, the spatial
norms, resampling and the common layers' functions — runs on torch's
products (cuDNN's on a card), as the JAX package's run on XLA's, with the
reference's padding, ceil-mode and resize arithmetic. The rest of the JAX
module (rnn, the remaining losses …) waits for ROADMAP.md Queue A step
12b.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ..kernels.flash import flash_attention as _flash
from ..kernels.flash_attention import _ref_attention
from ..ops._op import op
from ..ops.creation import zeros_like
from ..ops.manipulation import pad, unsqueeze  # noqa: F401
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
    there off a TPU. The kernels take float32, bfloat16 and float16."""
    if q.shape[1] != k.shape[1]:
        return _ref_attention(q, k, v, causal)
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


# ------------------------------------------------------------ conv / pool
# The spatial part of ``paddle_tpu/nn/functional.py``: convolutions and
# pools on torch's (cuDNN's, on a card) products, as the JAX package's
# run on XLA's, with the reference's padding rules — its explicit pads
# (``_conv_padding``), XLA's ``SAME``/``VALID`` (the odd pixel on the high
# side, at any stride), and the pools' ceil mode, which pads the high edge
# (``_ceil_extra``) and keeps a last window that starts in the padding.
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, spatial, channel_last=False):
    """The reference's padding forms as ``[(lo, hi)]`` a spatial dim, or
    the string ``"SAME"``/``"VALID"``: an int, one int a dim, ``2 *
    spatial`` ints (lo, hi a dim), one pair a dim, or a pair for every
    dim of the tensor (batch and channel pairs zero)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * spatial
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        if len(padding) == spatial:
            sp = padding
        elif len(padding) == spatial + 2:
            sp = padding[1:-1] if channel_last else padding[2:]
            nc = padding[:1] + padding[-1:] if channel_last else padding[:2]
            if any(int(v) != 0 for p in nc for v in p):
                raise ValueError(
                    f"padding on batch/channel dims must be zero, got "
                    f"{padding}")
        else:
            raise ValueError(f"bad padding {padding}")
        return [tuple(int(v) for v in p) for p in sp]
    if len(padding) == spatial and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * spatial:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(spatial)]
    raise ValueError(f"bad padding {padding}")


def _string_pads(mode, sizes, windows, strides):
    """XLA's pads of ``"SAME"`` (output ``ceil(size / stride)``, the odd
    pixel on the high side) or ``"VALID"`` (none); ``windows`` are the
    dilated window extents."""
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {mode!r}")
    pads = []
    for n, w, s in zip(sizes, windows, strides):
        total = max((-(-n // s) - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """Pad (or, where negative, crop) the trailing spatial dims of ``x`` by
    ``pads`` ([(lo, hi)] first spatial dim first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if not any(flat):
        return x
    return TF.pad(x, flat, value=value)


def _nc_first(x):
    """channels-last -> channels-first (the pools and convs run NC*)."""
    return x.permute((0, x.dim() - 1) + tuple(range(1, x.dim() - 1)))


def _nc_last(x):
    return x.permute((0,) + tuple(range(2, x.dim())) + (1,))


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _conv_nd(nd, x, weight, bias, stride, padding, dilation, groups,
             channel_last):
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pads = _conv_padding(padding, nd, channel_last)
    if channel_last:
        x = _nc_first(x)
    if isinstance(pads, str):
        k = weight.shape[2:]
        pads = _string_pads(pads, x.shape[2:],
                            [d * (kk - 1) + 1 for d, kk in zip(dilation, k)],
                            stride)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pads],
                        dilation, groups)
    else:
        out = _CONV[nd](_pad_spatial(x, pads), weight, bias, stride, 0,
                        dilation, groups)
    return _nc_last(out) if channel_last else out


@op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution, Paddle's OIHW weight in either layout."""
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format != "NCHW")


@op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    not data_format.startswith("NC"))


@op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    not data_format.startswith("NC"))


def _conv_transpose_nd(nd, x, weight, bias, stride, padding, output_padding,
                       dilation, groups, channel_last):
    """The reference's transposed conv (a conv over the stride-dilated
    input, pads ``d (k - 1) - lo`` and ``d (k - 1) - hi + output_padding``)
    as torch's full transposed conv, then cropped (or zero-extended) by
    those pads: any per-side pads, as the reference takes them."""
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    opad = _pair(output_padding, nd)
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    pads = _conv_padding(padding, nd, channel_last)
    if channel_last:
        x = _nc_first(x)
    out = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    out = _pad_spatial(out, [(-lo, op_ - hi) for (lo, hi), op_
                             in zip(pads, opad)])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return _nc_last(out) if channel_last else out


@op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """Paddle's ``[in, out / groups, kh, kw]`` weight; ``output_size`` is
    taken and not read, as in the reference."""
    return _conv_transpose_nd(2, x, weight, bias, stride, padding,
                              output_padding, dilation, groups,
                              not data_format.startswith("NC"))


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL"):
    """The 2-D transposed conv over a trailing unit dim (the reference's
    delegation: one int each of stride, padding, output_padding and
    dilation)."""
    cl = not data_format.startswith("NC")
    if cl:
        x = x.permute(0, 2, 1)
    out = conv2d_transpose(
        x.unsqueeze(-1), weight.unsqueeze(-1), bias,
        (_pair(stride, 1)[0], 1), (_pair(padding, 1)[0], 0),
        (_pair(output_padding, 1)[0], 0), (_pair(dilation, 1)[0], 1), groups)
    out = out.squeeze(-1)
    return out.permute(0, 2, 1) if cl else out


@op
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose_nd(3, x, weight, bias, stride, padding,
                              output_padding, dilation, groups,
                              not data_format.startswith("NC"))


def _ceil_extra(size, k, s, pad, pad_hi=None):
    """Extra high-side padding so ceil-mode windows are all taken (the
    last one may start in the padding)."""
    pad_hi = pad if pad_hi is None else pad_hi
    span = size + pad + pad_hi - k
    out_floor = span // s + 1
    out_ceil = -(-span // s) + 1
    if out_ceil > out_floor:
        return (out_ceil - 1) * s + k - size - pad - pad_hi
    return 0


def _neg(x):
    return float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min


_MAX_POOL = {2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool_pads(nd, x, k, s, padding, ceil_mode, channel_last):
    """(x channels-first, the full pads or the string mode's pads, whether
    the padding was a string)."""
    pads = _conv_padding(padding, nd, channel_last)
    if channel_last:
        x = _nc_first(x)
    if isinstance(pads, str):
        return x, _string_pads(pads, x.shape[2:], k, s), True
    if ceil_mode:
        pads = [(lo, hi + _ceil_extra(x.shape[2 + i], k[i], s[i], lo, hi))
                for i, (lo, hi) in enumerate(pads)]
    return x, pads, False


def _max_pool_nd(nd, x, kernel_size, stride, padding, ceil_mode,
                 return_mask, data_format):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    cl = not data_format.startswith("NC")
    x, pads, is_str = _pool_pads(nd, x, k, s, padding, ceil_mode, cl)
    if is_str and return_mask:
        raise NotImplementedError("return_mask with string padding")
    xp = _pad_spatial(x, pads, _neg(x))
    if not return_mask:
        out = _MAX_POOL[nd](xp, k, s)
        return _nc_last(out) if cl else out
    out, idx = _MAX_POOL[nd](xp, k, s, return_indices=True)
    # torch's index runs over the padded input; the mask is the flat index
    # into the unpadded spatial dims (Paddle's convention)
    coords, rest = [], idx
    for d in range(nd - 1, -1, -1):
        n_pad = xp.shape[2 + d]
        coords.append(rest % n_pad - pads[d][0])
        rest = rest // n_pad
    mask = torch.zeros_like(idx)
    for d, c in zip(range(nd), reversed(coords)):
        mask = mask * x.shape[2 + d] + c
    mask = mask.to(dtype_mod.long_dtype())
    if cl:
        return _nc_last(out), _nc_last(mask)
    return out, mask


def _avg_pool_nd(nd, x, kernel_size, stride, padding, ceil_mode, exclusive,
                 divisor_override, data_format):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    cl = not data_format.startswith("NC")
    x, pads, is_str = _pool_pads(nd, x, k, s, padding, ceil_mode, cl)
    summed = _AVG_POOL[nd](_pad_spatial(x, pads), k, s, divisor_override=1)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and not is_str:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = _AVG_POOL[nd](_pad_spatial(ones, pads), k, s,
                              divisor_override=1)
        out = summed / count
    else:
        out = summed / math.prod(k)
    return _nc_last(out) if cl else out


@op
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling; ``return_mask`` adds the flat H*W input index of each
    window's max (the first, in window order)."""
    return _max_pool_nd(2, x, kernel_size, stride, padding, ceil_mode,
                        return_mask, data_format)


@op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Average pooling: ``exclusive`` divides by the window's count of
    input (not padding) elements, except under string padding, which
    divides by the window size, as the reference does."""
    return _avg_pool_nd(2, x, kernel_size, stride, padding, ceil_mode,
                        exclusive, divisor_override, data_format)


@op
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    return _max_pool_nd(3, x, kernel_size, stride, padding, ceil_mode,
                        return_mask, data_format)


@op
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _avg_pool_nd(3, x, kernel_size, stride, padding, ceil_mode,
                        exclusive, divisor_override, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    out = max_pool2d(unsqueeze(x, -1), (_pair(kernel_size, 1)[0], 1),
                     (_pair(stride, 1)[0], 1) if stride is not None else None,
                     padding=(_pair(padding, 1)[0], 0), ceil_mode=ceil_mode,
                     return_mask=return_mask)
    if return_mask:  # W = 1: the flat H*W index is the length index
        return out[0].squeeze(-1), out[1].squeeze(-1)
    return out.squeeze(-1)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    """The 2-D pool over a unit width; ``ceil_mode`` is taken and not
    passed on, as in the reference."""
    out = avg_pool2d(unsqueeze(x, -1), (_pair(kernel_size, 1)[0], 1),
                     (_pair(stride, 1)[0], 1) if stride is not None else None,
                     padding=(_pair(padding, 1)[0], 0), exclusive=exclusive)
    return out.squeeze(-1)


def _bins(n, o):
    """Adaptive pooling's bins: ``[floor(i n / o), ceil((i + 1) n / o))``."""
    return [((i * n) // o, -(-(i + 1) * n // o)) for i in range(o)]


def _adaptive_nd(x, out_size, reduce):
    """``reduce`` (mean or amax) over the adaptive bins of the trailing
    ``len(out_size)`` dims: all at once where every bin size divides,
    else one dim at a time (the reference's separable form)."""
    nd = len(out_size)
    sizes = x.shape[-nd:]
    if all(o == 1 for o in out_size):
        return reduce(x, tuple(range(-nd, 0)), True)
    if all(n % o == 0 for n, o in zip(sizes, out_size)):
        shape = tuple(x.shape[:-nd])
        for n, o in zip(sizes, out_size):
            shape += (o, n // o)
        return reduce(x.reshape(shape), tuple(range(-2 * nd + 1, 0, 2)),
                      False)
    out = x
    for d, (n, o) in enumerate(zip(sizes, out_size)):
        ax = x.dim() - nd + d
        out = torch.cat([reduce(out.narrow(ax, lo, hi - lo), (ax,), True)
                         for lo, hi in _bins(n, o)], dim=ax)
    return out


def _mean(x, dims, keepdim):
    return torch.mean(x, dim=dims, keepdim=keepdim)


def _amax(x, dims, keepdim):
    return torch.amax(x, dim=dims, keepdim=keepdim)


def _adaptive_max_mask(x, out_size):
    """Each adaptive bin's max and the flat input index of its first
    maximum (the reference's per-bin loop)."""
    nd = len(out_size)
    sizes = tuple(x.shape[-nd:])
    lead = tuple(x.shape[:-nd])
    vals, idxs = [], []
    for region in itertools.product(*(_bins(n, o)
                                      for n, o in zip(sizes, out_size))):
        seg = x[(Ellipsis,) + tuple(slice(lo, hi) for lo, hi in region)]
        dims = [hi - lo for lo, hi in region]
        flat = seg.reshape(lead + (-1,))
        am = torch.argmax(flat, dim=-1)
        vals.append(torch.amax(flat, dim=-1))
        pos = torch.zeros_like(am)
        for d in range(nd):
            step = math.prod(dims[d + 1:])
            pos = pos * sizes[d] + region[d][0] + (am // step) % dims[d]
        idxs.append(pos)
    out = torch.stack(vals, dim=-1).reshape(lead + tuple(out_size))
    mask = torch.stack(idxs, dim=-1).reshape(lead + tuple(out_size))
    return out, mask.to(dtype_mod.long_dtype())


@op
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_nd(x, _pair(output_size), _mean)


@op
def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    if return_mask:
        return _adaptive_max_mask(x, _pair(output_size))
    return _adaptive_nd(x, _pair(output_size), _amax)


@op
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_nd(x, _pair(output_size, 3), _mean)


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW", name=None):
    out_size = (tuple(output_size) if isinstance(output_size, (list, tuple))
                else (output_size,) * 3)
    if return_mask:
        return _adaptive_max_mask(x, out_size)
    return _adaptive_nd(x, out_size, _amax)


def adaptive_avg_pool1d(x, output_size):
    return adaptive_avg_pool2d(unsqueeze(x, -1),
                               (int(output_size), 1)).squeeze(-1)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    out = adaptive_max_pool2d(unsqueeze(x, -1), (int(output_size), 1),
                              return_mask=return_mask)
    if return_mask:  # W = 1: the flat index is the length index
        return out[0].squeeze(-1), out[1].squeeze(-1)
    return out.squeeze(-1)


def _unpool_nd(x, indices, sizes):
    """Scatter ``x`` to the flat positions ``indices`` of zero planes of
    the trailing ``sizes``."""
    N, C = x.shape[:2]
    flat = torch.zeros((N, C, math.prod(sizes)), dtype=x.dtype,
                       device=x.device)
    out = flat.scatter(2, indices.reshape(N, C, -1).long(),
                       x.reshape(N, C, -1))
    return out.reshape((N, C) + tuple(sizes))


@op
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    """The inverse of ``max_pool2d(return_mask=True)``: each value to its
    flat H*W position."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    IH, IW = x.shape[2:]
    if output_size is None:
        size = ((IH - 1) * s[0] - 2 * p[0] + k[0],
                (IW - 1) * s[1] - 2 * p[1] + k[1])
    else:
        size = (output_size[-2], output_size[-1])
    return _unpool_nd(x, indices, size)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL"):
    out = max_unpool2d(unsqueeze(x, -1), unsqueeze(indices, -1),
                       (kernel_size, 1),
                       (stride, 1) if stride is not None else None,
                       (padding, 0),
                       None if output_size is None
                       else (output_size[-1], 1))
    return out.squeeze(-1)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW"):
    k = _pair(kernel_size, 3)
    s = _pair(stride, 3) if stride is not None else k
    p = _pair(padding, 3)
    if output_size is None:
        size = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                     for i in range(3))
    else:
        size = tuple(output_size[-3:])
    return _max_unpool3d_impl(x, indices, *size)


@op
def _max_unpool3d_impl(x, indices, OD, OH, OW):
    return _unpool_nd(x, indices, (OD, OH, OW))


def _fractional_bounds(in_size, out_size, u, kernel):
    """Graham's fractional pooling regions: ``[ceil(a (i + u) - 1),
    ceil(a (i + 1 + u) - 1))``, ``a = in / out``; ``kernel`` overrides
    each region's extent."""
    alpha = in_size / out_size
    bounds = []
    for i in range(out_size):
        lo = max(int(math.ceil(alpha * (i + u) - 1)), 0)
        hi = (lo + kernel if kernel
              else max(int(math.ceil(alpha * (i + 1 + u) - 1)), lo + 1))
        bounds.append((lo, min(hi, in_size)))
    return bounds


def _fractional_u(random_u):
    """One shared u: ``random_u``, or a uniform draw of the key walk."""
    if random_u is not None:
        return float(random_u)
    return float(random_mod.uniform_shaped(random_mod.next_key(), ()))


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Fractional max pooling (Graham 2014) with one shared ``u``."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else (output_size[-2], output_size[-1]))
    kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else (kernel_size if kernel_size else (None, None)))
    u = _fractional_u(random_u)
    H, W = x.shape[2:]
    bounds = (_fractional_bounds(H, oh, u, kh), _fractional_bounds(W, ow, u,
                                                                   kw))
    if return_mask:
        return _fractional_pool_impl_mask(x, bounds, (H, W))
    return _fractional_pool_impl(x, bounds, (H, W))


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    od, oh, ow = ((output_size,) * 3 if isinstance(output_size, int)
                  else (output_size[-3], output_size[-2], output_size[-1]))
    kd, kh, kw = ((kernel_size,) * 3 if isinstance(kernel_size, int)
                  else (kernel_size if kernel_size else (None,) * 3))
    u = _fractional_u(random_u)
    D, H, W = x.shape[2:]
    bounds = (_fractional_bounds(D, od, u, kd),
              _fractional_bounds(H, oh, u, kh),
              _fractional_bounds(W, ow, u, kw))
    if return_mask:
        return _fractional_pool_impl_mask(x, bounds, (D, H, W))
    return _fractional_pool_impl(x, bounds, (D, H, W))


@op
def _fractional_pool_impl(x, bounds, in_sizes):
    # separable: a max over a box is the max over each axis in turn
    out = x
    for i, b in enumerate(bounds):
        out = torch.cat([torch.amax(out.narrow(2 + i, lo, hi - lo),
                                    dim=2 + i, keepdim=True)
                         for lo, hi in b], dim=2 + i)
    return out


@op
def _fractional_pool_impl_mask(x, bounds, in_sizes):
    lead = tuple(x.shape[:2])
    vals, idxs = [], []
    for region in itertools.product(*bounds):
        seg = x[(Ellipsis,) + tuple(slice(lo, hi) for lo, hi in region)]
        dims = [hi - lo for lo, hi in region]
        patch = seg.reshape(lead + (-1,))
        vals.append(torch.amax(patch, dim=-1))
        am = torch.argmax(patch, dim=-1)
        flat = torch.zeros_like(am)
        for d, ((lo, _hi), full) in enumerate(zip(region, in_sizes)):
            c = (am // math.prod(dims[d + 1:])) % dims[d]
            flat = flat * full + (c + lo)
        idxs.append(flat)
    shape = lead + tuple(len(b) for b in bounds)
    out = torch.stack(vals, dim=-1).reshape(shape)
    mask = torch.stack(idxs, dim=-1).reshape(shape)
    return out, mask.to(dtype_mod.long_dtype())


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """``(sum |x|^p over the window)^(1/p)``; p = inf is max pooling. The
    sum is the average at a divisor of the full window, times it."""
    p = float(norm_type)
    if p == float("inf"):
        return max_pool2d(x, kernel_size, stride, padding,
                          ceil_mode=ceil_mode, data_format=data_format)
    kh, kw = _pair(kernel_size)
    s = avg_pool2d(x.abs().pow(p), kernel_size, stride, padding,
                   ceil_mode=ceil_mode, divisor_override=kh * kw,
                   data_format=data_format)
    return (s * float(kh * kw)).pow(1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, name=None):
    out = lp_pool2d(unsqueeze(x, -1), norm_type,
                    (_pair(kernel_size, 1)[0], 1),
                    (_pair(stride, 1)[0], 1) if stride is not None else None,
                    padding=(_pair(padding, 1)[0], 0), ceil_mode=ceil_mode)
    return out.squeeze(-1)


# ----------------------------------------------------------- spatial norms
@op
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    N = x.shape[0]
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    if ch_axis != 1:
        x = x.movedim(ch_axis, 1)
    C = x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((N, num_groups, C // num_groups) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, keepdim=True, correction=0)
    out = ((xg - mean) * _rsqrt(var, epsilon)).reshape((N, C) + spatial)
    bshape = (1, C) + (1,) * len(spatial)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    if ch_axis != 1:
        out = out.movedim(1, ch_axis)
    return out.to(x.dtype)


@op
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Normalized over each sample's channel maps (the running statistics
    are taken and not used, as in the reference)."""
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean) * _rsqrt(var, eps)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out.to(x.dtype)


@op
def normalize(x, p=2, axis=1, epsilon=1e-12):
    if p == 2:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    else:
        n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                                keepdim=True), 1.0 / p)
    return x / torch.clamp(n, min=epsilon)


@op
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    sq = torch.square(x)
    half = size // 2
    padded = TF.pad(sq.movedim(1, -1), (half, size - half - 1)).movedim(-1, 1)
    acc = sum(padded[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


# ------------------------------------------------------------- resampling
def linear_resize_weights(in_size, out_size):
    """The ``[in_size, out_size]`` float32 weights of ``jax.image.resize``'s
    linear method along one dim (``scale_and_translate``'s
    ``compute_weight_mat``): half-pixel sample positions, a triangle
    kernel widened by ``in / out`` when it shrinks (antialiasing), weights
    normalised per output pixel, outputs whose sample lies outside the
    input zero. Numpy, step for step in float32, so the transforms (host
    numpy) and ``interpolate`` (tensors) share it."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@op
def _interp(x, size, data_format):
    """Linear resize with ``jax.image.resize``'s arithmetic: one weight
    matrix a resized spatial dim, contracted in ``x``'s type."""
    axes = _spatial_axes(x, data_format, size)
    out = x
    for ax, osz in zip(axes, size):
        n = out.shape[ax]
        if n == osz:
            continue
        w = torch.from_numpy(linear_resize_weights(n, osz)).to(
            device=x.device, dtype=x.dtype)
        out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


def _spatial_axes(x, data_format, size=None):
    axes = (range(2, x.dim()) if data_format.startswith("NC")
            else range(1, x.dim() - 1))
    if size is not None and len(size) != len(axes):
        raise ValueError(
            f"interpolate: size has {len(size)} element(s) but the input "
            f"has {len(axes)} spatial dim(s) for data_format {data_format}")
    return axes


@op
def _interp_nearest(x, size, data_format, align_corners):
    """Nearest: ``src = floor(dst * in / out)``, or with ``align_corners``
    ``round(dst * (in - 1) / (out - 1))`` half away from zero."""
    out = x
    for ax, osz in zip(_spatial_axes(x, data_format, size), size):
        n = out.shape[ax]
        dst = torch.arange(osz, dtype=torch.float32, device=x.device)
        if align_corners:
            c = torch.floor(dst * ((n - 1) / max(osz - 1, 1)) + 0.5)
        else:
            c = torch.floor(dst * (n / osz))
        idx = torch.clamp(c.long(), 0, n - 1)
        out = torch.index_select(out, ax, idx)
    return out


def _cubic_weights(t, a=-0.75):
    """Cubic-convolution weights of the 4 taps around offset ``t``
    (a = -0.75, the reference's constant)."""
    def near(d):
        return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0

    def far(d):
        return ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a

    return far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)


@op
def _interp_cubic(x, size, data_format):
    out = x
    for ax, osz in zip(_spatial_axes(x, data_format, size), size):
        n = out.shape[ax]
        if osz == n:
            continue
        c = (torch.arange(osz, dtype=torch.float32, device=x.device) + 0.5) \
            * (n / osz) - 0.5
        i0 = torch.floor(c)
        t = (c - i0).to(out.dtype)
        taps = [torch.clamp(i0.long() + k, 0, n - 1) for k in (-1, 0, 1, 2)]
        wshape = [1] * out.dim()
        wshape[ax] = osz
        out = sum(torch.index_select(out, ax, idx) * w.reshape(wshape)
                  for idx, w in zip(taps, _cubic_weights(t)))
    return out


@op
def _interp_align_corners(x, size, data_format):
    out = x
    for ax, osz in zip(_spatial_axes(x, data_format, size), size):
        n = out.shape[ax]
        if osz == n:
            continue
        c = torch.arange(osz, dtype=torch.float32, device=x.device) \
            * ((n - 1) / max(osz - 1, 1))
        lo = torch.floor(c).long()
        hi = torch.clamp(lo + 1, max=n - 1)
        w = (c - lo).to(out.dtype)
        wshape = [1] * out.dim()
        wshape[ax] = osz
        a = torch.index_select(out, ax, lo)
        b = torch.index_select(out, ax, hi)
        out = a + (b - a) * w.reshape(wshape)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims: ``nearest``, ``bilinear``/``trilinear``/
    ``linear`` (``jax.image.resize``'s, antialiased when shrinking, or
    corner-anchored with ``align_corners``), ``bicubic`` (a = -0.75) or
    ``area`` (adaptive average pooling)."""
    spatial = x.shape[2:] if data_format.startswith("NC") else x.shape[1:-1]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size])]
    if mode == "area":
        if len(size) != len(spatial):
            raise ValueError(
                f"interpolate: size has {len(size)} element(s) but the "
                f"input has {len(spatial)} spatial dim(s) for data_format "
                f"{data_format!r}")
        nd = len(size)
        pool = {1: adaptive_avg_pool1d, 2: adaptive_avg_pool2d,
                3: adaptive_avg_pool3d}[nd]
        arg = size[0] if nd == 1 else size
        if data_format.startswith("NC"):
            return pool(x, arg)
        return _nc_last(pool(_nc_first(x), arg))
    if mode == "nearest":
        return _interp_nearest(x, tuple(size), data_format,
                               bool(align_corners))
    if mode == "bicubic":
        if align_corners:
            raise NotImplementedError(
                "interpolate(mode='bicubic', align_corners=True) is not "
                "implemented; use align_corners=False or a linear mode")
        return _interp_cubic(x, tuple(size), data_format)
    if mode not in ("bilinear", "trilinear", "linear"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    if align_corners:
        return _interp_align_corners(x, tuple(size), data_format)
    return _interp(x, tuple(size), data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format=data_format)


# -------------------------------------------------------- the common layers'
@op
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    N, C, H, W = x.shape
    out = x.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(N, C // (r * r), H * r, W * r)


@op
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    if data_format == "NCHW":
        B, C, H, W = x.shape
        xr = x.reshape(B, C, H // r, r, W // r, r)
        return xr.permute(0, 1, 3, 5, 2, 4).reshape(B, C * r * r, H // r,
                                                    W // r)
    B, H, W, C = x.shape
    # (c, ry, rx) channel order, as the NCHW branch: the two layouts are
    # transposes of each other
    xr = x.reshape(B, H // r, r, W // r, r, C)
    return xr.permute(0, 1, 3, 5, 2, 4).reshape(B, H // r, W // r,
                                                C * r * r)


@op
def channel_shuffle(x, groups, data_format="NCHW"):
    """Interleave channels across ``groups`` (ShuffleNet's mixing)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(
            f"data_format must be 'NCHW' or 'NHWC', got {data_format!r}")
    channels = x.shape[1] if data_format == "NCHW" else x.shape[3]
    if groups <= 0 or channels % groups != 0:
        raise ValueError(
            f"channels ({channels}) must be divisible by groups ({groups})")
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, groups, C // groups, H, W).transpose(1, 2)
        return out.reshape(N, C, H, W)
    N, H, W, C = x.shape
    out = x.reshape(N, H, W, groups, C // groups).transpose(3, 4)
    return out.reshape(N, H, W, C)


@op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C * kh * kw, L]``, channel-major as the reference's
    patches."""
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings), _pair(strides))


@op
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of :func:`unfold`: overlapping patches add."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   _pair(dilations), _pair(paddings), _pair(strides))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@op
def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    C = x.shape[axis]
    if C % groups != 0:
        raise ValueError(f"channels ({C}) not divisible by groups ({groups})")
    shape = tuple(x.shape[:axis]) + (C // groups, groups) \
        + tuple(x.shape[axis + 1:])
    return torch.amax(x.reshape(shape), dim=axis + 1)


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1 [B, in1], x2 [B, in2], weight [out, in1, in2] -> [B, out]."""
    out = _bilinear_impl(x1, x2, weight)
    if bias is not None:
        out = out + bias
    return out


@op
def _bilinear_impl(x1, x2, w):
    return torch.einsum("bi,oij,bj->bo", x1, w, x2)


@op
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


@op
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, random_mod.next_key(), float(p))


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole channel maps: the mask shared per (batch,
    channel)."""
    if not training or p == 0.0:
        return x
    mask_shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
    return _alpha_dropout(x, random_mod.next_key(), float(p),
                          mask_shape=mask_shape)


@op
def _alpha_dropout(x, key, p, mask_shape=None):
    alpha = 1.6732632423543772
    scale_ = 1.0507009873554805
    alpha_p = -alpha * scale_
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = _mask(key, keep, mask_shape if mask_shape else tuple(x.shape),
                 x.device)
    kept = torch.where(mask, x, torch.full((), alpha_p, dtype=x.dtype,
                                           device=x.device))
    return (a * kept + b).to(x.dtype)
