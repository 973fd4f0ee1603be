"""LLaMA-2 family for serving, in PyTorch.

The counterpart of ``paddle_tpu/models/llama.py``: the same configuration
dataclass and presets, the same numerical helpers (rotary tables, neox
rotation, QKV split, SwiGLU, RMSNorm with its cast points), and the same
STACKED parameter layout — every decoder weight carries a leading layer
dimension (``wq [L, H, nh*hd]`` … ``w_down [L, I, H]``), so the serving
programs walk the layers by indexing one tensor per weight, as the JAX
package's ``lax.scan`` does. Only the serving path is ported; there is no
training forward here.

Weights come either from a seeded init (normal 0.02, ones for the norms,
through a ``torch.Generator`` — what ``chip_smoke.py`` uses, where no JAX
exists) or from the JAX model through :func:`load_decode_params`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # "cuda" routes the serving attention through the hand-written CUDA
    # kernels of ``paddle_tpu_torch/kernels`` (their plain PyTorch
    # versions on CPU tensors); "torch" calls the plain versions on any
    # device — the A/B switch mirroring the JAX config's "pallas"|"jnp"
    decode_attention: str = "cuda"
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama_7b(**kw):
    return LlamaConfig(**kw)


def llama_tiny(**kw):
    """Test/dryrun config."""
    defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=4, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
    defaults.update(kw)
    return LlamaConfig(**defaults)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name):
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{name!r}")
    return _DTYPES[name]


def _rope_tables(seq_len, head_dim, theta, device="cpu"):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)


def _apply_rope(x, sin, cos):
    # x: [B, S, H, D] neox-style; the product runs in the promoted type
    # and casts back to x.dtype, as the JAX helper does
    return (x * cos[None, :, None, :]
            + _rotate_half(x) * sin[None, :, None, :]).to(x.dtype)


def _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd):
    B, S = hn.shape[0], hn.shape[1]
    q = (hn @ lwq).reshape(B, S, nh, hd)
    k = (hn @ lwk).reshape(B, S, nkv, hd)
    v = (hn @ lwv).reshape(B, S, nkv, hd)
    return q, k, v


def _swiglu_raw(hn, lg, lu, ld):
    return (torch.nn.functional.silu(hn @ lg) * (hn @ lu)) @ ld


def _rms(x, w, eps):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    # cast back BEFORE the weight multiply (the JAX helper's cast point)
    return out.to(x.dtype) * w


#: stacked decoder weights, in the order the serving programs unpack them
STACK_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "input_ln", "post_ln")


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM holding the stacked serving parameters.

    ``device`` defaults to ``"cuda"``; tests pass ``"cpu"``. ``seed``
    drives the init (normal 0.02 for matrices, ones for the norms)
    through a ``torch.Generator`` on ``device``. There is no forward:
    the serving programs in ``paddle_tpu_torch/serving/decode.py`` read
    the parameters through :func:`llama_decode_params`.
    """

    def __init__(self, config: LlamaConfig, device="cuda", seed=0):
        super().__init__()
        self.config = c = config
        H, I, V, L = (c.hidden_size, c.intermediate_size, c.vocab_size,
                      c.num_hidden_layers)
        nh, nkv, hd = c.num_attention_heads, c.num_key_value_heads, \
            c.head_dim
        dt = torch_dtype(c.dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def normal(*shape):
            # one layer at a time: a float32 draw of a whole 7B stack
            # would need 4 bytes per weight of scratch
            out = torch.empty(shape, dtype=dt, device=device)
            for sl in (out if len(shape) == 3 else (out,)):
                sl.copy_(torch.randn(sl.shape, generator=gen,
                                     device=device) * 0.02)
            return nn.Parameter(out, requires_grad=False)

        def ones(*shape):
            return nn.Parameter(torch.ones(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.embed_tokens = normal(V, H)
        self.wq = normal(L, H, nh * hd)
        self.wk = normal(L, H, nkv * hd)
        self.wv = normal(L, H, nkv * hd)
        self.wo = normal(L, nh * hd, H)
        self.w_gate = normal(L, H, I)
        self.w_up = normal(L, H, I)
        self.w_down = normal(L, I, H)
        self.input_ln = ones(L, H)
        self.post_ln = ones(L, H)
        self.final_norm = ones(H)
        self.lm_head = None if c.tie_word_embeddings else normal(H, V)

    @property
    def device(self):
        return self.embed_tokens.device

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


def llama_decode_params(model):
    """The stacked parameter dict (+ tied flag) the serving programs take,
    keyed like ``paddle_tpu.serving.decode.llama_decode_params``."""
    p = {k: getattr(model, k) for k in STACK_KEYS}
    p["embed"] = model.embed_tokens
    p["final_norm"] = model.final_norm
    tied = model.lm_head is None
    p["lm_head"] = model.embed_tokens if tied else model.lm_head
    return p, tied


def load_decode_params(model, params, tied):
    """Fill ``model`` from the dict ``paddle_tpu.serving.decode.
    llama_decode_params`` returns (values converted to numpy by the
    caller): same names, same shapes. ``tied`` must match the model's
    ``tie_word_embeddings``."""
    if bool(tied) != (model.lm_head is None):
        raise ValueError(f"tied={tied} does not match the model "
                         f"(tie_word_embeddings="
                         f"{model.config.tie_word_embeddings})")
    own, _ = llama_decode_params(model)
    with torch.no_grad():
        for name, dst in own.items():
            if name == "lm_head" and tied:
                continue
            src = torch.as_tensor(np.array(params[name]))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return model


__all__ = ["LlamaConfig", "llama_7b", "llama_tiny", "LlamaForCausalLM",
           "llama_decode_params", "load_decode_params", "STACK_KEYS"]
