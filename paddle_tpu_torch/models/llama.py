"""LLaMA-2 family for serving and training, in PyTorch.

The counterpart of ``paddle_tpu/models/llama.py``: the same configuration
dataclass and presets, the same numerical helpers (rotary tables, neox
rotation, QKV split, SwiGLU, RMSNorm with its cast points), and the same
STACKED parameter layout — every decoder weight carries a leading layer
dimension (``wq [L, H, nh*hd]`` … ``w_down [L, I, H]``), so the serving
programs and the training forward walk the layers by indexing one tensor
per weight, as the JAX package's ``lax.scan`` does.

:meth:`LlamaForCausalLM.forward` is the single-device branch of the JAX
``_llama_forward``: embedding gather, the layer loop in the ``bshd`` or
the head-major ``bhsd`` layout (attention through the flash kernels and
their backward; under ``bhsd`` with ``fuse_rope`` the kernels rotate Q and
K themselves), per-layer recompute (``torch.utils.checkpoint`` in place
of ``jax.checkpoint``: the whole layer, or under
``recompute_policy="dots"`` everything but the seven projections), the
final norm, then logits or the shifted cross-entropy (unfused, or in
``loss_chunk`` chunks under checkpoint).
Gradients come from PyTorch's autograd; the parameters are trainable,
and the serving programs run under ``torch.inference_mode`` so they
record no graph.

Weights come either from a seeded init (normal 0.02, ones for the norms,
through a ``torch.Generator`` — what ``chip_smoke.py`` uses, where no JAX
exists) or from the JAX model through :func:`load_decode_params`.
"""
from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# _rotate_half: the serving programs rotate at offset positions with it
from ..kernels.flash import _rotate_half  # noqa: F401
from ..kernels.flash import flash_attention_bhsd, rope_rotate
from ..kernels.flash_attention import attention


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
    # training fields of the JAX config, same names and defaults; the
    # forward raises NotImplementedError on the mesh knobs (pipeline,
    # context parallelism: the port has no mesh) and serves the rest as
    # the reference does on one device (see _check_training_config)
    use_recompute: bool = True
    recompute_policy: str = "full"
    sequence_parallel: bool = False
    pipeline_microbatches: int = 0
    pipeline_virtual_stages: int = 1
    context_parallel: str = ""
    attention_layout: str = "bshd"
    loss_chunk: int = 0
    # the serving engine's attention: "pallas" (the reference's name) runs
    # the hand-written kernels, "jnp" their plain versions, as
    # FLAGS_use_cuda_kernels=False does; ContinuousBatchingEngine reads it
    decode_attention: str = "pallas"
    fuse_rope: bool = False
    # the reference's Pallas tile sizes (0: its default); validated as
    # non-negative ints and otherwise unused: the port's flash tiles are
    # fixed at 64 rows by 64 keys by its wgmma/mma.sync design, and their
    # tuning is ROADMAP Queue B item 6
    flash_block_q: int = 0
    flash_block_k: int = 0
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama_7b(**kw):
    return LlamaConfig(**kw)


def llama_13b(**kw):
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40, **kw)


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


#: the neox rotation of [B, S, H, D] (the JAX ``_apply_rope``): the
#: flash kernels' plain version rotates the same way
_apply_rope = rope_rotate


def _apply_rope_bhsd(x, sin, cos):
    # x: [B, H, S, D]
    return rope_rotate(x.transpose(1, 2), sin, cos).transpose(1, 2)


def _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd):
    B, S = hn.shape[0], hn.shape[1]
    q = (hn @ lwq).reshape(B, S, nh, hd)
    k = (hn @ lwk).reshape(B, S, nkv, hd)
    v = (hn @ lwv).reshape(B, S, nkv, hd)
    return q, k, v


def _qkv_bhsd(hn, lwq, lwk, lwv, nh, nkv, hd):
    """The head-major projections ``[B, nh, S, hd]`` (JAX ``"bsh,hnd->
    bnsd"``): each a view of its product, so no transpose pass touches
    memory; the flash kernels read them through their strides."""
    B, S = hn.shape[0], hn.shape[1]
    return tuple((hn @ w).view(B, S, n, hd).transpose(1, 2)
                 for w, n in ((lwq, nh), (lwk, nkv), (lwv, nkv)))


def _attention_bhsd(q, k, v, rope=None):
    """``[B, H, S, D]`` causal attention (JAX ``_attention_bhsd``,
    ``paddle_tpu/models/llama.py:167``): the flash kernels on CUDA
    tensors at every S (the reference's ``S % 128`` gate is a TPU tiling
    rule; the kernels mask any tail), their plain versions on the CPU.
    ``rope=(sin, cos)``: q/k arrive un-rotated and rotate inside the
    kernels (the plain versions rotate first, as the reference's
    fallback does). K/V keep their KV heads (no repeat). The config's
    block sizes select no tile here."""
    return flash_attention_bhsd(q, k, v, causal=True, rope=rope)


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

#: config value -> its only value in the port, which has no mesh (the
#: reference ignores the others without a ``pp``/``sep`` axis, but a
#: config that sets them asks for one)
_MESH_KNOBS = {"pipeline_microbatches": 0, "pipeline_virtual_stages": 1,
               "context_parallel": ""}


def _check_training_config(c):
    """Raise on what the port cannot serve: the mesh knobs (ROADMAP Queue
    A step 13) and block sizes the reference would not take. Every other
    training value is served as the reference serves it on one device:
    ``sequence_parallel`` is read nowhere, ``fuse_rope`` only under
    ``attention_layout="bhsd"``, ``recompute_policy`` only under
    ``use_recompute``, ``flash_block_q/k`` select no tile."""
    for name, ported in _MESH_KNOBS.items():
        value = getattr(c, name)
        if value != ported:
            raise NotImplementedError(
                f"LlamaConfig.{name}={value!r} is not ported (only "
                f"{ported!r}); see ROADMAP.md Queue A step 13")
    for name in ("flash_block_q", "flash_block_k"):
        value = getattr(c, name)
        if isinstance(value, bool) or int(value) != value or value < 0:
            raise ValueError(f"LlamaConfig.{name} must be a non-negative "
                             f"int, got {value!r}")


def _layer_body(h, lwq, lwk, lwv, lwo, lg, lu, ld, lin, lpost, sin, cos,
                nh, nkv, hd, eps, head_major=False, fuse_rope=False):
    """One decoder layer of the JAX ``layer_body``: RMSNorm, QKV, RoPE,
    causal attention through the flash kernels, o-projection, residual,
    RMSNorm, SwiGLU, residual. ``head_major`` is the ``bhsd`` branch
    (projections to ``[B, nh, S, hd]``, the o-projection from it); with
    ``fuse_rope`` there the kernels rotate Q and K (``defer_rope``)."""
    B, S = h.shape[0], h.shape[1]
    hn = _rms(h, lin, eps)
    if head_major:
        q, k, v = _qkv_bhsd(hn, lwq, lwk, lwv, nh, nkv, hd)
        if not fuse_rope:
            q = _apply_rope_bhsd(q, sin, cos)
            k = _apply_rope_bhsd(k, sin, cos)
        attn = _attention_bhsd(q, k, v,
                               rope=(sin, cos) if fuse_rope else None)
        attn = attn.transpose(1, 2)
    else:
        q, k, v = _qkv_bshd(hn, lwq, lwk, lwv, nh, nkv, hd)
        q = _apply_rope(q, sin, cos)
        k = _apply_rope(k, sin, cos)
        attn = attention(q, k, v, causal=True)
    h = h + attn.reshape(B, S, nh * hd) @ lwo
    return h + _swiglu_raw(_rms(h, lpost, eps), lg, lu, ld)


def _dots_policy(ctx, op, *args, **kwargs):
    """``recompute_policy="dots"`` (JAX ``dots_with_no_batch_dims_
    saveable``): save the products without batch dimensions — in a layer
    the seven projections q, k, v, o, gate, up and down, each one
    ``aten.mm`` — and recompute the rest (norms, rotation, SiLU,
    attention: the plain attention's products are batched, and the
    kernels launch outside the dispatcher, as the reference's
    ``pallas_call`` is no dot)."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ce_chunk(xc, t, head):
    """Sum and count of the shifted CE over one chunk, from float32 logits
    (the JAX ``ce_chunk``: ``preferred_element_type=float32``)."""
    lg = xc.float() @ head.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, t.clamp(min=0)[..., None])[..., 0]
    m = (t >= 0).float()
    return torch.sum((lse - picked) * m), torch.sum(m)


def _shifted_ce(x, head, labels, loss_chunk):
    """Mean next-token cross-entropy of ``x @ head`` against ``labels``
    shifted by one; labels < 0 are masked. ``loss_chunk > 0`` dividing S
    computes it chunk by chunk under checkpoint, so only one
    ``[B, chunk, V]`` float32 logits block is ever live."""
    B, S = labels.shape
    if loss_chunk > 0 and S % loss_chunk != 0:
        warnings.warn(
            f"loss_chunk={loss_chunk} does not divide seq_len={S}; falling "
            f"back to the unfused CE (full [B,S,V] f32 logits materialize)")
    if loss_chunk > 0 and S % loss_chunk == 0:
        tgt = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], dim=1)
        tot = x.new_zeros((), dtype=torch.float32)
        cnt = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, loss_chunk):
            s, n = checkpoint(_ce_chunk, x[:, c0:c0 + loss_chunk],
                              tgt[:, c0:c0 + loss_chunk], head,
                              use_reentrant=False)
            tot, cnt = tot + s, cnt + n
        return tot / torch.clamp(cnt, min=1.0)
    # unfused: the [B, S-1, V] logits materialize once, in float32
    lf = (x[:, :-1] @ head).float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = labels[:, 1:]
    picked = lf.gather(-1, tgt.clamp(min=0)[..., None])[..., 0]
    mask = (tgt >= 0).float()
    return torch.sum((lse - picked) * mask) / torch.clamp(torch.sum(mask),
                                                          min=1.0)


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM over stacked parameters.

    ``device`` defaults to ``"cuda"``; tests pass ``"cpu"``. ``seed``
    drives the init (normal 0.02 for matrices, ones for the norms)
    through a ``torch.Generator`` on ``device``. ``forward(input_ids)``
    returns logits, ``forward(input_ids, labels)`` the loss; the serving
    programs in ``paddle_tpu_torch/serving/decode.py`` read the same
    parameters through :func:`llama_decode_params`.
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
            with torch.no_grad():
                for sl in (out if len(shape) == 3 else (out,)):
                    sl.copy_(torch.randn(sl.shape, generator=gen,
                                         device=device) * 0.02)
            return nn.Parameter(out)

        def ones(*shape):
            return nn.Parameter(torch.ones(shape, dtype=dt, device=device))

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

    def forward(self, input_ids, labels=None, position_ids=None):
        """Logits ``[B, S, V]`` for ``input_ids [B, S]``, or with
        ``labels`` the mean shifted cross-entropy (labels < 0 masked).
        ``position_ids`` is accepted and unused, as in the JAX model:
        positions are ``0 .. S-1``."""
        c = self.config
        _check_training_config(c)
        nh, nkv, hd = c.num_attention_heads, c.num_key_value_heads, \
            c.head_dim
        eps = float(c.rms_norm_eps)
        ids = torch.as_tensor(input_ids).to(self.device).long()
        S = ids.shape[1]
        x = self.embed_tokens[ids]
        sin, cos = _rope_tables(S, hd, float(c.rope_theta), device=x.device)
        # one unbind per weight: each layer's slice is a view whose
        # gradient lands in the stacked parameter's .grad in one stack
        layers = zip(*(torch.unbind(getattr(self, k)) for k in STACK_KEYS))
        body = functools.partial(
            _layer_body, head_major=c.attention_layout == "bhsd",
            fuse_rope=bool(c.fuse_rope))
        # the reference reads recompute_policy only under use_recompute;
        # any policy but "dots" recomputes the whole layer
        ckpt = {}
        if c.recompute_policy == "dots":
            ckpt["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        for lp in layers:
            args = (x, *lp, sin, cos, nh, nkv, hd, eps)
            x = (checkpoint(body, *args, use_reentrant=False, **ckpt)
                 if c.use_recompute else body(*args))
        x = _rms(x, self.final_norm, eps)
        head = self.embed_tokens.T if self.lm_head is None else self.lm_head
        if labels is None:
            return x @ head
        labels = torch.as_tensor(labels).to(self.device).long()
        return _shifted_ce(x, head, labels, int(c.loss_chunk))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, max_cache_len=None, seed=None, eos_token_id=None):
        """Autoregressive generation over the continuous-batching engine,
        as the JAX model's ``generate``: one slot per row, exact-length
        prefill, up to 16 fused decode ticks per step (no queue to
        starve), greedy by default (``temperature > 0``: top-k sampling).
        Row ``i`` samples with ``fold_in(base, i)``, ``base`` being
        ``PRNGKey(seed)`` or else the global generator's next key. A row
        that stops at ``eos_token_id`` is padded with it (with 0 when
        there is none). Returns ``[B, max_new_tokens]`` ids on the
        model's device, in ``input_ids``' integer dtype.

        The engine's programs live on the model (``_serving_jit``), so
        a later call with the same shapes counts no new program."""
        from ..core import random as prng
        from ..serving import ContinuousBatchingEngine, GenerationRequest
        c = self.config
        ids_np = (input_ids.cpu().numpy() if torch.is_tensor(input_ids)
                  else np.asarray(input_ids))
        B, S = ids_np.shape
        s_max = int(max_cache_len or min(c.max_position_embeddings,
                                         S + max_new_tokens))
        if S + int(max_new_tokens) > s_max:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the KV cache length ({s_max}); raise max_cache_len / "
                f"max_position_embeddings or generate fewer tokens")
        base_key = (prng.PRNGKey(seed) if seed is not None
                    else prng.next_key())
        engine = ContinuousBatchingEngine(
            self, num_slots=B, max_seq_len=s_max,
            prefill_bucketing="exact", decode_chunk=16,
            jit_cache=self.__dict__.setdefault("_serving_jit", {}))
        reqs = [GenerationRequest(
            prompt=ids_np[i], max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            eos_token_id=eos_token_id,
            prng_key=prng.fold_in(base_key, i).numpy()) for i in range(B)]
        outs = engine.generate(reqs)
        pad = int(eos_token_id) if eos_token_id is not None else 0
        out = np.stack([
            np.pad(o, (0, int(max_new_tokens) - len(o)), constant_values=pad)
            for o in outs])
        return torch.as_tensor(out.astype(ids_np.dtype), device=self.device)


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


class LlamaPretrainCriterion(nn.Module):
    """Loss wrapper of the PaddleNLP criterion surface: passes a loss
    through; with ``labels``, the mean cross-entropy of logits
    ``[..., V]`` against integer labels (float32 log-softmax, label
    -100 ignored), as ``paddle_tpu.nn.functional.cross_entropy``."""

    def __init__(self, config=None):
        super().__init__()

    def forward(self, loss_or_logits, labels=None):
        if labels is None:
            return loss_or_logits
        logits = loss_or_logits
        labels = torch.as_tensor(labels).to(logits.device).long()
        if labels.dim() == logits.dim():
            labels = labels.squeeze(-1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        mask = labels != -100
        picked = logp.gather(-1, torch.where(mask, labels, 0)[..., None])
        loss = torch.where(mask, -picked[..., 0], 0.0)
        return loss.sum() / torch.clamp(mask.sum(), min=1)


__all__ = ["LlamaConfig", "llama_7b", "llama_tiny", "LlamaForCausalLM",
           "LlamaPretrainCriterion", "llama_decode_params",
           "load_decode_params", "STACK_KEYS"]
