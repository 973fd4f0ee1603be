"""Head-major training (``attention_layout="bhsd"``, with and without
``fuse_rope``) and ``recompute_policy="dots"`` in the port, on the CPU.

The model's loss and every parameter gradient on ``llama_tiny`` are held
to the JAX model with the same weights on two JAX paths: its default CPU
path (``_attention_bhsd``'s jnp fallback, which rotates Q and K itself)
and its Pallas kernels forced through interpret mode (the test patches
``paddle_tpu.models.llama._attention_bhsd`` as
``tests/test_models.py::test_fuse_rope_matches_unfused`` does, with the
config's 16-row blocks so that a 40-token sequence walks three tiles and
a tail; restored after). Tolerances are ``tests/test_torch_train.py``'s:
``LOSS_RTOL`` relative on the loss, ``GRAD_TOL`` of each tensor's largest
entry on its gradient (float32; the frameworks sum in other orders).

Each JAX model and its gradients are built once per file (a
module-scoped cache). ``dots`` is held to ``full`` bit for bit, and a
dispatch-mode count of the matrix products the backward runs shows that
it recomputes none of the seven projections a layer.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

import paddle_tpu as paddle
import paddle_tpu.models.llama as jllama
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.serving.decode import llama_decode_params as j_params
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from torch_threads import one_torch_thread  # noqa: F401


LOSS_RTOL = 1e-5          # tests/test_torch_train.py's
GRAD_TOL = 1e-5
LAYERS = 2
B, S = 2, 40
BLOCK = 16

#: llama_tiny has 4 query heads; 2 KV heads (its default) is the GQA case
CONFIGS = {
    "bhsd_gqa": dict(attention_layout="bhsd"),
    "bhsd_mha": dict(attention_layout="bhsd", num_key_value_heads=4),
    "rope_gqa": dict(attention_layout="bhsd", fuse_rope=True),
    "rope_mha": dict(attention_layout="bhsd", fuse_rope=True,
                     num_key_value_heads=4),
}


def _cfg(name):
    return dict(CONFIGS[name], num_hidden_layers=LAYERS,
                flash_block_q=BLOCK, flash_block_k=BLOCK)


def _ids(seed=7):
    return np.random.RandomState(seed).randint(0, 256, (B, S)) \
        .astype(np.int32)


def _pallas_interpret(q, k, v, nh, rope=None, block_q=0, block_k=0):
    """``_attention_bhsd`` through the Pallas kernels (interpret mode):
    K/V repeated to the query heads, heads folded into the batch, as
    ``paddle_tpu/models/llama.py:174-188`` does on a TPU."""
    import jax.numpy as jnp
    Bq, Hq, Sq, D = q.shape
    G = Hq // k.shape[1]
    k, v = jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1)
    o = jflash.flash_attention_bhsd(
        q.reshape(Bq * Hq, Sq, D), k.reshape(Bq * Hq, Sq, D),
        v.reshape(Bq * Hq, Sq, D), causal=True, block_q=block_q,
        block_k=block_k, rope=rope)
    return o.reshape(Bq, Hq, Sq, D)


def _jax_run(name, path):
    """The JAX model's loss, parameter gradients and weights."""
    jmesh._STATE["mesh"] = None
    paddle.seed(21)
    jm = JLlama(j_tiny(**_cfg(name)))
    ids = paddle.to_tensor(_ids())
    orig = jllama._attention_bhsd
    if path == "interpret":
        jllama._attention_bhsd = _pallas_interpret
        jflash._FORCE_INTERPRET[0] = True
    try:
        loss = jm(ids, ids)
        loss.backward()
    finally:
        jllama._attention_bhsd = orig
        jflash._FORCE_INTERPRET[0] = False
    p, tied = j_params(jm)
    grads = {n: np.asarray(getattr(jm, n).grad.value, np.float32)
             for n in PARAMS}
    return float(loss), grads, ({k: np.asarray(v) for k, v in p.items()},
                                tied)


PARAMS = ("embed_tokens", "wq", "wk", "wv", "wo", "w_gate", "w_up",
          "w_down", "input_ln", "post_ln", "final_norm", "lm_head")


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name, path):
        if (name, path) not in cache:
            cache[(name, path)] = _jax_run(name, path)
        return cache[(name, path)]
    return get


def _port(cfg, weights, **over):
    tm = LlamaForCausalLM(llama_tiny(**dict(cfg, **over)), device="cpu")
    load_decode_params(tm, *weights)
    ids = torch.from_numpy(_ids()).long()
    loss = tm(ids, ids)
    loss.backward()
    return loss.detach(), {n: getattr(tm, n).grad for n in PARAMS}


@pytest.mark.parametrize("path", ["jnp", "interpret"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_jax(jax_runs, name, path):
    jloss, jgrads, weights = jax_runs(name, path)
    loss, grads = _port(_cfg(name), weights)
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    for n in PARAMS:
        want = jgrads[n]
        err = np.max(np.abs(grads[n].numpy() - want))
        assert err <= GRAD_TOL * np.max(np.abs(want)), (n, err)


def test_fused_rope_equals_unfused_rotation(jax_runs):
    """On the CPU the fused mode's plain versions rotate Q and K exactly
    as the unfused branch does: the same bits."""
    weights = jax_runs("rope_gqa", "jnp")[2]
    a = _port(_cfg("rope_gqa"), weights)
    b = _port(_cfg("bhsd_gqa"), weights)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][n], b[1][n]) for n in PARAMS)


class _MatmulCount(TorchDispatchMode):
    """Counts the ``aten.mm`` calls that reach the dispatcher (a product
    that selective checkpointing serves from its cache never does), and
    among them the forward projections: a layer weight as the right
    operand, untransposed (the backward's products take its transpose or
    no weight at all)."""

    def __init__(self, weights):
        super().__init__()
        self.storages = {w.untyped_storage().data_ptr() for w in weights}
        self.mm = self.projections = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
            w = args[1]
            if w.untyped_storage().data_ptr() in self.storages \
                    and w.stride(1) == 1:
                self.projections += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(cfg, weights, early_stop=True, **over):
    tm = LlamaForCausalLM(llama_tiny(**dict(cfg, **over)), device="cpu")
    load_decode_params(tm, *weights)
    ids = torch.from_numpy(_ids()).long()
    stack = [getattr(tm, n) for n in ("wq", "wk", "wv", "wo", "w_gate",
                                      "w_up", "w_down")]
    with set_checkpoint_early_stop(early_stop):
        loss = tm(ids, ids)
        with _MatmulCount(stack) as count:
            loss.backward()
    return count, {n: getattr(tm, n).grad for n in PARAMS}


@pytest.mark.parametrize("name", ["rope_gqa", "bhsd_mha"])
def test_dots_saves_the_seven_projections(jax_runs, name):
    """``recompute_policy="dots"``: gradients bit for bit ``full``'s; its
    backward re-runs none of the seven forward projections and so runs
    exactly the matrix products of a backward without recompute. ``full``
    re-runs them: all seven a layer without the checkpoint's early stop,
    six with it (the down projection's output is needed by no backward
    product, so the recompute stops before it)."""
    weights = jax_runs(name, "jnp")[2]
    none, g_none = _backward_matmuls(_cfg(name), weights,
                                     use_recompute=False)
    for early_stop, rerun in ((True, 6), (False, 7)):
        full, g_full = _backward_matmuls(_cfg(name), weights, early_stop)
        dots, g_dots = _backward_matmuls(_cfg(name), weights, early_stop,
                                         recompute_policy="dots")
        assert none.projections == dots.projections == 0
        assert full.projections == rerun * LAYERS
        assert dots.mm == none.mm and full.mm == none.mm + rerun * LAYERS
        assert all(torch.equal(g_dots[n], g_full[n]) for n in PARAMS)
        assert all(torch.equal(g_none[n], g_full[n]) for n in PARAMS)
