"""The port's LLaMA training path (``paddle_tpu_torch``) against the JAX
package, on the CPU: the flash backward, the attention dispatcher's
gradients, the model's forward, loss and parameter gradients, AdamW with
the global-norm clip, and ``TrainStep``.

Inputs come from a numpy seed and reach both sides as the same arrays;
weights are the JAX model's, carried across by ``load_decode_params``.
Everything is float32 unless a test says otherwise, and each test states
its tolerance. On the CPU the port's wrappers run their plain versions;
``test_torch_on_card.py`` holds the two backward kernels (and a training
step through them) against the plain versions on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.serving.decode import llama_decode_params as j_params
from paddle_tpu_torch.flags import get_flag, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels.flash_attention import _ref_attention, attention
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainCriterion,
                                           llama_decode_params, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.serving import ContinuousBatchingEngine, \
    GenerationRequest
from paddle_tpu_torch.serving import decode as tdec
from torch_threads import one_torch_thread  # noqa: F401


# model / train-step tolerances (float32): the two frameworks sum the
# matmuls in different orders, so a loss agrees to ~1e-6 relative and a
# gradient to ~1e-6 of its tensor's largest entry
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # max|dg| <= GRAD_TOL * max|g_jax|, per parameter
PARAMS = ("embed_tokens", "wq", "wk", "wv", "wo", "w_gate", "w_up",
          "w_down", "input_ln", "post_ln", "final_norm", "lm_head")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, JTensor):
        x = x.value
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_err(got, want):
    return float(np.max(np.abs(_np(got) - _np(want))))


def _rel_err(got, want):
    return _max_err(got, want) / max(float(np.max(np.abs(_np(want)))),
                                     1e-30)


def _ids(B, S, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _pair(seed=21, **cfg):
    """The JAX tiny LLaMA and the port's, with the JAX weights."""
    paddle.seed(seed)
    jm = JLlama(j_tiny(**cfg))
    p, tied = j_params(jm)
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


# ------------------------------------------------------- (a) flash backward
class TestFlashBackwardReference:
    """``flash_attention_bwd_reference`` against ``jax.grad`` through
    ``flash_attention_pallas`` in interpret mode (the Pallas ``_dkv_kernel``
    and ``_dq_kernel`` bodies run), with ``dO`` as the cotangent.
    Tolerance: max-abs <= 1e-5 — float32 on both sides, summation order
    only."""

    @pytest.fixture(autouse=True)
    def _interpret(self):
        jflash._FORCE_INTERPRET[0] = True
        yield
        jflash._FORCE_INTERPRET[0] = False

    @pytest.mark.parametrize("S,block,H,Hk", [
        (128, 64, 4, 4),     # two tiles, causal pruning
        (200, 128, 4, 4),    # tail: 200 % 128 rows past S masked
        (128, 64, 4, 2),     # GQA: dK/dV summed over each group
        (200, 128, 4, 2),    # tail and GQA
    ])
    def test_matches_jax_grad_of_pallas(self, S, block, H, Hk):
        B, D = 1, 64
        r = np.random.RandomState(S + Hk)
        q, k, v = (r.randn(B, S, h, D).astype(np.float32) * 0.5
                   for h in (H, Hk, Hk))
        do = r.randn(B, S, H, D).astype(np.float32)

        def f(q_, k_, v_):
            o = jflash.flash_attention_pallas(q_, k_, v_, causal=True,
                                              block_q=block, block_k=block)
            return jnp.sum(o * do)
        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v))
        tq, tk, tv = _t(q), _t(k), _t(v)
        o, lse = tflash.flash_attention_fwd(tq, tk, tv, True)
        got = tflash.flash_attention_bwd_reference(tq, tk, tv, o, lse,
                                                   _t(do), True)
        assert got[1].shape == (B, S, Hk, D)
        for g, w in zip(got, want):
            assert _max_err(g, w) <= 1e-5

    def test_kernel_split_equals_whole(self):
        """The per-kernel plain versions compose into the whole backward,
        bit for bit."""
        r = np.random.RandomState(3)
        q, k, v, do = (_t(r.randn(2, 40, h, 64).astype(np.float32))
                       for h in (4, 2, 2, 4))
        o, lse = tflash.flash_attention_fwd(q, k, v, True)
        dq, dk, dv = tflash.flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do, True)
        delta = tflash.attention_delta(o, do)
        dk2, dv2 = tflash.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        dq2 = tflash.flash_bwd_dq(q, k, v, do, lse, delta, True)
        assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
            and torch.equal(dv, dv2)


# ------------------------------------------- (b) dispatcher gradients, CPU
class TestAttentionGradients:
    """On CPU tensors ``attention`` runs the flash autograd Function with
    the plain forward and the plain (formula) backward, launching no
    kernel. Its gradients match autograd through the plain forward to
    max-abs 1e-5 (float32, summation order only)."""

    @pytest.mark.parametrize("Hk", [4, 2])
    def test_plain_backward_without_launches(self, Hk):
        reset_launches()
        r = np.random.RandomState(Hk)
        q, k, v = (_t(r.randn(2, 33, h, 64).astype(np.float32))
                   .requires_grad_() for h in (4, Hk, Hk))
        do = _t(r.randn(2, 33, 4, 64).astype(np.float32))
        out = attention(q, k, v, causal=True)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, (q, k, v), do)
        want = torch.autograd.grad(_ref_attention(q, k, v, True), (q, k, v),
                                   do)
        for g, w in zip(got, want):
            assert _max_err(g, w) <= 1e-5
        assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES

    def test_expanded_output_gradient(self):
        """Autograd may hand the backward a strided gradient (here an
        expanded one from ``sum``); the Function makes it contiguous."""
        r = np.random.RandomState(5)
        q, k, v = (_t(r.randn(1, 20, 2, 64).astype(np.float32))
                   .requires_grad_() for _ in range(3))
        attention(q, k, v).sum().backward()
        want = torch.autograd.grad(_ref_attention(q, k, v, True).sum(),
                                   (q, k, v))
        for t, w in zip((q, k, v), want):
            assert _max_err(t.grad, w) <= 1e-5

    def test_flag_off_takes_plain_versions(self):
        assert get_flag("FLAGS_use_cuda_kernels") is True
        set_flags({"FLAGS_use_cuda_kernels": False})
        try:
            q = torch.zeros(1, 8, 2, 64, requires_grad=True)
            out = attention(q, q, q)
            out.sum().backward()
            assert q.grad is not None
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        with pytest.raises(KeyError):
            set_flags({"FLAGS_no_such_flag": 1})

    def test_head_dim_outside_the_kernels_raises(self):
        m = torch.zeros(1, 8, 2, 36, device="meta")
        with pytest.raises(ValueError):
            tflash.flash_bwd_dq(m, m, m, m, None, None)
        # the kernels take any D % 8 == 0 up to 256 (Queue C 7): 32 passes,
        # 36 does not
        assert tflash._check_shapes("flash_bwd_dq", *(
            torch.zeros(1, 8, 2, 32, device="meta"),) * 3)[-1] == 32
        with pytest.raises(NotImplementedError, match="head_dim 36"):
            tflash._check_shapes("flash_bwd_dq", m, m, m)


# ---------------------------------------------------- (c) the model forward
class TestModel:
    """``LlamaForCausalLM`` on ``llama_tiny`` against the JAX model with the
    same weights: logits, the unfused loss and the ``loss_chunk`` loss to
    ``LOSS_RTOL``; every parameter gradient against the JAX eager
    ``m(ids, ids).backward()`` to ``GRAD_TOL`` of its largest entry."""

    def test_logits(self):
        jm, tm = _pair()
        ids = _ids(2, 24, seed=1)
        want = jm(paddle.to_tensor(ids))
        got = tm(_t(ids))
        assert got.shape == (2, 24, 256)
        assert _rel_err(got, want) <= 1e-5

    @pytest.mark.parametrize("loss_chunk", [0, 8])
    def test_loss(self, loss_chunk):
        jm, tm = _pair(loss_chunk=loss_chunk)
        ids = _ids(2, 24, seed=2)
        ids[0, 5] = -1                      # a masked label
        want = float(jm(paddle.to_tensor(np.abs(ids)),
                        paddle.to_tensor(ids)))
        got = float(tm(_t(np.abs(ids)), _t(ids)).detach())
        assert abs(got - want) <= LOSS_RTOL * abs(want)

    def test_loss_chunk_not_dividing_warns_and_matches(self):
        _, tm = _pair(loss_chunk=7)
        ids = _t(_ids(1, 24, seed=3))
        with pytest.warns(UserWarning, match="does not divide"):
            a = tm(ids, ids)
        tm.config.loss_chunk = 0
        assert float(a.detach()) == float(tm(ids, ids).detach())

    @pytest.mark.parametrize("recompute", [True, False])
    def test_parameter_gradients(self, recompute):
        jm, tm = _pair(use_recompute=recompute)
        ids = _ids(2, 24, seed=4)
        jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jloss.backward()
        tloss = tm(_t(ids), _t(ids))
        tloss.backward()
        assert abs(float(tloss.detach()) - float(jloss)) <= \
            LOSS_RTOL * abs(float(jloss))
        for name in PARAMS:
            g = getattr(tm, name).grad
            assert g is not None and g.shape == getattr(tm, name).shape
            assert _rel_err(g, getattr(jm, name).grad) <= GRAD_TOL, name

    def test_recompute_gives_the_same_gradients(self):
        _, a = _pair(use_recompute=True)
        _, b = _pair(use_recompute=False)
        ids = _t(_ids(2, 16, seed=5))
        a(ids, ids).backward()
        b(ids, ids).backward()
        for name in PARAMS:
            assert torch.equal(getattr(a, name).grad, getattr(b, name).grad)

    def test_tied_embeddings(self):
        jm, tm = _pair(tie_word_embeddings=True)
        ids = _ids(1, 16, seed=6)
        want = float(jm(paddle.to_tensor(ids), paddle.to_tensor(ids)))
        got = float(tm(_t(ids), _t(ids)).detach())
        assert tm.lm_head is None
        assert abs(got - want) <= LOSS_RTOL * abs(want)

    @pytest.mark.parametrize("knob,value,item", [
        ("pipeline_microbatches", 2, "Queue A step 13"),
        ("context_parallel", "ring", "Queue A step 13"),
    ])
    def test_unported_knobs_raise(self, knob, value, item):
        """The mesh knobs: the port has no mesh until ROADMAP Queue A
        step 13."""
        tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, **{knob: value}),
                              device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            tm(_t(_ids(1, 8, seed=0)))

    @pytest.mark.parametrize("knob,value,ignored", [
        ("recompute_policy", "dots", False),
        ("attention_layout", "bhsd", False),
        ("fuse_rope", True, True),
        ("flash_block_q", 128, True),
        ("flash_block_k", 128, True),
        ("sequence_parallel", True, True),
    ])
    def test_served_knobs(self, knob, value, ignored):
        """Every single-device training value is served. Where the
        reference ignores it (``fuse_rope`` under ``bshd``, the Pallas
        block sizes off the TPU, ``sequence_parallel``) the loss and every
        gradient equal the default config's bit for bit; ``dots`` saves
        what ``full`` recomputes, so it gives the same bits too; ``bhsd``
        within ``LOSS_RTOL``/``GRAD_TOL`` of the default. Each equals the
        JAX model's for the same config within those bounds."""
        jm, tm = _pair(**{knob: value})
        _, base = _pair()
        ids = _ids(2, 24, seed=4)
        jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jloss.backward()
        got, want = (m(_t(ids), _t(ids)) for m in (tm, base))
        got.backward()
        want.backward()
        if ignored or knob == "recompute_policy":
            assert torch.equal(got, want)
        assert abs(float(got.detach()) - float(want.detach())) <= \
            LOSS_RTOL * abs(float(want.detach()))
        assert abs(float(got.detach()) - float(jloss)) <= \
            LOSS_RTOL * abs(float(jloss))
        for name in PARAMS:
            g, g0 = getattr(tm, name).grad, getattr(base, name).grad
            if ignored or knob == "recompute_policy":
                assert torch.equal(g, g0), name
            assert _rel_err(g, g0) <= GRAD_TOL, name
            assert _rel_err(g, getattr(jm, name).grad) <= GRAD_TOL, name

    def test_block_sizes_must_be_non_negative_ints(self):
        for value in (-1, 1.5):
            tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                             flash_block_q=value),
                                  device="cpu")
            with pytest.raises(ValueError, match="non-negative int"):
                tm(_t(_ids(1, 8, seed=0)))

    def test_pretrain_criterion(self):
        """Against ``paddle_tpu.nn.functional.cross_entropy`` through the
        JAX criterion (label -100 ignored); 1e-6 relative."""
        from paddle_tpu.models.llama import LlamaPretrainCriterion as JCrit
        r = np.random.RandomState(7)
        logits = r.randn(2, 5, 11).astype(np.float32)
        labels = r.randint(0, 11, (2, 5)).astype(np.int64)
        labels[1, 2] = -100
        want = float(JCrit()(paddle.to_tensor(logits),
                             paddle.to_tensor(labels)))
        crit = LlamaPretrainCriterion()
        got = float(crit(_t(logits), _t(labels)))
        assert abs(got - want) <= 1e-6 * abs(want)
        loss = torch.tensor(3.0)
        assert crit(loss) is loss


# ------------------------------------------------------- (d) the optimizer
class TestAdamW:
    """AdamW + ClipGradByGlobalNorm(0.5) over five steps of identical
    gradients (the clip binds: the gradients' norm is above 0.5), decay
    on with an ``apply_decay_param_fun`` that exempts the norm weight,
    against the JAX optimizers' eager ``step()``. float32 parameters agree
    to 1e-6; bfloat16 parameters to one bf16 ulp (the two sides may round
    a master value that sits on a rounding boundary differently), and
    their float32 masters to 1e-6."""

    SHAPES = {"w": (8, 6), "norm": (6,), "b": (5,)}

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_five_steps_match_jax(self, dtype):
        r = np.random.RandomState(11)
        init = {n: r.randn(*s).astype(np.float32) * 0.1
                for n, s in self.SHAPES.items()}
        grads = [{n: r.randn(*s).astype(np.float32) * 0.3
                  for n, s in self.SHAPES.items()} for _ in range(5)]
        jdt = jnp.dtype(dtype)
        tdt = getattr(torch, dtype)
        jp = {n: JParameter(jnp.asarray(v).astype(jdt), name=n)
              for n, v in init.items()}
        tp = {n: torch.nn.Parameter(_t(v).to(tdt)) for n, v in init.items()}
        decay = lambda name: name != "norm"          # noqa: E731
        jopt = JAdamW(learning_rate=0.01, parameters=list(jp.values()),
                      weight_decay=0.1, apply_decay_param_fun=decay,
                      grad_clip=JClip(0.5))
        topt = AdamW(learning_rate=0.01, parameters=list(tp.items()),
                     weight_decay=0.1, apply_decay_param_fun=decay,
                     grad_clip=ClipGradByGlobalNorm(0.5))
        for g in grads:
            for n in self.SHAPES:
                jp[n].grad = JTensor(jnp.asarray(g[n]).astype(jdt))
                tp[n].grad = _t(g[n]).to(tdt)
            jopt.step()
            topt.step()
            for n in self.SHAPES:
                a, b = _np(tp[n]), _np(jp[n])
                if dtype == "float32":
                    assert np.max(np.abs(a - b)) <= 1e-6, n
                else:
                    ulp = np.spacing(np.abs(b).astype(np.float32)) * 2 ** 16
                    assert np.all(np.abs(a - b) <= ulp), n
                    jm = jopt._slots[id(jp[n])]["master"]
                    tm = topt._slots[id(tp[n])]["master"]
                    assert _max_err(tm, jm) <= 1e-6, n
        assert topt._step_count == 5

    def test_adam_and_state_dict_round_trip(self):
        p = torch.nn.Parameter(torch.ones(4))
        opt = Adam(learning_rate=0.1, parameters=[p], weight_decay=0.5)
        p.grad = torch.ones(4)
        opt.step()
        # coupled L2: g + 0.5 * p enters the moments; first step moves
        # each weight by lr exactly (mhat / sqrt(vhat) = 1)
        assert torch.allclose(p.detach(), torch.full((4,), 0.9))
        state = opt.state_dict()
        assert set(state) == {"param_0.moment1", "param_0.moment2", "@step"}
        opt2 = Adam(learning_rate=0.1, parameters=[p])
        opt2.set_state_dict(state)
        assert opt2._step_count == 1
        assert torch.equal(opt2._slots[id(p)]["moment1"], state[
            "param_0.moment1"])
        opt.set_lr(0.5)
        assert opt.get_lr() == 0.5

    def test_lr_scheduler_raises(self):
        with pytest.raises(NotImplementedError, match="Queue A step 12"):
            AdamW(learning_rate=object(), parameters=[])

    def test_clip_matches_jax(self):
        """The clipped gradients themselves, bf16 and f32: the norm in
        float32, each gradient scaled in float32 and cast back."""
        r = np.random.RandomState(2)
        gs = [r.randn(7, 3).astype(np.float32), r.randn(4).astype(np.float32)]
        for dt in ("float32", "bfloat16"):
            jg = [(None, JTensor(jnp.asarray(g).astype(dt))) for g in gs]
            tg = [(None, _t(g).to(getattr(torch, dt))) for g in gs]
            want = JClip(1.0)(jg)
            got = ClipGradByGlobalNorm(1.0)(tg)
            for (_, a), (_, b) in zip(got, want):
                assert a.dtype == getattr(torch, dt)
                assert _max_err(a, b) <= (1e-6 if dt == "float32" else 4e-3)


# ------------------------------------------------------- (e) the train step
class TestTrainStep:
    """``TrainStep`` on ``llama_tiny`` against the JAX ``TrainStep``
    (AdamW lr 1e-3 with ClipGradByGlobalNorm(1.0), as ``bench.py`` wires
    it): three ``step``s then one ``accum_step(accum=2)``. Losses agree
    to ``LOSS_RTOL`` relative. Parameters after each step agree to 3e-5
    absolute: Adam divides each gradient by its own root mean square, so
    an entry whose gradient is near zero turns the gradients' 1e-6
    relative difference into a visible share of its ~lr = 1e-3 step
    (1.6e-5 at worst on these seeds); 3e-5 is 3% of one step."""

    def test_steps_and_accum_step_match_jax(self):
        jm, tm = _pair(seed=5)
        ids = _ids(4, 24, seed=8)
        jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                      grad_clip=JClip(1.0))
        jstep = JTrainStep(jm, lambda loss, _lab: loss, jopt)
        topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
        tstep = TrainStep(tm, lambda loss, _lab: loss, topt)
        ji = paddle.to_tensor(ids)
        losses = []
        for i in range(4):
            if i < 3:
                jl = float(jstep.step((ji, ji), (ji,)))
                tl = float(tstep.step((_t(ids), _t(ids)), (_t(ids),)))
            else:
                jl = float(jstep.accum_step((ji, ji), (ji,), 2))
                tl = float(tstep.accum_step((_t(ids), _t(ids)), (_t(ids),),
                                            2))
            assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
            for name in PARAMS:
                err = _max_err(getattr(tm, name), getattr(jm, name))
                assert err <= 3e-5, (i, name, err)
            losses.append(tl)
        assert losses[2] < losses[0]
        assert float(tstep.eval_step((_t(ids), _t(ids)), (_t(ids),))) < \
            losses[3]

    def test_check_nan_inf_raises_after_the_update(self):
        set_flags({"FLAGS_check_nan_inf": True})
        try:
            _, tm = _pair(num_hidden_layers=1)
            opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
            step = TrainStep(tm, lambda loss, _lab: loss * float("nan"), opt)
            ids = _t(_ids(1, 8, seed=9))
            with pytest.raises(RuntimeError, match="FLAGS_check_nan_inf"):
                step.step((ids, ids), (ids,))
            assert step._step_count == 1 and opt._step_count == 1
        finally:
            set_flags({"FLAGS_check_nan_inf": False})

    @pytest.mark.parametrize("knob,value", [
        ("mesh", object()), ("sharding_stage", 2), ("loss_scale", 1.0),
        ("donate", False)])
    def test_unported_options_raise(self, knob, value):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(None, None, None, **{knob: value})

    def test_accum_needs_a_divisible_batch(self):
        _, tm = _pair(num_hidden_layers=1)
        step = TrainStep(tm, lambda loss, _lab: loss,
                         AdamW(parameters=tm.parameters()))
        ids = _t(_ids(3, 8, seed=1))
        with pytest.raises(ValueError, match="divisible"):
            step.accum_step((ids, ids), (ids,), 2)


# ------------------------------------------ (f) serving records no graph
class TestServingRecordsNoGraph:
    """The parameters are trainable now; the serving programs and the
    engine run under ``torch.inference_mode``, so nothing they return
    carries an autograd graph."""

    def test_programs_and_engine(self):
        _, tm = _pair()
        assert all(p.requires_grad for p in tm.parameters())
        params, tied = llama_decode_params(tm)
        c = tm.config
        ids = _ids(2, 12, seed=3)
        pk, pv, tok, _ = tdec._prefill_impl(
            [params], ids, np.array([12, 9]), np.zeros((2, 2), np.int64),
            np.zeros(2, np.float32), np.zeros(2, np.int32),
            nh=c.num_attention_heads, nkv=c.num_key_value_heads,
            hd=c.head_dim, eps=c.rms_norm_eps, theta=c.rope_theta,
            tied=tied)
        for t in (*pk, *pv, tok):
            assert not t.requires_grad and t.grad_fn is None
        eng = ContinuousBatchingEngine(tm, num_slots=2, max_seq_len=64,
                                       prefix_block_size=8, prefill_chunk=16)
        seqs = [eng.submit(GenerationRequest(prompt=_ids(1, n, seed=n)[0],
                                             max_new_tokens=5))
                for n in (7, 20)]
        while eng.has_work():
            eng.step()
        assert all(len(s.tokens) == 5 for s in seqs)
        for pool in (*eng.cache.pool.k, *eng.cache.pool.v):
            assert not pool.requires_grad and pool.grad_fn is None
        assert all(p.grad is None for p in tm.parameters())
