"""Continuous-batching engine, in PyTorch.

The port of ``paddle_tpu/serving/engine.py``'s ``ContinuousBatchingEngine``.
Its default settings: a paged KV pool (:class:`~.kv_cache.
PagedKVCache`), chunked prefill (``prefill_chunk=512``)
and the unified ragged step (``ragged_step=True``): every :meth:`step`
admits queued requests into free slots (short prompts take one bucketed
cold prefill per group, long prompts enter chunked prefill), then runs ONE
unified step — every running slot a span-1 decode row, every planned
prefill chunk a span-n row of one packed buffer — with up to
``decode_chunk`` fused decode ticks when nothing else is pending, and
retires sequences at EOS or their token budget.

More decode programs ride the same engine:

- ``fused_tick=True``: every tail tick of the unified step is ONE launch
  of the fused-tick kernel (``kernels/fused_decode_tick.py``) instead of
  the scanned per-layer stack;
- ``paged_attn=False``: the dense-slot engine — a :class:`~.kv_cache.
  SlotKVCache`, one-shot cold prefill (``prefill_chunk`` is validated,
  then ignored; ``ragged_step`` is ignored), and each step one call of
  ``decode._decode_steps_impl`` over the dense-cache decode kernel;
- ``ragged_step=False``: the two-program step, the A/B baseline the
  unified step is pinned against — at most one chunk call
  (``decode._paged_suffix_prefill_impl``), then one call of
  ``decode._paged_decode_steps_impl`` over the paged decode kernel;
- ``decode_ticks > 1`` (unified engine): every step is ONE multi-tick
  program (``decode._multitick_step_impl``): tick 0 as in the unified
  step, then up to ``decode_ticks - 1`` tail ticks under an on-device
  EOS/budget alive mask, replayed from a captured CUDA graph
  (``serving/graphs.py``; with ``fused_tick``, one fused-tick launch a
  tick), and one host sync a step; the host trims each slot at its first
  EOS or budget cut, so streams equal ``decode_ticks=1``.

Quantized serving composes with those, under the reference's rules:

- ``kv_dtype="int8" | "fp8"`` (the unified engine only): the pool stores
  int8 with per-row-per-head scale planes, or e4m3 with per-block
  planes; every append quantizes on write and the attention kernels
  read the narrow pool with its scales (``kernels/*``, quantized modes);
- ``quantize_weights=True`` (every engine): the decode parameters are
  converted once per model into int8 ``(q, scale)`` pairs
  (``decode.quantize_decode_params``, cached on the model), dequantized a
  layer at a time in each program, and in-kernel by the fused tick;
- ``quantize_activations=True`` (with ``quantize_weights``, the unified
  engine only): every projection runs int8 x int8 with int32
  accumulation; the fused tick then takes the scanned tick, as the
  reference routes it.

``prefix_cache=True`` (or a :class:`~.prefix_cache.PrefixCache`) turns on
automatic prefix caching on either cache: retiring sequences publish their
full KV blocks into a ref-counted LRU trie, and an admission whose prompt
shares a cached chain installs it (paged: zero-copy table references;
dense: one block copy a block) and prefills only the uncovered suffix
(``decode._paged_suffix_prefill_impl`` / ``_suffix_prefill_impl``).
``host_tier_bytes > 0`` puts a host-RAM spill tier behind the trie: an
evicted block spills device→host, and a lookup that runs off the resident
chain readmits the spilled continuation host→device
(:class:`~.prefix_cache.HostTier`).

``spec_decode=True`` (paged only) turns every step into ONE speculative
verify call (``decode._spec_verify_impl``): a :class:`~.drafter.Drafter`
(default :class:`~.drafter.NgramDrafter`; or :class:`~.drafter.
ModelDrafter`) proposes up to ``spec_k`` tokens a running slot, the
program scores each ``[last_token, d_1 .. d_k]`` span through the ragged
kernel and samples ``spec_k + 1`` positions a row along the key walk, the
host accepts the longest matching draft prefix plus the model's own token
at the first mismatch, and rejected draft rows go back through
``PagedKVCache.truncate``. Streams equal speculation off, greedy and
sampled. Drafts share the packed buffer's headroom with the chunk grant
(``FIFOScheduler.spec_grants``).

``priority_classes`` (a :class:`~.policy.ClassTable`, a spec string or a
mapping) with more than the neutral class turns on the multi-tenant
policy: admission by (effective class rank, TTFT slack, FIFO tick) with
per-class slot headroom (:class:`~.policy.PolicyScheduler`), and an
SLO-urgent request displaces running lower-class work by the preemption
path (``on_policy_preempt``, the ``policy_preemptions`` stat).

Offline use::

    engine = ContinuousBatchingEngine(model, num_slots=8)
    outs = engine.generate([GenerationRequest(prompt=ids, ...), ...])

``tp=N`` (with ``collective_dtype`` and ``collective_overlap``) is the
reference's tensor-parallel serving (``serving/tp.py``): every program
runs ``N`` head shards in lockstep with two reductions a layer, the paged
pool partitioned per shard, the collective ledger
(``_record_collectives``) the reference's to the byte. The shards share
the engine's device (``tp_devices``). Every engine runs its programs over
a list of shards: one at ``tp=1``.

The constructor takes the JAX engine's arguments in its order.

The surface the serving gateway (``serving/server``) and
``LlamaForCausalLM.generate`` read is the reference's: the streaming
hooks ``on_token`` / ``on_finish`` / ``on_policy_preempt``, the span
``tracer`` and the ``cost`` observatory (each site guarded by
``_tr()`` / ``_co()``, one attribute check when off), the injectable
``step_clock`` the SLO stamps read, ``restore`` / ``evict`` for recovery
by recompute, and the program cache: every serving program is handed out
of ``jit_cache`` under the reference's key, and
:meth:`decode_compilations` / :meth:`prefill_compilations` count the
argument signatures each key ran with — eager PyTorch compiles nothing,
so these are the trace counts the JAX engine reports for the same
traffic.

While the kernels are on (``FLAGS_use_cuda_kernels`` on, the config's
``decode_attention`` ``"pallas"`` and the model on CUDA) the constructor
holds the model's head geometry, and for the fused tick its widths,
against every kernel the chosen engine launches, so an engine the
kernels cannot serve raises before it admits a request.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core import random as prng
from ..flags import get_flag
from ..kernels import decode as dense_decode
from ..kernels import fused_decode_tick, paged_decode, ragged_attention
from ..kernels._launch import check_head_dim
from ..models.llama import llama_decode_params
from ..profiler.tracing import NULL_SPAN
from ..quantization import collective_wire_bytes
from .block_manager import BlockManager
from .decode import (_decode_steps_impl, _multitick_step_impl,
                     _paged_decode_steps_impl, _paged_suffix_prefill_impl,
                     _prefill_impl, _ragged_step_impl, _spec_verify_impl,
                     _suffix_prefill_impl, quantize_decode_params)
from .drafter import NgramDrafter
from .graphs import TailGraphs
from .kv_cache import PagedKVCache, PoolExhausted, SlotKVCache
from .policy import ClassTable, PolicyScheduler, select_victims
from .prefix_cache import PrefixCache
from .request import GenerationRequest, GenerationResult, Sequence
from .scheduler import FIFOScheduler
from .tp import _tp_validate, place_tp_params, tp_allreduce, tp_devices


def _kernels_on(params, config):
    """Whether the engine's programs launch the CUDA kernels: the flag on,
    the config's ``decode_attention`` ``"pallas"``, the weights on CUDA."""
    return (get_flag("FLAGS_use_cuda_kernels")
            and config.decode_attention == "pallas"
            and params["embed"].device.type == "cuda")


def _signature(arg):
    """The part of one program argument a JAX trace is keyed on: shape
    and dtype of an array or tensor (the parameter dict is the model's,
    fixed for a cache)."""
    if isinstance(arg, (np.ndarray, torch.Tensor)):
        return tuple(arg.shape), str(arg.dtype)
    return None


class _Program:
    """One serving program of the jit cache: the eager function plus the
    argument signatures it has run with. Where the JAX engine caches a
    jitted function whose ``_cache_size()`` counts its traces (one per
    signature), the port records the signatures, so the counts — and the
    compile-once contract that reads them — are the reference's."""

    __slots__ = ("fn", "signatures")

    def __init__(self, fn):
        self.fn = fn
        self.signatures = set()

    def _cache_size(self):
        return len(self.signatures)

    def __call__(self, *args, **kw):
        # keyword arguments are host-side state, not traced arguments
        # (the multi-tick program's graph holder)
        self.signatures.add(tuple(_signature(a) for a in args))
        return self.fn(*args, **kw)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a LLaMA-family model.

    ``model`` is a :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`;
    the engine runs on the model's device, and its attention follows
    ``FLAGS_use_cuda_kernels`` (on: the CUDA kernels on a CUDA model,
    their plain versions on a CPU one; off: the plain versions).

    ``prefix_block_size`` is the KV block size of the paged pool and the
    prefix trie's block size. ``prefix_blocks`` sizes the trie's budget
    (default: ``num_slots`` full-length prompts); a shared
    :class:`~.prefix_cache.PrefixCache` instance carries one trie and pool
    across engines driven from one thread, its geometry checked against
    this engine's.

    ``prefill_chunk`` bounds TTFT under mixed traffic: a prompt longer
    than it is prefilled ``prefill_chunk`` tokens per step (rounded up to
    a block multiple) through the unified step, beside the decode rows.
    The per-step chunk grant adapts to a measured tokens-per-second EWMA
    (``headroom_mult`` decode-steps' worth of time, capped at
    ``prefill_chunk``); ``headroom_mult=None`` pins it at the cap.

    ``spec_decode`` / ``spec_k`` / ``drafter``, ``host_tier_bytes`` and
    ``priority_classes`` are the reference's speculative, tiered and
    multi-tenant knobs (module docstring); like it, speculation is
    refused with ``decode_ticks > 1`` and with ``fused_tick``.
    """

    def __init__(self, model, num_slots=8, max_seq_len=None, decode_chunk=8,
                 prefill_bucketing="pow2", jit_cache=None,
                 prefix_cache=False, prefix_blocks=None,
                 prefix_block_size=32, paged_attn=True,
                 prefill_chunk=512, ragged_step=True, headroom_mult=2.0,
                 step_clock=None, spec_decode=False, spec_k=4,
                 drafter=None, decode_ticks=1, kv_dtype=None,
                 quantize_weights=False, quantize_activations=False,
                 tp=1, collective_dtype="fp",
                 host_tier_bytes=0, priority_classes=None,
                 fused_tick=False, collective_overlap=False):
        c = model.config
        # multi-tenant policy and the host tier: policy, not geometry —
        # neither changes a program's shapes or its cache key
        self.classes = ClassTable.coerce(priority_classes)
        self._policy = self.classes.active
        self._host_tier_bytes = int(host_tier_bytes)
        if self._host_tier_bytes < 0:
            raise ValueError(
                f"host_tier_bytes must be >= 0, got {host_tier_bytes}")
        if c.decode_attention not in ("pallas", "jnp"):
            raise ValueError(
                f"decode_attention must be 'pallas' or 'jnp', got "
                f"{c.decode_attention!r}")
        if prefill_bucketing not in ("pow2", "exact"):
            raise ValueError(
                f"prefill_bucketing must be 'pow2' or 'exact', got "
                f"{prefill_bucketing!r}")
        # tensor parallelism (serving/tp.py): tp=N shards every serving
        # program over heads, the paged pool partitioned per shard
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1, got {int(tp)}")
        if collective_dtype not in ("fp", "int8"):
            raise ValueError(
                f"collective_dtype must be 'fp' or 'int8', got "
                f"{collective_dtype!r}")
        self._tp = int(tp)
        # tp=1 has no shards and no wire: the effective dtype is fp
        self._coll_dtype = collective_dtype if self._tp > 1 else "fp"
        if self._tp > 1:
            if not (bool(paged_attn) and bool(ragged_step)):
                raise ValueError(
                    "tp > 1 requires the unified ragged paged engine "
                    "(paged_attn=True, ragged_step=True): tensor "
                    "parallelism shards the packed-span programs and "
                    "the block pool; the dense / two-program paths "
                    "never grew shard plumbing")
            _tp_validate(c.num_attention_heads, c.num_key_value_heads,
                         c.intermediate_size, self._tp)
            if self._coll_dtype == "int8" and c.hidden_size % self._tp:
                raise ValueError(
                    f"collective_dtype='int8' needs hidden_size "
                    f"({c.hidden_size}) divisible by tp={self._tp}: the "
                    f"quantized all-reduce chunks the activation per "
                    f"shard")
        self._coll_overlap = bool(collective_overlap)
        if self._coll_overlap and self._tp <= 1:
            raise ValueError(
                "collective_overlap=True requires tp > 1: the overlap "
                "schedule rewrites the per-layer tensor-parallel "
                "all-reduce pair, and a tp=1 engine has no collectives "
                "to overlap")
        # where the shards live: all on the model's device
        self._tp_devices = tp_devices(self._tp, model.device)
        if kv_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"kv_dtype must be None (store KV at the pool dtype), "
                f"'int8' or 'fp8', got {kv_dtype!r}")
        if kv_dtype is not None and not (paged_attn and ragged_step):
            raise ValueError(
                f"kv_dtype={kv_dtype!r} requires the unified ragged "
                f"paged engine (paged_attn=True, ragged_step=True): the "
                f"quantized pool's one upcast site is the ragged "
                f"attention kernel, and the dense / two-program paths "
                f"never grew scale-plane plumbing")
        if quantize_activations and not quantize_weights:
            raise ValueError(
                "quantize_activations=True requires "
                "quantize_weights=True: the int8xint8 projection path "
                "contracts runtime-quantized activations against the "
                "int8 weight pytree, so there is no activation-only "
                "variant")
        if quantize_activations and not (paged_attn and ragged_step):
            raise ValueError(
                "quantize_activations=True requires the unified ragged "
                "paged engine (paged_attn=True, ragged_step=True): only "
                "the packed-span programs grew the int8xint8 projection "
                "path, and a dense-path decode would silently fall back "
                "to weight-dequant matmuls")
        self._paged = bool(paged_attn)
        # the unified ragged step is the paged engine's; the dense engine
        # ignores ragged_step, as the reference does
        self._ragged = self._paged and bool(ragged_step)
        self._fused_tick = bool(fused_tick)
        if self._fused_tick and not self._ragged:
            raise ValueError(
                "fused_tick=True requires the unified ragged paged "
                "engine (paged_attn=True, ragged_step=True): the fused "
                "program is the packed-span tick body, and the dense / "
                "two-program paths never grew its dispatch site")
        if int(decode_ticks) < 1:
            raise ValueError(
                f"decode_ticks must be >= 1, got {int(decode_ticks)}")
        self._decode_ticks = int(decode_ticks)
        self._mtick = self._decode_ticks > 1
        if self._mtick and not self._ragged:
            raise ValueError(
                "decode_ticks > 1 requires the unified ragged engine "
                "(paged_attn=True, ragged_step=True): multi-tick decode "
                "is the unified step's fused tail driven past the host "
                "sync")
        # speculative decode (paged only: rollback truncates the slot's
        # private block tail): every step is ONE verify call
        self._spec = bool(spec_decode)
        if self._spec and not self._paged:
            raise ValueError(
                "spec_decode requires the paged engine (paged_attn="
                "True): draft rollback truncates the slot's private "
                "block tail, which the dense per-slot cache does not "
                "have")
        if self._spec and int(spec_k) < 1:
            raise ValueError(f"spec_k must be >= 1, got {int(spec_k)}")
        if self._mtick and self._spec:
            raise ValueError(
                "decode_ticks > 1 is incompatible with spec_decode: a "
                "speculative step is a verify launch every step, so "
                "there is no pure-decode tail to multi-tick")
        if self._fused_tick and self._spec:
            raise ValueError(
                "fused_tick=True is incompatible with spec_decode: the "
                "fused program is the one-token tick body, and a verify "
                "launch is a spec_len-token span")
        self._spec_k = int(spec_k)
        self._spec_len = self._spec_k + 1       # the sampling-walk depth
        self.drafter = None
        if self._spec:
            self.drafter = drafter if drafter is not None \
                else NgramDrafter()
        self.model = model
        self.config = c
        self._bucketing = prefill_bucketing
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len or c.max_position_embeddings)
        self._params, self._tied = llama_decode_params(model)
        self._dtype = self._params["embed"].dtype
        # quantized serving: the pool's storage mode (None / "int8" /
        # "fp8"), int8 weight-only projections, int8 x int8 projections
        self._kv_quant = kv_dtype
        self._wq8 = bool(quantize_weights)
        self._a8 = bool(quantize_activations)
        if _kernels_on(self._params, c):
            self._check_kernel_limits()
        if self._wq8:
            # converted once per model: a rebuilt engine shares the
            # pairs (and the program cache)
            qp = model.__dict__.get("_decode_qparams")
            if qp is None:
                qp = quantize_decode_params(self._params, self._tied)
                model.__dict__["_decode_qparams"] = qp
            self._params = qp
        # what the programs take: one parameter dict a shard (views of
        # the model's tensors on a shared device)
        self._shards = place_tp_params(self._params, self._tp_devices)
        bs = int(prefix_block_size)
        if bs < 1:
            raise ValueError(f"prefix_block_size must be >= 1, got {bs}")
        self.prefix_cache = None
        self._owns_pool = not isinstance(prefix_cache, PrefixCache)
        if self._paged:
            pool = self._paged_pool(prefix_cache, prefix_blocks, bs)
            self.cache = PagedKVCache(
                c.num_hidden_layers, self.num_slots, self.max_seq_len,
                c.num_key_value_heads, c.head_dim,
                dtype=self._dtype, block_size=bs,
                pool=pool, prefix_cache=self.prefix_cache,
                device=model.device, kv_dtype=self._kv_quant)
        else:
            self.cache = SlotKVCache(
                c.num_hidden_layers, self.num_slots, self.max_seq_len,
                c.num_key_value_heads, c.head_dim,
                dtype=self._dtype, device=model.device)
            if prefix_cache:
                self.prefix_cache = self._dense_trie(prefix_cache,
                                                     prefix_blocks, bs)
        self._kv_dtype = kv_dtype or str(self._dtype).replace("torch.", "")
        # chunked prefill (paged only: the dense cache has no block tables
        # to resume through, so its prefill stays one-shot). The chunk
        # rounds UP to a block multiple so every non-final chunk boundary
        # is block-aligned
        self._chunk = None
        if prefill_chunk and int(prefill_chunk) < 1:
            # validated on both engines: an A/B toggle of paged_attn must
            # not turn a hard error into a silent no-op
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None/0 to disable), "
                f"got {int(prefill_chunk)}")
        if self._paged and prefill_chunk:
            self._chunk = -(-int(prefill_chunk) // bs) * bs
        # the packed token buffer: num_slots decode rows plus the chunk
        # cap, when a prompt long enough to chunk can exist at all
        chunkable = self._chunk is not None and self._chunk < self.max_seq_len
        self._token_budget = self.num_slots + (self._chunk if chunkable
                                               else 0)
        # the verify program's packed buffer: the larger of the chunk
        # demand and every slot's full draft, not their sum (drafts share
        # the chunk headroom)
        self._spec_budget = self.num_slots + max(
            self._chunk if chunkable else 0, self.num_slots * self._spec_k)
        if headroom_mult is not None and float(headroom_mult) <= 0:
            raise ValueError(
                f"headroom_mult must be > 0 (or None for fixed-cap chunk "
                f"pacing), got {headroom_mult}")
        self._headroom_mult = (None if headroom_mult is None
                               else float(headroom_mult))
        self._clock = step_clock if step_clock is not None \
            else time.perf_counter
        # the current step's start reading of step_clock: the SLO stamps
        # quantize to it, so a step reads its clock exactly twice
        self._stamp_t = None
        self._tps_ewma = None
        self._dt_decode_ewma = None
        if self._policy:
            # the closures read the live attributes at decision time, so
            # the injected step_clock and the slot array are current
            self.scheduler = PolicyScheduler(
                decode_chunk, table=self.classes,
                clock=lambda: self._clock(),
                slot_usage=self._class_slot_usage)
        else:
            self.scheduler = FIFOScheduler(decode_chunk)
        self._slots = [None] * self.num_slots
        self._last_tok = np.zeros(self.num_slots, np.int32)
        self._temps = np.zeros(self.num_slots, np.float32)
        self._topks = np.zeros(self.num_slots, np.int32)
        # per-slot PRNG keys: uint32 values held in int64 (core/random.py)
        self._keys = np.zeros((self.num_slots, 2), np.int64)
        # serving programs, shareable across engines of one model so a
        # rebuilt engine counts as one program (model.generate and the
        # gateway's factory pass the model-level dict)
        self._jit = jit_cache if jit_cache is not None else {}
        # program-key variant tags: a quantized pool or parameter set is
        # another program of the same function (the reference's tags)
        self._kvtag = (("kv8f",) if kv_dtype == "fp8"
                       else ("kv8",) if kv_dtype else ())
        self._wtag = ("w8",) if self._wq8 else ()
        self._atag = ("a8",) if self._a8 else ()
        self._fktag = ("fk",) if self._fused_tick else ()
        # a sharded program is another program of the same function: the
        # degree and wire dtype (and the overlap schedule) key it apart
        self._tptag = ((f"tp{self._tp}", self._coll_dtype)
                       + (("ov",) if self._coll_overlap else ())
                       if self._tp > 1 else ())
        # the multi-tick tail's captured CUDA graphs and their buffers
        self._tail = TailGraphs() if self._mtick else None
        self.stats = {"steps": 0, "decode_calls": 0, "decode_steps": 0,
                      "slot_steps": 0, "active_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0,
                      "prefill_tokens_saved": 0,
                      "prefill_copy_dispatches": 0,
                      "prefill_chunks": 0, "chunk_tokens": 0,
                      "unified_steps": 0, "mtick_syncs": 0, "mtick_ticks": 0,
                      "mtick_pure_syncs": 0, "last_decode_ticks": 0,
                      "spec_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_tokens": 0,
                      "spec_last_accept": [],
                      "headroom": self._chunk or 0, "headroom_tps": 0.0,
                      "last_step_duration_s": 0.0, "last_step_tokens": 0,
                      "tokens_generated": 0, "cancelled": 0, "timeouts": 0,
                      "preemptions": 0, "restores": 0,
                      "policy_preemptions": 0}
        # fault-injection hook: called with the engine at the top of every
        # step attempt; a PoolExhausted it raises is repaired by
        # preemption, anything else propagates
        self.fault_hook = None
        # request-lifecycle tracer (profiler/tracing.py) and cost
        # observatory (profiler/cost.py): None in a bare engine; the
        # gateway installs one of each on every engine it builds
        self.tracer = None
        self.cost = None
        # streaming hooks, run on the thread driving step():
        # on_token(seq, token) for every generated token, on_finish(seq)
        # once per sequence whatever its finish reason (cancel()
        # included), on_policy_preempt(victim) just before an SLO-driven
        # displacement (never on the neutral table)
        self.on_token = None
        self.on_finish = None
        self.on_policy_preempt = None

    def _paged_pool(self, prefix_cache, prefix_blocks, bs):
        """The paged engine's block pool: ``num_slots x max_blocks`` live
        blocks, plus the trie's budget with a prefix cache (which it sets
        up as ``self.prefix_cache``); a shared cache's pool after its
        geometry checks."""
        c = self.config
        live = self.num_slots * -(-self.max_seq_len // bs)
        dtype = self._dtype
        # the storage dtype follows kv_dtype: a shared pool must match the
        # engine's quantization mode exactly
        store = (torch.float8_e4m3fn if self._kv_quant == "fp8"
                 else torch.int8 if self._kv_quant else dtype)
        if isinstance(prefix_cache, PrefixCache):
            pool = prefix_cache.pool
            want = (c.num_hidden_layers, c.num_key_value_heads, c.head_dim)
            have = (pool.num_layers, pool.num_kv_heads, pool.head_dim)
            if have != want or pool.store_dtype != store \
                    or pool.block_size != bs \
                    or pool.kv_dtype != self._kv_quant:
                raise ValueError(
                    f"shared PrefixCache pool geometry "
                    f"{have}/bs={pool.block_size}/{pool.store_dtype} does "
                    f"not match this paged engine {want}/bs={bs}/{store} "
                    f"(kv_dtype={self._kv_quant!r})")
            if pool.tp != self._tp:
                raise ValueError(
                    f"shared PrefixCache pool is partitioned for "
                    f"tp={pool.tp} but this engine runs tp={self._tp}: a "
                    f"pool's head-axis partition must match every engine "
                    f"serving from it")
            if pool.num_blocks <= live:
                raise ValueError(
                    f"shared pool of {pool.num_blocks} blocks cannot back "
                    f"{live} live blocks plus a prefix trie on the paged "
                    f"engine")
            if prefix_cache.max_blocks is None:
                # a dense-idiom cache adopted by a paged engine: bound the
                # trie to the pool's headroom over the live grid
                prefix_cache.max_blocks = pool.num_blocks - live
            self.prefix_cache = prefix_cache
            return pool
        budget = 0
        if prefix_cache:
            if prefix_blocks is None:
                budget = self.num_slots * max(self.max_seq_len // bs, 1)
            else:
                budget = int(prefix_blocks)
                if budget < 1:
                    raise ValueError(
                        f"prefix_blocks must be >= 1, got {budget}")
        pool = BlockManager(c.num_hidden_layers, live + budget, bs,
                            c.num_key_value_heads, c.head_dim, dtype=dtype,
                            kv_dtype=self._kv_quant,
                            device=self.model.device, tp=self._tp)
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                pool, max_blocks=budget,
                host_tier_bytes=self._host_tier_bytes)
        return pool

    def _dense_trie(self, prefix_cache, prefix_blocks, bs):
        """The dense engine's trie: a shared cache after its geometry
        checks, or a fresh one on a pool of ``prefix_blocks`` blocks
        (default ``num_slots`` full-length prompts; the pool IS the
        budget)."""
        c = self.config
        if isinstance(prefix_cache, PrefixCache):
            pool = prefix_cache.pool
            want = (self.cache.k.shape[0],) + tuple(self.cache.k.shape[3:])
            have = (pool.num_layers, pool.num_kv_heads, pool.head_dim)
            if have != want or pool.store_dtype != self.cache.k.dtype:
                raise ValueError(
                    f"shared PrefixCache pool geometry {have}/"
                    f"{pool.store_dtype} does not match this engine's cache "
                    f"{want}/{self.cache.k.dtype}")
            return prefix_cache
        nb = (self.num_slots * max(self.max_seq_len // bs, 1)
              if prefix_blocks is None else int(prefix_blocks))
        # 0 or negative: BlockManager raises rather than defaulting
        return PrefixCache(BlockManager(
            c.num_hidden_layers, nb, bs, c.num_key_value_heads, c.head_dim,
            dtype=self._dtype, device=self.model.device),
            host_tier_bytes=self._host_tier_bytes)

    @property
    def fused_tick(self) -> bool:
        """Whether every tail tick of the unified step is ONE fused-tick
        kernel launch instead of the scanned per-layer stack."""
        return self._fused_tick

    @property
    def ragged_step(self) -> bool:
        return self._ragged

    @property
    def prefill_chunk(self) -> int:
        """The chunk the engine runs (block-rounded), 0 when off."""
        return self._chunk or 0

    @property
    def kv_dtype(self) -> str:
        """The KV storage this engine serves from: ``"int8"`` / ``"fp8"``
        on a quantized pool, else the pool's dtype name (``"float32"`` /
        ``"bfloat16"``)."""
        return self._kv_dtype

    @property
    def quantize_weights(self) -> bool:
        """Whether the projections run on int8 weight-only pairs."""
        return self._wq8

    @property
    def quantize_activations(self) -> bool:
        """Whether the projections run int8 x int8 (per-row activation
        quantization at run time, int32 accumulation)."""
        return self._a8

    @property
    def decode_ticks(self) -> int:
        """Most decode ticks a step runs behind one host sync (1: the
        unified step, one sync a token)."""
        return self._decode_ticks

    @property
    def spec_decode(self) -> bool:
        """Whether every step is one speculative verify call (draft →
        ragged-span verify → block-tail rollback)."""
        return self._spec

    @property
    def spec_k(self) -> int:
        """Most draft tokens a verify span takes (0 with speculation
        off)."""
        return self._spec_k if self._spec else 0

    @property
    def tp(self) -> int:
        """The tensor-parallel degree: the shards every serving program
        runs over (1: no shards)."""
        return self._tp

    @property
    def collective_dtype(self) -> str:
        """The effective wire dtype of the per-layer reductions: ``"int8"``
        the EQuARX all-reduce, ``"fp"`` the plain sum (and the value at
        tp=1, where nothing reduces)."""
        return self._coll_dtype

    @property
    def collective_overlap(self) -> bool:
        """Whether the reductions run the row-chunked schedule (the fp
        ring); False at tp=1."""
        return self._coll_overlap

    @property
    def tp_devices(self) -> list:
        """The device of each shard: the model's device, ``tp`` times."""
        return list(self._tp_devices)

    def _record_collectives(self, co, spans):
        """The exact collective ledger of one sharded launch, at every
        launch site behind the ``_co()`` guard: ``spans`` is ``[(rows,
        repeats)]``, each repeat one pass over the layer stack paying the
        per-layer reduction pair on a ``[rows, hidden]`` activation, its
        bytes by ``quantization.collective_wire_bytes`` — the reference's
        accounting, launch for launch."""
        if self._tp <= 1:
            return
        L = self.config.num_hidden_layers
        hidden = self.config.hidden_size
        fp_b = self._dtype.itemsize
        ops, nbytes = 0, 0
        for rows, reps in spans:
            if rows <= 0 or reps <= 0:
                continue
            ops += 2 * L * reps
            nbytes += 2 * L * reps * collective_wire_bytes(
                rows, hidden, self._tp, self._coll_dtype, fp_itemsize=fp_b)
        co.record_collective(self._coll_dtype, ops, nbytes)

    @property
    def num_active(self) -> int:
        """Slots in use (the /metrics active-slots gauge)."""
        return self.num_slots - self.cache.num_free

    def release(self):
        """Drop the KV storage of a dead engine, so a rebuild does not
        hold two pools (a shared :class:`~.prefix_cache.PrefixCache`'s
        pool stays: the next engine adopts it), and the multi-tick tail's
        graphs; host bookkeeping stays readable."""
        if self._owns_pool:
            self.cache.release()
            if self.prefix_cache is not None and not self._paged:
                self.prefix_cache.pool.release()
        elif not self._paged:
            self.cache.release()
        if self._tail is not None:
            self._tail.release()

    def _check_kernel_limits(self):
        """Raise unless every kernel this engine launches takes the model,
        in the pool's storage mode: the flash forward (cold prefill); then
        ragged attention and paged decode, or ragged attention and the
        fused tick (any ``num_slots``; under ``quantize_activations`` the
        scanned tick's paged decode instead), or paged decode alone (the
        two-program step), or dense decode. The int8 x int8 projections
        want widths that are multiples of 8 on a card. Under tensor
        parallelism the kernels run at a shard's head counts, and a fused
        tick is the scanned one (paged decode)."""
        c = self.config
        nh, nkv, hd = (c.num_attention_heads // self._tp,
                       c.num_key_value_heads // self._tp, c.head_dim)
        check_head_dim("flash", hd)
        if self._a8 and any(w % 8 for w in (
                c.hidden_size, c.intermediate_size, c.vocab_size,
                nh * hd, nkv * hd)):
            raise NotImplementedError(
                "quantize_activations on a card: the int8 x int8 "
                "projections (torch._int_mm) want hidden, intermediate, "
                "vocab and head widths that are multiples of 8")
        if not self._paged:
            dense_decode.check_limits(nh, nkv, hd)
            return
        if self._ragged or self._spec:
            ragged_attention.check_limits(nh, nkv, hd)
        if self._fused_tick and not self._a8 and self._tp == 1:
            fused_decode_tick.check_limits(nh, nkv, hd, c.hidden_size,
                                           c.intermediate_size,
                                           c.vocab_size)
        else:
            paged_decode.check_limits(nh, nkv, hd)

    # ------------------------------------------------------------- tracing
    def _tr(self):
        """The recording tracer, or None — the guard of every trace site."""
        t = self.tracer
        return t if (t is not None and t.enabled) else None

    def _co(self):
        """The active cost observatory, or None — the guard of every
        cost site. Also keeps the prefix cache's ``cost`` on the live
        observatory, as the reference does."""
        c = self.cost
        co = c if (c is not None and c.enabled) else None
        pc = self.prefix_cache
        if pc is not None and pc.cost is not co:
            pc.cost = co
        return co

    def _wrap_prog(self, key, fn, host_out):
        """Every program accessor hands out through here, so with the
        observatory on every program call is counted once. ``host_out``
        names the results the engine fetches to host."""
        co = self._co()
        if co is None:
            return fn
        return co.wrap(key, fn, host_out=host_out)

    def _trace_phase_end(self, tr, seq, args=None):
        """Close the sequence's current lifecycle span on its request
        lane and restart the mark."""
        tr.complete(seq.trace_phase, seq.trace_mark,
                    tid=tr.req_tid(seq.request_id), args=args)
        seq.trace_mark = tr.now()

    def _tspan(self, name, args=None):
        tr = self._tr()
        if tr is None:
            return NULL_SPAN
        return tr.span(name, args=args)

    # ------------------------------------------------------------ programs
    def _fn_consts(self):
        c = self.config
        return dict(nh=c.num_attention_heads, nkv=c.num_key_value_heads,
                    hd=c.head_dim, eps=float(c.rms_norm_eps),
                    theta=float(c.rope_theta), tied=self._tied,
                    decode_attn=c.decode_attention)

    def _q_consts(self):
        """The a8 keyword of the programs that grew the int8 x int8 path
        (none when off; the validation keeps a8 off the dense and
        two-program engines)."""
        return dict(a8=True) if self._a8 else {}

    def _tp_consts(self, overlap=True):
        """A sharded program's keywords ({} at tp=1): a shard's head counts
        and the reduction. The cold and suffix prefills never take the
        overlap schedule, as in the reference."""
        if self._tp <= 1:
            return {}
        c = self.config
        return dict(nh=c.num_attention_heads // self._tp,
                    nkv=c.num_key_value_heads // self._tp,
                    tp_reduce=tp_allreduce(
                        self._coll_dtype, self._tp_devices,
                        overlap=overlap and self._coll_overlap))

    def _program(self, key, fn, host_out, overlap=True, **kw):
        if key not in self._jit:
            consts = self._fn_consts()
            consts.update(self._tp_consts(overlap))
            self._jit[key] = _Program(functools.partial(fn, **kw, **consts))
        return self._wrap_prog(key, self._jit[key], host_out)

    def _prefill_fn(self):
        # host reads tok0 (result 2)
        # the cold prefill never touches the pool: engines differing only
        # in kv_dtype share it
        return self._program(("prefill",) + self._wtag + self._atag
                             + self._tptag, _prefill_impl, (2,),
                             overlap=False, **self._q_consts())

    def _ragged_fn(self, n_steps):
        # the full packed geometry (num_slots AND token budget) keys the
        # program, as in the reference; host reads tokens and tick-0 keys
        key = ("ragged", self.num_slots, self._token_budget, int(n_steps),
               self.config.decode_attention) + self._kvtag + self._wtag \
            + self._atag + self._tptag + self._fktag
        return self._program(key, _ragged_step_impl, (2, 3),
                             n_steps=int(n_steps), fused=self._fused_tick,
                             **self._q_consts())

    def _suffix_fn(self):
        # the paged and dense suffix programs key apart (table-indirect vs
        # slot-indexed); host reads tok0 (result 2)
        tags = self._kvtag + self._wtag + self._atag + self._tptag
        if self._paged:
            return self._program(("psuffix",) + tags,
                                 _paged_suffix_prefill_impl, (2,),
                                 overlap=False, **self._q_consts())
        return self._program(("suffix",) + tags, _suffix_prefill_impl, (2,))

    def _decode_fn(self, n_steps):
        kind, fn = (("pdecode", _paged_decode_steps_impl) if self._paged
                    else ("decode", _decode_steps_impl))
        key = (kind, int(n_steps), self.config.decode_attention) \
            + self._kvtag + self._wtag
        return self._program(key, fn, (0,), n_steps=int(n_steps))

    def _mtick_fn(self):
        # the full packed geometry plus decode_ticks (config) key the
        # program; the tick count run is a runtime argument, so this is
        # the engine's ONE decode program. Host reads the token block,
        # the key walk and ticks_run
        key = ("mtick", self.num_slots, self._token_budget,
               self._decode_ticks, self.config.decode_attention) \
            + self._kvtag + self._wtag + self._atag + self._tptag \
            + self._fktag
        return self._program(key, _multitick_step_impl, (2, 3, 4),
                             max_ticks=self._decode_ticks,
                             fused=self._fused_tick, **self._q_consts())

    def _spec_fn(self):
        # the full packed geometry (num_slots AND the spec budget) plus
        # the sampling-walk depth key the program; host reads the tokens
        # and the key walk
        key = ("spec", self.num_slots, self._spec_budget, self._spec_len,
               self.config.decode_attention) + self._kvtag + self._wtag \
            + self._atag + self._tptag
        return self._program(key, _spec_verify_impl, (2, 3),
                             spec_len=self._spec_len, **self._q_consts())

    def decode_compilations(self) -> int:
        """Decode-program signatures of THIS engine's kind (the
        compile-once hook): one per ``(num_slots, spec_budget, spec_len)``
        on the speculative engine (its verify program is its decode
        program), one per ``(num_slots, token_budget, decode_ticks)`` on
        the multi-tick engine, one per ``(num_slots, token_budget,
        n_steps)`` on the unified engine, one per ``n_steps`` on the
        two-program and dense ones, however sampling knobs, budgets,
        tables and span mixes vary — the JAX engine's trace count."""
        tags = self._kvtag + self._wtag + self._atag + self._tptag \
            + self._fktag
        if self._spec:
            # spec_len is configuration: two engines differing only in
            # spec_k may share a budget, so it is part of the identity
            return sum(fn._cache_size() for key, fn in self._jit.items()
                       if key[0] == "spec"
                       and key[1] == self.num_slots
                       and key[2] == self._spec_budget
                       and key[3] == self._spec_len
                       and key[5:] == tags)
        if self._mtick:
            return sum(fn._cache_size() for key, fn in self._jit.items()
                       if key[0] == "mtick"
                       and key[1] == self.num_slots
                       and key[2] == self._token_budget
                       and key[3] == self._decode_ticks
                       and key[5:] == tags)
        if self._ragged:
            return sum(fn._cache_size() for key, fn in self._jit.items()
                       if key[0] == "ragged"
                       and key[1] == self.num_slots
                       and key[2] == self._token_budget
                       and key[5:] == tags)
        kind = "pdecode" if self._paged else "decode"
        return sum(fn._cache_size() for key, fn in self._jit.items()
                   if key[0] == kind and key[3:] == tags)

    def prefill_compilations(self) -> int:
        """Prefill-side signatures, cold and suffix: one per (padded
        group, bucket), whatever the hit/miss/eviction mix."""
        sfx = "psuffix" if self._paged else "suffix"
        return sum(fn._cache_size() for key, fn in self._jit.items()
                   if (key[0] == "prefill"
                       and key[1:] == self._wtag + self._atag
                       + self._tptag)
                   or (key[0] == sfx
                       and key[1:] == self._kvtag + self._wtag
                       + self._atag + self._tptag))

    # ------------------------------------------------------------- intake
    def _key_for(self, request):
        if request.prng_key is not None:
            return np.asarray(request.prng_key, np.int64).reshape(2)
        if request.seed is not None:
            return prng.PRNGKey(int(request.seed)).numpy()
        return prng.next_key().numpy()

    def validate(self, request):
        """Raise the submit-time errors without mutating engine state."""
        if not isinstance(request, GenerationRequest):
            raise TypeError(
                f"submit() takes a GenerationRequest, got "
                f"{type(request).__name__}")
        prompt_len = int(np.asarray(request.prompt).reshape(-1).shape[0])
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if int(request.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        if prompt_len + int(request.max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the KV cache length "
                f"({self.max_seq_len}); raise max_seq_len or generate "
                f"fewer tokens")
        if request.timeout_s is not None and float(request.timeout_s) <= 0:
            raise ValueError(
                f"timeout_s must be > 0, got {request.timeout_s}")
        # an unknown priority_class raises here, on the caller's thread:
        # the HTTP front door answers 400
        self.classes.resolve(request.priority_class)

    def submit(self, request) -> Sequence:
        """Queue a request; returns its live Sequence handle."""
        self.validate(request)
        deadline = (time.monotonic() + float(request.timeout_s)
                    if request.timeout_s is not None else None)
        seq = Sequence(request, key=self._key_for(request), deadline=deadline)
        seq.pclass = self.classes.resolve(request.priority_class)
        seq.t_submit = self._clock()
        tr = self._tr()
        if tr is not None:
            seq.trace_mark = tr.now()
        self.scheduler.submit(seq)
        return seq

    def cancel(self, seq: Sequence) -> bool:
        """Retire a sequence with ``finish_reason="cancelled"`` — queued,
        mid-chunked-prefill or running. Must be called from the thread
        driving :meth:`step`. Returns False if it already finished."""
        if seq.done:
            return False
        if seq.status == "queued":
            if not self.scheduler.remove(seq):
                return False
        self.stats["cancelled"] += 1
        self._finish(seq, "cancelled", [])
        return True

    # ------------------------------------------------------------ stepping
    def _admission_hit_len(self, seq):
        """THE prefix lookup for one admitted sequence (the scheduler
        calls it once per pop): records the hit, pins the matched chain
        at once — before any admission this step can publish and evict —
        and keeps it on the sequence for :meth:`_admit_group`. Returns the
        covered token count."""
        matched = self.prefix_cache.lookup(seq.work)
        if matched:
            self.prefix_cache.acquire(matched)
            seq.prefix_nodes = matched
        return self.prefix_cache.block_size * len(matched)

    def _bucket(self, plen):
        if self._bucketing == "exact":
            return plen
        return min(max(8, 1 << (plen - 1).bit_length()), self.max_seq_len)

    def _admit_group(self, seqs, finished):
        """Admit a batch. A sequence whose UNCOVERED prompt is longer than
        ``prefill_chunk`` claims its slot (installing any matched chain)
        and enters chunked prefill; prefix-cache hits take the suffix path
        (ONE suffix prefill per suffix-length bucket); misses take the
        cold path (ONE prefill call per prompt-length bucket). The lookup
        and its pins already ran at scheduler pop time
        (:meth:`_admission_hit_len`): a cold sequence that retires at once
        publishes inside ``_admit_cold``, and an unpinned matched chain
        could be evicted before ``_admit_hits`` installs it."""
        tr = self._tr()
        for seq in seqs:
            if tr is not None:
                # close the waiting span (queued, or preempted/recovered)
                self._trace_phase_end(
                    tr, seq,
                    args={"prefix_hit_tokens": seq.prefix_hit_tokens})
            seq.trace_phase = "prefill"
        cold, hits = [], []
        for seq in seqs:
            covered = seq.prefix_hit_tokens
            if self._chunk and seq.work_len - covered > self._chunk:
                self._enter_chunked_prefill(seq, covered)
            elif seq.prefix_nodes:
                hits.append((seq, seq.prefix_nodes))
            else:
                cold.append(seq)
        if cold:
            self._admit_cold(cold, finished)
        if hits:
            self._admit_hits(hits, finished)

    def _enter_chunked_prefill(self, seq, covered=0):
        """Claim a slot for a long prompt without prefilling it yet: a
        matched prefix chain installs by table reference and counts toward
        the resume offset; the rest arrives chunk by chunk."""
        slot = self.cache.alloc()
        seq.slot = slot
        if seq.prefix_nodes:
            self.cache.install_prefix(
                slot, [node.block_id for node in seq.prefix_nodes])
        seq.prefilled = covered
        self.cache.lengths[slot] = covered
        seq.status = "prefilling"
        if seq.t_admitted is None:
            seq.t_admitted = self._stamp_now()
        self._slots[slot] = seq
        self.scheduler.enter_prefill(seq)

    def _admit_cold(self, seqs, finished):
        by_bucket = {}
        for seq in seqs:
            by_bucket.setdefault(self._bucket(seq.work_len), []).append(seq)
        for s_pad, group in sorted(by_bucket.items()):
            G = len(group)
            Gp = 1 << (G - 1).bit_length()
            ids = np.zeros((Gp, s_pad), np.int32)
            lens = np.ones(Gp, np.int32)  # pad rows: 1 valid token
            temps = np.zeros(Gp, np.float32)
            topks = np.zeros(Gp, np.int32)
            keys = np.zeros((Gp, 2), np.int64)
            for i, seq in enumerate(group):
                ids[i, :seq.work_len] = seq.work
                lens[i] = seq.work_len
                temps[i] = float(seq.request.temperature)
                topks[i] = int(seq.request.top_k)
                keys[i] = np.asarray(seq.key)
            with self._tspan("prefill_launch",
                             args={"bucket": s_pad, "group": G}):
                pk, pv, tok0s, keys2 = self._prefill_fn()(
                    self._shards, ids, lens, keys, temps, topks)
                tok0s = tok0s.cpu().numpy()
            keys2 = keys2.numpy()
            co = self._co()
            if co is not None:
                # a sharded cold prefill: one pass over the padded group
                self._record_collectives(co, [(Gp * s_pad, 1)])
            for i, seq in enumerate(group):
                seq.launches += 1       # rode this bucket's prefill
                slot = self.cache.alloc()
                seq.slot = slot   # before the write: a PoolExhausted
                # raised by the block growth must leave the claimed slot
                # findable for _abort_admission
                self.cache.write_prefill(slot, [k[:, i] for k in pk],
                                         [v[:, i] for v in pv],
                                         seq.work_len)
                self._install_seq(seq, slot, tok0s[i], keys2[i],
                                  seq.work_len, finished)

    def _admit_hits(self, hits, finished):
        """Admit prefix-cache hits, then ONE suffix-prefill call per
        suffix-length bucket over the uncovered prompt tails.

        Paged: zero-copy install — the slot's table references the
        matched chain's blocks, private tail blocks are appended for the
        prompt, and the suffix prefill writes through the table. Dense:
        the matched blocks are copied into the slot, one copy a block
        (``prefill_copy_dispatches``)."""
        pc = self.prefix_cache
        bs = pc.block_size
        by_bucket = {}
        for seq, matched in hits:
            suffix_len = seq.work_len - len(matched) * bs
            by_bucket.setdefault(self._bucket(suffix_len),
                                 []).append((seq, matched))
        for s_pad, group in sorted(by_bucket.items()):
            rows = []
            for seq, matched in group:
                covered = len(matched) * bs
                slot = self.cache.alloc()
                seq.slot = slot
                if self._paged:
                    self.cache.install_prefix(
                        slot, [node.block_id for node in matched])
                    self.cache.ensure_capacity(slot, seq.work_len)
                else:
                    for j, node in enumerate(matched):
                        self.cache.copy_block_in(slot, j * bs, pc.pool,
                                                 node.block_id)
                        self.stats["prefill_copy_dispatches"] += 1
                rows.append((seq, covered, seq.work_len - covered, True))
            tok0s, keys2 = self._suffix_call(s_pad, rows)
            for i, (seq, matched) in enumerate(group):
                seq.launches += 1       # rode this bucket's suffix call
                slot = seq.slot
                self.cache.lengths[slot] = seq.work_len
                self.stats["prefill_tokens_saved"] += seq.prefix_hit_tokens
                self._install_seq(seq, slot, tok0s[i], keys2[i],
                                  seq.work_len - seq.prefix_hit_tokens,
                                  finished)

    def _suffix_call(self, s_pad, rows):
        """ONE suffix-prefill call for an ``s_pad``-bucket group, shared by
        the hit path (dense and paged) and the two-program chunk path.
        ``rows`` is ``[(seq, offset, n, live)]``: prefill
        ``work[offset:offset+n]`` into the sequence's claimed slot, whose
        storage already covers the span. Only ``live`` rows sample
        (non-final chunks run greedy and their output is discarded).
        Padding rows carry sentinel tables (paged) or slot ``num_slots``
        (dense) and a fully covered prefix, so nothing of theirs is
        written. Returns host ``tok0s`` and host ``keys2``."""
        Gp = 1 << (len(rows) - 1).bit_length()
        if self._paged:
            mb = self.cache.max_blocks
            addr = np.full((Gp, mb), self.cache.sentinel, np.int32)
            prefix_lens = np.full(Gp, mb * self.cache.block_size, np.int32)
        else:
            addr = np.full(Gp, self.num_slots, np.int32)
            prefix_lens = np.full(Gp, self.max_seq_len, np.int32)
        ids = np.zeros((Gp, s_pad), np.int32)
        suf_lens = np.ones(Gp, np.int32)
        temps = np.zeros(Gp, np.float32)
        topks = np.zeros(Gp, np.int32)
        keys = np.zeros((Gp, 2), np.int64)
        for i, (seq, off, n, live) in enumerate(rows):
            addr[i] = self.cache.tables[seq.slot] if self._paged \
                else seq.slot
            ids[i, :n] = seq.work[off:off + n]
            suf_lens[i] = n
            prefix_lens[i] = off
            keys[i] = np.asarray(seq.key, np.int64)
            if live:
                temps[i] = float(seq.request.temperature)
                topks[i] = int(seq.request.top_k)
        kv = (self.cache.kv_args() if self._paged
              else (self.cache.k, self.cache.v))
        with self._tspan("prefill_launch",
                         args={"bucket": s_pad, "group": len(rows)}):
            _, _, tok0s, keys2 = self._suffix_fn()(
                self._shards, *kv, addr, prefix_lens, ids, suf_lens, keys,
                temps, topks)
            tok0s = tok0s.cpu().numpy()
        co = self._co()
        if co is not None:
            # a sharded suffix prefill: one pass over the padded group
            self._record_collectives(co, [(Gp * s_pad, 1)])
        return tok0s, keys2.numpy()

    def _run_prefill_chunks(self, plan, finished):
        """The two-program engine's chunk call: ONE paged suffix-prefill
        call per chunk-length bucket (full chunks share the
        ``prefill_chunk`` bucket), each chunk written through its table at
        the host resume offset. Only a FINAL chunk samples, so the PRNG
        walk equals a one-shot prefill's."""
        by_bucket = {}
        for seq, n in plan:
            by_bucket.setdefault(self._bucket(n), []).append((seq, n))
        for s_pad, group in sorted(by_bucket.items()):
            rows = []
            for seq, n in group:
                off = seq.prefilled
                self.cache.ensure_capacity(seq.slot, off + n)
                rows.append((seq, off, n, off + n == seq.work_len))
            tok0s, keys2 = self._suffix_call(s_pad, rows)
            for i, (seq, n) in enumerate(group):
                self._advance_chunk(seq, n, tok0s[i], keys2[i], finished)

    def _advance_chunk(self, seq, n, tok0, key0, finished):
        """Per-chunk completion bookkeeping; ``tok0``/``key0`` are the
        chunk row's sample and advanced key, consumed only when this
        chunk completes the prompt."""
        slot, end = seq.slot, seq.prefilled + n
        seq.launches += 1               # rode this chunk's call
        self.stats["prefill_chunks"] += 1
        self.stats["chunk_tokens"] += n
        tr = self._tr()
        if tr is not None:
            tr.complete(f"prefill_chunk[{seq.trace_chunk_i}]",
                        seq.trace_mark, tid=tr.req_tid(seq.request_id),
                        args={"tokens": n, "offset": seq.prefilled})
            seq.trace_mark = tr.now()
            seq.trace_chunk_i += 1
        self.cache.lengths[slot] = end
        seq.prefilled = end
        if end == seq.work_len:
            self.scheduler.leave_prefill(seq)
            self.stats["prefill_tokens_saved"] += seq.prefix_hit_tokens
            self._install_seq(seq, slot, tok0, key0,
                              seq.work_len - seq.prefix_hit_tokens, finished)

    def _install_seq(self, seq, slot, tok0, key2, prefilled_tokens,
                     finished):
        """Post-prefill slot bookkeeping shared by the cold and chunked
        paths. A RESTORED sequence (``restore_point > 0``, recompute after
        preemption) adopts no sampled output: it resumes from its last
        streamed token with the key snapshot taken when it was
        displaced."""
        req = seq.request
        seq.slot = slot
        seq.status = "running"
        if seq.t_admitted is None:
            seq.t_admitted = self._stamp_now()
        tr = self._tr()
        if tr is not None:
            self._trace_phase_end(
                tr, seq, args={"prefix_hit_tokens": seq.prefix_hit_tokens,
                               "restored": bool(seq.restore_point)})
        seq.trace_phase = "decode"
        self._slots[slot] = seq
        self._temps[slot] = float(req.temperature)
        self._topks[slot] = int(req.top_k)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += int(prefilled_tokens)
        if seq.restore_point:
            self._last_tok[slot] = int(seq.tokens[-1])
            self._keys[slot] = np.asarray(seq.key, np.int64)
            return
        seq.tokens = [int(tok0)]
        self._last_tok[slot] = seq.tokens[0]
        self._keys[slot] = np.asarray(key2, np.int64)
        self.stats["tokens_generated"] += 1
        self._emit(seq, seq.tokens[0])
        self._maybe_finish(seq, finished)

    def _maybe_finish(self, seq, finished):
        req = seq.request
        t = seq.tokens[-1]
        if req.eos_token_id is not None and t == int(req.eos_token_id):
            self._finish(seq, "stop", finished)
        elif len(seq.tokens) >= int(req.max_new_tokens):
            self._finish(seq, "length", finished)

    def _finish(self, seq, reason, finished):
        if seq.status == "prefilling":
            self.scheduler.leave_prefill(seq)
        seq.status = "finished"
        seq.finish_reason = reason
        seq.t_finish = self._stamp_now()
        tr = self._tr()
        if tr is not None:
            args = {"finish_reason": reason, "tokens": len(seq.tokens)}
            if seq.trace_accepts:
                args["accept_lens"] = list(seq.trace_accepts)
            self._trace_phase_end(tr, seq, args=args)
            tr.instant("finished", tid=tr.req_tid(seq.request_id),
                       args={"finish_reason": reason})
        slot = seq.slot
        if slot is not None and self._slots[slot] is seq:
            self._release_slot(seq, slot)
        self._release_prefix(seq)
        finished.append(seq)
        if self.on_finish is not None:
            self.on_finish(seq)

    def _release_slot(self, seq, slot):
        """Slot teardown shared by retirement and preemption: reset the
        slot's knobs (a stale temperature would keep the sampler off its
        all-greedy fast path) and hand its blocks back
        (:meth:`_donate_and_free`)."""
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._last_tok[slot] = 0
        self._donate_and_free(seq, slot)

    def _donate_and_free(self, seq, slot):
        """Publish before freeing: the slot's written rows are intact and
        the sequence's own pins still shield its matched chain during the
        publish walk. Paged + trie: DONATE the slot's full written blocks
        (prompt AND generated tokens, capped at the written length: the
        last sampled token's KV is never in the cache) and free only the
        rest. Dense + trie: copy the prompt's full blocks out, then free.
        Without a trie: free."""
        pc = self.prefix_cache
        if pc is not None and self._paged:
            with self._tspan("donate", args={"slot": slot}):
                written = int(self.cache.lengths[slot])
                content = seq.prompt if not seq.tokens else np.concatenate(
                    [seq.prompt, np.asarray(seq.tokens, np.int32)])
                donated = pc.publish_donate(content[:written],
                                            self.cache.slot_block_ids(slot))
                self.cache.free(slot, keep=donated)
        elif pc is not None:
            with self._tspan("donate", args={"slot": slot}):
                pc.publish(seq.prompt, slot, self.cache)
                self.cache.free(slot)
        else:
            self.cache.free(slot)

    def _release_prefix(self, seq):
        """Drop the sequence's pins on its matched chain (once)."""
        if self.prefix_cache is not None and seq.prefix_nodes:
            self.prefix_cache.release(seq.prefix_nodes)
            seq.prefix_nodes = []

    def _expire_deadlines(self, seqs, finished):
        """Retire every sequence whose deadline has passed, queued or
        running."""
        now = time.monotonic()
        for seq in seqs:
            if seq.done or seq.deadline is None or now < seq.deadline:
                continue
            if seq.status == "queued" and not self.scheduler.remove(seq):
                continue
            self.stats["timeouts"] += 1
            self._finish(seq, "timeout", finished)

    def _stamp_now(self):
        """The current step's start reading inside a step, a fresh clock
        reading outside one (submit, cancel)."""
        return self._stamp_t if self._stamp_t is not None \
            else self._clock()

    def _emit(self, seq, token):
        if seq.t_first_token is None:
            seq.t_first_token = self._stamp_now()
        seq.t_last_token = self._stamp_now()
        if self.on_token is not None:
            self.on_token(seq, token)

    @torch.inference_mode()
    def step(self):
        """Admit + this step's chunk grant + decode, as ONE unified step,
        + retire. Runs under ``torch.inference_mode()``: the model's
        parameters are trainable, and serving records no graph. Returns
        every sequence this step finished, deadline expiries included.

        A :class:`~.kv_cache.PoolExhausted` raised in the step body is
        repaired here: the half-done admission goes back to the queue,
        the youngest slot-holding sequence is preempted by recompute, and
        the step retries without re-admitting. Anything else the
        ``fault_hook`` or the step raises propagates to the driver (the
        gateway's supervisor)."""
        t0 = self._clock()
        self._stamp_t = t0
        tr = self._tr()
        ts0 = tr.now() if tr is not None else None
        co = self._co()
        cost0 = co.snapshot() if co is not None else None
        finished = []
        self._expire_deadlines(
            list(self.scheduler.queue)
            + [s for s in self._slots if s is not None], finished)
        step_tokens, had_chunks = 0, False
        admitted = []
        for attempt in range(self.num_slots + 2):
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self)
                if attempt == 0:
                    if self._policy:
                        # policy decisions record through the step's
                        # tracer; displace best-effort work BEFORE
                        # admission, so the freed slots are in num_free
                        # for this step's admission
                        self.scheduler.tracer = tr
                        self._policy_preempt()
                    admitted = self.scheduler.admissions(
                        self.cache.num_free,
                        hit_len_fn=self._admission_hit_len
                        if self.prefix_cache is not None else None)
                    if admitted:
                        if co is not None:
                            co.set_phase("admit")
                        with self._tspan("admit",
                                         args={"n": len(admitted)}):
                            self._admit_group(admitted, finished)
                if self._spec:
                    step_tokens, had_chunks = self._spec_step(finished)
                elif self._mtick:
                    step_tokens, had_chunks = self._multitick_step(
                        finished)
                elif self._ragged:
                    step_tokens, had_chunks = self._unified_step(finished)
                else:
                    step_tokens, had_chunks = self._two_program_step(
                        finished)
                break
            except PoolExhausted:
                self._abort_admission(admitted)
                admitted = []
                if not self._preempt_youngest():
                    self._stamp_t = None
                    raise
            except BaseException:
                # no popped-but-uninstalled sequence may be stranded
                self._abort_admission(admitted)
                self._stamp_t = None
                raise
        self.stats["steps"] += 1
        self._record_step(self._clock() - t0, step_tokens, had_chunks)
        self._stamp_t = None
        if co is not None:
            co.set_phase(None)
        if tr is not None:
            tr.complete("step", ts0,
                        args={"step": self.stats["steps"] - 1,
                              "tokens": step_tokens,
                              "chunks": bool(had_chunks)})
            # counter tracks on the step timeline: pool occupancy and
            # table pressure, and this step's dispatch/transfer deltas
            if self._paged:
                tr.counter("kv_blocks", self.cache.occupancy())
                tr.counter("block_table_fill",
                           {"fill": round(self.cache.table_fill(), 6)})
            if co is not None:
                d = co.delta(cost0)
                tr.counter("dispatches",
                           {"per_step": d["dispatches"],
                            "compiles": d["compiles"]})
                tr.counter("transfer_bytes",
                           {"h2d": d["h2d_bytes"],
                            "d2h": d["d2h_bytes"]})
        return finished

    # ----------------------------------------------------- fault recovery
    def _abort_admission(self, seqs):
        """Unwind a half-done admission: every popped sequence not yet
        installed goes back to the queue HEAD in its FIFO order, its
        claimed slot freed."""
        tr = self._tr()
        for seq in sorted(seqs, key=lambda s: -s.queue_tick):
            if seq.status != "queued":
                continue
            self._release_prefix(seq)
            seq.prefix_hit_tokens = 0
            if seq.slot is not None:
                if self._slots[seq.slot] is None:
                    self.cache.free(seq.slot)
                seq.slot = None
            if seq.trace_phase == "prefill":
                # back to a fresh queued span; the aborted attempt stays
                # visible as the closed span before it
                if tr is not None:
                    tr.instant("admission_aborted",
                               tid=tr.req_tid(seq.request_id))
                seq.trace_phase = "queued"
                seq.trace_mark = tr.now() if tr is not None else None
            self.scheduler.requeue_front(seq)

    def _class_slot_usage(self):
        """Running count per class name for the policy scheduler's
        headroom: a walk of the slot array (a prefilling sequence holds a
        slot and counts)."""
        used = {}
        for seq in self._slots:
            if seq is None or seq.done:
                continue
            pclass = getattr(seq, "pclass", None)
            if pclass is not None:
                used[pclass.name] = used.get(pclass.name, 0) + 1
        return used

    def _policy_preempt(self):
        """SLO-driven preemption: when queued requests have waited past
        the urgency fraction of their TTFT budget and free slots cannot
        cover them, displace one strictly lower-rank running sequence per
        uncovered urgent request through :meth:`_preempt` (chain donated,
        key snapshotted, stream unchanged after restore). Runs before
        admission inside the step's stamp window, so urgency and victims
        replay under an injected clock. Equals never displace equals."""
        urgent = self.scheduler.urgent(self._stamp_t)
        if not urgent:
            return
        free = self.cache.num_free
        tr = self._tr()
        for seq in urgent[free:]:
            pclass = getattr(seq, "pclass", None)
            rank = pclass.rank if pclass is not None else 0
            victims = select_victims(self._slots, 1, rank)
            if not victims:
                continue
            victim = victims[0]
            self.stats["policy_preemptions"] += 1
            if tr is not None:
                tr.instant(
                    "policy_preempt",
                    args={"urgent": seq.request_id,
                          "victim": victim.request_id,
                          "victim_class": getattr(
                              victim.pclass, "name", None)})
            if self.on_policy_preempt is not None:
                self.on_policy_preempt(victim)
            self._preempt(victim)

    def _preempt_youngest(self) -> bool:
        """PoolExhausted repair: displace the youngest slot-holding
        sequence. Returns False when there is none."""
        victims = [s for s in self._slots if s is not None and not s.done]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda s: s.request_id))
        return True

    def _displace(self, seq, reason):
        """Slot teardown shared by preemption and :meth:`evict`: free the
        slot now and snapshot its current key (what the next decode tick
        would have sampled with), so a recompute resumes the same walk.
        A mid-recompute sequence keeps the snapshot it carries. Leaves the
        sequence slotless and unqueued."""
        slot = seq.slot
        tr = self._tr()
        if tr is not None:
            self._trace_phase_end(
                tr, seq, args={reason: True, "tokens": len(seq.tokens)})
            tr.instant(reason, tid=tr.req_tid(seq.request_id),
                       args={"slot": slot})
        if seq.status == "prefilling":
            self.scheduler.leave_prefill(seq)
        if seq.tokens and seq.status == "running":
            seq.key = self._keys[slot].copy()
        self._release_slot(seq, slot)
        self._release_prefix(seq)
        seq.slot = None

    def _preempt(self, seq):
        """Preemption by recompute: displace the sequence and re-queue it
        here through :meth:`restore`. Nothing is emitted; consumers see a
        pause."""
        self.stats["preemptions"] += 1
        self._displace(seq, "preempted")
        self.restore(seq)
        seq.trace_phase = "preempted"   # restore() named it "recovered"

    def evict(self, seq: Sequence) -> bool:
        """Remove a live sequence from this engine for re-admission by
        another engine's :meth:`restore` (same displacement as
        preemption, but ownership leaves the engine). A queued sequence
        is simply dequeued. Must be called from the thread driving
        :meth:`step`. Returns False for a finished sequence or one this
        engine does not hold."""
        if seq.done:
            return False
        if seq.status == "queued":
            return self.scheduler.remove(seq)
        if seq.slot is None or self._slots[seq.slot] is not seq:
            return False
        self._displace(seq, "evicted")
        seq.status = "queued"   # slotless, awaiting the target's restore
        return True

    def restore(self, seq: Sequence) -> bool:
        """Re-enqueue a live sequence for recovery by recompute (crash
        recovery and preemption both land here): its KV is rebuilt by
        prefilling ``prompt + tokens[:-1]``, after which decode resumes
        from the last generated token with the saved key walk, so the
        continuation is the one the sequence would have produced and no
        consumer sees a replayed token. Must be called from the thread
        driving :meth:`step`. Returns False for a finished sequence."""
        if seq.done:
            return False
        seq.status = "queued"
        seq.slot = None
        seq.prefix_nodes = []
        seq.prefix_hit_tokens = 0
        seq.prefilled = 0
        seq.restore_point = len(seq.tokens)
        tr = self._tr()
        seq.trace_phase = "recovered"
        seq.trace_mark = tr.now() if tr is not None else None
        if seq.tokens:
            seq.work = np.concatenate(
                [seq.prompt, np.asarray(seq.tokens[:-1], np.int32)])
        else:
            seq.work = seq.prompt
        self.stats["restores"] += 1
        self.scheduler.submit(seq)
        return True

    # ------------------------------------------------- headroom budgeting
    def _record_step(self, dt, tokens, had_chunks):
        """Feed the step's duration and processed tokens into the stats
        and the headroom EWMAs the adaptive chunk grant derives from."""
        self.stats["last_step_duration_s"] = float(dt)
        self.stats["last_step_tokens"] = int(tokens)
        if not (self._ragged or self._spec) or tokens <= 0 or dt <= 0:
            return
        a = 0.2
        if had_chunks:
            tps = tokens / dt
            self._tps_ewma = tps if self._tps_ewma is None \
                else (1 - a) * self._tps_ewma + a * tps
            self.stats["headroom_tps"] = self._tps_ewma
        else:
            self._dt_decode_ewma = dt if self._dt_decode_ewma is None \
                else (1 - a) * self._dt_decode_ewma + a * dt

    def _prefill_budget(self):
        """This step's chunk-token grant: ``headroom_tps x headroom_mult x
        decode-only step time`` minus the decode rows sharing the step,
        clamped to ``[1, prefill_chunk]``; the fixed cap until both EWMAs
        have a reading, or with ``headroom_mult=None``."""
        cap = self._chunk
        if self._headroom_mult is None or self._tps_ewma is None \
                or self._dt_decode_ewma is None:
            self.stats["headroom"] = cap
            return cap
        n_dec = sum(1 for s in self._slots
                    if s is not None and s.status == "running")
        afford = int(self._tps_ewma * self._headroom_mult
                     * self._dt_decode_ewma) - n_dec
        budget = max(1, min(cap, afford))
        self.stats["headroom"] = budget
        return budget

    # -------------------------------------------------------- unified step
    def _unified_step(self, finished):
        """ONE call for everything this step advances: every running slot
        a span-1 decode row, every planned prefill chunk a span-n row of
        the packed buffer (``decode._ragged_step_impl``). Pure-decode
        steps fuse ``choose_num_steps`` ticks. Returns
        ``(tokens_processed, had_chunks)`` for the headroom EWMAs."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            co.set_phase("plan")
        plan = []
        if self._chunk and self.scheduler.num_prefilling:
            plan = self.scheduler.prefill_plan(self._prefill_budget(),
                                               self.cache.block_size,
                                               cap=self._chunk)
        active = [s for s in self._slots
                  if s is not None and s.status == "running"]
        if not active and not plan:
            return 0, False
        n = self.scheduler.choose_num_steps(active) if active else 1
        R, T = self.num_slots, self._token_budget
        ids = np.zeros(T, np.int32)
        seg = np.full(T, R, np.int32)       # sentinel: dead packed rows
        pos = np.zeros(T, np.int32)
        qstart = np.zeros(R, np.int32)
        qlen = np.zeros(R, np.int32)
        kvlen = np.zeros(R, np.int32)
        dec_mask = np.zeros(R, np.int32)
        temps = np.zeros(R, np.float32)
        topks = np.zeros(R, np.int32)
        keys = self._keys.copy()
        cursor = self._pack_decode_rows(n, ids, seg, pos, qstart, qlen,
                                        kvlen, dec_mask, temps, topks)
        chunk_rows, cursor = self._pack_chunk_rows(
            plan, cursor, ids, seg, pos, qstart, qlen, kvlen, keys,
            temps, topks)
        if tr is not None:
            # plan: the chunk grant + span packing; launch: the one
            # program + the host transfer that fences it; host-accept:
            # token and chunk bookkeeping
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": len(plan),
                              "fused_steps": n})
            tl0 = tr.now()
        if co is not None:
            co.set_phase("launch")
        _, _, toks, keys_t0, keys_fin = self._ragged_fn(n)(
            self._shards, *self.cache.kv_args(), self.cache.tables, ids,
            seg, pos,
            qstart, qlen, kvlen, dec_mask, keys, temps, topks)
        toks_np = toks.cpu().numpy()        # [n, R]
        keys_t0_np = keys_t0.numpy()
        self.stats["unified_steps"] += 1
        if co is not None:
            # a sharded step: tick 0 reduces the padded packed buffer,
            # each tail tick the slot rows
            self._record_collectives(
                co, [(self._token_budget, 1), (self.num_slots, n - 1)])
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0,
                        args={"packed_tokens": cursor, "fused_steps": n})
            th0 = tr.now()
        if active:
            # decode rows adopt the post-tail key walk; chunk/idle rows
            # keep their host key (a final chunk adopts its tick-0 key
            # inside _install_seq below)
            self._keys = np.where(dec_mask[:, None] > 0, keys_fin.numpy(),
                                  self._keys)
        for slot, seq, ntok, final in chunk_rows:
            self._advance_chunk(seq, ntok, toks_np[0, slot],
                                keys_t0_np[slot], finished)
        if active:
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += n
            self.stats["slot_steps"] += n * self.num_slots
            for slot in range(self.num_slots):
                s = self._slots[slot]
                if s is not None and dec_mask[slot]:
                    s.launches += 1     # rode this step's one program
            self._accept_decode_rows(toks_np, n, dec_mask, finished)
        if tr is not None:
            tr.complete("host-accept", th0,
                        args={"emitted": (n * len(active) if active
                                          else 0)})
        return cursor + (n - 1) * len(active), bool(chunk_rows)

    def _two_program_step(self, finished):
        """The two-program step (``ragged_step=False``, and the dense
        engine, which never has a chunk plan): at most one budgeted chunk
        call (``_run_prefill_chunks``), then ONE decode call over every
        slot fusing ``choose_num_steps`` ticks — the A/B baseline the
        unified step is pinned against. Returns ``(tokens_processed,
        had_chunks)``."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            # the chunk calls below are this engine's prefill plan
            co.set_phase("plan")
        plan = []
        if self._chunk and self.scheduler.num_prefilling:
            plan = self.scheduler.prefill_plan(self._chunk,
                                               self.cache.block_size,
                                               cap=self._chunk)
            if plan:
                self._run_prefill_chunks(plan, finished)
        chunk_tokens = sum(c for _, c in plan)
        active = [s for s in self._slots
                  if s is not None and s.status == "running"]
        n = self.scheduler.choose_num_steps(active) if active else 0
        if tr is not None:
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": len(plan),
                              "fused_steps": n})
            tl0 = tr.now()
        if not active:
            return chunk_tokens, bool(plan)
        if co is not None:
            co.set_phase("launch")
        if self._paged:
            lens = self.cache.lengths.copy()
            for slot, s in enumerate(self._slots):
                if s is not None and s.status == "running":
                    # the table covers the n appended rows before the call
                    self.cache.ensure_capacity(slot, int(lens[slot]) + n)
                elif s is not None:
                    # mid-prefill slot: its table is real, so the decode
                    # append must drop, not land where the next chunk
                    # writes — a length past the capacity (the program's
                    # dead-slot clamp) does that
                    lens[slot] = self.cache.max_blocks * \
                        self.cache.block_size
            toks, _, _, keys = self._decode_fn(n)(
                self._shards, *self.cache.kv_args(), self.cache.tables,
                self._last_tok, lens, self._keys, self._temps, self._topks)
        else:
            toks, nk, nv, keys = self._decode_fn(n)(
                self._shards, self.cache.k, self.cache.v, self._last_tok,
                self.cache.lengths, self._keys, self._temps, self._topks)
            self.cache.update(nk, nv)
        self._keys = keys.numpy()
        toks_np = toks.cpu().numpy()
        if co is not None:
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0, args={"fused_steps": n})
            th0 = tr.now()
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * self.num_slots
        for s in active:
            s.launches += 1             # rode this one decode call
        # every running slot rode the call; the accept skips slots whose
        # sequence finished at an earlier tick, and mid-prefill ones
        self._accept_decode_rows(toks_np, n,
                                 np.ones(self.num_slots, np.int32), finished)
        if tr is not None:
            tr.complete("host-accept", th0,
                        args={"emitted": n * len(active)})
        return chunk_tokens + n * len(active), bool(plan)

    def _multitick_step(self, finished):
        """ONE call that advances every slot by up to ``decode_ticks``
        tokens: the unified step with one host sync a step. Every running
        slot packs a span-1 decode row and every planned chunk its span
        into tick 0, as in :meth:`_unified_step`; the tail runs ``n - 1``
        ticks (``FIFOScheduler.choose_decode_ticks``) with EOS/budget
        retirement on the device. The host accepts the ``[n, R]`` token
        block at once, trimming each slot at its first EOS or budget cut,
        and adopts each surviving row's key at its cut from the key walk.
        Returns ``(tokens_processed, had_chunks)``."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            co.set_phase("plan")
        plan = []
        if self._chunk and self.scheduler.num_prefilling:
            plan = self.scheduler.prefill_plan(self._prefill_budget(),
                                               self.cache.block_size,
                                               cap=self._chunk)
        active = [s for s in self._slots
                  if s is not None and s.status == "running"]
        if not active and not plan:
            return 0, False
        n = self.scheduler.choose_decode_ticks(active, self._decode_ticks)
        R, T = self.num_slots, self._token_budget
        ids = np.zeros(T, np.int32)
        seg = np.full(T, R, np.int32)       # sentinel: dead packed rows
        pos = np.zeros(T, np.int32)
        qstart = np.zeros(R, np.int32)
        qlen = np.zeros(R, np.int32)
        kvlen = np.zeros(R, np.int32)
        dec_mask = np.zeros(R, np.int32)
        temps = np.zeros(R, np.float32)
        topks = np.zeros(R, np.int32)
        eos_ids = np.full(R, -1, np.int32)  # -1: no EOS configured
        budgets = np.zeros(R, np.int32)
        keys = self._keys.copy()
        # with the alive-mask metadata the rows pre-grow min(n, remaining)
        # rows: the device stops each row's appends at its cut
        cursor = self._pack_decode_rows(n, ids, seg, pos, qstart, qlen,
                                        kvlen, dec_mask, temps, topks,
                                        eos_ids=eos_ids, budgets=budgets)
        chunk_rows, cursor = self._pack_chunk_rows(
            plan, cursor, ids, seg, pos, qstart, qlen, kvlen, keys,
            temps, topks)
        if tr is not None:
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": len(plan),
                              "ticks": n})
            tl0 = tr.now()
        if co is not None:
            co.set_phase("launch")
        _, _, toks, kwalk, ticks = self._mtick_fn()(
            self._shards, *self.cache.kv_args(), self.cache.tables, ids,
            seg, pos,
            qstart, qlen, kvlen, dec_mask, keys, temps, topks, eos_ids,
            budgets, np.int32(n), tail=self._tail)
        toks_np = toks.numpy()              # [max_ticks, R], host already
        kwalk_np = kwalk.numpy()            # [max_ticks, R, 2]
        self.stats["unified_steps"] += 1
        if co is not None:
            # the reference's accounting: tick 0 on the padded packed
            # buffer, then the tail ticks its while_loop ran (ticks_run;
            # the port's tail runs all n - 1 on the device: the launch
            # tally's tp_reduce counts those)
            self._record_collectives(
                co, [(self._token_budget, 1), (self.num_slots, ticks - 1)])
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0,
                        args={"packed_tokens": cursor, "ticks": n,
                              "ticks_run": ticks})
            th0 = tr.now()
        # chunk bookkeeping first, as in the unified step (a final chunk
        # adopts tick 0's token and key)
        for slot, seq, ntok, final in chunk_rows:
            self._advance_chunk(seq, ntok, toks_np[0, slot],
                                kwalk_np[0, slot], finished)
        emitted_total = 0
        if active:
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += ticks
            self.stats["slot_steps"] += ticks * self.num_slots
            self.stats["mtick_syncs"] += 1
            self.stats["mtick_ticks"] += ticks
            if not chunk_rows:
                # every span a decode row: a fused engine ran tick 0
                # through the fused tick
                self.stats["mtick_pure_syncs"] += 1
            self.stats["last_decode_ticks"] = ticks
            counts = np.zeros(R, np.int32)  # accepted tokens per slot
            for slot in range(self.num_slots):
                s = self._slots[slot]
                if s is not None and dec_mask[slot]:
                    s.launches += 1     # rode this step's one program
            emitted_total = self._accept_decode_rows(
                toks_np, ticks, dec_mask, finished, counts=counts)
            # each surviving decode row adopts its key at its cut,
            # keys_walk[m - 1] after m accepted tokens; snapshot after the
            # chunk bookkeeping (a final chunk's key write must survive)
            knp = self._keys.copy()
            for slot in range(self.num_slots):
                seq = self._slots[slot]
                if seq is None or not dec_mask[slot] \
                        or seq.status != "running" or counts[slot] == 0:
                    continue
                knp[slot] = kwalk_np[counts[slot] - 1, slot]
            self._keys = knp
        if tr is not None:
            tr.complete("host-accept", th0,
                        args={"emitted": emitted_total,
                              "ticks_run": ticks})
        return sum(c for _, c in plan) + emitted_total, bool(chunk_rows)

    def _spec_step(self, finished):
        """ONE call for everything a speculative step advances: every
        running slot packs a draft-extended verify span ``[last_token, d_1
        .. d_k]`` (the drafts' K/V appended through the block table like a
        chunk's) and every planned chunk its span
        (``decode._spec_verify_impl``). The host accepts the longest draft
        prefix the model's own samples reproduce, emits it plus the
        model's token at the first mismatch (so a launch advances every
        slot), stops at EOS or ``max_new_tokens`` where sequential decode
        would, truncates the rejected draft rows' blocks back to the pool,
        and adopts the key walk at the cut, ``keys_walk[m - 1]`` after m
        emitted tokens. Drafts are clipped per row to ``spec_k``, the
        row's remaining budget less one and the KV capacity, and granted
        from what the chunk plan left of the packed buffer. Returns
        ``(tokens_processed, had_chunks)``."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            co.set_phase("plan")
        plan = []
        if self._chunk and self.scheduler.num_prefilling:
            plan = self.scheduler.prefill_plan(self._prefill_budget(),
                                               self.cache.block_size,
                                               cap=self._chunk)
        active = [(slot, s) for slot, s in enumerate(self._slots)
                  if s is not None and s.status == "running"]
        if not active and not plan:
            return 0, False
        R, T = self.num_slots, self._spec_budget
        lens = self.cache.lengths
        chunk_spend = sum(n for _, n in plan)
        drafts = []
        for slot, s in active:
            cap = min(self._spec_k, s.remaining - 1,
                      self.max_seq_len - int(lens[slot]) - 1)
            d = self.drafter.propose(s, cap) if cap > 0 else ()
            drafts.append(np.asarray(d, np.int32).reshape(-1)[:max(cap, 0)])
        grants = self.scheduler.spec_grants(
            [len(d) for d in drafts], T - R - chunk_spend)
        ids = np.zeros(T, np.int32)
        seg = np.full(T, R, np.int32)       # sentinel: dead packed rows
        pos = np.zeros(T, np.int32)
        qstart = np.zeros(R, np.int32)
        qlen = np.zeros(R, np.int32)
        kvlen = np.zeros(R, np.int32)
        sample_start = np.zeros(R, np.int32)
        temps = np.zeros(R, np.float32)
        topks = np.zeros(R, np.int32)
        keys = self._keys.copy()
        cursor = 0
        verify_rows = []                    # (slot, seq, draft, len0)
        for (slot, s), d, g in zip(active, drafts, grants):
            d = d[:g]
            L0 = int(lens[slot])
            q = 1 + len(d)
            # the span appends rows [L0, L0 + q): the table covers them
            # before the call, and truncate hands rejected ones back
            self.cache.ensure_capacity(slot, L0 + q)
            qstart[slot] = cursor
            qlen[slot] = q
            kvlen[slot] = L0 + q
            sample_start[slot] = cursor     # sample every span position
            ids[cursor] = self._last_tok[slot]
            ids[cursor + 1:cursor + q] = d
            seg[cursor:cursor + q] = slot
            pos[cursor:cursor + q] = np.arange(L0, L0 + q, dtype=np.int32)
            temps[slot] = self._temps[slot]
            topks[slot] = self._topks[slot]
            verify_rows.append((slot, s, d, L0))
            cursor += q
        chunk_rows, cursor = self._pack_chunk_rows(
            plan, cursor, ids, seg, pos, qstart, qlen, kvlen, keys,
            temps, topks, sample_start=sample_start)
        if tr is not None:
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": len(plan),
                              "draft_tokens": int(sum(grants))})
            tl0 = tr.now()
        if co is not None:
            co.set_phase("launch")
        _, _, toks, kwalk = self._spec_fn()(
            self._shards, *self.cache.kv_args(), self.cache.tables, ids,
            seg, pos, qstart, qlen, kvlen, sample_start, keys, temps, topks)
        toks_np = toks.cpu().numpy()        # [spec_len, R]
        kwalk_np = kwalk.numpy()            # [spec_len, R, 2]
        self.stats["spec_steps"] += 1
        if co is not None:
            # one packed verify forward a step (no decode tail)
            self._record_collectives(co, [(self._spec_budget, 1)])
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0, args={"packed_tokens": cursor})
            th0 = tr.now()
        # chunk bookkeeping first, as in the unified step (a final chunk
        # adopts walk step 0's token and key)
        for slot, seq, ntok, final in chunk_rows:
            self._advance_chunk(seq, ntok, toks_np[0, slot],
                                kwalk_np[0, slot], finished)
        emitted_total = 0
        accept_lens = []
        if verify_rows:
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += 1
            self.stats["slot_steps"] += self.num_slots
            # snapshot after the chunk bookkeeping: a final chunk's key
            # write must survive
            knp = self._keys.copy()
            for slot, seq, d, L0 in verify_rows:
                seq.launches += 1       # rode this step's one verify
                a = 0
                while a < len(d) and int(toks_np[a, slot]) == int(d[a]):
                    a += 1
                req = seq.request
                emit = []
                for j in range(a + 1):
                    t = int(toks_np[j, slot])
                    emit.append(t)
                    if req.eos_token_id is not None \
                            and t == int(req.eos_token_id):
                        break       # sequential decode stops here
                    if len(seq.tokens) + len(emit) \
                            >= int(req.max_new_tokens):
                        break
                m = len(emit)
                # rows [L0, L0 + 1 + len(d)) were written; [L0, L0 + m)
                # are confirmed (the last emitted token's own KV is not in
                # the cache, as after any decode tick)
                self.cache.truncate(slot, L0 + m)
                self.cache.lengths[slot] = L0 + m
                self._last_tok[slot] = emit[-1]
                knp[slot] = kwalk_np[m - 1, slot]
                self.stats["spec_proposed"] += len(d)
                self.stats["spec_accepted"] += m - 1
                self.stats["spec_tokens"] += m
                accept_lens.append(m)
                if tr is not None and len(seq.trace_accepts) < 512:
                    seq.trace_accepts.append(m)
                emitted_total += m
                for t in emit:
                    seq.tokens.append(t)
                    self.stats["active_slot_steps"] += 1
                    self.stats["tokens_generated"] += 1
                    self._emit(seq, t)
                self._maybe_finish(seq, finished)
            self._keys = knp
        self.stats["spec_last_accept"] = accept_lens
        if tr is not None:
            if verify_rows:
                tr.instant("spec_accept",
                           args={"accept_lens": list(accept_lens),
                                 "proposed": [len(d) for _, _, d, _
                                              in verify_rows]})
            tr.complete("host-accept", th0,
                        args={"emitted": emitted_total})
        return chunk_spend + emitted_total, bool(chunk_rows)

    def _pack_decode_rows(self, n, ids, seg, pos, qstart, qlen, kvlen,
                          dec_mask, temps, topks, eos_ids=None,
                          budgets=None):
        """Pack every RUNNING slot's span-1 decode row into the packed
        buffer, pre-growing its table for the fused ticks: ``n`` rows on
        the unified step (its tail appends unconditionally), ``min(n,
        remaining)`` when the alive-mask metadata (``eos_ids``/``budgets``,
        the multi-tick step) is packed too, since the device stops a row's
        appends at its cut. Returns the cursor past the decode rows."""
        lens = self.cache.lengths
        cursor = 0
        for slot, s in enumerate(self._slots):
            if s is None or s.status != "running":
                continue
            grow = n if budgets is None else min(n, s.remaining)
            self.cache.ensure_capacity(slot, int(lens[slot]) + grow)
            qstart[slot] = cursor
            qlen[slot] = 1
            kvlen[slot] = int(lens[slot]) + 1
            dec_mask[slot] = 1
            ids[cursor] = self._last_tok[slot]
            seg[cursor] = slot
            pos[cursor] = int(lens[slot])
            temps[slot] = self._temps[slot]
            topks[slot] = self._topks[slot]
            if eos_ids is not None:
                eos = s.request.eos_token_id
                eos_ids[slot] = -1 if eos is None else int(eos)
                budgets[slot] = s.remaining
            cursor += 1
        return cursor

    def _accept_decode_rows(self, toks_np, n, dec_mask, finished,
                            counts=None):
        """Host-accept of the fused ticks' ``[n, R]`` token block, tick
        major; a slot whose sequence finished at an earlier tick is
        skipped from then on (on the multi-tick step the device's alive
        cut equals this trim). ``counts`` ([R], optional) receives each
        slot's accepted tokens, the multi-tick key-walk index. Returns
        tokens emitted."""
        emitted = 0
        for i in range(n):
            for slot in range(self.num_slots):
                seq = self._slots[slot]
                if seq is None or seq.status != "running" \
                        or not dec_mask[slot]:
                    continue
                t = int(toks_np[i, slot])
                seq.tokens.append(t)
                if counts is not None:
                    counts[slot] += 1
                self.cache.lengths[slot] += 1
                self._last_tok[slot] = t
                self.stats["active_slot_steps"] += 1
                self.stats["tokens_generated"] += 1
                emitted += 1
                self._emit(seq, t)
                self._maybe_finish(seq, finished)
        return emitted

    def _pack_chunk_rows(self, plan, cursor, ids, seg, pos, qstart, qlen,
                         kvlen, keys, temps, topks, sample_start=None):
        """Pack this step's planned prefill chunks into the packed buffer,
        for the unified, multi-tick and speculative steps alike. A chunk
        row samples (and advances its key) only on its FINAL chunk, so the
        stream equals a one-shot prefill's. ``sample_start`` is the verify
        program's extra metadata: a chunk row samples at its span END.
        Returns ``(chunk_rows, cursor)``."""
        chunk_rows = []                     # (slot, seq, n_tokens, final)
        for seq, ntok in plan:
            slot, off = seq.slot, seq.prefilled
            self.cache.ensure_capacity(slot, off + ntok)
            final = off + ntok == seq.work_len
            qstart[slot] = cursor
            qlen[slot] = ntok
            kvlen[slot] = off + ntok
            if sample_start is not None:
                sample_start[slot] = cursor + ntok - 1
            ids[cursor:cursor + ntok] = seq.work[off:off + ntok]
            seg[cursor:cursor + ntok] = slot
            pos[cursor:cursor + ntok] = np.arange(off, off + ntok,
                                                  dtype=np.int32)
            keys[slot] = np.asarray(seq.key, np.int64)
            if final:
                temps[slot] = float(seq.request.temperature)
                topks[slot] = int(seq.request.top_k)
            chunk_rows.append((slot, seq, ntok, final))
            cursor += ntok
        return chunk_rows, cursor

    def has_work(self) -> bool:
        return bool(self.scheduler.num_queued
                    or any(s is not None for s in self._slots))

    # ------------------------------------------------------------- offline
    def generate(self, requests):
        """Submit all, run to completion, return each request's
        :class:`GenerationResult` in submission order."""
        seqs = [self.submit(r) for r in requests]
        while self.has_work():
            self.step()
        return [GenerationResult(s.output_ids(), s.finish_reason,
                                 s.request_id) for s in seqs]
