"""The multi-tick step's tail on a CUDA graph: one scanned decode tick,
captured once over static device buffers and replayed once per tick.

The JAX package runs the multi-tick tail as a compiled ``lax.while_loop``
(``paddle_tpu/serving/decode.py``, ``_multitick_step_impl``): one program,
no host in the loop. Eager PyTorch would instead pay the Python launches
of every tick's ops (about 15 a layer). The port's form of that one
program is this module: :func:`tail_tick` is one tick that reads and
writes only device state (:class:`TailState`), so it can be captured as a
``torch.cuda.CUDAGraph`` and replayed ``n`` times with no host work
between ticks.

What the tick keeps on the device, where the unified step's tick
(``serving/decode.py``, ``_fused_decode_tick``) uses host metadata:

- the lengths, the alive mask, the last tokens and the tick counter; the
  append coordinates and RoPE positions are computed from them;
- the alive mask retires a row on its EOS (``eos``, -1 for none) or when
  its budget is spent, as the host's ``_maybe_finish`` would: a retired
  row stops appending and its length stops advancing;
- a masked row cannot simply skip its write (the write set is fixed at
  capture) and ``index_put_`` faults on the sentinel block id, so every
  row that does not append writes the current value of one trash
  coordinate back to it. The host picks that coordinate where no
  appending row of the step writes (:func:`trash_coord`), so the rewrite
  aliases no live write and changes no bit of the pool;
- the PRNG draws: every row splits its key every tick, dead or alive, so
  the walk does not depend on the tokens; the host computes the ``n``
  draws before the launch (``core/random.py``, bit for bit jax's) and
  uploads them once;
- on a quantized pool the append quantizes on the device inside the tick
  (``kv_cache.quantize_kv_rows`` / ``quantize_kv_rows_fp8``): an int8
  pool writes data and scale plane at the same flat coordinate, the trash
  row carrying back its own data and its own scale; an fp8 pool writes
  the data alone, through a ``uint8`` view (CUDA's ``where`` and
  ``index_put_`` take no float8).

On the CPU, or with ``FLAGS_cuda_graph_tail`` off, the same tick runs
eagerly: that is what the CPU tests hold against the JAX program.
:class:`TailGraphs` (one an engine) holds the captured graphs, keyed by
``(num_slots, max_blocks, dtype, all-greedy, kernels)``. The first use of
a key runs its first tick eagerly on the current stream (which builds
and loads the kernels and allocates the split-KV tickets outside the
graph's memory pool), then captures on a side stream; a capture that
fails raises, and nothing falls back to the eager tail. Every launch,
replays included, goes on the current stream, the device's default
stream on every thread: the kernels' shared per-device buffers
(``kernels/split_kv.py``) need them ordered.

Launch counts: the kernel wrappers count at capture, when nothing runs on
the device, so the capture's counts are taken back and recorded with the
graph, and every replay adds them (``kernels.count_replay``), a
tensor-parallel tick's reductions with them.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import random as prng
from ..flags import get_flag
from ..kernels import capture_counts, count_replay
from ..models.llama import _rms, _rotate_half
from .kv_cache import quantize_kv_rows, quantize_kv_rows_fp8, store_view
from .tp import one_shard

# one graph capture at a time in the process (an engine fleet's replicas
# drive their engines from threads of their own)
_CAPTURE_LOCK = threading.Lock()

NEG_INF = -1e30


def apply_rope_rows(x, sin_p, cos_p):
    """Rope with a different position per batch row (ragged decode).
    x: [B, 1, H, D]; sin_p/cos_p: [B, D] taken at each row's position."""
    return (x * cos_p[:, None, None, :]
            + _rotate_half(x) * sin_p[:, None, None, :]).to(x.dtype)


def decode_layers(params, h, sin_r, cos_r, n_layers, write, attend, *, nh,
                  nkv, hd, eps, a8=False, tp_reduce=one_shard):
    """The layer stack of one decode tick, shared by every single-token
    program (the unified and two-program ticks, dense decode, the
    multi-tick tail): ``serving/decode.py``'s ``layer_stack`` with RoPE
    at each row's position, ``write(l, k, v, s)`` (the rows' K/V ``[R,
    Hkv, D]`` into the layer's cache) and ``attend(l, q, s)`` (``[R, H,
    D]`` → ``[R, H, D]``), ``s`` the shard. ``h`` is every shard's copy
    of the embedded tokens ``[R, 1, hidden]``; returns the residual stream
    after the last layer."""
    from .decode import layer_stack

    def core(l, q, k, v, s):
        q = apply_rope_rows(q, sin_r, cos_r)
        k = apply_rope_rows(k, sin_r, cos_r)
        write(l, k[:, 0], v[:, 0], s)
        return attend(l, q[:, 0], s)

    return layer_stack(params, h, n_layers, core, nh=nh, nkv=nkv, hd=hd,
                       eps=eps, a8=a8, tp_reduce=tp_reduce)


def sampling_args(temps, top_ks, V, dev):
    """The per-row sampling knobs as device tensors: temperatures
    (clamped at 1e-6), the ascending-sort index of each row's k-th largest
    logit ``[R, 1]`` and the sampled-row mask; ``None`` when every row is
    greedy (the sampler's host branch: no sort, no draw)."""
    temps = np.asarray(temps, np.float32)
    if not (temps > 0.0).any():
        return None
    tk = np.asarray(top_ks, np.int64)
    k_eff = np.clip(np.where(tk <= 0, V, tk), 1, V)
    return (torch.from_numpy(np.maximum(temps, np.float32(1e-6))).to(dev),
            torch.from_numpy(V - k_eff)[:, None].to(dev),
            torch.from_numpy(temps > 0.0).to(dev))


def sample_rows_dev(logits, draw, args):
    """Per-row sampling on device tensors only: greedy (the first maximal
    index, as ``jnp.argmax``) where a row's temperature is <= 0, else a
    top-k temperature Gumbel-max draw under ``draw [R, 2]``. ``args`` is
    :func:`sampling_args`' tuple, or None for an all-greedy batch."""
    greedy = torch.argmax(logits, dim=-1)
    if args is None:
        return greedy
    temps, kth_idx, sampled = args
    lg = logits.float() / temps[:, None]
    srt = torch.sort(lg, dim=-1).values      # ascending: kth = srt[V - k]
    kth = torch.gather(srt, 1, kth_idx)
    lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    return torch.where(sampled, prng.categorical(draw, lg), greedy)


def trash_coord(tables, nb, bs, lens0, dec_mask, n_ticks):
    """A pool coordinate ``(block, row)`` no appending row writes in a
    step of ``n_ticks`` ticks: decode row r (``dec_mask``) appends at most
    at logical rows ``[lens0[r], lens0[r] + n_ticks)`` through its table.
    The highest block's row 0 unless that is such a target. One always
    exists: the pool holds ``num_slots * max_seq_len`` rows at least, and
    the appends of a step fewer. The tail takes it flattened,
    ``block * bs + row``."""
    mb = tables.shape[1]
    targets = set()
    for r in np.flatnonzero(np.asarray(dec_mask) > 0):
        p0 = int(lens0[r])
        for p in range(p0, min(p0 + n_ticks, mb * bs)):
            targets.add((int(tables[r, p // bs]), p % bs))
    for b in range(nb - 1, -1, -1):
        for p in range(bs):
            if (b, p) not in targets:
                return b, p
    raise RuntimeError("no pool row outside the step's appends")


class TailState:
    """The static device buffers one tail runs on: ``R`` rows of at most
    ``max_ticks`` ticks over tables of ``mb`` blocks. The program fills
    them before the first tail tick (:meth:`load`); :func:`tail_tick`
    reads and updates them in place."""

    def __init__(self, R, mb, max_ticks, sin, cos, greedy, dev):
        i64 = dict(dtype=torch.int64, device=dev)
        self.tok = torch.zeros(R, **i64)              # last sampled tokens
        self.lens = torch.zeros(R, **i64)             # rows written so far
        self.alive = torch.zeros(R, dtype=torch.bool, device=dev)
        self.tables = torch.zeros(R, mb, dtype=torch.int32, device=dev)
        # lens0, eos, budgets, the flat trash row, then the draws
        # [max_ticks, R, 2]
        self.meta = torch.zeros(3 * R + 1 + 2 * max_ticks * R, **i64)
        self.eos = self.meta[R:2 * R]
        self.budgets = self.meta[2 * R:3 * R]
        self.trash = self.meta[3 * R:3 * R + 1]
        self.draws = self.meta[3 * R + 1:].view(max_ticks, R, 2)
        self.toks = torch.zeros(max_ticks, R, **i64)   # tick t's samples
        self.alive_hist = torch.zeros(max_ticks, R, dtype=torch.bool,
                                      device=dev)
        self.t = torch.zeros(1, **i64)                 # the tick index
        self.sin, self.cos = sin, cos
        self.sampling = None if greedy else (
            torch.zeros(R, dtype=torch.float32, device=dev),
            torch.zeros(R, 1, **i64),
            torch.zeros(R, dtype=torch.bool, device=dev))

    def load(self, tok0, tables_dev, meta, sampling, alive0):
        """Fill the buffers for one step: tick 0's tokens, the tables, the
        packed int64 metadata (lens0, eos, budgets, trash row, draws) and the
        sampling knobs (device tensors); ticks start at 1."""
        self.tok.copy_(tok0)
        self.tables.copy_(tables_dev)
        self.meta.copy_(meta)
        self.lens.copy_(self.meta[:self.tok.shape[0]])
        self.alive.copy_(alive0)
        self.t.fill_(1)
        if self.sampling is not None:
            for dst, src in zip(self.sampling, sampling):
                dst.copy_(src)


def _masked_rows(t, flat, live, x, trash):
    """``t`` viewed as rows of ``x``'s trailing shape: write ``x`` at
    ``flat`` where ``live``, the trash row's own value elsewhere."""
    rows = t.view((-1,) + tuple(x.shape[1:]))
    old = rows.index_select(0, trash)
    rows[flat] = torch.where(live.view((-1,) + (1,) * (x.dim() - 1)), x, old)


def _masked_write(pool_l, flat, live, x, trash):
    """Write rows ``x [R, Hkv, D]`` at flat pool rows ``flat`` (block *
    bs + row) where ``live``; every other row carries the trash row's own
    value back to it. A quantized pool side ``(data, scale)`` quantizes
    on write: int8 data and scale at the same flat row (the trash row's
    data and scale both carried back), fp8 data alone. Only 1-D index
    tensors: a 0-d one would be read on the host, a sync the capture
    refuses."""
    if isinstance(pool_l, tuple):
        data, sc = pool_l
        if data.dtype == torch.float8_e4m3fn:
            _masked_rows(store_view(data), flat, live,
                         store_view(quantize_kv_rows_fp8(x)), trash)
            return
        q, s = quantize_kv_rows(x)
        _masked_rows(data, flat, live, q, trash)
        _masked_rows(sc, flat, live, s, trash)
        return
    _masked_rows(pool_l, flat, live, x, trash)


def tail_tick(params, head, pool_k, pool_v, st, *, nh, nkv, hd, eps,
              paged_fn, a8=False, tp_reduce=one_shard):
    """ONE scanned decode tick on device state ``st``: embed the last
    tokens; per layer RMSNorm → QKV → RoPE at each row's length → append
    K/V through the tables (alive rows) → paged attention over ``lens +
    alive`` (``paged_fn``: the kernel or its plain version) → O-proj →
    SwiGLU; then the final norm, the lm head and one sample per row under
    tick t's draw. Records tick t's tokens and alive mask, advances the
    lengths of the alive rows, retires rows on EOS or budget and moves to
    tick t + 1, all in place: no host value is read. A quantized pool
    side is a ``(data, scale)`` pair (:func:`_masked_write`); ``a8`` runs
    the projections int8 x int8. ``params`` and the pool sides are
    per-shard lists: every shard appends to and attends over its own pool
    at the same coordinates."""
    from .decode import _embed, _head_logits, _kv_data, _kv_layer, \
        _paged_attend
    nb, bs = _kv_data(pool_k).shape[1], _kv_data(pool_k).shape[2]
    mb = st.tables.shape[1]
    s_tot = mb * bs
    lens, am = st.lens, st.alive
    bi = torch.clamp(lens // bs, max=mb - 1)
    phys = torch.gather(st.tables, 1, bi[:, None])[:, 0].long()
    live = am & (lens < s_tot) & (phys < nb)
    flat = torch.where(live, phys * bs + lens % bs, st.trash)
    pidx = torch.clamp(lens, 0, s_tot - 1)
    sin_r, cos_r = st.sin[pidx], st.cos[pidx]
    att_len = (lens + am).to(torch.int32)

    def write(l, k, v, s):
        _masked_write(_kv_layer(pool_k[s], l), flat, live, k, st.trash)
        _masked_write(_kv_layer(pool_v[s], l), flat, live, v, st.trash)

    h = decode_layers(
        params, _embed(params, st.tok[:, None]), sin_r, cos_r,
        _kv_data(pool_k).shape[0], write,
        lambda l, q, s: _paged_attend(paged_fn, q, _kv_layer(pool_k[s], l),
                                      _kv_layer(pool_v[s], l), st.tables,
                                      att_len),
        nh=nh, nkv=nkv, hd=hd, eps=eps, a8=a8, tp_reduce=tp_reduce)
    logits = _head_logits(_rms(h[:, 0], params[0]["final_norm"], eps), head)
    nxt = sample_rows_dev(logits, st.draws.index_select(0, st.t)[0],
                          st.sampling)
    st.toks.index_copy_(0, st.t, nxt[None])
    st.alive_hist.index_copy_(0, st.t, am[None])
    st.alive.copy_(am & (nxt != st.eos) & (st.t + 1 < st.budgets))
    st.lens.add_(am.long())
    st.tok.copy_(nxt)
    st.t.add_(1)


class _Entry:
    __slots__ = ("state", "graph", "counts")

    def __init__(self, state):
        self.state = state
        self.graph = None
        self.counts = {}


class TailGraphs:
    """One engine's captured tail ticks and their static buffers, one
    entry a key. ``ticks`` counts the tail ticks run through it (eager
    warm-ups and replays), ``captures`` the graphs captured."""

    def __init__(self):
        self._entries = {}
        self.ticks = 0
        self.captures = 0

    def state(self, key, make):
        """The entry's :class:`TailState`, made by ``make()`` on first
        use."""
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry(make())
        return e.state

    def run(self, key, n, tick, graph=True):
        """Run ``n`` tail ticks of entry ``key``: ``tick()`` is one
        :func:`tail_tick` on the entry's state. With ``graph``, the first
        tick of a key never run before goes eagerly (the warm-up), then
        the graph is captured on a side stream; every other tick is a
        replay. A capture that fails raises. Without, every tick runs
        eagerly."""
        self.ticks += n
        if not graph:
            for _ in range(n):
                tick()
            return
        e = self._entries[key]
        done = 0
        if e.graph is None and n > 0:
            # the warm-up runs on the current (default) stream: its
            # kernels share the device's split-KV tickets and the fused
            # tick's grid barrier with every other launch there, a
            # fleet's other replicas' included, and stay ordered with them
            tick()
            done = 1
            side = torch.cuda.Stream()
            # capture_begin/end on the side stream, not torch.cuda.graph:
            # its entry empties the allocator's cache, and every later step
            # would pay cudaMalloc for its activations again. A capture
            # runs nothing, so the side stream only records. Thread-local
            # capture, one capture at a time in the process: a fleet's
            # other replicas go on launching (and allocating) on their
            # own threads, on the default stream, which does not
            # synchronise with the non-blocking side stream
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, capture_counts(e.counts), \
                    torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    tick()
                finally:
                    graph.capture_end()
            e.graph = graph
            self.captures += 1
        for _ in range(done, n):
            e.graph.replay()
            count_replay(e.counts)

    def release(self):
        """Drop every graph and buffer (a dead engine's)."""
        self._entries.clear()


def use_graph(dev) -> bool:
    """Whether the tail replays a captured graph on ``dev``: a CUDA
    device with ``FLAGS_cuda_graph_tail`` on."""
    return dev.type == "cuda" and get_flag("FLAGS_cuda_graph_tail")
