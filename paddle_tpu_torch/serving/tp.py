"""Tensor-parallel serving: the engine's ``tp=N`` sharded over heads.

The port of the tensor-parallel plumbing of ``paddle_tpu/serving/
decode.py``. The JAX package wraps every serving program in
``shard_map`` over a ``("tp",)`` mesh: one process, one program, ``tp``
shards that each run the layer body on their own heads and meet at two
all-reduces a layer. The port keeps that single-controller design. One
engine holds ``tp`` shards, each with

- its own parameter dict (:func:`place_tp_params`): column shards of
  ``wq/wk/wv/w_gate/w_up`` (``nh/tp`` query heads, ``nkv/tp`` KV heads,
  ``intermediate/tp`` MLP features), row shards of ``wo/w_down`` (their
  products are partial sums), and the embedding, norms and lm head
  replicated;
- its own pool planes ``[L, nb, bs, Hkv/tp, D]`` (``BlockManager`` with
  ``tp``; an int8 pool's per-row scale planes split on their head axis 3,
  an fp8 pool's per-block planes on axis 2). The host bookkeeping —
  block tables, refcounts, the prefix trie — stays one copy: every
  shard's pool has the same block layout.

The shards run in lockstep inside each program's layer loop
(``serving/decode.py`` ``layer_stack``): every shard's attention half up
to its partial ``o``, one reduction (:func:`tp_allreduce`) that hands
every shard its reduced copy, the residual add, then the MLP half the
same way. After the last reduction the math is replicated (final norm,
lm head, sampling, the key walk), so it runs once, on shard 0's copy.

Where the shards live: every shard of a ``tp=N`` engine sits on the
engine's device (:func:`tp_devices`) — the CPU in the tests, one card in
``chip_smoke.py`` — as the JAX package's CPU tests build their mesh of
virtual devices on one host. Shards on separate cards are the rest of
ROADMAP Queue A step 10. Every shard tensor is placed and every reduction
moves data with ``.to(devices[s])``, a no-op on a shared device.

An engine without tensor parallelism is the same design at one shard: a
list of one parameter dict, one pool shard, and :func:`one_shard` for the
reduction.

The reductions (``collective_dtype``, ``collective_overlap``):

- ``"fp"``: the shards' partials summed in the order ``0 .. tp - 1``
  (:func:`_psum`);
- ``"int8"``: the EQuARX block-quantized all-reduce
  (``quantization.quantized_psum_int8``);
- ``collective_overlap=True``: the partial-sum rows split into
  ``_OVERLAP_CHUNKS`` row chunks, each reduced on its own
  (:func:`_overlap_reduce`), and fp runs the ring reduce-scatter +
  all-gather (:func:`_permute_allreduce`), in the ring's own summation
  order. Row chunking keeps every row's scale and value, so streams and
  the byte ledger equal the unchunked schedule's; on one card nothing
  overlaps, and the schedule is here for its values and its ledger.

Every reduction counts in the launching thread's tally beside the
kernels' launches (``kernels.count_launch``; graph captures and replays
as theirs): ``tp_reduce`` one a reduction, ``tp_wire_ops`` the wire
operations the reference's schedule lowers it to (``psum`` one; int8 two
``all_to_all`` and two ``all_gather``; the ring ``2 (tp - 1)``
``ppermute``; times the chunks under overlap) and ``tp_wire_bytes`` the
bytes of ``quantization.collective_wire_bytes`` — what the device really
ran, beside the engine's ledger, which follows the reference's launch
accounting.
"""
from __future__ import annotations

import torch

from ..kernels import count_launch
from ..quantization import collective_wire_bytes, quantized_psum_int8

_COL_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")   # shard output features
_ROW_KEYS = ("wo", "w_down")                       # shard input features

#: row chunks of one overlapped reduction site
_OVERLAP_CHUNKS = 2


# ---------------------------------------------------------------- layout
def tp_devices(tp, device):
    """The devices of a ``tp``-way engine's shards: ``device`` for every
    shard (shards on separate cards are not ported)."""
    return [torch.device(device)] * tp


def _tp_validate(nh, nkv, inter, tp):
    """Refuse a degree the head or MLP axes cannot split evenly, as the
    reference's ``device_put`` onto its sharding refuses an axis the mesh
    does not divide."""
    if nh % tp or nkv % tp:
        raise ValueError(
            f"tp={tp} must divide num_attention_heads ({nh}) and "
            f"num_key_value_heads ({nkv}): the mesh shards over heads")
    if inter % tp:
        raise ValueError(
            f"tp={tp} must divide intermediate_size ({inter}): the mesh "
            f"shards the MLP's features")


def _shard(t, axis, s, tp):
    n = t.shape[axis] // tp
    return t.narrow(axis, s * n, n)


def place_tp_params(params, devices):
    """The decode parameter dict split into one shard dict a device,
    shard ``s`` on ``devices[s]``, after the reference's
    ``_params_pspec``: ``wq/wk/wv/w_gate/w_up [L, in, out]`` sharded on
    their output axis, ``wo/w_down`` on their input axis, the rest
    replicated. Under ``quantize_weights`` each projection is an int8
    ``(q, scale [L, 1, out])`` pair: a column-sharded weight's scales
    shard with it, a row-sharded weight's stay whole; the lm head pair is
    replicated. On a shared device the shards are views of the model's
    tensors (no copy)."""
    tp = len(devices)
    out = []
    for s, dev in enumerate(devices):
        shard = {}
        for k, v in params.items():
            if k in _COL_KEYS:
                shard[k] = (tuple(_shard(x, 2, s, tp).to(dev) for x in v)
                            if isinstance(v, tuple)
                            else _shard(v, 2, s, tp).to(dev))
            elif k in _ROW_KEYS:
                shard[k] = ((_shard(v[0], 1, s, tp).to(dev), v[1].to(dev))
                            if isinstance(v, tuple)
                            else _shard(v, 1, s, tp).to(dev))
            else:
                shard[k] = (tuple(x.to(dev) for x in v)
                            if isinstance(v, tuple) else v.to(dev))
        out.append(shard)
    return out


# ------------------------------------------------------------ reductions
def one_shard(parts):
    """``tp_reduce`` of an engine of one shard: its partial sum is the
    sum."""
    return parts


def _psum(parts, devices):
    """The fp all-reduce: the partials summed in shard order ``0 .. tp -
    1`` (at ``tp=2`` one add, the reference's ``psum``'s bits); every
    shard gets a copy."""
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(devices[0])
    return [total.to(d) for d in devices]


def _permute_allreduce(parts, devices):
    """The ring reduce-scatter + all-gather of ``collective_overlap=True``
    (fp), in the ring's own summation order: the hidden axis splits into
    ``tp`` pieces, and piece ``p`` is accumulated around the ring from
    shard ``p - 1``, each hop adding the next shard's piece to what it
    received (``((x[p-1] + x[p]) + x[p+1]) + ... + x[p-2]``, shards
    mod ``tp``); the summed pieces then circulate back to every shard.
    At ``tp=2`` every element is one commutative add, the bits of
    :func:`_psum`."""
    tp = len(parts)
    hid = parts[0].shape[-1]
    n = hid // tp
    summed = []
    for p in range(tp):
        first = (p - 1) % tp
        acc = parts[first][..., p * n:(p + 1) * n]
        for j in range(1, tp):
            s = (first + j) % tp
            acc = acc.to(devices[s]) + parts[s][..., p * n:(p + 1) * n]
        summed.append(acc)
    return [torch.cat([x.to(d) for x in summed], dim=-1) for d in devices]


def _overlap_reduce(base, parts, devices):
    """The chunked schedule of one reduction site: the partial-sum rows
    split into ``_OVERLAP_CHUNKS`` row chunks, each reduced by ``base``
    on its own, then put back together per shard. Row chunks only, so
    every row's scale (int8) and value are what the unchunked reduction
    gives."""
    shp = parts[0].shape
    rows = parts[0].numel() // shp[-1]
    flat = [p.reshape(rows, shp[-1]) for p in parts]
    n = max(1, min(_OVERLAP_CHUNKS, rows))
    bounds = [(i * rows) // n for i in range(n + 1)]
    chunks = [base([f[lo:hi] for f in flat], devices)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    return [torch.cat([c[s] for c in chunks]).reshape(shp)
            for s in range(len(parts))]


def tp_allreduce(collective_dtype, devices, overlap=False):
    """The per-layer cross-shard reduction (the reference's
    ``_tp_allreduce``), ``tp_reduce`` of the layer loops: a callable
    taking the shards' partial sums and returning every shard's reduced
    copy. ``"fp"`` sums in shard order, ``"int8"`` is the EQuARX
    all-reduce; ``overlap`` swaps in the row-chunked schedule, and fp its
    ring (module docstring)."""
    tp = len(devices)
    if collective_dtype == "int8":
        base, ops = quantized_psum_int8, 4   # 2 all_to_all + 2 all_gather
    elif overlap:
        base, ops = _permute_allreduce, 2 * (tp - 1)   # ppermute hops
    else:
        base, ops = _psum, 1

    def reduce(parts):
        hidden = parts[0].shape[-1]
        rows = parts[0].numel() // hidden
        if overlap:
            out = _overlap_reduce(base, parts, devices)
            chunks = max(1, min(_OVERLAP_CHUNKS, rows))
        else:
            out = base(parts, devices)
            chunks = 1
        count_launch("tp_reduce")
        count_launch("tp_wire_ops", ops * chunks)
        count_launch("tp_wire_bytes", collective_wire_bytes(
            rows, hidden, tp, collective_dtype,
            fp_itemsize=parts[0].element_size()))
        return out

    return reduce
