"""Kernels of the serving and training paths — the attention kernels and
the fused decode tick — each a hand-written CUDA kernel for Hopper
(``paddle_tpu_torch/csrc``) beside its plain PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Every launch adds one to the
launching thread's tally of that kernel (an engine fleet runs one driver
thread a replica, all launching into one process): :func:`thread_launches`
reads one thread's, and :data:`LAUNCHES` sums them all when it is read,
so a run can show which kernels its path went through. A CUDA graph
launches its kernels at each replay, not at capture: :func:`capture_counts`
records the capturing thread's launches with the graph instead of
counting them, and :func:`count_replay` adds them at every replay, so
:data:`LAUNCHES` stays equal to what the device ran. The same tallies
count the tensor-parallel engine's cross-shard reductions
(:data:`WIRE`), so captures and replays carry them too.
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping

#: the counted kernels (the flash kernels' fused-RoPE mode counts apart,
#: as ``name[rope]``; ``rope_qk`` is that mode's rotation pre-pass of the
#: backward)
KERNELS = ("flash", "paged_decode", "ragged_attention", "flash_bwd_dkv",
           "flash_bwd_dq", "decode", "fused_decode_tick", "flash[rope]",
           "flash_bwd_dkv[rope]", "flash_bwd_dq[rope]", "rope_qk")
#: the tensor-parallel reductions (``serving/tp.py``), counted beside the
#: launches: reductions, the wire operations they lower to, wire bytes
WIRE = ("tp_reduce", "tp_wire_ops", "tp_wire_bytes")
_COUNTED = KERNELS + WIRE
# each thread's tally by its ident, written only by that thread (a thread
# that takes a finished thread's ident carries on its tally)
_BY_THREAD = {}
_local = threading.local()


class _Launches(Mapping):
    """Launches per kernel since the last :func:`reset_launches`, summed
    over the threads' tallies at each read."""

    def __getitem__(self, name):
        if name not in _COUNTED:
            raise KeyError(name)
        return sum(t[name] for t in list(_BY_THREAD.values()))

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)

    def __repr__(self):
        return repr(dict(self))


LAUNCHES = _Launches()


def reset_launches():
    for tally in list(_BY_THREAD.values()):
        for name in _COUNTED:
            tally[name] = 0


def _tally():
    tally = getattr(_local, "tally", None)
    if tally is None:
        tally = _local.tally = _BY_THREAD.setdefault(
            threading.get_ident(), dict.fromkeys(_COUNTED, 0))
    return tally


def count_launch(name, n=1):
    record = getattr(_local, "capture", None)
    if record is not None:      # captured into a graph: nothing ran
        record[name] += n
    else:
        _tally()[name] += n


def thread_launches(ident=None):
    """One thread's launches per kernel (and its :data:`WIRE` counts)
    since the last reset: the calling thread's, or thread ``ident``'s."""
    tally = _BY_THREAD.get(threading.get_ident() if ident is None
                           else ident)
    return dict(tally) if tally else dict.fromkeys(_COUNTED, 0)


@contextlib.contextmanager
def capture_counts(record):
    """Around a CUDA-graph capture on this thread: the launches counted
    inside go to ``record`` (the graph's launches a replay), not to
    :data:`LAUNCHES` (nothing ran). Other threads count as usual."""
    record.update(dict.fromkeys(_COUNTED, 0))
    _local.capture = record
    try:
        yield record
    finally:
        _local.capture = None


def count_replay(record):
    """One replay of a captured graph: add its launches."""
    tally = _tally()
    for name, n in record.items():
        tally[name] += n
