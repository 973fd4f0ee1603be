"""``paddle.geometric`` — graph message passing and segment reductions,
the counterpart of ``paddle_tpu/geometric.py``.

Each op is plain torch on the tensor's device: ``index_add`` sums rows
into their segments, ``scatter_reduce`` takes their max or min. The JAX
package's rules hold: the row count is ``max(ids) + 1`` of the index data
(``out_size`` where the op takes one), a row no index points at is 0 (not
+-inf), a mean divides by ``max(count, 1)``, and indices outside
``[0, rows)`` are dropped, as XLA's scatter drops them.
"""
from __future__ import annotations

import torch

from .ops._op import op

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "send_u_recv", "send_ue_recv", "send_uv"]


def _num_segments(ids, out_size):
    if out_size is not None:
        return int(out_size)
    return int(torch.as_tensor(ids).max()) + 1


def _segment(data, ids, n, kind):
    ids = torch.as_tensor(ids, device=data.device).long().reshape(-1)
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        data, ids = data[keep], ids[keep]
    rows = (n,) + tuple(data.shape[1:])
    total = data.new_zeros(rows).index_add(0, ids, data)
    if kind == "sum":
        return total
    counts = data.new_zeros(n).index_add(
        0, ids, torch.ones_like(ids, dtype=data.dtype))
    counts = counts.reshape((n,) + (1,) * (data.dim() - 1))
    if kind == "mean":
        return total / torch.clamp(counts, min=1)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_zeros(rows).scatter_reduce(
        0, index, data, "amax" if kind == "max" else "amin",
        include_self=False)
    # the reference's contract: rows no edge points at are 0, not +-inf
    return torch.where(counts > 0, out, torch.zeros_like(out))


def _seg_op(kind):
    @op(name=f"geometric.segment_{kind}")
    def impl(data, segment_ids, n):
        return _segment(data, segment_ids, n, kind)

    def seg(data, segment_ids, name=None):
        return impl(data, segment_ids, _num_segments(segment_ids, None))

    seg.__name__ = seg.__qualname__ = f"segment_{kind}"
    seg.__doc__ = (f"Segment {kind} over non-negative segment ids: one "
                   f"output row a segment, ``max(ids) + 1`` rows.")
    return seg


segment_sum = _seg_op("sum")
segment_mean = _seg_op("mean")
segment_max = _seg_op("max")
segment_min = _seg_op("min")


_MSG_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}


def _gather(x, index):
    return torch.index_select(
        x, 0, torch.as_tensor(index, device=x.device).long().reshape(-1))


@op(name="geometric.send_u_recv")
def _send_u_recv_impl(x, src_index, dst_index, reduce_op, n):
    return _segment(_gather(x, src_index), dst_index, n, reduce_op)


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather ``x`` rows at ``src_index`` and reduce them into
    ``dst_index`` rows (``reduce_op``: sum, mean, max or min)."""
    return _send_u_recv_impl(x, src_index, dst_index, reduce_op,
                             _num_segments(dst_index, out_size))


@op(name="geometric.send_ue_recv")
def _send_ue_recv_impl(x, y, src_index, dst_index, message_op, reduce_op, n):
    msg = _MSG_OPS[message_op](_gather(x, src_index), y)
    return _segment(msg, dst_index, n, reduce_op)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Node rows gathered at ``src_index``, combined with the edge rows
    ``y`` by ``message_op`` (add, sub, mul, div), then reduced into
    ``dst_index`` rows."""
    return _send_ue_recv_impl(x, y, src_index, dst_index, message_op,
                              reduce_op, _num_segments(dst_index, out_size))


@op(name="geometric.send_uv")
def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """One message an edge: ``x[src] (op) y[dst]``, no reduction."""
    return _MSG_OPS[message_op](_gather(x, src_index), _gather(y, dst_index))
