"""``PyLayer`` — user-defined differentiable ops, the counterpart of
``paddle_tpu/autograd/py_layer.py``, as a thin class over
``torch.autograd.Function``.

Subclass with ``@staticmethod forward(ctx, *args)`` and ``@staticmethod
backward(ctx, *grads)`` and call ``MyOp.apply(*args)``. ``ctx`` is a
:class:`PyLayerContext` with Paddle's ``save_for_backward`` /
``saved_tensor``. Tensor arguments are differentiable; ``backward``
returns one gradient per tensor argument, in order (None becomes zeros,
as in the reference); other arguments get none.
"""
from __future__ import annotations

import torch


class PyLayerContext:
    """Carries state from ``forward`` to ``backward``."""

    def __init__(self, fn_ctx=None):
        self._ctx = fn_ctx
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if self._ctx is not None and all(isinstance(t, torch.Tensor)
                                         for t in tensors):
            self._ctx.save_for_backward(*tensors)
            self._saved = None
        else:
            self._saved = tensors

    def saved_tensor(self):
        return self._ctx.saved_tensors if self._saved is None \
            else self._saved


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, n_args, *args):
        ctx.layer = layer
        ctx.pctx = PyLayerContext(ctx)
        ctx.tensor_pos = [i for i, a in enumerate(args)
                          if isinstance(a, torch.Tensor)]
        ctx.meta = [(a.shape, a.dtype, a.device) if isinstance(
            a, torch.Tensor) else None for a in args]
        return layer.forward(ctx.pctx, *args)

    @staticmethod
    def backward(ctx, *grads):
        with torch.no_grad():
            got = ctx.layer.backward(ctx.pctx, *grads)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        out = [None] * len(ctx.meta)
        for j, pos in enumerate(ctx.tensor_pos):
            g = got[j] if j < len(got) else None
            if g is None:
                shape, dtype, dev = ctx.meta[pos]
                g = torch.zeros(shape, dtype=dtype, device=dev)
            out[pos] = g
        return (None, None, *out)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        if kwargs:
            raise TypeError("PyLayer.apply takes positional arguments only "
                            "(reference eager PyLayer semantics)")
        return _Function.apply(cls, len(args), *args)


LegacyPyLayer = PyLayer

__all__ = ["PyLayer", "PyLayerContext", "LegacyPyLayer"]
