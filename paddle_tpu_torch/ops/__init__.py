"""The op library: Paddle's functional surface over torch — the
counterpart of ``paddle_tpu/ops/__init__.py`` for its four core modules
(``creation``, ``math``, ``manipulation``, ``linalg``, and the long
tail: ``extra``, ``tail`` and the in-place ``inplace``). Nothing is
patched onto ``torch.Tensor``: Paddle-only methods (``cast``,
``astype`` …) and the in-place ``*_`` variants are these functions."""
from __future__ import annotations

from ._op import OP_REGISTRY, op, register_op
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from . import creation, linalg, manipulation, math  # noqa: F401
from .manipulation import (broadcast_tensors, broadcast_to, cast, chunk,
                           expand, expand_as, numel, pad, reshape,
                           scatter_nd, shape, split, tile, unbind, unstack)
from .math import floor_mod
from .extra import *  # noqa: F401,F403
from .inplace import *  # noqa: F401,F403
from .tail import *  # noqa: F401,F403
from . import extra, inplace, tail  # noqa: F401
from .tail import view

# public ops that wrap a body registered under a private name, or compose
# registered ops: recorded under their public names, as the reference does
for _f in (reshape, split, chunk, unstack, unbind, tile, broadcast_to,
           expand, expand_as, broadcast_tensors, scatter_nd, pad, cast,
           numel, shape, floor_mod, view, extra.bucketize, extra.lu_unpack,
           extra.broadcast_shape, extra.tensor_split, extra.hsplit,
           extra.vsplit, extra.dsplit, extra.tolist, extra.rank,
           extra.is_tensor, extra.is_complex, extra.is_floating_point,
           extra.is_integer, extra.is_empty, extra.tril_indices,
           extra.triu_indices, extra.poisson, extra.randint_like,
           extra.set_printoptions):
    register_op(_f)
register_op(cast, name="astype")
del _f
