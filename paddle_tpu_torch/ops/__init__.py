"""The op library: Paddle's functional surface over torch — the
counterpart of ``paddle_tpu/ops/__init__.py`` for its four core modules
(``creation``, ``math``, ``manipulation``, ``linalg``). Nothing is
patched onto ``torch.Tensor``: Paddle-only methods (``cast``,
``astype`` …) are these functions. ``extra``, ``inplace`` and ``tail``
wait for ROADMAP.md Queue A step 12b."""
from __future__ import annotations

from ._op import OP_REGISTRY, op, register_op
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from . import creation, linalg, manipulation, math  # noqa: F401
from .manipulation import (broadcast_tensors, broadcast_to, cast, chunk,
                           expand, expand_as, numel, pad, reshape,
                           scatter_nd, shape, split, tile, unbind, unstack,
                           view)
from .math import floor_mod

# public ops that wrap a body registered under a private name, or compose
# registered ops: recorded under their public names, as the reference does
for _f in (reshape, split, chunk, unstack, unbind, tile, broadcast_to,
           expand, expand_as, broadcast_tensors, scatter_nd, pad, cast,
           numel, shape, floor_mod, view):
    register_op(_f)
register_op(cast, name="astype")
del _f
