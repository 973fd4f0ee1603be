"""The op registry and the AMP dispatch point — the counterpart of
``paddle_tpu/ops/_op.py``.

The port's ops are plain functions on ``torch.Tensor`` with Paddle's
signatures; torch's autograd records them. :func:`op` registers a
function in :data:`OP_REGISTRY` under its dispatch name (the JAX
package's registry name: ``_reshape`` for ``reshape``'s body,
``_cross_entropy_impl`` for ``cross_entropy``'s …), so a test can
enumerate the op library, and wraps it so that under ``amp.auto_cast``
its floating tensor inputs are cast by that name before it runs
(``paddle_tpu/ops/_op.py:52-56``). An op's body calls torch functions
only, never another registered op, so one call casts once, as one
``tensor_op`` application does there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

from ..amp import _STATE, amp_cast_inputs

OP_REGISTRY: Dict[str, Callable] = {}


def op(fn=None, *, name=None):
    """Decorator: register ``fn`` as framework op ``name`` (default: its
    own name) with the AMP cast hook."""
    def deco(f):
        op_name = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if _STATE.enabled:
                args, kwargs = amp_cast_inputs(op_name, args, kwargs)
            return f(*args, **kwargs)

        wrapper.raw_fn = f
        wrapper.op_name = op_name
        OP_REGISTRY[op_name] = wrapper
        return wrapper

    if fn is not None:
        return deco(fn)
    return deco


def register_op(fn, name=None):
    """Record an already-built public op (a thin wrapper over a registered
    body, or a composite of registered ops) under its public name, as
    ``paddle_tpu/ops/_op.py`` ``register_op`` does."""
    OP_REGISTRY[name or fn.__name__] = fn
    return fn
