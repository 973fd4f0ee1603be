"""Eager autograd — the counterpart of ``paddle_tpu/autograd/engine.py``
(``:1-60`` and ``grad``), on PyTorch's own engine: the JAX package records
a ``jax.vjp`` tape op by op; here every op is a torch op and torch's
autograd records it. ``no_grad``, ``enable_grad`` and
``set_grad_enabled`` are torch's; :func:`grad` takes Paddle's arguments.
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    grads = None if grad_tensors is None else _as_list(grad_tensors)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (a list), leaving every ``.grad`` untouched. An input the
    outputs do not reach raises unless ``allow_unused`` (then None), as
    in the reference. ``create_graph=True`` raises there (no higher-order
    eager gradients), and so it does here."""
    if create_graph:
        raise NotImplementedError(
            "create_graph=True (higher-order eager grad) is not supported, "
            "as in the reference; see ROADMAP.md Queue A step 12b "
            "(autograd/functional)")
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    grads = None if grad_outputs is None else _as_list(grad_outputs)
    got = torch.autograd.grad(outputs, inputs, grads,
                              retain_graph=retain_graph, allow_unused=True)
    for i, (t, g) in enumerate(zip(inputs, got)):
        if g is None and not allow_unused:
            raise ValueError(
                f"input {i} (shape {tuple(t.shape)}) is unreachable from "
                "outputs; pass allow_unused=True to get None for it")
    return list(got)


__all__ = ["backward", "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled"]
