"""``nn.utils`` — the counterpart of ``paddle_tpu/nn/utils/__init__.py``:
flattening parameters to a vector and back, value clipping of gradients,
and the weight-norm and spectral-norm reparameterizations (forward
pre-hooks that rebuild the weight from its parts each call, so autograd
reaches the parts)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Parameter
from ..clip import clip_grad_norm_  # noqa: F401


def parameters_to_vector(parameters):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters):
    offset = 0
    for p in parameters:
        n = math.prod(p.shape)
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient to ``[-clip_value, clip_value]`` in place."""
    cv = float(clip_value)
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-cv, cv)


def _norm_except(v, dim):
    """The L2 norm over every axis but ``dim`` (kept, to broadcast back);
    ``dim=None``: the whole norm."""
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    dim = dim % v.dim()
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


class _WeightNormHook:
    """Rebuilds ``name`` as ``g * v / ||v||`` before each forward; ``g``
    keeps the reference's 1-D shape ``[w.shape[dim]]`` (a scalar for
    ``dim=None``), so state dicts interchange."""

    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def compute(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        if self.dim is not None:
            bshape = [1] * v.dim()
            bshape[self.dim] = v.shape[self.dim]
            g = g.reshape(bshape)
        return v * (g / _norm_except(v, self.dim))

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute(layer))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``layer.<name>`` as magnitude ``<name>_g`` times
    direction ``<name>_v / ||<name>_v||``."""
    w = getattr(layer, name)
    hook = _WeightNormHook(name, dim)
    del layer._parameters[name]
    layer.add_parameter(name + "_v", Parameter(w.detach().clone()))
    with torch.no_grad():
        g0 = _norm_except(w, dim)
    layer.add_parameter(name + "_g", Parameter(
        g0.reshape(-1) if dim is not None else g0))
    handle = layer.register_forward_pre_hook(hook)
    if not hasattr(layer, "_weight_norm_handles"):
        object.__setattr__(layer, "_weight_norm_handles", {})
    layer._weight_norm_handles[name] = (hook, handle)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one parameter and drop the hook."""
    hook, handle = layer._weight_norm_handles.pop(name)
    with torch.no_grad():
        w = hook.compute(layer)
    handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    delattr(layer, name)
    layer.add_parameter(name, Parameter(w))
    return layer


class _SpectralNormHook:
    """Divides ``name`` by its largest singular value before each
    forward, estimated by a power iteration whose ``u`` persists (started
    from ``RandomState(0)``); the iteration runs without gradient, and
    sigma is the contraction ``u^T W v`` of the weight itself, so the
    backward carries ``d sigma / dW = u v^T``."""

    def __init__(self, name, n_power_iterations, eps, dim):
        self.name = name
        self.n = max(1, int(n_power_iterations))
        self.eps = eps
        self.dim = dim
        self.u = None

    def compute(self, layer):
        w = getattr(layer, self.name + "_orig")
        h = w.shape[self.dim]
        with torch.no_grad():
            wm = torch.movedim(w, self.dim, 0).reshape(h, -1).float()
            if self.u is None:
                u0 = np.random.RandomState(0).randn(h)
                self.u = u0 / (np.linalg.norm(u0) + self.eps)
            u = torch.as_tensor(self.u, dtype=torch.float32,
                                device=w.device)
            for _ in range(self.n):
                v = wm.T @ u
                v = v / (torch.linalg.norm(v) + self.eps)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + self.eps)
            self.u = u.cpu().numpy()
            rest = [s for i, s in enumerate(w.shape) if i != self.dim]
            uv = torch.movedim(torch.outer(u, v).reshape([h] + rest), 0,
                               self.dim).to(w.dtype)
        return w / torch.sum(w * uv)

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute(layer))


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """``layer.<name>`` becomes ``W / sigma_max(W)``, sigma refreshed by
    the power iteration every forward."""
    w = getattr(layer, name)
    hook = _SpectralNormHook(name, n_power_iterations, eps, dim)
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", Parameter(w.detach().clone()))
    handle = layer.register_forward_pre_hook(hook)
    if not hasattr(layer, "_spectral_norm_handles"):
        object.__setattr__(layer, "_spectral_norm_handles", {})
    layer._spectral_norm_handles[name] = (hook, handle)
    hook(layer, None)
    return layer
