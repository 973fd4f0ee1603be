"""``nn.Layer`` — the counterpart of ``paddle_tpu/nn/layer.py``: a
``torch.nn.Module`` with Paddle's surface. ``nn.Module`` does the
bookkeeping (parameters, buffers, sublayers, hooks, ``train``/``eval``,
device and dtype moves); this class adds Paddle's names and semantics:

- ``create_parameter`` with the reference's initializer precedence (the
  attribute's initializer, then ``default_initializer``, then zeros for a
  bias or Xavier-uniform for a weight, unless ``set_global_initializer``
  replaced those) and the ``ParamAttr`` attributes (name, learning-rate
  scale, regularizer, trainability), on the current device;
- ``register_buffer(..., persistable=...)``, ``add_parameter``,
  ``add_sublayer``, ``sublayers``, ``apply`` (this layer first);
- ``state_dict`` in the JAX package's order — every parameter, then every
  persistable buffer — with its keys, and ``set_state_dict`` (also
  ``load_dict`` / ``set_dict``), which takes tensors or numpy arrays,
  checks shapes and returns ``(missing, unexpected)``;
- ``to(device, dtype)`` with Paddle's names (``"gpu:0"``, ``"bfloat16"``),
  ``astype``; ``register_forward_post_hook`` (torch's forward hook).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core.tensor import Parameter, from_numpy
from . import initializer as init_mod


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype_mod.to_torch_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # ------------------------------------------------------------ construction
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        dtype = dtype_mod.to_torch_dtype(dtype) or self._dtype
        if attr is not None and getattr(attr, "initializer", None) \
                is not None:
            initializer = attr.initializer
        elif default_initializer is not None:
            initializer = default_initializer
        elif is_bias:
            initializer = (init_mod._global_init["bias"]
                           or init_mod.Constant(0.0))
        else:
            initializer = (init_mod._global_init["weight"]
                           or init_mod.XavierUniform())
        value = initializer(list(shape), dtype,
                            device_mod.current_torch_device())
        p = Parameter(value)
        if attr is not None and getattr(attr, "name", None):
            p.name = attr.name
        lr = getattr(attr, "learning_rate", None) if attr is not None \
            else None
        if lr is not None:
            p.optimize_attr = {"learning_rate": lr}
        if attr is not None and getattr(attr, "trainable", True) is False:
            p.trainable = False
        if attr is not None and getattr(attr, "regularizer", None) \
                is not None:
            p.regularizer = attr.regularizer
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # ------------------------------------------------------------ iteration
    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix=prefix,
                                     recurse=include_sublayers,
                                     remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def apply(self, fn):
        """``fn`` on this layer, then on every sublayer (pre-order)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ------------------------------------------------------------ device/dtype
    def to(self, device=None, dtype=None, blocking=None):
        kw = {}
        if device is not None:
            kw["device"] = device_mod.Place(device).torch_device
        if dtype is not None:
            kw["dtype"] = dtype_mod.to_torch_dtype(dtype)
        return super().to(**kw) if kw else self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True):
        """Every parameter, then every persistable buffer, by attribute
        path (the tensors themselves)."""
        out = OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            out[name] = p
        for prefix, layer in self.named_modules() if include_sublayers \
                else [("", self)]:
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                key = f"{prefix}.{bname}" if prefix else bname
                if key not in out:
                    out[key] = b
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if not isinstance(src, torch.Tensor):
                src = from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: {tuple(src.shape)} vs "
                    f"{tuple(target.shape)}")
            target.copy_(src.to(device=target.device, dtype=target.dtype))
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ------------------------------------------------------------ hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; returns a handle with
        ``remove()``."""
        return self.register_forward_hook(hook)

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[int(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(int(idx)), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self._modules[str(i)] = sub
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
