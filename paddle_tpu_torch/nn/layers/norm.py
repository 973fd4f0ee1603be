"""Normalization layers — the counterpart of
``paddle_tpu/nn/layers/norm.py``: the batch norms (running buffers
``_mean`` and ``_variance``, Paddle's ``momentum``: ``running = m *
running + (1 - m) * batch``, the biased variance), ``SyncBatchNorm`` (one
rank: the batch norm), ``LayerNorm``, ``RMSNorm``, ``GroupNorm``, the
instance norms, ``LocalResponseNorm`` and ``SpectralNorm`` (which raises,
as the reference's does)."""
from __future__ import annotations

import torch

from ...core import device as device_mod
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[num_features],
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None
        dev = device_mod.current_torch_device()
        self.register_buffer("_mean", torch.zeros(
            [num_features], dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            [num_features], dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


BatchNorm = _BatchNormBase


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm. On one rank it is the batch norm; the
    class exists for the API and ``convert_sync_batchnorm`` (across ranks:
    ROADMAP.md Queue A step 13)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon, data_format=layer.data_format)
            with torch.no_grad():
                if layer.weight is not None:
                    new.weight.copy_(layer.weight)
                if layer.bias is not None:
                    new.bias.copy_(layer.bias)
                new._mean.copy_(layer._mean)
                new._variance.copy_(layer._variance)
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=self.normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=self.normalized_shape,
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_channels], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[num_channels],
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(shape=[num_features],
                                              attr=bias_attr, is_bias=True)
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(InstanceNorm2D):
    """[N, C, L]: the functional normalizes over every trailing dim."""


class InstanceNorm3D(InstanceNorm2D):
    """[N, C, D, H, W] (the same reduction)."""


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """Raises, as the reference's class does (its spectral normalization
    is ``nn.utils.spectral_norm``)."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        raise NotImplementedError(
            "SpectralNorm: planned (low-priority parity item)")
