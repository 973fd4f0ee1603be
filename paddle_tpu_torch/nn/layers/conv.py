"""Conv layers — the counterpart of ``paddle_tpu/nn/layers/conv.py``
(reference: ``python/paddle/nn/layer/conv.py``): Paddle's ``[out, in /
groups, *k]`` weight (``[in, out / groups, *k]`` for the transposes) from
``KaimingUniform(fan_in)`` and a ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))``
bias, drawn by the port's key walk as the JAX package draws them."""
from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from ..functional import _pair
from ..layer import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding,
                 dilation, groups, weight_attr, bias_attr, data_format, ndim):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, ndim)
        self.stride = _pair(stride, ndim)
        self.padding = padding
        self.dilation = _pair(dilation, ndim)
        self.groups = groups
        self.data_format = data_format
        fan_in = in_channels // groups * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, *self.kernel_size],
            attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        if bias_attr is not False:
            bound = 1.0 / np.sqrt(fan_in)
            self.bias = self.create_parameter(
                shape=[out_channels], attr=bias_attr, is_bias=True,
                default_initializer=I.Uniform(-bound, bound))
        else:
            self.bias = None

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.stride = _pair(stride)
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = _pair(dilation)
        self.groups = groups
        kernel_size = _pair(kernel_size)
        fan_in = in_channels // groups * int(np.prod(kernel_size))
        self.weight = self.create_parameter(
            shape=[in_channels, out_channels // groups, *kernel_size],
            attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[out_channels],
                                              attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, output_size)


class Conv1DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        k = _pair(kernel_size, 1)[0]
        fan_in = in_channels // groups * k
        self.weight = self.create_parameter(
            shape=[in_channels, out_channels // groups, k], attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(shape=[out_channels],
                                           attr=bias_attr, is_bias=True))

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, output_size)


class Conv3DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        ks = _pair(kernel_size, 3)
        fan_in = in_channels // groups * int(np.prod(ks))
        self.weight = self.create_parameter(
            shape=[in_channels, out_channels // groups, *ks], attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(shape=[out_channels],
                                           attr=bias_attr, is_bias=True))

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, output_size)
