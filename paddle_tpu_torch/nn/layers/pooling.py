"""Pooling layers — the counterpart of ``paddle_tpu/nn/layers/pooling.py``
(reference: ``python/paddle/nn/layer/pooling.py``), argument for argument
(as there, ``MaxPool2D`` and the 1-D and 3-D pools pass no
``data_format`` on)."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size,
                                     return_mask=self.return_mask)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        out = F.adaptive_avg_pool2d(x.unsqueeze(-1), (self.output_size, 1))
        return out.squeeze(-1)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size,
                                     return_mask=self.return_mask)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCL", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.random_u = random_u
        self.return_mask = return_mask

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.random_u = random_u
        self.return_mask = return_mask

    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)
