"""``paddle.flops`` — the counterpart of ``paddle_tpu/hapi/dynamic_flops.py``
(reference: ``python/paddle/hapi/dynamic_flops.py``): per-layer FLOP
counting through forward post-hooks on the leaf layers over one forward
of zeros on the net's device.

Counting convention follows the reference: one multiply-add = 1 FLOP
(MACs), conv counts ``out_elems * (k*k*c_in/groups + bias)``, linear
``out_elems * in_features (+ bias)``, norms/activations elementwise.
``custom_ops`` maps a Layer CLASS to ``fn(layer, inputs, output) -> int``
for anything not in the table.
"""
from __future__ import annotations

import numpy as np


def _numel(t):
    return int(np.prod(t.shape)) if getattr(t, "shape", None) else 1


def _count_linear(layer, inputs, output):
    in_features = layer.weight.shape[0]
    bias = 1 if getattr(layer, "bias", None) is not None else 0
    return _numel(output) * (in_features + bias)


def _count_conv(layer, inputs, output):
    w = layer.weight  # [out_c, in_c/groups, *k]
    kernel_ops = int(np.prod(w.shape[1:]))
    bias = 1 if getattr(layer, "bias", None) is not None else 0
    return _numel(output) * (kernel_ops + bias)


def _count_conv_transpose(layer, inputs, output):
    # transpose-conv weights are [in_c, out_c/groups, *k]; every INPUT
    # element multiplies every kernel weight exactly once regardless of
    # stride, so MACs = in_elems * out_c/groups * prod(k)
    w = layer.weight
    bias = 1 if getattr(layer, "bias", None) is not None else 0
    return (_numel(inputs[0]) * int(np.prod(w.shape[1:]))
            + bias * _numel(output))


def _count_norm(layer, inputs, output):
    return 2 * _numel(inputs[0])


def _count_act(layer, inputs, output):
    return _numel(inputs[0])


def _count_pool(layer, inputs, output):
    return _numel(output)


def _count_zero(layer, inputs, output):
    return 0


def _default_table():
    from .. import nn
    table = {
        nn.Linear: _count_linear,
        nn.Conv1D: _count_conv, nn.Conv2D: _count_conv,
        nn.Conv3D: _count_conv,
        nn.BatchNorm1D: _count_norm, nn.BatchNorm2D: _count_norm,
        nn.BatchNorm3D: _count_norm, nn.BatchNorm: _count_norm,
        nn.LayerNorm: _count_norm, nn.GroupNorm: _count_norm,
        nn.ReLU: _count_act, nn.ReLU6: _count_act, nn.GELU: _count_act,
        nn.Sigmoid: _count_act, nn.Tanh: _count_act, nn.Silu: _count_act,
        nn.LeakyReLU: _count_act, nn.Hardswish: _count_act,
        nn.Hardsigmoid: _count_act, nn.Softmax: _count_act,
        nn.AvgPool1D: _count_pool, nn.AvgPool2D: _count_pool,
        nn.AvgPool3D: _count_pool, nn.MaxPool1D: _count_pool,
        nn.MaxPool2D: _count_pool, nn.MaxPool3D: _count_pool,
        nn.AdaptiveAvgPool1D: _count_pool, nn.AdaptiveAvgPool2D: _count_pool,
        nn.AdaptiveAvgPool3D: _count_pool,
        nn.Dropout: _count_zero, nn.Flatten: _count_zero,
        nn.Embedding: _count_zero,
    }
    for t in ("ConvTranspose1D", "Conv1DTranspose", "Conv2DTranspose",
              "Conv3DTranspose"):
        if hasattr(nn, t):
            table[getattr(nn, t)] = _count_conv_transpose
    return {k: v for k, v in table.items() if k is not None}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs (MACs) of one forward at ``input_size`` (list incl. batch).
    Unlisted leaf layers count 0 (composites are covered through their
    leaves)."""
    import torch

    table = _default_table()
    if custom_ops:
        table.update(custom_ops)
    counts = []
    handles = []

    def make_hook(layer):
        fn = None
        for cls in type(layer).__mro__:
            if cls in table:
                fn = table[cls]
                break
        if fn is None:
            return None

        def hook(lyr, inputs, output):
            out = output[0] if isinstance(output, (tuple, list)) else output
            counts.append((type(lyr).__name__, int(fn(lyr, inputs, out))))

        return hook

    for layer in net.sublayers(include_self=True):
        if list(layer.children()):
            continue  # count leaves only
        h = make_hook(layer)
        if h is not None:
            handles.append(layer.register_forward_post_hook(h))
    # per-layer training flags: a blanket net.train() after would flip
    # deliberately-frozen sublayers (e.g. an eval'd BatchNorm inside a
    # training net) back to train mode
    modes = [(l, l.training) for l in net.sublayers(include_self=True)]
    try:
        param = next(iter(net.parameters()), None)
        x = torch.zeros(tuple(input_size), dtype=torch.float32,
                        device=param.device if param is not None else None)
        net.eval()
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
        for layer, was in modes:
            layer.training = was
    total = sum(c for _, c in counts)
    if print_detail:
        for name, c in counts:
            print(f"{name:<24}{c:>16,}")
        print(f"{'Total Flops:':<24}{total:>16,}")
    return total
