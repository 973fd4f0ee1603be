"""``paddle.summary`` — the counterpart of ``paddle_tpu/hapi/summary.py``
(reference: ``python/paddle/hapi/model_summary.py``): the parameter table
and the ``total_params`` / ``trainable_params`` counts, a parameter
trainable unless its ``stop_gradient`` is set."""
from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None):
    total = 0
    trainable = 0
    rows = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not getattr(p, "stop_gradient", not p.requires_grad):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    print(f"{'Param':<{width}}{'Shape':<24}{'Count':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
