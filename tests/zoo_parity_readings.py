"""Print the readings behind the vision zoo's CPU parity limits
(``test_torch_vision_models*.py``), one JSON line a case: each training
step's loss, worst gradient and worst BatchNorm buffer error against the
JAX package in float64 (the limits' cases), the float32 cases against the
reference's float64 step, feature mode, and the port's float32 step
against the reference's own float32 step for two BatchNorm networks (why
the float32 cases are held against float64).

Run from the repository root: ``python3 tests/zoo_parity_readings.py``
(about five minutes on one CPU thread).
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import test_torch_vision_models as base  # noqa: E402
import test_torch_vision_models_dense as dense  # noqa: E402
import test_torch_vision_models_inception as inception  # noqa: E402
import test_torch_vision_models_more as more  # noqa: E402


def emit(kind, fn, loss, grads, bufs, **kw):
    worst = max(grads, key=grads.get)
    print(json.dumps({"case": kind, "model": fn, **kw,
                      "loss_rel_err": float(loss),
                      "grad_err_over_max": float(grads[worst]),
                      "worst_gradient": worst,
                      "buffer_err": float(max(bufs.values(), default=0.0))}),
          flush=True)


def main():
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    for mod in (base, more, dense, inception):
        for case in mod.TRAIN:
            fn, kw, side = case[1:4]
            emit("float64", fn, *base.step_errors(
                fn, kw, side, 2, torch.float64, base.ZERO_GRAD), side=side)
        for fn, side in mod.FEATURES:
            print(json.dumps({"case": "features", "model": fn,
                              "err_over_max": float(base.feature_error(
                                  fn, {}, side))}), flush=True)
    for fn, side, n in (("LeNet", 28, 2), ("shufflenet_v2_x0_25", 64, 8)):
        emit("float32_vs_float64", fn, *base.step_errors(
            fn, {}, side, n, torch.float32, base.F32_ZERO_GRAD), side=side,
            batch=n)
    for fn, side, n in (("mobilenet_v1", 64, 2), ("mobilenet_v2", 64, 16)):
        emit("float32_vs_reference_float32", fn, *base.step_errors(
            fn, {}, side, n, torch.float32, base.F32_ZERO_GRAD, wide=False),
            side=side, batch=n)


if __name__ == "__main__":
    main()
