"""AMP — the counterpart of ``paddle_tpu/amp/__init__.py``.

``auto_cast`` is the reference's O1 / O2 by op NAME, not
``torch.autocast``: every op of the port's surface goes through one
dispatch point (``ops/_op.py``), which casts the op's floating inputs
before it runs, by the same white and black lists the JAX package keeps
(its dispatch names, private ones included: ``_cross_entropy_impl``,
``_batch_norm_train`` …). O1 casts the white-list ops' inputs to the AMP
dtype and the black-list ops' to float32; O2 casts every other op's
inputs to the AMP dtype too. float64 inputs are never cast. So an op's
output type under AMP is the JAX package's, op by op (``torch.autocast``
keeps ``layer_norm`` in its input type and casts ``addmm``: other types
and other bits).

``decorate(level="O2")`` casts a model's floating parameters to the AMP
dtype; the optimizers keep float32 master weights for them.
``GradScaler`` is the reference's dynamic loss scaling. Like the
reference it does not look at the AMP dtype: with ``enable=False`` every
method passes through.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core import dtype as dtype_mod

# Ops that benefit from low precision — the reference's white list
WHITE_LIST = {
    "matmul", "mm", "bmm", "einsum", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "linear", "addmm",
}
# Numerically sensitive ops stay fp32 — the reference's black list
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "_cross_entropy_impl", "layer_norm",
    "rms_norm", "batch_norm", "_batch_norm_train", "_batch_norm_eval",
    "group_norm", "mean", "sum", "norm", "cumsum", "erf", "erfinv", "pow",
    "rsqrt", "sqrt", "square", "std", "var", "nll_loss", "mse_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_STATE = _AmpState()


def amp_state():
    return _STATE


def amp_target(op_name):
    """The dtype op ``op_name``'s floating inputs are cast to under the
    current AMP state, or None (no cast)."""
    st = _STATE
    if not st.enabled:
        return None
    if op_name in BLACK_LIST or op_name in st.custom_black:
        return torch.float32
    if op_name in WHITE_LIST or op_name in st.custom_white \
            or st.level == "O2":
        return st.dtype
    return None


def _cast_tree(obj, target):
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point() and obj.dtype != target \
                and obj.dtype != torch.float64:
            return obj.to(target)
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast_tree(v, target) for v in obj)
    if isinstance(obj, dict):
        return {k: _cast_tree(v, target) for k, v in obj.items()}
    return obj


def amp_cast_inputs(op_name, args, kwargs):
    """``(args, kwargs)`` with their floating tensors cast for op
    ``op_name`` (unchanged when AMP is off or the op takes no cast)."""
    target = amp_target(op_name)
    if target is None:
        return args, kwargs
    return _cast_tree(args, target), _cast_tree(kwargs, target)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    st = _STATE
    prev = (st.enabled, st.dtype, st.level, st.custom_white, st.custom_black)
    st.enabled = bool(enable)
    st.dtype = dtype_mod.to_torch_dtype(dtype)
    st.level = level
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of ``models`` to ``dtype`` in
    place (the parameter objects stay, so an optimizer built before keeps
    them); the optimizers keep float32 master copies (their slots)."""
    d = dtype_mod.to_torch_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for _, p in m.named_parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's ``GradScaler``).

    ``scale(loss)`` multiplies the loss; ``unscale_(opt)`` divides every
    gradient in float32 and notes whether any is not finite (one device
    sync); ``step(opt)`` updates from those float32 gradients unless one
    was not finite; ``update()`` moves the scale: halved (``decr_ratio``)
    after ``decr_every_n_nan_or_inf`` bad steps in a row, doubled
    (``incr_ratio``) after ``incr_every_n_steps`` good ones. A parameter
    of a low-precision type cannot hold a float32 ``.grad`` in torch, so
    the unscaled gradients go to the optimizer as a list (its
    ``_apply_params_grads``, what ``step()`` calls) rather than through
    ``.grad``."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = None
        #: steps skipped for a non-finite gradient since construction
        self.skipped_steps = 0

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads, bad = [], None
        for p in optimizer._parameter_list:
            if p.requires_grad and p.grad is not None:
                g = p.grad.float() * inv
                n = torch.sum(~torch.isfinite(g))
                bad = n if bad is None else bad + n
                grads.append((p, g))
        self._found_inf = bool(bad is not None and int(bad) > 0)
        self._unscaled = grads

    def step(self, optimizer):
        """Unscale (unless ``unscale_`` ran) and update unless a gradient
        was not finite. The scale moves in ``update()``."""
        if not self._enable:
            optimizer.step()
            return
        if self._unscaled is None:
            self.unscale_(optimizer)
        if self._found_inf:
            self.skipped_steps += 1
        else:
            optimizer._apply_params_grads(self._unscaled)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def update(self):
        if not (self._enable and self._dynamic):
            self._found_inf = False
            self._unscaled = None
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = None

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._incr_ratio = state.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = state.get("decr_ratio", self._decr_ratio)
        self._enable = state.get("enable", self._enable)
        self._incr_every = state.get("incr_every_n_steps", self._incr_every)
        self._decr_every = state.get("decr_every_n_nan_or_inf",
                                     self._decr_every)
        self._dynamic = state.get("use_dynamic_loss_scaling", self._dynamic)

    set_state_dict = load_state_dict


def is_bfloat16_supported(device=None):
    """True: torch computes bfloat16 on the CPU and on every CUDA card this
    port targets (sm_90)."""
    return True


def is_float16_supported(device=None):
    """True on both: torch computes float16 on the CPU and the card, and
    the flash kernels take it."""
    return True


__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "WHITE_LIST",
           "BLACK_LIST"]
