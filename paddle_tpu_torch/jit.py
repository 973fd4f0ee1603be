"""``TrainStep`` — the counterpart of ``paddle_tpu/jit/__init__.py``'s
``TrainStep`` (``:164-393``) on one device, in eager PyTorch.

The JAX class compiles forward, loss, backward, clip and update into one
XLA program with donated buffers. Here the same sequence runs eagerly:
PyTorch's autograd takes the gradients (through the flash backward
kernels), the optimizer updates the parameters in place, and there is no
compile, mesh or donation. The options that place the step on a mesh
raise ``NotImplementedError`` (ROADMAP Queue A step 13). ``donate`` and
``loss_scale`` are taken and change nothing, as in the reference (which
stores ``loss_scale`` and never reads it; loss scaling is
``amp.GradScaler``'s). The model is any ``nn.Module``: the LLaMA model
or a ``nn.Layer``.

``FLAGS_check_nan_inf`` (read at construction) adds the reference's
debug guard: every step counts the non-finite values of the loss and the
gradients, applies the update, then raises if there were any.
"""
from __future__ import annotations

from typing import Callable

import torch

from .flags import get_flag


def _norm_batch(inputs):
    return inputs if isinstance(inputs, tuple) else (inputs,)


def _norm_labels(labels):
    labels = labels if isinstance(labels, tuple) else (labels,)
    return labels if len(labels) > 1 else labels[0]


def _micro(x, accum, i):
    """Rows ``i*B/accum .. (i+1)*B/accum`` of batch ``x`` — microbatch ``i``
    of the reference's ``reshape(accum, B // accum, ...)``."""
    x = torch.as_tensor(x)
    if x.shape[0] % accum:
        raise ValueError(f"batch {x.shape[0]} is not divisible by "
                         f"accum={accum}")
    return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]


class TrainStep:
    """``step(inputs, labels)``: forward -> loss -> backward -> grad clip
    -> optimizer update; returns the float32 loss.
    ``accum_step(inputs, labels, accum)``: ``accum`` microbatches, float32
    gradient sums divided by ``accum``, one update; returns the mean loss.
    ``eval_step(inputs, labels)``: the loss, no update.

    ``inputs`` is the model's positional arguments (a tuple, or one
    value); ``labels`` go to ``loss_fn(model_output, *labels)``.
    The reference's ``grad_accum_steps`` is never read there
    (``accum_step`` takes the count), so the port does not take it.
    """

    def __init__(self, model, loss_fn: Callable, optimizer, *, mesh=None,
                 batch_axes=None, sharding_stage: int = 0,
                 param_spec_fn=None, donate: bool = True, loss_scale=None):
        for knob, value, default, item in (
                ("mesh", mesh, None, "Queue A step 13"),
                ("batch_axes", batch_axes, None, "Queue A step 13"),
                ("sharding_stage", sharding_stage, 0, "Queue A step 13"),
                ("param_spec_fn", param_spec_fn, None, "Queue A step 13")):
            if value != default:
                raise NotImplementedError(
                    f"TrainStep({knob}=...) is not ported; see ROADMAP.md "
                    f"{item}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate = donate
        self.loss_scale = loss_scale
        self._step_count = 0
        self._check_nan = bool(get_flag("FLAGS_check_nan_inf"))

    def _params(self):
        return [p for p in self.optimizer._parameter_list if p.requires_grad]

    def _loss(self, inputs, labels):
        out = self.model(*inputs)
        loss = (self.loss_fn(out, *labels) if isinstance(labels, tuple)
                else self.loss_fn(out, labels))
        return loss.float()

    def _bad_count(self, loss, grads):
        if not self._check_nan:
            return 0
        bad = torch.sum(~torch.isfinite(loss))
        for g in grads:
            if g is not None and g.is_floating_point():
                bad = bad + torch.sum(~torch.isfinite(g))
        return int(bad)

    def _raise_on_nan(self, bad, loss):
        if bad > 0:
            raise RuntimeError(
                f"FLAGS_check_nan_inf: {bad} non-finite value(s) in "
                f"loss/gradients at step {self._step_count} "
                f"(loss={float(loss)})")

    def step(self, inputs, labels):
        inputs, labels = _norm_batch(inputs), _norm_labels(labels)
        self.optimizer.clear_grad()
        loss = self._loss(inputs, labels)
        loss.backward()
        bad = self._bad_count(loss, [p.grad for p in self._params()])
        self.optimizer.step()
        self.optimizer.clear_grad()
        self._step_count += 1
        loss = loss.detach()
        self._raise_on_nan(bad, loss)
        return loss

    def accum_step(self, inputs, labels, accum: int):
        """Gradient-accumulating step: ``accum`` microbatches, one update."""
        inputs, labels = _norm_batch(inputs), _norm_labels(labels)
        accum = int(accum)
        params = self._params()
        g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32)
        for i in range(accum):
            mb_in = tuple(_micro(x, accum, i) for x in inputs)
            mb_lab = (tuple(_micro(x, accum, i) for x in labels)
                      if isinstance(labels, tuple)
                      else _micro(labels, accum, i))
            self.optimizer.clear_grad()
            loss = self._loss(mb_in, mb_lab)
            loss.backward()
            with torch.no_grad():
                for acc, p in zip(g_sum, params):
                    if p.grad is not None:
                        acc.add_(p.grad.float())
            loss_sum = loss_sum.to(loss.device) + loss.detach()
        self.optimizer.clear_grad()
        grads = [g.div_(accum) for g in g_sum]
        mean_loss = loss_sum / accum
        bad = self._bad_count(loss_sum, grads)
        self.optimizer._apply_params_grads(list(zip(params, grads)))
        self._step_count += 1
        self._raise_on_nan(bad, mean_loss)
        return mean_loss

    @torch.no_grad()
    def eval_step(self, inputs, labels):
        return self._loss(_norm_batch(inputs), _norm_labels(labels))
