"""Optimizers — the counterpart of ``paddle_tpu/optimizer/optimizer.py``'s
``Optimizer`` (``:26-202``), ``Adam`` (``:236-270``) and ``AdamW``
(``:273-331``), with the Paddle surface: ``step()``, ``clear_grad()``,
``get_lr``/``set_lr``, ``state_dict``/``set_state_dict``.

The update follows the reference step by step: the grad clip first; the
moments in float32; a float32 master copy for every parameter that is not
float32 (as the reference keeps one whatever its ``multi_precision``
says, the port takes no such argument); bias correction with the
float step count; AdamW's decoupled decay ``master *= 1 - lr * coeff``
before the Adam update, skipped for the parameters whose name
``apply_decay_param_fun`` rejects. Where the reference builds new arrays,
the port updates the moments, the master and float32 parameters IN PLACE
(same operations in the same order), so the optimizer state takes no
second copy.

Parameter names: pass ``model.named_parameters()`` to name each parameter
by its attribute path (what ``apply_decay_param_fun`` and
``state_dict`` keys see); a bare parameter list names them ``param_<i>``.
The learning rate is a float: ``LRScheduler`` is not ported (ROADMAP
Queue A step 12). The reference's arguments that change nothing there
(``multi_precision``, ``name``, ``lazy_mode``, ``clear_grad``'s
``set_to_zero``) are not taken.
"""
from __future__ import annotations

import torch

_NOT_PORTED = "ROADMAP Queue A step 12"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (eager-style optimizer; pass "
                "model.parameters() or model.named_parameters())")
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate must be a float; {type(learning_rate)} "
                f"(an LRScheduler) is not ported — see {_NOT_PORTED}")
        self._parameter_list, self._names = [], []
        for i, item in enumerate(parameters):
            pname, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names.append(pname or f"param_{i}")
        self._name_of = {id(p): n for p, n in zip(self._parameter_list,
                                                  self._names)}
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        # a bare float is L2Decay(float) added to the gradient (coupled);
        # AdamW keeps its coefficient for the decoupled decay instead
        if weight_decay is None:
            self._coeff = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._coeff = float(weight_decay)
        else:
            raise NotImplementedError(
                f"weight_decay must be a float; regularizer objects are not "
                f"ported — see {_NOT_PORTED}")
        self._decoupled_wd = False
        self._slots = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr plumbing
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ------------------------------------------------------------ the update
    def _init_slots(self, param):
        return {}

    def _update(self, param, grad, slots, lr, step, decay=True):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """One update from each trainable parameter's ``.grad``."""
        self._apply_params_grads(
            [(p, p.grad) for p in self._parameter_list
             if p.requires_grad and p.grad is not None])

    @torch.no_grad()
    def _apply_params_grads(self, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        lr = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._slots[id(p)] = self._init_slots(p)
            if self._coeff and not self._decoupled_wd:
                g = g + self._coeff * p
            self._update(p, g, slots, lr, self._step_count,
                         decay=self._decays(self._name_of.get(id(p), "")))

    def _decays(self, name):
        return True

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    # ------------------------------------------------------------ state dict
    def state_dict(self):
        out = {}
        for p, key in zip(self._parameter_list, self._names):
            for sname, sval in self._slots.get(id(p), {}).items():
                out[f"{key}.{sname}"] = sval
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        for p, key in zip(self._parameter_list, self._names):
            slots = {sk[len(key) + 1:]: torch.as_tensor(sv).to(p.device)
                     for sk, sv in state.items()
                     if sk.startswith(key + ".")}
            if slots:
                self._slots[id(p)] = slots


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots(self, param):
        s = {"moment1": torch.zeros_like(param, dtype=torch.float32),
             "moment2": torch.zeros_like(param, dtype=torch.float32)}
        # a float32 master for every low-precision parameter
        if param.dtype != torch.float32:
            s["master"] = param.detach().float()
        return s

    def _adam_delta(self, grad, slots, step):
        """``mhat / (sqrt(vhat) + eps)``; updates the moments in place."""
        g = grad.float()
        b1, b2 = self._beta1, self._beta2
        m = slots["moment1"].mul_(b1).add_(g * (1 - b1))
        v = slots["moment2"].mul_(b2).add_(torch.square(g).mul_(1 - b2))
        t = float(step)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return mhat.div_(vhat.sqrt_().add_(self._epsilon))

    def _update(self, param, grad, slots, lr, step, decay=True):
        delta = self._adam_delta(grad, slots, step)
        master = slots.get("master", param)
        if self._decoupled_wd and decay and self._coeff:
            master.mul_(1.0 - lr * self._coeff)
        master.sub_(delta.mul_(lr))
        if master is not param:
            param.copy_(master)


class AdamW(Adam):
    """Decoupled weight decay (``master *= 1 - lr * coeff`` before the Adam
    update). ``apply_decay_param_fun(name) -> bool`` picks the decayed
    parameters by name; the port honours it in ``step()`` and in
    ``jit.TrainStep`` alike."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                f"AdamW lr_ratio is not ported — see {_NOT_PORTED}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name):
        fun = self._apply_decay_param_fun
        return True if fun is None else bool(fun(name))
