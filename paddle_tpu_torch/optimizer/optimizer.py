"""Optimizers — the counterpart of ``paddle_tpu/optimizer/optimizer.py``:
``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``RMSProp`` (centered or not), ``Adadelta``, ``Adamax`` and ``Lamb``
(``LBFGS`` is ``optimizer/lbfgs.py``), with the
Paddle surface: ``step()``, ``clear_grad()``, ``minimize``,
``get_lr``/``set_lr``, ``state_dict``/``set_state_dict``.

The update follows the reference step by step: the grad clip first; then,
for the coupled optimizers, a parameter's own regularizer
(``ParamAttr(regularizer=...)``) or else the optimizer's ``weight_decay``
(a float is ``L2Decay(float)``; ``L1Decay``/``L2Decay`` objects) added to
the gradient; the learning rate (a float, or an ``LRScheduler`` read each
step) times the parameter's ``optimize_attr["learning_rate"]``; the
moments in float32; a float32 master copy for every parameter that is not
float32 (as the reference keeps one whatever its ``multi_precision``
says); bias correction with the float step count; AdamW's decoupled decay
``master *= 1 - lr * coeff`` before the Adam update, skipped for the
parameters ``apply_decay_param_fun`` rejects. Where the reference builds
new arrays, the port updates the slots, the master and float32
parameters IN PLACE (same operations in the same order).

Parameter names: pass ``model.named_parameters()`` to name each parameter
by its attribute path (what ``apply_decay_param_fun`` and ``state_dict``
keys see: the LLaMA path); a bare parameter list names them as the
reference does — ``apply_decay_param_fun`` gets ``p.name or ""`` and the
state keys are ``p.name`` or ``param_<i>``. The reference's arguments that
change nothing there (``multi_precision``, ``lazy_mode``, ``name``,
AdamW's ``lr_ratio``, ``clear_grad``'s ``set_to_zero``) are accepted and
unused, as there. Each optimizer's slots carry the JAX package's names
(``moment``, ``mean_square``, ``avg_squared_grad``, ``inf_norm`` …), so a
``state_dict`` crosses with the same keys.
"""
from __future__ import annotations

import torch

from ..regularizer import L2Decay
from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (eager-style optimizer; pass "
                "model.parameters() or model.named_parameters())")
        if not isinstance(learning_rate, LRScheduler) and (
                isinstance(learning_rate, bool)
                or not isinstance(learning_rate, (int, float))):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._parameter_list, self._names = [], []
        self._decay_name = {}
        for i, item in enumerate(parameters):
            pname, p = item if isinstance(item, tuple) else (None, item)
            own = getattr(p, "name", None)
            self._parameter_list.append(p)
            self._names.append(pname or own or f"param_{i}")
            self._decay_name[id(p)] = pname if pname is not None \
                else (own or "")
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # one representation: a penalty-gradient callable (a bare float is
        # L2Decay(float)); _coeff is kept for AdamW's decoupled decay
        if weight_decay is None:
            self._wd_fn, self._coeff = None, 0.0
        elif callable(weight_decay):
            self._wd_fn = weight_decay
            self._coeff = float(getattr(weight_decay, "_coeff", 0.0))
        else:
            self._coeff = float(weight_decay)
            self._wd_fn = L2Decay(self._coeff) if self._coeff else None
        self._decoupled_wd = False
        self._slots = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr plumbing
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @staticmethod
    def _param_lr(p):
        attr = getattr(p, "optimize_attr", None)
        if attr:
            return float(attr.get("learning_rate", 1.0))
        return 1.0

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
            if not self._decoupled_wd:
                reg = getattr(p, "regularizer", None) or self._wd_fn
                if reg is not None:
                    g = g + reg(p)
            self._update(p, g, slots, lr * self._param_lr(p),
                         self._step_count, decay=self._decays(p))

    def _decays(self, p):
        return True

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # ------------------------------------------------------------ state dict
    def state_dict(self):
        out = {}
        for p, key in zip(self._parameter_list, self._names):
            for sname, sval in self._slots.get(id(p), {}).items():
                out[f"{key}.{sname}"] = sval
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for p, key in zip(self._parameter_list, self._names):
            slots = {sk[len(key) + 1:]: torch.as_tensor(sv).to(
                p.device, copy=True) for sk, sv in state.items()
                if sk.startswith(key + ".")}
            if slots:
                self._slots[id(p)] = slots


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, param, grad, slots, lr, step, decay=True):
        param.sub_(lr * grad.to(param.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, param):
        return {"velocity": torch.zeros_like(param, dtype=torch.float32)}

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        v = slots["velocity"].mul_(self._momentum).add_(g)
        delta = g + self._momentum * v if self._nesterov else v
        param.sub_(lr * delta.to(param.dtype))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
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
    update). ``weight_decay`` is a float or an ``L2Decay`` (an ``L1Decay``
    raises, as in the reference: decoupled decay is L2).
    ``apply_decay_param_fun(name) -> bool`` picks the decayed parameters;
    the port honours it in ``step()`` and in ``jit.TrainStep`` alike."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if weight_decay is None:
            self._coeff = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._coeff = float(weight_decay)
        else:
            if not isinstance(weight_decay, L2Decay):
                raise TypeError(
                    f"AdamW's decoupled weight decay only supports a float "
                    f"or L2Decay, got {type(weight_decay).__name__}; use "
                    f"Adam(weight_decay=L1Decay(...)) for an L1 penalty")
            self._coeff = float(weight_decay._coeff)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, p):
        fun = self._apply_decay_param_fun
        return True if fun is None else bool(fun(self._decay_name[id(p)]))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, param):
        return {"moment": torch.full_like(param, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        acc = slots["moment"].add_(torch.square(g))
        param.sub_((lr * g / (torch.sqrt(acc) + self._epsilon))
                   .to(param.dtype))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slots(self, param):
        s = {"mean_square": torch.zeros_like(param, dtype=torch.float32),
             "momentum": torch.zeros_like(param, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(param, dtype=torch.float32)
        return s

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        rho = self._rho
        ms = slots["mean_square"]
        ms.copy_(rho * ms + (1 - rho) * torch.square(g))
        denom = ms
        if self._centered:
            mg = slots["mean_grad"]
            mg.copy_(rho * mg + (1 - rho) * g)
            denom = ms - torch.square(mg)
        mom = slots["momentum"]
        mom.copy_(self._momentum * mom
                  + lr * g / torch.sqrt(denom + self._epsilon))
        param.sub_(mom.to(param.dtype))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _init_slots(self, param):
        return {"avg_squared_grad": torch.zeros_like(param,
                                                     dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(param,
                                                       dtype=torch.float32)}

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        rho, eps = self._rho, self._epsilon
        asg, asu = slots["avg_squared_grad"], slots["avg_squared_update"]
        asg.copy_(rho * asg + (1 - rho) * torch.square(g))
        upd = g * torch.sqrt(asu + eps) / torch.sqrt(asg + eps)
        asu.copy_(rho * asu + (1 - rho) * torch.square(upd))
        param.sub_(lr * upd.to(param.dtype))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, param):
        return {"moment": torch.zeros_like(param, dtype=torch.float32),
                "inf_norm": torch.zeros_like(param, dtype=torch.float32)}

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        b1 = self._beta1
        m, u = slots["moment"], slots["inf_norm"]
        m.copy_(b1 * m + (1 - b1) * g)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(g)))
        param.sub_((lr / (1 - b1 ** float(step)))
                   * (m / (u + self._epsilon)).to(param.dtype))


class Lamb(Optimizer):
    """LAMB: the Adam direction plus ``lamb_weight_decay * param``, scaled
    by the trust ratio ``|param| / |direction|``;
    ``exclude_from_weight_decay_fn(param) -> bool`` drops the decay term
    for the parameters it names."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decays(self, p):
        return self._exclude_fn is None or not self._exclude_fn(p)

    def _init_slots(self, param):
        return {"moment1": torch.zeros_like(param, dtype=torch.float32),
                "moment2": torch.zeros_like(param, dtype=torch.float32)}

    def _update(self, param, grad, slots, lr, step, decay=True):
        g = grad.float()
        p32 = param.float()
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        t = float(step)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        wd = self._wd if decay else 0.0
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + wd * p32
        w_norm = torch.sqrt(torch.sum(torch.square(p32)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), dtype=w_norm.dtype,
                                       device=w_norm.device))
        param.copy_((p32 - lr * trust * r).to(param.dtype))
