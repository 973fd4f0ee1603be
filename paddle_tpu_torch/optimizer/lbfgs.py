"""L-BFGS — the counterpart of ``paddle_tpu/optimizer/lbfgs.py``: the
closure-driven quasi-Newton step with a bounded ``(s, y)`` history, the
two-loop recursion and the bracketing strong-Wolfe line search, ported as
the JAX package writes them (not ``torch.optim.LBFGS``), so the iterates
follow the reference's. The outer loop runs on the host (the closure is
evaluated a data-dependent number of times a step); the recursion works
on the parameters flattened into one float32 vector on their device.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _flatten(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


class LBFGS(Optimizer):
    """paddle.optimizer.LBFGS: ``step(closure)`` where the closure
    zeroes grads, recomputes the loss, calls backward, and returns the
    loss tensor."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        # honest contract: the L-BFGS update bypasses the base step path
        # that applies these — silently ignoring them would change
        # training behavior for users migrating from another optimizer
        if weight_decay not in (None, 0.0):
            raise ValueError("LBFGS does not support weight_decay (fold "
                             "the L2 term into the closure's loss)")
        if grad_clip is not None:
            raise ValueError("LBFGS does not support grad_clip (the line "
                             "search already bounds the step)")
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         name=name)
        self.max_iter = int(max_iter)
        self.max_eval = (int(max_eval) if max_eval is not None
                         else self.max_iter * 5 // 4)
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', got "
                f"{line_search_fn!r}")
        self.line_search_fn = line_search_fn
        self._s_hist = []  # parameter deltas
        self._y_hist = []  # gradient deltas
        self._rho = []
        self._prev_flat_grad = None
        self._n_evals = 0

    # ----------------------------------------------------------- plumbing
    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _gather(self, closure):
        with torch.enable_grad():
            loss = closure()
        self._n_evals += 1
        g = _flatten([p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in self._parameter_list])
        return float(loss.detach()), g.float()

    def _direction(self, grad):
        """Two-loop recursion over the (s, y) history."""
        q = -grad
        alphas = []
        for s, y, rho in zip(reversed(self._s_hist), reversed(self._y_hist),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._y_hist:
            y_last, s_last = self._y_hist[-1], self._s_hist[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-20)
            q = q * gamma
        for (s, y, rho), a in zip(
                zip(self._s_hist, self._y_hist, self._rho),
                reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _push_history(self, s, y):
        ys = float(torch.dot(y, s))
        if ys > 1e-10:  # curvature condition
            self._s_hist.append(s)
            self._y_hist.append(y)
            self._rho.append(1.0 / ys)
            if len(self._s_hist) > self.history_size:
                self._s_hist.pop(0)
                self._y_hist.pop(0)
                self._rho.pop(0)

    # --------------------------------------------------------- line search
    def _strong_wolfe(self, closure, x0, loss0, grad0, d, t,
                      c1=1e-4, c2=0.9, max_ls=25):
        """Bracketing strong-Wolfe search along d (reference
        ``_strong_wolfe``); returns (loss, grad, t)."""
        dg0 = float(torch.dot(grad0, d))

        def phi(step):
            self._set_flat_params(x0 + step * d)
            loss, g = self._gather(closure)
            return loss, g, float(torch.dot(g, d))

        def budget_left():
            return self._n_evals < self.max_eval

        t_prev, f_prev, g_prev, dg_prev = 0.0, loss0, grad0, dg0
        bracket = None
        f_new = g_new = None
        t_eval = t
        for _ in range(max_ls):
            f_new, g_new, dg_new = phi(t)
            t_eval = t  # the point params/loss/grad actually correspond to
            if f_new > loss0 + c1 * t * dg0 or f_new >= f_prev:
                bracket = (t_prev, f_prev, g_prev, dg_prev,
                           t, f_new, g_new, dg_new)
                break
            if abs(dg_new) <= -c2 * dg0:
                return f_new, g_new, t_eval
            if dg_new >= 0:
                bracket = (t, f_new, g_new, dg_new,
                           t_prev, f_prev, g_prev, dg_prev)
                break
            if not budget_left():
                return f_new, g_new, t_eval
            t_prev, f_prev, g_prev, dg_prev = t, f_new, g_new, dg_new
            t = 2.0 * t
        else:
            # bracketing exhausted: return the LAST EVALUATED point, never
            # an extrapolated step whose loss/grad were not computed
            return f_new, g_new, t_eval
        lo_t, lo_f, lo_g, lo_dg, hi_t, hi_f, hi_g, hi_dg = bracket
        for _ in range(max_ls):
            if not budget_left():
                break
            t = 0.5 * (lo_t + hi_t)
            f_new, g_new, dg_new = phi(t)
            t_eval = t
            if f_new > loss0 + c1 * t * dg0 or f_new >= lo_f:
                hi_t, hi_f, hi_g, hi_dg = t, f_new, g_new, dg_new
            else:
                if abs(dg_new) <= -c2 * dg0:
                    return f_new, g_new, t_eval
                if dg_new * (hi_t - lo_t) >= 0:
                    hi_t, hi_f, hi_g, hi_dg = lo_t, lo_f, lo_g, lo_dg
                lo_t, lo_f, lo_g, lo_dg = t, f_new, g_new, dg_new
            if abs(hi_t - lo_t) < self.tolerance_change:
                break
        return f_new, g_new, t_eval

    # --------------------------------------------------------------- step
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step needs a closure that recomputes "
                             "the loss and calls backward()")
        self._n_evals = 0
        loss, grad = self._gather(closure)
        if float(torch.max(torch.abs(grad))) <= self.tolerance_grad:
            return loss
        x = _flatten([p.detach() for p in self._parameter_list]).float()
        lr = self.get_lr()

        for it in range(self.max_iter):
            d = self._direction(grad)
            dg = float(torch.dot(grad, d))
            if dg > -1e-20:  # not a descent direction: reset history
                self._s_hist, self._y_hist, self._rho = [], [], []
                d = -grad
                dg = -float(torch.dot(grad, grad))
            t = (min(1.0, 1.0 / float(torch.sum(torch.abs(grad)))) * lr
                 if it == 0 and not self._s_hist else lr)
            if self.line_search_fn == "strong_wolfe":
                new_loss, new_grad, t = self._strong_wolfe(
                    closure, x, loss, grad, d, t)
                x_new = x + t * d
            else:
                x_new = x + t * d
                self._set_flat_params(x_new)
                new_loss, new_grad = self._gather(closure)
            self._push_history(x_new - x, new_grad - grad)
            delta = float(torch.max(torch.abs(x_new - x)))
            loss_change = abs(new_loss - loss)
            x, loss, grad = x_new, new_loss, new_grad
            self._set_flat_params(x)
            if float(torch.max(torch.abs(grad))) <= self.tolerance_grad:
                break
            if delta <= self.tolerance_change \
                    or loss_change <= self.tolerance_change:
                break
            if self._n_evals >= self.max_eval:
                break
        self._step_count += 1
        return loss
