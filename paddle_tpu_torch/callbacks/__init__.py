"""``paddle.callbacks`` — the counterpart of ``paddle_tpu/callbacks``
(reference: ``python/paddle/callbacks/``): the callbacks
``paddle.Model.fit`` drives, on the host."""
from __future__ import annotations

import os
import time


def _resolve_mode(mode, monitor):
    """'auto' picks 'max' only for accuracy-like monitors (reference/keras
    convention: min unless 'acc' is in the name), so error/mae/bleu-style
    monitors default to 'min'."""
    if mode in ("min", "max"):
        return mode
    return "max" if "acc" in monitor else "min"


def _metric_value(logs, monitor):
    cur = (logs or {}).get(monitor)
    if cur is None:
        return None
    return float(cur[0] if isinstance(cur, (list, tuple)) else cur)


def _is_better(cur, best, mode, min_delta):
    if best is None:
        return True
    return (cur < best - min_delta) if mode == "min" \
        else (cur > best + min_delta)


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fanout(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return fanout
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                               f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"  step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                               f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"  epoch done in {dt:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoints"

    def on_epoch_end(self, epoch, logs=None):
        if self.model and epoch % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.model:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0
        self.mode = _resolve_mode(mode, monitor)

    def on_eval_end(self, logs=None):
        cur = _metric_value(logs, self.monitor)
        if cur is None:
            return
        better = _is_better(cur, self.best, self.mode, self.min_delta)
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Scalar logger writing ``scalars.jsonl`` under ``log_dir`` (one
    record a train batch), as the reference's does: the VisualDL package
    is not a dependency."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._step = 0

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def on_train_batch_end(self, step, logs=None):
        import json
        if self._f and logs:
            rec = {"step": self._step,
                   **{k: float(v) for k, v in logs.items()
                      if isinstance(v, (int, float))}}
            self._f.write(json.dumps(rec) + "\n")
        self._step += 1

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer LR by ``factor`` when the monitored metric
    plateaus for ``patience`` evals (reference: paddle.callbacks.
    ReduceLROnPlateau; plateau logic matches optimizer.lr.ReduceOnPlateau
    with threshold_mode='abs'). Skips with a warning when the optimizer is
    driven by an LRScheduler — the scheduler owns the LR then."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = float(min_lr)
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0
        self.mode = _resolve_mode(mode, monitor)

    def on_eval_end(self, logs=None):
        cur = _metric_value(logs, self.monitor)
        if cur is None:
            return
        # cooldown elapses on EVERY eval (improving ones included) and
        # swallows bad evals while active — matches
        # optimizer.lr.ReduceOnPlateau / keras semantics
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if _is_better(cur, self.best, self.mode, self.min_delta):
            self.best = cur
            self.wait = 0
            return
        # swallow the bad eval only while cooldown is STILL active after
        # the decrement (keras re-checks post-decrement: with counter==1
        # this same eval already counts toward patience)
        if self.cooldown_counter > 0:
            return
        self.wait += 1
        if self.wait < self.patience:
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        from ..optimizer.lr import LRScheduler as Sched
        if isinstance(getattr(opt, "_learning_rate", None), Sched):
            import warnings
            warnings.warn(
                "ReduceLROnPlateau skipped: the optimizer is driven by an "
                "LRScheduler which owns the learning rate")
            return
        new_lr = max(opt.get_lr() * self.factor, self.min_lr)
        if new_lr < opt.get_lr():
            opt.set_lr(new_lr)
            if self.verbose:
                print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
        self.wait = 0
        self.cooldown_counter = self.cooldown
