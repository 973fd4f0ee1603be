"""``paddle.Model`` — the counterpart of ``paddle_tpu/hapi/model.py``
(reference: ``python/paddle/hapi/model.py``), the Keras-like high-level
API.

``prepare`` builds a ``jit.TrainStep`` (eager here: the step updates the
network's own parameters, so there is no ``sync_to_model``);
``fit``/``evaluate``/``predict`` are host loops that feed it. As in the
reference, ``train_batch`` steps an ``LRScheduler`` learning rate after
every batch, and the ``callbacks.LRScheduler`` callback, when given,
steps it again. ``prepare(mesh=...)`` raises as ``TrainStep`` does
(ROADMAP.md Queue A step 13); ``save(training=False)`` is ``jit.save``'s
inference export, which the port does not have yet (step 14).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..callbacks import CallbackList, ProgBarLogger
from ..jit import TrainStep
from ..metric import Metric, _np


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None):
        """``amp_configs`` is taken and unused, as in the reference."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        if optimizer is not None and loss is not None:
            loss_fn = loss if callable(loss) else \
                (lambda out, lab: loss(out, lab))
            self._train_step = TrainStep(self.network, loss_fn, optimizer,
                                         mesh=mesh)
        return self

    # ------------------------------------------------------------------ steps
    def train_batch(self, inputs, labels=None, update=True):
        if self._train_step is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        loss = self._train_step.step(tuple(inputs), tuple(labels))
        from ..optimizer.lr import LRScheduler
        if isinstance(self._optimizer._learning_rate, LRScheduler):
            self._optimizer._learning_rate.step()
        return [float(loss)]

    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        loss = self._train_step.eval_step(tuple(inputs), tuple(labels))
        return [float(loss)]

    def predict_batch(self, inputs):
        from ..core.tensor import to_tensor
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with torch.no_grad():
            out = self.network(*[x if isinstance(x, torch.Tensor)
                                 else to_tensor(x) for x in inputs])
        self.network.train()
        return out

    # ------------------------------------------------------------------ loops
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader
        from ..io.dataset import Dataset
        if isinstance(train_data, Dataset):
            train_data = DataLoader(train_data, batch_size=batch_size,
                                    shuffle=shuffle, drop_last=drop_last,
                                    num_workers=num_workers)
        cbks = CallbackList([ProgBarLogger(log_freq, verbose)] +
                            (callbacks or []))
        cbks.set_model(self)
        cbks.set_params({"epochs": epochs, "verbose": verbose})
        cbks.on_train_begin()
        self.stop_training = False
        it_count = 0
        logs = None
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            self.network.train()
            logs = {}
            for step, batch in enumerate(train_data):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                losses = self.train_batch(inputs, labels)
                logs = {"loss": losses[0]}
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbks.on_eval_end(eval_logs)
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader
        from ..io.dataset import Dataset
        if isinstance(eval_data, Dataset):
            eval_data = DataLoader(eval_data, batch_size=batch_size,
                                   num_workers=num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in eval_data:
            inputs, labels = self._split_batch(batch)
            if self._train_step is not None:
                losses.append(self.eval_batch(inputs, labels)[0])
            out = self.predict_batch(inputs)
            for m in self._metrics:
                m.update(m.compute(out, labels[0] if isinstance(labels, list)
                                   else labels))
        self.network.train()
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, list):
                logs.update(dict(zip(name, acc)))
            else:
                logs[name] = acc
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader
        from ..io.dataset import Dataset
        if isinstance(test_data, Dataset):
            test_data = DataLoader(test_data, batch_size=batch_size,
                                   num_workers=num_workers)
        outputs = []
        for batch in test_data:
            inputs, _ = self._split_batch(batch, has_label=False)
            out = self.predict_batch(inputs)
            outputs.append(_np(out) if isinstance(out, torch.Tensor) else
                           [_np(o) for o in out])
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs)]
        return outputs

    def _split_batch(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if has_label and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    # ------------------------------------------------------------------ state
    def parameters(self):
        return self.network.parameters()

    def state_dict(self):
        return self.network.state_dict()

    def save(self, path, training=True):
        """training=True: checkpoint (``path.pdparams``: the network's
        parameters and buffers; ``path.pdopt``: the optimizer, its
        scheduler inside). training=False: the reference's inference
        export through ``jit.save``, not ported yet."""
        from ..framework import io as fio
        if not training:
            if self._inputs is None:
                raise ValueError(
                    "Model.save(training=False) exports an inference "
                    "program and needs the input spec: construct the "
                    "Model with inputs=[InputSpec(...)]")
            raise NotImplementedError(
                "Model.save(training=False) exports through jit.save, "
                "which is not ported; see ROADMAP.md Queue A step 14")
        fio.save(self.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import io as fio
        params_path = path if path.endswith(".pdparams") \
            else path + ".pdparams"
        self.network.set_state_dict(fio.load(params_path))
        opt_path = params_path[:-9] + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path))
        if self._train_step is not None and self._optimizer is not None \
                and self._loss is not None:
            self.prepare(self._optimizer, self._loss, self._metrics)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtype)
