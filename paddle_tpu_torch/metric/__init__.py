"""``paddle.metric`` — the counterpart of ``paddle_tpu/metric`` (reference:
``python/paddle/metric/metrics.py``): ``Metric``, ``Accuracy`` (top-k),
``Precision``, ``Recall``, ``Auc`` (its threshold bins) and ``accuracy``.

As there, ``compute`` takes the model's tensors (any device) and
``update``/``accumulate`` keep their state on the host in numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """A tensor (any device or type) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pv = _np(pred)
        lv = _np(label)
        maxk = max(self.topk)
        order = np.argsort(-pv, axis=-1)[..., :maxk]
        if lv.ndim == order.ndim:
            lv = lv.squeeze(-1)
        correct = (order == lv[..., None])
        return correct

    def update(self, correct, *args):
        correct = np.asarray(correct)
        n = correct.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += float(correct[..., :k].sum())
            self.count[i] += n
        return self.total[0] / max(self.count[0], 1)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels)
        pred_pos = (p.round() if p.dtype.kind == "f" else p) == 1
        self.tp += int(((pred_pos) & (lab == 1)).sum())
        self.fp += int(((pred_pos) & (lab == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels)
        pred_pos = (p.round() if p.dtype.kind == "f" else p) == 1
        self.tp += int((pred_pos & (lab == 1)).sum())
        self.fn += int((~pred_pos & (lab == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


def _trapezoid(y, x):
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x)


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels).ravel()
        pos_prob = p[:, 1] if p.ndim == 2 else p
        bins = (pos_prob * self.num_thresholds).astype(int)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds, descending
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Top-``k`` accuracy of one batch as a float32 scalar tensor on
    ``input``'s device."""
    m = Accuracy(topk=(k,))
    c = m.compute(input, label)
    m.update(c)
    dev = input.device if isinstance(input, torch.Tensor) else None
    return torch.tensor(np.float32(m.accumulate()), device=dev)
