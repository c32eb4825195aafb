"""Metrics (the port of ``paddle_tpu/metric``): ``Accuracy(topk)``,
``Precision``, ``Recall`` and ``Auc`` with the same ``compute`` /
``update`` / ``accumulate``.  ``compute`` runs on the tensors' device;
``update`` accumulates host numbers."""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def reset(self):
        ...

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        """Optional device-side pre-processing before ``update``."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy.  Labels are ``[N]``, ``[N, 1]`` or one-hot."""

    def __init__(self, topk=(1,), name="acc"):
        super().__init__(name)
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.reset()

    def compute(self, pred, label, *args):
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        k = max(self.topk)
        # descending argsort, ties broken as JAX's reversed stable sort
        top = torch.argsort(pred, dim=-1, stable=True).flip(-1)[..., :k]
        if label.dim() == pred.dim():
            if label.shape[-1] == pred.shape[-1]:
                label = label.argmax(dim=-1)          # one-hot
            else:
                label = label.squeeze(-1)             # [N, 1]
        return (top == label.unsqueeze(-1)).float()

    def update(self, correct):
        # flatten to [N, k] so rank > 2 inputs count every position
        c = _np(correct)
        c = c.reshape(-1, c.shape[-1]) if c.ndim > 1 else c.reshape(-1, 1)
        for i, k in enumerate(self.topk):
            self._correct[i] += float(c[:, :k].sum())
        self._count += c.shape[0]
        return self.accumulate()

    def accumulate(self):
        res = [c / self._count if self._count else 0.0
               for c in self._correct]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self._correct = [0.0] * len(self.topk)
        self._count = 0

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class _BinaryStat(Metric):
    def __init__(self, name):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fp = 0.0
        self.fn = 0.0

    def update(self, pred, label):
        p = (_np(pred).ravel() > 0.5).astype(np.float32)
        lab = _np(label).ravel().astype(np.float32)
        self.tp += float(((p == 1) & (lab == 1)).sum())
        self.fp += float(((p == 1) & (lab == 0)).sum())
        self.fn += float(((p == 0) & (lab == 1)).sum())
        return self.accumulate()


class Precision(_BinaryStat):
    def __init__(self, name="precision"):
        super().__init__(name)

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(_BinaryStat):
    def __init__(self, name="recall"):
        super().__init__(name)

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    """Bucketed streaming ROC AUC: predictions histogrammed into
    ``num_thresholds + 1`` buckets per class; ``preds`` are ``[N, 2]``
    probabilities (column 1 positive) or ``[N]`` scores in [0, 1]."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__(name)
        if curve != "ROC":
            raise ValueError(
                f"Auc: only the 'ROC' curve is implemented, got {curve!r}")
        self._nt = int(num_thresholds)
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._nt + 1, np.float64)
        self._stat_neg = np.zeros(self._nt + 1, np.float64)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1).astype(bool)
        score = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip((score * self._nt).astype(np.int64), 0, self._nt)
        self._stat_pos += np.bincount(bins[labels], minlength=self._nt + 1)
        self._stat_neg += np.bincount(bins[~labels], minlength=self._nt + 1)
        return self.accumulate()

    def accumulate(self):
        # thresholds from high to low: cumulative TP/FP per bucket edge,
        # then the trapezoid in (FP, TP) space
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0.0 or tot_neg == 0.0:
            return 0.0
        tp_prev = np.concatenate([[0.0], tp[:-1]])
        fp_prev = np.concatenate([[0.0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))
