"""Metric base class and the standard classification metrics:
counterpart of ``paddle_tpu/metric/metrics.py``.

``Metric`` (the reset / update / accumulate / compute protocol),
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` (histogram
buckets over ``num_thresholds``; the JAX package computes the ROC area
for either ``curve``) and the functional ``accuracy``.  ``compute()``
runs in torch on the tensors' device (Accuracy's per-sample top-k hits),
``update()`` accumulates in host numpy between steps, as in the JAX
package.  Inputs are torch tensors or numpy.

Top-k order: the JAX package reverses an ascending stable ``argsort``, so
among equal scores the HIGHER index comes first; ``_topk`` does the same.
"""

from __future__ import annotations

import abc
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_torch(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x))


def _topk(p: torch.Tensor, k: int) -> torch.Tensor:
    """The JAX ``argsort(p)[..., ::-1][..., :k]``."""
    return torch.argsort(p, dim=-1, stable=True).flip(-1)[..., :k]


class Metric(metaclass=abc.ABCMeta):
    """Stateful streaming metric: reset() -> update()* -> accumulate()."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Preprocessing of (pred, label) on their device; identity by
        default.  Whatever it returns is passed to ``update``."""
        return args


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,), name=None,
                 *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._init_name(name)
        self.reset()

    def compute(self, pred, label, *args):
        """Per-sample hits of the top-maxk predictions ``[N, maxk]``
        float32, on the predictions' device."""
        p = _to_torch(pred)
        lab = _to_torch(label).to(p.device)
        idx = _topk(p, self.maxk)
        if lab.dim() == p.dim():  # one-hot / column labels
            lab = lab.argmax(-1) if lab.shape[-1] == p.shape[-1] \
                else lab.squeeze(-1)
        return (idx == lab[..., None]).float()

    def update(self, correct, *args):
        c = _to_np(correct)
        num = c.shape[0] if c.ndim else 1
        self.total_samples += num
        for i, k in enumerate(self.topk):
            self.correct_k[i] += float(c[..., :k].sum())
        res = [ck / max(self.total_samples, 1) for ck in self.correct_k]
        return res if len(self.topk) > 1 else res[0]

    def reset(self):
        self.total_samples = 0
        self.correct_k = [0.0 for _ in self.topk]

    def accumulate(self):
        res = [ck / max(self.total_samples, 1) for ck in self.correct_k]
        return res if len(res) > 1 else res[0]

    def _init_name(self, name):
        name = name or "acc"
        self._name = [f"{name}_top{k}" for k in self.topk] \
            if len(self.topk) > 1 else [name]

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision = tp / (tp + fp)."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_to_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _to_np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall = tp / (tp + fn)."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_to_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _to_np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via histogram buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        """preds: (N, 2) class probabilities or (N,) positive scores."""
        p = _to_np(preds)
        pos_prob = p[:, 1] if p.ndim == 2 else p.reshape(-1)
        l = _to_np(labels).reshape(-1).astype(np.int64)
        bucket = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                         0, self._num_thresholds)
        np.add.at(self._stat_pos, bucket, (l == 1).astype(np.int64))
        np.add.at(self._stat_neg, bucket, (l == 0).astype(np.int64))

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        # walk thresholds from high to low, accumulating TP/FP counts
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += self.trapezoid_area(tot_neg, new_neg, tot_pos, new_pos)
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy: the mean of the rows whose label is
    among the k best scores (a 0-d float32 tensor)."""
    p = _to_torch(input)
    lab = _to_torch(label).to(p.device)
    if lab.dim() == p.dim():
        lab = lab.squeeze(-1)
    hit = (_topk(p, k) == lab[..., None]).any(-1)
    return hit.float().mean()
