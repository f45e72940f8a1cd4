"""Evaluation metrics: counterpart of ``paddle_tpu/metric/``."""

from .metrics import Accuracy, Auc, Metric, Precision, Recall, accuracy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
