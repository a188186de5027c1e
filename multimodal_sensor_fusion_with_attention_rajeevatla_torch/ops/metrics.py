"""Classification and calibration metrics, port of the JAX package's ``ops/metrics.py``.

- ``cross_entropy_loss`` and ``weighted_accuracy`` are tensor functions that
  stay on the device (the training step calls them and never synchronises);
- ``accuracy``, ``macro_f1``, the calibration errors (equal-width bins with a
  right-closed final bin) and ``negative_log_likelihood`` return Python
  floats, computed with numpy from tensors or arrays.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def _np(x: ArrayLike) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(predictions: ArrayLike, labels: ArrayLike) -> float:
    return float(np.mean(_np(predictions) == _np(labels)))


def macro_f1(labels: ArrayLike, predictions: ArrayLike) -> float:
    """Macro-averaged F1 with sklearn's default label set (classes present in
    the labels or the predictions) and ``zero_division=0``."""
    y_true = _np(labels).astype(np.int64).ravel()
    y_pred = _np(predictions).astype(np.int64).ravel()
    classes = np.union1d(np.unique(y_true), np.unique(y_pred))
    if classes.size == 0:
        return 0.0
    f1s = []
    for cls in classes:
        tp = np.sum((y_pred == cls) & (y_true == cls))
        fp = np.sum((y_pred == cls) & (y_true != cls))
        fn = np.sum((y_pred != cls) & (y_true == cls))
        denom = 2 * tp + fp + fn
        f1s.append(0.0 if denom == 0 else 2.0 * tp / denom)
    return float(np.mean(f1s))


def _bin_stats(confidences, predictions, labels, num_bins: int):
    confidences = _np(confidences).astype(np.float64).ravel()
    predictions = _np(predictions).ravel()
    labels = _np(labels).ravel()
    # equal-width bins; the final bin is right-closed (conf == 1.0 included)
    bin_ids = np.clip(np.floor(confidences * num_bins).astype(np.int64), 0, num_bins - 1)
    correct = (predictions == labels).astype(np.float64)
    counts = np.bincount(bin_ids, minlength=num_bins).astype(np.float64)
    conf_sums = np.bincount(bin_ids, weights=confidences, minlength=num_bins)
    acc_sums = np.bincount(bin_ids, weights=correct, minlength=num_bins)
    nonzero = counts > 0
    avg_conf = np.zeros(num_bins)
    avg_acc = np.zeros(num_bins)
    avg_conf[nonzero] = conf_sums[nonzero] / counts[nonzero]
    avg_acc[nonzero] = acc_sums[nonzero] / counts[nonzero]
    return counts, avg_conf, avg_acc, nonzero


def expected_calibration_error(confidences, predictions, labels, num_bins: int = 15) -> float:
    counts, avg_conf, avg_acc, nonzero = _bin_stats(confidences, predictions, labels, num_bins)
    total = counts.sum()
    if total == 0:
        return 0.0
    return float(np.sum((counts[nonzero] / total) * np.abs(avg_acc[nonzero] - avg_conf[nonzero])))


def maximum_calibration_error(confidences, predictions, labels, num_bins: int = 15) -> float:
    counts, avg_conf, avg_acc, nonzero = _bin_stats(confidences, predictions, labels, num_bins)
    if not np.any(nonzero):
        return 0.0
    return float(np.max(np.abs(avg_acc[nonzero] - avg_conf[nonzero])))


def negative_log_likelihood(logits: ArrayLike, labels: ArrayLike) -> float:
    """Mean cross-entropy of raw logits against integer labels."""
    logits = torch.as_tensor(_np(logits), dtype=torch.float32)
    labels = torch.as_tensor(_np(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    return float(-logp.gather(-1, labels[:, None])[:, 0].mean())


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Label-smoothed cross-entropy with ``torch.nn.CrossEntropyLoss``
    semantics: ``-(1 - s) * logp_true - s * mean(logp)`` per row. With
    ``sample_weight`` (0 for padded rows) the mean is weighted and divided by
    ``max(sum(w), 1)``, so an all-zero weight vector gives a zero loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_logp = logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        loss = -(1.0 - label_smoothing) * true_logp - label_smoothing * logp.mean(dim=-1)
    else:
        loss = -true_logp
    if sample_weight is not None:
        weight = sample_weight.to(loss.dtype)
        return (loss * weight).sum() / weight.sum().clamp(min=1.0)
    return loss.mean()


def weighted_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, sample_weight: torch.Tensor
) -> torch.Tensor:
    """Share of rows whose argmax is the label, weighted as the loss is
    (the training step's accuracy, a tensor on the logits' device)."""
    weight = sample_weight.to(torch.float32)
    hits = (logits.argmax(dim=-1) == labels.long()).to(torch.float32)
    return (hits * weight).sum() / weight.sum().clamp(min=1.0)
