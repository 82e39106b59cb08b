"""Multiclass / multilabel classification eval metrics (a copy of
automl_tpu/eval/classification.py, numpy only).

The reference evaluates ImageNet21k (multi-hot labels) with AUC under the
precision-recall curve plus top-1 (efficientnetv2/main.py:231-287,
`tf.metrics.AUC(curve='PR')`). Here AUC-PR is computed exactly as
micro-averaged average precision (the step-interpolated area under the PR
curve over all (example, class) scores) instead of TF's 200-threshold
bucket approximation.
"""

from __future__ import annotations

import numpy as np


def average_precision_pr(scores: np.ndarray, labels: np.ndarray) -> float:
  """Micro AUC-PR / average precision.

  scores: [N, C] real-valued (logits or probabilities — only the order
  matters). labels: [N, C] multi-hot {0,1}. Returns AP in [0, 1].
  """
  s = np.asarray(scores, np.float64).ravel()
  y = np.asarray(labels).ravel() > 0.5
  n_pos = int(y.sum())
  if n_pos == 0:
    return 0.0
  order = np.argsort(-s, kind="stable")
  y = y[order]
  tp = np.cumsum(y)
  precision = tp / np.arange(1, y.size + 1)
  # step-wise area: sum of precision at each positive, / total positives
  return float((precision * y).sum() / n_pos)


def precision_at_1(scores: np.ndarray, labels: np.ndarray) -> float:
  """Fraction of examples whose top-scored class is in the label set."""
  scores = np.asarray(scores)
  labels = np.asarray(labels)
  top = np.argmax(scores, axis=-1)
  hit = labels[np.arange(len(top)), top] > 0.5
  return float(hit.mean()) if len(top) else 0.0


class MultiLabelEvaluator:
  """Streaming accumulator for multilabel eval batches."""

  def __init__(self):
    self._scores = []
    self._labels = []

  def add_batch(self, scores, labels):
    self._scores.append(np.asarray(scores, np.float32))
    self._labels.append(np.asarray(labels, np.int8))

  @property
  def num_examples(self) -> int:
    return sum(len(s) for s in self._scores)

  def result(self) -> dict:
    scores = np.concatenate(self._scores) if self._scores else np.zeros((0, 1))
    labels = np.concatenate(self._labels) if self._labels else np.zeros((0, 1))
    return {
        "auc_pr": average_precision_pr(scores, labels),
        "precision_at_1": precision_at_1(scores, labels),
        "samples": len(scores),
    }
