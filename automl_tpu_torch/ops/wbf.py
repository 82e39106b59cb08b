"""Weighted box fusion for ensembling detections across models: the
counterpart of automl_tpu/ops/wbf.py, host numpy as there.

Algorithm parity: efficientdet/tf2/wbf.py:20-95 (greedy per-class clustering at
IoU > 0.55, score-weighted box average, confidence scaled by cluster size /
num_models). Host-side eval tooling; detections are [N, 7] rows
[image_id, xmin, ymin, xmax, ymax, score, class] (the reference's column
order for wbf input).
"""

from __future__ import annotations

import numpy as np

IOU_THRESH = 0.55


def _iou(cluster_boxes: np.ndarray, box: np.ndarray) -> np.ndarray:
  x11, y11, x12, y12 = cluster_boxes.T
  x21, y21, x22, y22 = box
  xa, ya = np.maximum(x11, x21), np.maximum(y11, y21)
  xb, yb = np.minimum(x12, x22), np.minimum(y12, y22)
  inter = np.maximum(xb - xa, 0) * np.maximum(yb - ya, 0)
  a1 = (x12 - x11) * (y12 - y11)
  a2 = (x22 - x21) * (y22 - y21)
  return inter / np.maximum(a1 + a2 - inter, 1e-10)


def _average(cluster: list[np.ndarray], num_models: int) -> np.ndarray:
  d = np.stack(cluster)
  w = d[:, 5]
  avg = np.array([
      d[0, 0],
      np.sum(d[:, 1] * w) / np.sum(w),
      np.sum(d[:, 2] * w) / np.sum(w),
      np.sum(d[:, 3] * w) / np.sum(w),
      np.sum(d[:, 4] * w) / np.sum(w),
      np.mean(d[:, 5]) * min(1.0, len(cluster) / num_models),
      d[0, 6],
  ])
  return avg


def ensemble_detections(detections, num_models: int,
                        num_classes: int | None = None) -> np.ndarray:
  """Fuse [N, 7] detections from `num_models` models -> clustered [M, 7]."""
  detections = np.asarray(detections, np.float64)
  classes = (range(int(num_classes)) if num_classes
             else np.unique(detections[:, 6]).astype(int))
  all_clusters = []
  for cid in classes:
    class_dets = detections[detections[:, 6] == cid]
    clusters: list[list[np.ndarray]] = []
    averages: list[np.ndarray] = []
    for det in class_dets:
      idx = -1
      if averages:
        ious = _iou(np.stack(averages)[:, 1:5], det[1:5])
        if ious.max() >= IOU_THRESH:
          idx = int(np.argmax(ious))
      if idx == -1:
        clusters.append([det])
        averages.append(_average([det], num_models))
      else:
        clusters[idx].append(det)
        averages[idx] = _average(clusters[idx], num_models)
    all_clusters.extend(averages)
  if not all_clusters:
    return np.zeros((0, 7))
  out = np.stack(all_clusters)
  return out[np.argsort(-out[:, 5])]
