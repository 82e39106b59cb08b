"""COCO detection metrics (AP/AR) in pure numpy, pycocotools semantics.

A copy of automl_tpu/eval/coco_metric.py (the port imports nothing of the
JAX package), so every result equals JAX's exactly: greedy score-ordered
matching per (image, class) at IoU thresholds .50:.05:.95, crowd regions
as ignore, area-range buckets, 101-point interpolated AP, and the
standard 12-metric summary; the COCO detection-results file with its
rounding and the test-dev file name. As in JAX, write_detections_json
given a `.json` path whose parent directory is missing raises
FileNotFoundError (it creates directories only for a directory path).

Host-side, eval-only code: detections arrive from the device NMS as
[image_id, ymin, xmin, ymax, xmax, score, class] rows
(ops/postprocess.generate_detections).
"""

from __future__ import annotations

import collections

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)  # 10 thresholds
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(dets, gts, iscrowd):
  """IoU [D, G]; for crowd gt, IoU = intersection / det area (pycocotools)."""
  if len(dets) == 0 or len(gts) == 0:
    return np.zeros((len(dets), len(gts)))
  ymin = np.maximum(dets[:, None, 0], gts[None, :, 0])
  xmin = np.maximum(dets[:, None, 1], gts[None, :, 1])
  ymax = np.minimum(dets[:, None, 2], gts[None, :, 2])
  xmax = np.minimum(dets[:, None, 3], gts[None, :, 3])
  inter = np.maximum(ymax - ymin, 0) * np.maximum(xmax - xmin, 0)
  area_d = ((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]))[:, None]
  area_g = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]))[None, :]
  union = np.where(iscrowd[None, :], area_d,
                   area_d + area_g - inter)
  return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class COCOEvaluator:
  """Accumulate (detections, groundtruth) per image; compute() -> 12 metrics.

  add(image_id, det_boxes [D,4] (ymin,xmin,ymax,xmax), det_scores [D],
      det_classes [D], gt_boxes [G,4], gt_classes [G], gt_is_crowd [G] opt)
  """

  def __init__(self, per_class: bool = False, label_map=None):
    self._dets = collections.defaultdict(list)   # (img, cls) -> [score, box]
    self._gts = collections.defaultdict(list)    # (img, cls) -> [box, crowd]
    self._images = set()
    self._classes = set()
    self.per_class = per_class
    self.label_map = label_map

  def add(self, image_id, det_boxes, det_scores, det_classes,
          gt_boxes, gt_classes, gt_is_crowd=None):
    image_id = int(image_id)
    self._images.add(image_id)
    det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
    det_scores = np.asarray(det_scores, np.float64).reshape(-1)
    det_classes = np.asarray(det_classes).reshape(-1).astype(int)
    for b, s, c in zip(det_boxes, det_scores, det_classes):
      if s > 0:
        self._dets[(image_id, c)].append((s, b))
        self._classes.add(c)
    gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
    gt_classes = np.asarray(gt_classes).reshape(-1).astype(int)
    if gt_is_crowd is None:
      gt_is_crowd = np.zeros(len(gt_classes), bool)
    gt_is_crowd = np.asarray(gt_is_crowd).reshape(-1).astype(bool)
    for b, c, cr in zip(gt_boxes, gt_classes, gt_is_crowd):
      if c > 0:
        self._gts[(image_id, c)].append((b, cr))
        self._classes.add(c)

  # -- evaluation --------------------------------------------------------
  #
  # pycocotools protocol, restructured for speed:
  #   * the IoU matrix is computed ONCE per (image, class) and shared by all
  #     four area ranges (pycocotools computeIoU / evaluateImg split);
  #   * the greedy matcher runs once per (image, class, area) — max-det
  #     variants are exact prefixes of the maxDet=100 match matrix, so
  #     accumulate() just slices [:, :max_det] (as pycocotools does);
  #   * the matcher is vectorized over the 10 IoU thresholds and the gt axis,
  #     leaving only the (score-ordered, inherently sequential) det loop in
  #     Python — and dets whose best IoU is below the lowest threshold (the
  #     vast majority of the top-100) skip the loop entirely.

  def _match_img_cls(self, img, cls):
    """-> (d_scores [D], {area: (dt_matched [T,D], dt_ignore [T,D], n_gt)})
    or None when the (image, class) pair has no dets and no gt."""
    dets = sorted(self._dets.get((img, cls), []),
                  key=lambda x: -x[0])[:MAX_DETS[-1]]
    gts = self._gts.get((img, cls), [])
    T = len(IOU_THRESHOLDS)
    if not dets and not gts:
      return None
    d_boxes = np.array([d[1] for d in dets]).reshape(-1, 4)
    d_scores = np.array([d[0] for d in dets])
    g_boxes = np.array([g[0] for g in gts]).reshape(-1, 4)
    g_crowd = np.array([g[1] for g in gts], bool).reshape(-1)
    g_area = ((g_boxes[:, 2] - g_boxes[:, 0])
              * (g_boxes[:, 3] - g_boxes[:, 1])) if len(gts) else np.zeros(0)
    d_area = ((d_boxes[:, 2] - d_boxes[:, 0])
              * (d_boxes[:, 3] - d_boxes[:, 1])) if len(dets) else np.zeros(0)
    D, G = len(dets), len(gts)

    per_area = {}
    ious = None
    # matching threshold per row: min(thr, 1 - 1e-10), as pycocotools
    thr_col = np.minimum(IOU_THRESHOLDS, 1 - 1e-10)[:, None]  # [T, 1]
    for area, area_rng in AREA_RANGES.items():
      g_ignore = g_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
      dt_m = -np.ones((T, D), np.int64)
      if G and D:
        if ious is None:
          ious = _iou_matrix(d_boxes, g_boxes, g_crowd)  # [D, G]
          max_iou = ious.max(axis=1)
        gt_matched = np.zeros((T, G), bool)
        # ignored gts always lose to any in-threshold non-ignored gt
        # (pycocotools' sorted-gt early break); crowd gts stay available.
        penalty = 2.0 * g_ignore
        min_thr = thr_col[0, 0]
        t_idx = np.arange(T)
        for di in range(D):
          if max_iou[di] < min_thr:
            continue  # cannot match at any threshold
          row = ious[di]                                   # [G]
          valid = (~gt_matched | g_crowd) & (row >= thr_col)  # [T, G]
          score = np.where(valid, row - penalty, -np.inf)
          # last-max to mirror pycocotools' tie behavior (equal IoU -> the
          # later gt index wins)
          best = (G - 1) - np.argmax(score[:, ::-1], axis=1)
          has = score[t_idx, best] > -np.inf
          dt_m[has, di] = best[has]
          gt_matched[t_idx[has], best[has]] = True
      matched = dt_m >= 0
      matched_ignored = np.zeros((T, D), bool)
      if D and G:
        matched_ignored[matched] = g_ignore[dt_m[matched]]
      d_oor = (d_area < area_rng[0]) | (d_area > area_rng[1])
      dt_ignore = matched_ignored | (~matched & d_oor[None, :])
      per_area[area] = (matched, dt_ignore, int(np.sum(~g_ignore)))
    return d_scores, per_area

  def _evaluated(self):
    """Cache of per-(img, cls) match results, built once per compute()."""
    if getattr(self, "_eval_cache", None) is None:
      self._eval_cache = {}
      for cls in sorted(self._classes):
        rows = []
        for img in sorted(self._images):
          r = self._match_img_cls(img, cls)
          if r is not None:
            rows.append(r)
        self._eval_cache[cls] = rows
    return self._eval_cache

  def _accumulate(self, area: str, max_det: int):
    """-> precision [T, R, K], recall [T, K] (K = all seen classes)."""
    T, R = len(IOU_THRESHOLDS), len(RECALL_POINTS)
    classes = sorted(self._classes)
    precision = -np.ones((T, R, len(classes)))
    recall = -np.ones((T, len(classes)))
    cache = self._evaluated()
    for ki, cls in enumerate(classes):
      rows = cache[cls]
      if not rows:
        continue
      # per-image maxDet slice BEFORE the global score sort (pycocotools)
      scores = np.concatenate([r[0][:max_det] for r in rows])
      order = np.argsort(-scores, kind="mergesort")
      matches = np.concatenate(
          [r[1][area][0][:, :max_det] for r in rows], axis=1)[:, order]
      ignored = np.concatenate(
          [r[1][area][1][:, :max_det] for r in rows], axis=1)[:, order]
      n_gt = sum(r[1][area][2] for r in rows)
      if n_gt == 0:
        continue
      keep = ~ignored
      tp = np.cumsum(matches & keep, axis=1).astype(np.float64)   # [T, N]
      fp = np.cumsum(~matches & keep, axis=1).astype(np.float64)
      rc = tp / n_gt
      pr = tp / np.maximum(tp + fp, 1e-10)
      recall[:, ki] = rc[:, -1] if rc.shape[1] else 0.0
      # precision envelope (monotone non-increasing from the right)
      pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
      n = rc.shape[1]
      if n == 0:
        precision[:, :, ki] = 0.0
        continue
      for ti in range(T):
        inds = np.searchsorted(rc[ti], RECALL_POINTS, side="left")
        valid = inds < n
        q = np.zeros(R)
        q[valid] = pr[ti][inds[valid]]
        precision[ti, :, ki] = q
    return precision, recall

  def compute(self) -> dict:
    """The standard 12 COCO metrics (+ per-class AP when enabled)."""
    self._eval_cache = None  # new detections may have arrived since last call
    p_all, r_all = self._accumulate("all", 100)

    def mean_valid(x):
      v = x[x > -1]
      return float(np.mean(v)) if v.size else -1.0

    metrics = {
        "AP": mean_valid(p_all),
        "AP50": mean_valid(p_all[0]),
        "AP75": mean_valid(p_all[5]),
        "ARmax100": mean_valid(r_all),
    }
    for area in ("small", "medium", "large"):
      p, r = self._accumulate(area, 100)
      metrics[f"AP{area[0]}"] = mean_valid(p)
      metrics[f"AR{area[0]}"] = mean_valid(r)
    for md in (1, 10):
      _, r = self._accumulate("all", md)
      metrics[f"ARmax{md}"] = mean_valid(r)
    if self.per_class:
      classes = sorted(self._classes)
      for ki, cls in enumerate(classes):
        name = (self.label_map or {}).get(cls, str(cls))
        metrics[f"AP_/{name}"] = mean_valid(p_all[:, :, ki])
    return metrics

  def add_batch_from_detections(self, detections, valid_len,
                                gt_boxes, gt_classes, gt_is_crowd=None):
    """Consume [B, K, 7] device detections + padded gt arrays."""
    detections = np.asarray(detections)
    valid_len = np.asarray(valid_len).astype(int)
    if gt_boxes is None:
      gt_boxes = np.zeros((detections.shape[0], 0, 4))
    if gt_classes is None:
      gt_classes = np.zeros((detections.shape[0], 0), int)
    gt_boxes = np.asarray(gt_boxes)
    gt_classes = np.asarray(gt_classes)
    for i in range(detections.shape[0]):
      n = valid_len[i]
      d = detections[i, :n]
      crowd = None if gt_is_crowd is None else gt_is_crowd[i]
      self.add(d[0, 0] if n else i, d[:, 1:5], d[:, 5], d[:, 6],
               gt_boxes[i], gt_classes[i], crowd)

  # -- COCO detection-results file / test-dev submission -------------------
  #
  # The reference's EvaluationMetric dumps accumulated detections to the
  # COCO-server result format — per detection
  # {image_id, category_id, bbox [x, y, w, h] @2dp, score @3dp} — under the
  # mandated file name detections_test-dev2017_*_results.json
  # (efficientdet/coco_metric.py:119-133; result rounding :125-127).

  TESTDEV_FILENAME = "detections_test-dev2017_test_results.json"

  def detection_results(self) -> list:
    """Accumulated detections in COCO detection-results (xywh) format."""
    rows = []
    for (img, cls), lst in self._dets.items():
      for s, b in lst:
        ymin, xmin, ymax, xmax = (float(v) for v in b)
        rows.append({
            "image_id": int(img),
            "category_id": int(cls),
            "bbox": [round(xmin, 2), round(ymin, 2),
                     round(xmax - xmin, 2), round(ymax - ymin, 2)],
            "score": round(float(s), 3),
        })
    rows.sort(key=lambda r: (r["image_id"], -r["score"], r["category_id"]))
    return rows

  def write_detections_json(self, path: str) -> str:
    """Write detection results; a directory path gets the reference's
    mandated test-dev file name (coco_metric.py:128-131). Returns the file."""
    import json
    import os
    if os.path.isdir(path) or not path.endswith(".json"):
      os.makedirs(path, exist_ok=True)
      path = os.path.join(path, self.TESTDEV_FILENAME)
    with open(path, "w") as f:
      json.dump(self.detection_results(), f)
    return path

  def add_detection_results(self, results) -> None:
    """Reload detection_results()-format rows (dump -> reload round trip)."""
    for r in results:
      x, y, w, h = r["bbox"]
      self._dets[(int(r["image_id"]), int(r["category_id"]))].append(
          (float(r["score"]), np.array([y, x, y + h, x + w], np.float64)))
      self._images.add(int(r["image_id"]))
      self._classes.add(int(r["category_id"]))
    self._eval_cache = None
