"""Synthetic data: classification (the data_dir='null' mode) and detection
(main_det --use_fake_data).

The counterpart of automl_tpu/data/pipeline.py::SyntheticClassification
and SyntheticDetection, the same numpy stream seed for seed: fixed-shape
uint8 NHWC canvases, one-hot labels or one to three boxes per image. The
TFRecord readers come with ROADMAP M9.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticClassification:
  """Yields the same batch forever: image uint8 [B, S, S, 3], label f32
  [B, num_classes] one-hot."""

  def __init__(self, batch_size: int, image_size: int, num_classes: int,
               seed: int = 0):
    rng = np.random.RandomState(seed)
    self.batch = {
        "image": rng.randint(0, 256, (batch_size, image_size, image_size, 3),
                             dtype=np.uint8),
        "label": np.eye(num_classes, dtype=np.float32)[
            rng.randint(0, num_classes, batch_size)],
    }

  def __iter__(self) -> Iterator[dict]:
    while True:
      yield self.batch


class SyntheticDetection:
  """Yields the same fixed-shape detection batch forever: image uint8
  [B, S, S, 3], true_hw f32 [B, 2], gt_boxes f32 [B, G, 4], gt_classes
  int32 [B, G] (-1 padding)."""

  def __init__(self, batch_size: int, image_size: int,
               max_instances: int = 100, num_classes: int = 90, seed: int = 0):
    rng = np.random.RandomState(seed)
    b, s, g = batch_size, image_size, max_instances
    boxes = np.zeros((b, g, 4), np.float32)
    classes = -np.ones((b, g), np.int32)
    for i in range(b):
      n = rng.randint(1, 4)
      y0 = rng.uniform(0, s * 0.6, n)
      x0 = rng.uniform(0, s * 0.6, n)
      hh = rng.uniform(s * 0.1, s * 0.4, n)
      ww = rng.uniform(s * 0.1, s * 0.4, n)
      boxes[i, :n] = np.stack([y0, x0, np.minimum(y0 + hh, s),
                               np.minimum(x0 + ww, s)], axis=1)
      classes[i, :n] = rng.randint(1, num_classes + 1, n)
    self.batch = {
        "image": rng.randint(0, 256, (b, s, s, 3), dtype=np.uint8),
        "true_hw": np.full((b, 2), s, np.float32),
        "gt_boxes": boxes,
        "gt_classes": classes,
    }

  def __iter__(self) -> Iterator[dict]:
    while True:
      yield self.batch
