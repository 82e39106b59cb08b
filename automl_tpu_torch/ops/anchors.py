"""Multiscale anchors, box encode / decode, and anchor labeling on the device.

The counterpart of automl_tpu/ops/anchors.py. Anchor boxes are generated
with numpy (the JAX code's own arithmetic) and held as a float32 tensor on
the model's device. Labeling runs on the device inside the train step,
batched over images: one IoU matrix [B, G, A], the thresholded argmax
match, then every valid ground-truth box claims its best anchor
(force-match), lowest box index first. Matched boxes and classes are
gathered (JAX multiplies by a one-hot matrix at HIGHEST precision: the same
values).
"""

from __future__ import annotations

import numpy as np
import torch

BOX_EPS = 1e-8


def parse_image_size(image_size) -> tuple[int, int]:
  """Int, 'WxH' string, or (h, w) -> (height, width)."""
  if isinstance(image_size, int):
    return (image_size, image_size)
  if isinstance(image_size, str):
    w, h = image_size.lower().split("x")
    return (int(h), int(w))
  if isinstance(image_size, (tuple, list)) and len(image_size) == 2:
    return tuple(int(v) for v in image_size)
  raise ValueError(f"Cannot parse image size {image_size!r}")


def get_feat_sizes(image_size, max_level: int) -> list[dict]:
  """Per-level (height, width): successive stride-2 halvings (ceil)."""
  h, w = parse_image_size(image_size)
  feat_sizes = [{"height": h, "width": w}]
  for _ in range(1, max_level + 1):
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    feat_sizes.append({"height": h, "width": w})
  return feat_sizes


class Anchors:
  """Multiscale anchor boxes, (ymin, xmin, ymax, xmax) in absolute pixels,
  in the order of flatten_predictions: per level, positions row-major,
  the anchor configuration (octave x aspect) fastest."""

  def __init__(self, min_level: int, max_level: int, num_scales: int,
               aspect_ratios, anchor_scale, image_size, device=None):
    self.min_level = min_level
    self.max_level = max_level
    self.num_scales = num_scales
    self.aspect_ratios = tuple(aspect_ratios)
    if isinstance(anchor_scale, (list, tuple)):
      if len(anchor_scale) != max_level - min_level + 1:
        raise ValueError("one anchor_scale per level expected")
      self.anchor_scales = list(anchor_scale)
    else:
      self.anchor_scales = [anchor_scale] * (max_level - min_level + 1)
    self.image_size = parse_image_size(image_size)
    self.feat_sizes = get_feat_sizes(image_size, max_level)
    self.boxes = torch.as_tensor(self._generate_boxes(), device=device)

  def _generate_boxes(self) -> np.ndarray:
    boxes_all = []
    for level in range(self.min_level, self.max_level + 1):
      feat = self.feat_sizes[level]
      stride_y = self.feat_sizes[0]["height"] / float(feat["height"])
      stride_x = self.feat_sizes[0]["width"] / float(feat["width"])
      anchor_scale = self.anchor_scales[level - self.min_level]
      boxes_level = []
      for octave in range(self.num_scales):
        for aspect in self.aspect_ratios:
          octave_scale = octave / float(self.num_scales)
          base_y = anchor_scale * stride_y * 2 ** octave_scale
          base_x = anchor_scale * stride_x * 2 ** octave_scale
          if isinstance(aspect, (list, tuple)):
            aspect_x, aspect_y = aspect
          else:
            aspect_x = np.sqrt(aspect)
            aspect_y = 1.0 / aspect_x
          half_y = base_y * aspect_y / 2.0
          half_x = base_x * aspect_x / 2.0
          x = np.arange(stride_x / 2, self.image_size[1], stride_x)
          y = np.arange(stride_y / 2, self.image_size[0], stride_y)
          xv, yv = np.meshgrid(x, y)
          xv, yv = xv.reshape(-1), yv.reshape(-1)
          boxes = np.stack(
              [yv - half_y, xv - half_x, yv + half_y, xv + half_x], axis=1)
          boxes_level.append(boxes[:, None, :])
      boxes_all.append(np.concatenate(boxes_level, axis=1).reshape(-1, 4))
    return np.vstack(boxes_all).astype(np.float32)

  def get_anchors_per_location(self) -> int:
    return self.num_scales * len(self.aspect_ratios)

  def counts_per_level(self) -> list[int]:
    a = self.get_anchors_per_location()
    return [self.feat_sizes[l]["height"] * self.feat_sizes[l]["width"] * a
            for l in range(self.min_level, self.max_level + 1)]


def decode_box_outputs(pred_boxes, anchor_boxes):
  """(ty, tx, th, tw) relative to anchors -> absolute (ymin, xmin, ymax,
  xmax)."""
  anchor_boxes = anchor_boxes.to(pred_boxes.dtype)
  ycenter_a = (anchor_boxes[..., 0] + anchor_boxes[..., 2]) / 2
  xcenter_a = (anchor_boxes[..., 1] + anchor_boxes[..., 3]) / 2
  ha = anchor_boxes[..., 2] - anchor_boxes[..., 0]
  wa = anchor_boxes[..., 3] - anchor_boxes[..., 1]
  ty, tx, th, tw = pred_boxes.unbind(-1)
  w = torch.exp(tw) * wa
  h = torch.exp(th) * ha
  ycenter = ty * ha + ycenter_a
  xcenter = tx * wa + xcenter_a
  return torch.stack([ycenter - h / 2, xcenter - w / 2,
                      ycenter + h / 2, xcenter + w / 2], dim=-1)


def decode_anchors_to_centersize(pred_boxes, anchor_boxes):
  """Anchors in center-size form (ycenter, xcenter, h, w), in pred_boxes'
  dtype (the TFLite custom-NMS contract)."""
  anchor_boxes = anchor_boxes.to(pred_boxes.dtype)
  ycenter_a = (anchor_boxes[..., 0] + anchor_boxes[..., 2]) / 2
  xcenter_a = (anchor_boxes[..., 1] + anchor_boxes[..., 3]) / 2
  ha = anchor_boxes[..., 2] - anchor_boxes[..., 0]
  wa = anchor_boxes[..., 3] - anchor_boxes[..., 1]
  return torch.stack([ycenter_a, xcenter_a, ha, wa], dim=-1)


def encode_boxes(gt_boxes, anchor_boxes):
  """Faster-RCNN encode: gt vs anchors -> (ty, tx, th, tw), no scale
  factors."""
  ycenter_a = (anchor_boxes[..., 0] + anchor_boxes[..., 2]) / 2
  xcenter_a = (anchor_boxes[..., 1] + anchor_boxes[..., 3]) / 2
  ha = anchor_boxes[..., 2] - anchor_boxes[..., 0] + BOX_EPS
  wa = anchor_boxes[..., 3] - anchor_boxes[..., 1] + BOX_EPS
  ycenter = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
  xcenter = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
  h = gt_boxes[..., 2] - gt_boxes[..., 0] + BOX_EPS
  w = gt_boxes[..., 3] - gt_boxes[..., 1] + BOX_EPS
  return torch.stack([(ycenter - ycenter_a) / ha,
                      (xcenter - xcenter_a) / wa,
                      torch.log(h / ha), torch.log(w / wa)], dim=-1)


def pairwise_iou(boxes_a, boxes_b):
  """IoU [..., A, B] of (ymin, xmin, ymax, xmax) boxes [..., A, 4] and
  [..., B, 4]."""
  a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
  ymin = torch.maximum(a[..., 0], b[..., 0])
  xmin = torch.maximum(a[..., 1], b[..., 1])
  ymax = torch.minimum(a[..., 2], b[..., 2])
  xmax = torch.minimum(a[..., 3], b[..., 3])
  inter = torch.clamp(ymax - ymin, min=0) * torch.clamp(xmax - xmin, min=0)
  area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
  area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
  union = area_a + area_b - inter
  return torch.where(union > 0, inter / union, torch.zeros_like(union))


def label_anchors(anchor_boxes, gt_boxes, gt_classes,
                  match_threshold: float = 0.5):
  """Labels every anchor of a batch (automl_tpu/ops/anchors.py:153-193,
  batched).

  anchor_boxes [A, 4]; gt_boxes [B, G, 4]; gt_classes [B, G], padding rows
  with class <= 0. Returns cls_targets [B, A] int32 (class - 1, -1 for
  background), box_targets [B, A, 4] f32 (0 for negatives), num_positives
  [B] f32."""
  b, g = gt_classes.shape
  n_anchors = anchor_boxes.shape[0]
  gt_boxes = gt_boxes.float()
  valid = gt_classes > 0                                     # [B, G]
  iou = pairwise_iou(gt_boxes, anchor_boxes)                 # [B, G, A]
  iou = torch.where(valid[..., None], iou, torch.full_like(iou, -1.0))
  best_iou, best_gt = iou.max(dim=1)                         # [B, A]
  matches = torch.where(best_iou >= match_threshold, best_gt,
                        torch.full_like(best_gt, -1))
  # Force-match: each valid box claims its best anchor; where several claim
  # one anchor, the lowest box index wins (JAX: argmax of a one-hot).
  force_anchor = iou.argmax(dim=2)                           # [B, G]
  force_anchor = torch.where(valid, force_anchor,
                             torch.full_like(force_anchor, n_anchors))
  force_gt = torch.full((b, n_anchors + 1), g, dtype=torch.long,
                        device=iou.device)
  force_gt.scatter_reduce_(1, force_anchor, torch.arange(
      g, device=iou.device).expand(b, g), reduce="amin")
  force_gt = force_gt[:, :n_anchors]
  forced = force_gt < g
  matches = torch.where(forced, force_gt, matches)
  positive = matches >= 0
  idx = torch.clamp(matches, min=0)
  matched_boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(b, -1, 4))
  matched_classes = torch.gather(gt_classes.long(), 1, idx)
  box_targets = encode_boxes(matched_boxes, anchor_boxes)
  box_targets = torch.where(positive[..., None], box_targets,
                            torch.zeros_like(box_targets))
  cls_targets = torch.where(positive, matched_classes - 1,
                            torch.full_like(matched_classes, -1))
  return (cls_targets.to(torch.int32), box_targets,
          positive.float().sum(dim=1))


class AnchorLabeler:
  """Batched on-device anchor labeler:
  label_anchors(gt_boxes [B, G, 4], gt_classes [B, G]) ->
  cls_targets [B, A] int32, box_targets [B, A, 4] f32, num_positives [B]."""

  def __init__(self, anchors: Anchors, match_threshold: float = 0.5):
    self.anchors = anchors
    self.match_threshold = match_threshold

  def label_anchors(self, gt_boxes, gt_classes):
    return label_anchors(self.anchors.boxes.to(gt_boxes.device), gt_boxes,
                         gt_classes, self.match_threshold)
