"""Fixed-shape NMS on the device: hard / gaussian / linear / diou, global
or per class, batched over images.

The counterpart of automl_tpu/ops/nms.py, whose single-image loop JAX
vmaps over the batch. Here the loop runs once over a [B, N] batch:
`max_output` rounds of argmax -> gather the chosen box -> its IoU row ->
update the live scores -> scatter NEG_INF at the chosen index. No round
reads a value back to the host, and every output has a fixed shape, so a
call on CUDA tensors never synchronises.

The update rules are JAX's (and so the reference's nms_np / TF
NonMaxSuppressionV5):
  hard      suppress where IoU > iou_thresh;
  gaussian  decay every overlap by exp(-iou^2 / sigma), remove nothing;
  linear    decay by (1 - iou) above iou_thresh with the +1-pixel IoU;
            a candidate that falls below score_thresh is removed for good;
  diou      suppress where iou - d^2 / (c^2 + 1e-10) > iou_thresh, the
            +1-pixel IoU, d the centre distance, c the enclosing diagonal.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)
METHODS = ("hard", "gaussian", "linear", "diou")


def _corners(box, boxes):
  """The intersection's (ymin, xmin, ymax, xmax) of box [B, 1, 4] with
  each of boxes [B, N, 4]."""
  return (torch.maximum(box[..., 0], boxes[..., 0]),
          torch.maximum(box[..., 1], boxes[..., 1]),
          torch.minimum(box[..., 2], boxes[..., 2]),
          torch.minimum(box[..., 3], boxes[..., 3]))


def _iou_one_to_many(box, boxes):
  ymin, xmin, ymax, xmax = _corners(box, boxes)
  inter = torch.clamp(ymax - ymin, min=0) * torch.clamp(xmax - xmin, min=0)
  area1 = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
  areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
  union = area1 + areas - inter
  return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _iou_plus_one(box, boxes):
  """IoU with nms_np's +1-pixel inclusive-coordinate areas."""
  ymin, xmin, ymax, xmax = _corners(box, boxes)
  inter = (torch.clamp(ymax - ymin + 1.0, min=0)
           * torch.clamp(xmax - xmin + 1.0, min=0))
  area1 = (box[..., 2] - box[..., 0] + 1.0) * (box[..., 3] - box[..., 1] + 1.0)
  areas = ((boxes[..., 2] - boxes[..., 0] + 1.0)
           * (boxes[..., 3] - boxes[..., 1] + 1.0))
  return inter / (area1 + areas - inter)


def batched_nms(boxes, scores, max_output: int, iou_thresh: float = 0.5,
                sigma: float = 0.0, score_thresh: float = float("-inf"),
                method: str | None = None):
  """NMS of each image of a batch.

  Args:
    boxes: [B, N, 4] (ymin, xmin, ymax, xmax); padding rows should carry
      score -inf (they are never selected).
    scores: [B, N].
    max_output: number of output slots.
    iou_thresh: suppression threshold (hard / linear / diou).
    sigma: gaussian soft-NMS sigma; > 0 decays by exp(-iou^2 / sigma).
    score_thresh: selections at or below it are invalid; linear also
      removes for good the candidates decayed strictly below it.
    method: 'hard' | 'gaussian' | 'linear' | 'diou'; None: gaussian where
      sigma > 0, else hard.

  Returns:
    (indices [B, max_output] int64, scores [B, max_output] f32, valid
    [B, max_output] bool); invalid slots have score NEG_INF.
  """
  if method is None:
    method = "gaussian" if sigma > 0 else "hard"
  if method not in METHODS:
    raise ValueError(f"Unknown NMS method: {method!r}")
  boxes = boxes.float()
  live = scores.float().clone()
  b = live.shape[0]
  if method == "diou":
    cy = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cx = (boxes[..., 1] + boxes[..., 3]) * 0.5
  out_idx, out_scores = [], []
  for _ in range(max_output):
    best = torch.argmax(live, dim=1, keepdim=True)             # [B, 1]
    out_idx.append(best)
    out_scores.append(live.gather(1, best))
    box = boxes.gather(1, best[..., None].expand(b, 1, 4))     # [B, 1, 4]
    if method == "gaussian":
      ious = _iou_one_to_many(box, boxes)
      live = live * torch.exp(-torch.square(ious) / sigma)
    elif method == "linear":
      ious = _iou_plus_one(box, boxes)
      decay = torch.where(ious > iou_thresh, 1.0 - ious,
                          torch.ones_like(ious))
      # guard: NEG_INF * 0 (a dead candidate, iou == 1) would be NaN
      live = torch.where(torch.isfinite(live), live * decay, live)
      live = live.masked_fill(live < score_thresh, NEG_INF)
    elif method == "diou":
      ious = _iou_plus_one(box, boxes)
      enc_h = (torch.maximum(box[..., 2], boxes[..., 2])
               - torch.minimum(box[..., 0], boxes[..., 0]))
      enc_w = (torch.maximum(box[..., 3], boxes[..., 3])
               - torch.minimum(box[..., 1], boxes[..., 1]))
      diag_sq = enc_h ** 2 + enc_w ** 2
      dist_sq = (cy - cy.gather(1, best)) ** 2 + (cx - cx.gather(1, best)) ** 2
      diou = ious - dist_sq / (diag_sq + 1e-10)
      live = live.masked_fill(diou > iou_thresh, NEG_INF)
    else:  # hard
      ious = _iou_one_to_many(box, boxes)
      live = live.masked_fill(ious > iou_thresh, NEG_INF)
    live = live.scatter(1, best, NEG_INF)
  idx, out = torch.cat(out_idx, dim=1), torch.cat(out_scores, dim=1)
  # Removed or exhausted candidates carry NEG_INF; guard score_thresh=-inf.
  valid = out > max(score_thresh, NEG_INF * 0.5)
  return idx, out.masked_fill(~valid, NEG_INF), valid


def nms(boxes, scores, max_output: int, iou_thresh: float = 0.5,
        sigma: float = 0.0, score_thresh: float = float("-inf"),
        method: str | None = None):
  """Single-image NMS: boxes [N, 4], scores [N] -> (indices
  [max_output], scores [max_output], valid [max_output]); batched_nms's
  contract otherwise."""
  out = batched_nms(boxes[None], scores[None], max_output, iou_thresh, sigma,
                    score_thresh, method)
  return tuple(t[0] for t in out)


def per_class_nms(boxes, scores, classes, max_output: int,
                  iou_thresh: float = 0.5, sigma: float = 0.0,
                  score_thresh: float = float("-inf"),
                  method: str | None = None):
  """NMS within each class, by translating each class's boxes into a band
  of its own: boxes [N, 4] or [B, N, 4], scores and classes [N] or [B, N].
  Returns nms() / batched_nms()'s contract for the same rank.

  Decoded boxes are unclipped and may have negative coordinates, so each
  image is rebased by its own minimum and its own span (JAX vmaps this
  per image; a minimum over the whole batch would change the sums)."""
  if boxes.dim() == 2:
    out = per_class_nms(boxes[None], scores[None], classes[None], max_output,
                        iou_thresh, sigma, score_thresh, method)
    return tuple(t[0] for t in out)
  boxes = boxes.float()
  lo = boxes.amin(dim=(1, 2))[:, None, None]
  span = torch.clamp(boxes.amax(dim=(1, 2))[:, None, None] - lo,
                     min=1.0) + 1.0
  offset = classes.float()[..., None] * span
  shifted = (boxes - lo) + offset
  return batched_nms(shifted, scores, max_output, iou_thresh, sigma,
                     score_thresh, method)
