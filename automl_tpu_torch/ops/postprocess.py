"""Detection postprocessing on the device: merge levels -> top-k -> decode
-> NMS -> clip -> (optionally) scale back to source-image coordinates.

The counterpart of automl_tpu/ops/postprocess.py, batched over images
where JAX vmaps one image's NMS. The model's heads give NCHW per-level
outputs; the merge flattens them in NHWC's anchor order
(models/efficientdet.py::flatten_predictions). Per-class suppression uses
the class-offset translation inside one fixed-shape NMS (ops/nms.py).

The top-k keeps jax.lax.top_k's order: the larger value first, the lower
index first among equal values (a stable descending sort; torch.topk's
order among ties is unspecified and differs between devices). Scores
pass through the sigmoid in f32 after the top-k, which runs in the
model's compute dtype, as in JAX.
"""

from __future__ import annotations

import copy
import functools

import torch

from automl_tpu_torch.models.efficientdet import flatten_predictions
from automl_tpu_torch.ops import anchors as anchors_lib
from automl_tpu_torch.ops import nms as nms_lib

CLASS_OFFSET = 1  # outputs are 1-based classes

# The pre-NMS candidate cap of the per-anchor-max path when the config has
# no nms_configs.pre_nms_topk: the reference's MAX_DETECTION_POINTS. The
# NMS scans the whole candidate set every round.
PRE_NMS_CANDIDATES = 5000


def nms_params(config) -> dict:
  """Method-dependent NMS defaults, as JAX resolves them (its `or`
  defaults: a score_thresh of 0.0 becomes gaussian's and linear's 0.001)."""
  nc = config.nms_configs
  method = nc.get("method")
  if method in ("hard", None, ""):
    method = "hard"
    sigma = 0.0
    iou_thresh = nc.get("iou_thresh") or 0.5
    score_thresh = nc.get("score_thresh") or float("-inf")
  elif method == "gaussian":
    sigma = nc.get("sigma") or 0.5
    iou_thresh = 0.5
    score_thresh = nc.get("score_thresh") or 0.001
  elif method == "linear":
    sigma = 0.0
    iou_thresh = nc.get("iou_thresh") or 0.3
    score_thresh = nc.get("score_thresh") or 0.001
  elif method == "diou":
    sigma = 0.0
    iou_thresh = nc.get("iou_thresh") or 0.5
    score_thresh = nc.get("score_thresh") or float("-inf")
  else:
    raise ValueError(f"Invalid nms method {method!r}")
  return dict(method=method, sigma=float(sigma), iou_thresh=float(iou_thresh),
              score_thresh=float(score_thresh),
              max_output_size=int(nc.get("max_output_size") or 100))


def merge_class_box_level_outputs(config, cls_outputs, box_outputs):
  """Per-level [B, A*c, H, W] lists -> flat [B, A_total, num_classes] and
  [B, A_total, 4] in anchor order."""
  return (flatten_predictions(cls_outputs, config.num_classes),
          flatten_predictions(box_outputs, 4))


def _stable_topk(values, k: int):
  """(values, indices) of the k largest entries of each row of [B, N],
  largest first and, among equal values, the lower index first
  (jax.lax.top_k's order)."""
  values, indices = torch.sort(values, dim=1, descending=True, stable=True)
  return values[:, :k], indices[:, :k]


def topk_class_boxes(config, cls_outputs, box_outputs):
  """Pre-NMS candidates: (scores [B, k], boxes [B, k, 4], classes [B, k],
  anchor indices [B, k]).

  max_nms_inputs > 0: the top k of the flattened (anchor, class) scores, an
  anchor may give several classes. Otherwise each anchor's best class,
  capped to the top pre_nms_topk anchors."""
  batch = cls_outputs.shape[0]
  num_classes = config.num_classes
  max_nms_inputs = config.nms_configs.get("max_nms_inputs", 0)
  if max_nms_inputs > 0:
    flat = cls_outputs.reshape(batch, -1)
    k = min(max_nms_inputs, flat.shape[1])
    scores, idx = _stable_topk(flat, k)
    indices = idx // num_classes
    classes = idx % num_classes
    box_topk = box_outputs.gather(1, indices[..., None].expand(-1, -1, 4))
    return scores, box_topk, classes, indices
  classes = torch.argmax(cls_outputs, dim=-1)
  scores = cls_outputs.amax(dim=-1)
  num_anchors = cls_outputs.shape[1]
  pre_nms_topk = int(config.nms_configs.get("pre_nms_topk")
                     or PRE_NMS_CANDIDATES)
  k = min(pre_nms_topk, num_anchors)
  if k < num_anchors:
    scores, indices = _stable_topk(scores, k)
    classes = classes.gather(1, indices)
    box_outputs = box_outputs.gather(1, indices[..., None].expand(-1, -1, 4))
  else:
    indices = torch.arange(num_anchors, device=cls_outputs.device).expand(
        batch, num_anchors)
  return scores, box_outputs, classes, indices


@functools.lru_cache(maxsize=8)
def _anchor_boxes(min_level, max_level, num_scales, aspect_ratios,
                  anchor_scale, image_size, device):
  return anchors_lib.Anchors(min_level, max_level, num_scales, aspect_ratios,
                             anchor_scale, image_size, device=device).boxes


def _frozen(v):
  """A hashable copy of a config value (lists become tuples)."""
  return tuple(_frozen(x) for x in v) if isinstance(v, (list, tuple)) else v


def _eval_anchor_boxes(config, device):
  """The config's anchor boxes [A, 4] on `device`, built once per config
  and device."""
  return _anchor_boxes(config.min_level, config.max_level, config.num_scales,
                       _frozen(config.aspect_ratios),
                       _frozen(config.anchor_scale),
                       _frozen(config.image_size), torch.device(device))


def pre_nms(config, cls_outputs, box_outputs, topk: bool = True):
  """-> (boxes [B, N, 4] absolute, scores [B, N] sigmoid, classes [B, N])."""
  cls_flat, box_flat = merge_class_box_level_outputs(
      config, cls_outputs, box_outputs)
  anchors = _eval_anchor_boxes(config, cls_flat.device)
  if topk:
    cls_sel, box_sel, classes, indices = topk_class_boxes(
        config, cls_flat, box_flat)
    anchor_boxes = anchors[indices]
  else:
    cls_sel, box_sel = cls_flat.amax(dim=-1), box_flat
    classes = torch.argmax(cls_flat, dim=-1)
    anchor_boxes = anchors[None]
  boxes = anchors_lib.decode_box_outputs(box_sel.float(), anchor_boxes)
  scores = torch.sigmoid(cls_sel.float())
  return boxes, scores, classes


def _gather_outputs(boxes, classes, idx, out_scores, valid):
  nms_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
  nms_classes = (classes.gather(1, idx) + CLASS_OFFSET).float()
  return (nms_boxes.masked_fill(~valid[..., None], 0.0),
          out_scores.masked_fill(~valid, 0.0),
          nms_classes.masked_fill(~valid, 0.0), valid.int().sum(dim=1))


@functools.lru_cache(maxsize=8)
def _canvas_limits(h: int, w: int, device):
  return torch.tensor([h, w, h, w], dtype=torch.float32, device=device)


def clip_boxes(boxes, image_size):
  """Clips [..., 4] (ymin, xmin, ymax, xmax) boxes into the canvas."""
  hi = _canvas_limits(*anchors_lib.parse_image_size(image_size), boxes.device)
  return torch.minimum(torch.clamp(boxes, min=0.0), hi.to(boxes.dtype))


def _postprocess(config, cls_outputs, box_outputs, image_scales,
                 per_class: bool):
  boxes, scores, classes = pre_nms(config, cls_outputs, box_outputs)
  p = nms_params(config)
  args = (p["max_output_size"], p["iou_thresh"], p["sigma"],
          p["score_thresh"], p["method"])
  if per_class:
    idx, out_scores, valid = nms_lib.per_class_nms(boxes, scores, classes,
                                                   *args)
  else:
    idx, out_scores, valid = nms_lib.batched_nms(boxes, scores, *args)
  nms_boxes, nms_scores, nms_classes, valid_len = _gather_outputs(
      boxes, classes, idx, out_scores, valid)
  nms_boxes = clip_boxes(nms_boxes, config.image_size)
  if image_scales is not None:
    scales = torch.as_tensor(image_scales, dtype=torch.float32,
                             device=nms_boxes.device).reshape(-1, 1, 1)
    nms_boxes = nms_boxes * scales
  return nms_boxes, nms_scores, nms_classes, valid_len


def postprocess_global(config, cls_outputs, box_outputs, image_scales=None):
  """Class-agnostic NMS over each anchor's best class. Returns (boxes
  [B, K, 4], scores [B, K], classes [B, K] (1-based, f32), valid_len [B])."""
  return _postprocess(config, cls_outputs, box_outputs, image_scales, False)


def postprocess_per_class(config, cls_outputs, box_outputs, image_scales=None):
  """NMS within each class (one class per anchor, or (anchor, class) pairs
  when nms_configs.max_nms_inputs > 0); postprocess_global's contract."""
  return _postprocess(config, cls_outputs, box_outputs, image_scales, True)


def postprocess_combined(config, cls_outputs, box_outputs, image_scales=None):
  """Combined-NMS equivalent: per-class hard NMS."""
  cfg = copy.deepcopy(config)
  cfg.nms_configs.method = "hard"
  cfg.nms_configs.sigma = 0.0
  return postprocess_per_class(cfg, cls_outputs, box_outputs, image_scales)


def generate_detections(config, cls_outputs, box_outputs, image_scales,
                        image_ids, per_class: bool = True):
  """-> ([B, K, 7] rows [image_id, ymin, xmin, ymax, xmax, score, class],
  valid_len [B])."""
  fn = postprocess_per_class if per_class else postprocess_global
  boxes, scores, classes, valid_len = fn(
      config, cls_outputs, box_outputs, image_scales)
  batch, k = scores.shape
  img_ids = torch.as_tensor(image_ids, dtype=torch.float32,
                            device=scores.device).reshape(batch, 1, 1)
  dets = torch.cat([img_ids.expand(batch, k, 1), boxes, scores[..., None],
                    classes[..., None]], dim=-1)
  return dets, valid_len


def transform_detections(detections):
  """[id, ymin, xmin, ymax, xmax, score, class] -> [id, x, y, w, h, score,
  class] (the COCO box format)."""
  d = detections
  return torch.stack([d[..., 0], d[..., 2], d[..., 1], d[..., 4] - d[..., 2],
                      d[..., 3] - d[..., 1], d[..., 5], d[..., 6]], dim=-1)
