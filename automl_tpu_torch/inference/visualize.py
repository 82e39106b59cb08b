"""Host-side drawing / image-summary utilities (PIL + matplotlib-Agg): the
counterpart of automl_tpu/inference/visualize.py, the same code.

Capability parity with efficientdet/visualize/vis_utils.py:
  visualize_boxes_and_labels_on_image_array (:763)  -> visualize_image
  draw_mask_on_image_array (:730)                   -> draw_mask
  draw_keypoints_on_image_array (:650)              -> draw_keypoints
  save_image_array_as_png / encode_..._as_png_str (:98-124)
  add_cdf_image_summary / add_hist_image_summary (:920-985) -> cdf_image/hist_image
  draw_side_by_side_evaluation_image (:506)         -> side_by_side_evaluation_image

All functions are pure numpy-in / numpy-out (uint8 [H,W,3]); TB/file writing
is the caller's job (train.metrics MetricsWriter or save_image_array_as_png).

One divergence: visualize_image draws a box thinner than its line (under
2 * line_thickness px) with as many inset rectangles as fit, where JAX's
raises PIL's ValueError (an inverted rectangle); other boxes are drawn
pixel for pixel as JAX draws them.
"""

from __future__ import annotations

import colorsys
import io

import numpy as np

from automl_tpu_torch.inference import label_util

_NUM_COLORS = 36


def _color(idx: int):
  h = (idx * 0.61803398875) % 1.0
  r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
  return int(r * 255), int(g * 255), int(b * 255)


def save_image_array_as_png(image, output_path: str) -> None:
  """Write a uint8 [H,W,3] array as PNG (ref: vis_utils.py:98)."""
  from PIL import Image
  Image.fromarray(np.asarray(image, np.uint8)).save(output_path, format="PNG")


def encode_image_as_png_bytes(image) -> bytes:
  """uint8 [H,W,3] -> PNG bytes (ref: vis_utils.py:110)."""
  from PIL import Image
  buf = io.BytesIO()
  Image.fromarray(np.asarray(image, np.uint8)).save(buf, format="PNG")
  return buf.getvalue()


def draw_mask(image, mask, color=None, alpha: float = 0.4):
  """Alpha-blend a binary [H,W] mask onto a uint8 image (vis_utils.py:730).

  Returns a new uint8 array; `color` defaults to red.
  """
  img = np.asarray(image, np.float32).copy()
  m = (np.asarray(mask) > 0.5).astype(np.float32)[..., None]
  color = np.asarray(color if color is not None else (255, 0, 0), np.float32)
  img = img * (1.0 - m * alpha) + color * (m * alpha)
  return np.clip(img, 0, 255).astype(np.uint8)


def draw_keypoints(image, keypoints, radius: int = 2, color=(255, 0, 0),
                   use_normalized_coordinates: bool = False):
  """Draw keypoints as filled circles (ref: vis_utils.py:650-728).

  keypoints: [K, 2] (y, x) pairs, absolute pixels unless
  use_normalized_coordinates. Returns a new uint8 array.
  """
  from PIL import Image, ImageDraw
  img = Image.fromarray(np.asarray(image, np.uint8))
  draw = ImageDraw.Draw(img)
  h, w = img.height, img.width
  for y, x in np.asarray(keypoints, np.float32).reshape(-1, 2):
    if use_normalized_coordinates:
      y, x = y * h, x * w
    draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                 fill=tuple(color), outline=tuple(color))
  return np.asarray(img)


def visualize_image(image, boxes, classes, scores, label_map=None,
                    min_score_thresh: float = 0.3, max_boxes_to_draw: int = 100,
                    line_thickness: int = 2, masks=None, keypoints=None,
                    skip_labels: bool = False):
  """Draw detections on a uint8 [H,W,3] image; returns a new uint8 array.

  boxes: [N, 4] absolute (ymin, xmin, ymax, xmax); classes: [N] int ids;
  scores: [N] in [0, 1]; masks: optional [N, H, W] binary instance masks;
  keypoints: optional [N, K, 2] per-detection (y, x) keypoints.
  (ref: vis_utils.py:763 visualize_boxes_and_labels_on_image_array)
  """
  from PIL import Image, ImageDraw

  label_map = label_util.get_label_map(label_map)
  image = np.asarray(image, np.uint8)
  order = np.argsort(-np.asarray(scores))

  # Masks first so boxes/labels stay crisp on top.
  if masks is not None:
    drawn = 0
    for i in order:
      if drawn >= max_boxes_to_draw:
        break
      if float(scores[i]) < min_score_thresh:
        continue
      image = draw_mask(image, masks[i], color=_color(int(classes[i]) %
                                                      _NUM_COLORS))
      drawn += 1

  img = Image.fromarray(image)
  draw = ImageDraw.Draw(img)
  drawn = 0
  for i in order:
    if drawn >= max_boxes_to_draw:
      break
    score = float(scores[i])
    if score < min_score_thresh:
      continue
    ymin, xmin, ymax, xmax = [float(v) for v in boxes[i]]
    cls = int(classes[i])
    color = _color(cls % _NUM_COLORS)
    for t in range(line_thickness):
      if xmax - t < xmin + t or ymax - t < ymin + t:
        break   # a box thinner than the line: PIL refuses the inset
      draw.rectangle([xmin + t, ymin + t, xmax - t, ymax - t], outline=color)
    if not skip_labels:
      name = label_map.get(cls, str(cls))
      text = f"{name}: {int(score * 100)}%"
      th = 11
      draw.rectangle([xmin, max(ymin - th - 2, 0), xmin + 7 * len(text),
                      max(ymin, th + 2)], fill=color)
      draw.text((xmin + 2, max(ymin - th - 1, 1)), text, fill="black")
    drawn += 1
  out = np.asarray(img)

  if keypoints is not None:
    drawn = 0
    for i in order:
      if drawn >= max_boxes_to_draw:
        break
      if float(scores[i]) < min_score_thresh:
        continue
      out = draw_keypoints(out, keypoints[i],
                           color=_color(int(classes[i]) % _NUM_COLORS))
      drawn += 1
  return out


def _figure_to_array(fig):
  import matplotlib
  matplotlib.use("Agg")
  fig.canvas.draw()
  w, h = fig.canvas.get_width_height()
  buf = np.frombuffer(fig.canvas.buffer_rgba(), np.uint8).reshape(h, w, 4)
  return buf[..., :3].copy()


def cdf_image(values, name: str = "cdf"):
  """Render the CDF of `values` to a uint8 image (ref: vis_utils.py:920-954)."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  values = np.sort(np.asarray(values, np.float32).ravel())
  n = values.size
  cum = np.cumsum(values)
  frac = np.arange(n, dtype=np.float32) / max(n, 1)
  fig, ax = plt.subplots(figsize=(4, 3), dpi=100)
  ax.plot(frac, cum / max(cum[-1], 1e-12) if n else cum)
  ax.set_title(name)
  ax.set_ylabel("cumulative normalized values")
  out = _figure_to_array(fig)
  plt.close(fig)
  return out


def hist_image(values, bins=50, name: str = "hist"):
  """Render a histogram of `values` to a uint8 image (vis_utils.py:956-985)."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  fig, ax = plt.subplots(figsize=(4, 3), dpi=100)
  ax.hist(np.asarray(values, np.float32).ravel(), bins=bins)
  ax.set_title(name)
  out = _figure_to_array(fig)
  plt.close(fig)
  return out


def side_by_side_evaluation_image(image, gt_boxes, gt_classes, det_boxes,
                                  det_classes, det_scores, label_map=None,
                                  min_score_thresh: float = 0.3):
  """[detections | ground truth] hstacked panel (ref: vis_utils.py:506-647).

  gt_boxes: [G, 4] absolute; gt_classes: [G] (0 rows = padding).
  Returns uint8 [H, 2W, 3].
  """
  gt_boxes = np.asarray(gt_boxes, np.float32)
  gt_classes = np.asarray(gt_classes)
  keep = gt_classes > 0
  gt_img = visualize_image(image, gt_boxes[keep], gt_classes[keep],
                           np.ones(int(keep.sum()), np.float32),
                           label_map=label_map, min_score_thresh=0.0)
  det_img = visualize_image(image, det_boxes, det_classes, det_scores,
                            label_map=label_map,
                            min_score_thresh=min_score_thresh)
  return np.concatenate([det_img, gt_img], axis=1)
