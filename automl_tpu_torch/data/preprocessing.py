"""Detection preprocessing on the device: training and eval.

The counterpart of automl_tpu/data/preprocessing.py::det_train_preprocess
(with _warp_to / augment.affine_warp and normalize_image), batched over
images: flip, scale jitter and crop as one inverse-map affine warp with
bilinear sampling, the ground-truth boxes carried through the same
transform. Its three random draws per image (flip, jitter, crop offset)
are inputs, drawn by det_train_draws from a torch.Generator (JAX draws
them from a key: the same distributions, other numbers). Images come in as
NHWC canvases (the loader's layout) and leave as float32 NCHW in the
channels_last memory format. det_eval_preprocess is the inference
resize of one image. The classification preprocessing comes with ROADMAP
M8.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def normalize_image(image, mean=MEAN_RGB, stddev=STDDEV_RGB):
  """(image - mean) / stddev over the last (channel) axis, in f32."""
  mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
  stddev = torch.as_tensor(stddev, dtype=torch.float32, device=image.device)
  return (image.float() - mean) / stddev


def det_train_draws(batch_size: int, generator, device=None):
  """Per image: flip (Bernoulli 0.5), a jitter uniform in [0, 1) and two
  crop-offset uniforms: (flip [B] bool, jitter [B], offsets [B, 2])."""
  u = torch.rand((batch_size, 4), generator=generator,
                 device=generator.device).to(device)
  return u[:, 0] < 0.5, u[:, 1], u[:, 2:4]


def _bilinear_warp(images, m, out_size: int):
  """Inverse-map affine warp of [B, H, W, C] f32 by per-image 3x3 `m`
  ([B, 3, 3]) to [B, out, out, C]: bilinear, edge-clamped, 0 outside
  [-1, H] x [-1, W] (augment.affine_warp with fill 0)."""
  b, h, w, c = images.shape
  dev = images.device
  yy = torch.arange(out_size, dtype=torch.float32, device=dev).view(1, -1, 1)
  xx = torch.arange(out_size, dtype=torch.float32, device=dev).view(1, 1, -1)
  e = lambda i, j: m[:, i, j].view(b, 1, 1)
  sy = e(0, 0) * yy + e(0, 1) * xx + e(0, 2)
  sx = e(1, 0) * yy + e(1, 1) * xx + e(1, 2)
  y0, x0 = torch.floor(sy), torch.floor(sx)
  wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
  y0i = torch.clamp(y0.long(), 0, h - 1)
  x0i = torch.clamp(x0.long(), 0, w - 1)
  y1i = torch.clamp(y0i + 1, 0, h - 1)
  x1i = torch.clamp(x0i + 1, 0, w - 1)
  flat = images.reshape(b * h * w, c)
  base = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1)

  def at(yi, xi):
    return flat[(base + yi * w + xi).reshape(-1)].view(b, out_size,
                                                       out_size, c)

  out = ((1 - wy) * (1 - wx) * at(y0i, x0i) + (1 - wy) * wx * at(y0i, x1i)
         + wy * (1 - wx) * at(y1i, x0i) + wy * wx * at(y1i, x1i))
  valid = (sy >= -1) & (sy <= h) & (sx >= -1) & (sx <= w)
  return torch.where(valid[..., None], out, torch.zeros_like(out))


def det_train_preprocess(images, boxes, classes, flip, jitter, offsets,
                         out_size: int, true_hw=None, jitter_min: float = 0.1,
                         jitter_max: float = 2.0, rand_hflip: bool = True,
                         mean=MEAN_RGB, stddev=STDDEV_RGB):
  """Canvases + padded ground truth -> flip + scale jitter + crop.

  images [B, H, W, C] canvases whose content fills [0:true_h, 0:true_w]
  (true_hw [B, 2], default the whole canvas); boxes [B, G, 4] absolute
  (ymin, xmin, ymax, xmax); classes [B, G], padding <= 0; flip, jitter,
  offsets from det_train_draws. Returns (images [B, C, out, out] f32
  normalized, channels_last; boxes [B, G, 4]; classes [B, G], -1 where a
  box left the crop)."""
  b, ch, cw, _ = images.shape
  dev = images.device
  f32 = torch.float32
  if true_hw is None:
    true_hw = torch.tensor([[ch, cw]] * b, dtype=f32, device=dev)
  h, w = true_hw[:, 0].to(f32), true_hw[:, 1].to(f32)
  do_flip = flip & bool(rand_hflip)
  jit = jitter_min + jitter.to(f32) * (jitter_max - jitter_min)
  scale = jit * out_size / torch.maximum(h, w)
  max_off_y = torch.clamp(h * scale - out_size, min=0.0)
  max_off_x = torch.clamp(w * scale - out_size, min=0.0)
  off_y, off_x = offsets[:, 0] * max_off_y, offsets[:, 1] * max_off_x

  # Inverse map out (y, x) -> content (iy, ix), optionally x-flipped about w.
  inv_s = 1.0 / scale
  iy_off = off_y * inv_s
  m = torch.zeros((b, 3, 3), dtype=f32, device=dev)
  m[:, 0, 0], m[:, 0, 2], m[:, 2, 2] = inv_s, iy_off, 1.0
  m[:, 1, 1] = torch.where(do_flip, -inv_s, inv_s)
  m[:, 1, 2] = torch.where(do_flip, w - off_x * inv_s, off_x * inv_s)
  out = _bilinear_warp(images.to(f32), m, out_size)
  # Zero the pixels sampled from outside the true content.
  yy = torch.arange(out_size, dtype=f32, device=dev).view(1, -1, 1)
  xx = torch.arange(out_size, dtype=f32, device=dev).view(1, 1, -1)
  v = lambda t: t.view(b, 1, 1)
  src_y = yy * v(inv_s) + v(iy_off)
  fwd_x = xx * v(inv_s) + v(off_x * inv_s)
  src_x = torch.where(v(do_flip), v(w) - fwd_x, fwd_x)
  inside = ((src_y >= 0) & (src_y < v(h)) & (src_x >= 0) & (src_x < v(w)))
  out = torch.where(inside[..., None], out, torch.zeros_like(out))

  # The boxes, forward-transformed.
  s, oy, ox = scale.view(b, 1), off_y.view(b, 1), off_x.view(b, 1)
  x_min, x_max = boxes[..., 1], boxes[..., 3]
  fl, wc = do_flip.view(b, 1), w.view(b, 1)
  fx_min = torch.where(fl, wc - x_max, x_min)
  fx_max = torch.where(fl, wc - x_min, x_max)
  new_boxes = torch.stack([boxes[..., 0] * s - oy, fx_min * s - ox,
                           boxes[..., 2] * s - oy, fx_max * s - ox], dim=-1)
  new_boxes = torch.clamp(new_boxes, 0.0, float(out_size))
  valid = ((new_boxes[..., 2] - new_boxes[..., 0] > 1e-3)
           & (new_boxes[..., 3] - new_boxes[..., 1] > 1e-3) & (classes > 0))
  classes = torch.where(valid, classes, torch.full_like(classes, -1))
  new_boxes = torch.where(valid[..., None], new_boxes,
                          torch.zeros_like(new_boxes))
  image = normalize_image(out, mean, stddev).permute(0, 3, 1, 2)
  return image, new_boxes, classes


def det_eval_preprocess(image, out_size: int, mean=MEAN_RGB,
                        stddev=STDDEV_RGB):
  """One [H, W, C] image -> ([out, out, C] f32, the scale that undoes the
  resize), automl_tpu/data/preprocessing.py::det_eval_preprocess's recipe:
  normalize first (so the padding is zero in normalized space), then a
  half-pixel bilinear resize without antialias (F.interpolate's
  align_corners=False is jax.image.resize's convention), then pad bottom
  and right. The scale and the scaled sizes are computed in float32 and
  truncated, as TF does: h 636 -> 256 gives 636 * (256 / 636) =
  255.99998f -> 255, not 256."""
  image = torch.as_tensor(image)
  h, w, c = image.shape
  scale32 = np.float32(min(np.float32(out_size) / np.float32(h),
                           np.float32(out_size) / np.float32(w)))
  sh = int(np.float32(h) * scale32)
  sw = int(np.float32(w) * scale32)
  normalized = normalize_image(image, mean, stddev)
  scaled = F.interpolate(normalized.permute(2, 0, 1)[None], size=(sh, sw),
                         mode="bilinear", align_corners=False,
                         antialias=False)[0].permute(1, 2, 0)
  out = torch.zeros((out_size, out_size, c), dtype=torch.float32,
                    device=image.device)
  out[:sh, :sw] = scaled
  return out, 1.0 / float(scale32)
