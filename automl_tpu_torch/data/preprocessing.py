"""Preprocessing on the device: classification and detection, training
and eval.

The counterpart of automl_tpu/data/preprocessing.py, batched over images.
Detection training: flip, scale jitter and crop as one inverse-map affine
warp with bilinear sampling, the ground-truth boxes carried through the
same transform. Classification training: an Inception crop (one bilinear
warp per image), a flip and RandAugment (data/augment.py), normalized by
the augname's family; the finetune path resizes the whole image and ends
with a cutout of random values; eval takes a centre crop and resizes it.
The random draws are inputs, drawn by det_train_draws / cls_train_draws /
cls_finetune_draws from a torch.Generator (JAX draws them from keys: the
same distributions, other numbers), so a test can feed JAX's draws in.
Images come in as NHWC canvases (the loader's layout) and leave as float32
NCHW in the channels_last memory format. det_eval_preprocess is the
inference resize of one image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from automl_tpu_torch.data import augment

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
  return augment.affine_warp(images, m, 0.0, "bilinear", (out_size, out_size))


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


# ---------------------------------------------------------------------------
# Classification.
# ---------------------------------------------------------------------------


def normalize_cls(images, norm: str = "v2"):
  """The classification normalization families: 'v2' (x - 128) / 128; 'ft'
  (x / 255 - 0.5) / 0.5; 'legacy' the per-channel ImageNet MEAN_RGB /
  STDDEV_RGB (the last axis is the channel's)."""
  x = images.float()
  if norm == "v2":
    return (x - 128.0) / 128.0
  if norm == "ft":
    return (x / 255.0 - 0.5) / 0.5
  if norm == "legacy":
    return normalize_image(x)
  raise ValueError(f"Unknown cls norm {norm!r}")


def norm_for_augname(augname: str | None) -> tuple[str, str | None]:
  """(norm, effective augname): 'effnetv1_*' -> legacy; 'ft*' -> ft."""
  if augname and augname.startswith("effnetv1_"):
    return "legacy", augname[len("effnetv1_"):]
  if augname and augname.startswith("ft"):
    return "ft", augname
  return "v2", augname


def _nchw(images):
  """[B, H, W, C] -> [B, C, H, W] in the channels_last memory format."""
  return images.permute(0, 3, 1, 2).contiguous(
      memory_format=torch.channels_last)


def random_resized_crop(images, crop, out_size: int):
  """Inception crops of [B, H, W, C] to [B, out, out, C] as one bilinear
  warp per image. crop [B, 4]: the area share (in [0.08, 1)), the log of
  the aspect ratio (in [log 3/4, log 4/3)) and two uniforms that place the
  crop's top left corner."""
  b, h, w, _ = images.shape
  # JAX's float32 arithmetic, each op taken in float64 and rounded to
  # float32: correctly rounded on any device (torch divides by a Python
  # number as a reciprocal product on the card, and its float32 exp there
  # is not correctly rounded), so the card's crops are the CPU's.
  r = lambda t: t.float().double()
  area, log_ratio, uy, ux = crop.float().double().unbind(1)
  ratio = r(torch.exp(log_ratio))
  crop_h = r(torch.sqrt(r(r(r(area * h) * w) / ratio)))
  crop_w = r(crop_h * ratio)
  crop_h = torch.clamp(crop_h, max=float(h))
  crop_w = torch.clamp(crop_w, max=float(w))
  m = torch.zeros((b, 3, 3), dtype=torch.float64, device=images.device)
  m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = crop_h / out_size, crop_w / out_size, 1
  m[:, 0, 2], m[:, 1, 2] = uy * r(h - crop_h), ux * r(w - crop_w)
  return _bilinear_warp(images.float(), m.float(), out_size)


def random_hflip(images, flip):
  """Each image mirrored left-right where flip [B] is True."""
  return torch.where(flip.view(-1, 1, 1, 1), images.flip(2), images)


def cls_train_draws(batch_size: int, out_size: int, generator,
                    num_layers: int = 2, device=None) -> dict:
  """The classification training draws of one batch: the crop [B, 4]
  (area share, log aspect ratio, two placement uniforms), the flip [B]
  (Bernoulli 0.5) and RandAugment's (augment.randaugment_draws)."""
  g = generator
  u = torch.rand((batch_size, 5), generator=g, device=g.device)
  lo, hi = float(np.log(3 / 4)), float(np.log(4 / 3))
  crop = torch.stack([0.08 + u[:, 0] * (1.0 - 0.08), lo + u[:, 1] * (hi - lo),
                      u[:, 2], u[:, 3]], 1)
  return {"crop": crop.to(device), "flip": (u[:, 4] < 0.5).to(device),
          "randaug": augment.randaugment_draws(batch_size, num_layers,
                                               out_size, out_size, g, device)}


def cls_train_preprocess(images, draws: dict, out_size: int,
                         augname: str = "randaug", ra_magnitude: float = 15.0):
  """[B, H, W, C] uint8 canvases -> [B, C, out, out] f32, normalized and
  augmented, channels_last. By augname: 'effnetv1_*' the legacy
  normalization, 'ft*' the finetune path (cls_finetune_preprocess, which
  takes cls_finetune_draws), else (x - 128) / 128; RandAugment when the
  augname names randaug or autoaug (draws from cls_train_draws, whose
  num_layers is RandAugment's)."""
  norm, aug = norm_for_augname(augname)
  if norm == "ft":
    return cls_finetune_preprocess(images, draws, out_size, augname=aug,
                                   ra_magnitude=ra_magnitude, train=True)
  imgs = random_resized_crop(images, draws["crop"], out_size)
  imgs = random_hflip(imgs, draws["flip"])
  if aug and ("randaug" in aug or "autoaug" in aug):
    imgs = augment.randaugment(imgs, draws["randaug"], ra_magnitude)
  return _nchw(normalize_cls(imgs, norm))


def cls_finetune_draws(batch_size: int, out_size: int, generator,
                       num_layers: int = 2, device=None) -> dict:
  """The finetune path's draws: the flip [B], RandAugment's, the cutout
  centre [B, 2] and its replacement values [B, out, out, 3], uniform in
  [-1, 1)."""
  g = generator
  return {"flip": (torch.rand((batch_size,), generator=g, device=g.device)
                   < 0.5).to(device),
          "randaug": augment.randaugment_draws(batch_size, num_layers,
                                               out_size, out_size, g, device),
          "cutout": augment.cutout_draws(batch_size, out_size, out_size, g,
                                         device),
          "replace": (torch.rand((batch_size, out_size, out_size, 3),
                                 generator=g, device=g.device) * 2.0
                      - 1.0).to(device)}


def cls_finetune_preprocess(images, draws, out_size: int, augname: str = "ft",
                            ra_magnitude: float = 15.0, train: bool = True):
  """The finetune path: the whole image resized (bilinear, antialiased when
  it shrinks, as jax.image.resize), flipped, RandAugment where the augname
  names it, normalized by 'ft', then a cutout (pad out // 4) of random
  values where the augname is 'ft' or names cutout. train=False: resize
  and normalize only (draws unused)."""
  imgs = F.interpolate(images.float().permute(0, 3, 1, 2),
                       size=(out_size, out_size), mode="bilinear",
                       align_corners=False, antialias=True)
  imgs = imgs.permute(0, 2, 3, 1)
  if not train:
    return _nchw(normalize_cls(imgs, "ft"))
  imgs = random_hflip(imgs, draws["flip"])
  if "randaug" in augname or "autoaug" in augname:
    imgs = augment.randaugment(imgs, draws["randaug"], ra_magnitude)
  imgs = normalize_cls(imgs, "ft")
  if augname == "ft" or "cutout" in augname:
    imgs = augment.cutout(imgs, draws["cutout"], out_size // 4,
                          replace=draws["replace"])
  return _nchw(imgs)


def cls_eval_preprocess(images, out_size: int, crop_pad: int = 32,
                        norm: str = "v2", precropped: bool = False):
  """Centre crop of the fraction out / (out + crop_pad), resized (bilinear,
  no antialias) to out, normalized: [B, H, W, C] -> [B, C, out, out] f32,
  channels_last. precropped (or canvases already out x out): normalize
  only."""
  b, h, w, c = images.shape
  if precropped or (h, w) == (out_size, out_size):
    return _nchw(normalize_cls(images, norm))
  frac = out_size / (out_size + crop_pad)
  crop_h, crop_w = int(h * frac), int(w * frac)
  y0, x0 = (h - crop_h) // 2, (w - crop_w) // 2
  crop = images[:, y0:y0 + crop_h, x0:x0 + crop_w].float().permute(0, 3, 1, 2)
  out = F.interpolate(crop, size=(out_size, out_size), mode="bilinear",
                      align_corners=False, antialias=False)
  return _nchw(normalize_cls(out.permute(0, 2, 3, 1), norm))
