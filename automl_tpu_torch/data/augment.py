"""Augmentation on the device, batched: RandAugment's 16 ops, mixup /
cutmix, mosaic and gridmask.

The counterpart of automl_tpu/data/augment.py. Images are NHWC float
batches in [0, 255] ([B, H, W, C], JAX's layout; the callers permute to
NCHW afterwards). JAX writes each op for one image and vmaps it; here each
op takes the batch and per-image parameters as [B] tensors. Every random
draw is an input (randaugment_draws, mixing_draws, gridmask_draws, ...,
from a torch.Generator), so a test can feed JAX's draws in; JAX draws them
from keys: the same distributions, other numbers.

Batched RandAugment runs as JAX's vmap(lax.switch) does: every op on every
image, the drawn op picked per image with torch.where. There is no host
loop over images and no host sync.

Geometric ops share one inverse-map affine warp (affine_warp), nearest or
bilinear, with a fill value outside the image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Affine warp.
# ---------------------------------------------------------------------------


def affine_warp(images, m, fill_value=128.0, method: str = "nearest",
                out_hw=None):
  """Warps [B, H, W, C] by the per-image INVERSE-map affine `m` [B, 3, 3]:
  output (y, x) samples the input at m @ (y, x, 1). Nearest rounds half to
  even (jnp.round's rule); bilinear clamps its taps to the edge. Outside
  the image (nearest: [0, H) x [0, W); bilinear: [-1, H] x [-1, W]) the
  output is fill_value. out_hw sets the output size (default the input's)."""
  b, h, w, c = images.shape
  oh, ow = out_hw if out_hw is not None else (h, w)
  dev = images.device
  yy = torch.arange(oh, dtype=torch.float32, device=dev).view(1, -1, 1)
  xx = torch.arange(ow, dtype=torch.float32, device=dev).view(1, 1, -1)
  m = m.to(torch.float32)

  def src(i):
    # XLA's CPU dot: fma(m[i, 1], x, m[i, 0] * y) + m[i, 2]. The fused
    # product-add, rounded once, is taken in float64 (exact for the f32
    # product), so that nearest taps round as JAX's do.
    e = lambda j: m[:, i, j].view(b, 1, 1)
    first = (e(0) * yy).double()
    return (e(1).double() * xx.double() + first).float() + e(2)

  sy, sx = src(0), src(1)
  flat = images.reshape(b * h * w, c)
  base = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1)

  def at(yi, xi):
    return flat[(base + yi * w + xi).reshape(-1)].view(b, oh, ow, c)

  if method == "nearest":
    iy, ix = torch.round(sy).long(), torch.round(sx).long()
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = at(iy.clamp(0, h - 1), ix.clamp(0, w - 1))
  elif method == "bilinear":
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x0i = torch.clamp(x0.long(), 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    out = ((1 - wy) * (1 - wx) * at(y0i, x0i) + (1 - wy) * wx * at(y0i, x1i)
           + wy * (1 - wx) * at(y1i, x0i) + wy * wx * at(y1i, x1i))
    valid = (sy >= -1) & (sy <= h) & (sx >= -1) & (sx <= w)
  else:
    raise ValueError(f"Unknown warp method {method!r}")
  fill = torch.full_like(out, fill_value)
  return torch.where(valid[..., None], out, fill)


def _eye(b, device):
  return torch.eye(3, dtype=torch.float32, device=device).repeat(b, 1, 1)


def translate_matrix(dy, dx):
  """[B] offsets -> [B, 3, 3] inverse maps (y + dy, x + dx)."""
  m = _eye(dy.shape[0], dy.device)
  m[:, 0, 2], m[:, 1, 2] = dy, dx
  return m


def rotate_matrix(radians, h: int, w: int):
  """[B] angles -> [B, 3, 3] inverse maps of a rotation about the centre."""
  cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
  # cos and sin correctly rounded on any device (float64, then float32).
  cos, sin = torch.cos(radians.double()).float(), torch.sin(
      radians.double()).float()
  m = _eye(radians.shape[0], radians.device)
  m[:, 0, 0], m[:, 0, 1] = cos, sin
  m[:, 1, 0], m[:, 1, 1] = -sin, cos
  m[:, 0, 2] = cy - (cos * cy + sin * cx)
  m[:, 1, 2] = cx - (-sin * cy + cos * cx)
  return m


def shear_matrix(level, axis: str):
  """x: output (y, x) samples (y, x + level * y); y: (y + level * x, x)."""
  m = _eye(level.shape[0], level.device)
  if axis == "x":
    m[:, 1, 0] = level
  else:
    m[:, 0, 1] = level
  return m


# ---------------------------------------------------------------------------
# Colour ops ([B, H, W, C] float in [0, 255]; factors [B]).
# ---------------------------------------------------------------------------


def _col(v, images):
  """A [B] parameter (or a scalar) broadcast against [B, H, W, C]."""
  v = torch.as_tensor(v, dtype=torch.float32, device=images.device)
  return v.view(-1, 1, 1, 1) if v.ndim else v


def _blend(a, b, factor):
  return torch.clamp(b + _col(factor, a) * (a - b), 0.0, 255.0)


def _grayscale(images):
  rgb = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype,
                     device=images.device)
  return (images * rgb).sum(-1, keepdim=True) * torch.ones_like(images)


def autocontrast(images):
  lo = images.amin((1, 2), keepdim=True)
  hi = images.amax((1, 2), keepdim=True)
  # 255 / (hi - lo) rounded once: a Python number over a tensor is a
  # reciprocal times the number in torch.
  scale = torch.where(hi > lo, (255.0 / (hi - lo).double()).float(),
                      torch.ones_like(hi))
  off = torch.where(hi > lo, -lo * scale, torch.zeros_like(hi))
  return torch.clamp(images * scale + off, 0.0, 255.0)


def equalize(images):
  """Per-image, per-channel histogram equalization with TF's rule (uint8
  semantics): step = (pixels - the last non-empty bin's count) // 255, the
  lookup (cumsum + step // 2) // step shifted one bin, identity where step
  is 0. Integer work: one scatter_add into [B * C, 256]."""
  b, h, w, c = images.shape
  ch = torch.clamp(images, 0, 255).to(torch.int64)          # truncates
  rows = ch.permute(0, 3, 1, 2).reshape(b * c, h * w)
  histo = torch.zeros((b * c, 256), dtype=torch.int64, device=images.device)
  histo.scatter_add_(1, rows, torch.ones_like(rows))
  bins = torch.arange(256, device=images.device)
  last = torch.where(histo > 0, bins, torch.zeros_like(bins)).amax(1,
                                                                   keepdim=True)
  step = (histo.sum(1, keepdim=True) - histo.gather(1, last)) // 255
  lut = (histo.cumsum(1) + step // 2) // torch.clamp(step, min=1)
  lut = torch.clamp(F.pad(lut[:, :-1], (1, 0)), 0, 255)
  out = torch.where(step == 0, rows, lut.gather(1, rows))
  return out.view(b, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def invert(images):
  return 255.0 - images


def posterize(images, bits):
  """Keeps the top `bits` ([B] int or an int) of each clipped uint8 value."""
  shift = (8 - torch.as_tensor(bits, device=images.device)).to(torch.int64)
  shift = shift.view(-1, 1, 1, 1) if shift.ndim else shift
  x = torch.clamp(images, 0, 255).to(torch.int64)
  return ((x >> shift) << shift).to(torch.float32)


def solarize(images, threshold=128.0):
  return torch.where(images < _col(threshold, images), images, 255.0 - images)


def solarize_add(images, addition=0.0, threshold=128.0):
  added = torch.clamp(images + _col(addition, images), 0.0, 255.0)
  return torch.where(images < _col(threshold, images), added, images)


def color(images, factor):
  return _blend(images, _grayscale(images), factor)


def contrast(images, factor):
  mean = _grayscale(images).mean((1, 2, 3), keepdim=True)
  return _blend(images, mean.expand_as(images), factor)


def brightness(images, factor):
  return _blend(images, torch.zeros_like(images), factor)


def sharpness(images, factor):
  """Blend with the 3 x 3 smoothing blur [[1,1,1],[1,5,1],[1,1,1]] / 13 of
  the interior; the border keeps its pixels (TF's rule)."""
  b, h, w, c = images.shape
  kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                        device=images.device) / 13.0
  x = images.permute(0, 3, 1, 2)
  blurred = F.conv2d(x, kernel.expand(c, 1, 3, 3), groups=c)
  blurred = F.pad(blurred, (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
  yy = torch.arange(h, device=images.device).view(h, 1)
  xx = torch.arange(w, device=images.device).view(1, w)
  interior = ((yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))[..., None]
  return _blend(images, torch.where(interior, blurred, images), factor)


def cutout(images, centre, pad_size, replace=128.0):
  """Replaces the square |y - cy| <= pad, |x - cx| <= pad of each image
  (centre [B, 2] int) by `replace`: a scalar or a full-shape tensor."""
  b, h, w, _ = images.shape
  dev = images.device
  yy = torch.arange(h, device=dev).view(1, h, 1)
  xx = torch.arange(w, device=dev).view(1, 1, w)
  cy, cx = centre[:, 0].view(b, 1, 1), centre[:, 1].view(b, 1, 1)
  pad = torch.as_tensor(pad_size, device=dev)
  pad = pad.view(-1, 1, 1) if pad.ndim else pad
  mask = ((yy - cy).abs() <= pad) & ((xx - cx).abs() <= pad)
  fill = torch.as_tensor(replace, dtype=images.dtype, device=dev)
  return torch.where(mask[..., None], fill.expand_as(images), images)


def cutout_draws(b: int, h: int, w: int, generator, device=None):
  """[B, 2] centres, uniform over the rows and columns."""
  u = torch.rand((b, 2), generator=generator, device=generator.device)
  size = torch.tensor([h, w], dtype=torch.float32, device=u.device)
  return torch.floor(u * size).long().clamp_max(
      torch.tensor([h - 1, w - 1], device=u.device)).to(device)


def rotate(images, degrees, replace=128.0):
  _, h, w, _ = images.shape
  return affine_warp(images, rotate_matrix(torch.deg2rad(degrees), h, w),
                     replace)


def translate_x(images, pixels, replace=128.0):
  return affine_warp(images, translate_matrix(torch.zeros_like(pixels),
                                              pixels), replace)


def translate_y(images, pixels, replace=128.0):
  return affine_warp(images, translate_matrix(pixels,
                                              torch.zeros_like(pixels)),
                     replace)


def shear_x_op(images, level, replace=128.0):
  return affine_warp(images, shear_matrix(level, "x"), replace)


def shear_y_op(images, level, replace=128.0):
  return affine_warp(images, shear_matrix(level, "y"), replace)


# ---------------------------------------------------------------------------
# RandAugment.
# ---------------------------------------------------------------------------

_MAX_LEVEL = 10.0
OPS = ("autocontrast", "equalize", "invert", "rotate", "posterize",
       "solarize", "solarize_add", "color", "contrast", "brightness",
       "sharpness", "shear_x", "shear_y", "translate_x", "translate_y",
       "cutout")


def _mag(level, maxval) -> np.float32:
  """level / 10 * maxval in float32, as JAX computes it."""
  return np.float32(level) / np.float32(_MAX_LEVEL) * np.float32(maxval)


def apply_op(name: str, images, sign, centre, magnitude: float):
  """RandAugment op `name` on the batch at `magnitude`, with per-image
  signs (sign [B] bool: True keeps +magnitude) and cutout centres [B, 2]."""
  dev = images.device

  def signed(maxval):
    v = torch.tensor(float(_mag(magnitude, maxval)), dtype=torch.float32,
                     device=dev)
    return torch.where(sign, v, -v)

  if name == "autocontrast":
    return autocontrast(images)
  if name == "equalize":
    return equalize(images)
  if name == "invert":
    return invert(images)
  if name == "rotate":
    return rotate(images, signed(30.0))
  if name == "posterize":
    return posterize(images, int(np.round(_mag(magnitude, 4.0))))
  if name == "solarize":
    return solarize(images, float(_mag(magnitude, 256.0)))
  if name == "solarize_add":
    return solarize_add(images, float(_mag(magnitude, 110.0)))
  if name in ("color", "contrast", "brightness", "sharpness"):
    fn = dict(color=color, contrast=contrast, brightness=brightness,
              sharpness=sharpness)[name]
    return fn(images, 1.0 + signed(0.9))
  if name in ("shear_x", "shear_y"):
    return (shear_x_op if name == "shear_x" else shear_y_op)(images,
                                                             signed(0.3))
  if name in ("translate_x", "translate_y"):
    return (translate_x if name == "translate_x" else translate_y)(
        images, signed(100.0))
  if name == "cutout":
    return cutout(images, centre, int(np.round(_mag(magnitude, 40.0))))
  raise ValueError(f"Unknown RandAugment op {name!r}")


def randaugment_draws(b: int, num_layers: int, h: int, w: int, generator,
                      device=None) -> dict:
  """Per image and layer: the op index [B, L] (uniform over the 16 ops),
  the sign [B, L] (Bernoulli 0.5) and the cutout centre [B, L, 2]."""
  g = generator
  u = torch.rand((b, num_layers, 4), generator=g, device=g.device)
  size = torch.tensor([h, w], dtype=torch.float32, device=u.device)
  centre = torch.minimum(torch.floor(u[..., 2:] * size),
                         size - 1).long()
  return {"op": torch.floor(u[..., 0] * len(OPS)).long().clamp_max(
              len(OPS) - 1).to(device),
          "sign": (u[..., 1] < 0.5).to(device), "centre": centre.to(device)}


def randaugment(images, draws: dict, magnitude: float = 15.0):
  """RandAugment on [B, H, W, C] in [0, 255]: for each layer, every op on
  the batch, the drawn one kept per image (JAX's vmap of lax.switch);
  clipped to [0, 255] at the end."""
  img = images.to(torch.float32)
  for layer in range(draws["op"].shape[1]):
    op = draws["op"][:, layer].view(-1, 1, 1, 1)
    sign, centre = draws["sign"][:, layer], draws["centre"][:, layer]
    out = img
    for i, name in enumerate(OPS):
      out = torch.where(op == i, apply_op(name, img, sign, centre, magnitude),
                        out)
    img = out
  return torch.clamp(img, 0.0, 255.0)


# ---------------------------------------------------------------------------
# Mixup / cutmix (batch level, labels mixed).
# ---------------------------------------------------------------------------


def beta_draws(n: int, alpha: float, generator, device=None):
  """[n] Beta(alpha, alpha) draws from the generator: X / (X + Y) of two
  Gamma(alpha) draws (torch.distributions.Beta has no generator); 0.5 where
  both underflow to 0."""
  a = torch.full((2, n), float(alpha), device=generator.device)
  x, y = torch._standard_gamma(a, generator=generator)
  s = x + y
  lam = torch.where(s > 0, x / torch.where(s > 0, s, torch.ones_like(s)),
                    torch.full_like(s, 0.5))
  return lam.to(device)


def mixup(images, labels, lam):
  """Each image (and label) mixed with the reversed batch by lam [B]."""
  li = lam.view(-1, 1, 1, 1).to(images.dtype)
  mixed = li * images + (1 - li) * images.flip(0)
  ll = lam.view(-1, 1).to(labels.dtype)
  return mixed, ll * labels + (1 - ll) * labels.flip(0)


def cutmix(images, labels, lam, centre):
  """Pastes into each image a box of the reversed batch's: side sqrt(1 -
  lam) of the image's, centred at centre [B, 2] (int), clipped; the labels
  mixed by the pasted area."""
  b, h, w, _ = images.shape
  dev = images.device
  cut = torch.sqrt(1.0 - lam)
  cut_h = (cut * h).to(torch.int64)
  cut_w = (cut * w).to(torch.int64)
  cy, cx = centre[:, 0], centre[:, 1]
  y0 = torch.clamp(cy - cut_h // 2, 0, h).view(b, 1, 1)
  y1 = torch.clamp(cy + cut_h // 2, 0, h).view(b, 1, 1)
  x0 = torch.clamp(cx - cut_w // 2, 0, w).view(b, 1, 1)
  x1 = torch.clamp(cx + cut_w // 2, 0, w).view(b, 1, 1)
  yy = torch.arange(h, device=dev).view(1, h, 1)
  xx = torch.arange(w, device=dev).view(1, 1, w)
  mask = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[..., None]
  mixed = torch.where(mask, images.flip(0), images)
  area = ((y1 - y0) * (x1 - x0)).view(-1).to(torch.float32) / (h * w)
  lam_eff = (1.0 - area).view(-1, 1).to(labels.dtype)
  return mixed, lam_eff * labels + (1 - lam_eff) * labels.flip(0)


def mixing_draws(b: int, h: int, w: int, generator, mixup_alpha: float = 0.0,
                 cutmix_alpha: float = 0.0, device=None) -> dict:
  """mixup's lam over its rows and cutmix's lam and centres over its (both
  on: the first b // 2 rows mixup, the rest cutmix)."""
  if not mixup_alpha and not cutmix_alpha:
    return {}
  n_mix = (b // 2 if cutmix_alpha else b) if mixup_alpha else 0
  out = {}
  if mixup_alpha:
    out["mixup_lam"] = beta_draws(n_mix, mixup_alpha, generator, device)
  if cutmix_alpha:
    out["cutmix_lam"] = beta_draws(b - n_mix, cutmix_alpha, generator, device)
    out["cutmix_centre"] = cutout_draws(b - n_mix, h, w, generator, device)
  return out


def mixing(images, labels, draws: dict, mixup_alpha: float = 0.0,
           cutmix_alpha: float = 0.0):
  """mixup and / or cutmix; both on: mixup the first half of the batch,
  cutmix the second."""
  if not mixup_alpha and not cutmix_alpha:
    return images, labels
  if mixup_alpha and cutmix_alpha:
    half = images.shape[0] // 2
    im1, lb1 = mixup(images[:half], labels[:half], draws["mixup_lam"])
    im2, lb2 = cutmix(images[half:], labels[half:], draws["cutmix_lam"],
                      draws["cutmix_centre"])
    return torch.cat([im1, im2]), torch.cat([lb1, lb2])
  if mixup_alpha:
    return mixup(images, labels, draws["mixup_lam"])
  return cutmix(images, labels, draws["cutmix_lam"], draws["cutmix_centre"])


# ---------------------------------------------------------------------------
# Mosaic and gridmask (detection).
# ---------------------------------------------------------------------------


def mosaic(images, boxes, classes, cu, center_range=(0.25, 0.75)):
  """Four images [4, H, W, C] -> one mosaic around the centre (cy, cx) =
  (lo + cu * (hi - lo)) * (H, W), cu [2] uniforms: each image warped
  (bilinear, fill 0) into its quadrant, its boxes [G, 4] carried and
  clipped (classes -1 where a box falls under 1 px). Returns (image [H, W,
  C], boxes [4G, 4], classes [4G])."""
  _, h, w, c = images.shape
  lo, hi = center_range
  cy = (lo + cu[0] * (hi - lo)) * h
  cx = (lo + cu[1] * (hi - lo)) * w
  dev = images.device
  zero = torch.zeros((), device=dev)
  fh = torch.tensor(float(h), device=dev)
  fw = torch.tensor(float(w), device=dev)
  yy = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1)
  xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, w)
  quads = [(zero, zero, cy, cx), (zero, cx, cy, fw), (cy, zero, fh, cx),
           (cy, cx, fh, fw)]
  out = torch.zeros((h, w, c), dtype=torch.float32, device=dev)
  out_boxes, out_classes = [], []
  for i, (y0, x0, y1, x1) in enumerate(quads):
    sy = fh / torch.clamp(y1 - y0, min=1.0)
    sx = fw / torch.clamp(x1 - x0, min=1.0)
    m = torch.eye(3, dtype=torch.float32, device=dev)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = sy, sx, -y0 * sy, -x0 * sx
    warped = affine_warp(images[i:i + 1].float(), m[None], 0.0, "bilinear")[0]
    mask = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[..., None]
    out = torch.where(mask, warped, out)
    bx = boxes[i]
    nb = torch.stack([bx[:, 0] / sy + y0, bx[:, 1] / sx + x0,
                      bx[:, 2] / sy + y0, bx[:, 3] / sx + x0], 1)
    nb = torch.stack([torch.minimum(torch.maximum(nb[:, 0], y0), y1),
                      torch.minimum(torch.maximum(nb[:, 1], x0), x1),
                      torch.minimum(torch.maximum(nb[:, 2], y0), y1),
                      torch.minimum(torch.maximum(nb[:, 3], x0), x1)], 1)
    valid = ((nb[:, 2] - nb[:, 0] > 1) & (nb[:, 3] - nb[:, 1] > 1)
             & (classes[i] > 0))
    out_boxes.append(torch.where(valid[:, None], nb, torch.zeros_like(nb)))
    out_classes.append(torch.where(valid, classes[i],
                                   torch.full_like(classes[i], -1)))
  return out, torch.cat(out_boxes), torch.cat(out_classes)


def gridmask_draws(b: int, h: int, w: int, generator, device=None) -> dict:
  """Per image: the grid period d, uniform over [max(1, S // 8), max(2, S //
  2)) for S = max(H, W), and the grid's offsets sy, sx, uniform over [0,
  d)."""
  side = max(h, w)
  lo, hi = max(1, side // 8), max(2, side // 2)
  u = torch.rand((b, 3), generator=generator, device=generator.device)
  d = torch.clamp(lo + torch.floor(u[:, 0] * (hi - lo)), max=hi - 1)
  off = torch.minimum(torch.floor(u[:, 1:] * d[:, None]), d[:, None] - 1)
  return {"d": d.long().to(device), "offset": off.long().to(device)}


def gridmask(images, draws: dict, ratio: float = 0.6, fill=1.0):
  """A grid of masked squares: where (y + sy) % d < keep and (x + sx) % d <
  keep, keep = int(d * ratio), the pixels take `fill`."""
  b, h, w, _ = images.shape
  dev = images.device
  d = torch.clamp(draws["d"], min=1).view(b, 1, 1)
  keep = (draws["d"].to(torch.float32) * ratio).to(torch.int64).view(b, 1, 1)
  sy = draws["offset"][:, 0].view(b, 1, 1)
  sx = draws["offset"][:, 1].view(b, 1, 1)
  yy = torch.arange(h, device=dev).view(1, h, 1)
  xx = torch.arange(w, device=dev).view(1, 1, w)
  masked = (((yy + sy) % d) < keep) & (((xx + sx) % d) < keep)
  return torch.where(masked[..., None],
                     torch.tensor(fill, dtype=images.dtype, device=dev),
                     images)

