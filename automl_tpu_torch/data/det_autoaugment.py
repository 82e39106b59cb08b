"""Box-aware AutoAugment for detection, batched on the device: policies
v0-v3.

The counterpart of automl_tpu/data/det_autoaugment.py: the same policy
tables (POLICY_V1 the same 14-of-20 subset of the reference's v1), the
same level -> magnitude mappings and op semantics. Every geometric op is
the inverse-map affine warp of data/augment.py, and its boxes go through
the FORWARD affine (the inverse of the inverse map) by their 4 corners and
are re-bounded, so image and boxes cannot drift apart; a box that leaves
the image (or was padding) becomes class -1 with zero coordinates.
*_Only_BBoxes and BBox_Cutout apply their op under the union of the gt
boxes.

Every draw is an input (autoaugment_draws, from a torch.Generator), so a
test can feed JAX's in: the sub-policy index per image, and per op slot
the uniform of its Bernoulli (the op runs where it is below the op's
probability), its sign (True keeps +magnitude) and its cutout centre. As
JAX's vmap of lax.switch does, every sub-policy runs on every image and
each image keeps the one it drew (torch.where): no host sync. Ops of
probability 0 never run and are skipped.
"""

from __future__ import annotations

import torch

from automl_tpu_torch.data import augment

_MAX_LEVEL = 10.0
MAX_OPS = 3   # the longest sub-policy (v2, v3)

POLICY_V0 = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
]

# The JAX package's subset of the reference's v1 (14 of its 20
# sub-policies), kept as it is there.
POLICY_V1 = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
    [("Equalize", 0.6, 10), ("TranslateX_BBox", 0.2, 2)],
    [("Color", 1.0, 10), ("TranslateY_Only_BBoxes", 0.4, 6)],
    [("Rotate_BBox", 0.8, 10), ("Contrast", 0.0, 10)],
    [("Cutout", 0.2, 2), ("Brightness", 0.8, 10)],
    [("Color", 1.0, 6), ("Equalize", 1.0, 2)],
    [("Color", 0.2, 8), ("Rotate_BBox", 0.8, 10)],
    [("Sharpness", 0.4, 4), ("TranslateY_Only_BBoxes", 0.0, 4)],
    [("Sharpness", 1.0, 4), ("SolarizeAdd", 0.4, 4)],
    [("Rotate_BBox", 1.0, 8), ("Sharpness", 0.2, 8)],
]

POLICY_V2 = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("Rotate_BBox", 0.4, 8), ("Sharpness", 0.4, 2), ("Rotate_BBox", 0.8, 10)],
    [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8), ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10), ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("TranslateY_BBox", 0.0, 4), ("Equalize", 0.6, 8), ("Solarize", 0.0, 10)],
    [("TranslateY_BBox", 0.2, 2), ("ShearY_BBox", 0.8, 8), ("Rotate_BBox", 0.8, 8)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4), ("TranslateY_BBox", 1.0, 6), ("Rotate_BBox", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("BBox_Cutout", 1.0, 4), ("Cutout", 0.2, 8)],
    [("Rotate_BBox", 0.0, 0), ("Equalize", 0.6, 6), ("ShearY_BBox", 0.6, 8)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2), ("Brightness", 0.2, 2)],
    [("TranslateY_BBox", 0.4, 8), ("Solarize", 0.4, 6), ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

POLICY_V3 = [
    [("Posterize", 0.8, 2), ("TranslateX_BBox", 1.0, 8)],
    [("BBox_Cutout", 0.2, 10), ("Sharpness", 1.0, 8)],
    [("Rotate_BBox", 0.6, 8), ("Rotate_BBox", 0.8, 10)],
    [("Equalize", 0.8, 10), ("AutoContrast", 0.2, 10)],
    [("SolarizeAdd", 0.2, 2), ("TranslateY_BBox", 0.2, 8)],
    [("Sharpness", 0.0, 2), ("Color", 0.4, 8)],
    [("Equalize", 1.0, 8), ("TranslateY_BBox", 1.0, 8)],
    [("Posterize", 0.6, 2), ("Rotate_BBox", 0.0, 10)],
    [("AutoContrast", 0.6, 0), ("Rotate_BBox", 1.0, 6)],
    [("Equalize", 0.0, 4), ("Cutout", 0.8, 10)],
    [("Brightness", 1.0, 2), ("TranslateY_BBox", 1.0, 6)],
    [("Contrast", 0.0, 2), ("ShearY_BBox", 0.8, 0)],
    [("AutoContrast", 0.8, 10), ("Contrast", 0.2, 10)],
    [("Rotate_BBox", 1.0, 10), ("Cutout", 1.0, 10)],
    [("SolarizeAdd", 0.8, 6), ("Equalize", 0.8, 8)],
]

POLICIES = {"v0": POLICY_V0, "v1": POLICY_V1, "v2": POLICY_V2,
            "v3": POLICY_V3}


def _policy(name: str):
  if name not in POLICIES:
    raise KeyError(f"Unknown det-autoaugment policy {name!r}; available: "
                   f"{sorted(POLICIES)}")
  return POLICIES[name]


def _transform_boxes_forward(boxes, classes, minv, out_hw):
  """(ymin, xmin, ymax, xmax) [B, G, 4] through the forward affine
  (inv(minv), minv [B, 3, 3]) by their corners, re-bounded and clipped to
  the image; degenerate boxes (and padding) become zeros of class -1."""
  fwd = torch.linalg.inv(minv.to(torch.float32))
  y0, x0, y1, x1 = boxes.unbind(-1)
  ones = torch.ones_like(y0)
  corners = torch.stack([
      torch.stack([y0, x0, ones], -1), torch.stack([y0, x1, ones], -1),
      torch.stack([y1, x0, ones], -1), torch.stack([y1, x1, ones], -1),
  ], 2)                                                     # [B, G, 4, 3]
  moved = torch.einsum("bij,bgcj->bgci", fwd, corners)
  h, w = out_hw
  ny0 = moved[..., 0].amin(2).clamp(0, h)
  nx0 = moved[..., 1].amin(2).clamp(0, w)
  ny1 = moved[..., 0].amax(2).clamp(0, h)
  nx1 = moved[..., 1].amax(2).clamp(0, w)
  new_boxes = torch.stack([ny0, nx0, ny1, nx1], -1)
  valid = (classes > 0) & (ny1 - ny0 > 1e-3) & (nx1 - nx0 > 1e-3)
  return (torch.where(valid[..., None], new_boxes,
                      torch.zeros_like(new_boxes)),
          torch.where(valid, classes, torch.full_like(classes, -1)))


def _affine_with_boxes(images, boxes, classes, minv):
  _, h, w, _ = images.shape
  nb, nc = _transform_boxes_forward(boxes, classes, minv, (h, w))
  return augment.affine_warp(images, minv, 128.0), nb, nc


def _boxes_mask(images, boxes, classes):
  """[B, H, W, 1]: inside any valid gt box ([y0, y1) x [x0, x1)); the
  union as a count (rows [B, H, G] @ columns [B, G, W]), exact in
  float32."""
  _, h, w, _ = images.shape
  dev = images.device
  yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, 1, h)
  xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
  valid = (classes > 0)[..., None]
  rows = ((yy >= boxes[..., 0:1]) & (yy < boxes[..., 2:3]) & valid).float()
  cols = ((xx >= boxes[..., 1:2]) & (xx < boxes[..., 3:4])).float()
  return (rows.transpose(1, 2) @ cols > 0)[..., None]


def apply_op(name: str, level: float, images, boxes, classes, sign, centre):
  """Op `name` at `level` on the batch: images [B, H, W, C] float in [0,
  255], boxes [B, G, 4] absolute, classes [B, G] (padding <= 0), sign [B]
  bool, centre [B, 2] int. Returns (images, boxes, classes)."""
  b, h, w, _ = images.shape
  dev = images.device
  zeros = torch.zeros((b,), dtype=torch.float32, device=dev)

  def signed(magnitude):   # magnitudes in float64, as JAX's Python floats
    v = torch.tensor(magnitude, dtype=torch.float32, device=dev)
    return torch.where(sign, v, -v)

  if name == "TranslateX_BBox":
    m = augment.translate_matrix(zeros, signed(level / _MAX_LEVEL * 250.0))
    return _affine_with_boxes(images, boxes, classes, m)
  if name == "TranslateY_BBox":
    m = augment.translate_matrix(signed(level / _MAX_LEVEL * 250.0), zeros)
    return _affine_with_boxes(images, boxes, classes, m)
  if name == "ShearX_BBox":
    m = augment.shear_matrix(signed(level / _MAX_LEVEL * 0.3), "x")
    return _affine_with_boxes(images, boxes, classes, m)
  if name == "ShearY_BBox":
    m = augment.shear_matrix(signed(level / _MAX_LEVEL * 0.3), "y")
    return _affine_with_boxes(images, boxes, classes, m)
  if name == "Rotate_BBox":
    deg = signed(level / _MAX_LEVEL * 30.0)
    m = augment.rotate_matrix(torch.deg2rad(deg), h, w)
    return _affine_with_boxes(images, boxes, classes, m)
  if name == "TranslateY_Only_BBoxes":
    m = augment.translate_matrix(signed(level / _MAX_LEVEL * 120.0), zeros)
    shifted = augment.affine_warp(images, m, 128.0)
    return (torch.where(_boxes_mask(images, boxes, classes), shifted, images),
            boxes, classes)
  if name == "Equalize":
    return augment.equalize(images), boxes, classes
  if name == "AutoContrast":
    return augment.autocontrast(images), boxes, classes
  if name == "Solarize":
    return (augment.solarize(images, 256.0 - level / _MAX_LEVEL * 256.0),
            boxes, classes)
  if name == "Posterize":
    bits = max(int(round(level / _MAX_LEVEL * 4.0)), 1)
    return augment.posterize(images, bits), boxes, classes
  if name == "Cutout":
    pad = int(level / _MAX_LEVEL * 100.0)
    return augment.cutout(images, centre, pad), boxes, classes
  if name == "BBox_Cutout":
    cut = augment.cutout(images, centre, int(level / _MAX_LEVEL * 50.0))
    return (torch.where(_boxes_mask(images, boxes, classes), cut, images),
            boxes, classes)
  if name == "SolarizeAdd":
    return (augment.solarize_add(images, level / _MAX_LEVEL * 110.0), boxes,
            classes)
  factor = level / _MAX_LEVEL * 1.8 + 0.1
  fn = {"Color": augment.color, "Sharpness": augment.sharpness,
        "Contrast": augment.contrast,
        "Brightness": augment.brightness}.get(name)
  if fn is None:
    raise ValueError(f"Unknown det-autoaugment op {name!r}")
  return fn(images, factor), boxes, classes


def autoaugment_draws(b: int, policy_name: str, h: int, w: int, generator,
                      device=None) -> dict:
  """Per image: the sub-policy [B] (uniform over the policy's), and per op
  slot [B, MAX_OPS] the Bernoulli's uniform in [0, 1), the sign (Bernoulli
  0.5) and the cutout centre [B, MAX_OPS, 2] (uniform over the rows and
  columns)."""
  n = len(_policy(policy_name))
  u = torch.rand((b, 1 + 4 * MAX_OPS), generator=generator,
                 device=generator.device)
  slots = u[:, 1:].view(b, MAX_OPS, 4)
  size = torch.tensor([h, w], dtype=torch.float32, device=u.device)
  centre = torch.minimum(torch.floor(slots[..., 2:] * size), size - 1).long()
  return {"sub": torch.floor(u[:, 0] * n).long().clamp_max(n - 1).to(device),
          "u": slots[..., 0].to(device), "sign": (slots[..., 1] < 0.5).to(
              device), "centre": centre.to(device)}


def distort(images, boxes, classes, draws: dict, policy_name: str = "v0"):
  """One sub-policy per image (draws["sub"]) on images [B, H, W, C] in
  [0, 255], boxes [B, G, 4] absolute, classes [B, G] (padding <= 0).
  Returns (images f32, boxes, classes)."""
  images = images.to(torch.float32)
  boxes = boxes.to(torch.float32)
  out = (images, boxes, classes)
  for s, sub_policy in enumerate(_policy(policy_name)):
    img, bx, cl = images, boxes, classes
    for j, (name, prob, level) in enumerate(sub_policy):
      if prob <= 0.0:
        continue
      new = apply_op(name, float(level), img, bx, cl, draws["sign"][:, j],
                     draws["centre"][:, j])
      do = draws["u"][:, j] < torch.tensor(prob, dtype=torch.float32,
                                           device=images.device)
      img, bx, cl = (torch.where(do.view((-1,) + (1,) * (t.ndim - 1)), n, t)
                     for n, t in zip(new, (img, bx, cl)))
    pick = draws["sub"] == s
    out = tuple(torch.where(pick.view((-1,) + (1,) * (t.ndim - 1)), n, t)
                for n, t in zip((img, bx, cl), out))
  return out
