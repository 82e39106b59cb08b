"""The mesh a vision model runs on: data parallelism and spatial
partitioning.

The counterpart of what GSPMD does for automl_tpu's detection and
classification runners on a mesh: the batch split over ('replica',
'data'), and, for detection on a 'model' axis above 1, image H split over
'model' (automl_tpu/train/runners.py). Here the split is explicit. A model takes
its VisionMesh with `attach` (the runners attach theirs to the model they
build), and its layers read it:

  * BatchNorm's moments are means over every axis that holds a distinct
    part of the batch or of the map (`stat_axes`); GroupNorm's and the
    squeeze-excite pool's over 'model' where the map is split;
  * a conv, depthwise conv or pool over a band of rows takes its halo rows
    from the neighbouring bands (`same_window`; `halo`, point-to-point
    sends whose backward sends the halo's gradient back) and runs VALID in
    H and SAME in W; only the image's own top and bottom bands see TF
    SAME's zero (or -inf) padding, asymmetric at stride 2.

Which maps are bands is decided here alone (`VisionMesh.is_band`): a map
is a band when its rows are 1 / m of its level's rows (the level follows
from the map's width, which is never split); whole images are cut into
bands by `split`, and a map that reaches a layer whole stays whole. The rule for maps too
short to split: where a conv or pool's output rows do not divide evenly
over the m bands, or a band is shorter than its halo, the input is
gathered (`to_whole`) and the map is computed whole on every rank of
'model' from there on; where a whole map meets banded ones (BiFPN's
fusion, the losses) it is cut to this rank's rows (`to_band`, uneven cuts
allowed). Gradients: a band holds the gradient of its rows; a whole map
holds on each rank a part of its gradient, the parts summing over 'model'
to the whole (a cut's backward is a plain slice, a gather's a sum over
'model' then this rank's slice). So every parameter's gradient is the sum
of the ranks' over the data axes and 'model', and BatchNorm over a whole
map does not count 'model' again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from automl_tpu_torch.ops.depthwise import conv_pads
from automl_tpu_torch.parallel import comm
from automl_tpu_torch.parallel.mesh import axis_size


def attach(model, vm):
  """Binds `vm` (a VisionMesh, or None to unbind) to every layer of
  `model` that reads one (each class that declares a `vm` attribute: the
  convs, norms, pools, resamplers and fusions); returns model."""
  for m in model.modules():
    if hasattr(type(m), "vm"):
      m.vm = vm
  return model


def _exchange(x, group, ranks, r, m, top: int, bottom: int, fill):
  """(rows above, rows below): the last `top` rows of band r - 1 and the
  first `bottom` rows of band r + 1, `fill` past the image's edges."""
  shape = list(x.shape)
  up = x.new_full(shape[:2] + [top] + shape[3:], fill)
  down = x.new_full(shape[:2] + [bottom] + shape[3:], fill)
  ops = []
  if top and r + 1 < m:
    ops.append(dist.P2POp(dist.isend, x[:, :, -top:].contiguous(),
                          ranks[r + 1], group))
  if top and r > 0:
    ops.append(dist.P2POp(dist.irecv, up, ranks[r - 1], group))
  if bottom and r > 0:
    ops.append(dist.P2POp(dist.isend, x[:, :, :bottom].contiguous(),
                          ranks[r - 1], group))
  if bottom and r + 1 < m:
    ops.append(dist.P2POp(dist.irecv, down, ranks[r + 1], group))
  if ops:
    for req in dist.batch_isend_irecv(ops):
      req.wait()
  return up, down


class _Halo(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, vm, top, bottom, fill):
    ctx.args = (vm, top, bottom)
    g = vm.mesh.get_group("model")
    ranks = dist.get_process_group_ranks(g)
    up, down = _exchange(x, g, ranks, vm.rank, vm.m, top, bottom, fill)
    return torch.cat([up, x, down], dim=2)

  @staticmethod
  def backward(ctx, gy):
    vm, top, bottom = ctx.args
    g = vm.mesh.get_group("model")
    ranks = dist.get_process_group_ranks(g)
    r, m = vm.rank, vm.m
    hb = gy.shape[2] - top - bottom
    gx = gy[:, :, top:top + hb].contiguous().clone()
    # The halo rows' gradients go back to the bands they came from: this
    # rank's top halo to band r - 1's last rows, its bottom halo to band
    # r + 1's first rows.
    g_up, g_down = gy[:, :, :top].contiguous(), gy[:, :, top + hb:].contiguous()
    from_below = gx.new_zeros(gx.shape[:2] + (top,) + gx.shape[3:])
    from_above = gx.new_zeros(gx.shape[:2] + (bottom,) + gx.shape[3:])
    ops = []
    if top and r > 0:
      ops.append(dist.P2POp(dist.isend, g_up, ranks[r - 1], g))
    if top and r + 1 < m:
      ops.append(dist.P2POp(dist.irecv, from_below, ranks[r + 1], g))
    if bottom and r + 1 < m:
      ops.append(dist.P2POp(dist.isend, g_down, ranks[r + 1], g))
    if bottom and r > 0:
      ops.append(dist.P2POp(dist.irecv, from_above, ranks[r - 1], g))
    if ops:
      for req in dist.batch_isend_irecv(ops):
        req.wait()
    if top and r + 1 < m:
      gx[:, :, hb - top:] += from_below
    if bottom and r > 0:
      gx[:, :, :bottom] += from_above
    return gx, None, None, None, None


class VisionMesh:
  """A mesh for a vision model: the batch over ('replica', 'data'); with
  spatial=True, image H over 'model' (image_hw: the model's input size)."""

  def __init__(self, mesh, image_hw=None, spatial: bool = False):
    self.mesh = mesh
    self.batch_axes = tuple(a for a in ("replica", "data")
                            if axis_size(mesh, a) > 1)
    self.m = axis_size(mesh, "model") if spatial else 1
    self.rank = mesh.get_local_rank("model") if self.m > 1 else 0
    self.image_hw = tuple(image_hw) if image_hw is not None else None

  def __deepcopy__(self, memo):
    return self      # a copy of the model shares the mesh

  @property
  def spatial(self) -> bool:
    return self.m > 1

  def level_h(self, w: int):
    """The rows of the level whose maps are w wide (None where no level
    is)."""
    hi, wi = self.image_hw
    for lvl in range(32):
      if -(-wi // 2 ** lvl) == w:
        return -(-hi // 2 ** lvl)
      if 2 ** lvl > wi:
        return None
    return None

  def global_h(self, x) -> int:
    """The rows of the whole map of which x is this rank's part."""
    return x.shape[2] * self.m if self.is_band(x) else x.shape[2]

  def is_band(self, x) -> bool:
    """Is x [B, C, h, w] this rank's band of rows of its level's map?"""
    if self.m == 1 or x.ndim != 4:
      return False
    h = self.level_h(x.shape[3])
    return h is not None and h != x.shape[2] and x.shape[2] * self.m == h

  def stat_axes(self, x) -> tuple:
    """The axes whose ranks hold distinct parts of x's batch or map."""
    return self.batch_axes + (("model",) if self.is_band(x) else ())

  def to_whole(self, x):
    """A band -> the whole map, the same on every rank of 'model'."""
    if not self.is_band(x):
      return x
    return comm.copy_to_axis(comm.gather_dim(x, self.mesh, "model", 2),
                             self.mesh, "model")

  def rows(self, h: int) -> tuple:
    """This rank's rows [lo, hi) of a map of h rows (uneven allowed)."""
    return self.rank * h // self.m, (self.rank + 1) * h // self.m

  def to_band(self, x):
    """A whole map -> this rank's rows of it (a band as they are)."""
    if self.m == 1 or self.is_band(x):
      return x
    lo, hi = self.rows(x.shape[2])
    return x[:, :, lo:hi]

  def split(self, x):
    """A whole image batch -> this rank's band of rows where its rows
    divide evenly over the bands; whole otherwise."""
    if self.m == 1 or x.shape[2] % self.m:
      return x
    return self.to_band(x)

  def conv_halo(self, x, k: int, s: int):
    """(top, bottom) halo rows of a SAME k x k window at stride s over the
    band x, or None where its output does not split evenly over the bands
    (or a halo is longer than a band): the caller gathers x whole."""
    hb = x.shape[2]
    h = hb * self.m
    lo = max((-(-h // s) - 1) * s + k - h, 0) // 2
    top, bottom = lo, k - s - lo
    if (h % s or (h // s) % self.m or bottom < 0 or top > hb
        or bottom > hb):
      return None
    return top, bottom

  def halo(self, x, top: int, bottom: int, fill=0.0):
    """The band x with `top` rows of the band above and `bottom` of the
    band below (fill past the image's top and bottom)."""
    if not top and not bottom:
      return x
    return _Halo.apply(x, self, top, bottom, fill)


def same_window(vm, x, k_hw, strides, padding, fill=0.0):
  """(x, padding) of a SAME window op (conv, depthwise conv, pool) on a
  mesh `vm` where x is this rank's band of rows: the band with its halo
  rows (`fill` past the image), VALID in H and SAME in W as explicit pads;
  or the map gathered whole where the op's output does not split over the
  bands. Otherwise as given."""
  if vm is None or padding != "SAME" or not vm.is_band(x):
    return x, padding
  plan = vm.conv_halo(x, k_hw[0], strides[0])
  if plan is None:
    return vm.to_whole(x), padding
  _, w_pads = conv_pads(x.shape[2:], k_hw, strides, "SAME")
  return vm.halo(x, plan[0], plan[1], fill), ((0, 0), w_pads)


def spatial_mean(vm, x):
  """x.mean((2, 3), keepdim=True) of the whole map where x is a band."""
  y = x.mean((2, 3), keepdim=True)
  if vm is not None and vm.is_band(x):
    y = comm.mean_over(y, vm.mesh, ("model",))
  return y
