"""Core vision layers: conv / depthwise / dense / batch norm / SE / pools.

The counterpart of automl_tpu/nn/layers.py. Tensors are NCHW, kept in the
channels_last memory format (physically NHWC, what cuDNN's NHWC convs
take); conv kernels are OIHW, depthwise kernels [C, 1, k, k] and dense
kernels [out, in]. The converter (convert.py) owns the transposes from the
JAX package's NHWC / HWIO layout. Every layer follows the active
mixed-precision policy (nn/precision.py): convs, matmuls and activations in
the compute dtype, parameters and normalization statistics in float32.

Parameter and buffer names are the JAX tree's leaf names (kernel, bias,
gamma, beta, moving_mean, moving_variance), and each child module is
registered under its JAX name, so a state_dict key is the JAX path with '.'
for '/' (stacked leaves aside: convert.py).

BatchNorm statistics, as in JAX, are not updated by the forward pass: in
training a BatchNorm keeps its new moving statistics as a pending update,
which the train step takes (take_bn_updates) and writes after the optimizer
step (apply_bn_updates), the order of automl_tpu/train/train_lib.py.

GroupNorm ("gn") holds no moving statistics: take_bn_updates skips it.
ConvTranspose2D (the segmentation head's upsampling) keeps its kernel as
[I, O, kh, kw], flipped against JAX's HWIO (convert.py).

QAT (nn/quant.py): with the mode on, Conv2D, DepthwiseConv2D (with the K6
knob on or off) and Dense fake-quantize their kernel per output channel
and their output per tensor, where JAX's layers do; SeparableConv2D
through its two children; ConvTranspose2D and the norms never.

Randomness (drop_connect, dropout) comes from a torch.Generator the caller
passes in. Initializers draw numpy arrays in the JAX layout
(convert.det_numpy_init carries them across).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

from automl_tpu_torch.nn import quant
from automl_tpu_torch.nn.precision import get_policy
from automl_tpu_torch.ops import depthwise
from automl_tpu_torch.parallel import comm, spatial

# ---------------------------------------------------------------------------
# Activations.
# ---------------------------------------------------------------------------


def srelu(x):
  """Smooth ReLU: log(1 + e^x)."""
  return torch.log1p(torch.exp(x))


ACTIVATIONS: dict = {
    "swish": F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "hswish": F.hardswish,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "srelu": srelu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "identity": lambda x: x,
    None: lambda x: x,
}


def activation_fn(name) -> Callable:
  if callable(name):
    return name
  if name not in ACTIVATIONS:
    raise ValueError(f"Unknown activation {name!r}")
  return ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# Initializers: (numpy Generator, JAX-layout shape) -> float32 array.
# ---------------------------------------------------------------------------


def conv_kernel_init(rng, shape):
  """Fan-out normal: N(0, sqrt(2 / (kh*kw*out_ch))). HWIO shape."""
  kh, kw, _, out_ch = shape
  return (math.sqrt(2.0 / (kh * kw * out_ch))
          * rng.standard_normal(shape)).astype(np.float32)


def depthwise_kernel_init(rng, shape):
  """Depthwise fan-out: N(0, sqrt(2 / (kh*kw)))."""
  kh, kw, _, _ = shape
  return (math.sqrt(2.0 / (kh * kw))
          * rng.standard_normal(shape)).astype(np.float32)


def dense_kernel_init(rng, shape):
  """Uniform(+-1/sqrt(fan_in)), [in, out] shape."""
  r = 1.0 / math.sqrt(shape[0])
  return rng.uniform(-r, r, shape).astype(np.float32)


def truncated_normal(rng, shape, lo=-2.0, hi=2.0):
  """Standard normal redrawn until inside [lo, hi]."""
  out = rng.standard_normal(shape)
  bad = (out < lo) | (out > hi)
  while bad.any():
    out[bad] = rng.standard_normal(int(bad.sum()))
    bad = (out < lo) | (out > hi)
  return out


# ---------------------------------------------------------------------------
# Conv / Dense.
# ---------------------------------------------------------------------------


def _pair(v):
  return (v, v) if isinstance(v, int) else tuple(v)


def _bias(b, like):
  return b.to(like.dtype).view(1, -1, *([1] * (like.ndim - 2)))


class Conv2D(tnn.Module):
  """NCHW conv, OIHW kernel, TF SAME padding by default (explicit pads,
  asymmetric at stride 2); on a band of a spatially split map (vm:
  parallel/spatial.py attach), with its halo rows."""

  vm = None

  def __init__(self, in_ch: int, out_ch: int, kernel_size=3, strides=1,
               padding="SAME", use_bias=False, groups: int = 1,
               kernel_init=conv_kernel_init, bias_init_value: float = 0.0,
               device=None):
    super().__init__()
    self.in_ch, self.out_ch = in_ch, out_ch
    self.kernel_size = _pair(kernel_size)
    self.strides = _pair(strides)
    self.padding = padding
    self.groups = groups
    self.kernel_init = kernel_init
    self.bias_init_value = bias_init_value
    kh, kw = self.kernel_size
    self.kernel = tnn.Parameter(torch.empty(
        (out_ch, in_ch // groups, kh, kw), device=device))
    self.bias = (tnn.Parameter(torch.full((out_ch,), float(bias_init_value),
                                          device=device))
                 if use_bias else None)

  def jax_kernel_shape(self):
    kh, kw = self.kernel_size
    return (kh, kw, self.in_ch // self.groups, self.out_ch)

  def _conv(self, x, kernel, padding):
    return depthwise.conv2d_same(x, kernel, self.strides, padding,
                                 self.groups)

  def forward(self, x):
    policy = get_policy()
    x = policy.cast_to_compute(x)
    kernel = quant.maybe_quant_kernel(self.kernel).to(policy.compute_dtype)
    x, padding = spatial.same_window(self.vm, x, self.kernel_size,
                                     self.strides, self.padding)
    y = self._conv(x, kernel, padding)
    if self.bias is not None:
      y = y + _bias(self.bias, y)
    return quant.maybe_quant_activation(y)


class DepthwiseConv2D(Conv2D):
  """Depthwise conv: groups == channels, kernel [C, 1, k, k].

  With the K6 knob off (the default, as in JAX) this is a plain F.conv2d,
  with no autograd function around it (automl_tpu/nn/layers.py:165-170);
  with it on, ops/depthwise.depthwise_conv, whose filter gradient is K6."""

  def __init__(self, channels: int, kernel_size=3, strides=1, padding="SAME",
               use_bias=False, device=None):
    super().__init__(channels, channels, kernel_size, strides, padding,
                     use_bias, groups=channels,
                     kernel_init=depthwise_kernel_init, device=device)

  def _conv(self, x, kernel, padding):
    if not depthwise.pallas_filter_grad_enabled():
      return super()._conv(x, kernel, padding)
    return depthwise.depthwise_conv(x, kernel, self.strides, padding)


class SeparableConv2D(tnn.Module):
  """Depthwise + pointwise; the pointwise conv holds the bias."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size=3, strides=1,
               use_bias=True, bias_init_value: float = 0.0, device=None):
    super().__init__()
    self.depthwise = DepthwiseConv2D(in_ch, kernel_size, strides,
                                     device=device)
    self.pointwise = Conv2D(in_ch, out_ch, 1, 1, use_bias=use_bias,
                            bias_init_value=bias_init_value, device=device)

  def forward(self, x):
    return self.pointwise(self.depthwise(x))


class Dense(tnn.Module):
  """y = x W^T + b with W [out, in] (JAX: [in, out])."""

  def __init__(self, in_dim: int, out_dim: int, use_bias=True,
               kernel_init=dense_kernel_init, device=None):
    super().__init__()
    self.in_dim, self.out_dim = in_dim, out_dim
    self.kernel_init = kernel_init
    self.kernel = tnn.Parameter(torch.empty((out_dim, in_dim), device=device))
    self.bias = (tnn.Parameter(torch.zeros((out_dim,), device=device))
                 if use_bias else None)

  def forward(self, x):
    policy = get_policy()
    y = F.linear(policy.cast_to_compute(x),
                 quant.maybe_quant_kernel(self.kernel).to(
                     policy.compute_dtype))
    if self.bias is not None:
      y = y + self.bias.to(y.dtype)
    return quant.maybe_quant_activation(y)


def conv_transpose_pads(k: int, s: int) -> tuple[int, int]:
  """lax.conv_transpose's SAME padding (before, after) of the dilated input
  for kernel size k and stride s (jax.lax's _conv_transpose_padding)."""
  pad_len = k + s - 2
  pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
  return pad_a, pad_len - pad_a


class ConvTranspose2D(tnn.Module):
  """NCHW transposed conv with lax.conv_transpose's SAME semantics
  (transpose_kernel=False): the output is H * s by W * s. The kernel is
  [I, O, kh, kw], JAX's HWIO kernel flipped in both spatial dims and
  permuted (convert.py), so F.conv_transpose2d's full output (padding 0)
  holds JAX's result from row and column k - 1 - pad_before on.
  No QAT hook, as in JAX."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size=3, strides=2,
               use_bias=True, device=None):
    super().__init__()
    self.in_ch, self.out_ch = in_ch, out_ch
    self.kernel_size = _pair(kernel_size)
    self.strides = _pair(strides)
    self.kernel_init = conv_kernel_init
    self.bias_init_value = 0.0
    kh, kw = self.kernel_size
    self.kernel = tnn.Parameter(torch.empty((in_ch, out_ch, kh, kw),
                                            device=device))
    self.bias = (tnn.Parameter(torch.zeros((out_ch,), device=device))
                 if use_bias else None)

  def jax_kernel_shape(self):
    kh, kw = self.kernel_size
    return (kh, kw, self.in_ch, self.out_ch)

  def forward(self, x):
    policy = get_policy()
    x = policy.cast_to_compute(x)
    h, w = x.shape[2], x.shape[3]
    starts, extra = [], []
    for size, k, s in zip((h, w), self.kernel_size, self.strides):
      start = k - 1 - conv_transpose_pads(k, s)[0]
      starts.append(start)
      # torch's full output is (size - 1) * s + k; JAX's reaches
      # start + size * s (past it only when s > k).
      extra.append(max(start + size * s - ((size - 1) * s + k), 0))
    y = F.conv_transpose2d(x, self.kernel.to(policy.compute_dtype),
                           stride=self.strides, output_padding=tuple(extra))
    (sh, sw), (th, tw) = self.strides, starts
    y = y[:, :, th:th + h * sh, tw:tw + w * sw]
    if self.bias is not None:
      y = y + _bias(self.bias, y)
    return y


# ---------------------------------------------------------------------------
# Batch normalization.
# ---------------------------------------------------------------------------


class BatchNorm(tnn.Module):
  """BN over (N, H, W) with f32 statistics and compute-dtype in/out.

  Training uses the batch moments in f32, the biased variance
  max(mean(x^2) - mean^2, 0), and keeps the new moving statistics
  m * old + (1 - m) * batch as `pending_update` (not written to the
  buffers: see the module docstring). The normalize is folded, in the
  compute dtype: x * inv + (beta - mean * inv), inv = rsqrt(var + eps) *
  gamma computed in f32 (automl_tpu/nn/layers.py:326-346).

  Cross-replica moments: with `axis_name` (a mesh axis of `mesh`) the
  mean and the mean of squares are averaged over the ranks of that axis;
  with `group_size` as well, the [n, C] pair is all-gathered and each rank
  averages its group's slice (JAX's axis_name / group_size under
  shard_map). Without them, a vision mesh (vm: parallel/spatial.py
  attach) averages them over every axis that holds a distinct part of the
  batch or the map, as GSPMD's global moments."""

  vm = None

  def __init__(self, channels: int, momentum=0.99, epsilon=1e-3,
               gamma_init_value: float = 1.0, device=None,
               axis_name: str | None = None, group_size: int | None = None,
               mesh=None):
    super().__init__()
    self.channels = channels
    self.momentum = momentum
    self.epsilon = epsilon
    self.gamma_init_value = gamma_init_value
    self.axis_name, self.group_size, self.mesh = axis_name, group_size, mesh
    self.gamma = tnn.Parameter(torch.full((channels,), float(gamma_init_value),
                                          device=device))
    self.beta = tnn.Parameter(torch.zeros((channels,), device=device))
    self.register_buffer("moving_mean", torch.zeros((channels,),
                                                    device=device))
    self.register_buffer("moving_variance", torch.ones((channels,),
                                                       device=device))
    self.pending_update = None

  def forward(self, x, train: bool = False):
    if train:
      mean, var = self._moments(x)
      m = self.momentum
      with torch.no_grad():
        self.pending_update = (m * self.moving_mean + (1 - m) * mean.detach(),
                               m * self.moving_variance + (1 - m) *
                               var.detach())
    else:
      mean, var = self.moving_mean, self.moving_variance
    inv = torch.rsqrt(var + self.epsilon) * self.gamma
    offset = self.beta - mean * inv
    y = x * _bias(inv, x) + _bias(offset, x)
    return get_policy().cast_to_compute(y)

  def _moments(self, x):
    xf = x.float()
    dims = (0,) + tuple(range(2, x.ndim))
    mean, mean_sq = xf.mean(dims), (xf * xf).mean(dims)
    if self.axis_name is not None:
      if self.group_size is not None:
        # Each rank's loss meets every group member's moments: the
        # gathered pair's gradient is summed over the axis, then cut.
        pair = comm.copy_to_axis(comm.gather_dim(
            torch.stack([mean, mean_sq])[None], self.mesh, self.axis_name,
            0), self.mesh, self.axis_name)
        start = (self.mesh.get_local_rank(self.axis_name) // self.group_size
                 * self.group_size)
        mean, mean_sq = pair[start:start + self.group_size].mean(0)
      else:
        mean, mean_sq = comm.mean_over(torch.stack([mean, mean_sq]),
                                       self.mesh, (self.axis_name,))
    elif self.vm is not None:
      mean, mean_sq = comm.mean_over(torch.stack([mean, mean_sq]),
                                     self.vm.mesh, self.vm.stat_axes(x))
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


class GroupNorm(tnn.Module):
  """GroupNorm over (H, W, the channels of a group), contiguous groups of
  C // groups channels. Statistics in f32: the mean, then the mean of the
  squared deviations (jnp.var's order, not F.group_norm's); gamma and beta
  f32; the output in the compute dtype. No moving statistics: `train` is
  ignored (automl_tpu/nn/layers.py:349-373)."""

  vm = None    # parallel/spatial.py attach

  def __init__(self, channels: int, groups: int = 8, epsilon=1e-3,
               device=None):
    super().__init__()
    self.channels, self.groups, self.epsilon = channels, groups, epsilon
    self.gamma = tnn.Parameter(torch.ones((channels,), device=device))
    self.beta = tnn.Parameter(torch.zeros((channels,), device=device))

  def forward(self, x, train: bool = False):
    del train
    b, c, h, w = x.shape
    g = self.groups
    if c % g:
      raise ValueError(f"GroupNorm: {c} channels are not a multiple of "
                       f"{g} groups")
    # NHWC view (free for channels_last), groups on the last axis.
    xg = x.float().permute(0, 2, 3, 1).reshape(b, h, w, g, c // g)
    # On a band of a spatially split map, the moments of the whole map.
    vm = self.vm
    over = (lambda v: comm.mean_over(v, vm.mesh, ("model",))) if (
        vm is not None and vm.is_band(x)) else (lambda v: v)
    mean = over(xg.mean((1, 2, 4), keepdim=True))
    var = over((xg - mean).square().mean((1, 2, 4), keepdim=True))
    xg = (xg - mean) * torch.rsqrt(var + self.epsilon)
    y = xg.reshape(b, h, w, c) * self.gamma + self.beta
    return get_policy().cast_to_compute(y.permute(0, 3, 1, 2))


def take_bn_updates(model: tnn.Module) -> dict:
  """{BatchNorm: (moving_mean, moving_variance)} of every BN's pending
  update from the last training forward; the pending updates are
  cleared."""
  out = {}
  for mod in model.modules():
    if isinstance(mod, BatchNorm) and mod.pending_update is not None:
      out[mod] = mod.pending_update
      mod.pending_update = None
  return out


@torch.no_grad()
def apply_bn_updates(updates: dict) -> None:
  for bn, (mean, var) in updates.items():
    bn.moving_mean.copy_(mean)
    bn.moving_variance.copy_(var)


def build_norm(channels: int, norm_type: str = "bn", momentum=0.99,
               epsilon=1e-3, gamma_init_value: float = 1.0, device=None):
  """Norm selector: "bn" / "syncbn" / "tpu_bn" -> BatchNorm (on a vision
  mesh its moments are global; BatchNorm's axis_name / group_size give
  grouped cross-replica moments); "gn" -> GroupNorm (8 groups; momentum
  and gamma_init_value unused, as in JAX)."""
  if norm_type in ("bn", "syncbn", "tpu_bn"):
    return BatchNorm(channels, momentum, epsilon, gamma_init_value,
                     device=device)
  if norm_type == "gn":
    return GroupNorm(channels, epsilon=epsilon, device=device)
  raise ValueError(f"Unknown norm type {norm_type!r}")


# ---------------------------------------------------------------------------
# Stochastic regularizers.
# ---------------------------------------------------------------------------


def _uniform(shape, generator, device):
  if generator is None:
    raise RuntimeError("a stochastic layer in training needs a "
                       "torch.Generator (generator=...)")
  return torch.rand(shape, generator=generator,
                    device=generator.device).to(device)


def apply_drop_connect(x, keep, survival_prob: float):
  """where(keep, x / survival_prob, 0) with keep broadcast per example."""
  return torch.where(keep, x / survival_prob, torch.zeros_like(x))


def drop_connect(x, train: bool, survival_prob, generator=None):
  """Stochastic depth on the residual branch: each example's branch is kept
  with probability survival_prob (a uniform draw below it) and scaled by
  1 / survival_prob."""
  if not train or survival_prob is None or survival_prob >= 1.0:
    return x
  shape = (x.shape[0],) + (1,) * (x.ndim - 1)
  keep = _uniform(shape, generator, x.device) < survival_prob
  return apply_drop_connect(x, keep, survival_prob)


def dropout(x, train: bool, rate: float, generator=None):
  if not train or rate <= 0.0:
    return x
  keep = 1.0 - rate
  mask = _uniform(x.shape, generator, x.device) < keep
  return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Squeeze-and-excitation.
# ---------------------------------------------------------------------------


class SqueezeExcite(tnn.Module):
  """Global pool -> reduce 1x1 -> act -> expand 1x1 -> sigmoid gate."""

  vm = None    # parallel/spatial.py attach

  def __init__(self, channels: int, reduced_ch: int, act="swish",
               device=None):
    super().__init__()
    self.reduce = Conv2D(channels, reduced_ch, 1, use_bias=True, device=device)
    self.expand = Conv2D(reduced_ch, channels, 1, use_bias=True, device=device)
    self.act = activation_fn(act)

  def forward(self, x):
    pooled = spatial.spatial_mean(self.vm, x)
    gate = torch.sigmoid(self.expand(self.act(self.reduce(pooled))))
    return x * gate


# ---------------------------------------------------------------------------
# Pooling / resize.
# ---------------------------------------------------------------------------


def _pool_pads(x, window, strides, padding, fill, vm):
  """(x, F.pad pads) of a pool; on a band of a spatially split map (vm),
  the band with its halo rows (fill past the image) and the W pads."""
  x, padding = spatial.same_window(vm, x, (window, window),
                                   (strides, strides), padding, fill)
  if padding == "VALID":
    return x, None
  (pt, pb), (pl, pr) = depthwise.conv_pads(
      x.shape[2:], (window, window), (strides, strides), padding)
  return x, (pl, pr, pt, pb)


def max_pool(x, window: int, strides: int, padding="SAME", vm=None):
  """Max pool; SAME pads with -inf (lax.reduce_window's init). vm: the
  VisionMesh of a spatially split map, if any."""
  x, pads = _pool_pads(x, window, strides, padding, float("-inf"), vm)
  if pads is not None:
    x = F.pad(x, pads, value=float("-inf"))
  return F.max_pool2d(x, window, strides)


def avg_pool(x, window: int, strides: int, padding="SAME", vm=None):
  """Average pool; the SAME padding does not count in the divisor (on a
  band, the neighbours' halo rows do)."""
  ones = torch.ones_like(x[:1, :1])
  band = x.shape[2]
  x, pads = _pool_pads(x, window, strides, padding, 0.0, vm)
  if x.shape[2] != band:
    ones = (torch.ones_like(x[:1, :1]) if x.shape[2] == band * vm.m
            else _pool_pads(ones, window, strides, padding, 0.0, vm)[0])
  if pads is not None:
    x, ones = F.pad(x, pads), F.pad(ones, pads)
  summed = F.avg_pool2d(x, window, strides, divisor_override=1)
  counts = F.avg_pool2d(ones, window, strides, divisor_override=1)
  return summed / counts


def resize_nearest(x, target_hw: Sequence[int], vm=None):
  """Nearest-neighbour upsample (BiFPN top-down path): integer factors
  repeat rows and columns, as jnp.repeat; others sample the nearest source
  pixel centre (jax.image.resize 'nearest'). vm: the VisionMesh of a
  spatially split map, if any."""
  h, w = x.shape[2], x.shape[3]
  th, tw = target_hw
  if vm is not None and vm.is_band(x):
    # target_hw is the whole map's: a band repeats to a band where the
    # factors are integers, else it is gathered whole first.
    hg = h * vm.m
    if th % hg == 0 and tw % w == 0:
      return x.repeat_interleave(th // hg, dim=2).repeat_interleave(
          tw // w, dim=3)
    x = vm.to_whole(x)
    h = hg
  if (th, tw) == (h, w):
    return x
  if th % h == 0 and tw % w == 0:
    return x.repeat_interleave(th // h, dim=2).repeat_interleave(tw // w,
                                                                 dim=3)
  return F.interpolate(x, size=(th, tw), mode="nearest-exact")
