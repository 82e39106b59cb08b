"""Depthwise convolution whose filter gradient is a hand-written CUDA kernel.

The counterpart of automl_tpu/ops/depthwise.py. The filter gradient of a
SAME-padded, stride-1 depthwise conv,

  dW[c, 0, kh, kw] = sum_{b,i,j} xpad[b, c, i+kh, j+kw] * dy[b, c, i, j],

summed in f32 over every image, is K6 (replaces _filter_grad_kernel, launched
by depthwise_filter_grad there). Its interface: x and dy [B, C, H, W] (dy
has x's shape at stride 1) in float32 or bfloat16, both in the
channels_last memory format (physically NHWC) and of one dtype; the result
is float32 [C, 1, k, k], the port's depthwise weight layout (the TPU kernel
took NHWC and returned [k, k, 1, C]). Odd k from 1 to 7. It has two
implementations: bf16 with C a multiple of 8 (every depthwise conv of
EfficientDet-D0) goes to the Hopper kernel of csrc/depthwise_sm90.cu (x and
dy tiles staged by TMA, whose zero fill makes the SAME halo; a tile shape
per map size from `sm90_plan`; one launch a call, the blocks' parts summed
in a cluster or by the last block of each channel chunk); float32 and
other C go to
csrc/depthwise.cu. `takes_sm90` says which a call takes;
`depthwise_filter_grad_kernel(..., _simt=True)` forces csrc/depthwise.cu's
kernel (comparisons only).

`depthwise_filter_grad` dispatches on the device of x: CUDA tensors go to
the kernels, which raise if they cannot be built or launched, CPU tensors
to depthwise_filter_grad_reference, a per-tap multiply-reduce in f32. There
is no fallback from the one to the other. `depthwise_filter_grad.launches`
counts kernel launches (either implementation), `.launches_sm90` those of
the Hopper kernel.

`depthwise_conv` is the autograd function around it: the forward is
F.conv2d(groups=C) with explicit TF SAME pads, dx is the library's input
gradient (cuDNN), and dW is K6 when the knob is on, the stride is 1, the
kernel square and the padding SAME; otherwise it is the library's weight
gradient, as _dw_bwd leaves it to XLA. The knob keeps the JAX names
(enable_pallas_filter_grad / pallas_filter_grad_enabled) and is off by
default, as in JAX; with it off DepthwiseConv2D calls F.conv2d with no
autograd function around it. The TPU-only VMEM gate of JAX's _use_pallas
(a per-image byte limit) has no counterpart: the CUDA kernel tiles any
image size. The shift-and-add forward (set_forward_impl("shift")) is not
ported (ROADMAP, "Leave out").
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZES = (1, 3, 5, 7)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
  """TF SAME padding (lo, hi) for one spatial dim (asymmetric at stride 2)."""
  out = -(-size // stride)  # ceil
  total = max((out - 1) * stride + k - size, 0)
  lo = total // 2
  return lo, total - lo


def conv_pads(x_hw, k_hw, strides, padding):
  """((top, bottom), (left, right)) pads of a SAME or VALID conv."""
  if padding == "SAME":
    return tuple(_same_pads(s, k, st) for s, k, st in zip(x_hw, k_hw, strides))
  if padding == "VALID":
    return (0, 0), (0, 0)
  raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def _pad_for_conv(x, pads):
  """(input, conv padding): symmetric pads go to the conv itself, others
  are applied with F.pad first."""
  (pt, pb), (pl, pr) = pads
  if pt == pb and pl == pr:
    return x, (pt, pl)
  return F.pad(x, (pl, pr, pt, pb)), (0, 0)


def conv2d_same(x, kernel, strides=(1, 1), padding="SAME", groups=1):
  """F.conv2d (NCHW, OIHW kernel) with TF SAME or VALID padding, the SAME
  pads computed by _same_pads (torch's padding="same" refuses stride 2)."""
  pads = conv_pads(x.shape[2:], kernel.shape[2:], strides, padding)
  xp, conv_pad = _pad_for_conv(x, pads)
  return F.conv2d(xp, kernel, None, strides, conv_pad, 1, groups)


# ---------------------------------------------------------------------------
# The knob (module state, as JAX's: read when a depthwise conv runs).
# ---------------------------------------------------------------------------

_ENABLED = False


def enable_pallas_filter_grad(on: bool = True) -> None:
  """Routes the filter gradient of stride-1 SAME depthwise convs through K6
  (the plain K6 for CPU tensors). Off by default."""
  global _ENABLED
  _ENABLED = bool(on)


def pallas_filter_grad_enabled() -> bool:
  return _ENABLED


# ---------------------------------------------------------------------------
# Plain K6 and the CUDA kernel.
# ---------------------------------------------------------------------------


def depthwise_filter_grad_reference(x, dy, k: int):
  """Plain K6: x, dy [B, C, H, W] -> dW [C, 1, k, k] f32, one multiply-reduce
  per tap."""
  (pt, pb), (pl, pr) = conv_pads(x.shape[2:], (k, k), (1, 1), "SAME")
  xp = F.pad(x.float(), (pl, pr, pt, pb))
  dyf = dy.float()
  h, w = dy.shape[2], dy.shape[3]
  out = torch.empty((x.shape[1], 1, k, k), dtype=torch.float32,
                    device=x.device)
  for kh in range(k):
    for kw in range(k):
      out[:, 0, kh, kw] = (xp[:, :, kh:kh + h, kw:kw + w] * dyf).sum((0, 2, 3))
  return out


@functools.cache
def _kernel_fns():
  """csrc/depthwise.cu's C entry points (filter_grad, parts), built and
  bound at first use."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("depthwise")
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  fn = lib.automl_depthwise_filter_grad
  # x dy partial out | dtype B H W C K parts | stream
  fn.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
  fn.restype = i32
  parts = lib.automl_depthwise_filter_grad_parts
  parts.argtypes = [i32] * 5
  parts.restype = i32
  return fn, parts


@functools.cache
def _sm90_fn():
  """csrc/depthwise_sm90.cu's C entry point, built and bound at first use."""
  from automl_tpu_torch.ops import cuda_build
  fn = cuda_build.load("depthwise_sm90").automl_depthwise_filter_grad_sm90
  # x dy partial out tickets | B H W C K cb nb th tw parts cluster | stream
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


# csrc/depthwise_sm90.cu: 256 threads a block, two ring stages of at most
# 48 KB each (x box and dy box), a dy box of about 16 KB, channel chunks of
# 64, 32, 16 or 8 channels (a thread owns two); one block on each SM (two
# were slower at every D0 map, measured on the H100).
_SM90_STAGE_BYTES = 48 * 1024
_SM90_DY_BYTES = 16 * 1024
_SM90_CHUNKS = (64, 32, 16, 8)
H100_SMS = 132


def takes_sm90(dtype: torch.dtype, c: int) -> bool:
  """Whether K6 on x / dy of this dtype and channel count goes to the Hopper
  kernel (csrc/depthwise_sm90.cu): bf16 with C a multiple of 8, so that a
  pixel's C * 2 bytes are a multiple of 16 (TMA's unit)."""
  return dtype == torch.bfloat16 and c % 8 == 0


class Sm90Plan(NamedTuple):
  """A launch of the Hopper K6: channel chunks of `cb` channels, tiles of
  `nb` images x `th` output rows x `tw` output columns, `parts` blocks per
  chunk in clusters of `cluster`; `chunks` and `tiles` (per chunk) follow
  from them. parts / cluster groups write a part each to the scratch when
  there are more than one."""
  cb: int
  nb: int
  th: int
  tw: int
  parts: int
  cluster: int
  chunks: int
  tiles: int


def _stage_bytes(cb, nb, th, tw, k):
  """A ring stage: the x box (the tile and its halo) and the dy box, each
  128-byte aligned."""
  r128 = lambda n: -(-n // 128) * 128
  return (r128(2 * cb * nb * (th + k - 1) * (tw + k - 1))
          + r128(2 * cb * nb * th * tw))


def _sm90_tile(cb, b, h, w, k):
  """(nb, th, tw): a tile of about a 16 KB dy box whose ring stage fits
  48 KB (see sm90_plan)."""
  pixels = _SM90_DY_BYTES // (2 * cb)
  if h * w <= pixels:
    fits = [n for n in range(1, min(b, pixels // (h * w), 256) + 1)
            if b % n == 0 and _stage_bytes(cb, n, h, w, k) <= _SM90_STAGE_BYTES]
    return max(fits, default=1), h, w
  th = min(h, 8)
  tw = min(w, pixels // th)
  while _stage_bytes(cb, 1, th, tw, k) > _SM90_STAGE_BYTES:
    if th > 1:
      th = -(-th // 2)
    else:
      tw = -(-tw // 2)
  return 1, th, tw


def sm90_plan(b: int, c: int, h: int, w: int, k: int,
              sms: int = H100_SMS) -> Sm90Plan:
  """The Hopper K6's tiles for x / dy [b, c, h, w] and a k x k filter.

  The channel chunk is the widest of 64, 32, 16 that wastes at most 10% of
  its lanes on channels past C and leaves at least 4 chunks (more blocks
  per map, and a smaller sum of parts per chunk: D0's 64-channel maps ran
  1.3-2.3x faster at 16 than at 64 on the H100), else the widest of 64 to
  8 that wastes at most 10%. A tile aims at a 16 KB dy box: on maps that
  small, whole images, several to a tile (BiFPN's 4 x 4 and 8 x 8 levels,
  so that no lane idles); on larger maps, windows of 8 rows and as many
  columns, halved until a stage fits 48 KB. Parts: at most one block on
  each of `sms` SMs, with the tiles dealt out evenly; up to 8 parts form
  one cluster, which sums them in distributed shared memory, more
  (clusters of 1) meet at the ticket. With 8 chunks or more and at most
  128 tiles a chunk (D0's 480- to 1152-channel maps), 8 parts a chunk in
  one cluster (no ticket), the chunks narrowed to 32 channels while their
  blocks fit two to an SM (480 and 672 channels: 1.4-1.7x faster than at
  64 on the H100)."""
  fits = [n for n in _SM90_CHUNKS if -(-c // n) * n <= 1.1 * c]
  cb = next((n for n in fits if n >= 16 and -(-c // n) >= 4), fits[0])

  def layout(cb):
    nb, th, tw = _sm90_tile(cb, b, h, w, k)
    return nb, th, tw, -(-c // cb), -(-b // nb) * -(-h // th) * -(-w // tw)

  nb, th, tw, chunks, tiles = layout(cb)
  if chunks >= 8 and tiles <= 128:
    while cb > 32 and cb // 2 in fits and -(-c // (cb // 2)) * 8 <= 2 * sms:
      cb //= 2
      nb, th, tw, chunks, tiles = layout(cb)
    parts = min(tiles, 8)      # one cluster a chunk: no ticket
  else:
    parts = min(tiles, max(1, sms // chunks))
    parts = -(-tiles // -(-tiles // parts))
  return Sm90Plan(cb, nb, th, tw, parts, parts if parts <= 8 else 1, chunks,
                  tiles)


def sm90_tile_origins(plan: Sm90Plan, b: int, h: int, w: int, part: int):
  """(image, row, column) of the first output of each tile that block
  `part` of a chunk takes, in its order: tiles part, part + parts, ...
  (the kernel's walk)."""
  tiles_h, tiles_w = -(-h // plan.th), -(-w // plan.tw)
  out = []
  for tile in range(part, plan.tiles, plan.parts):
    r = tile % (tiles_h * tiles_w)
    out.append((tile // (tiles_h * tiles_w) * plan.nb, r // tiles_w * plan.th,
                r % tiles_w * plan.tw))
  return out


# The tickets of the Hopper K6 (one int32 per channel chunk), per device:
# zero between calls, left zero by the kernel. One stream at a time.
_TICKETS = {}


def _tickets(device, n):
  t = _TICKETS.get(device)
  if t is None or t.numel() < n:
    t = _TICKETS[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                       device=device)
  return t


@functools.cache
def _sms(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def _check_kernel_inputs(x, dy, k):
  if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
    raise TypeError(f"K6 takes float32 or bfloat16 x and dy of one dtype, got "
                    f"{x.dtype}, {dy.dtype}")
  if x.device != dy.device:
    raise ValueError(f"K6 needs x and dy on one device, got {x.device}, "
                     f"{dy.device}")
  if x.ndim != 4 or dy.shape != x.shape:
    raise ValueError(f"K6 takes x and dy [B, C, H, W] of one shape (stride 1, "
                     f"SAME); got {tuple(x.shape)}, {tuple(dy.shape)}")
  if k not in KERNEL_SIZES:
    raise ValueError(f"K6 takes k in {KERNEL_SIZES}, got {k}")
  for name, t in (("x", x), ("dy", dy)):
    if not t.is_contiguous(memory_format=torch.channels_last):
      raise ValueError(f"K6 needs {name} in the channels_last memory format")


def depthwise_filter_grad_kernel(x, dy, k: int, *, _simt=False):
  """K6 on the card: the interface of depthwise_filter_grad_reference.
  `_simt` forces csrc/depthwise.cu's kernel (comparisons only)."""
  _check_kernel_inputs(x, dy, k)
  b, c, h, w = x.shape
  sm90 = not _simt and takes_sm90(x.dtype, c)
  if sm90 and (x.data_ptr() % 16 or dy.data_ptr() % 16):
    raise ValueError("the Hopper K6 needs 16-byte aligned x and dy (TMA)")
  out = torch.empty((c, 1, k, k), dtype=torch.float32, device=x.device)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    if sm90:
      plan = sm90_plan(b, c, h, w, k, _sms(x.device.index or 0))
      partial = tickets = None
      if plan.parts > plan.cluster:
        partial = torch.empty((plan.parts // plan.cluster, k * k, c),
                              dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, plan.chunks)
      ptr = lambda t: None if t is None else t.data_ptr()
      err = _sm90_fn()(x.data_ptr(), dy.data_ptr(), ptr(partial),
                       out.data_ptr(), ptr(tickets), b, h, w, c, k, plan.cb,
                       plan.nb, plan.th, plan.tw, plan.parts, plan.cluster,
                       stream)
    else:
      fn, parts_fn = _kernel_fns()
      parts = int(parts_fn(b, h, w, c, k))
      partial = torch.empty((parts, k * k, c), dtype=torch.float32,
                            device=x.device)
      err = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
               out.data_ptr(), _DTYPE_CODES[x.dtype], b, h, w, c, k, parts,
               stream)
  if err != 0:
    raise RuntimeError(f"depthwise filter-grad kernel launch failed: CUDA "
                       f"error {err}")
  depthwise_filter_grad.launches += 1
  depthwise_filter_grad.launches_sm90 += sm90
  return out


def depthwise_filter_grad(x, dy, k: int, stride: int = 1):
  """d(loss)/d(kernel) [C, 1, k, k] f32 of a SAME-padded depthwise conv:
  K6 for CUDA tensors, its plain version for CPU tensors. stride must be
  1, as in JAX."""
  if stride != 1:
    raise NotImplementedError("depthwise filter grad: stride 1 only")
  if x.device.type == "cpu":
    return depthwise_filter_grad_reference(x, dy, k)
  if x.device.type == "cuda":
    return depthwise_filter_grad_kernel(x, dy, k)
  raise ValueError(f"depthwise filter grad: no implementation on {x.device}")


depthwise_filter_grad.launches = 0
depthwise_filter_grad.launches_sm90 = 0


# ---------------------------------------------------------------------------
# The autograd function.
# ---------------------------------------------------------------------------


def _dw_forward(x, kernel, strides, padding):
  """Depthwise conv, NCHW, kernel [C, 1, kh, kw]."""
  return conv2d_same(x, kernel, strides, padding, x.shape[1])


class _DepthwiseConv(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, kernel, strides, padding):
    ctx.save_for_backward(x, kernel)
    ctx.strides, ctx.padding = strides, padding
    # The one place the knob is read for this conv: a knob flipped before
    # the backward does not change which path it takes.
    ctx.use_k6 = (_ENABLED and padding == "SAME" and strides == (1, 1)
                  and kernel.shape[2] == kernel.shape[3])
    return _dw_forward(x, kernel, strides, padding)

  @staticmethod
  def backward(ctx, dy):
    x, kernel = ctx.saved_tensors
    strides, padding = ctx.strides, ctx.padding
    k = kernel.shape[2]
    need_dx, need_dw = ctx.needs_input_grad[:2]
    use_k6 = need_dw and ctx.use_k6
    pads = conv_pads(x.shape[2:], kernel.shape[2:], strides, padding)
    xp, conv_pad = _pad_for_conv(x, pads)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        dy, xp, kernel, None, list(strides), list(conv_pad), [1, 1], False,
        [0, 0], x.shape[1], [need_dx, need_dw and not use_k6, False])
    if dxp is not None and xp is not x:
      (pt, _), (pl, _) = pads
      dxp = dxp[:, :, pt:pt + x.shape[2], pl:pl + x.shape[3]]
    if use_k6:
      cl = torch.channels_last
      dw = depthwise_filter_grad(x.contiguous(memory_format=cl),
                                 dy.contiguous(memory_format=cl), k
                                 ).to(kernel.dtype)
    return dxp, dw, None, None


def depthwise_conv(x, kernel, strides=(1, 1), padding="SAME"):
  """SAME/VALID depthwise conv (NCHW, kernel [C, 1, kh, kw]) whose filter
  gradient is K6 when the knob is on (see the module's docstring)."""
  return _DepthwiseConv.apply(x, kernel, tuple(strides), padding)
