"""Fused softmax cross-entropy: the hand-written CUDA kernels and their plain
versions.

The counterpart of automl_tpu/ops/xent.py. The loss of an LM's last layer,
  logits = x . w^T (tied, w [V, D]) or x . w (untied, w [D, V]),
  logits = cap * tanh(logits / cap)               (if logit_cap),
  loss = sum(weights * xent(logits, targets)) / max(sum(weights), 1),
without the [M, V] logits in device memory. Three kernels:
  * K3a, the forward (replaces _fwd_kernel): per token the logsumexp of its
    capped logits, online over vocab tiles, and the target's logit;
  * K3b, dx (replaces _dx_kernel): dx = dz . w, with dz = coef * (softmax -
    onehot) * cap' recomputed tile by tile;
  * K3c, dW (replaces _dw_kernel): dW = dz^T . x, the same recompute.
Each has two implementations. bf16 operands with D a multiple of 256 up to
2,048 (the LM's widths) go to the Hopper kernels of csrc/xent_sm90.cu
(wgmma fed by TMA; K3a up to D 1,024 with a block's rows of x resident in
shared memory, above it and K3b / K3c always a thread-block cluster of
D / 256 blocks that splits D);
float32 operands (golden tests) and other bf16 D go to csrc/xent.cu, whose
K3a takes any D a multiple of 8 and whose K3b / K3c keep an f32 [32, D]
accumulator in shared memory that bounds D (1,216 at bf16, 1,152 at
float32: `simt_bwd_max_dim`). `check_dim` holds each kernel's limit;
`takes_sm90` says which implementation a call takes. `xent_fwd_kernel(...,
_simt=True)`, `xent_dx_kernel` and `xent_dw_kernel` force the csrc/xent.cu
kernel (comparisons of the two only).

The kernels' interface: x [M, D] and w [V, D] at the operand dtype
(bfloat16, or float32 for golden tests), contiguous, D a multiple of 8;
targets int32 [M]; lse, tz and coef f32 [M] (the TPU kernels' lane-broadcast
[M, 128] operands and (8, M) outputs have no counterpart here). The logits
are products of operand-dtype values summed in f32; the cap and its
derivative 1 - tanh^2 are taken at the raw logits; exp, the logsumexp and
dz are f32, and dz is rounded to the operand dtype before the dx and dW
products. dx comes back in x's dtype, dW in w's.

`fused_softmax_xent` dispatches on the device of x: CUDA tensors go to the
kernels, which raise if they cannot be built or launched; CPU tensors go to
xent_fwd_reference / xent_dx_reference / xent_dw_reference. There is no
fallback from the one to the other. `fused_softmax_xent.launches_fwd`,
`.launches_dx` and `.launches_dw` count kernel launches (either
implementation), `.launches_fwd_sm90`, `.launches_dx_sm90` and
`.launches_dw_sm90` those of the Hopper kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OPERAND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Rows of x per step of the plain versions: bounds their [rows, V] f32
# temporaries (826 MB at V = 100,864) without changing the arithmetic.
_REFERENCE_ROWS = 2048


# ---------------------------------------------------------------------------
# Plain versions (the kernels' interface).
# ---------------------------------------------------------------------------


def _logits(xo, wo, logit_cap):
  """(z, dcap), [m, V] f32: the capped logits and the cap's derivative at
  the raw logits (1.0 without a cap). Operands are upcast to f32 first,
  which gives the same products as operand-dtype operands with f32
  accumulation."""
  z = xo.float() @ wo.float().t()
  if logit_cap:
    t = torch.tanh(z / logit_cap)
    return logit_cap * t, 1.0 - t * t
  return z, 1.0


def _target_hits(targets, vocab):
  """[m, V] bool: column == target (an id outside [0, V) hits nothing)."""
  cols = torch.arange(vocab, device=targets.device)
  return cols[None, :] == targets.long()[:, None]


def xent_fwd_reference(xo, wo, targets, *, logit_cap=0.0):
  """Plain K3a: x [M, D], w [V, D], targets [M] -> (lse, tz), f32 [M]."""
  lse, tz = [], []
  for i in range(0, xo.shape[0], _REFERENCE_ROWS):
    z, _ = _logits(xo[i:i + _REFERENCE_ROWS], wo, logit_cap)
    hits = _target_hits(targets[i:i + _REFERENCE_ROWS], wo.shape[0])
    lse.append(torch.logsumexp(z, dim=1))
    tz.append(torch.where(hits, z, 0.0).sum(dim=1))
  return torch.cat(lse), torch.cat(tz)


def _dz(xo, wo, targets, lse, coef, logit_cap):
  """[m, V] dz = coef * (softmax - onehot) * cap', rounded to the operand
  dtype (then back to f32 for the product)."""
  z, dcap = _logits(xo, wo, logit_cap)
  p = torch.exp(z - lse[:, None])
  dz = coef[:, None] * (p - _target_hits(targets, wo.shape[0]).float()) * dcap
  return dz.to(xo.dtype).float()


def xent_dx_reference(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                      out_dtype=None):
  """Plain K3b: -> dx [M, D] in out_dtype (default x's)."""
  parts = []
  for i in range(0, xo.shape[0], _REFERENCE_ROWS):
    s = slice(i, i + _REFERENCE_ROWS)
    dz = _dz(xo[s], wo, targets[s], lse[s], coef[s], logit_cap)
    parts.append(dz @ wo.float())
  return torch.cat(parts).to(out_dtype or xo.dtype)


def xent_dw_reference(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                      out_dtype=None):
  """Plain K3c: -> dW [V, D] in out_dtype (default w's)."""
  dw = torch.zeros(wo.shape, dtype=torch.float32, device=wo.device)
  for i in range(0, xo.shape[0], _REFERENCE_ROWS):
    s = slice(i, i + _REFERENCE_ROWS)
    dz = _dz(xo[s], wo, targets[s], lse[s], coef[s], logit_cap)
    dw += dz.t() @ xo[s].float()
  return dw.to(out_dtype or wo.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


# csrc/xent.cu's backward: 256 threads, 32 own rows a block, streamed tiles
# of 128 rows, the contracted axis staged BK (+ PAD) columns at a time.
_SIMT_BP, _SIMT_BQ = 32, 128
_SIMT_CHUNK = {torch.bfloat16: (64, 8), torch.float32: (32, 4)}  # (BK, PAD)
_MAX_SMEM = 232448                  # a block's shared memory on sm_90
# csrc/xent_sm90.cu: a block of a cluster holds 256 columns of D; clusters
# of at most 8 blocks own 128 rows and stream the others 64 at a time.
SM90_SLICE, SM90_MAX_DIM = 256, 2048
# The Hopper K3a keeps a block's 64 rows of x in shared memory up to this D
# (both warpgroups on every vocab tile, no cluster); above it a cluster of
# D / 256 blocks splits D, as in K3b / K3c.
SM90_RESIDENT_DIM = 1024
_SM90_OWN_ROWS, _SM90_STREAMED_ROWS = 128, 64


def _simt_bwd_smem_bytes(d: int, dtype: torch.dtype) -> int:
  """csrc/xent.cu::bwd_smem_bytes: the accumulator [32, D] f32, the P and Q
  stages, the logit and dz tiles and the per-token values."""
  bk, pad = _SIMT_CHUNK[dtype]
  size = 2 if dtype == torch.bfloat16 else 4
  acc_ld = -(-d // bk) * bk + 4
  return (4 * _SIMT_BP * acc_ld + size * 2 * (_SIMT_BP + _SIMT_BQ) * (bk + pad)
          + 4 * _SIMT_BP * (_SIMT_BQ + 4) + size * _SIMT_BP * (_SIMT_BQ + pad)
          + 4 * 3 * _SIMT_BQ)


@functools.cache
def simt_bwd_max_dim(dtype: torch.dtype) -> int:
  """The largest D csrc/xent.cu's K3b / K3c take at this operand dtype
  (csrc/xent.cu::max_dim): 1,216 at bf16, 1,152 at float32."""
  d = 8
  while _simt_bwd_smem_bytes(d + 8, dtype) <= _MAX_SMEM:
    d += 8
  return d


def takes_sm90(dtype: torch.dtype, d: int) -> bool:
  """Whether K3a, K3b and K3c on operands of this dtype and D go to the
  Hopper kernels (csrc/xent_sm90.cu): bf16 with D a multiple of 256 up to
  2,048."""
  return (dtype == torch.bfloat16 and d % SM90_SLICE == 0
          and SM90_SLICE <= d <= SM90_MAX_DIM)


def check_dim(which: str, dtype: torch.dtype, d: int, simt: bool = False):
  """Raises ValueError unless kernel `which` ("fwd", "dx" or "dw") takes D
  at this operand dtype (`simt`: the csrc/xent.cu kernel, forced). K3a
  takes any D a multiple of 8 (the Hopper kernel's D, and any other through
  csrc/xent.cu's); K3b and K3c at bf16 D a multiple of 256 up
  to 2,048 (the Hopper kernels) or any multiple of 8 up to 1,216, at
  float32 any multiple of 8 up to 1,152 (csrc/xent.cu's)."""
  if d < 8 or d % 8:
    raise ValueError(f"xent kernels take D a multiple of 8, got D = {d}")
  if which == "fwd" or d <= simt_bwd_max_dim(dtype):
    return
  if not simt and takes_sm90(dtype, d):
    return
  sm90 = (f" or a multiple of {SM90_SLICE} up to {SM90_MAX_DIM} "
          "(csrc/xent_sm90.cu)" if dtype == torch.bfloat16 and not simt
          else "")
  raise ValueError(
      f"the xent {which} kernel takes D at {dtype} up to "
      f"{simt_bwd_max_dim(dtype)} (csrc/xent.cu, whose f32 [32, D] "
      f"accumulator lives in shared memory){sm90}, got D = {d}")


@functools.cache
def _kernel_fns():
  """csrc/xent.cu's C entry points (fwd, dx, dw, max_dim), built and bound
  at first use."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("xent")
  ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  fwd = lib.automl_xent_fwd
  # x w tgt lse tz | dtype M V D cap | stream
  fwd.argtypes = [ptr] * 5 + [i32] * 4 + [f32, ptr]
  fwd.restype = i32
  bwd = []
  for fn in (lib.automl_xent_dx, lib.automl_xent_dw):
    # x w tgt lse coef out | dtype out_bf16 M V D cap | stream
    fn.argtypes = [ptr] * 6 + [i32] * 5 + [f32, ptr]
    fn.restype = i32
    bwd.append(fn)
  max_dim = lib.automl_xent_max_dim
  max_dim.argtypes = [i32]
  max_dim.restype = i32
  return fwd, bwd[0], bwd[1], max_dim


@functools.cache
def _sm90_fns():
  """csrc/xent_sm90.cu's C entry points (fwd, dx, dw, clusters), built and
  bound at first use."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("xent_sm90")
  ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  fwd = lib.automl_xent_fwd_sm90
  # x w tgt lse tz | M V D cap | n_whole n_split part_out | stream
  fwd.argtypes = [ptr] * 5 + [i32] * 3 + [f32, i32, i32, ptr, ptr]
  fwd.restype = i32
  fns = []
  for fn in (lib.automl_xent_dx_sm90, lib.automl_xent_dw_sm90):
    # x w tgt lse coef out | out_bf16 M V D cap | n_whole n_split part_out
    # | stream
    fn.argtypes = [ptr] * 6 + [i32] * 4 + [f32, i32, i32, ptr, ptr]
    fn.restype = i32
    fns.append(fn)
  clusters = lib.automl_xent_sm90_clusters
  clusters.argtypes = [i32, i32]
  clusters.restype = i32
  return fwd, fns[0], fns[1], clusters


_CLUSTER_KINDS = {"dw": 0, "dx": 1, "fwd": 2}


@functools.cache
def _sm90_clusters(device_index: int, d: int, which: str) -> int:
  with torch.cuda.device(device_index):
    return int(_sm90_fns()[3](d, _CLUSTER_KINDS[which]))


def sm90_clusters(d: int, which: str = "dx", device=None) -> int:
  """How many clusters of the Hopper K3a, K3b or K3c ("fwd", "dx", "dw") at
  this D the card runs at once (cudaOccupancyMaxActiveClusters)."""
  index = torch.device(device or "cuda").index
  return _sm90_clusters(torch.cuda.current_device() if index is None
                        else index, d, which)


def split_plan(own_tiles: int, active: int, streamed_tiles: int):
  """(n_whole, n_split) of a Hopper K3b / K3c launch: `own_tiles` clusters'
  worth of work (128 own rows each) on a card that runs `active` at once.
  The first n_whole tiles run whole; the rest, the last wave's, which would
  leave most of the card idle, are split n_split ways along the streamed
  tiles so that they fill one wave, and their parts are summed in a fixed
  order. (own_tiles, 1): no split."""
  if active < 1:
    raise ValueError(f"the card runs no cluster of this kernel ({active})")
  rest = own_tiles % active
  n_split = min(active // rest, streamed_tiles) if rest else 1
  return (own_tiles - rest, n_split) if n_split > 1 else (own_tiles, 1)


def split_ranges(streamed_tiles: int, n_split: int):
  """The streamed tiles [j0, j1) of each of a split tile's n_split parts
  (the kernels' j0 = tiles * part / n_split)."""
  return [(streamed_tiles * k // n_split, streamed_tiles * (k + 1) // n_split)
          for k in range(n_split)]


def merge_softmax_parts(m, l, t):
  """K3a's merge of a split tile's parts: (m, l, t) [parts, rows] f32 (the
  running max, sum of exp(z - m) and target logit over each part's vocab
  tiles) -> (lse, tz) [rows], merged in part order, as
  csrc/xent_sm90.cu::xent_fwd_merge_kernel does."""
  mm, ll, tt = m[0], l[0], t[0]
  for k in range(1, m.shape[0]):
    mn = torch.maximum(mm, m[k])
    ll = ll * torch.exp(mm - mn) + l[k] * torch.exp(m[k] - mn)
    mm, tt = mn, tt + t[k]
  return mm + torch.log(ll), tt


def _check_kernel_inputs(xo, wo, targets, *rows, which="fwd", simt=False):
  if xo.dtype not in _DTYPE_CODES:
    raise TypeError(f"xent kernels take float32 or bfloat16 operands, got "
                    f"{xo.dtype}")
  if wo.dtype != xo.dtype or wo.device != xo.device:
    raise ValueError(f"xent kernels need x and w of one dtype and device; "
                     f"got {xo.dtype} on {xo.device}, {wo.dtype} on "
                     f"{wo.device}")
  if xo.ndim != 2 or wo.ndim != 2 or xo.shape[1] != wo.shape[1]:
    raise ValueError(f"xent kernels need x [M, D] and w [V, D]; got "
                     f"{tuple(xo.shape)}, {tuple(wo.shape)}")
  if not (xo.is_contiguous() and wo.is_contiguous()):
    raise ValueError("xent kernels need contiguous x and w")
  d = xo.shape[1]
  check_dim(which, xo.dtype, d, simt)
  if not simt and takes_sm90(xo.dtype, d) and (
      xo.data_ptr() % 16 or wo.data_ptr() % 16):
    raise ValueError("the Hopper xent kernels need 16-byte aligned x and w "
                     "(TMA)")
  m = xo.shape[0]
  for name, t, dtype in (("targets", targets, torch.int32),
                         *((n, r, torch.float32) for n, r in rows)):
    if (t.dtype != dtype or tuple(t.shape) != (m,) or not t.is_contiguous()
        or t.device != xo.device):
      raise ValueError(f"{name} must be a contiguous {dtype} [{m}] tensor on "
                       f"x's device")


def _raise_on(err, which):
  if err != 0:
    raise RuntimeError(f"xent {which} kernel launch failed: CUDA error {err}")


def _stream(x):
  return torch.cuda.current_stream(x.device).cuda_stream


def _split(own, streamed, d, which, device):
  """(own_tiles, n_whole, n_split) of a Hopper K3a-c launch (split_plan on
  this card)."""
  own_tiles = -(-own // _SM90_OWN_ROWS)
  return (own_tiles, *split_plan(own_tiles, sm90_clusters(d, which, device),
                                 -(-streamed // _SM90_STREAMED_ROWS)))


def xent_fwd_kernel(xo, wo, targets, *, logit_cap=0.0, _simt=False):
  """K3a on the card: the interface of xent_fwd_reference. `_simt` forces
  csrc/xent.cu's kernel (comparisons only)."""
  _check_kernel_inputs(xo, wo, targets, simt=_simt)
  (m, d), v = xo.shape, wo.shape[0]
  sm90 = not _simt and takes_sm90(xo.dtype, d)
  lse = torch.empty((m,), dtype=torch.float32, device=xo.device)
  tz = torch.empty((m,), dtype=torch.float32, device=xo.device)
  cap = float(logit_cap or 0.0)
  with torch.cuda.device(xo.device):
    if sm90:
      # Up to SM90_RESIDENT_DIM the forward keeps x in shared memory and
      # has no cluster to split; above it, the cluster kernel's plan.
      own_tiles, n_whole, n_split = (
          (-(-m // _SM90_OWN_ROWS),) * 2 + (1,) if d <= SM90_RESIDENT_DIM
          else _split(m, v, d, "fwd", xo.device))
      parts = None
      if n_split > 1:
        parts = torch.empty(((own_tiles - n_whole) * n_split, 3,
                             _SM90_OWN_ROWS), dtype=torch.float32,
                            device=xo.device)
      err = _sm90_fns()[0](
          xo.data_ptr(), wo.data_ptr(), targets.data_ptr(), lse.data_ptr(),
          tz.data_ptr(), m, v, d, cap, n_whole, n_split,
          None if parts is None else parts.data_ptr(), _stream(xo))
    else:
      err = _kernel_fns()[0](
          xo.data_ptr(), wo.data_ptr(), targets.data_ptr(), lse.data_ptr(),
          tz.data_ptr(), _DTYPE_CODES[xo.dtype], m, v, d, cap, _stream(xo))
  _raise_on(err, "forward")
  fused_softmax_xent.launches_fwd += 1
  fused_softmax_xent.launches_fwd_sm90 += sm90
  return lse, tz


def _bwd_kernel(which, xo, wo, targets, lse, coef, logit_cap, out_dtype,
                simt):
  """K3b or K3c; returns (out, whether the Hopper kernel ran)."""
  _check_kernel_inputs(xo, wo, targets, ("lse", lse), ("coef", coef),
                       which=which, simt=simt)
  if out_dtype not in _DTYPE_CODES:
    raise TypeError(f"xent kernels write float32 or bfloat16, got {out_dtype}")
  (m, d), v = xo.shape, wo.shape[0]
  sm90 = not simt and takes_sm90(xo.dtype, d)
  out = torch.empty(((m if which == "dx" else v), d), dtype=out_dtype,
                    device=xo.device)
  args = (xo.data_ptr(), wo.data_ptr(), targets.data_ptr(), lse.data_ptr(),
          coef.data_ptr(), out.data_ptr())
  flags = (int(out_dtype == torch.bfloat16), m, v, d, float(logit_cap or 0.0))
  with torch.cuda.device(xo.device):
    if sm90:
      own, streamed = (m, v) if which == "dx" else (v, m)
      own_tiles, n_whole, n_split = _split(own, streamed, d, which,
                                           xo.device)
      parts = None
      if n_split > 1:
        parts = torch.empty(((own_tiles - n_whole) * n_split,
                             _SM90_OWN_ROWS, d), dtype=torch.float32,
                            device=xo.device)
      err = _sm90_fns()[1 if which == "dx" else 2](
          *args, *flags, n_whole, n_split,
          None if parts is None else parts.data_ptr(), _stream(xo))
    else:
      err = _kernel_fns()[1 if which == "dx" else 2](
          *args, _DTYPE_CODES[xo.dtype], *flags, _stream(xo))
  _raise_on(err, which)
  return out, sm90


def xent_dx_kernel(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                   out_dtype=None, _simt=False):
  """K3b on the card: the interface of xent_dx_reference. `_simt` forces
  csrc/xent.cu's kernel (comparisons only)."""
  dx, sm90 = _bwd_kernel("dx", xo, wo, targets, lse, coef, logit_cap,
                         out_dtype or xo.dtype, _simt)
  fused_softmax_xent.launches_dx += 1
  fused_softmax_xent.launches_dx_sm90 += sm90
  return dx


def xent_dw_kernel(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                   out_dtype=None, _simt=False):
  """K3c on the card: the interface of xent_dw_reference. `_simt` forces
  csrc/xent.cu's kernel (comparisons only)."""
  dw, sm90 = _bwd_kernel("dw", xo, wo, targets, lse, coef, logit_cap,
                         out_dtype or wo.dtype, _simt)
  fused_softmax_xent.launches_dw += 1
  fused_softmax_xent.launches_dw_sm90 += sm90
  return dw


def _on(x, cpu_fn, cuda_fn):
  if x.device.type == "cpu":
    return cpu_fn
  if x.device.type == "cuda":
    return cuda_fn
  raise ValueError(f"fused softmax xent: no implementation on {x.device}")


def xent_fwd(xo, wo, targets, **kw):
  """K3a for CUDA tensors, its plain version for CPU tensors."""
  return _on(xo, xent_fwd_reference, xent_fwd_kernel)(xo, wo, targets, **kw)


def xent_dx(xo, wo, targets, lse, coef, **kw):
  """K3b for CUDA tensors, its plain version for CPU tensors."""
  return _on(xo, xent_dx_reference, xent_dx_kernel)(xo, wo, targets, lse,
                                                    coef, **kw)


def xent_dw(xo, wo, targets, lse, coef, **kw):
  """K3c for CUDA tensors, its plain version for CPU tensors."""
  return _on(xo, xent_dw_reference, xent_dw_kernel)(xo, wo, targets, lse,
                                                    coef, **kw)


class _FusedXent(torch.autograd.Function):
  """The loss from K3a; its backward is K3b and K3c. The weighted mean and
  coef = g * weights / sum_w stay in plain torch, as in JAX's custom vjp."""

  @staticmethod
  def forward(ctx, x, w, targets, weights, logit_cap, operand_dtype):
    xo = x.to(operand_dtype).contiguous()
    wo = w.to(operand_dtype).contiguous()
    lse, tz = xent_fwd(xo, wo, targets, logit_cap=logit_cap)
    wts = weights.float()
    sum_w = wts.sum().clamp_min(1.0)
    ctx.save_for_backward(xo, wo, targets, wts, lse, sum_w)
    ctx.logit_cap, ctx.dtypes = logit_cap, (x.dtype, w.dtype)
    return ((lse - tz) * wts).sum() / sum_w

  @staticmethod
  def backward(ctx, g):
    xo, wo, targets, wts, lse, sum_w = ctx.saved_tensors
    coef = (g * wts / sum_w).contiguous()
    kw = dict(logit_cap=ctx.logit_cap)
    dx = xent_dx(xo, wo, targets, lse, coef, out_dtype=ctx.dtypes[0], **kw)
    dw = xent_dw(xo, wo, targets, lse, coef, out_dtype=ctx.dtypes[1], **kw)
    # targets are integral; the loss weights are data, not trained through:
    # they get a zero cotangent, as in JAX.
    return dx, dw, None, torch.zeros_like(wts), None, None


def fused_softmax_xent(x, w, targets, weights=None, *, tied: bool = True,
                       logit_cap: float = 0.0, block_m: int = 1024,
                       block_v: int = 1024, operand_dtype="bfloat16"):
  """Masked softmax cross-entropy against a projection, fully fused.

  x: [B, T, D] or [M, D]; targets / weights: [B, T] or [M] (weights default
  to ones). w: [V, D] tied, [D, V] untied; an untied w is laid out once as
  [V, D] here (autograd transposes its gradient back). The products run at
  `operand_dtype` ("bfloat16" or "float32", or a torch dtype) with f32
  accumulation.

  block_m / block_v are the TPU kernels' tile sizes. They are accepted for
  the JAX signature and steer nothing: the CUDA kernels' tiles are their
  own constants."""
  del block_m, block_v
  if x.ndim == 3:
    x = x.reshape(-1, x.shape[-1])
  targets = targets.reshape(-1).to(torch.int32).contiguous()
  if weights is None:
    weights = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
  weights = weights.reshape(-1).float()
  if not tied:
    w = w.t()
  if isinstance(operand_dtype, str):
    operand_dtype = _OPERAND_DTYPES[operand_dtype]
  return _FusedXent.apply(x, w, targets, weights, float(logit_cap or 0.0),
                          operand_dtype)


fused_softmax_xent.launches_fwd = 0
fused_softmax_xent.launches_dx = 0
fused_softmax_xent.launches_dw = 0
fused_softmax_xent.launches_fwd_sm90 = 0
fused_softmax_xent.launches_dx_sm90 = 0
fused_softmax_xent.launches_dw_sm90 = 0
