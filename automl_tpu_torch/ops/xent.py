"""Fused softmax cross-entropy: the hand-written CUDA kernels and their plain
versions.

The counterpart of automl_tpu/ops/xent.py. The loss of an LM's last layer,
  logits = x . w^T (tied, w [V, D]) or x . w (untied, w [D, V]),
  logits = cap * tanh(logits / cap)               (if logit_cap),
  loss = sum(weights * xent(logits, targets)) / max(sum(weights), 1),
without the [M, V] logits in device memory. Three kernels, in
csrc/xent.cu:
  * K3a, the forward (replaces _fwd_kernel): per token the logsumexp of its
    capped logits, online over vocab tiles, and the target's logit;
  * K3b, dx (replaces _dx_kernel): dx = dz . w, with dz = coef * (softmax -
    onehot) * cap' recomputed tile by tile;
  * K3c, dW (replaces _dw_kernel): dW = dz^T . x, the same recompute.

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
`.launches_dx` and `.launches_dw` count kernel launches.
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


@functools.cache
def _kernel_fns():
  """The kernels' C entry points (fwd, dx, dw, max_dim), built and bound at
  first use."""
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


def max_dim(dtype: torch.dtype) -> int:
  """The largest D the backward kernels take at this operand dtype (their
  f32 [32, D] accumulator lives in shared memory)."""
  return int(_kernel_fns()[3](_DTYPE_CODES[dtype]))


def _check_kernel_inputs(xo, wo, targets, *rows):
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
  if d % 8 or d > max_dim(xo.dtype):
    raise ValueError(f"xent kernels take D a multiple of 8 and at most "
                     f"{max_dim(xo.dtype)} at {xo.dtype}, got D = {d}")
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


def xent_fwd_kernel(xo, wo, targets, *, logit_cap=0.0):
  """K3a on the card: the interface of xent_fwd_reference."""
  _check_kernel_inputs(xo, wo, targets)
  (m, d), v = xo.shape, wo.shape[0]
  fwd = _kernel_fns()[0]
  lse = torch.empty((m,), dtype=torch.float32, device=xo.device)
  tz = torch.empty((m,), dtype=torch.float32, device=xo.device)
  with torch.cuda.device(xo.device):
    err = fwd(xo.data_ptr(), wo.data_ptr(), targets.data_ptr(),
              lse.data_ptr(), tz.data_ptr(), _DTYPE_CODES[xo.dtype], m, v, d,
              float(logit_cap or 0.0), _stream(xo))
  _raise_on(err, "forward")
  fused_softmax_xent.launches_fwd += 1
  return lse, tz


def _bwd_kernel(which, xo, wo, targets, lse, coef, logit_cap, out_dtype):
  _check_kernel_inputs(xo, wo, targets, ("lse", lse), ("coef", coef))
  if out_dtype not in _DTYPE_CODES:
    raise TypeError(f"xent kernels write float32 or bfloat16, got {out_dtype}")
  (m, d), v = xo.shape, wo.shape[0]
  fn = _kernel_fns()[1 if which == "dx" else 2]
  out = torch.empty(((m if which == "dx" else v), d), dtype=out_dtype,
                    device=xo.device)
  with torch.cuda.device(xo.device):
    err = fn(xo.data_ptr(), wo.data_ptr(), targets.data_ptr(), lse.data_ptr(),
             coef.data_ptr(), out.data_ptr(), _DTYPE_CODES[xo.dtype],
             int(out_dtype == torch.bfloat16), m, v, d,
             float(logit_cap or 0.0), _stream(xo))
  _raise_on(err, which)
  return out


def xent_dx_kernel(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                   out_dtype=None):
  """K3b on the card: the interface of xent_dx_reference."""
  dx = _bwd_kernel("dx", xo, wo, targets, lse, coef, logit_cap,
                   out_dtype or xo.dtype)
  fused_softmax_xent.launches_dx += 1
  return dx


def xent_dw_kernel(xo, wo, targets, lse, coef, *, logit_cap=0.0,
                   out_dtype=None):
  """K3c on the card: the interface of xent_dw_reference."""
  dw = _bwd_kernel("dw", xo, wo, targets, lse, coef, logit_cap,
                   out_dtype or wo.dtype)
  fused_softmax_xent.launches_dw += 1
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
