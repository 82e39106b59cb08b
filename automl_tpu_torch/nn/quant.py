"""Quantization-aware training: fake-quant with straight-through gradients.

The counterpart of automl_tpu/nn/quant.py. A process-global QAT mode is
read by Conv2D / DepthwiseConv2D / Dense at forward time (eager: each call
reads it, so a change takes effect at the next forward): kernels are
fake-quantized per output channel and layer outputs per tensor. Gradients
pass straight through (identity STE), so one train step trains float or
QAT depending on the mode. The training runners set the mode both ways at
entry, so a run never inherits it.

The output channel of the port's kernels is axis 0 (conv OIHW, depthwise
[C, 1, k, k], dense [out, in]); JAX's is axis -1 (HWIO, [in, out]).
maybe_quant_kernel quantizes along axis 0: the same scales on the same
channels.

Scales are dynamic: the abs-max of the current values over the slice,
amax / (2^(bits-1) - 1); torch.round rounds half to even, as jnp.round.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_QAT = {"enabled": False, "bits": 8}


def enable_qat(bits: int = 8) -> None:
  _QAT["enabled"] = True
  _QAT["bits"] = bits


def disable_qat() -> None:
  _QAT["enabled"] = False


def qat_enabled() -> bool:
  return _QAT["enabled"]


def qat_bits() -> int:
  return _QAT["bits"]


@contextlib.contextmanager
def qat_scope(bits: int = 8):
  """QAT on inside the block; the previous mode after it."""
  prev = dict(_QAT)
  enable_qat(bits)
  try:
    yield
  finally:
    _QAT.update(prev)


def fake_quant(x, bits: int = 8, axis: Optional[int] = None):
  """Symmetric fake quantization with a straight-through gradient.

  axis=None -> one scale for the tensor; axis=i -> a scale per slice
  along dim i. Where the abs-max is 0 the input passes through unchanged.
  Computed in float32, returned in x's dtype."""
  dtype = x.dtype
  xf = x.float()
  qmax = float(2 ** (bits - 1) - 1)  # e.g. 127 for int8
  if axis is None:
    amax = xf.abs().amax()
  else:
    axis = axis % xf.ndim
    dims = tuple(d for d in range(xf.ndim) if d != axis)
    amax = xf.abs().amax(dim=dims, keepdim=True)
  live = amax > 0
  # A tensor divisor: CUDA divides by a Python number as a product with
  # its reciprocal, a last bit off the quotient the CPU computes.
  scale = torch.where(live, amax / torch.full_like(amax, qmax),
                      torch.ones_like(amax))
  q = torch.clamp(torch.round(xf / scale), -qmax, qmax) * scale
  q = torch.where(live, q, xf)
  # straight-through estimator: forward q, backward identity
  return (xf + (q - xf).detach()).to(dtype)


def maybe_quant_kernel(kernel):
  """Fake-quant a conv / dense kernel per output channel (axis 0) when
  QAT is on."""
  if not qat_enabled():
    return kernel
  return fake_quant(kernel, qat_bits(), axis=0)


def maybe_quant_activation(x):
  """Fake-quant a layer output per tensor when QAT is on."""
  if not qat_enabled():
    return x
  return fake_quant(x, qat_bits(), axis=None)
