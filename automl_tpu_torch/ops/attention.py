"""Flash attention: the hand-written CUDA kernels and their plain versions.

The counterpart of automl_tpu/ops/attention.py. Four kernels:
  * K1, the forward (replaces _fwd_kernel): out and the row logsumexp lse;
  * K2, the fused backward (replaces _bwd_fused_kernel): dq, dk, dv from one
    recompute of s/p/ds per tile;
  * K5a and K5b, the split backward (replace _bwd_dq_kernel and
    _bwd_dkv_kernel): dq from one kernel, dk and dv from another, each
    recomputing s/p/ds.
Each has two CUDA implementations: for bf16 inputs (head_dim a multiple of
8, strides TMA takes) the Hopper kernels of csrc/flash_attention_sm90.cu
(bf16 wgmma fed by TMA; p and ds split into two bf16 halves for the
products that take them); for float32 inputs the scalar-FMA kernels of
csrc/flash_attention.cu. The private `_simt=True` sends bf16 to the
scalar-FMA kernels too (comparisons of the two only).

The kernels' interface: q, k, v, g, out, dq, dk, dv [B, T, N, H] (q/k/v/g
through their strides, unit H stride), lse and delta [B*N, T] f32 with row
r = b*N + n, segment ids [B, T] int32. The TPU kernels' [B*N, T, H]
transposes and lane-broadcast operands have no counterpart here.

Semantics, as in the JAX package: s = sm_scale * (q . k) with the operands'
products summed in f32; an optional tanh cap s = cap * tanh(s / cap); keys
masked by causality, the sliding window (q - k < window), the sequence end
and unequal segment ids; softmax over the live keys; p . v in f32. A masked
key gets -1e30 and an explicit p = 0.

`flash_attention` dispatches on the device of q: CUDA tensors go to the
kernels, which raise if they cannot be built or launched; CPU tensors go to
the plain versions (flash_fwd_reference, flash_bwd_reference,
flash_bwd_dq_reference, flash_bwd_dkv_reference). There is no fallback from
the one to the other. `flash_attention.launches_fwd` / `.launches_bwd` /
`.launches_dq` / `.launches_dkv` count kernel launches, and
`.launches_fwd_sm90` / `.launches_bwd_sm90` / `.launches_dq_sm90` /
`.launches_dkv_sm90` those of K1 / K2 / K5a / K5b that went to the Hopper
kernels.

The structure of JAX's _flash_res: the forward is the custom op
automl_tpu_torch::flash_fwd, called on detached q, k, v, and its (out, lse)
enter an identity autograd Function whose backward runs K2 or K5a + K5b
(flash_bwd_split: delta = rowsum(g * out) and the padded lse made once for
both, as JAX's _flash_bwd_pallas does).
torch.utils.checkpoint's selective policies see the custom op (a ctypes
launch inside an autograd Function they cannot see), so a policy that saves
its outputs (remat_policy "dots_flash", models/lm.py) keeps the backward
from running the forward again.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, NamedTuple

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


# ---------------------------------------------------------------------------
# Plain versions (the kernels' interface).
# ---------------------------------------------------------------------------


def _mask(t, causal, window, segs, device):
  """[B or 1, 1, T, T] bool, True = attend."""
  q_pos = torch.arange(t, device=device)[:, None]
  k_pos = torch.arange(t, device=device)[None, :]
  mask = torch.ones((t, t), dtype=torch.bool, device=device)
  if causal:
    mask &= q_pos >= k_pos
  if window is not None:
    mask &= (q_pos - k_pos) < window
  mask = mask[None, None]
  if segs is not None:
    mask = mask & (segs[:, None, :, None] == segs[:, None, None, :])
  return mask


def _scores(q, k, logit_cap, sm_scale):
  """(s_eff, dcap), [B, N, T, T] f32: the capped scaled scores and the cap's
  derivative (1.0 without a cap). Operands are upcast to f32 first, which
  gives the same products as input-dtype operands with f32 accumulation."""
  s = sm_scale * torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
  if logit_cap:
    capped = torch.tanh(s / logit_cap)
    return logit_cap * capped, 1.0 - capped * capped
  return s, 1.0


def _lse_rows(x):
  """[B, N, T] -> [B*N, T]."""
  return x.reshape(-1, x.shape[-1])


def flash_fwd_reference(q, k, v, segs=None, *, causal=True, window=None,
                        logit_cap=0.0, sm_scale=1.0):
  """Plain-PyTorch K1: q, k, v [B, T, N, H] (N equal) -> (out [B, T, N, H]
  in q's dtype, lse [B*N, T] f32).

  m = max(-1e30, live scores); p = exp(s - m) on live keys, 0 elsewhere;
  l = sum(p); out = (p . v) / max(l, 1e-30); lse = m + log(max(l, 1e-30))."""
  b, t, n, h = q.shape
  s, _ = _scores(q, k, logit_cap, sm_scale)
  mask = _mask(t, causal, window, segs, q.device)
  s = torch.where(mask, s, NEG_INF)
  m = s.amax(dim=-1, keepdim=True)
  p = torch.where(mask, torch.exp(s - m), 0.0)
  l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
  out = torch.einsum("bnqk,bknh->bqnh", p, v.float()) / l.transpose(1, 2)
  lse = (m + torch.log(l))[..., 0]
  return out.to(q.dtype), _lse_rows(lse)


def _delta(g, out):
  """rowsum(g * out) in f32: [B, T, N, H] -> [B*N, T]."""
  d = (g.float() * out.float()).sum(dim=-1)         # [B, T, N]
  return _lse_rows(d.transpose(1, 2))


def _bwd_terms(q, k, v, g, out, lse, segs, causal, window, logit_cap,
               sm_scale):
  """(p, ds) [B, N, T, T] f32: the math of the TPU kernels' _bwd_compute.

  p = exp(s_eff - lse) on live keys, 0 elsewhere; dp = g . v;
  ds = p * (dp - delta) * dcap with delta = rowsum(g * out)."""
  b, t, n, h = q.shape
  s, dcap = _scores(q, k, logit_cap, sm_scale)
  mask = _mask(t, causal, window, segs, q.device)
  lse4 = lse.reshape(b, n, t, 1)
  delta4 = _delta(g, out).reshape(b, n, t, 1)
  p = torch.where(mask, torch.exp(torch.where(mask, s, NEG_INF) - lse4), 0.0)
  dp = torch.einsum("bqnh,bknh->bnqk", g.float(), v.float())
  ds = torch.where(mask, p * (dp - delta4) * dcap, 0.0)
  return p, ds


def _dq_from(ds, q, k, sm_scale):
  """dq = sm_scale * ds . k in f32, in q's dtype."""
  return (sm_scale * torch.einsum("bnqk,bknh->bqnh", ds, k.float())).to(
      q.dtype)


def _dkv_from(p, ds, q, k, v, g, sm_scale):
  """dk = sm_scale * ds^T . q and dv = p^T . g in f32, in k's / v's dtype."""
  dk = sm_scale * torch.einsum("bnqk,bqnh->bknh", ds, q.float())
  dv = torch.einsum("bnqk,bqnh->bknh", p, g.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, g, out, lse, segs=None, *, causal=True,
                        window=None, logit_cap=0.0, sm_scale=1.0):
  """Plain-PyTorch K2: -> (dq, dk, dv), each [B, T, N, H] in its input's dtype.

  The two halves of the split backward (flash_bwd_dq_reference and
  flash_bwd_dkv_reference) from one recompute of p and ds."""
  p, ds = _bwd_terms(q, k, v, g, out, lse, segs, causal, window, logit_cap,
                     sm_scale)
  return (_dq_from(ds, q, k, sm_scale),
          *_dkv_from(p, ds, q, k, v, g, sm_scale))


def flash_bwd_dq_reference(q, k, v, g, out, lse, segs=None, *, causal=True,
                           window=None, logit_cap=0.0, sm_scale=1.0):
  """Plain-PyTorch K5a: -> dq [B, T, N, H] in q's dtype (the interface of
  flash_bwd_reference)."""
  _, ds = _bwd_terms(q, k, v, g, out, lse, segs, causal, window, logit_cap,
                     sm_scale)
  return _dq_from(ds, q, k, sm_scale)


def flash_bwd_dkv_reference(q, k, v, g, out, lse, segs=None, *, causal=True,
                            window=None, logit_cap=0.0, sm_scale=1.0):
  """Plain-PyTorch K5b: -> (dk, dv) [B, T, N, H] in k's / v's dtype."""
  p, ds = _bwd_terms(q, k, v, g, out, lse, segs, causal, window, logit_cap,
                     sm_scale)
  return _dkv_from(p, ds, q, k, v, g, sm_scale)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


class _KernelFns(NamedTuple):
  fwd: Any
  bwd: Any
  bwd_dq: Any
  bwd_dkv: Any


def _bind(fn, n_ptrs, n_strided, dtype_arg=True):
  """ctypes signature: n_ptrs tensors | dtype | n_strided tensors' strides |
  B T N H causal window | cap scale | stream."""
  ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
  fn.argtypes = ([ptr] * n_ptrs + [i32] * dtype_arg + [i64] * 3 * n_strided
                 + [i32] * 6 + [f32, f32] + [ptr])
  fn.restype = i32
  return fn


@functools.cache
def _kernel_fns() -> _KernelFns:
  """The scalar-FMA kernels' C entry points, built and bound at first use."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("flash_attention")
  return _KernelFns(
      # q k v seg out lse
      fwd=_bind(lib.automl_flash_fwd, 6, 3),
      # q k v g seg lse delta dq32 dq_turn dk dv
      bwd=_bind(lib.automl_flash_bwd, 11, 4),
      # q k v g seg lse delta dq
      bwd_dq=_bind(lib.automl_flash_bwd_dq, 8, 4),
      # q k v g seg lse delta dk dv
      bwd_dkv=_bind(lib.automl_flash_bwd_dkv, 9, 4))


@functools.cache
def _sm90_fns() -> _KernelFns:
  """The Hopper entry points (bf16 only: no dtype argument)."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("flash_attention_sm90")
  return _KernelFns(
      # q k v seg out lse
      fwd=_bind(lib.automl_flash_fwd_sm90, 6, 3, dtype_arg=False),
      # q k v g seg lse_p delta_p dq32 dq_turn dk dv
      bwd=_bind(lib.automl_flash_bwd_sm90, 11, 4, dtype_arg=False),
      # q k v g seg lse_p delta_p dq
      bwd_dq=_bind(lib.automl_flash_bwd_dq_sm90, 8, 4, dtype_arg=False),
      # q k v g seg lse_p delta_p dk dv
      bwd_dkv=_bind(lib.automl_flash_bwd_dkv_sm90, 9, 4, dtype_arg=False))


def _check_kernel_inputs(tensors, segs):
  q = tensors[0]
  if q.dtype not in _DTYPE_CODES:
    raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                    f"got {q.dtype}")
  for x in tensors:
    if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
      raise ValueError("flash attention kernels need q, k, v (and g, out) "
                       "of one dtype, shape and device; got "
                       f"{[(tuple(y.shape), y.dtype) for y in tensors]}")
    if x.stride(-1) != 1:
      raise ValueError("flash attention kernels need a unit head-dim stride")
  if q.shape[-1] > _MAX_HEAD_DIM:
    raise ValueError(f"flash attention kernels take head_dim <= "
                     f"{_MAX_HEAD_DIM}, got {q.shape[-1]}")
  if segs is not None and (segs.dtype != torch.int32 or not
                           segs.is_contiguous() or segs.device != q.device):
    raise ValueError("segment ids must be a contiguous int32 [B, T] tensor "
                     "on q's device")


def _strides(x):
  return x.stride(0), x.stride(1), x.stride(2)


# The Hopper kernels' q tiles: K2 reads lse and delta 64 queries at a time,
# K5a 128 (and K5b, which shares K5a's buffers, 64 from them).
_SM90_Q_TILE = 64
_SM90_SPLIT_Q_TILE = 128


def _takes_sm90(x, simt):
  """Whether a kernel on these checked inputs goes to the Hopper
  implementation: bf16 and not asked for the scalar-FMA one (`_simt`, a
  private argument that only comparisons of the two implementations
  pass)."""
  return x.dtype == torch.bfloat16 and not simt


def _tma_ready(x):
  """Strides a TMA tensor map takes: multiples of 8 elements (16 bytes of
  bf16), and 16-byte aligned data."""
  return all(s % 8 == 0 for s in _strides(x)) and x.data_ptr() % 16 == 0


def _check_tma(tensors):
  h = tensors[0].shape[-1]
  if h % 8:
    raise ValueError(f"bf16 flash attention kernels take head_dim a multiple "
                     f"of 8, got {h}")
  for x in tensors:
    if not _tma_ready(x):
      raise ValueError("bf16 flash attention kernels need strides that are "
                       "multiples of 8 elements and 16-byte aligned data, got "
                       f"strides {tuple(x.stride())}")


def _common(q, causal, window, logit_cap, sm_scale):
  b, t, n, h = q.shape
  return (b, t, n, h, int(bool(causal)), -1 if window is None else int(window),
          float(logit_cap or 0.0), float(sm_scale))


def _check_bwd_inputs(q, k, v, g, out, lse, segs):
  _check_kernel_inputs((q, k, v, g, out), segs)
  b, t, n, _ = q.shape
  if tuple(lse.shape) != (b * n, t) or lse.dtype != torch.float32 or \
      not lse.is_contiguous() or lse.device != q.device:
    raise ValueError(f"lse must be contiguous f32 [{b * n}, {t}] on q's "
                     "device")


def _raise_on(err, which):
  if err == -1:
    raise RuntimeError(f"flash attention {which} kernel: a TMA tensor map "
                       "could not be encoded")
  if err != 0:
    raise RuntimeError(f"flash attention {which} kernel launch failed: CUDA "
                       f"error {err}")


def flash_fwd_kernel(q, k, v, segs=None, *, causal=True, window=None,
                     logit_cap=0.0, sm_scale=1.0, _simt=False):
  """K1 on the card: the interface of flash_fwd_reference. bf16 goes to the
  Hopper kernel, float32 (or `_simt`) to the scalar-FMA one."""
  _check_kernel_inputs((q, k, v), segs)
  sm90 = _takes_sm90(q, _simt)
  if sm90:
    _check_tma((q, k, v))
  b, t, n, h = q.shape
  out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
  lse = torch.empty((b * n, t), dtype=torch.float32, device=q.device)
  dtype = () if sm90 else (_DTYPE_CODES[q.dtype],)
  fwd = _sm90_fns().fwd if sm90 else _kernel_fns().fwd
  with torch.cuda.device(q.device):
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if segs is None else segs.data_ptr(),
              out.data_ptr(), lse.data_ptr(), *dtype,
              *_strides(q), *_strides(k), *_strides(v),
              *_common(q, causal, window, logit_cap, sm_scale),
              torch.cuda.current_stream(q.device).cuda_stream)
  _raise_on(err, "forward")
  flash_attention.launches_fwd += 1
  flash_attention.launches_fwd_sm90 += sm90
  return out, lse


def _bwd_stats(g, out, lse, pad_to=None):
  """(lse, delta) as a backward kernel reads them: delta = rowsum(g * out),
  both contiguous f32 [B*N, T], or with `pad_to` (the Hopper kernels)
  zero-padded to [B*N, T rounded up to pad_to]."""
  delta = _delta(g, out)
  if pad_to is not None:
    pad = (0, -lse.shape[1] % pad_to)
    lse, delta = (torch.nn.functional.pad(x, pad) for x in (lse, delta))
  return lse.contiguous(), delta.contiguous()


def _launch_bwd(fn, which, outputs, q, k, v, g, stats, segs, causal,
                window, logit_cap, sm_scale, sm90):
  """Launches a backward kernel, `fn`, on checked inputs: q k v g seg, then
  `stats` (lse and delta from _bwd_stats), its `outputs`, the dtype (not
  for a Hopper kernel, `sm90`), the strides of q k v g and the common
  arguments."""
  dtype = () if sm90 else (_DTYPE_CODES[q.dtype],)
  with torch.cuda.device(q.device):
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             None if segs is None else segs.data_ptr(),
             *(x.data_ptr() for x in stats),
             *(x.data_ptr() for x in outputs), *dtype,
             *_strides(q), *_strides(k), *_strides(v), *_strides(g),
             *_common(q, causal, window, logit_cap, sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
  _raise_on(err, which)


def flash_bwd_kernel(q, k, v, g, out, lse, segs=None, *, causal=True,
                     window=None, logit_cap=0.0, sm_scale=1.0, _simt=False):
  """K2 on the card: the interface of flash_bwd_reference. bf16 goes to the
  Hopper kernel, float32 (or `_simt`) to the scalar-FMA one. dq is summed
  over key tiles in f32, in an order that one counter per (row, q tile)
  fixes (scalar FMA: atomics into a [B, T, N, H] buffer; Hopper: one bulk
  add per [64, 64] block of a block buffer), then cast to q's dtype: the
  result is the same from run to run."""
  _check_bwd_inputs(q, k, v, g, out, lse, segs)
  sm90 = _takes_sm90(q, _simt)
  if sm90:
    _check_tma((q, k, v, g))
  b, t, n, h = q.shape
  if sm90:
    # dq32: one [64 queries, 64 head dims] f32 block per (row b*N + n, q
    # tile, 64 head dims), the unit of the kernel's bulk adds.
    n_qt, n_ch = -(-t // _SM90_Q_TILE), -(-h // 64)
    dq32 = torch.zeros((b * n, n_qt, n_ch, 64, 64), dtype=torch.float32,
                       device=q.device)
    dq_turn = torch.zeros((b * n, n_qt), dtype=torch.int32, device=q.device)
  else:
    dq32 = torch.zeros((b, t, n, h), dtype=torch.float32, device=q.device)
    dq_turn = torch.zeros((b * n, t), dtype=torch.int32, device=q.device)
  dk = torch.empty((b, t, n, h), dtype=k.dtype, device=q.device)
  dv = torch.empty((b, t, n, h), dtype=v.dtype, device=q.device)
  _launch_bwd(_sm90_fns().bwd if sm90 else _kernel_fns().bwd, "backward",
              (dq32, dq_turn, dk, dv), q, k, v, g,
              _bwd_stats(g, out, lse, _SM90_Q_TILE if sm90 else None), segs,
              causal, window, logit_cap, sm_scale, sm90)
  flash_attention.launches_bwd += 1
  flash_attention.launches_bwd_sm90 += sm90
  if sm90:
    dq32 = _dq_from_blocks(dq32, b, t, n, h)
  return dq32.to(q.dtype), dk, dv


def _dq_from_blocks(blocks, b, t, n, h):
  """The Hopper K2's dq, [B*N, ceil(T/64), ceil(H/64), 64, 64] blocks (block
  (b*N + n, i, c) holds queries 64 i.. and head dims 64 c..), as a
  [B, T, N, H] view."""
  n_qt, n_ch = blocks.shape[1], blocks.shape[2]
  x = blocks.view(b, n, n_qt, n_ch, 64, 64).permute(0, 2, 4, 1, 3, 5)
  return x.reshape(b, n_qt * 64, n, n_ch * 64)[:, :t, :, :h]


def _split_route(q, k, v, g, out, lse, segs, simt, stats):
  """Checks the split backward's inputs; returns (sm90, stats): whether the
  Hopper kernel takes them, and lse / delta padded for it (`stats`, when
  flash_bwd_split made them for both kernels, or made here)."""
  _check_bwd_inputs(q, k, v, g, out, lse, segs)
  sm90 = _takes_sm90(q, simt)
  if sm90:
    _check_tma((q, k, v, g))
  if stats is None:
    stats = _bwd_stats(g, out, lse, _SM90_SPLIT_Q_TILE if sm90 else None)
  return sm90, stats


def flash_bwd_dq_kernel(q, k, v, g, out, lse, segs=None, *, causal=True,
                        window=None, logit_cap=0.0, sm_scale=1.0,
                        _simt=False, _stats=None):
  """K5a on the card: the interface of flash_bwd_dq_reference. bf16 goes to
  the Hopper kernel, float32 (or `_simt`) to the scalar-FMA one. Both keep
  one block's dq in f32 over the key tiles and write it once: no atomics,
  the same result from run to run."""
  sm90, stats = _split_route(q, k, v, g, out, lse, segs, _simt, _stats)
  dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
  _launch_bwd(_sm90_fns().bwd_dq if sm90 else _kernel_fns().bwd_dq,
              "dq backward", (dq,), q, k, v, g, stats, segs, causal, window,
              logit_cap, sm_scale, sm90)
  flash_attention.launches_dq += 1
  flash_attention.launches_dq_sm90 += sm90
  return dq


def flash_bwd_dkv_kernel(q, k, v, g, out, lse, segs=None, *, causal=True,
                         window=None, logit_cap=0.0, sm_scale=1.0,
                         _simt=False, _stats=None):
  """K5b on the card: the interface of flash_bwd_dkv_reference. bf16 goes to
  the Hopper kernel, float32 (or `_simt`) to the scalar-FMA one. Both keep
  one block's dk and dv in f32 over the q tiles and write them once."""
  sm90, stats = _split_route(q, k, v, g, out, lse, segs, _simt, _stats)
  dk = torch.empty(q.shape, dtype=k.dtype, device=q.device)
  dv = torch.empty(q.shape, dtype=v.dtype, device=q.device)
  _launch_bwd(_sm90_fns().bwd_dkv if sm90 else _kernel_fns().bwd_dkv,
              "dk/dv backward", (dk, dv), q, k, v, g, stats, segs, causal,
              window, logit_cap, sm_scale, sm90)
  flash_attention.launches_dkv += 1
  flash_attention.launches_dkv_sm90 += sm90
  return dk, dv


def flash_bwd_split(q, k, v, g, out, lse, segs=None, **kw):
  """K5a + K5b -> (dq, dk, dv): for CUDA tensors the kernels, fed one
  (lse, delta) pair made once for both; for CPU tensors their plain
  versions."""
  if _on(q, True, False):
    return (flash_bwd_dq_reference(q, k, v, g, out, lse, segs, **kw),
            *flash_bwd_dkv_reference(q, k, v, g, out, lse, segs, **kw))
  _, stats = _split_route(q, k, v, g, out, lse, segs, False, None)
  return (flash_bwd_dq_kernel(q, k, v, g, out, lse, segs, _stats=stats, **kw),
          *flash_bwd_dkv_kernel(q, k, v, g, out, lse, segs, _stats=stats,
                                **kw))


def _on(x, cpu_fn, cuda_fn):
  if x.device.type == "cpu":
    return cpu_fn
  if x.device.type == "cuda":
    return cuda_fn
  raise ValueError(f"flash attention: no implementation on {x.device}")


def flash_fwd(q, k, v, segs=None, **kw):
  """K1 for CUDA tensors, its plain version for CPU tensors."""
  return _on(q, flash_fwd_reference, flash_fwd_kernel)(q, k, v, segs, **kw)


def flash_bwd(q, k, v, g, out, lse, segs=None, **kw):
  """K2 for CUDA tensors, its plain version for CPU tensors."""
  return _on(q, flash_bwd_reference, flash_bwd_kernel)(
      q, k, v, g, out, lse, segs, **kw)


def flash_bwd_dq(q, k, v, g, out, lse, segs=None, **kw):
  """K5a for CUDA tensors, its plain version for CPU tensors."""
  return _on(q, flash_bwd_dq_reference, flash_bwd_dq_kernel)(
      q, k, v, g, out, lse, segs, **kw)


def flash_bwd_dkv(q, k, v, g, out, lse, segs=None, **kw):
  """K5b for CUDA tensors, its plain version for CPU tensors."""
  return _on(q, flash_bwd_dkv_reference, flash_bwd_dkv_kernel)(
      q, k, v, g, out, lse, segs, **kw)


# The forward as a custom op: what torch.utils.checkpoint's selective
# policies see and can save (JAX: the checkpoint_name'd "flash_out" and
# "flash_lse" of _flash). window < 0: no window.
@torch.library.custom_op(
    "automl_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? segs, bool causal, "
           "int window, float logit_cap, float sm_scale) -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, segs, causal, window, logit_cap, sm_scale):
  return flash_fwd(q, k, v, segs, causal=causal,
                   window=None if window < 0 else window,
                   logit_cap=logit_cap, sm_scale=sm_scale)


@_flash_fwd_op.register_fake
def _(q, k, v, segs, causal, window, logit_cap, sm_scale):
  b, t, n, _ = q.shape
  return torch.empty_like(q), q.new_empty((b * n, t), dtype=torch.float32)


class _FlashRes(torch.autograd.Function):
  """out = the forward's out, passed through (JAX's _flash_res): q, k, v,
  out and lse are its residuals, and its backward is K2 (bwd_fused) or K5a
  + K5b (or their plain versions)."""

  @staticmethod
  def forward(ctx, q, k, v, segs, out, lse, kw, bwd_fused):
    ctx.save_for_backward(q, k, v, out, lse, segs)
    ctx.kw, ctx.bwd_fused = kw, bwd_fused
    return out

  @staticmethod
  def backward(ctx, g):
    q, k, v, out, lse, segs = ctx.saved_tensors
    if g.stride(-1) != 1 or not _tma_ready(g):
      g = g.contiguous()
    args = (q, k, v, g, out, lse, segs)
    bwd = flash_bwd if ctx.bwd_fused else flash_bwd_split
    dq, dk, dv = bwd(*args, **ctx.kw)
    return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    logit_cap: float = 0.0, sm_scale: float | None = None,
                    segment_ids=None, block_q: int = 512, block_k: int = 512,
                    block_q_bwd: int | None = None,
                    block_k_bwd: int | None = None, bwd_fused: bool = False):
  """Multi-head flash attention with gradients.

  q: [B, T, N, H]; k, v: [B, T, Nkv, H] (Nkv divides N: GQA, k and v are
  repeated here so that autograd sums dk/dv over each group). Returns
  [B, T, N, H] in q's dtype. `window`: sliding-window size (None = full
  causal). `logit_cap`: tanh soft cap on the scores. `sm_scale` defaults to
  1/sqrt(H). `segment_ids`: optional [B, T] int, attention only within equal
  ids (packed sequences).

  block_q / block_k / block_q_bwd / block_k_bwd are the TPU kernels' tile
  sizes. They are accepted for the JAX signature and steer nothing: the CUDA
  kernels' tiles are their own constants. bwd_fused=False (the default, as
  in JAX) is the split backward, K5a for dq and K5b for dk/dv; True is the
  fused backward K2."""
  del block_q, block_k, block_q_bwd, block_k_bwd
  _on(q, None, None)  # raises on a device with no implementation
  b, t, n, h = q.shape
  nkv = k.shape[2]
  if nkv != n:
    if n % nkv != 0:
      raise ValueError(f"GQA requires n_heads ({n}) divisible by "
                       f"n_kv_heads ({nkv})")
    k = k.repeat_interleave(n // nkv, dim=2)
    v = v.repeat_interleave(n // nkv, dim=2)
  if sm_scale is None:
    sm_scale = 1.0 / math.sqrt(h)
  segs = None
  if segment_ids is not None:
    if tuple(segment_ids.shape) != (b, t):
      raise ValueError(f"segment_ids must be [B={b}, T={t}], "
                       f"got {tuple(segment_ids.shape)}")
    segs = segment_ids.to(torch.int32).contiguous()
  out, lse = _flash_fwd_op(q.detach(), k.detach(), v.detach(), segs,
                           bool(causal), -1 if window is None else int(window),
                           float(logit_cap or 0.0), float(sm_scale))
  kw = dict(causal=causal, window=window, logit_cap=logit_cap,
            sm_scale=sm_scale)
  return _FlashRes.apply(q, k, v, segs, out, lse, kw, bool(bwd_fused))


flash_attention.launches_fwd = 0
flash_attention.launches_bwd = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
flash_attention.launches_fwd_sm90 = 0
flash_attention.launches_bwd_sm90 = 0
flash_attention.launches_dq_sm90 = 0
flash_attention.launches_dkv_sm90 = 0


def dense_attention(q, k, v, *, causal=True, window=None, logit_cap=0.0,
                    sm_scale=None, segment_ids=None):
  """Reference O(T^2) attention in f32 (the JAX package's dense_attention)."""
  b, t, n, h = q.shape
  nkv = k.shape[2]
  if nkv != n:
    k = k.repeat_interleave(n // nkv, dim=2)
    v = v.repeat_interleave(n // nkv, dim=2)
  if sm_scale is None:
    sm_scale = 1.0 / math.sqrt(h)
  s, _ = _scores(q, k, logit_cap, sm_scale)
  mask = _mask(t, causal, window, segment_ids, q.device)
  p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
  return torch.einsum("bnqk,bknh->bqnh", p, v.float()).to(q.dtype)
