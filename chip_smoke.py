"""Smoke run of automl_tpu_torch on one NVIDIA GPU (the H100 port's quickest proof).

  python3 chip_smoke.py              # from the root of the repository
  python3 chip_smoke.py --profile    # only: profiles of a training step
                                     # (unfused and fused loss) and of a
                                     # decode step

Phases, each of which fails the run (non-zero exit) if it fails:
  0. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  1. build: compiles the CUDA kernels from automl_tpu_torch/csrc/ with nvcc
     for sm_90a, one nvcc per source, all at once;
  2. K4 (decode attention) against its plain PyTorch version on the card, at
     the serving slice's shapes (decode T=1 and prefill T=512, b8, 8 heads,
     hd 128, S 1024, bf16, cap 50) and on three small cases (GQA with a
     ragged S in f32, head-major rows with (m, l) stats, a fully-masked
     row); kernel, plain version and the library yardstick timed with CUDA
     events at the slice's shapes;
  3. K1 / K2 (flash-attention forward and fused backward) against their
     plain versions at the training slice's shapes (b8, T 2048, 8 heads,
     hd 128, bf16, causal, cap 50, sm_scale 1) and on small cases (GQA 8/2
     through flash_attention, window 16 + cap, packed segment ids, ragged T
     77 and 200 in f32, documents of length 1); timed as in 2;
  4. K3a / K3b / K3c (fused softmax xent forward, dx, dW) against their
     plain versions at the fused-loss slice's shapes (M 16,384 = b8 x T2048
     tokens, D 1,024, V 100,864, bf16 operands, cap 30, about 20% zero loss
     weights; K3b and K3c called twice must be bit-equal) and on small
     cases (ragged M and V, f32 operands, no cap, untied w through
     fused_softmax_xent's autograd against the CPU); timed as in 2;
  5. training slices: step 1 of lm-flops1e19 with use_flash_attention (K1/K2)
     against the same step on the dense attention path, with the fused loss
     "pallas" (K3) against the unfused loss at unembed_matmul_dtype
     "bfloat16_vjp" (the same operand precision), and with the chunked loss
     "scan" against the unfused f32 loss (loss, global grad norm, per-leaf
     cosine); then cli/main_lm trains it for 30 steps at b8 T2048 (Lion,
     cosine schedule, grad clip, weight decay, full remat), once unfused and
     once with fused_softmax_loss=pallas: the loss must be finite and fall,
     each run must launch K1 exactly 2 * n_layers * 30 times and K2
     n_layers * 30 times, the fused run K3a, K3b and K3c 30 times each, and
     a rerun of the unfused run to 31 steps must resume from the checkpoint
     at step 30;
  6. serving slice: lm-flops1e19 (seeded random weights in the JAX layout
     through the converter, cast for serving) generates 512 tokens greedily
     after a 512-token prompt at batch 8, through generate_lm.load_model and
     greedy_generate. The run must launch K4 exactly n_layers * 512 times;
     its prefill logits are held against the plain-attention path.

The library yardstick (library_ms) of each attention kernel is
torch.compile'd torch.nn.attention.flex_attention with the same tanh cap as
score_mod and the same mask as a block mask; that of K3a is the PyTorch
chain bf16 torch.matmul -> cap -> F.cross_entropy (no single PyTorch call
computes the fused loss), and K3b and K3c share that chain's autograd
backward, which computes both. The port never calls them. If one cannot be
compiled or run, the reason is printed and library_ms is null.

Prints a {"kernels": [...]} JSON line, then the card line, and last
{"ok": true, "device": {...}}. Imports no jax.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import shutil
import subprocess
import sys
import time

# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores,
# and device memory.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _time_ms(fn, iters: int, flush=None) -> float:
  """Mean device time of fn() in ms, CUDA events around each call; `flush`
  runs untimed before each call (to evict the cache from L2)."""
  import torch
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(iters):
    if flush is not None:
      flush()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _bound(flops: float, nbytes: float):
  """(bound ms, "operations" or "bytes"): the larger of the two times."""
  t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
  return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _library_ms(label, make_fn, iters, flush, what="flex_attention"):
  """Time of a library yardstick, or None with the reason printed."""
  try:
    fn = make_fn()
    ms = _time_ms(fn, iters, flush)
  except Exception as e:  # the yardstick only: the port never runs it
    print(f"  {label}: no library time ({type(e).__name__}: "
          f"{str(e).splitlines()[0][:300] if str(e) else ''})")
    return None
  print(f"  {label}: {what} {ms:.4f} ms")
  return ms


def _flex():
  import torch
  from torch.nn.attention import flex_attention as fx
  return torch.compile(fx.flex_attention, dynamic=False), fx.create_block_mask


def _cap_mod(cap):
  import torch

  def score_mod(score, b, h, q_idx, kv_idx):
    return cap * torch.tanh(score / cap)
  return score_mod


def _kernel_inputs(dev, gen, b, t, n, n_kv, h, s, dtype, p_live=0.7):
  import torch
  q = torch.randn((b, t, n, h), generator=gen, device=dev) * h ** -0.5
  kc = torch.randn((b * n_kv, h, s), generator=gen, device=dev)
  vc = torch.randn((b * n_kv, s, h), generator=gen, device=dev)
  mask = torch.rand((b, t, s), generator=gen, device=dev) < p_live
  mask[:, :, 0] = True
  return q.to(dtype), kc.to(dtype), vc.to(dtype), mask


def _compare(name, got, want, atol, rtol):
  """Max |got - want|; raises if outside atol + rtol * |want|."""
  import torch
  got, want = got.detach().float(), want.detach().float()
  if not torch.isfinite(got).all():
    raise AssertionError(f"{name}: non-finite kernel output")
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  max_err = float(err.max())
  print(f"  {name}: max|diff| {max_err:.3e} (atol {atol}, rtol {rtol})")
  if bad.any():
    raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                         f"tolerance, max|diff| {max_err:.3e}")
  return max_err


# bf16 outputs: both sides sum in f32 from the same bf16 inputs, then round;
# another summation order can land on the other side of a bf16 rounding
# step, one bf16 ulp: 2^-8 relative, <= 2^-6 absolute at |x| < 4.
BF16_TOL = dict(atol=1.6e-2, rtol=8e-3)
# f32: another summation order over S (or T) and H (the flash backward's
# dq over key tiles too, in a fixed order), and the card's expf/tanhf.
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def k4_phase(dev, flush):
  """K4 vs plain version; returns {shape label: dict(err, ms, plain_ms,
  library_ms, bound_ms, bound_by)}."""
  import torch
  from automl_tpu_torch.ops import decode_attention as da
  gen = torch.Generator(device=dev).manual_seed(0)
  kern, ref = da.decode_attention, da.decode_attention_reference

  print("K4 case 1: slice shapes b8 N8/8 hd128 S1024 bf16 cap50")
  b, n, h, s = 8, 8, 128, 1024
  q, kc, vc, _ = _kernel_inputs(dev, gen, b, 512, n, n, h, s, torch.bfloat16)
  prefill_mask = (torch.arange(s, device=dev)[None, :]
                  <= torch.arange(512, device=dev)[:, None]).expand(b, 512, s)
  prefill_mask = prefill_mask.contiguous()
  decode_mask = (torch.arange(s, device=dev) <= s - 2).expand(b, 1, s)
  decode_mask = decode_mask.contiguous()
  q1 = q[:, :1].contiguous()
  shapes = {"decode T=1": (q1, decode_mask), "prefill T=512": (q, prefill_mask)}
  flex, block_mask = _flex()
  out = {}
  for label, (qq, mm) in shapes.items():
    kw = dict(n_kv_heads=n, logit_cap=50.0)
    got = kern(qq, kc, vc, mm, **kw)
    torch.cuda.synchronize()
    err = _compare(label, got, ref(qq, kc, vc, mm, **kw), **BF16_TOL)
    iters = 100 if qq.shape[1] == 1 else 20
    t_kern = _time_ms(lambda: kern(qq, kc, vc, mm, **kw), iters, flush)
    t_ref = _time_ms(lambda: ref(qq, kc, vc, mm, **kw), iters, flush)
    t = qq.shape[1]
    # q, both caches, the mask and out once each; 4 flops per live
    # (query, key, head, dim)
    nbytes = 2 * (2 * b * t * n * h + 2 * b * n * h * s) + b * t * s
    bound_ms, bound_by = _bound(4.0 * h * n * float(mm.sum()), nbytes)

    def make_lib(qq=qq, mm=mm, t=t):
      qf = qq.transpose(1, 2).contiguous()                  # [B, N, T, H]
      kf = kc.reshape(b, n, h, s).transpose(2, 3).contiguous()
      vf = vc.reshape(b, n, s, h).contiguous()
      bm = block_mask(lambda bb, hh, qi, ki: mm[bb, qi, ki], B=b, H=None,
                      Q_LEN=t, KV_LEN=s, device=dev)
      return lambda: flex(qf, kf, vf, score_mod=_cap_mod(50.0),
                          block_mask=bm, scale=1.0)

    t_lib = _library_ms(label, make_lib, iters, flush)
    out[label] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                      bound_ms=bound_ms, bound_by=bound_by)
    print(f"  {label}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) (L2 flushed before each call)")

  print("K4 case 2: GQA N8/n_kv2, ragged S, f32, no cap")
  for s2 in (77, 200):
    q, kc2, vc2, mask = _kernel_inputs(dev, gen, 3, 5, 8, 2, 64, s2,
                                       torch.float32)
    got = kern(q, kc2, vc2, mask, n_kv_heads=2)
    _compare(f"S={s2}", got, ref(q, kc2, vc2, mask, n_kv_heads=2), **F32_TOL)

  print("K4 case 3: head-major rows, return_stats, GQA, bf16, cap 50")
  q, kc2, vc2, mask = _kernel_inputs(dev, gen, 2, 4, 4, 2, 128, 300,
                                     torch.bfloat16)
  kw = dict(n_kv_heads=2, logit_cap=50.0, layout="head_major",
            return_stats=True)
  (o, m, l), (o_r, m_r, l_r) = kern(q, kc2, vc2, mask, **kw), ref(
      q, kc2, vc2, mask, **kw)
  _compare("out", o, o_r, **BF16_TOL)
  _compare("m", m, m_r, **F32_TOL)
  _compare("l", l, l_r, **F32_TOL)

  print("K4 case 4: one fully-masked row, f32")
  q, kc2, vc2, mask = _kernel_inputs(dev, gen, 2, 3, 4, 4, 32, 50,
                                     torch.float32)
  mask[1, 2] = False
  got = kern(q, kc2, vc2, mask, n_kv_heads=4)
  _compare("out", got, ref(q, kc2, vc2, mask, n_kv_heads=4), **F32_TOL)
  if float(got[1, 2].abs().max()) != 0.0:
    raise AssertionError("fully-masked row is not 0")
  torch.cuda.synchronize()
  return out


def _flash_inputs(dev, gen, b, t, n, h, dtype, scale=1.0):
  import torch
  return [(torch.randn((b, t, n, h), generator=gen, device=dev) * scale
           ).to(dtype) for _ in range(4)]


def flash_phase(dev, flush):
  """K1 / K2 vs their plain versions; returns {"fwd": {...}, "bwd": {...}}
  with err, ms, plain_ms, library_ms, bound_ms, bound_by at the slice's
  shapes."""
  import torch
  from automl_tpu_torch.ops import attention as fa
  gen = torch.Generator(device=dev).manual_seed(1)

  b, t, n, h = 8, 2048, 8, 128
  print(f"K1/K2 case 1: slice shapes b{b} T{t} N{n}/{n} hd{h} bf16 causal "
        "cap50 sm_scale 1")
  # q as the model feeds it: already scaled (by ~1/sqrt(hd)).
  q, k, v, g = _flash_inputs(dev, gen, b, t, n, h, torch.bfloat16)
  q = (q.float() * h ** -0.5).bfloat16()
  kw = dict(causal=True, logit_cap=50.0, sm_scale=1.0)
  out, lse = fa.flash_fwd_kernel(q, k, v, None, **kw)
  torch.cuda.synchronize()
  out_r, lse_r = fa.flash_fwd_reference(q, k, v, None, **kw)
  err_fwd = _compare("K1 out", out, out_r, **BF16_TOL)
  _compare("K1 lse", lse, lse_r, **F32_TOL)
  grads = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, **kw)
  torch.cuda.synchronize()
  grads_r = fa.flash_bwd_reference(q, k, v, g, out_r, lse_r, None, **kw)
  err_bwd = max(_compare(f"K2 {name}", x, y, **BF16_TOL)
                for name, x, y in zip(("dq", "dk", "dv"), grads, grads_r))
  # K2 sums dq over key tiles in a fixed order: a second call is bit-equal.
  again = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, **kw)
  same = [bool(torch.equal(x, y)) for x, y in zip(grads, again)]
  print(f"  K2 called twice on the same inputs: dq, dk, dv bit-equal {same}")
  if not all(same):
    raise AssertionError("K2 gave two results on the same inputs")
  del grads, grads_r, again

  live = b * n * t * (t + 1) / 2          # causal (query, key) pairs
  elems = b * t * n * h
  bounds = {
      # 2 products of 2*H flops per live pair; q, k, v read, out (bf16) and
      # lse (f32) written
      "fwd": _bound(4.0 * h * live, 2 * 4 * elems + 4 * b * n * t),
      # 5 products; q, k, v, g, out and lse read, dq, dk, dv written
      "bwd": _bound(10.0 * h * live, 2 * 8 * elems + 4 * b * n * t),
  }
  flex, block_mask = _flex()
  bm = block_mask(lambda bb, hh, qi, ki: qi >= ki, B=None, H=None, Q_LEN=t,
                  KV_LEN=t, device=dev)
  qf, kf, vf, gf = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))

  def lib_fwd():
    return lambda: flex(qf, kf, vf, score_mod=_cap_mod(50.0), block_mask=bm,
                        scale=1.0)

  def lib_fwd_bwd():
    xs = [x.detach().requires_grad_() for x in (qf, kf, vf)]

    def fn():
      o = flex(*xs, score_mod=_cap_mod(50.0), block_mask=bm, scale=1.0)
      torch.autograd.grad(o, xs, gf)
    return fn

  def lib_bwd():
    xs = [x.detach().requires_grad_() for x in (qf, kf, vf)]
    o = flex(*xs, score_mod=_cap_mod(50.0), block_mask=bm, scale=1.0)
    return lambda: torch.autograd.grad(o, xs, gf, retain_graph=True)

  res = {}
  for key, kern_fn, ref_fn, lib, err in (
      ("fwd", lambda: fa.flash_fwd_kernel(q, k, v, None, **kw),
       lambda: fa.flash_fwd_reference(q, k, v, None, **kw), lib_fwd, err_fwd),
      ("bwd", lambda: fa.flash_bwd_kernel(q, k, v, g, out, lse, None, **kw),
       lambda: fa.flash_bwd_reference(q, k, v, g, out, lse, None, **kw),
       lib_bwd, err_bwd)):
    t_kern = _time_ms(kern_fn, 10, flush)
    t_ref = _time_ms(ref_fn, 5, flush)
    t_lib = _library_ms(f"K{1 if key == 'fwd' else 2}", lib, 10, flush)
    bound_ms, bound_by = bounds[key]
    res[key] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                    bound_ms=bound_ms, bound_by=bound_by)
    print(f"  {key}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) (L2 flushed before each call)")
  _library_ms("forward + backward", lib_fwd_bwd, 10, flush)
  del q, k, v, g, out, lse, out_r, lse_r, qf, kf, vf, gf
  torch.cuda.empty_cache()

  def both(name, q, k, v, g, segs=None, tol=F32_TOL, **kw):
    """K1 and K2 against the plain versions on one input."""
    o, l = fa.flash_fwd(q, k, v, segs, **kw)
    o_r, l_r = fa.flash_fwd_reference(q, k, v, segs, **kw)
    _compare(f"{name} out", o, o_r, **tol)
    _compare(f"{name} lse", l, l_r, **F32_TOL)
    for gname, x, y in zip(("dq", "dk", "dv"),
                           fa.flash_bwd(q, k, v, g, o_r, l_r, segs, **kw),
                           fa.flash_bwd_reference(q, k, v, g, o_r, l_r, segs,
                                                  **kw)):
      _compare(f"{name} {gname}", x, y, **tol)

  print("K1/K2 case 2: GQA N8/n_kv2 through flash_attention (autograd), "
        "bf16, T 256, cap 50, against the same call on the CPU's plain "
        "versions in f32")
  qg, _, _, gg = _flash_inputs(dev, gen, 2, 256, 8, 64, torch.bfloat16)
  kg, vg, _, _ = _flash_inputs(dev, gen, 2, 256, 2, 64, torch.bfloat16)
  outs = []
  for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
    xs = [x.detach().to(device, dtype).requires_grad_() for x in (qg, kg, vg)]
    o = fa.flash_attention(*xs, logit_cap=50.0)
    o.backward(gg.to(device, dtype))
    outs.append([o] + [x.grad for x in xs])
  for name, x, y in zip(("out", "dq", "dk", "dv"), *outs):
    _compare(f"GQA {name}", x, y.to(dev), **BF16_TOL)

  print("K1/K2 case 3: window 16 + cap 5, f32, T 300")
  both("window", *_flash_inputs(dev, gen, 2, 300, 2, 64, torch.float32),
       window=16, logit_cap=5.0, sm_scale=0.125)
  print("K1/K2 case 4: packed segment ids, f32, T 256, hd 128")
  segs = torch.cumsum((torch.rand((2, 256), generator=gen, device=dev)
                       < 0.03).int(), dim=1).int().contiguous()
  both("segments", *_flash_inputs(dev, gen, 2, 256, 2, 128, torch.float32),
       segs=segs, sm_scale=0.09)
  for tt in (77, 200):
    print(f"K1/K2 case 5: ragged T {tt}, f32")
    both(f"T={tt}", *_flash_inputs(dev, gen, 2, tt, 3, 32, torch.float32),
         sm_scale=0.2, logit_cap=50.0)
  print("K1/K2 case 6: documents of length 1 (each query sees only itself; "
        "a query with no live key cannot occur under causal masking)")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 1, 70, 2, 16, torch.float32)
  segs1 = torch.arange(70, device=dev, dtype=torch.int32)[None].contiguous()
  both("length-1 docs", qd, kd, vd, gd, segs=segs1, sm_scale=0.3)
  o, _ = fa.flash_fwd(qd, kd, vd, segs1, sm_scale=0.3)
  _compare("length-1 docs out == v", o, vd, atol=1e-6, rtol=0)
  torch.cuda.synchronize()
  return res


# K3b / K3c outputs (dx, dW, f32) against their plain versions: both round
# dz to bf16, from logits summed in another order; where a value lies near
# a rounding step the two land a bf16 step apart (2^-8 of that term).
# Measured on the H100 at the slice's shapes: 2.2e-4 (dx) and 3.2e-5 (dW)
# of the largest entry; the limit is 4.5x the larger.
XENT_GRAD_SHARE = 1e-3


def _compare_scaled(name, got, want, share):
  """_compare with atol = share * max|want| and rtol = share."""
  scale = float(want.detach().abs().max())
  return _compare(name, got, want, atol=share * scale, rtol=share)


def _xent_inputs(dev, gen, m, v, d, dtype, zero_share=0.2):
  """x [m, d], w [v, d] at dtype (logits of std ~1.6 at d 1024), targets
  int32 [m], weights [m] with about zero_share zeros."""
  import torch
  x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
  w = (torch.randn((v, d), generator=gen, device=dev) * 0.05).to(dtype)
  targets = torch.randint(0, v, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
  weights = (torch.rand((m,), generator=gen, device=dev) >= zero_share
             ).float()
  return x, w, targets, weights


def _xent_chain(x, w, targets, weights, cap):
  """The library yardstick of K3: bf16 torch.matmul, the cap, cross_entropy."""
  import torch
  z = torch.matmul(x, w.t()).float()
  z = cap * torch.tanh(z / cap)
  nll = torch.nn.functional.cross_entropy(z, targets.long(), reduction="none")
  return (nll * weights).sum() / weights.sum().clamp_min(1.0)


def xent_phase(dev, flush):
  """K3a / K3b / K3c vs their plain versions; returns {"fwd", "dx", "dw"}
  each with err, ms, plain_ms, library_ms, bound_ms, bound_by at the
  slice's shapes."""
  import torch
  from automl_tpu_torch.ops import xent
  gen = torch.Generator(device=dev).manual_seed(2)

  m, d, v, cap = 8 * 2048, 1024, 100_864, 30.0
  print(f"K3 case 1: slice shapes M {m} (b8 x T2048), D {d}, V {v}, bf16 "
        "operands, cap 30, about 20% zero loss weights")
  x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, torch.bfloat16)
  coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
  lse, tz = xent.xent_fwd_kernel(x, w, targets, logit_cap=cap)
  torch.cuda.synchronize()
  lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
  errs = {"fwd": max(_compare("K3a lse", lse, lse_r, **F32_TOL),
                     _compare("K3a tz", tz, tz_r, **F32_TOL))}
  kw = dict(logit_cap=cap, out_dtype=torch.float32)
  fns = {"dx": (xent.xent_dx_kernel, xent.xent_dx_reference, "K3b"),
         "dw": (xent.xent_dw_kernel, xent.xent_dw_reference, "K3c")}
  for key, (kern, ref, kid) in fns.items():
    got = kern(x, w, targets, lse_r, coef, **kw)
    torch.cuda.synchronize()
    errs[key] = _compare_scaled(f"{kid} {key}", got, ref(
        x, w, targets, lse_r, coef, **kw), XENT_GRAD_SHARE)
    # No atomics: each block owns its output rows, so a second call is
    # bit-equal.
    same = bool(torch.equal(got, kern(x, w, targets, lse_r, coef, **kw)))
    print(f"  {kid} called twice on the same inputs: bit-equal {same}")
    if not same:
      raise AssertionError(f"{kid} gave two results on the same inputs")
    if key == "dx":
      zero_rows = float(got[weights == 0].abs().max())
      print(f"  K3b rows of the {int((weights == 0).sum())} zero-weight "
            f"tokens: max|dx| {zero_rows}")
      if zero_rows != 0.0:
        raise AssertionError("a zero-weight token got a nonzero dx")
    del got
  torch.cuda.empty_cache()

  in_bytes = 2 * (m + v) * d + 4 * m            # x, w, targets
  bounds = {
      # the logits: 2 flops per (token, vocab, dim); lse and tz written
      "fwd": _bound(2.0 * m * v * d, in_bytes + 8 * m),
      # the logit recompute plus dz . w (dz^T . x); lse, coef read, dx (dW)
      # written in f32
      "dx": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * m * d),
      "dw": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * v * d),
  }

  def chain_fwd():
    return lambda: _xent_chain(x, w, targets, weights, cap)

  def chain_bwd():
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    loss = _xent_chain(xs, ws, targets, weights, cap)
    return lambda: torch.autograd.grad(loss, (xs, ws), retain_graph=True)

  chain = "chain bf16 matmul -> cap -> cross_entropy"
  t_lib = {"fwd": _library_ms("K3a", chain_fwd, 5, flush, chain)}
  torch.cuda.empty_cache()
  t_lib["dx"] = t_lib["dw"] = _library_ms(
      "K3b + K3c", chain_bwd, 3, flush, f"{chain}, autograd backward")
  torch.cuda.empty_cache()
  calls = {"fwd": (lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap),
                   lambda: xent.xent_fwd_reference(x, w, targets,
                                                   logit_cap=cap))}
  for key, (kern, ref, _) in fns.items():
    calls[key] = (lambda kern=kern: kern(x, w, targets, lse, coef, **kw),
                  lambda ref=ref: ref(x, w, targets, lse, coef, **kw))
  res = {}
  for key, (kern_fn, ref_fn) in calls.items():
    t_kern = _time_ms(kern_fn, 5 if key == "fwd" else 3, flush)
    t_ref = _time_ms(ref_fn, 2, flush)
    bound_ms, bound_by = bounds[key]
    res[key] = dict(err=errs[key], ms=t_kern, plain_ms=t_ref,
                    library_ms=t_lib[key], bound_ms=bound_ms,
                    bound_by=bound_by)
    print(f"  {key}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / t_kern:.2f}% "
          "of it (L2 flushed before each call)")
  del x, w, targets, weights, coef, lse, tz, lse_r, tz_r
  torch.cuda.empty_cache()

  def small(name, m, v, d, dtype, cap):
    x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, dtype)
    coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
    lse, tz = xent.xent_fwd(x, w, targets, logit_cap=cap)
    lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
    _compare(f"{name} lse", lse, lse_r, **F32_TOL)
    _compare(f"{name} tz", tz, tz_r, **F32_TOL)
    kw = dict(logit_cap=cap, out_dtype=torch.float32)
    for key, (_, ref, _) in fns.items():
      got = (xent.xent_dx if key == "dx" else xent.xent_dw)(
          x, w, targets, lse_r, coef, **kw)
      _compare_scaled(f"{name} {key}", got,
                      ref(x, w, targets, lse_r, coef, **kw), 1e-3)

  print("K3 case 2: ragged M 100, V 1000, D 128, f32 operands, cap 30")
  small("f32", 100, 1000, 128, torch.float32, 30.0)
  print("K3 case 3: ragged M 257, V 333, D 72, bf16 operands, no cap")
  small("D=72", 257, 333, 72, torch.bfloat16, 0.0)
  print("K3 case 4: untied w [D, V] through fused_softmax_xent (autograd), "
        "bf16 operands, M 150, V 700, D 64, against the same call on the "
        "CPU's plain versions")
  x, w, targets, weights = _xent_inputs(dev, gen, 150, 700, 64, torch.float32)
  w = w.t().contiguous()
  outs = []
  for device in (dev, torch.device("cpu")):
    xs = [t.detach().to(device).requires_grad_() for t in (x, w)]
    loss = xent.fused_softmax_xent(*xs, targets.to(device), weights.to(device),
                                   tied=False, logit_cap=30.0)
    loss.backward()
    outs.append([loss.detach()] + [t.grad for t in xs])
  _compare("untied loss", outs[0][0], outs[1][0].to(dev), atol=0, rtol=1e-5)
  for name, a, b in zip(("dx", "dW"), outs[0][1:], outs[1][1:]):
    _compare_scaled(f"untied {name}", a, b.to(dev), 1e-3)
  torch.cuda.synchronize()
  return res


def _step_flops(cfg, b, t, fused=False):
  """(executed, model) FLOPs of one training step with full remat.

  Executed: the blocks' matmuls 8 * params * tokens (forward, backward 2x,
  remat forward), the attention kernels (K1 twice, K2 once per layer,
  causal pairs), and the unembed 6 * d * V * tokens, or 10 with the fused
  loss (K3a 2, K3b 4 and K3c 4: both backward kernels recompute the
  logits). Model: what the step must compute, without any recompute:
  6 * params * tokens, attention forward and backward 12 * hd per causal
  pair and layer, the unembed 6 * d * V * tokens; the same for both
  losses."""
  d, hd, n, f = cfg.model_dim, cfg.head_dim, cfg.n_heads, \
      cfg.expand_factor * cfg.model_dim
  block_params = cfg.n_layers * (d * hd * (2 * n + 2 * cfg.n_kv_heads)
                                 + (3 if cfg.use_gated_ffn else 2) * d * f)
  tokens = b * t
  live = b * n * t * (t + 1) / 2
  unembed = d * cfg.vocab_size * tokens
  attention = cfg.n_layers * (2 * 4.0 * hd * live + 10.0 * hd * live)
  executed = (8.0 * block_params * tokens + attention
              + (10.0 if fused else 6.0) * unembed)
  model = (6.0 * block_params * tokens + cfg.n_layers * 12.0 * hd * live
           + 6.0 * unembed)
  return executed, model


def _step1(dev, tree, first, configs):
  """{label: (loss, grads)} of step 1 of lm-flops1e19 (lm_loss_and_grads)
  for each label's override string, from one parameter tree and batch."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer
  out = {}
  for label, overrides in configs.items():
    c = lm_lib.get_lm_config("lm-flops1e19")
    c.override(overrides)
    model = convert.load_jax_params(lm_lib.TransformerLM(c, device=dev), tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = lm_trainer.lm_loss_and_grads(model, first)
    torch.cuda.synchronize()
    print(f"step 1, {label} ({overrides}): loss {float(loss):.6f} "
          f"({time.perf_counter() - t0:.2f} s)")
    out[label] = (float(loss), grads)
    del model
  return out


def _step1_check(results, a, b, limits, why):
  """|dloss|, the relative difference of the global grad norms and the
  lowest per-leaf cosine of step 1 on paths a and b, within limits."""
  import torch
  from automl_tpu_torch.train import lm_trainer
  (loss_a, g_a), (loss_b, g_b) = results[a], results[b]
  norm_a = float(lm_trainer.global_norm(g_a))
  norm_b = float(lm_trainer.global_norm(g_b))
  cos = {k: float(torch.nn.functional.cosine_similarity(
      g_a[k].flatten().double(), g_b[k].flatten().double(), dim=0))
         for k in g_a}
  worst = min(cos, key=cos.get)
  d_loss, d_norm = abs(loss_a - loss_b), abs(norm_a / norm_b - 1)
  lim_loss, lim_norm, lim_cos = limits
  print(f"step 1, {a} vs {b}: |dloss| {d_loss:.3e} (limit {lim_loss:g}), "
        f"grad norm {norm_a:.5f} vs {norm_b:.5f} (rel. diff {d_norm:.3e}, "
        f"limit {lim_norm:g}), lowest per-leaf cosine {cos[worst]:.7f} at "
        f"{worst} (limit {lim_cos}). {why}")
  if not (d_loss <= lim_loss and d_norm <= lim_norm and cos[worst] >= lim_cos):
    raise AssertionError(f"step 1 on the {a} path disagrees with the {b} "
                         "path")


def _train_run(workdir, flags, steps, fused):
  """cli/main_lm for `steps` steps with every launch count set to 0 just
  before and read just after; checks that the loss is finite and falls.
  Returns (K1, K2, K3a, K3b, K3c) launches."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import attention as fa
  from automl_tpu_torch.ops import xent

  def counts():
    return (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd,
            xent.fused_softmax_xent.launches_fwd,
            xent.fused_softmax_xent.launches_dx,
            xent.fused_softmax_xent.launches_dw)

  cfg = lm_lib.get_lm_config("lm-flops1e19")
  batch = 8
  torch.cuda.reset_peak_memory_stats()
  fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0
  xent.fused_softmax_xent.launches_fwd = 0
  xent.fused_softmax_xent.launches_dx = 0
  xent.fused_softmax_xent.launches_dw = 0
  t0 = time.perf_counter()
  main_lm.main(flags + [f"--train_steps={steps}"])
  wall = time.perf_counter() - t0
  launches = counts()
  peak = torch.cuda.max_memory_allocated()
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  secs = [r["secs_per_step"] for r in recs]
  print(f"losses: {' '.join(f'{x:.4f}' for x in losses)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("training steps missing or loss not finite")
  if not np.mean(losses[-5:]) < losses[0]:
    raise AssertionError(f"loss did not fall: step 1 {losses[0]:.4f}, mean "
                         f"of the last 5 {np.mean(losses[-5:]):.4f}")
  n_layers = cfg.n_layers
  expected = (2 * n_layers * steps, n_layers * steps) + (
      (steps,) * 3 if fused else (0,) * 3)
  print(f"launches in the run: K1 {launches[0]}, K2 {launches[1]}, K3a "
        f"{launches[2]}, K3b {launches[3]}, K3c {launches[4]} (expected "
        f"{expected}: K1 2 x {n_layers} x {steps} with the remat forward, "
        f"K2 {n_layers} x {steps}, K3a-c {steps if fused else 0} each)")
  if launches != expected:
    raise AssertionError("the run did not go through the kernels as "
                         "expected")
  step_s = float(np.median(secs[4:]))
  flops, model_flops = _step_flops(cfg, batch, cfg.seq_len, fused)
  print(f"train b{batch} T{cfg.seq_len} ({'fused' if fused else 'unfused'} "
        f"loss): {steps} steps in {wall:.1f} s (model build included); step "
        f"{step_s * 1e3:.1f} ms (median of steps 5-{steps}), "
        f"{batch * cfg.seq_len / step_s:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; {flops / 1e12:.2f} TFLOP per step executed "
        f"= {100 * flops / step_s / PEAK_BF16_FLOPS:.2f}% of 989 TFLOP/s, "
        f"{model_flops / 1e12:.2f} TFLOP model = "
        f"{100 * model_flops / step_s / PEAK_BF16_FLOPS:.2f}%; loss "
        f"{losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of the last 5)")
  return launches


def training_phase(dev, workdir):
  """lm-flops1e19 training through main_lm, unfused and with the fused
  loss; returns the launches (K1, K2, K3a, K3b, K3c) of each 30-step run."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer

  batch, steps = 8, 30
  # Step 1 on each path, from the weights and first batch that the runs
  # below start from.
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  tree = convert.numpy_init(cfg, 0)
  first = next(iter(lm_trainer.SyntheticLMData(batch, cfg.seq_len,
                                               cfg.vocab_size)))
  first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
  flash = "use_flash_attention=true"
  results = _step1(dev, tree, first, {
      "flash": flash,
      "dense": "use_flash_attention=false",
      "fused pallas": f"{flash},fused_softmax_loss=pallas",
      "unfused bfloat16_vjp": f"{flash},unembed_matmul_dtype=bfloat16_vjp",
      "fused scan": f"{flash},fused_softmax_loss=scan",
  })
  # The dense path rounds the probabilities to bf16 before p.v (as the JAX
  # dots path does); the kernels keep them in f32, and sum in another
  # order. Measured on the H100: |dloss| 5e-5, norms 7e-6 apart, cosine
  # 0.999996; the limits are 20x, 140x and 40x those.
  _step1_check(results, "flash", "dense", (1e-3, 1e-3, 0.9999),
               "The limits: 20x, 140x, 40x (1 - cosine) of the measured.")
  # Both multiply bf16 operands with f32 sums; K3 rounds dz to bf16 where
  # the unfused backward rounds the cotangent of the logits, and both sum
  # in other orders. Measured on the H100: |dloss| 3.8e-6, norms 8.8e-5
  # apart, cosine 0.9999982.
  _step1_check(results, "fused pallas", "unfused bfloat16_vjp",
               (1e-4, 1e-3, 0.99995),
               "The limits: 26x, 11x, 28x (1 - cosine) of the measured.")
  # The same f32 math taken 256 tokens at a time, in other matmul calls.
  # Measured on the H100: |dloss| 0, norms 2.0e-6 apart, cosine 0.9999982.
  _step1_check(results, "fused scan", "flash", (1e-5, 5e-5, 0.99995),
               "The limits: 1e-5, 25x, 28x (1 - cosine) of the measured.")
  del results, tree, first
  torch.cuda.empty_cache()

  common = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
            "--warmup_steps=3", "--log_every=1", "--device=cuda"]
  flags = common + [f"--model_dir={workdir}", f"--experiment_config={flash}"]
  unfused = _train_run(workdir, flags, steps, fused=False)
  _resume_check(flags, workdir, steps)
  fused_dir = workdir + "_fused"
  fused = _train_run(fused_dir, common + [
      f"--model_dir={fused_dir}",
      f"--experiment_config={flash},fused_softmax_loss=pallas"], steps,
                     fused=True)
  torch.cuda.empty_cache()
  return unfused, fused


def _resume_check(flags, workdir, steps):
  """A rerun to steps + 1 must resume from the checkpoint at `steps`."""
  from automl_tpu_torch.cli import main_lm
  main_lm.main(flags + [f"--train_steps={steps + 1}"])
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  if [r["step"] for r in recs][steps:] != [steps + 1]:
    raise AssertionError("the rerun did not resume from the checkpoint")
  print(f"checkpoint at step {steps} restored: the rerun trained only step "
        f"{steps + 1} (loss {recs[-1]['loss']:.4f})")


def _profiled(fn):
  """(wall us, [(device us, calls, kernel name)] sorted, largest first) of
  one fn() under torch.profiler; fn must end in a synchronisation."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as p:
    t0 = time.perf_counter()
    fn()
    wall_us = (time.perf_counter() - t0) * 1e6
  rows = []   # device kernels only: an op's own row repeats its kernels'
  for e in p.key_averages():
    dt = getattr(e, "self_device_time_total", None)
    if dt is None:
      dt = e.self_cuda_time_total
    if dt > 0 and str(e.device_type).endswith("CUDA"):
      rows.append((dt, e.count, e.key))
  return wall_us, sorted(rows, reverse=True)


def profile_phase(dev):
  """Under torch.profiler (run with --profile): two steps of the training
  slice, unfused and with the fused loss "pallas", device time by kernel
  and the device-busy share of the steps' wall time; then the serving
  slice's decode step, from greedy_generate with 1 and with 65 new tokens
  (the difference over 64 steps)."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules

  for loss in ("false", "pallas"):
    cfg = lm_lib.get_lm_config("lm-flops1e19")
    cfg.override(f"use_flash_attention=true,fused_softmax_loss={loss}")
    model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev),
                                    convert.numpy_init(cfg, 0))
    lr_fn = schedules.lm_lr("cosine_decay", cfg.learning_rate,
                            num_train_steps=30, warmup_steps=3)
    tx = optimizers.build_optimizer("lion", lr_fn)
    step_fn = lm_trainer.make_lm_train_step(
        model, tx, weight_decay=cfg.weight_decay, lr_fn=lr_fn)
    state = lm_trainer.init_train_state(model, tx)
    data = iter(lm_trainer.SyntheticLMData(8, cfg.seq_len, cfg.vocab_size))

    def step(state):
      batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
      state, logs = step_fn(state, batch)
      float(logs["loss"])
      return state

    state = step(state)
    n = 2

    def steps():
      nonlocal state
      for _ in range(n):
        state = step(state)

    wall_us, rows = _profiled(steps)
    busy = sum(r[0] for r in rows)
    print(f"profile, {n} training steps, fused_softmax_loss={loss}: wall "
          f"{wall_us / n / 1e3:.1f} ms/step, device busy "
          f"{busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}% of "
          "the wall time)")
    for dt, count, key in rows[:20]:
      print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
            f"{count // n:5d} calls/step  {key[:90]}")
    del model, state, step_fn, tx
    torch.cuda.empty_cache()

  # The serving slice's shapes: b8, a 512-token prompt, cache 1024.
  _, model = generate_lm.load_model(config_name="lm-flops1e19", seed=0,
                                    device=dev)
  lm_lib.cast_lm_params_for_serving(model)
  b, t0, new = 8, 512, 512
  prompt = torch.from_numpy(np.random.default_rng(1).integers(
      3, cfg.vocab_size, (b, t0))).to(dev)
  kv_pos = torch.arange(t0 + new, device=dev).expand(b, t0 + new)
  pos = torch.arange(t0, device=dev).expand(b, t0)

  @torch.inference_mode()
  def prefill():
    model(prompt, positions=pos, cache=model.init_cache(b, t0 + new),
          cache_index=0, kv_positions=kv_pos)
    torch.cuda.synchronize()

  def generate():
    lm_lib.greedy_generate(model, prompt, new)
    torch.cuda.synchronize()

  # decode = generate - prefill, over new - 1 steps; the wall time from
  # unprofiled runs (the profiler's own host cost would inflate it).
  walls = []
  for fn in (prefill, generate):
    fn()
    t = time.perf_counter()
    fn()
    walls.append(time.perf_counter() - t)
  (_, rows_p), (_, rows_g) = _profiled(prefill), _profiled(generate)
  per_step = {}
  for rows, sign in ((rows_g, 1), (rows_p, -1)):
    for dt, _, key in rows:
      per_step[key] = per_step.get(key, 0.0) + sign * dt / (new - 1)
  busy = sum(per_step.values())
  k4 = sum(v for k, v in per_step.items() if "decode_attention_kernel" in k)
  wall_us = (walls[1] - walls[0]) / (new - 1) * 1e6
  print(f"profile, decode step (b{b}, {t0} + {new} tokens, cache "
        f"{t0 + new}; generate minus prefill over {new - 1} steps): wall "
        f"{wall_us / 1e3:.3f} ms/step, device busy {busy / 1e3:.3f} ms/step "
        f"({100 * busy / wall_us:.1f}% of the wall time), K4 "
        f"{k4 / 1e3:.3f} ms/step")


def serving_phase(dev):
  """lm-flops1e19 greedy serving; returns the K4 launches it made."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import decode_attention as da

  batch, t0, new = 8, 512, 512
  t = time.perf_counter()
  cfg, model = generate_lm.load_model(config_name="lm-flops1e19", seed=0,
                                      device=dev)
  lm_lib.cast_lm_params_for_serving(model)
  n_params = sum(p.numel() for p in model.parameters())
  print(f"lm-flops1e19: {n_params} params, d {cfg.model_dim}, "
        f"{cfg.n_layers} layers, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"hd {cfg.head_dim}, V {cfg.vocab_size}, "
        f"{cfg.activation_dtype}; built in {time.perf_counter() - t:.1f} s")
  prompt = torch.from_numpy(np.random.default_rng(1).integers(
      3, cfg.vocab_size, (batch, t0))).to(dev)
  total = t0 + new
  kv_pos = torch.arange(total, device=dev).expand(batch, total)
  pos = torch.arange(t0, device=dev).expand(batch, t0)

  @torch.inference_mode()
  def prefill():
    cache = model.init_cache(batch, total)
    return model(prompt, positions=pos, cache=cache, cache_index=0,
                 kv_positions=kv_pos)[0]

  def with_plain_attention(fn):
    cfg.use_decode_kernel = False
    try:
      return fn()
    finally:
      cfg.use_decode_kernel = True

  logits = prefill()
  logits_plain = with_plain_attention(prefill)
  if logits.shape != (batch, t0, cfg.vocab_size) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite "
                         "or of the wrong shape")
  diff = (logits - logits_plain).abs()
  max_d, mean_d = float(diff.max()), float(diff.mean())
  agree = float((logits.argmax(-1) == logits_plain.argmax(-1)).float().mean())
  # The plain path rounds scores and probabilities to bf16 (as the JAX dots
  # path does) where the kernel keeps them in f32: bf16-level noise through
  # 8 layers, on logits capped at 30.
  print(f"prefill logits, kernel vs plain attention: max|diff| {max_d:.4f} "
        f"(limit 0.25), mean|diff| {mean_d:.5f} (limit 0.02), "
        f"argmax agreement {agree:.4f}")
  if max_d > 0.25 or mean_d > 0.02:
    raise AssertionError("prefill logits disagree with the plain path")
  del logits, logits_plain, diff

  prefill_ms = _time_ms(prefill, 3)
  prefill_plain_ms = _time_ms(lambda: with_plain_attention(prefill), 3)
  print(f"prefill b{batch} x {t0}: {prefill_ms:.2f} ms "
        f"(plain attention {prefill_plain_ms:.2f} ms)")

  def generate():
    return lm_lib.greedy_generate(model, prompt, new)

  lm_lib.greedy_generate(model, prompt, 4)      # warm the decode shapes
  torch.cuda.synchronize()
  da.decode_attention.launches = 0
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  tokens = generate()
  end.record()
  end.synchronize()
  launches = da.decode_attention.launches
  gen_ms = start.elapsed_time(end)
  expected = cfg.n_layers * new
  print(f"decode_attention launches in the run: {launches} "
        f"(expected {cfg.n_layers} x (1 + {new - 1}) = {expected})")
  if launches != expected:
    raise AssertionError("the run did not go through the kernel as expected")
  if tokens.shape != (batch, total) or not bool(
      (tokens[:, :t0] == prompt).all()) or not bool(
          ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
    raise AssertionError("generated tokens malformed")

  start.record()
  tokens_plain = with_plain_attention(generate)
  end.record()
  end.synchronize()
  plain_ms = start.elapsed_time(end)
  same = tokens[:, t0:] == tokens_plain[:, t0:]
  prefix = [int(r.cumprod(0).sum()) for r in same.int()]
  decode_ms = (gen_ms - prefill_ms) / (new - 1)
  print(f"generate b{batch}, {t0} + {new} tokens: {gen_ms:.1f} ms; "
        f"decode {decode_ms:.3f} ms/step, "
        f"{batch * new / gen_ms * 1e3:.1f} tokens/s "
        f"(plain attention: {plain_ms:.1f} ms, "
        f"{(plain_ms - prefill_plain_ms) / (new - 1):.3f} ms/step)")
  print(f"generated tokens equal to the plain-attention run: "
        f"{int(same.sum())} of {same.numel()}; equal prefix per row {prefix}")
  return launches


def _entry(name, source, replaces, launches, r):
  return {"name": name, "route": "cuda", "source": source,
          "replaces": replaces, "launches": launches,
          "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
          "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
          "library_ms": r["library_ms"]}


def main() -> int:
  import torch
  from automl_tpu_torch.ops import cuda_build

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU",
          file=sys.stderr)
    return 1
  t_start = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda:0")
  card = subprocess.run(
      ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  print(f"card: {card}")
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

  t = time.perf_counter()
  sources = ("decode_attention", "flash_attention", "xent")
  with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
    libs = list(pool.map(cuda_build.build, sources))
  print(f"build: {', '.join(l.name for l in libs)} in "
        f"{time.perf_counter() - t:.1f} s (nvcc in parallel)")
  for lib in libs:
    log = lib.parent / (lib.name + ".log")
    for line in log.read_text().splitlines() if log.exists() else ():
      if "registers" in line or "spill" in line:
        print(f"  ptxas: {line.strip()}")

  if "--profile" in sys.argv[1:]:
    profile_phase(dev)
    return 0
  flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
  k4 = k4_phase(dev, flush_buf.zero_)
  flash = flash_phase(dev, flush_buf.zero_)
  k3 = xent_phase(dev, flush_buf.zero_)
  del flush_buf
  torch.cuda.empty_cache()
  # The training runs' model_dirs, inside the checkout (build/ is ignored).
  workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_lm")
  for d in (workdir, workdir + "_fused"):
    shutil.rmtree(d, ignore_errors=True)
  (k1_launches, k2_launches, *_), k3_launches = training_phase(dev, workdir)
  k4_launches = serving_phase(dev)
  print(f"prefill K4 at the slice's shapes: {json.dumps(k4['prefill T=512'])}")
  print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
  print(json.dumps({"kernels": [
      _entry("decode_attention", "automl_tpu_torch/csrc/decode_attention.cu",
             "automl_tpu/ops/decode_attention.py:51", k4_launches,
             k4["decode T=1"]),
      _entry("flash_fwd", "automl_tpu_torch/csrc/flash_attention.cu",
             "automl_tpu/ops/attention.py:82", k1_launches, flash["fwd"]),
      _entry("flash_bwd", "automl_tpu_torch/csrc/flash_attention.cu",
             "automl_tpu/ops/attention.py:320", k2_launches, flash["bwd"]),
      _entry("xent_fwd", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:66", k3_launches[2], k3["fwd"]),
      _entry("xent_dx", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:113", k3_launches[3], k3["dx"]),
      _entry("xent_dw", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:138", k3_launches[4], k3["dw"]),
  ]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
