"""Smoke run of automl_tpu_torch on one NVIDIA GPU (the H100 port's quickest proof).

  python3 chip_smoke.py              # from the root of the repository
  python3 chip_smoke.py --profile    # only: profiles of a training step
                                     # (unfused and fused loss; dots_flash
                                     # with the split and the fused
                                     # backward), of a decode step and of
                                     # an EfficientDet-D0 training step (K6
                                     # knob on and off)

Phases, each of which fails the run (non-zero exit) if it fails:
  0. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  1. build: compiles the CUDA kernels from automl_tpu_torch/csrc/ with nvcc
     for sm_90a, one nvcc per source (six), all at once;
  2. K4 (decode attention) against its plain PyTorch version on the card, at
     the serving slice's shapes (decode T=1 and prefill T=512, b8, 8 heads,
     hd 128, S 1024, bf16, cap 50: the Hopper kernels of
     decode_attention_sm90.cu, split-S and wgmma; two calls must be
     bit-equal) and on small cases (GQA 8/2 with T 1-8 across both
     designs, prefix-LM and window masks that leave dead, mixed and
     all-live tiles, head-major rows with (m, l) stats and a fully-masked
     row in both designs, whole splits masked at decode; the SIMT kernel of
     decode_attention.cu on f32, hd 256 and a fully-masked row); the Hopper
     and the SIMT kernel timed in turns with CUDA events at the slice's
     shapes, beside the plain version and the library yardstick;
  3. K1 / K2 / K5a / K5b (flash-attention forward, fused backward and the
     split backward's dq and dk/dv kernels) against their plain versions at
     the training slice's shapes (b8, T 2048, 8 heads, hd 128, bf16,
     causal, cap 50, sm_scale 1; K2, K5a and K5b called twice must be
     bit-equal) and on small cases (GQA 8/2 through flash_attention with
     either backward, window 16 + cap, packed segment ids, ragged T 77 and
     200 in f32, documents of length 1; bf16 hd 32 / 64 / 128 with ragged
     T, window, segments, no cap, non-causal, documents of length 1); bf16
     K1 / K2 are the Hopper kernels (flash_attention_sm90.cu), f32 ones and
     K5a / K5b the scalar-FMA kernels (flash_attention.cu), whose bf16 K1 /
     K2 are also checked and timed at the slice's shapes, in the same call;
     timed as in 2;
  4. K3a / K3b / K3c (fused softmax xent forward, dx, dW) against their
     plain versions at the fused-loss slice's shapes (M 16,384 = b8 x T2048
     tokens, D 1,024, V 100,864, bf16 operands, cap 30, about 20% zero loss
     weights; K3b and K3c called twice must be bit-equal) and on small
     cases (ragged M and V, f32 operands, no cap, untied w through
     fused_softmax_xent's autograd against the CPU); timed as in 2;
  5. training slices: step 1 of lm-flops1e19 with use_flash_attention (K1/K2)
     against the same step on the dense attention path, with the fused loss
     "pallas" (K3) against the unfused loss at unembed_matmul_dtype
     "bfloat16_vjp" (the same operand precision), with the chunked loss
     "scan" against the unfused f32 loss, with the split backward (K5a/K5b)
     against the fused one, and with the split backward under the remat
     policies dots and dots_flash against full remat (loss, global grad
     norm, per-leaf cosine, bit-equal leaves); then cli/main_lm trains it
     for 30 steps at b8 T2048 (Lion, cosine schedule, grad clip, weight
     decay) three times: unfused and with fused_softmax_loss=pallas, both
     under full remat with K2, and with flash_bwd_fused=false,
     remat_policy=dots_flash (the JAX flagship's policy). The loss must be
     finite and fall; the full-remat runs must launch K1 exactly 2 *
     n_layers * 30 times and K2 n_layers * 30 times, every launch the Hopper
     kernel's (a counter per implementation), the fused run K3a, K3b and
     K3c 30 times each, the dots_flash run K1, K5a and K5b n_layers * 30
     times each and K2 never; a rerun of the unfused run to 31 steps must
     resume from the checkpoint at step 30;
  6. K6 (the depthwise filter gradient) against its plain version at the
     detection slice's shapes, bf16, b16: EfficientNet-B0's first stride-1
     depthwise conv [16, 32, 256, 256] k3, a k5 block [16, 240, 64, 64]
     and a head level [16, 64, 64, 64] k3 (two calls must be bit-equal),
     and on small cases (f32, ragged 15 x 17, k5 and k7, C not a multiple
     of 8, batch 1, BiFPN level 7's 4 x 4); timed as in 2;
  7. detection slice: step 1 of EfficientDet-D0 (512 x 512, b16,
     mixed_precision: bf16 compute) with the K6 knob on against the same
     step with it off, from one set of seeded weights and one batch (the
     loss equal, the depthwise kernel grads and the other grads within
     stated limits); then cli/main_det trains D0 for 20 steps with the knob
     on and 20 with it off (--use_fake_data, batch_size=16): the loss must
     be finite and fall, the knob-on run must launch K6 exactly (K6 calls
     per step, derived from the model) x 20 times and the knob-off run 0
     times, and a rerun of the knob-on run to 21 steps must resume from
     the checkpoint at step 20;
  8. serving slice: lm-flops1e19 (seeded random weights in the JAX layout
     through the converter, cast for serving) generates 512 tokens greedily
     after a 512-token prompt at batch 8, through generate_lm.load_model and
     greedy_generate. The run must launch K4 exactly n_layers * 512 times,
     every launch the Hopper kernels' (a counter per implementation); its
     prefill logits are held against the plain-attention path.

Every kernel time is the mean over calls of CUDA events around one call,
after an L2 flush and a sleep kernel that keeps the card busy while the
host enqueues the call (_time_ms). The library yardstick (library_ms) of
each attention kernel is
torch.compile'd torch.nn.attention.flex_attention with the same tanh cap as
score_mod and the same mask as a block mask (K2, K5a and K5b share its
backward, which computes dq, dk and dv together); that of K3a is the PyTorch
chain bf16 torch.matmul -> cap -> F.cross_entropy (no single PyTorch call
computes the fused loss), and K3b and K3c share that chain's autograd
backward, which computes both; that of K6 is cuDNN's weight gradient of
F.conv2d(groups=C) (torch.ops.aten.convolution_backward, weight only), the
call the port makes with the knob off. The port never calls the others. If
one cannot be compiled or run, the reason is printed and library_ms is
null.

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
# float32 outside the tensor cores, and device memory.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


# Cycles of the sleep kernel before each timed call (about 0.5 ms).
SLEEP_CYCLES = 1_000_000


def _time_ms(fn, iters: int, flush=None) -> float:
  """Mean device time of fn() in ms, CUDA events around each call; `flush`
  runs untimed before each call (to evict the cache from L2). A sleep
  kernel after it keeps the card busy while the host enqueues fn, so that
  the events bracket fn's device work and not the host's time to launch
  it (which is longer than the flush for K4 and flex_attention)."""
  import torch
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(iters):
    if flush is not None:
      flush()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
  """(bound ms, "operations" or "bytes"): the larger of the two times."""
  t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def _k4_bound(q, mask, n_kv):
  """K4's least time: q, out, the mask and the K/V of every key live for
  one query of its batch row (mask.any over T) once each; 4 flops per live
  (query, key, head, dim)."""
  b, t, n, h = q.shape
  live_keys = float(mask.any(dim=1).sum())
  nbytes = (2 * 2 * b * t * n * h + b * t * mask.shape[-1]
            + 2 * 2 * live_keys * n_kv * h)
  return _bound(4.0 * h * n * float(mask.sum()), nbytes)


def k4_phase(dev, flush):
  """K4 vs plain version; returns {shape label: dict(err, ms, plain_ms,
  library_ms, bound_ms, bound_by)} for the Hopper kernels (bf16 routes to
  csrc/decode_attention_sm90.cu), with the SIMT kernel's time beside."""
  import torch
  from automl_tpu_torch.ops import decode_attention as da
  gen = torch.Generator(device=dev).manual_seed(0)
  kern, ref = da.decode_attention, da.decode_attention_reference

  def check(label, q, kc, vc, mask, tol, sm90=True, **kw):
    before = da.decode_attention.launches_sm90
    got, want = kern(q, kc, vc, mask, **kw), ref(q, kc, vc, mask, **kw)
    torch.cuda.synchronize()
    if (da.decode_attention.launches_sm90 - before == 1) != sm90:
      raise AssertionError(f"{label}: routed to the wrong kernel")
    if not kw.get("return_stats"):
      return _compare(label, got, want, **tol), got
    _compare(f"{label} m", got[1], want[1], **F32_TOL)
    _compare(f"{label} l", got[2], want[2], **F32_TOL)
    return _compare(f"{label} out", got[0], want[0], **tol), got

  print("K4 case 1: slice shapes b8 N8/8 hd128 S1024 bf16 cap50 (Hopper "
        "kernels; the SIMT kernel of decode_attention.cu beside)")
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
    err, got = check(label, qq, kc, vc, mm, BF16_TOL, **kw)
    again = kern(qq, kc, vc, mm, **kw)
    if not torch.equal(got, again):
      raise AssertionError(f"{label}: two calls of the Hopper kernel differ")
    print(f"  {label}: a second call bit-equal")
    _compare(f"{label} SIMT kernel", kern(qq, kc, vc, mm, _simt=True, **kw),
             ref(qq, kc, vc, mm, **kw), **BF16_TOL)
    iters = 100 if qq.shape[1] == 1 else 20
    sm90 = lambda: kern(qq, kc, vc, mm, **kw)
    simt = lambda: kern(qq, kc, vc, mm, _simt=True, **kw)
    turns = [_time_ms(fn, iters, flush) for fn in (sm90, simt, simt, sm90)]
    t_kern, t_simt = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    t_ref = _time_ms(lambda: ref(qq, kc, vc, mm, **kw), iters, flush)
    bound_ms, bound_by = _k4_bound(qq, mm, n)
    t = qq.shape[1]

    def make_lib(qq=qq, mm=mm, t=t):
      qf = qq.transpose(1, 2).contiguous()                  # [B, N, T, H]
      kf = kc.reshape(b, n, h, s).transpose(2, 3).contiguous()
      vf = vc.reshape(b, n, s, h).contiguous()
      bm = block_mask(lambda bb, hh, qi, ki: mm[bb, qi, ki], B=b, H=None,
                      Q_LEN=t, KV_LEN=s, device=dev)
      return lambda: flex(qf, kf, vf, score_mod=_cap_mod(50.0),
                          block_mask=bm, scale=1.0)

    t_lib = _library_ms(label, make_lib, iters, flush)
    if t == 1:
      # What one PyTorch reduction takes to read as many bytes as the live
      # K/V: a floor for a bytes-bound kernel at this size, beside bound_ms.
      live = torch.empty(int(2 * 2 * float(mm.any(dim=1).sum()) * n * h) // 2,
                         dtype=torch.bfloat16, device=dev)
      t_read = _time_ms(lambda: live.amax(), iters, flush)
      print(f"  {label}: torch.amax over {live.numel() * 2 / 1e6:.1f} MB (the "
            f"live K/V's bytes) {t_read:.4f} ms")
      del live
    out[label] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                      bound_ms=bound_ms, bound_by=bound_by, simt_ms=t_simt)
    print(f"  {label}: Hopper kernel {t_kern:.4f} ms ({turns[0]:.4f}, "
          f"{turns[3]:.4f}), SIMT kernel {t_simt:.4f} ms ({turns[1]:.4f}, "
          f"{turns[2]:.4f}), plain {t_ref:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; live keys' K/V) (in turns, L2 flushed before each "
          f"call)")

  print("K4 case 2: GQA N8/n_kv2, T 1-8 (split-S up to T 4, wgmma above), "
        "S 200, bf16, cap 50")
  for t in range(1, 9):
    q2, kc2, vc2, mask = _kernel_inputs(dev, gen, 2, t, 8, 2, 128, 200,
                                        torch.bfloat16)
    check(f"T={t}", q2, kc2, vc2, mask, BF16_TOL, n_kv_heads=2,
          logit_cap=50.0)

  print("K4 case 3: prefix-LM and window masks (dead, mixed and all-live "
        "tiles), T 400 over S 512, N4/n_kv2, hd 64 and hd 72")
  t, s3 = 400, 512
  qi = torch.arange(t, device=dev)[:, None]
  ki = torch.arange(s3, device=dev)[None, :]
  masks = {"prefix-LM 100": (ki < 100) | (ki <= qi),
           "window 200": (ki <= qi) & (qi - ki < 200)}
  for name, m2 in masks.items():
    m2 = m2.expand(2, t, s3).contiguous()
    classes = da.mask_tile_classes_reference(m2)
    counts = [int((classes == c).sum()) for c in (da.DEAD, da.MIXED, da.LIVE)]
    if min(counts) == 0:
      raise AssertionError(f"{name}: tiles dead / mixed / live {counts}")
    for hd in (64, 72):
      q3, kc3, vc3, _ = _kernel_inputs(dev, gen, 2, t, 4, 2, hd, s3,
                                       torch.bfloat16)
      check(f"{name} hd {hd} (tiles dead/mixed/live {counts})", q3, kc3, vc3,
            m2, BF16_TOL, n_kv_heads=2, logit_cap=50.0)

  print("K4 case 4: head-major rows, return_stats, GQA 4/2, bf16, cap 50 "
        "(decode T 2 and prefill T 100), one fully-masked row each")
  for t in (2, 100):
    q4, kc4, vc4, mask = _kernel_inputs(dev, gen, 2, t, 4, 2, 128, 304,
                                        torch.bfloat16)
    mask[1, t - 1] = False
    _, (o4, _, l4) = check(f"T={t}", q4, kc4, vc4, mask, BF16_TOL,
                           n_kv_heads=2, logit_cap=50.0, layout="head_major",
                           return_stats=True)
    if (float(o4[1, t - 1].abs().max()) != 0.0
        or float(l4[1, t - 1].max()) != 0.0):
      raise AssertionError("fully-masked row: out or l is not 0")

  print("K4 case 5: decode, keys 64-511 masked for every query (whole "
        "splits dead), b2 N8/8 hd128 S1024 bf16")
  q5, kc5, vc5, _ = _kernel_inputs(dev, gen, 2, 1, 8, 8, 128, 1024,
                                   torch.bfloat16)
  k5 = torch.arange(1024, device=dev)
  mask = ((k5 < 64) | ((k5 >= 512) & (k5 < 700))).expand(2, 1, 1024)
  check("dead splits", q5, kc5, vc5, mask.contiguous(), BF16_TOL,
        n_kv_heads=8, logit_cap=50.0)

  print("K4 case 6: the SIMT kernel: GQA N8/n_kv2, ragged S, f32, no cap; "
        "hd 256 bf16; one fully-masked row, f32")
  for s6 in (77, 200):
    q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 3, 5, 8, 2, 64, s6,
                                        torch.float32)
    check(f"S={s6}", q6, kc6, vc6, mask, F32_TOL, sm90=False, n_kv_heads=2)
  q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 2, 3, 4, 1, 256, 96,
                                      torch.bfloat16)
  check("hd 256", q6, kc6, vc6, mask, BF16_TOL, sm90=False, n_kv_heads=1)
  q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 2, 3, 4, 4, 32, 50,
                                      torch.float32)
  mask[1, 2] = False
  _, got = check("fully-masked row", q6, kc6, vc6, mask, F32_TOL, sm90=False,
                 n_kv_heads=4)
  if float(got[1, 2].abs().max()) != 0.0:
    raise AssertionError("fully-masked row is not 0")
  torch.cuda.synchronize()
  return out


def _flash_inputs(dev, gen, b, t, n, h, dtype, scale=1.0):
  import torch
  return [(torch.randn((b, t, n, h), generator=gen, device=dev) * scale
           ).to(dtype) for _ in range(4)]


def flash_phase(dev, flush):
  """K1 / K2 / K5a / K5b vs their plain versions; returns {"fwd", "bwd",
  "dq", "dkv"}, each with err, ms, plain_ms, library_ms, bound_ms, bound_by
  at the slice's shapes."""
  import torch
  from automl_tpu_torch.ops import attention as fa
  gen = torch.Generator(device=dev).manual_seed(1)

  b, t, n, h = 8, 2048, 8, 128
  print(f"K1/K2/K5 case 1: slice shapes b{b} T{t} N{n}/{n} hd{h} bf16 causal "
        "cap50 sm_scale 1 (K1/K2: the Hopper kernels of "
        "flash_attention_sm90.cu; beside them the scalar-FMA kernels of "
        "flash_attention.cu, reached with _simt)")
  # q as the model feeds it: already scaled (by ~1/sqrt(hd)).
  q, k, v, g = _flash_inputs(dev, gen, b, t, n, h, torch.bfloat16)
  q = (q.float() * h ** -0.5).bfloat16()
  kw = dict(causal=True, logit_cap=50.0, sm_scale=1.0)
  out, lse = fa.flash_fwd_kernel(q, k, v, None, **kw)
  torch.cuda.synchronize()
  out_r, lse_r = fa.flash_fwd_reference(q, k, v, None, **kw)
  err_fwd = _compare("K1 out", out, out_r, **BF16_TOL)
  _compare("K1 lse", lse, lse_r, **F32_TOL)
  out_s, lse_s = fa.flash_fwd_kernel(q, k, v, None, _simt=True, **kw)
  err_fwd_simt = _compare("K1 (scalar FMA) out", out_s, out_r, **BF16_TOL)
  _compare("K1 (scalar FMA) lse", lse_s, lse_r, **F32_TOL)
  del out_s, lse_s
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
  del again
  grads_s = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, _simt=True,
                                **kw)
  err_bwd_simt = max(_compare(f"K2 (scalar FMA) {name}", x, y, **BF16_TOL)
                     for name, x, y in zip(("dq", "dk", "dv"), grads_s,
                                           grads_r))
  del grads, grads_r, grads_s
  # K5a / K5b: no atomics; each block owns its output rows, so a second
  # call is bit-equal.
  args = (q, k, v, g, out_r, lse_r, None)
  dq = fa.flash_bwd_dq_kernel(*args, **kw)
  torch.cuda.synchronize()
  err_dq = _compare("K5a dq", dq, fa.flash_bwd_dq_reference(*args, **kw),
                    **BF16_TOL)
  dk, dv = fa.flash_bwd_dkv_kernel(*args, **kw)
  torch.cuda.synchronize()
  dk_r, dv_r = fa.flash_bwd_dkv_reference(*args, **kw)
  err_dkv = max(_compare("K5b dk", dk, dk_r, **BF16_TOL),
                _compare("K5b dv", dv, dv_r, **BF16_TOL))
  del dk_r, dv_r
  same = [bool(torch.equal(dq, fa.flash_bwd_dq_kernel(*args, **kw)))] + [
      bool(torch.equal(x, y)) for x, y in zip(
          (dk, dv), fa.flash_bwd_dkv_kernel(*args, **kw))]
  print(f"  K5a, K5b called twice on the same inputs: dq, dk, dv bit-equal "
        f"{same}")
  if not all(same):
    raise AssertionError("K5a or K5b gave two results on the same inputs")
  del dq, dk, dv

  live = b * n * t * (t + 1) / 2          # causal (query, key) pairs
  elems = b * t * n * h
  bounds = {
      # 2 products of 2*H flops per live pair; q, k, v read, out (bf16) and
      # lse (f32) written
      "fwd": _bound(4.0 * h * live, 2 * 4 * elems + 4 * b * n * t),
      # 5 products; q, k, v, g, out and lse read, dq, dk, dv written
      "bwd": _bound(10.0 * h * live, 2 * 8 * elems + 4 * b * n * t),
      # K5a: 3 products (s, dp, ds k); the same inputs, dq written
      "dq": _bound(6.0 * h * live, 2 * 6 * elems + 4 * b * n * t),
      # K5b: 4 products (s, dp, ds^T q, p^T g); dk, dv written
      "dkv": _bound(8.0 * h * live, 2 * 7 * elems + 4 * b * n * t),
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
  bwd_args = (q, k, v, g, out, lse, None)
  simt = dict(kw, _simt=True)
  # The library yardstick of K2, K5a and K5b is one: flex_attention's
  # backward, which computes dq, dk and dv together.
  for key, kid, kern_fn, ref_fn, lib, err, bound in (
      ("fwd", "K1", lambda: fa.flash_fwd_kernel(q, k, v, None, **kw),
       lambda: fa.flash_fwd_reference(q, k, v, None, **kw), lib_fwd, err_fwd,
       "fwd"),
      ("fwd_simt", "K1 (scalar FMA)",
       lambda: fa.flash_fwd_kernel(q, k, v, None, **simt), "fwd", "fwd",
       err_fwd_simt, "fwd"),
      ("bwd", "K2", lambda: fa.flash_bwd_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_reference(*bwd_args, **kw), lib_bwd, err_bwd,
       "bwd"),
      ("bwd_simt", "K2 (scalar FMA)",
       lambda: fa.flash_bwd_kernel(*bwd_args, **simt), "bwd", "bwd",
       err_bwd_simt, "bwd"),
      ("dq", "K5a", lambda: fa.flash_bwd_dq_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_dq_reference(*bwd_args, **kw), "bwd", err_dq,
       "dq"),
      ("dkv", "K5b", lambda: fa.flash_bwd_dkv_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_dkv_reference(*bwd_args, **kw), "bwd", err_dkv,
       "dkv")):
    t_kern = _time_ms(kern_fn, 10, flush)
    # The plain version and the yardstick are the same call for both
    # implementations of K1 / K2: timed once, with the Hopper kernel.
    t_ref = (_time_ms(ref_fn, 5, flush) if callable(ref_fn)
             else res[ref_fn]["plain_ms"])
    t_lib = (_library_ms(kid, lib, 10, flush) if callable(lib)
             else res[lib]["library_ms"])
    bound_ms, bound_by = bounds[bound]
    res[key] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                    bound_ms=bound_ms, bound_by=bound_by)
    vs_lib = (f", {t_kern / t_lib:.2f}x the library's time" if t_lib
              else "")
    print(f"  {kid}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / t_kern:.2f}% of "
          f"it{vs_lib} (L2 flushed before each call)")
  print(f"  K1: {res['fwd_simt']['ms'] / res['fwd']['ms']:.2f}x faster than "
        f"the scalar-FMA kernel; K2: "
        f"{res['bwd_simt']['ms'] / res['bwd']['ms']:.2f}x (one call)")
  print(f"  K5a + K5b: {res['dq']['ms'] + res['dkv']['ms']:.4f} ms against "
        f"K2's {res['bwd']['ms']:.4f} ms")
  _library_ms("forward + backward", lib_fwd_bwd, 10, flush)
  del q, k, v, g, out, lse, out_r, lse_r, qf, kf, vf, gf
  torch.cuda.empty_cache()

  def both(name, q, k, v, g, segs=None, tol=F32_TOL, **kw):
    """K1, K2, K5a and K5b against the plain versions on one input."""
    o, l = fa.flash_fwd(q, k, v, segs, **kw)
    o_r, l_r = fa.flash_fwd_reference(q, k, v, segs, **kw)
    _compare(f"{name} out", o, o_r, **tol)
    _compare(f"{name} lse", l, l_r, **F32_TOL)
    args = (q, k, v, g, o_r, l_r, segs)
    ref = fa.flash_bwd_reference(*args, **kw)
    for gname, x, y in zip(("dq", "dk", "dv"), fa.flash_bwd(*args, **kw), ref):
      _compare(f"{name} {gname}", x, y, **tol)
    split = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    for gname, x, y in zip(("K5a dq", "K5b dk", "K5b dv"), split, ref):
      _compare(f"{name} {gname}", x, y, **tol)

  for fused in (False, True):
    print(f"K1/{'K2' if fused else 'K5'} case 2: GQA N8/n_kv2 through "
          f"flash_attention (autograd, bwd_fused={fused}), bf16, T 256, cap "
          "50, against the same call on the CPU's plain versions in f32")
    qg, _, _, gg = _flash_inputs(dev, gen, 2, 256, 8, 64, torch.bfloat16)
    kg, vg, _, _ = _flash_inputs(dev, gen, 2, 256, 2, 64, torch.bfloat16)
    outs = []
    for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
      xs = [x.detach().to(device, dtype).requires_grad_()
            for x in (qg, kg, vg)]
      o = fa.flash_attention(*xs, logit_cap=50.0, bwd_fused=fused)
      o.backward(gg.to(device, dtype))
      outs.append([o] + [x.grad for x in xs])
    for name, x, y in zip(("out", "dq", "dk", "dv"), *outs):
      _compare(f"GQA {name}", x, y.to(dev), **BF16_TOL)

  print("K1/K2/K5 case 3: window 16 + cap 5, f32, T 300")
  both("window", *_flash_inputs(dev, gen, 2, 300, 2, 64, torch.float32),
       window=16, logit_cap=5.0, sm_scale=0.125)
  print("K1/K2/K5 case 4: packed segment ids, f32, T 256, hd 128")
  segs = torch.cumsum((torch.rand((2, 256), generator=gen, device=dev)
                       < 0.03).int(), dim=1).int().contiguous()
  both("segments", *_flash_inputs(dev, gen, 2, 256, 2, 128, torch.float32),
       segs=segs, sm_scale=0.09)
  for tt in (77, 200):
    print(f"K1/K2/K5 case 5: ragged T {tt}, f32")
    both(f"T={tt}", *_flash_inputs(dev, gen, 2, tt, 3, 32, torch.float32),
         sm_scale=0.2, logit_cap=50.0)
  print("K1/K2/K5 case 6: documents of length 1 (each query sees only itself; "
        "a query with no live key cannot occur under causal masking)")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 1, 70, 2, 16, torch.float32)
  segs1 = torch.arange(70, device=dev, dtype=torch.int32)[None].contiguous()
  both("length-1 docs", qd, kd, vd, gd, segs=segs1, sm_scale=0.3)
  o, _ = fa.flash_fwd(qd, kd, vd, segs1, sm_scale=0.3)
  _compare("length-1 docs out == v", o, vd, atol=1e-6, rtol=0)
  # bf16: K1 and K2 are the Hopper kernels (K5a / K5b the scalar-FMA ones).
  segs_b = torch.cumsum((torch.rand((2, 200), generator=gen, device=dev)
                         < 0.03).int(), dim=1).int().contiguous()
  for name, (bb, tt, nn, hh), extra in (
      ("bf16 hd32 T77 cap50", (2, 77, 3, 32), dict(logit_cap=50.0)),
      ("bf16 hd64 T200 window 16 cap5 segments", (2, 200, 2, 64),
       dict(window=16, logit_cap=5.0, segs=segs_b)),
      ("bf16 hd128 T200 no cap", (2, 200, 2, 128), dict()),
      ("bf16 hd128 T200 non-causal window 40", (2, 200, 2, 128),
       dict(causal=False, window=40))):
    print(f"K1/K2/K5 case 7: {name}")
    both(name, *_flash_inputs(dev, gen, bb, tt, nn, hh, torch.bfloat16),
         tol=BF16_TOL, sm_scale=hh ** -0.5, **extra)
  print("K1/K2/K5 case 8: bf16 documents of length 1, hd 64")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 1, 70, 2, 64, torch.bfloat16)
  both("bf16 length-1 docs", qd, kd, vd, gd, segs=segs1, tol=BF16_TOL,
       sm_scale=0.125)
  o, _ = fa.flash_fwd(qd, kd, vd, segs1, sm_scale=0.125)
  _compare("bf16 length-1 docs out == v", o, vd, atol=0, rtol=0)
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


def _step_flops(cfg, b, t, fused=False, policy="full", split=False):
  """(executed, model) FLOPs of one training step.

  Executed: the blocks' matmuls 8 * params * tokens under full remat
  (forward, backward 2x, remat forward), 6 under the dots policies, which
  save them; the attention kernels per layer and causal pair: K1 4 * hd,
  twice (once under dots_flash, which saves its outputs), and K2 10 * hd or
  K5a + K5b 14 * hd (split); the unembed 6 * d * V * tokens, or 10 with the
  fused loss (K3a 2, K3b 4 and K3c 4: both backward kernels recompute the
  logits). Model: what the step must compute, without any recompute:
  6 * params * tokens, attention forward and backward 12 * hd per causal
  pair and layer, the unembed 6 * d * V * tokens; the same for all
  paths."""
  d, hd, n, f = cfg.model_dim, cfg.head_dim, cfg.n_heads, \
      cfg.expand_factor * cfg.model_dim
  block_params = cfg.n_layers * (d * hd * (2 * n + 2 * cfg.n_kv_heads)
                                 + (3 if cfg.use_gated_ffn else 2) * d * f)
  tokens = b * t
  live = b * n * t * (t + 1) / 2
  unembed = d * cfg.vocab_size * tokens
  k1_runs = 1 if policy == "dots_flash" else 2
  attention = cfg.n_layers * hd * live * (
      k1_runs * 4.0 + (14.0 if split else 10.0))
  executed = ((8.0 if policy == "full" else 6.0) * block_params * tokens
              + attention + (10.0 if fused else 6.0) * unembed)
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


def _step1_check(results, a, b, limits, why, bit_equal=False):
  """|dloss|, the relative difference of the global grad norms and the
  lowest per-leaf cosine of step 1 on paths a and b, within limits; and
  how many grad leaves are bit-equal (with bit_equal, all must be)."""
  import torch
  from automl_tpu_torch.train import lm_trainer
  (loss_a, g_a), (loss_b, g_b) = results[a], results[b]
  norm_a = float(lm_trainer.global_norm(g_a))
  norm_b = float(lm_trainer.global_norm(g_b))
  cos = {k: float(torch.nn.functional.cosine_similarity(
      g_a[k].flatten().double(), g_b[k].flatten().double(), dim=0))
         for k in g_a}
  worst = min(cos, key=cos.get)
  equal = sum(bool(torch.equal(g_a[k], g_b[k])) for k in g_a)
  d_loss, d_norm = abs(loss_a - loss_b), abs(norm_a / norm_b - 1)
  lim_loss, lim_norm, lim_cos = limits
  print(f"step 1, {a} vs {b}: |dloss| {d_loss:.3e} (limit {lim_loss:g}), "
        f"grad norm {norm_a:.5f} vs {norm_b:.5f} (rel. diff {d_norm:.3e}, "
        f"limit {lim_norm:g}), lowest per-leaf cosine {cos[worst]:.7f} at "
        f"{worst} (limit {lim_cos}), {equal} of {len(g_a)} grad leaves "
        f"bit-equal. {why}")
  if not (d_loss <= lim_loss and d_norm <= lim_norm and cos[worst] >= lim_cos
          and (equal == len(g_a) or not bit_equal)):
    raise AssertionError(f"step 1 on the {a} path disagrees with the {b} "
                         "path")


def _train_run(workdir, flags, steps, label, expected, flops):
  """cli/main_lm for `steps` steps with every launch count set to 0 just
  before and read just after; checks that the loss is finite and falls and
  that the launches are `expected` ({kernel: launches}). `flops`: (executed,
  model) FLOPs of a step. Returns {kernel: launches}."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import attention as fa
  from automl_tpu_torch.ops import xent

  counters = {"K1": (fa.flash_attention, "launches_fwd"),
              "K1 sm90": (fa.flash_attention, "launches_fwd_sm90"),
              "K2": (fa.flash_attention, "launches_bwd"),
              "K2 sm90": (fa.flash_attention, "launches_bwd_sm90"),
              "K5a": (fa.flash_attention, "launches_dq"),
              "K5b": (fa.flash_attention, "launches_dkv"),
              "K3a": (xent.fused_softmax_xent, "launches_fwd"),
              "K3b": (xent.fused_softmax_xent, "launches_dx"),
              "K3c": (xent.fused_softmax_xent, "launches_dw")}
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  batch = 8
  torch.cuda.reset_peak_memory_stats()
  for fn, attr in counters.values():
    setattr(fn, attr, 0)
  t0 = time.perf_counter()
  main_lm.main(flags + [f"--train_steps={steps}"])
  wall = time.perf_counter() - t0
  launches = {kid: getattr(fn, attr) for kid, (fn, attr) in counters.items()}
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
  print(f"launches in the run: {launches} (expected {expected})")
  if launches != expected:
    raise AssertionError("the run did not go through the kernels as "
                         "expected")
  step_s = float(np.median(secs[4:]))
  flops, model_flops = flops
  print(f"train b{batch} T{cfg.seq_len} ({label}): {steps} steps in "
        f"{wall:.1f} s (model build included); step "
        f"{step_s * 1e3:.1f} ms (median of steps 5-{steps}), "
        f"{batch * cfg.seq_len / step_s:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; {flops / 1e12:.2f} TFLOP per step executed "
        f"= {100 * flops / step_s / PEAK_BF16_FLOPS:.2f}% of 989 TFLOP/s, "
        f"{model_flops / 1e12:.2f} TFLOP model = "
        f"{100 * model_flops / step_s / PEAK_BF16_FLOPS:.2f}%; loss "
        f"{losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of the last 5)")
  return launches


def training_phase(dev, workdir):
  """lm-flops1e19 training through main_lm: unfused, with the fused loss,
  and with the split backward under remat_policy dots_flash; returns
  {run: {kernel: launches}} of the three 30-step runs."""
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
  split = f"{flash},flash_bwd_fused=false"
  results = _step1(dev, tree, first, {
      "flash": flash,
      "dense": "use_flash_attention=false",
      "fused pallas": f"{flash},fused_softmax_loss=pallas",
      "unfused bfloat16_vjp": f"{flash},unembed_matmul_dtype=bfloat16_vjp",
      "fused scan": f"{flash},fused_softmax_loss=scan",
      "split": split,
      "split dots": f"{split},remat_policy=dots",
      "split dots_flash": f"{split},remat_policy=dots_flash",
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
  # A remat policy changes what the backward recomputes, never a value: the
  # kernels and matmuls that run again give the same bits. Measured on the
  # H100: the loss and all 82 grad leaves bit-equal, under dots and
  # dots_flash alike; so they must be.
  for policy in ("split dots", "split dots_flash"):
    _step1_check(results, policy, "split", (0.0, 0.0, 0.999999),
                 "Must be bit-equal.", bit_equal=True)
  # The forward is the same; K5a sums dq over key tiles in registers where
  # K2 adds them in a fixed order in L2, so dq (and all that it feeds) may
  # differ in its last bits. Measured on the H100: the loss equal, norms
  # 2.0e-6 apart, cosine 0.9999984, 8 of 82 leaves bit-equal.
  _step1_check(results, "split", "flash", (1e-6, 5e-5, 0.99995),
               "The limits: 1e-6, 25x, 31x (1 - cosine) of the measured.")
  del results, tree, first
  torch.cuda.empty_cache()

  common = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
            "--warmup_steps=3", "--log_every=1", "--device=cuda"]
  flags = common + [f"--model_dir={workdir}", f"--experiment_config={flash}"]
  n = cfg.n_layers * steps
  none = dict.fromkeys(("K1", "K1 sm90", "K2", "K2 sm90", "K5a", "K5b",
                        "K3a", "K3b", "K3c"), 0)
  t = cfg.seq_len
  runs = {}
  # Full remat re-runs K1 in the backward: 2 x n_layers a step. bf16
  # activations: every K1 and K2 launch is the Hopper kernel's ("sm90").
  sm90 = lambda k1, k2: {"K1": k1, "K1 sm90": k1, "K2": k2, "K2 sm90": k2}
  runs["unfused"] = _train_run(
      workdir, flags, steps, "unfused loss, full remat, K2",
      dict(none, **sm90(2 * n, n)), _step_flops(cfg, batch, t))
  _resume_check(flags, workdir, steps)
  fused_dir = workdir + "_fused"
  runs["fused"] = _train_run(
      fused_dir, common + [
          f"--model_dir={fused_dir}",
          f"--experiment_config={flash},fused_softmax_loss=pallas"], steps,
      "fused loss, full remat, K2",
      dict(none, **sm90(2 * n, n), K3a=steps, K3b=steps, K3c=steps),
      _step_flops(cfg, batch, t, fused=True))
  split_dir = workdir + "_split"
  # dots_flash saves K1's (out, lse): K1 once per layer and step.
  runs["split"] = _train_run(
      split_dir, common + [
          f"--model_dir={split_dir}",
          f"--experiment_config={split},remat_policy=dots_flash"], steps,
      "unfused loss, remat_policy dots_flash, K5a + K5b",
      dict(none, **sm90(n, 0), K5a=n, K5b=n),
      _step_flops(cfg, batch, t, policy="dots_flash", split=True))
  torch.cuda.empty_cache()
  return runs



def _resume_check(flags, workdir, steps, cli="automl_tpu_torch.cli.main_lm"):
  """A rerun of `cli` to steps + 1 must resume from the checkpoint at
  `steps`."""
  import importlib
  importlib.import_module(cli).main(flags + [f"--train_steps={steps + 1}"])
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  if [r["step"] for r in recs][steps:] != [steps + 1]:
    raise AssertionError("the rerun did not resume from the checkpoint")
  print(f"checkpoint at step {steps} restored: the rerun trained only step "
        f"{steps + 1} (loss {recs[-1]['loss']:.4f})")


# K6 against its plain version: both sum f32 products of the same inputs,
# in other orders, over B*H*W terms per output; relative to the largest
# entry of the result. Measured on the H100 at the slice's shapes: 2.3e-7,
# 4.1e-7 and 2.5e-7; the limit is 24x the largest.
K6_SHARE = 1e-5


def k6_phase(dev, flush):
  """K6 vs its plain version; returns {shape label: dict(err, ms, plain_ms,
  library_ms, bound_ms, bound_by)} at the detection slice's shapes."""
  import torch
  from automl_tpu_torch.ops import depthwise as dw
  gen = torch.Generator(device=dev).manual_seed(3)
  cl = torch.channels_last

  def inputs(b, c, h, w, dtype):
    return [torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
            .contiguous(memory_format=cl) for _ in range(2)]

  kern, ref = dw.depthwise_filter_grad_kernel, dw.depthwise_filter_grad_reference
  shapes = {"B0 stride-1 [16,32,256,256] k3": (16, 32, 256, 256, 3),
            "k5 block [16,240,64,64] k5": (16, 240, 64, 64, 5),
            "head level [16,64,64,64] k3": (16, 64, 64, 64, 3)}
  print("K6 case 1: the detection slice's shapes, bf16, b16")
  res = {}
  for label, (b, c, h, w, k) in shapes.items():
    x, dy = inputs(b, c, h, w, torch.bfloat16)
    got = kern(x, dy, k)
    torch.cuda.synchronize()
    err = _compare_scaled(label, got, ref(x, dy, k), K6_SHARE)
    # No atomics: fixed partial sums, summed in a fixed order.
    if not torch.equal(got, kern(x, dy, k)):
      raise AssertionError(f"K6 gave two results on the same inputs: {label}")
    pad = (k - 1) // 2
    weight = torch.randn((c, 1, k, k), generator=gen, device=dev).to(
        torch.bfloat16)

    def make_lib(x=x, dy=dy, weight=weight, pad=pad, c=c):
      def fn():
        return torch.ops.aten.convolution_backward(
            dy, x, weight, None, [1, 1], [pad, pad], [1, 1], False, [0, 0],
            c, [False, True, False])[1]
      lib = fn().float()
      print(f"  {label}: cuDNN's weight gradient (bf16) against the plain "
            f"version: max|diff| {float((lib - got).abs().max()):.3e} of "
            f"max|dW| {float(got.abs().max()):.3e}")
      return fn

    t_kern = _time_ms(lambda: kern(x, dy, k), 20, flush)
    t_ref = _time_ms(lambda: ref(x, dy, k), 3, flush)
    t_lib = _library_ms(label, make_lib, 20, flush,
                        "cuDNN depthwise weight gradient")
    n = b * c * h * w
    # x and dy read once (bf16), dW written (f32); 2 k^2 f32 flops per
    # element of dy.
    bound_ms, bound_by = _bound(2.0 * k * k * n, 2 * 2 * n + 4 * c * k * k,
                                PEAK_F32_FLOPS)
    res[label] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                      bound_ms=bound_ms, bound_by=bound_by)
    print(f"  {label}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / t_kern:.2f}% "
          "of it (L2 flushed before each call)")
    del x, dy, got
  torch.cuda.empty_cache()
  print("K6 case 2: small cases")
  for name, (b, c, h, w, k, dtype) in {
      "f32 ragged 15x17 k5 C13 b1": (1, 13, 15, 17, 5, torch.float32),
      "bf16 ragged 15x17 k3 C13 b1": (1, 13, 15, 17, 3, torch.bfloat16),
      "f32 k7 C33 (two channel chunks)": (2, 33, 9, 70, 7, torch.float32),
      "f32 BiFPN level 7 4x4 k3": (16, 64, 4, 4, 3, torch.float32),
      "f32 k1": (2, 8, 5, 6, 1, torch.float32)}.items():
    x, dy = inputs(b, c, h, w, dtype)
    _compare_scaled(name, dw.depthwise_filter_grad(x, dy, k),
                    ref(x, dy, k), K6_SHARE)
  torch.cuda.synchronize()
  return res


D0_BATCH = 16


def _det_config(**overrides):
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  cfg = get_efficientdet_config("efficientdet-d0")
  cfg.override(dict(mixed_precision=True, batch_size=D0_BATCH, **overrides))
  return cfg


def _det_step1(dev, cfg):
  """(loss, grads) of step 1 of D0 with the K6 knob off and on, from one
  model (seeded weights) and one preprocessed batch, the drop_connect masks
  drawn from one seed in both."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import runners, train_lib
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  params = convert.model_state(model)
  raw = pipeline.SyntheticDetection(D0_BATCH, cfg.image_size, cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)
  batch = runners.make_preprocess(cfg)(raw, gen.manual_seed(7))
  loss_and_grads = train_lib.make_det_loss_and_grads(model, cfg)
  out = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      loss, _, grads, _ = loss_and_grads(params, batch, None,
                                         gen.manual_seed(8))
      torch.cuda.synchronize()
    finally:
      dw.enable_pallas_filter_grad(False)
    print(f"D0 step 1, K6 knob {'on' if knob else 'off'}: loss "
          f"{float(loss):.6f} ({time.perf_counter() - t0:.2f} s)")
    out[knob] = (float(loss), grads)
  k6_leaves = sorted(
      f"{name}.kernel" for name, m in model.named_modules()
      if type(m).__name__ == "DepthwiseConv2D" and m.strides == (1, 1))
  return out, k6_leaves


def _det_step1_check(out, k6_leaves):
  """The knob changes only how the depthwise filter gradients are summed:
  the loss is the same, those grads agree to bf16 rounding (both are
  rounded to the bf16 compute dtype from f32 sums in other orders), the
  rest to the last bits of the dx they feed."""
  import torch
  (loss_off, g_off), (loss_on, g_on) = out[False], out[True]

  def cos(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))

  def rel(a, b):
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))

  d_loss = abs(loss_on - loss_off)
  k6 = {k: (cos(g_on[k], g_off[k]), rel(g_on[k], g_off[k]))
        for k in k6_leaves}
  rest = [k for k in g_off if k not in k6 and g_off[k].abs().max() > 0]
  others = {k: (cos(g_on[k], g_off[k]), rel(g_on[k], g_off[k]))
            for k in rest}
  worst_cos = min(k6, key=lambda k: k6[k][0])
  worst_rel = max(k6, key=lambda k: k6[k][1])
  o_cos = min(others, key=lambda k: others[k][0])
  o_rel = max(others, key=lambda k: others[k][1])
  print(f"D0 step 1, knob on vs off: |dloss| {d_loss:.3e} (limit "
        f"{DET_STEP1_LIMITS['loss']:g}); {len(k6)} depthwise kernel grads: "
        f"lowest cosine {k6[worst_cos][0]:.7f} at {worst_cos} (limit "
        f"{DET_STEP1_LIMITS['k6_cos']}), largest max|diff| / max|grad| "
        f"{k6[worst_rel][1]:.3e} at {worst_rel} (limit "
        f"{DET_STEP1_LIMITS['k6_rel']:g}); {len(others)} other grads: lowest "
        f"cosine {others[o_cos][0]:.7f} at {o_cos} (limit "
        f"{DET_STEP1_LIMITS['other_cos']}), largest max|diff| / max|grad| "
        f"{others[o_rel][1]:.3e} at {o_rel} (limit "
        f"{DET_STEP1_LIMITS['other_rel']:g})")
  if not (d_loss <= DET_STEP1_LIMITS["loss"]
          and k6[worst_cos][0] >= DET_STEP1_LIMITS["k6_cos"]
          and k6[worst_rel][1] <= DET_STEP1_LIMITS["k6_rel"]
          and others[o_cos][0] >= DET_STEP1_LIMITS["other_cos"]
          and others[o_rel][1] <= DET_STEP1_LIMITS["other_rel"]):
    raise AssertionError("D0 step 1 with the K6 knob on disagrees with the "
                         "knob off")


# Step 1 limits, knob on vs off. Measured on the H100 (b16, bf16): the
# loss equal, the depthwise kernel grads at most 1.3e-3 of a leaf's largest
# entry apart (a bf16 step: both are rounded to bf16 from f32 sums in other
# orders), cosine 1.0000000 to 7 digits, every other grad bit-equal (the
# same cuDNN dx). The limits: 1e-6, 7.7x, 1e-4 and 1e-3 off those.
DET_STEP1_LIMITS = dict(loss=1e-6, k6_cos=0.9999, k6_rel=1e-2,
                        other_cos=0.99999, other_rel=1e-3)


def _det_train_run(workdir, flags, steps, knob, per_step):
  """cli/main_det for `steps` steps with the K6 knob set in-process and its
  launch count set to 0 just before and read just after; checks that the
  loss is finite and falls. Returns (launches, step ms, img/s, peak GiB)."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_det
  from automl_tpu_torch.ops import depthwise as dw
  torch.cuda.reset_peak_memory_stats()
  dw.enable_pallas_filter_grad(knob)
  dw.depthwise_filter_grad.launches = 0
  t0 = time.perf_counter()
  try:
    main_det.main(flags + [f"--train_steps={steps}"])
  finally:
    dw.enable_pallas_filter_grad(False)
  wall = time.perf_counter() - t0
  launches = dw.depthwise_filter_grad.launches
  peak = torch.cuda.max_memory_allocated() / 2**30
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"losses (K6 knob {'on' if knob else 'off'}): "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("training steps missing or loss not finite")
  if not np.mean(losses[-5:]) < losses[0]:
    raise AssertionError(f"loss did not fall: step 1 {losses[0]:.4f}, mean "
                         f"of the last 5 {np.mean(losses[-5:]):.4f}")
  expected = per_step * steps if knob else 0
  print(f"K6 launches in the run: {launches} (expected {expected}: "
        f"{per_step} per step x {steps} steps with the knob on, 0 off)")
  if launches != expected:
    raise AssertionError("the run did not go through K6 as expected")
  step_s = float(np.median([r["secs_per_step"] for r in recs][4:]))
  print(f"D0 train b{D0_BATCH} 512x512 bf16, K6 knob "
        f"{'on' if knob else 'off'}: {steps} steps in {wall:.1f} s (model "
        f"build included); step {step_s * 1e3:.1f} ms (median of steps "
        f"5-{steps}), {D0_BATCH / step_s:.1f} img/s, peak memory "
        f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} "
        "(mean of the last 5)")
  return launches, step_s * 1e3, D0_BATCH / step_s, peak


def detection_phase(dev, workdir):
  """EfficientDet-D0 training: step 1 knob on vs off, then 20 steps through
  main_det with the knob on (and a resume to 21) and 20 with it off.
  Returns the knob-on run's K6 launches."""
  import torch
  from automl_tpu_torch.models import efficientdet
  cfg = _det_config()
  out, k6_leaves = _det_step1(dev, cfg)
  _det_step1_check(out, k6_leaves)
  del out
  torch.cuda.empty_cache()
  per_step = efficientdet.filter_grad_calls_per_step(
      efficientdet.EfficientDet(cfg, device="meta"))
  steps = 20
  flags = ["--mode=train", "--model_name=efficientdet-d0", "--use_fake_data",
           f"--hparams=mixed_precision=true,batch_size={D0_BATCH}",
           "--log_every=1", "--device=cuda"]
  on = _det_train_run(workdir, flags + [f"--model_dir={workdir}"], steps,
                      True, per_step)
  _resume_check(flags + [f"--model_dir={workdir}"], workdir, steps,
                "automl_tpu_torch.cli.main_det")
  off_dir = workdir + "_off"
  off = _det_train_run(off_dir, flags + [f"--model_dir={off_dir}"], steps,
                       False, per_step)
  print(f"D0 step ms, knob on vs off (one call): {on[1]:.1f} vs {off[1]:.1f}"
        f"; img/s {on[2]:.1f} vs {off[2]:.1f}; peak {on[3]:.2f} vs "
        f"{off[3]:.2f} GiB")
  torch.cuda.empty_cache()
  return on[0]


def _profiled(fn):
  """(wall us, device rows, host rows) of one fn() under torch.profiler;
  fn must end in a synchronisation. Device rows: (device us, calls, kernel
  name); host rows: (self CPU us, calls, op or autograd node name), each
  sorted largest first."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as p:
    t0 = time.perf_counter()
    fn()
    wall_us = (time.perf_counter() - t0) * 1e6
  rows, host = [], []   # device: kernels only (an op's row repeats them)
  for e in p.key_averages():
    dt = getattr(e, "self_device_time_total", None)
    if dt is None:
      dt = e.self_cuda_time_total
    if dt > 0 and str(e.device_type).endswith("CUDA"):
      rows.append((dt, e.count, e.key))
    elif str(e.device_type).endswith("CPU") and e.self_cpu_time_total > 0:
      host.append((e.self_cpu_time_total, e.count, e.key))
  return wall_us, sorted(rows, reverse=True), sorted(host, reverse=True)


def profile_phase(dev):
  """Under torch.profiler (run with --profile): two steps of the training
  slice, unfused and with the fused loss "pallas" (full remat, K2), then
  under remat_policy dots_flash with the split (K5a/K5b) and the fused (K2)
  backward, device time by kernel and the device-busy share of the steps'
  wall time; then the serving
  slice's decode step, from greedy_generate with 1 and with 65 new tokens
  (the difference over 64 steps)."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules

  flash = "use_flash_attention=true"
  for overrides in (f"{flash},fused_softmax_loss=false",
                    f"{flash},fused_softmax_loss=pallas",
                    f"{flash},remat_policy=dots_flash,flash_bwd_fused=false",
                    f"{flash},remat_policy=dots_flash,flash_bwd_fused=true"):
    cfg = lm_lib.get_lm_config("lm-flops1e19")
    cfg.override(overrides)
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
    torch.cuda.reset_peak_memory_stats()

    def steps():
      nonlocal state
      for _ in range(n):
        state = step(state)

    wall_us, rows, _ = _profiled(steps)
    busy = sum(r[0] for r in rows)
    print(f"profile, {n} training steps, {overrides}: wall "
          f"{wall_us / n / 1e3:.1f} ms/step, device busy "
          f"{busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}% of "
          f"the wall time), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for dt, count, key in rows[:20]:
      print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
            f"{count // n:5d} calls/step  {key[:90]}")
    del model, state, step_fn, tx
    torch.cuda.empty_cache()

  _det_profile(dev)

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
  (_, rows_p, _), (_, rows_g, _) = _profiled(prefill), _profiled(generate)
  per_step = {}
  for rows, sign in ((rows_g, 1), (rows_p, -1)):
    for dt, _, key in rows:
      per_step[key] = per_step.get(key, 0.0) + sign * dt / (new - 1)
  busy = sum(per_step.values())
  k4 = sum(v for k, v in per_step.items()
           if "decode_attention_kernel" in k or "k4_" in k)
  wall_us = (walls[1] - walls[0]) / (new - 1) * 1e6
  print(f"profile, decode step (b{b}, {t0} + {new} tokens, cache "
        f"{t0 + new}; generate minus prefill over {new - 1} steps): wall "
        f"{wall_us / 1e3:.3f} ms/step, device busy {busy / 1e3:.3f} ms/step "
        f"({100 * busy / wall_us:.1f}% of the wall time), K4 "
        f"{k4 / 1e3:.3f} ms/step")


def _det_profile(dev):
  """D0 training steps (b16, bf16): step times with the K6 knob off / on /
  off / on in turns (5 steps each, host clock); then two steps under
  torch.profiler with the knob off, then on: device time by kernel, the
  device-busy share, host (self CPU) time by op and autograd node, and the
  ops whose host time the knob on adds or removes most."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  cfg = _det_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=cfg.momentum))
  state = train_lib.create_train_state(model, tx)
  step_fn = train_lib.make_det_train_step(
      model, tx, cfg, preprocess_fn=runners.make_preprocess(cfg))
  raw = pipeline.SyntheticDetection(D0_BATCH, cfg.image_size,
                                    cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)

  def steps(count):
    nonlocal state
    for _ in range(count):
      state, m = step_fn(state, raw, gen.manual_seed(state.step))
      float(m["loss"])

  try:
    for knob in (False, True, False, True):
      dw.enable_pallas_filter_grad(knob)
      steps(2)
      t0 = time.perf_counter()
      steps(5)
      print(f"D0 step, K6 knob {'on' if knob else 'off'} (in turns): "
            f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms")
  finally:
    dw.enable_pallas_filter_grad(False)
  n = 2
  host = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      steps(1)
      wall_us, rows, host_rows = _profiled(lambda: steps(n))
    finally:
      dw.enable_pallas_filter_grad(False)
    host[knob] = {key: (dt, count) for dt, count, key in host_rows}
    busy = sum(r[0] for r in rows)
    k6 = sum(r[0] for r in rows if "filter_grad_kernel" in r[2]
             or "reduce_parts_kernel" in r[2])
    print(f"profile, {n} D0 training steps b{D0_BATCH}, K6 knob "
          f"{'on' if knob else 'off'}: wall {wall_us / n / 1e3:.1f} ms/step, "
          f"device busy {busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}"
          f"% of the wall time), K6 {k6 / n / 1e3:.2f} ms/step, host self "
          f"time in ops {sum(r[0] for r in host_rows) / n / 1e3:.1f} ms/step")
    for dt, count, key in rows[:20]:
      print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
            f"{count // n:5d} calls/step  {key[:90]}")
    print("  host, self CPU time by op:")
    for dt, count, key in host_rows[:15]:
      print(f"  {dt / n / 1e3:9.2f} ms/step  {count // n:5d} calls/step  "
            f"{key[:90]}")
  diff = sorted(
      ((host[True].get(k, (0, 0))[0] - host[False].get(k, (0, 0))[0], k)
       for k in host[True].keys() | host[False].keys()),
      key=lambda d: -abs(d[0]))
  print("host self CPU time, knob on minus off, by op (ms/step, calls/step "
        "off -> on):")
  for d, key in diff[:15]:
    print(f"  {d / n / 1e3:+9.2f} ms/step  {host[False].get(key, (0, 0))[1] // n:5d}"
          f" -> {host[True].get(key, (0, 0))[1] // n:5d}  {key[:90]}")
  del model, state, step_fn
  torch.cuda.empty_cache()


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
  da.decode_attention.launches_sm90 = 0
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  tokens = generate()
  end.record()
  end.synchronize()
  launches = da.decode_attention.launches
  sm90 = da.decode_attention.launches_sm90
  gen_ms = start.elapsed_time(end)
  expected = cfg.n_layers * new
  print(f"decode_attention launches in the run: {launches}, {sm90} of them "
        f"the Hopper kernels' (expected {cfg.n_layers} x (1 + {new - 1}) = "
        f"{expected}, all Hopper)")
  if launches != expected or sm90 != expected:
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


def _sass_report(lib):
  """Per kernel of a built library: its wgmma (HGMMA) instructions and its
  local-memory loads and stores (LDL / STL: spills) in the SASS, by
  cuobjdump, where the toolkit has it."""
  import re
  from torch.utils.cpp_extension import CUDA_HOME
  tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                   "cuobjdump")
  if not os.path.exists(tool):
    print(f"  sass: no cuobjdump ({tool})")
    return
  sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                        text=True, timeout=120, check=False).stdout
  for body in re.split(r"\n\s*Function : ", sass)[1:]:
    name = re.sub(r".*?\d((?:flash|k4)_\w*?_kernel)(?:ILi(\d+)E)?.*",
                  lambda m: m[1] + (f"<{m[2]}>" if m[2] else ""),
                  body.splitlines()[0].strip())
    ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body)
    count = lambda *names: sum(op in names for op in ops)
    first = re.search(r"HGMMA\.\S+", body)
    print(f"  sass {lib.name.split('-')[0]}: {name}: {count('HGMMA')} "
          f"HGMMA ({first.group(0) if first else '-'}, ...), "
          f"{count('LDL', 'STL')} LDL/STL")


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
  sources = ("decode_attention", "decode_attention_sm90", "flash_attention",
             "flash_attention_sm90", "xent", "depthwise")
  with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
    libs = list(pool.map(cuda_build.build, sources))
  print(f"build: {', '.join(l.name for l in libs)} in "
        f"{time.perf_counter() - t:.1f} s (nvcc in parallel)")
  for lib in libs:
    log = lib.parent / (lib.name + ".log")
    for line in log.read_text().splitlines() if log.exists() else ():
      if "registers" in line or "spill" in line:
        print(f"  ptxas: {line.strip()}")
  for name in ("decode_attention_sm90", "flash_attention_sm90"):
    _sass_report(libs[sources.index(name)])

  if "--profile" in sys.argv[1:]:
    profile_phase(dev)
    return 0
  flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
  k4 = k4_phase(dev, flush_buf.zero_)
  flash = flash_phase(dev, flush_buf.zero_)
  k3 = xent_phase(dev, flush_buf.zero_)
  k6 = k6_phase(dev, flush_buf.zero_)
  del flush_buf
  torch.cuda.empty_cache()
  # The training runs' model_dirs, inside the checkout (build/ is ignored).
  build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
  workdir = os.path.join(build, "chip_smoke_lm")
  det_dir = os.path.join(build, "chip_smoke_det")
  for d in (workdir, workdir + "_fused", workdir + "_split", det_dir,
            det_dir + "_off"):
    shutil.rmtree(d, ignore_errors=True)
  runs = training_phase(dev, workdir)
  k6_launches = detection_phase(dev, det_dir)
  k4_launches = serving_phase(dev)
  print(f"prefill K4 at the slice's shapes: {json.dumps(k4['prefill T=512'])}")
  print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
  print(json.dumps({"kernels": [
      _entry("decode_attention",
             "automl_tpu_torch/csrc/decode_attention_sm90.cu",
             "automl_tpu/ops/decode_attention.py:51", k4_launches,
             k4["decode T=1"]),
      _entry("flash_fwd", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:82", runs["unfused"]["K1 sm90"],
             flash["fwd"]),
      _entry("flash_bwd", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:320", runs["unfused"]["K2 sm90"],
             flash["bwd"]),
      _entry("flash_bwd_dq", "automl_tpu_torch/csrc/flash_attention.cu",
             "automl_tpu/ops/attention.py:240", runs["split"]["K5a"],
             flash["dq"]),
      _entry("flash_bwd_dkv", "automl_tpu_torch/csrc/flash_attention.cu",
             "automl_tpu/ops/attention.py:277", runs["split"]["K5b"],
             flash["dkv"]),
      _entry("xent_fwd", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:66", runs["fused"]["K3a"], k3["fwd"]),
      _entry("xent_dx", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:113", runs["fused"]["K3b"], k3["dx"]),
      _entry("xent_dw", "automl_tpu_torch/csrc/xent.cu",
             "automl_tpu/ops/xent.py:138", runs["fused"]["K3c"], k3["dw"]),
      _entry("depthwise_filter_grad", "automl_tpu_torch/csrc/depthwise.cu",
             "automl_tpu/ops/depthwise.py:37", k6_launches,
             k6["B0 stride-1 [16,32,256,256] k3"]),
  ]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
