"""Smoke run of automl_tpu_torch on one NVIDIA GPU (the H100 port's quickest proof).

  python3 chip_smoke.py              # from the root of the repository
  python3 chip_smoke.py --profile    # only: profiles of a training step
                                     # (unfused and fused loss; dots_flash
                                     # with the split and the fused
                                     # backward), of a decode step, of
                                     # an EfficientDet-D0 training step (K6
                                     # knob on and off), of D0 b32
                                     # inference (pre_nms_topk 2048, 5000)
                                     # and of a V2-S training step at 296
                                     # (knob on; RandAugment's share)

Phases, each of which fails the run (non-zero exit) if it fails:
  0. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
  1. build: compiles the CUDA kernels from automl_tpu_torch/csrc/ with nvcc
     for sm_90a, one nvcc per source (eight), all at once; prints each
     kernel's registers and spills, and the HGMMA and LDL/STL counts of the
     Hopper kernels' SASS;
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
     K1 / K2 / K5a / K5b are the Hopper kernels (flash_attention_sm90.cu),
     f32 ones the scalar-FMA kernels (flash_attention.cu), whose bf16
     instances are also checked and timed at the slice's shapes, in the
     same call; timed as in 2;
  4. K3a / K3b / K3c (fused softmax xent forward, dx, dW) against their
     plain versions at the fused-loss slice's shapes (M 16,384 = b8 x T2048
     tokens, D 1,024, V 100,864, bf16 operands, cap 30, about 20% zero loss
     weights; bf16 K3a, K3b and K3c are the Hopper kernels of
     xent_sm90.cu, called twice they must be bit-equal; the kernels of
     xent.cu, reached with _simt, are checked and timed beside them in the
     same call) and on small cases (the default LM's M 4,096, V 32,000, D
     2,048 through all three, K3a timed beside xent.cu's and the chain's
     forward; ragged M and V at D 256, 512 and 2,048; cap 0; f32 operands
     and bf16 D 72, which take xent.cu's kernels; untied w through
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
     times each (every launch the Hopper kernel's) and K2 never (the fused
     run's K3a, K3b and K3c launches all the Hopper kernels'); a rerun of
     the unfused run to 31 steps must resume from the checkpoint at step
     30;
  6. K6 (the depthwise filter gradient) against its plain version at every
     map of a D0 step (the 13 shapes of its 76 stride-1 depthwise convs,
     bf16, b16: the Hopper kernel of depthwise_sm90.cu, two calls
     bit-equal; the kernel of depthwise.cu, reached with _simt, checked
     and timed beside it), with the launch-weighted sums over a step, and
     on small cases (f32 and C not a multiple of 8, which take
     depthwise.cu: ragged 15 x 17, k5 and k7, batch 1, BiFPN level 7's
     4 x 4, k1; bf16 k7 and k1, a ragged map and a ragged channel chunk on
     the Hopper kernel); timed as in 2, in turns;
  7. detection slice: step 1 of EfficientDet-D0 (512 x 512, b16,
     mixed_precision: bf16 compute) with the K6 knob on against the same
     step with it off, from one set of seeded weights and one batch (the
     loss equal, the depthwise kernel grads and the other grads within
     stated limits); then cli/main_det trains D0 for 20 steps with the knob
     on and 20 with it off (--use_fake_data, batch_size=16): the loss must
     be finite and fall, the knob-on run must launch K6 exactly (K6 calls
     per step, derived from the model) x 20 times, every launch the Hopper
     kernel's, and the knob-off run 0 times, and a rerun of the knob-on run
     to 21 steps must resume from the checkpoint at step 20;
  8. detection inference and eval: D0 (512 x 512, b32, mixed_bfloat16,
     seeded weights, class-predict bias 0 and kernel x300) forward on the
     card, then postprocess_combined (hard NMS) and postprocess_global
     (gaussian) at pre_nms_topk 5000 and 2048 on the card, under sync
     debug mode "error" (a host sync inside raises), and on the CPU from
     the same raw outputs: hard, the same valid_len and classes, boxes and
     scores within INFER_BOX_TOL / INFER_SCORE_TOL in every slot;
     gaussian, the same in the confident slots (score > INFER_CONFIDENT)
     up to the first near tie;
     cli/bench_det (D0 b32 forward + postprocess, CUDA events) as a
     subprocess at pre_nms_topk 2048 and 5000, its JSON lines printed;
     entry() on the card (zeros [1, 512, 512, 3]); evaluate_detection on
     D0 b16 with the EMA params of the 20-step knob-off run, 2 synthetic
     batches, in COCO mode (every metric finite or -1) and testdev_dir
     mode (the JSON rows with their four keys); the closed loop of
     tests/test_closed_loop.py through the port (efficientdet-test, 400
     steps on one box-coded batch, then hard-NMS eval): AP50 > 0.5;
  9. classification: (g) K6 at every map of V2-S's stride-1 depthwise
     convs at 168 and 296 (bf16, b8 and b V2S_BATCH) against its plain
     version, timed in turns with depthwise.cu's and cuDNN's (in phase 6's
     call); (a) cli/infer_cls bm on EfficientNetV2-B0 224 b8 and V2-S 384
     b32, and the card's f32 logits against the CPU's (B0 b8, V2-S b4; atol
     CLS_LOGIT_ATOL, top-5 equal; the bf16 top-1 agreement printed); (b)
     cli/main_cls trains V2-S (b V2S_BATCH, bf16, RMSProp, EMA, RandAugment)
     in a child process over its 4 progressive stages (168 / 208 / 256 /
     296, 10 steps each) with the K6 knob on and off: the loss finite and
     falling within each stage after the first, 28 K6 launches a step, all
     the Hopper kernel's, with the knob and none without, per stage step
     ms, img/s and peak memory, and the two runs' losses within
     CLS_KNOB_RTOL of each other; (c) V2-S step 1 (b8, 168) knob on
     against off (DET_STEP1_LIMITS), and two f32 steps on the card against
     the CPU (the losses within CLS_LOSS_RTOL; step 1's params, BN
     statistics and EMA within CLS_UPDATE_ATOL / CLS_STATE_SHARE of the
     step's change); (d) 10 steps with mixup and cutmix 0.2; (e)
     cls_train_preprocess on the card against the CPU from the same draws
     (PRE_ATOL, PRE_WARP_SHARE); (f) evaluate_classification at 384 with
     the EMA of the run's last checkpoint;
  10. serving slice: lm-flops1e19 (seeded random weights in the JAX layout
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
        "cap50 sm_scale 1 (K1/K2/K5a/K5b: the Hopper kernels of "
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
  dq_r = fa.flash_bwd_dq_reference(*args, **kw)
  dk_r, dv_r = fa.flash_bwd_dkv_reference(*args, **kw)
  before = (fa.flash_attention.launches_dq_sm90,
            fa.flash_attention.launches_dkv_sm90)
  dq = fa.flash_bwd_dq_kernel(*args, **kw)
  dk, dv = fa.flash_bwd_dkv_kernel(*args, **kw)
  torch.cuda.synchronize()
  if (fa.flash_attention.launches_dq_sm90 - before[0],
      fa.flash_attention.launches_dkv_sm90 - before[1]) != (1, 1):
    raise AssertionError("bf16 K5a / K5b did not go to the Hopper kernels")
  err_dq = _compare("K5a dq", dq, dq_r, **BF16_TOL)
  err_dkv = max(_compare("K5b dk", dk, dk_r, **BF16_TOL),
                _compare("K5b dv", dv, dv_r, **BF16_TOL))
  same = [bool(torch.equal(dq, fa.flash_bwd_dq_kernel(*args, **kw)))] + [
      bool(torch.equal(x, y)) for x, y in zip(
          (dk, dv), fa.flash_bwd_dkv_kernel(*args, **kw))]
  print(f"  K5a, K5b called twice on the same inputs: dq, dk, dv bit-equal "
        f"{same}")
  if not all(same):
    raise AssertionError("K5a or K5b gave two results on the same inputs")
  del dq, dk, dv
  dq = fa.flash_bwd_dq_kernel(*args, _simt=True, **kw)
  err_dq_simt = _compare("K5a (scalar FMA) dq", dq, dq_r, **BF16_TOL)
  dk, dv = fa.flash_bwd_dkv_kernel(*args, _simt=True, **kw)
  err_dkv_simt = max(_compare("K5b (scalar FMA) dk", dk, dk_r, **BF16_TOL),
                     _compare("K5b (scalar FMA) dv", dv, dv_r, **BF16_TOL))
  del dq, dk, dv, dq_r, dk_r, dv_r

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
  # backward, which computes dq, dk and dv together. The scalar-FMA kernels
  # are timed right after the Hopper ones, in the same call.
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
      ("dq_simt", "K5a (scalar FMA)",
       lambda: fa.flash_bwd_dq_kernel(*bwd_args, **simt), "dq", "bwd",
       err_dq_simt, "dq"),
      ("dkv", "K5b", lambda: fa.flash_bwd_dkv_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_dkv_reference(*bwd_args, **kw), "bwd", err_dkv,
       "dkv"),
      ("dkv_simt", "K5b (scalar FMA)",
       lambda: fa.flash_bwd_dkv_kernel(*bwd_args, **simt), "dkv", "bwd",
       err_dkv_simt, "dkv")):
    t_kern = _time_ms(kern_fn, 10, flush)
    # The plain version and the yardstick are the same call for both
    # implementations of a kernel: timed once, with the Hopper kernel.
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
  print("  faster than the scalar-FMA kernel (one call): " + ", ".join(
      f"{kid} {res[key + '_simt']['ms'] / res[key]['ms']:.2f}x"
      for kid, key in (("K1", "fwd"), ("K2", "bwd"), ("K5a", "dq"),
                       ("K5b", "dkv"))))
  split_ms = res["dq"]["ms"] + res["dkv"]["ms"]
  print(f"  K5a + K5b: {split_ms:.4f} ms against K2's {res['bwd']['ms']:.4f} "
        f"ms ({split_ms / res['bwd']['ms']:.2f}x); the scalar-FMA K5a + K5b "
        f"{res['dq_simt']['ms'] + res['dkv_simt']['ms']:.4f} ms")
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
  # bf16: K1, K2, K5a and K5b are the Hopper kernels.
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


def _xent_bounds(m, v, d):
  """{"fwd", "dx", "dw"}: (bound ms, bound by) of K3a / K3b / K3c."""
  in_bytes = 2 * (m + v) * d + 4 * m            # x, w, targets
  return {
      # the logits: 2 flops per (token, vocab, dim); lse and tz written
      "fwd": _bound(2.0 * m * v * d, in_bytes + 8 * m),
      # the logit recompute plus dz . w (dz^T . x); lse, coef read, dx (dW)
      # written in f32
      "dx": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * m * d),
      "dw": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * v * d),
  }


def xent_phase(dev, flush):
  """K3a / K3b / K3c vs their plain versions; returns {"fwd", "dx", "dw"}
  each with err, ms, plain_ms, library_ms, bound_ms, bound_by at the
  slice's shapes (the Hopper kernels of csrc/xent_sm90.cu, with their
  csrc/xent.cu predecessors' times from the same call as simt_ms)."""
  import torch
  from automl_tpu_torch.ops import xent
  gen = torch.Generator(device=dev).manual_seed(2)
  f = xent.fused_softmax_xent

  def sm90_launches():
    return f.launches_dx_sm90 + f.launches_dw_sm90

  def fwd_checked(name, x, w, targets, cap, sm90):
    """K3a through the wrapper against its plain version (F32_TOL), routed
    as `sm90` says; a Hopper call twice must be bit-equal."""
    before = f.launches_fwd_sm90
    lse, tz = xent.xent_fwd(x, w, targets, logit_cap=cap)
    torch.cuda.synchronize()
    if f.launches_fwd_sm90 - before != int(sm90):
      raise AssertionError(f"K3a {name}: routed to the wrong kernel")
    lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
    err = max(_compare(f"{name} K3a lse", lse, lse_r, **F32_TOL),
              _compare(f"{name} K3a tz", tz, tz_r, **F32_TOL))
    if sm90:
      again = xent.xent_fwd(x, w, targets, logit_cap=cap)
      same = all(torch.equal(a, b) for a, b in zip((lse, tz), again))
      print(f"  {name} K3a called twice on the same inputs: bit-equal {same}")
      if not same:
        raise AssertionError(f"K3a {name} gave two results on the same "
                             "inputs")
    return lse, tz, lse_r, err

  m, d, v, cap = 8 * 2048, 1024, 100_864, 30.0
  print(f"K3 case 1: slice shapes M {m} (b8 x T2048), D {d}, V {v}, bf16 "
        "operands, cap 30, about 20% zero loss weights (K3a-c: the Hopper "
        "kernels of xent_sm90.cu; beside them those of xent.cu, reached with "
        "_simt)")
  x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, torch.bfloat16)
  coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
  lse, tz, lse_r, err = fwd_checked("slice", x, w, targets, cap, True)
  errs = {"fwd": err}
  lse_s, tz_s = xent.xent_fwd_kernel(x, w, targets, logit_cap=cap, _simt=True)
  _compare("slice K3a (xent.cu) lse", lse_s, lse_r, **F32_TOL)
  del lse_s, tz_s
  active = xent.sm90_clusters(d, "fwd")
  print(f"  K3a: {-(-m // 128)} clusters of {d // 256} blocks, {active} at "
        f"once on this card; split plan (whole tiles, parts of each of the "
        f"rest) {xent.split_plan(-(-m // 128), active, -(-v // 64))}")
  kw = dict(logit_cap=cap, out_dtype=torch.float32)
  fns = {"dx": (xent.xent_dx_kernel, xent.xent_dx_reference, "K3b"),
         "dw": (xent.xent_dw_kernel, xent.xent_dw_reference, "K3c")}
  for key, (kern, ref, kid) in fns.items():
    before = sm90_launches()
    got = kern(x, w, targets, lse_r, coef, **kw)
    torch.cuda.synchronize()
    if sm90_launches() != before + 1:
      raise AssertionError(f"{kid}: the bf16 slice did not go to the Hopper "
                           "kernel")
    want = ref(x, w, targets, lse_r, coef, **kw)
    errs[key] = _compare_scaled(f"{kid} {key}", got, want, XENT_GRAD_SHARE)
    # No atomics: each block writes its outputs once, and partial sums are
    # added in a fixed order, so a second call is bit-equal.
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
    got = kern(x, w, targets, lse_r, coef, _simt=True, **kw)
    _compare_scaled(f"{kid} (xent.cu) {key}", got, want, XENT_GRAD_SHARE)
    del got, want
    own, streamed = (m, v) if key == "dx" else (v, m)
    active = xent.sm90_clusters(d, key)
    plan = xent.split_plan(-(-own // 128), active, -(-streamed // 64))
    print(f"  {kid}: {-(-own // 128)} clusters of {d // 256} blocks, {active}"
          f" at once on this card; split plan (whole tiles, parts of each of "
          f"the rest) {plan}")
  torch.cuda.empty_cache()

  bounds = _xent_bounds(m, v, d)

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
  res = {}
  new = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap)
  old = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap,
                                     _simt=True)
  turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
  t_kern, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
  t_ref = _time_ms(lambda: xent.xent_fwd_reference(x, w, targets,
                                                   logit_cap=cap), 2, flush)
  res["fwd"] = dict(err=errs["fwd"], ms=t_kern, plain_ms=t_ref,
                    library_ms=t_lib["fwd"], bound_ms=bounds["fwd"][0],
                    bound_by=bounds["fwd"][1], simt_ms=t_old)
  # w's L2 reads by design: once per block of 64 tokens up to D 1,024 (x
  # resident), once per cluster of 128 above (xent.cu's K3a reads x again
  # for each 128-wide vocab tile).
  l2_fwd = -(-m // (64 if d <= xent.SM90_RESIDENT_DIM else 128)) * 2.0 * v * d
  print(f"  K3a: Hopper kernel {t_kern:.4f} ms ({turns[0]:.4f}, "
        f"{turns[3]:.4f}), xent.cu kernel {t_old:.4f} ms ({turns[1]:.4f}, "
        f"{turns[2]:.4f}): {t_old / t_kern:.2f}x; plain {t_ref:.4f} ms, "
        f"bound {bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}), "
        f"{100 * bounds['fwd'][0] / t_kern:.2f}% of it; w from L2 by design "
        f"{l2_fwd / 1e9:.1f} GB = {l2_fwd / t_kern / 1e9:.2f} TB/s (in turns, "
        "L2 flushed before each call)")
  # The streamed operand's L2 reads by design: each cluster of
  # xent_sm90.cu reads it once (dx: w per 128 tokens; dW: x per 128 vocab
  # rows).
  l2_bytes = {"dx": -(-m // 128) * 2.0 * v * d,
              "dw": -(-v // 128) * 2.0 * m * d}
  for key, (kern, ref, kid) in fns.items():
    new = lambda kern=kern: kern(x, w, targets, lse, coef, **kw)
    old = lambda kern=kern: kern(x, w, targets, lse, coef, _simt=True, **kw)
    turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
    t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    t_ref = _time_ms(lambda ref=ref: ref(x, w, targets, lse, coef, **kw), 2,
                     flush)
    bound_ms, bound_by = bounds[key]
    res[key] = dict(err=errs[key], ms=t_new, plain_ms=t_ref,
                    library_ms=t_lib[key], bound_ms=bound_ms,
                    bound_by=bound_by, simt_ms=t_old)
    print(f"  {kid}: Hopper kernel {t_new:.4f} ms ({turns[0]:.4f}, "
          f"{turns[3]:.4f}), xent.cu kernel {t_old:.4f} ms ({turns[1]:.4f}, "
          f"{turns[2]:.4f}): {t_old / t_new:.2f}x; plain {t_ref:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / t_new:.2f}% of it; the streamed operand from "
          f"L2 by design {l2_bytes[key] / 1e9:.1f} GB = "
          f"{l2_bytes[key] / t_new / 1e9:.2f} TB/s (in turns, L2 flushed "
          "before each call)")
  both = res["dx"]["ms"] + res["dw"]["ms"]
  if t_lib["dx"]:
    print(f"  K3b + K3c: {both:.4f} ms = {both / t_lib['dx']:.2f}x the "
          f"chain's backward ({t_lib['dx']:.4f} ms)")
  del x, w, targets, weights, coef, lse, tz, lse_r
  torch.cuda.empty_cache()

  def small(name, m, v, d, dtype, cap, sm90, time_it=False):
    x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, dtype)
    coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
    _, _, lse_r, _ = fwd_checked(name, x, w, targets, cap, sm90)
    if time_it:
      new = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap)
      old = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap,
                                         _simt=True)
      turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
      chain = _library_ms(f"{name} K3a", lambda: lambda: _xent_chain(
          x, w, targets, weights, cap), 3, flush,
          "chain bf16 matmul -> cap -> cross_entropy")
      bound_ms, bound_by = _xent_bounds(m, v, d)["fwd"]
      print(f"  {name} fwd: Hopper kernel "
            f"{(turns[0] + turns[3]) / 2:.4f} ms, xent.cu kernel "
            f"{(turns[1] + turns[2]) / 2:.4f} ms, chain {chain} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) (in turns, L2 flushed before "
            "each call)")
    kw = dict(logit_cap=cap, out_dtype=torch.float32)
    for key, (kern, ref, _) in fns.items():
      before = sm90_launches()
      got = (xent.xent_dx if key == "dx" else xent.xent_dw)(
          x, w, targets, lse_r, coef, **kw)
      if sm90_launches() - before != int(sm90):
        raise AssertionError(f"{name} {key}: routed to the wrong kernel")
      _compare_scaled(f"{name} {key}", got,
                      ref(x, w, targets, lse_r, coef, **kw), XENT_GRAD_SHARE)
      if time_it:
        ms = _time_ms(lambda kern=kern: kern(x, w, targets, lse_r, coef,
                                             **kw), 3, flush)
        bound_ms, bound_by = _xent_bounds(m, v, d)[key]
        print(f"  {name} {key}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) (L2 flushed before each call)")

  print("K3 case 2: the default LM's shapes: M 4096 (b2 x T2048), V 32000, "
        "D 2048, bf16 operands, cap 30 (K3a-c on the Hopper kernels, "
        "clusters of 8)")
  small("D=2048", 4096, 32_000, 2048, torch.bfloat16, 30.0, True,
        time_it=True)
  print("K3 case 3: ragged M and V on the Hopper kernels: M 300, V 1000, "
        "D 256 (clusters of 1), M 257, V 333, D 512 (of 2) and M 1000, V "
        "1500, D 2048 (of 8), cap 30")
  small("D=256", 300, 1000, 256, torch.bfloat16, 30.0, True)
  small("D=512", 257, 333, 512, torch.bfloat16, 30.0, True)
  small("D=2048 ragged", 1000, 1500, 2048, torch.bfloat16, 30.0, True)
  print("K3 case 4: no cap, M 130, V 2000, D 1024 (the Hopper kernels)")
  small("cap 0", 130, 2000, 1024, torch.bfloat16, 0.0, True)
  print("K3 case 5: ragged M 100, V 1000, D 128, f32 operands, cap 30 "
        "(xent.cu)")
  small("f32", 100, 1000, 128, torch.float32, 30.0, False)
  print("K3 case 6: ragged M 257, V 333, D 72, bf16 operands, no cap "
        "(xent.cu)")
  small("D=72", 257, 333, 72, torch.bfloat16, 0.0, False)
  print("K3 case 7: untied w [D, V] through fused_softmax_xent (autograd), "
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
              "K5a sm90": (fa.flash_attention, "launches_dq_sm90"),
              "K5b": (fa.flash_attention, "launches_dkv"),
              "K5b sm90": (fa.flash_attention, "launches_dkv_sm90"),
              "K3a": (xent.fused_softmax_xent, "launches_fwd"),
              "K3a sm90": (xent.fused_softmax_xent, "launches_fwd_sm90"),
              "K3b": (xent.fused_softmax_xent, "launches_dx"),
              "K3b sm90": (xent.fused_softmax_xent, "launches_dx_sm90"),
              "K3c": (xent.fused_softmax_xent, "launches_dw"),
              "K3c sm90": (xent.fused_softmax_xent, "launches_dw_sm90")}
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
  # The forward is the same, and K5b runs K2's dk / dv code; K5a sums dq
  # over key tiles in registers where K2 adds them in a fixed order in L2,
  # so dq (and all that it feeds) may differ in its last bits. Measured
  # on the H100 with the Hopper K5a / K5b: the loss equal, norms 8.6e-6
  # apart, cosine 0.9999984, 8 of 82 leaves bit-equal.
  _step1_check(results, "split", "flash", (1e-6, 5e-5, 0.99995),
               "The limits: 1e-6, 5.8x, 31x (1 - cosine) of the measured.")
  del results, tree, first
  torch.cuda.empty_cache()

  common = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
            "--warmup_steps=3", "--log_every=1", "--device=cuda"]
  flags = common + [f"--model_dir={workdir}", f"--experiment_config={flash}"]
  n = cfg.n_layers * steps
  none = dict.fromkeys(("K1", "K1 sm90", "K2", "K2 sm90", "K5a", "K5a sm90",
                        "K5b", "K5b sm90", "K3a", "K3a sm90", "K3b",
                        "K3b sm90", "K3c", "K3c sm90"), 0)
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
      # bf16 operands at D 1,024: every K3a, K3b and K3c launch the Hopper
      # kernels' (csrc/xent_sm90.cu).
      dict(none, **sm90(2 * n, n), K3a=steps, K3b=steps, K3c=steps,
           **{"K3a sm90": steps, "K3b sm90": steps, "K3c sm90": steps}),
      _step_flops(cfg, batch, t, fused=True))
  split_dir = workdir + "_split"
  # dots_flash saves K1's (out, lse): K1 once per layer and step. Every K5a
  # and K5b launch is the Hopper kernel's.
  runs["split"] = _train_run(
      split_dir, common + [
          f"--model_dir={split_dir}",
          f"--experiment_config={split},remat_policy=dots_flash"], steps,
      "unfused loss, remat_policy dots_flash, K5a + K5b",
      dict(none, **sm90(n, 0), **{"K5a": n, "K5a sm90": n, "K5b": n,
                                  "K5b sm90": n}),
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
# entry of the result. Measured on the H100 at the slice's shapes (the
# kernel of depthwise.cu): 2.3e-7, 4.1e-7 and 2.5e-7; the limit is 24x the
# largest.
K6_SHARE = 1e-5

# EfficientDet-D0's stride-1 depthwise convs at 512 x 512 (C, H, W, k) and
# their calls in a training step (76 in all), recorded with the port.
D0_K6_SHAPES = {(32, 256, 256, 3): 1, (144, 128, 128, 3): 1,
                (64, 64, 64, 3): 11, (240, 64, 64, 5): 1, (64, 32, 32, 3): 14,
                (672, 32, 32, 5): 2, (480, 32, 32, 5): 1, (480, 32, 32, 3): 2,
                (64, 16, 16, 3): 14, (1152, 16, 16, 3): 1,
                (1152, 16, 16, 5): 3, (64, 8, 8, 3): 14, (64, 4, 4, 3): 11}


def k6_phase(dev, flush):
  """K6 vs its plain version at every map of a D0 step (bf16, b16: the
  Hopper kernel of depthwise_sm90.cu, with the kernel of depthwise.cu,
  reached with _simt, and cuDNN's weight gradient timed in turns in the
  same call) and on small cases; returns {shape label: dict(err, ms,
  plain_ms, library_ms, bound_ms, bound_by, simt_ms, launches)}."""
  import torch
  from automl_tpu_torch.ops import depthwise as dw
  gen = torch.Generator(device=dev).manual_seed(3)
  cl = torch.channels_last
  f = dw.depthwise_filter_grad

  def inputs(b, c, h, w, dtype):
    return [torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
            .contiguous(memory_format=cl) for _ in range(2)]

  kern, ref = dw.depthwise_filter_grad_kernel, dw.depthwise_filter_grad_reference
  print(f"K6 case 1: every stride-1 depthwise conv map of a D0 step, bf16, "
        f"b16 ({sum(D0_K6_SHAPES.values())} calls a step)")
  res = {}
  b = 16
  for (c, h, w, k), per_step in D0_K6_SHAPES.items():
    label = f"[{b},{c},{h},{w}] k{k}"
    x, dy = inputs(b, c, h, w, torch.bfloat16)
    before = f.launches_sm90
    got = kern(x, dy, k)
    torch.cuda.synchronize()
    if f.launches_sm90 != before + 1:
      raise AssertionError(f"K6 {label}: did not go to the Hopper kernel")
    err = _compare_scaled(label, got, ref(x, dy, k), K6_SHARE)
    # No atomics in a sum: fixed partial sums, summed in a fixed order.
    if not torch.equal(got, kern(x, dy, k)):
      raise AssertionError(f"K6 gave two results on the same inputs: {label}")
    _compare_scaled(f"{label} (depthwise.cu)", kern(x, dy, k, _simt=True),
                    got, K6_SHARE)
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

    new = lambda x=x, dy=dy, k=k: kern(x, dy, k)
    old = lambda x=x, dy=dy, k=k: kern(x, dy, k, _simt=True)
    turns = [_time_ms(fn, 20, flush) for fn in (new, old, old, new)]
    t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    t_ref = _time_ms(lambda: ref(x, dy, k), 3, flush)
    t_lib = _library_ms(label, make_lib, 20, flush,
                        "cuDNN depthwise weight gradient")
    n = b * c * h * w
    # x and dy read once (bf16), dW written (f32); 2 k^2 f32 flops per
    # element of dy.
    bound_ms, bound_by = _bound(2.0 * k * k * n, 2 * 2 * n + 4 * c * k * k,
                                PEAK_F32_FLOPS)
    res[label] = dict(err=err, ms=t_new, plain_ms=t_ref, library_ms=t_lib,
                      bound_ms=bound_ms, bound_by=bound_by, simt_ms=t_old,
                      launches=per_step)
    plan = dw.sm90_plan(b, c, h, w, k, dw._sms(dev.index or 0))
    print(f"  {label} ({per_step} a step; plan {tuple(plan)}): Hopper kernel "
          f"{t_new:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}), depthwise.cu "
          f"{t_old:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}), cuDNN "
          f"{t_lib if t_lib is None else round(t_lib, 4)} ms, plain "
          f"{t_ref:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / t_new:.2f}% of it (in turns, L2 flushed before "
          "each call)")
    del x, dy, got
  torch.cuda.empty_cache()
  sums = {key: sum(r["launches"] * r[key] for r in res.values())
          for key in ("ms", "simt_ms", "bound_ms")}
  lib_sum = (None if any(r["library_ms"] is None for r in res.values())
             else sum(r["launches"] * r["library_ms"] for r in res.values()))
  print(f"K6 over a D0 step ({sum(D0_K6_SHAPES.values())} calls, the sums "
        f"of calls x time): Hopper kernel {sums['ms']:.4f} ms, depthwise.cu "
        f"{sums['simt_ms']:.4f} ms, cuDNN "
        f"{'n/a' if lib_sum is None else f'{lib_sum:.4f}'} ms, bound "
        f"{sums['bound_ms']:.4f} ms")
  print("K6 case 2: small cases (C not a multiple of 8 and float32 take "
        "depthwise.cu)")
  for name, (b, c, h, w, k, dtype) in {
      "f32 ragged 15x17 k5 C13 b1": (1, 13, 15, 17, 5, torch.float32),
      "bf16 ragged 15x17 k3 C13 b1": (1, 13, 15, 17, 3, torch.bfloat16),
      "f32 k7 C33 (two channel chunks)": (2, 33, 9, 70, 7, torch.float32),
      "f32 BiFPN level 7 4x4 k3": (16, 64, 4, 4, 3, torch.float32),
      "f32 k1": (2, 8, 5, 6, 1, torch.float32),
      "bf16 k7 C40 (five chunks of 8)": (2, 40, 9, 70, 7, torch.bfloat16),
      "bf16 k1 C8": (2, 8, 5, 6, 1, torch.bfloat16),
      "bf16 ragged 15x17 k5 C24 b3": (3, 24, 15, 17, 5, torch.bfloat16),
      "bf16 C136 33x31 k3 b7 (a ragged chunk)": (7, 136, 33, 31, 3,
                                                 torch.bfloat16)}.items():
    x, dy = inputs(b, c, h, w, dtype)
    before = f.launches_sm90
    got = dw.depthwise_filter_grad(x, dy, k)
    sm90 = f.launches_sm90 - before
    if sm90 != int(dw.takes_sm90(dtype, c)):
      raise AssertionError(f"K6 {name}: routed to the wrong kernel")
    _compare_scaled(f"{name} ({'Hopper' if sm90 else 'depthwise.cu'})", got,
                    ref(x, dy, k), K6_SHARE)
    if sm90 and not torch.equal(got, dw.depthwise_filter_grad(x, dy, k)):
      raise AssertionError(f"K6 gave two results on the same inputs: {name}")
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


def _det_step1_check(out, k6_leaves, what="D0"):
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
  print(f"{what} step 1, knob on vs off: |dloss| {d_loss:.3e} (limit "
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
    raise AssertionError(f"{what} step 1 with the K6 knob on disagrees with "
                         "the knob off")


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
  dw.depthwise_filter_grad.launches_sm90 = 0
  t0 = time.perf_counter()
  try:
    main_det.main(flags + [f"--train_steps={steps}"])
  finally:
    dw.enable_pallas_filter_grad(False)
  wall = time.perf_counter() - t0
  launches = dw.depthwise_filter_grad.launches
  sm90 = dw.depthwise_filter_grad.launches_sm90
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
  print(f"K6 launches in the run: {launches}, {sm90} of them the Hopper "
        f"kernel's (expected {expected}: {per_step} per step x {steps} steps "
        "with the knob on, all Hopper; 0 off)")
  if launches != expected or sm90 != expected:
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


D0_INFER_BATCH = 32
# Postprocess on the card against the same code on the CPU, from the same
# raw outputs. Hard NMS: valid_len and classes equal, boxes within
# INFER_BOX_TOL px (of D0's 512-px canvas: about 1.6 float32 steps at 512)
# and scores within INFER_SCORE_TOL. Gaussian NMS decays every overlap by
# a factor that the last bit of a box moves, so two overlapping candidates
# whose live scores are that close may be picked in either order, and the
# slots after such a pick differ: the confident slots (score >
# INFER_CONFIDENT) agree one by one within the same limits up to the first
# slot where the two sides pick different boxes, whose two scores must be
# within INFER_SCORE_TOL (a near tie); later slots are not compared.
INFER_BOX_TOL = 1e-4
INFER_SCORE_TOL = 1e-5
INFER_CONFIDENT = 0.3


def _infer_model(dev, batch):
  """D0 (mixed_bfloat16) with seeded weights whose class-predict bias is 0
  and kernel scaled by 300 (the init's logits lie within +-2e-3 of 0, so
  every score would tie to 4 digits: the scaled ones spread, and the
  confident set is not a field of ties), and a seeded batch of uniform
  [0, 1) NHWC images on the card."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import efficientdet
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import anchors
  precision.set_policy("mixed_bfloat16")
  model = efficientdet.build_detection_model("efficientdet-d0", device=dev)
  tree = convert.det_numpy_init(model, 0)
  predict = tree["class_net"]["class-predict"]["pointwise"]
  predict["bias"][:] = 0.0
  predict["kernel"] *= 300.0
  convert.load_det_params(model, tree)
  gen = torch.Generator(device=dev).manual_seed(11)
  h, w = anchors.parse_image_size(model.config.image_size)
  images = torch.rand((batch, h, w, 3), generator=gen, device=dev)
  return model, images


def _detections_agree(name, card, cpu, exact):
  """card and cpu: (boxes, scores, classes, valid_len) of one batch.
  exact: the same detections in every slot (hard NMS); else the confident
  slots up to the first near tie (gaussian NMS, see INFER_BOX_TOL)."""
  import torch
  card = [t.cpu() for t in card]
  if exact:
    if not torch.equal(card[3], cpu[3]) or not torch.equal(card[2], cpu[2]):
      raise AssertionError(f"{name}: valid_len or classes differ: card "
                           f"{card[3].tolist()}, CPU {cpu[3].tolist()}")
    boxes_d = float((card[0] - cpu[0]).abs().max())
    scores_d = float((card[1] - cpu[1]).abs().max())
    n, note = int(cpu[3].sum()), "every slot"
  else:
    boxes_d = scores_d = 0.0
    n, ties = 0, []
    for b in range(cpu[1].shape[0]):
      for i in range(int(min(cpu[3][b], card[3][b]))):
        if float(cpu[1][b, i]) <= INFER_CONFIDENT:
          break
        db = float((card[0][b, i] - cpu[0][b, i]).abs().max())
        ds = abs(float(card[1][b, i] - cpu[1][b, i]))
        if (db > INFER_BOX_TOL or int(card[2][b, i]) != int(cpu[2][b, i])):
          if ds > INFER_SCORE_TOL:
            raise AssertionError(
                f"{name}: image {b} slot {i}: the card picked score "
                f"{float(card[1][b, i]):.7f}, the CPU "
                f"{float(cpu[1][b, i]):.7f}: not a near tie")
          ties.append(i)
          break
        boxes_d, scores_d = max(boxes_d, db), max(scores_d, ds)
        n += 1
    note = (f"confident slots up to the first near tie ({len(ties)} of "
            f"{cpu[1].shape[0]} images reached one, at slots {ties})")
  print(f"  {name}: {n} detections compared ({note}), max|box diff| "
        f"{boxes_d:.3e} px (limit {INFER_BOX_TOL:g}), max|score diff| "
        f"{scores_d:.3e} (limit {INFER_SCORE_TOL:g})")
  if boxes_d > INFER_BOX_TOL or scores_d > INFER_SCORE_TOL or n == 0:
    raise AssertionError(f"{name}: card and CPU disagree")


def _infer_check(dev):
  """D0 b32 forward on the card, then postprocess_combined (hard) and
  postprocess_global (gaussian) at pre_nms_topk 5000 and 2048 on the card
  and, from the same raw outputs, on the CPU. The card's postprocess runs
  under torch.cuda.set_sync_debug_mode("error"): a call that waits for the
  card inside it raises."""
  import copy
  import torch
  from automl_tpu_torch.ops import postprocess
  model, images = _infer_model(dev, D0_INFER_BATCH)
  with torch.no_grad():
    cls_out, box_out = model(images.permute(0, 3, 1, 2), train=False)
  cpu_out = ([c.cpu() for c in cls_out], [b.cpu() for b in box_out])
  for topk in (5000, 2048):
    cfg = copy.deepcopy(model.config)
    cfg.nms_configs.pre_nms_topk = topk
    for name, fn, exact in (
        ("combined (hard)", postprocess.postprocess_combined, True),
        ("global (gaussian)", postprocess.postprocess_global, False)):
      fn(cfg, cls_out, box_out)               # anchors cached on the card
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode("error")
      try:
        card = fn(cfg, cls_out, box_out)
      finally:
        torch.cuda.set_sync_debug_mode("default")
      cpu = fn(cfg, *cpu_out)
      print(f"D0 b{D0_INFER_BATCH} postprocess {name}, pre_nms_topk {topk}: "
            f"valid_len card {card[3].tolist()[:8]}...; no host sync inside "
            "(sync debug mode 'error')")
      _detections_agree(f"{name} top-{topk}, card vs CPU", card, cpu, exact)
  del model, images, cls_out, box_out
  torch.cuda.empty_cache()


def _bench_det(topk):
  """cli/bench_det as a subprocess; returns its JSON line."""
  out = subprocess.run(
      [sys.executable, "-m", "automl_tpu_torch.cli.bench_det",
       f"--pre_nms_topk={topk}"], capture_output=True, text=True,
      timeout=600, check=False,
      cwd=os.path.dirname(os.path.abspath(__file__)))
  if out.returncode != 0:
    raise AssertionError(f"bench_det failed ({out.returncode}): "
                         f"{out.stderr[-2000:]}")
  line = out.stdout.strip().splitlines()[-1]
  print(f"bench_det --pre_nms_topk={topk}: {line}")
  return json.loads(line)


def _entry_check(dev):
  """entry() on the card: D0, seeded weights, zeros [1, 512, 512, 3]."""
  import torch
  from automl_tpu_torch.entry import entry
  fn, (images,) = entry(dev)
  boxes, scores, classes, valid_len = fn(images)
  torch.cuda.synchronize()
  print(f"entry(): valid_len {valid_len.tolist()}; first rows (ymin, xmin, "
        f"ymax, xmax, score, class):")
  for i in range(3):
    print(f"  {[round(float(v), 4) for v in boxes[0, i]]} "
          f"{float(scores[0, i]):.6f} {int(classes[0, i])}")
  if (tuple(boxes.shape) != (1, 100, 4) or not bool(
      torch.isfinite(boxes).all()) or not bool(torch.isfinite(scores).all())):
    raise AssertionError("entry() detections malformed")


def _eval_check(dev, ckpt_dir, workdir):
  """evaluate_detection on D0 at b16 with the EMA params of the 20-step
  knob-off run, over 2 synthetic eval batches, in COCO mode and in
  testdev_dir mode: every metric finite or -1, the JSON rows with the four
  keys."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  cfg = _det_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=cfg.momentum))
  state = CheckpointManager(ckpt_dir).restore(
      train_lib.create_train_state(model, tx))
  if state is None or state.ema_params is None:
    raise AssertionError(f"no checkpoint with EMA params in {ckpt_dir}")

  def batches():
    return iter(pipeline.SyntheticDetection(
        D0_BATCH, cfg.image_size, cfg.max_instances_per_image,
        cfg.num_classes))
  t = time.perf_counter()
  m = runners.evaluate_detection(model, state.ema_params, cfg, batches(), 2)
  print(f"evaluate_detection, D0 b{D0_BATCH}, EMA params of step "
        f"{state.step}, 2 batches ({time.perf_counter() - t:.1f} s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
  if len(m) != 12 or not all(math.isfinite(v) and (v >= 0 or v == -1)
                             for v in m.values()):
    raise AssertionError(f"COCO metrics malformed: {m}")
  td = runners.evaluate_detection(model, state.ema_params, cfg, batches(), 2,
                                  testdev_dir=os.path.join(workdir,
                                                           "testdev"))
  rows = json.load(open(td["detections_json"]))
  print(f"evaluate_detection, testdev_dir mode: AP {td['AP']}, {len(rows)} "
        f"rows in {os.path.basename(td['detections_json'])}")
  if td["AP"] != -1.0 or not rows or any(
      set(r) != {"image_id", "category_id", "bbox", "score"} for r in rows):
    raise AssertionError("test-dev detections malformed")
  del model, state
  torch.cuda.empty_cache()


def _closed_loop(dev, steps=400):
  """tests/test_closed_loop.py's recipe through the port, on the card:
  efficientdet-test overfits one synthetic batch whose pixels encode its
  boxes (f32, momentum), then hard-NMS detections on that batch through
  the COCO evaluator must reach AP50 > 0.5, JAX's own criterion."""
  import numpy as np
  import torch
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.eval.coco_metric import COCOEvaluator
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import postprocess
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  precision.set_policy("float32")
  try:
    cfg = get_efficientdet_config("efficientdet-test")
    cfg.override(dict(learning_rate=0.02, lr_warmup_init=0.002))
    cfg.nms_configs.method = "hard"
    cfg.nms_configs.sigma = 0.0
    model = runners.seeded_detection_model(cfg, 0, dev)
    tx = optimizers.masked_for_params(optimizers.build_optimizer(
        "momentum", schedules.detection_lr(cfg, steps_per_epoch=100)))
    state = train_lib.create_train_state(model, tx)
    step_fn = train_lib.make_det_train_step(model, tx, cfg)
    data = pipeline.SyntheticDetection(4, 64, max_instances=10,
                                       num_classes=3, seed=3).batch
    imgs = data["image"].astype(np.float32)
    for i in range(imgs.shape[0]):
      for g in range(10):
        if data["gt_classes"][i, g] > 0:
          y0, x0, y1, x1 = data["gt_boxes"][i, g].astype(int)
          c = int(data["gt_classes"][i, g])
          imgs[i, y0:y1, x0:x1] = [255 * (c == k) for k in (1, 2, 3)]
    images = ((torch.from_numpy(imgs) - torch.tensor(cfg.mean_rgb))
              / torch.tensor(cfg.stddev_rgb))
    batch = {"image": images.permute(0, 3, 1, 2).contiguous(
                 memory_format=torch.channels_last).to(dev),
             "gt_boxes": torch.from_numpy(data["gt_boxes"]).to(dev),
             "gt_classes": torch.from_numpy(data["gt_classes"]).to(dev)}
    gen = torch.Generator(device=dev)
    t = time.perf_counter()
    for _ in range(steps):
      state, m = step_fn(state, batch, gen.manual_seed(1))
    loss = float(m["loss"])
    with torch.no_grad():
      c, b = model(batch["image"], train=False)
      dets, valid = postprocess.generate_detections(
          cfg, c, b, torch.ones(4, device=dev), torch.arange(4, device=dev))
    ev = COCOEvaluator()
    ev.add_batch_from_detections(dets.cpu().numpy(), valid.cpu().numpy(),
                                 data["gt_boxes"], data["gt_classes"])
    metrics = ev.compute()
  finally:
    precision.set_policy("mixed_bfloat16")
  print(f"closed loop, efficientdet-test, {steps} steps "
        f"({time.perf_counter() - t:.1f} s): loss {loss:.4f}, AP50 "
        f"{metrics['AP50']:.4f} (must be > 0.5), AP {metrics['AP']:.4f}")
  if not metrics["AP50"] > 0.5:
    raise AssertionError("the closed loop did not reach AP50 > 0.5")


def inference_phase(dev, ckpt_dir, workdir):
  """EfficientDet-D0 inference and COCO eval: the card's postprocess
  against the CPU's, bench_det at pre_nms_topk 2048 and 5000, entry(),
  evaluate_detection on the trained EMA params, and the closed loop."""
  _infer_check(dev)
  bench = {topk: _bench_det(topk) for topk in (2048, 5000)}
  for topk, r in bench.items():
    print(f"D0 b{r['batch']} inference, pre_nms_topk {topk}: "
          f"{r['value']:.1f} img/s, {r['ms_per_call']:.2f} ms a call "
          f"(forward {r['forward_ms']:.2f} ms, postprocess "
          f"{r['postprocess_ms']:.2f} ms; {r['card']})")
  _entry_check(dev)
  _eval_check(dev, ckpt_dir, workdir)
  _closed_loop(dev)


def _infer_profile(dev):
  """D0 b32 inference under torch.profiler, at pre_nms_topk 2048 and 5000:
  wall and device-busy time of forward + postprocess_global and of the
  postprocess alone, the kernel launches of each, the largest device rows;
  then CUDA events around pre_nms, the NMS loop (batched_nms) and the
  whole postprocess, one call each, 11 times in turns: the medians, and
  the share of the postprocess that is not pre_nms."""
  import copy
  import torch
  from automl_tpu_torch.cli.bench_det import event_ms
  from automl_tpu_torch.ops import nms as nms_lib
  from automl_tpu_torch.ops import postprocess
  model, images = _infer_model(dev, D0_INFER_BATCH)
  for topk in (2048, 5000):
    cfg = copy.deepcopy(model.config)
    cfg.nms_configs.pre_nms_topk = topk

    @torch.no_grad()
    def forward():
      return model(images.permute(0, 3, 1, 2), train=False)

    outputs = forward()
    for label, fn in (
        ("forward + postprocess", lambda: postprocess.postprocess_global(
            cfg, *forward())),
        ("postprocess alone", lambda: postprocess.postprocess_global(
            cfg, *outputs))):
      fn()
      torch.cuda.synchronize()
      wall_us, rows, host = _profiled(lambda: (fn(), torch.cuda.synchronize()))
      busy = sum(r[0] for r in rows)
      launches = sum(c for _, c, k in host if k == "cudaLaunchKernel")
      print(f"profile, D0 b{D0_INFER_BATCH} {label}, pre_nms_topk {topk}: "
            f"wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}% of the wall time), "
            f"{launches} cudaLaunchKernel")
      for dt, count, key in rows[:8]:
        print(f"  {dt / 1e3:9.3f} ms {100 * dt / busy:5.1f}%  {count:5d} "
              f"calls  {key[:90]}")
    boxes, scores, _ = postprocess.pre_nms(cfg, *outputs)
    p = postprocess.nms_params(cfg)
    args = (p["max_output_size"], p["iou_thresh"], p["sigma"],
            p["score_thresh"], p["method"])
    times = {}
    for _ in range(11):                       # in turns; the host is noisy
      for label, fn in (
          ("pre_nms", lambda: postprocess.pre_nms(cfg, *outputs)),
          ("nms loop", lambda: nms_lib.batched_nms(boxes, scores, *args)),
          ("postprocess", lambda: postprocess.postprocess_global(
              cfg, *outputs))):
        times.setdefault(label, []).append(event_ms(fn)[1])
    ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"D0 b{D0_INFER_BATCH} postprocess, pre_nms_topk {topk} (CUDA "
          f"events, median of 11 in turns): pre_nms {ms['pre_nms']:.3f} ms, "
          f"NMS loop ({p['method']}, {p['max_output_size']} rounds over "
          f"{boxes.shape[1]} candidates) {ms['nms loop']:.3f} ms, whole "
          f"postprocess {ms['postprocess']:.3f} ms: all but pre_nms, "
          f"{100 * (1 - ms['pre_nms'] / ms['postprocess']):.1f}%, is the "
          "NMS loop and its gather (the loop alone and the whole call "
          "differ by the host's noise); each: "
          + "; ".join(f"{k} " + " ".join(f"{t:.1f}" for t in v)
                      for k, v in times.items()))
  del model, images
  torch.cuda.empty_cache()


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
  _infer_profile(dev)
  _cls_profile(dev)

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


def _cls_profile(dev):
  """V2-S training steps at its last stage (296 x 296, b V2S_BATCH, bf16,
  RandAugment m 10, the K6 knob on): step times (host clock, 5 steps),
  the preprocess and RandAugment alone (host clock around synchronised
  calls), then two steps under torch.profiler: device time by kernel, the
  device-busy share, K6's time and the launches a step."""
  import torch
  from automl_tpu_torch.data import augment, pipeline, preprocessing
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  cfg = _cls_config()
  size, b = 296, V2S_BATCH
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "rmsprop", schedules.warmup_lr("exponential", 0.016, steps_per_epoch=1,
                                     warmup_epochs=5)))
  state = train_lib.create_train_state(model, tx)
  prep = runners.make_cls_preprocess(cfg, size, 10.0, 0.0, 0.0)
  step_fn = train_lib.make_cls_train_step(model, tx, cfg, preprocess_fn=prep)
  raw = pipeline.SyntheticClassification(b, int(size * 1.15) // 2 * 2,
                                         1000).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)

  def steps(count):
    nonlocal state
    for _ in range(count):
      state, m = step_fn(state, raw, gen.manual_seed(state.step))
      float(m["loss"])

  def timed(fn, count=5):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
      fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / count * 1e3

  dw.enable_pallas_filter_grad(True)
  try:
    steps(3)
    step_ms = timed(lambda: steps(1))
    prep_ms = timed(lambda: prep(raw, gen.manual_seed(1)))
    imgs = torch.rand((b, size, size, 3), device=dev) * 255
    draws = augment.randaugment_draws(b, 2, size, size, gen.manual_seed(2))
    ra_ms = timed(lambda: augment.randaugment(imgs, draws, 10.0))
    crop = preprocessing.cls_train_draws(b, size, gen.manual_seed(3), 2)
    crop_ms = timed(lambda: preprocessing.random_resized_crop(
        raw["image"], crop["crop"], size))
    print(f"V2-S b{b} {size}x{size} step (K6 knob on): {step_ms:.1f} ms "
          f"(host clock, 5 steps); the preprocess alone {prep_ms:.1f} ms "
          f"({100 * prep_ms / step_ms:.1f}%), of which RandAugment (2 layers "
          f"x 16 ops on every image) {ra_ms:.1f} ms "
          f"({100 * ra_ms / step_ms:.1f}% of the step) and the crop "
          f"{crop_ms:.1f} ms")
    del imgs
    n = 2
    wall_us, rows, host_rows = _profiled(lambda: steps(n))
  finally:
    dw.enable_pallas_filter_grad(False)
  busy = sum(r[0] for r in rows)
  k6 = sum(r[0] for r in rows if "filter_grad" in r[2]
           or "reduce_parts_kernel" in r[2])
  k6_calls = sum(r[1] for r in rows if "filter_grad" in r[2])
  launches = sum(c for _, c, k in host_rows if k == "cudaLaunchKernel")
  print(f"profile, {n} V2-S training steps b{b} {size}x{size}, K6 knob on: "
        f"wall {wall_us / n / 1e3:.1f} ms/step, device busy "
        f"{busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}% of the "
        f"wall time), K6 {k6 / n / 1e3:.2f} ms/step in {k6_calls // n} "
        f"launches, {launches // n} cudaLaunchKernel a step")
  for dt, count, key in rows[:20]:
    print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
          f"{count // n:5d} calls/step  {key[:90]}")
  del model, state, step_fn
  torch.cuda.empty_cache()


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
    k6 = sum(r[0] for r in rows if "filter_grad" in r[2]
             or "reduce_parts_kernel" in r[2])
    k6_calls = sum(r[1] for r in rows if "filter_grad" in r[2]
                   or "reduce_parts_kernel" in r[2])
    print(f"profile, {n} D0 training steps b{D0_BATCH}, K6 knob "
          f"{'on' if knob else 'off'}: wall {wall_us / n / 1e3:.1f} ms/step, "
          f"device busy {busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}"
          f"% of the wall time), K6 {k6 / n / 1e3:.2f} ms/step in "
          f"{k6_calls // n} launches, host self "
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


# ---------------------------------------------------------------------------
# Classification (EfficientNetV2): inference, training, K6 at V2-S's maps.
# ---------------------------------------------------------------------------

# The cut: V2-S trains at b256 (the config's global batch is 4,096). 256
# is the cap of the cut (the largest power of two <= 256 that fits at the
# last stage's 296 x 296), not a measured limit: it fits, its stage-3 step
# peaking at 56.68 GiB (this script's stage line, H100 80GB HBM3 at 700 W),
# and no larger batch was tried.
V2S_BATCH = 256
V2S_STAGE_STEPS = 10
# The K6 knob-on and knob-off runs draw the same batches, crops, RandAugment
# ops and masks from the same seeds; they differ only in the bf16 rounding
# of the 28 depthwise filter gradients (f32 sums in other orders), from step
# 1's update on. Measured on the H100 (b256): stage 0's losses at most
# 0.15% apart, each stage's mean loss at most 0.34%. The limits: each of
# stage 0's steps and each stage's mean within CLS_KNOB_RTOL.
CLS_KNOB_RTOL = 1e-2
# Card f32 logits (TF32 off) against the CPU's from the same weights: the
# fc kernel is scaled (FC_SCALE) so that the logits are of order 1 and the
# top 5 are apart (seeded weights give logits of order 1e-3 and 1e-1).
CLS_LOGIT_ATOL = 1e-3
FC_SCALE = {"efficientnetv2-b0": 2000.0, "efficientnetv2-s": 30.0}
# cls_train_preprocess on the card against the CPU from the same draws, on
# [0, 255]: images whose RandAugment layers draw no nearest warp within
# PRE_ATOL everywhere; the others at most PRE_WARP_SHARE of their pixels
# off by more (a source coordinate within an ulp of .5 rounds either way).
PRE_ATOL = 1e-3
PRE_WARP_SHARE = 1e-3
CLS_LOSS_RTOL = 1e-4
# The state after one f32 RMSProp step, card against CPU: the params
# within CLS_STATE_SHARE of the largest update (decay 0.9 and nu from 0, so
# an update is at most lr * sqrt(10) an element), the BN statistics within
# CLS_STATE_SHARE of their largest change; the same for their EMA. A
# per-leaf relative rule cannot hold: where a train-mode BN cancels a
# gradient (a block's last BN beta, whose residual stream only 1x1 convs,
# each before a BN, read), both devices' gradients are rounding noise that
# RMSProp scales by up to lr / sqrt(eps); where a statistic is zero in exact
# arithmetic (the mean of an expand conv fed by a BN's zero-mean output),
# both devices' statistics are rounding noise.
CLS_F32_LR = 0.016
CLS_STATE_SHARE = 1e-3
CLS_UPDATE_ATOL = CLS_STATE_SHARE * CLS_F32_LR * 10 ** 0.5


def _cls_config(name="efficientnetv2-s", **overrides):
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  cfg = get_model_config(name)
  cfg.override(overrides)
  return cfg


def _stride1_depthwise_maps(model, size: int) -> dict:
  """{(C, H, W, k): calls a step} of the K6 calls of a classifier's training
  step at size x size: the stride-1 depthwise convs, with the map each
  sees (the stem and every stride-2 block halve it, SAME)."""
  from automl_tpu_torch.nn import layers as L
  h = -(-size // 2)
  maps = {}
  for block in model.blocks:
    dwc = getattr(block, "depthwise_conv2d", None)
    if isinstance(dwc, L.DepthwiseConv2D) and dwc.strides == (1, 1):
      key = (dwc.out_ch, h, h, dwc.kernel_size[0])
      maps[key] = maps.get(key, 0) + 1
    h = -(-h // block.args.strides)
  return maps


def _cls_infer_check(dev):
  """(a) infer_cls's predict (bm) on V2-B0 224 b8 and V2-S 384 b32; the
  card's f32 logits (TF32 off) against the CPU's from the same weights (B0
  b8, V2-S b4): atol CLS_LOGIT_ATOL and the top-5 equal; under
  mixed_bfloat16, the share of images whose top-1 is the CPU f32's."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import infer_cls
  from automl_tpu_torch.data import preprocessing
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  for name, b in (("efficientnetv2-b0", 8), ("efficientnetv2-s", 32)):
    r = infer_cls.main([f"--model_name={name}", "--runmode=bm",
                        f"--batch_size={b}", "--device=cuda"])
    cfg = _cls_config(name)
    print(f"infer_cls bm {name} {cfg.eval.isize}x{cfg.eval.isize} b{b} "
          f"(mixed_bfloat16, predict = eval preprocess + forward, CUDA "
          f"events): {r['fps']} img/s, {r['latency_ms']} ms a call")
  for name, b in (("efficientnetv2-b0", 8), ("efficientnetv2-s", 4)):
    cfg = _cls_config(name)
    isize = int(cfg.eval.isize)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (b, isize + 32, isize + 32,
                                                    3), dtype=np.uint8))
    logits = {}
    for where, policy in (("cpu", "float32"), ("cuda", "float32"),
                          ("cuda", "mixed_bfloat16")):
      precision.set_policy(policy)
      model = runners.seeded_classification_model(cfg.model, 0, where)
      with torch.no_grad():
        model.head.fc.kernel.mul_(FC_SCALE[name])
        x = preprocessing.cls_eval_preprocess(images.to(where), isize)
        logits[(where, policy)] = model(x, train=False).float().cpu()
      del model
    precision.set_policy("mixed_bfloat16")
    cpu, card = logits[("cpu", "float32")], logits[("cuda", "float32")]
    err = float((card - cpu).abs().max())
    same5 = torch.equal(cpu.topk(5).indices, card.topk(5).indices)
    bf16 = logits[("cuda", "mixed_bfloat16")]
    agree = float((bf16.argmax(-1) == cpu.argmax(-1)).float().mean())
    gap = float((cpu.topk(6).values[:, :5] - cpu.topk(6).values[:, 1:])
                .min())
    print(f"{name} b{b} {isize}x{isize}, card f32 vs CPU f32 logits: "
          f"max|diff| {err:.3e} (limit {CLS_LOGIT_ATOL}, logits up to "
          f"{float(cpu.abs().max()):.3f}, smallest top-5 gap {gap:.3e}); "
          f"top-5 equal {same5}; mixed_bfloat16 top-1 = CPU f32 top-1 in "
          f"{100 * agree:.1f}% of the images")
    if not (err <= CLS_LOGIT_ATOL and same5):
      raise AssertionError(f"{name}: the card's f32 logits disagree with "
                           "the CPU's")
  torch.cuda.empty_cache()


_CLS_CHILD = r"""
import json, sys, torch
from automl_tpu_torch.cli import main_cls
from automl_tpu_torch.ops import depthwise as dw
from automl_tpu_torch.train import runners
dw.enable_pallas_filter_grad(sys.argv[1] == "on")
f = dw.depthwise_filter_grad
marks = []
def mark():
  torch.cuda.synchronize()
  marks.append(dict(launches=f.launches, sm90=f.launches_sm90,
                    peak=torch.cuda.max_memory_allocated()))
  torch.cuda.reset_peak_memory_stats()
make = runners.make_cls_preprocess
def at_each_stage(*a, **k):
  mark()
  return make(*a, **k)
runners.make_cls_preprocess = at_each_stage
f.launches = f.launches_sm90 = 0
main_cls.main(sys.argv[2:])
mark()
print("CLS_STAGES " + json.dumps(marks))
"""


def _cls_train_run(workdir, knob: bool, steps: int, per_step: int,
                   stage_sizes):
  """(b) cli/main_cls trains V2-S as a subprocess for `steps` steps over
  its 4 progressive stages, the K6 knob set in the child, its launch count
  and peak memory read at each stage's start (a wrapper of
  runners.make_cls_preprocess) and at the end. Checks the loss (finite,
  falling within each stage after the first) and the launches (per_step a
  step, all Hopper, with the knob; none without). Returns ([(size, step
  ms, img/s, peak GiB, launches)] per stage, the losses)."""
  import numpy as np
  shutil.rmtree(workdir, ignore_errors=True)
  flags = ["--model_name=efficientnetv2-s", f"--model_dir={workdir}",
           f"--train_steps={steps}", "--log_every=1", "--device=cuda",
           f"--hparam_str=train.batch_size={V2S_BATCH}"]
  root = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-c", _CLS_CHILD,
                         "on" if knob else "off", *flags], cwd=root,
                        capture_output=True, text=True, timeout=600,
                        check=False)
  wall = time.perf_counter() - t0
  for line in proc.stdout.splitlines():
    if line.startswith("step ") and int(line.split()[1]) % 10 in (1, 0):
      print(f"  {line}")
  if proc.returncode != 0:
    print(proc.stdout[-3000:], proc.stderr[-6000:])
    raise AssertionError(f"main_cls (knob {knob}) exited {proc.returncode}")
  marks = json.loads(next(l for l in proc.stdout.splitlines()
                          if l.startswith("CLS_STAGES "))[11:])
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"losses (K6 knob {'on' if knob else 'off'}): "
        f"{' '.join(f'{x:.3f}' for x in losses)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("training steps missing or loss not finite")
  # Each stage draws its own synthetic batch (at its canvas), repeated
  # through the stage: the loss must fall within each stage after the
  # first (the mean of its last 3 steps below its first step's). Stage 0
  # rises before it falls, in both runs alike: 40 steps of a 350-epoch
  # config make steps_per_epoch 1, so the lr warms up to 0.016 in 5 steps,
  # and RMSProp's nu starts at 0 (decay 0.9), which scales step t's update
  # by 1 / sqrt(1 - 0.9^t), 3.2x at step 1. The update itself is held to
  # the CPU's in _cls_step1, and the two runs' losses to each other in
  # cls_phase.
  per_stage = steps // len(stage_sizes)
  for i in range(1, len(stage_sizes)):
    stage = losses[i * per_stage:(i + 1) * per_stage]
    if not np.mean(stage[-3:]) < stage[0]:
      raise AssertionError(f"loss did not fall in stage {i}: {stage[0]:.4f} "
                           f"-> {np.mean(stage[-3:]):.4f}")
  out = []
  for i, size in enumerate(stage_sizes):
    launches = marks[i + 1]["launches"] - marks[i]["launches"]
    sm90 = marks[i + 1]["sm90"] - marks[i]["sm90"]
    secs = [r["secs_per_step"] for r in recs[i * per_stage:(i + 1) *
                                              per_stage]]
    step_ms = float(np.median(secs[2:])) * 1e3
    peak = marks[i + 1]["peak"] / 2**30
    out.append((size, step_ms, V2S_BATCH / step_ms * 1e3, peak, launches))
    print(f"V2-S train b{V2S_BATCH} stage {i} {size}x{size} bf16, K6 knob "
          f"{'on' if knob else 'off'}: step {step_ms:.1f} ms (median of the "
          f"stage's steps 3-{per_stage}), {V2S_BATCH / step_ms * 1e3:.1f} "
          f"img/s, peak memory {peak:.2f} GiB, K6 launches {launches} "
          f"({sm90} Hopper)")
    expected = per_step * per_stage if knob else 0
    if launches != expected or sm90 != expected:
      raise AssertionError(f"stage {i}: {launches} K6 launches ({sm90} "
                           f"Hopper), expected {expected}")
  print(f"V2-S, {steps} steps in {wall:.1f} s (the child's start and model "
        f"build included); loss by stage, first step -> mean of the last 3: "
        + ", ".join(f"{stage[0]:.4f} -> {np.mean(stage[-3:]):.4f}"
                    for stage in (losses[i * per_stage:(i + 1) * per_stage]
                                  for i in range(len(stage_sizes)))))
  return out, losses


def _cls_knob_losses_check(on, off):
  """The knob-on and knob-off V2-S runs' losses against each other: each
  of stage 0's steps and each stage's mean within CLS_KNOB_RTOL."""
  import numpy as np
  on, off = np.asarray(on), np.asarray(off)
  per = V2S_STAGE_STEPS
  step_rel = np.abs(on[:per] - off[:per]) / np.abs(off[:per])
  means_on, means_off = (x.reshape(-1, per).mean(1) for x in (on, off))
  mean_rel = np.abs(means_on - means_off) / np.abs(means_off)
  print(f"V2-S losses, K6 knob on vs off: stage 0's steps at most "
        f"{100 * step_rel.max():.3f}% apart, the stages' mean losses "
        f"{' '.join(f'{a:.4f}/{b:.4f}' for a, b in zip(means_on, means_off))}"
        f" at most {100 * mean_rel.max():.3f}% apart (limit "
        f"{100 * CLS_KNOB_RTOL:g}%); the whole run's steps at most "
        f"{100 * (np.abs(on - off) / np.abs(off)).max():.3f}% apart")
  if step_rel.max() > CLS_KNOB_RTOL or mean_rel.max() > CLS_KNOB_RTOL:
    raise AssertionError("the V2-S run with the K6 knob on drifted from "
                         "the run with it off")


def _cls_state_check(name, new, ref_new, ref_old, limit=None):
  """Leaves after one f32 step, card against CPU: the largest max|diff|
  within `limit`, by default CLS_STATE_SHARE of the largest change the
  step made to these leaves on the CPU."""
  diff = {k: float((new[k].double() - ref_new[k].double()).abs().max())
          for k in ref_new}
  step = max(float((ref_new[k].double() - ref_old[k].double()).abs().max())
             for k in ref_new)
  limit = CLS_STATE_SHARE * step if limit is None else limit
  worst = max(diff, key=diff.get)
  print(f"  {name}: {len(diff)} leaves, largest change {step:.3e}, largest "
        f"max|card - CPU| {diff[worst]:.3e} at {worst} (limit {limit:.3e})")
  if diff[worst] > limit:
    raise AssertionError(f"V2-S f32 step 1: the card's {name} disagree "
                         "with the CPU's")


def _cls_step1(dev):
  """(c) Step 1 of V2-S (b8, 168 x 168, bf16) with the K6 knob off and on,
  from one model and one preprocessed batch, the dropout / drop_connect
  masks from one seed; then _cls_card_vs_cpu from the same weights and
  batch."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import layers as L
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.ops import losses
  from automl_tpu_torch.train import runners
  cfg = _cls_config()
  b, size = 8, 168
  raw = pipeline.SyntheticClassification(b, int(size * 1.15) // 2 * 2,
                                         1000).batch
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  prep = runners.make_cls_preprocess(cfg, size, 2.5, 0.0, 0.0)
  cpu_gen = torch.Generator()
  batch = prep({k: torch.from_numpy(v).to(dev) for k, v in raw.items()},
               cpu_gen.manual_seed(7))
  trainable = {k: p for k, p in model.named_parameters()}
  out = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      logits = model(batch["image"], train=True,
                     generator=cpu_gen.manual_seed(8))
      L.take_bn_updates(model)
      loss = losses.cross_entropy(logits, batch["label"], 0.1)
      grads = torch.autograd.grad(loss, list(trainable.values()),
                                  allow_unused=True)
      torch.cuda.synchronize()
    finally:
      dw.enable_pallas_filter_grad(False)
    print(f"V2-S step 1 (b{b}, {size}x{size}), K6 knob "
          f"{'on' if knob else 'off'}: loss {float(loss.detach()):.6f}")
    out[knob] = (float(loss.detach()),
                 {k: g if g is not None else torch.zeros_like(p)
                  for (k, p), g in zip(trainable.items(), grads)})
  k6_leaves = sorted(
      f"{name}.kernel" for name, m in model.named_modules()
      if isinstance(m, L.DepthwiseConv2D) and m.strides == (1, 1))
  if len(k6_leaves) != 28:
    raise AssertionError(f"V2-S has {len(k6_leaves)} stride-1 depthwise "
                         "convs, not 28")
  _det_step1_check(out, k6_leaves, "V2-S")
  del model, out, batch
  torch.cuda.empty_cache()

  _cls_card_vs_cpu(dev, cfg, raw, prep, f"b{b}, {size}x{size}")


def _cls_card_vs_cpu(dev, cfg, raw, prep, what):
  """Two f32 make_cls_train_step steps (RMSProp, EMA, the stage's
  preprocess) on the card and on the CPU from the same weights, batch and
  draws (a CPU generator feeds both): each step's loss within
  CLS_LOSS_RTOL (step 2's after the update); after step 1 the params, the
  BN statistics and their EMA under _cls_state_check."""
  import torch
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, train_lib
  precision.set_policy("float32")
  losses_by, snaps = {}, {}
  snap = lambda d: {k: v.detach().clone().cpu() for k, v in d.items()}
  for where in (str(dev), "cpu"):
    m = runners.seeded_classification_model(cfg.model, 0, where)
    tx = optimizers.masked_for_params(optimizers.build_optimizer(
        "rmsprop", CLS_F32_LR))
    step = train_lib.make_cls_train_step(m, tx, cfg, preprocess_fn=prep)
    state = train_lib.create_train_state(m, tx)
    old = snap(state.params)
    batch = {k: torch.from_numpy(v).to(where) for k, v in raw.items()}
    gen = torch.Generator()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen.manual_seed(9))
    snaps[where] = (snap(state.params), old, snap(state.ema_params))
    state, metrics2 = step(state, batch, gen.manual_seed(10))
    losses_by[where] = (float(metrics["loss"]), float(metrics2["loss"]))
    print(f"V2-S f32 steps 1 and 2 ({what}) on the {where}: loss "
          f"{losses_by[where][0]:.7f}, {losses_by[where][1]:.7f} "
          f"({time.perf_counter() - t0:.1f} s)")
    del m, state, step, batch
  precision.set_policy("mixed_bfloat16")
  card, cpu = losses_by[str(dev)], losses_by["cpu"]
  rel = [abs(a - c) / abs(c) for a, c in zip(card, cpu)]
  print(f"V2-S f32 steps 1 and 2, card vs CPU: loss rel. diff {rel[0]:.3e} "
        f"and {rel[1]:.3e} (limit {CLS_LOSS_RTOL})")
  (p_card, _, ema_card), (p_cpu, old_cpu, ema_cpu) = (snaps[str(dev)],
                                                       snaps["cpu"])
  stats = [k for k in p_cpu if optimizers.is_batch_stat(k)]
  params = [k for k in p_cpu if k not in stats]
  for what, card_d, cpu_d in (("", p_card, p_cpu),
                              ("EMA of the ", ema_card, ema_cpu)):
    _cls_state_check(what + "params", {k: card_d[k] for k in params},
                     {k: cpu_d[k] for k in params}, old_cpu, CLS_UPDATE_ATOL)
    _cls_state_check(what + "BN statistics", {k: card_d[k] for k in stats},
                     {k: cpu_d[k] for k in stats}, old_cpu)
  if max(rel) > CLS_LOSS_RTOL:
    raise AssertionError("V2-S f32 steps on the card disagree with the CPU")
  torch.cuda.empty_cache()


def _cls_mixing_run(workdir):
  """(d) 10 V2-S steps (b32, one stage at 168 x 168) with V2-M's
  mixup_alpha = cutmix_alpha = 0.2, through main_cls: every step mixes
  (augment.mixing called once a step), the loss finite."""
  import torch
  from automl_tpu_torch.cli import main_cls
  from automl_tpu_torch.data import augment
  shutil.rmtree(workdir, ignore_errors=True)
  calls = []
  mixing = augment.mixing
  augment.mixing = lambda *a, **k: calls.append(1) or mixing(*a, **k)
  try:
    t0 = time.perf_counter()
    out = main_cls.main([
        "--model_name=efficientnetv2-s", f"--model_dir={workdir}",
        "--train_steps=10", "--log_every=1", "--device=cuda",
        "--hparam_str=train.batch_size=32,train.stages=1,train.isize=168,"
        "data.mixup_alpha=0.2,data.cutmix_alpha=0.2"])
  finally:
    augment.mixing = mixing
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"V2-S b32 168x168 with mixup and cutmix 0.2 (half the batch each): "
        f"10 steps in {time.perf_counter() - t0:.1f} s, mixing called "
        f"{len(calls)} times; losses {' '.join(f'{x:.3f}' for x in losses)}")
  if len(calls) != 10 or len(losses) != 10 or not all(
      math.isfinite(x) for x in losses) or not math.isfinite(out["loss"]):
    raise AssertionError("the mixing run failed")
  torch.cuda.empty_cache()


def _cls_preprocess_check(dev):
  """(e) cls_train_preprocess (crop, flip, RandAugment 2 layers at m 10,
  v2 normalization) at b32 from 340 x 340 canvases to 296 x 296, on the
  card and on the CPU from the same draws, compared on [0, 255]: images
  with no nearest warp drawn within PRE_ATOL, the others at most
  PRE_WARP_SHARE of their pixels off by more."""
  import torch
  from automl_tpu_torch.data import augment, pipeline, preprocessing
  b, canvas, out = 32, 340, 296
  images = torch.from_numpy(pipeline.SyntheticClassification(
      b, canvas, 1000, seed=3).batch["image"])
  draws = preprocessing.cls_train_draws(b, out, torch.Generator().manual_seed(
      0), 2)   # seed 0 draws all 16 ops
  to = lambda d, dev: {k: (to(v, dev) if isinstance(v, dict) else v.to(dev))
                       for k, v in d.items()}
  res = {}
  for where in ("cpu", dev):
    x = preprocessing.cls_train_preprocess(images.to(where), to(draws, where),
                                           out, "randaug", 10.0)
    res[str(where)] = (x.float().cpu().permute(0, 2, 3, 1) * 128.0 + 128.0)
  cpu, card = res["cpu"], res[str(dev)]
  warps = {augment.OPS.index(n) for n in ("rotate", "shear_x", "shear_y",
                                          "translate_x", "translate_y")}
  off = ((card - cpu).abs() > PRE_ATOL).any(-1).float().mean((1, 2))
  worst_plain = worst_warp = 0.0
  for i in range(b):
    ops = set(draws["randaug"]["op"][i].tolist())
    if ops & warps:
      worst_warp = max(worst_warp, float(off[i]))
    else:
      worst_plain = max(worst_plain, float((card[i] - cpu[i]).abs().max()))
  n_warp = sum(bool(set(o.tolist()) & warps) for o in draws["randaug"]["op"])
  print(f"cls_train_preprocess b{b} {canvas}->{out}, RandAugment m10, card "
        f"vs CPU from the same draws: {b - n_warp} images without a nearest "
        f"warp, max|diff| {worst_plain:.3e} on [0, 255] (limit {PRE_ATOL}); "
        f"{n_warp} with one, at most {100 * worst_warp:.3f}% of an image's "
        f"pixels off by more than {PRE_ATOL} (limit {100 * PRE_WARP_SHARE}%)")
  if worst_plain > PRE_ATOL or worst_warp > PRE_WARP_SHARE:
    raise AssertionError("cls_train_preprocess on the card disagrees with "
                         "the CPU")
  ops_seen = sorted({augment.OPS[o] for o in
                     draws["randaug"]["op"].flatten().tolist()})
  print(f"  ops drawn: {len(ops_seen)} of 16 ({', '.join(ops_seen)})")


def _cls_eval_check(dev, ckpt_dir):
  """(f) evaluate_classification at 384 x 384 (V2-S's eval size, b32, 2
  synthetic minival batches) with the EMA of the knob-on run's last
  checkpoint (stage 4): top-1 and top-5 in [0, 1]."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import infer_cls
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  cfg = _cls_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  infer_cls.load_params(model, ckpt_dir, use_ema=True)
  t0 = time.perf_counter()
  m = runners.evaluate_classification(
      model, convert.model_state(model), cfg,
      iter(pipeline.SyntheticClassification(32, 384 + 32, 1000)), 2)
  print(f"evaluate_classification, V2-S 384x384 b32, the EMA of the last "
        f"checkpoint, 2 synthetic batches ({time.perf_counter() - t0:.1f} "
        f"s): top1 {m['top1']:.4f}, top5 {m['top5']:.4f}, samples "
        f"{m['samples']:.0f}")
  if m["samples"] != 64 or not (0 <= m["top1"] <= m["top5"] <= 1):
    raise AssertionError(f"classification eval malformed: {m}")
  del model
  torch.cuda.empty_cache()


def k6_v2s_phase(dev, flush, sizes=(168, 296), batches=(8, V2S_BATCH)):
  """(g) K6 at every distinct map of V2-S's training steps at 168 and 296
  (bf16, b8 and the smoke's batch): the Hopper kernel against its plain
  version (K6_SHARE, a second call bit-equal), then the Hopper kernel,
  depthwise.cu's and cuDNN's weight gradient timed in turns (L2
  flushed), beside the bound; and each step's launch-weighted sums."""
  import torch
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.ops import depthwise as dw
  model = EfficientNet(_cls_config().model, device="meta")
  gen = torch.Generator(device=dev).manual_seed(5)
  kern = dw.depthwise_filter_grad_kernel
  ref = dw.depthwise_filter_grad_reference
  f = dw.depthwise_filter_grad
  for size in sizes:
    maps = _stride1_depthwise_maps(model, size)
    for b in batches:
      sums = dict(ms=0.0, simt=0.0, lib=0.0, bound=0.0)
      for (c, h, w, k), calls in maps.items():
        label = f"[{b},{c},{h},{w}] k{k}"
        x, dy = [torch.randn((b, c, h, w), generator=gen, device=dev)
                 .to(torch.bfloat16).contiguous(
                     memory_format=torch.channels_last) for _ in range(2)]
        before = f.launches_sm90
        got = kern(x, dy, k)
        torch.cuda.synchronize()
        if f.launches_sm90 != before + 1:
          raise AssertionError(f"K6 {label}: not the Hopper kernel")
        _compare_scaled(f"V2-S {size} {label}", got, ref(x, dy, k), K6_SHARE)
        if not torch.equal(got, kern(x, dy, k)):
          raise AssertionError(f"K6 gave two results: {label}")
        weight = torch.randn((c, 1, k, k), generator=gen, device=dev).to(
            torch.bfloat16)
        pad = (k - 1) // 2
        fns = {
            "ms": lambda: kern(x, dy, k),
            "simt": lambda: kern(x, dy, k, _simt=True),
            "lib": lambda: torch.ops.aten.convolution_backward(
                dy, x, weight, None, [1, 1], [pad, pad], [1, 1], False,
                [0, 0], c, [False, True, False])[1]}
        order = ["ms", "simt", "lib", "lib", "simt", "ms"]
        turns = {key: [] for key in fns}
        for key in order:
          turns[key].append(_time_ms(fns[key], 20, flush))
        t = {key: sum(v) / len(v) for key, v in turns.items()}
        n = b * c * h * w
        bound_ms, by = _bound(2.0 * k * k * n, 2 * 2 * n + 4 * c * k * k,
                              PEAK_F32_FLOPS)
        for key in ("ms", "simt", "lib"):
          sums[key] += calls * t[key]
        sums["bound"] += calls * bound_ms
        plan = dw.sm90_plan(b, c, h, w, k, dw._sms(dev.index or 0))
        print(f"  K6 V2-S {size}: {label} x{calls} a step (plan "
              f"{tuple(plan)}): Hopper {t['ms']:.4f} ms, depthwise.cu "
              f"{t['simt']:.4f}, cuDNN {t['lib']:.4f}, bound {bound_ms:.4f} "
              f"({by}); Hopper/cuDNN {t['ms'] / t['lib']:.2f}")
        del x, dy, got
      print(f"K6 over a V2-S step at {size}x{size}, b{b} "
            f"({sum(maps.values())} calls, calls x ms): Hopper "
            f"{sums['ms']:.4f} ms, depthwise.cu {sums['simt']:.4f}, cuDNN "
            f"{sums['lib']:.4f}, bound {sums['bound']:.4f}; Hopper/cuDNN "
            f"{sums['ms'] / sums['lib']:.2f}")
  torch.cuda.empty_cache()


def cls_phase(dev, workdir):
  """Classification: (a) inference, (b) V2-S training through main_cls
  with the K6 knob on and off, (c) the step-1 checks, (d) mixing, (e) the
  preprocess card vs CPU, (f) eval with the EMA. Returns the knob-on run's
  K6 launches."""
  import torch
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.train import runners
  t0 = time.perf_counter()
  _cls_infer_check(dev)
  cfg = _cls_config()
  sizes = [runners._progressive_stage_params(cfg, i, 4)[0] for i in range(4)]
  meta = EfficientNet(cfg.model, device="meta")
  per_step = sum(_stride1_depthwise_maps(meta, sizes[0]).values())
  print(f"V2-S progressive stages: {sizes} px, RandAugment magnitude "
        f"{[runners._progressive_stage_params(cfg, i, 4)[1] for i in range(4)]}"
        f"; {per_step} K6 calls a step; maps at {sizes[0]}: "
        f"{_stride1_depthwise_maps(meta, sizes[0])}, at {sizes[-1]}: "
        f"{_stride1_depthwise_maps(meta, sizes[-1])}")
  steps = 4 * V2S_STAGE_STEPS
  on, losses_on = _cls_train_run(workdir, True, steps, per_step, sizes)
  off, losses_off = _cls_train_run(workdir + "_off", False, steps, per_step,
                                   sizes)
  for (size, ms_on, _, peak_on, _), (_, ms_off, _, peak_off, _) in zip(on,
                                                                       off):
    print(f"V2-S {size}x{size} b{V2S_BATCH}: step {ms_on:.1f} ms knob on vs "
          f"{ms_off:.1f} off; peak {peak_on:.2f} vs {peak_off:.2f} GiB")
  _cls_knob_losses_check(losses_on, losses_off)
  _cls_step1(dev)
  _cls_mixing_run(workdir + "_mix")
  _cls_preprocess_check(dev)
  _cls_eval_check(dev, os.path.join(workdir, "ckpt"))
  torch.cuda.empty_cache()
  print(f"classification phase: {time.perf_counter() - t0:.1f} s")
  return sum(r[4] for r in on)


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
    # Template arguments: an int (ILi128E; K6's k: ILi3E) and, for the
    # flash backward, a bool (Lb1E: K2 with its dq half; Lb0E: K5b
    # without); the xent kernels' bool alone (ILb1E: K3b, dx; ILb0E: K3c,
    # dW).
    name = re.sub(
        r".*?\d((?:flash|k4|xent|filter_grad)_\w*?_kernel)(?:ILi(\d+)E"
        r"(?:Lb([01])E)?"
        r"|ILb([01])E)?.*",
        lambda m: m[1] + (
            f"<{m[2]}{', kDq=' + m[3] if m[3] else ''}>" if m[2] else
            f"<kDx={m[4]}>" if m[4] else ""),
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
             "flash_attention_sm90", "xent", "xent_sm90", "depthwise",
             "depthwise_sm90")
  with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
    libs = list(pool.map(cuda_build.build, sources))
  print(f"build: {', '.join(l.name for l in libs)} in "
        f"{time.perf_counter() - t:.1f} s (nvcc in parallel)")
  for lib in libs:
    log = lib.parent / (lib.name + ".log")
    for line in log.read_text().splitlines() if log.exists() else ():
      if ("registers" in line or "spill" in line
          or "Performance Loss" in line):
        print(f"  ptxas: {line.strip()}")
  for name in ("decode_attention_sm90", "flash_attention_sm90", "xent_sm90",
               "depthwise_sm90"):
    _sass_report(libs[sources.index(name)])

  if "--profile" in sys.argv[1:]:
    profile_phase(dev)
    return 0
  flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
  k4 = k4_phase(dev, flush_buf.zero_)
  flash = flash_phase(dev, flush_buf.zero_)
  k3 = xent_phase(dev, flush_buf.zero_)
  k6 = k6_phase(dev, flush_buf.zero_)
  k6_v2s_phase(dev, flush_buf.zero_)
  del flush_buf
  torch.cuda.empty_cache()
  # The training runs' model_dirs, inside the checkout (build/ is ignored).
  build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
  workdir = os.path.join(build, "chip_smoke_lm")
  det_dir = os.path.join(build, "chip_smoke_det")
  cls_dir = os.path.join(build, "chip_smoke_cls")
  for d in (workdir, workdir + "_fused", workdir + "_split", det_dir,
            det_dir + "_off", os.path.join(build, "chip_smoke_infer"),
            cls_dir, cls_dir + "_off", cls_dir + "_mix"):
    shutil.rmtree(d, ignore_errors=True)
  runs = training_phase(dev, workdir)
  k6_launches = detection_phase(dev, det_dir)
  inference_phase(dev, os.path.join(det_dir + "_off", "ckpt"),
                  os.path.join(build, "chip_smoke_infer"))
  cls_k6_launches = cls_phase(dev, cls_dir)
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
      _entry("flash_bwd_dq", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:240", runs["split"]["K5a sm90"],
             flash["dq"]),
      _entry("flash_bwd_dkv", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:277", runs["split"]["K5b sm90"],
             flash["dkv"]),
      _entry("xent_fwd", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:66", runs["fused"]["K3a sm90"],
             k3["fwd"]),
      _entry("xent_dx", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:113", runs["fused"]["K3b sm90"],
             k3["dx"]),
      _entry("xent_dw", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:138", runs["fused"]["K3c sm90"],
             k3["dw"]),
      _entry("depthwise_filter_grad",
             "automl_tpu_torch/csrc/depthwise_sm90.cu",
             "automl_tpu/ops/depthwise.py:37", k6_launches + cls_k6_launches,
             k6["[16,32,256,256] k3"]),
  ]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
