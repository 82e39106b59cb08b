"""automl_tpu_torch's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips without them. Imports no jax,
so it runs where jax is not installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(--noconftest: tests/conftest.py sets up jax for the JAX package's tests.)
Tolerances: f32 atol = rtol = 1e-4 (another summation order, the card's
expf/tanhf); bf16 outputs atol 1.6e-2, rtol 8e-3 (one bf16 rounding
step). bf16 flash attention K1 / K2 / K5a / K5b run the Hopper kernels
(csrc/flash_attention_sm90.cu), f32 ones the scalar-FMA kernels
(csrc/flash_attention.cu). bf16 K3a / K3b / K3c with D a multiple of 256
up to 2,048 run the Hopper kernels (csrc/xent_sm90.cu), f32 and other D
those of csrc/xent.cu. bf16 K6 with C a multiple of 8 runs the Hopper
kernel (csrc/depthwise_sm90.cu), f32 and other C that of
csrc/depthwise.cu.
"""

import pytest
import torch

from automl_tpu_torch.ops import attention as fa
from automl_tpu_torch.ops import decode_attention as da
from automl_tpu_torch.ops import depthwise as dwise
from automl_tpu_torch.ops import xent

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1.6e-2, rtol=8e-3)


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda:0")


def _inputs(dev, b, t, n, n_kv, h, s, dtype, seed):
  gen = torch.Generator(device=dev).manual_seed(seed)
  q = torch.randn((b, t, n, h), generator=gen, device=dev) * h ** -0.5
  kc = torch.randn((b * n_kv, h, s), generator=gen, device=dev)
  vc = torch.randn((b * n_kv, s, h), generator=gen, device=dev)
  mask = torch.rand((b, t, s), generator=gen, device=dev) < 0.7
  mask[:, :, 0] = True
  return q.to(dtype), kc.to(dtype), vc.to(dtype), mask


def _k4_launches():
  f = da.decode_attention
  return (f.launches, f.launches_sm90, f.launches_simt)


def _close(got, want, dtype):
  tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
  torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b=8, t=1, n=8, n_kv=8, h=128, s=1024, cap=50.0),   # slice decode
    dict(b=8, t=512, n=8, n_kv=8, h=128, s=1024, cap=50.0),  # slice prefill
    dict(b=3, t=5, n=8, n_kv=2, h=64, s=77),                 # GQA, S % 8 != 0
    dict(b=2, t=37, n=4, n_kv=1, h=256, s=200, cap=30.0),    # hd 256, S tile 64
    dict(b=1, t=17, n=2, n_kv=2, h=40, s=130),               # T tiles, odd hd
], ids=["decode", "prefill", "gqa_ragged", "hd256", "odd_hd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_kernel_matches_plain(dev, case, dtype):
  case = dict(case)
  cap = case.pop("cap", 0.0)
  q, kc, vc, mask = _inputs(dev, dtype=dtype, seed=0, **case)
  before = _k4_launches()
  got = da.decode_attention(q, kc, vc, mask, n_kv_heads=case["n_kv"],
                            logit_cap=cap)
  torch.cuda.synchronize()
  sm90 = da.takes_sm90(q.dtype, kc.dtype, case["h"], case["s"])
  assert _k4_launches() == tuple(
      x + d for x, d in zip(before, (1, int(sm90), int(not sm90))))
  want = da.decode_attention_reference(q, kc, vc, mask,
                                       n_kv_heads=case["n_kv"], logit_cap=cap)
  _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s", [(4, 300), (2, 304), (100, 304)],
                         ids=["simt", "split_s", "wgmma"])
@pytest.mark.parametrize("layout", ["batch_major", "head_major"])
def test_decode_attention_kernel_stats_and_masked_row(dev, layout, t, s):
  """S 300 takes the scalar kernel, S 304 the Hopper kernels (T 2: split-S,
  T 100: wgmma)."""
  q, kc, vc, mask = _inputs(dev, 2, t, 4, 2, 128, s, torch.bfloat16, seed=1)
  mask[1, t - 1] = False
  kw = dict(n_kv_heads=2, logit_cap=50.0, layout=layout, return_stats=True)
  before = _k4_launches()
  out, m, l = da.decode_attention(q, kc, vc, mask, **kw)
  assert _k4_launches()[1] == before[1] + int(s % 8 == 0)
  out_r, m_r, l_r = da.decode_attention_reference(q, kc, vc, mask, **kw)
  _close(out, out_r, torch.bfloat16)
  torch.testing.assert_close(m, m_r, **F32_TOL)
  torch.testing.assert_close(l, l_r, **F32_TOL)
  assert float(out[1, t - 1].abs().max()) == 0.0
  assert float(l[1, t - 1].max()) == 0.0


@pytest.mark.cuda
def test_decode_attention_kernel_mixed_dtypes_and_strided_q(dev):
  """f32 q over a bf16 cache, and q as a strided view."""
  q, kc, vc, mask = _inputs(dev, 2, 3, 4, 4, 64, 96, torch.float32, seed=2)
  kc, vc = kc.bfloat16(), vc.bfloat16()
  q_strided = torch.cat([q, q], dim=-1)[..., :64]   # head stride 128
  assert not q_strided.is_contiguous() and torch.equal(q_strided, q)
  got = da.decode_attention(q_strided, kc, vc, mask, n_kv_heads=4)
  want = da.decode_attention_reference(q, kc, vc, mask, n_kv_heads=4)
  _close(got, want, torch.float32)


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take(dev):
  q, kc, vc, mask = _inputs(dev, 1, 1, 2, 2, 16, 8, torch.float32, seed=3)
  before = da.decode_attention.launches
  with pytest.raises(TypeError):
    da.decode_attention(q.half(), kc, vc, mask, n_kv_heads=2)
  with pytest.raises(ValueError, match="contiguous"):
    da.decode_attention(q, kc.transpose(1, 2).contiguous().transpose(1, 2),
                        vc, mask, n_kv_heads=2)
  q_big, kc_big, vc_big, mask_big = _inputs(dev, 1, 1, 1, 1, 512, 8,
                                            torch.float32, seed=4)
  with pytest.raises(ValueError, match="head_dim"):
    da.decode_attention(q_big, kc_big, vc_big, mask_big, n_kv_heads=1)
  assert da.decode_attention.launches == before


def _k4_mask(dev, kind, b, t, s):
  qi = torch.arange(t, device=dev)[:, None] + (s - t)  # queries at the end
  ki = torch.arange(s, device=dev)[None, :]
  mask = {"causal": ki <= qi,
          "prefix_lm": (ki < 100) | (ki <= qi),
          "window": (ki <= qi) & (qi - ki < 200),
          "dead_splits": (ki < 64) | ((ki >= 512) & (ki < 700)) | (ki == qi),
          }[kind]
  return mask.expand(b, t, s).contiguous()


# The Hopper kernels (csrc/decode_attention_sm90.cu) in both designs:
# split-S for T * rep <= 16 query rows per kv row, wgmma above.
@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b=2, t=1, n=8, n_kv=2, h=128, s=200, mask="random"),    # split-S
    dict(b=2, t=4, n=8, n_kv=2, h=128, s=200, mask="random"),    # 16 rows
    dict(b=2, t=5, n=8, n_kv=2, h=128, s=200, mask="random"),    # wgmma
    dict(b=2, t=8, n=8, n_kv=2, h=64, s=1000, mask="causal"),
    dict(b=2, t=1, n=8, n_kv=8, h=128, s=1024, mask="dead_splits"),
    dict(b=2, t=300, n=4, n_kv=2, h=72, s=512, mask="prefix_lm"),
    dict(b=2, t=300, n=4, n_kv=4, h=8, s=512, mask="window"),
    dict(b=1, t=130, n=2, n_kv=1, h=128, s=136, mask="causal"),
], ids=["t1_gqa", "t4_gqa", "t5_gqa", "t8_hd64", "dead_splits", "prefix_lm",
        "window_hd8", "t130_ragged"])
def test_decode_attention_sm90_matches_plain(dev, case):
  case = dict(case)
  kind = case.pop("mask")
  q, kc, vc, mask = _inputs(dev, dtype=torch.bfloat16, seed=5, **case)
  if kind != "random":
    mask = _k4_mask(dev, kind, case["b"], case["t"], case["s"])
  kw = dict(n_kv_heads=case["n_kv"], logit_cap=50.0)
  before = _k4_launches()
  got = da.decode_attention(q, kc, vc, mask, **kw)
  torch.cuda.synchronize()
  assert _k4_launches() == tuple(x + d for x, d in zip(before, (1, 1, 0)))
  _close(got, da.decode_attention_reference(q, kc, vc, mask, **kw),
         torch.bfloat16)
  again = da.decode_attention(q, kc, vc, mask, **kw)
  assert torch.equal(got, again), "two calls differ"


def _m7_mask(dev, kind, b, t, s):
  """M7's masks: rows at their own lengths with row 5 parked (key 0 only),
  as the server's bursts and chunks; a T-token block at an offset (the
  speculative verify, a chunk prefill; the draft's causal prefill from
  0 and its decode step at key 760); one length for every beam row."""
  ki = torch.arange(s, device=dev)
  tq = torch.arange(t, device=dev)[None, :, None]
  if kind == "per_row":
    lens = torch.tensor([40, 900, 511, 512, 1, 0, 700, 990],
                        device=dev)[:b, None, None]
    mask = ki <= lens + tq
    mask[5] = ki == 0
    return mask.contiguous()
  off = {"verify": s - 266, "chunk": 256, "beam": 600, "draft_step": 760,
         "prefill": 0, "moe_step": 512, "moe_last": s - 1}[kind]
  return (ki <= off + tq).expand(b, t, s).contiguous()


# M7's shapes on the Hopper kernels: the server's per-row masks with a
# parked row (split-S at T 1, wgmma at T 32), the speculative verify (T 5)
# at the target's hd 128 and the draft's hd 32, the draft's own steps at
# hd 32 (its T 507 prefill and a T 1 step late in its 768 cache, which
# the speculative path runs), a 256-token chunk at an offset, 64 beam rows;
# and the MoE model's greedy generation (b8, S 576): its causal T 512
# prefill and its T 1 steps with keys 0-512 and all 576 live.
@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b=8, t=1, h=128, s=1024, mask="per_row"),
    dict(b=8, t=32, h=128, s=1024, mask="per_row"),
    dict(b=1, t=5, h=128, s=768, mask="verify"),
    dict(b=1, t=5, h=32, s=768, mask="verify"),
    dict(b=1, t=1, h=32, s=768, mask="draft_step"),
    dict(b=1, t=507, h=32, s=768, mask="prefill"),
    dict(b=1, t=256, h=128, s=1024, mask="chunk"),
    dict(b=64, t=1, h=128, s=768, mask="beam"),
    dict(b=8, t=512, h=128, s=576, mask="prefill"),
    dict(b=8, t=1, h=128, s=576, mask="moe_step"),
    dict(b=8, t=1, h=128, s=576, mask="moe_last"),
], ids=["burst_parked", "chunk32_parked", "verify_hd128", "verify_hd32",
        "draft_step_hd32", "draft_prefill_hd32", "chunk256_offset",
        "beam_rows_64", "moe_prefill_s576", "moe_step_s576",
        "moe_last_step_s576"])
def test_decode_attention_sm90_at_m7_shapes(dev, case):
  case = dict(case)
  kind = case.pop("mask")
  q, kc, vc, _ = _inputs(dev, n=8, n_kv=8, dtype=torch.bfloat16, seed=15,
                         **case)
  mask = _m7_mask(dev, kind, case["b"], case["t"], case["s"])
  kw = dict(n_kv_heads=8, logit_cap=50.0)
  before = _k4_launches()
  got = da.decode_attention(q, kc, vc, mask, **kw)
  torch.cuda.synchronize()
  assert _k4_launches() == tuple(x + d for x, d in zip(before, (1, 1, 0)))
  _close(got, da.decode_attention_reference(q, kc, vc, mask, **kw),
         torch.bfloat16)
  assert torch.equal(got, da.decode_attention(q, kc, vc, mask, **kw))


def _causal_inputs(dev, t, dtype, b=4, n=8, n_kv=4, h=128, s=1024):
  """K4 inputs whose queries sit at positions 512 - t + 1 .. 512 of an S
  1024 cache (a decode step after a 512-token prompt, or its prefill): the
  keys past 512 are masked."""
  q, kc, vc, _ = _inputs(dev, b, t, n, n_kv, h, s, dtype, seed=18)
  pos = torch.arange(513 - t, 513, device=dev)
  mask = torch.arange(s, device=dev)[None, :] <= pos[:, None]
  return q, kc, vc, mask[None].expand(b, t, s).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("t", [1, 512], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_tp_shards_match_unsharded(dev, m, t, dtype):
  """serve_tp's shards: K4 on each rank's n_kv / m kv heads in head-major
  rows (and their q heads, GQA 8/4) equals the unsharded call's heads."""
  q, kc, vc, mask = _causal_inputs(dev, t, dtype)
  b, _, n, h = q.shape
  n_kv, s = kc.shape[0] // b, kc.shape[-1]
  want = da.decode_attention(q, kc, vc, mask, n_kv_heads=n_kv,
                             logit_cap=50.0)
  nkv_l, n_l = n_kv // m, n // m
  for r in range(m):
    heads = slice(r * nkv_l, (r + 1) * nkv_l)
    k_l = kc.view(b, n_kv, h, s)[:, heads].transpose(0, 1).reshape(
        nkv_l * b, h, s).contiguous()
    v_l = vc.view(b, n_kv, s, h)[:, heads].transpose(0, 1).reshape(
        nkv_l * b, s, h).contiguous()
    got = da.decode_attention(q[:, :, r * n_l:(r + 1) * n_l].contiguous(),
                              k_l, v_l, mask, n_kv_heads=nkv_l,
                              logit_cap=50.0, layout="head_major")
    _close(got, want[:, :, r * n_l:(r + 1) * n_l], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("t", [1, 512], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_sp_shards_merge_to_unsharded(dev, m, t, dtype):
  """serve_sp's shards: K4 with return_stats on each rank's S / m keys,
  merged by merge_partials over the stacked shards, equals the unsharded
  call; a shard past the queries' positions is fully masked and reports
  l = 0."""
  q, kc, vc, mask = _causal_inputs(dev, t, dtype)
  n_kv, s = kc.shape[0] // q.shape[0], kc.shape[-1]
  want = da.decode_attention(q, kc, vc, mask, n_kv_heads=n_kv,
                             logit_cap=50.0)
  sl = s // m
  stats = [da.decode_attention(
      q, kc[..., r * sl:(r + 1) * sl].contiguous(),
      vc[:, r * sl:(r + 1) * sl].contiguous(),
      mask[..., r * sl:(r + 1) * sl].contiguous(), n_kv_heads=n_kv,
      logit_cap=50.0, return_stats=True) for r in range(m)]
  for r, (_, _, l) in enumerate(stats):
    assert bool(l.any()) == (r * sl <= 512), r
  got = da.merge_partials(*(torch.stack(x) for x in zip(*stats)),
                          lambda x: x.amax(0, keepdim=True),
                          lambda x: x.sum(0, keepdim=True))[0]
  _close(got, want, dtype)


@pytest.mark.cuda
def test_lm_server_burst_on_card_syncs_nothing_and_runs_k4(dev):
  """LMServer on the card with use_decode_kernel=True (a small bf16 model,
  a 1024 cache): no host sync inside a burst (sync debug mode "error"),
  every burst step and chunk through the Hopper K4 (n_layers a call), each
  request's budget emitted in the vocabulary."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.inference import lm_server
  from automl_tpu_torch.models import lm as lm_lib
  cfg = lm_lib.get_lm_config("lm-test")
  cfg.update(dict(model_dim=64, head_dim=16, vocab_size=384))
  model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev),
                                  convert.numpy_init(cfg, 0))
  rng = torch.Generator().manual_seed(0)
  reqs = [lm_server.GenRequest(torch.randint(3, 384, (n,), generator=rng)
                               .tolist(), m)
          for n, m in ((40, 30), (300, 20), (9, 50), (500, 12))]
  server = lm_server.LMServer(model, max_batch=2, max_seq_len=1024, burst=4,
                              prefill_chunk=128, use_decode_kernel=True)
  burst = server._decode_burst

  def checked(*a, **kw):
    torch.cuda.set_sync_debug_mode("error")
    try:
      return burst(*a, **kw)
    finally:
      torch.cuda.set_sync_debug_mode(0)

  server._decode_burst = checked
  da.decode_attention.launches = da.decode_attention.launches_sm90 = 0
  got = server.serve(reqs)
  kinds = [e["kind"] for e in server.timeline]
  want = cfg.n_layers * (4 * kinds.count("burst") + kinds.count("chunk"))
  assert kinds.count("chunk") == 3 + 4
  assert (da.decode_attention.launches,
          da.decode_attention.launches_sm90) == (want, want)
  assert [len(r.tokens) for r in got] == [r.max_new_tokens for r in reqs]
  assert all(0 <= t < 384 for r in got for t in r.tokens)


@pytest.mark.cuda
def test_decode_attention_sm90_refuses_what_it_does_not_take(dev):
  q, kc, vc, mask = _inputs(dev, 2, 1, 4, 2, 128, 64, torch.bfloat16, seed=8)
  before = _k4_launches()
  with pytest.raises(TypeError, match="bool"):
    da.decode_attention(q, kc, vc, mask.to(torch.uint8), n_kv_heads=2)
  with pytest.raises(ValueError, match="contiguous"):
    da.decode_attention(q, kc, vc.transpose(1, 2).contiguous().transpose(1, 2),
                        mask, n_kv_heads=2)
  with pytest.raises(ValueError, match="divisible"):
    da.decode_attention(q[:, :, :3], kc, vc, mask, n_kv_heads=2)
  assert _k4_launches() == before


def _flash_inputs(dev, b, t, n, h, dtype, seed, segments=False):
  gen = torch.Generator(device=dev).manual_seed(seed)
  q, k, v, g = (torch.randn((b, t, n, h), generator=gen, device=dev).to(dtype)
                for _ in range(4))
  segs = None
  if segments:
    segs = torch.cumsum((torch.rand((b, t), generator=gen, device=dev) < 0.05)
                        .int(), dim=1).int().contiguous()
  return q, k, v, g, segs


FLASH_CASES = pytest.mark.parametrize("case", [
    dict(b=2, t=512, n=4, h=128, dtype=torch.bfloat16, logit_cap=50.0,
         sm_scale=128 ** -0.5),                                  # mid size
    dict(b=2, t=77, n=3, h=16, dtype=torch.float32),             # ragged T
    dict(b=2, t=200, n=2, h=64, dtype=torch.float32, window=16,
         logit_cap=5.0),                                         # window
    dict(b=2, t=130, n=2, h=100, dtype=torch.float32,
         segments=True),                                         # segments
    dict(b=1, t=64, n=1, h=8, dtype=torch.float32, causal=False),
], ids=["bf16_mid", "f32_ragged", "f32_window_cap", "f32_segments_hd100",
        "f32_non_causal"])


def _flash_launches():
  f = fa.flash_attention
  return (f.launches_fwd, f.launches_bwd, f.launches_dq, f.launches_dkv)


@pytest.mark.cuda
@FLASH_CASES
def test_flash_kernels_match_plain(dev, case):
  """K1 (out, lse) and K2 (dq, dk, dv) against their plain versions on the
  same inputs; each launch counted once."""
  case = dict(case)
  dtype = case.pop("dtype")
  q, k, v, g, segs = _flash_inputs(dev, case.pop("b"), case.pop("t"),
                                   case.pop("n"), case.pop("h"), dtype,
                                   seed=0, segments=case.pop("segments",
                                                             False))
  kw = dict(dict(causal=True, sm_scale=0.25), **case)
  before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
  out, lse = fa.flash_fwd(q, k, v, segs, **kw)
  torch.cuda.synchronize()
  out_r, lse_r = fa.flash_fwd_reference(q, k, v, segs, **kw)
  _close(out, out_r, dtype)
  torch.testing.assert_close(lse, lse_r, **F32_TOL)
  grads = fa.flash_bwd(q, k, v, g, out_r, lse_r, segs, **kw)
  torch.cuda.synchronize()
  for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, g, out_r, lse_r,
                                                     segs, **kw)):
    _close(got, want, dtype)
  assert (fa.flash_attention.launches_fwd,
          fa.flash_attention.launches_bwd) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(t=512, causal=True, logit_cap=50.0),
    dict(t=300, causal=True, window=70),
    dict(t=200, causal=False),
    dict(t=260, causal=False, window=40),
], ids=["causal", "causal_window", "non_causal", "non_causal_window"])
def test_flash_bwd_kernel_is_deterministic(dev, kw):
  """K2 adds dq over key tiles in a fixed order: two calls on the same
  inputs give bit-equal dq, dk, dv."""
  kw = dict(kw)
  q, k, v, g, _ = _flash_inputs(dev, 2, kw.pop("t"), 3, 64, torch.bfloat16,
                                seed=4)
  out, lse = fa.flash_fwd(q, k, v, **kw)
  first = fa.flash_bwd(q, k, v, g, out, lse, **kw)
  second = fa.flash_bwd(q, k, v, g, out, lse, **kw)
  torch.cuda.synchronize()
  for x, y in zip(first, second):
    assert torch.equal(x, y)


@pytest.mark.cuda
@FLASH_CASES
def test_split_bwd_kernels_match_plain(dev, case):
  """K5a (dq) and K5b (dk, dv) against their plain versions on the same
  inputs and the plain forward's (out, lse); each launch counted once."""
  case = dict(case)
  dtype = case.pop("dtype")
  q, k, v, g, segs = _flash_inputs(dev, case.pop("b"), case.pop("t"),
                                   case.pop("n"), case.pop("h"), dtype,
                                   seed=5, segments=case.pop("segments",
                                                             False))
  kw = dict(dict(causal=True, sm_scale=0.25), **case)
  out, lse = fa.flash_fwd_reference(q, k, v, segs, **kw)
  args = (q, k, v, g, out, lse, segs)
  before = _flash_launches()
  dq = fa.flash_bwd_dq(*args, **kw)
  dk, dv = fa.flash_bwd_dkv(*args, **kw)
  torch.cuda.synchronize()
  _close(dq, fa.flash_bwd_dq_reference(*args, **kw), dtype)
  for got, want in zip((dk, dv), fa.flash_bwd_dkv_reference(*args, **kw)):
    _close(got, want, dtype)
  assert _flash_launches() == (before[0], before[1], before[2] + 1,
                               before[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(t=512, causal=True, logit_cap=50.0),
    dict(t=300, causal=True, window=70),
    dict(t=260, causal=False, window=40),
], ids=["causal", "causal_window", "non_causal_window"])
def test_split_bwd_kernels_are_deterministic(dev, kw):
  """K5a keeps dq in registers over the key tiles and K5b dk/dv over the q
  tiles, with no atomics: two calls give bit-equal dq, dk, dv."""
  kw = dict(kw)
  q, k, v, g, _ = _flash_inputs(dev, 2, kw.pop("t"), 3, 128, torch.bfloat16,
                                seed=6)
  out, lse = fa.flash_fwd(q, k, v, **kw)
  args = (q, k, v, g, out, lse)
  first = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
  second = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
  torch.cuda.synchronize()
  for x, y in zip(first, second):
    assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_fused", [False, True], ids=["split", "fused"])
def test_flash_attention_autograd_gqa_on_card_matches_cpu(dev, bwd_fused):
  """flash_attention with GQA 4/2, window, cap, segments and T = 90 through
  autograd on the card (K1, and K5a + K5b or K2) and on the CPU (plain
  versions)."""
  q, _, _, g, segs = _flash_inputs(dev, 2, 90, 4, 32, torch.float32, seed=1,
                                   segments=True)
  _, k, v, _, _ = _flash_inputs(dev, 2, 90, 2, 32, torch.float32, seed=2)
  kw = dict(window=24, logit_cap=50.0, bwd_fused=bwd_fused)

  def run(device):
    xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, segment_ids=segs.to(device), **kw)
    out.backward(g.to(device))
    return [out.detach().cpu()] + [x.grad.cpu() for x in xs]

  # Each side runs twice, so that a failure also says which side does not
  # repeat itself. The CPU side runs on one thread: with several, its sums
  # were seen to change from run to run in one process (ROADMAP Queue 3).
  card, card_again = run(dev), run(dev)
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    cpu, cpu_again = run(torch.device("cpu")), run(torch.device("cpu"))
  finally:
    torch.set_num_threads(threads)
  for i, name in enumerate(("out", "dq", "dk", "dv")):
    note = (f"card rerun bit-equal {torch.equal(card[i], card_again[i])}, "
            f"CPU rerun bit-equal {torch.equal(cpu[i], cpu_again[i])}, card "
            f"rerun vs CPU max|diff| "
            f"{float((card_again[i] - cpu[i]).abs().max()):.3e}")
    torch.testing.assert_close(card[i], cpu[i], **F32_TOL,
                               msg=lambda m, name=name, note=note:
                               f"{name}: {m}; {note}")


@pytest.mark.cuda
def test_flash_kernels_rerun_bit_equal_on_the_gqa_autograd_case(dev):
  """The inputs of test_flash_attention_autograd_gqa_on_card_matches_cpu
  (GQA 4/2 repeated, T 90, hd 32, window 24, cap 50, segment ids, f32),
  through K1, K5a, K5b and K2 directly, 100 times with a flush of the
  allocator's cache between runs: every run bit-equal to the first. A race
  or an uninitialised read would show as a run that differs."""
  q, _, _, g, segs = _flash_inputs(dev, 2, 90, 4, 32, torch.float32, seed=1,
                                   segments=True)
  _, k, v, _, _ = _flash_inputs(dev, 2, 90, 2, 32, torch.float32, seed=2)
  k, v = (x.repeat_interleave(2, dim=2) for x in (k, v))
  kw = dict(causal=True, window=24, logit_cap=50.0, sm_scale=32 ** -0.5)

  def run():
    out, lse = fa.flash_fwd_kernel(q, k, v, segs, **kw)
    args = (q, k, v, g, out, lse, segs)
    return (out, lse, fa.flash_bwd_dq_kernel(*args, **kw),
            *fa.flash_bwd_dkv_kernel(*args, **kw),
            *fa.flash_bwd_kernel(*args, **kw))

  first = [x.clone() for x in run()]
  for i in range(100):
    junk = torch.full((1 << 22,), float("nan"), device=dev)  # dirty memory
    del junk
    again = run()
    for name, x, y in zip(("out", "lse", "K5a dq", "K5b dk", "K5b dv",
                           "K2 dq", "K2 dk", "K2 dv"), first, again):
      assert torch.equal(x, y), f"run {i}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("policy,k1_per_layer", [("full", 2), ("dots", 2),
                                                 ("dots_flash", 1)])
def test_remat_policy_launches_on_card(dev, policy, k1_per_layer):
  """The loss and grads of one lm-test batch on the card with the split
  backward: K1 runs once per layer under dots_flash, which saves its
  (out, lse), and twice under the other policies; K5a and K5b once per
  layer each, K2 never."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm
  from automl_tpu_torch.train import lm_trainer
  cfg = lm.get_lm_config("lm-test")
  cfg.override(dict(use_flash_attention=True, flash_bwd_fused=False,
                    remat_policy=policy))
  model = convert.load_jax_params(lm.TransformerLM(cfg, device=dev),
                                  convert.numpy_init(cfg, 0))
  batch = next(iter(lm_trainer.SyntheticLMData(2, cfg.seq_len,
                                               cfg.vocab_size)))
  batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
  before = _flash_launches()
  loss, _ = lm_trainer.lm_loss_and_grads(model, batch)
  assert torch.isfinite(loss)
  n = cfg.n_layers
  assert tuple(a - b for a, b in zip(_flash_launches(), before)) == (
      k1_per_layer * n, 0, n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [
    dict(use_flash_attention=True, moe_num_experts=4, moe_top_k=2,
         moe_capacity_factor=1.0),
    dict(use_flash_attention=True, use_window_chunk=True,
         window_chunk_size=16),
], ids=["m6_moe", "m6_window_chunk"])
def test_m6_step1_on_card_matches_cpu(dev, overrides):
  """The loss and grads of one lm-test batch (f32 activations, full f32
  matmuls) on the card and on the CPU from one set of weights: with the
  MoE FFN (top-2 at capacity 1.0, which drops slots: the same routing on
  both, so the same slots dropped) and with the chunked local attention.
  Loss rtol 1e-5, every grad leaf F32_TOL. The MoE case runs the f32 K1
  twice and K2 once per layer on the card (flash attention; the chunk
  path runs neither)."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm
  from automl_tpu_torch.train import lm_trainer
  cfg = lm.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", **overrides))
  tree = convert.numpy_init(cfg, 3)
  batch = next(iter(lm_trainer.SyntheticLMData(2, cfg.seq_len,
                                               cfg.vocab_size, seed=4)))

  def run(device):
    model = convert.load_jax_params(lm.TransformerLM(cfg, device=device),
                                    tree)
    loss, grads = lm_trainer.lm_loss_and_grads(
        model, {k: torch.from_numpy(x).to(device) for k, x in batch.items()})
    return float(loss), {k: g.cpu() for k, g in grads.items()}

  before = _flash_launches()
  card = run(dev)
  launched = tuple(a - b for a, b in zip(_flash_launches(), before))
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    cpu = run(torch.device("cpu"))
  finally:
    torch.set_num_threads(threads)
  n = cfg.n_layers
  assert launched == ((2 * n, n, 0, 0) if "moe_num_experts" in overrides
                      else (0, 0, 0, 0))
  assert card[0] == pytest.approx(cpu[0], rel=1e-5)
  for k in cpu[1]:
    torch.testing.assert_close(card[1][k], cpu[1][k], **F32_TOL,
                               msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(dev):
  q, k, v, g, _ = _flash_inputs(dev, 1, 16, 2, 16, torch.float32, seed=3)
  before = _flash_launches()
  with pytest.raises(TypeError):
    fa.flash_fwd(q.half(), k.half(), v.half())
  with pytest.raises(ValueError, match="dtype"):
    fa.flash_fwd(q, k.bfloat16(), v)
  with pytest.raises(ValueError, match="stride"):
    fa.flash_fwd(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
  big = torch.zeros((1, 4, 1, 256), device=dev)
  with pytest.raises(ValueError, match="head_dim"):
    fa.flash_fwd(big, big, big)
  with pytest.raises(ValueError, match="int32"):
    fa.flash_fwd(q, k, v, torch.zeros((1, 16), dtype=torch.int64, device=dev))
  out, lse = fa.flash_fwd_reference(q, k, v)
  for bwd in (fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
    with pytest.raises(ValueError, match="lse"):
      bwd(q, k, v, g, out, lse[:, :8])
    with pytest.raises(ValueError, match="lse"):
      bwd(q, k, v, g, out, lse.cpu())
    with pytest.raises(ValueError, match="dtype"):
      bwd(q, k, v, g.bfloat16(), out, lse)
  assert _flash_launches() == before


def _sm90_launches():
  f = fa.flash_attention
  return f.launches_fwd_sm90, f.launches_bwd_sm90


_SM90_CASES = [
    dict(b=2, t=77, n=3, h=32, logit_cap=50.0),                  # ragged T
    dict(b=2, t=200, n=2, h=64, window=16, logit_cap=5.0,
         segments=True),                                         # window
    dict(b=1, t=2048, n=2, h=128, logit_cap=50.0),               # slice T, hd
    dict(b=2, t=200, n=2, h=128),                                # no cap
    dict(b=1, t=70, n=2, h=64, length_one_docs=True),            # docs of 1
    dict(b=1, t=300, n=2, h=128, causal=False, window=40),
    dict(b=2, t=64, n=4, h=8),                                   # lm-test hd
]
_SM90_IDS = ["hd32_T77_cap50", "hd64_T200_window_segments",
             "hd128_T2048_cap50", "hd128_T200_nocap", "hd64_length1_docs",
             "hd128_non_causal_window", "hd8"]
SM90_CASES = pytest.mark.parametrize("case", _SM90_CASES, ids=_SM90_IDS)


@pytest.mark.cuda
@SM90_CASES
def test_sm90_flash_kernels_match_plain(dev, case):
  """The Hopper K1 (out bf16 tolerance, lse f32) and K2 (dq, dk, dv bf16
  tolerance) on bf16 inputs against their plain versions; each launch is
  counted once as a Hopper launch; K2 called twice is bit-equal."""
  case = dict(case)
  docs = case.pop("length_one_docs", False)
  b, t = case.pop("b"), case.pop("t")
  q, k, v, g, segs = _flash_inputs(dev, b, t, case.pop("n"), case["h"],
                                   torch.bfloat16, seed=7,
                                   segments=case.pop("segments", False))
  if docs:
    segs = torch.arange(t, device=dev, dtype=torch.int32)[None].repeat(b, 1)
  kw = dict(dict(causal=True, sm_scale=case.pop("h") ** -0.5), **case)
  before = _sm90_launches()
  out, lse = fa.flash_fwd(q, k, v, segs, **kw)
  torch.cuda.synchronize()
  out_r, lse_r = fa.flash_fwd_reference(q, k, v, segs, **kw)
  _close(out, out_r, torch.bfloat16)
  torch.testing.assert_close(lse, lse_r, **F32_TOL)
  if docs:   # each query sees only itself
    assert torch.equal(out, v)
  grads = fa.flash_bwd(q, k, v, g, out_r, lse_r, segs, **kw)
  torch.cuda.synchronize()
  for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, g, out_r,
                                                     lse_r, segs, **kw)):
    _close(got, want, torch.bfloat16)
  again = fa.flash_bwd(q, k, v, g, out_r, lse_r, segs, **kw)
  assert all(torch.equal(x, y) for x, y in zip(grads, again))
  assert _sm90_launches() == (before[0] + 1, before[1] + 2)


def _split_sm90_launches():
  f = fa.flash_attention
  return f.launches_dq, f.launches_dkv, f.launches_dq_sm90, f.launches_dkv_sm90


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SM90_CASES + [
    dict(b=2, t=130, n=4, n_kv=2, h=64, logit_cap=50.0, window=48)],
                         ids=_SM90_IDS + ["gqa_flash_attention"])
def test_sm90_split_bwd_kernels_match_plain(dev, case):
  """The Hopper K5a (dq) and K5b (dk, dv) on bf16 inputs, fed the plain
  forward's (out, lse) through flash_bwd_split, against their plain
  versions (bf16 tolerance); each launch counted once, as a Hopper launch;
  a second call bit-equal. The GQA case goes through flash_attention(...,
  bwd_fused=False) with autograd against the same call on the CPU's plain
  versions in f32 (bf16 tolerance)."""
  case = dict(case)
  docs = case.pop("length_one_docs", False)
  n_kv = case.pop("n_kv", None)
  b, t, n, h = (case.pop(x) for x in ("b", "t", "n", "h"))
  q, k, v, g, segs = _flash_inputs(dev, b, t, n, h, torch.bfloat16, seed=12,
                                   segments=case.pop("segments", False))
  if docs:
    segs = torch.arange(t, device=dev, dtype=torch.int32)[None].repeat(b, 1)
  before = _split_sm90_launches()
  if n_kv:
    _, k, v, _, _ = _flash_inputs(dev, b, t, n_kv, h, torch.bfloat16,
                                  seed=13)
    results = []
    for device, dtype in ((dev, torch.bfloat16),
                          (torch.device("cpu"), torch.float32)):
      xs = [x.detach().to(device, dtype).requires_grad_() for x in (q, k, v)]
      out = fa.flash_attention(*xs, bwd_fused=False, **case)
      out.backward(g.to(device, dtype))
      results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    assert _split_sm90_launches() == tuple(x + 1 for x in before)
    for name, got, want in zip(("out", "dq", "dk", "dv"), *results):
      torch.testing.assert_close(got.float(), want, **BF16_TOL,
                                 msg=lambda m, name=name: f"{name}: {m}")
    return
  kw = dict(dict(causal=True, sm_scale=h ** -0.5), **case)
  out, lse = fa.flash_fwd_reference(q, k, v, segs, **kw)
  args = (q, k, v, g, out, lse, segs)
  grads = fa.flash_bwd_split(*args, **kw)
  torch.cuda.synchronize()
  want = (fa.flash_bwd_dq_reference(*args, **kw),
          *fa.flash_bwd_dkv_reference(*args, **kw))
  for got, w in zip(grads, want):
    _close(got, w, torch.bfloat16)
  again = fa.flash_bwd_split(*args, **kw)
  assert all(torch.equal(x, y) for x, y in zip(grads, again))
  assert _split_sm90_launches() == tuple(x + 2 for x in before)


@pytest.mark.cuda
def test_sm90_bwd_split_operand_products_match_f32(dev):
  """K2's p^T g, ds^T q and ds k take p and ds as two bf16 halves (hi +
  lo, about 16 mantissa bits) through bf16 wgmma. Against the plain f32
  backward of the same bf16 values, with no rounding of p or ds: each
  term's factor is off by at most 2^-17 of itself, so a sum is off by at
  most 2^-17 of the sum of its terms' magnitudes (<= 2^-17 * n_terms *
  max term; bounded here by 2^-12 of the largest output); the output's
  final bf16 rounding adds 2^-9 of itself. Tolerance: atol 2^-12 * max|x|,
  rtol 2^-8. Rounding p or ds to bf16 once would leave 2^-9 of each term."""
  q, k, v, g, _ = _flash_inputs(dev, 2, 256, 2, 128, torch.bfloat16, seed=8)
  kw = dict(causal=True, logit_cap=50.0, sm_scale=128 ** -0.5)
  out, lse = fa.flash_fwd_reference(q.float(), k.float(), v.float(), None,
                                    **kw)
  grads = fa.flash_bwd(q, k, v, g, out.bfloat16(), lse, None, **kw)
  want = fa.flash_bwd_reference(q.float(), k.float(), v.float(), g.float(),
                                out.bfloat16().float(), lse, None, **kw)
  for got, ref in zip(grads, want):
    scale = float(ref.abs().max())
    torch.testing.assert_close(got.float(), ref, atol=2 ** -12 * scale,
                               rtol=2 ** -8)


@pytest.mark.cuda
def test_flash_attention_gqa_bf16_fused_takes_sm90_kernels(dev):
  """flash_attention with GQA 4/2, cap, bwd_fused=True on bf16 CUDA
  tensors (the Hopper K1 and K2) against the same call on the CPU's plain
  versions in f32, bf16 tolerance."""
  q, _, _, g, _ = _flash_inputs(dev, 2, 130, 4, 64, torch.bfloat16, seed=9)
  _, k, v, _, _ = _flash_inputs(dev, 2, 130, 2, 64, torch.bfloat16, seed=10)
  before = _sm90_launches()
  results = []
  for device, dtype in ((dev, torch.bfloat16),
                        (torch.device("cpu"), torch.float32)):
    xs = [x.detach().to(device, dtype).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, logit_cap=50.0, bwd_fused=True)
    out.backward(g.to(device, dtype))
    results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
  assert _sm90_launches() == (before[0] + 1, before[1] + 1)
  for name, got, want in zip(("out", "dq", "dk", "dv"), *results):
    torch.testing.assert_close(got.float(), want, **BF16_TOL,
                               msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_sm90_flash_kernels_refuse_what_tma_does_not_take(dev):
  """bf16 goes to the Hopper kernels, whose TMA descriptors need head_dim
  a multiple of 8 and strides of multiples of 8 elements: others raise,
  as does head_dim > 128; nothing is launched. The split backward's
  wrappers (K5a, K5b and flash_bwd_split) refuse the same."""
  q, k, v, g, _ = _flash_inputs(dev, 1, 16, 2, 16, torch.bfloat16, seed=11)
  before = (_flash_launches(), _sm90_launches(), _split_sm90_launches())
  odd = torch.cat([q, q[..., :4]], dim=-1)[..., :16]   # n stride 20
  assert odd.stride(-1) == 1 and odd.stride(2) == 20
  with pytest.raises(ValueError, match="stride"):
    fa.flash_fwd(odd, k, v)
  with pytest.raises(ValueError, match="stride"):
    fa.flash_bwd(q, k, v, odd, q, torch.zeros((2, 16), device=dev))
  h12 = torch.zeros((1, 16, 2, 12), device=dev, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="head_dim"):
    fa.flash_fwd(h12, h12, h12)
  big = torch.zeros((1, 4, 1, 256), device=dev, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="head_dim"):
    fa.flash_fwd(big, big, big)
  lse = torch.zeros((2, 16), device=dev)
  for bwd in (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_split):
    with pytest.raises(ValueError, match="stride"):
      bwd(q, k, v, odd, q, lse)
    with pytest.raises(ValueError, match="head_dim"):
      bwd(h12, h12, h12, h12, h12, lse)
    with pytest.raises(ValueError, match="head_dim"):
      bwd(big, big, big, big, big, torch.zeros((1, 4), device=dev))
  assert (_flash_launches(), _sm90_launches(),
          _split_sm90_launches()) == before


def _xent_inputs(dev, m, v, d, dtype, seed, zero_share=0.2):
  gen = torch.Generator(device=dev).manual_seed(seed)
  x = (0.5 * torch.randn((m, d), generator=gen, device=dev)).to(dtype)
  w = (torch.randn((v, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
  targets = torch.randint(0, v, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
  weights = (torch.rand((m,), generator=gen, device=dev) >= zero_share).float()
  return x, w, targets, weights


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(m=100, v=1000, d=128, cap=30.0),       # ragged M and V
    dict(m=100, v=1000, d=128, cap=0.0),
    dict(m=257, v=333, d=72, cap=30.0),         # D not a multiple of 64
    dict(m=64, v=128, d=1024, cap=30.0),        # the slice's D, whole tiles
    dict(m=3, v=5000, d=32, cap=0.0),           # few tokens, small D
], ids=["ragged_cap", "ragged_nocap", "odd_d", "slice_d", "few_tokens"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_xent_kernels_match_plain(dev, case, dtype):
  """K3a (lse, tz; f32 atol 1e-4) and K3b / K3c (dx, dW in f32 against the
  plain versions fed the same lse and coef, 20% zero weights) on the same
  inputs; each launch counted once. dx / dW tolerance atol 1e-6, rtol
  1e-3: f32 sums in another order, and with bf16 operands dz rounded to
  bf16 from logits summed in another order (a term that lands on the other
  side of a rounding step moves by 2^-8 of itself)."""
  x, w, targets, weights = _xent_inputs(dev, case["m"], case["v"], case["d"],
                                        dtype, seed=0)
  cap = case["cap"]
  counts = lambda: (xent.fused_softmax_xent.launches_fwd,
                    xent.fused_softmax_xent.launches_dx,
                    xent.fused_softmax_xent.launches_dw)
  before = counts()
  lse, tz = xent.xent_fwd(x, w, targets, logit_cap=cap)
  torch.cuda.synchronize()
  lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
  torch.testing.assert_close(lse, lse_r, **F32_TOL)
  torch.testing.assert_close(tz, tz_r, **F32_TOL)
  coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
  kw = dict(logit_cap=cap, out_dtype=torch.float32)
  for fn, ref in ((xent.xent_dx, xent.xent_dx_reference),
                  (xent.xent_dw, xent.xent_dw_reference)):
    got = fn(x, w, targets, lse_r, coef, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref(x, w, targets, lse_r, coef, **kw),
                               atol=1e-6, rtol=1e-3)
  assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
def test_xent_bwd_kernels_are_deterministic_and_zero_weight_rows(dev):
  """K3b and K3c own their output rows and sum in a fixed order: two calls
  are bit-equal. A token with weight 0 gets dx = 0 in its row."""
  x, w, targets, weights = _xent_inputs(dev, 300, 2000, 256, torch.bfloat16,
                                        seed=1)
  weights[7] = 0.0
  lse, _ = xent.xent_fwd(x, w, targets, logit_cap=30.0)
  coef = (weights / weights.sum()).contiguous()
  for fn in (xent.xent_dx, xent.xent_dw):
    first = fn(x, w, targets, lse, coef, logit_cap=30.0)
    second = fn(x, w, targets, lse, coef, logit_cap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
  dx = xent.xent_dx(x, w, targets, lse, coef, logit_cap=30.0)
  assert float(dx[7].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_fused_softmax_xent_autograd_on_card_matches_cpu(dev, tied):
  """fused_softmax_xent through autograd with bf16 operands on the card
  (K3a-c) and on the CPU (plain versions), from the same f32 x / w:
  loss rtol 1e-5, dx / dW atol 1e-6, rtol 1e-3 (see above)."""
  x, w, targets, weights = _xent_inputs(dev, 150, 700, 64, torch.float32,
                                        seed=2)
  if not tied:
    w = w.t().contiguous()
  results = []
  for device in (dev, torch.device("cpu")):
    xs = [t.detach().to(device).requires_grad_() for t in (x, w)]
    loss = xent.fused_softmax_xent(*xs, targets.to(device),
                                   weights.to(device), tied=tied,
                                   logit_cap=30.0)
    loss.backward()
    results.append([loss.detach().cpu()] + [t.grad.cpu() for t in xs])
  (loss, dx, dw), (loss_r, dx_r, dw_r) = results
  torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=0)
  torch.testing.assert_close(dx, dx_r, atol=1e-6, rtol=1e-3)
  torch.testing.assert_close(dw, dw_r, atol=1e-6, rtol=1e-3)


@pytest.mark.cuda
def test_xent_kernels_refuse_what_they_do_not_take(dev):
  x, w, targets, weights = _xent_inputs(dev, 16, 40, 64, torch.float32,
                                        seed=3)
  before = (xent.fused_softmax_xent.launches_fwd,
            xent.fused_softmax_xent.launches_dx,
            xent.fused_softmax_xent.launches_dw)
  with pytest.raises(TypeError):
    xent.xent_fwd(x.half(), w.half(), targets)
  with pytest.raises(ValueError, match="one dtype"):
    xent.xent_fwd(x, w.bfloat16(), targets)
  with pytest.raises(ValueError, match="contiguous"):
    xent.xent_fwd(x.t().contiguous().t(), w, targets)
  with pytest.raises(ValueError, match="multiple of 8"):
    xent.xent_fwd(x[:, :60].contiguous(), w[:, :60].contiguous(), targets)
  # The pure limit is csrc/xent.cu's own; beyond it its backward refuses.
  assert xent._kernel_fns()[3](1) == xent.simt_bwd_max_dim(torch.bfloat16)
  assert xent._kernel_fns()[3](0) == xent.simt_bwd_max_dim(torch.float32)
  big = xent.simt_bwd_max_dim(torch.bfloat16) + 8
  zb = lambda r: torch.zeros((r, big), device=dev, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="up to"):
    xent.xent_dx(zb(4), zb(8), targets[:4], weights[:4], weights[:4])
  with pytest.raises(ValueError, match="targets"):
    xent.xent_fwd(x, w, targets.long())
  lse, _ = xent.xent_fwd_reference(x, w, targets)
  with pytest.raises(ValueError, match="coef"):
    xent.xent_dx(x, w, targets, lse, weights[:8].contiguous())
  assert (xent.fused_softmax_xent.launches_fwd,
          xent.fused_softmax_xent.launches_dx,
          xent.fused_softmax_xent.launches_dw) == before


def _xent_counts():
  f = xent.fused_softmax_xent
  return (f.launches_fwd, f.launches_dx, f.launches_dw, f.launches_dx_sm90,
          f.launches_dw_sm90)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(m=100, v=1000, d=256, cap=30.0),       # C 1, ragged M and V
    dict(m=300, v=700, d=512, cap=0.0),         # C 2, no cap
    dict(m=257, v=333, d=768, cap=30.0),        # C 3: rows 21 / 21 / 22
    dict(m=130, v=2000, d=1024, cap=30.0),      # C 4, the slice's D
    dict(m=3840, v=200, d=1024, cap=0.0),       # 30 own tiles of dx
    dict(m=200, v=3000, d=2048, cap=30.0),      # C 8, the default LM's D
    dict(m=64, v=64, d=2048, cap=0.0),          # one tile each way
], ids=["d256", "d512_nocap", "d768", "d1024", "d1024_30tiles", "d2048",
        "d2048_one_tile"])
def test_xent_sm90_kernels_match_plain(dev, case):
  """The Hopper K3b / K3c (bf16, D a multiple of 256) against their plain
  versions fed the same lse and coef: dx / dW in f32 atol 1e-6, rtol 1e-3
  (see test_xent_kernels_match_plain) and in bf16 atol 1e-5, rtol 8e-3
  (plus one bf16 rounding); each launch counted once, as a Hopper one. The
  small cases split their few own tiles along the streamed rows (the last
  wave's plan) and sum the parts in a fixed order."""
  x, w, targets, weights = _xent_inputs(dev, case["m"], case["v"], case["d"],
                                        torch.bfloat16, seed=4)
  cap = case["cap"]
  lse, _ = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
  coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
  before = _xent_counts()
  for fn, ref in ((xent.xent_dx, xent.xent_dx_reference),
                  (xent.xent_dw, xent.xent_dw_reference)):
    for out_dtype, tol in ((torch.float32, dict(atol=1e-6, rtol=1e-3)),
                           (torch.bfloat16, dict(atol=1e-5, rtol=8e-3))):
      kw = dict(logit_cap=cap, out_dtype=out_dtype)
      got = fn(x, w, targets, lse, coef, **kw)
      torch.cuda.synchronize()
      assert got.dtype == out_dtype
      torch.testing.assert_close(got.float(), ref(x, w, targets, lse, coef,
                                                  **kw).float(), **tol)
  assert _xent_counts() == tuple(b + n for b, n in zip(before,
                                                       (0, 2, 2, 2, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [512, 1024], ids=["d512", "d1024"])
def test_xent_sm90_bwd_deterministic_and_zero_weight_rows(dev, d):
  """The Hopper K3b / K3c sum the cluster's partial logits in rank order
  and a split tile's parts in part order, and write each output once: two
  calls are bit-equal. A token with weight 0 gets dx = 0 exactly."""
  x, w, targets, weights = _xent_inputs(dev, 300, 2000, d, torch.bfloat16,
                                        seed=5)
  weights[7] = 0.0
  lse, _ = xent.xent_fwd(x, w, targets, logit_cap=30.0)
  coef = (weights / weights.sum()).contiguous()
  before = _xent_counts()
  for fn in (xent.xent_dx, xent.xent_dw):
    first = fn(x, w, targets, lse, coef, logit_cap=30.0)
    second = fn(x, w, targets, lse, coef, logit_cap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
  dx = xent.xent_dx(x, w, targets, lse, coef, logit_cap=30.0)
  assert float(dx[7].float().abs().max()) == 0.0
  assert float(dx[8].float().abs().max()) > 0.0
  assert _xent_counts()[3:] == (before[3] + 3, before[4] + 2)


@pytest.mark.cuda
def test_xent_bwd_dispatch_by_counter(dev):
  """bf16 with D 1,024 goes to the Hopper kernels; bf16 with D 72, float32,
  and `_simt=True` go to csrc/xent.cu's (whose result on the D 1,024 case
  matches the Hopper kernels' within the plain-version tolerance)."""
  cases = ((torch.bfloat16, 1024, {}, 1), (torch.bfloat16, 72, {}, 0),
           (torch.float32, 256, {}, 0), (torch.bfloat16, 1024,
                                         dict(_simt=True), 0))
  outs = {}
  for dtype, d, kw, sm90 in cases:
    x, w, targets, weights = _xent_inputs(dev, 130, 900, d, dtype, seed=6)
    lse, _ = xent.xent_fwd(x, w, targets, logit_cap=30.0)
    coef = (weights / weights.sum()).contiguous()
    before = _xent_counts()
    outs[(d, bool(kw))] = [
        xent.xent_dx_kernel(x, w, targets, lse, coef, logit_cap=30.0,
                            out_dtype=torch.float32, **kw),
        xent.xent_dw_kernel(x, w, targets, lse, coef, logit_cap=30.0,
                            out_dtype=torch.float32, **kw)]
    torch.cuda.synchronize()
    assert _xent_counts() == tuple(
        b + n for b, n in zip(before, (0, 1, 1, sm90, sm90))), (dtype, d, kw)
  for a, b in zip(outs[(1024, False)], outs[(1024, True)]):
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-3)


@pytest.mark.cuda
def test_xent_kernels_take_the_default_lm_dim(dev):
  """The default LM's D 2,048 (automl_tpu/models/lm.py:47), bf16: K3a, K3b
  and K3c run (before, all three were refused above D 1,216) and match
  their plain versions: lse / tz f32 atol 1e-4; dx / dW atol 1e-6, rtol
  1e-3. So does K3a with float32 operands."""
  x, w, targets, weights = _xent_inputs(dev, 300, 1500, 2048, torch.bfloat16,
                                        seed=7)
  before = _xent_counts()
  lse, tz = xent.xent_fwd(x, w, targets, logit_cap=30.0)
  lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=30.0)
  torch.testing.assert_close(lse, lse_r, **F32_TOL)
  torch.testing.assert_close(tz, tz_r, **F32_TOL)
  coef = (weights / weights.sum()).contiguous()
  kw = dict(logit_cap=30.0, out_dtype=torch.float32)
  for fn, ref in ((xent.xent_dx, xent.xent_dx_reference),
                  (xent.xent_dw, xent.xent_dw_reference)):
    torch.testing.assert_close(fn(x, w, targets, lse_r, coef, **kw),
                               ref(x, w, targets, lse_r, coef, **kw),
                               atol=1e-6, rtol=1e-3)
  assert _xent_counts() == tuple(b + n for b, n in zip(before,
                                                       (1, 1, 1, 1, 1)))
  xf, wf = x.float(), w.float()
  lse, _ = xent.xent_fwd(xf, wf, targets, logit_cap=30.0)
  torch.testing.assert_close(
      lse, xent.xent_fwd_reference(xf, wf, targets, logit_cap=30.0)[0],
      **F32_TOL)


@pytest.mark.cuda
def test_xent_sm90_refuses_what_tma_does_not_take(dev):
  """An x or w whose base is not 16-byte aligned (TMA), bf16 D 1,224 (a
  multiple of neither 256 nor within csrc/xent.cu's 1,216) and float32 D
  2,048 raise before any launch; no counter moves."""
  x, w, targets, weights = _xent_inputs(dev, 64, 300, 1024, torch.bfloat16,
                                        seed=8)
  lse, _ = xent.xent_fwd_reference(x, w, targets)
  coef = (weights / weights.sum()).contiguous()
  odd = torch.zeros((64 * 1024 + 4,), dtype=torch.bfloat16,
                    device=dev)[4:].view(64, 1024)
  before = _xent_counts()
  for fn in (xent.xent_dx, xent.xent_dw):
    with pytest.raises(ValueError, match="16-byte aligned"):
      fn(odd, w, targets, lse, coef)
    with pytest.raises(ValueError, match="16-byte aligned"):
      fn(x, torch.zeros((300 * 1024 + 4,), dtype=torch.bfloat16,
                        device=dev)[4:].view(300, 1024), targets, lse, coef)
    for d, dtype in ((1224, torch.bfloat16), (2048, torch.float32)):
      xd = torch.zeros((64, d), dtype=dtype, device=dev)
      wd = torch.zeros((300, d), dtype=dtype, device=dev)
      with pytest.raises(ValueError, match="up to"):
        fn(xd, wd, targets, lse, coef)
  assert _xent_counts() == before


def _fwd_counts():
  f = xent.fused_softmax_xent
  return (f.launches_fwd, f.launches_fwd_sm90)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(m=300, v=1000, d=1024, cap=30.0),      # ragged M and V, C 4
    dict(m=300, v=1000, d=1024, cap=0.0),
    dict(m=1000, v=3333, d=2048, cap=30.0),     # C 8, ragged
    dict(m=129, v=65, d=2048, cap=0.0),         # one own row past a tile
    dict(m=4000, v=700, d=1024, cap=30.0),      # 32 own tiles: the split
    dict(m=100, v=1000, d=256, cap=30.0),       # C 1
    dict(m=257, v=333, d=768, cap=0.0),         # C 3: rows 21 / 21 / 22
], ids=["d1024", "d1024_nocap", "d2048", "d2048_edge", "d1024_split",
        "d256", "d768_nocap"])
def test_xent_sm90_fwd_matches_plain(dev, case):
  """The Hopper K3a (bf16, D a multiple of 256) against the plain K3a: lse
  and the target logit f32 atol = rtol = 1e-4; a second call bit-equal;
  each call one launch, counted as a Hopper one."""
  x, w, targets, _ = _xent_inputs(dev, case["m"], case["v"], case["d"],
                                  torch.bfloat16, seed=9)
  cap = case["cap"]
  before = _fwd_counts()
  lse, tz = xent.xent_fwd(x, w, targets, logit_cap=cap)
  again = xent.xent_fwd(x, w, targets, logit_cap=cap)
  torch.cuda.synchronize()
  assert _fwd_counts() == (before[0] + 2, before[1] + 2)
  lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
  torch.testing.assert_close(lse, lse_r, **F32_TOL)
  torch.testing.assert_close(tz, tz_r, **F32_TOL)
  assert torch.equal(lse, again[0]) and torch.equal(tz, again[1])


@pytest.mark.cuda
def test_xent_fwd_dispatch_by_counter(dev):
  """bf16 with D 1,024 goes to the Hopper K3a; bf16 with D 72, float32 and
  `_simt=True` go to csrc/xent.cu's, whose result on the D 1,024 case
  matches the Hopper kernel's within the plain-version tolerance."""
  outs = {}
  for dtype, d, kw, sm90 in ((torch.bfloat16, 1024, {}, 1),
                             (torch.bfloat16, 72, {}, 0),
                             (torch.float32, 256, {}, 0),
                             (torch.bfloat16, 1024, dict(_simt=True), 0)):
    x, w, targets, _ = _xent_inputs(dev, 130, 900, d, dtype, seed=10)
    before = _fwd_counts()
    outs[(d, dtype, bool(kw))] = xent.xent_fwd_kernel(
        x, w, targets, logit_cap=30.0, **kw)
    torch.cuda.synchronize()
    assert _fwd_counts() == (before[0] + 1, before[1] + sm90), (dtype, d, kw)
  for a, b in zip(outs[(1024, torch.bfloat16, False)],
                  outs[(1024, torch.bfloat16, True)]):
    torch.testing.assert_close(a, b, **F32_TOL)


# K6 (depthwise filter gradient): f32 sums over B*H*W products in another
# order than the plain version's; relative to the largest entry.
K6_SHARE = 1e-4

# EfficientDet-D0's stride-1 depthwise convs at 512 x 512, batch 16 (C, H,
# W, k): every map of a training step.
D0_K6_SHAPES = [(32, 256, 256, 3), (144, 128, 128, 3), (64, 64, 64, 3),
                (240, 64, 64, 5), (64, 32, 32, 3), (672, 32, 32, 5),
                (480, 32, 32, 5), (480, 32, 32, 3), (64, 16, 16, 3),
                (1152, 16, 16, 3), (1152, 16, 16, 5), (64, 8, 8, 3),
                (64, 4, 4, 3)]


def _dw_inputs(dev, b, c, h, w, dtype, seed):
  gen = torch.Generator(device=dev).manual_seed(seed)
  cl = torch.channels_last
  x, dy = (torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
           .contiguous(memory_format=cl) for _ in range(2))
  return x, dy


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b=16, c=64, h=64, w=64, k=3),     # a head level of D0
    dict(b=2, c=240, h=16, w=16, k=5),     # a k5 block, 240 channels
    dict(b=1, c=13, h=15, w=17, k=5),      # ragged, C % 8 != 0, batch 1
    dict(b=3, c=40, h=4, w=4, k=3),        # BiFPN level 7
    dict(b=2, c=33, h=9, w=70, k=7),       # k7, two channel chunks
    dict(b=2, c=8, h=5, w=6, k=1),
], ids=["head", "k5", "ragged", "p7", "k7", "k1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_depthwise_filter_grad_kernel_matches_plain(dev, case, dtype):
  x, dy = _dw_inputs(dev, case["b"], case["c"], case["h"], case["w"], dtype,
                     seed=0)
  before = dwise.depthwise_filter_grad.launches
  got = dwise.depthwise_filter_grad(x, dy, case["k"])
  torch.cuda.synchronize()
  assert dwise.depthwise_filter_grad.launches == before + 1
  want = dwise.depthwise_filter_grad_reference(x, dy, case["k"])
  assert got.dtype == torch.float32 and got.shape == want.shape
  scale = float(want.abs().max())
  torch.testing.assert_close(got, want, atol=K6_SHARE * scale,
                             rtol=K6_SHARE)
  again = dwise.depthwise_filter_grad(x, dy, case["k"])
  assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 5)])
def test_depthwise_conv_autograd_on_card_matches_cpu(dev, stride, k,
                                                     monkeypatch):
  """Knob on: dx (cuDNN) and dW (K6 at stride 1) on the card against the
  same call on the CPU (the plain K6), f32 with TF32 off."""
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  gen = torch.Generator().manual_seed(4)
  x = torch.randn((2, 24, 13, 11), generator=gen)
  ker = torch.randn((24, 1, k, k), generator=gen)
  g = torch.randn_like(dwise.depthwise_conv(x, ker, (stride, stride)))
  before = dwise.depthwise_filter_grad.launches
  outs = []
  dwise.enable_pallas_filter_grad(True)
  try:
    for device in (dev, torch.device("cpu")):
      xs = x.to(device).contiguous(memory_format=torch.channels_last)
      xs.requires_grad_()
      ks = ker.to(device).requires_grad_()
      y = dwise.depthwise_conv(xs, ks, (stride, stride))
      y.backward(g.to(device))
      outs.append((y.detach(), xs.grad, ks.grad))
  finally:
    dwise.enable_pallas_filter_grad(False)
  assert dwise.depthwise_filter_grad.launches == before + (stride == 1)
  for a, b in zip(*outs):
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_depthwise_filter_grad_kernel_refuses_what_it_does_not_take(dev):
  x, dy = _dw_inputs(dev, 1, 8, 6, 6, torch.float32, seed=1)
  before = dwise.depthwise_filter_grad.launches
  with pytest.raises(TypeError):
    dwise.depthwise_filter_grad(x.half(), dy.half(), 3)
  with pytest.raises(TypeError):
    dwise.depthwise_filter_grad(x, dy.bfloat16(), 3)
  with pytest.raises(ValueError, match="channels_last"):
    dwise.depthwise_filter_grad(x.contiguous(), dy.contiguous(), 3)
  with pytest.raises(ValueError, match="k in"):
    dwise.depthwise_filter_grad(x, dy, 9)
  with pytest.raises(NotImplementedError):
    dwise.depthwise_filter_grad(x, dy, 3, stride=2)
  assert dwise.depthwise_filter_grad.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,k", D0_K6_SHAPES,
                         ids=[f"{c}x{h}x{w}_k{k}" for c, h, w, k in
                              D0_K6_SHAPES])
def test_depthwise_sm90_matches_plain_at_d0_maps(dev, c, h, w, k):
  """The Hopper K6 at every map of a D0 step (bf16, b16) against the plain
  version (K6_SHARE of the largest entry); one launch a call, counted as a
  Hopper one; a second call bit-equal."""
  x, dy = _dw_inputs(dev, 16, c, h, w, torch.bfloat16, seed=2)
  f = dwise.depthwise_filter_grad
  before = (f.launches, f.launches_sm90)
  got = dwise.depthwise_filter_grad(x, dy, k)
  again = dwise.depthwise_filter_grad(x, dy, k)
  torch.cuda.synchronize()
  assert (f.launches, f.launches_sm90) == (before[0] + 2, before[1] + 2)
  want = dwise.depthwise_filter_grad_reference(x, dy, k)
  scale = float(want.abs().max())
  torch.testing.assert_close(got, want, atol=K6_SHARE * scale,
                             rtol=K6_SHARE)
  assert torch.equal(got, again)


# EfficientNetV2-S's stride-1 depthwise convs (C, H, W, k) at its four
# progressive training sizes (168, 208, 256, 296): 5 at C 512, 1 at 768 and
# 8 at 960 on the stride-16 map, 14 at 1,536 on the stride-32 map.
V2S_K6_SHAPES = [(c, h, h, 3) for s16, s32 in ((11, 6), (13, 7), (16, 8),
                                                (19, 10))
                 for c, h in ((512, s16), (768, s16), (960, s16),
                              (1536, s32))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,k", V2S_K6_SHAPES,
                         ids=[f"{c}x{h}x{w}_k{k}" for c, h, w, k in
                              V2S_K6_SHAPES])
def test_depthwise_sm90_matches_plain_at_v2s_maps(dev, c, h, w, k):
  """The Hopper K6 at every map of V2-S's progressive training (bf16, b8:
  odd maps, not powers of two) against the plain version (K6_SHARE of the
  largest entry); one Hopper launch a call; a second call bit-equal."""
  x, dy = _dw_inputs(dev, 8, c, h, w, torch.bfloat16, seed=4)
  f = dwise.depthwise_filter_grad
  before = (f.launches, f.launches_sm90)
  got = dwise.depthwise_filter_grad(x, dy, k)
  again = dwise.depthwise_filter_grad(x, dy, k)
  torch.cuda.synchronize()
  assert (f.launches, f.launches_sm90) == (before[0] + 2, before[1] + 2)
  want = dwise.depthwise_filter_grad_reference(x, dy, k)
  torch.testing.assert_close(got, want, atol=K6_SHARE * float(
      want.abs().max()), rtol=K6_SHARE)
  assert torch.equal(got, again)


@pytest.mark.cuda
def test_cls_train_preprocess_on_card_matches_cpu(dev):
  """cls_train_preprocess (crop, flip, RandAugment 2 layers at m 10, v2
  normalization) at b8 from 120 x 120 canvases to 96 x 96, on the card and
  on the CPU from the same draws, on [0, 255]: images whose layers draw no
  nearest warp within atol 1e-3; the others at most 0.1% of their pixels
  off by more."""
  from automl_tpu_torch.data import augment, preprocessing
  gen = torch.Generator().manual_seed(1)
  images = torch.randint(0, 256, (8, 120, 120, 3), generator=gen,
                         dtype=torch.uint8)
  draws = preprocessing.cls_train_draws(8, 96, gen, 2)
  to = lambda d: {k: to(v) if isinstance(v, dict) else v.to(dev)
                  for k, v in d.items()}
  cpu = preprocessing.cls_train_preprocess(images, draws, 96, "randaug", 10.0)
  card = preprocessing.cls_train_preprocess(images.to(dev), to(draws), 96,
                                            "randaug", 10.0).cpu()
  cpu, card = (t.permute(0, 2, 3, 1) * 128.0 + 128.0 for t in (cpu, card))
  warps = {augment.OPS.index(n) for n in ("rotate", "shear_x", "shear_y",
                                          "translate_x", "translate_y")}
  for i in range(8):
    diff = (card[i] - cpu[i]).abs()
    if set(draws["randaug"]["op"][i].tolist()) & warps:
      assert float((diff > 1e-3).any(-1).float().mean()) <= 1e-3, i
    else:
      assert float(diff.max()) <= 1e-3, i


@pytest.mark.cuda
def test_depthwise_filter_grad_dispatch_by_counter(dev):
  """bf16 with C a multiple of 8 goes to the Hopper K6; bf16 C 13, float32
  and `_simt=True` go to csrc/depthwise.cu's, whose result on the bf16
  C 64 case matches the Hopper kernel's (K6_SHARE)."""
  f = dwise.depthwise_filter_grad
  outs = {}
  for c, dtype, kw, sm90 in ((64, torch.bfloat16, {}, 1),
                             (13, torch.bfloat16, {}, 0),
                             (64, torch.float32, {}, 0),
                             (64, torch.bfloat16, dict(_simt=True), 0)):
    x, dy = _dw_inputs(dev, 4, c, 20, 24, dtype, seed=3)
    before = (f.launches, f.launches_sm90)
    outs[(c, dtype, bool(kw))] = dwise.depthwise_filter_grad_kernel(
        x, dy, 3, **kw)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_sm90) == (before[0] + 1,
                                             before[1] + sm90), (c, dtype, kw)
  a, b = outs[(64, torch.bfloat16, False)], outs[(64, torch.bfloat16, True)]
  torch.testing.assert_close(a, b, atol=K6_SHARE * float(b.abs().max()),
                             rtol=K6_SHARE)
  odd = torch.zeros((4 * 20 * 24 * 64 + 4,), dtype=torch.bfloat16,
                    device=dev)[4:].view(4, 20, 24, 64).permute(0, 3, 1, 2)
  before = (f.launches, f.launches_sm90)
  with pytest.raises(ValueError, match="16-byte aligned"):
    dwise.depthwise_filter_grad(odd, odd, 3)
  assert (f.launches, f.launches_sm90) == before


# ---------------------------------------------------------------------------
# The host library (csrc/host/tfrecord_jpeg.cc) with the card machine's
# codec (nvJPEG where there is no libjpeg), and DevicePrefetcher to the
# card. nvJPEG's decode is held to the source pixels: PSNR above 30 dB at
# quality 90 on a smooth image, as libjpeg's is.
# ---------------------------------------------------------------------------


def _smooth_rgb(h, w, seed=0):
  import numpy as np
  rng = np.random.RandomState(seed)
  y, x = np.mgrid[:h, :w]
  img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (h + w)], -1)
  return np.clip(img + rng.randint(-3, 4, (h, w, 3)), 0, 255).astype(
      np.uint8)


def _psnr(a, b):
  import numpy as np
  mse = np.mean((a.astype(np.float64) - b) ** 2)
  return 10 * np.log10(255 ** 2 / max(mse, 1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(480, 640), (427, 640), (375, 500), (17, 23)])
def test_host_library_codec_round_trip(dev, hw):
  from automl_tpu_torch.data import native_loader as nl
  nl.build_host()
  assert nl._load().jpeg_codec().decode() == nl.codec()
  img = _smooth_rgb(*hw)
  data = nl.jpeg_encode_rgb(img, 90)
  assert nl.image_format(data) == "jpeg"
  back = nl.jpeg_decode_full(data)
  assert back.shape == img.shape and _psnr(back, img) > 30
  canvas, (ch, cw) = nl.jpeg_decode_to_canvas(data, 512, 512)
  scale = min(512 / hw[0], 512 / hw[1])
  assert abs(ch - hw[0] * scale) <= 8 and abs(cw - hw[1] * scale) <= 8
  assert canvas[ch:].max(initial=0) == 0 and canvas[:, cw:].max(initial=0) == 0


@pytest.mark.cuda
def test_host_library_pipelines_on_card_machine(dev, tmp_path):
  import numpy as np
  from automl_tpu_torch.data import native_loader as nl
  from automl_tpu_torch.data import pipeline
  path = str(tmp_path / "d.tfrecord")
  with nl.TFRecordWriter(path) as w:
    for i in range(7):
      w.write(nl.build_example({
          "image/encoded": [nl.jpeg_encode_rgb(_smooth_rgb(60 + i, 80, i))],
          "image/source_id": [str(i)],
          "image/object/bbox/ymin": [0.1], "image/object/bbox/xmin": [0.2],
          "image/object/bbox/ymax": [0.5], "image/object/bbox/xmax": [0.9],
          "image/object/class/label": [i + 1],
          "image/object/is_crowd": [0]}))
  got = list(nl.NativeParallelDetectionLoader([path], 3, 64, max_instances=2,
                                              num_workers=3, repeat=False))
  assert [b["image"].shape[0] for b in got] == [3, 3, 1]
  ids = sorted(float(v) for b in got for v in b["source_id"])
  assert ids == list(range(7))
  evals = list(pipeline.DetectionTFRecordLoader(path, False, 4, 64,
                                                max_instances=2))
  assert [b["image"].shape for b in evals] == [(4, 64, 64, 3), (3, 64, 64, 3)]
  b = evals[0]
  h = np.float32(60.0)
  scale = np.float32(64) / np.float32(80.0)
  np.testing.assert_array_equal(
      b["gt_boxes"][0, 0], np.stack([np.float32(0.1) * h,
                                     np.float32(0.2) * np.float32(80.0),
                                     np.float32(0.5) * h,
                                     np.float32(0.9) * np.float32(80.0)])
      * scale)


@pytest.mark.cuda
def test_device_prefetcher_stages_to_the_card(dev):
  import numpy as np
  from automl_tpu_torch.data import pipeline
  rng = np.random.RandomState(0)
  batches = [{"image": rng.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
              "gt_boxes": rng.rand(4, 5, 4).astype(np.float32)}
             for _ in range(5)]
  pf = pipeline.DevicePrefetcher(iter(batches), dev, buffer_size=2)
  got = []
  for b in pf:
    assert all(v.device.type == "cuda" for v in b.values())
    got.append({k: (v * 1).cpu() for k, v in b.items()})  # use on the card
  pf.close()
  assert not pf._thread.is_alive() and len(got) == 5
  for g, w in zip(got, batches):
    for k in w:
      np.testing.assert_array_equal(g[k].numpy(), w[k])


def _serving_driver(device, post_mode="per_class", batch_size=2,
                    mixed_precision=False):
  """efficientdet-test's ServingDriver with seeded weights whose
  class-predict bias is 0 (scores spread around 0.5)."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.inference.driver import ServingDriver
  d = ServingDriver("efficientdet-test", batch_size=batch_size,
                    mixed_precision=mixed_precision, post_mode=post_mode,
                    device=device)
  tree = convert.det_numpy_init(d.model, 0)
  tree["class_net"]["class-predict"]["pointwise"]["bias"][:] = 0.0
  convert.load_det_params(d.model, tree)
  return d._loaded()


@pytest.fixture
def f32_card():
  """True float32 convs and matmuls (no TF32) on the card; the policy
  ServingDriver sets is restored."""
  from automl_tpu_torch.nn import precision
  flags = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        flags)
    precision.set_policy("mixed_bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("post_mode", ["per_class", "global", "combined"])
def test_serving_driver_on_card_matches_cpu(dev, f32_card, post_mode):
  """ServingDriver.serve (float32) of 2 random 75 x 100 uint8 images on the
  card against the same driver on the CPU: valid_len equal, and every
  confident detection (score > 0.5) on either side has a partner on the
  other with the same class, its score within 1e-5 and its box within
  1e-4 px (the card's and the CPU's f32 convs sum in other orders)."""
  import numpy as np
  x = np.random.default_rng(0).integers(0, 256, (2, 75, 100, 3)).astype(
      np.uint8)
  got = _serving_driver(dev, post_mode).serve(x)
  want = _serving_driver("cpu", post_mode).serve(x)
  np.testing.assert_array_equal(got["valid_len"], want["valid_len"])
  n = 0
  for src, dst in ((want, got), (got, want)):
    for b in range(2):
      k = int(dst["valid_len"][b])
      for i in range(int(src["valid_len"][b])):
        if src["scores"][b, i] <= 0.5:
          continue
        n += 1
        ok = ((dst["classes"][b, :k] == src["classes"][b, i])
              & (np.abs(dst["scores"][b, :k] - src["scores"][b, i]) <= 1e-5)
              & (np.abs(dst["boxes"][b, :k] - src["boxes"][b, i]).max(-1)
                 <= 1e-4))
        assert ok.any(), (b, i, float(src["scores"][b, i]))
  assert n >= 4


@pytest.mark.cuda
def test_serving_export_round_trip_on_card(dev, tmp_path):
  """ServingDriver.export on the card (mixed_bfloat16, b2): serving.pt2
  loaded back gives the eager serve's detections bit for bit, on the
  card."""
  from automl_tpu_torch.inference import driver
  from automl_tpu_torch.nn import precision
  try:
    d = _serving_driver(dev, mixed_precision=True)
    d.export(str(tmp_path))
    program = driver.load_exported(str(tmp_path))
    x = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
      got, want = program(x), d.program(x)
    assert got[0].device.type == "cuda"
    for g, w in zip(got, want):
      assert torch.equal(g, w)
  finally:
    precision.set_policy("mixed_bfloat16")


# ---------------------------------------------------------------------------
# Segmentation and QAT (M3 / M11): step 1 at f32, card against CPU.
# ---------------------------------------------------------------------------


def _seg_batch(device, b, size, classes=3, seed=3):
  """Drawn on the host, the same on every device: a stride-4 mask of
  4 x 4-pixel class blocks, two void rows and 5% void pixels; the image
  the block's class as a brightness offset plus unit noise."""
  g = torch.Generator().manual_seed(seed)
  h = size // 4
  mask = torch.randint(0, classes, (b, h // 4, h // 4), generator=g)
  mask = mask.repeat_interleave(4, 1).repeat_interleave(4, 2)
  level = (mask.float() - (classes - 1) / 2).repeat_interleave(
      4, 1).repeat_interleave(4, 2)
  image = level[:, None] + torch.randn(b, 3, size, size, generator=g)
  mask = torch.where(torch.rand(b, h, h, generator=g) < 0.05, -1, mask)
  mask[:, :2] = -1
  return {"image": image.to(device).contiguous(
      memory_format=torch.channels_last), "mask": mask.to(device)}


def _small_det(heads):
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  cfg = get_efficientdet_config("efficientdet-test")
  cfg.override(dict(image_size=128, heads=list(heads)))
  return cfg


def _max_diff_share(card, cpu, old):
  """The largest max|card - CPU| over the leaves, over the largest change
  the step made to them on the CPU."""
  diff = max(float((card[k].cpu().double() - cpu[k].double()).abs().max())
             for k in cpu)
  step = max(float((cpu[k].double() - old[k].double()).abs().max())
             for k in cpu)
  return diff / step


@pytest.mark.cuda
def test_seg_step1_on_card_matches_cpu(dev, f32_card):
  """One f32 make_seg_train_step step of efficientdet-test with both heads
  at 128 x 128, b4 (momentum SGD, EMA), on the card and on the CPU from
  one seeded tree, batch and set of drop_connect masks: the loss within
  1e-4 relative, pixel_acc within 1%, the params within 1e-3 of the
  step's largest change."""
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, train_lib
  cfg = _small_det(("object_detection", "segmentation"))
  precision.set_policy("float32")
  res = {}
  for where in (dev, "cpu"):
    m = runners.seeded_detection_model(cfg, 0, where)
    tx = optimizers.masked_for_params(optimizers.build_optimizer(
        "momentum", 0.08, momentum=0.9))
    state = train_lib.create_train_state(m, tx)
    old = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    state, metrics = train_lib.make_seg_train_step(m, tx, cfg)(
        state, _seg_batch(where, 4, 128), torch.Generator().manual_seed(9))
    res[str(where)] = ({k: float(v) for k, v in metrics.items()},
                       {k: v.detach().cpu() for k, v in state.params.items()},
                       old)
  (card, p_card, _), (cpu, p_cpu, old) = res[str(dev)], res["cpu"]
  assert abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"])
  assert abs(card["pixel_acc"] - cpu["pixel_acc"]) <= 1e-2
  assert _max_diff_share(p_card, p_cpu, old) <= 1e-3


@pytest.mark.cuda
def test_qat_step1_on_card_matches_cpu(dev, f32_card):
  """One f32 make_det_train_step step of efficientdet-test (128 x 128, b4)
  under QAT on the card and on the CPU, one seeded tree, one batch
  preprocessed on the host, one set of drop_connect masks: the loss terms
  within 1e-3 relative (fake-quant rounds activations to their int8 grid,
  so a last-bit difference of a conv can move an element a whole
  quantization step; measured by chip_smoke.py on the H100: equal)."""
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision, quant
  from automl_tpu_torch.train import optimizers, runners, train_lib
  cfg = _small_det(("object_detection",))
  raw = pipeline.SyntheticDetection(4, 128, cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  batch = runners.make_preprocess(cfg)(
      {k: torch.from_numpy(v) for k, v in raw.items()},
      torch.Generator().manual_seed(7))
  precision.set_policy("float32")
  res = {}
  with quant.qat_scope():
    for where in (dev, "cpu"):
      m = runners.seeded_detection_model(cfg, 0, where)
      tx = optimizers.masked_for_params(optimizers.build_optimizer(
          "momentum", 0.08, momentum=0.9))
      state = train_lib.create_train_state(m, tx)
      _, metrics = train_lib.make_det_train_step(m, tx, cfg)(
          state, {k: v.to(where) for k, v in batch.items()},
          torch.Generator().manual_seed(9))
      res[str(where)] = {k: float(v) for k, v in metrics.items()}
  assert not quant.qat_enabled()
  for k in ("loss", "det_loss", "cls_loss", "box_loss"):
    assert abs(res[str(dev)][k] - res["cpu"][k]) <= 1e-3 * abs(
        res["cpu"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((64, 32, 3, 3), 0), ((96, 1, 5, 5), 0),
                                        ((10, 1280), 0), ((8, 64, 17, 23), None)],
                         ids=["conv", "depthwise", "dense", "activation"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fake_quant_on_card_matches_cpu(dev, shape, axis, dtype):
  """quant.fake_quant (8 and 4 bits; per output channel for kernels, per
  tensor for activations; one all-zero slice) on the card equals the
  CPU's bit for bit: elementwise after one max."""
  from automl_tpu_torch.nn import quant
  x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 3
  x[0] = 0.0
  x = x.to(dtype)
  for bits in (8, 4):
    want = quant.fake_quant(x, bits, axis)
    got = quant.fake_quant(x.to(dev), bits, axis)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), want)


# --- the parallel layer's second half (M10) at a world of one ---------------


@pytest.fixture
def mesh1(dev):
  """The mesh (1, 1, 1) on the card (NCCL at a world of one), torn down
  after the test."""
  import torch.distributed as dist
  from automl_tpu_torch.parallel import create_mesh
  torch.cuda.set_device(dev)
  fresh = not dist.is_initialized()
  yield create_mesh((1, 1, 1), device="cuda")
  if fresh and dist.is_initialized():
    dist.destroy_process_group()


def _small_lm(dev, seed, **kw):
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  cfg = lm_lib.lm_defaults()
  cfg.update(dict(dict(vocab_size=256, model_dim=128, n_layers=2, n_heads=2,
                       n_kv_heads=2, head_dim=64, expand_factor=2,
                       seq_len=128, use_flash_attention=True), **kw))
  return cfg, convert.numpy_init(cfg, seed)


def _flash_counts():
  f = fa.flash_attention
  return (f.launches_fwd, f.launches_fwd_sm90, f.launches_bwd,
          f.launches_bwd_sm90)


@pytest.mark.cuda
def test_gpipe_on_card_matches_plain_stack(dev, mesh1):
  """parallel/pipeline.py::pipeline_blocks over a small bf16 LM's blocks
  at one stage in 4 microbatches (b2 each) against the plain stack: the
  final-normed outputs within BF16_TOL; K1 / K2 1 / 1 a layer and
  microbatch, all Hopper's."""
  import torch.nn.functional as F
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.parallel.pipeline import pipeline_blocks
  cfg, tree = _small_lm(dev, 0)
  model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev), tree)
  gen = torch.Generator(device=dev).manual_seed(1)
  tokens = torch.randint(0, 256, (8, 128), generator=gen, device=dev)
  want = model(tokens, return_hidden=True)[0]
  x = F.embedding(tokens, model.embed).to(torch.bfloat16) * 128 ** 0.5
  pos = torch.arange(128, device=dev).expand(8, 128)
  before = _flash_counts()
  got, aux = pipeline_blocks(
      x, list(model.blocks), (pos,),
      lambda blk, h, e: (blk(h, e[0], None)[0],
                         h.new_zeros((), dtype=torch.float32)),
      mesh1, "model", 4)
  got = model.final_norm(got)
  (got.float().square().mean()).backward()
  after = _flash_counts()
  # 2 layers x 4 microbatches: K1 in the forward, K2 in the backward (no
  # remat around the blocks here), all Hopper's.
  assert [a - b for a, b in zip(after, before)] == [8, 8, 8, 8]
  _close(got.detach(), want.detach(), torch.bfloat16)
  assert float(aux) == 0.0


@pytest.mark.cuda
def test_moe_expert_parallel_on_card_bit_equal(dev, mesh1, monkeypatch):
  """A small bf16 MoE LM (4 experts, top-2) with its experts over 'model'
  on the mesh (1, 1, 1) against no mesh: the loss and every gradient leaf
  bit-equal (one rank: the same kernels on the same rows), the mesh run
  through the EP dispatch (its sum over 'model' once a layer); then the
  blocks in 4 microbatches through pipeline_blocks (dp x PP x EP at one
  rank), the final-normed outputs and the input's gradient bit-equal."""
  import torch.nn.functional as F
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.parallel.pipeline import pipeline_blocks
  from automl_tpu_torch.train import lm_trainer
  cfg, tree = _small_lm(dev, 2, moe_num_experts=4, moe_top_k=2,
                        moe_aux_loss_weight=0.01)
  plain = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev), tree)
  meshed = convert.load_jax_params(
      lm_lib.TransformerLM(cfg, device=dev, mesh=mesh1), tree)
  gen = torch.Generator(device=dev).manual_seed(3)
  batch = {"tokens": torch.randint(0, 256, (4, 129), generator=gen,
                                   device=dev)}
  calls, orig = [], lm_lib.comm.reduce_from_axis
  monkeypatch.setattr(lm_lib.comm, "reduce_from_axis",
                      lambda *a: calls.append(1) or orig(*a))
  lp, gp = lm_trainer.lm_loss_and_grads(plain, batch)
  assert not calls
  lm_, gm = lm_trainer.lm_loss_and_grads(meshed, batch)
  assert len(calls) >= cfg.n_layers
  assert float(lp) == float(lm_)
  for k in gp:
    assert torch.equal(gm[k].to_local(), gp[k]), k
  tokens = batch["tokens"][:, :-1]
  pos = torch.arange(128, device=dev).expand(4, 128)
  outs = []
  for model in (plain, meshed):
    x = (F.embedding(tokens, lm_lib._w(model.embed, model.par))
         .to(torch.bfloat16) * 128 ** 0.5).detach().requires_grad_()
    y, aux = pipeline_blocks(
        x, list(model.blocks), (pos,),
        lambda blk, h, e: tuple(blk(h, e[0], None)[::2]), mesh1, "model", 4)
    y = model.final_norm(y)
    (y.float().square().mean() + aux).backward()
    outs.append((y.detach(), aux.detach(), x.grad))
  for got, want in zip(outs[1], outs[0]):
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,k", [(32, 64, 64, 3), (240, 32, 32, 5),
                                     (64, 8, 8, 3)])
@pytest.mark.parametrize("m", [2, 4])
def test_depthwise_sm90_on_bands_sums_to_whole(dev, c, h, w, k, m):
  """K6 on m H-bands of a map, each the band's rows with k // 2 halo rows
  (zeros past the image) and dy padded by k // 2 zero rows, summed:
  the whole map's K6 within K6's f32-sum tolerance; every call the Hopper
  kernel's."""
  import torch.nn.functional as F
  gen = torch.Generator(device=dev).manual_seed(7)
  cl = torch.channels_last
  x, dy = (torch.randn((4, c, h, w), generator=gen, device=dev).to(
      torch.bfloat16).contiguous(memory_format=cl) for _ in range(2))
  whole = dwise.depthwise_filter_grad(x, dy, k)
  r, hb = k // 2, h // m
  xp = F.pad(x, (0, 0, r, r))
  f = dwise.depthwise_filter_grad
  before = f.launches_sm90
  total = sum(dwise.depthwise_filter_grad(
      xp[:, :, i * hb:i * hb + hb + 2 * r].contiguous(memory_format=cl),
      F.pad(dy[:, :, i * hb:(i + 1) * hb], (0, 0, r, r)).contiguous(
          memory_format=cl), k) for i in range(m))
  assert f.launches_sm90 - before == m
  scale = float(whole.abs().max())
  torch.testing.assert_close(total, whole, atol=1e-5 * scale, rtol=1e-5)
