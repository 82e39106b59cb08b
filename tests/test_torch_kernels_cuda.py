"""automl_tpu_torch's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips without them. Imports no jax,
so it runs where jax is not installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(--noconftest: tests/conftest.py sets up jax for the JAX package's tests.)
Tolerances: f32 atol = rtol = 1e-4 (another summation order, the card's
expf/tanhf); bf16 outputs atol 1.6e-2, rtol 8e-3 (one bf16 rounding
step).
"""

import pytest
import torch

from automl_tpu_torch.ops import attention as fa
from automl_tpu_torch.ops import decode_attention as da

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
  before = da.decode_attention.launches
  got = da.decode_attention(q, kc, vc, mask, n_kv_heads=case["n_kv"],
                            logit_cap=cap)
  torch.cuda.synchronize()
  assert da.decode_attention.launches == before + 1
  want = da.decode_attention_reference(q, kc, vc, mask,
                                       n_kv_heads=case["n_kv"], logit_cap=cap)
  _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch_major", "head_major"])
def test_decode_attention_kernel_stats_and_masked_row(dev, layout):
  q, kc, vc, mask = _inputs(dev, 2, 4, 4, 2, 128, 300, torch.bfloat16, seed=1)
  mask[1, 2] = False
  kw = dict(n_kv_heads=2, logit_cap=50.0, layout=layout, return_stats=True)
  out, m, l = da.decode_attention(q, kc, vc, mask, **kw)
  out_r, m_r, l_r = da.decode_attention_reference(q, kc, vc, mask, **kw)
  _close(out, out_r, torch.bfloat16)
  torch.testing.assert_close(m, m_r, **F32_TOL)
  torch.testing.assert_close(l, l_r, **F32_TOL)
  assert float(out[1, 2].abs().max()) == 0.0 and float(l[1, 2].max()) == 0.0


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


def _flash_inputs(dev, b, t, n, h, dtype, seed, segments=False):
  gen = torch.Generator(device=dev).manual_seed(seed)
  q, k, v, g = (torch.randn((b, t, n, h), generator=gen, device=dev).to(dtype)
                for _ in range(4))
  segs = None
  if segments:
    segs = torch.cumsum((torch.rand((b, t), generator=gen, device=dev) < 0.05)
                        .int(), dim=1).int().contiguous()
  return q, k, v, g, segs


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
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
def test_flash_attention_autograd_gqa_on_card_matches_cpu(dev):
  """flash_attention with GQA 4/2, window, cap, segments and T = 90 through
  autograd on the card (K1, K2) and on the CPU (plain versions)."""
  q, _, _, g, segs = _flash_inputs(dev, 2, 90, 4, 32, torch.float32, seed=1,
                                   segments=True)
  _, k, v, _, _ = _flash_inputs(dev, 2, 90, 2, 32, torch.float32, seed=2)
  kw = dict(window=24, logit_cap=50.0)
  results = []
  for device in (dev, torch.device("cpu")):
    xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, segment_ids=segs.to(device), **kw)
    out.backward(g.to(device))
    results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
  for got, want in zip(*results):
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(dev):
  q, k, v, g, _ = _flash_inputs(dev, 1, 16, 2, 16, torch.float32, seed=3)
  before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
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
  with pytest.raises(ValueError, match="lse"):
    fa.flash_bwd(q, k, v, g, out, lse[:, :8])
  assert (fa.flash_attention.launches_fwd,
          fa.flash_attention.launches_bwd) == before
