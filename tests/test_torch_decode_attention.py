"""automl_tpu_torch decode attention (plain version, CPU) vs the JAX kernel.

The JAX side is automl_tpu's Pallas decode-attention kernel in interpret
mode, as tests/test_decode_attention.py runs it; the torch side is
automl_tpu_torch.ops.decode_attention on CPU tensors, which is its plain
PyTorch version. Inputs come from numpy with a seed and go to both.
Tolerance: f32 atol = rtol = 2e-5 (tests/test_decode_attention.py), for the
summation order: one pass over S here, online over S blocks there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.ops import decode_attention as jax_da
from automl_tpu_torch.ops import decode_attention as torch_da

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, t, n, n_kv, h, s, seed, p_live=0.6):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, t, n, h), dtype=np.float32)
  kc = rng.standard_normal((b * n_kv, h, s), dtype=np.float32)
  vc = rng.standard_normal((b * n_kv, s, h), dtype=np.float32)
  mask = rng.random((b, t, s)) < p_live
  mask[:, :, 0] = True   # at least one live key per query row
  return q, kc, vc, mask


def _both(q, kc, vc, mask, **kw):
  want = jax_da.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(mask), **kw)
  got = torch_da.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.from_numpy(mask),
                                  **{k: v for k, v in kw.items()
                                     if k != "block_s"})
  return got, want


def _assert_close(got, want):
  if isinstance(want, tuple):
    for g, w in zip(got, want):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
  else:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", [
    # mirrors tests/test_decode_attention.py:50-71
    dict(b=2, t=1, n=4, n_kv=4, h=16, s=64, seed=0),                 # T=1
    dict(b=2, t=1, n=8, n_kv=2, h=16, s=48, cap=50.0, seed=1),       # GQA+cap
    dict(b=2, t=5, n=4, n_kv=4, h=16, s=80, block_s=32, seed=3),     # ragged S
    dict(b=1, t=37, n=2, n_kv=2, h=16, s=96, block_s=32, seed=7),    # T tiles
    dict(b=2, t=130, n=2, n_kv=1, h=16, s=64, block_s=64, seed=8),
], ids=["t1", "gqa_cap", "t5_ragged_s", "prefill_t37", "prefill_t130"])
def test_decode_attention_matches_jax_kernel(case):
  case = dict(case)
  cap, block_s = case.pop("cap", 0.0), case.pop("block_s", 2048)
  q, kc, vc, mask = _inputs(**case)
  got, want = _both(q, kc, vc, mask, n_kv_heads=case["n_kv"], logit_cap=cap,
                    block_s=block_s)
  _assert_close(got, want)


def test_fully_masked_row_is_finite_zero():
  q, kc, vc, mask = _inputs(b=2, t=3, n=4, n_kv=2, h=16, s=40, seed=5)
  mask[1, 2] = False
  got, want = _both(q, kc, vc, mask, n_kv_heads=2)
  assert torch.isfinite(got).all()
  assert (got[1, 2] == 0).all()
  _assert_close(got, want)


def test_head_major_matches_jax_and_batch_major():
  b, t, n, n_kv, h, s = 2, 3, 8, 4, 16, 48
  q, kc, vc, mask = _inputs(b, t, n, n_kv, h, s, seed=7, p_live=0.7)
  kh = kc.reshape(b, n_kv, h, s).transpose(1, 0, 2, 3).reshape(n_kv * b, h, s)
  vh = vc.reshape(b, n_kv, s, h).transpose(1, 0, 2, 3).reshape(n_kv * b, s, h)
  got, want = _both(q, np.ascontiguousarray(kh), np.ascontiguousarray(vh),
                    mask, n_kv_heads=n_kv, layout="head_major")
  _assert_close(got, want)
  batch_major, _ = _both(q, kc, vc, mask, n_kv_heads=n_kv)
  np.testing.assert_allclose(got.numpy(), batch_major.numpy(), atol=1e-6,
                             rtol=1e-6)


@pytest.mark.parametrize("layout", ["batch_major", "head_major"])
def test_return_stats_match_jax(layout):
  q, kc, vc, mask = _inputs(b=2, t=4, n=4, n_kv=2, h=16, s=72, seed=11)
  mask[0, 1] = False   # a fully-masked row reports raw l == 0
  got, want = _both(q, kc, vc, mask, n_kv_heads=2, logit_cap=50.0,
                    layout=layout, return_stats=True, block_s=32)
  _assert_close(got, want)
  assert float(got[2][0, 1].abs().max()) == 0.0


def test_cpu_tensors_never_count_as_kernel_launches():
  before = torch_da.decode_attention.launches
  q, kc, vc, mask = _inputs(b=1, t=1, n=2, n_kv=2, h=8, s=16, seed=2)
  torch_da.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc), torch.from_numpy(mask),
                            n_kv_heads=2)
  assert torch_da.decode_attention.launches == before


def test_bad_shapes_raise():
  q, kc, vc, mask = (torch.from_numpy(a) for a in
                     _inputs(b=2, t=1, n=4, n_kv=2, h=8, s=16, seed=0))
  with pytest.raises(ValueError, match="rows"):
    torch_da.decode_attention(q, kc, vc, mask, n_kv_heads=4)
  with pytest.raises(ValueError, match="divisible"):
    torch_da.decode_attention(q[:, :, :3], kc, vc, mask, n_kv_heads=2)
  with pytest.raises(ValueError, match="mask"):
    torch_da.decode_attention(q, kc, vc, mask[:, :, :8], n_kv_heads=2)


# The split-S decode kernel's arithmetic (decode_attention_split_reference:
# the plain version on 64-key slices, merged in the kernel's fixed order)
# against the JAX kernel, with the file's TOL.
@pytest.mark.parametrize("case", [
    dict(b=2, t=1, n=4, n_kv=4, h=16, s=200, seed=21),               # T=1
    dict(b=2, t=3, n=8, n_kv=2, h=16, s=160, cap=50.0, seed=22),     # GQA 8/2
    dict(b=2, t=2, n=4, n_kv=2, h=16, s=256, dead_keys=(64, 128), seed=23),
    dict(b=2, t=3, n=4, n_kv=2, h=16, s=192, dead_row=(1, 1), seed=24),
    dict(b=2, t=2, n=8, n_kv=4, h=16, s=136, layout="head_major", seed=25),
    dict(b=2, t=4, n=4, n_kv=2, h=16, s=320, cap=50.0, dead_row=(0, 3),
         stats=True, seed=26),
], ids=["t1", "gqa_8_2", "dead_split", "dead_row", "head_major", "stats"])
def test_split_reference_matches_jax_kernel(case):
  case = dict(case)
  cap, layout = case.pop("cap", 0.0), case.pop("layout", "batch_major")
  dead_keys, dead_row = case.pop("dead_keys", None), case.pop("dead_row", None)
  stats = case.pop("stats", False)
  q, kc, vc, mask = _inputs(**case)
  if dead_keys:
    mask[:, :, dead_keys[0]:dead_keys[1]] = False   # one split wholly masked
  if dead_row:
    mask[dead_row] = False
  b, n_kv, h, s = case["b"], case["n_kv"], case["h"], case["s"]
  if layout == "head_major":
    kc = np.ascontiguousarray(
        kc.reshape(b, n_kv, h, s).transpose(1, 0, 2, 3).reshape(-1, h, s))
    vc = np.ascontiguousarray(
        vc.reshape(b, n_kv, s, h).transpose(1, 0, 2, 3).reshape(-1, s, h))
  kw = dict(n_kv_heads=n_kv, logit_cap=cap, layout=layout,
            return_stats=stats or dead_row is not None)
  want = jax_da.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(mask), **kw)
  got = torch_da.decode_attention_split_reference(
      torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
      torch.from_numpy(mask), split_keys=64, **kw)
  _assert_close(got, want)
  if dead_row:
    out, _, l = got
    assert float(out[dead_row].abs().max()) == 0.0
    assert float(l[dead_row].abs().max()) == 0.0


def _direct_classes(mask, tile=64):
  """Tile classes by a loop over the tiles of a numpy mask."""
  b, t, s = mask.shape
  qt, nk = -(-t // tile), -(-s // tile)
  out = np.zeros((b, qt, nk), np.uint8)
  for i in range(b):
    for a in range(qt):
      for k in range(nk):
        block = mask[i, a * tile:(a + 1) * tile, k * tile:(k + 1) * tile]
        if not block.any():
          out[i, a, k] = torch_da.DEAD
        elif block.all() and (k + 1) * tile <= s:
          out[i, a, k] = torch_da.LIVE
        else:
          out[i, a, k] = torch_da.MIXED
  return out


@pytest.mark.parametrize("kind", ["causal_cache", "prefix_lm", "window",
                                  "random_ragged"])
def test_mask_tile_classes_match_direct_reduction(kind):
  """The plain version of the prefill pre-pass (dead / mixed / all live per
  64 x 64 tile) against a loop over the mask's tiles."""
  t, s = (300, 512) if kind != "random_ragged" else (77, 200)
  qi, ki = np.arange(t)[:, None], np.arange(s)[None, :]
  mask = {"causal_cache": ki <= qi,
          "prefix_lm": (ki < 100) | (ki <= qi),
          "window": (ki <= qi) & (qi - ki < 200),
          "random_ragged": np.random.default_rng(3).random((t, s)) < 0.999,
          }[kind]
  mask = np.stack([mask, np.roll(mask, 64, axis=1)])   # two batch rows
  got = torch_da.mask_tile_classes_reference(torch.from_numpy(mask)).numpy()
  np.testing.assert_array_equal(got, _direct_classes(mask))
  if kind in ("prefix_lm", "window"):
    assert {torch_da.DEAD, torch_da.MIXED, torch_da.LIVE} <= set(got.ravel())


def test_kernel_routing_by_dtype_and_shape():
  bf16, f32 = torch.bfloat16, torch.float32
  takes = torch_da.takes_sm90
  assert takes(bf16, bf16, 128, 1024) and takes(bf16, bf16, 72, 200)
  assert takes(bf16, bf16, 8, 8)
  assert not takes(f32, f32, 128, 1024)          # f32: the SIMT kernel
  assert not takes(f32, bf16, 128, 1024) and not takes(bf16, f32, 128, 1024)
  assert not takes(bf16, bf16, 256, 1024)        # H > 128
  assert not takes(bf16, bf16, 36, 1024)         # H not a multiple of 8
  assert not takes(bf16, bf16, 128, 77)          # S not a multiple of 8


@pytest.mark.parametrize("rows_kv,s_len", [(64, 1024), (2, 200), (8, 65536),
                                           (512, 4096), (1, 8)])
def test_decode_splits_fill_the_card(rows_kv, s_len):
  sms = 132
  tiles = torch_da.decode_split_tiles(rows_kv, s_len, sms)
  n_tiles = -(-s_len // 64)
  splits = -(-n_tiles // tiles)
  assert 1 <= tiles <= 32 and (splits - 1) * tiles < n_tiles
  # at least four blocks an SM where S has enough tiles for them
  assert rows_kv * splits >= min(4 * sms, rows_kv * n_tiles)
  if (rows_kv, s_len) == (64, 1024):   # the serving slice
    assert (tiles, splits) == (1, 16)
