"""automl_tpu_torch flash attention vs automl_tpu's Pallas kernels on the CPU.

The JAX side runs its Pallas kernels in interpret mode (the forward K1 and
the fused backward K2, bwd_fused=True); the port's CPU path is the plain
versions of its CUDA kernels. Inputs are made with numpy from a seed, in
f32; JAX matmuls run at "highest" precision (tests/conftest.py).
Tolerances are those of tests/test_attention.py: forward atol 2e-5,
gradients atol 3e-4 / rtol 1e-3 (another summation order over T and H).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.ops import attention as ja
from automl_tpu_torch.ops import attention as ta

torch.set_num_threads(1)

FWD_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=3e-4, rtol=1e-3)


def _arrays(b, t, n, nkv, h, seed, segments=False):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((b, t, n, h), dtype=np.float32)
  k = rng.standard_normal((b, t, nkv, h), dtype=np.float32)
  v = rng.standard_normal((b, t, nkv, h), dtype=np.float32)
  g = rng.standard_normal((b, t, n, h), dtype=np.float32)
  seg = None
  if segments:
    seg = np.cumsum(rng.integers(0, 2, (b, t)), axis=1).astype(np.int32)
  return q, k, v, g, seg


def _np(x):
  return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


CASES = {
    "plain": dict(),
    "cap": dict(logit_cap=50.0),
    "window": dict(window=16),
    "window_cap": dict(window=16, logit_cap=50.0),
    "gqa": dict(n=4, nkv=2),
    "t_not_divisible": dict(t=48, block=32),
    "segments": dict(segments=True),
    "segments_window_cap": dict(segments=True, window=16, logit_cap=50.0),
    "segments_gqa_ragged": dict(segments=True, n=4, nkv=2, t=40, block=16,
                                logit_cap=5.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_forward_and_grads_match_jax(name):
  case = dict(dict(b=2, t=64, n=2, nkv=None, h=16, block=16), **CASES[name])
  b, t, n, h, block = (case.pop(k) for k in ("b", "t", "n", "h", "block"))
  nkv = case.pop("nkv") or n
  q, k, v, g, seg = _arrays(b, t, n, nkv, h, seed=len(name),
                            segments=case.pop("segments", False))
  kw = dict(case)

  def jfn(q, k, v):
    return ja.flash_attention(
        q, k, v, block_q=block, block_k=block, bwd_fused=True,
        interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg), **kw)

  want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  want_grads = vjp(jnp.asarray(g))

  tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  before = (ta.flash_attention.launches_fwd, ta.flash_attention.launches_bwd)
  got = ta.flash_attention(
      tq, tk, tv, block_q=block, block_k=block,
      segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
  got.backward(torch.from_numpy(g))
  np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)
  for x, w in zip((tq, tk, tv), want_grads):
    np.testing.assert_allclose(_np(x.grad), _np(w), **GRAD_TOL)
  # CPU tensors take the plain versions: no kernel was launched.
  assert (ta.flash_attention.launches_fwd,
          ta.flash_attention.launches_bwd) == before


def _bnth(x):
  """[B, T, N, H] -> the TPU kernels' [B*N, T, H]."""
  b, t, n, h = x.shape
  return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * n, t, h)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window=8, logit_cap=5.0),
    dict(segments=True, logit_cap=50.0),
    dict(t=40, segments=True, window=16),
    dict(causal=False, logit_cap=5.0),
], ids=["causal", "window_cap", "segments_cap", "ragged_segments_window",
        "non_causal"])
def test_plain_kernels_match_pallas_kernels(kw):
  """flash_fwd_reference vs _flash_fwd_pallas (out, lse[:, 0, :]) and
  flash_bwd_reference vs _flash_bwd_fused_pallas, both interpret mode,
  at the kernels' own interfaces. Forward atol 2e-5 (lse too), backward
  atol 3e-4 / rtol 1e-3."""
  kw = dict(kw)
  t = kw.pop("t", 32)
  b, n, h = 2, 2, 8
  q, k, v, g, seg = _arrays(b, t, n, n, h, seed=t,
                            segments=kw.pop("segments", False))
  kw = dict(dict(causal=True, window=None, logit_cap=0.0, sm_scale=0.3), **kw)
  jsegs = None if seg is None else ja._seg_operands(jnp.asarray(seg), n)
  tsegs = None if seg is None else torch.from_numpy(seg)
  jout, jlse = ja._flash_fwd_pallas(
      _bnth(q), _bnth(k), _bnth(v), jsegs, n_heads=n, block_q=16,
      block_k=16, interpret=True, **kw)
  tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
  out, lse = ta.flash_fwd_reference(tq, tk, tv, tsegs, **kw)
  np.testing.assert_allclose(_bnth(_np(out)), jout, **FWD_TOL)
  np.testing.assert_allclose(_np(lse), jlse[:, 0, :], atol=2e-5, rtol=1e-6)

  delta = jnp.sum(_bnth(g) * jout, axis=-1)
  jdq, jdk, jdv = ja._flash_bwd_fused_pallas(
      _bnth(q), _bnth(k), _bnth(v), _bnth(g), jlse[:, 0, :], delta, jsegs,
      n_heads=n, block_q=16, block_k=16, interpret=True, **kw)
  grads = ta.flash_bwd_reference(tq, tk, tv, tg, out, lse, tsegs, **kw)
  for got, want in zip(grads, (jdq, jdk, jdv)):
    np.testing.assert_allclose(_bnth(_np(got)), want, **GRAD_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(window=8, logit_cap=50.0),
                                dict(segments=True)],
                         ids=["causal", "window_cap", "segments"])
def test_dense_attention_matches_jax(kw):
  kw = dict(kw)
  q, k, v, _, seg = _arrays(2, 24, 4, 2, 8, seed=3,
                            segments=kw.pop("segments", False))
  want = ja.dense_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
      segment_ids=None if seg is None else jnp.asarray(seg), **kw)
  got = ta.dense_attention(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
      segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_length_one_documents_attend_only_themselves():
  """Each token its own segment: out = v (softmax over one key), for the
  plain version as for JAX's kernel; atol 1e-6."""
  q, k, v, g, _ = _arrays(1, 20, 2, 2, 8, seed=4)
  seg = np.arange(20, dtype=np.int32)[None]
  got = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), logit_cap=50.0,
                           segment_ids=torch.from_numpy(seg))
  np.testing.assert_allclose(_np(got), v, atol=1e-6)
  want = ja.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            logit_cap=50.0, segment_ids=jnp.asarray(seg),
                            block_q=16, block_k=16, interpret=True,
                            bwd_fused=True)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


def test_bf16_inputs_keep_dtype_and_f32_math():
  """bf16 q/k/v: products of bf16 operands summed in f32 (the precision
  contract), output rounded once to bf16: within one bf16 step of the f32
  result on the same bf16 values."""
  q, k, v, _, _ = _arrays(1, 32, 2, 2, 16, seed=5)
  tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
  got = ta.flash_attention(*tb, logit_cap=50.0)
  want = ta.flash_attention(*(x.float() for x in tb), logit_cap=50.0)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1.6e-2,
                             rtol=8e-3)


def test_unported_and_wrong_inputs_raise():
  q, k, v, _, _ = _arrays(1, 8, 4, 3, 8, seed=6)
  tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
  with pytest.raises(NotImplementedError, match="K5"):
    ta.flash_attention(tq, tq, tq, bwd_fused=False)
  with pytest.raises(ValueError, match="GQA"):
    ta.flash_attention(tq, tk, tv)
  with pytest.raises(ValueError, match="segment_ids"):
    ta.flash_attention(tq, tq, tq, segment_ids=torch.zeros(1, 7))
  with pytest.raises(ValueError, match="no implementation"):
    ta.flash_attention(tq.to("meta"), tq.to("meta"), tq.to("meta"))
