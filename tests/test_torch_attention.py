"""automl_tpu_torch flash attention vs automl_tpu's Pallas kernels on the CPU.

The JAX side runs its Pallas kernels in interpret mode (the forward K1, the
fused backward K2, bwd_fused=True, and the split backward K5a/K5b,
bwd_fused=False); the port's CPU path is the plain versions of its CUDA
kernels. Inputs are made with numpy from a seed, in
f32; JAX matmuls run at "highest" precision (tests/conftest.py).
Tolerances are those of tests/test_attention.py: forward atol 2e-5,
gradients atol 3e-4 / rtol 1e-3 (another summation order over T and H).
"""

import contextlib
import functools
import types

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
# bf16 outputs: both packages multiply the bf16 operands exactly, sum in f32
# (in other orders) and round once to bf16; a value near a rounding step
# lands a step apart: 2^-8 relative, <= 2^-6 absolute at |x| < 4.
BF16_TOL = dict(atol=1.6e-2, rtol=8e-3)


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


def _launches():
  f = ta.flash_attention
  return (f.launches_fwd, f.launches_bwd, f.launches_dq, f.launches_dkv)


@pytest.mark.parametrize("bwd_fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_forward_and_grads_match_jax(name, bwd_fused):
  """flash_attention with the fused (K2) or the split (K5a/K5b) backward,
  the same in both packages."""
  case = dict(dict(b=2, t=64, n=2, nkv=None, h=16, block=16), **CASES[name])
  b, t, n, h, block = (case.pop(k) for k in ("b", "t", "n", "h", "block"))
  nkv = case.pop("nkv") or n
  q, k, v, g, seg = _arrays(b, t, n, nkv, h, seed=len(name),
                            segments=case.pop("segments", False))
  kw = dict(case)

  def jfn(q, k, v):
    return ja.flash_attention(
        q, k, v, block_q=block, block_k=block, bwd_fused=bwd_fused,
        interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg), **kw)

  want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  want_grads = vjp(jnp.asarray(g))

  tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  before = _launches()
  got = ta.flash_attention(
      tq, tk, tv, block_q=block, block_k=block, bwd_fused=bwd_fused,
      segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
  got.backward(torch.from_numpy(g))
  np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)
  for x, w in zip((tq, tk, tv), want_grads):
    np.testing.assert_allclose(_np(x.grad), _np(w), **GRAD_TOL)
  # CPU tensors take the plain versions: no kernel was launched.
  assert _launches() == before


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


@pytest.mark.parametrize("kw", [
    dict(t=40),
    dict(window=8, logit_cap=50.0),
    dict(segments=True, logit_cap=5.0),
    dict(t=20, length_one_docs=True, logit_cap=50.0),
    dict(t=48, bwd_blocks=(32, 8), window=16),
    dict(causal=False, window=12, logit_cap=5.0),
], ids=["ragged", "window_cap", "segments_cap", "length_one_docs",
        "bwd_blocks_differ", "non_causal_window"])
def test_plain_split_backward_matches_pallas_kernels(kw):
  """flash_bwd_dq_reference (K5a) and flash_bwd_dkv_reference (K5b) vs
  _flash_bwd_pallas in interpret mode, at the kernels' own interfaces, on
  the forward's (out, lse) from _flash_fwd_pallas with 16 x 16 blocks; the
  backward's blocks 16 x 16 or as given (the TPU tiling only: the results
  must not depend on it). Gradients atol 3e-4 / rtol 1e-3 (K2's
  tolerance). The plain K2 is the two halves: bit-equal to them."""
  kw = dict(kw)
  t = kw.pop("t", 32)
  bq, bk = kw.pop("bwd_blocks", (16, 16))
  b, n, h = 2, 2, 8
  q, k, v, g, seg = _arrays(b, t, n, n, h, seed=t + 1,
                            segments=kw.pop("segments", False))
  if kw.pop("length_one_docs", False):
    seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
  kw = dict(dict(causal=True, window=None, logit_cap=0.0, sm_scale=0.3), **kw)
  jsegs = None if seg is None else ja._seg_operands(jnp.asarray(seg), n)
  tsegs = None if seg is None else torch.from_numpy(seg)
  jout, jlse = ja._flash_fwd_pallas(
      _bnth(q), _bnth(k), _bnth(v), jsegs, n_heads=n, block_q=16,
      block_k=16, interpret=True, **kw)
  jlse = jlse[:, 0, :]
  delta = jnp.sum(_bnth(g) * jout, axis=-1)
  want = ja._flash_bwd_pallas(
      _bnth(q), _bnth(k), _bnth(v), _bnth(g), jlse, delta, jsegs,
      n_heads=n, block_q=bq, block_k=bk, interpret=True, **kw)
  tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
  out = torch.from_numpy(np.array(jout)).reshape(b, n, t, h).transpose(1, 2)
  lse = torch.from_numpy(np.array(jlse))
  args = (tq, tk, tv, tg, out, lse, tsegs)
  dq = ta.flash_bwd_dq_reference(*args, **kw)
  dk, dv = ta.flash_bwd_dkv_reference(*args, **kw)
  for got, w in zip((dq, dk, dv), want):
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_bnth(_np(got)), w, **GRAD_TOL)
  for x, y in zip(ta.flash_bwd_reference(*args, **kw), (dq, dk, dv)):
    assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(logit_cap=50.0),
    dict(window=16, logit_cap=5.0, segments=True),
    dict(t=40, n=4, nkv=2, logit_cap=50.0),
], ids=["causal_cap", "window_cap_segments", "gqa_ragged"])
def test_split_backward_bf16_matches_jax(kw):
  """bf16 q, k, v, g (the LM's dtype) through flash_attention with the
  split backward (bwd_fused=False) in both packages: JAX's vjp reaches
  _flash_bwd_pallas (interpret mode, 16 x 16 blocks), the port's CPU path
  the plain K5a and K5b. out, dq, dk and dv keep bf16 and agree within
  BF16_TOL (one bf16 rounding step of f32 sums taken in other orders)."""
  kw = dict(kw)
  b, t, n, nkv, h = 2, kw.pop("t", 64), kw.pop("n", 2), kw.pop("nkv", 2), 16
  q, k, v, g, seg = _arrays(b, t, n, nkv, h, seed=t + n,
                            segments=kw.pop("segments", False))
  jb = [jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v, g)]

  def jfn(q, k, v):
    return ja.flash_attention(
        q, k, v, block_q=16, block_k=16, bwd_fused=False, interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg), **kw)

  want, vjp = jax.vjp(jfn, *jb[:3])
  want_grads = vjp(jb[3])
  tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]
  xs = [x.clone().requires_grad_() for x in tb[:3]]
  before = _launches()
  got = ta.flash_attention(
      *xs, bwd_fused=False,
      segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
  got.backward(tb[3])
  assert _launches() == before
  for name, x, w in zip(("out", "dq", "dk", "dv"),
                        (got, *(x.grad for x in xs)), (want, *want_grads)):
    assert x.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
    np.testing.assert_allclose(x.detach().float().numpy(),
                               np.asarray(w, dtype=np.float32), **BF16_TOL,
                               err_msg=name)


def test_default_backward_is_the_split_backward(monkeypatch):
  """flash_attention's default backward is the split one in both packages
  (JAX: bwd_fused=False): the port's default call runs the plain K5a and
  K5b once each and not the plain K2, as JAX's default grad reaches
  _flash_bwd_pallas (two pallas_calls) and not _flash_bwd_fused_pallas;
  and the two give the same grads (atol 3e-4 / rtol 1e-3)."""
  q, k, v, g, _ = _arrays(1, 32, 2, 2, 8, seed=9)
  calls = []
  for name in ("flash_bwd_reference", "flash_bwd_dq_reference",
               "flash_bwd_dkv_reference"):
    fn = getattr(ta, name)
    monkeypatch.setattr(ta, name, lambda *a, _fn=fn, _n=name, **kw: (
        calls.append(_n), _fn(*a, **kw))[1])
  tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  ta.flash_attention(tq, tk, tv, logit_cap=50.0).backward(torch.from_numpy(g))
  assert sorted(calls) == ["flash_bwd_dkv_reference", "flash_bwd_dq_reference"]

  def jloss(q, k, v, **kw):
    out = ja.flash_attention(q, k, v, logit_cap=50.0, block_q=16,
                             block_k=16, interpret=True, **kw)
    return jnp.sum(out * jnp.asarray(g))

  def pallas_calls(**kw):
    grad = jax.grad(functools.partial(jloss, **kw), argnums=(0, 1, 2))
    return str(jax.make_jaxpr(grad)(*jargs)).count("pallas_call")

  jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  # The forward and two backward kernels; the fused backward is one.
  assert (pallas_calls(), pallas_calls(bwd_fused=True)) == (3, 2)
  want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
  for x, w in zip((tq, tk, tv), want):
    np.testing.assert_allclose(_np(x.grad), _np(w), **GRAD_TOL)


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
  with pytest.raises(ValueError, match="GQA"):
    ta.flash_attention(tq, tk, tv)
  with pytest.raises(ValueError, match="segment_ids"):
    ta.flash_attention(tq, tq, tq, segment_ids=torch.zeros(1, 7))
  with pytest.raises(ValueError, match="no implementation"):
    ta.flash_attention(tq.to("meta"), tq.to("meta"), tq.to("meta"))


@pytest.mark.parametrize("b,t,n,h", [(2, 77, 3, 32), (1, 200, 2, 128),
                                     (1, 64, 4, 8)])
def test_sm90_dq_blocks_reorder_to_btnh(b, t, n, h):
  """The Hopper K2 writes dq as f32 blocks [B*N, ceil(T/64), ceil(H/64), 64,
  64], block (b*N + n, i, c) holding queries 64 i.. and head dims 64 c..;
  _dq_from_blocks gives back [B, T, N, H]. Blocks built element by element
  from a known dq (padding left at zero) come back exact."""
  dq = torch.from_numpy(np.random.default_rng(0).standard_normal(
      (b, t, n, h)).astype(np.float32))
  n_qt, n_ch = -(-t // 64), -(-h // 64)
  blocks = torch.zeros((b * n, n_qt, n_ch, 64, 64))
  for bb in range(b):
    for nn in range(n):
      for i in range(n_qt):
        for c in range(n_ch):
          rows = dq[bb, 64 * i:64 * i + 64, nn, 64 * c:64 * c + 64]
          blocks[bb * n + nn, i, c, :rows.shape[0], :rows.shape[1]] = rows
  got = ta._dq_from_blocks(blocks, b, t, n, h)
  assert got.shape == (b, t, n, h)
  assert torch.equal(got, dq)


def test_sm90_routing_and_tma_checks(monkeypatch):
  """bf16 takes the Hopper kernels unless `_simt` asks for the scalar-FMA
  ones, float32 never does; the TMA checks refuse a head_dim that is not a
  multiple of 8 and strides that are not multiples of 8 elements, and take
  the LM's contiguous [B, T, N, H] (and a head slice of a wider tensor whose
  strides stay multiples of 8). The split wrappers (K5a, K5b) route so too:
  with stand-ins for the two libraries, a bf16 call reaches the Hopper
  entry point with lse and delta padded to 128 queries, and a float32 or
  `_simt` call the scalar-FMA one with them unpadded, each with as many
  arguments as its binding declares; a Hopper call counts in
  launches_dq_sm90 / launches_dkv_sm90, and a Hopper call on strides TMA
  does not take raises before any launch."""
  x = torch.zeros((2, 16, 4, 32), dtype=torch.bfloat16)
  assert ta._takes_sm90(x, simt=False)
  assert not ta._takes_sm90(x, simt=True)
  assert not ta._takes_sm90(x.float(), simt=False)
  ta._check_tma((x, x))
  wide = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
  ta._check_tma((wide[..., :32], x))
  with pytest.raises(ValueError, match="stride"):
    ta._check_tma((x, torch.zeros((2, 16, 4, 36))[..., :32]))
  with pytest.raises(ValueError, match="head_dim"):
    ta._check_tma((x[..., :12],))

  calls, pads = [], []

  def table(impl):
    return ta._KernelFns(*(
        lambda *a, _name=name: calls.append((impl, _name, len(a))) or 0
        for name in ta._KernelFns._fields))

  def n_args(n_ptrs, dtype_arg):
    return len(ta._bind(types.SimpleNamespace(), n_ptrs, 4,
                        dtype_arg=dtype_arg).argtypes)

  bwd_stats = ta._bwd_stats
  monkeypatch.setattr(ta, "_sm90_fns", lambda: table("sm90"))
  monkeypatch.setattr(ta, "_kernel_fns", lambda: table("simt"))
  monkeypatch.setattr(ta, "_bwd_stats", lambda g, out, lse, pad_to=None: (
      pads.append(pad_to), bwd_stats(g, out, lse, pad_to))[1])
  monkeypatch.setattr(torch.cuda, "device",
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, "current_stream",
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  b, t, n, h = 2, 200, 2, 32
  f = ta.flash_attention
  for dtype, simt, impl in ((torch.bfloat16, False, "sm90"),
                            (torch.float32, False, "simt"),
                            (torch.bfloat16, True, "simt")):
    xs = [torch.zeros((b, t, n, h), dtype=dtype) for _ in range(5)]
    lse = torch.zeros((b * n, t))
    calls.clear()
    pads.clear()
    before = (f.launches_dq, f.launches_dkv, f.launches_dq_sm90,
              f.launches_dkv_sm90)
    ta.flash_bwd_dq_kernel(*xs, lse, _simt=simt)
    ta.flash_bwd_dkv_kernel(*xs, lse, _simt=simt)
    sm90 = impl == "sm90"
    assert calls == [(impl, "bwd_dq", n_args(8, not sm90)),
                     (impl, "bwd_dkv", n_args(9, not sm90))]
    assert pads == [128 if sm90 else None] * 2
    assert (f.launches_dq, f.launches_dkv, f.launches_dq_sm90,
            f.launches_dkv_sm90) == (before[0] + 1, before[1] + 1,
                                     before[2] + sm90, before[3] + sm90)
  calls.clear()
  odd = torch.zeros((b, t, n, h + 4), dtype=torch.bfloat16)[..., :h]
  for fn in (ta.flash_bwd_dq_kernel, ta.flash_bwd_dkv_kernel):
    with pytest.raises(ValueError, match="stride"):
      fn(*xs[:3], odd, xs[4], lse)
  assert calls == []
