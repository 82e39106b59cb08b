"""automl_tpu_torch.ops.xent against automl_tpu.ops.xent on the CPU.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
its Pallas K3a-c in interpret mode, the port the plain versions of its CUDA
kernels, at the JAX tests' ragged shapes (M 100 against block_m 64, V 1000
against block_v 256, D 128), so JAX's pad masking is exercised, and at the
default LM's D 2,048 with small M and V. Tolerances are stated per test.
The kernels' D limits, the routing between the two implementations of
K3a, K3b and K3c, the Hopper kernels' split plan and K3a's merge of split
parts are pure Python, checked here with stand-ins for the libraries.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.models import lm as jlm
from automl_tpu.ops import xent as jxent
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.ops import xent as txent

torch.set_num_threads(1)

BLOCKS = dict(block_m=64, block_v=256)
M, D, V = 100, 128, 1000
# Gradients: f32 sums in another order. With bf16 operands both sides also
# round dz to bf16, from logits summed in another order; where that puts a
# value on the other side of a rounding step, one term of a sum of V (or M)
# moves by 2^-8 of itself, ~1e-9 here, far inside atol.
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, m=M, d=D, v=V, tied=True):
  """x [m, d], w [v, d] (tied) or [d, v], targets [m], weights [m] with
  about 20% zeros; f32 numpy."""
  rng = np.random.default_rng(seed)
  x = (0.5 * rng.standard_normal((m, d))).astype(np.float32)
  w = (rng.standard_normal((v, d) if tied else (d, v)) * d ** -0.5).astype(
      np.float32)
  targets = rng.integers(0, v, (m,)).astype(np.int32)
  weights = (rng.random(m) > 0.2).astype(np.float32)
  return x, w, targets, weights


def _both(a, dtype):
  """The same values as a JAX and a torch array at `dtype`."""
  jdt, tdt = DTYPES[dtype]
  return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
  if torch.is_tensor(x):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dims", [dict(m=M, d=D, v=V), dict(m=40, d=2048, v=300)],
                         ids=["d128", "d2048"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_kernels_match_pallas(cap, dtype, dims):
  """Plain K3a / K3b / K3c against _fwd_pallas / _bwd_pallas (interpret
  mode), fed the same lse and coef, at D 128 and at the default LM's D
  2,048 (M 40, V 300). lse and tz: atol 1e-5 (f32 sums in another order).
  dx and dW: atol 1e-6, rtol 1e-4 (GRAD_TOL)."""
  x, w, targets, weights = _case(0, **dims)
  jx, tx = _both(x, dtype)
  jw, tw = _both(w, dtype)
  jt, tt = jnp.asarray(targets), torch.from_numpy(targets)
  lse, tz = jxent._fwd_pallas(jx, jw, jt, logit_cap=cap, interpret=True,
                              **BLOCKS)
  got_lse, got_tz = txent.xent_fwd_reference(tx, tw, tt, logit_cap=cap)
  np.testing.assert_allclose(_np(got_lse), _np(lse), atol=1e-5, rtol=0)
  np.testing.assert_allclose(_np(got_tz), _np(tz), atol=1e-5, rtol=0)

  coef = (weights / max(weights.sum(), 1.0)).astype(np.float32)
  dx, dw = jxent._bwd_pallas(jx, jw, jt, lse, jnp.asarray(coef),
                             logit_cap=cap, interpret=True,
                             x_dtype=jnp.float32, w_dtype=jnp.float32,
                             **BLOCKS)
  kw = dict(logit_cap=cap, out_dtype=torch.float32)
  t_lse, t_coef = torch.tensor(_np(lse)), torch.from_numpy(coef)
  got_dx = txent.xent_dx_reference(tx, tw, tt, t_lse, t_coef, **kw)
  got_dw = txent.xent_dw_reference(tx, tw, tt, t_lse, t_coef, **kw)
  np.testing.assert_allclose(_np(got_dx), _np(dx), **GRAD_TOL)
  np.testing.assert_allclose(_np(got_dw), _np(dw), **GRAD_TOL)


def _grads_pair(x, w, targets, weights, **kw):
  """(loss, dx, dw) of fused_softmax_xent in JAX (jax.grad) and in the port
  (autograd), from the same f32 numpy inputs."""
  def jloss(x, w):
    return jxent.fused_softmax_xent(
        x, w, jnp.asarray(targets),
        None if weights is None else jnp.asarray(weights), **BLOCKS, **kw)

  want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
  tx = torch.from_numpy(x).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  loss = txent.fused_softmax_xent(
      tx, tw, torch.from_numpy(targets),
      None if weights is None else torch.from_numpy(weights), **BLOCKS, **kw)
  loss.backward()
  return (loss, tx.grad, tw.grad), (want[0], *want[1])


@pytest.mark.parametrize("case", [
    dict(tied=True, logit_cap=30.0, operand_dtype="float32"),
    dict(tied=False, logit_cap=30.0, operand_dtype="float32"),
    dict(tied=True, logit_cap=0.0, operand_dtype="float32"),
    dict(tied=True, logit_cap=30.0),                   # bf16 operands
    dict(tied=False, logit_cap=0.0),                   # bf16 operands
], ids=["tied_f32", "untied_f32", "tied_f32_nocap", "tied_bf16",
        "untied_bf16_nocap"])
def test_fused_softmax_xent_loss_and_grads_match_jax(case):
  """Loss rtol 1e-5; dx and dW GRAD_TOL. dW keeps w's layout and dtype."""
  x, w, targets, weights = _case(1, tied=case["tied"])
  got, want = _grads_pair(x, w, targets, weights, **case)
  np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5)
  assert got[2].shape == w.shape and got[2].dtype == torch.float32
  for g, wnt in zip(got[1:], want[1:]):
    np.testing.assert_allclose(_np(g), _np(wnt), **GRAD_TOL)


def test_3d_input_default_weights_match_jax():
  """x [B, T, D] with the default (all-one) weights, f32 operands: loss rtol
  1e-5, grads atol 1e-6, rtol 1e-4."""
  rng = np.random.default_rng(2)
  x = (0.5 * rng.standard_normal((2, 50, D))).astype(np.float32)
  w = (rng.standard_normal((V, D)) * D ** -0.5).astype(np.float32)
  targets = rng.integers(0, V, (2, 50)).astype(np.int32)
  got, want = _grads_pair(x, w, targets, None, logit_cap=30.0,
                          operand_dtype="float32")
  np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5)
  assert got[1].shape == x.shape
  for g, wnt in zip(got[1:], want[1:]):
    np.testing.assert_allclose(_np(g), _np(wnt), atol=1e-6, rtol=1e-4)


def test_bf16_x_gets_bf16_dx():
  """dx comes back in x's dtype: bf16 activations give a bf16 dx, as in
  JAX (same values up to one bf16 rounding: rtol 1e-2, atol 1e-5)."""
  x, w, targets, weights = _case(3)
  xb = torch.from_numpy(x).bfloat16().requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  txent.fused_softmax_xent(xb, tw, torch.from_numpy(targets),
                           torch.from_numpy(weights), logit_cap=30.0,
                           **BLOCKS).backward()
  assert xb.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32

  def jloss(x):
    return jxent.fused_softmax_xent(x, jnp.asarray(w), jnp.asarray(targets),
                                    jnp.asarray(weights), logit_cap=30.0,
                                    **BLOCKS)

  want = jax.grad(jloss)(jnp.asarray(x).astype(jnp.bfloat16))
  assert want.dtype == jnp.bfloat16
  np.testing.assert_allclose(_np(xb.grad), _np(want), rtol=1e-2, atol=1e-5)


def test_zero_weight_row_gets_zero_dx():
  """A token with loss weight 0 has dx = 0 in its row (exactly: coef 0
  makes its dz 0)."""
  x, w, targets, _ = _case(4)
  weights = np.ones((M,), np.float32)
  weights[3] = 0.0
  tx = torch.from_numpy(x).requires_grad_()
  txent.fused_softmax_xent(tx, torch.from_numpy(w), torch.from_numpy(targets),
                           torch.from_numpy(weights), operand_dtype="float32",
                           **BLOCKS).backward()
  assert float(tx.grad[3].abs().max()) == 0.0
  assert float(tx.grad[4].abs().max()) > 0.0


def test_loss_weights_get_a_zero_cotangent():
  """JAX's custom vjp gives the loss weights a zero cotangent (ops/xent.py
  :281), though the loss depends on them; the port does the same."""
  x, w, targets, weights = _case(5)

  def jloss(wts):
    return jxent.fused_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(targets), wts, **BLOCKS)

  want = jax.grad(jloss)(jnp.asarray(weights))
  tw = torch.from_numpy(weights).requires_grad_()
  txent.fused_softmax_xent(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(targets), tw, **BLOCKS).backward()
  assert np.all(_np(want) == 0.0)
  np.testing.assert_array_equal(tw.grad.numpy(), np.zeros(M, np.float32))


def test_lm_loss_fused_pallas_ignores_unembed_matmul_dtype():
  """lm_loss_fused_pallas takes bf16 operands whatever unembed_matmul_dtype
  says, in both packages: the "float32" and "bfloat16_vjp" configs give the
  same loss bit for bit, which differs from the f32-operand loss of
  fused_softmax_xent; against JAX's lm_loss_fused_pallas rtol 1e-5."""
  rng = np.random.default_rng(6)
  hidden = (0.5 * rng.standard_normal((2, 16, 32))).astype(np.float32)
  targets = rng.integers(0, 384, (2, 16)).astype(np.int32)
  embed = (rng.standard_normal((384, 32)) * 32 ** -0.5).astype(np.float32)
  losses = {}
  for mode in ("float32", "bfloat16_vjp"):
    cfg = tlm.get_lm_config("lm-test")
    cfg.unembed_matmul_dtype = mode
    model = tlm.TransformerLM(cfg, device="meta")
    model.embed = torch.nn.Parameter(torch.from_numpy(embed))
    with torch.no_grad():
      losses[mode] = float(tlm.lm_loss_fused_pallas(
          model, torch.from_numpy(hidden), torch.from_numpy(targets)))
    jcfg = jlm.get_lm_config("lm-test")
    jcfg.unembed_matmul_dtype = mode
    want = jlm.lm_loss_fused_pallas({"embed": jnp.asarray(embed)},
                                    jnp.asarray(hidden), jnp.asarray(targets),
                                    jcfg)
    np.testing.assert_allclose(losses[mode], float(want), rtol=1e-5)
  assert losses["float32"] == losses["bfloat16_vjp"]
  f32 = float(txent.fused_softmax_xent(
      torch.from_numpy(hidden), torch.from_numpy(embed),
      torch.from_numpy(targets), logit_cap=30.0, operand_dtype="float32"))
  assert f32 != losses["float32"]


def test_wrapper_dispatches_on_device_and_counts_only_kernels():
  """CPU tensors take the plain versions (no launch counted); a tensor on
  another device is refused."""
  x, w, targets, weights = _case(7, m=8, v=40, d=16)
  before = (txent.fused_softmax_xent.launches_fwd,
            txent.fused_softmax_xent.launches_dx,
            txent.fused_softmax_xent.launches_dw)
  tx = torch.from_numpy(x).requires_grad_()
  txent.fused_softmax_xent(tx, torch.from_numpy(w), torch.from_numpy(targets),
                           torch.from_numpy(weights)).backward()
  assert (txent.fused_softmax_xent.launches_fwd,
          txent.fused_softmax_xent.launches_dx,
          txent.fused_softmax_xent.launches_dw) == before
  meta = torch.empty((8, 16), device="meta")
  with pytest.raises(ValueError, match="no implementation"):
    txent.xent_fwd(meta, torch.empty((40, 16), device="meta"),
                   torch.empty((8,), dtype=torch.int32, device="meta"))


def test_kernel_dim_limits():
  """Each kernel's D limit, without the libraries: K3a takes any D a
  multiple of 8 (the default LM's 2,048 among them: before, it was held to
  the backward's limit and refused); K3b / K3c at bf16 D a multiple of 256
  up to 2,048 (the Hopper kernels) or any multiple of 8 up to 1,216
  (csrc/xent.cu: its f32 [32, D] accumulator fills a block's shared memory,
  csrc/xent.cu::max_dim), at float32 up to 1,152."""
  bf16, f32 = torch.bfloat16, torch.float32
  assert txent.simt_bwd_max_dim(bf16) == 1216
  assert txent.simt_bwd_max_dim(f32) == 1152
  for d in (256, 512, 768, 1024, 1280, 2048):
    assert txent.takes_sm90(bf16, d) and not txent.takes_sm90(f32, d)
  for d in (72, 1216, 1224, 2304, 4096):
    assert not txent.takes_sm90(bf16, d)
  for which in ("fwd", "dx", "dw"):
    txent.check_dim(which, bf16, 2048)     # the default LM
    txent.check_dim(which, bf16, 72)
    txent.check_dim(which, f32, 1152)
    with pytest.raises(ValueError, match="multiple of 8"):
      txent.check_dim(which, bf16, 2052)
  txent.check_dim("fwd", f32, 4096)
  txent.check_dim("fwd", bf16, 1224)
  for which in ("dx", "dw"):
    with pytest.raises(ValueError, match="up to 1216.*multiple of 256 up to "
                       "2048"):
      txent.check_dim(which, bf16, 1224)
    with pytest.raises(ValueError, match="up to 1152"):
      txent.check_dim(which, f32, 2048)
    with pytest.raises(ValueError, match="up to 1216"):
      txent.check_dim(which, bf16, 2048, simt=True)
    txent.check_dim(which, bf16, 1216, simt=True)


def test_split_plan():
  """The Hopper kernels' last wave: with A clusters at once, the T % A
  tiles left over are split A // (T % A) ways (at most the streamed tiles),
  the rest run whole; no split when A divides T or a split would be 1."""
  assert txent.split_plan(128, 30, 1576) == (120, 3)  # K3b, slice, H100
  assert txent.split_plan(788, 30, 256) == (780, 3)   # K3c
  assert txent.split_plan(32, 15, 500) == (30, 7)     # default LM's K3b
  assert txent.split_plan(250, 15, 64) == (250, 1)    # 10 left: 15 // 10
  assert txent.split_plan(120, 30, 10) == (120, 1)
  assert txent.split_plan(8, 30, 2) == (0, 2)         # streamed tiles bound
  assert txent.split_plan(1, 132, 16) == (0, 16)
  with pytest.raises(ValueError, match="no cluster"):
    txent.split_plan(4, 0, 8)


@pytest.mark.parametrize("dtype,d,sm90", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 1024, True),
    (torch.bfloat16, 2048, True), (torch.bfloat16, 72, False),
    (torch.bfloat16, 1224, False), (torch.bfloat16, 4096, False),
    (torch.float32, 1024, False), (torch.float32, 4096, False)])
def test_k3a_check_dim_and_routing(dtype, d, sm90):
  """K3a's check_dim("fwd") takes every D a multiple of 8, whichever kernel
  runs it; takes_sm90 sends bf16 with D a multiple of 256 up to 2,048 to
  the Hopper forward, the rest to csrc/xent.cu's (as K3b / K3c)."""
  txent.check_dim("fwd", dtype, d)
  txent.check_dim("fwd", dtype, d, simt=True)
  assert txent.takes_sm90(dtype, d) is sm90
  with pytest.raises(ValueError, match="multiple of 8"):
    txent.check_dim("fwd", dtype, d + 4)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 11])
@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["nocap", "cap30"])
def test_k3a_split_parts_merge_to_the_plain_k3a(n_split, cap):
  """The Hopper K3a's last wave: a split tile's parts each carry (m, l, t)
  over their vocab tiles (split_ranges: contiguous, none empty, together
  all 11 tiles of V 700); merged in part order (merge_softmax_parts, as
  csrc/xent_sm90.cu::xent_fwd_merge_kernel) they give the plain K3a's lse
  (atol 2e-6: exp and log of f32 sums in another grouping) and target
  logit (exact: one hit per row)."""
  x, w, targets, _ = _case(11, m=40, d=64, v=700)
  xo, wo = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
  tg = torch.from_numpy(targets)
  z = xo.float() @ wo.float().t()
  if cap:
    z = cap * torch.tanh(z / cap)
  tiles = -(-700 // 64)
  ranges = txent.split_ranges(tiles, n_split)
  assert ranges[0][0] == 0 and ranges[-1][1] == tiles
  assert all(j0 < j1 for j0, j1 in ranges)
  assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
  ms, ls, ts = [], [], []
  for j0, j1 in ranges:
    cols = torch.arange(64 * j0, min(64 * j1, 700))
    zp = z[:, cols]
    m = zp.max(dim=1).values
    ms.append(m)
    ls.append(torch.exp(zp - m[:, None]).sum(dim=1))
    ts.append(torch.where(cols[None, :] == tg[:, None].long(), zp,
                          0.0).sum(dim=1))
  lse, tz = txent.merge_softmax_parts(torch.stack(ms), torch.stack(ls),
                                      torch.stack(ts))
  lse_r, tz_r = txent.xent_fwd_reference(xo, wo, tg, logit_cap=cap)
  torch.testing.assert_close(lse, lse_r, atol=2e-6, rtol=0)
  torch.testing.assert_close(tz, tz_r, atol=0, rtol=0)


def test_bwd_routing_with_stand_in_libraries(monkeypatch):
  """With stand-ins for both libraries: bf16 K3b / K3c with D a multiple
  of 256 reach the Hopper entry points (counted in launches_dx_sm90 /
  launches_dw_sm90) with the split plan and a scratch buffer for the split
  tiles; float32, bf16 D 72 and `_simt` reach csrc/xent.cu's, each with
  as many arguments as its binding declares; K3a at the default LM's D
  2,048 and D 1,024 reaches the Hopper forward (launches_fwd_sm90), K3a at
  float32,
  bf16 D 72 or with `_simt` csrc/xent.cu's. What a kernel does not take
  (bf16 D 1,224, float32 D 2,048, an x TMA cannot read) raises before any
  launch or count."""
  calls = []

  def fake(impl, name, n_args, out=0):
    def fn(*args):
      assert len(args) == n_args, (impl, name, len(args))
      calls.append((impl, name, args))
      return out
    return fn

  monkeypatch.setattr(txent, "_kernel_fns", lambda: (
      fake("simt", "fwd", 11), fake("simt", "dx", 13), fake("simt", "dw", 13),
      None))
  monkeypatch.setattr(txent, "_sm90_fns", lambda: (
      fake("sm90", "fwd", 13), fake("sm90", "dx", 15), fake("sm90", "dw", 15),
      None))
  # Clusters at once on the H100: 30 of 4 blocks (D 1,024), 15 of 8.
  monkeypatch.setattr(txent, "sm90_clusters",
                      lambda d, which, device: {1024: 30, 2048: 15}[d])
  monkeypatch.setattr(torch.cuda, "device",
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, "current_stream",
                      lambda device: types.SimpleNamespace(cuda_stream=0))
  f = txent.fused_softmax_xent

  def run(m, v, d, dtype, **kw):
    x = torch.zeros((m, d), dtype=dtype)
    w = torch.zeros((v, d), dtype=dtype)
    t = torch.zeros((m,), dtype=torch.int32)
    lse, coef = torch.zeros((m,)), torch.zeros((m,))
    calls.clear()
    before = (f.launches_dx, f.launches_dw, f.launches_dx_sm90,
              f.launches_dw_sm90)
    txent.xent_dx_kernel(x, w, t, lse, coef, **kw)
    txent.xent_dw_kernel(x, w, t, lse, coef, **kw)
    after = (f.launches_dx, f.launches_dw, f.launches_dx_sm90,
             f.launches_dw_sm90)
    return [(impl, name) for impl, name, _ in calls], [
        a - b for a, b in zip(after, before)], [args for *_, args in calls]

  got, counts, args = run(16384, 100_864, 1024, torch.bfloat16)
  assert got == [("sm90", "dx"), ("sm90", "dw")] and counts == [1, 1, 1, 1]
  # (n_whole, n_split) of 128 and 788 own tiles on 30 clusters at once
  assert [a[11:13] for a in args] == [(120, 3), (780, 3)]
  assert all(a[13] for a in args)           # a scratch buffer for the parts
  got, _, args = run(4096, 32_000, 2048, torch.bfloat16)
  assert [a[11:13] for a in args] == [(30, 7), (250, 1)]
  assert args[1][13] is None                # no split, no scratch
  for m, v, d, dtype, kw in ((100, 1000, 72, torch.bfloat16, {}),
                             (100, 1000, 256, torch.float32, {}),
                             (100, 1000, 1024, torch.bfloat16,
                              dict(_simt=True))):
    got, counts, _ = run(m, v, d, dtype, **kw)
    assert got == [("simt", "dx"), ("simt", "dw")] and counts == [1, 1, 0, 0]
  for d, dtype, kw, impl in ((2048, torch.bfloat16, {}, "sm90"),
                             (1024, torch.bfloat16, {}, "sm90"),
                             (2048, torch.bfloat16, dict(_simt=True), "simt"),
                             (2048, torch.float32, {}, "simt"),
                             (72, torch.bfloat16, {}, "simt")):
    calls.clear()
    before = (f.launches_fwd, f.launches_fwd_sm90)
    txent.xent_fwd_kernel(torch.zeros((8, d), dtype=dtype),
                          torch.zeros((40, d), dtype=dtype),
                          torch.zeros((8,), dtype=torch.int32), **kw)
    assert [(i, name) for i, name, _ in calls] == [(impl, "fwd")]
    if impl == "sm90":    # one own tile of 128 rows, no split, no scratch
      assert calls[0][2][9:12] == (1, 1, None)
    assert (f.launches_fwd - before[0],
            f.launches_fwd_sm90 - before[1]) == (1, int(impl == "sm90"))

  before = (f.launches_dx, f.launches_dw, f.launches_dx_sm90,
            f.launches_dw_sm90)
  calls.clear()
  t, lse = torch.zeros((8,), dtype=torch.int32), torch.zeros((8,))
  for d, dtype in ((1224, torch.bfloat16), (2048, torch.float32)):
    with pytest.raises(ValueError, match="up to"):
      txent.xent_dx_kernel(torch.zeros((8, d), dtype=dtype),
                           torch.zeros((40, d), dtype=dtype), t, lse, lse)
  odd = torch.zeros((8 * 1024 + 4,), dtype=torch.bfloat16)[4:].view(8, 1024)
  with pytest.raises(ValueError, match="16-byte aligned"):
    txent.xent_dw_kernel(odd, torch.zeros((40, 1024), dtype=torch.bfloat16),
                         t, lse, lse)
  assert calls == [] and (f.launches_dx, f.launches_dw, f.launches_dx_sm90,
                          f.launches_dw_sm90) == before
