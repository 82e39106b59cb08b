"""automl_tpu_torch.ops.xent against automl_tpu.ops.xent on the CPU.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
its Pallas K3a-c in interpret mode, the port the plain versions of its CUDA
kernels, at the JAX tests' ragged shapes (M 100 against block_m 64, V 1000
against block_v 256, D 128), so JAX's pad masking is exercised. Tolerances
are stated per test.
"""

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_kernels_match_pallas(cap, dtype):
  """Plain K3a / K3b / K3c against _fwd_pallas / _bwd_pallas (interpret
  mode), fed the same lse and coef. lse and tz: atol 1e-5 (f32 sums in
  another order). dx and dW: atol 1e-6, rtol 1e-4 (GRAD_TOL)."""
  x, w, targets, weights = _case(0)
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
