"""automl_tpu_torch.nn.quant (QAT fake-quant) against automl_tpu.nn.quant.

tests/test_quant.py's five cases, each held against JAX's functions on the
same numpy inputs; the QAT hooks of Conv2D, DepthwiseConv2D (K6 knob on
and off) and Dense under qat_scope against JAX's apply under its qat_scope,
outputs and the straight-through gradients; and two steps of
`main_det --hparams=qat=true` on efficientdet-test against JAX's
run_detection with the same weights and data. Float32 throughout; the
tolerances are stated per test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu import nn as jnn
from automl_tpu.configs import efficientdet_configs as jdet_configs
from automl_tpu.models import efficientdet as jdet
from automl_tpu.nn import layers as jlayers
from automl_tpu.nn import quant as jquant
from automl_tpu.train import runners as jrunners
from automl_tpu_torch import convert
from automl_tpu_torch.cli import main_det as tcli
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.models import efficientdet as tdet
from automl_tpu_torch.nn import layers as tlayers
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.nn import quant
from automl_tpu_torch.ops import depthwise as tdw
from automl_tpu_torch.train import optimizers as topt

torch.set_num_threads(1)

# Fake-quant is elementwise after one max: the same f32 ops in both
# packages, so results agree to the last bit or within 1e-6. A layer's
# convs and matmuls, and their backward, sum in other orders: its outputs
# within 1e-6 absolute plus 1e-6 relative (f32 sums of up to 144 terms);
# a parameter's gradient (a sum over the batch and the map, of up to 162
# terms that cancel) within 1e-6 of the leaf's largest entry.
QUANT_ATOL = 1e-6
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)


def _assert_grad_close(got, want, what):
  scale = max(float(np.abs(want).max()), 1.0)
  np.testing.assert_allclose(got, want, atol=QUANT_ATOL * scale, rtol=0,
                             err_msg=what)


@pytest.fixture(autouse=True)
def f32_policy():
  jnn.set_policy("float32")
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")
    jquant.disable_qat()
    quant.disable_qat()


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
      0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# tests/test_quant.py's cases, each against JAX.
# ---------------------------------------------------------------------------


def test_fake_quant_levels_and_range():
  x = np.linspace(-1.0, 1.0, 1000, dtype=np.float32)
  q = quant.fake_quant(torch.from_numpy(x), bits=8).numpy()
  np.testing.assert_allclose(q, np.asarray(jquant.fake_quant(
      jnp.asarray(x), bits=8)), atol=QUANT_ATOL, rtol=0)
  # symmetric int8: at most 255 distinct levels, max abs error <= scale/2
  assert len(np.unique(q)) <= 255
  np.testing.assert_allclose(q, x, atol=(1.0 / 127) / 2 + 1e-6)
  np.testing.assert_array_equal(quant.fake_quant(torch.zeros(4)).numpy(),
                                np.zeros(4))


def test_fake_quant_per_channel_axis():
  """Per-channel scales keep a small channel precise (JAX's axis -1 of
  [64, 2] against the port's on the same array); the port's axis 0 of the
  transpose equals JAX's axis -1, as its kernels need."""
  x = np.stack([np.linspace(-1, 1, 64), 100 * np.linspace(-1, 1, 64)],
               -1).astype(np.float32)
  want = np.asarray(jquant.fake_quant(jnp.asarray(x), bits=8, axis=-1))
  q_pc = quant.fake_quant(torch.from_numpy(x), bits=8, axis=-1).numpy()
  np.testing.assert_allclose(q_pc, want, atol=QUANT_ATOL, rtol=0)
  q_t = quant.fake_quant(torch.from_numpy(x.T.copy()), bits=8, axis=0)
  np.testing.assert_allclose(q_t.numpy().T, want, atol=QUANT_ATOL, rtol=0)
  np.testing.assert_allclose(q_pc[:, 0], x[:, 0], atol=1.0 / 127)
  q_pt = quant.fake_quant(torch.from_numpy(x), bits=8, axis=None).numpy()
  np.testing.assert_allclose(q_pt, np.asarray(jquant.fake_quant(
      jnp.asarray(x), bits=8, axis=None)), atol=QUANT_ATOL, rtol=0)
  assert np.abs(q_pt[:, 0] - x[:, 0]).max() > 0.1


def test_fake_quant_straight_through_gradient():
  """d/dx sum(q(x)^2) = 2 q(x) (identity through the rounding): equal to
  JAX's gradient."""
  x = np.array([0.3, -0.7, 0.9], np.float32)
  t = torch.from_numpy(x).requires_grad_()
  (quant.fake_quant(t, bits=4) ** 2).sum().backward()
  want = jax.grad(lambda v: jnp.sum(jquant.fake_quant(v, bits=4) ** 2))(
      jnp.asarray(x))
  np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                             atol=QUANT_ATOL, rtol=0)
  q = quant.fake_quant(torch.from_numpy(x), bits=4)
  np.testing.assert_allclose(t.grad.numpy(), 2 * q.numpy(), rtol=1e-6)


def _conv_dense_pair():
  rng = np.random.default_rng(0)
  jconv, jdense = jlayers.Conv2D(4, 8, 3, name="c"), jlayers.Dense(
      8, 2, name="d")
  cp = {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 0.3}
  dp = {"kernel": rng.uniform(-0.3, 0.3, (8, 2)).astype(np.float32),
        "bias": rng.standard_normal(2).astype(np.float32) * 0.1}
  tconv, tdense = tlayers.Conv2D(4, 8, 3), tlayers.Dense(8, 2)
  convert.load_det_params(tconv, cp)
  convert.load_det_params(tdense, dp)
  x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
  return (jconv, cp, tconv), (jdense, dp, tdense), x


def test_conv_dense_apply_under_qat_scope():
  """Conv2D and Dense under qat_scope: the port's outputs against JAX's
  within LAYER_TOL; QAT changes the output by less than the int8 error;
  the scope restores the mode."""
  (jconv, cp, tconv), (jdense, dp, tdense), x = _conv_dense_pair()
  jp = jax.tree_util.tree_map(jnp.asarray, cp)
  y_float = tconv(_nchw(x))
  with quant.qat_scope(bits=8), jquant.qat_scope(bits=8):
    y_qat = tconv(_nchw(x))
    z_qat = tdense(y_qat.mean((2, 3)))
    jy = jconv(jp, jnp.asarray(x))
    jz = jdense(jax.tree_util.tree_map(jnp.asarray, dp), jy.mean(axis=(1, 2)))
  np.testing.assert_allclose(_nhwc(y_qat), np.asarray(jy), **LAYER_TOL)
  np.testing.assert_allclose(z_qat.detach().numpy(), np.asarray(jz),
                             **LAYER_TOL)
  assert not torch.equal(y_float, y_qat)
  np.testing.assert_allclose(y_qat.detach().numpy(), y_float.detach().numpy(),
                             atol=0.15, rtol=0.25)
  assert not quant.qat_enabled()


def test_qat_train_step_converges():
  """A tiny classifier still learns with QAT on (STE gradients flow): 30
  SGD steps at lr 0.5, the port's losses against JAX's within 1e-5."""
  import optax
  rng = np.random.default_rng(0)
  x = rng.standard_normal((32, 8)).astype(np.float32)
  y = np.eye(4, dtype=np.float32)[np.arange(32) % 4]
  p = {"kernel": rng.uniform(-0.35, 0.35, (8, 4)).astype(np.float32),
       "bias": np.zeros(4, np.float32)}
  jd, td = jlayers.Dense(8, 4, name="d"), tlayers.Dense(8, 4)
  convert.load_det_params(td, p)
  jparams = jax.tree_util.tree_map(jnp.asarray, p)
  tx = optax.sgd(0.5)
  jstate = tx.init(jparams)

  def jloss(params):
    return -jnp.mean(jnp.sum(y * jax.nn.log_softmax(jd(params, x)), -1))

  ttx = topt.sgd(0.5)
  params = dict(td.named_parameters())
  tstate = ttx.init(params)
  yt = torch.from_numpy(y)
  losses = []
  with quant.qat_scope(bits=8), jquant.qat_scope(bits=8):
    jstep = jax.jit(jax.value_and_grad(jloss))
    for _ in range(30):
      jl, jg = jstep(jparams)
      updates, jstate = tx.update(jg, jstate, jparams)
      jparams = optax.apply_updates(jparams, updates)
      loss = -(yt * torch.log_softmax(td(torch.from_numpy(x)), -1)).sum(
          -1).mean()
      grads = dict(zip(params, torch.autograd.grad(loss, list(
          params.values()))))
      with torch.no_grad():
        upd, tstate = ttx.update(grads, tstate, params)
        for k in params:
          params[k].add_(upd[k])
      losses.append(float(loss.detach()))
      np.testing.assert_allclose(float(loss), float(jl), atol=1e-5, rtol=0)
  assert losses[-1] < losses[0] * 0.8, losses


# ---------------------------------------------------------------------------
# The layers' hooks against JAX's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer", ["conv", "depthwise_off", "depthwise_on",
                                   "separable", "dense"])
def test_qat_layers_and_ste_gradients_match_jax(layer):
  """Each hooked layer under qat_scope: the output within LAYER_TOL of
  JAX's apply under its qat_scope, and the straight-through gradients
  (of sum(out * cotangent)) w.r.t. the input within LAYER_TOL and w.r.t.
  every parameter within 1e-6 of the leaf's largest entry. The depthwise conv with the K6 knob on takes
  ops/depthwise.depthwise_conv (the plain K6 on the CPU) with the
  fake-quantized kernel."""
  rng = np.random.default_rng(1)
  if layer == "conv":
    jm, tm = jlayers.Conv2D(8, 16, 3, 2, use_bias=True, name="l"), \
        tlayers.Conv2D(8, 16, 3, 2, use_bias=True)
  elif layer.startswith("depthwise"):
    jm, tm = jlayers.DepthwiseConv2D(16, 3, name="l"), \
        tlayers.DepthwiseConv2D(16, 3)
  elif layer == "separable":
    jm, tm = jlayers.SeparableConv2D(16, 8, 3, name="l"), \
        tlayers.SeparableConv2D(16, 8, 3)
  else:
    jm, tm = jlayers.Dense(16, 8, name="l"), tlayers.Dense(16, 8)
  tree = convert.det_numpy_init(tm, 3)
  for key in ("bias",):   # nonzero biases
    for node in ([tree] + [v for v in tree.values() if isinstance(v, dict)]):
      if key in node:
        node[key] = rng.standard_normal(node[key].shape).astype(np.float32)
  convert.load_det_params(tm, tree)
  shape = (2, 16) if layer == "dense" else (2, 9, 9, 16 if layer !=
                                                  "conv" else 8)
  x = rng.standard_normal(shape).astype(np.float32)
  jp = jax.tree_util.tree_map(jnp.asarray, tree)
  knob = layer == "depthwise_on"
  calls = []
  ref = tdw.depthwise_filter_grad_reference
  tdw.enable_pallas_filter_grad(knob)
  tdw.depthwise_filter_grad_reference = lambda *a: calls.append(1) or ref(*a)
  try:
    with quant.qat_scope(), jquant.qat_scope():
      jy, vjp = jax.vjp(lambda p, v: jm(p, v), jp, jnp.asarray(x))
      ct = rng.standard_normal(jy.shape).astype(np.float32)
      jgp, jgx = vjp(jnp.asarray(ct))
      tx_in = torch.from_numpy(x) if layer == "dense" else _nchw(x)
      tx_in.requires_grad_()
      ty = tm(tx_in)
      tct = torch.from_numpy(ct) if layer == "dense" else _nchw(ct)
      (ty * tct).sum().backward()
  finally:
    tdw.depthwise_filter_grad_reference = ref
    tdw.enable_pallas_filter_grad(False)
  assert len(calls) == (1 if knob else 0)
  to_jax = (lambda t: t.detach().numpy()) if layer == "dense" else _nhwc
  np.testing.assert_allclose(to_jax(ty), np.asarray(jy), **LAYER_TOL)
  np.testing.assert_allclose(to_jax(tx_in.grad), np.asarray(jgx),
                             **LAYER_TOL)
  got = convert.det_torch_to_jax_tree(
      {k: p.grad for k, p in tm.named_parameters()})
  for k, v in convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                          jgp)).items():
    _assert_grad_close(convert.flatten_tree(got)[k], v, k)


def test_transposed_conv_and_norms_are_not_quantized():
  """As in JAX: ConvTranspose2D, BatchNorm and GroupNorm have no QAT
  hook."""
  x = torch.randn(2, 8, 4, 4)
  mods = [tlayers.ConvTranspose2D(8, 8, 3, 2), tlayers.BatchNorm(8),
          tlayers.GroupNorm(8)]
  for m in mods:
    for p in m.parameters():
      torch.nn.init.normal_(p) if p.ndim > 1 else None
    with torch.no_grad():
      want = m(x)
      with quant.qat_scope():
        got = m(x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# main_det --hparams=qat=true against JAX's runner.
# ---------------------------------------------------------------------------

# Two QAT steps of the whole detector. Step 1 from the same weights: the
# loss terms within 1e-5 relative (measured on the CPU: 2e-7). Step 2 is
# chaotic in both packages: fake-quant rounds every activation to its
# tensor's int8 grid, so a last-bit difference of a conv moves elements
# across a rounding boundary (a whole quantization step). Measured on the
# CPU: JAX's own step-2 loss moves 1.1% when its step-1 parameters are
# perturbed by 1e-6 (relative), the port's from JAX's exact step-1 state
# differs 0.4%, and with only the kernels fake-quantized the two agree to
# 3e-7. Step 2's limit: 3% relative.
QAT_STEP1_RTOL = 1e-5
QAT_STEP2_RTOL = 3e-2


def test_main_det_qat_two_steps_match_jax_runner(tmp_path, monkeypatch):
  """`main_det --hparams=qat=true` (2 steps, efficientdet-test, f32) and
  JAX's run_detection with qat=True from the same seeded weights (the
  port's det_numpy_init tree given to JAX's init), on the same synthetic
  batches; the scale jitter pinned to 1 and no flip (so neither draws),
  drop_connect off in both. The loss terms of step 1 within
  QAT_STEP1_RTOL, of step 2 within QAT_STEP2_RTOL; QAT stays on after a
  run and the next run's entry turns it off."""
  monkeypatch.setattr(jlayers, "drop_connect", lambda x, *a, **k: x)
  monkeypatch.setattr(tlayers, "drop_connect", lambda x, *a, **k: x)
  hp = ("qat=true,jitter_min=1.0,jitter_max=1.0,input_rand_hflip=false,"
        "mixed_precision=false,batch_size=2")
  tree = convert.det_numpy_init(tdet.EfficientDet(
      tdet_configs.get_efficientdet_config("efficientdet-test")), 0)
  monkeypatch.setattr(jdet.EfficientDet, "init", lambda self, key:
                      jax.tree_util.tree_map(jnp.asarray, tree))
  jcfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  jcfg.override(hp, allow_new_keys=True)
  jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
  jrunners.run_detection(jcfg, jdir, 2, log_every=1)
  assert jquant.qat_enabled()
  tcli.main(["--model_name=efficientdet-test", f"--model_dir={tdir}",
             "--use_fake_data", "--device=cpu", "--train_steps=2",
             "--log_every=1", f"--hparams={hp}"])
  assert quant.qat_enabled() and quant.qat_bits() == 8
  read = lambda d: [json.loads(l) for l in open(os.path.join(
      d, "metrics.jsonl"))]
  jrecs, trecs = read(jdir), read(tdir)
  assert [r["step"] for r in trecs] == [r["step"] for r in jrecs] == [1, 2]
  for j, t, rtol in zip(jrecs, trecs, (QAT_STEP1_RTOL, QAT_STEP2_RTOL)):
    for k in ("loss", "det_loss", "cls_loss", "box_loss"):
      np.testing.assert_allclose(t[k], j[k], rtol=rtol,
                                 err_msg=f"step {t['step']} {k}")
  # a run without qat turns the mode off at entry
  tcli.main(["--model_name=efficientdet-test", f"--model_dir={tdir}_off",
             "--use_fake_data", "--device=cpu", "--train_steps=1",
             "--hparams=batch_size=2,mixed_precision=false"])
  assert not quant.qat_enabled()


def test_main_cls_qat_trains_under_the_mode(tmp_path):
  """`main_cls --hparam_str=train.qat=true,train.qat_bits=6` on
  efficientnetv2-test: the run sets the mode (6 bits) at entry and trains
  a finite loss that differs from the same step without QAT (the hooks
  ran); the run without it turns the mode off."""
  from automl_tpu_torch.cli import main_cls

  def run(name, extra):
    main_cls.main(["--model_name=efficientnetv2-test", "--device=cpu",
                   f"--model_dir={tmp_path / name}", "--train_steps=1",
                   "--log_every=1", f"--hparam_str=runtime.mixed_precision="
                   f"false{extra}"])
    rec = json.loads(open(tmp_path / name / "metrics.jsonl").readline())
    return rec["loss"]

  qat = run("qat", ",train.qat=true,train.qat_bits=6")
  assert quant.qat_enabled() and quant.qat_bits() == 6
  plain = run("plain", "")
  assert not quant.qat_enabled()
  assert np.isfinite(qat) and qat != plain
