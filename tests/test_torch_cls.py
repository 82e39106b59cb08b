"""automl_tpu_torch classification against automl_tpu's on the CPU:
schedules, optimizers, the Head, the train and eval steps, the runner,
the CLIs, the registry and the multi-label metrics.

One JAX-layout parameter tree, drawn with numpy from a seed
(convert.det_numpy_init, the BN leaves perturbed off their init values),
goes into both packages at the float32 policy. Every dropout and
drop_connect mask is JAX's: the JAX layers record theirs
(jax.debug.callback) and the port's replay them in the same order. JAX
matmuls and convs run at "highest" precision (tests/conftest.py).
Tolerances are stated per test.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automl_tpu import nn as jnn
from automl_tpu.configs import effnet_configs as jcfgs
from automl_tpu.data import datasets as jds
from automl_tpu.data import pipeline as jpipe
from automl_tpu.data import preprocessing as jpre
from automl_tpu.eval import classification as jevalc
from automl_tpu.models import efficientnet as jeff
from automl_tpu.nn import layers as jlayers
from automl_tpu.train import optimizers as jopt
from automl_tpu.train import runners as jrun
from automl_tpu.train import schedules as jsched
from automl_tpu.train import train_lib as jtrain
from automl_tpu_torch import convert
from automl_tpu_torch.cli import infer_cls as tinfer
from automl_tpu_torch.cli import main_cls as tmain
from automl_tpu_torch.configs import effnet_configs as tcfgs
from automl_tpu_torch.data import datasets as tds
from automl_tpu_torch.data import pipeline as tpipe
from automl_tpu_torch.eval import classification as tevalc
from automl_tpu_torch.models import efficientnet as teff
from automl_tpu_torch.nn import layers as tlayers
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import depthwise as tdw
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import runners as trun
from automl_tpu_torch.train import schedules as tsched
from automl_tpu_torch.train import train_lib as ttrain

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def f32_policy():
  jnn.set_policy("float32")
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
  return _t(np.asarray(a).transpose(0, 3, 1, 2)).contiguous(
      memory_format=torch.channels_last)


def _flat(tree):
  return {k: np.asarray(v) for k, v in convert.flatten_tree(tree).items()
          if hasattr(v, "shape")}


def _max_diff(got, want):
  got, want = _flat(got), _flat(want)
  assert set(got) == set(want)
  return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _perturbed_tree(tmodel, seed=0):
  """det_numpy_init with the BN leaves perturbed off their init values."""
  tree = convert.det_numpy_init(tmodel, seed)
  rng = np.random.default_rng(seed + 100)

  def perturb(node):
    for leaf, v in node.items():
      if isinstance(v, dict):
        perturb(v)
        continue
      noise = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
      if leaf == "gamma":
        node[leaf] = 1.0 + noise
      elif leaf in ("beta", "moving_mean"):
        node[leaf] = noise
      elif leaf == "moving_variance":
        node[leaf] = 1.0 + np.abs(noise)

  perturb(tree)
  return tree


def _nested(flat: dict) -> dict:
  """{'a.b': v} -> {'a': {'b': v}} (Config.override's dict form)."""
  out = {}
  for key, v in flat.items():
    node = out
    *parents, leaf = key.split(".")
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = v
  return out


# efficientnetv2-test with one more stage: a stride-1 MBConv with a skip,
# so the step also runs drop_connect and a stride-1 depthwise conv (K6).
MBCONV_STAGE = "r2_k3_s1_e2_i16_o16_se0.25"


def _cls_pair(seed=0, extra_stage=True, **overrides):
  jcfg = jcfgs.get_model_config("efficientnetv2-test")
  tcfg = tcfgs.get_model_config("efficientnetv2-test")
  for c in (jcfg, tcfg):
    if extra_stage:
      c.model.blocks_args = list(c.model.blocks_args) + [MBCONV_STAGE]
    c.override(_nested(overrides))
  tmodel = teff.EfficientNet(tcfg.model)
  tree = _perturbed_tree(tmodel, seed)
  convert.load_det_params(tmodel, tree)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  return jcfg, tcfg, jeff.build_model(jcfg.model), jparams, tmodel, tree


class MaskTape:
  """JAX's dropout / drop_connect masks recorded in call order and
  replayed, in the same order, by the port's layers."""

  def __init__(self, monkeypatch):
    self.masks = []
    tape = self.masks

    def record(mask):
      jax.debug.callback(lambda m: tape.append(np.asarray(m)), mask,
                         ordered=True)

    def jdropout(x, train, rate):
      if not train or rate <= 0.0:
        return x
      keep = 1.0 - rate
      mask = jax.random.bernoulli(jnn.make_rng("dropout"), keep, x.shape)
      record(mask)
      return jnp.where(mask, x / keep, jnp.zeros_like(x))

    def jdrop_connect(x, train, survival_prob):
      if not train or survival_prob is None or survival_prob >= 1.0:
        return x
      shape = (x.shape[0],) + (1,) * (x.ndim - 1)
      mask = jax.random.bernoulli(jnn.make_rng("drop_connect"),
                                  survival_prob, shape)
      record(mask)
      return jnp.where(mask, x / survival_prob, jnp.zeros_like(x))

    def tdropout(x, train, rate, generator=None):
      if not train or rate <= 0.0:
        return x
      keep = 1.0 - rate
      mask = torch.from_numpy(tape.pop(0))
      if mask.ndim == 4:
        mask = mask.permute(0, 3, 1, 2)
      return torch.where(mask, x / keep, torch.zeros_like(x))

    def tdrop_connect(x, train, survival_prob, generator=None):
      if not train or survival_prob is None or survival_prob >= 1.0:
        return x
      mask = torch.from_numpy(tape.pop(0)).view(-1, 1, 1, 1)
      return tlayers.apply_drop_connect(x, mask, survival_prob)

    monkeypatch.setattr(jlayers, "dropout", jdropout)
    monkeypatch.setattr(jlayers, "drop_connect", jdrop_connect)
    monkeypatch.setattr(tlayers, "dropout", tdropout)
    monkeypatch.setattr(tlayers, "drop_connect", tdrop_connect)


# ---------------------------------------------------------------------------
# Schedules and optimizers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["exponential", "cosine", "linear",
                                  "constant"])
def test_warmup_lr_matches_jax(name):
  """The classification schedules over steps 0-200, with and without
  warm-up and a minimal lr, against JAX's function called step by step:
  rtol 1e-6 (atol 1e-12 where the rate reaches 0)."""
  for kw in (dict(steps_per_epoch=7, total_steps=200, warmup_epochs=3,
                  decay_epochs=2.4, decay_factor=0.97),
             dict(steps_per_epoch=11, total_steps=150, warmup_epochs=0.5,
                  decay_epochs=1, decay_factor=0.5, minimal_lr=1e-3),
             dict(steps_per_epoch=5, total_steps=201, warmup_epochs=0)):
    j, t = jsched.warmup_lr(name, 0.016, **kw), tsched.warmup_lr(
        name, 0.016, **kw)
    want = np.array([float(j(s)) for s in range(201)], np.float32)
    got = np.array([t(s) for s in range(201)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                               err_msg=str(kw))
  with pytest.raises(ValueError):
    tsched.warmup_lr("bogus", 0.1)


def _opt_pair(name):
  sched = lambda count: 0.01 * (0.9 ** count)
  if name == "adamw":
    mask = {"w": True, "b": False, "moving_mean": False}
    j = jopt.build_optimizer(name, sched, weight_decay=0.05,
                             weight_decay_mask=mask)
    t = topt.build_optimizer(name, sched, weight_decay=0.05,
                             weight_decay_mask=lambda k: mask[k])
  else:
    j = jopt.build_optimizer(name, sched)
    t = topt.build_optimizer(name, sched)
  return j, t


@pytest.mark.parametrize("name", ["rmsprop", "adam", "adamw", "momentum",
                                  "lion"])
def test_optimizers_match_optax_five_steps(name):
  """Five updates with a schedule of the optimizer's count, the BN
  statistic masked out (optax.masked / masked_for_params) and, for adamw,
  a weight-decay mask: parameters atol 1e-7 and rtol 2.4e-7 (two float32
  steps: XLA's CPU rsqrt is not correctly rounded, and differs from
  torch's in the last bit for a third of the inputs) after every step; the
  masked-out leaf takes its update unchanged in both."""
  rng = np.random.default_rng(0)
  params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
            "moving_mean": rng.standard_normal((3,)).astype(np.float32)}
  jtx, ttx = _opt_pair(name)
  trainable = {k: k != "moving_mean" for k in params}
  jtx = optax.masked(jtx, trainable)
  ttx = topt.masked_for_params(ttx)
  jp = {k: jnp.asarray(v) for k, v in params.items()}
  tp = {k: _t(v).clone() for k, v in params.items()}
  js, ts = jtx.init(jp), ttx.init(tp)
  for step in range(5):
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in params.items()}
    ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
    jp = optax.apply_updates(jp, ju)
    tu, ts = ttx.update({k: _t(v) for k, v in g.items()}, ts, tp)
    tp = {k: tp[k] + tu[k] for k in tp}
    for k in params:
      np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7,
                                 rtol=2.4e-7,
                                 err_msg=f"{name} step {step} {k}")


# ---------------------------------------------------------------------------
# The model's head, the train and eval steps.
# ---------------------------------------------------------------------------


def test_head_matches_jax(monkeypatch):
  """The EfficientNet Head (conv, BN, act, pool, dropout 0.2 with JAX's
  mask, fc) in training and eval mode: logits atol 1e-5; the pending BN
  update too."""
  tape = MaskTape(monkeypatch)
  mcfg = jcfgs.get_model_config("efficientnetv2-b0").model
  jh = jeff.Head(24, 32, 10, mcfg)
  th = teff.Head(24, 32, 10, tcfgs.get_model_config("efficientnetv2-b0").model)
  tree = _perturbed_tree(th, 3)
  convert.load_det_params(th, tree)
  jp = jax.tree_util.tree_map(jnp.asarray, tree)
  x = np.random.default_rng(4).standard_normal((3, 5, 6, 24)).astype(
      np.float32)

  @jax.jit
  def jrun_head(p, x, key):
    with jnn.rng_scope(key):
      return jnn.run_and_collect_state(jh, p, x, True)

  (y, upd) = jrun_head(jp, jnp.asarray(x), jax.random.key(1))
  jax.effects_barrier()
  assert len(tape.masks) == 1 and tape.masks[0].shape == (3, 32)
  ty = th(_nchw(x), train=True)
  np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5)
  (mean, _), = tlayers.take_bn_updates(th).values()
  np.testing.assert_allclose(mean.numpy(), upd[("head", "norm",
                                                 "moving_mean")], atol=1e-5)
  np.testing.assert_allclose(
      th(_nchw(x), train=False).detach().numpy(),
      np.asarray(jh(jp, jnp.asarray(x), False)), atol=1e-5)


def _batch(b, size, classes, seed, multi=False):
  rng = np.random.default_rng(seed)
  image = rng.standard_normal((b, size, size, 3)).astype(np.float32)
  if multi:
    label = (rng.random((b, classes)) < 0.4).astype(np.float32)
  else:
    label = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
  return image, label


STEP_TOL = dict(atol=1e-6, rtol=0)


def _check_cls_state(tstate, jstate, what):
  assert tstate.step == int(jstate.step)
  for got, want, name in (
      (convert.det_torch_to_jax_tree(tstate.params), jstate.params, "params"),
      (convert.det_torch_to_jax_tree(tstate.ema_params), jstate.ema_params,
       "ema")):
    d = _max_diff(got, want)
    assert d <= STEP_TOL["atol"], (what, name, d)
  carried = convert.cls_state_to_jax(tstate)
  inner = jstate.opt_state.inner_state
  assert carried["count"] == int(inner[1].count)
  for name, want in (("nu", inner[0].nu), ("trace", inner[2].trace)):
    d = _max_diff(carried[name], want)
    assert d <= STEP_TOL["atol"], (what, name, d)


def _cls_tx(jcfg, tcfg, jparams, steps_per_epoch=4):
  kw = dict(steps_per_epoch=steps_per_epoch, total_steps=8,
            warmup_epochs=jcfg.train.lr_warmup_epoch,
            decay_epochs=jcfg.train.lr_decay_epoch,
            decay_factor=jcfg.train.lr_decay_factor,
            minimal_lr=jcfg.train.lr_min)
  jtx = jopt.masked_for_params(jopt.build_optimizer(
      jcfg.train.optimizer, jsched.warmup_lr(jcfg.train.lr_sched,
                                             jcfg.train.lr_base, **kw)),
      jparams)
  ttx = topt.masked_for_params(topt.build_optimizer(
      tcfg.train.optimizer, tsched.warmup_lr(tcfg.train.lr_sched,
                                             tcfg.train.lr_base, **kw)))
  return jtx, ttx


def test_cls_train_step_matches_jax_two_steps(monkeypatch):
  """Two make_cls_train_step steps on efficientnetv2-test plus a stride-1
  MBConv stage (RMSProp, exponential lr, EMA 0.9999, label smoothing 0.1,
  L2 with weight_decay_exclude, gclip 0.5, the K6 knob on: its plain
  version on the CPU), with JAX's dropout and drop_connect masks: every
  metric rtol 1e-5; parameters, BN statistics, EMA, nu and the momentum
  trace atol 1e-6 after each step. Then JAX's state after step 1, carried
  into a fresh port model (cls_state_from_jax), takes step 2 to JAX's
  state after step 2."""
  tape = MaskTape(monkeypatch)
  jcfg, tcfg, jm, jparams, tm, _ = _cls_pair(
      **{"train.gclip": 0.5, "train.lr_warmup_epoch": 0.25})
  jtx, ttx = _cls_tx(jcfg, tcfg, jparams)
  jstep = jax.jit(jtrain.make_cls_train_step(jm, jtx, jcfg))
  jstate = jtrain.create_train_state(jparams, jtx, ema=True)
  tstep = ttrain.make_cls_train_step(tm, ttx, tcfg)
  tstate = ttrain.create_train_state(tm, ttx, ema=True)
  calls = []
  ref = tdw.depthwise_filter_grad_reference
  monkeypatch.setattr(tdw, "depthwise_filter_grad_reference",
                      lambda *a: calls.append(1) or ref(*a))
  tdw.enable_pallas_filter_grad(True)
  try:
    jstates = []
    for i in range(2):
      image, label = _batch(4, 32, 4, seed=i)
      jstate, jm_ = jstep(jstate, {"image": jnp.asarray(image),
                                   "label": jnp.asarray(label)},
                          jax.random.key(9))
      jax.effects_barrier()
      jstates.append(jstate)
      assert len(tape.masks) == 3      # 2 drop_connect, the head's dropout
      tstate, tm_ = tstep(tstate, {"image": _nchw(image),
                                   "label": _t(label)}, torch.Generator())
      assert not tape.masks
      assert set(tm_) == set(jm_)
      for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
      _check_cls_state(tstate, jstate, f"step {i + 1}")
    assert len(calls) == 2 * 2        # two stride-1 depthwise convs a step

    j1 = jax.tree_util.tree_map(np.asarray, jstates[0])
    inner = j1.opt_state.inner_state
    tm2 = teff.EfficientNet(tcfg.model)
    state2 = convert.cls_state_from_jax(tm2, j1.step, j1.params, inner[0].nu,
                                        inner[1].count, inner[2].trace,
                                        j1.ema_params)
    image, label = _batch(4, 32, 4, seed=1)
    jstep(jstates[0], {"image": jnp.asarray(image),
                       "label": jnp.asarray(label)}, jax.random.key(9))
    jax.effects_barrier()
    state2, _ = ttrain.make_cls_train_step(tm2, ttx, tcfg)(
        state2, {"image": _nchw(image), "label": _t(label)},
        torch.Generator())
    _check_cls_state(state2, jstates[1], "carried step 2")
  finally:
    tdw.enable_pallas_filter_grad(False)


def test_cls_sigmoid_multilabel_step_matches_jax(monkeypatch):
  """One step of the multi-label (sigmoid) loss on multi-hot labels, no
  label smoothing: metrics rtol 1e-5, parameters atol 1e-6."""
  MaskTape(monkeypatch)
  jcfg, tcfg, jm, jparams, tm, _ = _cls_pair(
      extra_stage=False, **{"train.loss_type": "sigmoid",
                            "train.label_smoothing": 0.0,
                            "train.lr_warmup_epoch": 0})
  jtx, ttx = _cls_tx(jcfg, tcfg, jparams)
  jstate = jtrain.create_train_state(jparams, jtx, ema=True)
  tstate = ttrain.create_train_state(tm, ttx, ema=True)
  image, label = _batch(4, 32, 4, seed=5, multi=True)
  jstate, jm_ = jax.jit(jtrain.make_cls_train_step(jm, jtx, jcfg))(
      jstate, {"image": jnp.asarray(image), "label": jnp.asarray(label)},
      jax.random.key(1))
  jax.effects_barrier()
  tstate, tm_ = ttrain.make_cls_train_step(tm, ttx, tcfg)(
      tstate, {"image": _nchw(image), "label": _t(label)}, torch.Generator())
  for k in jm_:
    np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5,
                               atol=1e-7, err_msg=k)
  assert _max_diff(convert.det_torch_to_jax_tree(tstate.params),
                   jstate.params) <= 1e-6


def test_cls_eval_step_and_evaluate_classification_match_jax():
  """make_cls_eval_step's sums and evaluate_classification's top-1 / top-5
  (the eval preprocess from canvases, eval.isize 32) equal JAX's, from the
  same params, over 3 synthetic batches."""
  jcfg, tcfg, jm, jparams, tm, tree = _cls_pair(
      extra_stage=False, **{"model.num_classes": 10, "data.num_classes": 10})
  image, label = _batch(6, 32, 10, seed=7)
  want = jtrain.make_cls_eval_step(jm)(jparams, {"image": jnp.asarray(image),
                                                 "label": jnp.asarray(label)})
  got = ttrain.make_cls_eval_step(tm)(convert.model_state(tm),
                                      {"image": _nchw(image),
                                       "label": _t(label)})
  assert {k: float(v) for k, v in got.items()} == {
      k: float(v) for k, v in want.items()}
  want = jrun.evaluate_classification(
      jm, jparams, jcfg, iter(jpipe.SyntheticClassification(8, 64, 10)), 3)
  # the EMA-style params dict path: a copy, not the model's own tensors
  params = {k: v.clone() for k, v in convert.model_state(tm).items()}
  got = trun.evaluate_classification(
      tm, params, tcfg, iter(tpipe.SyntheticClassification(8, 64, 10)), 3)
  assert got == want


def test_progressive_stage_params_match_jax():
  """resolve_train_size and every stage's (size, magnitude, mixup, cutmix)
  for V2-S / M / L, a fractional train size and the test config: exact."""
  for name in ("efficientnetv2-s", "efficientnetv2-m", "efficientnetv2-l",
               "efficientnet-b0", "efficientnetv2-test"):
    jcfg, tcfg = jcfgs.get_model_config(name), tcfgs.get_model_config(name)
    assert trun.resolve_train_size(tcfg) == jrun.resolve_train_size(jcfg)
    for total in (1, 4):
      for stage in range(total):
        assert (trun._progressive_stage_params(tcfg, stage, total)
                == jrun._progressive_stage_params(jcfg, stage, total))
  s = tcfgs.get_model_config("efficientnetv2-s")
  assert [trun._progressive_stage_params(s, i, 4)[0] for i in range(4)] == [
      168, 208, 256, 296]


def test_run_classification_two_stages_writes_metrics_and_ckpts(tmp_path):
  """run_classification on efficientnetv2-test, 2 stages of 2 steps with
  mixup and cutmix (half the batch each) and an eval every stage: the
  stages' sizes in the log, finite losses in metrics.jsonl, eval lines,
  a checkpoint per stage, the archive by top-1; a rerun to 6 steps
  resumes from step 4."""
  cfg = tcfgs.get_model_config("efficientnetv2-test")
  cfg.override(_nested({"train.stages": 2, "data.ibase": 16,
                        "train.isize": 32, "data.mixup_alpha": 0.2,
                        "data.cutmix_alpha": 0.2,
                        "runtime.mixed_precision": False}))
  d = str(tmp_path / "cls")
  evals = lambda: iter(tpipe.SyntheticClassification(4, 64, 4))
  out = trun.run_classification(cfg, d, 4, log_every=1, eval_iter=evals,
                                eval_steps=1, device="cpu")
  assert np.isfinite(out["loss"]) and "eval/top1" in out
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  steps = [r["step"] for r in recs if "loss" in r]
  assert steps == [1, 2, 3, 4]
  assert [r["step"] for r in recs if "eval/top1" in r] == [2, 4]
  assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
  assert sorted(os.listdir(os.path.join(d, "ckpt"))) >= ["2", "4"]
  assert os.path.exists(os.path.join(d, "archive", "best_objective.txt"))
  trun.run_classification(cfg, d, 6, log_every=1, device="cpu")
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4, 5, 6]


def test_main_cls_trains_on_cpu(tmp_path):
  out = tmain.main(["--model_name=efficientnetv2-test", "--device=cpu",
                    f"--model_dir={tmp_path}", "--train_steps=2",
                    "--log_every=1", "--mode=traineval", "--eval_samples=8",
                    "--hparam_str=runtime.mixed_precision=false"])
  assert np.isfinite(out["loss"]) and 0 <= out["eval/top1"] <= 1


def _save_port_ckpt(tmodel, directory):
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  tx = topt.masked_for_params(topt.build_optimizer("rmsprop", 0.1))
  CheckpointManager(directory).save(3, ttrain.create_train_state(tmodel, tx))


def test_infer_cls_bm_and_infer_match_jax(tmp_path, capsys):
  """bm prints JAX's keys (fps, latency_ms); infer's top-5 from a port
  checkpoint equals JAX's infer from an orbax checkpoint of the same
  params (efficientnetv2-test, float32; probabilities atol 1e-4)."""
  from PIL import Image
  from automl_tpu.cli import infer_cls as jinfer
  from automl_tpu.train.checkpoint import CheckpointManager as JMngr
  hp = "--hparam_str=runtime.mixed_precision=false,model.num_classes=10"
  out = tinfer.main(["--model_name=efficientnetv2-test", "--device=cpu",
                     "--batch_size=2", "--bm_runs=1", hp])
  assert set(out) == {"fps", "latency_ms"} and out["fps"] > 0
  capsys.readouterr()

  jcfg, tcfg, jm, jparams, tm, tree = _cls_pair(
      extra_stage=False, **{"model.num_classes": 10})
  with torch.no_grad():   # a confident classifier: top-5 well apart
    tm.head.fc.kernel.mul_(30.0)
  tree = convert.det_torch_to_jax_tree(convert.model_state(tm))
  img = np.random.default_rng(3).integers(0, 256, (50, 70, 3), np.uint8)
  path = str(tmp_path / "x.png")
  Image.fromarray(img).save(path)
  port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
  _save_port_ckpt(tm, port_dir)
  jm_ = JMngr(jax_dir)
  jm_.save(1, {"params": jax.tree_util.tree_map(jnp.asarray, tree)})
  jm_.wait_until_finished()
  flags = ["--runmode=infer", f"--input_image={path}",
           "--model_name=efficientnetv2-test", hp]
  jinfer.main(flags + [f"--ckpt_path={jax_dir}"])
  want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  got = tinfer.main(flags + [f"--ckpt_path={port_dir}", "--device=cpu"])
  assert [c for c, _ in got["top5"]] == [c for c, _ in want["top5"]]
  with pytest.raises(NotImplementedError, match="orbax.*ROADMAP M9"):
    tinfer.main(flags + [f"--ckpt_path={jax_dir}", "--device=cpu"])
  np.testing.assert_allclose([p for _, p in got["top5"]],
                             [p for _, p in want["top5"]], atol=1e-4)


CLS_REFUSED = {
    "--mode=eval": "M9", "--train_file_pattern=x": "M9",
    "--val_file_pattern=x": "M9", "--native_loader": "M9",
    "--data_dir=/x": "M9", "--ft_init_ckpt=x": "M9", "--eval_timeout=3": "M9",
    "--mesh_shape=1,2": "M10", "--num_processes=2": "M10",
    "--hparam_str=train.qat=true": "M11",
    "--hparam_str=train.ft_init_ckpt=x": "M9"}
INFER_REFUSED = {"--runmode=export": "M9", "--runmode=eval": "M9",
                 "--tf_ckpt": "M9"}


@pytest.mark.parametrize("flag", list(CLS_REFUSED) + list(INFER_REFUSED))
def test_cli_refusals_name_their_roadmap_items(flag, tmp_path):
  if flag in INFER_REFUSED:
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP {INFER_REFUSED[flag]}"):
      tinfer.main(["--model_name=efficientnetv2-test", "--device=cpu", flag])
    return
  with pytest.raises(NotImplementedError, match=f"ROADMAP {CLS_REFUSED[flag]}"):
    tmain.main(["--model_name=efficientnetv2-test", "--device=cpu",
                f"--model_dir={tmp_path}", "--train_steps=1", flag])


def test_data_dir_and_mesh_refused_in_code(tmp_path):
  cfg = tcfgs.get_model_config("efficientnetv2-test")
  with pytest.raises(NotImplementedError, match="M10"):
    trun.run_classification(cfg, str(tmp_path), 1, mesh_shape=(1, 2),
                            device="cpu")
  cfg.data.data_dir = "/data"
  with pytest.raises(NotImplementedError, match="M9"):
    tds.build_dataset(cfg, "train", 2)
  tm = teff.EfficientNet(cfg.model)
  with pytest.raises(NotImplementedError, match="M10"):
    trun.evaluate_classification(tm, convert.model_state(tm), cfg, iter(()),
                                 1, mesh=object())


def test_registry_and_synthetic_data_match_jax():
  """Dataset names, every overlay and spec, SyntheticClassification and
  SyntheticMultiLabel (byte-equal from the same seed), multihot_on_device,
  and build_dataset's synthetic loaders."""
  assert tds.dataset_names() == jds.dataset_names()
  for name in jds.dataset_names():
    assert (tds.get_dataset_config(name).as_dict()
            == jds.get_dataset_config(name).as_dict())
  asdict = lambda specs: {k: dataclasses.asdict(v) for k, v in specs.items()}
  assert asdict(tds.DATASETS) == asdict(jds.DATASETS)
  with pytest.raises(KeyError):
    tds.get_dataset_config("bogus")
  want = jpipe.SyntheticClassification(5, 24, 7, seed=3).batch
  got = tpipe.SyntheticClassification(5, 24, 7, seed=3).batch
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])
  jit_, tit = iter(jds.SyntheticMultiLabel(3, 16, 50)), iter(
      tds.SyntheticMultiLabel(3, 16, 50))
  for _ in range(2):
    w, g = next(jit_), next(tit)
    for k in w:
      np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(
        tds.multihot_on_device(g["label_ids"], 50).numpy(),
        np.asarray(jds.multihot_on_device(jnp.asarray(w["label_ids"]), 50)))
  for ds in ("imagenet", "imagenet21k"):
    jc, tc = jcfgs.get_model_config("efficientnetv2-b0"), tcfgs.get_model_config(
        "efficientnetv2-b0")
    jc.data.ds_name = tc.data.ds_name = ds
    w = next(iter(jds.build_dataset(jc, "train", 2, canvas_size=20)))
    g = next(iter(tds.build_dataset(tc, "train", 2, canvas_size=20)))
    for k in w:
      np.testing.assert_array_equal(g[k], w[k])


def test_multilabel_metrics_match_jax():
  """average_precision_pr, precision_at_1 and MultiLabelEvaluator (ties in
  the scores included) equal JAX's."""
  rng = np.random.default_rng(8)
  scores = np.round(rng.standard_normal((30, 12)), 1)
  labels = (rng.random((30, 12)) < 0.2).astype(np.float32)
  assert tevalc.average_precision_pr(scores, labels) == \
      jevalc.average_precision_pr(scores, labels)
  assert tevalc.precision_at_1(scores, labels) == jevalc.precision_at_1(
      scores, labels)
  te, je = tevalc.MultiLabelEvaluator(), jevalc.MultiLabelEvaluator()
  for i in range(3):
    te.add_batch(scores[i * 10:(i + 1) * 10], labels[i * 10:(i + 1) * 10])
    je.add_batch(scores[i * 10:(i + 1) * 10], labels[i * 10:(i + 1) * 10])
  assert te.result() == je.result() and te.num_examples == 30
  assert tevalc.average_precision_pr(scores, 0 * labels) == 0.0


# ---------------------------------------------------------------------------
# Full size and trajectories (slow).
# ---------------------------------------------------------------------------

# Teacher-forced block outputs: max|diff| within BLOCK_SHARE of the block's
# largest activation (f32 through one block from the same input).
BLOCK_SHARE = 1e-5


@pytest.mark.slow
def test_v2s_teacher_forced_block_by_block_at_384():
  """EfficientNetV2-S at its eval size (384 x 384, b2, f32) in eval mode,
  teacher-forced: the stem, each of the 40 blocks and the head take JAX's
  own input; each output within BLOCK_SHARE of its largest entry (deep
  random-weight parity drifts, so no end-to-end comparison of the free
  forward)."""
  jcfg = jcfgs.get_model_config("efficientnetv2-s")
  tcfg = tcfgs.get_model_config("efficientnetv2-s")
  tm = teff.EfficientNet(tcfg.model)
  tree = _perturbed_tree(tm, 0)
  convert.load_det_params(tm, tree)
  jm = jeff.build_model(jcfg.model)
  jp = jax.tree_util.tree_map(jnp.asarray, tree)
  x = np.random.default_rng(1).standard_normal((2, 384, 384, 3)).astype(
      np.float32)

  def check(name, got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4:
      got = got.transpose(0, 2, 3, 1)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BLOCK_SHARE * scale, name

  with torch.no_grad():
    jx = jm.stem(jp["stem"], jnp.asarray(x), False)
    check("stem", tm.stem(_nchw(x), False), jx)
    assert len(jm.blocks) == len(tm.blocks) == 40
    for jb, tb in zip(jm.blocks, tm.blocks):
      jy = jb(jp[jb.name], jx, False, None)
      check(jb.name, tb(_nchw(jx), False, None), jy)
      jx = jy
    check("head", tm.head(_nchw(jx), False), jm.head(jp["head"], jx, False))


FORCED_ATOL = dict(param=2e-5, ema=2e-5, momentum=2e-4)


@pytest.mark.slow
def test_cls_trajectory_with_randaugment_and_mixup_matches_jax(monkeypatch):
  """20 make_cls_train_step steps on efficientnetv2-test (plus a stride-1
  MBConv stage; RMSProp, EMA, label smoothing) with the preprocess on the
  device: the crop, flip, RandAugment (2 layers, m 5), mixup and cutmix
  (0.2, half the batch each) from JAX's draws, JAX's dropout and
  drop_connect masks. Teacher-forced: before each step the port takes
  JAX's state (cls_state_from_jax); after it, the loss rtol 1e-5,
  parameters and EMA atol 2e-5, nu and the momentum trace atol 2e-4 (the
  tolerances of the detection trajectory)."""
  from automl_tpu.data import augment as jaug
  from test_torch_augment import _crop_draws, _ra_draws
  tape = MaskTape(monkeypatch)
  jcfg, tcfg, jm, jparams, tm, _ = _cls_pair(
      **{"data.mixup_alpha": 0.2, "data.cutmix_alpha": 0.2,
         "train.lr_warmup_epoch": 0.25})
  jtx, ttx = _cls_tx(jcfg, tcfg, jparams, steps_per_epoch=20)
  b, canvas, isize, ram = 4, 36, 32, 5.0

  def jprep(batch, rng):
    k1, k2 = jax.random.split(rng)
    images = jpre.cls_train_preprocess(batch["image"], k1, isize,
                                       augname="randaug", ra_num_layers=2,
                                       ra_magnitude=ram)
    return dict(zip(("image", "label"), jaug.mixing(
        images, batch["label"], k2, 0.2, 0.2)))

  def draws_of(rng):
    k1, k2 = jax.random.split(rng)
    keys = jax.random.split(k1, b * 3)
    ka, kb = jax.random.split(k2)
    kb1, kb2, kb3 = jax.random.split(kb, 3)
    half = b // 2
    beta = lambda k, n: _t(np.asarray(jax.random.beta(k, 0.2, 0.2, (n,))))
    return ({"crop": _crop_draws(keys[:b]),
             "flip": torch.tensor([bool(jax.random.bernoulli(k))
                                   for k in keys[b:2 * b]]),
             "randaug": _ra_draws(list(keys[2 * b:]), 2, isize, isize)},
            {"mixup_lam": beta(ka, half), "cutmix_lam": beta(kb1, b - half),
             "cutmix_centre": _t(np.stack([
                 np.asarray(jax.random.randint(kb2, (b - half,), 0, isize)),
                 np.asarray(jax.random.randint(kb3, (b - half,), 0, isize))],
                 1))})

  current = {}

  def tprep(batch, generator):
    images = tpre.cls_train_preprocess(batch["image"], current["pre"],
                                       isize, "randaug", ram)
    nhwc, labels = taug.mixing(images.permute(0, 2, 3, 1), batch["label"],
                               current["mix"], 0.2, 0.2)
    return {"image": nhwc.permute(0, 3, 1, 2), "label": labels}

  from automl_tpu_torch.data import augment as taug
  from automl_tpu_torch.data import preprocessing as tpre
  jstep = jax.jit(jtrain.make_cls_train_step(jm, jtx, jcfg,
                                             preprocess_fn=jprep))
  jstate = jtrain.create_train_state(jparams, jtx, ema=True)
  rng = jax.random.key(3)
  worst = dict(loss=0.0, param=0.0, ema=0.0, momentum=0.0)
  for step in range(20):
    raw = np.random.default_rng(step % 3).integers(
        0, 256, (b, canvas, canvas, 3), dtype=np.uint8)
    label = np.eye(4, dtype=np.float32)[[step % 4, 1, 2, 3]]
    before = jax.tree_util.tree_map(np.asarray, jstate)
    jstate, jmet = jstep(jstate, {"image": jnp.asarray(raw),
                                  "label": jnp.asarray(label)}, rng)
    jax.effects_barrier()
    current["pre"], current["mix"] = draws_of(jax.random.fold_in(
        jax.random.fold_in(rng, step), 1))
    inner = before.opt_state.inner_state
    tstate = convert.cls_state_from_jax(tm, before.step, before.params,
                                        inner[0].nu, inner[1].count,
                                        inner[2].trace, before.ema_params)
    tstate, tmet = ttrain.make_cls_train_step(tm, ttx, tcfg,
                                              preprocess_fn=tprep)(
        tstate, {"image": _t(raw), "label": _t(label)}, torch.Generator())
    assert not tape.masks
    worst["loss"] = max(worst["loss"], abs(float(tmet["loss"]) - float(
        jmet["loss"])) / abs(float(jmet["loss"])))
    carried = convert.cls_state_to_jax(tstate)
    jin = jstate.opt_state.inner_state
    worst["param"] = max(worst["param"], _max_diff(carried["params"],
                                                   jstate.params))
    worst["ema"] = max(worst["ema"], _max_diff(carried["ema_params"],
                                               jstate.ema_params))
    worst["momentum"] = max(worst["momentum"],
                            _max_diff(carried["nu"], jin[0].nu),
                            _max_diff(carried["trace"], jin[2].trace))
  print(f"teacher-forced trajectory, worst over 20 steps: {worst}")
  assert worst["loss"] <= 1e-5
  for k, tol in FORCED_ATOL.items():
    assert worst[k] <= tol, (k, worst[k])
