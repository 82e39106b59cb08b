"""automl_tpu_torch segmentation and GroupNorm against automl_tpu's on the CPU.

ConvTranspose2D against jax.lax.conv_transpose (odd and even maps),
GroupNorm against JAX's, the segmentation head alone and beside the
detection heads on efficientdet-test from one converted tree,
make_seg_train_step for 3 teacher-forced steps against JAX's, an
EfficientNetV2 with bn_type "gn" against JAX's, and the converter's round
trip of both. The parameter tree is drawn with numpy from a seed
(convert.det_numpy_init), BN leaves perturbed off their init values;
drop_connect is off in both packages for whole-model comparisons. Float32;
JAX matmuls and convs at "highest" precision (tests/conftest.py).
Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu import nn as jnn
from automl_tpu.configs import efficientdet_configs as jdet_configs
from automl_tpu.configs import effnet_configs as jeff_configs
from automl_tpu.models import efficientdet as jdet
from automl_tpu.models import efficientnet as jeff
from automl_tpu.nn import layers as jlayers
from automl_tpu.train import optimizers as jopt
from automl_tpu.train import schedules as jsched
from automl_tpu.train import train_lib as jtrain
from automl_tpu_torch import convert
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.configs import effnet_configs as teff_configs
from automl_tpu_torch.models import efficientdet as tdet
from automl_tpu_torch.models import efficientnet as teff
from automl_tpu_torch.nn import layers as tlayers
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import schedules as tsched
from automl_tpu_torch.train import train_lib as ttrain

torch.set_num_threads(1)

SEG = ["segmentation"]
BOTH = ["object_detection", "segmentation"]


@pytest.fixture(autouse=True)
def f32_policy():
  jnn.set_policy("float32")
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


@pytest.fixture
def no_drop_connect(monkeypatch):
  monkeypatch.setattr(jlayers, "drop_connect", lambda x, *a, **k: x)
  monkeypatch.setattr(jlayers, "drop_connect_with_key", lambda x, *a, **k: x)
  monkeypatch.setattr(tlayers, "drop_connect", lambda x, *a, **k: x)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
      0, 3, 1, 2)))


def _nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


def _flat(tree):
  return {k: np.asarray(v) for k, v in convert.flatten_tree(tree).items()
          if hasattr(v, "shape")}


def _tree(tmodel, seed=0):
  """det_numpy_init with the BN / GN leaves perturbed off their init."""
  tree = convert.det_numpy_init(tmodel, seed)
  rng = np.random.default_rng(seed + 100)

  def perturb(node):
    for leaf, v in node.items():
      if isinstance(v, dict):
        perturb(v)
        continue
      noise = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
      if leaf in ("gamma", "wsm"):
        node[leaf] = 1.0 + noise
      elif leaf in ("beta", "moving_mean"):
        node[leaf] = noise
      elif leaf == "moving_variance":
        node[leaf] = 1.0 + np.abs(noise)

  perturb(tree)
  return tree


def _seg_pair(heads, seed=0, **overrides):
  jcfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  tcfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  for c in (jcfg, tcfg):
    c.override(dict(heads=heads, **overrides), allow_new_keys=True)
  tmodel = tdet.EfficientDet(tcfg)
  tree = _tree(tmodel, seed)
  convert.load_det_params(tmodel, tree)
  return jcfg, tcfg, jdet.EfficientDet(jcfg), tree, tmodel


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------


class _Head(torch.nn.Module):
  """A ConvTranspose2D under one of the segmentation head's names, so the
  converter's kernel layout applies."""

  def __init__(self, *args, **kwargs):
    super().__init__()
    self.head_transpose = tlayers.ConvTranspose2D(*args, **kwargs)


@pytest.mark.parametrize("k,s,hw", [(3, 2, (5, 7)), (3, 2, (4, 6)),
                                    (3, 1, (5, 6)), (2, 2, (3, 4)),
                                    (1, 2, (3, 5)), (4, 3, (4, 3))])
def test_conv_transpose_matches_jax(k, s, hw):
  """lax.conv_transpose (SAME, no kernel flip) with bias against the port
  on the converted kernel, odd and even H / W, strides below and above k:
  atol = rtol = 1e-5; the output is (H s, W s)."""
  rng = np.random.default_rng(k * 10 + s)
  jm = jlayers.ConvTranspose2D(6, 5, k, s, name="head_transpose")
  p = {"kernel": rng.standard_normal((k, k, 6, 5)).astype(np.float32),
       "bias": rng.standard_normal(5).astype(np.float32)}
  tm = _Head(6, 5, k, s)
  convert.load_det_params(tm, {"head_transpose": p})
  assert tm.head_transpose.kernel.shape == (6, 5, k, k)
  x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
  want = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, p),
                       jnp.asarray(x)))
  got = _nhwc(tm.head_transpose(_nchw(x)))
  assert got.shape == want.shape == (2, hw[0] * s, hw[1] * s, 5)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
  back = convert.det_torch_to_jax_tree(tm.state_dict())["head_transpose"]
  np.testing.assert_array_equal(back["kernel"], p["kernel"])


@pytest.mark.parametrize("channels", [16, 32])
def test_group_norm_matches_jax(channels):
  """8 groups over (H, W, the group's channels), f32: atol = rtol = 1e-5;
  the port's output keeps the channels_last layout; a channel count that
  is not a multiple of 8 raises in both packages."""
  rng = np.random.default_rng(channels)
  x = (rng.standard_normal((3, 5, 7, channels)) * 3 + 1).astype(np.float32)
  p = {"gamma": 1 + 0.1 * rng.standard_normal(channels).astype(np.float32),
       "beta": 0.1 * rng.standard_normal(channels).astype(np.float32)}
  jm = jlayers.build_norm(channels, "gn", epsilon=1e-3, name="gn")
  tm = tlayers.build_norm(channels, "gn", epsilon=1e-3)
  assert isinstance(tm, tlayers.GroupNorm) and tm.groups == 8
  tm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
  want = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, p),
                       jnp.asarray(x), True))
  xt = _nchw(x).contiguous(memory_format=torch.channels_last)
  got = tm(xt, train=True)
  assert got.is_contiguous(memory_format=torch.channels_last)
  np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)
  assert tlayers.take_bn_updates(tm) == {}
  with pytest.raises(ValueError):
    tlayers.GroupNorm(12)(torch.zeros(1, 12, 2, 2))
  with pytest.raises(TypeError):
    jlayers.GroupNorm(12)({"gamma": jnp.ones(12), "beta": jnp.zeros(12)},
                          jnp.zeros((1, 2, 2, 12)))


# ---------------------------------------------------------------------------
# The segmentation head and EfficientDet's heads.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [SEG, BOTH])
def test_seg_outputs_match_jax(heads):
  """Eval-mode outputs on one converted tree, 64 x 64: the bare
  segmentation logits [B, 3, 16, 16] (stride 4) for ["segmentation"],
  (class levels, box levels, seg) for both heads, atol = rtol = 1e-4 (f32
  through the backbone and the BiFPN). filter_grad_calls_per_step counts
  the backbone's and BiFPN's depthwise convs (the seg head has none)."""
  jcfg, tcfg, jm, tree, tm = _seg_pair(heads)
  x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(
      np.float32)
  want = jax.jit(lambda p, x: jm(p, x, False))(
      jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
  with torch.no_grad():
    got = tm(_nchw(x), False)
  if heads == SEG:
    assert torch.is_tensor(got) and got.shape == (2, 3, 16, 16)
    pairs = [(got, want)]
    assert tm.class_net is None and tdet.filter_grad_calls_per_step(tm) == 9
  else:
    assert len(got) == len(want) == 3
    pairs = list(zip(got[0] + got[1], want[0] + want[1])) + [(got[2],
                                                               want[2])]
    assert tdet.filter_grad_calls_per_step(tm) == 29
  for t, j in pairs:
    np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=1e-4, rtol=1e-4)


def test_seg_and_gn_converter_round_trip():
  """JAX tree -> port -> JAX tree is exact for both heads (the transposed
  kernels flipped and permuted there and back) and for a GroupNorm
  EfficientNet; every leaf of JAX's init has a port counterpart of the
  same shape."""
  _, tcfg, jm, tree, tm = _seg_pair(BOTH, seed=3)
  back = _flat(convert.det_torch_to_jax_tree(tm.state_dict()))
  want = _flat(tree)
  assert set(back) == set(want)
  for k in want:
    np.testing.assert_array_equal(back[k], want[k], err_msg=k)
  shapes = jax.eval_shape(jm.init, jax.random.key(0))
  assert {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
      lambda s: np.empty(s.shape, np.uint8), shapes)).items()} == {
          k: v.shape for k, v in want.items()}
  k = "segmentation_head.con2d_t_0.kernel"
  j = tree["segmentation_head"]["con2d_t_0"]["kernel"]
  np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                j[::-1, ::-1].transpose(2, 3, 0, 1))
  mcfg = teff_configs.get_model_config("efficientnetv2-test").model
  mcfg.bn_type = "gn"
  gm = teff.EfficientNet(mcfg)
  gtree = _tree(gm, 5)
  convert.load_det_params(gm, gtree)
  gback = _flat(convert.det_torch_to_jax_tree(gm.state_dict()))
  assert set(gback) == set(_flat(gtree))
  for k, v in _flat(gtree).items():
    np.testing.assert_array_equal(gback[k], v, err_msg=k)
  assert not any(k.endswith("moving_mean") for k in gback)


def _seg_batch(i):
  rng = np.random.default_rng(40 + i)
  image = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
  mask = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
  mask[:, :3] = -1           # void rows
  mask[1, 5:8, 2:9] = -1
  return ({"image": jnp.asarray(image), "mask": jnp.asarray(mask)},
          {"image": _nchw(image).contiguous(memory_format=torch.channels_last),
           "mask": torch.from_numpy(mask)})


# Teacher-forced seg steps: metrics rtol 1e-4 (f32 through the model and
# its backward); parameters, EMA, BN statistics and momentum after a step
# atol 2e-5, rtol 1e-4 (tests/test_torch_det.py's STEP_TOL).
STEP_TOL = dict(atol=2e-5, rtol=1e-4)


def test_seg_train_step_teacher_forced_matches_jax(no_drop_connect):
  """3 make_seg_train_step steps (momentum SGD at the config's schedule,
  weight decay with an exclude regex, a global clip, EMA), each from JAX's
  state after the step before (det_state_from_jax), on a batch with void
  pixels: loss, xent, l2, gnorm and pixel_acc, and every parameter, BN
  statistic, EMA leaf and the momentum after the step against JAX's."""
  over = dict(gradient_clip_norm=1.0,
              weight_decay_exclude=r".*(con2d_t|depthwise).*")
  jcfg, tcfg, jm, tree, tm = _seg_pair(SEG, **over)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  jlr, tlr = jsched.detection_lr(jcfg, 1), tsched.detection_lr(tcfg, 1)
  jtx = jopt.masked_for_params(jopt.build_optimizer("momentum", jlr,
                                                    momentum=0.9), jparams)
  ttx = topt.masked_for_params(topt.build_optimizer("momentum", tlr,
                                                    momentum=0.9))
  jstep = jax.jit(jtrain.make_seg_train_step(jm, jtx, jcfg))
  jstate = jtrain.create_train_state(jparams, jtx)
  tstep = ttrain.make_seg_train_step(tm, ttx, tcfg)
  for i in range(3):
    jb, tb = _seg_batch(i)
    j = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = convert.det_state_from_jax(
        tm, j.step, j.params, j.opt_state.inner_state[0].trace,
        j.opt_state.inner_state[1].count, j.ema_params)
    jstate, jmetrics = jstep(jstate, jb, jax.random.key(2))
    tstate, tmetrics = tstep(tstate, tb, torch.Generator())
    assert set(tmetrics) == set(jmetrics) == {"loss", "xent", "l2", "gnorm",
                                              "pixel_acc"}
    for k in jmetrics:
      np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                 rtol=1e-4, atol=1e-6, err_msg=f"{i} {k}")
    assert 0.0 < float(tmetrics["pixel_acc"]) < 1.0
    carried = convert.det_state_to_jax(tstate)
    for name, got, want in (
        ("params", carried["params"], jstate.params),
        ("ema", carried["ema_params"], jstate.ema_params),
        ("momentum", carried["trace"], jstate.opt_state.inner_state[0].trace)):
      got, want = _flat(got), _flat(want)
      assert set(got) == set(want), name
      for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL,
                                   err_msg=f"step {i + 1} {name} {k}")
    assert carried["step"] == int(jstate.step)


# ---------------------------------------------------------------------------
# EfficientNet with GroupNorm.
# ---------------------------------------------------------------------------


def test_v2_test_with_group_norm_matches_jax(no_drop_connect):
  """efficientnetv2-test with model.bn_type=gn: logits in eval and train
  mode (GroupNorm has no moving statistics, so both are the same
  function; the head's dropout off) atol = rtol = 1e-4; no BN update is
  pending after training."""
  jcfg = jeff_configs.get_model_config("efficientnetv2-test").model
  tcfg = teff_configs.get_model_config("efficientnetv2-test").model
  for c in (jcfg, tcfg):   # the head's dropout off: no random draws
    c.override(dict(bn_type="gn", dropout_rate=0.0))
  jm, tm = jeff.EfficientNet(jcfg), teff.EfficientNet(tcfg)
  assert any(isinstance(m, tlayers.GroupNorm) for m in tm.modules())
  assert not any(isinstance(m, tlayers.BatchNorm) for m in tm.modules())
  tree = _tree(tm, 2)
  convert.load_det_params(tm, tree)
  x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
      np.float32)
  jp = jax.tree_util.tree_map(jnp.asarray, tree)
  for train in (False, True):
    want, upd = jnn.run_and_collect_state(jm, jp, jnp.asarray(x), train)
    got = tm(_nchw(x), train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    assert not upd and tlayers.take_bn_updates(tm) == {}


def test_converted_state_does_not_alias_the_tree():
  """det_jax_to_torch_state copies: a training state built from a JAX
  tree (det_state_from_jax) is updated in place (the EMA), and must not
  write into the caller's arrays, which may be a JAX array's buffer."""
  tm = tdet.EfficientDet(tdet_configs.get_efficientdet_config(
      "efficientdet-test"))
  tree = _tree(tm, 1)
  before = {k: v.copy() for k, v in _flat(tree).items()}
  state = convert.det_jax_to_torch_state(tree, list(tm.state_dict()))
  with torch.no_grad():
    for v in state.values():
      v.add_(1.0)
  for k, v in _flat(tree).items():
    np.testing.assert_array_equal(v, before[k], err_msg=k)
