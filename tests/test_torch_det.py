"""automl_tpu_torch detection training vs automl_tpu's on the CPU.

One JAX-layout parameter tree, drawn with numpy from a seed
(convert.det_numpy_init; BN statistics, gammas, betas and BiFPN fusion
weights perturbed off their init values), goes into both packages, on
efficientdet-test at the float32 policy. drop_connect is patched out of
both for whole-model comparisons (both draw their masks from their own
random streams); test_drop_connect_matches_jax holds the port's against
JAX's with one mask. JAX matmuls and convs run at "highest" precision
(tests/conftest.py). Tolerances are stated per test.
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
from automl_tpu.configs import effnet_configs as jeff_configs
from automl_tpu.data import preprocessing as jpre
from automl_tpu.models import efficientdet as jdet
from automl_tpu.models import efficientnet as jeff
from automl_tpu.nn import layers as jlayers
from automl_tpu.ops import anchors as janchors
from automl_tpu.ops import losses as jlosses
from automl_tpu.train import optimizers as jopt
from automl_tpu.train import schedules as jsched
from automl_tpu.train import train_lib as jtrain
from automl_tpu_torch import config as tconfig
from automl_tpu_torch import convert
from automl_tpu_torch.cli import main_det as tcli
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.configs import effnet_configs as teff_configs
from automl_tpu_torch.data import pipeline as tpipeline
from automl_tpu_torch.data import preprocessing as tpre
from automl_tpu_torch.models import efficientdet as tdet
from automl_tpu_torch.models import efficientnet as teff
from automl_tpu_torch.nn import layers as tlayers
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import anchors as tanchors
from automl_tpu_torch.ops import depthwise as tdw
from automl_tpu_torch.ops import losses as tlosses
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import schedules as tsched
from automl_tpu_torch.train import runners as trunners
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


def _tree(tmodel, seed=0):
  """det_numpy_init with the BN leaves and fusion weights perturbed."""
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


def _det_pair(name="efficientdet-test", seed=0, **overrides):
  jcfg = jdet_configs.get_efficientdet_config(name)
  tcfg = tdet_configs.get_efficientdet_config(name)
  for c in (jcfg, tcfg):
    c.override(overrides, allow_new_keys=True)
  tmodel = tdet.EfficientDet(tcfg)
  tree = _tree(tmodel, seed)
  convert.load_det_params(tmodel, tree)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  return jcfg, tcfg, jdet.EfficientDet(jcfg), jparams, tmodel, tree


def _flat(tree):
  return {k: np.asarray(v) for k, v in convert.flatten_tree(tree).items()
          if hasattr(v, "shape")}


def _assert_trees_close(got, want, atol, rtol, what):
  got, want = _flat(got), _flat(want)
  assert set(got) == set(want), what
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                               err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# Configs and the parameter tree.
# ---------------------------------------------------------------------------


def test_registry_and_tables_match_jax():
  names = tconfig.registered_names()
  for name in list(jdet_configs.EFFICIENTDET_MODEL_PARAMS) + list(
      jdet_configs.EFFICIENTDET_LITE_PARAMS) + ["efficientdet-test"]:
    assert name in names
    assert (tconfig.lookup(name).as_dict()
            == jdet_configs.get_efficientdet_config(name).as_dict())
  for name in ("efficientnet-b0", "efficientnet-lite3", "efficientnetv2-s"):
    assert (tconfig.lookup(name).as_dict()
            == jeff_configs.get_model_config(name).as_dict())
  with pytest.raises(KeyError):
    tconfig.lookup("efficientdet-d9")


@pytest.mark.parametrize("name", ["efficientdet-test", "efficientdet-d0",
                                  "efficientdet-lite3"])
def test_param_tree_matches_jax_init(name):
  """Every leaf of EfficientDet.init (jax.eval_shape: no compile) has a port
  counterpart of the same shape, and back; lite3 has the stem-width rule."""
  jm = jdet.EfficientDet(jdet_configs.get_efficientdet_config(name))
  shapes = jax.eval_shape(jm.init, jax.random.key(0))
  want = {k: tuple(v.shape) for k, v in convert.flatten_tree(
      jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.uint8),
                             shapes)).items()}
  tm = tdet.EfficientDet(tdet_configs.get_efficientdet_config(name),
                         device="meta")
  state = {k: torch.empty(v.shape) for k, v in tm.state_dict().items()}
  got = {k: v.shape for k, v in _flat(
      convert.det_torch_to_jax_tree(state)).items()}
  assert got == want
  assert sum(v.numel() for v in state.values()) == sum(
      int(np.prod(s)) for s in want.values())


def test_tree_round_trip():
  """JAX tree -> port -> JAX tree is exact."""
  tm = tdet.EfficientDet(tdet_configs.get_efficientdet_config(
      "efficientdet-test"))
  tree = _tree(tm, 3)
  convert.load_det_params(tm, tree)
  _assert_trees_close(convert.det_torch_to_jax_tree(tm.state_dict()), tree,
                      0, 0, "round trip")


# ---------------------------------------------------------------------------
# Layers and the backbone.
# ---------------------------------------------------------------------------


def test_batchnorm_train_matches_jax():
  """Outputs and both moving statistics within 1e-5."""
  rng = np.random.default_rng(0)
  x = (rng.standard_normal((3, 5, 6, 8)) * 2 + 1).astype(np.float32)
  p = {"gamma": rng.random(8).astype(np.float32) + 0.5,
       "beta": rng.standard_normal(8).astype(np.float32),
       "moving_mean": rng.standard_normal(8).astype(np.float32),
       "moving_variance": rng.random(8).astype(np.float32) + 0.5}
  jbn = jlayers.BatchNorm(8)
  y, upd = jnn.run_and_collect_state(jbn, p, jnp.asarray(x), True)
  tbn = tlayers.BatchNorm(8)
  tbn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
  ty = tbn(_nchw(x), train=True)
  np.testing.assert_allclose(_nhwc(ty), np.asarray(y), atol=1e-5, rtol=1e-5)
  (mean, var), = tlayers.take_bn_updates(tbn).values()
  np.testing.assert_allclose(mean.numpy(), upd[("bn", "moving_mean")],
                             atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(var.numpy(), upd[("bn", "moving_variance")],
                             atol=1e-5, rtol=1e-5)
  ey = tbn(_nchw(x), train=False)   # eval: the moving statistics
  np.testing.assert_allclose(_nhwc(ey), np.asarray(jbn(p, jnp.asarray(x))),
                             atol=1e-5, rtol=1e-5)


def test_drop_connect_matches_jax():
  """One mask (JAX's draw) through both: the same kept rows, scaled."""
  x = np.random.default_rng(1).standard_normal((6, 3, 4, 2)).astype(
      np.float32)
  key = jax.random.key(5)
  want = np.asarray(jlayers.drop_connect_with_key(jnp.asarray(x), key, 0.7))
  keep = np.array(jax.random.bernoulli(key, 0.7, (6, 1, 1, 1)))
  got = tlayers.apply_drop_connect(_nchw(x), torch.from_numpy(
      keep.transpose(0, 3, 1, 2)), 0.7)
  np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6)
  gen = torch.Generator().manual_seed(0)
  out = tlayers.drop_connect(_nchw(x), True, 0.7, gen)
  kept = (out.flatten(1) != 0).any(1)
  torch.testing.assert_close(out[kept], _nchw(x)[kept] / 0.7)
  assert tlayers.drop_connect(_nchw(x), False, 0.7) is not None
  with pytest.raises(RuntimeError):
    tlayers.drop_connect(_nchw(x), True, 0.7, None)


@pytest.mark.parametrize("block", ["r1_k3_s1_e1_i16_o16_se0.25",
                                   "r1_k5_s2_e6_i16_o24_se0.25",
                                   "r1_k3_s1_e4_i16_o16_c1"])
def test_block_matches_jax(block, no_drop_connect):
  """MBConv / FusedMBConv in training mode (batch statistics), with SE and
  the skip: output atol = rtol = 1e-5, the pending BN updates too."""
  mcfg = jeff_configs.get_model_config("efficientnet-b0").model
  args = jeff.decode_block_string(block)
  jb = jeff.BLOCK_TYPES[args.conv_type](args, mcfg, name="blk")
  tb = teff.BLOCK_TYPES[args.conv_type](teff.decode_block_string(block),
                                        teff_configs.get_model_config(
                                            "efficientnet-b0").model)
  tree = _tree(tb, 1)
  convert.load_det_params(tb, tree)
  x = np.random.default_rng(2).standard_normal((2, 9, 9, 16)).astype(
      np.float32)
  y, upd = jnn.run_and_collect_state(
      jb, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), True,
      0.8)
  ty = tb(_nchw(x), True, 0.8)
  np.testing.assert_allclose(_nhwc(ty), np.asarray(y), atol=1e-5, rtol=1e-5)
  names = {m: n for n, m in tb.named_modules()}
  updates = tlayers.take_bn_updates(tb)
  assert len(updates) == len(upd) // 2 == sum(
      isinstance(m, tlayers.BatchNorm) for m in tb.modules())
  for bn, (mean, var) in updates.items():
    path = ("blk",) + tuple(names[bn].split("."))
    np.testing.assert_allclose(mean.numpy(), upd[path + ("moving_mean",)],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), upd[path + ("moving_variance",)],
                               atol=1e-5, rtol=1e-5)


def test_efficientnet_b0_backbone_matches_jax():
  """B0 (16 blocks) features_only in eval mode on a 64x64 input: every
  endpoint within atol 1e-4, rtol 1e-4 (f32 through 16 blocks); the
  parameter count equals jax.eval_shape's."""
  jm = jeff.build_model("efficientnet-b0", no_head=True)
  tm = teff.build_model("efficientnet-b0", no_head=True)
  n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
      jax.eval_shape(jm.init, jax.random.key(0))))
  assert n_jax == sum(v.numel() for v in tm.state_dict().values())
  tree = _tree(tm, 4)
  convert.load_det_params(tm, tree)
  x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(
      np.float32)
  want = jax.jit(lambda p, x: jm(p, x, False, features_only=True))(
      jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
  with torch.no_grad():
    got = tm(_nchw(x), False, features_only=True)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]),
                               atol=1e-4, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# EfficientDet.
# ---------------------------------------------------------------------------

# efficientdet-test, and lite-style: the lite0 backbone rules (no SE,
# relu6, unscaled stem) at the test widths, sum fusion; then the other
# fusion weightings.
MODEL_CASES = {
    "test": {},
    "lite_style": dict(backbone_name="efficientnet-lite0", act_type="relu6",
                       fpn_weight_method="sum", mean_rgb=127.0,
                       stddev_rgb=128.0),
    "attn": dict(fpn_weight_method="attn"),
    "channel_fastattn": dict(fpn_weight_method="channel_fastattn",
                             separable_conv=False),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_efficientdet_outputs_match_jax(case):
  """Eval-mode class and box outputs per level, and flatten_predictions:
  atol = rtol = 1e-4."""
  jcfg, _, jm, jparams, tm, _ = _det_pair(**MODEL_CASES[case])
  x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(
      np.float32)
  jcls, jbox = jax.jit(lambda p, x: jm(p, x, False))(jparams, jnp.asarray(x))
  with torch.no_grad():
    tcls, tbox = tm(_nchw(x), False)
  for j, t in zip(jcls + jbox, tcls + tbox):
    np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=1e-4, rtol=1e-4)
  for c, jout, tout in ((jcfg.num_classes, jcls, tcls), (4, jbox, tbox)):
    np.testing.assert_allclose(
        tdet.flatten_predictions(tout, c).numpy(),
        np.asarray(jdet.flatten_predictions(jout, c)), atol=1e-4, rtol=1e-4)


@pytest.mark.slow
def test_efficientdet_d0_full_size_matches_jax():
  """D0 at 512 x 512, b1, eval mode: class and box outputs per level within
  atol 1e-3, rtol 1e-3 (f32 through the 16 backbone blocks, 3 BiFPN cells
  and the heads; the JAX side compiles for minutes on a CPU)."""
  _, _, jm, jparams, tm, _ = _det_pair("efficientdet-d0")
  x = np.random.default_rng(10).standard_normal((1, 512, 512, 3)).astype(
      np.float32)
  jcls, jbox = jax.jit(lambda p, x: jm(p, x, False))(jparams, jnp.asarray(x))
  with torch.no_grad():
    tcls, tbox = tm(_nchw(x), False)
  for j, t in zip(jcls + jbox, tcls + tbox):
    np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Anchors, losses, preprocessing, schedule, clipping, EMA.
# ---------------------------------------------------------------------------

# Tie-free boxes: each box's best anchor leads the next by >= 0.038 IoU
# (a box smaller than the anchors would tie every anchor that contains it),
# and no anchor lies within 1e-4 of the 0.5 threshold.
GT_BOXES = np.array([
    [[4.3, 5.1, 40.7, 38.2], [20.1, 30.5, 50.2, 60.3], [0, 0, 0, 0],
     [0, 0, 0, 0]],
    [[10.9, 2.7, 38.1, 31.3], [33.3, 25.1, 61.8, 57.9],
     [1.7, 30.6, 29.2, 62.3], [0, 0, 0, 0]]], np.float32)
GT_CLASSES = np.array([[1, 3, -1, -1], [2, 1, 3, -1]], np.int32)


def test_anchors_and_labeler_match_jax():
  """Anchor boxes exact; labels exact (classes, positives) and box targets
  within 1e-5 on tie-free boxes."""
  cfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  args = (cfg.min_level, cfg.max_level, cfg.num_scales, cfg.aspect_ratios,
          cfg.anchor_scale, cfg.image_size)
  ja, ta = janchors.Anchors(*args), tanchors.Anchors(*args)
  np.testing.assert_array_equal(ta.boxes.numpy(), np.asarray(ja.boxes))
  assert ta.counts_per_level() == ja.counts_per_level()
  want = janchors.AnchorLabeler(ja).label_anchors(jnp.asarray(GT_BOXES),
                                                  jnp.asarray(GT_CLASSES))
  got = tanchors.AnchorLabeler(ta).label_anchors(torch.from_numpy(GT_BOXES),
                                                 torch.from_numpy(GT_CLASSES))
  np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5,
                             rtol=1e-5)
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
  assert float(got[2].min()) > 0
  pred = np.random.default_rng(5).standard_normal(
      (2, ta.boxes.shape[0], 4)).astype(np.float32) * 0.3
  np.testing.assert_allclose(
      tanchors.decode_box_outputs(torch.from_numpy(pred), ta.boxes).numpy(),
      np.asarray(janchors.decode_box_outputs(jnp.asarray(pred), ja.boxes)),
      atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("iou_loss_type", [None, "giou", "ciou"])
def test_detection_loss_matches_jax(iou_loss_type):
  """total, cls, box and box-IoU losses within rtol 1e-5."""
  cfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  cfg.override(dict(iou_loss_type=iou_loss_type, label_smoothing=0.1))
  ja = janchors.Anchors(cfg.min_level, cfg.max_level, cfg.num_scales,
                        cfg.aspect_ratios, cfg.anchor_scale, cfg.image_size)
  cls_t, box_t, npos = janchors.AnchorLabeler(ja).label_anchors(
      jnp.asarray(GT_BOXES), jnp.asarray(GT_CLASSES))
  rng = np.random.default_rng(6)
  a = ja.boxes.shape[0]
  cls_o = rng.standard_normal((2, a, cfg.num_classes)).astype(np.float32)
  box_o = (0.2 * rng.standard_normal((2, a, 4))).astype(np.float32)
  want = jlosses.detection_loss(jnp.asarray(cls_o), jnp.asarray(box_o), cls_t,
                                box_t, npos, cfg, anchor_boxes=ja.boxes)
  tcfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  tcfg.override(dict(iou_loss_type=iou_loss_type, label_smoothing=0.1))
  got = tlosses.detection_loss(
      torch.from_numpy(cls_o), torch.from_numpy(box_o),
      torch.from_numpy(np.array(cls_t)), torch.from_numpy(np.array(box_t)),
      torch.from_numpy(np.array(npos)), tcfg,
      anchor_boxes=torch.from_numpy(np.asarray(ja.boxes)))
  for g, w in zip(got, want):
    np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)
  assert (float(got[3]) > 0) == bool(iou_loss_type)


def test_det_train_preprocess_matches_jax():
  """The same three draws per image into both: images within atol 1e-3 of
  normalized values (a bilinear sample on a pixel edge may take the
  neighbour where the two f32 source coordinates differ in the last bit;
  at most 0.1% of the values), boxes within 1e-3 px, classes equal."""
  b, canvas, out = 3, 40, 32
  rng = np.random.default_rng(7)
  images = rng.integers(0, 256, (b, canvas, canvas, 3)).astype(np.uint8)
  true_hw = np.array([[40, 40], [40, 30], [25, 40]], np.float32)
  boxes = np.array([[[3.2, 4.1, 20.5, 30.3], [0, 0, 0, 0]]] * b, np.float32)
  classes = np.array([[2, -1]] * b, np.int32)
  keys = jax.random.split(jax.random.key(11), b)
  want = [jpre.det_train_preprocess(jnp.asarray(images[i], jnp.float32),
                                    jnp.asarray(boxes[i]),
                                    jnp.asarray(classes[i]), keys[i], out,
                                    true_hw=jnp.asarray(true_hw[i]))
          for i in range(b)]
  draws = []
  for k in keys:
    k1, k2, k3 = jax.random.split(k, 3)
    draws.append((bool(jax.random.bernoulli(k1)),
                  float(jax.random.uniform(k2, ())),
                  np.asarray(jax.random.uniform(k3, (2,)))))
  assert len({d[0] for d in draws}) == 2   # both flip branches
  flip = torch.tensor([d[0] for d in draws])
  jit = torch.tensor([d[1] for d in draws])
  off = torch.from_numpy(np.stack([d[2] for d in draws]))
  img, tb, tc = tpre.det_train_preprocess(
      torch.from_numpy(images), torch.from_numpy(boxes),
      torch.from_numpy(classes), flip, jit, off, out,
      true_hw=torch.from_numpy(true_hw))
  assert img.is_contiguous(memory_format=torch.channels_last)
  wimg = np.stack([np.asarray(w[0]) for w in want])
  diff = np.abs(_nhwc(img) - wimg)
  assert (diff > 1e-3).mean() <= 1e-3, diff.max()
  np.testing.assert_allclose(tb.numpy(), np.stack([np.asarray(w[1])
                                                   for w in want]), atol=1e-3)
  np.testing.assert_array_equal(tc.numpy(), np.stack([np.asarray(w[2])
                                                      for w in want]))


def test_detection_lr_clip_and_ema_match_jax():
  cfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  for method in ("cosine", "polynomial", "stepwise", "constant"):
    cfg.lr_decay_method = method
    tc = tdet_configs.get_efficientdet_config("efficientdet-test")
    tc.lr_decay_method = method
    jfn, tfn = jsched.detection_lr(cfg, 5), tsched.detection_lr(tc, 5)
    for step in (0, 1, 4, 5, 6, 100, 1400):
      np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6)
  rng = np.random.default_rng(8)
  grads = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 5,
           "b": rng.standard_normal(7).astype(np.float32)}
  want = jopt.clip_gradients(jax.tree_util.tree_map(jnp.asarray, grads), 3.0)
  got = topt.clip_gradients({k: torch.from_numpy(v) for k, v in grads.items()},
                            3.0)
  for k in grads:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
  ema = {k: v * 0.5 for k, v in grads.items()}
  for step in (0, 3, 10000):
    w = jopt.ema_update(jax.tree_util.tree_map(jnp.asarray, ema),
                        jax.tree_util.tree_map(jnp.asarray, grads), 0.9998,
                        step)
    t = topt.ema_update({k: torch.from_numpy(v.copy()) for k, v in
                         ema.items()},
                        {k: torch.from_numpy(v) for k, v in grads.items()},
                        0.9998, step)
    for k in grads:
      np.testing.assert_allclose(t[k].numpy(), np.asarray(w[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------


def _train_batch():
  rng = np.random.default_rng(9)
  image = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
  return ({"image": jnp.asarray(image), "gt_boxes": jnp.asarray(GT_BOXES),
           "gt_classes": jnp.asarray(GT_CLASSES)},
          {"image": _nchw(image).contiguous(memory_format=torch.channels_last),
           "gt_boxes": torch.from_numpy(GT_BOXES),
           "gt_classes": torch.from_numpy(GT_CLASSES)})


# Metrics rtol 1e-4 (f32 through the model and the backward); parameters,
# EMA, BN statistics and the momentum after a step atol 2e-5, rtol 1e-4.
STEP_TOL = dict(atol=2e-5, rtol=1e-4)


def _check_state(tstate, jstate, what):
  _assert_trees_close(convert.det_torch_to_jax_tree(tstate.params),
                      jstate.params, what=f"{what} params", **STEP_TOL)
  _assert_trees_close(convert.det_torch_to_jax_tree(tstate.ema_params),
                      jstate.ema_params, what=f"{what} ema", **STEP_TOL)
  carried = convert.det_state_to_jax(tstate)
  _assert_trees_close(carried["trace"], jstate.opt_state.inner_state[0].trace,
                      what=f"{what} momentum", **STEP_TOL)
  sched = jstate.opt_state.inner_state[1]
  if "count" in getattr(sched, "_fields", ()):   # a schedule, not a constant
    assert carried["count"] == int(sched.count)
  assert tstate.step == int(jstate.step)


def test_det_train_step_matches_jax_two_steps(no_drop_connect):
  """Two make_det_train_step steps on efficientdet-test with the K6 knob on
  (the CPU tensors take the plain K6; JAX computes dW with XLA on the CPU):
  loss and every metric, every parameter, the EMA (BN statistics
  included), the BN statistics and the momentum after each step. Then the
  JAX state after step 1 carried into a fresh port model
  (det_state_from_jax) takes step 2 to JAX's state after step 2."""
  jcfg, tcfg, jm, jparams, tm, tree = _det_pair()
  jlr, tlr = jsched.detection_lr(jcfg, 1), tsched.detection_lr(tcfg, 1)
  jtx = jopt.masked_for_params(jopt.build_optimizer("momentum", jlr,
                                                    momentum=0.9), jparams)
  ttx = topt.masked_for_params(topt.build_optimizer("momentum", tlr,
                                                    momentum=0.9))
  jstep = jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))
  jstate = jtrain.create_train_state(jparams, jtx)
  jbatch, tbatch = _train_batch()
  tstep = ttrain.make_det_train_step(tm, ttx, tcfg)
  tstate = ttrain.create_train_state(tm, ttx)
  calls = []
  ref = tdw.depthwise_filter_grad_reference
  tdw.enable_pallas_filter_grad(True)
  try:
    tdw.depthwise_filter_grad_reference = lambda *a: calls.append(1) or ref(*a)
    jstates = []
    for i in range(2):
      jstate, jmetrics = jstep(jstate, jbatch, jax.random.key(2))
      jstates.append(jstate)
      tstate, tmetrics = tstep(tstate, tbatch, torch.Generator())
      assert set(tmetrics) == set(jmetrics)
      for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
      _check_state(tstate, jstate, f"step {i + 1}")
    # One stride-1 block in the test backbone, 8 BiFPN nodes, 2 heads x 5
    # levels x (1 repeat + the predict conv): 29 per step.
    per_step = tdet.filter_grad_calls_per_step(tm)
    assert per_step == 1 + 8 + 2 * 5 * 2
    assert len(calls) == 2 * per_step

    carried = convert.det_state_to_jax(tstate)
    assert carried["step"] == 2
    tm2 = tdet.EfficientDet(tcfg)
    j1 = jax.tree_util.tree_map(np.asarray, jstates[0])
    state2 = convert.det_state_from_jax(
        tm2, j1.step, j1.params, j1.opt_state.inner_state[0].trace,
        j1.opt_state.inner_state[1].count, j1.ema_params)
    step2 = ttrain.make_det_train_step(tm2, ttx, tcfg)
    state2, _ = step2(state2, tbatch, torch.Generator())
    _check_state(state2, jstates[1], "carried step 2")
    assert len(calls) == 3 * per_step
  finally:
    tdw.depthwise_filter_grad_reference = ref
    tdw.enable_pallas_filter_grad(False)


# Teacher-forced steps: the largest absolute difference after any step.
# Parameters and EMA: STEP_TOL's atol. The momentum (a step's gradient plus
# 0.9 of the last) is ill-conditioned here: JAX from parameters perturbed
# by 1e-7 (relative) moves it by up to 9.8e-5 at step 1; the limit is 2x
# that.
FORCED_ATOL = dict(param=2e-5, ema=2e-5, momentum=2e-4)


def _det_batch(i):
  """Batch i of the trajectory: 2 images made with numpy, GT_BOXES."""
  image = np.random.default_rng(60 + i).standard_normal(
      (2, 64, 64, 3)).astype(np.float32)
  return ({"image": jnp.asarray(image), "gt_boxes": jnp.asarray(GT_BOXES),
           "gt_classes": jnp.asarray(GT_CLASSES)},
          {"image": _nchw(image).contiguous(memory_format=torch.channels_last),
           "gt_boxes": torch.from_numpy(GT_BOXES),
           "gt_classes": torch.from_numpy(GT_CLASSES)})


def _max_diff(got, want):
  got, want = _flat(got), _flat(want)
  return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


@pytest.mark.slow
def test_det_momentum_trajectory_with_ema_and_k6_matches_jax(
    no_drop_connect, record_property):
  """10 make_det_train_step steps on efficientdet-test (momentum SGD at the
  config's schedule, gradient clipping, EMA) with the K6 knob on (the
  port's CPU tensors take the plain K6 at every stride-1 depthwise filter
  gradient), from one converted parameter tree and 10 batches made with
  numpy, against automl_tpu/train/train_lib.py::make_det_train_step (JAX
  takes XLA's filter gradient on the CPU).

  Teacher-forced: each step starts from JAX's state before it, carried into
  the port (det_state_from_jax), and must give JAX's loss (rtol 1e-5) and
  JAX's parameters, EMA (BN statistics included) and momentum after it
  (FORCED_ATOL), so that no step's error is hidden by or blamed on an
  earlier one. Free-running, the
  two trajectories part: at batch 2 the BN moments of the 4 x 4 to 1 x 1
  maps amplify f32 rounding about tenfold a step, so JAX from parameters
  perturbed by 1e-7 (relative) parts from JAX as much. The free-running
  port must match JAX's loss at steps 1-3 (rtol 1e-5) and stay within 10x
  of that perturbed JAX's distance, in the largest relative loss
  difference and in the largest parameter difference after 10 steps. The
  distances are recorded as properties (--junitxml, junit_family xunit1);
  ROADMAP Queue 3 item 2."""
  steps = 10
  jcfg, tcfg, jm, jparams, tm, _ = _det_pair(seed=3)
  jlr, tlr = jsched.detection_lr(jcfg, 1), tsched.detection_lr(tcfg, 1)
  jtx = jopt.masked_for_params(jopt.build_optimizer("momentum", jlr,
                                                    momentum=0.9), jparams)
  ttx = topt.masked_for_params(topt.build_optimizer("momentum", tlr,
                                                    momentum=0.9))
  jstep = jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))
  tstep = ttrain.make_det_train_step(tm, ttx, tcfg)

  def run_jax(params):
    state, losses, states = jtrain.create_train_state(params, jtx), [], []
    for i in range(steps):
      states.append(state)
      state, metrics = jstep(state, _det_batch(i)[0], jax.random.key(2))
      losses.append(float(metrics["loss"]))
    return states + [state], losses

  jstates, jloss = run_jax(jparams)
  rng = np.random.default_rng(5)
  perturbed = jax.tree_util.tree_map(
      lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(
          a.dtype), jparams)
  pstates, ploss = run_jax(perturbed)

  calls = []
  ref = tdw.depthwise_filter_grad_reference
  tdw.enable_pallas_filter_grad(True)
  try:
    tdw.depthwise_filter_grad_reference = lambda *a: calls.append(1) or ref(*a)
    tstate, tloss = ttrain.create_train_state(tm, ttx), []
    for i in range(steps):
      tstate, metrics = tstep(tstate, _det_batch(i)[1], torch.Generator())
      tloss.append(float(metrics["loss"]))
    free = tstate
    forced_rel, forced = 0.0, []
    tm2 = tdet.EfficientDet(tcfg)
    step2 = ttrain.make_det_train_step(tm2, ttx, tcfg)
    for i in range(steps):
      j = jax.tree_util.tree_map(np.asarray, jstates[i])
      state = convert.det_state_from_jax(
          tm2, j.step, j.params, j.opt_state.inner_state[0].trace,
          j.opt_state.inner_state[1].count, j.ema_params)
      state, metrics = step2(state, _det_batch(i)[1], torch.Generator())
      forced_rel = max(forced_rel, abs(float(metrics["loss"]) - jloss[i])
                       / abs(jloss[i]))
      np.testing.assert_allclose(float(metrics["loss"]), jloss[i], rtol=1e-5,
                                 err_msg=f"step {i + 1}")
      want = jstates[i + 1]
      carried = convert.det_state_to_jax(state)
      forced.append((
          _max_diff(convert.det_torch_to_jax_tree(state.params), want.params),
          _max_diff(convert.det_torch_to_jax_tree(state.ema_params),
                    want.ema_params),
          _max_diff(carried["trace"], want.opt_state.inner_state[0].trace)))
  finally:
    tdw.depthwise_filter_grad_reference = ref
    tdw.enable_pallas_filter_grad(False)
  assert len(calls) == 2 * steps * tdet.filter_grad_calls_per_step(tm)

  rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
  free_param = _max_diff(convert.det_torch_to_jax_tree(free.params),
                         jstates[-1].params)
  floor_param = _max_diff(pstates[-1].params, jstates[-1].params)
  record_property("teacher_forced_max_rel_loss_diff", forced_rel)
  for name, col in (("param", 0), ("ema", 1), ("momentum", 2)):
    worst = max(f[col] for f in forced)
    record_property(f"teacher_forced_max_{name}_diff", worst)
    assert worst <= FORCED_ATOL[name], (name, worst)
  record_property("free_max_rel_loss_diff", rel(tloss, jloss))
  record_property("free_max_param_diff", free_param)
  record_property("free_max_ema_diff", _max_diff(
      convert.det_torch_to_jax_tree(free.ema_params), jstates[-1].ema_params))
  record_property("jax_perturbed_max_rel_loss_diff", rel(ploss, jloss))
  record_property("jax_perturbed_max_param_diff", floor_param)
  np.testing.assert_allclose(tloss[:3], jloss[:3], rtol=1e-5)
  assert rel(tloss, jloss) <= 10 * rel(ploss, jloss)
  assert free_param <= 10 * floor_param


def test_det_train_step_options_match_jax(no_drop_connect):
  """One step with the moving positives normalizer (positives_momentum),
  the FGSM neighbour loss (adv_multiplier) and var_freeze_expr on the stem,
  against JAX's; tolerances as the plain step's. The frozen stem moves only
  by its momentum (zero on step 1)."""
  opts = dict(positives_momentum=0.9, adv_multiplier=0.5, adv_step_size=0.05,
              var_freeze_expr="backbone/stem/.*")
  jcfg, tcfg, jm, jparams, tm, _ = _det_pair(**opts)
  jtx = jopt.masked_for_params(jopt.build_optimizer("momentum", 1e-2),
                               jparams)
  ttx = topt.masked_for_params(topt.build_optimizer("momentum", 1e-2))
  jstate = jtrain.create_train_state(jparams, jtx, moving_normalizer=True)
  jstate, jmetrics = jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))(
      jstate, _train_batch()[0], jax.random.key(2))
  tstate = ttrain.create_train_state(tm, ttx, moving_normalizer=True)
  stem_before = tm.backbone.stem.conv2d.kernel.detach().clone()
  tstate, tmetrics = ttrain.make_det_train_step(tm, ttx, tcfg)(
      tstate, _train_batch()[1], torch.Generator())
  for k in jmetrics:
    np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                               rtol=1e-4, atol=1e-6, err_msg=k)
  np.testing.assert_allclose(float(tstate.normalizer),
                             float(jstate.normalizer), rtol=1e-6)
  torch.testing.assert_close(tm.backbone.stem.conv2d.kernel, stem_before,
                             rtol=0, atol=0)
  _check_state(tstate, jstate, "options step")


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_det_train_step_with_adam_or_rmsprop_matches_jax(name,
                                                         no_drop_connect):
  """One detection step with config.optimizer adam (and rmsprop), as
  run_detection builds it, against JAX's: metrics rtol 1e-4; the
  optimizer's moments, parameters and EMA within STEP_TOL. Adam's first
  update is lr * g / (|g| + 1e-8): on the leaves whose gradient is zero
  but for rounding (a bias or BN beta that a train-mode BN normalizes
  away: |g| < 1e-6, a rounding of sums of order 1), it is lr times the sign of
  that rounding, another in each program; there only the moments are
  held."""
  jcfg, tcfg, jm, jparams, tm, _ = _det_pair(optimizer=name)
  jtx = jopt.masked_for_params(jopt.build_optimizer(jcfg.optimizer, 1e-3),
                               jparams)
  ttx = topt.masked_for_params(topt.build_optimizer(tcfg.optimizer, 1e-3))
  jstate = jtrain.create_train_state(jparams, jtx)
  jstate, jmetrics = jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))(
      jstate, _train_batch()[0], jax.random.key(2))
  tstate = ttrain.create_train_state(tm, ttx)
  tstate, tmetrics = ttrain.make_det_train_step(tm, ttx, tcfg)(
      tstate, _train_batch()[1], torch.Generator())
  for k in jmetrics:
    np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                               rtol=1e-4, atol=1e-6, err_msg=k)
  inner = jstate.opt_state.inner_state[0]
  moments = ("mu", "nu") if name == "adam" else ("nu",)
  for m in moments:
    _assert_trees_close(
        convert.det_torch_to_jax_tree(tstate.opt_state[0][m]),
        getattr(inner, m), what=m, **STEP_TOL)
  noise = set()
  if name == "adam":   # |mu| = 0.1 |g| on step 1
    noise = {k for k, v in _flat(inner.mu).items()
             if 0 < np.abs(v).max() < 1e-7}
    assert len(noise) < len(_flat(inner.mu)) // 4
  for got, want, what in (
      (tstate.params, jstate.params, "params"),
      (tstate.ema_params, jstate.ema_params, "ema")):
    got = _flat(convert.det_torch_to_jax_tree(got))
    for k, v in _flat(want).items():
      if k not in noise:
        np.testing.assert_allclose(got[k], v, err_msg=f"{what}: {k}",
                                   **STEP_TOL)


def test_det_grid_mask_preprocess_matches_jax():
  """grid_mask: JAX's run_detection preprocess (gridmask with fill 1 on
  each canvas, then det_train_preprocess) and the port's from JAX's draws;
  images as test_det_train_preprocess_matches_jax's (atol 1e-3, at most
  0.1% of the values), boxes atol 1e-3, classes equal. The port's
  make_preprocess with grid_mask on runs the mask (its output differs from
  grid_mask off on the same draws)."""
  b, canvas, out = 3, 40, 32
  rng = np.random.default_rng(12)
  images = rng.integers(0, 256, (b, canvas, canvas, 3)).astype(np.uint8)
  true_hw = np.full((b, 2), canvas, np.float32)
  boxes = np.array([[[3.2, 4.1, 20.5, 30.3], [0, 0, 0, 0]]] * b, np.float32)
  classes = np.array([[2, -1]] * b, np.int32)
  from automl_tpu.data import augment as jaug
  from automl_tpu_torch.data import augment as taug
  key = jax.random.key(4)
  gkeys = jax.random.split(jax.random.fold_in(key, 11), b)
  masked = jax.vmap(jaug.gridmask)(jnp.asarray(images, jnp.float32), gkeys)
  keys = jax.random.split(key, b)
  want = jax.vmap(lambda im, bx, c, hw, k: jpre.det_train_preprocess(
      im, bx, c, k, out, true_hw=hw))(masked, jnp.asarray(boxes),
                                       jnp.asarray(classes),
                                       jnp.asarray(true_hw), keys)
  d, offs = [], []
  for k in gkeys:
    k1, k2, k3 = jax.random.split(k, 3)
    dd = int(jax.random.randint(k1, (), canvas // 8, canvas // 2))
    d.append(dd)
    offs.append([int(jax.random.randint(k2, (), 0, dd)),
                 int(jax.random.randint(k3, (), 0, dd))])
  draws = []
  for k in keys:
    k1, k2, k3 = jax.random.split(k, 3)
    draws.append((bool(jax.random.bernoulli(k1)),
                  float(jax.random.uniform(k2, ())),
                  np.asarray(jax.random.uniform(k3, (2,)))))
  tmasked = taug.gridmask(torch.from_numpy(images).float(),
                          {"d": torch.tensor(d), "offset": torch.tensor(offs)})
  np.testing.assert_array_equal(tmasked.numpy(), np.asarray(masked))
  img, tb, tc = tpre.det_train_preprocess(
      tmasked, torch.from_numpy(boxes), torch.from_numpy(classes),
      torch.tensor([x[0] for x in draws]), torch.tensor([x[1] for x in draws]),
      torch.from_numpy(np.stack([x[2] for x in draws])), out,
      true_hw=torch.from_numpy(true_hw))
  diff = np.abs(_nhwc(img) - np.asarray(want[0]))
  assert (diff > 1e-3).mean() <= 1e-3, diff.max()
  np.testing.assert_allclose(tb.numpy(), np.asarray(want[1]), atol=1e-3)
  np.testing.assert_array_equal(tc.numpy(), np.asarray(want[2]))
  cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  batch = {"image": torch.from_numpy(images),
           "gt_boxes": torch.from_numpy(boxes),
           "gt_classes": torch.from_numpy(classes),
           "true_hw": torch.from_numpy(true_hw)}
  plain = trunners.make_preprocess(cfg)(batch,
                                        torch.Generator().manual_seed(0))
  cfg.grid_mask = True
  gridded = trunners.make_preprocess(cfg)(batch,
                                          torch.Generator().manual_seed(0))
  assert gridded["image"].shape == plain["image"].shape
  assert not torch.equal(gridded["image"], plain["image"])


def test_main_det_trains_with_grid_mask(tmp_path):
  out = tcli.main(["--model_name=efficientdet-test", "--device=cpu",
                   f"--model_dir={tmp_path}", "--use_fake_data",
                   "--train_steps=1", "--hparams=grid_mask=true"])
  assert np.isfinite(out["loss"])


@pytest.mark.slow
def test_d0_step_matches_jax_full_size(no_drop_connect):
  """One D0 step at 512 x 512, b4, on a batch from the port's
  det_train_preprocess (jitter and crop, which make the initial loss large
  in both): the metrics within rtol 1e-3 (f32 drift through D0's depth)."""
  jcfg, tcfg, jm, jparams, tm, _ = _det_pair("efficientdet-d0")
  raw = {k: torch.from_numpy(v) for k, v in tpipeline.SyntheticDetection(
      4, 512, 100, 90).batch.items()}
  from automl_tpu_torch.train import runners as trunners
  tb = trunners.make_preprocess(tcfg)(raw, torch.Generator().manual_seed(7))
  jb = {"image": jnp.asarray(_nhwc(tb["image"])),
        "gt_boxes": jnp.asarray(tb["gt_boxes"].numpy()),
        "gt_classes": jnp.asarray(tb["gt_classes"].numpy())}
  jtx = jopt.masked_for_params(jopt.build_optimizer("momentum", 1e-3),
                               jparams)
  _, jm_ = jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))(
      jtrain.create_train_state(jparams, jtx), jb, jax.random.key(0))
  ttx = topt.masked_for_params(topt.build_optimizer("momentum", 1e-3))
  _, tm_ = ttrain.make_det_train_step(tm, ttx, tcfg)(
      ttrain.create_train_state(tm, ttx), tb, torch.Generator())
  for k in jm_:
    np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-3,
                               atol=1e-5, err_msg=k)


def test_main_det_on_cpu_trains_and_resumes(tmp_path):
  """cli/main_det on efficientdet-test: finite losses in metrics.jsonl, a
  checkpoint, and a rerun to 5 steps resumes from step 4."""
  d = str(tmp_path / "det")
  flags = ["--model_name=efficientdet-test", f"--model_dir={d}",
           "--use_fake_data", "--device=cpu", "--log_every=1"]
  out = tcli.main(flags + ["--train_steps=4"])
  assert np.isfinite(out["loss"])
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  assert [r["step"] for r in recs] == [1, 2, 3, 4]
  assert all(np.isfinite(r["loss"]) for r in recs)
  assert os.path.exists(os.path.join(d, "ckpt", "4", "state.pt"))
  assert os.path.exists(os.path.join(d, "config.yaml"))
  tcli.main(flags + ["--train_steps=5"])
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]


def test_synthetic_detection_matches_jax():
  from automl_tpu.data import pipeline as jpipeline
  want = jpipeline.SyntheticDetection(3, 64, 10, 5).batch
  got = tpipeline.SyntheticDetection(3, 64, 10, 5).batch
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])


# Each refused flag and the ROADMAP item its message names.
UNPORTED_FLAGS = {"--mesh_shape=1,2,1": "the world has 1"}


@pytest.mark.parametrize("flag", list(UNPORTED_FLAGS))
def test_unported_options_raise(flag, tmp_path):
  """A mesh that does not cover the world's processes (one here) is
  refused before anything starts, as JAX's create_mesh refuses a mesh
  that does not cover its devices."""
  with pytest.raises(ValueError, match=UNPORTED_FLAGS[flag]):
    tcli.main(["--model_name=efficientdet-test", "--device=cpu",
               f"--model_dir={tmp_path}", "--train_steps=1", flag])


def test_main_det_train_and_eval_without_val_files_trains(tmp_path):
  """--mode=train_and_eval --eval_every=1 with no val files trains and
  evaluates nothing, as JAX's CLI does."""
  d = str(tmp_path / "det")
  out = tcli.main(["--model_name=efficientdet-test", f"--model_dir={d}",
                   "--use_fake_data", "--device=cpu", "--log_every=1",
                   "--train_steps=2", "--mode=train_and_eval",
                   "--eval_every=1"])
  assert np.isfinite(out["loss"]) and "AP" not in out
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  assert [r["step"] for r in recs] == [1, 2]
  assert not any(k.startswith("eval/") for r in recs for k in r)
  assert os.path.exists(os.path.join(d, "ckpt", "2", "state.pt"))
