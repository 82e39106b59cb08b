"""automl_tpu_torch's detection postprocess against automl_tpu's on the CPU.

NMS (the four methods, batched and per class), nms_params, the top-k's
order among tied scores, generate_detections fed JAX's own raw
efficientdet-test outputs (teacher-forced), transform_detections,
clip_boxes, decode_anchors_to_centersize and det_eval_preprocess. The
same numpy inputs go to both packages; tolerances are stated per test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu import nn as jnn
from automl_tpu.configs import efficientdet_configs as jdet_configs
from automl_tpu.data import preprocessing as jpre
from automl_tpu.models import efficientdet as jdet
from automl_tpu.ops import anchors as janchors
from automl_tpu.ops import nms as jnms
from automl_tpu.ops import postprocess as jpost
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.data import preprocessing as tpre
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import anchors as tanchors
from automl_tpu_torch.ops import nms as tnms
from automl_tpu_torch.ops import postprocess as tpost

torch.set_num_threads(1)
NEG = float("-inf")

# method: (iou_thresh, sigma, score_thresh), nms_params's defaults.
NMS_CASES = {
    "hard": (0.5, 0.0, NEG),
    "gaussian": (0.5, 0.5, 0.001),
    "linear": (0.3, 0.0, 0.001),
    "diou": (0.5, 0.0, NEG),
}


@pytest.fixture(autouse=True)
def f32_policy():
  jnn.set_policy("float32")
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def _random_boxes(rng, n, lo=0.0, extent=300.0):
  """[n, 4] pixel boxes in [lo, lo + 1.3 extent), sides 3-30% of extent."""
  yx = rng.uniform(lo, lo + extent, (n, 2))
  hw = rng.uniform(0.03, 0.3, (n, 2)) * extent
  return np.concatenate([yx, yx + hw], axis=1).astype(np.float32)


def _tie_free_scores(rng, b, n):
  """[b, n] distinct scores in (0, 1), the last 5 of each row padding
  (-inf)."""
  s = (rng.permutation(b * n) + 1).reshape(b, n) / (b * n + 1.0)
  s = s.astype(np.float32)
  s[:, -5:] = NEG
  return s


def _assert_nms_close(got, want, exact, what):
  """Hard / diou (exact): indices, scores and valid equal. Soft methods:
  valid equal, scores within rtol 1e-5, indices equal wherever a score
  is separated from its neighbours by more than 1e-5 relative (a closer
  pair may come out in either order)."""
  (ti, ts, tv), (ji, js, jv) = [tuple(np.asarray(x) for x in o)
                                for o in (got, want)]
  np.testing.assert_array_equal(tv, jv, err_msg=what)
  if exact:
    np.testing.assert_array_equal(ti, ji, err_msg=what)
    np.testing.assert_array_equal(ts, js, err_msg=what)
    return
  np.testing.assert_allclose(ts[jv], js[jv], rtol=1e-5, err_msg=what)
  gap = np.abs(np.diff(js)) > 1e-5 * np.abs(js[1:])
  sep = np.ones_like(jv)
  sep[1:] &= gap
  sep[:-1] &= gap
  keep = sep & jv
  assert keep.sum() >= jv.sum() // 2, what
  np.testing.assert_array_equal(ti[keep], ji[keep], err_msg=what)


@pytest.mark.parametrize("n", [200, 500])
@pytest.mark.parametrize("method", list(NMS_CASES))
def test_nms_matches_jax(method, n):
  """batched_nms over 3 images (and nms on one) against JAX's nms per
  image: N 200 / 500 tie-free pixel boxes, 5 padding rows, max_output 50;
  tolerances in _assert_nms_close."""
  iou, sigma, thresh = NMS_CASES[method]
  rng = np.random.default_rng(n + len(method))
  boxes = np.stack([_random_boxes(rng, n) for _ in range(3)])
  scores = _tie_free_scores(rng, 3, n)
  got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         50, iou, sigma, thresh, method)
  exact = method in ("hard", "diou")
  for i in range(3):
    want = jnms.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 50, iou,
                    sigma, thresh, method)
    assert int(np.asarray(want[2]).sum()) > 5
    _assert_nms_close([t[i] for t in got], want, exact, f"image {i}")
  one = tnms.nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 50,
                 iou, sigma, thresh, method)
  for a, b in zip(one, got):
    np.testing.assert_array_equal(a.numpy(), b[0].numpy())


@pytest.mark.parametrize("method", list(NMS_CASES))
def test_per_class_nms_matches_jax_per_image_extents(method):
  """Per-class NMS on a batch whose images have very different extents:
  image 0 has negative coordinates within +-60 px, image 1 spans 2e6 px,
  90 classes. Each image is rebased by its own minimum and span, as JAX's
  vmap does: a rebase over the whole batch would shift image 0's class
  bands by multiples of 2e6, where a float32 step is 16 px, and change its
  IoUs. Tolerances as test_nms_matches_jax."""
  iou, sigma, thresh = NMS_CASES[method]
  rng = np.random.default_rng(7)
  n = 300
  boxes = np.stack([_random_boxes(rng, n, lo=-60.0, extent=90.0),
                    _random_boxes(rng, n, lo=0.0, extent=2e6)])
  scores = _tie_free_scores(rng, 2, n)
  classes = rng.integers(0, 90, (2, n)).astype(np.int32)
  # image 0: three dense classes (suppression happens) with large ids, so
  # a batch-wide span would push their bands far out
  classes[0] = rng.integers(87, 90, n)
  got = tnms.per_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(classes), 50, iou, sigma, thresh,
                           method)
  exact = method in ("hard", "diou")
  for i in range(2):
    want = jnms.per_class_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                              jnp.asarray(classes[i]), 50, iou, sigma, thresh,
                              method)
    _assert_nms_close([t[i] for t in got], want, exact, f"image {i}")
    one = tnms.per_class_nms(torch.from_numpy(boxes[i]),
                             torch.from_numpy(scores[i]),
                             torch.from_numpy(classes[i]), 50, iou, sigma,
                             thresh, method)
    _assert_nms_close(one, want, exact, f"image {i} alone")


def test_nms_rejects_unknown_method():
  with pytest.raises(ValueError, match="Unknown NMS method"):
    tnms.nms(torch.zeros((4, 4)), torch.zeros(4), 2, method="soft")


def _cfg_pair(name="efficientdet-test", **overrides):
  jcfg = jdet_configs.get_efficientdet_config(name)
  tcfg = tdet_configs.get_efficientdet_config(name)
  for c in (jcfg, tcfg):
    c.override(overrides, allow_new_keys=True)
  return jcfg, tcfg


@pytest.mark.parametrize("nms_configs", [
    {}, dict(method="hard"), dict(method=None), dict(method=""),
    dict(method="hard", iou_thresh=0.6, score_thresh=0.2),
    dict(method="gaussian", sigma=0.3, score_thresh=0.05),
    dict(method="linear"), dict(method="linear", iou_thresh=0.4),
    dict(method="diou"), dict(method="diou", score_thresh=0.05),
    dict(max_output_size=50), dict(max_nms_inputs=200)],
    ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "default")
def test_nms_params_match_jax(nms_configs):
  """nms_params equal to JAX's for every method, its `or` defaults
  included (the config's score_thresh 0.0 -> 0.001 for gaussian)."""
  jcfg, tcfg = _cfg_pair(nms_configs=nms_configs)
  assert tpost.nms_params(tcfg) == jpost.nms_params(jcfg)


def test_nms_params_reject_unknown_method():
  _, tcfg = _cfg_pair(nms_configs=dict(method="soft"))
  with pytest.raises(ValueError, match="Invalid nms method"):
    tpost.nms_params(tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nms_configs", [dict(pre_nms_topk=100),
                                         dict(max_nms_inputs=150)])
def test_topk_class_boxes_ties_match_jax(nms_configs, dtype):
  """Class outputs on a 1/2 grid, so most scores tie: the same scores,
  indices, classes and boxes as JAX, i.e. jax.lax.top_k's and jnp.argmax's
  order among ties (the lower index first). Exact."""
  jcfg, tcfg = _cfg_pair(nms_configs=nms_configs)
  rng = np.random.default_rng(3)
  cls = (rng.integers(-4, 4, (2, 774, 3)) * 0.5).astype(np.float32)
  box = (0.1 * rng.standard_normal((2, 774, 4))).astype(np.float32)
  want = jpost.topk_class_boxes(jcfg, jnp.asarray(cls, dtype),
                                jnp.asarray(box, dtype))
  got = tpost.topk_class_boxes(tcfg, torch.from_numpy(cls).to(
      getattr(torch, dtype)), torch.from_numpy(box).to(getattr(torch, dtype)))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.float().numpy(),
                                  np.asarray(w).astype(np.float32))


# ---------------------------------------------------------------------------
# generate_detections, teacher-forced on JAX's raw outputs.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_raw_outputs():
  """JAX's efficientdet-test eval-mode class and box outputs on 2 random
  images, its class-predict bias zeroed so the scores spread around 0.5
  (NHWC per level, numpy)."""
  jnn.set_policy("float32")
  try:
    cfg = jdet_configs.get_efficientdet_config("efficientdet-test")
    model = jdet.EfficientDet(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    pointwise = params["class_net"]["class-predict"]["pointwise"]
    pointwise["bias"] = jnp.zeros_like(pointwise["bias"])
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3))
    cls, box = jax.jit(lambda p, x: model(p, x, False))(
        params, jnp.asarray(x, jnp.float32))
    return [np.asarray(c) for c in cls], [np.asarray(b) for b in box]
  finally:
    jnn.set_policy("mixed_bfloat16")


def _nchw(levels):
  return [torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in levels]


POSTPROCESS = {"global": "postprocess_global",
               "per_class": "postprocess_per_class",
               "combined": "postprocess_combined"}


def _assert_boxes_close(got, want, what=""):
  """Box coordinates within 4 float32 steps of the largest coordinate:
  XLA's CPU exp is not correctly rounded (it differs from torch's in the
  last bit for ~9% of inputs), so decoded boxes differ by a step or two
  of the centre and size they are summed from."""
  want = np.asarray(want)
  atol = 4 * float(np.spacing(np.float32(np.abs(want).max())))
  np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                             err_msg=what)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("kind", list(POSTPROCESS))
def test_postprocess_teacher_forced_matches_jax(jax_raw_outputs, kind, tied,
                                                scaled):
  """postprocess_global / _per_class / _combined and generate_detections
  on JAX's own raw outputs (converted to NCHW): valid_len equal, scores
  and classes within atol 1e-6, boxes as _assert_boxes_close (the
  config's gaussian NMS for global and per-class, hard for combined).
  `tied` rounds the class outputs to 1/8, so most scores tie, and caps
  pre_nms_topk at 128 of the 774 anchors: the top-k must keep JAX's order
  among ties."""
  cls, box = jax_raw_outputs
  overrides = {}
  if tied:
    cls = [np.round(c * 8) / 8 for c in cls]
    overrides = dict(nms_configs=dict(pre_nms_topk=128))
  jcfg, tcfg = _cfg_pair(**overrides)
  scales = np.array([1.5, 0.75], np.float32) if scaled else None
  fn = POSTPROCESS[kind]
  want = getattr(jpost, fn)(jcfg, [jnp.asarray(c) for c in cls],
                            [jnp.asarray(b) for b in box], scales)
  got = getattr(tpost, fn)(tcfg, _nchw(cls), _nchw(box), scales)
  np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
  assert int(got[3].min()) > 10
  _assert_boxes_close(got[0].numpy(), want[0], "boxes")
  for g, w in zip(got[1:3], want[1:3]):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
  if kind != "combined":
    ids = np.array([7, 8])
    jd, jv = jpost.generate_detections(
        jcfg, [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
        scales, ids, per_class=kind == "per_class")
    td, tv = tpost.generate_detections(tcfg, _nchw(cls), _nchw(box), scales,
                                       ids, per_class=kind == "per_class")
    jd = np.asarray(jd)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _assert_boxes_close(td[..., 1:5].numpy(), jd[..., 1:5], "dets")
    np.testing.assert_allclose(td.numpy()[..., [0, 5, 6]],
                               jd[..., [0, 5, 6]], rtol=0, atol=1e-6)
    jt = np.asarray(jpost.transform_detections(jnp.asarray(jd)))
    np.testing.assert_array_equal(
        tpost.transform_detections(torch.from_numpy(jd.copy())).numpy(), jt)


def test_pre_nms_without_topk_matches_jax(jax_raw_outputs):
  """pre_nms(topk=False): every anchor with its best class; boxes as
  _assert_boxes_close, scores within 1e-6, classes exact."""
  cls, box = jax_raw_outputs
  jcfg, tcfg = _cfg_pair()
  want = jpost.pre_nms(jcfg, [jnp.asarray(c) for c in cls],
                       [jnp.asarray(b) for b in box], topk=False)
  got = tpost.pre_nms(tcfg, _nchw(cls), _nchw(box), topk=False)
  _assert_boxes_close(got[0].numpy(), want[0])
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                             atol=1e-6)
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_postprocess_combined_leaves_the_config_alone():
  _, tcfg = _cfg_pair()
  before = copy.deepcopy(tcfg.nms_configs)
  rng = np.random.default_rng(0)
  cls = [torch.from_numpy(rng.standard_normal((1, 27, s, s)).astype(
      np.float32)) for s in (8, 4, 2, 1, 1)]
  box = [torch.from_numpy(0.1 * rng.standard_normal((1, 36, s, s)).astype(
      np.float32)) for s in (8, 4, 2, 1, 1)]
  tpost.postprocess_combined(tcfg, cls, box)
  assert tcfg.nms_configs == before


# ---------------------------------------------------------------------------
# Boxes and the eval resize.
# ---------------------------------------------------------------------------


def test_clip_and_transform_and_centersize_match_jax():
  """clip_boxes (an int size and a 'WxH' string), transform_detections and
  decode_anchors_to_centersize: exact."""
  rng = np.random.default_rng(1)
  boxes = rng.uniform(-40, 700, (2, 30, 4)).astype(np.float32)
  for size in (512, "640x384"):
    np.testing.assert_array_equal(
        tpost.clip_boxes(torch.from_numpy(boxes), size).numpy(),
        np.asarray(jpost.clip_boxes(jnp.asarray(boxes), size)))
  dets = rng.uniform(0, 100, (2, 30, 7)).astype(np.float32)
  np.testing.assert_array_equal(
      tpost.transform_detections(torch.from_numpy(dets)).numpy(),
      np.asarray(jpost.transform_detections(jnp.asarray(dets))))
  anchors = tanchors.Anchors(3, 7, 3, [1.0, 2.0, 0.5], 4.0, 64).boxes
  pred = torch.zeros((2, anchors.shape[0], 4))
  np.testing.assert_array_equal(
      tanchors.decode_anchors_to_centersize(pred, anchors).numpy(),
      np.asarray(janchors.decode_anchors_to_centersize(
          jnp.asarray(pred.numpy()), jnp.asarray(anchors.numpy()))))


@pytest.mark.parametrize("hw,out", [((30, 40), 64), ((200, 150), 64),
                                    ((636, 500), 256), ((48, 48), 48)],
                         ids=["upscale", "downscale", "f32_truncation",
                              "same_size"])
def test_det_eval_preprocess_matches_jax(hw, out):
  """The eval resize against JAX's (jax.image.resize, antialias off):
  values within atol 2e-6 (another order of the two-tap sums), the scale
  exact; h 636 -> 256 truncates to 255 rows, the rest zero padding."""
  rng = np.random.default_rng(hw[0])
  img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
  want, want_scale = jpre.det_eval_preprocess(jnp.asarray(img), out)
  got, got_scale = tpre.det_eval_preprocess(torch.from_numpy(img), out)
  assert got.shape == (out, out, 3)
  assert got_scale == want_scale
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=2e-6)
  if hw == (636, 500):
    assert got[254].abs().sum() > 0 and got[255:].abs().sum() == 0
