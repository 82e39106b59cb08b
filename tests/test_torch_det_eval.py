"""automl_tpu_torch's detection eval path against automl_tpu's on the CPU.

The COCO evaluator (a copy: its results must equal JAX's exactly),
archive_ckpt, evaluate_detection end to end on efficientdet-test from one
JAX-layout parameter tree, the eval half of run_detection, and entry()
against JAX's entry forward. Tolerances are stated per test.
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
from automl_tpu.data import pipeline as jpipeline
from automl_tpu.eval import coco_metric as jcoco
from automl_tpu.models import efficientdet as jdet
from automl_tpu.ops import postprocess as jpost
from automl_tpu.train import runners as jrunners
from automl_tpu_torch import convert
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.data import pipeline as tpipeline
from automl_tpu_torch.entry import entry
from automl_tpu_torch.eval import coco_metric as tcoco
from automl_tpu_torch.models import efficientdet as tdet
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import postprocess as tpost
from automl_tpu_torch.train import checkpoint as tckpt
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import runners as trunners
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


# ---------------------------------------------------------------------------
# The COCO evaluator.
# ---------------------------------------------------------------------------


def _workload(seed, n_images=6, n_classes=4):
  """Random (image, det, gt) rows for both evaluators: sizes spanning the
  small / medium / large areas, crowd gt, jittered near-matches, classes
  with no gt and gt with no detections."""
  rng = np.random.RandomState(seed)
  rows = []
  for img in range(n_images):
    n_gt = rng.randint(0, 8)
    gt_yx = rng.uniform(0, 300, (n_gt, 2))
    gt = np.concatenate([gt_yx, gt_yx + rng.uniform(4, 150, (n_gt, 2))], 1)
    gt_cls = rng.randint(1, n_classes + 1, n_gt)
    crowd = rng.rand(n_gt) < 0.2
    n_det = rng.randint(0, 25)
    if n_det and n_gt:
      det = gt[rng.randint(0, n_gt, n_det)] + rng.normal(0, 8, (n_det, 4))
    else:
      yx = rng.uniform(0, 300, (n_det, 2))
      det = np.concatenate([yx, yx + rng.uniform(4, 150, (n_det, 2))], 1)
    rows.append((img + 1, det, rng.uniform(0.05, 1.0, n_det),
                 rng.randint(1, n_classes + 1, n_det), gt, gt_cls, crowd))
  return rows


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_coco_evaluator_matches_jax(seed, per_class):
  """compute() equal to JAX's, metric for metric (exact), on random
  workloads with crowd gt, per-class AP and the area ranges; then after a
  detection_results() dump reloaded by add_detection_results into fresh
  evaluators; add_batch_from_detections on the device format."""
  rows = _workload(seed)
  evs = [m.COCOEvaluator(per_class=per_class) for m in (jcoco, tcoco)]
  for ev in evs:
    for r in rows:
      ev.add(*r)
  want, got = (ev.compute() for ev in evs)
  assert got == want
  assert want["AP"] > 0
  assert evs[1].detection_results() == evs[0].detection_results()

  fresh = [m.COCOEvaluator(per_class=per_class) for m in (jcoco, tcoco)]
  for ev in fresh:
    for img, _, _, _, gt, gt_cls, crowd in rows:
      ev.add(img, np.zeros((0, 4)), [], [], gt, gt_cls, crowd)
    ev.add_detection_results(evs[0].detection_results())
  assert fresh[1].compute() == fresh[0].compute()

  dets = np.zeros((len(rows), 25, 7), np.float32)
  valid = np.zeros(len(rows), np.int32)
  gt_boxes = np.zeros((len(rows), 8, 4), np.float32)
  gt_classes = -np.ones((len(rows), 8), np.int32)
  for i, (img, det, score, cls, gt, gt_cls, _) in enumerate(rows):
    n = len(det)
    dets[i, :n] = np.concatenate(
        [np.full((n, 1), img), det, score[:, None], cls[:, None]], 1)
    valid[i] = n
    gt_boxes[i, :len(gt)], gt_classes[i, :len(gt)] = gt, gt_cls
  batch = [m.COCOEvaluator(per_class=per_class) for m in (jcoco, tcoco)]
  for ev in batch:
    ev.add_batch_from_detections(dets, valid, gt_boxes, gt_classes)
  assert batch[1].compute() == batch[0].compute()


def test_coco_json_paths_match_jax(tmp_path):
  """write_detections_json: a directory gets the test-dev file name, a
  `.json` path is written as given, and a `.json` path whose parent
  directory is missing raises FileNotFoundError in both packages (ADVICE
  r5 on automl_tpu/eval/coco_metric.py:285: the port matches)."""
  evs = [m.COCOEvaluator() for m in (jcoco, tcoco)]
  for ev in evs:
    for r in _workload(1):
      ev.add(*r)
  for name, ev in zip(("jax", "torch"), evs):
    d = tmp_path / name
    path = ev.write_detections_json(str(d / "testdev"))
    assert path == str(d / "testdev" / tcoco.COCOEvaluator.TESTDEV_FILENAME)
    assert ev.write_detections_json(str(d / "out.json")) == str(
        d / "out.json")
    with pytest.raises(FileNotFoundError):
      ev.write_detections_json(str(d / "missing" / "out.json"))
  assert tcoco.COCOEvaluator.TESTDEV_FILENAME == (
      jcoco.COCOEvaluator.TESTDEV_FILENAME)
  for f in ("testdev/" + tcoco.COCOEvaluator.TESTDEV_FILENAME, "out.json"):
    assert (json.load(open(tmp_path / "torch" / f))
            == json.load(open(tmp_path / "jax" / f)))


def test_archive_ckpt_keeps_the_best(tmp_path):
  """archive_ckpt copies a better step's checkpoint into archive/, moves
  the previous one to backup/, and refuses a worse or equal objective."""
  model = tdet.EfficientDet(tdet_configs.get_efficientdet_config(
      "efficientdet-test"))
  tx = topt.masked_for_params(topt.build_optimizer("momentum", 0.1))
  state = ttrain.create_train_state(model, tx)
  mngr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
  for step in (1, 2, 3):
    mngr.save(step, state._replace(step=step))
  d = str(tmp_path)
  assert tckpt.archive_ckpt(d, 1, 0.3, mngr)
  assert not tckpt.archive_ckpt(d, 2, 0.3, mngr)
  assert tckpt.archive_ckpt(d, 3, 0.5, mngr)
  assert not tckpt.archive_ckpt(d, 2, 0.4, mngr)
  assert sorted(os.listdir(tmp_path / "archive")) == ["3",
                                                     "best_objective.txt"]
  assert open(tmp_path / "archive" / "best_objective.txt").read() == (
      "step 3 objective 0.5\n")
  assert sorted(os.listdir(tmp_path / "backup")) == ["1", "best_objective.txt"]
  assert not tckpt.archive_ckpt(d, 9, 0.9, mngr)   # no such step


# ---------------------------------------------------------------------------
# evaluate_detection, run_detection's eval, entry().
# ---------------------------------------------------------------------------


def _tree(tmodel, seed=0, class_scale=1.0):
  """A seeded JAX-layout tree whose class-predict bias is 0 (scores spread
  around 0.5, so every image keeps its 100 detections) and whose
  class-predict kernel is scaled by class_scale."""
  tree = convert.det_numpy_init(tmodel, seed)
  predict = tree["class_net"]["class-predict"]["pointwise"]
  predict["bias"][:] = 0.0
  predict["kernel"] *= class_scale
  return tree


def _det_pair(name="efficientdet-test"):
  jcfg = jdet_configs.get_efficientdet_config(name)
  tcfg = tdet_configs.get_efficientdet_config(name)
  tmodel = tdet.EfficientDet(tcfg)
  tree = _tree(tmodel)
  convert.load_det_params(tmodel, tree)
  return (jcfg, tcfg, jdet.EfficientDet(jcfg),
          jax.tree_util.tree_map(jnp.asarray, tree), tmodel, tree)


def _eval_batches(n=2, seed=0):
  """n batches of 2 random 64 x 64 images with 4 ground-truth boxes each
  on the 32-px anchors' grid, so that untrained detections overlap some
  (numpy, the loaders' layout)."""
  rng = np.random.default_rng(seed)
  batches = []
  for _ in range(n):
    corners = rng.choice([0.0, 8.0, 16.0, 24.0, 32.0], (2, 4, 2))
    batches.append({
        "image": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "gt_boxes": np.concatenate([corners, corners + 32.0],
                                   -1).astype(np.float32),
        "gt_classes": rng.integers(1, 4, (2, 4)).astype(np.int32)})
  return batches


@pytest.mark.parametrize("method", ["gaussian", "hard"])
def test_evaluate_detection_matches_jax(method):
  """evaluate_detection on efficientdet-test, 2 batches of 2 (the same
  numpy batches in both packages), per-class AP on: every metric within
  1e-4 of JAX's."""
  jcfg, tcfg, jm, jparams, tm, _ = _det_pair()
  for c in (jcfg, tcfg):
    c.nms_configs.method = method
  want = jrunners.evaluate_detection(jm, jparams, jcfg,
                                     iter(_eval_batches()), 2, per_class=True)
  got = trunners.evaluate_detection(tm, convert.model_state(tm), tcfg,
                                    iter(_eval_batches()), 2, per_class=True)
  assert set(got) == set(want)
  assert want["AP50"] > 0 and want["ARmax100"] > 0
  for k in want:
    assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_evaluate_detection_testdev_and_params(tmp_path):
  """testdev_dir mode: AP -1 and the submission JSON, whose rows match
  JAX's (same image ids and classes, boxes within 1e-2 px after the 2-dp
  rounding, scores within 1e-3 after the 3-dp rounding) on the confident
  detections (score > 0.5). Evaluating other params leaves the model's
  own state as it was."""
  jcfg, tcfg, jm, jparams, tm, tree = _det_pair()
  for c in (jcfg, tcfg):
    c.nms_configs.method = "hard"
  data = dict(batch_size=2, image_size=64, max_instances=4, num_classes=3)
  want = jrunners.evaluate_detection(
      jm, jparams, jcfg, iter(jpipeline.SyntheticDetection(**data)), 1,
      testdev_dir=str(tmp_path / "jax"))
  own = {k: v.clone() for k, v in convert.model_state(tm).items()}
  zeros = {k: torch.zeros_like(v) for k, v in own.items()}
  got = trunners.evaluate_detection(
      tm, own, tcfg, iter(tpipeline.SyntheticDetection(**data)), 1,
      testdev_dir=str(tmp_path / "torch"))
  assert got["AP"] == want["AP"] == -1.0
  assert got["detections_json"].endswith(
      tcoco.COCOEvaluator.TESTDEV_FILENAME)
  rows = [[r for r in json.load(open(m["detections_json"]))
           if r["score"] > 0.5] for m in (got, want)]
  assert len(rows[1]) > 5 and len(rows[0]) == len(rows[1])
  for g, w in zip(*rows):
    assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                 w["category_id"])
    assert abs(g["score"] - w["score"]) <= 1e-3
    np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
  trunners.evaluate_detection(
      tm, zeros, tcfg, iter(tpipeline.SyntheticDetection(**data)), 1,
      testdev_dir=str(tmp_path / "zeros"))
  for k, v in convert.model_state(tm).items():
    torch.testing.assert_close(v, own[k], rtol=0, atol=0)


def test_run_detection_evals_and_archives(tmp_path):
  """run_detection with an eval_iter factory and eval_every=1: an eval
  after each of 3 steps (on the EMA params) written to metrics.jsonl as
  eval/<metric>, a checkpoint before each, archive/ holding the first step
  with the best AP, and each eval's two PNGs in vis/step_<n>/; then with an iterator and eval_every=0,
  one eval at the end, returned with the training metrics."""
  cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  cfg.nms_configs.method = "hard"
  d = str(tmp_path / "det")

  def eval_iter():
    return iter(tpipeline.SyntheticDetection(2, 64, 4, 3, seed=1))

  out = trunners.run_detection(cfg, d, 3, eval_iter=eval_iter, eval_steps=1,
                               eval_every=1, log_every=1, device="cpu")
  assert np.isfinite(out["loss"])
  recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
  evals = [r for r in recs if "eval/AP" in r]
  assert [r["step"] for r in evals] == [1, 2, 3]
  assert all(np.isfinite(r["eval/AP"]) for r in evals)
  assert sorted(os.listdir(os.path.join(d, "ckpt"))) == ["1", "2", "3"]
  aps = [r["eval/AP"] for r in evals]
  best = int(np.argmax(aps)) + 1
  archived = open(os.path.join(d, "archive", "best_objective.txt")).read()
  assert archived == f"step {best} objective {max(aps)}\n"
  assert os.path.isdir(os.path.join(d, "archive", str(best)))
  for step in (1, 2, 3):
    assert sorted(os.listdir(os.path.join(d, "vis", f"step_{step}"))) == [
        "eval_image_0.png", "eval_image_1.png"]

  d2 = str(tmp_path / "det2")
  out = trunners.run_detection(cfg, d2, 2, eval_iter=eval_iter(),
                               eval_steps=1, log_every=1, device="cpu")
  assert {"loss", "AP", "AP50", "ARmax100"} <= set(out)
  assert os.path.exists(os.path.join(d2, "archive", "best_objective.txt"))


def _assert_confident_match(got, want, thresh, score_tol, box_tol):
  """Every detection above `thresh` on either side has a partner on the
  other, in the same image, with the same class, its score within
  score_tol and every coordinate within box_tol px."""
  got = [t.float().numpy() for t in got]
  want = [np.asarray(t, np.float32) for t in want]
  n = 0
  for src, dst in ((want, got), (got, want)):
    boxes, scores, classes, valid = src
    for b in range(scores.shape[0]):
      for i in range(int(valid[b])):
        if scores[b, i] <= thresh:
          continue
        n += 1
        ok = ((dst[2][b] == classes[b, i])
              & (np.abs(dst[1][b] - scores[b, i]) <= score_tol)
              & (np.abs(dst[0][b] - boxes[b, i]).max(-1) <= box_tol))
        assert ok[:int(dst[3][b])].any(), (b, i, scores[b, i])
  assert n >= 4


def _jax_entry_forward(jm):
  def forward(params, images):
    cls_outputs, box_outputs = jm(params, images, train=False)
    return jpost.postprocess_global(jm.config, cls_outputs, box_outputs)
  return jax.jit(forward)


@pytest.mark.parametrize("policy,score_tol,box_tol", [
    ("mixed_bfloat16", 5e-3, 1.0), ("float32", 1e-5, 1e-3)])
def test_entry_matches_jax_entry(policy, score_tol, box_tol):
  """entry() on efficientdet-test against the forward of JAX's entry()
  (forward + postprocess_global, the config's gaussian NMS) from one tree,
  on 2 random 64 x 64 images: the confident detections (score > 0.5)
  agree, scores and boxes within bf16-level tolerances under
  mixed_bfloat16 (what entry sets) and float32-level ones under float32.
  The gaussian tail below is chaotic across implementations and not
  compared."""
  cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  tree = _tree(tdet.EfficientDet(cfg), seed=3)
  fn, (example,) = entry("cpu", params=tree, config=cfg)
  assert example.shape == (1, 64, 64, 3) and not example.any()
  tprecision.set_policy(policy)
  jnn.set_policy(policy)
  x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
      np.float32)
  got = fn(torch.from_numpy(x))
  jm = jdet.build_detection_model("efficientdet-test")
  want = _jax_entry_forward(jm)(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(x))
  assert [tuple(t.shape) for t in got] == [w.shape for w in want]
  _assert_confident_match(got, want, 0.5, score_tol, box_tol)
  assert tuple(fn(example)[3].shape) == (1,)


@pytest.mark.slow
def test_entry_d0_matches_jax_entry():
  """entry() at D0 512 x 512 against JAX's entry forward from one tree, 1
  random image, both under the float32 policy: every one of the 100
  detections within score 1e-5 and 1e-3 px, the classes equal. The
  class-predict kernel is scaled by 300 (its init spreads D0's logits
  over only +-2e-3, where every top-100 score ties to 4 digits), so the
  top scores range from 0.58 to 0.61 (under mixed_bfloat16 the two
  packages' bf16 convs order such a field differently from about the
  12th detection on; test_entry_matches_jax_entry holds bf16 on
  efficientdet-test)."""
  cfg = tdet_configs.get_efficientdet_config("efficientdet-d0")
  tree = _tree(tdet.EfficientDet(cfg), class_scale=300.0)
  fn, _ = entry("cpu", params=tree, config=cfg)
  tprecision.set_policy("float32")
  x = np.random.default_rng(0).standard_normal((1, 512, 512, 3)).astype(
      np.float32)
  got = [t.float().numpy() for t in fn(torch.from_numpy(x))]
  jm = jdet.build_detection_model("efficientdet-d0")
  want = [np.asarray(t, np.float32) for t in _jax_entry_forward(jm)(
      jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))]
  np.testing.assert_array_equal(got[3], want[3])
  np.testing.assert_array_equal(got[2], want[2])
  np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
  np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)


@pytest.mark.slow
def test_closed_loop_reaches_ap50():
  """tests/test_closed_loop.py's recipe through the port: efficientdet-test
  overfits one synthetic batch whose pixels encode the boxes (400 momentum
  steps, f32), then hard-NMS detections on the same batch through the
  COCO evaluator: AP50 > 0.5, JAX's own criterion, and the loss < 1."""
  cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  cfg.override(dict(learning_rate=0.02, lr_warmup_init=0.002))
  cfg.nms_configs.method = "hard"
  cfg.nms_configs.sigma = 0.0
  model = trunners.seeded_detection_model(cfg, 0, "cpu")
  tx = topt.masked_for_params(topt.build_optimizer(
      "momentum", tsched.detection_lr(cfg, steps_per_epoch=100)))
  state = ttrain.create_train_state(model, tx)
  step_fn = ttrain.make_det_train_step(model, tx, cfg)
  data = tpipeline.SyntheticDetection(4, 64, max_instances=10,
                                      num_classes=3, seed=3).batch
  imgs = data["image"].astype(np.float32)
  for i in range(imgs.shape[0]):
    for g in range(10):
      if data["gt_classes"][i, g] > 0:
        y0, x0, y1, x1 = data["gt_boxes"][i, g].astype(int)
        cls = int(data["gt_classes"][i, g])
        imgs[i, y0:y1, x0:x1] = [255 * (cls == c) for c in (1, 2, 3)]
  images = (torch.from_numpy(imgs) - torch.tensor(cfg.mean_rgb)) / (
      torch.tensor(cfg.stddev_rgb))
  batch = {"image": images.permute(0, 3, 1, 2).contiguous(
               memory_format=torch.channels_last),
           "gt_boxes": torch.from_numpy(data["gt_boxes"]),
           "gt_classes": torch.from_numpy(data["gt_classes"])}
  gen = torch.Generator()
  for _ in range(400):
    state, m = step_fn(state, batch, gen.manual_seed(1))
  assert float(m["loss"]) < 1.0, float(m["loss"])
  with torch.no_grad():
    c, b = model(batch["image"], train=False)
    dets, valid = tpost.generate_detections(cfg, c, b, torch.ones(4),
                                            torch.arange(4))
  ev = tcoco.COCOEvaluator()
  ev.add_batch_from_detections(dets.numpy(), valid.numpy(), data["gt_boxes"],
                               data["gt_classes"])
  metrics = ev.compute()
  assert metrics["AP50"] > 0.5, metrics
