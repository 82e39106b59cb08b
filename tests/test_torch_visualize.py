"""automl_tpu_torch's drawing utilities, label maps, weighted box fusion,
eval images and inspect_tfrecords against automl_tpu's on the CPU.

The same PIL and matplotlib draw for both packages, so images are held
pixel for pixel (PNG files byte for byte) wherever the inputs are the
same; the eval images of run_detection (the port's own detections) are
held by their ground-truth half, and inspect_tfrecords' sample PNGs within
the TFRecord readers' tolerance (tests/test_torch_readers.py).
"""

import io
import os

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from automl_tpu.inference import label_util as jlabel
from automl_tpu.inference import visualize as jvis
from automl_tpu.ops import wbf as jwbf
from automl_tpu.train import runners as jrunners
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs
from automl_tpu_torch.data import pipeline as tpipeline
from automl_tpu_torch.inference import label_util as tlabel
from automl_tpu_torch.inference import visualize as tvis
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import wbf as twbf
from automl_tpu_torch.train import runners as trunners

tf.config.set_visible_devices([], "GPU")


def _image(seed=0, h=48, w=64):
  return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
      np.uint8)


def _dets(seed, n=6, h=48, w=64, classes=3):
  rng = np.random.default_rng(seed)
  yx = rng.uniform(0, [h * 0.7, w * 0.7], (n, 2))
  hw = rng.uniform(4, [h * 0.4, w * 0.4], (n, 2))
  boxes = np.concatenate([yx, yx + hw], 1).astype(np.float32)
  return (boxes, rng.integers(1, classes + 1, n),
          rng.uniform(0.05, 1.0, n).astype(np.float32))


def test_png_writers_match_jax(tmp_path):
  """save_image_array_as_png and encode_image_as_png_bytes write the same
  bytes as JAX's; the PNG decodes to the image."""
  img = _image()
  for m in (jvis, tvis):
    m.save_image_array_as_png(img, str(tmp_path / f"{m.__name__}.png"))
  files = [open(tmp_path / f"{m.__name__}.png", "rb").read()
           for m in (jvis, tvis)]
  assert files[0] == files[1]
  assert tvis.encode_image_as_png_bytes(img) == jvis.encode_image_as_png_bytes(
      img) == files[0]
  np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(files[1]))),
                                img)


@pytest.mark.parametrize("alpha,color", [(0.4, None), (0.7, (0, 200, 30))])
def test_draw_mask_matches_jax(alpha, color):
  img = _image(1)
  mask = np.random.default_rng(2).uniform(0, 1, img.shape[:2])
  want = jvis.draw_mask(img, mask, color=color, alpha=alpha)
  got = tvis.draw_mask(img, mask, color=color, alpha=alpha)
  np.testing.assert_array_equal(got, want)
  assert (got != img).any()


@pytest.mark.parametrize("normalized", [False, True])
def test_draw_keypoints_matches_jax(normalized):
  img = _image(3)
  kp = np.random.default_rng(4).uniform(0, 1, (5, 2))
  if not normalized:
    kp = kp * [48, 64]
  want = jvis.draw_keypoints(img, kp, radius=3, color=(0, 255, 0),
                             use_normalized_coordinates=normalized)
  got = tvis.draw_keypoints(img, kp, radius=3, color=(0, 255, 0),
                            use_normalized_coordinates=normalized)
  np.testing.assert_array_equal(got, want)
  assert (got != img).any()


@pytest.mark.parametrize("extras", ["plain", "masks_keypoints", "skip_labels",
                                    "voc_cap"])
def test_visualize_image_matches_jax(extras):
  """visualize_image: boxes, labels and scores (coco names), with masks
  and keypoints, without labels, and with the voc map, a score threshold
  and max_boxes_to_draw."""
  img = _image(5)
  boxes, classes, scores = _dets(6)
  kw = {}
  if extras == "masks_keypoints":
    rng = np.random.default_rng(7)
    kw = dict(masks=rng.uniform(0, 1, (6, 48, 64)),
              keypoints=rng.uniform(0, 40, (6, 3, 2)))
  elif extras == "skip_labels":
    kw = dict(skip_labels=True, line_thickness=3)
  elif extras == "voc_cap":
    kw = dict(label_map="voc", min_score_thresh=0.4, max_boxes_to_draw=2)
  want = jvis.visualize_image(img, boxes, classes, scores, **kw)
  got = tvis.visualize_image(img, boxes, classes, scores, **kw)
  np.testing.assert_array_equal(got, want)
  assert got.shape == img.shape and (got != img).any()


def test_visualize_image_draws_boxes_thinner_than_the_line():
  """A detection box under 2 px tall or wide (as a clipped box can be):
  JAX's visualize_image raises PIL's ValueError; the port's draws the
  inset rectangles that fit, so with line_thickness 2 such a box comes out
  as JAX draws it with line_thickness 1."""
  img = _image(12)
  boxes = np.array([[10, 10, 10, 30], [20, 5, 21, 40], [5, 30, 40, 30.5]],
                   np.float32)
  classes, scores = np.array([1, 2, 3]), np.array([0.9, 0.8, 0.7],
                                                  np.float32)
  with pytest.raises(ValueError):
    jvis.visualize_image(img, boxes, classes, scores, skip_labels=True)
  got = tvis.visualize_image(img, boxes, classes, scores, skip_labels=True)
  want = jvis.visualize_image(img, boxes, classes, scores, skip_labels=True,
                              line_thickness=1)
  np.testing.assert_array_equal(got, want)
  assert (got != img).any()


def test_cdf_and_hist_images_match_jax():
  """cdf_image and hist_image (matplotlib Agg) render the same pixels as
  JAX's."""
  values = np.random.default_rng(8).standard_normal(500)
  np.testing.assert_array_equal(tvis.cdf_image(values, "loss"),
                                jvis.cdf_image(values, "loss"))
  np.testing.assert_array_equal(tvis.hist_image(values, bins=20),
                                jvis.hist_image(values, bins=20))
  assert tvis.cdf_image(values).shape == (300, 400, 3)


def test_side_by_side_evaluation_image_matches_jax():
  """[detections | ground truth] panels: padding rows (class 0) skipped."""
  img = _image(9)
  det_boxes, det_classes, det_scores = _dets(10)
  gt_boxes, gt_classes, _ = _dets(11, n=4)
  gt_boxes = np.concatenate([gt_boxes, np.zeros((2, 4), np.float32)])
  gt_classes = np.concatenate([gt_classes, [0, 0]])
  args = (img, gt_boxes, gt_classes, det_boxes, det_classes, det_scores)
  want = jvis.side_by_side_evaluation_image(*args, min_score_thresh=0.2)
  got = tvis.side_by_side_evaluation_image(*args, min_score_thresh=0.2)
  np.testing.assert_array_equal(got, want)
  assert got.shape == (48, 128, 3)


def test_label_maps_match_jax(tmp_path):
  """The coco, voc and waymo maps, and get_label_map of None, a name in
  any case, a dict and a yaml file; other kinds raise ValueError."""
  for name in ("coco", "voc", "waymo"):
    assert getattr(tlabel, name) == getattr(jlabel, name)
  path = tmp_path / "labels.yaml"
  path.write_text("1: cat\n2: dog\n7: traffic cone\n")
  for arg in (None, "", "coco", "VOC", "waymo", {3: "x"}, str(path)):
    assert tlabel.get_label_map(arg) == jlabel.get_label_map(arg)
  assert tlabel.get_label_map(str(path)) == {1: "cat", 2: "dog",
                                             7: "traffic cone"}
  with pytest.raises(ValueError):
    tlabel.get_label_map(3)


def test_create_pascal_tfrecord_uses_label_util():
  from automl_tpu_torch.cli import create_pascal_tfrecord
  assert create_pascal_tfrecord.VOC_LABELS is tlabel.voc


def test_wbf_ensemble():
  """tests/test_detection_ops.py::test_wbf_ensemble through the port."""
  dets = np.array([
      [0, 10, 10, 50, 50, 0.9, 1],
      [0, 12, 12, 52, 52, 0.7, 1],
      [0, 100, 100, 120, 120, 0.6, 2],
  ], np.float64)
  out = twbf.ensemble_detections(dets, num_models=2)
  assert out.shape[0] == 2
  np.testing.assert_allclose(out[0, 1], (10 * 0.9 + 12 * 0.7) / 1.6,
                             rtol=1e-6)
  np.testing.assert_allclose(out[0, 5], 0.8, rtol=1e-6)
  np.testing.assert_allclose(out[1, 5], 0.3, rtol=1e-6)
  np.testing.assert_array_equal(out, jwbf.ensemble_detections(dets, 2))


@pytest.mark.parametrize("seed,num_classes", [(0, None), (1, 4), (2, None)])
def test_ensemble_detections_matches_jax(seed, num_classes):
  """ensemble_detections on 3 models' jittered detections of the same
  objects (clusters of several sizes, classes with none): exactly JAX's
  rows and order; an empty input gives [0, 7]."""
  rng = np.random.default_rng(seed)
  objs = rng.uniform(0, 200, (8, 2))
  rows = []
  for m in range(3):
    for o, (y, x) in enumerate(objs):
      if rng.uniform() < 0.8:
        jit = rng.normal(0, 3, 4)
        rows.append([0, x + jit[0], y + jit[1], x + 40 + jit[2],
                     y + 30 + jit[3], rng.uniform(0.1, 1), o % 3])
  dets = np.array(rows)
  want = jwbf.ensemble_detections(dets, 3, num_classes)
  got = twbf.ensemble_detections(dets, 3, num_classes)
  np.testing.assert_array_equal(got, want)
  assert len(got) < len(dets)
  assert twbf.ensemble_detections(np.zeros((0, 7)), 2).shape == (0, 7)


def _eval_batch(seed=0, scaled=True):
  rng = np.random.default_rng(seed)
  corners = rng.choice([0.0, 8.0, 16.0, 24.0, 32.0], (3, 4, 2))
  gt_classes = rng.integers(1, 4, (3, 4)).astype(np.int32)
  gt_classes[:, -1] = -1
  batch = {"image": rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8),
           "gt_boxes": np.concatenate([corners, corners + 32.0],
                                      -1).astype(np.float32),
           "gt_classes": gt_classes}
  if scaled:
    batch["image_scale"] = np.array([1.5, 2.0, 0.5], np.float32)
  return batch


@pytest.mark.parametrize("scaled", [False, True])
def test_write_eval_images_matches_jax(tmp_path, scaled):
  """_write_eval_images fed the same batch and detections (source
  coordinates, mapped back by image_scale) writes PNG files equal byte for
  byte to JAX's, for the first n images only."""
  batch = _eval_batch(scaled=scaled)
  rng = np.random.default_rng(3)
  dets = np.zeros((3, 10, 7), np.float32)
  for i in range(3):
    boxes, classes, scores = _dets(20 + i, n=10, h=64, w=64)
    dets[i] = np.concatenate([np.full((10, 1), i), boxes * 1.5,
                              scores[:, None], classes[:, None]], 1)
  valid = rng.integers(3, 10, 3)
  jrunners._write_eval_images(batch, dets, valid, str(tmp_path / "jax"), 2)
  trunners._write_eval_images(batch, dets, valid, str(tmp_path / "torch"), 2)
  names = sorted(os.listdir(tmp_path / "torch"))
  assert names == sorted(os.listdir(tmp_path / "jax")) == [
      "eval_image_0.png", "eval_image_1.png"]
  for n in names:
    assert (open(tmp_path / "torch" / n, "rb").read()
            == open(tmp_path / "jax" / n, "rb").read())


def test_run_detection_writes_eval_images(tmp_path):
  """run_detection with evals every step writes vis/step_<n>/
  eval_image_{0,1}.png of shape [H, 2W, 3]; the ground-truth half (right)
  of each equals JAX's drawing of the eval batch's ground truth."""
  tprecision.set_policy("float32")
  try:
    cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
    cfg.nms_configs.method = "hard"

    def eval_iter():
      return iter(tpipeline.SyntheticDetection(2, 64, 4, 3, seed=1))

    d = str(tmp_path / "det")
    trunners.run_detection(cfg, d, 2, eval_iter=eval_iter, eval_steps=1,
                           eval_every=1, log_every=1, device="cpu")
  finally:
    tprecision.set_policy("mixed_bfloat16")
  batch = next(eval_iter())
  for step in (1, 2):
    for i in range(2):
      png = np.asarray(Image.open(os.path.join(
          d, "vis", f"step_{step}", f"eval_image_{i}.png")))
      assert png.shape == (64, 128, 3)
      keep = batch["gt_classes"][i] > 0
      want = jvis.visualize_image(
          batch["image"][i], batch["gt_boxes"][i][keep],
          batch["gt_classes"][i][keep], np.ones(int(keep.sum()), np.float32),
          min_score_thresh=0.0)
      np.testing.assert_array_equal(png[:, 64:], want)


def test_evaluate_detection_vis_dir(tmp_path):
  """evaluate_detection(vis_dir=..., vis_samples=1) writes one panel, of
  the first batch only, next to unchanged metrics."""
  cfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  model = trunners.seeded_detection_model(cfg, 0, "cpu")
  params = dict(model.state_dict(keep_vars=True))
  data = lambda: iter(tpipeline.SyntheticDetection(2, 64, 4, 3, seed=2))
  want = trunners.evaluate_detection(model, params, cfg, data(), 2)
  got = trunners.evaluate_detection(model, params, cfg, data(), 2,
                                    vis_dir=str(tmp_path / "vis"),
                                    vis_samples=1)
  assert got == want
  assert os.listdir(tmp_path / "vis") == ["eval_image_0.png"]


# ---------------------------------------------------------------------------
# inspect_tfrecords.
# ---------------------------------------------------------------------------


def _jpeg(rng, h, w) -> bytes:
  y, x = np.mgrid[:h, :w]
  base = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (h + w)], -1)
  img = np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(
      np.uint8)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, "JPEG", quality=90)
  return buf.getvalue()


@pytest.fixture(scope="module")
def det_records(tmp_path_factory):
  """7 COCO-like detection records over 2 files (crowd boxes included),
  JPEGs by PIL, records by TF's writer."""
  d = tmp_path_factory.mktemp("inspect")
  rng = np.random.default_rng(0)
  examples = []
  for i, (h, w) in enumerate([(480, 640), (427, 640), (640, 480), (333, 500),
                              (96, 128), (500, 375), (40, 70)]):
    n = int(rng.integers(1, 6))
    y0, x0 = rng.uniform(0, 0.6, n), rng.uniform(0, 0.6, n)
    feats = {
        "image/encoded": [_jpeg(rng, h, w)],
        "image/source_id": [str(100 + i).encode()],
        "image/object/bbox/ymin": list(y0),
        "image/object/bbox/xmin": list(x0),
        "image/object/bbox/ymax": list(y0 + rng.uniform(0.05, 0.4, n)),
        "image/object/bbox/xmax": list(x0 + rng.uniform(0.05, 0.4, n)),
        "image/object/class/label": [int(v) for v in rng.integers(1, 91, n)],
        "image/object/is_crowd": [int(i % 3 == 1 and j == 0)
                                  for j in range(n)]}
    examples.append(feats)

  def feature(v):
    if isinstance(v[0], bytes):
      return tf.train.Feature(bytes_list=tf.train.BytesList(value=v))
    if isinstance(v[0], int):
      return tf.train.Feature(int64_list=tf.train.Int64List(value=v))
    return tf.train.Feature(float_list=tf.train.FloatList(value=v))

  for f, (a, b) in enumerate(((0, 4), (4, 7))):
    with tf.io.TFRecordWriter(str(d / f"det-{f:05d}-of-00002")) as w:
      for ex in examples[a:b]:
        w.write(tf.train.Example(features=tf.train.Features(feature={
            k: feature(v) for k, v in ex.items()})).SerializeToString())
  return str(d / "det-*")


def test_inspect_tfrecords_matches_jax(det_records, tmp_path, capsys):
  """inspect_tfrecords --eval over every record: stats (records, boxes per
  image, class histogram) equal to JAX's, and each record_<i>.png within
  the readers' tolerance of JAX's (pixels at most 1 level apart on at most
  1e-4 of them)."""
  from automl_tpu.cli import inspect_tfrecords as jinspect
  from automl_tpu_torch.cli import inspect_tfrecords as tinspect
  flags = [f"--file_pattern={det_records}", "--num_samples=10", "--eval",
           "--canvas_size=256"]
  want = jinspect.main(flags + [f"--save_samples_dir={tmp_path / 'jax'}"])
  jout = capsys.readouterr().out
  got = tinspect.main(flags + [f"--save_samples_dir={tmp_path / 'torch'}"])
  assert got == want and capsys.readouterr().out.replace(
      str(tmp_path / "torch"), "") == jout.replace(str(tmp_path / "jax"), "")
  assert got["records_scanned"] == 7 and got["class_histogram"]
  names = sorted(os.listdir(tmp_path / "torch"))
  assert names == sorted(os.listdir(tmp_path / "jax"))
  assert len(names) == 7
  for n in names:
    g = np.asarray(Image.open(tmp_path / "torch" / n)).astype(np.int32)
    w = np.asarray(Image.open(tmp_path / "jax" / n)).astype(np.int32)
    assert g.shape == w.shape == (256, 256, 3)
    diff = np.abs(g - w)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (n, diff.max())
