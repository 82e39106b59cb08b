"""The TF-free TFRecord readers of automl_tpu_torch (data/pipeline.py)
against automl_tpu's tf.data readers on the CPU.

The records span 3 files of uneven length, at COCO-like sizes (and two
small ones), with a grayscale JPEG, crowd boxes, an empty source_id and
more boxes than max_instances; the JPEGs are written by PIL, the records
by TF's writer. Each eval pass is held batch by batch and in order:
pixels at most 1 level apart on at most 1e-4 of them and equal elsewhere
(measured: all equal; the decode is libjpeg's IFAST as TF's, the resize
TF's kernel's float32 arithmetic), boxes within rtol 1e-6, and true_hw,
image_scale, source_id, classes and label ids exact.
"""

import io

import numpy as np
import pytest
import tensorflow as tf
import torch
from PIL import Image

from automl_tpu.data import pipeline as jpipe
from automl_tpu_torch.data import pipeline as tpipe

tf.config.set_visible_devices([], "GPU")

PIXEL_SHARE = 1e-4
BOX_RTOL = 1e-6
SIZES = [(480, 640), (427, 640), (640, 480), (333, 500), (375, 500),
         (96, 128), (500, 375), (40, 70), (612, 612)]
GRAY = 3          # the grayscale record
EMPTY_ID = 5      # the record whose source_id is ""
MAX_INSTANCES = 5


def _jpeg(rng, h, w, gray=False) -> bytes:
  y, x = np.mgrid[:h, :w]
  base = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (h + w)], -1)
  noise = rng.randint(-20, 21, (h, w, 3))
  img = np.clip(base + noise, 0, 255).astype(np.uint8)
  im = Image.fromarray(img)
  buf = io.BytesIO()
  (im.convert("L") if gray else im).save(buf, "JPEG", quality=90)
  return buf.getvalue()


def _feature(values):
  if isinstance(values[0] if values else 0.0, bytes):
    return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
  if values and isinstance(values[0], int):
    return tf.train.Feature(int64_list=tf.train.Int64List(value=values))
  return tf.train.Feature(float_list=tf.train.FloatList(value=values))


def _write(path, examples):
  with tf.io.TFRecordWriter(path) as w:
    for feats in examples:
      w.write(tf.train.Example(features=tf.train.Features(feature={
          k: _feature(v) for k, v in feats.items()})).SerializeToString())


@pytest.fixture(scope="module")
def records(tmp_path_factory):
  """{kind: file pattern} for the detection, ImageNet and multi-label
  records, 3 files each (4, 3 and 2 records)."""
  d = tmp_path_factory.mktemp("records")
  rng = np.random.RandomState(0)
  det, cls, multi = [], [], []
  for i, (h, w) in enumerate(SIZES):
    jpeg = _jpeg(rng, h, w, gray=i == GRAY)
    n = 7 if i == 0 else rng.randint(1, 5)
    y0, x0 = rng.uniform(0, 0.6, n), rng.uniform(0, 0.6, n)
    y1 = y0 + rng.uniform(0.05, 0.4, n)
    x1 = x0 + rng.uniform(0.05, 0.4, n)
    crowd = [int(i % 3 == 1 and j == 0) for j in range(n)]
    det.append({
        "image/encoded": [jpeg],
        "image/source_id": [b"" if i == EMPTY_ID else str(1000 + i).encode()],
        "image/object/bbox/ymin": [float(v) for v in y0],
        "image/object/bbox/xmin": [float(v) for v in x0],
        "image/object/bbox/ymax": [float(v) for v in y1],
        "image/object/bbox/xmax": [float(v) for v in x1],
        "image/object/class/label": [int(v) for v in rng.randint(1, 91, n)],
        "image/object/is_crowd": crowd,
    })
    cls.append({"image/encoded": [jpeg], "image/class/label": [i % 7]})
    multi.append({"image": [jpeg],
                  "labels": [int(v) for v in rng.randint(0, 50, 1 + i % 6)]})
  out = {"det_meta": {
      float(ex["image/source_id"][0] or b"0"):
      (ex["image/object/class/label"], ex["image/object/is_crowd"])
      for ex in det}}
  for kind, examples in (("det", det), ("cls", cls), ("multi", multi)):
    for f, (a, b) in enumerate(((0, 4), (4, 7), (7, 9))):
      _write(str(d / f"{kind}-{f:05d}-of-00003.tfrecord"), examples[a:b])
    out[kind] = str(d / f"{kind}-*.tfrecord")
  return out


def _pixels_close(name, got, want):
  diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
  assert diff.max() <= 1, (name, diff.max())
  assert (diff > 0).mean() <= PIXEL_SHARE, (name, (diff > 0).mean())


def _same_passes(got_iter, want_iter, image_keys=("image",),
                 box_keys=(), exact_keys=()):
  got, want = list(got_iter), list(want_iter)
  assert len(got) == len(want)
  for i, (g, w) in enumerate(zip(got, want)):
    assert set(g) == set(w), (set(g), set(w))
    for k in g:
      assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (
          i, k, g[k].shape, w[k].shape, g[k].dtype, w[k].dtype)
    for k in image_keys:
      _pixels_close(f"batch {i} {k}", g[k], w[k])
    for k in box_keys:
      np.testing.assert_allclose(g[k], w[k], rtol=BOX_RTOL, atol=0)
    for k in exact_keys:
      np.testing.assert_array_equal(g[k], w[k], err_msg=f"batch {i} {k}")
  return got


@pytest.mark.parametrize("canvas,batch", [(512, 2), (256, 4)])
def test_detection_eval_pass_matches_tf(records, canvas, batch):
  kw = dict(is_training=False, batch_size=batch, canvas_size=canvas,
            max_instances=MAX_INSTANCES)
  got = _same_passes(
      tpipe.DetectionTFRecordLoader(records["det"], **kw),
      jpipe.DetectionTFRecordLoader(records["det"], **kw),
      box_keys=("gt_boxes",),
      exact_keys=("true_hw", "image_scale", "source_id", "gt_classes"))
  assert len(got) == -(-len(SIZES) // batch)       # the partial last batch
  ids = np.concatenate([b["source_id"] for b in got])
  assert 0.0 in ids                                # "" read as "0"
  # round-robin over the 3 files: their first records come first
  assert list(ids[:3]) == [1000.0, 1004.0, 1007.0]


@pytest.mark.parametrize("canvas", [96, 352, 32])
def test_imagenet_eval_pass_matches_tf(records, canvas):
  """isize = canvas - 32: 64 (< 320, the centre crop), 320 (no crop) and
  the canvas <= 32 branch (a plain resize)."""
  kw = dict(is_training=False, batch_size=4, canvas_size=canvas,
            num_classes=7, drop_remainder=False)
  got = _same_passes(tpipe.ImageNetTFRecordLoader(records["cls"], **kw),
                     jpipe.ImageNetTFRecordLoader(records["cls"], **kw),
                     exact_keys=("label",))
  side = canvas if canvas <= 32 else canvas - 32
  assert got[0]["image"].shape[1:] == (side, side, 3)


def test_multilabel_eval_pass_matches_tf(records):
  kw = dict(is_training=False, batch_size=4, canvas_size=96, max_labels=4,
            drop_remainder=True)
  got = _same_passes(tpipe.MultiLabelTFRecordLoader(records["multi"], **kw),
                     jpipe.MultiLabelTFRecordLoader(records["multi"], **kw),
                     exact_keys=("label_ids",))
  assert len(got) == len(SIZES) // 4               # drop_remainder


def test_detection_training_pass_is_a_permutation_without_crowds(records):
  """The first len(SIZES) training examples are the records in some order
  (shuffle then repeat), crowd boxes skipped; another seed, another order;
  the images are the eval pass's."""
  kw = dict(is_training=True, batch_size=1, canvas_size=128,
            max_instances=MAX_INSTANCES, shuffle_buffer=4)
  evals = {float(b["source_id"][0]): b for b in tpipe.DetectionTFRecordLoader(
      records["det"], is_training=False, batch_size=1, canvas_size=128,
      max_instances=MAX_INSTANCES)}

  def first_pass(seed):
    it = iter(tpipe.DetectionTFRecordLoader(records["det"], seed=seed, **kw))
    return [next(it) for _ in SIZES]

  passes = [first_pass(0), first_pass(0), first_pass(1)]
  ids = [[float(b["source_id"][0]) for b in p] for p in passes]
  assert sorted(ids[0]) == sorted(evals) and ids[0] == ids[1]
  assert ids[2] != ids[0]
  assert any(any(c) for _, c in records["det_meta"].values())
  for b in passes[0]:
    sid = float(b["source_id"][0])
    np.testing.assert_array_equal(b["image"], evals[sid]["image"])
    labels, crowd = records["det_meta"][sid]
    kept = [l for l, c in zip(labels, crowd) if not c][:MAX_INSTANCES]
    want = np.full((MAX_INSTANCES,), -1, np.int32)
    want[:len(kept)] = kept
    np.testing.assert_array_equal(b["gt_classes"][0], want)


def test_shards_are_disjoint_and_cover_every_file(records):
  for training in (False, True):
    shards = [tpipe.ImageNetTFRecordLoader(
        records["cls"], training, 2, 64, 7, shard_index=i,
        num_shards=2).files(torch.Generator().manual_seed(0))
              for i in range(2)]
    assert not set(shards[0]) & set(shards[1])
    assert len(shards[0]) + len(shards[1]) == 3
  one = tpipe.ImageNetTFRecordLoader(records["cls"], False, 1, 64, 7,
                                     shard_index=1, num_shards=2)
  assert sum(1 for _ in one) == 3                  # file 1 of 3: 3 records


def test_interleave_refills_its_slots_in_tf_order(tmp_path):
  """More files than the cycle: tf.data opens the next file in the slot a
  file left, when the cycle comes back to it."""
  from automl_tpu_torch.data import native_loader as nl
  files = []
  for f, n in enumerate((1, 3, 2, 2)):
    path = str(tmp_path / f"f{f}.tfrecord")
    with nl.TFRecordWriter(path) as w:
      for r in range(n):
        w.write(f"{f}.{r}".encode())
    files.append(path)
  got = [r.decode() for r in tpipe.interleave(files, cycle_length=2)]
  ds = tf.data.Dataset.from_tensor_slices(files).interleave(
      tf.data.TFRecordDataset, cycle_length=2, block_length=1)
  assert got == [r.decode() for r in ds.as_numpy_iterator()]


def test_other_image_formats_raise_naming_the_format(tmp_path):
  from automl_tpu_torch.data import native_loader as nl
  buf = io.BytesIO()
  Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "PNG")
  path = str(tmp_path / "png.tfrecord")
  _write(path, [{"image/encoded": [buf.getvalue()],
                 "image/class/label": [1]}])
  with pytest.raises(ValueError, match="png"):
    nl.jpeg_decode_full(buf.getvalue())
  with pytest.raises(ValueError, match="png"):
    next(iter(tpipe.ImageNetTFRecordLoader(path, False, 1, 64, 3,
                                           drop_remainder=False)))


def test_device_prefetcher_on_the_cpu_and_its_errors():
  batches = [{"image": np.full((2, 4, 4, 3), i, np.uint8),
              "label": np.eye(2, dtype=np.float32)} for i in range(3)]
  pf = tpipe.DevicePrefetcher(iter(batches), device="cpu")
  got = list(pf)
  pf.close()
  assert len(got) == 3 and not pf._thread.is_alive()
  for g, w in zip(got, batches):
    assert all(torch.is_tensor(v) for v in g.values())
    np.testing.assert_array_equal(g["image"].numpy(), w["image"])

  def failing():
    yield batches[0]
    raise OSError("corrupt TFRecord")

  pf = tpipe.DevicePrefetcher(failing(), device="cpu")
  it = iter(pf)
  next(it)
  with pytest.raises(OSError, match="corrupt"):
    next(it)
  pf.close()
  # close() stops a thread that is still staging an endless stream
  pf = tpipe.DevicePrefetcher(iter(lambda: batches[0], None), device="cpu",
                              buffer_size=1)
  next(iter(pf))
  pf.close()
  assert not pf._thread.is_alive()
