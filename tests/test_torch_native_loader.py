"""The port's host library (csrc/host/tfrecord_jpeg.cc) and its bindings
(data/native_loader.py) against automl_tpu's native loader and TF on the
CPU, where the library is built with libjpeg.

Held bit for bit: TFRecord framing, parse_example (against JAX's parser
and TF's writer), build_example / TFRecordWriter bytes (against JAX's),
both canvas decodes (against JAX's library), jpeg_decode_full (against
tf.io.decode_image, grayscale included), resize_bilinear (against
tf.image.resize, rounded), and the parallel loaders' example sets (against JAX's, with a partial tail batch, repeat and
teardown). jpeg_encode_rgb is held to its source by PSNR > 30 dB on a
smooth image at quality 90.
"""

import io
import os

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from automl_tpu.data import native_loader as jnl
from automl_tpu_torch.data import native_loader as tnl

tf.config.set_visible_devices([], "GPU")


def _jpeg(h, w, seed=0, gray=False, quality=90) -> bytes:
  rng = np.random.RandomState(seed)
  y, x = np.mgrid[:h, :w]
  img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1),
                  (x * y) % 256], -1) + rng.randint(-12, 13, (h, w, 3))
  im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
  buf = io.BytesIO()
  (im.convert("L") if gray else im).save(buf, "JPEG", quality=quality)
  return buf.getvalue()


def _records(n, h=40, w=30):
  return [tnl.build_example({"image/encoded": [_jpeg(h + i, w + 2 * i, i)],
                             "image/class/label": [i % 4]})
          for i in range(n)]


def test_library_builds_outside_native_with_libjpeg():
  path = tnl.build_host()
  assert tnl.codec() == "libjpeg"
  assert path.parent.name == "automl_tpu_torch" and "native" not in str(path)
  assert tnl._load().jpeg_codec() == b"libjpeg"


def test_tfrecord_roundtrip_and_crc(tmp_path):
  path = str(tmp_path / "t.tfrecord")
  records = [b"hello", b"world" * 100, b""]
  with tnl.TFRecordWriter(path) as w:
    for r in records:
      w.write(r)
  assert list(tnl.TFRecordFile(path)) == records
  assert list(jnl.TFRecordFile(path)) == records
  assert [r.numpy() for r in tf.data.TFRecordDataset(path)] == records
  raw = bytearray(open(path, "rb").read())
  raw[14] ^= 0xFF                        # a data byte of the first record
  open(path, "wb").write(bytes(raw))
  with pytest.raises(IOError, match="CRC"):
    list(tnl.TFRecordFile(path))
  assert list(tnl.TFRecordFile(path, check_crc=False))[1:] == records[1:]
  with pytest.raises(FileNotFoundError):
    tnl.TFRecordFile(str(tmp_path / "missing"))


FEATURES = {
    "image/encoded": [b"abc", b"\x00\xff"],
    "image/source_id": ["1234"],
    "image/object/bbox/xmin": [0.5, 0.25, 1e-8],
    "image/object/class/label": [42, 0, 2 ** 40],
    "image/object/is_crowd": [0, 1, 0],
    "neg": [-1],
}


def test_build_example_and_writer_bytes_equal_jax(tmp_path):
  assert tnl.build_example(FEATURES) == jnl.build_example(FEATURES)
  for mod, name in ((tnl, "port"), (jnl, "jax")):
    with mod.TFRecordWriter(str(tmp_path / name)) as w:
      w.write(mod.build_example(FEATURES))
      w.write(b"")
  assert (open(tmp_path / "port", "rb").read()
          == open(tmp_path / "jax", "rb").read())
  assert all(tnl._crc32c_py(d) == jnl._crc32c_py(d)
             for d in (b"", b"a", bytes(range(256)) * 3))


def test_parse_example_equals_jax_and_tf_writer():
  ex = tf.train.Example(features=tf.train.Features(feature={
      "image/encoded": tf.train.Feature(
          bytes_list=tf.train.BytesList(value=[b"abc", b""])),
      "image/class/label": tf.train.Feature(
          int64_list=tf.train.Int64List(value=[42, -1, 2 ** 40])),
      "bbox/xmin": tf.train.Feature(
          float_list=tf.train.FloatList(value=[0.5, 0.25])),
      "empty": tf.train.Feature(float_list=tf.train.FloatList(value=[])),
  })).SerializeToString()
  got = tnl.parse_example(ex)
  assert got == jnl.parse_example(ex)
  assert got["image/encoded"] == [b"abc", b""]
  assert got["image/class/label"] == [42, 2 ** 64 - 1, 2 ** 40]
  np.testing.assert_array_equal(np.float32(got["bbox/xmin"]), [0.5, 0.25])
  own = tnl.parse_example(tnl.build_example(FEATURES))
  assert own == jnl.parse_example(jnl.build_example(FEATURES))
  parsed = tf.io.parse_single_example(tnl.build_example(FEATURES), {
      "image/object/class/label": tf.io.VarLenFeature(tf.int64),
      "image/object/bbox/xmin": tf.io.VarLenFeature(tf.float32)})
  assert list(parsed["image/object/class/label"].values.numpy()) == \
      FEATURES["image/object/class/label"]


@pytest.mark.parametrize("hw,gray", [((480, 640), False), ((427, 640), False),
                                     ((333, 500), True), ((17, 23), False),
                                     ((64, 48), False)])
def test_decodes_bit_equal_jax_and_tf(hw, gray):
  data = _jpeg(*hw, gray=gray)
  full = tnl.jpeg_decode_full(data)
  want = tf.io.decode_image(data, channels=3, expand_animations=False)
  np.testing.assert_array_equal(full, want.numpy())
  for canvas in ((512, 512), (64, 64), (224, 160)):
    for stretch in (False, True):
      got, got_hw = tnl.jpeg_decode_to_canvas(data, *canvas, stretch=stretch)
      exp, exp_hw = jnl.jpeg_decode_to_canvas(data, *canvas, stretch=stretch)
      assert got_hw == exp_hw
      np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("src,dst", [((480, 640), (384, 512)),
                                     ((333, 500), (320, 320)),
                                     ((17, 23), (256, 448)),
                                     ((612, 612), (612, 612))])
def test_resize_bilinear_bit_equal_tf(src, dst):
  """The readers' resize: tf.cast(tf.round(tf.image.resize(x, size,
  "bilinear")), tf.uint8), every pixel."""
  img = tf.io.decode_image(_jpeg(*src), channels=3).numpy()
  want = tf.cast(tf.round(tf.image.resize(img, dst, method="bilinear")),
                 tf.uint8).numpy()
  np.testing.assert_array_equal(tnl.resize_bilinear(img, *dst), want)
  with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
    tnl.resize_bilinear(img[..., 0], *dst)


def test_decode_errors_name_the_problem():
  with pytest.raises(ValueError, match="gif"):
    tnl.jpeg_decode_full(b"GIF89a" + b"\x00" * 20)
  with pytest.raises(ValueError, match="bmp"):
    tnl.jpeg_decode_full(b"BM" + b"\x00" * 20)
  with pytest.raises(ValueError, match="JPEG"):
    tnl.jpeg_decode_full(b"\xff\xd8\xff\xe0" + b"\x00" * 20)
  with pytest.raises(ValueError, match="decode failed"):
    tnl.jpeg_decode_to_canvas(b"\xff\xd8\xff" + b"\x01" * 10, 8, 8)


def test_encode_round_trip():
  y, x = np.mgrid[:375, :500]
  img = np.stack([x // 2, y // 2, (x + y) // 4], -1).astype(np.uint8)
  data = tnl.jpeg_encode_rgb(img, quality=90)
  back = tnl.jpeg_decode_full(data)
  mse = np.mean((back.astype(np.float64) - img) ** 2)
  assert 10 * np.log10(255 ** 2 / max(mse, 1e-12)) > 30
  np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).shape,
                                img.shape)
  with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
    tnl.jpeg_encode_rgb(img[..., 0])


def _example_set(batches, key):
  return sorted(np.asarray(r).tobytes() for b in batches for r in b[key])


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_classification_loader_equals_jax_as_sets(tmp_path,
                                                          workers):
  """11 examples in batches of 4: the same example set as JAX's pipeline
  (and the port's serial loader), the partial tail batch last."""
  path = str(tmp_path / "c.tfrecord")
  with tnl.TFRecordWriter(path) as w:
    for r in _records(11):
      w.write(r)
  kw = dict(batch_size=4, canvas_size=32, num_classes=4, repeat=False)
  got = list(tnl.NativeParallelClassificationLoader(
      [path], num_workers=workers, prefetch_batches=2, **kw))
  want = list(jnl.NativeParallelClassificationLoader([path], num_workers=2,
                                                     **kw))
  serial = list(tnl.NativeClassificationLoader([path], **kw))
  assert [b["image"].shape[0] for b in got] == [4, 4, 3]
  for key in ("image", "label", "content_hw"):
    assert _example_set(got, key) == _example_set(want, key)
  # the serial loader yields whole batches only: the first 8 examples
  assert len(_example_set(serial, "image")) == 8
  assert set(_example_set(serial, "image")) <= set(_example_set(got, "image"))


def test_parallel_detection_loader_equals_jax_as_sets(tmp_path):
  path = str(tmp_path / "d.tfrecord")
  rng = np.random.RandomState(0)
  with tnl.TFRecordWriter(path) as w:
    for i in range(7):
      n = 1 + i % 4
      w.write(tnl.build_example({
          "image/encoded": [_jpeg(40 + 7 * i, 80 - 3 * i, i, gray=i == 2)],
          "image/source_id": [str(100 + i) if i != 3 else ""],
          "image/object/bbox/ymin": [float(v) for v in rng.uniform(0, .5, n)],
          "image/object/bbox/xmin": [float(v) for v in rng.uniform(0, .5, n)],
          "image/object/bbox/ymax": [float(v) for v in rng.uniform(.5, 1, n)],
          "image/object/bbox/xmax": [float(v) for v in rng.uniform(.5, 1, n)],
          "image/object/class/label": [int(v) for v in rng.randint(1, 9, n)],
          "image/object/is_crowd": [int(j == 1) for j in range(n)]}))
  for skip in (True, False):
    kw = dict(batch_size=3, canvas_size=64, max_instances=3, skip_crowd=skip,
              repeat=False)
    got = list(tnl.NativeParallelDetectionLoader([path], num_workers=3, **kw))
    want = list(jnl.NativeParallelDetectionLoader([path], num_workers=2,
                                                  **kw))
    assert [b["image"].shape[0] for b in got] == [3, 3, 1]
    for key in ("image", "true_hw", "gt_boxes", "gt_classes", "source_id"):
      assert _example_set(got, key) == _example_set(want, key), key


def test_parallel_loader_repeats_and_tears_down(tmp_path):
  path = str(tmp_path / "r.tfrecord")
  with tnl.TFRecordWriter(path) as w:
    for r in _records(3):
      w.write(r)
  it = iter(tnl.NativeParallelClassificationLoader(
      [path], batch_size=4, canvas_size=16, num_classes=4, num_workers=2,
      repeat=True))
  for _ in range(5):   # past one pass of 3 examples
    assert next(it)["image"].shape == (4, 16, 16, 3)
  it.close()           # pipeline_destroy joins the reader and workers
  with pytest.raises(ValueError, match="empty file list"):
    next(iter(tnl.NativeParallelDetectionLoader([], 1, 8)))


def test_nothing_writes_the_jax_packages_library(tmp_path):
  """The port builds only under build/automl_tpu_torch/."""
  lib = os.path.join(os.path.dirname(jnl.__file__), "..", "..", "native",
                     "libtfrecord_jpeg.so")
  before = os.path.getmtime(lib) if os.path.exists(lib) else None
  tnl.build_host()
  tnl.jpeg_decode_full(_jpeg(8, 8))
  after = os.path.getmtime(lib) if os.path.exists(lib) else None
  assert before == after
