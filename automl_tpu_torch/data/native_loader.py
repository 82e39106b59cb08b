"""ctypes bindings for the port's host library (csrc/host/tfrecord_jpeg.cc),
plus a dependency-free TF-Example wire-format parser and writer.

The counterpart of automl_tpu/data/native_loader.py, with its names:
TFRecordFile, jpeg_decode_to_canvas, parse_example, the classification
and detection loaders (one serial, two with a C++ reader thread and a
JPEG worker pool), TFRecordWriter, build_example and the pure-Python
CRC32C. Added here: jpeg_decode_full (the whole image as
tf.io.decode_image decodes it), jpeg_encode_rgb, codec(), and
masked_crc32c (the library's CRC, which ckpt/tf_bundle.py checks TF
checkpoints with).

The library is built with g++ at first use into
build/automl_tpu_torch/tfrecord_jpeg-<codec>-<hash>.so (never into
native/, which belongs to the JAX package). Its JPEG codec is libjpeg
where g++ finds jpeglib.h, else the CUDA toolkit's nvJPEG (decode and
encode on the GPU); codec() says which, and raises when neither is there.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import struct
import subprocess
from typing import Iterator

import numpy as np

from automl_tpu_torch.ops import cuda_build

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "csrc" / "host"
          / "tfrecord_jpeg.cc")
BUILD_DIR = SOURCE.parents[3] / "build" / "automl_tpu_torch"

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cuda_home() -> str | None:
  from torch.utils.cpp_extension import CUDA_HOME
  return CUDA_HOME


@functools.cache
def codec() -> str:
  """'libjpeg' where g++ finds jpeglib.h, else 'nvjpeg' where the CUDA
  toolkit has nvjpeg.h. RuntimeError when there is no g++ or neither."""
  try:
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True, check=False)
  except FileNotFoundError as e:
    raise RuntimeError("g++ not found: the host library "
                       "csrc/host/tfrecord_jpeg.cc cannot be built") from e
  if probe.returncode == 0:
    return "libjpeg"
  cuda = _cuda_home()
  if cuda and os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")):
    return "nvjpeg"
  raise RuntimeError(
      "csrc/host/tfrecord_jpeg.cc needs libjpeg (jpeglib.h, -ljpeg) or the "
      f"CUDA toolkit's nvJPEG (nvjpeg.h under CUDA_HOME={cuda}); found "
      "neither")


def _flags(which: str) -> list[str]:
  # no FMA contraction: the resize must round as TF's kernel does
  flags = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
  if which == "libjpeg":
    return flags + ["-ljpeg", "-lpthread"]
  cuda = _cuda_home()
  lib = os.path.join(cuda, "lib64")
  return flags + ["-DAUTOML_NVJPEG", f"-I{cuda}/include", f"-L{lib}",
                  f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart", "-lpthread"]


def build_host(which: str | None = None) -> pathlib.Path:
  """Compiles csrc/host/tfrecord_jpeg.cc with g++ unless its library
  exists; returns the path. RuntimeError with the compiler's output when
  the build fails."""
  which = which or codec()
  return cuda_build.build_host_library(SOURCE, _flags(which),
                                       f"tfrecord_jpeg-{which}",
                                       f" with {which}", BUILD_DIR)


@functools.cache
def _load() -> ctypes.CDLL:
  lib = ctypes.CDLL(str(build_host()))
  i32p = ctypes.POINTER(ctypes.c_int)
  sig = {
      "tfrecord_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
      "tfrecord_next": (ctypes.c_int64,
                        [ctypes.c_void_p, ctypes.POINTER(_U8P)]),
      "tfrecord_rewind": (None, [ctypes.c_void_p]),
      "tfrecord_close": (None, [ctypes.c_void_p]),
      "crc32c_masked": (ctypes.c_uint32, [_U8P, ctypes.c_int64]),
      "jpeg_codec": (ctypes.c_char_p, []),
      "jpeg_last_error": (ctypes.c_char_p, []),
      "jpeg_image_info": (ctypes.c_int, [_U8P, ctypes.c_int64, i32p]),
      "jpeg_decode_full": (ctypes.c_int, [_U8P, ctypes.c_int64, _U8P,
                                          ctypes.c_int, ctypes.c_int]),
      "jpeg_encode_rgb": (ctypes.c_int64, [_U8P, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int,
                                           ctypes.POINTER(_U8P)]),
      "jpeg_free": (None, [_U8P]),
      "resize_bilinear_rgb": (None, [_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                                     ctypes.c_int, ctypes.c_int]),
      "jpeg_decode_resize": (ctypes.c_int, [_U8P, ctypes.c_int64, _U8P,
                                            ctypes.c_int, ctypes.c_int,
                                            i32p]),
      "jpeg_decode_stretch": (ctypes.c_int, [_U8P, ctypes.c_int64, _U8P,
                                             ctypes.c_int, ctypes.c_int,
                                             i32p]),
      "pipeline_create": (ctypes.c_void_p, [
          ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_int]),
      "pipeline_next_batch": (ctypes.c_int, [
          ctypes.c_void_p, _U8P, ctypes.POINTER(ctypes.c_int64),
          ctypes.POINTER(ctypes.c_int32)]),
      "det_pipeline_create": (ctypes.c_void_p, [
          ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_int]),
      "det_pipeline_next_batch": (ctypes.c_int, [
          ctypes.c_void_p, _U8P, ctypes.POINTER(ctypes.c_float),
          ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
          ctypes.POINTER(ctypes.c_float)]),
      "pipeline_dropped": (ctypes.c_int64, [ctypes.c_void_p]),
      "pipeline_destroy": (None, [ctypes.c_void_p]),
  }
  for name, (restype, argtypes) in sig.items():
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes
  return lib


def _u8(a: np.ndarray):
  return a.ctypes.data_as(_U8P)


def masked_crc32c(data) -> int:
  """The masked CRC32C (TFRecord framing's) of a bytes object or a
  contiguous numpy array's bytes, computed by the host library."""
  buf = (np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray))
         else np.ascontiguousarray(data).reshape(-1).view(np.uint8))
  return int(_load().crc32c_masked(_u8(buf), buf.size))


def _codec_error(what: str) -> str:
  return f"{what}: {_load().jpeg_last_error().decode(errors='replace')}"


class TFRecordFile:
  """Iterate raw records of one TFRecord file via the native reader."""

  def __init__(self, path: str, check_crc: bool = True):
    self._lib = _load()
    self._handle = self._lib.tfrecord_open(path.encode(), int(check_crc))
    if not self._handle:
      raise FileNotFoundError(path)

  def __iter__(self) -> Iterator[bytes]:
    ptr = _U8P()
    while True:
      n = self._lib.tfrecord_next(self._handle, ctypes.byref(ptr))
      if n == -2:
        return
      if n < 0:
        raise IOError("corrupt TFRecord (CRC mismatch)")
      yield ctypes.string_at(ptr, n)

  def rewind(self):
    self._lib.tfrecord_rewind(self._handle)

  def close(self):
    if getattr(self, "_handle", None):
      self._lib.tfrecord_close(self._handle)
      self._handle = None

  def __del__(self):
    self.close()


def _as_buffer(data: bytes) -> np.ndarray:
  return np.frombuffer(data, np.uint8)


def image_format(data: bytes) -> str:
  """The encoded image's format from its magic bytes."""
  for magic, name in ((b"\xff\xd8\xff", "jpeg"), (b"\x89PNG", "png"),
                      (b"GIF8", "gif"), (b"BM", "bmp")):
    if data[:len(magic)] == magic:
      return name
  return "unknown"


def jpeg_decode_full(data: bytes) -> np.ndarray:
  """The whole image as uint8 RGB [h, w, 3], decoded as
  tf.io.decode_image(channels=3) decodes a JPEG (libjpeg: JDCT_IFAST,
  fancy upsampling); a grayscale JPEG comes out as RGB. Only JPEG is
  decoded: another format (PNG, GIF, BMP, which TF also takes) raises a
  ValueError that names it."""
  fmt = image_format(data)
  if fmt != "jpeg":
    raise ValueError(f"only JPEG images are decoded; got {fmt} "
                     f"({data[:4]!r})")
  lib = _load()
  buf = _as_buffer(data)
  hwc = (ctypes.c_int * 3)()
  if lib.jpeg_image_info(_u8(buf), len(data), hwc) != 0:
    raise ValueError(_codec_error("JPEG header"))
  out = np.empty((hwc[0], hwc[1], 3), np.uint8)
  if lib.jpeg_decode_full(_u8(buf), len(data), _u8(out), hwc[0], hwc[1]):
    raise ValueError(_codec_error("JPEG decode failed"))
  return out


def jpeg_encode_rgb(rgb: np.ndarray, quality: int = 90) -> bytes:
  """uint8 RGB [h, w, 3] -> baseline 4:2:0 JPEG bytes."""
  rgb = np.ascontiguousarray(rgb, np.uint8)
  if rgb.ndim != 3 or rgb.shape[2] != 3:
    raise ValueError(f"jpeg_encode_rgb wants [h, w, 3], got {rgb.shape}")
  lib = _load()
  out = _U8P()
  n = lib.jpeg_encode_rgb(_u8(rgb), rgb.shape[0], rgb.shape[1], int(quality),
                          ctypes.byref(out))
  if n < 0:
    raise RuntimeError(_codec_error("JPEG encode failed"))
  try:
    return ctypes.string_at(out, n)
  finally:
    lib.jpeg_free(out)


def resize_bilinear(image: np.ndarray, h: int, w: int) -> np.ndarray:
  """uint8 RGB [H, W, 3] -> uint8 [h, w, 3]: tf.cast(tf.round(
  tf.image.resize(image, (h, w), "bilinear")), tf.uint8), with TF's
  kernel's float32 arithmetic (half-pixel centres, no antialias; round
  half to even)."""
  image = np.ascontiguousarray(image, np.uint8)
  if image.ndim != 3 or image.shape[2] != 3:
    raise ValueError(f"resize_bilinear wants [h, w, 3], got {image.shape}")
  out = np.empty((h, w, 3), np.uint8)
  _load().resize_bilinear_rgb(_u8(image), image.shape[0], image.shape[1],
                              _u8(out), h, w)
  return out


def jpeg_decode_to_canvas(data: bytes, out_h: int, out_w: int,
                          stretch: bool = False):
  """-> (canvas uint8 [out_h, out_w, 3], (content_h, content_w)).

  stretch=False: aspect-preserving, content top-left, zero pad (the
  detection canvas). stretch=True: the whole canvas with independent H / W
  scales (the classification training canvas)."""
  lib = _load()
  out = np.zeros((out_h, out_w, 3), np.uint8)
  hw = (ctypes.c_int * 2)()
  buf = _as_buffer(data)
  fn = lib.jpeg_decode_stretch if stretch else lib.jpeg_decode_resize
  if fn(_u8(buf), len(data), _u8(out), out_h, out_w, hw) != 0:
    raise ValueError(_codec_error("JPEG decode failed"))
  return out, (hw[0], hw[1])


# ---------------------------------------------------------------------------
# A minimal protobuf wire parser for tf.train.Example.
# Example = { features: { feature map<string, Feature> } }
# Feature = oneof { BytesList(1), FloatList(2), Int64List(3) }
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
  result, shift = 0, 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _walk_fields(buf: bytes):
  """Yield (field_number, wire_type, value_bytes_or_int)."""
  pos = 0
  while pos < len(buf):
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:  # varint
      val, pos = _read_varint(buf, pos)
    elif wire == 1:  # 64-bit
      val = buf[pos:pos + 8]
      pos += 8
    elif wire == 2:  # length-delimited
      n, pos = _read_varint(buf, pos)
      val = buf[pos:pos + n]
      pos += n
    elif wire == 5:  # 32-bit
      val = buf[pos:pos + 4]
      pos += 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, val


def _parse_feature(buf: bytes):
  """Feature -> list of bytes / floats / ints."""
  for field, _, val in _walk_fields(buf):
    if field == 1:  # BytesList
      return [v for f, _, v in _walk_fields(val) if f == 1]
    if field == 2:  # FloatList
      out = []
      for f, w, v in _walk_fields(val):
        if f == 1 and w == 2:  # packed
          out.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif f == 1:
          out.append(struct.unpack("<f", v)[0])
      return out
    if field == 3:  # Int64List
      out = []
      for f, w, v in _walk_fields(val):
        if f == 1 and w == 0:
          out.append(v)
        elif f == 1 and w == 2:  # packed varints
          p = 0
          while p < len(v):
            x, p = _read_varint(v, p)
            out.append(x)
      return out
  return []


def parse_example(record: bytes) -> dict:
  """tf.train.Example bytes -> {key: list}; int64 values as their
  unsigned 64-bit varints (as the JAX package reads them)."""
  out = {}
  for field, _, features_buf in _walk_fields(record):
    if field != 1:  # Example.features
      continue
    for f2, _, entry in _walk_fields(features_buf):
      if f2 != 1:  # Features.feature (map entry)
        continue
      key, feature = None, None
      for f3, _, v in _walk_fields(entry):
        if f3 == 1:
          key = v.decode()
        elif f3 == 2:
          feature = v
      if key is not None and feature is not None:
        out[key] = _parse_feature(feature)
  return out


class NativeClassificationLoader:
  """ImageNet TFRecords -> {'image': uint8 [B, S, S, 3] (stretched),
  'label': one-hot}, one example at a time in this thread."""

  def __init__(self, files: list[str], batch_size: int, canvas_size: int,
               num_classes: int, repeat: bool = True):
    self.files = list(files)
    self.batch_size = batch_size
    self.canvas = canvas_size
    self.num_classes = num_classes
    self.repeat = repeat

  def __iter__(self):
    images, labels = [], []
    while True:
      for path in self.files:
        for record in TFRecordFile(path):
          ex = parse_example(record)
          jpeg = ex.get("image/encoded", [None])[0]
          label = int(ex.get("image/class/label", [-1])[0])
          if jpeg is None:
            continue
          canvas, _ = jpeg_decode_to_canvas(jpeg, self.canvas, self.canvas,
                                            stretch=True)
          images.append(canvas)
          onehot = np.zeros((self.num_classes,), np.float32)
          if 0 <= label < self.num_classes:
            onehot[label] = 1.0
          labels.append(onehot)
          if len(images) == self.batch_size:
            yield {"image": np.stack(images), "label": np.stack(labels)}
            images, labels = [], []
      if not self.repeat:
        return


class NativeParallelClassificationLoader:
  """The C++ pipeline for classification records: a reader thread, a JPEG
  worker pool and a bounded ring of decoded examples; Python receives
  ready {'image' uint8 [B, S, S, 3] (stretched), 'label' one-hot,
  'content_hw'} batches. The order of examples depends on the workers; a
  finite stream ends with its partial batch."""

  def __init__(self, files: list[str], batch_size: int, canvas_size: int,
               num_classes: int, num_workers: int = 4,
               prefetch_batches: int = 4, repeat: bool = True):
    self.files = [f.encode() for f in files]
    self.batch_size = batch_size
    self.canvas = canvas_size
    self.num_classes = num_classes
    self.num_workers = num_workers
    self.prefetch_batches = prefetch_batches
    self.repeat = repeat

  def __iter__(self):
    if not self.files:
      raise ValueError("NativeParallelClassificationLoader: empty file list")
    lib = _load()
    arr = (ctypes.c_char_p * len(self.files))(*self.files)
    handle = lib.pipeline_create(arr, len(self.files), self.batch_size,
                                 self.canvas, self.canvas, self.num_workers,
                                 self.prefetch_batches, int(self.repeat))
    if not handle:
      raise RuntimeError("pipeline_create failed")
    b, s = self.batch_size, self.canvas
    try:
      while True:
        images = np.empty((b, s, s, 3), np.uint8)
        labels = np.empty((b,), np.int64)
        hw = np.empty((b, 2), np.int32)
        got = lib.pipeline_next_batch(
            handle, _u8(images),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if got == 0:
          return
        onehot = np.zeros((got, self.num_classes), np.float32)
        valid = (labels[:got] >= 0) & (labels[:got] < self.num_classes)
        onehot[np.arange(got)[valid], labels[:got][valid]] = 1.0
        yield {"image": images[:got], "label": onehot,
               "content_hw": hw[:got]}
        if got < b:
          return
    finally:
      lib.pipeline_destroy(handle)


class NativeParallelDetectionLoader:
  """The C++ pipeline for detection records: it also parses the gt boxes,
  classes and crowd flags, puts the boxes in canvas coordinates, skips
  crowds (skip_crowd) and pads to max_instances; Python receives ready
  {image, true_hw, gt_boxes, gt_classes, source_id} batches."""

  def __init__(self, files: list[str], batch_size: int, canvas_size: int,
               max_instances: int = 100, skip_crowd: bool = True,
               num_workers: int = 4, prefetch_batches: int = 4,
               repeat: bool = True):
    self.files = [f.encode() for f in files]
    self.batch_size = batch_size
    self.canvas = canvas_size
    self.max_instances = max_instances
    self.skip_crowd = skip_crowd
    self.num_workers = num_workers
    self.prefetch_batches = prefetch_batches
    self.repeat = repeat

  def __iter__(self):
    if not self.files:
      raise ValueError("NativeParallelDetectionLoader: empty file list")
    lib = _load()
    arr = (ctypes.c_char_p * len(self.files))(*self.files)
    handle = lib.det_pipeline_create(
        arr, len(self.files), self.batch_size, self.canvas,
        self.max_instances, int(self.skip_crowd), self.num_workers,
        self.prefetch_batches, int(self.repeat))
    if not handle:
      raise RuntimeError("det_pipeline_create failed")
    b, s, g = self.batch_size, self.canvas, self.max_instances
    f32p = ctypes.POINTER(ctypes.c_float)
    try:
      while True:
        images = np.empty((b, s, s, 3), np.uint8)
        true_hw = np.empty((b, 2), np.float32)
        boxes = np.empty((b, g, 4), np.float32)
        classes = np.empty((b, g), np.int32)
        source_id = np.empty((b,), np.float32)
        got = lib.det_pipeline_next_batch(
            handle, _u8(images), true_hw.ctypes.data_as(f32p),
            boxes.ctypes.data_as(f32p),
            classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            source_id.ctypes.data_as(f32p))
        if got == 0:
          return
        yield {"image": images[:got], "true_hw": true_hw[:got],
               "gt_boxes": boxes[:got], "gt_classes": classes[:got],
               "source_id": source_id[:got]}
        if got < b:
          return
    finally:
      lib.pipeline_destroy(handle)


# ---------------------------------------------------------------------------
# TFRecord writing and Example building (the dataset converters).
# ---------------------------------------------------------------------------


@functools.cache
def _crc_table() -> tuple:
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
    table.append(c)
  return tuple(table)


def _crc32c_py(data: bytes) -> int:
  table = _crc_table()
  c = 0xFFFFFFFF
  for b in data:
    c = table[(c ^ b) & 0xFF] ^ (c >> 8)
  return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  crc = _crc32c_py(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
  """Writes TFRecord framing (CRC32C-masked), readable by TF's readers."""

  def __init__(self, path: str):
    self._f = open(path, "wb")

  def write(self, record: bytes):
    header = struct.pack("<Q", len(record))
    self._f.write(header)
    self._f.write(struct.pack("<I", _masked_crc(header)))
    self._f.write(record)
    self._f.write(struct.pack("<I", _masked_crc(record)))

  def close(self):
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *a):
    self.close()


def _write_varint(out: bytearray, value: int):
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def _field(out: bytearray, number: int, wire: int):
  _write_varint(out, (number << 3) | wire)


def _length_delimited(number: int, payload: bytes) -> bytes:
  out = bytearray()
  _field(out, number, 2)
  _write_varint(out, len(payload))
  out += payload
  return bytes(out)


def _encode_feature(values) -> bytes:
  inner = bytearray()
  if values and isinstance(values[0], (bytes, str)):
    lst = bytearray()
    for v in values:
      if isinstance(v, str):
        v = v.encode()
      lst += _length_delimited(1, v)
    inner += _length_delimited(1, bytes(lst))          # BytesList
  elif values and isinstance(values[0], float):
    packed = struct.pack(f"<{len(values)}f", *values)
    lst = _length_delimited(1, packed)                 # packed FloatList
    inner += _length_delimited(2, bytes(lst))
  else:
    lst = bytearray()
    for v in values:
      _field(lst, 1, 0)
      _write_varint(lst, int(v) & 0xFFFFFFFFFFFFFFFF)
    inner += _length_delimited(3, bytes(lst))          # Int64List
  return bytes(inner)


def build_example(features: dict) -> bytes:
  """{key: list of bytes / str | float | int} -> a serialized
  tf.train.Example."""
  feats = bytearray()
  for key, values in features.items():
    if not isinstance(values, (list, tuple)):
      values = [values]
    entry = (_length_delimited(1, key.encode())
             + _length_delimited(2, _encode_feature(list(values))))
    feats += _length_delimited(1, entry)               # map entry
  return _length_delimited(1, bytes(feats))            # Example.features
