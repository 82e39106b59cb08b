"""Host input: synthetic data, the TFRecord readers without TF, and the
device prefetcher.

The counterpart of automl_tpu/data/pipeline.py. SyntheticClassification
and SyntheticDetection (the data_dir='null' mode and main_det
--use_fake_data) give the same numpy stream seed for seed: fixed-shape
uint8 NHWC canvases, one-hot labels or one to three boxes per image.

DetectionTFRecordLoader, ImageNetTFRecordLoader and
MultiLabelTFRecordLoader take the JAX readers' arguments and return their
batch keys, shapes and dtypes, and copy their tf.data graphs without TF:
list_files (sorted unless shuffled), files.shard(n, i) (files, not
records), interleave with cycle_length 16 and blocks of 1 (so an eval pass
is round-robin over the files), training's shuffle(buffer).repeat(), the
map, and batch. Each image is decoded as tf.io.decode_image decodes it
(native_loader.jpeg_decode_full) and resized as tf.image.resize(...,
"bilinear") does (native_loader.resize_bilinear: TF's kernel's float32
arithmetic, rounded half to even), in float32 geometry as TF computes it.
Decode and resize run on a pool of host threads (ctypes calls release the
GIL). Training order comes from a
torch.Generator seeded from `seed` (tf.data's order cannot be reproduced).

DevicePrefetcher stages host batches into pinned memory and copies them
to the device on a side stream from a background thread.
"""

from __future__ import annotations

import collections
import concurrent.futures
import glob
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from automl_tpu_torch.data import native_loader


class SyntheticClassification:
  """Yields the same batch forever: image uint8 [B, S, S, 3], label f32
  [B, num_classes] one-hot."""

  def __init__(self, batch_size: int, image_size: int, num_classes: int,
               seed: int = 0):
    rng = np.random.RandomState(seed)
    self.batch = {
        "image": rng.randint(0, 256, (batch_size, image_size, image_size, 3),
                             dtype=np.uint8),
        "label": np.eye(num_classes, dtype=np.float32)[
            rng.randint(0, num_classes, batch_size)],
    }

  def __iter__(self) -> Iterator[dict]:
    while True:
      yield self.batch


class SyntheticDetection:
  """Yields the same fixed-shape detection batch forever: image uint8
  [B, S, S, 3], true_hw f32 [B, 2], gt_boxes f32 [B, G, 4], gt_classes
  int32 [B, G] (-1 padding)."""

  def __init__(self, batch_size: int, image_size: int,
               max_instances: int = 100, num_classes: int = 90, seed: int = 0):
    rng = np.random.RandomState(seed)
    b, s, g = batch_size, image_size, max_instances
    boxes = np.zeros((b, g, 4), np.float32)
    classes = -np.ones((b, g), np.int32)
    for i in range(b):
      n = rng.randint(1, 4)
      y0 = rng.uniform(0, s * 0.6, n)
      x0 = rng.uniform(0, s * 0.6, n)
      hh = rng.uniform(s * 0.1, s * 0.4, n)
      ww = rng.uniform(s * 0.1, s * 0.4, n)
      boxes[i, :n] = np.stack([y0, x0, np.minimum(y0 + hh, s),
                               np.minimum(x0 + ww, s)], axis=1)
      classes[i, :n] = rng.randint(1, num_classes + 1, n)
    self.batch = {
        "image": rng.randint(0, 256, (b, s, s, 3), dtype=np.uint8),
        "true_hw": np.full((b, 2), s, np.float32),
        "gt_boxes": boxes,
        "gt_classes": classes,
    }

  def __iter__(self) -> Iterator[dict]:
    while True:
      yield self.batch


# ---------------------------------------------------------------------------
# TFRecord readers (tf.data's graph without TF).
# ---------------------------------------------------------------------------


def list_files(file_pattern: str, shuffle: bool, generator=None) -> list:
  """tf.data.Dataset.list_files: the matches sorted, or in an order drawn
  from the generator when shuffled. ValueError when nothing matches."""
  files = sorted(glob.glob(file_pattern))
  if not files:
    raise ValueError(f"no files match {file_pattern!r}")
  if shuffle:
    files = [files[i] for i in torch.randperm(len(files),
                                              generator=generator).tolist()]
  return files


def interleave(files: list, cycle_length: int = 16) -> Iterator[bytes]:
  """The records of `files` as tf.data's interleave (block_length 1) gives
  them: one record from each open file of the cycle in turn; a file that
  ends leaves its slot empty, and the next file opens in that slot when the
  cycle comes back to it."""
  pending = iter(files)
  slots = [None] * cycle_length
  open_count, exhausted, i = 0, False, 0
  while not exhausted or open_count:
    if slots[i] is not None:
      rec = next(slots[i], None)
      if rec is not None:
        yield rec
      else:
        slots[i] = None
        open_count -= 1
      i = (i + 1) % cycle_length
    elif not exhausted:
      path = next(pending, None)
      if path is None:
        exhausted = True
      else:
        slots[i] = iter(native_loader.TFRecordFile(path))
        open_count += 1
    else:
      i = (i + 1) % cycle_length


def shuffle_buffer(items, buffer_size: int, generator) -> Iterator:
  """tf.data's shuffle: a buffer of buffer_size items, each output drawn
  uniformly from it and replaced by the next input; the rest drained in
  random order at the end."""
  buf = []
  for item in items:
    if len(buf) < buffer_size:
      buf.append(item)
      continue
    j = int(torch.randint(len(buf), (), generator=generator))
    buf[j], item = item, buf[j]
    yield item
  while buf:
    j = int(torch.randint(len(buf), (), generator=generator))
    buf[j], buf[-1] = buf[-1], buf[j]
    yield buf.pop()


def _ordered_map(fn, items, workers: int) -> Iterator:
  """fn over items on a pool of threads, in order, with a bounded number
  in flight."""
  with concurrent.futures.ThreadPoolExecutor(workers) as pool:
    pending = collections.deque()
    for item in items:
      pending.append(pool.submit(fn, item))
      if len(pending) >= 2 * workers:
        yield pending.popleft().result()
    while pending:
      yield pending.popleft().result()


def _int64(v: int) -> int:
  """An int64 read as its unsigned varint (parse_example) -> signed."""
  return v - (1 << 64) if v >= 1 << 63 else v


def _cls_image(jpeg: bytes, size: int, is_training: bool) -> np.ndarray:
  """The classification readers' image: a size x size resize in training
  (and for tiny canvases, size <= 32); in eval the reference geometry at
  isize = size - 32: a centre crop of int(ratio * min(h, w)), ratio =
  isize / (isize + 32), only when isize < 320, then one resize to isize."""
  image = native_loader.jpeg_decode_full(jpeg)
  if is_training or size <= 32:
    return native_loader.resize_bilinear(image, size, size)
  isize = size - 32
  if isize < 320:
    h, w = image.shape[:2]
    ratio = np.float32(isize / (isize + 32))
    crop = int(ratio * np.float32(min(h, w)))
    y0, x0 = (h - crop) // 2, (w - crop) // 2
    image = image[y0:y0 + crop, x0:x0 + crop]
  return native_loader.resize_bilinear(image, isize, isize)


def _batches(examples, batch_size: int, drop_remainder: bool):
  """Stacks dict examples into batches of batch_size."""
  batch = []
  for ex in examples:
    batch.append(ex)
    if len(batch) == batch_size:
      yield {k: np.stack([e[k] for e in batch]) for k in batch[0]}
      batch = []
  if batch and not drop_remainder:
    yield {k: np.stack([e[k] for e in batch]) for k in batch[0]}


class _TFRecordReader:
  """The tf.data graph shared by the three readers: files -> shard ->
  interleave -> (training: shuffle, repeat) -> map on a thread per CPU ->
  batch."""

  def __init__(self, file_pattern, is_training, batch_size, shuffle_buffer,
               drop_remainder, shard_index, num_shards, seed):
    self.file_pattern = file_pattern
    self.is_training = is_training
    self.batch_size = batch_size
    self.shuffle_buffer = shuffle_buffer
    self.drop_remainder = drop_remainder
    self.shard_index = shard_index
    self.num_shards = num_shards
    self.seed = seed

  def files(self, generator=None) -> list:
    files = list_files(self.file_pattern, self.is_training, generator)
    return files[self.shard_index::self.num_shards]

  def records(self) -> Iterator[bytes]:
    if not self.is_training:
      yield from interleave(self.files())
      return
    generator = torch.Generator().manual_seed(self.seed)
    while True:   # shuffle(buffer).repeat(): every epoch anew
      yield from shuffle_buffer(interleave(self.files(generator)),
                                self.shuffle_buffer, generator)

  def parse(self, record: bytes) -> dict:
    raise NotImplementedError

  def __iter__(self):
    return _batches(_ordered_map(self.parse, self.records(),
                                 os.cpu_count() or 1),
                    self.batch_size, self.drop_remainder)


class ImageNetTFRecordLoader(_TFRecordReader):
  """ImageNet-style TFRecords ('image/encoded', 'image/class/label') ->
  {'image': uint8 [B, S, S, 3] (eval: [B, S - 32, S - 32, 3], the
  reference's eval crop), 'label': f32 one-hot [B, num_classes]}.

  canvas_size should be about 1.15x the largest train size, so that the
  device-side random crop has room."""

  def __init__(self, file_pattern: str, is_training: bool, batch_size: int,
               canvas_size: int, num_classes: int,
               shuffle_buffer: int = 8192, drop_remainder: bool = True,
               shard_index: int = 0, num_shards: int = 1, seed: int = 0):
    super().__init__(file_pattern, is_training, batch_size, shuffle_buffer,
                     drop_remainder, shard_index, num_shards, seed)
    self.canvas_size = canvas_size
    self.num_classes = num_classes

  def parse(self, record: bytes) -> dict:
    ex = native_loader.parse_example(record)
    label = _int64(ex.get("image/class/label", [-1])[0])
    onehot = np.zeros((self.num_classes,), np.float32)
    if 0 <= label < self.num_classes:
      onehot[label] = 1.0
    return {"image": _cls_image(ex["image/encoded"][0], self.canvas_size,
                                self.is_training),
            "label": onehot}


class MultiLabelTFRecordLoader(_TFRecordReader):
  """ImageNet21k-style TFRecords ('image', 'labels') -> {'image': uint8
  canvas, 'label_ids': int32 [B, max_labels], -1 padded}; the multi-hot
  expansion stays on the device (datasets.multihot_on_device)."""

  def __init__(self, file_pattern: str, is_training: bool, batch_size: int,
               canvas_size: int, max_labels: int = 16,
               shuffle_buffer: int = 8192, drop_remainder: bool = True,
               shard_index: int = 0, num_shards: int = 1, seed: int = 0):
    super().__init__(file_pattern, is_training, batch_size, shuffle_buffer,
                     drop_remainder, shard_index, num_shards, seed)
    self.canvas_size = canvas_size
    self.max_labels = max_labels

  def parse(self, record: bytes) -> dict:
    ex = native_loader.parse_example(record)
    ids = [_int64(v) for v in ex.get("labels", [])][:self.max_labels]
    label_ids = np.full((self.max_labels,), -1, np.int32)
    label_ids[:len(ids)] = ids
    return {"image": _cls_image(ex["image"][0], self.canvas_size,
                                self.is_training),
            "label_ids": label_ids}


class DetectionTFRecordLoader(_TFRecordReader):
  """COCO-style detection TFRecords -> fixed-shape batches: image uint8
  [B, S, S, 3] (aspect-preserving resize, content top-left, zero pad),
  true_hw f32 [B, 2] (the content size, not rounded), gt_boxes f32 [B, G,
  4] canvas coordinates, gt_classes int32 [B, G] (-1 padded), image_scale
  f32 [B] (source / canvas) and source_id f32 [B]. Crowd boxes are skipped
  in training (skip_crowd_during_training); an eval pass keeps its last,
  partial batch."""

  def __init__(self, file_pattern: str, is_training: bool, batch_size: int,
               canvas_size: int, max_instances: int = 100,
               skip_crowd_during_training: bool = True,
               shuffle_buffer: int = 4096, shard_index: int = 0,
               num_shards: int = 1, seed: int = 0):
    super().__init__(file_pattern, is_training, batch_size, shuffle_buffer,
                     is_training, shard_index, num_shards, seed)
    self.canvas_size = canvas_size
    self.max_instances = max_instances
    self.skip_crowd = is_training and skip_crowd_during_training

  def parse(self, record: bytes) -> dict:
    ex = native_loader.parse_example(record)
    image = native_loader.jpeg_decode_full(ex["image/encoded"][0])
    size, g = self.canvas_size, self.max_instances
    h, w = np.float32(image.shape[0]), np.float32(image.shape[1])
    scale = np.float32(size) / max(h, w)
    nh, nw = int(np.round(h * scale)), int(np.round(w * scale))
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:nh, :nw] = native_loader.resize_bilinear(image, nh, nw)
    coord = lambda k: np.asarray(ex.get(f"image/object/bbox/{k}", []),
                                 np.float32)
    boxes = np.stack([coord("ymin") * h, coord("xmin") * w,
                      coord("ymax") * h, coord("xmax") * w], 1) * scale
    labels = np.asarray([_int64(v) for v in
                         ex.get("image/object/class/label", [])], np.int32)
    if self.skip_crowd:
      crowd = np.asarray(ex.get("image/object/is_crowd", []), bool)
      boxes, labels = boxes[~crowd], labels[~crowd]
    n = min(len(labels), g)
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_boxes[:n] = boxes[:n]
    gt_classes = np.full((g,), -1, np.int32)
    gt_classes[:n] = labels[:n]
    sid = ex.get("image/source_id", [b"0"])[0] or b"0"
    return {"image": canvas,
            "true_hw": np.array([h * scale, w * scale], np.float32),
            "gt_boxes": gt_boxes, "gt_classes": gt_classes,
            "image_scale": np.float32(1.0) / scale,
            "source_id": np.float32(float(sid))}


# ---------------------------------------------------------------------------
# Device prefetcher: host batches staged onto the device while the step
# runs.
# ---------------------------------------------------------------------------


class _Failed:
  def __init__(self, exc: BaseException):
    self.exc = exc


class DevicePrefetcher:
  """Wraps a host batch iterator: a background thread stages each batch
  ({name: array}) into pinned host memory and copies it to `device` on a
  side CUDA stream, buffer_size batches ahead; the consumer's stream waits
  on the batch's event before it is handed over. On a CPU device the
  batches become CPU tensors. An exception in the host iterator is raised
  in the consumer. close() stops the thread."""

  def __init__(self, host_iter, device="cuda", buffer_size: int = 2):
    self.device = torch.device(device)
    self._q = queue.Queue(maxsize=buffer_size)
    self._stop = threading.Event()
    cuda = self.device.type == "cuda"
    self._stream = torch.cuda.Stream(self.device) if cuda else None
    self._thread = threading.Thread(target=self._stage, args=(host_iter,),
                                    daemon=True)
    self._thread.start()

  def _put(self, item) -> bool:
    while not self._stop.is_set():
      try:
        self._q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _stage(self, host_iter):
    try:
      for batch in host_iter:
        if self._stop.is_set():
          return
        host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        event = None
        if self._stream is not None:
          with torch.cuda.stream(self._stream):
            staged = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        else:
          staged = host
        if not self._put((staged, event)):
          return
    except Exception as e:  # handed to the consumer, raised there
      self._put(_Failed(e))
    finally:
      self._put(None)  # the end of the stream

  def __iter__(self):
    while True:
      item = self._q.get()
      if item is None:
        return
      if isinstance(item, _Failed):
        raise item.exc
      staged, event = item
      if event is not None:
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for v in staged.values():
          v.record_stream(consumer)
      yield staged

  def close(self):
    self._stop.set()
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass
    self._thread.join(timeout=10)
