"""A reader of TensorFlow's V2 checkpoint format (the tensor bundle) that
needs no TensorFlow: the port's counterpart of tf.train.load_checkpoint,
which automl_tpu/ckpt/tf_compat.py calls.

A checkpoint `prefix` is two kinds of files:

  prefix.index                      a LevelDB-style table: data blocks of
                                    prefix-compressed (key, value) entries
                                    with restart points, an index block of
                                    (last key, BlockHandle) entries, and a
                                    48-byte footer (the metaindex and index
                                    handles, then the table magic). Each
                                    block ends in a compression byte (0:
                                    none, the only kind TF writes) and the
                                    masked CRC32C of the block and that
                                    byte.
  prefix.data-0000k-of-0000n        the tensors' bytes, raw little-endian.

The entry of the empty key is a BundleHeaderProto (num_shards,
endianness, version); every other key is a tensor's name and its value a
BundleEntryProto (dtype, shape, shard_id, offset, size, crc32c: the masked
CRC32C of the tensor's bytes). The protos are read with the wire walker
of data/native_loader.py, and every CRC is checked by the host library
(csrc/host/tfrecord_jpeg.cc: crc32c_masked).

Tensors come back as numpy arrays. bfloat16 has no numpy dtype: it is
widened to float32, which is exact (its bits are the high half of the
float32's). What the reader cannot take raises a ValueError that names
it: a compressed block, a V1 checkpoint (no .index file), a big-endian
bundle, a string, resource or variant tensor that was asked for, a
partitioned (sliced) variable, a truncated file, and a CRC mismatch (the
tensor's name, or the index block's offset).
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from automl_tpu_torch.data import native_loader

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
BLOCK_TRAILER_SIZE = 5

# tensorflow/core/framework/types.proto: DataType -> numpy dtype
# (little-endian). DT_BFLOAT16 (14) is widened to float32.
DT_BFLOAT16 = 14
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
           DT_BFLOAT16: np.uint16}
_DTYPE_NAMES = {7: "string", 8: "complex64", 18: "complex128",
                20: "resource", 21: "variant"}


def _varint(buf: bytes, pos: int):
  return native_loader._read_varint(buf, pos)


def _int64(v: int) -> int:
  """A varint's unsigned 64 bits as a signed int64."""
  return v - (1 << 64) if v >= 1 << 63 else v


def _read_block(data: bytes, offset: int, size: int, where: str) -> bytes:
  """The block at `offset` of `size` bytes, its trailer checked."""
  end = offset + size + BLOCK_TRAILER_SIZE
  if offset < 0 or end > len(data):
    raise ValueError(f"{where}: block [{offset}, {end}) lies past the end of "
                     f"the table ({len(data)} bytes): truncated")
  block, trailer = data[offset:offset + size], data[offset + size:end]
  if trailer[0] != 0:
    raise ValueError(f"{where}: block at byte {offset} has compression type "
                     f"{trailer[0]} (only 0, none, is read)")
  (stored,) = struct.unpack("<I", trailer[1:])
  if native_loader.masked_crc32c(block + trailer[:1]) != stored:
    raise ValueError(f"{where}: CRC mismatch in the block at byte {offset}")
  return block


def _block_entries(block: bytes, where: str):
  """Yield (key, value) of one block: entries {varint32 shared, varint32
  non_shared, varint32 value_length, key suffix, value} up to the restart
  array (uint32 offsets, then their uint32 count). Each restart point must
  start an entry that shares no prefix."""
  if len(block) < 4:
    raise ValueError(f"{where}: block of {len(block)} bytes")
  (n_restarts,) = struct.unpack("<I", block[-4:])
  limit = len(block) - 4 * (n_restarts + 1)
  if limit < 0:
    raise ValueError(f"{where}: {n_restarts} restart points in a block of "
                     f"{len(block)} bytes")
  restarts = set(struct.unpack(f"<{n_restarts}I", block[limit:-4]))
  key, pos = b"", 0
  while pos < limit:
    start = pos
    shared, pos = _varint(block, pos)
    non_shared, pos = _varint(block, pos)
    n_value, pos = _varint(block, pos)
    if start in restarts and shared:
      raise ValueError(f"{where}: restart point {start} shares {shared} "
                       "bytes of the previous key")
    if shared > len(key) or pos + non_shared + n_value > limit:
      raise ValueError(f"{where}: corrupt entry at byte {start}")
    key = key[:shared] + block[pos:pos + non_shared]
    pos += non_shared
    yield key, block[pos:pos + n_value]
    pos += n_value


def _parse_header(value: bytes) -> dict:
  """BundleHeaderProto: num_shards (1), endianness (2: 0 little, 1 big);
  its version (3) is not needed."""
  out = {"num_shards": 1, "endianness": 0}
  for field, _, v in native_loader._walk_fields(value):
    if field == 1:
      out["num_shards"] = v
    elif field == 2:
      out["endianness"] = v
  return out


def _parse_shape(value: bytes) -> tuple:
  """TensorShapeProto: dim (2, repeated Dim{size 1}), unknown_rank (3)."""
  dims = []
  for field, _, v in native_loader._walk_fields(value):
    if field == 2:
      size = 0
      for f2, _, v2 in native_loader._walk_fields(v):
        if f2 == 1:
          size = _int64(v2)
      dims.append(size)
    elif field == 3 and v:
      raise ValueError("a tensor of unknown rank")
  return tuple(dims)


def _parse_entry(value: bytes) -> dict:
  """BundleEntryProto: dtype (1), shape (2), shard_id (3), offset (4),
  size (5), crc32c (6, fixed32), slices (7)."""
  out = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": None, "slices": 0}
  for field, _, v in native_loader._walk_fields(value):
    if field == 1:
      out["dtype"] = v
    elif field == 2:
      out["shape"] = _parse_shape(v)
    elif field == 3:
      out["shard_id"] = v
    elif field == 4:
      out["offset"] = _int64(v)
    elif field == 5:
      out["size"] = _int64(v)
    elif field == 6:
      (out["crc32c"],) = struct.unpack("<I", v)
    elif field == 7:
      out["slices"] += 1
  return out


def checkpoint_prefix(path: str) -> str:
  """The prefix of the checkpoint at `path`: a prefix itself, or a
  directory whose `checkpoint` file names the latest one (relative names
  are under the directory), as tf.train.load_checkpoint takes."""
  if os.path.isdir(path):
    state = os.path.join(path, "checkpoint")
    if not os.path.exists(state):
      raise FileNotFoundError(f"{path}: a directory without a 'checkpoint' "
                              "file naming the latest checkpoint")
    m = re.search(r'^model_checkpoint_path:\s*"(.*)"\s*$',
                  open(state).read(), re.M)
    if m is None:
      raise ValueError(f"{state}: no model_checkpoint_path")
    name = m.group(1)
    return name if os.path.isabs(name) else os.path.join(path, name)
  return path


class CheckpointReader:
  """The tensors of one TF V2 checkpoint (tf.train.load_checkpoint's
  reader): the index is read and checked when it is made, each tensor
  when it is asked for."""

  def __init__(self, path: str):
    prefix = checkpoint_prefix(path)
    index = prefix + ".index"
    if not os.path.exists(index):
      if os.path.isfile(prefix):
        raise ValueError(f"{prefix}: a V1 checkpoint (one file, no .index): "
                         "only the V2 format is read")
      raise FileNotFoundError(f"no checkpoint at {prefix} (no {index})")
    self.prefix = prefix
    with open(index, "rb") as f:
      data = f.read()
    entries, self.data_blocks = self._read_table(data, index)
    if b"" not in entries:
      raise ValueError(f"{index}: no BundleHeaderProto (empty key)")
    header = _parse_header(entries.pop(b""))
    if header["endianness"] != 0:
      raise ValueError(f"{index}: a big-endian bundle: only little-endian "
                       "is read")
    self.num_shards = int(header["num_shards"])
    self._entries = {k.decode(): _parse_entry(v) for k, v in entries.items()}

  @staticmethod
  def _read_table(data: bytes, where: str):
    """-> ({key: value} of every data block, the number of data blocks)."""
    if len(data) < FOOTER_SIZE:
      raise ValueError(f"{where}: {len(data)} bytes, shorter than the "
                       f"{FOOTER_SIZE}-byte table footer: truncated")
    footer = data[-FOOTER_SIZE:]
    lo, hi = struct.unpack("<II", footer[-8:])
    if (hi << 32) | lo != TABLE_MAGIC:
      raise ValueError(f"{where}: bad table magic {(hi << 32) | lo:#x}: not "
                       "a TF checkpoint index, or truncated")
    pos = 0
    _, pos = _varint(footer, pos)          # metaindex handle (empty)
    _, pos = _varint(footer, pos)
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    body = data[:-FOOTER_SIZE]
    entries = {}
    index_block = _read_block(body, index_off, index_size, where)
    n_blocks = 0
    for _, handle in _block_entries(index_block, where):
      n_blocks += 1
      off, p = _varint(handle, 0)
      size, _ = _varint(handle, p)
      block = _read_block(body, off, size, where)
      for key, value in _block_entries(block, where):
        entries[key] = value
    return entries, n_blocks

  def get_variable_to_shape_map(self) -> dict:
    return {k: list(e["shape"]) for k, e in self._entries.items()}

  def shard_path(self, shard: int) -> str:
    return f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"

  def get_tensor(self, name: str) -> np.ndarray:
    if name not in self._entries:
      raise KeyError(f"{name} is not in the checkpoint {self.prefix}")
    e = self._entries[name]
    if e["slices"]:
      raise ValueError(f"{name}: a partitioned variable ({e['slices']} "
                       "slices) is not read")
    if e["dtype"] not in _DTYPES:
      what = _DTYPE_NAMES.get(e["dtype"], f"DataType {e['dtype']}")
      raise ValueError(f"{name}: a {what} tensor is not read")
    dtype = np.dtype(_DTYPES[e["dtype"]]).newbyteorder("<")
    count = int(np.prod(e["shape"], dtype=np.int64))
    if e["size"] != count * dtype.itemsize:
      raise ValueError(f"{name}: {e['size']} bytes for shape {e['shape']} "
                       f"of {dtype}")
    out = np.empty(count, dtype)
    path = self.shard_path(e["shard_id"])
    with open(path, "rb") as f:
      f.seek(e["offset"])
      got = f.readinto(memoryview(out).cast("B"))
    if got != e["size"]:
      raise ValueError(f"{name}: {path} ends {e['size'] - got} bytes short "
                       "of the tensor: truncated")
    if (e["crc32c"] is not None
        and native_loader.masked_crc32c(out) != e["crc32c"]):
      raise ValueError(f"{name}: CRC mismatch in {path} (corrupt data)")
    out = out.reshape(e["shape"])
    if e["dtype"] == DT_BFLOAT16:
      out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def load_checkpoint(path: str) -> CheckpointReader:
  """tf.train.load_checkpoint's counterpart: a reader of the checkpoint at
  `path` (a prefix, or a directory with a `checkpoint` file)."""
  return CheckpointReader(path)


def load_tf_checkpoint(path: str) -> dict:
  """Every tensor of a TF checkpoint as {name: ndarray}, without the
  names that start with '_' (the object graph of a TF2 checkpoint) or
  that contain 'optimizer' (its slots), as automl_tpu's
  tf_compat.load_tf_checkpoint filters them."""
  reader = load_checkpoint(path)
  return {name: reader.get_tensor(name)
          for name in reader.get_variable_to_shape_map()
          if not name.startswith("_") and "optimizer" not in name.lower()}
