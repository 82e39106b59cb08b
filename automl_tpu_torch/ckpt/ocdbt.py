"""OCDBT key-value stores (tensorstore's format), read and written without
tensorstore.

An orbax checkpoint of the JAX package keeps its arrays in one such store
per step (<step>/default/). The store is a directory:
  manifest.ocdbt     the configuration and the versions: each version's
                     B-tree root (file, offset, length, height);
  d/<name>           data files: B-tree nodes and values;
  ocdbt.process_<n>/ the stores each process wrote, whose data files a
                     merged top manifest's nodes point into.
Manifests and nodes start with a header {magic uint32 big-endian, length
uint64, version varint, compression varint (0 none, 1 zstd)}, then the
body (a Zstandard frame where compressed) and end with the CRC32C of all
that came before (uint32). Integers in bodies are LEB128 varints; arrays
of records are stored column by column. A node holds its height, a table
of the data files it points into ({base path, relative path}, each path
sharing a prefix with the one before) and its entries, their keys
prefix-compressed: a leaf's values inline or as (file, offset, length)
references; an interior node's children as such references, each with
the length of the key prefix its subtree shares, which the child's keys
leave out.

OcdbtStore reads the newest version; write_store writes the smallest store
that tensorstore and orbax read back: one version whose root is one leaf.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from typing import NamedTuple

import numpy as np

from automl_tpu_torch.ckpt import zstd

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
# orbax's configuration (tensorstore's defaults as orbax opens a store)
MAX_INLINE_VALUE_BYTES = 1024
_MAX_DECODED_NODE_BYTES = 100_000_000
_VERSION_TREE_ARITY_LOG2 = 4


class Ref(NamedTuple):
  """A value or node in a data file: its path and byte range."""
  path: str
  offset: int
  length: int


class _Reader:
  """Bounds-checked reads of a decoded body; ValueError naming `what`."""

  def __init__(self, data: bytes, what: str):
    self.data, self.pos, self.what = data, 0, what

  def fail(self, msg: str):
    raise ValueError(f"{self.what}: {msg}")

  def take(self, n: int) -> bytes:
    if n < 0 or self.pos + n > len(self.data):
      self.fail("truncated")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def u8(self) -> int:
    return self.take(1)[0]

  def varint(self) -> int:
    value = shift = 0
    while True:
      if self.pos >= len(self.data) or shift > 63:
        self.fail("truncated or overlong varint")
      c = self.data[self.pos]
      self.pos += 1
      value |= (c & 0x7F) << shift
      shift += 7
      if c < 0x80:
        return value

  def varints(self, n: int) -> list[int]:
    return [self.varint() for _ in range(n)]

  def end(self):
    if self.pos != len(self.data):
      self.fail(f"{len(self.data) - self.pos} bytes left over")


def _open_frame(raw: bytes, magic: int, what: str) -> bytes:
  """The body of a manifest or node file: header, length and CRC32C
  checked, decompressed where it says zstd."""
  if len(raw) < 4 + 8 + 2 + 4:
    raise ValueError(f"{what}: truncated ({len(raw)} bytes)")
  got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from(
      "<Q", raw, 4)[0]
  if got_magic != magic:
    raise ValueError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
  if length != len(raw):
    raise ValueError(f"{what}: says {length} bytes, has {len(raw)}")
  want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
  got = zstd.crc32c(np.frombuffer(raw, np.uint8, len(raw) - 4))
  if got != want:
    raise ValueError(f"{what}: CRC32C {got:#010x}, stored {want:#010x}")
  r = _Reader(raw[:-4], what)
  r.pos = 12
  version, compression = r.varint(), r.varint()
  if version != 0:
    raise ValueError(f"{what}: format version {version}")
  body = raw[r.pos:-4]
  if compression == 0:
    return body
  if compression == 1:
    return zstd.decompress(body, what)
  raise ValueError(f"{what}: compression {compression}")


def _close_frame(body: bytes, magic: int) -> bytes:
  """A manifest or node file of `body`, compressed as a frame of raw
  blocks (what orbax's zstd configuration reads)."""
  payload = zstd.raw_frame(body).tobytes()
  head_len = 4 + 8 + 2
  length = head_len + len(payload) + 4
  head = struct.pack(">I", magic) + struct.pack("<Q", length) + b"\x00\x01"
  data = head + payload
  return data + struct.pack("<I", zstd.crc32c(data))


def _varint(v: int) -> bytes:
  out = bytearray()
  while True:
    b = v & 0x7F
    v >>= 7
    if v:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _read_data_files(r: _Reader) -> list[str]:
  """A data file table: each file's path (base path + relative path)."""
  n = r.varint()
  prefix = [0] + r.varints(n - 1) if n else []
  suffix = r.varints(n)
  base = r.varints(n)
  paths, prev = [], b""
  for i in range(n):
    if prefix[i] > len(prev):
      r.fail("data file prefix longer than the path before")
    full = prev[:prefix[i]] + r.take(suffix[i])
    if base[i] > len(full):
      r.fail("data file base path longer than its path")
    paths.append(full.decode())
    prev = full
  return paths


def _read_keys(r: _Reader, n: int, interior: bool):
  """A node's keys and, in an interior node, the length of the key prefix
  each child's subtree shares (a column between the key lengths and the
  key bytes)."""
  prefix = [0] + r.varints(n - 1) if n else []
  suffix = r.varints(n)
  common = r.varints(n) if interior else [0] * n
  keys, prev = [], b""
  for i in range(n):
    if prefix[i] > len(prev):
      r.fail("key prefix longer than the key before")
    prev = prev[:prefix[i]] + r.take(suffix[i])
    if common[i] > len(prev):
      r.fail("subtree prefix longer than its key")
    keys.append(prev)
  return keys, common


def _refs(r: _Reader, files: list[str], n: int) -> list[Ref]:
  file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
  out = []
  for f, o, ln in zip(file_ids, offsets, lengths):
    if f >= len(files):
      r.fail(f"data file {f} of {len(files)}")
    out.append(Ref(files[f], o, ln))
  return out


class OcdbtStore:
  """The newest version of the OCDBT store in `root` (a directory holding
  manifest.ocdbt), read at construction: list() its keys, read(key) a
  value. ValueError naming the file for a missing or malformed manifest,
  a bad node or a checksum mismatch."""

  def __init__(self, root: str):
    self.root = root
    path = os.path.join(root, MANIFEST)
    try:
      with open(path, "rb") as f:
        raw = f.read()
    except OSError as e:
      raise ValueError(f"no OCDBT manifest {path}: {e}") from e
    root_ref, height = self._manifest(raw, path)
    self._values: dict[str, bytes | Ref] = {}
    if root_ref is not None:
      self._walk(root_ref, height, b"")

  def _manifest(self, raw: bytes, what: str):
    r = _Reader(_open_frame(raw, _MANIFEST_MAGIC, what), what)
    r.take(16)                                   # uuid
    kind = r.varint()
    if kind != 0:
      r.fail(f"manifest kind {kind} (numbered manifests are not read)")
    r.varint()                                   # max_inline_value_bytes
    r.varint()                                   # max_decoded_node_bytes
    r.u8()                                       # version_tree_arity_log2
    if r.varint() == 1:                          # zstd compression: level
      r.take(4)
    files = _read_data_files(r)
    n = r.varint()
    generations = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    roots = _refs(r, files, n)
    r.varints(3 * n)                             # statistics
    r.take(8 * n)                                # commit times
    m = r.varint()                               # older versions' nodes
    r.varints(m)                                 # generation numbers
    _refs(r, files, m)
    r.varints(m)                                 # generations each covers
    r.take(8 * m)                                # commit times
    r.take(m)                                    # heights
    r.end()
    if n == 0:
      if m:
        r.fail("versions only in version tree nodes")
      return None, 0
    if generations != sorted(generations):
      r.fail("versions out of order")
    # the newest version, which tensorstore keeps inline
    return roots[-1], heights[-1]

  def _fetch(self, ref: Ref) -> bytes:
    """The bytes `ref` names (thread-safe: each call opens its file)."""
    path = os.path.join(self.root, ref.path)
    try:
      fd = os.open(path, os.O_RDONLY)
    except OSError as e:
      raise ValueError(f"OCDBT data file {path}: {e}") from e
    try:
      data = os.pread(fd, ref.length, ref.offset)
    finally:
      os.close(fd)
    if len(data) != ref.length:
      raise ValueError(f"OCDBT data file {path}: {len(data)} bytes at "
                       f"{ref.offset}, want {ref.length}")
    return data

  def _walk(self, ref: Ref, height: int, prefix: bytes):
    what = f"OCDBT node {ref.path}@{ref.offset}"
    r = _Reader(_open_frame(self._fetch(ref), _NODE_MAGIC, what), what)
    if r.u8() != height:
      r.fail(f"height differs from its parent's reference ({height})")
    files = _read_data_files(r)
    n = r.varint()
    keys, common = _read_keys(r, n, height > 0)
    if height == 0:
      lengths = r.varints(n)
      kinds = [r.u8() for _ in range(n)]
      if any(k > 1 for k in kinds):
        r.fail("value kind other than inline (0) or indirect (1)")
      indirect = [i for i in range(n) if kinds[i]]
      ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
      for i in range(n):
        if not kinds[i]:
          self._values[(prefix + keys[i]).decode()] = r.take(lengths[i])
      for j, i in enumerate(indirect):
        if ids[j] >= len(files):
          r.fail(f"data file {ids[j]} of {len(files)}")
        self._values[(prefix + keys[i]).decode()] = Ref(
            files[ids[j]], offsets[j], lengths[i])
      r.end()
      return
    children = _refs(r, files, n)
    r.varints(3 * n)                             # statistics
    r.end()
    for key, c, child in zip(keys, common, children):
      self._walk(child, height - 1, prefix + key[:c])

  def list(self) -> list[str]:
    return sorted(self._values)

  def __contains__(self, key: str) -> bool:
    return key in self._values

  def read(self, key: str) -> bytes:
    """The value of `key`; KeyError where the store has none."""
    return self.read_many([key])[0]

  def read_many(self, keys) -> list[bytes]:
    """The values of `keys`, in order."""
    return [v if isinstance(v, bytes) else self._fetch(v)
            for v in (self._values[k] for k in keys)]


def write_store(root: str, items) -> int:
  """Writes (key, bytes-like) pairs as a new OCDBT store in `root`: values
  above MAX_INLINE_VALUE_BYTES (written as they come) and the B-tree's one
  leaf in one data file under d/, the rest inline in the leaf, then
  manifest.ocdbt with one version. Returns the bytes written."""
  os.makedirs(os.path.join(root, "d"), exist_ok=True)
  name = "d/" + uuid.uuid4().hex
  sizes, inline, offsets = {}, {}, {}
  total = 0
  with open(os.path.join(root, name), "wb") as f:
    for k, v in items:
      v = memoryview(v).cast("B")
      sizes[k] = v.nbytes
      if v.nbytes > MAX_INLINE_VALUE_BYTES:
        offsets[k] = total
        f.write(v)
        total += v.nbytes
      else:
        inline[k] = bytes(v)
    keys = sorted(sizes)
    node = bytearray([0])                              # height: a leaf
    node += _varint(1) + _varint(len(name)) + _varint(0) + name.encode()
    node += _varint(len(keys))
    prev, prefixes, suffixes = b"", [], []
    for k in (k.encode() for k in keys):
      p = os.path.commonprefix([k, prev])
      prefixes.append(len(p))
      suffixes.append(k[len(p):])
      prev = k
    node += b"".join(_varint(p) for p in prefixes[1:])
    node += b"".join(_varint(len(s)) for s in suffixes) + b"".join(suffixes)
    node += b"".join(_varint(sizes[k]) for k in keys)
    node += bytes(1 if k in offsets else 0 for k in keys)
    indirect = [k for k in keys if k in offsets]
    node += b"".join(_varint(0) for _ in indirect)     # data file 0
    node += b"".join(_varint(offsets[k]) for k in indirect)
    node += b"".join(inline[k] for k in keys if k in inline)
    node_file = _close_frame(bytes(node), _NODE_MAGIC)
    node_offset = total
    f.write(node_file)
    total += len(node_file)
  body = bytearray(uuid.uuid4().bytes)
  body += _varint(0)                                   # single manifest
  body += _varint(MAX_INLINE_VALUE_BYTES) + _varint(_MAX_DECODED_NODE_BYTES)
  body += bytes([_VERSION_TREE_ARITY_LOG2]) + _varint(1) + struct.pack("<i", 0)
  body += _varint(1) + _varint(len(name)) + _varint(0) + name.encode()
  body += _varint(1)                                   # one version
  body += _varint(1) + bytes([0])                      # generation, height
  body += _varint(0) + _varint(node_offset) + _varint(len(node_file))
  body += (_varint(len(keys)) + _varint(len(node_file))
           + _varint(node_offset))                     # statistics
  body += struct.pack("<Q", time.time_ns())
  body += _varint(0)                                   # no version nodes
  manifest = _close_frame(bytes(body), _MANIFEST_MAGIC)
  with open(os.path.join(root, MANIFEST), "wb") as f:
    f.write(manifest)
  return total + len(manifest)
