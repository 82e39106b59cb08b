"""The JAX package's orbax checkpoints, read and written without orbax.

automl_tpu/train/checkpoint.py::CheckpointManager saves a training state
with orbax's StandardSave into <directory>/<step>/:
  _CHECKPOINT_METADATA   JSON: the item handlers and timestamps;
  default/_METADATA      JSON: tree_metadata maps each leaf's path (a
                         tuple's repr) to its key_metadata (each key and
                         its key_type: 2 a dict key or a NamedTuple's
                         field, 1 a sequence index) and value_metadata
                         (skip_deserialize for a leaf with no array: None,
                         an empty dict or list);
  default/               an OCDBT store (ckpt/ocdbt.py) holding each array
                         as a zarr v2 array named by its keys joined with
                         '.': <name>/.zarray (JSON: shape, chunks, dtype,
                         compressor zstd, fill_value, order C) and a chunk
                         per grid cell, <name>/<i>.<j>... (a scalar's: 0).

read_step turns a step directory into the JAX tree (nested dicts and
lists) of torch tensors, each equal to orbax's restore bit for bit
(bfloat16 as torch.bfloat16); write_step writes such a tree as orbax does,
each array one chunk in a Zstandard frame of raw blocks.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import time

import numpy as np
import torch

from automl_tpu_torch.ckpt import ocdbt, zstd

ITEM = "default"
_CKPT_METADATA = "_CHECKPOINT_METADATA"
_TREE_METADATA = "_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
# zarr v2 dtype -> (numpy dtype of the bytes, torch dtype)
_DTYPES = {
    "<f4": (np.float32, torch.float32), "<f2": (np.float16, torch.float16),
    "<f8": (np.float64, torch.float64), "<i4": (np.int32, torch.int32),
    "<i8": (np.int64, torch.int64), "<u4": (np.uint32, torch.uint32),
    "|b1": (np.bool_, torch.bool), "bfloat16": (np.uint16, torch.bfloat16),
}
_ZARR_DTYPE = {t: z for z, (_, t) in _DTYPES.items()}
_THREADS = min(16, os.cpu_count() or 1)


def is_orbax_step(step_dir: str) -> bool:
  """Whether `step_dir` is a step directory orbax wrote (it holds
  _CHECKPOINT_METADATA or default/)."""
  return (os.path.exists(os.path.join(step_dir, _CKPT_METADATA))
          or os.path.isdir(os.path.join(step_dir, ITEM)))


def _tree_metadata(item_dir: str) -> dict:
  path = os.path.join(item_dir, _TREE_METADATA)
  try:
    with open(path) as f:
      meta = json.load(f)
  except (OSError, json.JSONDecodeError) as e:
    raise ValueError(f"orbax tree metadata {path}: {e}") from e
  if "tree_metadata" not in meta:
    raise ValueError(f"orbax tree metadata {path} has no tree_metadata")
  if meta.get("use_zarr3"):
    raise ValueError(f"{path}: zarr v3 arrays are not read (use_zarr3)")
  return meta["tree_metadata"]


def _empty(value_meta: dict):
  """The value of a leaf saved with no array."""
  kind = value_meta.get("value_type")
  return {"Dict": {}, "List": [], "Tuple": []}.get(kind)


def _as_lists(node):
  """Nested dicts whose keys are all ints (sequence indices) -> lists."""
  if not isinstance(node, dict):
    return node
  node = {k: _as_lists(v) for k, v in node.items()}
  if node and all(isinstance(k, int) for k in node):
    return [node.get(i) for i in range(max(node) + 1)]
  return node


class _ZArray:
  """A zarr v2 array's metadata, from its .zarray."""

  def __init__(self, name: str, raw: bytes):
    self.name = name
    try:
      meta = json.loads(raw)
    except json.JSONDecodeError as e:
      raise ValueError(f"{name}/.zarray: {e}") from e
    if meta.get("zarr_format") != 2:
      raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("dtype") not in _DTYPES:
      raise ValueError(f"{name}: dtype {meta.get('dtype')!r} is not read")
    if meta.get("order", "C") != "C" or meta.get("filters"):
      raise ValueError(f"{name}: order {meta.get('order')} / filters "
                       f"{meta.get('filters')} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
      raise ValueError(f"{name}: compressor {comp.get('id')!r} is not read")
    self.compressed = comp is not None
    self.shape = tuple(meta["shape"])
    self.chunks = tuple(meta["chunks"])
    if len(self.chunks) != len(self.shape) or any(c < 1 for c in self.chunks):
      raise ValueError(f"{name}: chunks {self.chunks} for shape {self.shape}")
    self.zdtype = meta["dtype"]
    self.np_dtype = _DTYPES[self.zdtype][0]
    self.sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    self.fill = 0 if fill is None else fill

  def cells(self):
    """(chunk key, the slices of the array it covers) of each grid cell."""
    grid = [math.ceil(s / c) for s, c in zip(self.shape, self.chunks)]
    for idx in np.ndindex(*grid):
      key = self.sep.join(str(i) for i in idx) if idx else "0"
      sl = tuple(slice(i * c, min((i + 1) * c, s))
                 for i, c, s in zip(idx, self.chunks, self.shape))
      yield f"{self.name}/{key}", sl


def _fill_value(z: _ZArray):
  if z.zdtype == "bfloat16":     # the bits of a float fill value
    return np.frombuffer(torch.tensor([float(z.fill)], dtype=torch.bfloat16)
                         .view(torch.int16).numpy().tobytes(), np.uint16)[0]
  if isinstance(z.fill, str):    # "NaN", "Infinity", "-Infinity"
    return float(z.fill)
  return z.fill


def _read_array(store: ocdbt.OcdbtStore, z: _ZArray) -> torch.Tensor:
  """The whole array, its chunks read and decoded (a missing chunk is the
  fill value); ValueError for a chunk of the wrong size."""
  out = np.empty(z.shape, z.np_dtype)
  cells = list(z.cells())
  if not all(key in store for key, _ in cells):
    out[...] = _fill_value(z)
  chunk_bytes = math.prod(z.chunks) * out.itemsize
  whole = z.chunks == z.shape
  for key, sl in cells:
    if key not in store:
      continue
    raw = store.read(key)
    if whole:     # decoded in place
      dst = out
    else:
      dst = np.empty(z.chunks, z.np_dtype)
    if z.compressed:
      n = zstd.decompress_into(raw, dst, what=f"chunk {key}")
    else:
      n = len(raw)
      if n == chunk_bytes:
        dst.reshape(-1).view(np.uint8)[:] = np.frombuffer(raw, np.uint8)
    if n != chunk_bytes:
      raise ValueError(f"chunk {key}: {n} bytes, want {chunk_bytes}")
    if not whole:
      out[sl] = dst[tuple(slice(0, s.stop - s.start) for s in sl)]
  t = torch.from_numpy(out)
  return t.view(torch.bfloat16) if z.zdtype == "bfloat16" else t


def read_step(step_dir: str, item: str = ITEM, only=None):
  """The tree saved in an orbax step directory: nested dicts (dict keys and
  NamedTuple fields) and lists (sequence indices) of CPU tensors; a leaf
  saved with no array is None, {} or [] as orbax restores it. only: the
  top-level keys to read (default: all). Arrays are read on a thread pool.
  ValueError naming the file for a missing manifest or metadata, a
  malformed store, zarr array or Zstandard frame."""
  item_dir = os.path.join(step_dir, item)
  store = ocdbt.OcdbtStore(item_dir)
  meta = _tree_metadata(item_dir)
  tree: dict = {}
  arrays = []          # (parent node, key, array name)
  for entry in meta.values():
    keys = [int(k["key"]) if k["key_type"] == 1 else k["key"]
            for k in entry["key_metadata"]]
    if only is not None and keys[0] not in only:
      continue
    node = tree
    for k in keys[:-1]:
      node = node.setdefault(k, {})
    value_meta = entry.get("value_metadata", {})
    if value_meta.get("skip_deserialize"):
      node[keys[-1]] = _empty(value_meta)
    else:
      arrays.append((node, keys[-1], ".".join(str(k) for k in keys)))
  zarrays = []
  for _, _, name in arrays:
    if f"{name}/.zarray" not in store:
      raise ValueError(f"{item_dir}: no array {name} (no {name}/.zarray)")
    zarrays.append(_ZArray(name, store.read(f"{name}/.zarray")))
  with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
    values = list(pool.map(lambda z: _read_array(store, z), zarrays))
  for (node, key, _), value in zip(arrays, values):
    node[key] = value
  return _as_lists(tree)


def _leaves(tree, path=()):
  """(path of (key, key_type), leaf) of a tree of dicts, lists / tuples
  (NamedTuples by field) and leaves, in orbax's order (dict keys sorted)."""
  if hasattr(tree, "_fields"):          # a NamedTuple: its fields, as keys
    tree = dict(zip(tree._fields, tree))
  if isinstance(tree, dict):
    if not tree:
      yield path, {}
    for k in sorted(tree):
      yield from _leaves(tree[k], path + ((str(k), 2),))
  elif isinstance(tree, (list, tuple)):
    if not tree:
      yield path, []
    for i, v in enumerate(tree):
      yield from _leaves(v, path + ((str(i), 1),))
  else:
    yield path, tree


def _contiguous(arr: np.ndarray) -> np.ndarray:
  """arr in C order (np.ascontiguousarray would make a scalar 1-d)."""
  return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _as_numpy(value):
  """(C-contiguous numpy array of the value's bytes, zarr dtype)."""
  if torch.is_tensor(value):
    t = value.detach().cpu().contiguous()
    if t.dtype not in _ZARR_DTYPE:
      raise ValueError(f"dtype {t.dtype} has no zarr v2 counterpart here")
    z = _ZARR_DTYPE[t.dtype]
    if t.dtype == torch.bfloat16:
      t = t.view(torch.int16)
    return _contiguous(t.numpy()), z
  arr = _contiguous(np.asarray(value))
  for z, (np_dtype, _) in _DTYPES.items():
    if z != "bfloat16" and arr.dtype == np_dtype:
      return arr, z
  raise ValueError(f"dtype {arr.dtype} has no zarr v2 counterpart here")


def write_step(step_dir: str, tree) -> int:
  """Writes `tree` (nested dicts, lists / tuples, NamedTuples; leaves
  torch tensors, numpy arrays or numbers, None) as orbax's StandardSave
  does into step_dir: _CHECKPOINT_METADATA, default/_METADATA and the
  OCDBT store of zarr v2 arrays, each one chunk compressed as a Zstandard
  frame of raw blocks. It is written under a temporary name and renamed,
  as orbax does, so a reader following the directory sees all of it or
  none. Returns the bytes written."""
  start = time.time_ns()
  tmp = f"{step_dir}.orbax-checkpoint-tmp-{start}"
  item_dir = os.path.join(tmp, ITEM)
  os.makedirs(item_dir)
  tree_meta = {}
  arrays = []
  for path, leaf in _leaves(tree):
    keys = [k for k, _ in path]
    entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
    if leaf is None or isinstance(leaf, (dict, list)):
      kind = ("None" if leaf is None else
              "Dict" if isinstance(leaf, dict) else "List")
      entry["value_metadata"] = {"value_type": kind,
                                 "skip_deserialize": True}
    else:
      entry["value_metadata"] = {"value_type": "np.ndarray",
                                 "skip_deserialize": False}
      arrays.append((".".join(keys), leaf))
    tree_meta[repr(tuple(keys))] = entry

  def items():
    for name, leaf in arrays:
      arr, z = _as_numpy(leaf)
      shape = list(arr.shape)
      zarray = {"chunks": [max(1, s) for s in shape],
                "compressor": {"id": "zstd", "level": 1},
                "dimension_separator": ".", "dtype": z, "fill_value": None,
                "filters": None, "order": "C", "shape": shape,
                "zarr_format": 2}
      yield f"{name}/.zarray", json.dumps(zarray,
                                          separators=(",", ":")).encode()
      if arr.size:
        key = ".".join("0" for _ in shape) if shape else "0"
        yield f"{name}/{key}", zstd.raw_frame(arr.reshape(-1).view(np.uint8))

  total = ocdbt.write_store(item_dir, items())
  meta = json.dumps({"tree_metadata": tree_meta, "use_ocdbt": True,
                     "use_zarr3": False,
                     "store_array_data_equal_to_fill_value": True,
                     "custom_metadata": None})
  with open(os.path.join(item_dir, _TREE_METADATA), "w") as f:
    f.write(meta)
  ckpt_meta = json.dumps({
      "item_handlers": {ITEM: _HANDLER}, "metrics": {},
      "performance_metrics": {}, "init_timestamp_nsecs": start,
      "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
  with open(os.path.join(tmp, _CKPT_METADATA), "w") as f:
    f.write(ckpt_meta)
  os.replace(tmp, step_dir)
  return total + len(meta) + len(ckpt_meta)
