"""Zstandard frames, read and written without the zstandard package.

ctypes bindings for csrc/host/zstd.cc, a frame decoder written to RFC 8878
(the codec of every array chunk and B-tree node of the JAX package's orbax
checkpoints), its writer of frames made of raw blocks, and the unmasked
CRC32C of OCDBT's manifests and nodes. ctypes releases the GIL while a
frame decodes, so callers decode on threads (ckpt/orbax.py reads arrays on
a pool).

The library is built with g++ at first use into
build/automl_tpu_torch/zstd-<hash>.so, keyed by a hash of the source and
the flags. There is no fallback: without g++, or when the build fails,
every call raises a RuntimeError naming g++ and the source.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np

from automl_tpu_torch.ops import cuda_build

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "csrc" / "host"
          / "zstd.cc")
BUILD_DIR = SOURCE.parents[3] / "build" / "automl_tpu_torch"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build() -> pathlib.Path:
  """Compiles csrc/host/zstd.cc with g++ unless its library exists; returns
  the path. RuntimeError naming g++ and the source when it cannot."""
  return cuda_build.build_host_library(
      SOURCE, _FLAGS, "zstd", " (the Zstandard decoder of orbax checkpoints)",
      BUILD_DIR)


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = ctypes.CDLL(str(build()))
  i64 = ctypes.c_int64
  for name, res, args in [
      ("zstd_decompressed_bound", i64, [_U8P, i64]),
      ("zstd_decompress", i64, [_U8P, i64, _U8P, i64]),
      ("zstd_error_name", ctypes.c_char_p, [i64]),
      ("zstd_raw_frame_size", i64, [i64]),
      ("zstd_write_raw_frame", i64, [_U8P, i64, _U8P]),
      ("crc32c_update", ctypes.c_uint32, [ctypes.c_uint32, _U8P, i64])]:
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = res, args
  return lib


def _u8(data) -> np.ndarray:
  """A uint8 view of bytes-like data (no copy)."""
  return np.frombuffer(data, np.uint8) if not isinstance(
      data, np.ndarray) else data.reshape(-1).view(np.uint8)


def _ptr(arr: np.ndarray):
  return arr.ctypes.data_as(_U8P)


def _check(code: int, what: str) -> int:
  if code < 0:
    raise ValueError(f"{what}: {_lib().zstd_error_name(code).decode()}")
  return code


def decompress_into(frame, out: np.ndarray, what: str = "zstd") -> int:
  """Decodes every frame of `frame` into `out` (a contiguous array, seen as
  bytes); returns the bytes written. ValueError naming the fault."""
  src = _u8(frame)
  dst = out.reshape(-1).view(np.uint8)
  return _check(_lib().zstd_decompress(_ptr(src), src.size, _ptr(dst),
                                       dst.size), what)


def decompress(frame, what: str = "zstd") -> bytes:
  """The content of every frame of `frame` (bytes-like), concatenated.
  ValueError naming the fault for a malformed, truncated or corrupted
  input (a bad checksum included)."""
  src = _u8(frame)
  bound = _check(_lib().zstd_decompressed_bound(_ptr(src), src.size), what)
  out = np.empty(bound, np.uint8)
  n = decompress_into(src, out, what)
  return out[:n].tobytes()


def raw_frame(data) -> np.ndarray:
  """One Zstandard frame of raw blocks holding `data` (with its content
  size; no checksum), as uint8: what any Zstandard decoder reads back."""
  src = _u8(data)
  lib = _lib()
  out = np.empty(lib.zstd_raw_frame_size(src.size), np.uint8)
  lib.zstd_write_raw_frame(_ptr(src), src.size, _ptr(out))
  return out


def crc32c(data, crc: int = 0) -> int:
  """The CRC32C (Castagnoli) of `data`, unmasked, continuing from `crc`."""
  src = _u8(data)
  return int(_lib().crc32c_update(crc, _ptr(src), src.size))
