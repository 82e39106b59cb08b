"""Builds the package's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with nvcc for
sm_90a into `build/automl_tpu_torch/<name>-<hash>.so` at the root of the
checkout, keyed by a hash of the sources and the flags (macros a tool
defines get a library of their own), at first use, and loaded with
ctypes. Nothing here runs when the module is imported, so the
package imports where there is no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "automl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
  from torch.utils.cpp_extension import CUDA_HOME
  candidates = [shutil.which("nvcc")]
  if CUDA_HOME:
    candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
  for path in candidates:
    if path and os.path.exists(path):
      return path
  raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                     "the CUDA kernels of automl_tpu_torch cannot be built")


def _flags(defines=()):
  return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def library_path(name: str, defines=()) -> pathlib.Path:
  """Where `csrc/<name>.cu` builds to: the name (and the macros defined,
  lower case) plus a hash of its sources and flags."""
  digest = hashlib.sha256(" ".join(_flags(defines)).encode())
  for src in sorted(CSRC.glob("*.cu*")):  # .cu and shared .cuh headers
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  tag = "".join(f"-{d.lower()}" for d in defines)
  return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines=()) -> pathlib.Path:
  """Compiles `csrc/<name>.cu` (with `defines`: macros, -D) unless its
  library exists; returns the path.

  The compiler's resource report (-Xptxas -v: registers, shared memory,
  spills per kernel) is kept beside the library as `<library>.log`."""
  out = library_path(name, defines)
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    tmp_out = pathlib.Path(tmp) / out.name
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp_out),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                         f"{proc.stdout}\n{proc.stderr}")
    (out.parent / (out.name + ".log")).write_text(proc.stdout + proc.stderr)
    os.replace(tmp_out, out)  # atomic: a concurrent build sees all or none
  return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
  """The ctypes handle of `csrc/<name>.cu`, built at first use."""
  return ctypes.CDLL(str(build(name)))
