"""Where a streamed tile's time goes inside the Hopper K3a / K3b / K3c.

  python -m automl_tpu_torch.cli.xent_phases          # the LM slice's shapes
  python -m automl_tpu_torch.cli.xent_phases --m=4096 --v=32000 --d=2048

Builds csrc/xent_sm90.cu with XENT_PHASE_CLOCKS (clock64 stamps at the
steps of tiles 64-79 in the first block's two consumer warpgroups, a
separate library; the main build has no stamps), runs K3a, K3b and K3c
once to warm up and once to measure on bf16 operands made from a seed
(cap --cap), and prints per warpgroup the median SM clocks of a tile and
of its steps. K3a up to D 1,024: a tile's products (with the waits for
its chunks), then its cap, exp and online softmax; above it: issuing the
next tile's logit product, waiting for the other blocks' partials, the
pass (the partials summed, the cap, the online max and sum of exp),
waiting for the next logits and freeing the ring stage, sending the next
partials. K3b / K3c: waiting for the other blocks'
partials, the dz pass (the partials summed, exp and the cap, dz rounded
and sent), issuing the next tile's logit product, waiting for the other
blocks' dz, the dz . Q product and the next logits, sending the next
partials, freeing the ring stage. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

STEPS = ("wait for partials", "dz pass", "issue next logits", "wait for dz",
         "dz . Q and next logits", "send next partials", "free the stage")
FWD_STEPS = ("issue next logits", "wait for partials", "(m, l, t) pass",
             "wait for next logits, free the stage", "send next partials")
# K3a up to D 1,024 (x resident; both warpgroups on every vocab tile).
RESIDENT_STEPS = ("the tile's products (with the waits for its chunks)",
                  "cap, exp and the online softmax")


def _report(kid, m, v, d, stamps, steps):
  """Per warpgroup: the median clocks of a tile and of each of its steps."""
  import numpy as np
  for wg in range(2):
    diffs = np.median(np.diff(stamps[wg][:, :len(steps) + 1], axis=1),
                      axis=0)
    tile = np.median(np.diff(stamps[wg][:, 0]))
    print(f"{kid} M {m} V {v} D {d}, warpgroup {wg}: {tile:.0f} clocks a "
          "tile; " + ", ".join(f"{name} {c:.0f} ({100 * c / tile:.0f}%)"
                               for name, c in zip(steps, diffs)))


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--m", type=int, default=16384)
  parser.add_argument("--v", type=int, default=100_864)
  parser.add_argument("--d", type=int, default=1024)
  parser.add_argument("--cap", type=float, default=30.0)
  args = parser.parse_args(argv)
  import numpy as np
  import torch
  from automl_tpu_torch.ops import cuda_build, xent
  if not torch.cuda.is_available():
    print("xent_phases: no CUDA device", file=sys.stderr)
    return 1
  card = subprocess.run(
      ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=False).stdout.strip()
  print(f"card: {card}; torch {torch.__version__}")
  lib = ctypes.CDLL(str(cuda_build.build("xent_sm90",
                                         defines=("XENT_PHASE_CLOCKS",))))
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  dev = torch.device("cuda:0")
  gen = torch.Generator(device=dev).manual_seed(0)
  m, v, d = args.m, args.v, args.d
  x = torch.randn((m, d), generator=gen, device=dev).bfloat16()
  w = (torch.randn((v, d), generator=gen, device=dev) * 0.05).bfloat16()
  targets = torch.randint(0, v, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
  coef = torch.full((m,), 1.0 / m, device=dev)
  stream = torch.cuda.current_stream().cuda_stream
  clocks = (ctypes.c_longlong * (2 * 16 * 8))()

  def read_stamps():
    if lib.automl_xent_phase_clocks(clocks):
      raise RuntimeError("could not read the phase clocks")
    return np.array(clocks, dtype=np.int64).reshape(2, 16, 8)

  fwd = lib.automl_xent_fwd_sm90
  fwd.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_float, i32, i32, ptr, ptr]
  fwd.restype = i32
  tiles = -(-m // 128)
  n_whole, n_split = (
      (tiles, 1) if d <= xent.SM90_RESIDENT_DIM else
      xent.split_plan(tiles, xent.sm90_clusters(d, "fwd"), -(-v // 64)))
  lse = torch.empty((m,), device=dev)
  tz = torch.empty((m,), device=dev)
  parts = (torch.empty(((tiles - n_whole) * n_split, 3, 128), device=dev)
           if n_split > 1 else None)
  for _ in range(2):
    err = fwd(x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(),
              tz.data_ptr(), m, v, d, args.cap, n_whole, n_split,
              None if parts is None else parts.data_ptr(), stream)
    torch.cuda.synchronize()
    if err:
      raise RuntimeError(f"xent fwd launch failed: CUDA error {err}")
  if v < 80 * (128 if d <= xent.SM90_RESIDENT_DIM else 64):
    print("K3a: too few vocab tiles, no stamps")
  else:
    _report("K3a", m, v, d, read_stamps(),
            RESIDENT_STEPS if d <= xent.SM90_RESIDENT_DIM else FWD_STEPS)
  for which, own, streamed in (("dx", m, v), ("dw", v, m)):
    fn = getattr(lib, f"automl_xent_{which}_sm90")
    fn.argtypes = [ptr] * 6 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr,
                                           ptr]
    fn.restype = i32
    tiles = -(-own // 128)
    n_whole, n_split = xent.split_plan(tiles, xent.sm90_clusters(d, which),
                                       -(-streamed // 64))
    out = torch.empty((own, d), device=dev)
    parts = (torch.empty(((tiles - n_whole) * n_split, 128, d), device=dev)
             if n_split > 1 else None)
    for _ in range(2):
      err = fn(x.data_ptr(), w.data_ptr(), targets.data_ptr(),
               lse.data_ptr(), coef.data_ptr(), out.data_ptr(), 0, m, v, d,
               args.cap, n_whole, n_split,
               None if parts is None else parts.data_ptr(), stream)
      torch.cuda.synchronize()
      if err:
        raise RuntimeError(f"xent {which} launch failed: CUDA error {err}")
    kid = f"K3{'b' if which == 'dx' else 'c'}"
    if streamed < 80 * 64:
      print(f"{kid}: fewer than 80 streamed tiles, no stamps")
      continue
    _report(kid, m, v, d, read_stamps(), STEPS)
  return 0


if __name__ == "__main__":
  sys.exit(main())
