"""Where a streamed tile's time goes inside the Hopper K3b / K3c.

  python -m automl_tpu_torch.cli.xent_phases          # the LM slice's shapes
  python -m automl_tpu_torch.cli.xent_phases --m=4096 --v=32000 --d=2048

Builds csrc/xent_sm90.cu with XENT_PHASE_CLOCKS (clock64 stamps at the
steps of tiles 64-79 in the first block's two consumer warpgroups, a
separate library; the main build has no stamps), runs K3b and K3c once to
warm up and once to measure on bf16 operands made from a seed (cap
--cap), and prints per warpgroup the median SM clocks of a tile and of its
steps: waiting for the other blocks' partials, the dz pass (the partials
summed, exp and the cap, dz rounded and sent), issuing the next tile's
logit product, waiting for the other blocks' dz, the dz . Q product and
the next logits, sending the next partials, freeing the ring stage. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

STEPS = ("wait for partials", "dz pass", "issue next logits", "wait for dz",
         "dz . Q and next logits", "send next partials", "free the stage")


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
  lse, _ = xent.xent_fwd_kernel(x, w, targets, logit_cap=args.cap)
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
               None if parts is None else parts.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
      torch.cuda.synchronize()
      if err:
        raise RuntimeError(f"xent {which} launch failed: CUDA error {err}")
    clocks = (ctypes.c_longlong * (2 * 16 * 8))()
    if lib.automl_xent_phase_clocks(clocks):
      raise RuntimeError("could not read the phase clocks")
    stamps = np.array(clocks, dtype=np.int64).reshape(2, 16, 8)
    if streamed < 80 * 64:
      print(f"K3{'b' if which == 'dx' else 'c'}: fewer than 80 streamed "
            "tiles, no stamps")
      continue
    for wg in range(2):
      steps = np.median(np.diff(stamps[wg], axis=1), axis=0)
      tile = np.median(np.diff(stamps[wg][:, 0]))
      print(f"K3{'b' if which == 'dx' else 'c'} M {m} V {v} D {d}, "
            f"warpgroup {wg}: {tile:.0f} clocks a tile; " + ", ".join(
                f"{name} {c:.0f} ({100 * c / tile:.0f}%)"
                for name, c in zip(STEPS, steps)))
  return 0


if __name__ == "__main__":
  sys.exit(main())
