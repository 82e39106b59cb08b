"""Times the flash-attention kernels (K1, K2, K5a, K5b) on the card.

  python -m automl_tpu_torch.cli.flash_bench            # the LM slice's shapes
  python -m automl_tpu_torch.cli.flash_bench --t=4096 --iters=20

For bf16 q, k, v, g [B, T, N, H] (causal, sm_scale 1, q scaled by
1/sqrt(H) as the model feeds it), with the tanh cap at --cap and at 0:
the forward K1, the fused backward K2 and the split backward's K5a (dq)
and K5b (dk, dv), each of the Hopper kernels (csrc/flash_attention_sm90.cu)
and of the scalar-FMA kernels (csrc/flash_attention.cu, reached with
`_simt`), in turns (Hopper, scalar, scalar, Hopper), CUDA events around
each call, L2 flushed before each. Prints one line per kernel and a JSON
line of the means. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _time_ms(fn, iters, flush):
  import torch
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(iters):
    flush()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--b", type=int, default=8)
  parser.add_argument("--t", type=int, default=2048)
  parser.add_argument("--n", type=int, default=8)
  parser.add_argument("--h", type=int, default=128)
  parser.add_argument("--cap", type=float, default=50.0)
  parser.add_argument("--iters", type=int, default=10)
  args = parser.parse_args(argv)
  import torch
  from automl_tpu_torch.ops import attention as fa
  if not torch.cuda.is_available():
    print("flash_bench: no CUDA device", file=sys.stderr)
    return 1
  card = subprocess.run(
      ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=False).stdout.strip()
  print(f"card: {card}; torch {torch.__version__}")
  dev = torch.device("cuda:0")
  gen = torch.Generator(device=dev).manual_seed(0)
  shape = (args.b, args.t, args.n, args.h)
  q, k, v, g = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                for _ in range(4))
  q = (q.float() * args.h ** -0.5).bfloat16()
  flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
  times = {}
  for cap in (args.cap, 0.0):
    kw = dict(causal=True, logit_cap=cap, sm_scale=1.0)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, **kw)
    bwd_args = (q, k, v, g, out, lse, None)
    runs = {
        "K1": lambda simt: fa.flash_fwd_kernel(q, k, v, None, _simt=simt,
                                               **kw),
        "K2": lambda simt: fa.flash_bwd_kernel(*bwd_args, _simt=simt, **kw),
        "K5a": lambda simt: fa.flash_bwd_dq_kernel(*bwd_args, _simt=simt,
                                                   **kw),
        "K5b": lambda simt: fa.flash_bwd_dkv_kernel(*bwd_args, _simt=simt,
                                                    **kw)}
    for kid, run in runs.items():
      got = {}
      for simt in (False, True, True, False):
        got.setdefault(simt, []).append(
            _time_ms(lambda: run(simt), args.iters, flush))
      for simt, ms in got.items():
        name = f"{kid} {'scalar FMA' if simt else 'Hopper'} cap {cap:g}"
        times[name] = sum(ms) / len(ms)
        print(f"{name}: {' / '.join(f'{x:.4f}' for x in ms)} ms "
              f"(b{args.b} T{args.t} N{args.n} hd{args.h}, L2 flushed)")
  print(json.dumps(times))
  return 0


if __name__ == "__main__":
  sys.exit(main())
