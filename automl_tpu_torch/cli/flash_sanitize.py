"""The flash-attention kernels under compute-sanitizer, on the card.

  python -m automl_tpu_torch.cli.flash_sanitize            # every tool, case
  python -m automl_tpu_torch.cli.flash_sanitize --case=sm90   # one case, no
                                                  # sanitizer (what it runs)
  python -m automl_tpu_torch.cli.flash_sanitize --loop=20  # no sanitizer:
      # chip_smoke.py --profile, then the GQA autograd card test 20 times
  python -m automl_tpu_torch.cli.flash_sanitize --case=cpu_repeat
      # the CPU side of that test's split case, repeated and diffed

Without --case it builds the kernels, then runs itself once per (tool,
case) under `compute-sanitizer --tool <tool> --error-exitcode 7`, tools
racecheck, synccheck and initcheck, and prints each run's summary line and
exit code. Cases:
  simt: the scalar-FMA kernels of csrc/flash_attention.cu (K1, K5a, K5b,
    K2) in f32 at the shapes of the card test
    test_flash_attention_autograd_gqa_on_card_matches_cpu: GQA 4/2 (k and v
    repeated), T 90, hd 32, window 24, cap 50, segment ids;
  sm90: the Hopper K1 and K2 of csrc/flash_attention_sm90.cu in bf16 at a
    small shape: B 1, T 200 (ragged), N 2, hd 64, window 70, cap 50,
    segment ids, and hd 128, T 130, causal.
Exits non-zero if compute-sanitizer is missing or any run fails.

--case=cpu_repeat (no sanitizer) runs the CPU side of
test_flash_attention_autograd_gqa_on_card_matches_cpu[split] (the plain
versions of K1, K5a and K5b on the same seeded inputs) REPEATS times with
torch's default threads and REPEATS times with one thread, keeps every
intermediate (the scores, out, lse, p, ds, and out / dq / dk / dv through
autograd) and prints, per intermediate, how many runs differ from the
first and by how much; with the machine's load and its other python
processes. Exits non-zero if a one-thread run differs.

--loop=N reproduces the conditions of the failures of
test_flash_attention_autograd_gqa_on_card_matches_cpu seen on the card
(right after chip_smoke.py --profile, or after its full run: --after=''),
runs --case=cpu_repeat once in a fresh process, and then that test (both
backwards) N times, each in a fresh process; prints each run's last line
(and the failure's message), how many runs passed, and exits non-zero if
one failed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

TOOLS = ("racecheck", "synccheck", "initcheck")
CASES = ("simt", "sm90")
REPEATS = 40


def _inputs(b, t, n, h, dtype, seed, segments):
  import torch
  gen = torch.Generator(device="cuda").manual_seed(seed)
  q, k, v, g = (torch.randn((b, t, n, h), generator=gen, device="cuda")
                .to(dtype) for _ in range(4))
  segs = None
  if segments:
    segs = torch.cumsum((torch.rand((b, t), generator=gen, device="cuda")
                         < 0.05).int(), dim=1).int().contiguous()
  return q, k, v, g, segs


def run_case(case: str) -> None:
  import torch
  from automl_tpu_torch.ops import attention as fa
  if case == "simt":
    q, _, _, g, segs = _inputs(2, 90, 4, 32, torch.float32, 1, True)
    _, k, v, _, _ = _inputs(2, 90, 2, 32, torch.float32, 2, False)
    k, v = (x.repeat_interleave(2, dim=2) for x in (k, v))
    kw = dict(causal=True, window=24, logit_cap=50.0, sm_scale=32 ** -0.5)
    out, lse = fa.flash_fwd_kernel(q, k, v, segs, **kw)
    args = (q, k, v, g, out, lse, segs)
    fa.flash_bwd_dq_kernel(*args, **kw)
    fa.flash_bwd_dkv_kernel(*args, **kw)
    fa.flash_bwd_kernel(*args, **kw)
  else:
    for b, t, n, h, kw, segments in (
        (1, 200, 2, 64, dict(window=70, logit_cap=50.0), True),
        (1, 130, 2, 128, dict(), False)):
      q, k, v, g, segs = _inputs(b, t, n, h, torch.bfloat16, 3, segments)
      kw = dict(kw, causal=True, sm_scale=h ** -0.5)
      out, lse = fa.flash_fwd_kernel(q, k, v, segs, **kw)
      fa.flash_bwd_kernel(q, k, v, g, out, lse, segs, **kw)
  torch.cuda.synchronize()
  print(f"case {case}: ran")


def cpu_repeat() -> int:
  """The CPU side of the GQA autograd card test, repeated and diffed."""
  import torch
  from automl_tpu_torch.ops import attention as fa
  q, _, _, g, segs = _inputs(2, 90, 4, 32, torch.float32, 1, True)
  _, k, v, _, _ = _inputs(2, 90, 2, 32, torch.float32, 2, False)
  q, k, v, g, segs = (x.cpu() for x in (q, k, v, g, segs))
  kr, vr = (x.repeat_interleave(2, dim=2) for x in (k, v))
  kw = dict(causal=True, window=24, logit_cap=50.0, sm_scale=32 ** -0.5)

  def run():
    s, _ = fa._scores(q, kr, 50.0, 32 ** -0.5)
    out, lse = fa.flash_fwd_reference(q, kr, vr, segs, **kw)
    p, ds = fa._bwd_terms(q, kr, vr, g, out, lse, segs, kw["causal"],
                          kw["window"], 50.0, kw["sm_scale"])
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out_ag = fa.flash_attention(*xs, segment_ids=segs, window=24,
                                logit_cap=50.0, bwd_fused=False)
    out_ag.backward(g)
    return dict(scores=s, out=out, lse=lse, p=p, ds=ds, autograd_out=out_ag,
                dq=xs[0].grad, dk=xs[1].grad, dv=xs[2].grad)

  others = subprocess.run(["ps", "-eo", "pid,pcpu,etime,comm,args"],
                          capture_output=True, text=True).stdout.splitlines()
  others = [l for l in others[1:]
            if "python" in l and str(os.getpid()) not in l]
  print(f"cpu_repeat: load average {os.getloadavg()}, {os.cpu_count()} CPUs, "
        f"{len(others)} other python processes")
  for line in others[:10]:
    print(f"  {line[:160]}")
  threads = torch.get_num_threads()
  one_thread_differs = False
  for n_threads in (threads, 1):
    torch.set_num_threads(n_threads)
    first = run()
    differs = {name: [] for name in first}
    for _ in range(REPEATS - 1):
      for name, x in run().items():
        if not torch.equal(x, first[name]):
          differs[name].append(float((x - first[name]).abs().max()))
    torch.set_num_threads(threads)
    print(f"cpu_repeat, {n_threads} threads, {REPEATS} runs: " + ", ".join(
        f"{name} {len(d)} differ" + (f" (max {max(d):.2e})" if d else "")
        for name, d in differs.items()))
    one_thread_differs |= n_threads == 1 and any(differs.values())
  return 1 if one_thread_differs else 0


def loop(n: int, after: list[str]) -> int:
  root = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  proc = subprocess.run([sys.executable, "chip_smoke.py", *after],
                        cwd=root, capture_output=True, text=True, check=False)
  print(proc.stdout + proc.stderr)
  print(f"chip_smoke.py {' '.join(after)}: exit {proc.returncode}")
  diag = subprocess.run([sys.executable, "-m",
                         "automl_tpu_torch.cli.flash_sanitize",
                         "--case=cpu_repeat"], cwd=root, capture_output=True,
                        text=True, check=False)
  print(diag.stdout + diag.stderr[-2000:])
  test = ("tests/test_torch_kernels_cuda.py::"
          "test_flash_attention_autograd_gqa_on_card_matches_cpu")
  passed = 0
  for i in range(n):
    run = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                          "-p", "no:cacheprovider", "-q", test], cwd=root,
                         capture_output=True, text=True, check=False)
    passed += run.returncode == 0
    lines = run.stdout.strip().splitlines()
    print(f"run {i + 1}: exit {run.returncode}: {lines[-1] if lines else ''}")
    if run.returncode:
      print("\n".join(l for l in lines if l.startswith("E ")))
  print(f"{passed} of {n} runs passed")
  return 0 if passed == n and proc.returncode == 0 else 1


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--case", choices=(*CASES, "cpu_repeat"))
  parser.add_argument("--loop", type=int, default=0)
  parser.add_argument("--after", default="--profile",
                      help="chip_smoke.py's arguments for the run before "
                      "--loop's ('' for its full run)")
  args = parser.parse_args(argv)
  if args.case == "cpu_repeat":
    return cpu_repeat()
  if args.case:
    run_case(args.case)
    return 0
  if args.loop:
    return loop(args.loop, args.after.split())
  from automl_tpu_torch.ops import cuda_build
  for name in ("flash_attention", "flash_attention_sm90"):
    cuda_build.build(name)
  tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
  if not os.path.exists(tool):
    print("compute-sanitizer not found (PATH, /usr/local/cuda/bin)")
    return 1
  failed = 0
  for case in CASES:
    for name in TOOLS:
      cmd = [tool, "--tool", name, "--error-exitcode", "7", sys.executable,
             "-m", "automl_tpu_torch.cli.flash_sanitize", f"--case={case}"]
      proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                            check=False)
      lines = (proc.stdout + proc.stderr).splitlines()
      summary = [l for l in lines if "SUMMARY" in l or "Error" in l
                 or "error" in l][:12]
      print(f"{' '.join(cmd[:5])} ... --case={case}: exit {proc.returncode}")
      for line in summary or lines[-3:]:
        print(f"  {line}")
      failed += proc.returncode != 0
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
