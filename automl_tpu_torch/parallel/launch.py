"""Runs a command as N local processes of one torch.distributed world.

For a world on one machine without torchrun: each process gets its rank,
the world size and a rendezvous (a file:// store, which needs no port),
and the launcher waits for all of them under one deadline. A process that
fails, or a deadline that passes, ends every process of the world, so a
hung collective becomes an error rather than a hang.

  results = run_local(lambda rank: [sys.executable, "worker.py", str(rank)],
                      nproc=4, timeout_secs=120)
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Callable, Optional, Sequence


def file_store(directory: str) -> str:
  """A fresh file:// rendezvous URL in `directory`."""
  fd, path = tempfile.mkstemp(prefix="store-", dir=directory)
  os.close(fd)
  os.unlink(path)
  return f"file://{path}"


def run_local(argv_for_rank: Callable[[int], Sequence[str]], nproc: int,
              timeout_secs: float, env=None,
              cwd: Optional[str] = None) -> list[str]:
  """Starts argv_for_rank(r) for r in [0, nproc), all at once, and waits.
  env: one environment for every process, or a function of the rank.
  Returns each process's output (stdout and stderr) when all exit 0;
  raises RuntimeError with the outputs when one fails (the others are
  ended) and TimeoutError when the deadline passes first."""
  env_for = env if callable(env) else (lambda r: env)
  outs = [tempfile.TemporaryFile(mode="w+") for _ in range(nproc)]
  procs = [subprocess.Popen(list(argv_for_rank(r)), stdout=outs[r],
                            stderr=subprocess.STDOUT, env=env_for(r),
                            cwd=cwd)
           for r in range(nproc)]
  deadline = time.monotonic() + timeout_secs
  failed = timed_out = False
  try:
    while any(p.poll() is None for p in procs):
      if any(p.returncode not in (None, 0) for p in procs):
        failed = True
        break
      if time.monotonic() > deadline:
        timed_out = True
        break
      time.sleep(0.05)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
      p.wait()
  texts = []
  for f in outs:
    f.seek(0)
    texts.append(f.read())
    f.close()
  report = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{t[-4000:]}"
                     for r, (p, t) in enumerate(zip(procs, texts)))
  if timed_out:
    raise TimeoutError(f"{nproc} processes passed {timeout_secs} s:\n{report}")
  if failed or any(p.returncode != 0 for p in procs):
    raise RuntimeError(f"a process of {nproc} failed:\n{report}")
  return texts
