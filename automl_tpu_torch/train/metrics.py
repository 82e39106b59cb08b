"""Training metrics: a JSONL writer and a step timer.

The counterpart of automl_tpu/train/metrics.py. It writes
model_dir/metrics.jsonl only: the JAX writer's TensorBoard events come
from clu, which is JAX-side.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
  """write(step, {name: scalar}) -> one line of model_dir/metrics.jsonl."""

  def __init__(self, model_dir: str):
    os.makedirs(model_dir, exist_ok=True)
    self._f = open(os.path.join(model_dir, "metrics.jsonl"), "a")

  def write(self, step: int, scalars: dict):
    rec = {"step": int(step), "time": time.time()}
    rec.update({k: float(v) for k, v in scalars.items()})
    self._f.write(json.dumps(rec) + "\n")
    self._f.flush()

  def close(self):
    self._f.close()


class StepTimer:
  """Steps/sec and examples/sec over a rolling window of steps."""

  def __init__(self, window: int = 50):
    self.window = window
    self._t0 = time.perf_counter()
    self._count = 0

  def tick(self, examples: int = 0) -> Optional[dict]:
    self._count += 1
    if self._count % self.window:
      return None
    dt = time.perf_counter() - self._t0
    out = {"steps_per_sec": self.window / dt}
    if examples:
      out["examples_per_sec"] = examples * self.window / dt
    self._t0 = time.perf_counter()
    return out
