"""LM learning-rate schedules as step -> lr functions.

The counterpart of automl_tpu/train/schedules.py::lm_lr. The arithmetic is
done in float32, as the JAX function's jnp ops do, so both give the same
rates. The vision schedules (warmup_lr, detection_lr) come with the
detection training slice: ROADMAP M5.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def lm_lr(name: str, base_lr: float, *, num_train_steps: int,
          warmup_steps: int = 1, end_decay: float = 0.1,
          decay_start: float | int | None = None,
          decay_steps: int | None = None,
          steps_after_decay: int | None = None) -> Callable:
  """LM schedule family: cosine_decay / constant with linear warmup.

  Steps are 1-based inside the schedule; cosine decays from `decay_start`
  (default: the end of warmup; a float in (0, 1) is a fraction of
  num_train_steps) over `decay_steps` down to `end_decay * lr`;
  `steps_after_decay` instead ends the decay that many steps before the
  end. Returns fn(step) -> lr as a Python float (an f32 value)."""
  if decay_steps is not None and steps_after_decay is not None:
    raise ValueError("Cannot specify both decay_steps and steps_after_decay.")
  if isinstance(decay_start, float) and 0.0 < decay_start < 1.0:
    decay_start = int(num_train_steps * decay_start)
  if steps_after_decay is not None:
    decay_steps = num_train_steps - steps_after_decay
    decay_steps -= decay_start if decay_start is not None else warmup_steps
  if decay_start is None:
    decay_start = warmup_steps
  if decay_steps is None:
    decay_steps = max(num_train_steps - decay_start, 1)
  if name not in ("constant", "cosine_decay"):
    raise ValueError(f"Unknown lm lr schedule {name!r}")
  f32 = np.float32

  def fn(step) -> float:
    s = f32(step) + f32(1.0)
    warmup_factor = np.minimum(s, f32(warmup_steps)) / f32(warmup_steps)
    if name == "constant":
      return float(f32(base_lr) * warmup_factor)
    progress = np.maximum(f32(0.0), s - f32(decay_start)) / f32(decay_steps)
    decay = (f32(1.0) + np.cos(np.minimum(progress, f32(1.0))
                               * f32(math.pi))) / f32(2.0)
    return float(f32(base_lr) * warmup_factor
                 * ((f32(1.0) - f32(end_decay)) * decay + f32(end_decay)))

  return fn
