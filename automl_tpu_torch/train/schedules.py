"""Learning-rate schedules as step -> lr functions.

The counterpart of automl_tpu/train/schedules.py: warmup_lr
(classification), lm_lr and detection_lr. The arithmetic is done in
float32, as the JAX functions' jnp ops do, so both give the same rates.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def warmup_lr(name: str, base_lr: float, *, steps_per_epoch: int | None = None,
              total_steps: int | None = None, warmup_epochs: float = 5,
              decay_epochs: float = 2.4, decay_factor: float = 0.97,
              minimal_lr: float = 0.0) -> Callable:
  """Classification schedule family: exponential (staircase, every
  decay_epochs), cosine, linear or constant, floored at minimal_lr, with a
  linear warm-up from 0 over warmup_epochs. fn(step) -> lr as a Python
  float (an f32 value)."""
  if name not in ("exponential", "cosine", "linear", "constant"):
    raise ValueError(f"Unknown lr schedule {name!r}")
  if name == "exponential" and steps_per_epoch is None:
    raise ValueError("the exponential schedule needs steps_per_epoch")
  if name in ("cosine", "linear") and total_steps is None:
    raise ValueError(f"the {name} schedule needs total_steps")
  f32 = np.float32

  def fn(step) -> float:
    step = f32(step)
    if name == "exponential":
      decay_steps = f32(steps_per_epoch * decay_epochs)
      lr = f32(base_lr) * f32(decay_factor) ** np.floor(step / decay_steps)
    elif name == "cosine":
      lr = f32(0.5 * base_lr) * (f32(1.0) + np.cos(
          f32(math.pi) * step / f32(total_steps)))
    elif name == "linear":
      lr = f32(base_lr) * np.maximum(f32(1.0) - step / f32(total_steps),
                                     f32(0.0))
    else:
      lr = f32(base_lr)
    if minimal_lr:
      lr = np.maximum(lr, f32(minimal_lr))
    if warmup_epochs and steps_per_epoch:
      warmup_steps = f32(warmup_epochs * steps_per_epoch)
      if step < warmup_steps:
        lr = f32(base_lr) * step / warmup_steps
    return float(lr)

  return fn


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


def detection_lr(config, steps_per_epoch: int) -> Callable:
  """Detection schedule: linear warmup from lr_warmup_init, then cosine /
  polynomial / stepwise / constant decay (config keys learning_rate,
  lr_warmup_init, lr_warmup_epoch, num_epochs, lr_decay_method,
  first/second_lr_drop_epoch, poly_lr_power). fn(step) -> lr as a Python
  float (an f32 value)."""
  f32 = np.float32
  base_lr = config.learning_rate
  warmup_init = config.lr_warmup_init
  warmup_steps = int(config.lr_warmup_epoch * steps_per_epoch)
  total_steps = int(config.num_epochs * steps_per_epoch)
  method = config.lr_decay_method
  if method not in ("cosine", "polynomial", "stepwise", "constant"):
    raise ValueError(f"Unknown lr_decay_method {method!r}")
  decay_steps = f32(max(total_steps - warmup_steps, 1))

  def fn(step) -> float:
    step = f32(step)
    if method == "cosine":
      lr = f32(0.5 * base_lr) * (f32(1.0) + np.cos(
          f32(math.pi) * (step - f32(warmup_steps)) / decay_steps))
    elif method == "polynomial":
      frac = np.clip((step - f32(warmup_steps)) / decay_steps, f32(0.0),
                     f32(1.0))
      lr = f32(base_lr) * (f32(1.0) - frac) ** f32(config.poly_lr_power)
    elif method == "stepwise":
      first = config.first_lr_drop_epoch * steps_per_epoch
      second = config.second_lr_drop_epoch * steps_per_epoch
      lr = f32(base_lr if step < first else
               base_lr * 0.1 if step < second else base_lr * 0.01)
    else:
      lr = f32(base_lr)
    if warmup_steps and step < warmup_steps:
      lr = f32(warmup_init) + f32(base_lr - warmup_init) * step / f32(
          warmup_steps)
    return float(lr)

  return fn
