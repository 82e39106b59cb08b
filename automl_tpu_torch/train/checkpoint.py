"""Checkpoints of training states with torch.save.

The counterpart of automl_tpu/train/checkpoint.py::CheckpointManager, with
its directory layout (<directory>/<step>/) and methods. A checkpoint holds
every field of a training state (a NamedTuple: step, params, opt_state and,
for the detection trainer, ema_params and normalizer) as CPU tensors in
<directory>/<step>/state.pt.
Saves are synchronous, so wait_until_finished has nothing to wait for.
archive_ckpt keeps the best checkpoint by an eval objective. Restoring the JAX package's orbax checkpoints needs jax: ROADMAP M9.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

_FILE = "state.pt"


def _to(tree, device):
  """Tensors of a nested dict / tuple / list moved to `device`, detached."""
  if torch.is_tensor(tree):
    return tree.detach().to(device, copy=True)
  if isinstance(tree, dict):
    return {k: _to(v, device) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_to(v, device) for v in tree)
  return tree


class CheckpointManager:
  """save / restore / latest_step over <directory>/<step>/state.pt, keeping
  the newest max_to_keep steps."""

  def __init__(self, directory: str, max_to_keep: int = 5):
    self.directory = os.path.abspath(directory)
    os.makedirs(self.directory, exist_ok=True)
    self.max_to_keep = max_to_keep

  def all_steps(self) -> list[int]:
    return sorted(int(name) for name in os.listdir(self.directory)
                  if name.isdigit() and os.path.exists(
                      os.path.join(self.directory, name, _FILE)))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state) -> bool:
    """Writes every field of a NamedTuple training state (step, params,
    opt_state, ...). Returns False (and writes nothing) for a step already
    saved."""
    if step in self.all_steps():
      return False
    d = os.path.join(self.directory, str(step))
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    saved = {f: _to(getattr(state, f), "cpu") for f in state._fields}
    saved["step"] = int(state.step)
    torch.save(saved, os.path.join(tmp, _FILE))
    os.replace(tmp, d)
    for old in self.all_steps()[:-self.max_to_keep]:
      shutil.rmtree(os.path.join(self.directory, str(old)))
    return True

  def restore(self, state_template, step: Optional[int] = None):
    """The saved state as state_template's type: its params are copied into
    the template's tensors in place (the model's parameters and buffers),
    every other field goes to their device. None when there is no
    checkpoint."""
    step = self.latest_step() if step is None else step
    if step is None:
      return None
    saved = torch.load(os.path.join(self.directory, str(step), _FILE),
                       map_location="cpu", weights_only=True)
    params = state_template.params
    if set(saved["params"]) != set(params):
      raise ValueError("checkpoint parameters do not match the model's: "
                       f"{sorted(set(saved['params']) ^ set(params))}")
    device = next(iter(params.values())).device
    with torch.no_grad():
      for k, p in params.items():
        p.copy_(saved["params"][k])
    rest = {f: _to(saved[f], device) for f in state_template._fields
            if f not in ("step", "params")}
    return state_template._replace(step=saved["step"], params=params, **rest)

  def wait_until_finished(self):
    """Saves are synchronous: nothing to wait for."""


def archive_ckpt(ckpt_dir: str, step: int, objective: float,
                 mngr: CheckpointManager) -> bool:
  """Keeps the best checkpoint by eval objective (JAX's archive_ckpt).

  Copies mngr's <step>/ into <ckpt_dir>/archive/ when `objective` beats
  archive/best_objective.txt; the previous archive moves to backup/.
  Returns whether it archived."""
  archive = os.path.join(ckpt_dir, "archive")
  backup = os.path.join(ckpt_dir, "backup")
  best_file = os.path.join(archive, "best_objective.txt")
  if os.path.exists(best_file):
    with open(best_file) as f:
      best = float(f.read().strip().split()[-1])
    if objective <= best:
      return False
  mngr.wait_until_finished()
  src = os.path.join(mngr.directory, str(step))
  if not os.path.isdir(src):
    return False
  if os.path.isdir(backup):
    shutil.rmtree(backup)
  if os.path.isdir(archive):
    shutil.move(archive, backup)
  os.makedirs(archive)
  shutil.copytree(src, os.path.join(archive, str(step)))
  with open(best_file, "w") as f:
    f.write(f"step {step} objective {objective}\n")
  return True
