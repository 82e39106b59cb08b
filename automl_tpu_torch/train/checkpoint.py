"""Checkpoints of training states with torch.save.

The counterpart of automl_tpu/train/checkpoint.py::CheckpointManager, with
its directory layout (<directory>/<step>/) and methods. A checkpoint holds
every field of a training state (a NamedTuple: step, params, opt_state and,
for the detection trainer, ema_params and normalizer) as CPU tensors in
<directory>/<step>/state.pt.
Saves are synchronous (written to <step>.tmp, then renamed), so
wait_until_finished has nothing to wait for. watch_checkpoints follows a
trainer's directory for a continuous eval. archive_ckpt keeps the best
checkpoint by an eval objective. saved_params reads the parameters (or
their EMA) of one step for inference; restore_params copies them into a
model for serving. The JAX package's orbax checkpoints
are OCDBT stores of zarr chunks, which need tensorstore: they are refused
(refuse_orbax, ROADMAP M9's orbax item).

On a mesh (the LM trainer's), state_for_save gathers the full tensors on
every rank, rank 0 alone writes the same state.pt as a one-process run,
and every rank waits at a barrier; restore cuts the full tensors to each
rank's parts. So a checkpoint resumes on any mesh shape, or on none. A
model whose parameters take other names on some meshes (the LM's GPipe
layout, which stacks its layers) saves and restores through a renaming
(`names`) to the names it has everywhere else.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

_FILE = "state.pt"


def _rank() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
  if dist.is_initialized() and dist.get_world_size() > 1:
    dist.barrier()


def map_named(tree, params: dict, fn):
  """tree with fn(leaf, params[name]) at each tensor under a dict key that
  names a parameter (an optimizer state's per-parameter leaves); every
  other leaf as it is."""
  if isinstance(tree, dict):
    return {k: (fn(v, params[k]) if torch.is_tensor(v) and k in params
                else map_named(v, params, fn)) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(map_named(v, params, fn) for v in tree)
  return tree


def _full(local, p):
  """The full tensor of `local`, placed as DTensor parameter p."""
  if isinstance(local, DTensor):
    return local.full_tensor()
  return DTensor.from_local(local, p.device_mesh, p.placements,
                            shape=p.shape, stride=p.stride(),
                            run_check=False).full_tensor()


def _part(full, p):
  """This rank's part of a full tensor, placed as DTensor parameter p."""
  return distribute_tensor(full.to(p.device_mesh.device_type),
                           p.device_mesh, p.placements,
                           src_data_rank=None).to_local()


def _renamed(tree, params, names):
  """tree with names({name: leaf}) in place of each dict's leaves that
  name a parameter of `params` (the params, an optimizer state's
  per-parameter leaves); everything else as it is."""
  if isinstance(tree, dict):
    named = {k: v for k, v in tree.items()
             if k in params and torch.is_tensor(v)}
    rest = {k: _renamed(v, params, names) for k, v in tree.items()
            if k not in named}
    return {**names(named), **rest} if named else rest
  if isinstance(tree, (tuple, list)):
    return type(tree)(_renamed(v, params, names) for v in tree)
  return tree


def state_for_save(state, names=None):
  """What trainers pass to CheckpointManager.save: the state as it is, or,
  where its params are DTensors, with the full tensors gathered (the
  params, and each per-parameter optimizer leaf as its parameter). names:
  {name: tensor} -> the same in the checkpoint's names, for every
  parameter-keyed dict of the state."""
  params = state.params
  if any(isinstance(p, DTensor) for p in params.values()):
    state = state._replace(
        params={k: p.full_tensor() for k, p in params.items()},
        opt_state=map_named(state.opt_state, params, _full))
  if names is None:
    return state
  return state._replace(**{f: _renamed(getattr(state, f), params, names)
                           for f in state._fields if f != "step"})


def _to(tree, device):
  """Tensors of a nested dict / tuple / list moved to `device`, detached."""
  if torch.is_tensor(tree):
    return tree.detach().to(device, copy=True)
  if isinstance(tree, dict):
    return {k: _to(v, device) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_to(v, device) for v in tree)
  return tree


def _load(directory: str, step: int, mmap: bool = False) -> dict:
  """The dict saved at `step` in `directory`, its tensors on the CPU (with
  mmap, read from the file only where they are used)."""
  return torch.load(os.path.join(directory, str(step), _FILE),
                    map_location="cpu", weights_only=True, mmap=mmap)


def _copy_params(params: dict, saved: dict) -> None:
  """Copies saved {name: tensor} into params ({name: parameter}) in place;
  a DTensor takes its part. ValueError when the names differ."""
  if set(saved) != set(params):
    raise ValueError("checkpoint parameters do not match the model's: "
                     f"{sorted(set(saved) ^ set(params))}")
  with torch.no_grad():
    for k, p in params.items():
      if isinstance(p, DTensor):
        p.to_local().copy_(_part(saved[k], p))
      else:
        p.copy_(saved[k])


class CheckpointManager:
  """save / restore / latest_step over <directory>/<step>/state.pt, keeping
  the newest max_to_keep steps."""

  def __init__(self, directory: str, max_to_keep: int = 5):
    self.directory = os.path.abspath(directory)
    os.makedirs(self.directory, exist_ok=True)
    self.max_to_keep = max_to_keep

  def all_steps(self) -> list[int]:
    return all_checkpoint_steps(self.directory)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state) -> bool:
    """Writes every field of a NamedTuple training state (step, params,
    opt_state, ...). Returns False (and writes nothing) for a step already
    saved."""
    if _rank() != 0:         # rank 0 writes; every rank waits for it
      _barrier()
      return True
    if step in self.all_steps():
      _barrier()
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
    _barrier()
    return True

  def restore(self, state_template, step: Optional[int] = None, names=None):
    """The saved state as state_template's type: its params are copied into
    the template's tensors in place (the model's parameters and buffers;
    a DTensor takes its part of the saved tensor), every other field goes
    to their device (a per-parameter optimizer leaf of a DTensor parameter
    as the parameter's part). names: {name: tensor} in the checkpoint's
    names -> the template's (state_for_save's inverse). None when there is
    no checkpoint."""
    step = self.latest_step() if step is None else step
    if step is None:
      return None
    saved = _load(self.directory, step)
    if names is not None:
      saved = {f: v if f == "step" else _renamed(v, saved["params"], names)
               for f, v in saved.items()}
    params = state_template.params
    _copy_params(params, saved["params"])
    first = next(iter(params.values()))
    if isinstance(first, DTensor):
      device = first.to_local().device
      rest = {f: _to(map_named(
          saved[f], params,
          lambda v, p: _part(v, p) if isinstance(p, DTensor) else v), device)
              for f in state_template._fields if f not in ("step", "params")}
      return state_template._replace(step=saved["step"], params=params,
                                     **rest)
    device = first.device
    rest = {f: _to(saved[f], device) for f in state_template._fields
            if f not in ("step", "params")}
    return state_template._replace(step=saved["step"], params=params, **rest)

  def wait_until_finished(self):
    """Saves are synchronous: nothing to wait for."""


def refuse_orbax(path: str) -> None:
  """NotImplementedError when `path` is a checkpoint directory of the JAX
  package (orbax: step directories holding _CHECKPOINT_METADATA or
  default/)."""
  if os.path.isdir(path) and any(
      os.path.exists(os.path.join(path, d, "_CHECKPOINT_METADATA"))
      or os.path.isdir(os.path.join(path, d, "default"))
      for d in os.listdir(path)):
    raise NotImplementedError(
        f"{path} is an orbax checkpoint of the JAX package: its OCDBT "
        "store of zarr chunks needs tensorstore, and automl_tpu_torch does "
        "not read it (ROADMAP M9, its orbax item, stays queued)")


def _saved(directory: str, step: Optional[int], mmap: bool = False) -> dict:
  """The dict saved at `step` (default: the latest) in a port checkpoint
  directory. FileNotFoundError naming the directory where there is no such
  step; an orbax directory of the JAX package is refused (refuse_orbax)."""
  refuse_orbax(directory)
  steps = all_checkpoint_steps(directory)
  if step is None and steps:
    step = steps[-1]
  if step is None:
    raise FileNotFoundError(f"no checkpoint under {directory}")
  if step not in steps:
    raise FileNotFoundError(f"no checkpoint of step {step} under "
                            f"{directory} (steps {steps})")
  return _load(directory, step, mmap)


def saved_params(directory: str, step: Optional[int] = None,
                 use_ema: bool = False) -> dict:
  """{name: CPU tensor} of the params (with use_ema, the EMA when the
  checkpoint has one) of step `step` (default: the latest) of a port
  checkpoint directory. FileNotFoundError without a checkpoint; an orbax
  directory of the JAX package is refused (refuse_orbax)."""
  saved = _saved(directory, step)
  if use_ema and saved.get("ema_params"):
    return saved["ema_params"]
  return saved["params"]


def restore_params(directory: str, params: dict,
                   step: Optional[int] = None, names=None) -> int:
  """Copies the params of step `step` (default: the latest) of a port
  checkpoint directory into `params` ({name: parameter}, a model's) in
  place, a DTensor its part; the rest of the state (the optimizer's) is
  not read. names: {name: tensor} in the checkpoint's names -> params'
  (a pipeline model's lm.stacked_layers). Returns the step.
  FileNotFoundError naming the directory without that step; an orbax
  directory of the JAX package is refused (refuse_orbax)."""
  saved = _saved(directory, step, mmap=True)
  _copy_params(params, saved["params"] if names is None
               else names(saved["params"]))
  return saved["step"]


# What restoring a checkpoint that vanished or was cut short raises: the
# file gone (FileNotFoundError), a truncated archive (RuntimeError from
# torch.load, EOFError) or parameters that do not match (ValueError).
RESTORE_ERRORS = (FileNotFoundError, RuntimeError, EOFError, ValueError)


def all_checkpoint_steps(directory: str) -> list[int]:
  """The sorted steps with a complete checkpoint on disk
  (<directory>/<step>/state.pt; a save in progress is <step>.tmp)."""
  if not os.path.isdir(directory):
    return []
  return sorted(int(name) for name in os.listdir(directory)
                if name.isdigit() and os.path.exists(
                    os.path.join(directory, name, _FILE)))


def watch_checkpoints(directory: str, timeout_secs: float = 3600.0,
                      poll_secs: float = 10.0,
                      last_seen: Optional[int] = None) -> Iterator[int]:
  """Yields each new checkpoint step as it appears in `directory`, in
  order, until timeout_secs pass with no new one (JAX's
  watch_checkpoints; tf.train.checkpoints_iterator's role). A checkpoint
  may vanish (the trainer keeps max_to_keep) before the caller restores
  it: the caller skips it (RESTORE_ERRORS)."""
  deadline = time.time() + timeout_secs
  while time.time() < deadline:
    fresh = [s for s in all_checkpoint_steps(directory)
             if last_seen is None or s > last_seen]
    if fresh:
      for s in fresh:
        last_seen = s
        yield s
      deadline = time.time() + timeout_secs
    else:
      time.sleep(poll_secs)


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
