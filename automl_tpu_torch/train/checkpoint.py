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
model for serving.

Each of these also reads the steps the JAX package's CheckpointManager
wrote (orbax: <directory>/<step>/default/, an OCDBT store of zarr arrays,
read by ckpt/orbax.py without orbax or tensorstore): the JAX tree becomes
the port's state through convert.py's layouts (the LM's stacked blocks,
the vision models' kernels), and the optimizer's state is matched to the
template's field by field (optax's chain indices, masked states, empty
states). A directory may hold steps of both packages: a JAX run resumed by
the port goes on writing state.pt steps beside JAX's.

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

from automl_tpu_torch import convert
from automl_tpu_torch.ckpt import orbax

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


def _is_jax(directory: str, step: int) -> bool:
  return orbax.is_orbax_step(os.path.join(directory, str(step)))


def _no_none(tree):
  """tree without its None leaves (optax's masked-out entries)."""
  if isinstance(tree, dict):
    return {k: _no_none(v) for k, v in tree.items() if v is not None}
  if isinstance(tree, list):
    return [_no_none(v) for v in tree if v is not None]
  return tree


def _jax_params(tree, keys=None) -> dict:
  """{port name: tensor} of a JAX parameter tree: the LM's layout without
  keys, else the vision models' for the given state_dict keys.
  ValueError where the tree does not fit."""
  if not isinstance(tree, dict):
    raise ValueError(f"no JAX parameter tree (found {type(tree).__name__})")
  try:
    if keys is None:
      return convert.jax_to_torch_state(tree)
    return convert.det_jax_to_torch_state(_no_none(tree), list(keys))
  except KeyError as e:
    raise ValueError(f"the JAX tree does not fit the model: {e}") from e


def _from_jax(tree: dict, template) -> dict:
  """A JAX training state (orbax.read_step's tree) as the dict a state.pt
  of template's type holds: per-parameter dicts (the params, the EMA,
  each optimizer moment) in the port's names, the optimizer's state
  matched to the template's (a JAX list for a tuple; optax.masked's
  inner_state unwrapped; an empty state for {}), each tensor in the
  template's dtype. ValueError naming the first path that does not fit."""
  from automl_tpu_torch.train.lm_trainer import LMTrainState
  lm = isinstance(template, LMTrainState)
  names = set(template.params)

  def walk(port, jax, path):
    if (isinstance(jax, dict) and set(jax) == {"inner_state"}
        and not (isinstance(port, dict) and "inner_state" in port)):
      jax = jax["inner_state"]
    if isinstance(port, (tuple, list)):
      if not isinstance(jax, list) or len(jax) != len(port):
        raise ValueError(f"{path}: the JAX state has {jax!r:.80}, the "
                         f"port's {len(port)} entries")
      return type(port)(walk(p, j, f"{path}/{i}")
                        for i, (p, j) in enumerate(zip(port, jax)))
    if isinstance(port, dict):
      if not port:
        return {}
      if set(port) <= names and all(torch.is_tensor(v)
                                    for v in port.values()):
        got = _jax_params(jax, None if lm else port)
        return {k: v.to(port[k].dtype) if k in port else v
                for k, v in got.items()}
      if not isinstance(jax, dict) or set(port) - set(jax):
        raise ValueError(f"{path}: the JAX state has no "
                         f"{sorted(set(port) - set(jax or {}))}")
      return {k: walk(v, jax[k], f"{path}/{k}") for k, v in port.items()}
    if port is None:
      return None
    if not torch.is_tensor(jax):
      raise ValueError(f"{path}: the JAX state has {jax!r:.80}, not an array")
    if isinstance(port, (int, float)):
      return type(port)(jax.item())
    return jax.to(port.dtype)

  if not torch.is_tensor(tree.get("step")):
    raise ValueError("the JAX state has no step")
  out = {f: walk(getattr(template, f), tree.get(f), f)
         for f in template._fields if f != "step"}
  out["step"] = int(tree["step"].item())
  return out


def _read_state(directory: str, step: int, template) -> dict:
  """The dict of step `step` for template's type: a state.pt, or a JAX
  step converted (_from_jax)."""
  if _is_jax(directory, step):
    tree = orbax.read_step(os.path.join(directory, str(step)))
    return _from_jax(tree, template)
  return _load(directory, step)


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
    saved = _read_state(self.directory, step, state_template)
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


def _step_of(directory: str, step: Optional[int]) -> int:
  """`step`, or the latest step, of a checkpoint directory of either
  package. FileNotFoundError naming the directory where there is no such
  step."""
  steps = all_checkpoint_steps(directory)
  if step is None and steps:
    step = steps[-1]
  if step is None:
    raise FileNotFoundError(f"no checkpoint under {directory}")
  if step not in steps:
    raise FileNotFoundError(f"no checkpoint of step {step} under "
                            f"{directory} (steps {steps})")
  return step


def _jax_step(directory: str, step: int, fields) -> dict:
  tree = orbax.read_step(os.path.join(directory, str(step)), only=fields)
  if "step" in tree:
    tree["step"] = int(tree["step"].item())
  return tree


def saved_params(directory: str, step: Optional[int] = None,
                 use_ema: bool = False, keys=None) -> dict:
  """{name: CPU tensor} of the params (with use_ema, the EMA when the
  checkpoint has one) of step `step` (default: the latest) of a checkpoint
  directory of either package. keys: the model's state_dict keys, which a
  JAX step of a vision model is converted to
  (convert.det_jax_to_torch_state); without them a JAX step is read in the
  LM's layout. FileNotFoundError without a checkpoint."""
  step = _step_of(directory, step)
  if _is_jax(directory, step):
    tree = _jax_step(directory, step, ("params", "ema_params"))
    ema = tree.get("ema_params")
    return _jax_params(ema if use_ema and ema else tree.get("params"), keys)
  saved = _load(directory, step)
  if use_ema and saved.get("ema_params"):
    return saved["ema_params"]
  return saved["params"]


def restore_params(directory: str, params: dict,
                   step: Optional[int] = None, names=None) -> int:
  """Copies the LM params of step `step` (default: the latest) of a
  checkpoint directory of either package into `params` ({name:
  parameter}, a model's) in place, a DTensor its part; the rest of the
  state (the optimizer's) is not read. names: {name: tensor} in the
  checkpoint's names -> params' (a pipeline model's lm.stacked_layers).
  Returns the step. FileNotFoundError naming the directory without that
  step."""
  step = _step_of(directory, step)
  if _is_jax(directory, step):
    tree = _jax_step(directory, step, ("step", "params"))
    saved = {"step": tree.get("step", step),
             "params": _jax_params(tree.get("params"))}
  else:
    saved = _load(directory, step, mmap=True)
  _copy_params(params, saved["params"] if names is None
               else names(saved["params"]))
  return saved["step"]


# What restoring a checkpoint that vanished or was cut short raises: the
# file gone (FileNotFoundError), a truncated archive (RuntimeError from
# torch.load, EOFError), parameters that do not match or a JAX step whose
# files are gone or cut short (ValueError).
RESTORE_ERRORS = (FileNotFoundError, RuntimeError, EOFError, ValueError)


def all_checkpoint_steps(directory: str) -> list[int]:
  """The sorted steps with a checkpoint on disk: <directory>/<step>/state.pt
  (a save in progress is <step>.tmp) or a JAX step (orbax writes
  <step>.orbax-checkpoint-tmp-<time> and renames it)."""
  if not os.path.isdir(directory):
    return []
  return sorted(int(name) for name in os.listdir(directory)
                if name.isdigit() and (
                    os.path.exists(os.path.join(directory, name, _FILE))
                    or orbax.is_orbax_step(os.path.join(directory, name))))


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
