"""LM training: train step, eval step and the runner, on one device or a
mesh.

The counterpart of automl_tpu/train/lm_trainer.py. The model holds the
parameters; LMTrainState.params is its {name: nn.Parameter} dict, and the
train step updates those tensors in place (the JAX step returns new
arrays; in place keeps one copy of the weights on the card). The update
follows the JAX step: value and grad of the LM loss, global-norm gradient
clip, the optimizer, an optional per-leaf update RMS clip, decoupled weight
decay scaled by the learning rate (params -= lr * wd * params), then
params += updates.

On a mesh (run_lm's mesh_shape, or a model built with one) the parameters
are DTensors and the step works on each rank's part: the batch is this
rank's rows (a DTensor batch's local part), with ring attention active
also its chunk of the sequence; the loss is this rank's share of the
global mean, and the parameters' gradients are summed over the ranks that
split the tokens (models/lm.py). The norms the clip and the logs take are
global (one all-reduce); the optimizer, elementwise, runs on the local
parts, and LMTrainState.opt_state holds them (each leaf in the placements
of the parameter of its name: train/checkpoint.py gathers them). Each
process feeds its rows of the global batch (select_local_batch), and rank
0 alone writes the metrics, the validation and the checkpoint. The loss
follows cfg.fused_softmax_loss as the JAX step's does, plus
moe_aux_loss_weight times the MoE load-balance loss where moe_num_experts
is set; the eval step stays unfused and without the aux, as JAX's does.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from automl_tpu_torch import convert
from automl_tpu_torch.models import lm as lm_lib
from automl_tpu_torch.parallel import comm
from automl_tpu_torch.parallel import distributed as dist_lib
from automl_tpu_torch.parallel.mesh import create_mesh
from automl_tpu_torch.train import optimizers as opt_lib
from automl_tpu_torch.train import schedules
from automl_tpu_torch.train.optimizers import global_norm
from automl_tpu_torch.train.checkpoint import (CheckpointManager,
                                               map_named, state_for_save)
from automl_tpu_torch.train.metrics import MetricsWriter, NoWriter


class LMTrainState(NamedTuple):
  step: int
  params: Any       # {name: nn.Parameter} of the model, updated in place
  opt_state: Any


def _local(x):
  return x.to_local() if isinstance(x, DTensor) else x


def init_train_state(model: lm_lib.TransformerLM, tx) -> LMTrainState:
  """Step 0, the model's parameters and the optimizer's state (on a mesh,
  each rank's parts of it)."""
  params = dict(model.named_parameters())
  opt_state = tx.init(params)
  if model.mesh is not None:
    opt_state = map_named(opt_state, params, lambda v, p: _local(v))
  return LMTrainState(0, params, opt_state)


def _sumsq(tree: dict, params: Optional[dict] = None) -> torch.Tensor:
  """[len(tree)] f32 sums of squares of each leaf. With params (a mesh
  model's DTensors, tree holding the local parts of leaves placed as the
  parameter of the same name), the global sums: each rank's local sum
  over the copies of its part, summed over the world in one all-reduce."""
  vals = list(tree.values())
  sq = torch.stack(torch._foreach_norm(vals, 2, dtype=torch.float32)) ** 2
  if params is None:
    return sq
  mesh = next(iter(params.values())).device_mesh
  copies = torch.tensor(
      [float(np.prod([mesh.size(i) for i, pl in enumerate(
          params[k].placements) if not pl.is_shard()] or [1]))
       for k in tree], device=sq.device)
  sq = sq / copies
  if mesh.size() > 1:
    torch.distributed.all_reduce(sq)
  return sq


def _diagnostics(prefix: str, tree: dict, params: Optional[dict]) -> dict:
  """Global norm and rms of a tree ({'wnorm', 'wrms'} for weights, 'g' and
  'u' for grads and updates), and per leaf
  {'diag/<prefix>/<name>/{norm,rms}'}: the name is the port's parameter
  name with '/' for '.', so per-layer leaves are blocks/<i>/... where the
  JAX tree has one stacked blocks/... leaf."""
  sq = _sumsq(tree, params)
  sizes = torch.tensor([float((params or tree)[k].numel()) for k in tree],
                       device=sq.device)
  short = {"weights": "w", "grads": "g", "updates": "u"}[prefix]
  out = {f"{short}rms": torch.sqrt(sq.sum() / max(float(sizes.sum()), 1.0))}
  if prefix == "weights":
    out["wnorm"] = torch.sqrt(sq.sum())
  for (name, _), q, n in zip(tree.items(), sq, sizes):
    key = name.replace(".", "/")
    out[f"diag/{prefix}/{key}/norm"] = torch.sqrt(q)
    out[f"diag/{prefix}/{key}/rms"] = torch.sqrt(q / torch.clamp(n, min=1))
  return out


def _device_batch(batch: dict, device) -> dict:
  return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
          for k, v in batch.items()}


def _shifted(batch: dict):
  """(inputs, targets, loss weights, segment ids, prefix markers)."""
  tokens = batch["tokens"]
  inputs, targets = tokens[:, :-1], tokens[:, 1:]
  weights = batch.get("loss_weights")
  segment_ids = batch.get("segment_ids")
  causal_attention = batch.get("causal_attention")
  return (inputs, targets,
          None if weights is None else weights[:, 1:],
          None if segment_ids is None else segment_ids[:, :-1],
          None if causal_attention is None else causal_attention[:, :-1])


def _local_batch(model: lm_lib.TransformerLM, batch: dict):
  """_shifted of this rank's part of a batch: a DTensor's local rows (a
  plain tensor is taken as this rank's rows), and with ring attention
  active this rank's chunk of the sequence on 'model'."""
  parts = _shifted({k: _local(v) for k, v in batch.items()})
  par = model.par
  if par is None or not par.ring:
    return parts
  t = parts[0].shape[1]
  if t % par.model:
    raise ValueError(f"ring attention: sequence {t} does not split over "
                     f"mesh axis 'model' size {par.model}")
  n = t // par.model
  return tuple(None if x is None else x[:, par.rank * n:(par.rank + 1) * n]
               for x in parts)


def _global_mean(model, local_mean, targets, weights):
  """This rank's share of the global (weighted) token mean, from its local
  mean: local_mean * max(w_local, 1) / max(w_global, 1), the weights summed
  over the token axes (identity off a mesh that splits the tokens)."""
  par = model.par
  if par is None or not par.token_axes:
    return local_mean
  w = (weights.float().sum() if weights is not None else
       torch.tensor(float(targets.numel()), device=targets.device))
  w_all = comm.all_reduce(w.detach().clone(), par.mesh, par.token_axes)
  return local_mean * torch.clamp(w.detach(), min=1.0) / torch.clamp(
      w_all, min=1.0)


def _loss(model: lm_lib.TransformerLM, inputs, targets, weights, segment_ids,
          causal_attention):
  """The training loss, dispatched on cfg.fused_softmax_loss as in the JAX
  step: False, the logits and lm_loss; "pallas", the fused kernels
  (lm_loss_fused_pallas); any other true value ("scan", True), the chunked
  lm_loss_fused. Plus moe_aux_loss_weight times the layers' summed MoE
  load-balance loss (a weight of 0 without moe_num_experts). On a mesh
  that splits the tokens, this rank's share of the global loss."""
  cfg = model.cfg
  fused = cfg.get("fused_softmax_loss", False)
  aux_w = (float(cfg.get("moe_aux_loss_weight", 0.0) or 0.0)
           if cfg.get("moe_num_experts") else 0.0)
  out, _, aux = model(inputs, segment_ids=segment_ids,
                      causal_attention=causal_attention, return_aux=True,
                      return_hidden=bool(fused))
  if not fused:
    loss = lm_lib.lm_loss(out, targets, weights)
  elif fused == "pallas":
    loss = lm_lib.lm_loss_fused_pallas(model, out, targets, weights)
  else:
    loss = lm_lib.lm_loss_fused(model, out, targets, weights,
                                int(cfg.get("loss_chunk_size", 256)))
  return _global_mean(model, loss, targets, weights) + aux_w * _share(
      model, aux)


def _share(model, value):
  """This rank's share of a value every rank of the token axes holds
  alike (the MoE aux: a global one), so that the shares sum to it."""
  par = model.par
  if par is None or not par.token_axes:
    return value
  n = 1
  for a in par.token_axes:
    n *= par.mesh.size(par.mesh.mesh_dim_names.index(a))
  return value / n


def lm_loss_and_grads(model: lm_lib.TransformerLM, batch: dict):
  """(loss, {name: grad}) of the LM loss on a device batch: tokens
  [B, T+1] (+ loss_weights, segment_ids, causal_attention). On a mesh the
  loss is the global one on every rank and each grad a DTensor placed as
  its parameter."""
  params = dict(model.named_parameters())
  for p in params.values():
    p.grad = None
  loss = _loss(model, *_local_batch(model, batch))
  loss.backward()
  par = model.par
  if par is not None and par.token_axes:
    loss = comm.all_reduce(loss.detach().clone(), par.mesh, par.token_axes)
  grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in params.items()}
  for p in params.values():
    p.grad = None
  return loss.detach(), grads


def make_lm_train_step(model: lm_lib.TransformerLM, tx,
                       grad_clip_norm: float = 1.0,
                       update_clip_rms: float = 0.0,
                       weight_decay: float = 0.0,
                       lr_fn=None, diagnostics: bool = False):
  """-> step(state, batch) -> (state, logs), batch {'tokens' [B, T+1],
  'loss_weights', 'segment_ids', 'causal_attention' optional} on the
  model's device. logs hold 0-d tensors (no host sync): loss, gnorm, unorm,
  and with diagnostics wnorm, wrms, grms, urms and per-leaf norm/rms.

  Weight decay is scaled by lr_fn(step) when given (the raw coefficient
  otherwise), as in the JAX step."""

  def train_step(state: LMTrainState, batch):
    loss, grads = lm_loss_and_grads(model, batch)
    params = state.params
    mesh_params = params if model.mesh is not None else None
    if mesh_params is not None:
      # The optimizer is elementwise: it runs on each rank's parts.
      params = {k: _local(p) for k, p in params.items()}
      grads = {k: _local(g) for k, g in grads.items()}
    norm = (global_norm if mesh_params is None else
            lambda tree: torch.sqrt(_sumsq(tree, mesh_params).sum()))
    with torch.no_grad():
      gnorm = norm(grads)
      if grad_clip_norm:
        scale = torch.clamp(grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
      updates, opt_state = tx.update(grads, state.opt_state, params)
      if update_clip_rms:
        sq = _sumsq(updates, mesh_params)
        sizes = [(mesh_params or params)[k].numel() for k in updates]
        updates = {k: u * torch.clamp(update_clip_rms / torch.sqrt(
                       q / n + 1e-12), max=1.0)
                   for (k, u), q, n in zip(updates.items(), sq, sizes)}
      if weight_decay:
        lr = lr_fn(state.step) if lr_fn is not None else 1.0
        wd = float(np.float32(weight_decay) * np.float32(lr))
        updates = {k: u - wd * params[k] for k, u in updates.items()}
      logs = {"loss": loss, "gnorm": gnorm, "unorm": norm(updates)}
      if diagnostics:
        logs.update(_diagnostics("grads", grads, mesh_params))
        logs.update(_diagnostics("updates", updates, mesh_params))
      for k, p in params.items():
        p.add_(updates[k])
      if diagnostics:
        logs.update(_diagnostics("weights", params, mesh_params))
    return LMTrainState(state.step + 1, state.params, opt_state), logs

  return train_step


class SyntheticLMData:
  """Synthetic token batches: each row repeats a random 4-token pattern, so
  the loss measurably drops (the JAX package's numpy stream, seed for
  seed)."""

  def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
               seed: int = 0):
    self.rng = np.random.RandomState(seed)
    self.b, self.t, self.v = batch_size, seq_len, vocab_size

  def __iter__(self):
    while True:
      pattern = self.rng.randint(1, self.v, (self.b, 4))
      reps = (self.t + 1) // 4 + 1
      tokens = np.tile(pattern, (1, reps))[:, :self.t + 1]
      yield {"tokens": tokens.astype(np.int32)}


def make_lm_eval_step(model: lm_lib.TransformerLM):
  """-> eval_step(params, batch) -> (loss, total weight), without
  gradients; on a mesh both global (this rank's part of the batch, as the
  train step takes it). params is the model's own parameter dict (kept for
  the JAX signature)."""

  @torch.no_grad()
  def eval_step(params, batch):
    del params
    inputs, targets, weights, segment_ids, causal_attention = _local_batch(
        model, batch)
    if weights is None:
      weights = torch.ones(targets.shape, dtype=torch.float32,
                           device=targets.device)
    logits, _ = model(inputs, segment_ids=segment_ids,
                      causal_attention=causal_attention)
    par = model.par
    if par is None or not par.token_axes:
      return lm_lib.lm_loss(logits, targets, weights), weights.float().sum()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    w = weights.float()
    sums = comm.all_reduce(torch.stack([(nll * w).sum(), w.sum()]),
                           par.mesh, par.token_axes)
    return sums[0] / sums[1].clamp_min(1.0), sums[1]

  return eval_step


def _jax_path(name: str, stacked: bool):
  """The JAX tree's path of a parameter of the port, as a tuple (ints for
  list indices): blocks.<i>.x.y -> ('blocks', 'x', 'y') when the JAX tree
  stacks the layers (use_scan), else ('blocks', i, 'x', 'y')."""
  parts = name.split(".")
  if parts[0] == "blocks":
    rest = tuple(parts[2:])
    return ("blocks",) + rest if stacked else ("blocks", int(parts[1])) + rest
  return tuple(parts)


def write_sharding_artifact(model: lm_lib.TransformerLM, path: str) -> None:
  """`path :: shape :: dtype :: sharding` per leaf of the JAX tree, then
  the total: JAX's params_sharding.txt, in its path names and leaf order,
  with the stacked [L, ...] shape of each block leaf where the JAX tree
  stacks the layers (use_scan), and each leaf's PartitionSpec (from its
  DTensor placements; P() without a mesh)."""
  stacked = bool(model.cfg.get("use_scan", True))
  pipe = model.stacked
  n_layers = int(model.cfg.n_layers)
  specs = model.param_placements()
  leaves = {}
  for name, p in model.named_parameters():
    key = tuple(name.split(".")) if pipe else _jax_path(name, stacked)
    if key in leaves:
      continue
    shape, spec = tuple(p.shape), specs[name]
    if stacked and key[0] == "blocks" and not pipe:
      shape, spec = (n_layers,) + shape, (None,) + tuple(spec)
    spec = list(spec)
    while spec and spec[-1] is None:      # as JAX prints a leaf's spec
      spec.pop()
    leaves[key] = (shape, str(p.dtype).split(".")[-1], lm_lib.P(*spec))
  lines, total = [], 0
  for key in sorted(leaves, key=lambda k: tuple((isinstance(e, str), e)
                                                for e in k)):
    shape, dtype, spec = leaves[key]
    total += int(np.prod(shape))
    lines.append(f"{'/'.join(str(e) for e in key)} :: {shape} :: {dtype} :: "
                 f"{spec}")
  lines.append(f"total_params :: {total}")
  with open(path, "w") as f:
    f.write("\n".join(lines) + "\n")



def run_lm(config, model_dir: str, train_steps: int,
           sharding=None, mesh_shape=None, dcn_mesh_shape=None,
           data_iter=None, log_every: int = 20,
           learning_rate: float = 1e-3, optimizer: str = "lion",
           lr_schedule: str = "cosine_decay", warmup_steps: int = 0,
           end_decay: float = 0.1, eval_iter=None, eval_every: int = 0,
           eval_steps: int = 8, ckpt_every: int = 0,
           deep_diagnostics: bool = False, seed: int = 0,
           device="cuda") -> dict:
  """Trains a TransformerLM; on a mesh when mesh_shape is given (over the
  world's processes: parallel/distributed.py initialize), else on one
  device. Returns the last logs as floats.

  As the JAX runner: experiment_config.yaml in model_dir, the lm_lr
  schedule with warmup (0 = min(1000, steps / 10)), resume from the latest
  checkpoint in model_dir/ckpt, per-log-step scalars in metrics.jsonl
  (loss, gnorm, unorm, lr, secs_per_step, tokens_per_sec), periodic
  validation, periodic and final checkpoints, and the step-0
  params_sharding.txt. sharding defaults to the GSPMD layout on a mesh
  and data_parallel without one, as in JAX. Each process feeds its rows of
  each global batch from data_iter; rank 0 writes the files. Weights are
  drawn with numpy from `seed` (convert.numpy_init: the JAX init's
  distributions, other numbers)."""
  device = torch.device(device)
  mesh = (create_mesh(mesh_shape, dcn_mesh_shape=dcn_mesh_shape,
                      device=device.type) if mesh_shape else None)
  sharding = sharding or (lm_lib.ShardingConfig() if mesh is not None
                          else lm_lib.ShardingConfig.data_parallel())
  writer_rank = dist_lib.process_index() == 0
  os.makedirs(model_dir, exist_ok=True)
  if writer_rank:
    config.save_to_yaml(os.path.join(model_dir, "experiment_config.yaml"))

  model = lm_lib.TransformerLM(config, sharding, device=device, mesh=mesh)
  convert.load_jax_params(model, convert.numpy_init(config, seed))
  device = model.device
  warmup = warmup_steps or max(1, min(1000, train_steps // 10))
  lr_fn = schedules.lm_lr(lr_schedule, learning_rate,
                          num_train_steps=train_steps, warmup_steps=warmup,
                          end_decay=end_decay)
  tx = opt_lib.build_optimizer(optimizer, lr_fn)
  state = init_train_state(model, tx)
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  # A pipeline model's checkpoint in the per-layer names of every layout.
  save_names = lm_lib.per_layer if model.stacked else None
  restored = mngr.restore(
      state, names=lm_lib.stacked_layers if model.stacked else None)
  if restored is not None:
    state = restored
  if writer_rank:
    write_sharding_artifact(model,
                            os.path.join(model_dir, "params_sharding.txt"))
  step_fn = make_lm_train_step(
      model, tx, weight_decay=config.get("weight_decay", 0.0), lr_fn=lr_fn,
      diagnostics=deep_diagnostics)
  eval_fn = make_lm_eval_step(model)
  writer = MetricsWriter(model_dir) if writer_rank else NoWriter()

  it = data_iter if data_iter is not None else iter(
      SyntheticLMData(config.get("batch_size", 8), config.seq_len,
                      config.vocab_size))

  def device_batch(host_batch):
    """This process's rows of a global host batch (the whole of it in a
    world of one), on the device; on a mesh, a DTensor batch."""
    if mesh is None:
      return _device_batch(host_batch, device)
    from automl_tpu_torch.data.lm_pipeline import select_local_batch
    idx, count = dist_lib.batch_coordinate(mesh)
    return dist_lib.build_global_batch(
        select_local_batch(host_batch, idx, count), mesh)

  def run_validation(step):
    """Weight-averaged held-out loss (incremental mean)."""
    mean_loss, total_w = 0.0, 0.0
    for i, ebatch in enumerate(iter(eval_iter)):
      if i >= eval_steps:
        break
      loss, w = (float(x) for x in eval_fn(state.params,
                                           device_batch(ebatch)))
      total_w += w
      mean_loss += (loss - mean_loss) * (w / max(total_w, 1e-6))
    writer.write(step, {"validation_loss": mean_loss,
                        "validation_weights": total_w})
    if writer_rank:
      print(f"step {step} validation_loss {mean_loss:.4f}")
    return mean_loss

  logs = {}
  prev_t = time.perf_counter()
  step = state.step
  while step < train_steps:
    batch = device_batch(next(it))
    state, logs = step_fn(state, batch)
    step += 1
    if ckpt_every and step % ckpt_every == 0:
      mngr.save(step, state_for_save(state, save_names))
    if step % log_every == 0 or step == train_steps:
      l = {k: float(v) for k, v in logs.items()}   # waits for the step
      now = time.perf_counter()
      n_steps = log_every if step % log_every == 0 else step % log_every
      l["lr"] = lr_fn(step - 1)
      l["secs_per_step"] = (now - prev_t) / n_steps
      l["tokens_per_sec"] = (batch["tokens"].shape[0] * config.seq_len
                             * n_steps / max(now - prev_t, 1e-9))
      prev_t = now
      writer.write(step, l)
      if writer_rank:
        print(f"step {step} loss {l['loss']:.4f} lr {l['lr']:.2e} "
              f"gnorm {l['gnorm']:.3f} ({l['tokens_per_sec']:.0f} tok/s)")
    if eval_iter is not None and eval_every and (
        step % eval_every == 0 or step == train_steps):
      logs = dict(logs)
      logs["validation_loss"] = run_validation(step)
  mngr.save(step, state_for_save(state, save_names))
  mngr.wait_until_finished()
  writer.close()
  return {k: float(v) for k, v in logs.items()}
