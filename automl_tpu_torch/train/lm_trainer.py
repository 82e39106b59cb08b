"""LM training on one device: train step, eval step and the runner.

The counterpart of automl_tpu/train/lm_trainer.py. The model holds the
parameters; LMTrainState.params is its {name: nn.Parameter} dict, and the
train step updates those tensors in place (the JAX step returns new
arrays; in place keeps one copy of the weights on the card). The update
follows the JAX step: value and grad of the LM loss, global-norm gradient
clip, the optimizer, an optional per-leaf update RMS clip, decoupled weight
decay scaled by the learning rate (params -= lr * wd * params), then
params += updates.

run_lm runs on one device; a mesh, a sharding config and multi-process
input are not ported yet (ROADMAP M10). The loss follows
cfg.fused_softmax_loss as the JAX step's does, plus moe_aux_loss_weight
times the MoE load-balance loss where moe_num_experts is set; the eval step
stays unfused and without the aux, as JAX's does.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.models import lm as lm_lib
from automl_tpu_torch.train import optimizers as opt_lib
from automl_tpu_torch.train import schedules
from automl_tpu_torch.train.optimizers import global_norm
from automl_tpu_torch.train.checkpoint import CheckpointManager
from automl_tpu_torch.train.metrics import MetricsWriter


class LMTrainState(NamedTuple):
  step: int
  params: Any       # {name: nn.Parameter} of the model, updated in place
  opt_state: Any


def init_train_state(model: lm_lib.TransformerLM, tx) -> LMTrainState:
  params = dict(model.named_parameters())
  return LMTrainState(0, params, tx.init(params))


def _rms(tree: dict) -> torch.Tensor:
  n = sum(x.numel() for x in tree.values())
  return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                        for x in tree.values()) / max(n, 1))


def _per_leaf_diagnostics(prefix: str, tree: dict) -> dict:
  """{'diag/<prefix>/<name>/{norm,rms}'}: the name is the port's parameter
  name with '/' for '.', so per-layer leaves are blocks/<i>/... where the
  JAX tree has one stacked blocks/... leaf."""
  out = {}
  for name, leaf in tree.items():
    sq = torch.sum(torch.square(leaf.float()))
    key = name.replace(".", "/")
    out[f"diag/{prefix}/{key}/norm"] = torch.sqrt(sq)
    out[f"diag/{prefix}/{key}/rms"] = torch.sqrt(sq / max(leaf.numel(), 1))
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


def _loss(model: lm_lib.TransformerLM, inputs, targets, weights, segment_ids,
          causal_attention):
  """The training loss, dispatched on cfg.fused_softmax_loss as in the JAX
  step: False, the logits and lm_loss; "pallas", the fused kernels
  (lm_loss_fused_pallas); any other true value ("scan", True), the chunked
  lm_loss_fused. Plus moe_aux_loss_weight times the layers' summed MoE
  load-balance loss (a weight of 0 without moe_num_experts)."""
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
  return loss + aux_w * aux


def lm_loss_and_grads(model: lm_lib.TransformerLM, batch: dict):
  """(loss, {name: grad}) of the LM loss on a device batch: tokens
  [B, T+1] (+ loss_weights, segment_ids, causal_attention)."""
  params = dict(model.named_parameters())
  for p in params.values():
    p.grad = None
  loss = _loss(model, *_shifted(batch))
  loss.backward()
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
    with torch.no_grad():
      gnorm = global_norm(grads)
      if grad_clip_norm:
        scale = torch.clamp(grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
      updates, opt_state = tx.update(grads, state.opt_state, params)
      if update_clip_rms:
        def clip_rms(u):
          rms = torch.sqrt(torch.mean(torch.square(u.float())) + 1e-12)
          return u * torch.clamp(update_clip_rms / rms, max=1.0)
        updates = {k: clip_rms(u) for k, u in updates.items()}
      if weight_decay:
        lr = lr_fn(state.step) if lr_fn is not None else 1.0
        wd = float(np.float32(weight_decay) * np.float32(lr))
        updates = {k: u - wd * params[k] for k, u in updates.items()}
      logs = {"loss": loss, "gnorm": gnorm, "unorm": global_norm(updates)}
      if diagnostics:
        logs.update({"grms": _rms(grads), "urms": _rms(updates)})
        logs.update(_per_leaf_diagnostics("grads", grads))
        logs.update(_per_leaf_diagnostics("updates", updates))
      for k, p in params.items():
        p.add_(updates[k])
      if diagnostics:
        logs.update({"wnorm": global_norm(params), "wrms": _rms(params)})
        logs.update(_per_leaf_diagnostics("weights", params))
    return LMTrainState(state.step + 1, params, opt_state), logs

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
  gradients. params is the model's own parameter dict (kept for the JAX
  signature)."""

  @torch.no_grad()
  def eval_step(params, batch):
    del params
    inputs, targets, weights, segment_ids, causal_attention = _shifted(batch)
    if weights is None:
      weights = torch.ones(targets.shape, dtype=torch.float32,
                           device=targets.device)
    logits, _ = model(inputs, segment_ids=segment_ids,
                      causal_attention=causal_attention)
    return lm_lib.lm_loss(logits, targets, weights), weights.float().sum()

  return eval_step


def write_params_artifact(params: dict, path: str) -> None:
  """`name :: shape :: dtype :: device` per parameter, and the total (the
  one-device counterpart of the JAX runner's params_sharding.txt)."""
  lines = [f"{name} :: {tuple(p.shape)} :: {str(p.dtype).split('.')[-1]} :: "
           f"{p.device}" for name, p in params.items()]
  lines.append(f"total_params :: {sum(p.numel() for p in params.values())}")
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
  """Trains a TransformerLM on one device; returns the last logs as floats.

  As the JAX runner: experiment_config.yaml in model_dir, the lm_lr
  schedule with warmup (0 = min(1000, steps / 10)), resume from the latest
  checkpoint in model_dir/ckpt, per-log-step scalars in metrics.jsonl
  (loss, gnorm, unorm, lr, secs_per_step, tokens_per_sec), periodic
  validation, periodic and final checkpoints. Weights are drawn with numpy
  from `seed` (convert.numpy_init: the JAX init's distributions, other
  numbers). params.txt takes the place of params_sharding.txt."""
  if sharding is not None or mesh_shape or dcn_mesh_shape:
    raise NotImplementedError(
        "sharded / multi-device LM training is not ported to "
        "automl_tpu_torch yet: ROADMAP M10")
  device = torch.device(device)
  os.makedirs(model_dir, exist_ok=True)
  config.save_to_yaml(os.path.join(model_dir, "experiment_config.yaml"))

  model = lm_lib.TransformerLM(config, device=device)
  convert.load_jax_params(model, convert.numpy_init(config, seed))
  warmup = warmup_steps or max(1, min(1000, train_steps // 10))
  lr_fn = schedules.lm_lr(lr_schedule, learning_rate,
                          num_train_steps=train_steps, warmup_steps=warmup,
                          end_decay=end_decay)
  tx = opt_lib.build_optimizer(optimizer, lr_fn)
  state = init_train_state(model, tx)
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  restored = mngr.restore(state)
  if restored is not None:
    state = restored
  write_params_artifact(state.params, os.path.join(model_dir, "params.txt"))
  step_fn = make_lm_train_step(
      model, tx, weight_decay=config.get("weight_decay", 0.0), lr_fn=lr_fn,
      diagnostics=deep_diagnostics)
  eval_fn = make_lm_eval_step(model)
  writer = MetricsWriter(model_dir)

  it = data_iter if data_iter is not None else iter(
      SyntheticLMData(config.get("batch_size", 8), config.seq_len,
                      config.vocab_size))

  def run_validation(step):
    """Weight-averaged held-out loss (incremental mean)."""
    mean_loss, total_w = 0.0, 0.0
    for i, ebatch in enumerate(iter(eval_iter)):
      if i >= eval_steps:
        break
      loss, w = (float(x) for x in eval_fn(
          state.params, _device_batch(ebatch, device)))
      total_w += w
      mean_loss += (loss - mean_loss) * (w / max(total_w, 1e-6))
    writer.write(step, {"validation_loss": mean_loss,
                        "validation_weights": total_w})
    print(f"step {step} validation_loss {mean_loss:.4f}")
    return mean_loss

  logs = {}
  prev_t = time.perf_counter()
  step = state.step
  while step < train_steps:
    batch = _device_batch(next(it), device)
    state, logs = step_fn(state, batch)
    step += 1
    if ckpt_every and step % ckpt_every == 0:
      mngr.save(step, state)
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
      print(f"step {step} loss {l['loss']:.4f} lr {l['lr']:.2e} "
            f"gnorm {l['gnorm']:.3f} ({l['tokens_per_sec']:.0f} tok/s)")
    if eval_iter is not None and eval_every and (
        step % eval_every == 0 or step == train_steps):
      logs = dict(logs)
      logs["validation_loss"] = run_validation(step)
  mngr.save(step, state)
  mngr.wait_until_finished()
  writer.close()
  return {k: float(v) for k, v in logs.items()}
