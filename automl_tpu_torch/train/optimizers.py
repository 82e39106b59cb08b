"""Optimizers as optax-style gradient transformations on dicts of tensors.

The counterpart of automl_tpu/train/optimizers.py. A transformation is a
pair (init, update) over {name: tensor} dicts keyed like
model.named_parameters(): init(params) -> state; update(updates, state,
params) -> (updates, new state). The rules are optax's, so that one state
trains the same in both packages: scale_by_learning_rate negates, the Lion
momentum keeps the parameters' dtype, sign(0) = 0. torch.optim is not used:
its update rules and weight-decay placement differ from optax's.

Ported: sgd, momentum, rmsprop (optax's: eps inside the square root, nu
from 0, the learning rate applied before the momentum trace), adam, adamw
and lion, with weight-decay masks; the trainability mask
(masked_for_params: BatchNorm moving statistics pass through untouched),
per-variable then global gradient clipping, and the EMA of the trainers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
  init: Callable
  update: Callable


def _map(fn, *trees) -> dict:
  return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def chain(*txs) -> GradientTransformation:
  """Applies the transformations in order; the state is their tuple."""

  def init(params):
    return tuple(tx.init(params) for tx in txs)

  def update(updates, state, params=None):
    new_state = []
    for tx, s in zip(txs, state):
      updates, s = tx.update(updates, s, params)
      new_state.append(s)
    return updates, tuple(new_state)

  return GradientTransformation(init, update)


def identity() -> GradientTransformation:
  return GradientTransformation(lambda params: {},
                                lambda u, state, params=None: (u, state))


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
  """updates * -lr, where lr is a float or a schedule of the update count
  (optax.scale_by_learning_rate); the state holds the count."""

  def init(params):
    return {"count": 0}

  def update(updates, state, params=None):
    count = state["count"]
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return _map(lambda u: u * -lr, updates), {"count": count + 1}

  return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0,
                        mask=None) -> GradientTransformation:
  """updates + weight_decay * params; with mask (name -> bool, or a dict of
  bools), only where it is True (optax.add_decayed_weights' mask)."""

  def decays(name):
    if mask is None:
      return True
    return mask(name) if callable(mask) else mask[name]

  def update(updates, state, params=None):
    return {k: u + weight_decay * params[k] if decays(k) else u
            for k, u in updates.items()}, state

  return GradientTransformation(lambda params: {}, update)


def trace(decay: float) -> GradientTransformation:
  """Momentum: t <- g + decay * t; updates t (optax.trace)."""

  def init(params):
    return {"trace": _map(torch.zeros_like, params)}

  def update(updates, state, params=None):
    new = _map(lambda g, t: g + decay * t, updates, state["trace"])
    return new, {"trace": new}

  return GradientTransformation(init, update)


def sgd(learning_rate, momentum: float | None = None
        ) -> GradientTransformation:
  return chain(trace(momentum) if momentum is not None else identity(),
               scale_by_learning_rate(learning_rate))


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8
                 ) -> GradientTransformation:
  """nu <- (1 - decay) g^2 + decay nu (nu from 0); g * rsqrt(nu + eps)
  (optax.scale_by_rms with eps_in_sqrt, its default)."""

  def init(params):
    return {"nu": _map(torch.zeros_like, params)}

  def update(updates, state, params=None):
    nu = _map(lambda g, n: (1 - decay) * (g * g) + decay * n, updates,
              state["nu"])
    return _map(lambda g, n: torch.rsqrt(n + eps) * g, updates, nu), {
        "nu": nu}

  return GradientTransformation(init, update)


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8,
            momentum: float | None = None) -> GradientTransformation:
  """optax.rmsprop: scale_by_rms, then the learning rate, then the
  momentum trace (so a changing rate enters the trace step by step)."""
  return chain(scale_by_rms(decay, eps), scale_by_learning_rate(learning_rate),
               trace(momentum) if momentum is not None else identity())


def _bias_correction(decay: float, count: int) -> float:
  """1 - decay ** count in float32 (optax's bias correction)."""
  return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
  """Adam's moments (from 0) with bias correction: m_hat / (sqrt(v_hat) +
  eps), the count in the state (optax.scale_by_adam, eps_root 0)."""

  def init(params):
    return {"count": 0, "mu": _map(torch.zeros_like, params),
            "nu": _map(torch.zeros_like, params)}

  def update(updates, state, params=None):
    mu = _map(lambda g, m: (1 - b1) * g + b1 * m, updates, state["mu"])
    nu = _map(lambda g, n: (1 - b2) * (g * g) + b2 * n, updates, state["nu"])
    count = state["count"] + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    out = _map(lambda m, n: (m / c1) / (torch.sqrt(n / c2) + eps), mu, nu)
    return out, {"count": count, "mu": mu, "nu": nu}

  return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
  return chain(scale_by_adam(b1, b2, eps),
               scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mask=None) -> GradientTransformation:
  """optax.adamw: Adam, the decoupled weight decay (masked), then the
  learning rate."""
  return chain(scale_by_adam(b1, b2, eps),
               add_decayed_weights(weight_decay, mask),
               scale_by_learning_rate(learning_rate))


def scale_by_lion(b1: float = 0.9, b2: float = 0.99
                  ) -> GradientTransformation:
  """Lion: sign((1 - b1) g + b1 m); then m <- (1 - b2) g + b2 m, with m in
  the parameters' dtype."""

  def init(params):
    return {"momentum": _map(torch.zeros_like, params)}

  def update(updates, state, params=None):
    mu = state["momentum"]
    out = _map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m), updates, mu)
    new_mu = _map(lambda g, m: ((1.0 - b2) * g + b2 * m).to(m.dtype),
                  updates, mu)
    return out, {"momentum": new_mu}

  return GradientTransformation(init, update)


def lion(learning_rate, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.0, mask=None) -> GradientTransformation:
  return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay, mask),
               scale_by_learning_rate(learning_rate))


def build_optimizer(name: str, learning_rate, *, momentum: float = 0.9,
                    rmsprop_rho: float = 0.9, rmsprop_eps: float = 1e-3,
                    beta1: float = 0.9, beta2: float = 0.999,
                    weight_decay: float = 0.0,
                    weight_decay_mask=None) -> GradientTransformation:
  """Name -> transformation (learning_rate may be a schedule fn);
  weight_decay and its mask (name -> bool, or a dict) apply to adamw and
  lion."""
  name = (name or "sgd").lower()
  if name == "sgd":
    return sgd(learning_rate)
  if name == "momentum":
    return sgd(learning_rate, momentum=momentum)
  if name == "rmsprop":
    return rmsprop(learning_rate, decay=rmsprop_rho, eps=rmsprop_eps,
                   momentum=momentum)
  if name == "adam":
    return adam(learning_rate, b1=beta1, b2=beta2)
  if name == "adamw":
    return adamw(learning_rate, b1=beta1, b2=beta2, weight_decay=weight_decay,
                 mask=weight_decay_mask)
  if name == "lion":
    return lion(learning_rate, weight_decay=weight_decay,
                mask=weight_decay_mask)
  raise ValueError(f"Unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# Trainability mask, clipping, EMA.
# ---------------------------------------------------------------------------

BATCH_STAT_NAMES = ("moving_mean", "moving_variance")


def is_batch_stat(name: str) -> bool:
  return name.rsplit(".", 1)[-1] in BATCH_STAT_NAMES


def masked_for_params(tx: GradientTransformation) -> GradientTransformation:
  """tx on the trainable leaves only; the updates of the BN moving
  statistics pass through unchanged (optax.masked with nn.trainable_mask).
  The state is tx's over the trainable leaves; the mask is read from the
  names."""

  def trainable(tree):
    return {k: v for k, v in tree.items() if not is_batch_stat(k)}

  def init(params):
    return tx.init(trainable(params))

  def update(updates, state, params=None):
    new, state = tx.update(trainable(updates), state,
                           None if params is None else trainable(params))
    return {k: new.get(k, u) for k, u in updates.items()}, state

  return GradientTransformation(init, update)


def _norms(leaves: list) -> torch.Tensor:
  """[len(leaves)] f32 L2 norms, in one multi-tensor call."""
  return torch.stack(torch._foreach_norm(leaves, 2, dtype=torch.float32))


def global_norm(tree: dict) -> torch.Tensor:
  """sqrt of the sum of squares of every leaf, in f32 (optax.global_norm)."""
  return torch.linalg.vector_norm(_norms(list(tree.values())))


def clip_gradients(grads: dict, clip_norm: float | None,
                   per_var: bool = True) -> dict:
  """Per-variable clip-by-norm (per_var, the detection trainer's setting),
  then a global clip (automl_tpu train/optimizers.py:110-123), with
  multi-tensor ops: a handful of calls however many leaves."""
  if not clip_norm:
    return grads
  gs = list(grads.values())
  if per_var:
    scales = torch.clamp(clip_norm / torch.clamp(_norms(gs), min=1e-12),
                         max=1.0)
    gs = torch._foreach_mul(gs, list(scales.unbind()))
  scale = torch.clamp(clip_norm / torch.clamp(
      torch.linalg.vector_norm(_norms(gs)), min=1e-12), max=1.0)
  return dict(zip(grads, torch._foreach_mul(gs, scale)))


def ema_init(params: dict) -> dict:
  """A copy of every leaf (parameters and BN statistics)."""
  return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, decay: float, step=None):
  """TF ExponentialMovingAverage, in place: decay_t = min(decay,
  (1 + t) / (10 + t)) in f32; e -= (1 - decay_t) * (e - p)."""
  d = np.float32(decay)
  if step is not None:
    t = np.float32(step)
    d = min(d, (np.float32(1.0) + t) / (np.float32(10.0) + t))
  w = float(np.float32(1.0) - np.float32(d))
  es = list(ema_params.values())
  diffs = torch._foreach_sub(es, [params[k].to(e.dtype) for k, e in
                                  ema_params.items()])
  torch._foreach_add_(es, diffs, alpha=-w)
  return ema_params
