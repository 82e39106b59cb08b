"""Optimizers as optax-style gradient transformations on dicts of tensors.

The counterpart of automl_tpu/train/optimizers.py. A transformation is a
pair (init, update) over {name: tensor} dicts keyed like
model.named_parameters(): init(params) -> state; update(updates, state,
params) -> (updates, new state). The rules are optax's, so that one state
trains the same in both packages: scale_by_learning_rate negates, the Lion
momentum keeps the parameters' dtype, sign(0) = 0. torch.optim is not used:
its update rules and weight-decay placement differ from optax's.

Ported: sgd, momentum, lion. rmsprop, adam, adamw, weight-decay masks,
and the EMA and trainability masks of the vision trainers come with
ROADMAP M5.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
  """updates + weight_decay * params."""

  def update(updates, state, params=None):
    return _map(lambda u, p: u + weight_decay * p, updates, params), state

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
         weight_decay: float = 0.0) -> GradientTransformation:
  return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay),
               scale_by_learning_rate(learning_rate))


def build_optimizer(name: str, learning_rate, *, momentum: float = 0.9,
                    weight_decay: float = 0.0) -> GradientTransformation:
  """Name -> transformation (learning_rate may be a schedule fn).

  rmsprop / adam / adamw and the weight-decay mask are not ported yet:
  ROADMAP M5."""
  name = (name or "sgd").lower()
  if name in ("rmsprop", "adam", "adamw"):
    raise NotImplementedError(
        f"optimizer {name!r} is not ported to automl_tpu_torch yet: "
        "ROADMAP M5")
  if name == "sgd":
    return sgd(learning_rate)
  if name == "momentum":
    return sgd(learning_rate, momentum=momentum)
  if name == "lion":
    return lion(learning_rate, weight_decay=weight_decay)
  raise ValueError(f"Unknown optimizer {name!r}")
