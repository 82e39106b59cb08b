"""Regularized evolution over optimizer programs.

Capability parity with the reference's search driver pattern (hero/core.py
mutate/hparam_tune + the end-to-end 'learn a regression with a mutated
optimizer program' flow exercised in hero/core_test.py:838+).

Classic regularized evolution (Real et al.): keep a sliding population; each
cycle, sample a tournament, mutate the best member, evaluate, push, pop the
oldest. Deduplicates by program hash (functional-equivalence cache, cf.
hero/core.py Program.hash).
"""

from __future__ import annotations

import collections
import random
from typing import Callable

from automl_tpu_torch.search.program import Program


def regularized_evolution(
    seed_program: Program,
    evaluate: Callable[[Program], float],
    cycles: int = 50,
    population_size: int = 20,
    tournament_size: int = 5,
    seed: int = 0,
    minimize: bool = True,
    hparam_tune_prob: float = 0.25,
    abstract_inputs: dict | None = None,
):
  """Returns (best_program, best_fitness, stats).

  Dedup is by FUNCTIONAL hash (abstract-value execution, so renamed/dead-code
  variants hit the cache, ref: hero/core.py:360); with probability
  `hparam_tune_prob` a cycle tunes one scalar instead of mutating structure
  (ref: hero/core.py:178). When `abstract_inputs` is given (name -> example
  array), children are shape-validated by abstract execution before any real
  evaluation spend (ref: hero's abstract execution gate).

  stats: dict(history, evaluations, cache_hits, rejected_abstract,
  failed_evaluations).
  """
  rng = random.Random(seed)
  sign = 1.0 if minimize else -1.0
  population = collections.deque()
  cache: dict[str, float] = {}
  stats = {"evaluations": 0, "cache_hits": 0, "rejected_abstract": 0,
           "failed_evaluations": 0}

  def run(prog: Program) -> float:
    h = prog.functional_hash()
    if h in cache:
      stats["cache_hits"] += 1
      return cache[h]
    try:
      if abstract_inputs is not None:
        prog.abstract_execute(**abstract_inputs)
    except Exception:
      stats["rejected_abstract"] += 1
      cache[h] = float("inf") * sign
      return cache[h]
    stats["evaluations"] += 1
    try:
      cache[h] = float(evaluate(prog))
    except Exception:
      # passed the abstract gate but crashed on real data — distinct from
      # an abstract-gate rejection for tuning the gate/mutation mix
      stats["failed_evaluations"] = stats.get("failed_evaluations", 0) + 1
      cache[h] = float("inf") * sign
    return cache[h]

  best = seed_program
  best_fit = run(seed_program)
  population.append((seed_program, best_fit))
  history = [best_fit]

  for _ in range(cycles):
    sample = rng.sample(list(population),
                        min(tournament_size, len(population)))
    parent = min(sample, key=lambda pf: sign * pf[1])[0]
    if rng.random() < hparam_tune_prob:
      child = parent.hparam_tune(rng)
    else:
      child = parent.mutate(rng)
    fit = run(child)
    population.append((child, fit))
    if len(population) > population_size:
      population.popleft()
    if sign * fit < sign * best_fit:
      best, best_fit = child, fit
    history.append(best_fit)
  stats["history"] = history
  return best, best_fit, stats
