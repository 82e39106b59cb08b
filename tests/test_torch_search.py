"""automl_tpu_torch.search against automl_tpu.search on the CPU.

The cases of tests/test_search.py on the port (parse / execute / mutate /
hash, Lion as a program, abstract execution on meta tensors, evolution on a
regression), then the port against JAX: the registry's names, arities and
order; for a seed the same mutants, source for source, with the same
hashes and functional hashes; program_to_optimizer(LION_PROGRAM) against
JAX's and against the port's lion; regularized_evolution with a
deterministic fitness, the same history and stats. Tolerances are stated
per test.
"""

import ast
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.search import evolution as jevolution
from automl_tpu.search import program as jprogram
from automl_tpu.train import optimizers as jopt
from automl_tpu_torch.search import evolution
from automl_tpu_torch.search.program import (
    LION_PROGRAM, MOMENTUM_PROGRAM, Program, default_registry,
    program_to_optimizer)
from automl_tpu_torch.train.optimizers import lion

INPUTS = ("g", "m", "w")


def _lion_prog():
  return Program(LION_PROGRAM, inputs=INPUTS)


def _descend(prog, loss_and_grad, w, steps, lr=0.05):
  """`steps` steps of program_to_optimizer(prog, lr) from w; the last
  loss as a float."""
  tx = program_to_optimizer(prog, learning_rate=lr)
  state = tx.init(w)
  loss = float("inf")
  for _ in range(steps):
    loss, g = loss_and_grad(w)
    up, state = tx.update(g, state, w)
    w = w + up
  return float(loss)


# ---------------------------------------------------------------------------
# tests/test_search.py's cases on the port.
# ---------------------------------------------------------------------------


def test_program_execute():
  p = Program("s = add(a, b)\nreturn mul(s, 2.0)", inputs=("a", "b"))
  out = p.execute(a=torch.tensor(3.0), b=torch.tensor(4.0))
  assert float(out) == 14.0


def test_program_pytree_execution():
  """Exact: sign of a momentum of 0, and 0.01 g (rtol 1e-6)."""
  g = {"w": torch.tensor([0.5, -0.1])}
  m = {"w": torch.zeros(2)}
  update, m_new = _lion_prog().execute(g=g, m=m, w=None)
  np.testing.assert_array_equal(update["w"].numpy(), [1.0, -1.0])
  np.testing.assert_allclose(m_new["w"].numpy(), 0.01 * g["w"].numpy(),
                             rtol=1e-6)


def test_lion_program_matches_lion_optimizer():
  """The program-space Lion reproduces train/optimizers.lion step for
  step, bit for bit (the same products, summed in the same pairs)."""
  params = {"w": torch.tensor([1.0, -2.0, 0.3])}
  tx_prog = program_to_optimizer(_lion_prog(), learning_rate=0.1)
  tx_ref = lion(learning_rate=0.1)
  sp, sr = tx_prog.init(params), tx_ref.init(params)
  for i in range(4):
    g = {"w": torch.tensor([0.5, -0.1, 0.0]) * (i + 1)}
    up, sp = tx_prog.update(g, sp, params)
    ur, sr = tx_ref.update(g, sr, params)
    torch.testing.assert_close(up["w"], ur["w"], atol=0, rtol=0)


def test_program_hash_and_mutation():
  p = _lion_prog()
  rng = random.Random(0)
  hashes = {p.hash()}
  changed = executable = 0
  for _ in range(12):
    m = p.mutate(rng)
    if m.hash() not in hashes:
      changed += 1
    hashes.add(m.hash())
    try:
      # some mutants are semantically invalid (evolution filters them)
      m.execute(g={"w": torch.ones(2)}, m={"w": torch.zeros(2)}, w=None)
      executable += 1
    except Exception:
      pass
  assert changed >= 6   # mutations usually produce new programs
  assert executable >= 6  # and most remain executable


def test_abstract_execution_validates_without_flops():
  """Meta tensors in, meta tensors of the right shape and dtype out; a
  card tensor's shape is taken without its data."""
  p = _lion_prog()
  g = torch.empty(128, device="meta")
  out = p.abstract_execute(g=g, m=g, w=g)
  assert out[0].shape == (128,) and out[0].device.type == "meta"
  out = p.abstract_execute(g={"a": torch.ones(3, 4)}, m={"a": torch.ones(
      3, 4)}, w=None)
  assert out[1]["a"].shape == (3, 4) and out[1]["a"].dtype == torch.float32
  assert out[1]["a"].device.type == "meta"
  with pytest.raises((TypeError, ValueError)):   # a tree against a leaf
    p.abstract_execute(g={"a": g}, m=g, w=g)


def test_rejects_unsafe_source():
  with pytest.raises(NameError):
    Program("x = __import__('os')\nreturn x", inputs=()).execute()
  with pytest.raises(ValueError):
    Program("return [i for i in range(3)]", inputs=()).execute()


def _regression():
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
  y = x @ torch.tensor([1.0, -2.0, 0.5, 3.0])

  def loss_and_grad(w):
    r = x @ w - y
    return torch.mean(r * r), 2.0 / x.shape[0] * (x.T @ r)

  return loss_and_grad


def test_evolution_improves_regression():
  """Evolve an optimizer program to fit a linear regression faster (the
  reference's end-to-end search smoke, core_test.py:838+)."""
  loss_and_grad = _regression()

  def evaluate(prog):
    return _descend(prog, loss_and_grad, torch.zeros(4), 30)

  seed = Program(MOMENTUM_PROGRAM, inputs=INPUTS)
  base_fit = evaluate(seed)
  best, best_fit, stats = evolution.regularized_evolution(
      seed, evaluate, cycles=15, population_size=8, seed=1)
  assert best_fit <= base_fit
  assert np.isfinite(best_fit)


def test_functional_hash_invariances():
  """Renamed variables, dead code and -x / neg(x) hash alike; a change to
  the computed function (constants, ops) does not."""
  a = Program("u = interpolate(m, g, 0.1)\nreturn sign(u)", ("g", "m"))
  renamed = Program("zz = interpolate(m, g, 0.1)\nreturn sign(zz)", ("g", "m"))
  dead = Program("u = interpolate(m, g, 0.1)\nunused = square(g)\n"
                 "return sign(u)", ("g", "m"))
  reordered = Program("dead2 = abs(m)\nu = interpolate(m, g, 0.1)\n"
                      "return sign(u)", ("g", "m"))
  assert a.functional_hash() == renamed.functional_hash()
  assert a.functional_hash() == dead.functional_hash()
  assert a.functional_hash() == reordered.functional_hash()
  assert a.hash() != dead.hash()
  diff_const = Program("u = interpolate(m, g, 0.2)\nreturn sign(u)", ("g", "m"))
  diff_fn = Program("u = interpolate(m, g, 0.1)\nreturn tanh(u)", ("g", "m"))
  assert a.functional_hash() != diff_const.functional_hash()
  assert a.functional_hash() != diff_fn.functional_hash()
  n1 = Program("return -g", ("g",))
  n2 = Program("return neg(g)", ("g",))
  assert n1.functional_hash() == n2.functional_hash()


def test_hparam_tune_changes_only_scalars():
  p = _lion_prog()
  tuned = p.hparam_tune(random.Random(3))
  ops = lambda prog: [n.func.id for s in prog.body
                      for n in ast.walk(s) if isinstance(n, ast.Call)]
  assert ops(tuned) == ops(p)
  vals = lambda prog: [n.value for n in prog.collect_hparams()]
  assert any(vals(p.hparam_tune(random.Random(s))) != vals(p)
             for s in range(5))


def test_evolution_dedup_cache_hits():
  """Functionally equivalent mutants do not spend evaluations again."""
  calls = []

  def evaluate(prog):
    calls.append(prog.functional_hash())
    return 1.0

  seed = Program(MOMENTUM_PROGRAM, inputs=INPUTS)
  _, _, stats = evolution.regularized_evolution(
      seed, evaluate, cycles=40, population_size=8, seed=0,
      hparam_tune_prob=0.0)
  assert stats["cache_hits"] > 0
  assert stats["evaluations"] == len(calls) == len(set(calls))


def test_evolution_rediscovers_sign_update():
  """On an ill-conditioned quadratic (coordinate scales 1e-2..1e2) a
  sign update dominates; evolution from a tanh seed reaches Lion-like
  quality."""
  scales = torch.tensor([0.01, 0.1, 1.0, 10.0, 100.0])

  def loss_and_grad(w):
    return torch.sum(scales * w * w), 2.0 * scales * w

  def evaluate(prog):
    return _descend(prog, loss_and_grad, torch.full((5,), 2.0), 40)

  seed_prog = Program(
      "u = interpolate(m, g, 0.1)\nupdate = tanh(u)\n"
      "m_new = interpolate(m, g, 0.01)\nreturn update, m_new", inputs=INPUTS)
  base = evaluate(seed_prog)
  lion_fit = evaluate(_lion_prog())
  assert lion_fit < base * 0.5
  spec = torch.empty(5, device="meta")
  best, best_fit, stats = evolution.regularized_evolution(
      seed_prog, evaluate, cycles=120, population_size=12, seed=0,
      abstract_inputs=dict(g=spec, m=spec, w=spec))
  assert best_fit <= lion_fit * 1.5, (best_fit, lion_fit, str(best))
  assert best_fit < base * 0.5, (best_fit, base)
  assert stats["evaluations"] > 10 and np.isfinite(best_fit)


# ---------------------------------------------------------------------------
# The port against JAX.
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
  """The same names with the same arities in the same order (mutate draws
  from the registry by position)."""
  want = [(k, a) for k, (_, a) in jprogram.default_registry().items()]
  assert [(k, a) for k, (_, a) in default_registry().items()] == want


@pytest.mark.parametrize("source", [LION_PROGRAM, MOMENTUM_PROGRAM])
def test_mutants_and_hashes_match_jax(source):
  """60 generations from one seed (mutate, with hparam_tune every third):
  every mutant's source, hash and functional hash equal JAX's as
  strings."""
  assert jprogram.LION_PROGRAM == LION_PROGRAM
  assert jprogram.MOMENTUM_PROGRAM == MOMENTUM_PROGRAM
  jp, tp = jprogram.Program(source, INPUTS), Program(source, INPUTS)
  jr, tr = random.Random(11), random.Random(11)
  for i in range(60):
    jp = jp.hparam_tune(jr) if i % 3 == 0 else jp.mutate(jr)
    tp = tp.hparam_tune(tr) if i % 3 == 0 else tp.mutate(tr)
    assert tp.source == jp.source
    assert tp.canonical() == jp.canonical()
    assert tp.hash() == jp.hash()
    assert tp.functional_hash() == jp.functional_hash()
    assert [n.value for n in tp.collect_hparams()] == [
        n.value for n in jp.collect_hparams()]


def test_program_to_optimizer_lion_matches_jax_and_lion():
  """5 steps on a two-leaf tree: the port's program Lion against JAX's
  (updates and momentum within 1e-7 absolute, f32) and bit-equal to the
  port's lion(lr, b1=0.9, b2=0.99)."""
  rng = np.random.default_rng(0)
  shapes = {"a": (3, 4), "b": (5,)}
  w = {k: rng.standard_normal(s).astype(np.float32) for k, s in
       shapes.items()}
  jtx = jprogram.program_to_optimizer(
      jprogram.Program(LION_PROGRAM, INPUTS), 3e-3)
  jref = jopt.lion(3e-3, b1=0.9, b2=0.99)
  ttx = program_to_optimizer(_lion_prog(), 3e-3)
  tref = lion(3e-3, b1=0.9, b2=0.99)
  jw = {k: jnp.asarray(v) for k, v in w.items()}
  tw = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
  tw_ref = {k: v.clone() for k, v in tw.items()}
  js, ts, trs = jtx.init(jw), ttx.init(tw), tref.init(tw_ref)
  assert jax.tree_util.tree_leaves(jref.init(jw))   # a momentum tree
  for step in range(5):
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jw)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tu, ts = ttx.update(tg, ts, tw)
    ru, trs = tref.update(tg, trs, tw_ref)
    for k in shapes:
      np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), atol=1e-7,
                                 rtol=0, err_msg=f"step {step} update {k}")
      np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                 atol=1e-7, rtol=0, err_msg=f"momentum {k}")
      torch.testing.assert_close(tu[k], ru[k], atol=0, rtol=0)
      torch.testing.assert_close(ts.m[k], trs[0]["momentum"][k], atol=0,
                                 rtol=0)
    jw = {k: jw[k] + ju[k] for k in shapes}
    tw = {k: tw[k] + tu[k] for k in shapes}
    tw_ref = {k: tw_ref[k] + ru[k] for k in shapes}


def _hash_fitness(prog):
  """A deterministic fitness of the program's function alone."""
  return (int(prog.functional_hash(), 16) % 1000) / 10.0


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_regularized_evolution_matches_jax(seed):
  """A fitness that depends on the program's function alone, the abstract
  gate on (JAX: ShapeDtypeStructs; the port: meta tensors): the same best
  program, fitness, history and stats (evaluations, cache hits, abstract
  rejections, failed evaluations) as JAX's."""
  spec_j = jax.ShapeDtypeStruct((5,), jnp.float32)
  spec_t = torch.empty(5, device="meta")
  jbest, jfit, jstats = jevolution.regularized_evolution(
      jprogram.Program(MOMENTUM_PROGRAM, INPUTS), _hash_fitness, cycles=60,
      population_size=8, seed=seed,
      abstract_inputs=dict(g=spec_j, m=spec_j, w=spec_j))
  tbest, tfit, tstats = evolution.regularized_evolution(
      Program(MOMENTUM_PROGRAM, INPUTS), _hash_fitness, cycles=60,
      population_size=8, seed=seed,
      abstract_inputs=dict(g=spec_t, m=spec_t, w=spec_t))
  assert tstats == jstats
  assert tfit == jfit and tbest.source == jbest.source
