"""Symbolic-program search space for optimizer discovery.

The counterpart of automl_tpu/search/program.py, over the port's trees:
dicts (flat, as train/optimizers.py uses, or nested) of tensors, with
Python numbers and 0-d tensors as scalar leaves.

  * A Program is a straight-line sequence of single-target assignments
    ending in `return <expr>`; its inputs are named formals (g, m, w, ...).
    Parsing keeps JAX's whitelist and refusals.
  * Execution walks the AST with a whitelisted function registry: every op
    is a torch function mapped over the tree's leaves, a scalar broadcast
    over a tree.
  * Abstract execution runs the program on `device="meta"` tensors (shapes
    and dtypes, no data), in place of jax.eval_shape.
  * canonical / hash / functional_hash / mutate / hparam_tune are pure
    Python, as in JAX: for a seed the same mutants, source for source, and
    the same hash strings. The registry keeps JAX's names, arities and
    insertion order, which mutate draws from.
  * program_to_optimizer wraps (g, m, w) -> (update, m_new) programs as the
    port's GradientTransformation; LION_PROGRAM reproduces Lion.
"""

from __future__ import annotations

import ast
import copy
import hashlib
import math
import random
from typing import Any, Callable, NamedTuple

import torch

from automl_tpu_torch.train.optimizers import GradientTransformation


# ---------------------------------------------------------------------------
# Trees: dicts of leaves; None is the empty tree (jax.tree_util's rules).
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
  """fn over the leaves of `tree`; the other trees must share its dict
  structure below each dict of `tree` (a leaf of `tree` takes whatever the
  others hold there, as a JAX prefix does)."""
  if isinstance(tree, dict):
    for other in rest:
      if not isinstance(other, dict) or set(other) != set(tree):
        raise ValueError("tree_map: the trees' structures differ")
    return {k: tree_map(fn, v, *(o[k] for o in rest)) for k, v in
            tree.items()}
  if tree is None:
    if any(o is not None for o in rest):
      raise ValueError("tree_map: the trees' structures differ")
    return None
  return fn(tree, *rest)


def tree_leaves(tree) -> list:
  if isinstance(tree, dict):
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
  return [] if tree is None else [tree]


def _structure(tree):
  if isinstance(tree, dict):
    return tuple((k, _structure(tree[k])) for k in sorted(tree))
  return None if tree is None else "*"


def _t(x):
  """A leaf as a tensor (a Python number: a 0-d float32 tensor, as jnp
  makes one of a weakly typed float)."""
  if torch.is_tensor(x):
    return x
  return torch.as_tensor(x, dtype=torch.float32 if isinstance(x, float)
                         else None)


# ---------------------------------------------------------------------------
# Function registry (fn_lib equivalent). All ops act leaf-wise on trees.
# ---------------------------------------------------------------------------


def _tree_unary(fn):
  return lambda x: tree_map(fn, x)


def _tree_binary(fn):
  def apply(a, b):
    if _structure(a) == _structure(b):
      return tree_map(fn, a, b)
    # scalar broadcast
    return tree_map(lambda x: fn(x, b), a)
  return apply


def _interpolate(a, b, t):
  """(1 - t) * a + t * b (hero/fn_lib.py interpolate)."""
  return tree_map(lambda x, y: (1.0 - t) * x + t * y, a, b)


def _global_norm(x):
  """sqrt of the sum of squares of every leaf (optax.global_norm, which
  takes arrays only: a Python number raises, as there)."""
  leaves = tree_leaves(x)
  for v in leaves:
    if not torch.is_tensor(v):
      raise ValueError(f"global_norm takes tensors only, got {v!r}")
  return torch.sqrt(_t(sum((torch.sum(torch.square(v)) for v in leaves),
                           0.0)))


def _dot(a, b):
  leaves = tree_map(lambda x, y: torch.sum(_t(x * y)), a, b)
  return sum(tree_leaves(leaves))


def _cosine_sim(a, b):
  return _dot(a, b) / torch.clamp(_global_norm(a) * _global_norm(b),
                                  min=1e-12)


def _clip_by_global_norm(x, max_norm):
  norm = _global_norm(x)
  scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
  return tree_map(lambda v: v * scale, x)


def _eps_like(x):
  """sign(x) * 1e-12 + (x == 0) * 1e-12 in x's dtype: the guard that keeps
  a divisor off 0."""
  return (torch.sign(x) + (x == 0).to(x.dtype)) * 1e-12


def _on_tensors(fn):
  """fn on tensor leaves, Python numbers made 0-d tensors first (a jnp
  function returns an array for a Python number)."""
  return lambda *args: fn(*(_t(a) for a in args))


class FunctionRegistry(dict):
  """name -> (callable, arity); arity is read by mutation proposals."""

  def register(self, name: str, fn: Callable, arity: int):
    self[name] = (fn, arity)
    return fn


def _nonneg(fn):
  """Domain guard: apply to |x| (ref: fn_lib.py nonneg)."""
  return lambda x: fn(torch.abs(x))


def _clip(lo, hi):
  return lambda x: torch.clamp(x, lo, hi)


def default_registry() -> FunctionRegistry:
  """The whitelisted math table, JAX's names, arities and order, with the
  same domain guards, so mutants cannot produce NaN out of range."""
  r = FunctionRegistry()
  c30, c15 = _clip(-30, 30), _clip(-15, 15)
  # neg, negative and cube keep Python numbers Python numbers, as JAX's
  # lambdas do; every other op returns a tensor.
  plain = ("neg", "negative", "cube")
  unary = {
      "sign": torch.sign,
      "abs": torch.abs,
      "neg": lambda x: -x,
      "negative": lambda x: -x,
      "square": torch.square,
      "sqrt": _nonneg(torch.sqrt),
      "cube": lambda x: x * x * x,
      "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
      "reciprocal": lambda x: 1.0 / (x + _eps_like(x)),
      "cos": torch.cos, "sin": torch.sin, "tan": torch.tan,
      "arcsin": lambda x: torch.asin(torch.clamp(x, -1.0, 1.0)),
      "arccos": lambda x: torch.acos(torch.clamp(x, -1.0, 1.0)),
      "arctan": torch.atan,
      "sinh": lambda x: torch.sinh(c30(x)),
      "cosh": lambda x: torch.cosh(c30(x)),
      "tanh": torch.tanh,
      "arcsinh": torch.asinh,
      "arccosh": lambda x: torch.acosh(torch.abs(x) + 1.0),
      "arctanh": lambda x: torch.atanh(torch.clamp(x, -1 + 1e-7, 1 - 1e-7)),
      "exp": lambda x: torch.exp(c30(x)),
      "exp2": lambda x: torch.exp2(c30(x)),
      "exp10": lambda x: torch.pow(10.0, c15(x)),
      "expm1": lambda x: torch.expm1(c30(x)),
      "log": _nonneg(lambda x: torch.log(x + 1e-12)),
      "log2": _nonneg(lambda x: torch.log2(x + 1e-12)),
      "log10": _nonneg(lambda x: torch.log10(x + 1e-12)),
      "log1p": lambda x: torch.log(torch.abs(1.0 + x) + 1e-12),
  }
  for name, fn in unary.items():
    r.register(name, _tree_unary(fn if name in plain else _on_tensors(fn)),
               1)
  for name, fn in [
      ("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
      ("div", lambda a, b: a / (b + _eps_like(b))),
      ("max", torch.maximum), ("min", torch.minimum),
      ("power", lambda a, b: torch.pow(torch.abs(a) + 1e-12,
                                       torch.clamp(b, -8, 8))),
  ]:
    r.register(name, _tree_binary(_on_tensors(fn)), 2)
  # no-arg constants (ref: fn_lib.py noarg_fn_dict)
  r.register("get_pi", lambda: math.pi, 0)
  r.register("get_e", lambda: math.e, 0)
  r.register("get_eps", lambda: 1e-8, 0)
  r.register("interpolate", _interpolate, 3)
  r.register("global_norm", _global_norm, 1)
  r.register("dot", _dot, 2)
  r.register("cosine_sim", _cosine_sim, 2)
  r.register("clip_by_global_norm", _clip_by_global_norm, 2)
  return r


# ---------------------------------------------------------------------------
# Program.
# ---------------------------------------------------------------------------


class Program:
  """Straight-line program: assignments then `return expr [, expr ...]`.

  Example (Lion):
    u = interpolate(m, g, 0.1)
    update = sign(u)
    m_new = interpolate(m, g, 0.01)
    return update, m_new
  """

  def __init__(self, source: str, inputs: tuple[str, ...],
               registry: FunctionRegistry | None = None):
    self.source = source.strip()
    self.inputs = tuple(inputs)
    self.registry = registry or default_registry()
    self.body = self._parse(self.source)

  # -- parse / validate ----------------------------------------------------
  def _parse(self, source: str) -> list[ast.stmt]:
    tree = ast.parse(source)
    body = tree.body
    if not body or not isinstance(body[-1], ast.Return):
      raise ValueError("program must end with `return ...`")
    for stmt in body[:-1]:
      if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
              and isinstance(stmt.targets[0], ast.Name)):
        raise ValueError(f"only single-target assignments allowed: "
                         f"{ast.dump(stmt)}")
    return body

  # -- execution -------------------------------------------------------------
  def _eval_expr(self, node: ast.expr, env: dict) -> Any:
    if isinstance(node, ast.Name):
      if node.id not in env:
        raise NameError(f"undefined variable {node.id!r}")
      return env[node.id]
    if isinstance(node, ast.Constant):
      return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
      return -self._eval_expr(node.operand, env)
    if isinstance(node, ast.Call):
      if not isinstance(node.func, ast.Name) or node.func.id not in self.registry:
        raise NameError(f"function not in registry: {ast.dump(node.func)}")
      fn, arity = self.registry[node.func.id]
      args = [self._eval_expr(a, env) for a in node.args]
      if len(args) != arity:
        raise TypeError(f"{node.func.id} expects {arity} args, got {len(args)}")
      return fn(*args)
    if isinstance(node, ast.Tuple):
      return tuple(self._eval_expr(e, env) for e in node.elts)
    raise ValueError(f"unsupported expression: {ast.dump(node)}")

  def execute(self, **kwargs) -> Any:
    env = dict(kwargs)
    missing = set(self.inputs) - set(env)
    if missing:
      raise TypeError(f"missing inputs: {sorted(missing)}")
    for stmt in self.body[:-1]:
      env[stmt.targets[0].id] = self._eval_expr(stmt.value, env)
    return self._eval_expr(self.body[-1].value, env)

  def abstract_execute(self, **kwargs):
    """Validate shapes / dtypes without compute: the program on meta
    tensors of the inputs' shapes and dtypes (tensor leaves of any device;
    other leaves as they are). Returns the outputs, meta tensors."""
    def meta(v):
      return torch.empty_like(v, device="meta") if torch.is_tensor(v) else v
    with torch.no_grad():
      return self.execute(**{k: tree_map(meta, v) for k, v in
                             kwargs.items()})

  # -- identity ----------------------------------------------------------------
  def canonical(self) -> str:
    return ast.dump(ast.Module(body=self.body, type_ignores=[]))

  def hash(self) -> str:
    return hashlib.sha256(self.canonical().encode()).hexdigest()[:16]

  def functional_hash(self) -> str:
    """Hash over abstract values, not syntax (ref: hero/core.py:360): each
    input is a fixed token, every call hash(fn_name, arg_tokens), and the
    hash is taken over the return value's tokens only, so renamed
    variables, reordered independent statements and dead assignments hash
    alike; a change to the computed function (constants included) does
    not."""
    def sym(node: ast.expr, env: dict) -> str:
      if isinstance(node, ast.Name):
        if node.id not in env:
          raise NameError(node.id)
        return env[node.id]
      if isinstance(node, ast.Constant):
        return f"const:{node.value!r}"
      if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        # hash exactly as a call to `neg` so `-x` and `neg(x)` dedup
        return hashlib.sha256(
            f"neg({sym(node.operand, env)})".encode()).hexdigest()[:24]
      if isinstance(node, ast.Call):
        args = ",".join(sym(a, env) for a in node.args)
        return hashlib.sha256(
            f"{node.func.id}({args})".encode()).hexdigest()[:24]
      if isinstance(node, ast.Tuple):
        return "(" + ",".join(sym(e, env) for e in node.elts) + ")"
      raise ValueError(ast.dump(node))

    env = {name: f"input:{name}" for name in self.inputs}
    for stmt in self.body[:-1]:
      env[stmt.targets[0].id] = sym(stmt.value, env)
    out = sym(self.body[-1].value, env)
    return hashlib.sha256(out.encode()).hexdigest()[:16]

  def collect_hparams(self) -> list[ast.Constant]:
    """The hard-coded numeric scalars (ref: hero/core.py collect_scalars)."""
    return [n for n in ast.walk(ast.Module(body=self.body, type_ignores=[]))
            if isinstance(n, ast.Constant)
            and isinstance(n.value, (int, float))
            and not isinstance(n.value, bool)]

  def hparam_tune(self, rng: random.Random) -> "Program":
    """Mutate ONE scalar constant, leaving the structure alone
    (hyperparameter-tuning mode, ref: hero/core.py:178-190)."""
    body = copy.deepcopy(self.body)
    consts = [n for n in ast.walk(ast.Module(body=body, type_ignores=[]))
              if isinstance(n, ast.Constant)
              and isinstance(n.value, (int, float))
              and not isinstance(n.value, bool)]
    if not consts:
      return Program(self.source, self.inputs, self.registry)
    node = rng.choice(consts)
    factor = rng.choice([0.1, 0.3, 0.5, 2.0, 3.0, 10.0, -1.0])
    node.value = float(node.value) * factor
    module = ast.Module(body=body, type_ignores=[])
    ast.fix_missing_locations(module)
    return Program(ast.unparse(module), self.inputs, self.registry)

  def __str__(self):
    return ast.unparse(ast.Module(body=self.body, type_ignores=[]))

  # -- mutation -----------------------------------------------------------------
  def _variables_before(self, idx: int) -> list[str]:
    names = list(self.inputs)
    for stmt in self.body[:idx]:
      if isinstance(stmt, ast.Assign):
        names.append(stmt.targets[0].id)
    return names

  def mutate(self, rng: random.Random) -> "Program":
    """Return a mutated copy (constant perturb / fn swap / arg swap /
    insert / delete)."""
    for _ in range(20):  # retry until a structurally valid mutant parses
      try:
        body = copy.deepcopy(self.body)
        op = rng.choice(["constant", "swap_fn", "swap_arg", "insert",
                         "delete"])
        if op == "constant":
          consts = [n for n in ast.walk(ast.Module(body=body, type_ignores=[]))
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, (int, float))]
          if not consts:
            continue
          node = rng.choice(consts)
          factor = rng.choice([0.1, 0.5, 2.0, 10.0, -1.0])
          node.value = float(node.value) * factor + rng.gauss(0, 1e-3)
        elif op == "swap_fn":
          calls = [n for stmt in body for n in ast.walk(stmt)
                   if isinstance(n, ast.Call)]
          if not calls:
            continue
          node = rng.choice(calls)
          arity = len(node.args)
          candidates = [name for name, (_, a) in self.registry.items()
                        if a == arity and name != node.func.id]
          if not candidates:
            continue
          node.func = ast.Name(id=rng.choice(candidates), ctx=ast.Load())
        elif op == "swap_arg":
          idx = rng.randrange(len(body))
          stmt = body[idx]
          names = [n for n in ast.walk(stmt) if isinstance(n, ast.Name)
                   and isinstance(n.ctx, ast.Load)
                   and n.id not in self.registry]
          if not names:
            continue
          node = rng.choice(names)
          node.id = rng.choice(self._variables_before(idx))
        elif op == "insert":
          idx = rng.randrange(len(body))  # before stmt idx
          vars_avail = self._variables_before(idx)
          fn_name = rng.choice(list(self.registry))
          _, arity = self.registry[fn_name]
          args = []
          for _ in range(arity):
            if rng.random() < 0.25:
              args.append(ast.Constant(value=round(rng.uniform(0, 1), 3)))
            else:
              args.append(ast.Name(id=rng.choice(vars_avail), ctx=ast.Load()))
          new_name = f"v{rng.randrange(10_000)}"
          body.insert(idx, ast.Assign(
              targets=[ast.Name(id=new_name, ctx=ast.Store())],
              value=ast.Call(func=ast.Name(id=fn_name, ctx=ast.Load()),
                             args=args, keywords=[])))
        elif op == "delete":
          if len(body) <= 2:
            continue
          idx = rng.randrange(len(body) - 1)
          deleted = body[idx].targets[0].id
          body.pop(idx)
          # references to the deleted var must rebind
          for later in body[idx:]:
            for n in ast.walk(later):
              if isinstance(n, ast.Name) and n.id == deleted \
                 and isinstance(n.ctx, ast.Load):
                n.id = rng.choice(self._variables_before(idx))
        module = ast.Module(body=body, type_ignores=[])
        ast.fix_missing_locations(module)
        return Program(ast.unparse(module), self.inputs, self.registry)
      except (ValueError, IndexError, SyntaxError):
        continue
    return Program(self.source, self.inputs, self.registry)


# ---------------------------------------------------------------------------
# Programs as optimizers.
# ---------------------------------------------------------------------------

# The Lion update expressed in the search space (lion/README.md semantics).
LION_PROGRAM = """
u = interpolate(m, g, 0.1)
update = sign(u)
m_new = interpolate(m, g, 0.01)
return update, m_new
"""

# A signless momentum baseline (a typical search seed).
MOMENTUM_PROGRAM = """
m_new = interpolate(m, g, 0.1)
update = m_new
return update, m_new
"""


class ProgramOptState(NamedTuple):
  m: Any


def program_to_optimizer(program: Program,
                         learning_rate: float) -> GradientTransformation:
  """Wrap a (g, m, w) -> (update, m_new) program as the port's
  GradientTransformation over {name: tensor} trees: the updates are
  -learning_rate * update, the state the program's m (zeros at init)."""

  def init_fn(params):
    return ProgramOptState(m=tree_map(torch.zeros_like, params))

  def update_fn(grads, state, params=None):
    update, m_new = program.execute(g=grads, m=state.m, w=params)
    scaled = tree_map(lambda u: -learning_rate * u, update)
    return scaled, ProgramOptState(m=m_new)

  return GradientTransformation(init_fn, update_fn)
