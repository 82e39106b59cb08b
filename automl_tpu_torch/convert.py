"""Parameters between the JAX package's tree and the PyTorch modules.

The JAX LM (automl_tpu/models/lm.py TransformerLM.init) keeps its
parameters as a nested dict of arrays:

  embed [V, d]; unembed [d, V] (untied only); final_norm/scale [d];
  blocks/...: attn/{wq, wo} [d, n, h], attn/{wk, wv} [d, n_kv, h],
  attn/per_dim_scale [h], ffn/{w0, wg} [d, f], ffn/w1 [f, d],
  {pre,post}_{attn,ffn}_norm/scale [d]

where every `blocks` leaf carries a leading [L] axis (the scan-stacked
layout), or `blocks` is a list of per-layer dicts. The PyTorch modules use
the same layouts, one TransformerBlock per layer, so a leaf converts by
slicing off its layer and renaming `a/b/c` to `a.b.c`:
`blocks/attn/wq[i]` <-> `blocks.{i}.attn.wq`.

A tree is given as numpy arrays (np.asarray of each JAX leaf), or read from
a `params.npz` whose keys are the tree's paths joined with `/`.

A training state carries over the same way (lion_state_from_jax /
lion_state_to_jax): the step, the parameters, and the Lion momentum, a tree
in the parameters' layout, so that a run started by the JAX trainer can go
on in the port and back.
"""

from __future__ import annotations

import numpy as np
import torch

from automl_tpu_torch.config import Config


def flatten_tree(tree, prefix: str = "") -> dict:
  """Nested dict/list of arrays -> {'a/b/c': array}."""
  if isinstance(tree, dict):
    items = tree.items()
  elif isinstance(tree, (list, tuple)):
    items = ((str(i), v) for i, v in enumerate(tree))
  else:
    return {prefix: tree}
  out = {}
  for k, v in items:
    out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
  return out


def unflatten_tree(flat: dict) -> dict:
  """{'a/b/c': array} -> nested dict."""
  tree: dict = {}
  for path, value in flat.items():
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = value
  return tree


def jax_to_torch_state(tree) -> dict:
  """JAX-layout LM parameter tree -> state dict of TransformerLM."""
  blocks = tree.get("blocks")
  state = {}
  for path, value in flatten_tree({k: v for k, v in tree.items()
                                   if k != "blocks"}).items():
    state[path.replace("/", ".")] = torch.from_numpy(np.array(value))
  if isinstance(blocks, (list, tuple)):     # per-layer list
    for i, layer in enumerate(blocks):
      for path, value in flatten_tree(layer).items():
        state[f"blocks.{i}.{path.replace('/', '.')}"] = torch.from_numpy(
            np.array(value))
  elif blocks is not None:                  # scan-stacked [L, ...]
    for path, value in flatten_tree(blocks).items():
      value = np.asarray(value)
      for i in range(value.shape[0]):
        state[f"blocks.{i}.{path.replace('/', '.')}"] = torch.from_numpy(
            np.array(value[i]))
  return state


def torch_to_jax_tree(state: dict) -> dict:
  """TransformerLM state dict -> JAX-layout tree of numpy arrays, with the
  blocks stacked on a leading [L] axis."""
  top, per_layer = {}, {}
  for name, value in state.items():
    arr = value.detach().cpu().numpy()
    parts = name.split(".")
    if parts[0] == "blocks":
      per_layer.setdefault("/".join(parts[2:]), {})[int(parts[1])] = arr
    else:
      top["/".join(parts)] = arr
  for path, layers in per_layer.items():
    top["blocks/" + path] = np.stack([layers[i] for i in sorted(layers)])
  return unflatten_tree(top)


def load_npz(path) -> dict:
  """params.npz with '/'-joined tree paths as keys -> nested tree."""
  with np.load(path) as data:
    return unflatten_tree({k: data[k] for k in data.files})


def save_npz(path, tree) -> None:
  np.savez(path, **flatten_tree(tree))


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
  """Copies a JAX-layout tree into the model's parameters (strict)."""
  model.load_state_dict(jax_to_torch_state(tree), strict=True)
  return model


def numpy_init(cfg: Config, seed: int = 0) -> dict:
  """A seeded JAX-layout parameter tree with the JAX model's init scales.

  The same distributions as automl_tpu TransformerLM.init (normals scaled
  by fan-in, zero norm scales and per-dim scale), drawn with numpy so that
  no jax is needed; the numbers differ from jax.random's."""
  rng = np.random.default_rng(seed)
  dt = np.dtype(cfg.param_dtype)
  d, hd, L = cfg.model_dim, cfg.head_dim, cfg.n_layers
  n, n_kv = cfg.n_heads, cfg.n_kv_heads
  f = cfg.expand_factor * d

  def normal(shape, scale):
    w = rng.standard_normal(shape, dtype=np.float32)
    w *= np.float32(scale)
    return w.astype(dt, copy=False)

  attn = {"wq": normal((L, d, n, hd), d ** -0.5),
          "wk": normal((L, d, n_kv, hd), d ** -0.5),
          "wv": normal((L, d, n_kv, hd), d ** -0.5),
          "wo": normal((L, d, n, hd), (n * hd) ** -0.5)}
  if cfg.get("use_per_dim_scale"):
    attn["per_dim_scale"] = np.zeros((L, hd), np.float32)
  ffn = {"w0": normal((L, d, f), d ** -0.5),
         "w1": normal((L, f, d), f ** -0.5)}
  if cfg.use_gated_ffn:
    ffn["wg"] = normal((L, d, f), d ** -0.5)
  blocks = {"attn": attn, "ffn": ffn}
  norms = ["pre_attn_norm", "pre_ffn_norm"]
  if cfg.use_post_ln:
    norms += ["post_attn_norm", "post_ffn_norm"]
  for name in norms:
    blocks[name] = {"scale": np.zeros((L, d), np.float32)}
  tree = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
          "final_norm": {"scale": np.zeros((d,), np.float32)},
          "blocks": blocks}
  if not cfg.tie_embeddings:
    tree["unembed"] = normal((d, cfg.vocab_size), d ** -0.5)
  return tree


def lion_state_from_jax(model: torch.nn.Module, step, params, momentum,
                        count=None):
  """A JAX LMTrainState trained with Lion, as numpy trees, -> the port's
  LMTrainState (automl_tpu_torch/train/lm_trainer.py) for `model`.

  params and momentum are JAX-layout trees (the momentum is
  opt_state[0].momentum of optax.chain(scale_by_lion, add_decayed_weights,
  scale_by_learning_rate)); count is that chain's schedule count
  (opt_state[2].count), the step when not given. The model's parameters
  are set in place. The state fits train.optimizers.lion /
  build_optimizer("lion")."""
  from automl_tpu_torch.train.lm_trainer import LMTrainState
  load_jax_params(model, params)
  named = dict(model.named_parameters())
  mom = jax_to_torch_state(momentum)
  if set(mom) != set(named):
    raise ValueError("momentum tree does not match the model's parameters: "
                     f"{sorted(set(mom) ^ set(named))}")
  mu = {k: mom[k].to(device=p.device, dtype=p.dtype) for k, p in named.items()}
  step = int(np.asarray(step))
  count = step if count is None else int(np.asarray(count))
  return LMTrainState(step, named, ({"momentum": mu}, {}, {"count": count}))


def lion_state_to_jax(state) -> dict:
  """The port's Lion LMTrainState -> {step, params, momentum, count} with
  JAX-layout numpy trees (blocks stacked on a leading [L] axis)."""
  lion_state, _, sched = state.opt_state
  return {"step": int(state.step),
          "params": torch_to_jax_tree(state.params),
          "momentum": torch_to_jax_tree(lion_state["momentum"]),
          "count": int(sched["count"])}
