"""Parameters between the JAX package's tree and the PyTorch modules.

The JAX LM (automl_tpu/models/lm.py TransformerLM.init) keeps its
parameters as a nested dict of arrays:

  embed [V, d]; unembed [d, V] (untied only); final_norm/scale [d];
  blocks/...: attn/{wq, wo} [d, n, h], attn/{wk, wv} [d, n_kv, h] (with
  use_combined_qkv attn/wqkv [3, d, n, h], or attn/wkv [2, d, n_kv, h]
  beside wq under GQA), attn/per_dim_scale [h], ffn/{w0, wg} [d, f],
  ffn/w1 [f, d] (with moe_num_experts E: ffn/router [d, E] f32,
  ffn/{w0, wg} [E, d, f], ffn/w1 [E, f, d]),
  {pre,post}_{attn,ffn}_norm/scale [d]; after
  quantize_lm_params a quantized weight w is {w/qvalue int8, w/scale f32}

where every `blocks` leaf carries a leading [L] axis (the scan-stacked
layout), or `blocks` is a list of per-layer dicts. The PyTorch modules use
the same layouts, one TransformerBlock per layer, so a leaf converts by
slicing off its layer and renaming `a/b/c` to `a.b.c`:
`blocks/attn/wq[i]` <-> `blocks.{i}.attn.wq`.

A tree is given as numpy arrays (np.asarray of each JAX leaf), or read from
a `params.npz` whose keys are the tree's paths joined with `/`. A model on
a mesh (DTensor parameters) takes each full leaf cut to its rank's part;
full_state gathers such a model's parameters back to full tensors.

A training state carries over the same way (lion_state_from_jax /
lion_state_to_jax): the step, the parameters, and the Lion momentum, a tree
in the parameters' layout, so that a run started by the JAX trainer can go
on in the port and back.

The EfficientDet tree (automl_tpu/models/efficientdet.py EfficientDet.init)
maps to the port's modules by name (models/efficientdet.py): a state_dict
key is the JAX path with '.' for '/', with two differences. Layouts: conv
kernels HWIO <-> OIHW, depthwise [k, k, 1, C] <-> [C, 1, k, k] (the same
transpose), dense [in, out] <-> [out, in]. Stacking: JAX stacks on a
leading axis what the port keeps as one module per repeat, after a path
component 'conv_stack', 'cells_rep' or '<prefix>-bn-<level>':
`class_net/conv_stack/depthwise/kernel[i]` <->
`class_net.conv_stack.<i>.depthwise.kernel`. BatchNorm moving statistics
are buffers. The segmentation head's transposed-conv kernels
(con2d_t_<i>, head_transpose) are HWIO in JAX and [I, O, kh, kw] in the
port, flipped in both spatial dims (lax.conv_transpose does not flip,
F.conv_transpose2d does): port[i, o, a, b] = jax[kh-1-a, kw-1-b, i, o].
GroupNorm's gamma / beta carry as they are. det_state_from_jax /
det_state_to_jax carry a detection
training state (step, parameters, momentum trace, EMA, moving normalizer).
An EfficientNet classifier's tree (the backbone plus head/*) maps the same
way; cls_state_from_jax / cls_state_to_jax carry a classification
training state under RMSProp (step, parameters, nu, the schedule count,
the momentum trace, EMA).
"""

from __future__ import annotations

import re

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


def _tensor(value) -> torch.Tensor:
  """A tensor of its own (a copy) of an array or a tensor."""
  if torch.is_tensor(value):
    return value.detach().clone()
  return torch.from_numpy(np.array(value))


def jax_to_torch_state(tree) -> dict:
  """JAX-layout LM parameter tree (leaves numpy arrays or tensors) ->
  state dict of TransformerLM."""
  blocks = tree.get("blocks")
  state = {}
  for path, value in flatten_tree({k: v for k, v in tree.items()
                                   if k != "blocks"}).items():
    state[path.replace("/", ".")] = _tensor(value)
  if isinstance(blocks, (list, tuple)):     # per-layer list
    for i, layer in enumerate(blocks):
      for path, value in flatten_tree(layer).items():
        state[f"blocks.{i}.{path.replace('/', '.')}"] = _tensor(value)
  elif blocks is not None:                  # scan-stacked [L, ...]
    for path, value in flatten_tree(blocks).items():
      if not torch.is_tensor(value):
        value = np.asarray(value)
      for i in range(value.shape[0]):
        state[f"blocks.{i}.{path.replace('/', '.')}"] = _tensor(value[i])
  return state


def torch_to_jax_tree(state: dict) -> dict:
  """TransformerLM state dict -> JAX-layout tree of numpy arrays, with the
  blocks stacked on a leading [L] axis."""
  top, per_layer = {}, {}
  for name, value in state.items():
    arr = value.detach().cpu().numpy()
    parts = name.split(".")
    if parts[0] == "blocks" and parts[1].isdigit():
      per_layer.setdefault("/".join(parts[2:]), {})[int(parts[1])] = arr
    else:                         # a stacked block leaf keeps its [L, ...]
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
  """Copies a JAX-layout tree into the model's parameters (strict).

  An int8 leaf of JAX's quantize_lm_params ({'qvalue', 'scale'}) turns the
  model's float parameter of that name into a QuantizedWeight first."""
  from automl_tpu_torch.models.lm import QuantizedWeight
  state = jax_to_torch_state(tree)
  for key in [k for k in state if k.endswith(".qvalue")]:
    owner_name, _, attr = key[:-len(".qvalue")].rpartition(".")
    owner = model.get_submodule(owner_name)
    weight = getattr(owner, attr)
    if not isinstance(weight, QuantizedWeight):
      scale = state[key[:-len("qvalue")] + "scale"]
      delattr(owner, attr)
      setattr(owner, attr, QuantizedWeight(
          torch.empty_like(state[key], device=weight.device),
          torch.empty_like(scale, device=weight.device)))
  params = dict(model.named_parameters())
  if getattr(model, "stacked", False):     # a pipeline model's [L, ...]
    from automl_tpu_torch.models.lm import stacked_layers
    state = stacked_layers(state)
  if getattr(model, "mesh", None) is None:
    model.load_state_dict(state, strict=True)
    return model
  from torch.distributed.tensor import DTensor, distribute_tensor
  if set(params) != set(state):
    raise ValueError("tree does not match the model's parameters: "
                     f"{sorted(set(params) ^ set(state))}")
  with torch.no_grad():
    for k, p in params.items():
      if isinstance(p, DTensor):
        part = distribute_tensor(state[k].to(p.device_mesh.device_type),
                                 p.device_mesh, p.placements,
                                 src_data_rank=None).to_local()
        p.to_local().copy_(part)
      else:
        p.copy_(state[k])
  return model


def full_state(model: torch.nn.Module) -> dict:
  """{name: full tensor} of a model's parameters (a DTensor gathered)."""
  from torch.distributed.tensor import DTensor
  return {k: p.full_tensor() if isinstance(p, DTensor) else p
          for k, p in model.named_parameters()}


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
  if cfg.get("use_combined_qkv"):
    # The same draws, stacked: JAX's wqkv [3, d, n, h] where the heads
    # match, else wq and wkv [2, d, n_kv, h] (each with the [L] axis first).
    wk, wv = attn.pop("wk"), attn.pop("wv")
    if n_kv == n:
      attn["wqkv"] = np.stack([attn.pop("wq"), wk, wv], axis=1)
    else:
      attn["wkv"] = np.stack([wk, wv], axis=1)
  if cfg.get("use_per_dim_scale"):
    attn["per_dim_scale"] = np.zeros((L, hd), np.float32)
  e = int(cfg.get("moe_num_experts") or 0)
  experts = (e,) if e else ()     # the MoE FFN's expert axis
  ffn = {"w0": normal((L, *experts, d, f), d ** -0.5),
         "w1": normal((L, *experts, f, d), f ** -0.5)}
  if cfg.use_gated_ffn:
    ffn["wg"] = normal((L, *experts, d, f), d ** -0.5)
  if e:
    ffn["router"] = normal((L, d, e), d ** -0.5).astype(np.float32)
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


# ---------------------------------------------------------------------------
# EfficientDet / EfficientNet.
# ---------------------------------------------------------------------------

_STACKED = re.compile(r"^(conv_stack|cells_rep|.+-bn-\d+)$")


def det_jax_path(key: str):
  """Port state_dict key -> (JAX tree path, index on the stacked leading
  axis or None)."""
  parts = key.split(".")
  for i in range(1, len(parts)):
    if parts[i].isdigit() and _STACKED.match(parts[i - 1]):
      return "/".join(parts[:i] + parts[i + 1:]), int(parts[i])
  return "/".join(parts), None


_TRANSPOSED = re.compile(r"(^|\.)(con2d_t_\d+|head_transpose)\.kernel$")


def _to_port_layout(key: str, value: np.ndarray) -> np.ndarray:
  if _TRANSPOSED.search(key):
    return value[::-1, ::-1].transpose(2, 3, 0, 1).copy()  # HWIO -> IOHW
  if key.rsplit(".", 1)[-1] == "kernel":
    if value.ndim == 4:
      return value.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if value.ndim == 2:
      return value.T                       # [in, out] -> [out, in]
  return value


def _to_jax_layout(key: str, value: np.ndarray) -> np.ndarray:
  if _TRANSPOSED.search(key):
    return value.transpose(2, 3, 0, 1)[::-1, ::-1].copy()
  if key.rsplit(".", 1)[-1] == "kernel":
    if value.ndim == 4:
      return value.transpose(2, 3, 1, 0)   # OIHW -> HWIO
    if value.ndim == 2:
      return value.T
  return value


def det_jax_to_torch_state(tree, keys) -> dict:
  """JAX-layout tree (nested dict of arrays or tensors) -> {port key:
  tensor} for the given port state_dict keys (every one must be found)."""
  flat = flatten_tree(tree)
  state = {}
  for key in keys:
    path, idx = det_jax_path(key)
    if path not in flat:
      raise KeyError(f"{key}: no leaf {path!r} in the JAX tree")
    value = flat[path]
    bf16 = torch.is_tensor(value) and value.dtype == torch.bfloat16
    value = np.asarray(value.view(torch.int16) if bf16 else value)
    if idx is not None:
      value = value[idx]
    # A copy: the port updates states in place (the EMA), and the tree's
    # arrays may be the caller's (or a JAX array's read-only buffer).
    t = torch.from_numpy(np.array(_to_port_layout(key, value), order="C"))
    state[key] = t.view(torch.bfloat16) if bf16 else t
  used = {det_jax_path(k)[0] for k in keys}
  extra = sorted(set(flat) - used)
  if extra:
    raise KeyError(f"JAX leaves with no port counterpart: {extra[:10]}")
  return state


def det_torch_to_jax_tree(state: dict, model=None) -> dict:
  """{port key: tensor} -> JAX-layout tree of numpy arrays, repeats
  stacked on a leading axis. With the model, the tree also holds the empty
  dicts JAX keeps for parameter-free children (a ResampleFeatureMap
  without its 1x1 conv)."""
  flat, stacks = {}, {}
  for key, value in state.items():
    arr = _to_jax_layout(key, value.detach().float().cpu().numpy()
                         if value.dtype == torch.bfloat16
                         else value.detach().cpu().numpy())
    path, idx = det_jax_path(key)
    if idx is None:
      flat[path] = arr
    else:
      stacks.setdefault(path, {})[idx] = arr
  for path, items in stacks.items():
    flat[path] = np.stack([items[i] for i in sorted(items)])
  tree = unflatten_tree(flat)
  for name, mod in (model.named_modules() if model is not None else ()):
    if name and next(iter(mod.parameters()), None) is None:
      node = tree
      for part in det_jax_path(name + ".x")[0].split("/")[:-1]:
        node = node.setdefault(part, {})
  return tree


def model_state(model: torch.nn.Module) -> dict:
  """{name: tensor} of the model's parameters and buffers (the JAX tree's
  leaves, BN moving statistics included); the tensors themselves."""
  return dict(model.state_dict(keep_vars=True))


def load_det_params(model: torch.nn.Module, tree) -> torch.nn.Module:
  """Copies a JAX-layout EfficientDet / EfficientNet tree into the model
  (strict: every leaf on both sides)."""
  keys = list(model.state_dict())
  model.load_state_dict(det_jax_to_torch_state(tree, keys), strict=True)
  return model


def det_numpy_init(model: torch.nn.Module, seed: int = 0) -> dict:
  """A seeded JAX-layout tree for an EfficientDet / EfficientNet, each leaf
  drawn with its module's JAX initializer (nn/layers.py), in numpy; the
  distributions of the JAX init, other numbers."""
  from automl_tpu_torch.models.efficientdet import FNode
  from automl_tpu_torch.nn import layers as L
  rng = np.random.default_rng(seed)
  state = {}
  for key, value in model.state_dict().items():
    prefix, leaf = key.rpartition(".")[::2]
    mod = model.get_submodule(prefix)
    shape = tuple(value.shape)
    if isinstance(mod, (L.Conv2D, L.ConvTranspose2D)) and leaf == "kernel":
      arr = _to_port_layout(key, mod.kernel_init(rng, mod.jax_kernel_shape()))
    elif isinstance(mod, (L.Conv2D, L.ConvTranspose2D)) and leaf == "bias":
      arr = np.full(shape, mod.bias_init_value, np.float32)
    elif isinstance(mod, L.Dense) and leaf == "kernel":
      arr = _to_port_layout(key, mod.kernel_init(rng, (mod.in_dim,
                                                       mod.out_dim)))
    elif isinstance(mod, L.BatchNorm) and leaf == "gamma":
      arr = np.full(shape, mod.gamma_init_value, np.float32)
    elif isinstance(mod, L.GroupNorm) and leaf == "gamma":
      arr = np.ones(shape, np.float32)
    elif leaf in ("beta", "moving_mean", "bias"):
      arr = np.zeros(shape, np.float32)
    elif leaf == "moving_variance" or (isinstance(mod, FNode)
                                       and leaf == "wsm"):
      arr = np.ones(shape, np.float32)
    else:
      raise ValueError(f"no initializer for {key}")
    state[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
  return det_torch_to_jax_tree(state, model)


def det_state_from_jax(model: torch.nn.Module, step, params, trace, count,
                       ema_params=None, normalizer=None):
  """A JAX detection TrainState, as numpy trees, -> the port's TrainState
  (train/train_lib.py) for `model`, whose parameters and BN statistics are
  set in place.

  trace is the momentum of optax.masked(optax.sgd(lr, momentum)):
  opt_state.inner_state[0].trace, whose masked-out leaves (the BN moving
  statistics) hold no array; count is the schedule count
  (opt_state.inner_state[1].count). ema_params is a tree like params."""
  from automl_tpu_torch.train.optimizers import is_batch_stat
  from automl_tpu_torch.train.train_lib import TrainState
  load_det_params(model, params)
  state = model_state(model)
  trainable = [k for k in state if not is_batch_stat(k)]
  # optax's MaskedNode (the BN statistics' entry) is an empty tuple: no leaf.
  trace_state = det_jax_to_torch_state(trace, trainable)
  dev = next(iter(state.values())).device
  mu = {k: v.to(dev) for k, v in trace_state.items()}
  ema = None
  if ema_params is not None:
    ema = {k: v.to(dev) for k, v in
           det_jax_to_torch_state(ema_params, list(state)).items()}
  norm = (None if normalizer is None else
          torch.tensor(float(np.asarray(normalizer)), device=dev))
  return TrainState(int(np.asarray(step)), state,
                    ({"trace": mu}, {"count": int(np.asarray(count))}),
                    ema, norm)


def det_state_to_jax(state, model=None) -> dict:
  """The port's detection TrainState -> {step, params, trace, count,
  ema_params, normalizer} with JAX-layout numpy trees (the trace holds the
  trainable leaves only); with the model, params hold JAX's empty dicts."""
  trace_state, sched = state.opt_state
  return {"step": int(state.step),
          "params": det_torch_to_jax_tree(state.params, model),
          "trace": det_torch_to_jax_tree(trace_state["trace"]),
          "count": int(sched["count"]),
          "ema_params": (None if state.ema_params is None else
                         det_torch_to_jax_tree(state.ema_params)),
          "normalizer": (None if state.normalizer is None else
                         float(state.normalizer))}


def cls_state_from_jax(model: torch.nn.Module, step, params, nu, count,
                       trace, ema_params=None):
  """A JAX classification TrainState under optax.masked(optax.rmsprop(lr,
  momentum=...)), as numpy trees, -> the port's TrainState for `model`
  (an EfficientNet classifier), whose parameters and BN statistics are set
  in place.

  nu is opt_state.inner_state[0].nu, count opt_state.inner_state[1].count
  (the schedule's), trace opt_state.inner_state[2].trace; their
  masked-out leaves (the BN moving statistics) hold no array."""
  from automl_tpu_torch.train.optimizers import is_batch_stat
  from automl_tpu_torch.train.train_lib import TrainState
  load_det_params(model, params)
  state = model_state(model)
  trainable = [k for k in state if not is_batch_stat(k)]
  dev = next(iter(state.values())).device
  tree = lambda t, keys: {k: v.to(dev) for k, v in
                          det_jax_to_torch_state(t, keys).items()}
  ema = None if ema_params is None else tree(ema_params, list(state))
  opt_state = ({"nu": tree(nu, trainable)}, {"count": int(np.asarray(count))},
               {"trace": tree(trace, trainable)})
  return TrainState(int(np.asarray(step)), state, opt_state, ema)


def cls_state_to_jax(state, model=None) -> dict:
  """The port's classification TrainState (RMSProp) -> {step, params, nu,
  count, trace, ema_params} with JAX-layout numpy trees (nu and the trace
  hold the trainable leaves only)."""
  rms, sched, trace = state.opt_state
  return {"step": int(state.step),
          "params": det_torch_to_jax_tree(state.params, model),
          "nu": det_torch_to_jax_tree(rms["nu"]),
          "count": int(sched["count"]),
          "trace": det_torch_to_jax_tree(trace["trace"]),
          "ema_params": (None if state.ema_params is None else
                         det_torch_to_jax_tree(state.ema_params))}
