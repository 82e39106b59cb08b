"""Published TF checkpoints into the port's models, with no TensorFlow:
the counterpart of automl_tpu/ckpt/tf_compat.py.

The name maps are JAX's: each TF variable name maps to a path of the JAX
package's parameter tree (the JAX layout: NHWC / HWIO, scan-stacked BiFPN
cells and head repeats), and effnet_var_map / effdet_var_map here return
the same {tf_name: (path, transform or setter)} as JAX's do, walking the
port's own modules. A conversion fills a JAX-layout numpy tree (a
template from convert.det_numpy_init, or zeros of its shapes as JAX's
eval_shape gives) and loads it into the model through the M0 converter
(convert.load_det_params), so the layout mapping to PyTorch is written
once, in convert.py.

Variable names of the reference (TF1-style; '{name}/ExponentialMovingAverage'
holds an EMA shadow):

  {model}/stem/conv2d/kernel
  {model}/blocks_{i}/conv2d[_k]/kernel                (expand / project)
  {model}/blocks_{i}/depthwise_conv2d/depthwise_kernel
  {model}/blocks_{i}/tpu_batch_normalization[_k]/{gamma,beta,moving_mean,
                                                  moving_variance}
  {model}/blocks_{i}/se/conv2d/{kernel,bias}          (reduce)
  {model}/blocks_{i}/se/conv2d_1/{kernel,bias}        (expand)
  {model}/head/conv2d/kernel, head/tpu_batch_normalization/*, head/dense/*

TF depthwise kernels are [kh, kw, C, 1], the JAX layout's [kh, kw, 1, C];
everything else maps 1:1. Checkpoints are read by ckpt/tf_bundle.py.
"""

from __future__ import annotations

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.ckpt.tf_bundle import load_tf_checkpoint
from automl_tpu_torch.models.efficientnet import (FusedMBConvBlock,
                                                  MBConvBlock)

__all__ = ["effnet_var_map", "effdet_var_map", "convert_effnet_checkpoint",
           "convert_effdet_checkpoint", "load_tf_checkpoint"]


def _dw_transpose(w):
  return np.transpose(w, (0, 1, 3, 2))


def _ident(x):
  return x


def effnet_var_map(model, scope: str | None = None) -> dict[str, tuple]:
  """{tf_var_name: (JAX tree path, transform)} for the port's EfficientNet
  (a classifier, or a detection backbone without its head)."""
  scope = scope or model.cfg.model_name
  out: dict[str, tuple] = {}

  def bn(tf_prefix, path):
    for leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
      out[f"{tf_prefix}/{leaf}"] = (path + (leaf,), _ident)

  def se(p, base):
    out[f"{p}/se/conv2d/kernel"] = (base + ("se", "reduce", "kernel"), _ident)
    out[f"{p}/se/conv2d/bias"] = (base + ("se", "reduce", "bias"), _ident)
    out[f"{p}/se/conv2d_1/kernel"] = (base + ("se", "expand", "kernel"),
                                      _ident)
    out[f"{p}/se/conv2d_1/bias"] = (base + ("se", "expand", "bias"), _ident)

  out[f"{scope}/stem/conv2d/kernel"] = (("stem", "conv2d", "kernel"), _ident)
  bn(f"{scope}/stem/tpu_batch_normalization", ("stem", "norm"))

  for i, block in enumerate(model.blocks):
    name = f"blocks_{i}"
    p, base = f"{scope}/{name}", (name,)
    # TF numbers the convs and the batch norms of a block in creation order.
    convs = iter(["conv2d"] + [f"conv2d_{k}" for k in range(1, 4)])
    norms = iter(["tpu_batch_normalization"]
                 + [f"tpu_batch_normalization_{k}" for k in range(1, 4)])
    if not isinstance(block, (MBConvBlock, FusedMBConvBlock)):
      raise TypeError(type(block))
    fused = isinstance(block, FusedMBConvBlock)
    if block.expand_conv is not None:
      out[f"{p}/{next(convs)}/kernel"] = (base + ("expand_conv", "kernel"),
                                          _ident)
      bn(f"{p}/{next(norms)}", base + ("norm0",))
    if not fused:
      out[f"{p}/depthwise_conv2d/depthwise_kernel"] = (
          base + ("depthwise_conv2d", "kernel"), _dw_transpose)
      bn(f"{p}/{next(norms)}", base + ("norm1",))
    if block.se is not None:
      se(p, base)
    out[f"{p}/{next(convs)}/kernel"] = (base + ("project_conv", "kernel"),
                                        _ident)
    bn(f"{p}/{next(norms)}", base + ("norm1" if fused else "norm2",))

  if model.head is not None:
    out[f"{scope}/head/conv2d/kernel"] = (("head", "conv2d", "kernel"), _ident)
    bn(f"{scope}/head/tpu_batch_normalization", ("head", "norm"))
    if model.head.fc is not None:
      out[f"{scope}/head/dense/kernel"] = (("head", "fc", "kernel"), _ident)
      out[f"{scope}/head/dense/bias"] = (("head", "fc", "bias"), _ident)
  return out


def _assign(transform=None):
  """Setter: full-leaf overwrite (optionally transforming the TF value)."""
  def setter(cur, val):
    v = transform(val) if transform else val
    if tuple(cur.shape) != tuple(v.shape):
      raise ValueError(f"shape mismatch: ckpt {v.shape} vs model {cur.shape}")
    return v
  return setter


def _assign_row(row, transform=None):
  """Setter: write into row `row` of a [R, ...]-stacked leaf."""
  def setter(cur, val):
    v = transform(val) if transform else val
    if tuple(cur.shape[1:]) != tuple(v.shape):
      raise ValueError(
          f"shape mismatch: ckpt {v.shape} vs stacked model {cur.shape}")
    cur = np.array(cur)
    cur[row] = v
    return cur
  return setter


def _assign_wsm(j, row=None):
  """Setter: TF's per-input fusion scalar -> element j of the 'wsm' vector
  (inside row `row` of a cell stack)."""
  def setter(cur, val):
    cur = np.array(cur)
    if row is None:
      cur[j] = val
    else:
      cur[row, j] = val
    return cur
  return setter


def effdet_var_map(model) -> dict[str, tuple]:
  """{tf_var_name: (JAX tree path, setter)} for the port's EfficientDet.

  setter(current leaf, checkpoint value) -> new leaf. The JAX layout
  stacks BiFPN cells 1..N-1 under fpn_cells/cells_rep and the head's conv
  repeats under {net}/conv_stack and {net}/{prefix}-bn-{LEVEL}: a TF
  variable of cell r >= 1 or repeat i is written into that row.

    {backbone_name}/...                          (effnet map, no head)
    resample_p6/{conv2d/{kernel,bias}, bn/*}
    fpn_cells/cell_{r}/fnode{i}/WSM[_k]          (fusion weights, scalars)
    fpn_cells/cell_{r}/fnode{i}/resample_{j}_{off}_{num_levels+i}/...
    fpn_cells/cell_{r}/fnode{i}/op_after_combine{num_levels+i}/
        conv/{depthwise_kernel,pointwise_kernel,bias}, bn/*
    {class,box}_net/{class,box}-{i}/{depthwise_kernel,pointwise_kernel,bias}
    {class,box}_net/{class,box}-{i}-bn-{LEVEL}/*  (LEVEL = min..max level)
    {class,box}_net/{class,box}-predict/...
  """
  config = model.config
  out: dict[str, tuple] = {}

  def bn(tf_prefix, path, row=None):
    for leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
      out[f"{tf_prefix}/{leaf}"] = (
          path + (leaf,), _assign() if row is None else _assign_row(row))

  def mk(row, transform=None):
    return _assign(transform) if row is None else _assign_row(row, transform)

  def conv(tf_prefix, path, row=None):
    if config.separable_conv:
      out[f"{tf_prefix}/depthwise_kernel"] = (
          path + ("depthwise", "kernel"), mk(row, _dw_transpose))
      out[f"{tf_prefix}/pointwise_kernel"] = (
          path + ("pointwise", "kernel"), mk(row))
      out[f"{tf_prefix}/bias"] = (path + ("pointwise", "bias"), mk(row))
    else:
      out[f"{tf_prefix}/kernel"] = (path + ("kernel",), mk(row))
      out[f"{tf_prefix}/bias"] = (path + ("bias",), mk(row))

  def full_conv(tf_prefix, path, row=None):
    out[f"{tf_prefix}/kernel"] = (path + ("kernel",), mk(row))
    out[f"{tf_prefix}/bias"] = (path + ("bias",), mk(row))

  for tf_name, (path, tr) in effnet_var_map(
      model.backbone, scope=config.backbone_name).items():
    out[tf_name] = (("backbone",) + path, _assign(tr))

  for level, layer in enumerate(model.resample_layers, start=6):
    if layer.needs_1x1:
      name = f"resample_p{level}"
      full_conv(f"{name}/conv2d", (name, "conv2d"))
      bn(f"{name}/bn", (name, "bn"))

  num_levels = config.max_level - config.min_level + 1
  cells = model.fpn_cells
  for rep in range(config.fpn_cell_repeats):
    if rep == 0:
      cell, tree_cell, row = cells.cell_0, "cell_0", None
    else:
      cell, tree_cell, row = cells.cells_rep[rep - 1], "cells_rep", rep - 1
    for ni, fnode in enumerate(cell.fnodes):
      scope = f"fpn_cells/cell_{rep}/fnode{ni}"
      base = ("fpn_cells", tree_cell, f"fnode{ni}")
      if fnode.weight_method in ("attn", "fastattn", "channel_attn",
                                 "channel_fastattn"):
        for j in range(len(fnode.inputs_offsets)):
          wsm = "WSM" if j == 0 else f"WSM_{j}"
          out[f"{scope}/{wsm}"] = (base + ("wsm",), _assign_wsm(j, row))
      for j, (offset, rl) in enumerate(zip(fnode.inputs_offsets,
                                           fnode.resample_layers)):
        if rl.needs_1x1:
          rscope = f"{scope}/resample_{j}_{offset}_{num_levels + ni}"
          rpath = base + (f"resample_{j}_{offset}",)
          full_conv(f"{rscope}/conv2d", rpath + ("conv2d",), row=row)
          bn(f"{rscope}/bn", rpath + ("bn",), row=row)
      oscope = f"{scope}/op_after_combine{num_levels + ni}"
      opath = base + ("op_after_combine",)
      conv(f"{oscope}/conv", opath + ("conv",), row=row)
      bn(f"{oscope}/bn", opath + ("bn",), row=row)

  for net, prefix, root in ((model.class_net, "class", "class_net"),
                            (model.box_net, "box", "box_net")):
    for i in range(net.repeats):
      conv(f"{root}/{prefix}-{i}", (root, "conv_stack"), row=i)
      for lvl_id in range(net.num_levels):
        level = config.min_level + lvl_id
        bn(f"{root}/{prefix}-{i}-bn-{level}",
           (root, f"{prefix}-bn-{level}"), row=i)
    conv(f"{root}/{prefix}-predict", (root, net.predict_name))
  return out


def _zeros_template(model) -> dict:
  """Zeros in the model's JAX-layout tree (JAX's default template: its
  eval_shape, zero-filled)."""
  return convert.det_torch_to_jax_tree(
      {k: torch.zeros(v.shape, dtype=torch.float32)
       for k, v in model.state_dict().items()}, model)


def _node(tree, path):
  node = tree
  for k in path[:-1]:
    node = node[k]
  return node


def _pick(ckpt, tf_name, use_ema):
  """The checkpoint's name for tf_name: its EMA shadow when use_ema and
  the checkpoint holds one; None when neither is there."""
  ema = f"{tf_name}/ExponentialMovingAverage"
  if use_ema and ema in ckpt:
    return ema
  return tf_name if tf_name in ckpt else None


def _finish(model, params, missing, strict):
  if missing and strict:
    raise KeyError(f"{len(missing)} variables missing from checkpoint, e.g. "
                   f"{missing[:5]}")
  convert.load_det_params(model, params)
  return params


def convert_effdet_checkpoint(ckpt, model, params=None, use_ema: bool = False,
                              strict: bool = True) -> dict:
  """A TF EfficientDet checkpoint (a path, or {name: array}) -> the
  model's JAX-layout numpy tree, which is also loaded into the model.
  params: the template to fill (default: zeros); use_ema prefers
  '{name}/ExponentialMovingAverage'; strict raises KeyError when a mapped
  variable is missing, else the template keeps its value there."""
  if isinstance(ckpt, str):
    ckpt = load_tf_checkpoint(ckpt)
  if params is None:
    params = _zeros_template(model)
  missing = []
  for tf_name, (path, setter) in effdet_var_map(model).items():
    name = _pick(ckpt, tf_name, use_ema)
    if name is None:
      missing.append(tf_name)
      continue
    node, leaf = _node(params, path), path[-1]
    want = np.asarray(node[leaf])
    try:
      new = np.asarray(setter(want, np.asarray(ckpt[name])))
      if new.shape != want.shape:
        raise ValueError(f"converted {tf_name} {np.shape(ckpt[name])} -> "
                         f"{new.shape}, param leaf wants {want.shape}")
    except ValueError as e:
      raise ValueError(f"at {path}: {e}") from e
    node[leaf] = np.asarray(new, want.dtype)
  return _finish(model, params, missing, strict)


def convert_effnet_checkpoint(ckpt, model, params=None, use_ema: bool = False,
                              scope: str | None = None, strict: bool = True,
                              exclude_prefixes: tuple = ()) -> dict:
  """A TF EfficientNet checkpoint (a path, or {name: array}) -> the
  model's JAX-layout numpy tree, which is also loaded into the model.

  params: the template to fill (default: zeros). use_ema prefers
  '{name}/ExponentialMovingAverage'. scope: the checkpoint's top-level
  name (default the model's name; a detection backbone's is the config's
  backbone_name). exclude_prefixes: JAX tree path prefixes left at the
  template's values, e.g. (("head", "fc"),) to finetune with another class
  count."""
  if isinstance(ckpt, str):
    ckpt = load_tf_checkpoint(ckpt)
  if params is None:
    params = _zeros_template(model)
  missing = []
  for tf_name, (path, transform) in effnet_var_map(model, scope).items():
    if any(path[:len(pre)] == tuple(pre) for pre in exclude_prefixes):
      continue
    name = _pick(ckpt, tf_name, use_ema)
    if name is None:
      missing.append(tf_name)
      continue
    node = _node(params, path)
    want = np.asarray(node[path[-1]])
    value = transform(np.asarray(ckpt[name]))
    if tuple(want.shape) != tuple(value.shape):
      raise ValueError(f"shape mismatch at {path}: ckpt {value.shape} "
                       f"vs model {tuple(want.shape)}")
    node[path[-1]] = np.asarray(value, want.dtype)
  return _finish(model, params, missing, strict)
