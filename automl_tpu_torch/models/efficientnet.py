"""EfficientNet V1 / V2 / lite: the classifier and the detection backbone.

The counterpart of automl_tpu/models/efficientnet.py: the same block-string
codec, compound scaling and blocks (MBConv, FusedMBConv), NCHW in the
channels_last memory format (nn/layers.py). Children carry the JAX names
(stem, blocks_<i>, head; expand_conv, norm0, depthwise_conv2d, ...), so the
state_dict mirrors the JAX parameter tree.

forward(images, train, features_only, generator): a torch.Generator draws
the drop_connect masks in training.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.nn as tnn

from automl_tpu_torch.config import Config
from automl_tpu_torch.nn import layers as L
from automl_tpu_torch.nn.precision import get_policy

# ---------------------------------------------------------------------------
# Block args codec.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockArgs:
  num_repeat: int
  kernel_size: int
  strides: int
  expand_ratio: int
  input_filters: int
  output_filters: int
  se_ratio: float | None = None
  conv_type: int = 0  # 0 = MBConv, 1 = FusedMBConv
  id_skip: bool = True


def decode_block_string(s: str) -> BlockArgs:
  """Decode 'r2_k3_s2_e4_i48_o64_se0.25[_c1][_noskip]'."""
  ops = s.split("_")
  kv = {}
  noskip = False
  for op in ops:
    if op == "noskip":
      noskip = True
      continue
    m = re.match(r"([a-z]+)([\d.]+)", op)
    if not m:
      raise ValueError(f"Cannot parse block-string op {op!r} in {s!r}")
    kv[m.group(1)] = m.group(2)
  strides = kv["s"]
  # v1 writes strides as 's11'/'s22'; v2 as 's1'/'s2'.
  stride = int(strides[0])
  if len(strides) == 2 and strides[0] != strides[1]:
    raise ValueError(f"Unequal strides unsupported: {s!r}")
  return BlockArgs(
      num_repeat=int(kv["r"]),
      kernel_size=int(kv["k"]),
      strides=stride,
      expand_ratio=int(kv["e"]),
      input_filters=int(kv["i"]),
      output_filters=int(kv["o"]),
      se_ratio=float(kv["se"]) if "se" in kv else None,
      conv_type=int(kv.get("c", 0)),
      id_skip=not noskip,
  )


def round_filters(filters: int, width_coefficient: float | None,
                  depth_divisor: int = 8, min_depth: int | None = 8,
                  skip: bool = False, round_down_protect: bool = False) -> int:
  """Compound-scaled channel count, snapped to the divisor;
  round_down_protect adds the efficientdet backbone's never-below-90%
  correction."""
  if skip or not width_coefficient:
    return filters
  filters *= width_coefficient
  min_depth = min_depth or depth_divisor
  new_filters = max(min_depth,
                    int(filters + depth_divisor / 2) // depth_divisor * depth_divisor)
  if round_down_protect and new_filters < 0.9 * filters:
    new_filters += depth_divisor
  return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float | None,
                  skip: bool = False) -> int:
  if skip or not depth_coefficient:
    return repeats
  return int(math.ceil(depth_coefficient * repeats))


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------


def _norm(mcfg, ch, device):
  return L.build_norm(ch, mcfg.get("bn_type") or "bn", mcfg.bn_momentum,
                      mcfg.bn_epsilon, device=device)


def _has_skip(args: BlockArgs) -> bool:
  return (args.id_skip and args.strides == 1
          and args.input_filters == args.output_filters)


class MBConvBlock(tnn.Module):
  """Mobile inverted bottleneck: expand -> depthwise -> SE -> project."""

  def __init__(self, args: BlockArgs, mcfg: Config, device=None):
    super().__init__()
    self.args = args
    self.conv_dropout = mcfg.get("conv_dropout")
    self.act = L.activation_fn(mcfg.act_fn)
    filters = args.input_filters * args.expand_ratio
    self.expand_conv = self.norm0 = None
    if args.expand_ratio != 1:
      self.expand_conv = L.Conv2D(args.input_filters, filters, 1,
                                  device=device)
      self.norm0 = _norm(mcfg, filters, device)
    self.depthwise_conv2d = L.DepthwiseConv2D(filters, args.kernel_size,
                                              args.strides, device=device)
    self.norm1 = _norm(mcfg, filters, device)
    self.se = None
    if mcfg.get("use_se", True) and args.se_ratio and 0 < args.se_ratio <= 1:
      reduced = max(1, int(args.input_filters * args.se_ratio))
      self.se = L.SqueezeExcite(filters, reduced, mcfg.act_fn, device=device)
    self.project_conv = L.Conv2D(filters, args.output_filters, 1,
                                 device=device)
    self.norm2 = _norm(mcfg, args.output_filters, device)

  def forward(self, x, train=False, survival_prob=None, generator=None):
    inputs = x
    if self.expand_conv is not None:
      x = self.act(self.norm0(self.expand_conv(x), train))
    x = self.act(self.norm1(self.depthwise_conv2d(x), train))
    if self.conv_dropout and self.args.expand_ratio > 1:
      x = L.dropout(x, train, self.conv_dropout, generator)
    if self.se is not None:
      x = self.se(x)
    x = self.norm2(self.project_conv(x), train)
    if _has_skip(self.args):
      x = L.drop_connect(x, train, survival_prob, generator)
      x = x + inputs
    return x


class FusedMBConvBlock(tnn.Module):
  """Fused MBConv: one kxk conv expands and filters, then SE + project."""

  def __init__(self, args: BlockArgs, mcfg: Config, device=None):
    super().__init__()
    self.args = args
    self.conv_dropout = mcfg.get("conv_dropout")
    self.act = L.activation_fn(mcfg.act_fn)
    filters = args.input_filters * args.expand_ratio
    self.expand_conv = self.norm0 = None
    if args.expand_ratio != 1:
      self.expand_conv = L.Conv2D(args.input_filters, filters,
                                  args.kernel_size, args.strides,
                                  device=device)
      self.norm0 = _norm(mcfg, filters, device)
      project_kernel, project_strides = 1, 1
    else:
      project_kernel, project_strides = args.kernel_size, args.strides
    self.se = None
    if mcfg.get("use_se", True) and args.se_ratio and 0 < args.se_ratio <= 1:
      reduced = max(1, int(args.input_filters * args.se_ratio))
      self.se = L.SqueezeExcite(filters, reduced, mcfg.act_fn, device=device)
    self.project_conv = L.Conv2D(filters, args.output_filters, project_kernel,
                                 project_strides, device=device)
    self.norm1 = _norm(mcfg, args.output_filters, device)

  def forward(self, x, train=False, survival_prob=None, generator=None):
    inputs = x
    if self.expand_conv is not None:
      x = self.act(self.norm0(self.expand_conv(x), train))
    if self.conv_dropout and self.args.expand_ratio > 1:
      x = L.dropout(x, train, self.conv_dropout, generator)
    if self.se is not None:
      x = self.se(x)
    x = self.norm1(self.project_conv(x), train)
    if self.expand_conv is None:
      x = self.act(x)
    if _has_skip(self.args):
      x = L.drop_connect(x, train, survival_prob, generator)
      x = x + inputs
    return x


BLOCK_TYPES = {0: MBConvBlock, 1: FusedMBConvBlock}


class Stem(tnn.Module):

  def __init__(self, in_ch: int, stem_filters: int, mcfg: Config,
               device=None):
    super().__init__()
    self.conv2d = L.Conv2D(in_ch, stem_filters, 3, 2, device=device)
    self.norm = _norm(mcfg, stem_filters, device)
    self.act = L.activation_fn(mcfg.act_fn)

  def forward(self, x, train=False):
    return self.act(self.norm(self.conv2d(x), train))


class Head(tnn.Module):

  def __init__(self, in_ch: int, feature_size: int, num_classes: int,
               mcfg: Config, device=None):
    super().__init__()
    self.conv2d = L.Conv2D(in_ch, feature_size, 1, 1, device=device)
    self.norm = _norm(mcfg, feature_size, device)
    self.act = L.activation_fn(mcfg.act_fn)
    self.dropout_rate = mcfg.get("dropout_rate") or 0.0
    self.fc = (L.Dense(feature_size, num_classes, device=device)
               if num_classes else None)

  def forward(self, x, train=False, generator=None):
    x = self.act(self.norm(self.conv2d(x), train))
    x = x.mean((2, 3))
    x = L.dropout(x, train, self.dropout_rate, generator)
    if self.fc is not None:
      x = self.fc(x)
    return x


# ---------------------------------------------------------------------------
# Model.
# ---------------------------------------------------------------------------


def model_defaults() -> Config:
  """Model-section defaults (automl_tpu/models/efficientnet.py:292)."""
  return Config(dict(
      model_name="efficientnetv2-s",
      blocks_args=None,          # list[str] block strings
      width_coefficient=1.0,
      depth_coefficient=1.0,
      dropout_rate=0.2,
      survival_prob=0.8,
      bn_type=None,              # None/'bn' | 'tpu_bn' | 'gn'
      bn_momentum=0.9,
      bn_epsilon=1e-3,
      gn_groups=8,
      depth_divisor=8,
      min_depth=8,
      act_fn="silu",
      feature_size=1280,
      num_classes=1000,
      conv_dropout=None,
      use_se=True,               # lite models disable SE entirely
      round_down_protect=False,  # True for efficientdet-family backbones
      fix_head_stem=False,       # lite models: don't scale stem/head filters
      in_channels=3,
  ))


class EfficientNet(tnn.Module):
  """EfficientNet V1/V2/lite classifier and detection backbone.

  forward(images, train) -> logits (num_classes set);
  forward(images, train, features_only=True) -> endpoints dict with
  'stem', 'features' and 'reduction_1'..'reduction_5' (stride 2..32 maps).
  """

  vm = None    # parallel/spatial.py attach (the runners', train_lib's)

  def __init__(self, mcfg: Config, device=None):
    super().__init__()
    self.cfg = mcfg
    wc, dc = mcfg.width_coefficient, mcfg.depth_coefficient
    div, mind = mcfg.depth_divisor, mcfg.min_depth
    protect = bool(mcfg.get("round_down_protect", False))
    blocks_args = [decode_block_string(s) if isinstance(s, str) else s
                   for s in mcfg.blocks_args]

    stem_filters = round_filters(blocks_args[0].input_filters, wc, div, mind,
                                 skip=mcfg.fix_head_stem,
                                 round_down_protect=protect)
    self.stem = Stem(mcfg.in_channels, stem_filters, mcfg, device)

    self.blocks: list[tnn.Module] = []
    for i, args in enumerate(blocks_args):
      # Block 0 takes the stem's width (lite: the stem is not scaled).
      a = dataclasses.replace(
          args,
          input_filters=stem_filters if i == 0 else
          round_filters(args.input_filters, wc, div, mind,
                        round_down_protect=protect),
          output_filters=round_filters(args.output_filters, wc, div, mind,
                                       round_down_protect=protect),
          num_repeat=round_repeats(
              args.num_repeat, dc,
              skip=mcfg.fix_head_stem and i in (0, len(blocks_args) - 1)),
      )
      block_cls = BLOCK_TYPES[a.conv_type]
      reps = [a] + [dataclasses.replace(a, input_filters=a.output_filters,
                                        strides=1)] * (a.num_repeat - 1)
      for r in reps:
        block = block_cls(r, mcfg, device)
        self.add_module(f"blocks_{len(self.blocks)}", block)
        self.blocks.append(block)

    self.head = None
    if not mcfg.get("no_head"):
      head_in = self.blocks[-1].args.output_filters
      feature_size = round_filters(mcfg.feature_size or 1280, wc, div, mind,
                                   skip=mcfg.fix_head_stem,
                                   round_down_protect=protect)
      self.head = Head(head_in, feature_size, mcfg.num_classes, mcfg, device)

  def reduction_channels(self) -> dict:
    """{reduction index: channels} of the endpoints reduction_1..5."""
    out, red = {}, 0
    for idx, block in enumerate(self.blocks):
      if idx == len(self.blocks) - 1 or self.blocks[idx + 1].args.strides > 1:
        red += 1
        out[red] = block.args.output_filters
    return out

  def forward(self, x, train: bool = False, features_only: bool = False,
              generator=None):
    policy = get_policy()
    x = policy.cast_to_compute(x)
    endpoints = {}
    x = self.stem(x, train)
    endpoints["stem"] = x
    reduction_idx = 0
    base_sp = self.cfg.survival_prob
    n = len(self.blocks)
    for idx, block in enumerate(self.blocks):
      is_reduction = (idx == n - 1) or (self.blocks[idx + 1].args.strides > 1)
      survival_prob = None
      if base_sp:
        survival_prob = 1.0 - (1.0 - base_sp) * float(idx) / n
      x = block(x, train, survival_prob, generator)
      if is_reduction:
        reduction_idx += 1
        endpoints[f"reduction_{reduction_idx}"] = x
    endpoints["features"] = x
    if features_only:
      return endpoints
    if self.head is None:
      raise ValueError("Backbone built with no_head=True supports only "
                       "features_only=True")
    return policy.cast_to_output(self.head(x, train, generator))


def build_model(model_name_or_cfg, device=None, **overrides) -> EfficientNet:
  """Build from a named config ('efficientnet-b0', ...) or a model config."""
  from automl_tpu_torch.configs import effnet_configs  # the registry
  if isinstance(model_name_or_cfg, str):
    mcfg = effnet_configs.get_model_config(model_name_or_cfg).model
  else:
    mcfg = model_name_or_cfg
  if overrides:
    mcfg.override(overrides, allow_new_keys=True)
  return EfficientNet(mcfg, device)
