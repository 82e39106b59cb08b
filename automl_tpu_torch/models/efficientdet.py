"""EfficientDet: EfficientNet backbone + BiFPN + class/box heads.

The counterpart of automl_tpu/models/efficientdet.py, NCHW in the
channels_last memory format. Children carry the JAX names (backbone,
resample_p6, fpn_cells/cell_0/fnode<i>/resample_<i>_<offset>, class_net,
class-bn-<level>, class-predict, ...). Where JAX stacks identical parameters
on a leading axis for lax.scan (the BiFPN cells 1..N-1 under 'cells_rep',
the heads' 'conv_stack' and per-level BNs '<prefix>-bn-<level>' [R, C]),
the port keeps one module per repeat in a ModuleList (cells_rep.<i>,
conv_stack.<i>, class-bn-3.<i>); convert.py stacks and unstacks.

forward(images [B, 3, H, W], train, generator) -> (class outputs, box
outputs): per-level lists [B, A*num_classes, H_l, W_l] / [B, A*4, H_l, W_l]
in the compute dtype; flatten_predictions gives the flat anchor-ordered
[B, total_anchors, c] form. On a spatial mesh (parallel/spatial.py) each
map is this rank's band of rows, or whole where a level is too short to
split, and the outputs likewise. config.heads picks the heads, as in JAX:
["segmentation"] alone returns the bare segmentation logits [B,
seg_num_classes, H / 4, W / 4] (SegmentationHead), both heads (class, box,
seg).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as tnn
from torch.utils import checkpoint as torch_checkpoint

from automl_tpu_torch.config import Config
from automl_tpu_torch.models import fpn_configs
from automl_tpu_torch.models.efficientnet import EfficientNet
from automl_tpu_torch.nn import layers as L
from automl_tpu_torch.nn.precision import get_policy


def head_conv_kernel_init(rng, shape):
  """variance_scaling (fan_in, truncated normal) for separable head convs."""
  fan_in = shape[0] * shape[1] * shape[2]
  stddev = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  return (stddev * L.truncated_normal(rng, shape)).astype(np.float32)


def head_dense_kernel_init(rng, shape):
  return (0.01 * rng.standard_normal(shape)).astype(np.float32)


def global_hw(vm, x) -> tuple:
  """(h, w) of the whole map of which x is this rank's part (x's own off a
  spatial mesh vm: parallel/spatial.py)."""
  h = vm.global_h(x) if vm is not None else x.shape[2]
  return h, x.shape[3]


class ResampleFeatureMap(tnn.Module):
  """1x1-conv channel match (+BN) and max-pool down / nearest up-sampling."""

  vm = None    # parallel/spatial.py attach

  def __init__(self, in_channels: int, target_num_channels: int,
               apply_bn: bool = False, conv_after_downsample: bool = False,
               pooling_type: str = "max", device=None):
    super().__init__()
    self.conv_after_downsample = conv_after_downsample
    self.pooling_type = pooling_type
    self.needs_1x1 = in_channels != target_num_channels
    self.conv2d = self.bn = None
    if self.needs_1x1:
      self.conv2d = L.Conv2D(in_channels, target_num_channels, 1, 1,
                             use_bias=True, device=device)
      if apply_bn:
        self.bn = L.BatchNorm(target_num_channels, device=device)

  def _maybe_1x1(self, x, train):
    if self.needs_1x1:
      x = self.conv2d(x)
      if self.bn is not None:
        x = self.bn(x, train)
    return x

  def forward(self, x, target_hw, train=False):
    h, w = global_hw(self.vm, x)
    th, tw = target_hw
    if h > th and w > tw:
      if not self.conv_after_downsample:
        x = self._maybe_1x1(x, train)
      stride_h = (h - 1) // th + 1
      pool = L.max_pool if self.pooling_type == "max" else L.avg_pool
      x = pool(x, stride_h + 1, stride_h, vm=self.vm)
      if self.conv_after_downsample:
        x = self._maybe_1x1(x, train)
    elif h <= th and w <= tw:
      x = self._maybe_1x1(x, train)
      if h < th or w < tw:
        x = L.resize_nearest(x, (th, tw), vm=self.vm)
    else:
      raise ValueError(f"Incompatible resample {h}x{w} -> {th}x{tw}")
    return x


class OpAfterCombine(tnn.Module):
  """(act ->) sep-conv -> BN (-> act) after feature fusion."""

  def __init__(self, fpn_num_filters: int, conv_bn_act_pattern: bool,
               separable_conv: bool, act_type: str, device=None):
    super().__init__()
    self.conv_bn_act_pattern = conv_bn_act_pattern
    self.act = L.activation_fn(act_type)
    use_bias = not conv_bn_act_pattern
    if separable_conv:
      self.conv = L.SeparableConv2D(fpn_num_filters, fpn_num_filters, 3, 1,
                                    use_bias=use_bias, device=device)
    else:
      self.conv = L.Conv2D(fpn_num_filters, fpn_num_filters, 3, 1,
                           use_bias=use_bias, device=device)
    self.bn = L.BatchNorm(fpn_num_filters, device=device)

  def forward(self, x, train=False):
    if not self.conv_bn_act_pattern:
      x = self.act(x)
    x = self.bn(self.conv(x), train)
    if self.conv_bn_act_pattern:
      x = self.act(x)
    return x


class FNode(tnn.Module):
  """One BiFPN fusion node: resample the inputs, weighted-fuse, conv-bn."""

  vm = None    # parallel/spatial.py attach

  def __init__(self, feat_level: int, inputs_offsets: list[int],
               input_channels: list[int], config: Config,
               weight_method: str, device=None):
    super().__init__()
    self.feat_level = feat_level
    self.inputs_offsets = list(inputs_offsets)
    self.weight_method = weight_method
    self.resample_layers = []
    for i, offset in enumerate(self.inputs_offsets):
      layer = ResampleFeatureMap(
          input_channels[offset], config.fpn_num_filters,
          apply_bn=config.apply_bn_for_resampling,
          conv_after_downsample=config.conv_after_downsample, device=device)
      self.add_module(f"resample_{i}_{offset}", layer)
      self.resample_layers.append(layer)
    self.op_after_combine = OpAfterCombine(
        config.fpn_num_filters, config.conv_bn_act_pattern,
        config.separable_conv, config.act_type, device=device)
    n = len(self.inputs_offsets)
    self.wsm = None
    if weight_method in ("attn", "fastattn"):
      self.wsm = tnn.Parameter(torch.ones((n,), device=device))
    elif weight_method in ("channel_attn", "channel_fastattn"):
      self.wsm = tnn.Parameter(torch.ones((n, config.fpn_num_filters),
                                          device=device))

  def _fuse(self, nodes):
    """sum_i w_i * node_i, the weights in the nodes' dtype. On a spatial
    mesh, whole maps meeting bands are cut to this rank's rows first."""
    vm = self.vm
    if vm is not None and any(vm.is_band(n) for n in nodes):
      nodes = [vm.to_band(n) for n in nodes]
    dtype = nodes[0].dtype
    method = self.weight_method
    if method == "sum":
      w = [None] * len(nodes)
    elif method == "attn":
      w = torch.softmax(self.wsm.to(dtype), 0)
    elif method == "fastattn":
      w = torch.relu(self.wsm.to(dtype))
      w = w / (w.sum() + 1e-4)
    elif method == "channel_attn":
      w = torch.softmax(self.wsm.to(dtype), 0)[:, None, :, None, None]
    elif method == "channel_fastattn":
      w = torch.relu(self.wsm.to(dtype))
      w = (w / (w.sum(0) + 1e-4))[:, None, :, None, None]
    else:
      raise ValueError(f"Unknown weight method {method!r}")
    out = None
    for node, wi in zip(nodes, w):
      term = node if wi is None else node * wi
      out = term if out is None else out + term
    return out

  def forward(self, feats, feat_hw, train=False):
    """feats: list of node tensors; feat_hw: {level: (h, w)}. Appends the
    new node."""
    nodes = [layer(feats[offset], feat_hw[self.feat_level], train)
             for layer, offset in zip(self.resample_layers,
                                      self.inputs_offsets)]
    return feats + [self.op_after_combine(self._fuse(nodes), train)]


class FPNCell(tnn.Module):
  """One BiFPN cell: the whole node DAG once."""

  def __init__(self, input_channels: list[int], config: Config, device=None):
    super().__init__()
    self.config = config
    self.fpn_config = config.fpn_config or fpn_configs.get_fpn_config(
        config.fpn_name, config.min_level, config.max_level,
        config.fpn_weight_method)
    channels = list(input_channels)
    self.fnodes = []
    for i, node in enumerate(self.fpn_config.nodes):
      fnode = FNode(
          node["feat_level"], node["inputs_offsets"], channels, config,
          weight_method=node.get("weight_method",
                                 self.fpn_config.weight_method),
          device=device)
      self.add_module(f"fnode{i}", fnode)
      self.fnodes.append(fnode)
      channels.append(config.fpn_num_filters)

  def forward(self, feats, feat_hw, train=False):
    for fnode in self.fnodes:
      feats = fnode(feats, feat_hw, train)
    # Per level, the last node produced at that level.
    out = []
    for level in range(self.config.min_level, self.config.max_level + 1):
      for i, node in enumerate(reversed(self.fpn_config.nodes)):
        if node["feat_level"] == level:
          out.append(feats[-1 - i])
          break
    return out


class FPNCells(tnn.Module):
  """BiFPN cell stack: cell_0 takes the backbone's channels, cells_rep
  holds the fpn_cell_repeats - 1 identical cells after it."""

  def __init__(self, input_channels: list[int], config: Config, device=None):
    super().__init__()
    num_levels = config.max_level - config.min_level + 1
    uniform = [config.fpn_num_filters] * num_levels
    self.cell_0 = FPNCell(input_channels, config, device)
    self.cells_rep = tnn.ModuleList(
        FPNCell(uniform, config, device)
        for _ in range(config.fpn_cell_repeats - 1))

  def forward(self, feats, feat_hw, train=False):
    feats = self.cell_0(feats, feat_hw, train)
    for cell in self.cells_rep:
      feats = cell(feats, feat_hw, train)
    return feats


class _PredictionNet(tnn.Module):
  """A conv tower shared across levels, with per-level BNs, then the
  prediction conv. Repeat i of level l: conv_stack[i] -> <prefix>-bn-<l>[i]
  -> act (+ drop_connect residual for i > 0 when survival_prob is set)."""

  def __init__(self, num_outputs: int, num_filters: int, repeats: int,
               num_levels: int, config: Config, predict_bias_init: float,
               conv_prefix: str, predict_name: str, device=None):
    super().__init__()
    self.repeats = repeats
    self.num_levels = num_levels
    self.act = L.activation_fn(config.act_type)
    self.survival_prob = config.survival_prob
    self.grad_checkpoint = config.get("grad_checkpoint", False)
    sep = config.separable_conv

    def make_conv(in_ch, out_ch, bias_init):
      if sep:
        conv = L.SeparableConv2D(in_ch, out_ch, 3, 1, use_bias=True,
                                 bias_init_value=bias_init, device=device)
        conv.depthwise.kernel_init = head_conv_kernel_init
        conv.pointwise.kernel_init = head_conv_kernel_init
      else:
        conv = L.Conv2D(in_ch, out_ch, 3, 1, use_bias=True,
                        kernel_init=head_dense_kernel_init,
                        bias_init_value=bias_init, device=device)
      return conv

    self.conv_stack = tnn.ModuleList(
        make_conv(num_filters, num_filters, 0.0) for _ in range(repeats))
    self.bns = []
    for lvl in range(num_levels):
      bns = tnn.ModuleList(L.BatchNorm(num_filters, device=device)
                           for _ in range(repeats))
      self.add_module(f"{conv_prefix}-bn-{config.min_level + lvl}", bns)
      self.bns.append(bns)
    self.predict_name = predict_name
    self.add_module(predict_name,
                    make_conv(num_filters, num_outputs, predict_bias_init))

  @property
  def predict(self):
    return self._modules[self.predict_name]

  def _block(self, x, i, bn, train, generator):
    orig = x
    x = self.act(bn(self.conv_stack[i](x), train))
    if self.survival_prob:
      # drop_connect and the residual apply together, only for i > 0
      # (automl_tpu/models/efficientdet.py:355-364).
      dropped = x
      if train and generator is not None:   # JAX: nn.has_rng()
        dropped = L.drop_connect(x, train, self.survival_prob, generator)
      if i > 0:
        x = dropped + orig
    return x

  def forward(self, feats, train=False, generator=None):
    outputs = []
    for level_id in range(self.num_levels):
      x = feats[level_id]
      for i in range(self.repeats):
        bn = self.bns[level_id][i]
        if self.grad_checkpoint and torch.is_grad_enabled():
          x = torch_checkpoint.checkpoint(self._block, x, i, bn, train,
                                          generator, use_reentrant=False)
        else:
          x = self._block(x, i, bn, train, generator)
      outputs.append(self.predict(x))
    return outputs


class ClassNet(_PredictionNet):

  def __init__(self, config: Config, num_anchors: int, device=None):
    super().__init__(
        num_outputs=config.num_classes * num_anchors,
        num_filters=config.fpn_num_filters,
        repeats=config.box_class_repeats,
        num_levels=config.max_level - config.min_level + 1,
        config=config, predict_bias_init=-math.log((1 - 0.01) / 0.01),
        conv_prefix="class", predict_name="class-predict", device=device)


class BoxNet(_PredictionNet):

  def __init__(self, config: Config, num_anchors: int, device=None):
    super().__init__(
        num_outputs=4 * num_anchors,
        num_filters=config.fpn_num_filters,
        repeats=config.box_class_repeats,
        num_levels=config.max_level - config.min_level + 1,
        config=config, predict_bias_init=0.0,
        conv_prefix="box", predict_name="box-predict", device=device)


class SegmentationHead(tnn.Module):
  """U-Net-style decoder over the BiFPN features: from the coarsest level,
  num_up = max_level - min_level times a stride-2 transposed conv
  (con2d_t_<i>, no bias), BN (bn_<i>), the activation, a crop to the next
  finer level's size and a concat [x, skip] on the channels; then
  head_transpose (stride 2, bias) to seg_num_classes, at stride
  2^(min_level - 1) of the image."""

  def __init__(self, config: Config, device=None):
    super().__init__()
    num_filters = config.fpn_num_filters
    self.act = L.activation_fn(config.act_type)
    self.num_up = config.max_level - config.min_level
    self.convs, self.bns = [], []
    in_ch = num_filters
    for level in range(self.num_up):
      conv = L.ConvTranspose2D(in_ch, num_filters, 3, 2, use_bias=False,
                               device=device)
      bn = L.BatchNorm(num_filters, device=device)
      self.add_module(f"con2d_t_{level}", conv)
      self.add_module(f"bn_{level}", bn)
      self.convs.append(conv)
      self.bns.append(bn)
      in_ch = num_filters * 2  # after the skip concat
    self.head_transpose = L.ConvTranspose2D(in_ch, config.seg_num_classes, 3,
                                            2, device=device)

  def forward(self, feats, train=False):
    x = feats[-1]
    for conv, bn, skip in zip(self.convs, self.bns, reversed(feats[:-1])):
      x = self.act(bn(conv(x), train))
      # tiny inputs can saturate pyramid sizes at 1: crop to the skip's
      x = x[:, :, :skip.shape[2], :skip.shape[3]]
      x = torch.cat([x, skip], dim=1)
    return self.head_transpose(x)


class EfficientDet(tnn.Module):
  """Backbone -> resample P6..Pmax -> BiFPN cells -> class/box heads and
  / or the segmentation head."""

  vm = None    # parallel/spatial.py attach (the runners', train_lib's)

  def __init__(self, config: Config, device=None):
    super().__init__()
    self.config = config
    heads = config.get("heads") or ["object_detection"]
    from automl_tpu_torch.configs import effnet_configs
    bcfg = effnet_configs.get_model_config(config.backbone_name).model
    bcfg.override(dict(
        act_fn=config.act_type,
        survival_prob=config.survival_prob or 0.8,
        num_classes=None,            # features only
        no_head=True,                # stem + blocks only
        round_down_protect=True,     # efficientdet-family backbone rounding
    ), allow_new_keys=True)
    if config.backbone_config:
      bcfg.override(config.backbone_config, allow_new_keys=True)
    self.backbone = EfficientNet(bcfg, device)

    reduction_channels = self.backbone.reduction_channels()
    min_l, max_l = config.min_level, config.max_level
    input_channels = [reduction_channels[l] for l in range(min_l, 6)]
    self.resample_layers = []
    in_ch = reduction_channels[5]
    for level in range(6, max_l + 1):
      layer = ResampleFeatureMap(
          in_ch, config.fpn_num_filters,
          apply_bn=config.apply_bn_for_resampling,
          conv_after_downsample=config.conv_after_downsample, device=device)
      self.add_module(f"resample_p{level}", layer)
      self.resample_layers.append(layer)
      input_channels.append(config.fpn_num_filters)
      in_ch = config.fpn_num_filters

    self.fpn_cells = FPNCells(input_channels, config, device)
    num_anchors = len(config.aspect_ratios) * config.num_scales
    self.class_net = self.box_net = self.segmentation_head = None
    if "object_detection" in heads:
      self.class_net = ClassNet(config, num_anchors, device)
      self.box_net = BoxNet(config, num_anchors, device)
    if "segmentation" in heads:
      self.segmentation_head = SegmentationHead(config, device)

  def forward(self, images, train: bool = False, generator=None):
    config = self.config
    images = get_policy().cast_to_compute(images).contiguous(
        memory_format=torch.channels_last)
    endpoints = self.backbone(images, train, features_only=True,
                              generator=generator)
    feats = [endpoints[f"reduction_{l}"] for l in range(config.min_level, 6)]
    for layer in self.resample_layers:
      h, w = global_hw(self.vm, feats[-1])
      feats.append(layer(feats[-1], ((h + 1) // 2, (w + 1) // 2), train))
    feat_hw = {level: global_hw(self.vm, f) for level, f in
               zip(range(config.min_level, config.max_level + 1), feats)}
    feats = self.fpn_cells(feats, feat_hw, train)
    # Outputs stay in the compute dtype; the loss upcasts.
    outputs = []
    if self.class_net is not None:
      outputs.append(self.class_net(feats, train, generator))
      outputs.append(self.box_net(feats, train, generator))
    if self.segmentation_head is not None:
      outputs.append(self.segmentation_head(feats, train))
    return tuple(outputs) if len(outputs) != 1 else outputs[0]


def filter_grad_calls_per_step(model: EfficientDet) -> int:
  """How many depthwise filter gradients a training step of `model` takes
  through K6 with the knob on: every stride-1, square, SAME depthwise conv
  once per forward call, the class and box heads' convs (shared across
  levels) once per level. The segmentation head has no depthwise conv."""
  levels = model.config.max_level - model.config.min_level + 1
  heads = {id(m) for net in (model.class_net, model.box_net)
           if net is not None for m in net.modules()}
  return sum(levels if id(m) in heads else 1 for m in model.modules()
             if isinstance(m, L.DepthwiseConv2D) and m.strides == (1, 1)
             and m.kernel_size[0] == m.kernel_size[1]
             and m.padding == "SAME")


def flatten_predictions(level_outputs, channels_per_anchor: int):
  """Per-level [B, A*c, H, W] -> flat [B, total_anchors, c] in anchor order
  (per level, positions row-major, anchors fastest: NHWC's order)."""
  batch = level_outputs[0].shape[0]
  flat = [x.permute(0, 2, 3, 1).reshape(batch, -1, channels_per_anchor)
          for x in level_outputs]
  return torch.cat(flat, dim=1)


def build_detection_model(model_name_or_config, device=None,
                          **overrides) -> EfficientDet:
  from automl_tpu_torch.configs import efficientdet_configs
  if isinstance(model_name_or_config, str):
    cfg = efficientdet_configs.get_efficientdet_config(model_name_or_config)
  else:
    cfg = model_name_or_config
  if overrides:
    cfg.override(overrides, allow_new_keys=True)
  return EfficientDet(cfg, device)
