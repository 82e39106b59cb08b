"""The train steps: forward / backward, loss, clipping, optimizer,
BatchNorm statistics and EMA, all on the model's device.

The counterpart of automl_tpu/train/train_lib.py (TrainState,
create_train_state, make_cls_train_step, make_cls_eval_step,
make_seg_train_step, make_det_train_step, _freeze_grads).

Classification: the preprocess (crop, flip, RandAugment, mixing) on the
device, the cross-entropy (softmax with label smoothing, or sigmoid) plus
the L2 term over the leaves weight_decay_exclude does not match (on the
JAX path), a global gradient clip (gclip), the masked optimizer, the BN
moving statistics, the EMA; top-1 against the argmax of the (soft) label.

Segmentation (EfficientDet with heads=["segmentation"]): sparse
cross-entropy on the f32 log-softmax over the valid pixels (mask ids >= 0;
the mean over at least 1), plus the L2 term over the leaves
weight_decay_exclude does not match, a global gradient clip
(gradient_clip_norm), the optimizer, the BN moving statistics, the EMA;
pixel accuracy over the valid pixels.

Detection: the order of the
JAX step is kept: anchor labeling on the device, the (optionally moving)
positives normalizer, the detection loss plus L2 on the clean batch (and
the FGSM neighbour loss when adv_multiplier > 0), var_freeze_expr,
per-variable then global clipping, the masked optimizer, then the BN
moving statistics of the clean forward pass, then the EMA of everything
(statistics included) with TF's min(decay, (1 + t) / (10 + t)).

TrainState.params is the model's own {name: tensor} (parameters and BN
buffers, convert.model_state), updated in place: one copy of the weights
on the card.

On a vision mesh (the model's vm: parallel/spatial.py attach) the
state is replicated and each rank takes its rows of the batch (and, on a
spatial mesh, its band of each image): its loss is its share of the
global loss (the classification mean divided by the data ranks; the
detection sums over its anchors, over the global positives count), the
gradients and the loss terms are summed over the data axes (and 'model'
where the map is split), so the optimizer, the BN statistics and the EMA
run alike on every rank.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, NamedTuple, Optional

import torch

from automl_tpu_torch import convert
from automl_tpu_torch.models.efficientdet import flatten_predictions
from automl_tpu_torch.nn import layers as L
from automl_tpu_torch.ops import anchors as anchors_lib
from automl_tpu_torch.ops import losses as losses_lib
from automl_tpu_torch.parallel import comm
from automl_tpu_torch.train import optimizers as opt_lib


def _sum_axes(vm) -> tuple:
  """The axes a rank's loss share and gradients are summed over."""
  return vm.batch_axes + (("model",) if vm.spatial else ())


def _reduce(vm, tree: dict, axes) -> dict:
  """{k: tensor} summed over `axes` (one all-reduce of the flat values)."""
  if not axes or not tree:
    return tree
  keys = list(tree)
  flat = torch.cat([tree[k].reshape(-1).float() for k in keys])
  comm.all_reduce(flat, vm.mesh, axes)
  out, i = {}, 0
  for k in keys:
    n = tree[k].numel()
    out[k] = flat[i:i + n].view_as(tree[k]).to(tree[k].dtype)
    i += n
  return out


def _n_ranks(vm, axes) -> int:
  n = 1
  for a in axes:
    n *= vm.mesh.size(vm.mesh.mesh_dim_names.index(a))
  return n


class TrainState(NamedTuple):
  step: int
  params: Any                       # {name: tensor} of the model, in place
  opt_state: Any
  ema_params: Optional[dict] = None
  # Moving average of the focal-loss positives normalizer; active when
  # config.positives_momentum > 0.
  normalizer: Optional[torch.Tensor] = None


def create_train_state(model, tx, ema: bool = True,
                       moving_normalizer: bool = False) -> TrainState:
  params = convert.model_state(model)
  dev = next(iter(params.values())).device
  return TrainState(
      step=0, params=params, opt_state=tx.init(params),
      ema_params=opt_lib.ema_init(params) if ema else None,
      normalizer=(torch.ones((), device=dev) if moving_normalizer else None))


def freeze_grads(grads: dict, pattern) -> dict:
  """Zero the grads whose JAX path matches var_freeze_expr."""
  return {k: torch.zeros_like(g) if pattern.match(convert.det_jax_path(k)[0])
          else g for k, g in grads.items()}


def l2_mask_fn(exclude_regex):
  """weight_decay_exclude -> mask_fn(names) for losses.l2_leaves: False
  where the regex matches the leaf's JAX path (a '/'-joined path of the
  JAX tree, from the port's name)."""
  if not exclude_regex:
    return None
  pat = re.compile(exclude_regex)
  return lambda names: not pat.match(convert.det_jax_path(".".join(names))[0])


@torch.no_grad()
def add_l2(trainable: dict, grads: dict, weight_decay: float, mask_fn=None):
  """The L2 term over losses.l2_leaves(trainable, mask_fn) (tf.nn.l2_loss
  semantics); its gradient, weight_decay * v a leaf, is added to `grads`
  in place."""
  decayed = losses_lib.l2_leaves(trainable, mask_fn)
  if weight_decay and decayed:
    torch._foreach_add_([grads[k] for k in decayed], list(decayed.values()),
                        alpha=weight_decay)
  return losses_lib.l2_regularization(decayed, weight_decay)


@contextlib.contextmanager
def params_in(model, params: dict):
  """The model's parameters and buffers hold `params` ({name: tensor}, the
  keys of convert.model_state) inside the block and their own values
  after it; a no-op when `params` are the model's own tensors."""
  own = convert.model_state(model)
  if all(params[k] is v for k, v in own.items()):
    yield
    return
  saved = {k: v.detach().clone() for k, v in own.items()}
  with torch.no_grad():
    for k, v in own.items():
      v.copy_(params[k])
  try:
    yield
  finally:
    with torch.no_grad():
      for k, v in own.items():
        v.copy_(saved[k])


# ---------------------------------------------------------------------------
# Classification.
# ---------------------------------------------------------------------------


def make_cls_train_step(model, tx, config, preprocess_fn=None):
  """-> train_step(state, batch, generator) -> (state, metrics).

  batch: {'image' [B, 3, H, W] float, 'label' [B, num_classes] (one-hot,
  soft or multi-hot)} on the model's device, or raw loader batches that
  preprocess_fn(batch, generator) turns into that (the crop, flip,
  RandAugment and mixing on the device). generator draws the
  preprocessing's randomness, then the dropout and drop_connect masks.
  metrics hold 0-d tensors (no host sync): loss, xent, l2, gnorm, top1."""
  train_cfg = config.train
  label_smoothing = train_cfg.label_smoothing
  loss_type = train_cfg.get("loss_type")
  weight_decay = train_cfg.weight_decay
  l2_mask = l2_mask_fn(train_cfg.get("weight_decay_exclude"))
  ema_decay = train_cfg.get("ema_decay", 0.0)
  gclip = train_cfg.get("gclip", 0.0)

  def train_step(state: TrainState, batch, generator=None):
    if preprocess_fn is not None:
      batch = preprocess_fn(batch, generator)
    params = state.params
    trainable = {k: p for k, p in params.items()
                 if not opt_lib.is_batch_stat(k)}
    for p in trainable.values():
      p.grad = None
    vm = getattr(model, "vm", None)
    logits = model(batch["image"], train=True, generator=generator)
    bn_updates = L.take_bn_updates(model)
    xent = losses_lib.cross_entropy(logits, batch["label"], label_smoothing,
                                    loss_type)
    if vm is not None:     # this rank's share of the global mean
      xent = xent / _n_ranks(vm, vm.batch_axes)
    xent.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in trainable.items()}
    for p in trainable.values():
      p.grad = None
    with torch.no_grad():
      label = batch["label"]
      top1 = (logits.argmax(-1) == label.argmax(-1)).float().mean()
      if vm is not None:
        grads = _reduce(vm, grads, vm.batch_axes)
        red = _reduce(vm, {"xent": xent.detach(), "top1": top1},
                      vm.batch_axes)
        xent, top1 = red["xent"], red["top1"] / _n_ranks(vm, vm.batch_axes)
      l2 = add_l2(trainable, grads, weight_decay, l2_mask).to(xent.device)
      grads = opt_lib.clip_gradients(grads, gclip, per_var=False)
      updates, opt_state = tx.update(grads, state.opt_state, params)
      torch._foreach_add_([params[k] for k in grads],
                          [updates[k] for k in grads])
      L.apply_bn_updates(bn_updates)
      ema_params = state.ema_params
      if ema_params is not None and ema_decay:
        ema_params = opt_lib.ema_update(ema_params, params, ema_decay,
                                        state.step)
      metrics = {
          "loss": xent.detach() + l2, "xent": xent.detach(), "l2": l2,
          "gnorm": opt_lib.global_norm(grads), "top1": top1}
    return TrainState(state.step + 1, params, opt_state, ema_params,
                      state.normalizer), metrics

  return train_step


def make_cls_eval_step(model):
  """-> eval_step(params, batch{'image' preprocessed, 'label' one-hot}) ->
  {top1_sum, top5_sum, count}: 0-d tensors of the batch, with `params`
  ({name: tensor}) in the model for the call."""

  def eval_step(params, batch):
    with params_in(model, params), torch.no_grad():
      logits = model(batch["image"], train=False)
    labels = batch["label"].argmax(-1)
    top1 = (logits.argmax(-1) == labels).float()
    top5 = (logits.topk(min(5, logits.shape[-1]), -1).indices
            == labels[:, None]).any(-1).float()
    return {"top1_sum": top1.sum(), "top5_sum": top5.sum(),
            "count": torch.tensor(float(top1.shape[0]))}

  return eval_step


# ---------------------------------------------------------------------------
# Segmentation.
# ---------------------------------------------------------------------------


def make_seg_loss_and_grads(model, config):
  """-> loss_and_grads(params, batch, generator) -> (loss, aux, grads,
  bn_updates) of the segmentation step on a device batch: the loss with
  L2, aux {xent, l2, pixel_acc} (0-d tensors), grads {name: tensor} of the
  trainable leaves (L2's included), and the forward pass's BN updates."""
  weight_decay = config.get("weight_decay", 0.0) or 0.0
  l2_mask = l2_mask_fn(config.get("weight_decay_exclude"))

  def loss_and_grads(params, batch, generator=None):
    trainable = {k: p for k, p in params.items()
                 if not opt_lib.is_batch_stat(k)}
    for p in trainable.values():
      p.grad = None
    outputs = model(batch["image"], train=True, generator=generator)
    bn_updates = L.take_bn_updates(model)
    seg_logits = (outputs[-1] if isinstance(outputs, (tuple, list))
                  else outputs)
    mask = batch["mask"].long()
    logp = torch.log_softmax(seg_logits.float(), dim=1)
    valid = (mask >= 0).float()
    n_valid = valid.sum().clamp_min(1.0)
    nll = -logp.gather(1, mask.clamp_min(0)[:, None])[:, 0]
    xent = (nll * valid).sum() / n_valid
    xent.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in trainable.items()}
    for p in trainable.values():
      p.grad = None
    with torch.no_grad():
      l2 = add_l2(trainable, grads, weight_decay, l2_mask).to(xent.device)
      correct = (seg_logits.argmax(1) == mask).float() * valid
      aux = {"xent": xent.detach(), "l2": l2,
             "pixel_acc": correct.sum() / n_valid}
    return xent.detach() + l2, aux, grads, bn_updates

  return loss_and_grads


def make_seg_train_step(model, tx, config):
  """-> train_step(state, batch, generator) -> (state, metrics).

  batch: {'image' [B, 3, H, W] float, 'mask' [B, Hm, Wm] integer class
  ids at the head's output resolution (ids < 0 are void pixels)} on the
  model's device; the model's last output (the bare logits when the
  segmentation head is the only head) is the segmentation. generator
  draws the drop_connect masks. metrics hold 0-d tensors (no host sync):
  loss, xent, l2, gnorm, pixel_acc."""
  loss_and_grads = make_seg_loss_and_grads(model, config)
  gclip = config.get("gradient_clip_norm", 0.0) or 0.0
  ema_decay = config.get("moving_average_decay", 0.0) or 0.0

  def train_step(state: TrainState, batch, generator=None):
    params = state.params
    loss, aux, grads, bn_updates = loss_and_grads(params, batch, generator)
    with torch.no_grad():
      grads = opt_lib.clip_gradients(grads, gclip, per_var=False)
      updates, opt_state = tx.update(grads, state.opt_state, params)
      torch._foreach_add_([params[k] for k in grads],
                          [updates[k] for k in grads])
      L.apply_bn_updates(bn_updates)
      ema_params = state.ema_params
      if ema_params is not None and ema_decay:
        ema_params = opt_lib.ema_update(ema_params, params, ema_decay,
                                        state.step)
      metrics = dict(aux, loss=loss, gnorm=opt_lib.global_norm(grads))
    return TrainState(state.step + 1, params, opt_state, ema_params,
                      state.normalizer), metrics

  return train_step


# ---------------------------------------------------------------------------
# Detection.
# ---------------------------------------------------------------------------


def make_det_loss_and_grads(model, config):
  """-> loss_and_grads(params, batch, normalizer, generator) -> (loss,
  aux, grads, bn_updates) of the detection step on a preprocessed device
  batch: the loss with L2, aux {det_loss, cls_loss, box_loss, box_iou_loss,
  l2, num_positives [B], normalizer (the moving one when
  positives_momentum > 0)}, grads {name: tensor} of the trainable leaves
  (the BN statistics have none: their JAX grads are zeros), and the clean
  pass's BN updates (nn/layers.py take_bn_updates). `normalizer` is the
  state's moving normalizer (None when off)."""
  device = next(model.parameters()).device
  anchors = anchors_lib.Anchors(
      config.min_level, config.max_level, config.num_scales,
      config.aspect_ratios, config.anchor_scale, config.image_size,
      device=device)
  labeler = anchors_lib.AnchorLabeler(anchors)
  num_classes = config.num_classes
  weight_decay = config.weight_decay
  pos_momentum = config.get("positives_momentum", 0.0) or 0.0
  adv_mult = config.get("adv_multiplier", 0.0) or 0.0
  adv_step = config.get("adv_step_size", 0.01)

  def loss_and_grads(params, batch, moving_normalizer=None, generator=None):
    vm = getattr(model, "vm", None)
    with torch.no_grad():
      cls_t, box_t, num_pos = labeler.label_anchors(batch["gt_boxes"],
                                                    batch["gt_classes"])
      num_pos_sum = num_pos.sum()
      if vm is not None:      # the global batch's positives
        num_pos_sum = _reduce(vm, {"n": num_pos_sum}, vm.batch_axes)["n"]
    # Positives sum + 1, or its momentum-smoothed moving average.
    normalizer = num_pos_sum + 1.0
    if pos_momentum > 0:
      if moving_normalizer is None:
        raise ValueError("positives_momentum > 0 needs create_train_state("
                         "moving_normalizer=True)")
      normalizer = moving_normalizer = (
          pos_momentum * moving_normalizer + (1.0 - pos_momentum) * normalizer)

    def det_loss_on(images):
      if vm is not None and vm.spatial:
        images = vm.split(images)
      cls_out, box_out = model(images, train=True, generator=generator)
      ct, bt, boxes = cls_t, box_t, anchors.boxes
      if vm is not None and vm.spatial:
        # Each level's outputs and targets cut to this rank's rows (a
        # whole level's too: its loss counts once over the ranks).
        cls_out, box_out = ([vm.to_band(o) for o in outs]
                            for outs in (cls_out, box_out))
        idx = _band_anchors(vm, cls_out, anchors, cls_t.device)
        ct, bt, boxes = cls_t[:, idx], box_t[:, idx], boxes[idx]
      return losses_lib.detection_loss(
          flatten_predictions(cls_out, num_classes),
          flatten_predictions(box_out, 4), ct, bt, num_pos, config,
          anchor_boxes=boxes, normalizer=normalizer)

    trainable = {k: p for k, p in params.items()
                 if not opt_lib.is_batch_stat(k)}
    for p in trainable.values():
      p.grad = None
    gen_state = (generator.get_state()
                 if adv_mult > 0 and generator is not None else None)
    det_loss, cls_loss, box_loss, iou_loss = det_loss_on(batch["image"])
    bn_updates = L.take_bn_updates(model)
    if adv_mult > 0:
      # FGSM neighbour loss: the image gradient on the clean pass's draws,
      # a step along its sign, and the loss there (on fresh draws); the
      # attack itself is not differentiated.
      if gen_state is not None:
        after_clean = generator.get_state()
        generator.set_state(gen_state)
      image = batch["image"].detach().requires_grad_()
      (img_grad,) = torch.autograd.grad(det_loss_on(image)[0], image)
      if gen_state is not None:
        generator.set_state(after_clean)
      adv_images = (batch["image"] + adv_step * torch.sign(img_grad)).detach()
      det_loss = det_loss + adv_mult * det_loss_on(adv_images)[0]
      L.take_bn_updates(model)   # only the clean pass's statistics count
    det_loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in trainable.items()}
    for p in trainable.values():
      p.grad = None
    with torch.no_grad():
      if vm is not None:
        axes = _sum_axes(vm)
        grads = _reduce(vm, grads, axes)
        terms = _reduce(vm, {"det": det_loss.detach(),
                             "cls": cls_loss.detach(),
                             "box": box_loss.detach(),
                             "iou": iou_loss.detach()}, axes)
        det_loss, cls_loss, box_loss, iou_loss = (
            terms[k] for k in ("det", "cls", "box", "iou"))
      l2 = add_l2(trainable, grads, weight_decay)
    loss = det_loss + l2
    aux = {"det_loss": det_loss.detach(), "cls_loss": cls_loss.detach(),
           "box_loss": box_loss.detach(), "box_iou_loss": iou_loss.detach(),
           "l2": l2.detach(), "num_positives": num_pos,
           "normalizer": moving_normalizer}
    return loss.detach(), aux, grads, bn_updates

  return loss_and_grads


def _band_anchors(vm, level_outputs, anchors, device):
  """The flat anchor indices of this rank's rows of each level's outputs
  (whole levels cut as VisionMesh.to_band cuts them)."""
  parts, start = [], 0
  for lvl in range(anchors.min_level, anchors.min_level + len(level_outputs)):
    h, w = (anchors.feat_sizes[lvl][k] for k in ("height", "width"))
    per_row = w * anchors.get_anchors_per_location()
    lo, hi = vm.rows(h)
    parts.append(torch.arange(start + lo * per_row, start + hi * per_row,
                              device=device))
    start += h * per_row
  return torch.cat(parts)


def make_det_train_step(model, tx, config, preprocess_fn=None):
  """-> train_step(state, batch, generator) -> (state, metrics).

  batch: {'image' [B, 3, H, W] float, 'gt_boxes' [B, G, 4], 'gt_classes'
  [B, G]} on the model's device (or raw loader batches that
  preprocess_fn(batch, generator) turns into that). generator (a
  torch.Generator) draws drop_connect masks and preprocess_fn's
  randomness. metrics hold 0-d tensors (no host sync): loss, det_loss,
  cls_loss, box_loss, box_iou_loss, l2, gnorm, num_positives."""
  loss_and_grads = make_det_loss_and_grads(model, config)
  clip_norm = config.get("clip_gradients_norm", 0.0)
  ema_decay = config.get("moving_average_decay", 0.0)
  freeze_pat = (re.compile(config.var_freeze_expr)
                if config.get("var_freeze_expr") else None)

  def train_step(state: TrainState, batch, generator=None):
    if preprocess_fn is not None:
      batch = preprocess_fn(batch, generator)
    params = state.params
    loss, aux, grads, bn_updates = loss_and_grads(params, batch,
                                                  state.normalizer, generator)
    with torch.no_grad():
      if freeze_pat is not None:
        grads = freeze_grads(grads, freeze_pat)
      grads = opt_lib.clip_gradients(grads, clip_norm)
      updates, opt_state = tx.update(grads, state.opt_state, params)
      torch._foreach_add_([params[k] for k in grads],
                          [updates[k] for k in grads])
      L.apply_bn_updates(bn_updates)
      ema_params = state.ema_params
      if ema_params is not None and ema_decay:
        ema_params = opt_lib.ema_update(ema_params, params, ema_decay,
                                        state.step)
      npos = aux["num_positives"].float().mean()
      vm = getattr(model, "vm", None)
      if vm is not None:
        npos = comm.mean_over(npos, vm.mesh, vm.batch_axes)
      metrics = {"loss": loss, "gnorm": opt_lib.global_norm(grads),
                 "num_positives": npos}
      metrics.update({k: aux[k] for k in ("det_loss", "cls_loss", "box_loss",
                                          "box_iou_loss", "l2")})
    return TrainState(state.step + 1, params, opt_state, ema_params,
                      aux["normalizer"]), metrics

  return train_step
