"""The runners on one device: classification (with progressive resizing)
and detection, training and evaluation.

The counterpart of automl_tpu/train/runners.py.

Classification (run_classification): config.yaml in model_dir, the
precision policy from runtime.mixed_precision, seeded weights in the JAX
layout (convert.det_numpy_init), warmup_lr over steps_per_epoch =
train_steps // epochs, the config's optimizer (rmsprop by default) with the
BN statistics masked, EMA, resume from model_dir/ckpt. train.stages
progressive stages (_progressive_stage_params: the image size, RandAugment
magnitude and mixup / cutmix alphas ramp up stage by stage), each with its
own preprocess on the device (cls_train_preprocess, then mixing) and a
synthetic loader at its canvas (int(size * 1.15) // 2 * 2); a checkpoint
and (with an eval set) an eval at the end of each stage or every
eval_every steps, archive_ckpt keeping the best by top-1 (AUC-PR for
multi-label data). evaluate_classification: the eval preprocess (centre
crop, resize, the augname's normalization) and the model on the device,
top-1 / top-5 (or AUC-PR and precision@1) on the host.

Detection (run_detection): detection_lr over steps_per_epoch =
train_steps // num_epochs, momentum SGD for optimizer="sgd" with the BN
statistics masked, EMA, resume from model_dir/ckpt, the synthetic loader
(SyntheticDetection), grid_mask and preprocessing on the device
(det_train_preprocess), metrics.jsonl and a final checkpoint. Evaluation
(eval_iter): every eval_every steps, after a checkpoint, or once at the
end, on the EMA parameters when there are any; evaluate_detection runs the
model and postprocess.generate_detections on the device and the
COCOEvaluator on the host; archive_ckpt keeps the best checkpoint by AP.

Each step's randomness (preprocessing draws, dropout and drop_connect
masks) comes from a torch.Generator seeded from (seed, step), as JAX folds
the step into its key, so a resumed run draws what an uninterrupted one
would.

Not ported yet, each refused naming its ROADMAP item: the eval images
(vis_dir: inference/visualize.py, M9; the in-training eval writes none),
autoaugment_policy (M9), ft_init_ckpt (M9: ckpt/tf_compat.py), qat (M11),
init_backbone_ckpt (M9), meshes (M10).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.data import augment, datasets, pipeline, preprocessing
from automl_tpu_torch.models.efficientdet import EfficientDet
from automl_tpu_torch.models.efficientnet import EfficientNet
from automl_tpu_torch.nn import precision
from automl_tpu_torch.ops import anchors as anchors_lib
from automl_tpu_torch.ops import postprocess
from automl_tpu_torch.train import optimizers as opt_lib
from automl_tpu_torch.train import schedules, train_lib
from automl_tpu_torch.train.checkpoint import CheckpointManager, archive_ckpt
from automl_tpu_torch.train.metrics import MetricsWriter


def _refuse_unported(config, mesh_shape, init_backbone_ckpt):
  unported = [
      (mesh_shape, "a device mesh", "M10"),
      (init_backbone_ckpt, "init_backbone_ckpt", "M9"),
      (config.get("autoaugment_policy"), "autoaugment_policy",
       "M9 (det_autoaugment)"),
      (config.get("qat"), "qat", "M11"),
  ]
  for on, what, item in unported:
    if on:
      raise NotImplementedError(
          f"{what} is not ported to automl_tpu_torch yet: ROADMAP {item}")


def step_seed(seed: int, step: int) -> int:
  """The seed of step `step`'s generator."""
  return (seed + 1) * 1_000_003 + step


# ---------------------------------------------------------------------------
# Classification.
# ---------------------------------------------------------------------------


def resolve_train_size(config) -> int:
  """train.isize <= 16 is a fraction of eval.isize (then snapped down to a
  multiple of 16)."""
  esize = config.eval.isize or config.train.isize
  tsize = float(config.train.isize or esize)
  if tsize <= 16.0:
    tsize = int(float(esize) * tsize) // 16 * 16
  return int(tsize)


def _progressive_stage_params(config, stage: int, total_stages: int):
  """Stage `stage`'s (image size, RandAugment magnitude, mixup alpha,
  cutmix alpha): each ramps linearly up to the config's from data.ibase
  (the size snapped down to a multiple of 8)."""
  target = resolve_train_size(config)
  ibase = int(config.data.ibase or target)
  if total_stages <= 1:
    return (target, config.data.ram, config.data.mixup_alpha,
            config.data.cutmix_alpha)
  ratio = float(stage + 1) / total_stages
  size = int(round(ibase + (target - ibase) * ratio))
  size = (size // 8) * 8
  ram = config.data.ram * (stage + 1) / total_stages
  mix = config.data.mixup_alpha * (stage + 1) / total_stages
  cut = config.data.cutmix_alpha * (stage + 1) / total_stages
  return size, ram, mix, cut


def _refuse_unported_cls(config, mesh_shape):
  unported = [
      (mesh_shape, "a device mesh", "M10"),
      (config.train.get("ft_init_ckpt"),
       "train.ft_init_ckpt (a TF checkpoint: ckpt/tf_compat.py)", "M9"),
      (config.train.get("qat"), "train.qat", "M11"),
  ]
  for on, what, item in unported:
    if on:
      raise NotImplementedError(
          f"{what} is not ported to automl_tpu_torch yet: ROADMAP {item}")


def seeded_classification_model(mcfg, seed: int = 0, device="cuda"):
  """An EfficientNet classifier (model config `mcfg`) with weights drawn
  from `seed` in the JAX layout (convert.det_numpy_init), as
  run_classification starts from."""
  model = EfficientNet(mcfg, device=device)
  convert.load_det_params(model, convert.det_numpy_init(model, seed))
  return model


def make_cls_preprocess(config, isize: int, ram: float, mixup_a: float,
                        cutmix_a: float):
  """preprocess(batch, generator) on the device for one progressive stage:
  cls_train_preprocess at isize with RandAugment magnitude ram (its draws,
  then mixing's, from the generator), multi-hot labels from label_ids, then
  mixup / cutmix."""
  augname = config.data.augname
  num_layers = int(config.data.ra_num_layers)
  ft = preprocessing.norm_for_augname(augname)[0] == "ft"

  def preprocess(batch, generator):
    images = batch["image"]
    b, dev = images.shape[0], images.device
    draws = (preprocessing.cls_finetune_draws if ft else
             preprocessing.cls_train_draws)(b, isize, generator, num_layers,
                                            device=dev)
    images = preprocessing.cls_train_preprocess(
        images, draws, isize, augname=augname, ra_magnitude=ram)
    if "label_ids" in batch:
      labels = datasets.multihot_on_device(batch["label_ids"],
                                           config.data.num_classes)
    else:
      labels = batch["label"]
    if mixup_a or cutmix_a:
      mix = augment.mixing_draws(b, isize, isize, generator, mixup_a,
                                 cutmix_a, device=dev)
      nhwc, labels = augment.mixing(images.permute(0, 2, 3, 1), labels, mix,
                                    mixup_a, cutmix_a)
      images = nhwc.permute(0, 3, 1, 2)
    return {"image": images, "label": labels}

  return preprocess


def run_classification(config, model_dir: str, train_steps: int,
                       mesh_shape=None, data_iter=None, log_every: int = 50,
                       eval_iter=None, eval_steps: int = 0,
                       eval_every: int = 0, seed: int = 0,
                       device="cuda") -> dict:
  """Trains an EfficientNet classifier on one device; returns the last
  metrics as floats (and the last eval's as eval/<name>).

  data_iter: a host iterator of {'image' uint8 [B, H, W, 3] canvases,
  'label' [B, classes] (or 'label_ids')}; by default synthetic batches.
  eval_iter: an iterator, or a zero-argument factory of fresh iterators,
  of held-out batches; with eval_steps set, an eval at the end of every
  progressive stage (or every eval_every steps). metrics.jsonl gets every
  log_every steps the step's metrics plus lr, secs_per_step and
  examples_per_sec (host clock; each logged step waits for its loss)."""
  _refuse_unported_cls(config, mesh_shape)
  device = torch.device(device)
  os.makedirs(model_dir, exist_ok=True)
  config.save_to_yaml(os.path.join(model_dir, "config.yaml"))
  precision.set_policy("mixed_bfloat16" if config.runtime.mixed_precision
                       else "float32")
  model = seeded_classification_model(config.model, seed, device)
  batch_size = int(config.train.batch_size)
  steps_per_epoch = max(train_steps // max(config.train.epochs, 1), 1)
  lr_fn = schedules.warmup_lr(
      config.train.lr_sched, config.train.lr_base,
      steps_per_epoch=steps_per_epoch, total_steps=train_steps,
      warmup_epochs=config.train.lr_warmup_epoch,
      decay_epochs=config.train.lr_decay_epoch,
      decay_factor=config.train.lr_decay_factor,
      minimal_lr=config.train.lr_min)
  tx = opt_lib.masked_for_params(
      opt_lib.build_optimizer(config.train.optimizer, lr_fn))
  state = train_lib.create_train_state(model, tx,
                                       ema=bool(config.train.ema_decay))
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"),
                           max_to_keep=config.runtime.keep_checkpoint_max)
  restored = mngr.restore(state)
  if restored is not None:
    state = restored
  total_stages = max(int(config.train.stages or 0), 1)
  stage_steps = train_steps // total_stages
  generator = torch.Generator(device=device)
  writer = MetricsWriter(model_dir)
  objective_key = "auc_pr" if config.data.get("multiclass") else "top1"

  def run_eval(at_step):
    params = (state.ema_params if state.ema_params is not None
              else state.params)
    fresh = eval_iter() if callable(eval_iter) else eval_iter
    em = evaluate_classification(model, params, config, fresh, eval_steps)
    writer.write(at_step, {f"eval/{k}": v for k, v in em.items()})
    print(f"eval @ {at_step}: " +
          " ".join(f"{k} {v:.4f}" for k, v in em.items()))
    if em.get(objective_key, -1) >= 0:
      archive_ckpt(model_dir, at_step, em[objective_key], mngr)
    return em

  metrics, out_eval = {}, {}
  step = state.step
  prev_t = time.perf_counter()
  for stage in range(total_stages):
    isize, ram, mixup_a, cutmix_a = _progressive_stage_params(
        config, stage, total_stages)
    step_fn = train_lib.make_cls_train_step(
        model, tx, config,
        preprocess_fn=make_cls_preprocess(config, isize, ram, mixup_a,
                                          cutmix_a))
    canvas = int(isize * 1.15) // 2 * 2
    if data_iter is not None:
      it = data_iter
    elif config.data.get("multiclass"):
      it = iter(datasets.SyntheticMultiLabel(
          batch_size, canvas, config.data.num_classes,
          int(config.data.get("max_labels", 16))))
    else:
      it = iter(pipeline.SyntheticClassification(batch_size, canvas,
                                                 config.data.num_classes))
    stage_end = min((stage + 1) * stage_steps, train_steps)
    last_log = step
    while step < stage_end:
      batch = {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
               for k, v in next(it).items()}
      generator.manual_seed(step_seed(seed, step))
      state, metrics = step_fn(state, batch, generator)
      step += 1
      if step % log_every == 0 or step == stage_end:
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        now = time.perf_counter()
        n_steps = step - last_log
        m["lr"] = lr_fn(step - 1)
        m["secs_per_step"] = (now - prev_t) / n_steps
        m["examples_per_sec"] = batch_size * n_steps / max(now - prev_t, 1e-9)
        prev_t, last_log = now, step
        writer.write(step, m)
        print(f"step {step} stage {stage} isize {isize} loss {m['loss']:.4f} "
              f"top1 {m['top1']:.3f} ({m['examples_per_sec']:.1f} img/s)")
      if (eval_every and eval_iter is not None and eval_steps
          and step % eval_every == 0 and step < stage_end):
        mngr.save(step, state)
        out_eval = run_eval(step)
        prev_t = time.perf_counter()
    mngr.save(step, state)
    if eval_iter is not None and eval_steps:
      out_eval = run_eval(step)
      prev_t = time.perf_counter()
  writer.close()
  mngr.wait_until_finished()
  out = {k: float(v) for k, v in metrics.items()}
  out.update({f"eval/{k}": v for k, v in out_eval.items()})
  return out


def evaluate_classification(model, params, config, eval_iter, eval_steps: int,
                            mesh=None) -> dict:
  """Held-out classification eval: {top1, top5, samples} (multi-label data:
  {auc_pr, precision_at_1, samples}, eval/classification.py).

  params: {name: tensor} to evaluate (the EMA, or the model's own state).
  Each batch: {'image' [B, H, W, 3] canvases, 'label' one-hot or ids (or
  'label_ids')}; cls_eval_preprocess at eval.isize with the augname's
  normalization and the model run on the model's device, the metrics on
  the host. A multi-process eval (mesh) is ROADMAP M10."""
  from automl_tpu_torch.eval.classification import MultiLabelEvaluator
  if mesh is not None:
    raise NotImplementedError(
        "multi-process eval is not ported to automl_tpu_torch yet: ROADMAP "
        "M10")
  isize = int(config.eval.isize or resolve_train_size(config))
  norm, _ = preprocessing.norm_for_augname(config.data.get("augname"))
  multiclass = bool(config.data.get("multiclass"))
  num_classes = int(config.data.num_classes or config.model.num_classes)
  device = next(model.parameters()).device
  ev = MultiLabelEvaluator() if multiclass else None
  top1 = top5 = total = 0
  with train_lib.params_in(model, params), torch.no_grad():
    for _ in range(eval_steps):
      try:
        batch = next(eval_iter)
      except StopIteration:
        break  # a finite eval set smaller than eval_steps: a partial pass
      images = torch.as_tensor(np.asarray(batch["image"])).to(device)
      logits = model(preprocessing.cls_eval_preprocess(images, isize,
                                                       norm=norm),
                     train=False).float().cpu().numpy()
      if multiclass:
        ev.add_batch(logits, datasets.multihot_on_device(
            np.asarray(batch["label_ids"]), num_classes).numpy())
        continue
      labels = np.asarray(batch["label"])
      if labels.ndim > 1:  # one-hot -> ids
        labels = np.argmax(labels, -1)
      order = np.argsort(-logits, axis=-1)
      top1 += int((order[:, 0] == labels).sum())
      top5 += int((order[:, :5] == labels[:, None]).any(-1).sum())
      total += len(labels)
  if multiclass:
    return ev.result()
  return {"top1": top1 / max(total, 1), "top5": top5 / max(total, 1),
          "samples": float(total)}


# ---------------------------------------------------------------------------
# Detection.
# ---------------------------------------------------------------------------


def make_preprocess(config):
  """preprocess(batch, generator) on the device: gridmask (with
  config.grid_mask; fill 1) then det_train_preprocess, with draws from the
  generator."""
  size = anchors_lib.parse_image_size(config.image_size)[0]
  use_gridmask = bool(config.get("grid_mask"))

  def preprocess(batch, generator):
    images = batch["image"]
    if use_gridmask:
      _, h, w, _ = images.shape
      images = augment.gridmask(images.float(), augment.gridmask_draws(
          images.shape[0], h, w, generator, images.device))
    flip, jitter, offsets = preprocessing.det_train_draws(
        images.shape[0], generator, images.device)
    image, boxes, classes = preprocessing.det_train_preprocess(
        images, batch["gt_boxes"], batch["gt_classes"], flip, jitter,
        offsets, size, true_hw=batch["true_hw"],
        jitter_min=config.jitter_min, jitter_max=config.jitter_max,
        rand_hflip=config.input_rand_hflip, mean=config.mean_rgb,
        stddev=config.stddev_rgb)
    return {"image": image, "gt_boxes": boxes, "gt_classes": classes}

  return preprocess


def seeded_detection_model(config, seed: int = 0, device="cuda"):
  """An EfficientDet with weights drawn from `seed` in the JAX layout
  (convert.det_numpy_init), as run_detection starts from."""
  model = EfficientDet(config, device=device)
  convert.load_det_params(model, convert.det_numpy_init(model, seed))
  return model


def run_detection(config, model_dir: str, train_steps: int,
                  mesh_shape=None, eval_iter=None, eval_steps: int = 0,
                  eval_every: int = 0, log_every: int = 50,
                  init_backbone_ckpt=None, seed: int = 0,
                  device="cuda") -> dict:
  """Trains EfficientDet on one device, with optional COCO evals; returns
  the last metrics as floats (and the final eval's, when there is one).
  metrics.jsonl gets, every log_every steps, the step's metrics plus lr,
  secs_per_step and examples_per_sec (host clock, each logged step waits
  for its loss), and each in-training eval's metrics as eval/<name>.

  eval_iter: an iterator (one eval at the end) or a zero-argument factory
  of fresh iterators (needed for eval_every > 0: an eval every eval_every
  steps and at the last step)."""
  _refuse_unported(config, mesh_shape, init_backbone_ckpt)
  device = torch.device(device)
  os.makedirs(model_dir, exist_ok=True)
  config.save_to_yaml(os.path.join(model_dir, "config.yaml"))
  precision.set_policy("mixed_bfloat16" if config.mixed_precision
                       else "float32")
  model = seeded_detection_model(config, seed, device)
  batch_size = int(config.batch_size)
  steps_per_epoch = max(train_steps // max(config.num_epochs, 1), 1)
  lr_fn = schedules.detection_lr(config, steps_per_epoch)
  tx = opt_lib.masked_for_params(opt_lib.build_optimizer(
      config.optimizer if config.optimizer != "sgd" else "momentum", lr_fn,
      momentum=config.momentum))
  state = train_lib.create_train_state(
      model, tx, ema=bool(config.moving_average_decay),
      moving_normalizer=(config.get("positives_momentum", 0.0) or 0.0) > 0)
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  restored = mngr.restore(state)
  if restored is not None:
    state = restored
  step_fn = train_lib.make_det_train_step(model, tx, config,
                                          preprocess_fn=make_preprocess(config))
  size = anchors_lib.parse_image_size(config.image_size)
  it = iter(pipeline.SyntheticDetection(batch_size, size[0],
                                        config.max_instances_per_image,
                                        config.num_classes))
  generator = torch.Generator(device=device)
  writer = MetricsWriter(model_dir)

  def evaluate():
    fresh = eval_iter() if callable(eval_iter) else eval_iter
    params = (state.ema_params if state.ema_params is not None
              else state.params)
    return evaluate_detection(model, params, config, fresh, eval_steps)

  metrics = {}
  step = state.step
  prev_t = time.perf_counter()
  while step < train_steps:
    batch = {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
             for k, v in next(it).items()}
    generator.manual_seed(step_seed(seed, step))
    state, metrics = step_fn(state, batch, generator)
    step += 1
    if step % log_every == 0 or step == train_steps:
      m = {k: float(v) for k, v in metrics.items()}   # waits for the step
      now = time.perf_counter()
      n_steps = log_every if step % log_every == 0 else step % log_every
      m["lr"] = lr_fn(step - 1)
      m["secs_per_step"] = (now - prev_t) / n_steps
      m["examples_per_sec"] = batch_size * n_steps / max(now - prev_t, 1e-9)
      prev_t = now
      writer.write(step, m)
      print(f"step {step} loss {m['loss']:.4f} cls {m['cls_loss']:.4f} "
            f"box {m['box_loss']:.5f} ({m['examples_per_sec']:.1f} img/s)")
    if (eval_every and eval_iter is not None and eval_steps
        and (step % eval_every == 0 or step == train_steps)):
      mngr.save(step, state)
      em = evaluate()
      writer.write(step, {f"eval/{k}": v for k, v in em.items()})
      print(f"eval @ {step}: AP {em.get('AP', -1):.4f} "
            f"AP50 {em.get('AP50', -1):.4f}")
      if em.get("AP", -1) >= 0:
        archive_ckpt(model_dir, step, em["AP"], mngr)
  writer.close()
  mngr.save(step, state)
  mngr.wait_until_finished()
  out = {k: float(v) for k, v in metrics.items()}
  if eval_iter is not None and eval_steps and not eval_every:
    out.update(evaluate())
    if out.get("AP", -1) >= 0:
      archive_ckpt(model_dir, step, out["AP"], mngr)
  return out


def evaluate_detection(model, params, config, eval_iter, eval_steps: int,
                       per_class: bool = False, vis_dir: str | None = None,
                       vis_samples: int = 2, mesh=None,
                       testdev_dir: str | None = None) -> dict:
  """COCO eval: the model and the NMS on the model's device, the
  COCOEvaluator on the host.

  params: {name: tensor} to evaluate (the EMA, or the model's own state).
  Each batch: {'image' [B, H, W, 3] (NHWC, unnormalised), 'gt_boxes'
  [B, G, 4] canvas coordinates, 'gt_classes' [B, G], and optionally
  'image_scale' and 'source_id'}; the images are normalised with the
  config's mean and stddev on the device. Synthetic batches without
  'source_id' get image ids step * B + i.

  With testdev_dir set (the reference's test-dev mode) no ground truth is
  needed: the detections go to the COCO-server submission JSON and the
  result is {'AP': -1.0, 'detections_json': path}.

  vis_dir (the eval images) needs inference/visualize.py, and mesh a
  multi-process run: not ported yet (ROADMAP M9, M10) and refused
  (vis_samples belongs to vis_dir)."""
  from automl_tpu_torch.eval.coco_metric import COCOEvaluator
  if vis_dir:
    raise NotImplementedError(
        "eval images (vis_dir) need inference/visualize.py, which is not "
        "ported to automl_tpu_torch yet: ROADMAP M9")
  if mesh is not None:
    raise NotImplementedError(
        "multi-process eval is not ported to automl_tpu_torch yet: ROADMAP "
        "M10")
  device = next(model.parameters()).device
  evaluator = COCOEvaluator(per_class=per_class, label_map=None)
  mean = torch.tensor(config.mean_rgb, dtype=torch.float32, device=device)
  std = torch.tensor(config.stddev_rgb, dtype=torch.float32, device=device)
  with train_lib.params_in(model, params), torch.no_grad():
    for step in range(eval_steps):
      try:
        batch = next(eval_iter)
      except StopIteration:
        break  # a finite eval set smaller than eval_steps: a partial pass
      images = torch.as_tensor(np.asarray(batch["image"]),
                               dtype=torch.float32).to(device)
      images = ((images - mean) / std).permute(0, 3, 1, 2).contiguous(
          memory_format=torch.channels_last)
      b = images.shape[0]
      scale = np.asarray(batch.get("image_scale", 1.0), np.float32)
      scales = np.broadcast_to(scale.reshape(-1), (b,))
      if "source_id" in batch:
        ids = np.broadcast_to(
            np.asarray(batch["source_id"], np.float32).reshape(-1), (b,))
      else:
        ids = np.arange(step * b, step * b + b, dtype=np.float32)
      # gt boxes are in canvas coordinates: scaled as the detections are
      if testdev_dir is not None and "gt_boxes" not in batch:
        gt_boxes = np.zeros((b, 0, 4), np.float32)
        gt_classes = np.zeros((b, 0), np.int32)
      else:
        gt_boxes = (np.asarray(batch["gt_boxes"], np.float32)
                    * scale.reshape(-1, 1, 1))
        gt_classes = np.asarray(batch["gt_classes"])
      cls_out, box_out = model(images, train=False)
      dets, valid = postprocess.generate_detections(
          config, cls_out, box_out,
          torch.from_numpy(np.ascontiguousarray(scales)).to(device),
          torch.from_numpy(np.ascontiguousarray(ids)).to(device))
      evaluator.add_batch_from_detections(dets.cpu().numpy(),
                                          valid.cpu().numpy(), gt_boxes,
                                          gt_classes)
  if testdev_dir is not None:
    # the reference returns [-1.] in test-dev mode
    return {"AP": -1.0,
            "detections_json": evaluator.write_detections_json(testdev_dir)}
  return evaluator.compute()
