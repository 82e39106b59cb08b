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
statistics masked, EMA, resume from model_dir/ckpt, a host loader
(data_iter: the TFRecord readers, or SyntheticDetection by default),
box-aware AutoAugment (autoaugment_policy), grid_mask and preprocessing on
the device (det_train_preprocess), metrics.jsonl and a final checkpoint;
profile=True writes a torch.profiler trace of steps 10-14 into
model_dir/profile/ (JAX writes an xprof trace there). Evaluation
(eval_iter): every eval_every steps, after a checkpoint, or once at the
end, on the EMA parameters when there are any; evaluate_detection runs the
model and postprocess.generate_detections on the device and the
COCOEvaluator on the host; archive_ckpt keeps the best checkpoint by AP.

Each step's randomness (preprocessing draws, dropout and drop_connect
masks) comes from a torch.Generator seeded from (seed, step), as JAX folds
the step into its key, so a resumed run draws what an uninterrupted one
would.

A loader's batches may be numpy arrays or tensors, on the host or
already on the device (data/pipeline.py::DevicePrefetcher).

Published TF checkpoints (ckpt/tf_compat.py, read without TF):
train.ft_init_ckpt starts a classifier from one, all but its head's fc
(train.ft_init_ema: its EMA shadows, by default); init_backbone_ckpt
starts a detector's backbone from an EfficientNet checkpoint
(init_backbone_ema). Both fill the seeded weights with strict=False, before
a checkpoint in model_dir is restored. evaluate_detection(vis_dir=...)
writes [detections | ground truth] PNGs of the first batch
(inference/visualize.py); run_detection's in-training evals write them to
model_dir/vis/step_<n>/.

QAT (nn/quant.py): run_detection (config.qat, qat_bits) and
run_classification (train.qat, train.qat_bits) set the process-wide QAT
mode both ways at entry, as JAX does, so a run never inherits it and its
in-training evals run under it.

Meshes (mesh_shape, JAX's runners on a mesh): one process per device, the
state replicated, each process feeding batch_size / (replica x data) rows
of every global batch (the ranks of 'model' the same rows), the train steps
under a VisionMesh (parallel/spatial.py): gradients summed over the data
axes, and, for detection on a 'model' axis above 1, image H split over
'model' (spatial partitioning). Rank 0 writes config.yaml, the metrics,
the checkpoints and the eval images; the others wait for it. The evals
take the mesh: each process predicts its rows, and the predictions are
gathered over the data axes, so every process computes the same global
metric; without it, a run of more than one process is refused, as in JAX.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.data import (augment, datasets, det_autoaugment,
                                   pipeline, preprocessing)
from automl_tpu_torch.models.efficientdet import EfficientDet
from automl_tpu_torch.models.efficientnet import EfficientNet
from automl_tpu_torch.nn import precision, quant
from automl_tpu_torch.ops import anchors as anchors_lib
from automl_tpu_torch.ops import postprocess
from automl_tpu_torch.parallel import comm
from automl_tpu_torch.parallel import distributed as dist_lib
from automl_tpu_torch.parallel import spatial as spatial_lib
from automl_tpu_torch.parallel.mesh import axis_size, create_mesh
from automl_tpu_torch.train import optimizers as opt_lib
from automl_tpu_torch.train import schedules, train_lib
from automl_tpu_torch.train.checkpoint import CheckpointManager, archive_ckpt
from automl_tpu_torch.train.metrics import MetricsWriter, NoWriter



def _run_mesh(mesh_shape, device, image_hw=None):
  """(mesh, VisionMesh, device, (row coordinate, rows' count), writes) of
  a run: without mesh_shape (None, None, device, (0, 1), True); with it,
  the mesh over the world's processes, spatial where image_hw is given
  and 'model' is above 1, and the mesh's device."""
  if not mesh_shape:
    return None, None, device, (0, 1), True
  mesh = create_mesh(mesh_shape, device=device.type)
  vm = spatial_lib.VisionMesh(
      mesh, image_hw,
      spatial=image_hw is not None and axis_size(mesh, "model") > 1)
  if device.type == "cuda":
    device = torch.device("cuda", torch.cuda.current_device())
  return (mesh, vm, device, dist_lib.batch_coordinate(mesh),
          dist_lib.process_index() == 0)


def _local_rows(batch_size: int, count: int) -> int:
  if batch_size % count:
    raise ValueError(f"batch {batch_size} does not split over {count} "
                     "rows of the mesh")
  return batch_size // count


def _multi_process_check(mesh):
  if mesh is None and dist_lib.process_count() > 1:
    raise ValueError(
        "multi-process eval needs the training mesh (mesh=...) to assemble "
        "local eval batches into global arrays against sharded params")


def _gather_rows(x, mesh):
  """Each process's rows of x (a tensor or numpy array) in the global
  batch's order (over 'data', then 'replica'); x itself off a mesh."""
  if mesh is None:
    return x
  t = x if torch.is_tensor(x) else torch.as_tensor(np.ascontiguousarray(x))
  dev = (torch.device("cuda", torch.cuda.current_device())
         if mesh.device_type == "cuda" else torch.device("cpu"))
  out = comm.all_gather_dims(t.to(dev), mesh, (("data", 0), ("replica", 0)))
  return out if torch.is_tensor(x) else out.cpu().numpy()


def set_qat_mode(on, bits) -> None:
  """QAT on (with `bits`, 8 when unset) or off: the mode is process-wide,
  so a run sets it both ways and never inherits it."""
  if on:
    quant.enable_qat(int(bits or 8))
  else:
    quant.disable_qat()


def step_seed(seed: int, step: int, row: int = 0, rows: int = 1) -> int:
  """The seed of step `step`'s generator (on a mesh, of the rows at
  coordinate `row` of `rows`: the ranks of 'model' draw alike)."""
  return ((seed + 1) * 1_000_003 + step) * rows + row


def on_device(batch: dict, device) -> dict:
  """A loader's batch ({name: numpy array or tensor}) as tensors on
  `device`; tensors already there are taken as they are."""
  return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
              ).to(device, non_blocking=True) for k, v in batch.items()}


def _host(v) -> np.ndarray:
  """A batch value (numpy array or tensor, on any device) as numpy."""
  return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


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


def classification_state(model, config, lr_fn=lambda step: 0.0):
  """(training state, optimizer) of run_classification for `model`: also
  the template an eval restores a checkpoint into."""
  tx = opt_lib.masked_for_params(
      opt_lib.build_optimizer(config.train.optimizer, lr_fn))
  return train_lib.create_train_state(
      model, tx, ema=bool(config.train.ema_decay)), tx


def init_from_tf_checkpoint(model, ckpt: str, **kwargs) -> None:
  """Overwrites the EfficientNet `model`'s (seeded) weights with those of
  a TF checkpoint, strict=False: what the checkpoint lacks, or kwargs'
  exclude_prefixes name, keeps its value (tf_compat's
  convert_effnet_checkpoint, with kwargs use_ema, scope,
  exclude_prefixes)."""
  from automl_tpu_torch.ckpt import tf_compat
  tf_compat.convert_effnet_checkpoint(
      ckpt, model, params=convert.det_torch_to_jax_tree(
          convert.model_state(model), model), strict=False, **kwargs)


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
  examples_per_sec (host clock; each logged step waits for its loss).
  mesh_shape: a mesh over the world's processes (see the module); each
  process's data_iter yields its rows of each batch."""
  mesh, vm, device, (row, rows), writes = _run_mesh(mesh_shape,
                                                    torch.device(device))
  os.makedirs(model_dir, exist_ok=True)
  if writes:
    config.save_to_yaml(os.path.join(model_dir, "config.yaml"))
  precision.set_policy("mixed_bfloat16" if config.runtime.mixed_precision
                       else "float32")
  set_qat_mode(config.train.get("qat"), config.train.get("qat_bits", 8))
  model = spatial_lib.attach(
      seeded_classification_model(config.model, seed, device), vm)
  ft_ckpt = config.train.get("ft_init_ckpt")
  if ft_ckpt:   # finetune: everything but the classifier's fc
    init_from_tf_checkpoint(
        model, ft_ckpt, use_ema=bool(config.train.get("ft_init_ema", True)),
        exclude_prefixes=(("head", "fc"),))
  batch_size = int(config.train.batch_size)
  local_batch = _local_rows(batch_size, rows)
  steps_per_epoch = max(train_steps // max(config.train.epochs, 1), 1)
  lr_fn = schedules.warmup_lr(
      config.train.lr_sched, config.train.lr_base,
      steps_per_epoch=steps_per_epoch, total_steps=train_steps,
      warmup_epochs=config.train.lr_warmup_epoch,
      decay_epochs=config.train.lr_decay_epoch,
      decay_factor=config.train.lr_decay_factor,
      minimal_lr=config.train.lr_min)
  state, tx = classification_state(model, config, lr_fn)
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"),
                           max_to_keep=config.runtime.keep_checkpoint_max)
  restored = mngr.restore(state)
  if restored is not None:
    state = restored
  total_stages = max(int(config.train.stages or 0), 1)
  stage_steps = train_steps // total_stages
  generator = torch.Generator(device=device)
  writer = MetricsWriter(model_dir) if writes else NoWriter()
  objective_key = "auc_pr" if config.data.get("multiclass") else "top1"

  def run_eval(at_step):
    params = (state.ema_params if state.ema_params is not None
              else state.params)
    fresh = eval_iter() if callable(eval_iter) else eval_iter
    em = evaluate_classification(model, params, config, fresh, eval_steps,
                                 mesh=mesh)
    writer.write(at_step, {f"eval/{k}": v for k, v in em.items()})
    if writes:
      print(f"eval @ {at_step}: " +
            " ".join(f"{k} {v:.4f}" for k, v in em.items()))
    if writes and em.get(objective_key, -1) >= 0:
      archive_ckpt(model_dir, at_step, em[objective_key], mngr)
    dist_lib.barrier()
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
          local_batch, canvas, config.data.num_classes,
          int(config.data.get("max_labels", 16))))
    else:
      it = iter(pipeline.SyntheticClassification(local_batch, canvas,
                                                 config.data.num_classes))
    stage_end = min((stage + 1) * stage_steps, train_steps)
    last_log = step
    while step < stage_end:
      batch = on_device(next(it), device)
      generator.manual_seed(step_seed(seed, step, row, rows))
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
        if writes:
          print(f"step {step} stage {stage} isize {isize} loss "
                f"{m['loss']:.4f} top1 {m['top1']:.3f} "
                f"({m['examples_per_sec']:.1f} img/s)")
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
  the host. mesh (a run of several processes): each process feeds its rows
  and the logits and labels are gathered, so every process computes the
  same global metric."""
  from automl_tpu_torch.eval.classification import MultiLabelEvaluator
  _multi_process_check(mesh)
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
      images = on_device({"image": batch["image"]}, device)["image"]
      logits = _gather_rows(model(preprocessing.cls_eval_preprocess(
          images, isize, norm=norm), train=False).float(), mesh).cpu().numpy()
      if multiclass:
        ev.add_batch(logits, _gather_rows(datasets.multihot_on_device(
            _host(batch["label_ids"]), num_classes).numpy(), mesh))
        continue
      labels = _host(batch["label"])
      if labels.ndim > 1:  # one-hot -> ids
        labels = np.argmax(labels, -1)
      labels = _gather_rows(labels, mesh)
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
  """preprocess(batch, generator) on the device: box-aware AutoAugment
  (with config.autoaugment_policy), gridmask (with config.grid_mask; fill
  1), then det_train_preprocess, with draws from the generator in that
  order."""
  size = anchors_lib.parse_image_size(config.image_size)[0]
  use_gridmask = bool(config.get("grid_mask"))
  aa_policy = config.get("autoaugment_policy")

  def preprocess(batch, generator):
    images = batch["image"]
    boxes, classes = batch["gt_boxes"], batch["gt_classes"]
    if aa_policy:   # before the geometric jitter, as in JAX
      _, h, w, _ = images.shape
      draws = det_autoaugment.autoaugment_draws(
          images.shape[0], aa_policy, h, w, generator, images.device)
      images, boxes, classes = det_autoaugment.distort(
          images, boxes, classes, draws, aa_policy)
    if use_gridmask:
      _, h, w, _ = images.shape
      images = augment.gridmask(images.float(), augment.gridmask_draws(
          images.shape[0], h, w, generator, images.device))
    flip, jitter, offsets = preprocessing.det_train_draws(
        images.shape[0], generator, images.device)
    image, boxes, classes = preprocessing.det_train_preprocess(
        images, boxes, classes, flip, jitter,
        offsets, size, true_hw=batch["true_hw"],
        jitter_min=config.jitter_min, jitter_max=config.jitter_max,
        rand_hflip=config.input_rand_hflip, mean=config.mean_rgb,
        stddev=config.stddev_rgb)
    return {"image": image, "gt_boxes": boxes, "gt_classes": classes}

  return preprocess


def detection_state(model, config, lr_fn=lambda step: 0.0):
  """(training state, optimizer) of run_detection for `model`: also the
  template an eval restores a checkpoint into."""
  tx = opt_lib.masked_for_params(opt_lib.build_optimizer(
      config.optimizer if config.optimizer != "sgd" else "momentum", lr_fn,
      momentum=config.momentum))
  return train_lib.create_train_state(
      model, tx, ema=bool(config.moving_average_decay),
      moving_normalizer=(config.get("positives_momentum", 0.0) or 0.0) > 0
  ), tx


def restore_eval_params(mngr, template, step):
  """The EMA (else the params) of checkpoint `step`, restored into
  `template` (its model's tensors take the params); None when the
  checkpoint vanished or was cut short (a concurrent trainer keeps
  max_to_keep), as JAX's eval loop skips it."""
  from automl_tpu_torch.train.checkpoint import RESTORE_ERRORS
  try:
    state = mngr.restore(template, step=step)
  except RESTORE_ERRORS as e:
    print(f"checkpoint {step} vanished, skipping: {e!r}")
    return None
  if state is None:
    return None
  return state.ema_params if state.ema_params is not None else state.params


def seeded_detection_model(config, seed: int = 0, device="cuda"):
  """An EfficientDet with weights drawn from `seed` in the JAX layout
  (convert.det_numpy_init), as run_detection starts from."""
  model = EfficientDet(config, device=device)
  convert.load_det_params(model, convert.det_numpy_init(model, seed))
  return model


PROFILE_STEPS = (10, 14)   # the steps run_detection(profile=True) traces


def _start_profile(device):
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == "cuda":
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  profiler = torch.profiler.profile(activities=activities)
  profiler.start()
  return profiler


def _stop_profile(profiler, model_dir: str, device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  profiler.stop()
  out = os.path.join(model_dir, "profile")
  os.makedirs(out, exist_ok=True)
  a, b = PROFILE_STEPS
  path = os.path.join(out, f"trace_steps_{a}-{b}.json")
  profiler.export_chrome_trace(path)
  print(f"profile of steps {a}-{b}: {path}")


def run_detection(config, model_dir: str, train_steps: int,
                  mesh_shape=None, data_iter=None, eval_iter=None,
                  eval_steps: int = 0, eval_every: int = 0,
                  log_every: int = 50, ckpt_every: int = 0,
                  init_backbone_ckpt=None, init_backbone_ema: bool = True,
                  profile: bool = False, seed: int = 0,
                  device="cuda") -> dict:
  """Trains EfficientDet on one device, with optional COCO evals; returns
  the last metrics as floats (and the final eval's, when there is one).
  metrics.jsonl gets, every log_every steps, the step's metrics plus lr,
  secs_per_step and examples_per_sec (host clock, each logged step waits
  for its loss), and each in-training eval's metrics as eval/<name>.

  data_iter: a host iterator of {'image' uint8 [B, S, S, 3] canvases,
  'true_hw', 'gt_boxes', 'gt_classes' (extra keys such as image_scale and
  source_id are ignored)}; by default synthetic batches. eval_iter: an
  iterator (one eval at the end) or a zero-argument factory of fresh
  iterators (needed for eval_every > 0: an eval every eval_every steps and
  at the last step; each writes its eval images to
  model_dir/vis/step_<n>/). ckpt_every: a checkpoint every ckpt_every
  steps before the last (0: at the evals and the end only), from which a
  rerun resumes. init_backbone_ckpt: a TF EfficientNet
  checkpoint (scope config.backbone_name) for the backbone's weights. profile: a torch.profiler trace of steps 10-14 (or
  from step 10 to the end, if that comes first) into
  model_dir/profile/trace_steps_10-14.json. mesh_shape: a mesh over the
  world's processes (see the module; image H over a 'model' axis above
  1); each process's data_iter yields its rows of each batch."""
  size = anchors_lib.parse_image_size(config.image_size)
  mesh, vm, device, (row, rows), writes = _run_mesh(
      mesh_shape, torch.device(device), image_hw=size)
  os.makedirs(model_dir, exist_ok=True)
  if writes:
    config.save_to_yaml(os.path.join(model_dir, "config.yaml"))
  precision.set_policy("mixed_bfloat16" if config.mixed_precision
                       else "float32")
  set_qat_mode(config.get("qat"), config.get("qat_bits", 8))
  model = spatial_lib.attach(seeded_detection_model(config, seed, device),
                             vm)
  if init_backbone_ckpt:
    init_from_tf_checkpoint(model.backbone, init_backbone_ckpt,
                            use_ema=init_backbone_ema,
                            scope=config.backbone_name)
  batch_size = int(config.batch_size)
  steps_per_epoch = max(train_steps // max(config.num_epochs, 1), 1)
  lr_fn = schedules.detection_lr(config, steps_per_epoch)
  state, tx = detection_state(model, config, lr_fn)
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  restored = mngr.restore(state)
  if restored is not None:
    state = restored
  step_fn = train_lib.make_det_train_step(model, tx, config,
                                          preprocess_fn=make_preprocess(config))
  it = data_iter if data_iter is not None else iter(
      pipeline.SyntheticDetection(_local_rows(batch_size, rows), size[0],
                                  config.max_instances_per_image,
                                  config.num_classes))
  generator = torch.Generator(device=device)
  writer = MetricsWriter(model_dir) if writes else NoWriter()
  profiler = None

  def evaluate(vis_dir=None):
    fresh = eval_iter() if callable(eval_iter) else eval_iter
    params = (state.ema_params if state.ema_params is not None
              else state.params)
    return evaluate_detection(model, params, config, fresh, eval_steps,
                              vis_dir=vis_dir if writes else None, mesh=mesh)

  metrics = {}
  step = state.step
  prev_t = time.perf_counter()
  while step < train_steps:
    batch = on_device(next(it), device)
    generator.manual_seed(step_seed(seed, step, row, rows))
    if profile and step == PROFILE_STEPS[0]:
      profiler = _start_profile(device)
    state, metrics = step_fn(state, batch, generator)
    step += 1
    if profiler is not None and step > PROFILE_STEPS[1]:
      _stop_profile(profiler, model_dir, device)
      profiler = None
    if ckpt_every and step % ckpt_every == 0 and step < train_steps:
      mngr.save(step, state)
    if step % log_every == 0 or step == train_steps:
      m = {k: float(v) for k, v in metrics.items()}   # waits for the step
      now = time.perf_counter()
      n_steps = log_every if step % log_every == 0 else step % log_every
      m["lr"] = lr_fn(step - 1)
      m["secs_per_step"] = (now - prev_t) / n_steps
      m["examples_per_sec"] = batch_size * n_steps / max(now - prev_t, 1e-9)
      prev_t = now
      writer.write(step, m)
      if writes:
        print(f"step {step} loss {m['loss']:.4f} cls {m['cls_loss']:.4f} "
              f"box {m['box_loss']:.5f} ({m['examples_per_sec']:.1f} img/s)")
    if (eval_every and eval_iter is not None and eval_steps
        and (step % eval_every == 0 or step == train_steps)):
      mngr.save(step, state)
      em = evaluate(os.path.join(model_dir, "vis", f"step_{step}"))
      writer.write(step, {f"eval/{k}": v for k, v in em.items()})
      if writes:
        print(f"eval @ {step}: AP {em.get('AP', -1):.4f} "
              f"AP50 {em.get('AP50', -1):.4f}")
      if writes and em.get("AP", -1) >= 0:
        archive_ckpt(model_dir, step, em["AP"], mngr)
      dist_lib.barrier()
  if profiler is not None:
    _stop_profile(profiler, model_dir, device)
  writer.close()
  mngr.save(step, state)
  mngr.wait_until_finished()
  out = {k: float(v) for k, v in metrics.items()}
  if eval_iter is not None and eval_steps and not eval_every:
    out.update(evaluate())
    if writes and out.get("AP", -1) >= 0:
      archive_ckpt(model_dir, step, out["AP"], mngr)
    dist_lib.barrier()
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

  With vis_dir set, [detections | ground truth] PNGs of the first
  vis_samples images of the first batch go there as eval_image_<i>.png
  (_write_eval_images). mesh (a run of several processes): each process
  feeds its rows; the detections, ground truth and image ids are gathered
  over the data axes, so every process computes the same global metric
  (synthetic ids follow the rows' coordinate)."""
  from automl_tpu_torch.eval.coco_metric import COCOEvaluator
  _multi_process_check(mesh)
  row, rows = (dist_lib.batch_coordinate(mesh) if mesh is not None
               else (0, 1))
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
      images = on_device({"image": batch["image"]}, device)["image"].float()
      images = ((images - mean) / std).permute(0, 3, 1, 2).contiguous(
          memory_format=torch.channels_last)
      b = images.shape[0]
      scale = _host(batch.get("image_scale", 1.0)).astype(np.float32)
      scales = np.broadcast_to(scale.reshape(-1), (b,)).copy()
      if "source_id" in batch:
        ids = np.broadcast_to(
            _host(batch["source_id"]).astype(np.float32).reshape(-1),
            (b,)).copy()
      else:
        offset = (step * rows + row) * b
        ids = np.arange(offset, offset + b, dtype=np.float32)
      # gt boxes are in canvas coordinates: scaled as the detections are
      if testdev_dir is not None and "gt_boxes" not in batch:
        gt_boxes = np.zeros((b, 0, 4), np.float32)
        gt_classes = np.zeros((b, 0), np.int32)
      else:
        gt_boxes = (_host(batch["gt_boxes"]).astype(np.float32)
                    * scale.reshape(-1, 1, 1))
        gt_classes = _host(batch["gt_classes"])
      cls_out, box_out = model(images, train=False)
      dets, valid = postprocess.generate_detections(
          config, cls_out, box_out,
          torch.from_numpy(np.ascontiguousarray(scales)).to(device),
          torch.from_numpy(np.ascontiguousarray(ids)).to(device))
      dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
      if vis_dir and step == 0:
        _write_eval_images(batch, dets, valid, vis_dir, vis_samples)
      evaluator.add_batch_from_detections(
          *(_gather_rows(a, mesh) for a in (dets, valid, gt_boxes,
                                             gt_classes)))
  if testdev_dir is not None:
    # the reference returns [-1.] in test-dev mode
    return {"AP": -1.0,
            "detections_json": evaluator.write_detections_json(testdev_dir)}
  return evaluator.compute()


def _write_eval_images(batch, dets, valid, vis_dir: str, n: int) -> None:
  """[detections | ground truth] PNGs of the batch's first n images
  (canvas coordinates) as vis_dir/eval_image_<i>.png. dets: [B, K, 7]
  rows [id, ymin, xmin, ymax, xmax, score, class] in source coordinates,
  mapped back to the canvas by the batch's image_scale."""
  from automl_tpu_torch.inference import visualize
  os.makedirs(vis_dir, exist_ok=True)
  images = _host(batch["image"])
  if images.dtype != np.uint8:
    images = np.clip(images, 0, 255).astype(np.uint8)
  scales = np.broadcast_to(
      _host(batch.get("image_scale", 1.0)).astype(np.float32).reshape(-1),
      (images.shape[0],))
  gt_boxes, gt_classes = _host(batch["gt_boxes"]), _host(batch["gt_classes"])
  for i in range(min(n, images.shape[0])):
    k = int(valid[i])
    s = float(scales[i])
    panel = visualize.side_by_side_evaluation_image(
        images[i], gt_boxes[i], gt_classes[i],
        dets[i, :k, 1:5] / max(s, 1e-8), dets[i, :k, 6].astype(np.int32),
        dets[i, :k, 5])
    visualize.save_image_array_as_png(
        panel, os.path.join(vis_dir, f"eval_image_{i}.png"))
