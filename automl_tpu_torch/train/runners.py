"""The detection runner on one device: training and COCO evaluation.

The counterpart of automl_tpu/train/runners.py::run_detection and
evaluate_detection. Training: config.yaml in model_dir, the precision
policy from config.mixed_precision, seeded weights in the JAX layout
(convert.det_numpy_init), detection_lr over steps_per_epoch = train_steps
// num_epochs, momentum SGD for optimizer="sgd" with the BN statistics
masked, EMA, resume from model_dir/ckpt, the synthetic loader
(SyntheticDetection), preprocessing on the device (det_train_preprocess),
metrics.jsonl and a final checkpoint. Evaluation (eval_iter): every
eval_every steps, after a checkpoint, or once at the end, on the EMA
parameters when there are any; evaluate_detection runs the model and
postprocess.generate_detections on the device and the COCOEvaluator on
the host; archive_ckpt keeps the best checkpoint by AP.

Each step's randomness (preprocessing draws, drop_connect masks) comes
from a torch.Generator seeded from (seed, step), as JAX folds the step
into its key, so a resumed run draws what an uninterrupted one would.

Not ported yet, each refused naming its ROADMAP item: the eval images
(vis_dir: inference/visualize.py, M9; the in-training eval writes none),
autoaugment_policy (M9), grid_mask (M8), qat (M11), init_backbone_ckpt
(M9), meshes (M10).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.data import pipeline, preprocessing
from automl_tpu_torch.models.efficientdet import EfficientDet
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
      (config.get("grid_mask"), "grid_mask", "M8 (augment)"),
      (config.get("qat"), "qat", "M11"),
  ]
  for on, what, item in unported:
    if on:
      raise NotImplementedError(
          f"{what} is not ported to automl_tpu_torch yet: ROADMAP {item}")


def step_seed(seed: int, step: int) -> int:
  """The seed of step `step`'s generator."""
  return (seed + 1) * 1_000_003 + step


def make_preprocess(config):
  """preprocess(batch, generator) on the device: det_train_preprocess with
  draws from the generator."""
  size = anchors_lib.parse_image_size(config.image_size)[0]

  def preprocess(batch, generator):
    images = batch["image"]
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


@contextlib.contextmanager
def _params_in(model, params: dict):
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
  with _params_in(model, params), torch.no_grad():
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
