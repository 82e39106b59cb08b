"""ServingDriver / InferenceDriver: build, restore, serve, benchmark and
export EfficientDet: the counterpart of automl_tpu/inference/driver.py.

One program (ServeProgram, a torch.nn.Module) does uint8 images ->
normalise / resize / pad -> network -> box decode -> NMS on the driver's
device. Divergences from JAX, each tested in tests/test_torch_driver.py:

  export        torch.export.export of the whole program, saved as
                serving.pt2 (JAX writes StableHLO, serving.stablehlo),
                with the same config.json. export_saved_model and
                export_tflite write TensorFlow's artifacts and need TF:
                they raise NotImplementedError (ROADMAP "Leave out").
  init_random   seeded weights drawn in numpy in the JAX layout
                (convert.det_numpy_init, as entry() and the trainers
                start from), not jax.random's numbers.
  benchmark     trace_filename gets a torch.profiler Chrome trace of one
                call (JAX writes an xprof trace into its directory).
  load          a checkpoint directory of either package's trainers
                (train/checkpoint.py: the params of a step; the JAX
                package's orbax steps read by ckpt/orbax.py).

Every entry point runs on `device` (default "cuda"): nothing falls back to
the CPU unless the caller asks for it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from automl_tpu_torch import convert
from automl_tpu_torch.configs.efficientdet_configs import (
    get_efficientdet_config)
from automl_tpu_torch.data import preprocessing
from automl_tpu_torch.models.efficientdet import EfficientDet
from automl_tpu_torch.nn import precision
from automl_tpu_torch.ops import depthwise, postprocess
from automl_tpu_torch.ops.anchors import parse_image_size

POST_FNS = {"per_class": postprocess.postprocess_per_class,
            "global": postprocess.postprocess_global,
            "combined": postprocess.postprocess_combined}
OUTPUT_KEYS = ("boxes", "scores", "classes", "valid_len")
EXPORT_FILE = "serving.pt2"


class ServeProgram(torch.nn.Module):
  """uint8 [B, H, W, 3] (any H, W) -> (boxes [B, K, 4] in the input's
  pixels, scores [B, K], classes [B, K], valid_len [B]): the eval
  preprocess to the config's size, the eval forward and the post_mode
  postprocess, with scale_out = max(H, W) / size as JAX's serve."""

  def __init__(self, model: EfficientDet, post_mode: str):
    super().__init__()
    self.model = model
    self.post_mode = post_mode

  def forward(self, images):
    config = self.model.config
    size = parse_image_size(config.image_size)[0]
    b, h, w, _ = images.shape
    x, _ = preprocessing.det_eval_preprocess(images, size, config.mean_rgb,
                                             config.stddev_rgb)
    cls_out, box_out = self.model(x.permute(0, 3, 1, 2), train=False)
    scales = torch.full((b,), max(h, w) / size, dtype=torch.float32,
                        device=images.device)
    return POST_FNS[self.post_mode](config, cls_out, box_out, scales)


class ServingDriver:
  """End-to-end detection serving: uint8 image batches -> detections.

    driver = ServingDriver('efficientdet-d0', batch_size=1)
    driver.load(ckpt_dir)             # or .init_random() / .load_tf(prefix)
    dets = driver.serve(images)       # [B, H, W, 3] uint8 -> dict of numpy

  The constructor sets the process-wide precision policy
  (mixed_bfloat16, or float32 with mixed_precision=False), as JAX's does.
  """

  def __init__(self, model_name: str, batch_size: int = 1,
               min_score_thresh: float = 0.3, max_boxes_to_draw: int = 100,
               mixed_precision: bool = True, hparams=None,
               post_mode: str = "per_class", device="cuda"):
    self.config = get_efficientdet_config(model_name)
    if hparams:
      self.config.override(hparams)
    if post_mode not in POST_FNS:
      raise ValueError(f"post_mode must be per_class/global/combined, "
                       f"got {post_mode!r}")
    self.post_mode = post_mode
    self.batch_size = batch_size
    self.min_score_thresh = min_score_thresh
    self.max_boxes_to_draw = max_boxes_to_draw
    self.device = torch.device(device)
    precision.set_policy("mixed_bfloat16" if mixed_precision else "float32")
    self.model = EfficientDet(self.config, device=self.device).eval()
    self.program = ServeProgram(self.model, post_mode).eval()
    self.params = None   # {name: tensor} once loaded

  def _loaded(self):
    self.params = convert.model_state(self.model)
    return self

  def init_random(self, seed: int = 0):
    """Seeded weights in the JAX layout (convert.det_numpy_init)."""
    convert.load_det_params(self.model,
                            convert.det_numpy_init(self.model, seed))
    return self._loaded()

  def load(self, ckpt_path: str, step: Optional[int] = None):
    """The params of step `step` (default: the latest) of a checkpoint
    directory written by either package's trainers (model_dir/ckpt: the
    port's state.pt, or JAX's orbax steps)."""
    from automl_tpu_torch.train.checkpoint import saved_params
    keys = list(convert.model_state(self.model))
    self.model.load_state_dict(saved_params(ckpt_path, step, keys=keys),
                               strict=True)
    return self._loaded()

  def load_tf(self, ckpt_path: str, use_ema: bool = True):
    """A published TF EfficientDet checkpoint (prefix or directory), read
    without TF (ckpt/tf_compat.py); use_ema prefers the EMA shadows."""
    from automl_tpu_torch.ckpt import tf_compat
    tf_compat.convert_effdet_checkpoint(ckpt_path, self.model,
                                        use_ema=use_ema)
    return self._loaded()

  def _check_loaded(self):
    if self.params is None:
      raise RuntimeError("Call load(), load_tf() or init_random() first")

  def _run(self, images):
    if not torch.is_tensor(images):
      images = torch.from_numpy(np.array(images))   # a writable copy
    images = images.to(self.device)
    with torch.no_grad():
      return self.program(images)

  def serve(self, images) -> dict:
    """images: [B, H, W, 3] uint8 (any H, W; resized on the device) ->
    {boxes, scores, classes, valid_len} as numpy."""
    self._check_loaded()
    return {k: v.cpu().numpy() for k, v in zip(OUTPUT_KEYS,
                                                self._run(images))}

  def serve_files(self, image_files: Sequence[str]) -> dict:
    """Serves image files (PIL) as one batch, each at the top left of a
    canvas of the largest height and width."""
    from PIL import Image
    images = [np.asarray(Image.open(f).convert("RGB")) for f in image_files]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    canvas = np.zeros((len(images), h, w, 3), np.uint8)
    for i, im in enumerate(images):
      canvas[i, :im.shape[0], :im.shape[1]] = im
    return self.serve(canvas)

  def visualize(self, image, detections: dict, index: int = 0, **kwargs):
    """Image `index`'s valid detections drawn on `image` (uint8 [H, W, 3];
    inference/visualize.py::visualize_image)."""
    from automl_tpu_torch.inference.visualize import visualize_image
    n = int(detections["valid_len"][index])
    kwargs.setdefault("label_map", self.config.label_map)
    kwargs.setdefault("min_score_thresh", self.min_score_thresh)
    kwargs.setdefault("max_boxes_to_draw", self.max_boxes_to_draw)
    return visualize_image(
        image, detections["boxes"][index][:n],
        detections["classes"][index][:n].astype(int),
        detections["scores"][index][:n], **kwargs)

  def _sync(self):
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def benchmark(self, images=None, bm_runs: int = 10,
                trace_filename: Optional[str] = None) -> dict:
    """Serve throughput on the device: one warm-up call, then bm_runs
    calls on the host clock, ending in a synchronise ->
    {fps, latency_ms, batch_size}. trace_filename: a torch.profiler
    Chrome trace of one call, written there."""
    self._check_loaded()
    if images is None:
      size = parse_image_size(self.config.image_size)
      images = np.zeros((self.batch_size, *size, 3), np.uint8)
    images = torch.as_tensor(images).to(self.device)
    self._run(images)
    self._sync()
    if trace_filename:
      activities = [torch.profiler.ProfilerActivity.CPU]
      if self.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
      with torch.profiler.profile(activities=activities) as prof:
        self._run(images)
        self._sync()
      os.makedirs(os.path.dirname(trace_filename) or ".", exist_ok=True)
      prof.export_chrome_trace(trace_filename)
    start = time.perf_counter()
    for _ in range(bm_runs):
      self._run(images)
    self._sync()
    elapsed = time.perf_counter() - start
    return {"fps": images.shape[0] * bm_runs / elapsed,
            "latency_ms": elapsed / bm_runs * 1000.0,
            "batch_size": int(images.shape[0])}

  def export(self, output_dir: str):
    """torch.export.export of the whole serve program (preprocess ->
    forward -> postprocess) at uint8 [batch_size, *image_size, 3], saved
    as output_dir/serving.pt2 with config.json {model_name, image_size,
    batch_size}. The forward is traced with the K6 knob off (its
    default): with it on, a ValueError says so. A failed export raises."""
    self._check_loaded()
    if depthwise.pallas_filter_grad_enabled():
      raise ValueError(
          "export traces the eval forward with the K6 knob off: call "
          "ops.depthwise.enable_pallas_filter_grad(False) first (the knob "
          "changes only the training backward)")
    size = parse_image_size(self.config.image_size)
    example = torch.zeros((self.batch_size, *size, 3), dtype=torch.uint8,
                          device=self.device)
    # One eager call first: the postprocess caches its anchors and canvas
    # limits per config and device, and a cache filled while tracing
    # would hold the tracer's fake tensors.
    self._run(example)
    with torch.no_grad():
      exported = torch.export.export(self.program, (example,))
    os.makedirs(output_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(output_dir, EXPORT_FILE))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
      json.dump({"model_name": self.config.name,
                 "image_size": list(size),
                 "batch_size": self.batch_size}, f)
    return output_dir

  def export_saved_model(self, output_dir: str):
    raise NotImplementedError(
        "export_saved_model writes a TF SavedModel (jax2tf in JAX) and needs "
        "TensorFlow, which the port's machines do not have (ROADMAP: Leave "
        "out); use export(), a torch.export program (serving.pt2)")

  def export_tflite(self, output_path: str, post_mode: str = "tflite",
                    int8_calibration_images=None):
    raise NotImplementedError(
        "export_tflite writes a TFLite model (jax2tf in JAX) and needs "
        "TensorFlow, which the port's machines do not have (ROADMAP: Leave "
        "out); use export(), a torch.export program (serving.pt2)")


def load_exported(export_dir: str):
  """The program ServingDriver.export saved (serving.pt2), as a callable:
  uint8 [batch_size, *image_size, 3] on the device it was exported on ->
  (boxes, scores, classes, valid_len)."""
  program = torch.export.load(os.path.join(export_dir, EXPORT_FILE)).module()
  return program.requires_grad_(False)


class InferenceDriver:
  """One-shot image file -> detections and the annotated image."""

  def __init__(self, model_name: str, ckpt_path: Optional[str] = None,
               **kwargs):
    self.driver = ServingDriver(model_name, batch_size=1, **kwargs)
    if ckpt_path:
      self.driver.load(ckpt_path)
    else:
      self.driver.init_random()

  def inference(self, image_path: str, output_dir: Optional[str] = None):
    """-> (detections, annotated uint8 image); with output_dir, the
    annotated image is saved there under the input's file name."""
    from PIL import Image
    image = np.asarray(Image.open(image_path).convert("RGB"))
    dets = self.driver.serve(image[None])
    annotated = self.driver.visualize(image, dets, 0)
    if output_dir:
      os.makedirs(output_dir, exist_ok=True)
      Image.fromarray(annotated).save(
          os.path.join(output_dir, os.path.basename(image_path)))
    return dets, annotated
