"""Model inspector CLI for EfficientDet (automl_tpu/cli/inspector.py's
flags): dry / infer / bm / export / params_flops / video runmodes.

Examples:
  python -m automl_tpu_torch.cli.inspector --runmode=dry \\
    --model_name=efficientdet-d0
  python -m automl_tpu_torch.cli.inspector --runmode=bm \\
    --model_name=efficientdet-d0 --batch_size=8 --bm_runs=20
  python -m automl_tpu_torch.cli.inspector --runmode=infer \\
    --input_image=img.jpg --output_image_dir=/tmp/out --device=cpu \\
    --model_name=efficientdet-test

dry serves zeros [batch_size, 64, 64, 3]; bm times ServingDriver.benchmark
(--trace_filename: a torch.profiler Chrome trace of one call); infer draws
the detections of --input_image into --output_image_dir (PIL); export
writes ServingDriver.export's serving.pt2 (torch.export; JAX writes
StableHLO) into --export_dir; video annotates --input_video frame by frame
into --output_video (cv2, mp4v). params_flops prints the parameter count
(every parameter and BN statistic, JAX's leaves) and the FLOPs of one eval
forward at [1, image_size, image_size, 3] counted by
torch.utils.flop_counter.FlopCounterMode on the meta device (convolutions
and matrix products, 2 per multiply-add; XLA's cost_analysis, which JAX
prints, also counts elementwise work). saved_model (a TF SavedModel)
raises NotImplementedError: it needs TensorFlow. Weights: --ckpt_path (a
port checkpoint directory), else seeded (ServingDriver.init_random).
Added here: --device (cuda, cuda:N or cpu; default cuda).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--runmode", default="dry",
                 choices=["dry", "infer", "bm", "benchmark", "export",
                          "saved_model", "params_flops", "video"])
  p.add_argument("--input_video", default=None)
  p.add_argument("--output_video", default=None)
  p.add_argument("--model_name", default="efficientdet-d0")
  p.add_argument("--ckpt_path", default=None)
  p.add_argument("--hparams", default="")
  p.add_argument("--batch_size", type=int, default=1)
  p.add_argument("--bm_runs", type=int, default=10)
  p.add_argument("--input_image", default=None)
  p.add_argument("--output_image_dir", default=None)
  p.add_argument("--export_dir", default=None)
  p.add_argument("--trace_filename", default=None)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  return p.parse_args(argv)


def params_flops(model_name: str, hparams: str = "") -> dict:
  """{params, flops} of the model: every state tensor's elements, and
  FlopCounterMode's count of one eval forward at [1, size, size, 3] on the
  meta device."""
  import torch
  from torch.utils.flop_counter import FlopCounterMode
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.models.efficientdet import build_detection_model
  from automl_tpu_torch.ops.anchors import parse_image_size
  config = get_efficientdet_config(model_name)
  config.override(hparams)
  model = build_detection_model(config, device="meta")
  n = sum(t.numel() for t in model.state_dict().values())
  h, w = parse_image_size(model.config.image_size)
  x = torch.zeros((1, 3, h, w), device="meta")
  with torch.no_grad(), FlopCounterMode(display=False) as counter:
    model(x, train=False)
  return {"params": n, "flops": counter.get_total_flops()}


def _video(args, driver) -> dict:
  """Each frame of --input_video served and annotated into
  --output_video (cv2, mp4v, the input's frame rate)."""
  import cv2
  cap = cv2.VideoCapture(args.input_video)
  fps = cap.get(cv2.CAP_PROP_FPS) or 24
  writer = None
  frames = 0
  try:
    while True:
      ok, frame = cap.read()
      if not ok:
        break
      rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
      annotated = driver.visualize(rgb, driver.serve(rgb[None]), 0)
      if writer is None:
        writer = cv2.VideoWriter(
            args.output_video, cv2.VideoWriter_fourcc(*"mp4v"), fps,
            (annotated.shape[1], annotated.shape[0]))
      writer.write(cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
      frames += 1
  finally:
    cap.release()
    if writer is not None:
      writer.release()
  return {"frames": frames, "output": args.output_video}


def main(argv=None):
  args = parse_args(argv)
  from automl_tpu_torch.inference.driver import InferenceDriver, ServingDriver

  if args.runmode == "params_flops":
    result = params_flops(args.model_name, args.hparams)
  elif args.runmode == "infer":
    if not args.input_image:
      raise ValueError("--runmode=infer needs --input_image")
    d = InferenceDriver(args.model_name, args.ckpt_path, device=args.device)
    dets, _ = d.inference(args.input_image, args.output_image_dir)
    result = {"detections": int(dets["valid_len"][0])}
  else:
    driver = ServingDriver(args.model_name, batch_size=args.batch_size,
                           hparams=args.hparams, device=args.device)
    if args.ckpt_path:
      driver.load(args.ckpt_path)
    else:
      driver.init_random()
    if args.runmode == "dry":
      import numpy as np
      out = driver.serve(np.zeros((args.batch_size, 64, 64, 3), np.uint8))
      result = {"runmode": "dry", "ok": True,
                "valid_len": out["valid_len"].tolist()}
    elif args.runmode in ("bm", "benchmark"):
      bm = driver.benchmark(bm_runs=args.bm_runs,
                            trace_filename=args.trace_filename)
      result = {k: round(float(v), 3) for k, v in bm.items()}
    elif args.runmode in ("export", "saved_model"):
      if not args.export_dir:
        raise ValueError(f"--runmode={args.runmode} needs --export_dir")
      if args.runmode == "saved_model":
        driver.export_saved_model(args.export_dir)
      result = {"export_dir": driver.export(args.export_dir)}
    else:   # video
      if not (args.input_video and args.output_video):
        raise ValueError("--runmode=video needs --input_video and "
                         "--output_video")
      result = _video(args, driver)
  print(json.dumps(result))
  return result


if __name__ == "__main__":
  main()
