"""Classification inference and benchmark CLI (automl_tpu/cli/infer_cls.py's
flags).

Examples:
  python -m automl_tpu_torch.cli.infer_cls --model_name=efficientnetv2-b0 \\
    --runmode=bm --batch_size=8
  python -m automl_tpu_torch.cli.infer_cls --runmode=infer \\
    --input_image=cat.jpg --ckpt_path=/tmp/v2s/ckpt --device=cpu

bm prints {"fps", "latency_ms"} of predict (the eval preprocess from a
uint8 canvas of eval.isize + 32 plus the forward) at --batch_size: the
best of 3 rounds of --bm_runs calls, CUDA events around each round (a
host clock with a synchronise on the CPU). infer prints the top-5 classes
and their softmax probabilities for --input_image (PIL, imported only
here), from the port's checkpoint directory (--ckpt_path: the params of
its latest step, or its EMA with --use_ema) or, as the JAX CLI's key 0,
run_classification's weights from seed 0. Added here: --device (default
cuda).
Not ported yet, and refused with their ROADMAP item: --runmode=export
(torch.export, inference/driver.py) and --runmode=eval (the TFRecord eval
reader), --tf_ckpt and the JAX package's orbax directories (all M9).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--runmode", default="bm", choices=["bm", "infer", "export",
                                                     "eval"])
  p.add_argument("--model_name", default="efficientnetv2-b0")
  p.add_argument("--ckpt_path", default=None,
                 help="the port's checkpoint directory (model_dir/ckpt)")
  p.add_argument("--tf_ckpt", action="store_true", help="not ported (M9)")
  p.add_argument("--use_ema", action="store_true")
  p.add_argument("--dataset", default=None,
                 help="dataset config overlay (e.g. imagenet21k)")
  p.add_argument("--hparam_str", default="")
  p.add_argument("--batch_size", type=int, default=8)
  p.add_argument("--bm_runs", type=int, default=10)
  p.add_argument("--input_image", default=None)
  p.add_argument("--export_dir", default=None)
  p.add_argument("--val_file_pattern", default=None, help="not ported (M9)")
  p.add_argument("--eval_samples", type=int, default=50000)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  return p.parse_args(argv)


def _refuse_unported(args):
  orbax = args.ckpt_path and os.path.isdir(args.ckpt_path) and any(
      os.path.exists(os.path.join(args.ckpt_path, d, "_CHECKPOINT_METADATA"))
      or os.path.isdir(os.path.join(args.ckpt_path, d, "default"))
      for d in os.listdir(args.ckpt_path))
  unported = [
      (args.runmode == "export", "--runmode=export (torch.export, "
       "inference/driver.py)", "M9"),
      (args.runmode == "eval", "--runmode=eval (the TFRecord eval reader)",
       "M9"),
      (args.tf_ckpt, "--tf_ckpt (ckpt/tf_compat.py)", "M9"),
      (orbax, "an orbax checkpoint of the JAX package", "M9"),
  ]
  for on, what, item in unported:
    if on:
      raise NotImplementedError(
          f"{what} is not ported to automl_tpu_torch yet: ROADMAP {item}")


def load_params(model, ckpt_path: str, use_ema: bool = False) -> dict:
  """The params (or EMA) of the latest step of a port checkpoint directory
  (train/checkpoint.py's <ckpt_path>/<step>/state.pt), copied into the
  model."""
  import torch
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  mngr = CheckpointManager(ckpt_path)
  step = mngr.latest_step()
  if step is None:
    raise FileNotFoundError(f"no checkpoint in {ckpt_path}")
  saved = torch.load(os.path.join(mngr.directory, str(step), "state.pt"),
                     map_location="cpu", weights_only=True)
  params = saved["ema_params"] if use_ema and saved.get("ema_params") \
      else saved["params"]
  model.load_state_dict(params, strict=True)
  return params


def main(argv=None):
  args = parse_args(argv)
  _refuse_unported(args)
  import numpy as np
  import torch
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  from automl_tpu_torch.data import preprocessing
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners

  config = get_model_config(args.model_name)
  if args.dataset:
    from automl_tpu_torch.data import datasets as ds_lib
    config.override(ds_lib.get_dataset_config(args.dataset).as_dict(),
                    allow_new_keys=True)
  config.override(args.hparam_str)
  precision.set_policy("mixed_bfloat16" if config.runtime.mixed_precision
                       else "float32")
  device = torch.device(args.device)
  model = runners.seeded_classification_model(config.model, 0, device)
  if args.ckpt_path:
    load_params(model, args.ckpt_path, args.use_ema)
  model.eval()
  isize = int(config.eval.isize)
  canvas = isize + 32
  # The serving normalization is training's (by the augname).
  norm, _ = preprocessing.norm_for_augname(config.data.get("augname"))

  @torch.no_grad()
  def predict(images):
    x = preprocessing.cls_eval_preprocess(images, isize, norm=norm)
    return model(x, train=False)

  if args.runmode == "bm":
    images = torch.zeros((args.batch_size, canvas, canvas, 3),
                         dtype=torch.uint8, device=device)
    predict(images)
    cuda = device.type == "cuda"
    best = float("inf")
    for _ in range(3):
      if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
      else:
        t0 = time.perf_counter()
      for _ in range(args.bm_runs):
        out = predict(images)
      if cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
      else:
        out.sum().item()
        secs = time.perf_counter() - t0
      best = min(best, secs / args.bm_runs)
    result = {"fps": round(args.batch_size / best, 2),
              "latency_ms": round(best * 1000, 3)}
  else:   # infer
    from PIL import Image
    img = Image.open(args.input_image).convert("RGB").resize((canvas, canvas))
    logits = predict(torch.from_numpy(np.asarray(img).copy())[None].to(
        device))[0].float().cpu()
    probs = torch.softmax(logits, -1).numpy()
    top5 = np.argsort(-logits.numpy())[:5]
    result = {"top5": [[int(i), round(float(probs[i]), 4)] for i in top5]}
  print(json.dumps(result))
  return result


if __name__ == "__main__":
  main()
