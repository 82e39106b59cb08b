"""Classification inference and benchmark CLI (automl_tpu/cli/infer_cls.py's
flags).

Examples:
  python -m automl_tpu_torch.cli.infer_cls --model_name=efficientnetv2-b0 \\
    --runmode=bm --batch_size=8
  python -m automl_tpu_torch.cli.infer_cls --runmode=infer \\
    --input_image=cat.jpg --ckpt_path=/tmp/v2s/ckpt --device=cpu
  python -m automl_tpu_torch.cli.infer_cls --runmode=infer --tf_ckpt \\
    --ckpt_path=/ckpts/efficientnetv2-b0/model --use_ema --input_image=cat.jpg
  python -m automl_tpu_torch.cli.infer_cls --runmode=export \\
    --export_dir=/tmp/v2b0-export --batch_size=8

bm prints {"fps", "latency_ms"} of predict (the eval preprocess from a
uint8 canvas of eval.isize + 32 plus the forward) at --batch_size: the
best of 3 rounds of --bm_runs calls, CUDA events around each round (a
host clock with a synchronise on the CPU). infer prints the top-5 classes
and their softmax probabilities for --input_image (PIL, imported only
here), from a checkpoint directory of either package (--ckpt_path: the
params of its latest step, or its EMA with --use_ema; a JAX orbax
directory is read by ckpt/orbax.py), or with --tf_ckpt from a
published TF checkpoint (a prefix or directory, read without TF by
ckpt/tf_compat.py; --use_ema prefers its EMA shadows), or, as the JAX
CLI's key 0, run_classification's weights from seed 0. Added here:
--device (default cuda).
eval prints {"top1", "samples"} over --val_file_pattern (the TF-free
ImageNet reader at eval.isize + 32, the reference's eval crop, the last
partial batch kept) up to --eval_samples, or, for multi-label data
(--dataset=imagenet21k), {"auc_pr", "precision_at_1", ...} of
eval/classification.py::MultiLabelEvaluator.
export saves torch.export's program of predict at uint8 [batch_size,
canvas, canvas, 3] as --export_dir/model.pt2 (JAX writes StableHLO,
model.stablehlo).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from automl_tpu_torch.data import preprocessing


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--runmode", default="bm", choices=["bm", "infer", "export",
                                                     "eval"])
  p.add_argument("--model_name", default="efficientnetv2-b0")
  p.add_argument("--ckpt_path", default=None,
                 help="the port's checkpoint directory (model_dir/ckpt)")
  p.add_argument("--tf_ckpt", action="store_true",
                 help="ckpt_path is a published TF checkpoint")
  p.add_argument("--use_ema", action="store_true")
  p.add_argument("--dataset", default=None,
                 help="dataset config overlay (e.g. imagenet21k)")
  p.add_argument("--hparam_str", default="")
  p.add_argument("--batch_size", type=int, default=8)
  p.add_argument("--bm_runs", type=int, default=10)
  p.add_argument("--input_image", default=None)
  p.add_argument("--export_dir", default=None)
  p.add_argument("--val_file_pattern", default=None)
  p.add_argument("--eval_samples", type=int, default=50000)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  return p.parse_args(argv)


EXPORT_FILE = "model.pt2"


class Predict(torch.nn.Module):
  """uint8 [B, H, W, 3] canvases -> logits: the eval preprocess (centre
  crop, resize to isize, the augname's normalization) and the forward."""

  def __init__(self, model, isize: int, norm: str):
    super().__init__()
    self.model, self.isize, self.norm = model, isize, norm

  def forward(self, images):
    x = preprocessing.cls_eval_preprocess(images, self.isize, norm=self.norm)
    return self.model(x, train=False)


def load_params(model, ckpt_path: str, use_ema: bool = False) -> dict:
  """The params (or EMA) of the latest step of a checkpoint directory of
  either package (train/checkpoint.py's <ckpt_path>/<step>/state.pt, or
  the JAX package's orbax steps), copied into the model."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.train.checkpoint import saved_params
  params = saved_params(ckpt_path, use_ema=use_ema,
                        keys=list(convert.model_state(model)))
  model.load_state_dict(params, strict=True)
  return params


def _eval(args, config, predict, canvas: int, device) -> dict:
  """ImageNet top-1, or the multi-label metrics, over --val_file_pattern
  up to --eval_samples."""
  import numpy as np
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.data.datasets import multihot_on_device
  from automl_tpu_torch.eval.classification import MultiLabelEvaluator
  if not args.val_file_pattern:
    raise ValueError("--runmode=eval needs --val_file_pattern")
  logits_of = lambda batch: predict(torch.from_numpy(batch["image"]).to(
      device)).float().cpu().numpy()
  if config.data.get("multiclass"):
    loader = pipeline.MultiLabelTFRecordLoader(
        args.val_file_pattern, is_training=False, batch_size=args.batch_size,
        canvas_size=canvas, max_labels=int(config.data.get("max_labels", 16)),
        drop_remainder=False)
    ev = MultiLabelEvaluator()
    for batch in loader:
      ev.add_batch(logits_of(batch), multihot_on_device(
          batch["label_ids"], config.data.num_classes).numpy())
      if ev.num_examples >= args.eval_samples:
        break
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in ev.result().items()}
  loader = pipeline.ImageNetTFRecordLoader(
      args.val_file_pattern, is_training=False, batch_size=args.batch_size,
      canvas_size=canvas, num_classes=config.data.num_classes,
      drop_remainder=False)
  correct = total = 0
  for batch in loader:
    pred = np.argmax(logits_of(batch), -1)
    correct += int((pred == np.argmax(batch["label"], -1)).sum())
    total += len(pred)
    if total >= args.eval_samples:
      break
  return {"top1": round(correct / max(total, 1), 4), "samples": total}


def main(argv=None):
  args = parse_args(argv)
  import numpy as np
  from automl_tpu_torch.configs.effnet_configs import get_model_config
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
  if args.ckpt_path and args.tf_ckpt:
    from automl_tpu_torch.ckpt import tf_compat
    tf_compat.convert_effnet_checkpoint(args.ckpt_path, model,
                                        use_ema=args.use_ema)
  elif args.ckpt_path:
    load_params(model, args.ckpt_path, args.use_ema)
  model.eval()
  isize = int(config.eval.isize)
  canvas = isize + 32
  # The serving normalization is training's (by the augname).
  norm, _ = preprocessing.norm_for_augname(config.data.get("augname"))

  program = Predict(model, isize, norm).eval()
  predict = torch.no_grad()(program)

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
  elif args.runmode == "eval":
    result = _eval(args, config, predict, canvas, device)
  elif args.runmode == "export":
    if not args.export_dir:
      raise ValueError("--runmode=export needs --export_dir")
    example = torch.zeros((args.batch_size, canvas, canvas, 3),
                          dtype=torch.uint8, device=device)
    with torch.no_grad():
      exported = torch.export.export(program, (example,))
    os.makedirs(args.export_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(args.export_dir, EXPORT_FILE))
    result = {"export_dir": args.export_dir}
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
