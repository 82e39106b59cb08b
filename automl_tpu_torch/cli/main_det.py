"""EfficientDet training CLI on one device (automl_tpu/cli/main_det.py's
flags).

Examples:
  python -m automl_tpu_torch.cli.main_det --mode=train \\
    --model_name=efficientdet-d0 --model_dir=/tmp/d0 --use_fake_data \\
    --train_steps=20 --hparams=mixed_precision=true,batch_size=16
  python -m automl_tpu_torch.cli.main_det --model_name=efficientdet-test \\
    --model_dir=/tmp/det-test --use_fake_data --device=cpu --train_steps=4

Added here: --device (cuda, cuda:N or cpu; default cuda) and --log_every.
Without a train file the synthetic loader is used, as in JAX.
--mode=train_and_eval and --eval_every are accepted: their eval set comes
from --val_file_pattern, whose reader is not ported yet, so they train
only, as JAX does without val files (run_detection's eval_iter takes an
eval set in code). Not ported yet, and refused with their ROADMAP item:
--mode=eval, --val_file_pattern, --testdev_dir and --eval_timeout (M9:
the TFRecord eval reader, watch_checkpoints), --train_file_pattern,
--native_loader, --init_backbone_ckpt, --run_epoch_in_child_process and
--profile (M9), --mesh_shape and the multi-process flags (M10).
--compilation_cache_dir sets XLA's compile cache and has no meaning in
eager PyTorch; it is accepted and ignored.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--mode", default="train",
                 choices=["train", "eval", "train_and_eval"],
                 help="train or train_and_eval (eval: ROADMAP M9)")
  p.add_argument("--model_name", default="efficientdet-d0")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--hparams", default="",
                 help="k=v,k2.k3=v override string or YAML path")
  p.add_argument("--train_file_pattern", default=None, help="not ported (M9)")
  p.add_argument("--val_file_pattern", default=None, help="not ported (M9)")
  p.add_argument("--use_fake_data", action="store_true")
  p.add_argument("--train_steps", type=int, default=0,
                 help="0 -> num_epochs * num_examples_per_epoch / batch_size")
  p.add_argument("--num_examples_per_epoch", type=int, default=120000)
  p.add_argument("--eval_samples", type=int, default=5000)
  p.add_argument("--native_loader", action="store_true",
                 help="not ported (M9)")
  p.add_argument("--native_workers", type=int, default=4)
  p.add_argument("--eval_every", type=int, default=0)
  p.add_argument("--testdev_dir", default=None, help="not ported (M9)")
  p.add_argument("--eval_timeout", type=float, default=0,
                 help="not ported (M9)")
  p.add_argument("--mesh_shape", default=None, help="not ported (M10)")
  p.add_argument("--init_backbone_ckpt", default=None,
                 help="not ported (M9)")
  p.add_argument("--profile", action="store_true", help="not ported (M9)")
  p.add_argument("--run_epoch_in_child_process", action="store_true",
                 help="not ported (M9)")
  p.add_argument("--coordinator_address", default=None,
                 help="not ported (M10)")
  p.add_argument("--num_processes", type=int, default=None)
  p.add_argument("--process_id", type=int, default=None)
  p.add_argument("--compilation_cache_dir", default=None,
                 help="ignored (XLA's cache)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  p.add_argument("--log_every", type=int, default=50,
                 help="steps between metrics.jsonl lines")
  return p.parse_args(argv)


def _refuse_unported(args):
  unported = [
      (args.mode == "eval", "--mode=eval (it reads the eval set's TFRecords)",
       "M9"),
      (args.val_file_pattern, "--val_file_pattern (TFRecord eval input)",
       "M9"),
      (args.testdev_dir, "--testdev_dir (TFRecord eval input)", "M9"),
      (args.eval_timeout, "--eval_timeout (watch_checkpoints)", "M9"),
      (args.train_file_pattern and not args.use_fake_data,
       "--train_file_pattern (TFRecord input)", "M9"),
      (args.native_loader, "--native_loader", "M9"),
      (args.init_backbone_ckpt, "--init_backbone_ckpt", "M9"),
      (args.run_epoch_in_child_process, "--run_epoch_in_child_process",
       "M9"),
      (args.profile, "--profile", "M9"),
      (args.mesh_shape, "--mesh_shape", "M10"),
      (args.coordinator_address or args.num_processes or args.process_id,
       "multi-process training", "M10"),
  ]
  for on, what, item in unported:
    if on:
      raise NotImplementedError(
          f"{what} is not ported to automl_tpu_torch yet: ROADMAP {item}")


def main(argv=None):
  args = parse_args(argv)
  _refuse_unported(args)
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.train import runners

  config = get_efficientdet_config(args.model_name)
  config.override(args.hparams)
  batch_size = int(config.batch_size)
  train_steps = args.train_steps or (
      config.num_epochs * args.num_examples_per_epoch // batch_size)
  eval_every = args.eval_every
  if args.mode == "train_and_eval" and not eval_every:
    eval_every = max(args.num_examples_per_epoch // batch_size, 1)
  # No eval set without --val_file_pattern (M9): train_and_eval trains.
  metrics = runners.run_detection(
      config, args.model_dir, train_steps,
      eval_every=eval_every if args.mode == "train_and_eval" else 0,
      log_every=args.log_every, seed=args.seed, device=args.device)
  print({k: round(v, 4) for k, v in metrics.items()})
  return metrics


if __name__ == "__main__":
  main()
