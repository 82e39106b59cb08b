"""EfficientNet / V2 classification training CLI on one device
(automl_tpu/cli/main_cls.py's flags).

Examples:
  python -m automl_tpu_torch.cli.main_cls --model_name=efficientnetv2-s \\
    --model_dir=/tmp/v2s --train_steps=40 \\
    --hparam_str=train.batch_size=128
  python -m automl_tpu_torch.cli.main_cls --model_name=efficientnetv2-test \\
    --model_dir=/tmp/cls-test --train_steps=4 --device=cpu --log_every=1

Added here: --device (cuda, cuda:N or cpu; default cuda) and --log_every.
Data are synthetic (the reference's null-input mode), with a synthetic
minival for --mode=traineval. Not ported yet, and refused with their
ROADMAP item: --mode=eval, --train_file_pattern, --val_file_pattern,
--native_loader, a TFRecord --data_dir (data.data_dir) and --ft_init_ckpt
(M9: the TFRecord readers, watch_checkpoints, ckpt/tf_compat.py),
--mesh_shape and the multi-process flags (M10). --compilation_cache_dir
sets XLA's compile cache and has no meaning in eager PyTorch; it is
accepted and ignored.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--mode", default="train",
                 choices=["train", "traineval", "eval"],
                 help="train or traineval (eval: ROADMAP M9)")
  p.add_argument("--model_name", default="efficientnetv2-b0")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--hparam_str", default="")
  p.add_argument("--dataset", default=None,
                 help="dataset config name (ImageNet, ImageNet21k, "
                      "ImagenetFt, Cifar10Ft, Cifar100Ft, FlowersFt, "
                      "TFFlowersFt, CarsFt)")
  p.add_argument("--data_dir", default=None, help="not ported (M9)")
  p.add_argument("--train_file_pattern", default=None, help="not ported (M9)")
  p.add_argument("--native_loader", action="store_true",
                 help="not ported (M9)")
  p.add_argument("--native_workers", type=int, default=4)
  p.add_argument("--val_file_pattern", default=None, help="not ported (M9)")
  p.add_argument("--eval_samples", type=int, default=50000)
  p.add_argument("--eval_every", type=int, default=0,
                 help="steps between in-training evals (traineval); "
                      "0 = eval at each progressive-stage boundary")
  p.add_argument("--eval_timeout", type=float, default=0,
                 help="not ported (M9)")
  p.add_argument("--ft_init_ckpt", default=None, help="not ported (M9)")
  p.add_argument("--train_steps", type=int, default=0)
  p.add_argument("--mesh_shape", default=None, help="not ported (M10)")
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
      (args.mode == "eval", "--mode=eval (it reads checkpoints against the "
       "eval set's TFRecords)", "M9"),
      (args.train_file_pattern, "--train_file_pattern (TFRecord input)",
       "M9"),
      (args.val_file_pattern, "--val_file_pattern (TFRecord eval input)",
       "M9"),
      (args.native_loader, "--native_loader", "M9"),
      (args.data_dir and args.data_dir != "null",
       "--data_dir (TFRecord input)", "M9"),
      (args.eval_timeout, "--eval_timeout (watch_checkpoints)", "M9"),
      (args.ft_init_ckpt, "--ft_init_ckpt (ckpt/tf_compat.py)", "M9"),
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
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  from automl_tpu_torch.data import datasets as ds_lib
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.train import runners

  config = get_model_config(args.model_name)
  if args.dataset:
    # model config <- dataset config <- hparam_str
    config.override(ds_lib.get_dataset_config(args.dataset).as_dict(),
                    allow_new_keys=True)
  config.override(args.hparam_str)
  batch_size = int(config.train.batch_size)
  spec = ds_lib.DATASETS.get(config.data.ds_name)
  num_images = spec.splits["train"].num_images if spec else 1_281_167
  steps_per_epoch = max(num_images // batch_size, 1)
  train_steps = args.train_steps or max(
      config.train.epochs * steps_per_epoch,
      int(config.train.get("min_steps") or 0))

  eval_iter, eval_steps = None, 0
  if args.mode == "traineval":   # a synthetic minival (null-data mode)
    eval_batch = int(config.eval.batch_size or batch_size)
    ecanvas = (int(config.eval.isize or runners.resolve_train_size(config))
               + 32)

    def eval_iter():  # a fresh iterator per eval pass
      if config.data.get("multiclass"):
        return iter(ds_lib.SyntheticMultiLabel(
            eval_batch, ecanvas, config.data.num_classes,
            int(config.data.get("max_labels", 16))))
      return iter(pipeline.SyntheticClassification(
          eval_batch, ecanvas, config.data.num_classes))
    eval_steps = max(args.eval_samples // eval_batch, 1)

  metrics = runners.run_classification(
      config, args.model_dir, train_steps, eval_iter=eval_iter,
      eval_steps=eval_steps, eval_every=args.eval_every, seed=args.seed,
      log_every=args.log_every, device=args.device)
  print({k: round(v, 4) for k, v in metrics.items()})
  return metrics


if __name__ == "__main__":
  main()
