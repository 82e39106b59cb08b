"""EfficientNet / V2 classification train / eval CLI on one device
(automl_tpu/cli/main_cls.py's flags).

Examples:
  python -m automl_tpu_torch.cli.main_cls --model_name=efficientnetv2-s \\
    --model_dir=/tmp/v2s --train_steps=40 \\
    --hparam_str=train.batch_size=128
  python -m automl_tpu_torch.cli.main_cls --model_name=efficientnetv2-test \\
    --model_dir=/tmp/cls-test --train_steps=4 --device=cpu --log_every=1
  python -m automl_tpu_torch.cli.main_cls --model_name=efficientnetv2-test \\
    --model_dir=/tmp/cls-test --mode=eval --device=cpu \\
    --val_file_pattern='/tmp/imagenet/validation-*' --eval_samples=64

Input: --train_file_pattern through the TF-free reader
(data/pipeline.py::ImageNetTFRecordLoader) or, with --native_loader, the
C++ pipeline; --dataset with --data_dir, the dataset's files under it
(datasets.build_dataset: the ImageNet or multi-label reader); else
synthetic batches (the reference's null-input mode). On a CUDA device the
batches are staged by DevicePrefetcher. traineval and eval take
--val_file_pattern (or the dataset's eval split under --data_dir, else a
synthetic minival); --mode=eval restores the latest checkpoint of
model_dir/ckpt (or, with --eval_timeout, each new one) and evaluates its
EMA.

--ft_init_ckpt (train.ft_init_ckpt) finetunes from a published TF
checkpoint (read without TF, ckpt/tf_compat.py): every weight but the
head's fc, its EMA shadows with train.ft_init_ema (the default).

Added here: --device (cuda, cuda:N or cpu; default cuda) and --log_every.
On a mesh: --mesh_shape=r,d,m (one process per point: torchrun, or the
multi-process flags); each process reads batch_size / (r x d) rows of
every batch, and the ranks of 'model' compute the same rows
(train/runners.py).
--compilation_cache_dir sets XLA's compile cache and has no meaning in
eager PyTorch; it is accepted and ignored.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--mode", default="train",
                 choices=["train", "traineval", "eval"])
  p.add_argument("--model_name", default="efficientnetv2-b0")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--hparam_str", default="")
  p.add_argument("--dataset", default=None,
                 help="dataset config name (ImageNet, ImageNet21k, "
                      "ImagenetFt, Cifar10Ft, Cifar100Ft, FlowersFt, "
                      "TFFlowersFt, CarsFt)")
  p.add_argument("--data_dir", default=None,
                 help="TFRecord directory of --dataset (None: synthetic)")
  p.add_argument("--train_file_pattern", default=None)
  p.add_argument("--native_loader", action="store_true",
                 help="the C++ pipeline (reader thread, JPEG worker pool, "
                      "prefetch ring) for --train_file_pattern")
  p.add_argument("--native_workers", type=int, default=4)
  p.add_argument("--val_file_pattern", default=None)
  p.add_argument("--eval_samples", type=int, default=50000)
  p.add_argument("--eval_every", type=int, default=0,
                 help="steps between in-training evals (traineval); "
                      "0 = eval at each progressive-stage boundary")
  p.add_argument("--eval_timeout", type=float, default=0,
                 help="eval mode: evaluate each new checkpoint until this "
                      "many seconds pass with no new one; 0 = the latest "
                      "once")
  p.add_argument("--ft_init_ckpt", default=None,
                 help="a TF checkpoint to finetune from (head excluded)")
  p.add_argument("--train_steps", type=int, default=0)
  p.add_argument("--mesh_shape", default=None,
                 help="replica,data,model over the world's processes; "
                      "default: no mesh")
  p.add_argument("--coordinator_address", default=None,
                 help="host:port or file:// rendezvous of a multi-process "
                      "run (default: torchrun's environment)")
  p.add_argument("--num_processes", type=int, default=None)
  p.add_argument("--process_id", type=int, default=None)
  p.add_argument("--compilation_cache_dir", default=None,
                 help="ignored (XLA's cache)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  p.add_argument("--log_every", type=int, default=50,
                 help="steps between metrics.jsonl lines")
  return p.parse_args(argv)


def _eval_mode(args, config, eval_iter, eval_steps, device):
  """Evaluates the latest checkpoint of model_dir/ckpt (or, with
  --eval_timeout, each new one) on its EMA parameters; a checkpoint that
  vanishes or is cut short is skipped."""
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  from automl_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 watch_checkpoints)
  precision.set_policy("mixed_bfloat16" if config.runtime.mixed_precision
                       else "float32")
  model = runners.seeded_classification_model(config.model, args.seed,
                                              device)
  template, _ = runners.classification_state(model, config)
  mngr = CheckpointManager(f"{args.model_dir}/ckpt")

  def eval_step_num(step):
    params = runners.restore_eval_params(mngr, template, step)
    if params is None:
      return None
    m = runners.evaluate_classification(model, params, config, eval_iter(),
                                        eval_steps)
    print(f"step {step}:", {k: round(float(v), 4) for k, v in m.items()})
    return m

  metrics = None
  if args.eval_timeout:
    for step in watch_checkpoints(mngr.directory,
                                  timeout_secs=args.eval_timeout,
                                  poll_secs=min(10.0, args.eval_timeout / 5)):
      metrics = eval_step_num(step) or metrics
  else:
    metrics = eval_step_num(mngr.latest_step())
  if metrics is None:
    raise FileNotFoundError(f"no checkpoint in {args.model_dir}/ckpt")
  return metrics


def main(argv=None):
  args = parse_args(argv)
  import glob

  import torch
  from automl_tpu_torch.cli.main_det import _shard_files, init_mesh
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  from automl_tpu_torch.data import datasets as ds_lib
  from automl_tpu_torch.data import native_loader, pipeline
  from automl_tpu_torch.train import runners

  mesh_shape, row, rows = init_mesh(args)

  config = get_model_config(args.model_name)
  if args.dataset:
    # model config <- dataset config <- hparam_str
    config.override(ds_lib.get_dataset_config(args.dataset).as_dict(),
                    allow_new_keys=True)
  config.override(args.hparam_str)
  if args.ft_init_ckpt:
    config.train.ft_init_ckpt = args.ft_init_ckpt
  if args.data_dir:
    config.data.data_dir = args.data_dir
  device = torch.device(args.device)
  batch_size = int(config.train.batch_size)
  local_batch = runners._local_rows(batch_size, rows)
  spec = ds_lib.DATASETS.get(config.data.ds_name)
  num_images = spec.splits["train"].num_images if spec else 1_281_167
  steps_per_epoch = max(num_images // batch_size, 1)
  train_steps = args.train_steps or max(
      config.train.epochs * steps_per_epoch,
      int(config.train.get("min_steps") or 0))

  host = None
  canvas = int(runners.resolve_train_size(config) * 1.15) // 2 * 2
  if args.train_file_pattern and config.data.ds_name != "null":
    if args.native_loader:
      files = _shard_files(sorted(glob.glob(args.train_file_pattern)), row,
                           rows)
      host = native_loader.NativeParallelClassificationLoader(
          files, local_batch, canvas, config.data.num_classes,
          num_workers=args.native_workers)
    else:
      host = pipeline.ImageNetTFRecordLoader(
          args.train_file_pattern, is_training=True, batch_size=local_batch,
          canvas_size=canvas, num_classes=config.data.num_classes,
          shard_index=row, num_shards=rows, seed=args.seed)
  elif args.data_dir and spec is not None:
    host = ds_lib.build_dataset(config, "train", local_batch,
                                canvas_size=canvas, seed=args.seed)

  eval_iter, eval_steps = None, 0
  if args.mode in ("traineval", "eval"):
    eval_batch = int(config.eval.batch_size or batch_size)
    ecanvas = (int(config.eval.isize or runners.resolve_train_size(config))
               + 32)
    if args.val_file_pattern:
      def eval_iter():  # a fresh iterator per eval pass
        if config.data.get("multiclass"):
          return iter(pipeline.MultiLabelTFRecordLoader(
              args.val_file_pattern, is_training=False,
              batch_size=eval_batch, canvas_size=ecanvas,
              max_labels=int(config.data.get("max_labels", 16))))
        return iter(pipeline.ImageNetTFRecordLoader(
            args.val_file_pattern, is_training=False, batch_size=eval_batch,
            canvas_size=ecanvas, num_classes=config.data.num_classes))
    elif args.data_dir and spec is not None and "eval" in spec.splits:
      def eval_iter():
        return iter(ds_lib.build_dataset(config, "eval", eval_batch,
                                         canvas_size=ecanvas))
    else:   # a synthetic minival (the null-data mode)
      def eval_iter():
        if config.data.get("multiclass"):
          return iter(ds_lib.SyntheticMultiLabel(
              eval_batch, ecanvas, config.data.num_classes,
              int(config.data.get("max_labels", 16))))
        return iter(pipeline.SyntheticClassification(
            eval_batch, ecanvas, config.data.num_classes))
    eval_steps = max(args.eval_samples // eval_batch, 1)

  if args.mode == "eval":
    return _eval_mode(args, config, eval_iter, eval_steps, device)

  data_iter = prefetcher = None
  if host is not None:
    if device.type == "cuda":
      prefetcher = pipeline.DevicePrefetcher(iter(host), device)
      data_iter = iter(prefetcher)
    else:
      data_iter = iter(host)
  try:
    metrics = runners.run_classification(
        config, args.model_dir, train_steps, mesh_shape=mesh_shape,
        data_iter=data_iter,
        eval_iter=eval_iter, eval_steps=eval_steps,
        eval_every=args.eval_every, seed=args.seed,
        log_every=args.log_every, device=args.device)
  finally:
    if prefetcher is not None:
      prefetcher.close()
  print({k: round(v, 4) for k, v in metrics.items()})
  return metrics


if __name__ == "__main__":
  main()
