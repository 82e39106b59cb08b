"""EfficientDet train / eval CLI on one device or a mesh
(automl_tpu/cli/main_det.py's flags).

Examples:
  python -m automl_tpu_torch.cli.main_det --mode=train \\
    --model_name=efficientdet-d0 --model_dir=/tmp/d0 --use_fake_data \\
    --train_steps=20 --hparams=mixed_precision=true,batch_size=16
  python -m automl_tpu_torch.cli.main_det --model_name=efficientdet-test \\
    --model_dir=/tmp/det-test --train_file_pattern='/tmp/coco/train-*' \\
    --val_file_pattern='/tmp/coco/val-*' --mode=train_and_eval \\
    --device=cpu --train_steps=4 --eval_samples=8
  python -m automl_tpu_torch.cli.main_det --mode=eval --model_dir=/tmp/d0 \\
    --val_file_pattern='/tmp/coco/val-*' --eval_samples=128

Input: --train_file_pattern through the TF-free reader
(data/pipeline.py::DetectionTFRecordLoader) or, with --native_loader, the
C++ pipeline (--native_workers); without one, synthetic batches. On a CUDA
device the batches are staged by DevicePrefetcher. --mode=eval restores
the latest checkpoint of model_dir/ckpt (or, with --eval_timeout, each new
one until that many seconds pass without one) and evaluates its EMA over
--val_file_pattern (--eval_samples); --testdev_dir writes the COCO-server
JSON instead of AP. --run_epoch_in_child_process runs each epoch (and, in
train_and_eval, each eval) in a child process; this process never touches
CUDA. --profile writes a torch.profiler trace of steps 10-14 into
model_dir/profile/ (JAX writes an xprof trace).

--init_backbone_ckpt starts the backbone from a published TF EfficientNet
checkpoint (read without TF, ckpt/tf_compat.py; its EMA shadows where it
has them).

On a mesh: --mesh_shape=r,d,m (one process per point: run it under
torchrun, or give --coordinator_address / --num_processes / --process_id
to each process); each process reads batch_size / (r x d) rows of every
batch (its share of the files with --native_loader, the TF-free reader's
shard otherwise), and a 'model' axis above 1 splits image H
(train/runners.py). On the card, one process per GPU:
  torchrun --nproc_per_node=1 -m automl_tpu_torch.cli.main_det \
    --model_name=efficientdet-d0 --model_dir=/tmp/d0-mesh --use_fake_data \
    --mesh_shape=1,1,1 --train_steps=10

Added here: --device (cuda, cuda:N or cpu; default cuda) and --log_every.
--compilation_cache_dir sets XLA's compile cache and has no meaning in
eager PyTorch; it is accepted and ignored.
"""

from __future__ import annotations

import argparse
import glob
import subprocess
import sys


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--mode", default="train",
                 choices=["train", "eval", "train_and_eval"])
  p.add_argument("--model_name", default="efficientdet-d0")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--hparams", default="",
                 help="k=v,k2.k3=v override string or YAML path")
  p.add_argument("--train_file_pattern", default=None)
  p.add_argument("--val_file_pattern", default=None)
  p.add_argument("--use_fake_data", action="store_true")
  p.add_argument("--train_steps", type=int, default=0,
                 help="0 -> num_epochs * num_examples_per_epoch / batch_size")
  p.add_argument("--num_examples_per_epoch", type=int, default=120000)
  p.add_argument("--eval_samples", type=int, default=5000)
  p.add_argument("--native_loader", action="store_true",
                 help="the C++ pipeline (reader thread, JPEG worker pool, "
                      "prefetch ring; gt parsed in C++) instead of the "
                      "TF-free reader")
  p.add_argument("--native_workers", type=int, default=4)
  p.add_argument("--eval_every", type=int, default=0,
                 help="steps between in-training evals (train_and_eval)")
  p.add_argument("--testdev_dir", default=None,
                 help="eval mode: write the COCO-server submission JSON "
                      "into this directory instead of computing AP")
  p.add_argument("--eval_timeout", type=float, default=0,
                 help="eval mode: evaluate each new checkpoint until this "
                      "many seconds pass with no new one; 0 = the latest "
                      "once")
  p.add_argument("--mesh_shape", default=None,
                 help="replica,data,model over the world's processes; "
                      "default: no mesh")
  p.add_argument("--init_backbone_ckpt", default=None,
                 help="a TF EfficientNet checkpoint for the backbone")
  p.add_argument("--profile", action="store_true",
                 help="a torch.profiler trace of steps 10-14 into "
                      "model_dir/profile/")
  p.add_argument("--run_epoch_in_child_process", action="store_true",
                 help="each epoch in a fresh child process (resuming from "
                      "the latest checkpoint; a nonzero exit propagates; "
                      "train_and_eval adds an eval child per epoch)")
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


def init_mesh(args):
  """(mesh shape or None, this process's row coordinate, rows of the
  mesh): brings the world up (the multi-process flags, else torchrun's
  environment) and places this process on the mesh's data axes (the
  ranks of 'model' share their rows)."""
  import torch
  from automl_tpu_torch.parallel import distributed
  from automl_tpu_torch.parallel import mesh as mesh_lib
  distributed.initialize(
      args.coordinator_address, args.num_processes, args.process_id,
      backend="nccl" if torch.device(args.device).type == "cuda" else "gloo")
  if not args.mesh_shape:
    return None, 0, 1
  shape = mesh_lib.mesh_shape_for(
      tuple(int(x) for x in args.mesh_shape.split(",")),
      mesh_lib.world_size())
  return (shape, distributed.process_index() // shape[-1],
          mesh_lib.world_size() // shape[-1])


def _shard_files(files, proc_id, n_proc):
  """This process's files; ValueError on an empty shard (rather than
  streaming the whole set, which would repeat data across processes)."""
  mine = files[proc_id::n_proc]
  if not mine:
    raise ValueError(
        f"process {proc_id}/{n_proc} got no input files from {len(files)} "
        "matches: --native_loader shards by file; use at least one file "
        "per process")
  return mine


def _config(args):
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  config = get_efficientdet_config(args.model_name)
  config.override(args.hparams)
  return config


def _train_steps(args, config) -> int:
  return args.train_steps or (
      config.num_epochs * args.num_examples_per_epoch
      // int(config.batch_size))


def _run_epochs_in_children(args):
  """One child process per epoch: each runs this CLI to the epoch's
  cumulative step count and exits (so host-memory leaks die with it),
  resuming from the latest checkpoint; in train_and_eval an eval child
  follows each epoch. This process does config arithmetic only and never
  initialises CUDA, so the children own the card. A child's nonzero exit
  propagates."""
  config = _config(args)
  batch_size = int(config.batch_size)
  train_steps = _train_steps(args, config)
  steps_per_epoch = max(args.num_examples_per_epoch // batch_size, 1)
  epoch_ends = list(range(steps_per_epoch, train_steps, steps_per_epoch))
  epoch_ends.append(train_steps)

  def flags(extra):
    out = [sys.executable, "-m", "automl_tpu_torch.cli.main_det",
           f"--model_dir={args.model_dir}",
           f"--model_name={args.model_name}", f"--seed={args.seed}",
           f"--num_examples_per_epoch={args.num_examples_per_epoch}",
           f"--device={args.device}", f"--log_every={args.log_every}",
           f"--native_workers={args.native_workers}"]
    for name in ("hparams", "train_file_pattern", "val_file_pattern",
                 "init_backbone_ckpt"):
      v = getattr(args, name)
      if v:
        out.append(f"--{name}={v}")
    for name in ("use_fake_data", "native_loader"):
      if getattr(args, name):
        out.append(f"--{name}")
    return out + extra

  do_eval = args.mode == "train_and_eval" and args.val_file_pattern
  for end in epoch_ends:
    rc = subprocess.call(flags(["--mode=train", f"--train_steps={end}"]))
    if rc != 0:
      raise SystemExit(rc)
    if do_eval:
      rc = subprocess.call(flags(
          ["--mode=eval", f"--eval_samples={args.eval_samples}"]))
      if rc != 0:
        raise SystemExit(rc)
  return {"train_steps": float(train_steps)}


def _eval_mode(args, config, eval_iter, eval_steps, device):
  """Evaluates the latest checkpoint of model_dir/ckpt (or, with
  --eval_timeout, each new one) on its EMA parameters; a checkpoint that
  vanishes or is cut short is skipped."""
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  from automl_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 watch_checkpoints)
  precision.set_policy("mixed_bfloat16" if config.mixed_precision
                       else "float32")
  model = runners.seeded_detection_model(config, args.seed, device)
  template, _ = runners.detection_state(model, config)
  mngr = CheckpointManager(f"{args.model_dir}/ckpt")

  def eval_step_num(step):
    params = runners.restore_eval_params(mngr, template, step)
    if params is None:
      return None
    m = runners.evaluate_detection(model, params, config, eval_iter(),
                                   eval_steps, testdev_dir=args.testdev_dir)
    print(f"step {step}:", {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in m.items()})
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
  if args.run_epoch_in_child_process:
    if args.mesh_shape or args.num_processes:
      raise ValueError("--run_epoch_in_child_process runs one process")
    return _run_epochs_in_children(args)
  import torch
  from automl_tpu_torch.data import native_loader, pipeline
  from automl_tpu_torch.ops import anchors
  from automl_tpu_torch.train import runners

  mesh_shape, row, rows = init_mesh(args)
  config = _config(args)
  device = torch.device(args.device)
  batch_size = int(config.batch_size)
  local_batch = runners._local_rows(batch_size, rows)
  train_steps = _train_steps(args, config)
  size = anchors.parse_image_size(config.image_size)

  eval_iter, eval_steps = None, 0
  eval_every = args.eval_every
  if args.mode == "train_and_eval" and not eval_every:
    eval_every = max(args.num_examples_per_epoch // batch_size, 1)
  if args.mode in ("eval", "train_and_eval") and args.val_file_pattern:
    def eval_iter():  # a fresh iterator per eval pass
      return iter(pipeline.DetectionTFRecordLoader(
          args.val_file_pattern, is_training=False, batch_size=local_batch,
          canvas_size=size[0], max_instances=config.max_instances_per_image,
          shard_index=row, num_shards=rows))
    eval_steps = max(args.eval_samples // batch_size, 1)

  if args.mode == "eval":
    if eval_iter is None:
      raise ValueError("--mode=eval needs --val_file_pattern")
    return _eval_mode(args, config, eval_iter, eval_steps, device)

  train_iter = prefetcher = None
  if args.train_file_pattern and not args.use_fake_data:
    if args.native_loader:
      files = _shard_files(sorted(glob.glob(args.train_file_pattern)), row,
                           rows)
      host = native_loader.NativeParallelDetectionLoader(
          files, local_batch, size[0],
          max_instances=config.max_instances_per_image,
          skip_crowd=config.skip_crowd_during_training,
          num_workers=args.native_workers)
    else:
      host = pipeline.DetectionTFRecordLoader(
          args.train_file_pattern, is_training=True, batch_size=local_batch,
          canvas_size=size[0], max_instances=config.max_instances_per_image,
          skip_crowd_during_training=config.skip_crowd_during_training,
          shard_index=row, num_shards=rows, seed=args.seed)
    if device.type == "cuda":
      prefetcher = pipeline.DevicePrefetcher(iter(host), device)
      train_iter = iter(prefetcher)
    else:
      train_iter = iter(host)
  try:
    metrics = runners.run_detection(
        config, args.model_dir, train_steps, mesh_shape=mesh_shape,
        data_iter=train_iter,
        eval_iter=eval_iter, eval_steps=eval_steps,
        eval_every=eval_every if args.mode == "train_and_eval" else 0,
        log_every=args.log_every, init_backbone_ckpt=args.init_backbone_ckpt,
        profile=args.profile, seed=args.seed, device=args.device)
  finally:
    if prefetcher is not None:
      prefetcher.close()
  print({k: round(v, 4) for k, v in metrics.items()})
  return metrics


if __name__ == "__main__":
  main()
