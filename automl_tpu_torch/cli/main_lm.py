"""LM training CLI on one device or a mesh (automl_tpu/cli/main_lm.py's
flags).

Examples:
  python -m automl_tpu_torch.cli.main_lm --model_dir=/tmp/lm \\
    --config_name=lm-flops1e19 --experiment_config=use_flash_attention=true \\
    --batch_size=8 --train_steps=30 --warmup_steps=3
  python -m automl_tpu_torch.cli.main_lm --model_dir=/tmp/lm-test \\
    --config_name=lm-test --device=cpu --train_steps=8 --log_every=1

  python -m automl_tpu_torch.cli.main_lm --model_dir=/tmp/lm-prefix \
    --config_name=lm-test --device=cpu --prefix_lm --tokenizer=spm.model \
    --train_file=train.tsv --valid_file=valid.tsv --train_steps=8

On a mesh: --mesh_shape=r,d,m (one process per point: run it under
torchrun, or give --coordinator_address / --num_processes / --process_id
to each process), --dcn_mesh_shape folded into it, and
--sharding_config=gspmd|dp|sp|fsdp (sp turns use_ring_attention on, as in
JAX):

  torchrun --nproc_per_node=2 -m automl_tpu_torch.cli.main_lm \
    --model_dir=/tmp/lm-dp --config_name=lm-flops1e19 --mesh_shape=1,2,1 \
    --sharding_config=gspmd --experiment_config=use_flash_attention=true

Added here: --device (cuda, cuda:N or cpu; default cuda; a CPU mesh runs
on gloo, a CUDA one on NCCL) and --log_every.
--compilation_cache_dir sets XLA's compile cache and has no meaning in
eager PyTorch; it is accepted and ignored.

--model_dir may be a run directory of the JAX package's main_lm: its
latest orbax checkpoint is resumed and the run goes on there.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--model_dir", required=True)
  p.add_argument("--config_name", default="",
                 help="named experiment config (lm-flops2e17/1e18/1e19, "
                      "lm-test)")
  p.add_argument("--experiment_config", default="",
                 help="override string onto lm_defaults()")
  p.add_argument("--sharding_config", default="gspmd",
                 choices=["gspmd", "dp", "sp", "fsdp"],
                 help="the PartitionSpecs of the parameters and activations "
                      "on the mesh (sp: sequence-parallel, with ring "
                      "attention)")
  p.add_argument("--mesh_shape", default=None,
                 help="replica,data,model (one -1 takes the rest of the "
                      "world); default: no mesh")
  p.add_argument("--dcn_mesh_shape", default=None,
                 help="DCN factors folded into --mesh_shape's axes")
  p.add_argument("--coordinator_address", default=None,
                 help="host:port (or a file:// URL) of the rendezvous of a "
                      "multi-process run; default: the JAX_* or torchrun "
                      "environment")
  p.add_argument("--num_processes", type=int, default=None)
  p.add_argument("--process_id", type=int, default=None)
  p.add_argument("--train_steps", type=int, default=None,
                 help="default: config.num_train_steps")
  p.add_argument("--learning_rate", type=float, default=None)
  p.add_argument("--optimizer", default=None)
  p.add_argument("--prefix_lm", action="store_true",
                 help="read --train_file / --valid_file lines as "
                      "input<TAB>target pairs and train a prefix-LM "
                      "(attention both ways within the inputs, the loss on "
                      "the targets)")
  p.add_argument("--train_file", default=None,
                 help="text file of documents (blank-line separated); "
                      "default: synthetic copy-task data")
  p.add_argument("--valid_file", default=None,
                 help="held-out text file for periodic validation")
  p.add_argument("--tokenizer", default="byte",
                 help="'byte' or the path of a SentencePiece .model")
  p.add_argument("--lr_schedule", default=None,
                 choices=[None, "cosine_decay", "constant"])
  p.add_argument("--warmup_steps", type=int, default=None,
                 help="0 = auto (min(1000, steps/10))")
  p.add_argument("--eval_every", type=int, default=None,
                 help="validation interval in steps (0 = off)")
  p.add_argument("--eval_steps", type=int, default=None)
  p.add_argument("--ckpt_every", type=int, default=0)
  p.add_argument("--deep_diagnostics", action="store_true",
                 help="log global+per-param norm/rms of weights/grads/"
                      "updates")
  p.add_argument("--batch_size", type=int, default=None)
  p.add_argument("--compilation_cache_dir", default=None,
                 help="ignored (XLA's cache)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  p.add_argument("--log_every", type=int, default=20,
                 help="steps between metrics.jsonl lines")
  return p.parse_args(argv)


def main(argv=None):
  args = parse_args(argv)
  import torch
  from automl_tpu_torch.parallel import distributed
  distributed.initialize(
      args.coordinator_address, args.num_processes, args.process_id,
      backend="nccl" if torch.device(args.device).type == "cuda" else "gloo")
  from automl_tpu_torch.data.lm_pipeline import (ByteTokenizer,
                                                 PackedLMLoader,
                                                 PrefixLMLoader,
                                                 SentencePieceModel)
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer

  config = lm_lib.get_lm_config(args.config_name)
  config.override(args.experiment_config)
  # CLI flags (when given) take precedence over the named config's values.
  for flag, key in [("train_steps", "num_train_steps"),
                    ("learning_rate", "learning_rate"),
                    ("optimizer", "optimizer"),
                    ("lr_schedule", "lr_schedule"),
                    ("warmup_steps", "warmup_steps"),
                    ("eval_every", "eval_every"),
                    ("eval_steps", "eval_steps"),
                    ("batch_size", "batch_size")]:
    v = getattr(args, flag)
    if v is not None:
      config[key] = v
  sharding = {"gspmd": lm_lib.ShardingConfig,
              "dp": lm_lib.ShardingConfig.data_parallel,
              "sp": lm_lib.ShardingConfig.sequence_parallel,
              "fsdp": lm_lib.ShardingConfig.fsdp}[args.sharding_config]()
  if args.sharding_config == "sp":
    config.use_ring_attention = True
  shape = lambda flag: (tuple(int(x) for x in flag.split(",")) if flag
                        else None)
  data_iter = None
  eval_iter = None
  if args.train_file:
    tok = (ByteTokenizer() if args.tokenizer == "byte"
           else SentencePieceModel(args.tokenizer))
    config.vocab_size = max(config.vocab_size, tok.vocab_size)
    loader = (PrefixLMLoader.from_tsv_file if args.prefix_lm
              else PackedLMLoader.from_text_file)
    data_iter = iter(loader(args.train_file, config.batch_size,
                            config.seq_len, tokenizer=tok))
    if args.valid_file:
      eval_iter = loader(args.valid_file, config.batch_size, config.seq_len,
                         tokenizer=tok, repeat=False)
  logs = lm_trainer.run_lm(
      config, args.model_dir, config.num_train_steps, sharding=sharding,
      mesh_shape=shape(args.mesh_shape),
      dcn_mesh_shape=shape(args.dcn_mesh_shape), data_iter=data_iter,
      log_every=args.log_every, learning_rate=config.learning_rate,
      lr_schedule=config.lr_schedule, warmup_steps=config.warmup_steps,
      eval_iter=eval_iter, eval_every=config.eval_every,
      eval_steps=config.eval_steps, ckpt_every=args.ckpt_every,
      deep_diagnostics=args.deep_diagnostics,
      optimizer=config.optimizer, seed=args.seed, device=args.device)
  if distributed.process_index() == 0:
    print({k: round(v, 4) for k, v in logs.items()
           if not k.startswith("diag/")})
  return logs


if __name__ == "__main__":
  main()
