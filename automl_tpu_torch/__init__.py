"""automl_tpu_torch: the PyTorch / CUDA port of automl_tpu for NVIDIA Hopper.

Importing the package loads torch only: no jax, no automl_tpu, no CUDA
build. Kernels are compiled from csrc/ at their first launch.

Subpackages:
  config    -- dot-dict Config with override-string / YAML layering
  convert   -- JAX-layout parameter trees / Lion states <-> torch
  models    -- decoder-only LM: training (flash attention, remat, loss) and
               KV-cached serving (greedy / sampled)
  ops       -- flash attention (forward, fused backward) and decode
               attention: CUDA kernels + plain PyTorch versions
  train     -- LM trainer, optimizers, lm_lr, metrics, checkpoints
  data      -- byte tokenizer, document packing, packed batches
  cli       -- main_lm (training), generate_lm
"""

__version__ = "0.1.0"
