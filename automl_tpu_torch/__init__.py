"""automl_tpu_torch: the PyTorch / CUDA port of automl_tpu for NVIDIA Hopper.

Importing the package loads torch only: no jax, no automl_tpu, no CUDA
build. Kernels are compiled from csrc/ at their first launch.

Subpackages:
  config    -- dot-dict Config with override-string / YAML layering, and
               the registry of named configs
  configs   -- named EfficientNet and EfficientDet configs
  convert   -- JAX-layout parameter trees (LM, EfficientDet) and training
               states <-> torch
  nn        -- precision policy; vision layers (conv, depthwise, BatchNorm
               with JAX state semantics, SE, drop_connect, pools)
  models    -- decoder-only LM: training (flash attention, remat policies,
               plain / chunked / fused loss) and KV-cached serving (greedy
               / sampled); EfficientNet and EfficientDet
  ops       -- flash attention (forward, fused and split backward), decode
               attention, the fused softmax cross-entropy and the depthwise
               filter gradient: CUDA kernels + plain PyTorch versions; anchors,
               IoU and detection losses
  train     -- LM trainer, detection train step and runner, optimizers,
               schedules, metrics, checkpoints
  data      -- byte tokenizer, document packing, packed batches; synthetic
               detection data and its preprocessing
  cli       -- main_lm, main_det (training), generate_lm
"""

__version__ = "0.1.0"
