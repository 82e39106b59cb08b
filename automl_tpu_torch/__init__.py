"""automl_tpu_torch: the PyTorch / CUDA port of automl_tpu for NVIDIA Hopper.

Importing the package loads torch only: no jax, no automl_tpu, no CUDA
build. Kernels are compiled from csrc/ at their first launch.

Subpackages:
  config    -- dot-dict Config with override-string / YAML layering, and
               the registry of named configs
  configs   -- named EfficientNet and EfficientDet configs
  convert   -- JAX-layout parameter trees (LM, EfficientDet) and training
               states <-> torch
  nn        -- precision policy; vision layers (conv, depthwise, transposed
               conv, BatchNorm with JAX state semantics, GroupNorm, SE,
               drop_connect, pools); QAT fake-quant (quant)
  models    -- decoder-only LM: training (flash attention, remat policies,
               plain / chunked / fused loss) and KV-cached serving (greedy
               / sampled); EfficientNet and EfficientDet (detection and
               segmentation heads)
  ops       -- flash attention (forward, fused and split backward), decode
               attention, the fused softmax cross-entropy and the depthwise
               filter gradient: CUDA kernels + plain PyTorch versions; anchors,
               IoU and detection losses
  train     -- LM trainer, detection, segmentation and classification
               train steps and runners, optimizers, schedules, metrics,
               checkpoints
  search    -- symbolic optimizer programs (parse, execute, abstract
               execution, mutation, hashes), programs as optimizers, and
               regularized evolution
  data      -- byte tokenizer, document packing, packed batches; synthetic
               detection data and its preprocessing; the TF-free TFRecord
               readers and the native C++ loader
  ckpt      -- published TF checkpoints, read without TensorFlow
               (tf_bundle) and mapped onto the models (tf_compat); the
               JAX package's orbax run directories, read and written
               without orbax or tensorstore (orbax, ocdbt, zstd)
  inference -- detection serving (ServingDriver / InferenceDriver, export
               with torch.export), drawing and label maps
  cli       -- main_lm, main_det, main_cls (training), generate_lm,
               infer_cls, inspector, inspect_tfrecords, the TFRecord
               converters
"""

__version__ = "0.1.0"
