"""entry(): EfficientDet-D0 inference as one callable, the counterpart of
__graft_entry__.py::entry; dryrun_multichip(n): its multi-device dry run.

  fn, (images,) = entry()               # on the card; entry("cpu") here
  boxes, scores, classes, valid_len = fn(images)

D0 under the mixed_bfloat16 policy (set process-wide, as JAX's entry
does), weights drawn from seed 0 in the JAX layout
(convert.det_numpy_init) or copied from a JAX-layout numpy tree
(convert.load_det_params). fn takes NHWC float32 images, already
normalised as the model expects, and runs the forward in eval mode and
postprocess_global, all on the model's device. The example input is
zeros [1, 512, 512, 3] (the config's image size).

dryrun_multichip(n_devices, device) runs the ten cases of JAX's dry run on
n_devices local processes of one world (parallel/launch.py run_local: gloo
on the CPU, NCCL on the card) at tiny widths, and prints rank 0's ten
lines: detection dp x sp (image H over 'model'), LM dp x tp, tp and sp
serving, dp x SP (ring attention), dp x PP (GPipe), dp x EP (MoE), FSDP,
dp x PP x EP, and a 1536 x 1536 detection forward with H over every rank.

  python -m automl_tpu_torch.entry --dryrun_multichip=4 --device=cpu
"""

from __future__ import annotations

import torch

from automl_tpu_torch import convert
from automl_tpu_torch.models.efficientdet import build_detection_model
from automl_tpu_torch.nn import precision
from automl_tpu_torch.ops import anchors, postprocess


def entry(device=None, params=None, config=None):
  """-> (fn, (example_images,)). device: default "cuda"; params: a
  JAX-layout tree, default det_numpy_init(model, 0); config: an
  EfficientDet config, default efficientdet-d0's (tests take smaller
  ones)."""
  device = torch.device(device or "cuda")
  precision.set_policy("mixed_bfloat16")
  model = build_detection_model(config or "efficientdet-d0", device=device)
  convert.load_det_params(model, params if params is not None
                          else convert.det_numpy_init(model, 0))
  h, w = anchors.parse_image_size(model.config.image_size)
  images = torch.zeros((1, h, w, 3), dtype=torch.float32, device=device)

  @torch.no_grad()
  def forward(images):
    cls_outputs, box_outputs = model(images.permute(0, 3, 1, 2), train=False)
    return postprocess.postprocess_global(model.config, cls_outputs,
                                          box_outputs)

  return forward, (images,)


def _det_dryrun_config(name="efficientdet-d0", **kw):
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  cfg = get_efficientdet_config(name)
  cfg.override(kw, allow_new_keys=True)
  return cfg


def _lm_dryrun_config(**kw):
  from automl_tpu_torch.models import lm as lm_lib
  cfg = lm_lib.lm_defaults()
  cfg.override(dict(dict(vocab_size=64, model_dim=32, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=8, expand_factor=2,
                         seq_len=32, activation_dtype="float32"), **kw),
               allow_new_keys=True)
  return cfg


def _mesh_str(mesh) -> str:
  return str(dict(zip(mesh.mesh_dim_names, mesh.shape)))


def _lm_step(cfg, mesh, sharding=None, seed=0):
  """(loss, model) of one Lion step on the mesh, ones tokens [rows, 33]."""
  import numpy as np
  from automl_tpu_torch.data.lm_pipeline import select_local_batch
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.parallel import distributed
  from automl_tpu_torch.train import lm_trainer
  from automl_tpu_torch.train import optimizers as opt_lib
  model = lm_lib.TransformerLM(cfg, sharding, mesh=mesh)
  convert.load_jax_params(model, convert.numpy_init(cfg, seed))
  tx = opt_lib.build_optimizer("lion", 1e-3)
  step = lm_trainer.make_lm_train_step(model, tx)
  idx, count = distributed.batch_coordinate(mesh)
  rows = 2 * count
  tokens = np.ones((rows, 33), np.int32)
  batch = distributed.build_global_batch(
      select_local_batch({"tokens": tokens}, idx, count), mesh)
  _, logs = step(lm_trainer.init_train_state(model, tx), batch)
  return float(logs["loss"]), model


def _dryrun_cases(n: int, device) -> list:
  """The ten cases on this process's rank of a world of n; their lines."""
  import math

  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.models.efficientdet import EfficientDet
  from automl_tpu_torch.parallel import comm, create_mesh, spatial
  from automl_tpu_torch.parallel import distributed
  from automl_tpu_torch.train import optimizers as opt_lib
  from automl_tpu_torch.train import schedules, train_lib
  lines = []
  say = lambda text: lines.append(f"dryrun_multichip({n}): {text}")
  precision.set_policy("float32")
  sp = 2 if n % 2 == 0 else 1
  dev = device.type
  mesh = create_mesh((1, n // sp, sp), device=dev)
  idx, count = distributed.batch_coordinate(mesh)

  # 1. Detection train step: dp over 'data', image H over 'model'.
  cfg = _det_dryrun_config(image_size=64, fpn_num_filters=16,
                           fpn_cell_repeats=1, box_class_repeats=1,
                           num_classes=3)
  cfg.backbone_config = dict(
      blocks_args=["r1_k3_s1_e1_i8_o8", "r1_k3_s2_e2_i8_o16",
                   "r1_k3_s2_e2_i16_o16", "r1_k3_s2_e2_i16_o24",
                   "r1_k3_s2_e2_i24_o32"],
      feature_size=32, width_coefficient=1.0, depth_coefficient=1.0)
  model = EfficientDet(cfg, device=device)
  convert.load_det_params(model, convert.det_numpy_init(model, 0))
  tx = opt_lib.masked_for_params(opt_lib.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=0.9))
  state = train_lib.create_train_state(model, tx)
  gt = [[8.0, 8.0, 40.0, 40.0]] + [[0.0] * 4] * 3
  batch = {"image": torch.ones((2, 3, 64, 64), device=device).contiguous(
               memory_format=torch.channels_last),
           "gt_boxes": torch.tensor([gt] * 2, device=device),
           "gt_classes": torch.tensor([[1, -1, -1, -1]] * 2, device=device,
                                      dtype=torch.int32)}
  spatial.attach(model, spatial.VisionMesh(mesh, (64, 64), spatial=True))
  _, metrics = train_lib.make_det_train_step(model, tx, cfg)(state, batch)
  loss = float(metrics["loss"])
  assert math.isfinite(loss), metrics
  say(f"detection dp x sp mesh={_mesh_str(mesh)} loss={loss:.4f} OK")

  # 2. LM train step, dp over 'data', tp over 'model' (the GSPMD layout).
  loss, _ = _lm_step(_lm_dryrun_config(n_kv_heads=2), mesh,
                     lm_lib.ShardingConfig(), seed=2)
  assert math.isfinite(loss)
  say(f"LM dp x tp loss={loss:.4f} OK")

  # 3-4. Tensor- and sequence-parallel serving.
  prompt = torch.ones((2, 4), dtype=torch.long, device=device)
  for kind, kw, sharding, seed in (
      ("tp", dict(serve_tp=True), lm_lib.ShardingConfig(), 9),
      ("sp", dict(serve_sp=True, use_ring_attention=True, n_kv_heads=2),
       lm_lib.ShardingConfig.sequence_parallel(), 10)):
    scfg = _lm_dryrun_config(**kw)
    smodel = convert.load_jax_params(
        lm_lib.TransformerLM(scfg, sharding, mesh=mesh),
        convert.numpy_init(scfg, seed))
    out = lm_lib.greedy_generate(smodel, prompt, 4)
    assert tuple(out.shape) == (2, 8), out.shape
    if kind == "tp":
      say("LM tp SERVING (sharded cache + shard_map decode kernel, "
          f"mesh={_mesh_str(mesh)}) OK")
    else:
      say("LM sp SERVING (S-sharded cache + partial-merge decode kernel, "
          f"mesh={_mesh_str(mesh)}) OK")

  # 5. Sequence parallelism: ring attention over 'model'.
  loss, _ = _lm_step(_lm_dryrun_config(use_ring_attention=True), mesh,
                     lm_lib.ShardingConfig.sequence_parallel(), seed=3)
  assert math.isfinite(loss)
  say(f"LM dp x SP (ring attention) loss={loss:.4f} OK")

  # 6. Pipeline parallelism: the layers staged over 'model' (GPipe).
  loss, _ = _lm_step(_lm_dryrun_config(
      n_layers=2 * sp, use_pipeline=True, pipeline_microbatches=2), mesh,
      seed=4)
  assert math.isfinite(loss)
  say(f"LM dp x PP (GPipe) loss={loss:.4f} OK")

  # 7. Expert parallelism: the MoE experts over 'model'.
  loss, _ = _lm_step(_lm_dryrun_config(moe_num_experts=2 * sp, moe_top_k=2),
                     mesh, seed=5)
  assert math.isfinite(loss)
  say(f"LM dp x EP (MoE) loss={loss:.4f} OK")

  # 8. FSDP: weights and optimizer state over 'data'.
  loss, fs_model = _lm_step(_lm_dryrun_config(), mesh,
                            lm_lib.ShardingConfig.fsdp(), seed=8)
  spec = str(fs_model.param_placements()["embed"])
  assert math.isfinite(loss) and "data" in spec, spec
  say("LM FSDP (ZeRO-3 weights+opt over 'data', embed spec "
      f"{spec}) loss={loss:.4f} OK")

  # 9. dp x PP x EP: MoE inside the GPipe-staged stack.
  loss, _ = _lm_step(_lm_dryrun_config(
      n_layers=2 * sp, use_pipeline=True, pipeline_microbatches=2,
      moe_num_experts=2, moe_top_k=2, moe_aux_loss_weight=0.01), mesh,
      seed=6)
  assert math.isfinite(loss)
  say(f"LM dp x PP x EP (MoE through GPipe) loss={loss:.4f} OK")

  # 10. A 1536 x 1536 detection forward, H over every rank.
  hcfg = _det_dryrun_config(image_size=1536, fpn_num_filters=8,
                            fpn_cell_repeats=1, box_class_repeats=1,
                            num_classes=3, max_level=8, anchor_scale=5.0)
  hcfg.backbone_config = dict(
      blocks_args=["r1_k3_s1_e1_i4_o4", "r1_k3_s2_e1_i4_o8",
                   "r1_k3_s2_e1_i8_o8", "r1_k3_s2_e1_i8_o8",
                   "r1_k3_s2_e1_i8_o8"],
      feature_size=8, width_coefficient=1.0, depth_coefficient=1.0)
  hmodel = EfficientDet(hcfg, device=device)
  convert.load_det_params(hmodel, convert.det_numpy_init(hmodel, 7))
  sp_mesh = create_mesh((1, 1, n), device=dev)
  vm = spatial.VisionMesh(sp_mesh, (1536, 1536), spatial=True)
  spatial.attach(hmodel, vm)
  with torch.no_grad():
    images = vm.split(torch.ones((1, 3, 1536, 1536), device=device)
                      .contiguous(memory_format=torch.channels_last))
    cls_out, box_out = hmodel(images, train=False)
    total = sum(vm.to_band(o).float().sum() for o in cls_out + box_out)
    total = float(comm.all_reduce(total.reshape(1), sp_mesh, ("model",))[0])
  assert math.isfinite(total)
  say("detection 1536x1536 spatially sharded (H over 'model', "
      f"{_mesh_str(sp_mesh)}) sum={total:.3e} OK")
  return lines


def _dryrun_worker(n: int, rank: int, store: str, device: str) -> None:
  from automl_tpu_torch.parallel import distributed
  device = torch.device(device)
  if device.type == "cpu":
    torch.set_num_threads(1)
  distributed.initialize(store, n, rank,
                         backend="nccl" if device.type == "cuda" else "gloo",
                         timeout_secs=300)
  if device.type == "cuda":
    device = torch.device("cuda", torch.cuda.current_device())
  lines = _dryrun_cases(n, device)
  if rank == 0:
    print("\n".join(lines), flush=True)
  torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     timeout_secs: float = 600.0) -> list:
  """Runs the ten dry-run cases on n_devices local processes (device:
  default "cuda"; "cpu" for gloo ranks) and prints rank 0's lines; returns
  them. A failing or hung process raises (run_local)."""
  import os
  import sys
  import tempfile

  from automl_tpu_torch.parallel.launch import file_store, run_local
  device = str(device or "cuda")
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join(
      p for p in (root, env.get("PYTHONPATH")) if p)
  with tempfile.TemporaryDirectory() as d:
    store = file_store(d)
    outs = run_local(
        lambda r: [sys.executable, "-m", "automl_tpu_torch.entry",
                   "--dryrun_worker", str(n_devices), str(r), store, device],
        n_devices, timeout_secs, env=env)
  lines = [l for l in outs[0].splitlines() if l.startswith("dryrun_multichip")]
  print("\n".join(lines))
  return lines


if __name__ == "__main__":
  import argparse
  p = argparse.ArgumentParser()
  p.add_argument("--dryrun_multichip", type=int, default=None)
  p.add_argument("--dryrun_worker", nargs=4, default=None)
  p.add_argument("--device", default="cuda")
  a = p.parse_args()
  if a.dryrun_worker:
    n_, r_, store_, dev_ = a.dryrun_worker
    _dryrun_worker(int(n_), int(r_), store_, dev_)
  else:
    dryrun_multichip(a.dryrun_multichip or 1, a.device)
