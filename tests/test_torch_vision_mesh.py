"""automl_tpu_torch's vision meshes on gloo ranks: grouped BatchNorm
moments, the detection step with data parallelism and spatial partitioning
(image H over 'model', halo exchange, the plain K6 on each band), the
classification step, the runners and the multi-process evals, held against
automl_tpu on as many of the 8 simulated CPU devices (tests/conftest.py)
on the same mesh shapes, and dryrun_multichip(4)'s ten lines.

Two launches of gloo processes (parallel/launch.py): 2 ranks for the
meshes (1, 2, 1) and (1, 1, 2) and the evals, 4 ranks for (1, 2, 2),
(1, 1, 4) and the grouped moments. The workers import no JAX; each saves
what it computed, and the tests compare:

  * the detection train step of efficientdet-test (K6 knob on) on
    (1, 2, 1), (1, 1, 2), (1, 2, 2) and (1, 1, 4) against JAX's on the
    global batch, and on (1, 1, 2) also against JAX's jitted on the same
    mesh with the image sharded P(('replica', 'data'), 'model'): metrics
    rtol 1e-5, the parameters, BN statistics and EMA atol 2e-5 (rtol
    1e-4; the teacher-forced step limits of tests/test_torch_det.py). On
    (1, 1, 2) levels 6 and 7 have 1 row for 2 ranks and on (1, 1, 4)
    level 5 has 2 rows for 4: those maps are gathered and computed whole;
  * the classification step of efficientnetv2-test on (1, 2, 1) against
    JAX's on the same mesh (metrics rtol 1e-5, state atol 1e-6);
  * run_detection through the mesh (1, 2, 2) against the same run in one
    process (its preprocessing made deterministic): the loss rtol 1e-5,
    rank 0's checkpoint within 2e-5;
  * evaluate_classification and evaluate_detection on 2 processes against
    one process and against JAX's: equal metrics;
  * main_det and main_cls refuse a batch that does not split over the
    mesh's data rows.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

GT_BOXES = np.array([[[4.3, 5.1, 40.7, 38.2], [20.1, 30.5, 50.2, 60.3],
                      [0, 0, 0, 0]],
                     [[10.9, 2.7, 38.1, 31.3], [33.3, 25.1, 61.8, 57.9],
                      [8.0, 40.0, 30.0, 63.0]]] * 2, np.float32)
GT_CLASSES = np.array([[1, 3, -1], [2, 1, 3]] * 2, np.int32)
DET_MESHES = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 2, 2), (1, 1, 4)]}
CLS_OVERRIDES = {"model": {"dropout_rate": 0.0, "survival_prob": 1.0},
                 "train": {"lr_warmup_epoch": 0}}
STEP_TOL = dict(atol=2e-5, rtol=1e-4)


def _det_batch():
  rng = np.random.default_rng(9)
  return (rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
          GT_BOXES, GT_CLASSES)


def _cls_batch():
  rng = np.random.default_rng(3)
  image = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
  label = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)]
  return image, label


def _perturbed(tree, seed):
  """The BN leaves and fusion weights of a det_numpy_init tree perturbed."""
  rng = np.random.default_rng(seed + 100)

  def walk(node):
    for leaf, v in node.items():
      if isinstance(v, dict):
        walk(v)
        continue
      noise = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
      if leaf in ("gamma", "wsm"):
        node[leaf] = 1.0 + noise
      elif leaf in ("beta", "moving_mean"):
        node[leaf] = noise
      elif leaf == "moving_variance":
        node[leaf] = 1.0 + np.abs(noise)
  walk(tree)
  return tree


def _det_parts():
  from automl_tpu_torch import convert
  from automl_tpu_torch.configs import efficientdet_configs as cfgs
  from automl_tpu_torch.models import efficientdet as tdet
  from automl_tpu_torch.train import optimizers, schedules, train_lib
  cfg = cfgs.get_efficientdet_config("efficientdet-test")
  model = tdet.EfficientDet(cfg)
  tree = _perturbed(convert.det_numpy_init(model, 0), 0)
  convert.load_det_params(model, tree)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=0.9))
  return cfg, model, tree, train_lib.create_train_state(model, tx), \
      train_lib.make_det_train_step(model, tx, cfg)


def _cls_parts():
  from automl_tpu_torch import convert
  from automl_tpu_torch.configs import effnet_configs as cfgs
  from automl_tpu_torch.models import efficientnet as teff
  from automl_tpu_torch.train import optimizers, schedules, train_lib
  cfg = cfgs.get_model_config("efficientnetv2-test")
  cfg.override(CLS_OVERRIDES)
  model = teff.EfficientNet(cfg.model)
  tree = _perturbed(convert.det_numpy_init(model, 1), 1)
  convert.load_det_params(model, tree)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      cfg.train.optimizer, schedules.warmup_lr(
          cfg.train.lr_sched, cfg.train.lr_base, steps_per_epoch=4,
          total_steps=8, warmup_epochs=0,
          decay_epochs=cfg.train.lr_decay_epoch,
          decay_factor=cfg.train.lr_decay_factor,
          minimal_lr=cfg.train.lr_min)))
  return cfg, model, tree, train_lib.create_train_state(model, tx, ema=True), \
      train_lib.make_cls_train_step(model, tx, cfg)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                          ).contiguous(memory_format=torch.channels_last)


def _state(st):
  return {"params": {k: v.detach().clone() for k, v in st.params.items()},
          "ema": {k: v.detach().clone() for k, v in st.ema_params.items()}
          if st.ema_params is not None else None}


def _eval_batches(kind):
  from automl_tpu_torch.data import pipeline
  it = (pipeline.SyntheticDetection(4, 64, 3, 3, seed=5) if kind == "det"
        else pipeline.SyntheticClassification(4, 48, 4, seed=5))
  return [next(iter(it)) for _ in range(2)]


def _rows(batch, idx, count):
  per = 4 // count
  return {k: v[idx * per:(idx + 1) * per] for k, v in batch.items()}


def _evals(mesh, idx, count):
  from automl_tpu_torch.configs import efficientdet_configs as dcfgs
  from automl_tpu_torch.configs import effnet_configs as ccfgs
  from automl_tpu_torch.train import runners
  out = {}
  dcfg = dcfgs.get_efficientdet_config("efficientdet-test")
  dm = runners.seeded_detection_model(dcfg, 0, "cpu")
  out["det"] = runners.evaluate_detection(
      dm, dict(dm.state_dict(keep_vars=True)), dcfg,
      iter([_rows(b, idx, count) for b in _eval_batches("det")]), 2,
      mesh=mesh)
  ccfg = ccfgs.get_model_config("efficientnetv2-test")
  ccfg.eval.isize = 32
  cm = runners.seeded_classification_model(ccfg.model, 0, "cpu")
  out["cls"] = runners.evaluate_classification(
      cm, dict(cm.state_dict(keep_vars=True)), ccfg,
      iter([_rows(b, idx, count) for b in _eval_batches("cls")]), 2,
      mesh=mesh)
  return out


def _worker(rank, world, store, out):
  torch.set_num_threads(1)
  from automl_tpu_torch.nn import layers as L
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise
  from automl_tpu_torch.parallel import create_mesh, distributed, spatial
  distributed.initialize(store, world, rank, backend="gloo",
                         timeout_secs=60)
  precision.set_policy("float32")
  res = {}
  image, boxes, classes = _det_batch()
  batch = {"image": _nchw(image), "gt_boxes": torch.from_numpy(boxes),
           "gt_classes": torch.from_numpy(classes)}
  depthwise.enable_pallas_filter_grad(True)
  calls = []
  ref = depthwise.depthwise_filter_grad_reference
  depthwise.depthwise_filter_grad_reference = (
      lambda *a: calls.append(tuple(a[0].shape)) or ref(*a))
  for shape in DET_MESHES[world]:
    mesh = create_mesh(shape, device="cpu")
    idx, count = distributed.batch_coordinate(mesh)
    _, model, _, state, step = _det_parts()
    spatial.attach(model, spatial.VisionMesh(mesh, (64, 64),
                                             spatial=shape[2] > 1))
    calls.clear()
    state, metrics = step(state, _rows(batch, idx, count))
    res[shape] = dict(_state(state), k6=list(calls),
                      metrics={k: float(v) for k, v in metrics.items()})
  depthwise.depthwise_filter_grad_reference = ref
  depthwise.enable_pallas_filter_grad(False)
  if world == 2:
    mesh = create_mesh((1, 2, 1), device="cpu")
    idx, count = distributed.batch_coordinate(mesh)
    _, model, _, state, step = _cls_parts()
    image, label = _cls_batch()
    spatial.attach(model, spatial.VisionMesh(mesh))
    state, metrics = step(state, _rows({"image": _nchw(image),
                                        "label": torch.from_numpy(label)},
                                       idx, count))
    res["cls"] = dict(_state(state),
                      metrics={k: float(v) for k, v in metrics.items()})
    res["evals"] = _evals(mesh, idx, count)
  else:
    # Grouped moments: 4 ranks on 'data' in groups of 2 (rank r's rows
    # hold the value r), and the runner on (1, 2, 2).
    mesh = create_mesh((1, 4, 1), device="cpu")
    bn = L.BatchNorm(2, axis_name="data", group_size=2, mesh=mesh)
    x = torch.from_numpy(_bn_input()[rank:rank + 1].transpose(0, 3, 1, 2)
                         ).contiguous().requires_grad_(True)
    y = bn(x, train=True)
    w = torch.from_numpy(_bn_weight()[rank:rank + 1].transpose(0, 3, 1, 2))
    (y * w).sum().backward()
    res["bn"] = {"y": y.detach(), "dx": x.grad,
                 "moving": [t.clone() for t in bn.pending_update]}
    res["runner"] = _runner(out, rank)
  torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _bn_input():
  """[4, 4, 4, 2] NHWC: device r's rows r plus a pattern."""
  rng = np.random.default_rng(4)
  return (np.arange(4.0)[:, None, None, None]
          + 0.3 * rng.standard_normal((4, 4, 4, 2))).astype(np.float32)


def _bn_weight():
  return np.random.default_rng(5).standard_normal((4, 4, 4, 2)).astype(
      np.float32)


def _det_runner_cfg():
  from automl_tpu_torch.configs import efficientdet_configs as cfgs
  cfg = cfgs.get_efficientdet_config("efficientdet-test")
  cfg.override(dict(jitter_min=1.0, jitter_max=1.0, input_rand_hflip=False,
                    batch_size=4, mixed_precision=False))
  return cfg


def _runner_batches():
  from automl_tpu_torch.data import pipeline
  return [next(iter(pipeline.SyntheticDetection(4, 64, 3, 3, seed=2)))]


def _runner(out, rank):
  """One run_detection step on (1, 2, 2): (metrics, rank 0's checkpoint)."""
  from automl_tpu_torch.parallel import distributed
  from automl_tpu_torch.parallel.mesh import create_mesh
  from automl_tpu_torch.train import runners
  mesh = create_mesh((1, 2, 2), device="cpu")
  idx, count = distributed.batch_coordinate(mesh)
  d = os.path.join(out, "det_run")
  m = runners.run_detection(
      _det_runner_cfg(), d, 1, mesh_shape=(1, 2, 2),
      data_iter=iter([_rows(b, idx, count) for b in _runner_batches()]),
      log_every=1, device="cpu")
  ckpt = (torch.load(os.path.join(d, "ckpt", "1", "state.pt"),
                     weights_only=True)["params"] if rank == 0 else None)
  return {"metrics": m, "ckpt": ckpt,
          "files": sorted(os.listdir(d)) if rank == 0 else None}


def _launch(tmp_path_factory, world):
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = tmp_path_factory.mktemp(f"vision{world}")
  store = file_store(str(d))
  env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  run_local(lambda r: [sys.executable, __file__, str(r), str(world), store,
                       str(d)], world, timeout_secs=240, env=env)
  return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
  return _launch(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
  return _launch(tmp_path_factory, 4)


@pytest.fixture
def f32(monkeypatch):
  from automl_tpu import nn as jnn
  from automl_tpu.nn import layers as jlayers
  from automl_tpu_torch.nn import precision
  monkeypatch.setattr(jlayers, "drop_connect", lambda x, *a, **k: x)
  monkeypatch.setattr(jlayers, "drop_connect_with_key", lambda x, *a, **k: x)
  jnn.set_policy("float32")
  precision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    precision.set_policy("mixed_bfloat16")


def _jmesh(shape):
  import jax
  from automl_tpu.parallel import create_mesh as jcreate
  return jcreate(shape, devices=jax.devices()[:int(np.prod(shape))])


def _close(got: dict, want: dict, what, **tol):
  from automl_tpu_torch import convert
  want = {k: np.asarray(v) for k, v in
          convert.flatten_tree(want).items() if hasattr(v, "shape")}
  got = {k: np.asarray(v) for k, v in got.items() if hasattr(v, "shape")}
  assert set(got) == set(want), what
  for k in want:
    np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}: {k}",
                               **tol)


def _jax_det_step(shape=None):
  """JAX's det train step state after one step: on `shape`'s mesh with the
  image sharded P(('replica', 'data'), 'model') (rows only off 'model'),
  or with no mesh (None)."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import NamedSharding, PartitionSpec as JP
  from automl_tpu.configs import efficientdet_configs as jcfgs
  from automl_tpu.models import efficientdet as jdet
  from automl_tpu.parallel import replicate
  from automl_tpu.train import optimizers as jopt
  from automl_tpu.train import schedules as jsched
  from automl_tpu.train import train_lib as jtrain
  _, _, tree, _, _ = _det_parts()
  jcfg = jcfgs.get_efficientdet_config("efficientdet-test")
  jm = jdet.EfficientDet(jcfg)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  jtx = jopt.masked_for_params(jopt.build_optimizer(
      "momentum", jsched.detection_lr(jcfg, 1), momentum=0.9), jparams)
  state = jtrain.create_train_state(jparams, jtx)
  image, boxes, classes = _det_batch()
  batch = {"image": jnp.asarray(image), "gt_boxes": jnp.asarray(boxes),
           "gt_classes": jnp.asarray(classes)}
  if shape is not None:
    mesh = _jmesh(shape)
    state = replicate(mesh, state)
    rows = JP(("replica", "data"))
    batch = {k: jax.device_put(v, NamedSharding(
        mesh, JP(("replica", "data"), "model")
        if k == "image" and shape[2] > 1 else rows))
             for k, v in batch.items()}
  return jax.jit(jtrain.make_det_train_step(jm, jtx, jcfg))(
      state, batch, jax.random.key(2))


@pytest.fixture(scope="module")
def jax_det_step():
  from automl_tpu import nn as jnn
  from automl_tpu.nn import layers as jlayers
  saved = jlayers.drop_connect, jlayers.drop_connect_with_key
  jlayers.drop_connect = jlayers.drop_connect_with_key = (
      lambda x, *a, **k: x)
  jnn.set_policy("float32")
  try:
    yield _jax_det_step
  finally:
    jlayers.drop_connect, jlayers.drop_connect_with_key = saved
    jnn.set_policy("mixed_bfloat16")


def _check_det(ranks, shape, state, metrics):
  from automl_tpu_torch import convert
  _, tmodel, _, _, _ = _det_parts()
  for res in ranks:
    got = res[shape]
    for k, v in metrics.items():
      np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5,
                                 atol=1e-6, err_msg=k)
    _close(convert.flatten_tree(convert.det_torch_to_jax_tree(
        got["params"], tmodel)), state.params, f"{shape} params",
        **STEP_TOL)
    _close(convert.flatten_tree(convert.det_torch_to_jax_tree(
        got["ema"], tmodel)), state.ema_params, f"{shape} ema", **STEP_TOL)


@pytest.fixture(scope="module")
def jax_one_device(jax_det_step):
  return jax_det_step(None)


@pytest.mark.parametrize("world,shape", [(2, (1, 2, 1)), (2, (1, 1, 2)),
                                         (4, (1, 2, 2)), (4, (1, 1, 4))])
def test_det_step_on_mesh_matches_jax(two, four, jax_one_device, world,
                                      shape):
  """One det train step (K6 knob on: the plain K6 on each band, its x the
  haloed rows and dy padded by k // 2 zero rows) on the mesh against JAX's
  step on the global batch (the result GSPMD keeps on any mesh): metrics
  rtol 1e-5, parameters (with the BN statistics) and EMA within the
  teacher-forced limits of tests/test_torch_det.py, on every rank; K6 sees
  the bands' shapes.

  JAX's own program on (1, 2, 2) departs from its one-device result by up
  to 7.9e-4 at fpn_cells/cell_0/fnode0's depthwise kernel (and within
  2.4e-7 on (1, 1, 2) and (1, 2, 1)); the same-mesh comparison is made on
  (1, 1, 2) below."""
  state, metrics = jax_one_device
  ranks = (two if world == 2 else four)[1]
  _check_det(ranks, shape, state, metrics)
  for res in ranks:
    # One stride-1 backbone block, 8 BiFPN nodes, 2 heads x 5 levels x 2.
    assert len(res[shape]["k6"]) == 29
    if shape[2] > 1:
      hb = 32 // shape[2] + 2      # the first block's band and its halo
      assert (4 // shape[1], 8, hb, 32) in res[shape]["k6"]


def test_det_spatial_step_matches_jax_on_same_mesh(two, jax_det_step):
  """The spatial step on (1, 1, 2) against JAX's jitted on the same mesh
  (image H sharded over 'model'), within the same limits."""
  state, metrics = jax_det_step((1, 1, 2))
  _check_det(two[1], (1, 1, 2), state, metrics)


def test_cls_step_on_mesh_matches_jax(two, f32):
  """One classification step of efficientnetv2-test (no dropout or
  drop_connect) on (1, 2, 1): each rank's 2 rows, the gradients and BN
  moments over 'data', against JAX's step on the same mesh: metrics rtol
  1e-5, parameters, BN statistics and EMA atol 1e-6."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import NamedSharding, PartitionSpec as JP
  from automl_tpu.configs import effnet_configs as jcfgs
  from automl_tpu.models import efficientnet as jeff
  from automl_tpu.parallel import replicate
  from automl_tpu.train import optimizers as jopt
  from automl_tpu.train import schedules as jsched
  from automl_tpu.train import train_lib as jtrain
  from automl_tpu_torch import convert
  tcfg, tmodel, tree, _, _ = _cls_parts()
  jcfg = jcfgs.get_model_config("efficientnetv2-test")
  jcfg.override(CLS_OVERRIDES)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  jtx = jopt.masked_for_params(jopt.build_optimizer(
      jcfg.train.optimizer, jsched.warmup_lr(
          jcfg.train.lr_sched, jcfg.train.lr_base, steps_per_epoch=4,
          total_steps=8, warmup_epochs=0,
          decay_epochs=jcfg.train.lr_decay_epoch,
          decay_factor=jcfg.train.lr_decay_factor,
          minimal_lr=jcfg.train.lr_min)), jparams)
  mesh = _jmesh((1, 2, 1))
  state = replicate(mesh, jtrain.create_train_state(jparams, jtx, ema=True))
  image, label = _cls_batch()
  rows = NamedSharding(mesh, JP(("replica", "data")))
  state, metrics = jax.jit(jtrain.make_cls_train_step(
      jeff.build_model(jcfg.model), jtx, jcfg))(
          state, {"image": jax.device_put(jnp.asarray(image), rows),
                  "label": jax.device_put(jnp.asarray(label), rows)},
          jax.random.key(1))
  for res in two[1]:
    got = res["cls"]
    for k, v in metrics.items():
      np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5,
                                 atol=1e-7, err_msg=k)
    _close(convert.flatten_tree(convert.det_torch_to_jax_tree(
        got["params"], tmodel)), state.params, "params", atol=1e-6,
        rtol=1e-5)
    _close(convert.flatten_tree(convert.det_torch_to_jax_tree(
        got["ema"], tmodel)), state.ema_params, "ema", atol=1e-6, rtol=1e-5)


def test_grouped_cross_replica_bn_matches_jax(four, f32):
  """BatchNorm(axis_name='data', group_size=2) on 4 ranks (rank r's rows
  r plus a pattern): the normalized output, the gradient of a weighted sum
  of it and the moving statistics against JAX's BatchNorm under shard_map
  on 4 devices (the counterpart of
  tests/test_parallel.py::test_grouped_cross_replica_bn), within atol
  1e-6, rtol 1e-5."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as JP
  from automl_tpu import nn as jnn
  from automl_tpu.nn import layers as jlayers
  shard_map = getattr(jax, "shard_map", None)
  if shard_map is None:
    from jax.experimental.shard_map import shard_map
  mesh = _jmesh((1, 4, 1))
  bn = jlayers.BatchNorm(2, axis_name="data", group_size=2, name="bn")
  params = bn.init(None)
  x = jnp.asarray(_bn_input())

  def fn(params, x, w):
    def loss(x):
      out, state = jnn.run_and_collect_state(
          lambda: bn(params, x, train=True))
      return jnp.sum(out * w), (out, state)
    (_, (out, state)), dx = jax.value_and_grad(loss, has_aux=True)(x)
    return out, dx, state[("bn", "moving_mean")][None], \
        state[("bn", "moving_variance")][None]
  spec = JP(("replica", "data"))
  out, dx, mm, mv = shard_map(fn, mesh=mesh, in_specs=(JP(), spec, spec),
                              out_specs=(spec, spec, spec, spec))(
                                  params, x, jnp.asarray(_bn_weight()))
  for r, res in enumerate(four[1]):
    got = res["bn"]
    np.testing.assert_allclose(got["y"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(out[r:r + 1]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got["dx"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(dx[r:r + 1]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got["moving"][0].numpy(), np.asarray(mm[r]),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got["moving"][1].numpy(), np.asarray(mv[r]),
                               atol=1e-6, rtol=1e-5)


def test_run_detection_on_mesh_matches_one_process(four, tmp_path, f32):
  """run_detection on (1, 2, 2) (image H over 'model', each process its
  rows; the preprocessing's jitter fixed, no flip) against the same run in
  one process: every rank's loss rtol 1e-5, rank 0's checkpoint within
  2e-5 of the one-process run's; rank 0 alone wrote config.yaml, the
  metrics and the checkpoint."""
  from automl_tpu_torch.train import runners
  d, ranks = four
  want = runners.run_detection(_det_runner_cfg(), str(tmp_path), 1,
                               data_iter=iter(_runner_batches()),
                               log_every=1, device="cpu")
  saved = torch.load(tmp_path / "ckpt" / "1" / "state.pt",
                     weights_only=True)["params"]
  for res in ranks:
    np.testing.assert_allclose(res["runner"]["metrics"]["loss"],
                               want["loss"], rtol=1e-5)
  got = ranks[0]["runner"]
  assert got["files"] == ["ckpt", "config.yaml", "metrics.jsonl"]
  for k, v in saved.items():
    np.testing.assert_allclose(got["ckpt"][k].numpy(), v.numpy(),
                               **STEP_TOL, err_msg=k)


def test_multi_process_evals_match_one_process_and_jax(two, f32):
  """evaluate_detection and evaluate_classification on 2 processes (each
  its 2 rows of each batch; predictions gathered) give, on both, the
  metrics of one process on the whole batches and of JAX's evals with the
  same weights."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.configs import efficientdet_configs as jdcfgs
  from automl_tpu.configs import effnet_configs as jccfgs
  from automl_tpu.models import efficientdet as jdet
  from automl_tpu.models import efficientnet as jeff
  from automl_tpu.train import runners as jrun
  from automl_tpu_torch import convert
  want = _evals(None, 0, 1)
  for res in two[1]:
    for kind in ("det", "cls"):
      assert res["evals"][kind].keys() == want[kind].keys()
      for k, v in want[kind].items():
        np.testing.assert_allclose(res["evals"][kind][k], v, atol=1e-6,
                                   err_msg=f"{kind} {k}")
  from automl_tpu_torch.train import runners
  from automl_tpu_torch.configs import efficientdet_configs as tdcfgs
  from automl_tpu_torch.configs import effnet_configs as tccfgs
  dm = runners.seeded_detection_model(
      tdcfgs.get_efficientdet_config("efficientdet-test"), 0, "cpu")
  jcfg = jdcfgs.get_efficientdet_config("efficientdet-test")
  jdet_m = jdet.EfficientDet(jcfg)
  jparams = jax.tree_util.tree_map(jnp.asarray, convert.det_torch_to_jax_tree(
      convert.model_state(dm), dm))
  jd = jrun.evaluate_detection(jdet_m, jparams, jcfg,
                               iter(_eval_batches("det")), 2)
  ccfg = tccfgs.get_model_config("efficientnetv2-test")
  cm = runners.seeded_classification_model(ccfg.model, 0, "cpu")
  jccfg = jccfgs.get_model_config("efficientnetv2-test")
  jccfg.eval.isize = 32
  jc = jrun.evaluate_classification(
      jeff.build_model(jccfg.model), jax.tree_util.tree_map(
          jnp.asarray, convert.det_torch_to_jax_tree(
              convert.model_state(cm), cm)), jccfg,
      iter(_eval_batches("cls")), 2)
  for kind, jwant in (("det", jd), ("cls", jc)):
    for k, v in want[kind].items():
      np.testing.assert_allclose(v, jwant[k], atol=1e-6,
                                 err_msg=f"{kind} {k}")


# dryrun_multichip's lines, JAX's f-strings with their numbers as patterns.
_MESH = r"\{'replica': 1, 'data': 2, 'model': 2\}"
_NUM = r"-?[0-9.]+(e[+-][0-9]+)?"
DRYRUN = [
    rf"detection dp x sp mesh={_MESH} loss={_NUM} OK",
    rf"LM dp x tp loss={_NUM} OK",
    rf"LM tp SERVING \(sharded cache \+ shard_map decode kernel, "
    rf"mesh={_MESH}\) OK",
    rf"LM sp SERVING \(S-sharded cache \+ partial-merge decode kernel, "
    rf"mesh={_MESH}\) OK",
    rf"LM dp x SP \(ring attention\) loss={_NUM} OK",
    rf"LM dp x PP \(GPipe\) loss={_NUM} OK",
    rf"LM dp x EP \(MoE\) loss={_NUM} OK",
    rf"LM FSDP \(ZeRO-3 weights\+opt over 'data', embed spec "
    rf"PartitionSpec\('data'\)\) loss={_NUM} OK",
    rf"LM dp x PP x EP \(MoE through GPipe\) loss={_NUM} OK",
    rf"detection 1536x1536 spatially sharded \(H over 'model', "
    r"\{'replica': 1, 'data': 1, 'model': 4\}\) sum=" + _NUM + " OK",
]


def test_dryrun_multichip_four_ranks():
  """dryrun_multichip(4) on 4 gloo ranks prints JAX's ten lines, in order:
  detection dp x sp, LM dp x tp, tp and sp serving, dp x SP, dp x PP,
  dp x EP, FSDP, dp x PP x EP, the 1536^2 spatially sharded forward."""
  from automl_tpu_torch.entry import dryrun_multichip
  lines = dryrun_multichip(4, "cpu", timeout_secs=240)
  assert len(lines) == 10
  for line, pattern in zip(lines, DRYRUN):
    assert re.fullmatch(r"dryrun_multichip\(4\): " + pattern, line), line


@pytest.mark.parametrize("cli", ["det", "cls"])
def test_cli_batch_must_split_over_rows(cli, tmp_path, monkeypatch):
  """main_det and main_cls refuse a global batch that does not split over
  the mesh's data rows (a batch of 4 over 3 rows) before reading data,
  rather than train a smaller batch than configured."""
  from automl_tpu_torch.cli import main_cls, main_det
  monkeypatch.setattr(main_det, "init_mesh", lambda args: ((1, 3, 1), 0, 3))
  if cli == "det":
    argv = ["--model_name=efficientdet-test", "--use_fake_data",
            "--hparams=batch_size=4", "--device=cpu", "--train_steps=1",
            f"--model_dir={tmp_path}"]
    main = main_det.main
  else:
    argv = ["--model_name=efficientnetv2-test", "--device=cpu",
            "--train_steps=1", "--hparam_str=train.batch_size=4",
            f"--model_dir={tmp_path}"]
    main = main_cls.main
  with pytest.raises(ValueError, match="batch 4 does not split over 3 rows"):
    main(argv)


if __name__ == "__main__":
  _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
