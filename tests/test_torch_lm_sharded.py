"""automl_tpu_torch's LM on a mesh against automl_tpu's on the CPU.

Two launches of gloo processes (parallel/launch.py: a file:// rendezvous, a
60 s collective timeout, a deadline on the launch) run the port; the tests
hold what each process saved against the JAX package on as many of the 8
simulated CPU devices (tests/conftest.py), on the same mesh shape:

  * 4 ranks, mesh (1, 2, 2): one Lion step of lm-test (f32 activations,
    packed segments and loss weights) under the gspmd, data-parallel,
    sequence-parallel + ring attention and fsdp layouts, against JAX's
    make_lm_train_step under jax.set_mesh: the loss within rtol 1e-5 and at
    least 99.9% of the parameters within 1e-6 (a Lion step moves each by
    lr * sign(grad), so a gradient within rounding of 0 may flip); each
    parameter's placement and params_sharding.txt against JAX's
    PartitionSpecs; the gspmd layout with flash attention (the kernels'
    plain versions on each rank's heads) and with the fused loss (K3's
    plain versions on each rank's rows) against the same port model off
    the mesh; MoE with its experts over a 'model' axis of 2 against JAX;
  * 2 ranks, mesh (1, 1, 2): greedy_generate with serve_tp and with
    serve_sp (a ring-attention training config), and LMServer with
    serve_tp, token for token against JAX's.

The workers import no JAX. Every comparison feeds one numpy-seeded tree to
both packages through the converter.
"""

import os
import sys

import numpy as np
import pytest
import torch

MODES = ("gspmd", "dp", "sp", "fsdp")
# Port-only variants on mesh (1, 2, 2), each against the same model off the
# mesh: flash attention on each rank's heads, and the fused loss (K3's
# plain versions on each rank's rows, the unembedding gathered).
VARIANTS = {"flash": dict(use_flash_attention=True),
            "fused_pallas": dict(fused_softmax_loss="pallas")}
B, T = 4, 64
# One layer: JAX's compiles of the sharded decode take most of this file's
# time, and each layer runs the same branches.
SERVE = dict(model_dim=64, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=97, seq_len=256, activation_dtype="float32")
PROMPT_LEN, NEW = 7, 12
REQUESTS = [(7, 9), (13, 5), (3, 11), (6, 6)]      # (prompt length, budget)


def _train_cfg(pkg, mode, **kw):
  cfg = pkg.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", **kw))
  if mode == "sp":
    cfg.override(dict(use_ring_attention=True))
  return cfg


def _sharding(pkg, mode):
  s = pkg.ShardingConfig
  return {"gspmd": s, "dp": s.data_parallel, "sp": s.sequence_parallel,
          "fsdp": s.fsdp}[mode]()


def _tree(cfg, seed=0):
  """numpy_init with the zero-init scales perturbed."""
  from automl_tpu_torch import convert
  tree = convert.numpy_init(cfg, seed)
  rng = np.random.default_rng(seed + 100)
  flat = convert.flatten_tree(tree)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = (0.3 * rng.standard_normal(value.shape)).astype(np.float32)
  return convert.unflatten_tree(flat)


def _batch():
  """tokens [4, 65] in packed documents: segment ids, and loss weights that
  drop a row's last 9 tokens."""
  rng = np.random.default_rng(11)
  tokens = rng.integers(3, 384, (B, T + 1)).astype(np.int32)
  seg = np.cumsum(rng.random((B, T + 1)) < 0.08, axis=1).astype(np.int32)
  w = np.ones((B, T + 1), np.float32)
  w[:, -9:] = 0.0
  return {"tokens": tokens, "segment_ids": seg, "loss_weights": w}


def _lr(pkg):
  return pkg.lm_lr("cosine_decay", 1e-3, num_train_steps=10, warmup_steps=1,
                   end_decay=0.1)


def _serve_prompts():
  rng = np.random.RandomState(5)
  prompt = rng.randint(1, 97, (2, PROMPT_LEN))
  reqs = [(rng.randint(1, 97, n).tolist(), m) for n, m in REQUESTS]
  return prompt, reqs


def _train_worker(rank, world, out):
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  from automl_tpu_torch.parallel import create_mesh, distributed
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules
  from automl_tpu_torch.data.lm_pipeline import select_local_batch
  mesh = create_mesh((1, 2, 2), device="cpu")
  res = {}
  for mode in MODES + tuple(f"gspmd_{v}" for v in VARIANTS):
    base, _, variant = mode.partition("_")
    cfg = _train_cfg(tlm, base, **VARIANTS.get(variant, {}))
    model = tlm.TransformerLM(cfg, _sharding(tlm, base), device="cpu",
                              mesh=mesh)
    convert.load_jax_params(model, _tree(cfg))
    lr = _lr(schedules)
    tx = optimizers.build_optimizer("lion", lr)
    step = lm_trainer.make_lm_train_step(model, tx, weight_decay=0.1,
                                         lr_fn=lr)
    idx, count = distributed.batch_coordinate(mesh)
    batch = distributed.build_global_batch(
        select_local_batch(_batch(), idx, count), mesh)
    state, logs = step(lm_trainer.init_train_state(model, tx), batch)
    full = convert.full_state(model)
    res[mode] = {"loss": float(logs["loss"]), "gnorm": float(logs["gnorm"]),
                 "specs": {k: str(v) for k, v in
                           model.param_placements().items()}}
    if rank == 0:
      res[mode]["params"] = {k: v.detach() for k, v in full.items()}
      lm_trainer.write_sharding_artifact(
          model, os.path.join(out, f"params_sharding_{mode}.txt"))
  # MoE on the 'model' axis: expert parallelism (each rank's 2 of 4
  # experts), one Lion step.
  moe = _train_cfg(tlm, "gspmd", moe_num_experts=4)
  model = tlm.TransformerLM(moe, device="cpu", mesh=mesh)
  convert.load_jax_params(model, _tree(moe))
  lr = _lr(schedules)
  tx = optimizers.build_optimizer("lion", lr)
  step = lm_trainer.make_lm_train_step(model, tx, weight_decay=0.1, lr_fn=lr)
  idx, count = distributed.batch_coordinate(mesh)
  _, logs = step(lm_trainer.init_train_state(model, tx),
                 distributed.build_global_batch(
                     select_local_batch(_batch(), idx, count), mesh))
  res["moe"] = float(logs["loss"])
  return res


def _serve_worker(rank, world, out):
  from automl_tpu_torch import convert
  from automl_tpu_torch.inference import lm_server
  from automl_tpu_torch.models import lm as tlm
  from automl_tpu_torch.parallel import create_mesh
  mesh = create_mesh((1, 1, 2), device="cpu")
  prompt, reqs = _serve_prompts()
  res = {}
  for mode, kw in (("tp", dict(serve_tp=True)),
                   ("sp", dict(serve_sp=True, use_ring_attention=True))):
    cfg = tlm.lm_defaults()
    cfg.update(dict(SERVE, **kw))
    model = convert.load_jax_params(
        tlm.TransformerLM(cfg, device="cpu", mesh=mesh),
        convert.numpy_init(cfg, 3))
    res[f"greedy_{mode}"] = tlm.greedy_generate(
        model, torch.from_numpy(prompt), NEW)
    if mode == "tp":
      server = lm_server.LMServer(model, max_batch=2, max_seq_len=64, burst=4)
      res["server_tp"] = [r.tokens for r in server.serve(
          [lm_server.GenRequest(p, m) for p, m in reqs])]
  return res


def _worker(role, rank, world, store, out):
  torch.set_num_threads(1)
  from automl_tpu_torch.parallel import distributed
  distributed.initialize(store, world, rank, backend="gloo",
                         timeout_secs=60)
  res = (_train_worker if role == "train" else _serve_worker)(rank, world,
                                                              out)
  torch.save(res, os.path.join(out, f"{role}{rank}.pt"))


def _launch(tmp_path_factory, role, world):
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = tmp_path_factory.mktemp(role)
  store = file_store(str(d))
  env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  run_local(lambda r: [sys.executable, __file__, role, str(r), str(world),
                       store, str(d)], world, timeout_secs=240, env=env)
  return d, [torch.load(d / f"{role}{r}.pt", weights_only=False)
             for r in range(world)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  return _launch(tmp_path_factory, "train", 4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
  return _launch(tmp_path_factory, "serve", 2)[1]


def _jmesh(shape):
  import jax
  from automl_tpu.parallel import create_mesh as jcreate
  return jcreate(shape, devices=jax.devices()[:int(np.prod(shape))])


def _jax_step(mode):
  """(loss, params after one Lion step as {jax path: array}) of JAX's
  make_lm_train_step on mesh (1, 2, 2)."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  from automl_tpu.train import lm_trainer as jtrain
  from automl_tpu.train import optimizers as jopt
  from automl_tpu.train import schedules as jsched
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  cfg = _train_cfg(jlm, mode)
  tree = _tree(_train_cfg(tlm, mode))
  with jax.set_mesh(_jmesh((1, 2, 2))):
    model = jlm.TransformerLM(cfg, _sharding(jlm, mode))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    lr = _lr(jsched)
    tx = jopt.build_optimizer("lion", lr)
    state = jtrain.LMTrainState(jnp.zeros((), jnp.int32), params,
                                tx.init(params))
    step = jax.jit(jtrain.make_lm_train_step(model, tx, weight_decay=0.1,
                                             lr_fn=lr))
    state, logs = step(state, {k: jnp.asarray(v) for k, v in
                               _batch().items()})
    return (float(logs["loss"]),
            convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        state.params)))


@pytest.mark.parametrize("mode", MODES)
def test_lion_step_matches_jax(trained, mode):
  """One Lion step on mesh (1, 2, 2): every rank's loss within rtol 1e-5 of
  JAX's, and >= 99.9% of the parameters within 1e-6 (the rest moved by
  2 lr at most: a sign flip of a gradient within rounding of 0)."""
  from automl_tpu_torch import convert
  _, ranks = trained
  loss, want = _jax_step(mode)
  for res in ranks:
    np.testing.assert_allclose(res[mode]["loss"], loss, rtol=1e-5)
  got = convert.flatten_tree(convert.torch_to_jax_tree(
      ranks[0][mode]["params"]))
  assert set(got) == set(want)
  close = total = 0
  for path, w in want.items():
    diff = np.abs(got[path] - w)
    close += int(np.sum(diff <= 1e-6))
    total += w.size
    assert diff.max() <= 2.5e-3, path       # 2 lr + decay: a flipped sign
  assert close >= 0.999 * total, (close, total)


@pytest.mark.parametrize("mode", MODES)
def test_placements_match_jax_specs(trained, mode):
  """Each parameter's placement is its JAX ShardingConfig PartitionSpec
  (trailing Nones dropped, as JAX prints a NamedSharding's spec), on every
  rank; params_sharding.txt names, shapes and orders the leaves as JAX's
  run_lm does, line for line, with the stacked blocks' specs led by None."""
  import jax
  from automl_tpu.models import lm as jlm
  from automl_tpu_torch.parallel.mesh import P
  d, ranks = trained
  sh = _sharding(jlm, mode)

  def norm(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
      spec.pop()
    return str(P(*spec))

  jspec = {"embed": sh.embed, "wq": sh.attn_qkv, "wk": sh.attn_qkv,
           "wv": sh.attn_qkv, "wo": sh.attn_o, "w0": sh.ffn0, "wg": sh.ffn0,
           "w1": sh.ffn1, "scale": sh.norm_scale}
  for res in ranks:
    for name, spec in res[mode]["specs"].items():
      assert spec == norm(jspec.get(name.split(".")[-1], ())), name
  cfg = _train_cfg(jlm, mode)
  shapes = jax.eval_shape(jlm.TransformerLM(cfg).init, jax.random.key(0))
  want = []
  for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
    path = jax.tree_util.keystr(kp).replace("'", "").replace("]", "") \
        .replace("[", "/").strip("/")
    spec = jspec.get(path.split("/")[-1], ())
    if path.startswith("blocks/"):
      spec = (None,) + tuple(spec)
    want.append(f"{path} :: {tuple(leaf.shape)} :: {leaf.dtype} :: "
                f"{norm(spec)}")
  total = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
  want.append(f"total_params :: {total}")
  got = (d / f"params_sharding_{mode}.txt").read_text().splitlines()
  assert got == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_on_mesh_match_one_device(trained, variant):
  """gspmd on mesh (1, 2, 2) with flash attention (each rank's 2 of 4
  heads through the kernels' plain versions, the heads gathered) or the
  fused loss (each rank's rows through K3's plain versions, the
  unembedding gathered) against the same port model and batch on one
  device: loss rtol 1e-5, >= 99.9% of the parameters within 1e-6."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules
  _, ranks = trained
  cfg = _train_cfg(tlm, "gspmd", **VARIANTS[variant])
  model = convert.load_jax_params(tlm.TransformerLM(cfg), _tree(cfg))
  lr = _lr(schedules)
  tx = optimizers.build_optimizer("lion", lr)
  step = lm_trainer.make_lm_train_step(model, tx, weight_decay=0.1, lr_fn=lr)
  state, logs = step(lm_trainer.init_train_state(model, tx),
                     {k: torch.from_numpy(v) for k, v in _batch().items()})
  got = ranks[0][f"gspmd_{variant}"]
  np.testing.assert_allclose(got["loss"], float(logs["loss"]), rtol=1e-5)
  close = total = 0
  for k, p in state.params.items():
    diff = (got["params"][k] - p.detach()).abs()
    close += int((diff <= 1e-6).sum())
    total += p.numel()
  assert close >= 0.999 * total


def test_moe_on_model_axis_refused(trained):
  """MoE on a 'model' axis of 2 is no longer refused: expert parallelism
  (experts over 'model', the data-parallel layout otherwise), one Lion
  step's loss on every rank within rtol 1e-5 of JAX's on mesh (1, 2, 2)."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  from automl_tpu.train import lm_trainer as jtrain
  from automl_tpu.train import optimizers as jopt
  from automl_tpu.train import schedules as jsched
  from automl_tpu_torch.models import lm as tlm
  cfg = _train_cfg(jlm, "gspmd", moe_num_experts=4)
  tree = _tree(_train_cfg(tlm, "gspmd", moe_num_experts=4))
  with jax.set_mesh(_jmesh((1, 2, 2))):
    model = jlm.TransformerLM(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    lr = _lr(jsched)
    tx = jopt.build_optimizer("lion", lr)
    state = jtrain.LMTrainState(jnp.zeros((), jnp.int32), params,
                                tx.init(params))
    step = jax.jit(jtrain.make_lm_train_step(model, tx, weight_decay=0.1,
                                             lr_fn=lr))
    _, logs = step(state, {k: jnp.asarray(v) for k, v in _batch().items()})
  for res in trained[1]:
    np.testing.assert_allclose(res["moe"], float(logs["loss"]), rtol=1e-5)


def _jax_serving(mode):
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  kw = (dict(serve_tp=True) if mode == "tp"
        else dict(serve_sp=True, use_ring_attention=True))
  jcfg, tcfg = jlm.lm_defaults(), tlm.lm_defaults()
  jcfg.update(dict(SERVE, **kw))
  tcfg.update(dict(SERVE, **kw))
  params = jax.tree_util.tree_map(jnp.asarray, convert.numpy_init(tcfg, 3))
  return jlm.TransformerLM(jcfg, jlm.ShardingConfig()), params


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_greedy_generate_sharded_matches_jax(served, mode):
  """greedy_generate with serve_tp (the head-leading cache, K4 head-major
  on each rank's kv heads) and serve_sp (ring-attention config; the cache
  over the sequence, K4's partials merged) on mesh (1, 1, 2): token for
  token against JAX's on 2 devices, on both ranks."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  prompt, _ = _serve_prompts()
  with jax.set_mesh(_jmesh((1, 1, 2))):
    model, params = _jax_serving(mode)
    want = np.asarray(jlm.greedy_generate(model, params,
                                          jnp.asarray(prompt, jnp.int32),
                                          NEW))
  for res in served:
    np.testing.assert_array_equal(res[f"greedy_{mode}"].numpy(), want)


def test_lm_server_serve_tp_matches_jax(served):
  """LMServer with serve_tp on 2 ranks (4 requests through 2 slots, bursts
  of 4) against JAX's LMServer on 2 devices: the same tokens per request,
  on both ranks."""
  import jax
  from automl_tpu.inference import lm_server as jsrv
  _, reqs = _serve_prompts()
  with jax.set_mesh(_jmesh((1, 1, 2))):
    model, params = _jax_serving("tp")
    server = jsrv.LMServer(model, params, max_batch=2, max_seq_len=64,
                           burst=4)
    want = [r.tokens for r in server.serve(
        [jsrv.GenRequest(p, m) for p, m in reqs])]
  for res in served:
    assert res["server_tp"] == want


if __name__ == "__main__":
  _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
