"""automl_tpu_torch's GPipe stages, MoE expert parallelism and prefix-LM
masks under ring attention on gloo ranks, against automl_tpu on as many of
the 8 simulated CPU devices (tests/conftest.py), on the same mesh shapes.

One launch of 4 gloo processes (parallel/launch.py) runs every case and
saves what each rank computed; the workers import no JAX:

  * pipeline_blocks_sharded at 4 stages (mesh (1, 1, 4); L 8, B 8, M 4 and
    M 2; a per-layer aux), and at 2 stages x 2 data rows (mesh (1, 2, 2),
    with a per-row extra): outputs, aux and gradients within 1e-5 of JAX's;
  * one Lion step of lm-test on mesh (1, 2, 2) under dp x PP, dp x EP and
    dp x PP x EP, a prefix-LM under ring attention and MoE under ring
    attention (the sequence-parallel layout: the routing groups span the
    sequence chunks too), against JAX's make_lm_train_step under
    jax.set_mesh: loss within rtol 1e-5, >= 99.9% of the parameters within
    1e-6. The EP routing group spans both data ranks and drops slots: the
    kept slots equal JAX's routing exactly and the aux is within 1e-6;
  * the placements and params_sharding.txt of the pipeline model (its
    stacked blocks over 'model', as pipeline_blocks_sharded's in_specs);
  * use_pipeline without use_scan raises JAX's ValueError on a 'model'
    axis of 2, and a stage count that does not divide the layers a
    ValueError (JAX's shard_map refuses the uneven split);
  * a pipelined run_lm's checkpoint keeps the per-layer names of every
    other layout: it reads back into the pipeline model, and a run with no
    mesh resumes from it.
"""

import os
import sys

import numpy as np
import pytest
import torch

L, B, D = 8, 8, 12
# A routing group of 256 tokens spans both data ranks' 2 x 64; a capacity
# of int(0.75 * 2 * 256 / 4) = 96 drops slots.
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.75,
           moe_group_size=256, moe_aux_loss_weight=0.01)
CASES = {"pp": dict(use_pipeline=True, pipeline_microbatches=2),
         "ep": MOE,
         "ppep": dict(MOE, use_pipeline=True, pipeline_microbatches=2),
         "prefix_ring": dict(use_ring_attention=True),
         "ring_ep": dict(MOE, use_ring_attention=True)}
BL, T = 4, 64


def _pipe_params():
  rng = np.random.default_rng(0)
  return {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
          "b": (0.01 * rng.standard_normal((L, D))).astype(np.float32)}


def _pipe_x():
  rng = np.random.default_rng(2)
  return (rng.standard_normal((B, D)).astype(np.float32),
          (1.0 + rng.random((B, 1))).astype(np.float32))


def _block_fn(lib, tanh):
  def block_fn(layer, h, extras):
    scale = extras[0] if extras and extras[0] is not None else 1.0
    out = tanh(h @ layer["w"] + layer["b"]) * scale + h
    return out, lib.sum(out ** 2) * 1e-3
  return block_fn


def _cfg(pkg, case):
  cfg = pkg.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", **CASES[case]))
  return cfg


def _sharding(pkg, case):
  s = pkg.ShardingConfig
  return s.sequence_parallel() if "ring" in case else s.data_parallel()


def _tree(cfg, seed=0):
  from automl_tpu_torch import convert
  tree = convert.numpy_init(cfg, seed)
  rng = np.random.default_rng(seed + 100)
  flat = convert.flatten_tree(tree)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = (0.3 * rng.standard_normal(value.shape)).astype(np.float32)
  return convert.unflatten_tree(flat)


def _batch(case):
  rng = np.random.default_rng(11)
  tokens = rng.integers(3, 384, (BL, T + 1)).astype(np.int32)
  batch = {"tokens": tokens}
  if case == "prefix_ring":
    # a prefix of 20-40 tokens per row, attended bidirectionally
    n = rng.integers(20, 40, BL)
    batch["causal_attention"] = (np.arange(T + 1)[None] < n[:, None]
                                 ).astype(np.int32)
    w = np.ones((BL, T + 1), np.float32)
    w[np.arange(T + 1)[None] < n[:, None]] = 0.0
    batch["loss_weights"] = w
  return batch


def _lr(pkg):
  return pkg.lm_lr("cosine_decay", 1e-3, num_train_steps=10, warmup_steps=1,
                   end_decay=0.1)


def _pipe_worker(res):
  """pipeline_blocks_sharded on (1, 1, 4) at M 4 / M 2, and on (1, 2, 2)
  with a per-row extra: outputs, aux, and the gradients of
  sum(out ** 2) + aux (the full stacked gradient, gathered)."""
  import torch.distributed as dist
  from automl_tpu_torch.parallel import comm, create_mesh
  from automl_tpu_torch.parallel.pipeline import pipeline_blocks_sharded
  params = {k: torch.from_numpy(v) for k, v in _pipe_params().items()}
  x, scale = (torch.from_numpy(a) for a in _pipe_x())
  for name, shape, m_micro in (("s4m4", (1, 1, 4), 4), ("s4m2", (1, 1, 4), 2),
                               ("s2d2m2", (1, 2, 2), 2)):
    mesh = create_mesh(shape, device="cpu")
    s_count, me = shape[2], mesh.get_local_rank("model")
    n_data = shape[1]
    di = mesh.get_local_rank("data")
    per = L // s_count
    local = {k: v[me * per:(me + 1) * per].clone().requires_grad_(True)
             for k, v in params.items()}
    layers = [{k: v[j] for k, v in local.items()} for j in range(per)]
    rows = slice(di * B // n_data, (di + 1) * B // n_data)
    xl = x[rows].clone().requires_grad_(True)
    extras = (scale[rows],) if n_data > 1 else ()
    out, aux = pipeline_blocks_sharded(
        xl, layers, extras, _block_fn(torch, torch.tanh), mesh,
        num_microbatches=m_micro)
    loss = (out ** 2).sum() + aux / n_data
    loss.backward()
    grads = {}
    for k, v in local.items():
      g = comm.all_reduce(v.grad.clone(), mesh, ("data",))
      grads[k] = comm.all_gather_dims(g, mesh, (("model", 0),))
    xg = comm.all_gather_dims(xl.grad, mesh, (("data", 0),))
    res[name] = {"out": comm.all_gather_dims(out.detach(), mesh,
                                             (("data", 0),)),
                 "aux": float(aux), "grads": grads, "x_grad": xg}
    dist.barrier()


def _lm_worker(rank, res, out):
  from automl_tpu_torch import convert
  from automl_tpu_torch.data.lm_pipeline import select_local_batch
  from automl_tpu_torch.models import lm as tlm
  from automl_tpu_torch.parallel import create_mesh, distributed
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules
  mesh = create_mesh((1, 2, 2), device="cpu")
  for case in CASES:
    cfg = _cfg(tlm, case)
    model = tlm.TransformerLM(cfg, _sharding(tlm, case), device="cpu",
                              mesh=mesh)
    convert.load_jax_params(model, _tree(cfg))
    lr = _lr(schedules)
    tx = optimizers.build_optimizer("lion", lr)
    step = lm_trainer.make_lm_train_step(model, tx, weight_decay=0.1,
                                         lr_fn=lr)
    idx, count = distributed.batch_coordinate(mesh)
    batch = distributed.build_global_batch(
        select_local_batch(_batch(case), idx, count), mesh)
    r = {}
    if case == "ep":
      # The first MoE layer on a test input (the embedded rows, normed):
      # its aux and its kept slots of the global batch, gathered in the
      # batch's order.
      from automl_tpu_torch.parallel import comm
      local = select_local_batch(_batch(case), idx, count)["tokens"]
      x = model.embed.full_tensor().detach()[
          torch.from_numpy(local[:, :-1]).long()] * (cfg.model_dim ** 0.5)
      moe = model.blocks[0].ffn
      orig, kept = moe._global_slots, []

      def spy(idx_):
        out_ = orig(idx_)
        kept.append(out_[1].reshape(idx_.shape))
        return out_
      moe._global_slots = spy
      with torch.no_grad():
        _, aux = moe(model.blocks[0].pre_ffn_norm(x))
      moe._global_slots = orig
      r.update(moe_x=x, moe_aux=float(aux),
               keep=comm.all_gather_dims(kept[0], mesh, (("data", 0),)))
    state, logs = step(lm_trainer.init_train_state(model, tx), batch)
    full = convert.full_state(model)
    r.update(loss=float(logs["loss"]),
             specs={k: str(v) for k, v in model.param_placements().items()})
    if rank == 0:
      r["params"] = {k: v.detach() for k, v in full.items()}
      lm_trainer.write_sharding_artifact(
          model, os.path.join(out, f"params_sharding_{case}.txt"))
    res[case] = r
  # A pipelined run's checkpoint (per-layer names), read back into the
  # pipeline model
  from automl_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 state_for_save)
  cfg = _cfg(tlm, "pp")
  run = os.path.join(out, "pp_run")
  lm_trainer.run_lm(cfg, run, 1, mesh_shape=(1, 2, 2), device="cpu")
  model = tlm.TransformerLM(cfg, device="cpu", mesh=mesh)
  tx = optimizers.build_optimizer("lion", 1e-3)
  state = CheckpointManager(os.path.join(run, "ckpt")).restore(
      lm_trainer.init_train_state(model, tx), names=tlm.stacked_layers)
  state = state_for_save(state, tlm.per_layer)
  res["pp_restored"] = {k: v.detach() for k, v in state.params.items()}
  res["pp_restored_opt"] = state.opt_state
  # JAX's refusal: the pipeline needs the stacked layout
  cfg.override(dict(use_scan=False))
  try:
    tlm.TransformerLM(cfg, device="cpu", mesh=mesh)
    res["no_scan"] = None
  except ValueError as e:
    res["no_scan"] = str(e)


def _worker(rank, world, store, out):
  torch.set_num_threads(1)
  from automl_tpu_torch.parallel import distributed
  distributed.initialize(store, world, rank, backend="gloo",
                         timeout_secs=60)
  res = {}
  _pipe_worker(res)
  _lm_worker(rank, res, out)
  torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = tmp_path_factory.mktemp("pipeline")
  store = file_store(str(d))
  env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  run_local(lambda r: [sys.executable, __file__, str(r), "4", store, str(d)],
            4, timeout_secs=240, env=env)
  return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(4)]


def _jmesh(shape):
  import jax
  from automl_tpu.parallel import create_mesh as jcreate
  return jcreate(shape, devices=jax.devices()[:int(np.prod(shape))])


@pytest.mark.parametrize("name,shape,m_micro", [
    ("s4m4", (1, 1, 4), 4), ("s4m2", (1, 1, 4), 2), ("s2d2m2", (1, 2, 2), 2)])
def test_pipeline_blocks_sharded_matches_jax(ranks, name, shape, m_micro):
  """Outputs, aux and the gradients of sum(out ** 2) + aux (stacked
  parameters and input) against JAX's pipeline_blocks_sharded on the same
  mesh: within 1e-5 (the gradients: of their largest entry), on every
  rank."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.parallel.pipeline import pipeline_blocks_sharded as jpipe
  params = {k: jnp.asarray(v) for k, v in _pipe_params().items()}
  x, scale = (jnp.asarray(a) for a in _pipe_x())
  with_extra = shape[1] > 1
  fn = _block_fn(jnp, jnp.tanh)

  def loss(p, x):
    out, aux = jpipe(x, p, (scale,) if with_extra else None,
                     block_fn=lambda lp, h, e: fn(lp, h, e or ()),
                     mesh=_jmesh(shape), num_microbatches=m_micro)
    return jnp.sum(out ** 2) + aux, (out, aux)
  (_, (out, aux)), (g, gx) = jax.jit(jax.value_and_grad(
      loss, argnums=(0, 1), has_aux=True))(params, x)
  for res in ranks[1]:
    got = res[name]
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["aux"], float(aux), atol=1e-5, rtol=1e-5)
    # Gradients of sum(out ** 2) reach ~40: within 1e-5 of the largest
    # entry of each (f32 sums in another order).
    for gg, want in [(got["grads"][k], g[k]) for k in g] + [
        (got["x_grad"], gx)]:
      want = np.asarray(want)
      assert np.abs(gg.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _jax_step(case):
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  from automl_tpu.train import lm_trainer as jtrain
  from automl_tpu.train import optimizers as jopt
  from automl_tpu.train import schedules as jsched
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  cfg = _cfg(jlm, case)
  tree = _tree(_cfg(tlm, case))
  with jax.set_mesh(_jmesh((1, 2, 2))):
    model = jlm.TransformerLM(cfg, _sharding(jlm, case))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    lr = _lr(jsched)
    tx = jopt.build_optimizer("lion", lr)
    state = jtrain.LMTrainState(jnp.zeros((), jnp.int32), params,
                                tx.init(params))
    step = jax.jit(jtrain.make_lm_train_step(model, tx, weight_decay=0.1,
                                             lr_fn=lr))
    state, logs = step(state, {k: jnp.asarray(v) for k, v in
                               _batch(case).items()})
    return (float(logs["loss"]),
            convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        state.params)))


@pytest.mark.parametrize("case", list(CASES))
def test_lion_step_matches_jax(ranks, case):
  """One Lion step on mesh (1, 2, 2): dp x PP, dp x EP, dp x PP x EP, a
  prefix-LM under ring attention and MoE under ring attention. Every
  rank's loss within rtol 1e-5 of JAX's, >= 99.9% of the parameters within
  1e-6."""
  from automl_tpu_torch import convert
  _, rk = ranks
  loss, want = _jax_step(case)
  for res in rk:
    np.testing.assert_allclose(res[case]["loss"], loss, rtol=1e-5)
  got = convert.flatten_tree(convert.torch_to_jax_tree(
      rk[0][case]["params"]))
  assert set(got) == set(want)
  close = total = 0
  for path, w in want.items():
    diff = np.abs(got[path] - w)
    close += int(np.sum(diff <= 1e-6))
    total += w.size
    assert diff.max() <= 2.5e-3, path
  assert close >= 0.999 * total, (close, total)


def test_ep_routing_across_ranks_matches_jax(ranks):
  """The first MoE layer's routing on mesh (1, 2, 2): its one group of 256
  tokens spans both data ranks; the kept slots of the global batch equal
  JAX's routing of the same input exactly, with drops, and the aux of the
  layer (a product of two global means) is within 1e-6 of JAX's."""
  import jax
  import jax.numpy as jnp
  from automl_tpu.models import lm as jlm
  from automl_tpu_torch.models import lm as tlm
  _, rk = ranks
  cfg = _cfg(jlm, "ep")
  tree = _tree(_cfg(tlm, "ep"))
  layer = jax.tree_util.tree_map(lambda p: jnp.asarray(p[0]),
                                 tree["blocks"])
  x = np.concatenate([rk[0]["ep"]["moe_x"].numpy(),
                      rk[2]["ep"]["moe_x"].numpy()])     # data rows 0, 1
  blk = jlm.TransformerBlock(cfg, jlm.ShardingConfig.data_parallel())
  h = blk.pre_ffn_norm(layer["pre_ffn_norm"], jnp.asarray(x))
  _, aux = blk.ffn(layer["ffn"], h)
  # JAX's routing: top-k of the router's softmax, positions within each
  # expert token-major over the group's slots, kept below the capacity.
  probs = jax.nn.softmax(jnp.einsum("sd,de->se", h.reshape(-1, 32),
                                    layer["ffn"]["router"]), -1)
  _, idx = jax.lax.top_k(probs, 2)
  flat = np.asarray(idx).reshape(-1)
  onehot = np.eye(4)[flat]
  pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
  want_keep = pos < int(0.75 * 2 * 256 / 4)
  assert 0 < (~want_keep).sum()
  for res in rk:
    np.testing.assert_array_equal(res["ep"]["keep"].numpy().reshape(-1),
                                  want_keep)
    np.testing.assert_allclose(res["ep"]["moe_aux"], float(aux), atol=1e-6)


def test_pipeline_placements_and_sharding_file(ranks):
  """The pipeline model's stacked blocks are split over 'model' on the
  layer axis (pipeline_blocks_sharded's in_specs), the rest replicated
  (the data-parallel layout); params_sharding.txt names and shapes JAX's
  stacked tree, line for line."""
  import jax
  from automl_tpu.models import lm as jlm
  from automl_tpu_torch.parallel.mesh import P
  d, rk = ranks
  for res in rk:
    for name, spec in res["pp"]["specs"].items():
      assert spec == str(P("model") if name.startswith("blocks.")
                         else P()), name
  shapes = jax.eval_shape(jlm.TransformerLM(_cfg(jlm, "pp")).init,
                          jax.random.key(0))
  want = []
  for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
    path = jax.tree_util.keystr(kp).replace("'", "").replace("]", "") \
        .replace("[", "/").strip("/")
    spec = P("model") if path.startswith("blocks/") else P()
    want.append(f"{path} :: {tuple(leaf.shape)} :: {leaf.dtype} :: {spec}")
  total = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
  want.append(f"total_params :: {total}")
  assert (d / "params_sharding_pp.txt").read_text().splitlines() == want


def test_pipeline_without_scan_raises_jax_error(ranks):
  """use_pipeline on a 'model' axis above 1 needs the stacked layout:
  JAX's ValueError, in its words."""
  for res in ranks[1]:
    assert res["no_scan"] is not None and "use_scan" in res["no_scan"]


class _StubMesh:
  """What TransformerLM's mesh bookkeeping reads of a (1, 1, 2) mesh."""
  mesh_dim_names = ("replica", "data", "model")

  def size(self, i):
    return (1, 1, 2)[i]

  def get_local_rank(self, axis):
    return 0


def test_pipeline_stages_must_divide_layers():
  """use_pipeline over 2 stages with 3 layers is refused before anything
  is placed."""
  from automl_tpu_torch.models import lm as tlm
  cfg = _cfg(tlm, "pp")
  cfg.override(dict(n_layers=3))
  with pytest.raises(ValueError, match="n_layers \\(3\\) must be divisible"):
    tlm.TransformerLM(cfg, device="cpu", mesh=_StubMesh())


def _momentum(opt_state):
  """Lion's per-parameter momentum dict in a chained optimizer state."""
  if isinstance(opt_state, dict):
    return opt_state.get("momentum") or next(
        (m for v in opt_state.values() if (m := _momentum(v))), None)
  if isinstance(opt_state, (tuple, list)):
    return next((m for v in opt_state if (m := _momentum(v))), None)
  return None


def test_pipelined_checkpoint_resumes_without_mesh(ranks):
  """run_lm's checkpoint of the pipeline model on (1, 2, 2) holds the
  per-layer names (blocks.<i>.<leaf>): read back into the pipeline model it
  gives the same parameters and momentum on every rank; restored with no
  mesh it gives the same parameters, and run_lm with no mesh resumes from
  it at step 1 and trains step 2."""
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as tlm
  from automl_tpu_torch.train import lm_trainer, optimizers
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  d, rk = ranks
  run = str(d / "pp_run")
  saved = torch.load(os.path.join(run, "ckpt", "1", "state.pt"),
                     weights_only=True)
  cfg = _cfg(tlm, "pp")
  plain = tlm.TransformerLM(cfg, device="cpu")
  assert set(saved["params"]) == set(dict(plain.named_parameters()))
  momentum = _momentum(saved["opt_state"])
  assert set(momentum) == set(saved["params"])
  for res in rk:
    assert set(res["pp_restored"]) == set(saved["params"])
    for k, v in res["pp_restored"].items():
      assert torch.equal(v, saved["params"][k]), k
    for k, v in _momentum(res["pp_restored_opt"]).items():
      assert torch.equal(v, momentum[k]), k
  tx = optimizers.build_optimizer("lion", 1e-3)
  state = CheckpointManager(os.path.join(run, "ckpt")).restore(
      lm_trainer.init_train_state(plain, tx))
  assert int(state.step) == 1
  for k, v in convert.full_state(plain).items():
    assert torch.equal(v, saved["params"][k]), k
  logs = lm_trainer.run_lm(cfg, run, 2, device="cpu")
  assert np.isfinite(logs["loss"])
  assert CheckpointManager(os.path.join(run, "ckpt")).all_steps() == [1, 2]


if __name__ == "__main__":
  _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
