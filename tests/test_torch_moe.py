"""automl_tpu_torch's MoE FFN and its load-balance loss against automl_tpu's.

One config and one JAX-layout parameter tree made with numpy from a seed
(norm and per-dim scales perturbed away from zero) go into both packages,
on lm-test with moe_num_experts set and f32 activations. JAX's flash
kernels run in interpret mode, the port's plain versions; JAX matmuls run
at "highest" precision (tests/conftest.py). Tolerances, as
tests/test_torch_lm.py's: the FFN's output atol 1e-5 (f32, another
summation order), logits atol 1e-4, the loss rtol 1e-5, gradients atol
3e-4, rtol 1e-3; routing decisions (experts, kept slots) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.models import lm as jlm
from automl_tpu.train import lm_trainer as jtrain
from automl_tpu.train import optimizers as jopt
from automl_tpu.train import schedules as jsched
from automl_tpu_torch import convert
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.ops import attention as tattn
from automl_tpu_torch.train import lm_trainer as ttrain
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import schedules as tsched

torch.set_num_threads(1)

MOE = dict(activation_dtype="float32", moe_num_experts=4, moe_top_k=2,
           moe_capacity_factor=2.0)
GRAD_TOL = dict(atol=3e-4, rtol=1e-3)


def _cfgs(**kw):
  jcfg, tcfg = jlm.get_lm_config("lm-test"), tlm.get_lm_config("lm-test")
  kw = dict(MOE, **kw)
  jcfg.override(kw)
  tcfg.override(kw)
  return jcfg, tcfg


def _tree(tcfg, seed=0):
  """numpy_init with the zero-init scales perturbed."""
  tree = convert.numpy_init(tcfg, seed)
  rng = np.random.default_rng(seed + 100)
  flat = convert.flatten_tree(tree)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = (0.3 * rng.standard_normal(value.shape)).astype(np.float32)
  return convert.unflatten_tree(flat)


def _models(seed=0, **kw):
  jcfg, tcfg = _cfgs(**kw)
  tree = _tree(tcfg, seed)
  jmodel = jlm.TransformerLM(jcfg)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  tmodel = convert.load_jax_params(tlm.TransformerLM(tcfg), tree)
  return jmodel, jparams, tmodel


def _ffn_pair(seed=0, **kw):
  """(JAX MoEFFN, its params, the port's MoEFFN) with layer 0's weights."""
  jcfg, tcfg = _cfgs(**kw)
  ffn = _tree(tcfg, seed)["blocks"]["ffn"]
  jffn = jlm.MoEFFN(jcfg, jlm.ShardingConfig.data_parallel())
  tffn = tlm.MoEFFN(tcfg)
  tffn.load_state_dict({k: torch.from_numpy(np.array(v[0]))
                        for k, v in ffn.items()})
  return jffn, {k: jnp.asarray(v[0]) for k, v in ffn.items()}, tffn


def _x(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
  return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat(tree):
  return {k: np.asarray(v) for k, v in convert.flatten_tree(tree).items()}


def _jax_keep(jffn, jparams, x, g_size, capacity):
  """JAX's kept slots, by its own route_group arithmetic: the token-major
  cumsum of the one-hot experts of lax.top_k over the softmax."""
  e, k = jffn.num_experts, jffn.top_k
  xf = jnp.asarray(x).reshape(-1, x.shape[-1])
  probs = jax.nn.softmax(jnp.einsum("sd,de->se", xf, jparams["router"]), -1)
  _, idx = jax.lax.top_k(probs, k)
  flat_e = idx.reshape(-1, g_size * k)
  e_mask = jax.nn.one_hot(flat_e, e, dtype=jnp.float32)
  pos = jnp.sum((jnp.cumsum(e_mask, axis=1) - e_mask) * e_mask, -1)
  return np.asarray(idx), np.asarray(pos < capacity).reshape(-1)


# --- the MoE FFN -------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(moe_top_k=1), dict(moe_top_k=2),
    dict(moe_top_k=2, moe_capacity_factor=0.5),
    dict(moe_top_k=1, moe_capacity_factor=0.25, use_gated_ffn=False),
    dict(moe_top_k=2, moe_group_size=8),
], ids=["top1", "top2", "top2_drops", "top1_drops_ungated", "groups_of_8"])
def test_moe_ffn_matches_jax(case):
  """Output atol 1e-5, aux rtol 1e-6; the experts chosen and the slots
  kept (capacity 0.5 and 0.25 drop tokens) equal JAX's exactly."""
  jffn, jparams, tffn = _ffn_pair(seed=1, **case)
  x = _x((2, 16, 32), 2)
  want, want_aux = jffn.apply(jparams, jnp.asarray(x))
  got, aux = tffn(torch.from_numpy(x))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
  g_size, capacity = tffn.routing(32)
  _, idx, _ = tffn.route(torch.from_numpy(x))
  _, keep = tffn.slots(idx, g_size, capacity)
  want_idx, want_keep = _jax_keep(jffn, jparams, x, g_size, capacity)
  np.testing.assert_array_equal(_np(idx), want_idx)
  np.testing.assert_array_equal(_np(keep), want_keep)
  if case.get("moe_capacity_factor", 2.0) < 1:
    assert not want_keep.all()      # the case drops tokens


@pytest.mark.parametrize("shape,groups", [
    ((2, 16, 32), (8, 32 * 100)),    # tests/test_lm.py:839: 4 groups vs 1
    ((5, 16, 32), (32, 80)),         # tests/test_lm.py:878: 80 % 32 -> 20
], ids=["grouping", "odd_divisor"])
def test_moe_grouping_matches_jax_and_is_invariant(shape, groups):
  """With ample capacity (factor 4) the group size changes no value: each
  group size against JAX's (atol 1e-5), and the two against each other
  (atol 1e-5, tests/test_lm.py's). The group is the largest divisor of
  B * T at most moe_group_size."""
  x = _x(shape, 3)
  outs = []
  for g in groups:
    jffn, jparams, tffn = _ffn_pair(seed=4, moe_capacity_factor=4.0,
                                    moe_group_size=g)
    want, _ = jffn.apply(jparams, jnp.asarray(x))
    got, _ = tffn(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    outs.append(_np(got))
  np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)
  s = shape[0] * shape[1]
  assert tffn.routing(s)[0] == s and _ffn_pair(
      moe_group_size=groups[0])[2].routing(s)[0] == {32: 8, 80: 20}[s]


def test_moe_single_expert_equals_dense_ffn():
  """E = 1 with ample capacity is the dense gated FFN (the gate is 1.0),
  in the port as in JAX (tests/test_lm.py:785): atol 1e-5; aux 1."""
  jffn, jparams, tffn = _ffn_pair(seed=5, moe_num_experts=1, moe_top_k=1)
  _, tcfg = _cfgs(moe_num_experts=1, moe_top_k=1)
  dense = tlm.FFN(tcfg)
  dense.load_state_dict({k: v.data[0] for k, v in tffn.named_parameters()
                         if k != "router"})
  x = _x((2, 8, 32), 6)
  got, aux = tffn(torch.from_numpy(x))
  want, want_aux = jffn.apply(jparams, jnp.asarray(x))
  np.testing.assert_allclose(_np(got), _np(dense(torch.from_numpy(x))),
                             atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
  assert float(aux) == pytest.approx(1.0, rel=1e-6) and float(
      want_aux) == pytest.approx(1.0, rel=1e-6)


def test_tied_router_probabilities_take_lax_top_k_order():
  """A router with equal columns gives tied probabilities: the experts
  chosen are lax.top_k's (the lower index first among ties), exactly, and
  so are the outputs (atol 1e-5)."""
  jffn, jparams, tffn = _ffn_pair(seed=7, moe_num_experts=4, moe_top_k=2)
  router = np.array(jparams["router"])
  router[:, 2] = router[:, 0]          # experts 0 and 2 tie
  router[:, 3] = router[:, 1]          # experts 1 and 3 tie
  jparams = dict(jparams, router=jnp.asarray(router))
  tffn.router.data.copy_(torch.from_numpy(router))
  x = _x((2, 8, 32), 8)
  _, idx, _ = tffn.route(torch.from_numpy(x))
  want_idx, _ = _jax_keep(jffn, jparams, x, 16, 16)
  np.testing.assert_array_equal(_np(idx), want_idx)
  assert set(map(tuple, np.sort(want_idx, 1))) <= {(0, 2), (1, 3)}
  tffn.router.data.zero_()             # all four tie
  _, idx, _ = tffn.route(torch.from_numpy(x))
  assert (_np(idx) == [0, 1]).all()
  want, _ = jffn.apply(jparams, jnp.asarray(x))
  tffn.router.data.copy_(torch.from_numpy(router))
  got, _ = tffn(torch.from_numpy(x))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_moe_aux_value_and_gradient_match_jax():
  """d(aux)/d(router) and d(aux)/dx against jax.grad (GRAD_TOL); the
  value rtol 1e-6. The aux takes its gradient through the mean
  probabilities only (the top-1 one-hot is a constant)."""
  jffn, jparams, tffn = _ffn_pair(seed=9)
  x = _x((2, 16, 32), 10)
  want_aux, (want_dr, want_dx) = jax.value_and_grad(
      lambda r, xx: jffn.apply(dict(jparams, router=r), xx)[1],
      argnums=(0, 1))(jparams["router"], jnp.asarray(x))
  tx = torch.from_numpy(x).requires_grad_()
  _, aux = tffn(tx)
  aux.backward()
  np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
  np.testing.assert_allclose(_np(tffn.router.grad), _np(want_dr), **GRAD_TOL)
  np.testing.assert_allclose(_np(tx.grad), _np(want_dx), **GRAD_TOL)


def test_moe_block_matches_jax():
  """TransformerBlock with the MoE FFN (and post-LN): output atol 1e-5,
  aux rtol 1e-6."""
  jcfg, tcfg = _cfgs(use_post_ln=True)
  tree = _tree(tcfg, seed=11)
  jblock = jlm.TransformerBlock(jcfg, jlm.ShardingConfig.data_parallel())
  tblock = tlm.TransformerBlock(tcfg)
  tblock.load_state_dict({k.split(".", 2)[2]: v for k, v in
                          convert.jax_to_torch_state(tree).items()
                          if k.startswith("blocks.0.")})
  x = _x((2, 8, 32), 12)
  pos = np.broadcast_to(np.arange(8), (2, 8)).copy()
  mask = np.array(jlm.causal_mask(jnp.asarray(pos), jnp.asarray(pos)))
  want, _, want_aux = jblock.apply(
      jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["blocks"]),
      jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask))
  got, _, aux = tblock(torch.from_numpy(x), torch.from_numpy(pos),
                       torch.from_numpy(mask))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


# --- the LM ------------------------------------------------------------------


def _batch(seed, b=2, t=64, v=384):
  rng = np.random.default_rng(seed)
  return {"tokens": rng.integers(3, v, (b, t + 1)).astype(np.int32),
          "loss_weights": (rng.random((b, t + 1)) < 0.9).astype(np.float32)}


def _jax_loss_and_grads(jmodel, jparams, batch):
  """The JAX train step's loss_fn (aux included), through
  jax.value_and_grad."""
  b = {k: jnp.asarray(v) for k, v in batch.items()}
  inputs, targets = b["tokens"][:, :-1], b["tokens"][:, 1:]
  weights = b["loss_weights"][:, 1:]
  aux_w = float(jmodel.cfg.moe_aux_loss_weight)
  fused = jmodel.cfg.get("fused_softmax_loss", False)

  def loss_fn(params):
    if fused:
      hidden, _, aux = jmodel(params, inputs, return_aux=True,
                              return_hidden=True)
      if fused == "pallas":
        loss = jlm.lm_loss_fused_pallas(params, hidden, targets, jmodel.cfg,
                                        weights)
      else:
        loss = jlm.lm_loss_fused(params, hidden, targets, jmodel.cfg,
                                 weights, int(jmodel.cfg.loss_chunk_size))
      return loss + aux_w * aux
    logits, _, aux = jmodel(params, inputs, return_aux=True)
    return jlm.lm_loss(logits, targets, weights) + aux_w * aux

  return jax.value_and_grad(loss_fn)(jparams)


def _grads_close(grads, want_grads):
  got, want = _flat(convert.torch_to_jax_tree(grads)), _flat(want_grads)
  assert set(got) == set(want)
  for path in want:
    np.testing.assert_allclose(got[path], want[path], err_msg=path,
                               **GRAD_TOL)


def test_moe_lm_logits_and_aux_match_jax():
  """Logits atol 1e-4 and the summed aux rtol 1e-5, with and without the
  scan (remat), and with a KV cache, where the aux is 0 in both."""
  jmodel, jparams, tmodel = _models(seed=13)
  tokens = np.random.default_rng(14).integers(0, 384, (2, 16))
  want, _, want_aux = jmodel(jparams, jnp.asarray(tokens), return_aux=True)
  got, _, aux = tmodel(torch.from_numpy(tokens), return_aux=True)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
  np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
  assert 0.9 < float(aux) / tmodel.cfg.n_layers < 4.0
  pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
  with torch.no_grad():
    got_c, cache, aux_c = tmodel(
        torch.from_numpy(tokens), positions=torch.from_numpy(pos),
        cache=tmodel.init_cache(2, 16), cache_index=0, return_aux=True)
  want_c, _, want_aux_c = jmodel(
      jparams, jnp.asarray(tokens), positions=jnp.asarray(pos),
      cache=jmodel.init_cache(2, 16), cache_index=0, return_aux=True)
  np.testing.assert_allclose(_np(got_c), _np(want_c), atol=1e-4, rtol=1e-4)
  assert float(aux_c) == float(want_aux_c) == 0.0


@pytest.mark.parametrize("policy", ["full", "dots", "dots_flash"])
def test_moe_loss_and_grads_match_jax_under_remat(policy):
  """The training loss (aux weight 0.01) and every gradient leaf, router
  included, with flash attention and the same remat policy in both
  packages: loss rtol 1e-5, grads GRAD_TOL; the policy changes no value in
  the port (each against full remat: bit-equal)."""
  kw = dict(use_flash_attention=True, use_remat=True, remat_policy=policy)
  jmodel, jparams, tmodel = _models(seed=15, **kw)
  batch = _batch(16)
  want_loss, want_grads = _jax_loss_and_grads(jmodel, jparams, batch)
  tb = {k: torch.from_numpy(v) for k, v in batch.items()}
  loss, grads = ttrain.lm_loss_and_grads(tmodel, tb)
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
  _grads_close(grads, want_grads)
  tmodel.cfg.remat_policy = "full"
  loss_full, grads_full = ttrain.lm_loss_and_grads(tmodel, tb)
  assert float(loss_full) == float(loss)
  assert all(torch.equal(grads[k], grads_full[k]) for k in grads)


@pytest.mark.parametrize("fused", [False, "scan", "pallas"])
def test_moe_lion_steps_match_jax(fused):
  """5 Lion steps (cosine schedule, weight decay 0.1, moe_aux_loss_weight
  0.01, top-2 with drops at capacity 1.0) against
  jtrain.make_lm_train_step, in each loss mode (set on the built configs:
  JAX's override turns the word into a bool): the loss at every step rtol
  1e-5, and >= 99.9% of the final parameters within 1e-6 (a gradient near
  0 may flip Lion's sign and move its entry by 2 lr, as in
  tests/test_torch_lm_train.py)."""
  steps = 5
  jmodel, jparams, tmodel = _models(seed=17, moe_capacity_factor=1.0)
  for cfg in (jmodel.cfg, tmodel.cfg):
    cfg.fused_softmax_loss = fused
    cfg.loss_chunk_size = 16
  lr_kw = dict(num_train_steps=steps, warmup_steps=2, end_decay=0.1)
  jlr = jsched.lm_lr("cosine_decay", 3e-3, **lr_kw)
  tlr = tsched.lm_lr("cosine_decay", 3e-3, **lr_kw)
  jtx, ttx = jopt.build_optimizer("lion", jlr), topt.build_optimizer(
      "lion", tlr)
  jstep = jax.jit(jtrain.make_lm_train_step(jmodel, jtx, weight_decay=0.1,
                                            lr_fn=jlr))
  tstep = ttrain.make_lm_train_step(tmodel, ttx, weight_decay=0.1,
                                    lr_fn=tlr)
  jstate = jtrain.LMTrainState(jnp.zeros((), jnp.int32), jparams,
                               jtx.init(jparams))
  tstate = ttrain.init_train_state(tmodel, ttx)
  for i in range(steps):
    batch = _batch(18 + i)
    jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    tstate, tlogs = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]),
                               rtol=1e-5, err_msg=f"step {i + 1}")
  got = _flat(convert.torch_to_jax_tree(tstate.params))
  n_ok = n = 0
  for path, w in _flat(jstate.params).items():
    n_ok += int(np.sum(np.abs(got[path] - w) <= 1e-6))
    n += w.size
  assert n_ok / n >= 0.999


def test_moe_chunk_and_flash_paths_run_the_plain_kernels(monkeypatch):
  """With the MoE FFN the attention paths stay as they were: flash runs
  the plain K1 (and K2) once per layer (twice for K1 under full remat)."""
  _, _, tmodel = _models(seed=23, use_flash_attention=True)
  calls = dict.fromkeys(("flash_fwd_reference", "flash_bwd_reference"), 0)
  for name in calls:
    fn = getattr(tattn, name)

    def counted(*a, _fn=fn, _n=name, **k):
      calls[_n] += 1
      return _fn(*a, **k)
    monkeypatch.setattr(tattn, name, counted)
  ttrain.lm_loss_and_grads(tmodel, {k: torch.from_numpy(v)
                                    for k, v in _batch(24).items()})
  n = tmodel.cfg.n_layers
  assert calls == {"flash_fwd_reference": 2 * n, "flash_bwd_reference": n}


# --- int8, serving casts, the converter --------------------------------------


def test_int8_moe_router_stays_float_and_generates_as_jax():
  """quantize_lm_params on a MoE model (tests/test_lm.py:854): the router
  stays f32 and unquantised, the expert weights quantise with JAX's axes
  (a scale per layer and output column, reduced over E and d), each
  qvalue and scale bit-equal to JAX's; greedy generation with the int8
  weights (the decode kernel's plain version on prefill and every step)
  gives JAX's tokens exactly."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s=0, model_dim=64, head_dim=16)
  tree = _tree(tcfg, seed=25)
  jq = jlm.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, tree),
                              min_size=64)
  tmodel = tlm.quantize_lm_params(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree), min_size=64)
  assert isinstance(tmodel.blocks[0].ffn.router, torch.nn.Parameter)
  assert tmodel.blocks[0].ffn.router.dtype == torch.float32
  w0 = tmodel.blocks[0].ffn.w0
  assert isinstance(w0, tlm.QuantizedWeight) and w0.scale.shape == (
      1, 1, 4 * 64)
  want = convert.load_jax_params(
      tlm.TransformerLM(tcfg), jax.tree_util.tree_map(np.asarray, jq))
  for name, value in tmodel.state_dict().items():
    assert torch.equal(value, want.state_dict()[name]), name
  prompt = np.random.default_rng(26).integers(3, 384, (2, 6))
  jtok = jlm.greedy_generate(jlm.TransformerLM(jcfg), jq,
                             jnp.asarray(prompt), 6)
  ttok = tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 6)
  np.testing.assert_array_equal(_np(ttok), _np(jtok))


def test_cast_for_serving_keeps_the_router_f32():
  """cast_lm_params_for_serving casts the expert weights to bf16 and
  leaves the router f32, leaf for leaf as JAX's cast does."""
  jcfg, tcfg = _cfgs(activation_dtype="bfloat16")
  tree = _tree(tcfg)
  jtree = jlm.cast_lm_params_for_serving(
      jax.tree_util.tree_map(jnp.asarray, tree), jcfg)
  model = tlm.cast_lm_params_for_serving(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree))
  dtypes = {n: str(p.dtype).replace("torch.", "")
            for n, p in model.state_dict().items()}
  for path, leaf in convert.flatten_tree(jtree).items():
    name = (path.replace("blocks/", "blocks.0.", 1) if path.startswith(
        "blocks/") else path).replace("/", ".")
    assert dtypes[name] == str(leaf.dtype), path
  assert dtypes["blocks.0.ffn.router"] == "float32"
  assert dtypes["blocks.0.ffn.w0"] == "bfloat16"


def test_moe_tree_converts_both_ways_and_lion_state_carries():
  """numpy_init's MoE tree has JAX's leaves and shapes (router [L, d, E]
  f32, w0 / wg [L, E, d, f], w1 [L, E, f, d]); it loads into the port and
  comes back bit-equal, and a JAX Lion state after one step carries into
  the port and back bit-equal."""
  jmodel, jparams, tmodel = _models(seed=27)
  jinit = jax.eval_shape(jmodel.init, jax.random.key(0))
  tree = _flat(jparams)
  want = {k: (tuple(v.shape), np.dtype(v.dtype))
          for k, v in convert.flatten_tree(jinit).items()}
  assert {k: (v.shape, v.dtype) for k, v in tree.items()} == want
  assert tree["blocks/ffn/router"].shape == (2, 32, 4)
  back = _flat(convert.torch_to_jax_tree(tmodel.state_dict()))
  for path in tree:
    np.testing.assert_array_equal(back[path], tree[path])
  lr = jsched.lm_lr("cosine_decay", 1e-3, num_train_steps=4, warmup_steps=1)
  jtx = jopt.build_optimizer("lion", lr)
  jstep = jax.jit(jtrain.make_lm_train_step(jmodel, jtx))
  jstate, _ = jstep(jtrain.LMTrainState(jnp.zeros((), jnp.int32), jparams,
                                        jtx.init(jparams)),
                    {k: jnp.asarray(v) for k, v in _batch(28).items()})
  host = jax.device_get(jstate)
  tstate = convert.lion_state_from_jax(
      tmodel, host.step, host.params, host.opt_state[0].momentum,
      host.opt_state[2].count)
  out = convert.lion_state_to_jax(tstate)
  for got, wnt in ((out["params"], host.params),
                   (out["momentum"], host.opt_state[0].momentum)):
    got, wnt = _flat(got), _flat(wnt)
    assert set(got) == set(wnt)
    for path in wnt:
      np.testing.assert_array_equal(got[path], wnt[path])
