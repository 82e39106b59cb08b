"""automl_tpu_torch LM vs automl_tpu LM on the CPU, module by module and whole.

Both packages get one config and one JAX-layout parameter tree made with
numpy from a seed (norm scales and per-dim scales perturbed away from their
zero init so they matter). Activations are f32; JAX matmuls run at
"highest" precision (tests/conftest.py). JAX's decode kernel runs in
interpret mode. Tolerances are stated per test: f32 with another summation
order and other sin/cos/tanh implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automl_tpu.models import lm as jlm
from automl_tpu_torch import convert
from automl_tpu_torch.cli import generate_lm as torch_cli
from automl_tpu_torch.models import lm as tlm

torch.set_num_threads(1)

SMALL = dict(activation_dtype="float32")
GQA = dict(activation_dtype="float32", n_kv_heads=2)


def _cfgs(name="lm-test", **kw):
  jcfg, tcfg = jlm.get_lm_config(name), tlm.get_lm_config(name)
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


def _models(jcfg, tcfg, seed=0):
  tree = _tree(tcfg, seed)
  jmodel = jlm.TransformerLM(jcfg)
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  tmodel = convert.load_jax_params(tlm.TransformerLM(tcfg), tree)
  return jmodel, jparams, tmodel


def _layer(tree, i=0):
  return jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]), tree["blocks"])


def _np(x):
  return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# --- modules -----------------------------------------------------------------


def test_rope_matches():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((2, 5, 3, 8), dtype=np.float32)
  pos = rng.integers(0, 64, (2, 5))
  want = jlm.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
  got = tlm.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
  # f32 angles up to 63 rad: sin/cos of two libraries differ by a few ulp
  np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["causal", "window", "segments", "prefix"])
def test_causal_mask_matches(kind):
  rng = np.random.default_rng(1)
  pos = np.broadcast_to(np.arange(7), (2, 7))
  kw = {}
  if kind == "window":
    kw = dict(window_size=3)
  elif kind == "segments":
    seg = np.sort(rng.integers(0, 3, (2, 7)), axis=1)
    kw = dict(segment_ids_q=seg, segment_ids_k=seg)
  elif kind == "prefix":
    pre = (np.arange(7) < 3).astype(np.int32)[None].repeat(2, 0)
    kw = dict(window_size=2, prefix_q=pre, prefix_k=pre)
  want = jlm.causal_mask(jnp.asarray(pos), jnp.asarray(pos),
                         **{k: (jnp.asarray(v) if k != "window_size" else v)
                            for k, v in kw.items()})
  got = tlm.causal_mask(torch.from_numpy(pos.copy()),
                        torch.from_numpy(pos.copy()),
                        **{k: (torch.from_numpy(v) if k != "window_size"
                               else v) for k, v in kw.items()})
  np.testing.assert_array_equal(_np(got), _np(want))


def test_rmsnorm_matches():
  rng = np.random.default_rng(2)
  x = rng.standard_normal((2, 3, 32), dtype=np.float32)
  scale = rng.standard_normal(32).astype(np.float32)
  want = jlm.RMSNorm(32, None).apply({"scale": jnp.asarray(scale)},
                                     jnp.asarray(x))
  norm = tlm.RMSNorm(32)
  norm.scale.data.copy_(torch.from_numpy(scale))
  np.testing.assert_allclose(_np(norm(torch.from_numpy(x))), _np(want),
                             atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_matches(gated):
  jcfg, tcfg = _cfgs(use_gated_ffn=gated, **SMALL)
  tree = _tree(tcfg)
  x = np.random.default_rng(3).standard_normal((2, 4, 32), dtype=np.float32)
  jffn = jlm.FFN(jcfg, jlm.ShardingConfig.data_parallel())
  want = jffn.apply(_layer(tree)["ffn"], jnp.asarray(x))
  tffn = tlm.FFN(tcfg)
  tffn.load_state_dict({k: torch.from_numpy(v[0]) for k, v in
                        tree["blocks"]["ffn"].items()})
  np.testing.assert_allclose(_np(tffn(torch.from_numpy(x))), _np(want),
                             atol=1e-5, rtol=1e-5)


def _attn_pair(jcfg, tcfg, tree):
  jattn = jlm.Attention(jcfg, jlm.ShardingConfig.data_parallel())
  tattn = tlm.Attention(tcfg)
  tattn.load_state_dict({k: torch.from_numpy(v[0]) for k, v in
                         tree["blocks"]["attn"].items()})
  return jattn, _layer(tree)["attn"], tattn


@pytest.mark.parametrize("heads", [SMALL, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("branch", ["no_cache", "dots", "kernel"])
def test_attention_branches_match(branch, heads):
  """no_cache: dense [B, T, T]; dots: the cache below decode_kernel_min_s;
  kernel: the cache at or above it (the JAX Pallas kernel in interpret
  mode, the port's decode_attention). Prefill 6 tokens into a cache of 10,
  then one decode step at index 6. atol/rtol 1e-5."""
  min_s = {"no_cache": 768, "dots": 11, "kernel": 10}[branch]
  jcfg, tcfg = _cfgs(decode_kernel_min_s=min_s, **heads)
  tree = _tree(tcfg, seed=4)
  jattn, jp, tattn = _attn_pair(jcfg, tcfg, tree)
  b, t, s = 2, 6, 10
  x = np.random.default_rng(5).standard_normal((b, t + 1, 32),
                                               dtype=np.float32)
  pos = np.broadcast_to(np.arange(t + 1), (b, t + 1)).copy()
  tol = dict(atol=1e-5, rtol=1e-5)
  if branch == "no_cache":
    mask = np.array(jlm.causal_mask(jnp.asarray(pos), jnp.asarray(pos)))
    want, _ = jattn.apply(jp, jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(mask))
    got, cache = tattn(torch.from_numpy(x), torch.from_numpy(pos),
                       torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    return
  kv_pos = np.broadcast_to(np.arange(s), (b, s))
  n_kv = tcfg.n_kv_heads
  jcache = {"k": jnp.zeros((b * n_kv, 8, s)), "v": jnp.zeros((b * n_kv, s, 8))}
  tcache = {"k": torch.zeros(b * n_kv, 8, s), "v": torch.zeros(b * n_kv, s, 8)}
  for lo, hi in ((0, t), (t, t + 1)):     # prefill, then one decode step
    mask = np.array(jlm.causal_mask(jnp.asarray(pos[:, lo:hi]),
                                    jnp.asarray(kv_pos)))
    want, jcache = jattn.apply(jp, jnp.asarray(x[:, lo:hi]),
                               jnp.asarray(pos[:, lo:hi]), jnp.asarray(mask),
                               cache=jcache, cache_index=lo)
    got, tcache = tattn(torch.from_numpy(x[:, lo:hi]),
                        torch.from_numpy(pos[:, lo:hi]),
                        torch.from_numpy(mask), cache=tcache, cache_index=lo)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for key in ("k", "v"):
      np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **tol)


def test_kernel_gate_follows_config(monkeypatch):
  """use_decode_kernel / decode_kernel_min_s pick the branch as in JAX."""
  calls = []
  from automl_tpu_torch.ops import decode_attention as da
  real = da.decode_attention
  monkeypatch.setattr(da, "decode_attention",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  x = torch.zeros(1, 1, 32)
  pos = torch.zeros(1, 1, dtype=torch.int64)
  for kw, used in ((dict(decode_kernel_min_s=8), True),
                   (dict(decode_kernel_min_s=9), False),
                   (dict(decode_kernel_min_s=0, use_decode_kernel=False),
                    False)):
    _, tcfg = _cfgs(**kw, **SMALL)
    attn = tlm.Attention(tcfg)
    for p in attn.parameters():
      p.data.zero_()
    calls.clear()
    cache = {"k": torch.zeros(4, 8, 8), "v": torch.zeros(4, 8, 8)}
    attn(x, pos, torch.ones(1, 1, 8, dtype=torch.bool), cache, 0)
    assert bool(calls) == used, kw


@pytest.mark.parametrize("heads", [SMALL, GQA], ids=["mha", "gqa"])
def test_transformer_block_matches(heads):
  jcfg, tcfg = _cfgs(use_post_ln=True, **heads)
  tree = _tree(tcfg, seed=6)
  jblock = jlm.TransformerBlock(jcfg, jlm.ShardingConfig.data_parallel())
  tblock = tlm.TransformerBlock(tcfg)
  tblock.load_state_dict({k.split(".", 2)[2]: v for k, v in
                          convert.jax_to_torch_state(tree).items()
                          if k.startswith("blocks.0.")})
  rng = np.random.default_rng(7)
  x = rng.standard_normal((2, 5, 32), dtype=np.float32)
  pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
  mask = np.array(jlm.causal_mask(jnp.asarray(pos), jnp.asarray(pos)))
  want, _, _ = jblock.apply(_layer(tree), jnp.asarray(x), jnp.asarray(pos),
                            jnp.asarray(mask))
  got, _ = tblock(torch.from_numpy(x), torch.from_numpy(pos),
                  torch.from_numpy(mask))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# --- the slice as a whole ----------------------------------------------------


@pytest.mark.parametrize("heads", [SMALL, GQA], ids=["mha", "gqa"])
def test_lm_logits_match_without_and_with_cache(heads):
  """Logits [B, T, V] (capped at 30), atol 1e-4: f32 through 2 layers."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s=0, **heads)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=8)
  tokens = np.random.default_rng(9).integers(0, 384, (2, 9))
  want, _ = jmodel(jparams, jnp.asarray(tokens))
  got, cache = tmodel(torch.from_numpy(tokens))
  assert cache is None
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)

  s = 12
  kv_pos = np.broadcast_to(np.arange(s), (2, s)).copy()
  pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
  want_c, _ = jmodel(jparams, jnp.asarray(tokens), positions=jnp.asarray(pos),
                     cache=jmodel.init_cache(2, s), cache_index=0,
                     kv_positions=jnp.asarray(kv_pos))
  got_c, cache = tmodel(torch.from_numpy(tokens),
                        positions=torch.from_numpy(pos),
                        cache=tmodel.init_cache(2, s), cache_index=0,
                        kv_positions=torch.from_numpy(kv_pos))
  assert len(cache) == tcfg.n_layers
  np.testing.assert_allclose(_np(got_c), _np(want_c), atol=1e-4, rtol=1e-4)
  hidden, _ = tmodel(torch.from_numpy(tokens), return_hidden=True)
  assert hidden.shape == (2, 9, 32)


@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_vjp"])
def test_unembed_bf16_modes_match(mode):
  """bf16 operands, f32 accumulation in both packages: atol 1e-4."""
  jcfg, tcfg = _cfgs(unembed_matmul_dtype=mode, **SMALL)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=15)
  tokens = np.random.default_rng(16).integers(0, 384, (2, 5))
  want, _ = jmodel(jparams, jnp.asarray(tokens))
  got, _ = tmodel(torch.from_numpy(tokens))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_vjp"])
def test_unembed_bf16_modes_grads_match_jax(mode, tied):
  """dx and dW of sum(unembed_logits(x) * r), capped at 30, against jax.grad
  of the JAX unembed_logits. "bfloat16_vjp" casts the cotangent to bf16
  and returns dx and dW unrounded in f32, as JAX's custom vjp does: rtol
  1e-5, atol 1e-6. Plain autograd of the bf16 forward (the "bfloat16"
  mode) rounds both grads to bf16 in both packages, after f32 sums taken in
  another order, so an entry may end one bf16 step apart: rtol 2^-7."""
  jcfg, tcfg = _cfgs(unembed_matmul_dtype=mode, tie_embeddings=tied, **SMALL)
  rng = np.random.default_rng(17)
  x = rng.standard_normal((2, 16, 32)).astype(np.float32)
  w = (rng.standard_normal((384, 32) if tied else (32, 384)) * 0.3).astype(
      np.float32)
  r = rng.standard_normal((2, 16, 384)).astype(np.float32)
  name = "embed" if tied else "unembed"

  def jloss(x, w):
    return jnp.sum(jlm.unembed_logits({name: w}, x, jcfg) * jnp.asarray(r))

  want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
  model = tlm.TransformerLM(tcfg, device="meta")
  tw = torch.nn.Parameter(torch.from_numpy(w))
  setattr(model, name, tw)
  tx = torch.from_numpy(x).requires_grad_()
  (tlm.unembed_logits(model, tx) * torch.from_numpy(r)).sum().backward()
  tol = (dict(rtol=1e-5, atol=1e-6) if mode == "bfloat16_vjp"
         else dict(rtol=2 ** -7, atol=1e-6))
  for got, wnt in zip((tx.grad, tw.grad), want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(wnt), **tol)


@pytest.mark.parametrize("heads", [SMALL, GQA], ids=["mha", "gqa"])
def test_greedy_generate_token_exact(heads):
  """Token-exact against JAX greedy_generate with its Pallas decode kernel
  on for prefill and every step (decode_kernel_min_s=0); log-probs of the
  chosen tokens within 1e-4."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s=0, **heads)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=10)
  prompt = np.random.default_rng(11).integers(3, 384, (2, 7))
  want, want_lp = jlm.greedy_generate(jmodel, jparams, jnp.asarray(prompt), 9,
                                      return_logprobs=True)
  got, got_lp = tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 9,
                                    return_logprobs=True)
  assert got.shape == (2, 16)
  np.testing.assert_array_equal(_np(got), _np(want))
  np.testing.assert_allclose(_np(got_lp), _np(want_lp), atol=1e-4)


def test_greedy_generate_eos_and_stop_early_exit():
  """eos_id and stop sequences end rows as in JAX: token-exact, with
  finished rows padded with 0."""
  jcfg, tcfg = _cfgs(**GQA)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=12)
  prompt = np.random.default_rng(13).integers(3, 384, (2, 4))
  fixed = _np(tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 8))
  eos = int(fixed[0, 4 + 2])
  stops = [[int(fixed[1, 5]), int(fixed[1, 6])], [999]]
  for kw in (dict(eos_id=eos), dict(stop_sequences=stops)):
    want = jlm.greedy_generate(jmodel, jparams, jnp.asarray(prompt), 8, **kw)
    got = tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 8, **kw)
    np.testing.assert_array_equal(_np(got), _np(want))
  got = _np(tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 8,
                                eos_id=eos))
  cut = 4 + int(np.nonzero(fixed[0, 4:] == eos)[0][0])   # row 0's first eos
  np.testing.assert_array_equal(got[0, :cut + 1], fixed[0, :cut + 1])
  assert (got[0, cut + 1:] == 0).all()


@pytest.mark.parametrize("trunc", [dict(top_k=5), dict(top_p=0.6),
                                   dict(top_k=6, top_p=0.5)],
                         ids=["top_k", "top_p", "both"])
def test_sampling_truncation_sets_match(trunc):
  """The port keeps exactly the tokens that JAX's sample_logits can draw:
  4000 JAX draws per row cover the kept set and never leave it, and the
  port's own draws stay inside it."""
  logits = np.random.default_rng(14).standard_normal((2, 32)).astype(
      np.float32)
  kept = tlm.truncate_logits(torch.from_numpy(logits), **trunc) > -1e8
  keys = jax.random.split(jax.random.key(0), 4000)
  draws = np.asarray(jax.vmap(lambda k: jlm.sample_logits(
      k, jnp.asarray(logits), 1.0, **trunc))(keys))             # [4000, 2]
  for row in range(2):
    assert set(draws[:, row].tolist()) == set(
        np.nonzero(kept[row].numpy())[0].tolist())
  gen = torch.Generator().manual_seed(0)
  for _ in range(50):
    tok = tlm.sample_logits(torch.from_numpy(logits), 1.0, generator=gen,
                            **trunc)
    assert kept[torch.arange(2), tok].all()


def test_cast_lm_params_for_serving_matches_jax_dtypes():
  jcfg, tcfg = _cfgs(activation_dtype="bfloat16", tie_embeddings=False)
  tree = _tree(tcfg)
  jtree = jlm.cast_lm_params_for_serving(
      jax.tree_util.tree_map(jnp.asarray, tree), jcfg)
  model = tlm.cast_lm_params_for_serving(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree))
  back = convert.torch_to_jax_tree(
      {k: v.float() for k, v in model.state_dict().items()})
  dtypes = {n: str(p.dtype).replace("torch.", "")
            for n, p in model.state_dict().items()}
  for path, leaf in convert.flatten_tree(jtree).items():
    if path.startswith("blocks/"):
      _, rest = path.split("/", 1)
      name = "blocks.0." + rest.replace("/", ".")
    else:
      name = path.replace("/", ".")
    assert dtypes[name] == str(leaf.dtype), path
  assert set(convert.flatten_tree(back)) == set(convert.flatten_tree(jtree))


def test_generate_cli_smoke(tmp_path, capsys):
  """The port's generate_lm on the CPU: a named config with seeded weights,
  and a model_dir holding a JAX-initialised params.npz."""
  out = torch_cli.main(["--config_name=lm-test", "--device=cpu",
                        "--prompt=hi", "--max_new_tokens=4", "--logprobs"])
  assert len(out) == 1 and "logprobs:" in capsys.readouterr().out

  jcfg = jlm.get_lm_config("lm-test")
  jcfg.override(dict(activation_dtype="float32"))
  params = jlm.TransformerLM(jcfg).init(jax.random.key(0))
  convert.save_npz(tmp_path / "params.npz",
                   jax.tree_util.tree_map(np.asarray, params))
  (tmp_path / "experiment_config.yaml").write_text(yaml.safe_dump(
      jcfg.as_dict()))
  out = torch_cli.main([f"--model_dir={tmp_path}", "--device=cpu",
                        "--prompt=ab", "--max_new_tokens=3", "--stop_at_eos",
                        "--stop=zz"])
  assert len(out) == 1


@pytest.mark.parametrize("option", [
    "serve_tp=True", "serve_sp=True", "use_ring_attention=True"])
def test_unported_options_raise(option):
  _, tcfg = _cfgs(**SMALL)
  tcfg.override(option)
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    tlm.TransformerLM(tcfg, device="meta")


# --- per-row cache_index (continuous batching) -------------------------------


@pytest.mark.parametrize("branch", ["dots", "kernel"])
def test_vector_cache_index_matches_scalar_and_jax(branch):
  """A [B] cache_index of equal entries writes and attends as the scalar
  one does (bit-equal logits and cache); a row parked at S leaves its cache
  rows bit-equal to before. Logits against JAX's vector path: 1e-4."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s={"dots": 33, "kernel": 32}[branch],
                     **GQA)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=20)
  b, t0, s = 2, 6, 32
  toks = np.random.default_rng(21).integers(3, 384, (b, t0))
  kv_pos = np.broadcast_to(np.arange(s), (b, s)).copy()
  with torch.inference_mode():
    got_s, cache_s = tmodel(torch.from_numpy(toks), cache=tmodel.init_cache(
        b, s), cache_index=0, kv_positions=torch.from_numpy(kv_pos))
    got_v, cache_v = tmodel(torch.from_numpy(toks), cache=tmodel.init_cache(
        b, s), cache_index=torch.zeros(b, dtype=torch.int64),
        kv_positions=torch.from_numpy(kv_pos))
  assert torch.equal(got_s, got_v)
  for cs, cv in zip(cache_s, cache_v):
    assert torch.equal(cs["k"], cv["k"]) and torch.equal(cs["v"], cv["v"])
  want, jcache = jmodel(jparams, jnp.asarray(toks),
                        cache=jmodel.init_cache(b, s),
                        cache_index=jnp.zeros((b,), jnp.int32),
                        kv_positions=jnp.asarray(kv_pos))
  np.testing.assert_allclose(_np(got_v), _np(want), atol=1e-4, rtol=1e-4)

  step = np.random.default_rng(22).integers(3, 384, (b, 1))
  pos = np.full((b, 1), t0)
  before = [{k: x.clone() for k, x in layer.items()} for layer in cache_v]
  idx = np.asarray([t0, s])
  with torch.inference_mode():
    got, cache_p = tmodel(torch.from_numpy(step), positions=torch.from_numpy(
        pos), cache=cache_v, cache_index=torch.from_numpy(idx),
        kv_positions=torch.from_numpy(kv_pos))
  want, _ = jmodel(jparams, jnp.asarray(step), positions=jnp.asarray(pos),
                   cache=jcache, cache_index=jnp.asarray(idx),
                   kv_positions=jnp.asarray(kv_pos))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
  n_kv = tcfg.n_kv_heads
  for old, new in zip(before, cache_p):
    assert not torch.equal(old["k"][:n_kv], new["k"][:n_kv])   # row 0 wrote
    assert torch.equal(old["k"][n_kv:], new["k"][n_kv:])       # row 1 parked
    assert torch.equal(old["v"][n_kv:], new["v"][n_kv:])


def _drop_write_reference(kc, vc, k, v, pos):
  """numpy: JAX's scatter with mode="drop" on the rank-3 cache."""
  kc, vc = kc.copy(), vc.copy()
  b, t, n_kv, _ = k.shape
  s = kc.shape[-1]
  for bi in range(b):
    for j in range(t):
      if 0 <= pos[bi, j] < s:
        for h in range(n_kv):
          kc[bi * n_kv + h, :, pos[bi, j]] = k[bi, j, h]
          vc[bi * n_kv + h, pos[bi, j]] = v[bi, j, h]
  return kc, vc


@pytest.mark.parametrize("form", ["per_row_offset", "explicit"])
def test_cache_write_drops_out_of_range_and_survives_collisions(form):
  """The per-row write against JAX's drop semantics, bit for bit. Row 0
  writes S-2 and S-1 while its other tokens are out of range (a clamp to
  S-1 would collide with the real write at S-1); row 1 writes nothing; row
  2 writes inside."""
  rng = np.random.default_rng(23)
  b, t, n_kv, hd, s = 3, 4, 2, 8, 16
  kc = rng.standard_normal((b * n_kv, hd, s)).astype(np.float32)
  vc = rng.standard_normal((b * n_kv, s, hd)).astype(np.float32)
  k = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
  v = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
  if form == "per_row_offset":
    idx = np.asarray([s - 2, s, 5])
    pos = idx[:, None] + np.arange(t)
  else:
    idx = pos = np.asarray([[s + 1, s - 2, s, s - 1], [s, s + 7, s, s],
                            [3, 9, 4, 0]])
  want_k, want_v = _drop_write_reference(kc, vc, k, v, pos)
  tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
  tlm._write_cache(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                   tlm._row_writes(torch.from_numpy(idx), t, s, n_kv))
  np.testing.assert_array_equal(tk.numpy(), want_k)
  np.testing.assert_array_equal(tv.numpy(), want_v)


def test_attention_explicit_positions_match_jax():
  """A chunk prefill's [B, T] positions with the tail parked at S (the
  server's chunks) through Attention against JAX's: outputs and the written
  cache within 1e-5; the parked positions keep their old values exactly."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s=0, **GQA)
  tree = _tree(tcfg, seed=24)
  jattn, jp, tattn = _attn_pair(jcfg, tcfg, tree)
  b, t, s, n_kv = 1, 8, 16, tcfg.n_kv_heads
  rng = np.random.default_rng(25)
  x = rng.standard_normal((b, t, 32), dtype=np.float32)
  pos = (4 + np.arange(t))[None]
  write = np.where(pos < 9, pos, s)
  mask = np.array(jlm.causal_mask(jnp.asarray(pos),
                                  jnp.asarray(np.arange(s)[None])))
  kc = rng.standard_normal((b * n_kv, 8, s)).astype(np.float32)
  vc = rng.standard_normal((b * n_kv, s, 8)).astype(np.float32)
  want, jcache = jattn.apply(jp, jnp.asarray(x), jnp.asarray(pos),
                             jnp.asarray(mask),
                             cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                             cache_index=jnp.asarray(write))
  tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
  got, _ = tattn(torch.from_numpy(x), torch.from_numpy(pos),
                 torch.from_numpy(mask), cache=tcache,
                 cache_index=tlm._row_writes(torch.from_numpy(write), t, s,
                                             n_kv))
  np.testing.assert_allclose(_np(got[:, :5]), _np(want[:, :5]), atol=1e-5,
                             rtol=1e-5)
  for key in ("k", "v"):
    np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=1e-5,
                               rtol=1e-5)
  np.testing.assert_array_equal(_np(tcache["k"])[:, :, 9:], kc[:, :, 9:])
  np.testing.assert_array_equal(_np(tcache["v"])[:, 9:], vc[:, 9:])


# --- combined qkv ------------------------------------------------------------


@pytest.mark.parametrize("heads", [SMALL, GQA], ids=["mha", "gqa"])
def test_combined_qkv_matches_jax_and_separate_weights(heads):
  """use_combined_qkv: wqkv [3, d, n, h] where the heads match, wq + wkv
  [2, d, n_kv, h] under GQA (numpy_init stacks the separate draws). Logits
  against JAX and against the separate weights: 1e-4; greedy tokens equal
  JAX's."""
  jcfg, tcfg = _cfgs(use_combined_qkv=True, decode_kernel_min_s=0, **heads)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=26)
  attn = tmodel.blocks[0].attn
  assert hasattr(attn, "wqkv") == (heads is SMALL)
  assert hasattr(attn, "wkv") == (heads is GQA)
  _, sep_cfg = _cfgs(decode_kernel_min_s=0, **heads)
  sep = convert.load_jax_params(tlm.TransformerLM(sep_cfg), _tree(sep_cfg, 26))
  tokens = np.random.default_rng(27).integers(3, 384, (2, 9))
  want, _ = jmodel(jparams, jnp.asarray(tokens))
  got, _ = tmodel(torch.from_numpy(tokens))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
  np.testing.assert_allclose(_np(got), _np(sep(torch.from_numpy(tokens))[0]),
                             atol=1e-4, rtol=1e-4)
  prompt = tokens[:, :5]
  np.testing.assert_array_equal(
      _np(tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 7)),
      _np(jlm.greedy_generate(jmodel, jparams, jnp.asarray(prompt), 7)))


# --- int8 weights --------------------------------------------------------------

INT8 = dict(activation_dtype="float32", model_dim=64, head_dim=16)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_quantize_lm_params_bit_equal_to_jax(tied):
  """The port's quantize_lm_params against JAX's on one tree: the same
  weights quantised (attention at d 64 and the FFN, embed / unembed; not
  the norm scales), each qvalue and scale bit-equal; convert loads JAX's
  int8 tree into the same module layout."""
  jcfg, tcfg = _cfgs(tie_embeddings=tied, **INT8)
  tree = _tree(tcfg, seed=28)
  jq = jlm.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, tree))
  loaded = convert.load_jax_params(
      tlm.TransformerLM(tcfg), jax.tree_util.tree_map(np.asarray, jq))
  ours = tlm.quantize_lm_params(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree))
  want, got = loaded.state_dict(), ours.state_dict()
  assert set(want) == set(got)
  quantized = {k for k in got if k.endswith(".qvalue")}
  assert "blocks.0.attn.wq.qvalue" in quantized and "blocks.1.ffn.w1.qvalue" \
      in quantized and ("embed.qvalue" in quantized) and (
          tied or "unembed.qvalue" in quantized)
  for name in got:
    assert got[name].dtype == want[name].dtype, name
    assert torch.equal(got[name], want[name]), name


def test_int8_generation_token_exact():
  """Greedy generation with int8 weights (GQA, the kernel's plain version
  on prefill and every step) equals JAX's on its quantised tree; log-probs
  within 1e-4."""
  jcfg, tcfg = _cfgs(decode_kernel_min_s=0, n_kv_heads=2, **INT8)
  tree = _tree(tcfg, seed=29)
  jmodel = jlm.TransformerLM(jcfg)
  jparams = jlm.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, tree))
  tmodel = tlm.quantize_lm_params(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree))
  prompt = np.random.default_rng(30).integers(3, 384, (2, 6))
  want, want_lp = jlm.greedy_generate(jmodel, jparams, jnp.asarray(prompt), 8,
                                      return_logprobs=True)
  got, got_lp = tlm.greedy_generate(tmodel, torch.from_numpy(prompt), 8,
                                    return_logprobs=True)
  np.testing.assert_array_equal(_np(got), _np(want))
  np.testing.assert_allclose(_np(got_lp), _np(want_lp), atol=1e-4)


def test_cast_for_serving_leaves_int8_weights_alone():
  """After quantisation, cast_lm_params_for_serving keeps qvalue int8 and
  scale f32 (as JAX's cast skips {qvalue, scale} leaves); JAX's own cast of
  its int8 tree gives the same dtypes leaf for leaf."""
  jcfg, tcfg = _cfgs(activation_dtype="bfloat16", model_dim=64, head_dim=16)
  tree = _tree(tcfg)
  jtree = jlm.cast_lm_params_for_serving(
      jlm.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, tree)), jcfg)
  model = tlm.cast_lm_params_for_serving(tlm.quantize_lm_params(
      convert.load_jax_params(tlm.TransformerLM(tcfg), tree)))
  dtypes = {n: str(p.dtype).replace("torch.", "")
            for n, p in model.state_dict().items()}
  for path, leaf in convert.flatten_tree(jtree).items():
    name = (path.replace("blocks/", "blocks.0.", 1) if path.startswith(
        "blocks/") else path).replace("/", ".")
    assert dtypes[name] == str(leaf.dtype), path


# --- the CLI -------------------------------------------------------------------


def test_generate_cli_beam_draft_server_and_int8(tmp_path, capsys,
                                                 monkeypatch):
  """Each mode of the port's generate_lm on the CPU returns one completion
  per prompt: beams, a draft model directory, the server on stdin prompts
  with a system prompt and chunked prefill, and int8 weights."""
  import io
  _, dcfg = _cfgs(**SMALL)
  convert.save_npz(tmp_path / "params.npz", convert.numpy_init(dcfg, 3))
  (tmp_path / "experiment_config.yaml").write_text(yaml.safe_dump(
      dcfg.as_dict()))
  base = ["--config_name=lm-test", "--device=cpu", "--max_new_tokens=5"]
  assert len(torch_cli.main(base + ["--prompt=hi", "--num_beams=3"])) == 1
  out = torch_cli.main(base + ["--prompt=hi", f"--draft_model_dir={tmp_path}",
                               "--n_draft=2", "--int8"])
  assert len(out) == 1
  monkeypatch.setattr("sys.stdin", io.StringIO("first prompt\nb\n\nthird\n"))
  out = torch_cli.main(base + ["--serve_slots=2", "--prefill_chunk=4",
                               "--system_prompt=sys: ", "--logprobs"])
  assert len(out) == 3 and capsys.readouterr().out.count("logprobs:") == 3


@pytest.mark.parametrize("flags,error,match", [
    (["--serve_mode=tp"], NotImplementedError, "M10"),
    (["--mesh_model=4"], NotImplementedError, "M10"),
    (["--tokenizer=/nonexistent/spm.model"], FileNotFoundError,
     "spm.model"),
    (["--num_beams=2", "--serve_slots=2"], ValueError, "num_beams"),
    (["--draft_model_dir=/tmp/d", "--logprobs"], ValueError, "draft"),
], ids=["serve_mode", "mesh_model", "tokenizer", "beams_with_slots",
        "draft_with_logprobs"])
def test_generate_cli_refusals(flags, error, match):
  with pytest.raises(error, match=match):
    torch_cli.main(["--config_name=lm-test", "--device=cpu", "--prompt=a"]
                   + flags)


# --- chunked local attention -------------------------------------------------


@pytest.mark.parametrize("cap", [50.0, 0.0], ids=["cap", "no_cap"])
@pytest.mark.parametrize("segments", [False, True], ids=["plain", "segments"])
def test_chunked_local_attn_matches_jax(segments, cap):
  """chunked_local_attn on [2, 32, 4, 8] with chunks of 8, with and
  without segment ids and the cap: atol 1e-5 (f32)."""
  rng = np.random.default_rng(40)
  q, k, v = (rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
             for _ in range(3))
  pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
  seg = np.sort(rng.integers(0, 4, (2, 32)), axis=1) if segments else None
  want = jlm.chunked_local_attn(
      *(jnp.asarray(x) for x in (q, k, v, pos)), 8, cap,
      segment_ids=None if seg is None else jnp.asarray(seg))
  got = tlm.chunked_local_attn(
      *(torch.from_numpy(x) for x in (q, k, v, pos)), 8, cap,
      segment_ids=None if seg is None else torch.from_numpy(seg))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
  with pytest.raises(ValueError, match="window_chunk_size"):
    tlm.chunked_local_attn(*(torch.from_numpy(x) for x in (q, k, v, pos)), 7)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("segments", [False, True], ids=["plain", "segments"])
def test_window_chunk_path_matches_jax(flash, segments, monkeypatch):
  """use_window_chunk with window_chunk_size 16 (T 64, GQA 4/2), with and
  without use_flash_attention and segment ids: logits atol 1e-4 against
  JAX's, grads of the summed logits atol 3e-4, rtol 1e-3. The chunk branch
  comes before the flash one, as in JAX: the flash kernel never runs; the
  prefix-LM markers still take the materialised mask."""
  from automl_tpu_torch.ops import attention as tattn
  kw = dict(use_window_chunk=True, window_chunk_size=16,
            use_flash_attention=flash, **GQA)
  jcfg, tcfg = _cfgs(**kw)
  jmodel, jparams, tmodel = _models(jcfg, tcfg, seed=41)
  rng = np.random.default_rng(42)
  tokens = rng.integers(0, 384, (2, 64))
  seg = np.sort(rng.integers(1, 4, (2, 64)), axis=1) if segments else None
  calls = []
  monkeypatch.setattr(tattn, "flash_attention",
                      lambda *a, **k: calls.append(1))
  jseg = None if seg is None else jnp.asarray(seg)
  want_logits, _ = jmodel(jparams, jnp.asarray(tokens), segment_ids=jseg)
  tseg = None if seg is None else torch.from_numpy(seg)
  got, _ = tmodel(torch.from_numpy(tokens), segment_ids=tseg)
  np.testing.assert_allclose(_np(got), _np(want_logits), atol=1e-4,
                             rtol=1e-4)
  (got * 1e-2).sum().backward()
  want_grads = jax.grad(
      lambda p: jnp.sum(jmodel(p, jnp.asarray(tokens), segment_ids=jseg)[0]
                        * 1e-2))(jparams)
  ours = convert.flatten_tree(convert.torch_to_jax_tree(
      {k: p.grad for k, p in tmodel.named_parameters()}))
  for path, w in convert.flatten_tree(want_grads).items():
    np.testing.assert_allclose(_np(ours[path]), _np(w), atol=3e-4, rtol=1e-3,
                               err_msg=path)
  assert not calls
  prefix = torch.zeros((2, 64), dtype=torch.int64)
  prefix[:, :5] = 1
  with torch.no_grad():
    got_p, _ = tmodel(torch.from_numpy(tokens), causal_attention=prefix)
  want_p, _ = jmodel(jparams, jnp.asarray(tokens),
                     causal_attention=jnp.asarray(prefix.numpy()))
  np.testing.assert_allclose(_np(got_p), _np(want_p), atol=1e-4, rtol=1e-4)


# --- distillation and the scaling summary ------------------------------------


@pytest.mark.parametrize("temperature", [1.0, 2.5])
@pytest.mark.parametrize("weighted", [False, True])
def test_distill_loss_matches_jax(weighted, temperature):
  """distill_loss rtol 1e-6, and its gradient in the student's logits
  against jax.grad (atol 1e-8, rtol 1e-5)."""
  rng = np.random.default_rng(43)
  s = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
  t = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
  w = (rng.random((2, 5)) < 0.7).astype(np.float32) if weighted else None
  jw = None if w is None else jnp.asarray(w)
  want, want_g = jax.value_and_grad(jlm.distill_loss)(
      jnp.asarray(s), jnp.asarray(t), jw, temperature)
  ts = torch.from_numpy(s).requires_grad_()
  got = tlm.distill_loss(ts, torch.from_numpy(t),
                         None if w is None else torch.from_numpy(w),
                         temperature)
  got.backward()
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
  np.testing.assert_allclose(_np(ts.grad), _np(want_g), atol=1e-8,
                             rtol=1e-5)


@pytest.mark.parametrize("name", ["", *sorted(jlm.lm_experiment_configs())],
                         ids=["lm_defaults", *sorted(
                             jlm.lm_experiment_configs())])
def test_scaling_summary_matches_jax(name):
  """scaling_summary on lm_defaults and every named config, and on each
  untied and ungated: the same integers as JAX's."""
  for kw in ({}, dict(tie_embeddings=False, use_gated_ffn=False)):
    jcfg, tcfg = _cfgs(name, **kw) if name else (
        jlm.get_lm_config(""), tlm.get_lm_config(""))
    if not name:
      jcfg.override(kw)
      tcfg.override(kw)
    assert tlm.scaling_summary(tcfg) == jlm.scaling_summary(jcfg)
