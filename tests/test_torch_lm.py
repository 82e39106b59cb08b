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
    "serve_tp=True", "serve_sp=True",
    "use_window_chunk=True", "use_ring_attention=True",
    "use_combined_qkv=True", "moe_num_experts=4"])
def test_unported_options_raise(option):
  _, tcfg = _cfgs(**SMALL)
  tcfg.override(option)
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    tlm.TransformerLM(tcfg, device="meta")


def test_vector_cache_index_raises():
  _, tcfg = _cfgs(**SMALL)
  attn = tlm.Attention(tcfg)
  for p in attn.parameters():
    p.data.zero_()
  cache = {"k": torch.zeros(4, 8, 8), "v": torch.zeros(4, 8, 8)}
  with pytest.raises(NotImplementedError, match="M7"):
    attn(torch.zeros(1, 1, 32), torch.zeros(1, 1, dtype=torch.int64),
         torch.ones(1, 1, 8, dtype=torch.bool), cache, torch.tensor([0]))
