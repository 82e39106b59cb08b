"""automl_tpu_torch's speculative_generate against automl_tpu's on the CPU.

Target and draft are tiny f32 LMs (JAX's tests/test_speculative.py sizes:
d 32, 4 heads of 8, V 61), each built in both packages from one numpy tree.
Greedy speculation is token-exact against JAX's speculative_generate and
its greedy_generate whatever the draft. At temperature > 0 the port draws
from a torch.Generator (JAX from jax.random; ROADMAP Queue 3), so the tests
hold what the scheme guarantees: a self-draft accepts everything, tokens
stay in the vocabulary, and the first emitted token is distributed as the
target's warped softmax (a chi-square bound, below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from automl_tpu.models import lm as jlm
from automl_tpu.models import speculative as jspec
from automl_tpu_torch import convert
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.models import speculative as tspec

torch.set_num_threads(1)


def _pair(n_layers, seed, **kw):
  """(JAX model, JAX params, port model): d 32, 4 heads of 8, f32. The
  norm scales are drawn N(0, 1) (zero at init): the tokens then vary, where
  an initialised tiny model repeats one token."""
  over = dict(vocab_size=61, model_dim=32, n_layers=n_layers, n_heads=4,
              n_kv_heads=4, head_dim=8, expand_factor=2, seq_len=64,
              use_flash_attention=False, activation_dtype="float32")
  over.update(kw)
  jcfg, tcfg = jlm.lm_defaults(), tlm.lm_defaults()
  jcfg.update(over)
  tcfg.update(over)
  flat = convert.flatten_tree(convert.numpy_init(tcfg, seed))
  rng = np.random.default_rng(seed + 100)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = rng.standard_normal(value.shape).astype(np.float32)
  tree = convert.unflatten_tree(flat)
  return (jlm.TransformerLM(jcfg, jlm.ShardingConfig.data_parallel()),
          jax.tree_util.tree_map(jnp.asarray, tree),
          convert.load_jax_params(tlm.TransformerLM(tcfg), tree))


def test_speculative_greedy_exact_with_mismatched_draft():
  """A different, smaller random draft: drafts get rejected, and the
  output equals JAX's speculative and greedy outputs; the iteration count
  and acceptance are JAX's too (the same drafts and argmaxes)."""
  jt, jtp, tt = _pair(3, seed=0)
  jd, jdp, td = _pair(1, seed=7)
  prompt = np.random.RandomState(0).randint(1, 61, (2, 6))
  want, want_stats = jspec.speculative_generate(
      jt, jtp, jd, jdp, jnp.asarray(prompt), 15, n_draft=3,
      return_stats=True)
  got, stats = tspec.speculative_generate(
      tt, td, torch.from_numpy(prompt), 15, n_draft=3, return_stats=True)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(jlm.greedy_generate(jt, jtp,
                                                  jnp.asarray(prompt), 15)))
  assert stats["iterations"] == int(want_stats["iterations"])
  assert stats["emitted"] == int(want_stats["emitted"]) >= 15
  assert stats["accept_rate"] < 1.0


def test_speculative_greedy_all_accept_when_draft_is_target():
  """Draft = target: every draft verifies; ceil(new / (k + 1)) iterations."""
  jt, jtp, tt = _pair(2, seed=1)
  prompt = np.asarray([[5, 9, 2, 17, 30]])
  new, k = 12, 3
  want = jlm.greedy_generate(jt, jtp, jnp.asarray(prompt), new)
  got, stats = tspec.speculative_generate(tt, tt, torch.from_numpy(prompt),
                                          new, n_draft=k, return_stats=True)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert stats["iterations"] == -(-new // (k + 1))
  assert stats["accept_rate"] == 1.0


def test_speculative_greedy_eos_matches_jax():
  """An eos the target emits as its 5th token: both stop and pad alike."""
  jt, jtp, tt = _pair(2, seed=3)
  jd, jdp, td = _pair(1, seed=4)
  prompt = np.asarray([[3, 1, 4, 1, 5]])
  base = np.asarray(jlm.greedy_generate(jt, jtp, jnp.asarray(prompt), 12))
  eos = int(base[0, 5 + 4])
  want = jspec.speculative_generate(jt, jtp, jd, jdp, jnp.asarray(prompt), 12,
                                    n_draft=4, eos_id=eos)
  got = tspec.speculative_generate(tt, td, torch.from_numpy(prompt), 12,
                                   n_draft=4, eos_id=eos)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(jlm.greedy_generate(
          jt, jtp, jnp.asarray(prompt), 12, eos_id=eos)))


def test_speculative_sampling_self_draft_accepts_all_and_stays_in_vocab():
  """temperature 0.8, top-k 20: a self-draft's ratio p / q is 1, so every
  draft is accepted; with a mismatched draft the full length is emitted,
  every token in the vocabulary, the prompt kept."""
  _, _, tt = _pair(2, seed=5)
  _, _, td = _pair(1, seed=6)
  prompt = torch.from_numpy(np.random.RandomState(1).randint(1, 61, (2, 5)))
  gen = torch.Generator().manual_seed(2)
  got, stats = tspec.speculative_generate(
      tt, tt, prompt, 10, n_draft=3, temperature=0.8, top_k=20,
      generator=gen, return_stats=True)
  assert got.shape == (2, 15) and stats["accept_rate"] == 1.0
  assert ((got >= 0) & (got < 61)).all()
  got2 = tspec.speculative_generate(tt, td, prompt, 10, n_draft=3,
                                    temperature=0.8, generator=gen)
  assert got2.shape == (2, 15) and ((got2 >= 0) & (got2 < 61)).all()
  assert torch.equal(got2[:, :5], prompt)


# Rejection sampling keeps the target's distribution: 4,000 rows of one
# prompt, each an independent speculative draw, give 4,000 samples of the
# first new token, held against JAX's warped target softmax at the prompt's
# last position over the 5 tokens top-k keeps. Chi-square with 4 degrees of
# freedom: the bound 30 has a tail probability of 5e-6 for a right sampler.
# The draws are fixed by the seed; this run's statistic is in the assert's
# message.
CHI2_BOUND = 30.0


def test_speculative_sampling_matches_target_distribution():
  vocab, rows = 8, 4000
  jt, jtp, tt = _pair(2, seed=11, vocab_size=vocab)
  jd, jdp, td = _pair(1, seed=12, vocab_size=vocab)
  prompt = np.asarray([[3, 1, 4, 1, 5, 2]])
  temperature, top_k = 1.3, 5

  def warped(model, params):
    logits, _ = model(params, jnp.asarray(prompt))
    return np.asarray(jax.nn.softmax(jspec._warp(
        logits[0, -1], temperature, top_k, 0.0)), np.float64)

  p, q = warped(jt, jtp), warped(jd, jdp)
  gen = torch.Generator().manual_seed(0)
  got = tspec.speculative_generate(
      tt, td, torch.from_numpy(prompt).repeat(rows, 1), 1, n_draft=2,
      temperature=temperature, top_k=top_k, generator=gen)
  counts = np.bincount(got[:, prompt.shape[1]].numpy(), minlength=vocab)
  kept = p > 0
  assert kept.sum() == top_k and counts[~kept].sum() == 0

  expected = rows * p[kept]
  chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
  assert chi2 < CHI2_BOUND, (chi2, counts, rows * p)
  # The draft's own distribution is far from the target's (total variation
  # 0.55 here), so the draws come right only through the acceptance test and
  # the residual.
  assert 0.5 * np.abs(p - q).sum() > 0.3, (p, q)
