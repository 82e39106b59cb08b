"""automl_tpu_torch's beam_search_generate against automl_tpu's on the CPU.

The model is JAX's tests/test_beam.py model (d 64, 2 layers, 4 heads over
2 kv heads of 16, V 61, f32 activations), built in both packages from one
numpy tree. Tokens must be equal, the length-normalised scores within
rtol 1e-5 (f32 log-probs summed over a few steps in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.models import beam as jbeam
from automl_tpu.models import lm as jlm
from automl_tpu_torch import convert
from automl_tpu_torch.models import beam as tbeam
from automl_tpu_torch.models import lm as tlm

torch.set_num_threads(1)

PROMPT = [5, 9, 23, 2]


@pytest.fixture(scope="module")
def pair():
  over = dict(model_dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              vocab_size=61, seq_len=64, use_flash_attention=False,
              activation_dtype="float32")
  jcfg, tcfg = jlm.lm_defaults(), tlm.lm_defaults()
  jcfg.update(over)
  tcfg.update(over)
  tree = convert.numpy_init(tcfg, 0)
  return (jlm.TransformerLM(jcfg, jlm.ShardingConfig.data_parallel()),
          jax.tree_util.tree_map(jnp.asarray, tree),
          convert.load_jax_params(tlm.TransformerLM(tcfg), tree))


def _both(pair, prompts, new, **kw):
  jmodel, jparams, tmodel = pair
  want, want_s = jbeam.beam_search_generate(
      jmodel, jparams, jnp.asarray(prompts), new, **kw)
  got, got_s = tbeam.beam_search_generate(tmodel, torch.tensor(prompts), new,
                                          **kw)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
  return got, got_s


def test_beam1_equals_greedy(pair):
  got, score = _both(pair, [PROMPT[:3]], 6, num_beams=1)
  want = tlm.greedy_generate(pair[2], torch.tensor([PROMPT[:3]]), 6)
  assert torch.equal(got, want) and torch.isfinite(score).all()


@pytest.mark.parametrize("k,lpen", [(3, 0.6), (4, 0.0)])
def test_beam_matches_jax(pair, k, lpen):
  _both(pair, [PROMPT], 5, num_beams=k, length_penalty=lpen)


def test_beam_eos_freezing_matches_jax(pair):
  """A beam that emits eos freezes (one pad continuation at no cost)."""
  base = tlm.greedy_generate(pair[2], torch.tensor([PROMPT]), 8)
  eos = int(base[0, 6])
  _both(pair, [PROMPT], 6, num_beams=3, length_penalty=0.6, eos_id=eos)


def test_beam_batched_two_rows(pair):
  """Two rows at once equal JAX's and each row alone (the cache gather
  stays inside each row's beams)."""
  p2 = [7, 3, 1, 40]
  both, s_both = _both(pair, [PROMPT, p2], 5, num_beams=3)
  for row, p in enumerate((PROMPT, p2)):
    one, s_one = tbeam.beam_search_generate(pair[2], torch.tensor([p]), 5,
                                            num_beams=3)
    assert torch.equal(both[row], one[0])
    np.testing.assert_allclose(float(s_both[row]), float(s_one[0]),
                               rtol=1e-5)


def test_top_k_keeps_lax_order_among_ties():
  """The beam's top K is lax.top_k's, the lower index first among equal
  values: what a frozen beam's -1e30 row and equal scores rely on."""
  x = np.asarray([[0.5, 2.0, 2.0, -1e30, 2.0, 0.5, -1e30, 1.0]] * 2,
                 np.float32)
  x[1, ::-1] = x[0]
  want_v, want_i = jax.lax.top_k(jnp.asarray(x), 6)
  got_v, got_i = tbeam._top_k(torch.from_numpy(x), 6)
  np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
  np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
