"""automl_tpu_torch's LMServer against automl_tpu's on the CPU.

Both packages get one config (the JAX server tests' tiny model: d 64, 2
layers, 4 heads of 16, V 97, f32 activations) and one JAX-layout parameter
tree made with numpy from a seed, and serve the same requests: greedy
tokens must be equal, log-probs within 1e-4 (f32 through two layers, in
another summation order). JAX matmuls run at "highest" precision
(tests/conftest.py). The JAX server's own cases (tests/test_lm_server.py)
hold it to its greedy_generate; the sharded servers (serve_tp on two gloo
ranks against JAX's on two devices) are in tests/test_torch_lm_sharded.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.inference import lm_server as jsrv
from automl_tpu.models import lm as jlm
from automl_tpu_torch import convert
from automl_tpu_torch.inference import lm_server as tsrv
from automl_tpu_torch.models import lm as tlm

torch.set_num_threads(1)

TINY = dict(model_dim=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
            vocab_size=97, seq_len=256, use_flash_attention=False,
            activation_dtype="float32")


def _cfgs(**kw):
  jcfg, tcfg = jlm.lm_defaults(), tlm.lm_defaults()
  jcfg.update(dict(TINY, **kw))
  tcfg.update(dict(TINY, **kw))
  return jcfg, tcfg


def _pair(seed=0, **kw):
  """(JAX model, JAX params, port model) from one numpy tree."""
  jcfg, tcfg = _cfgs(**kw)
  tree = convert.numpy_init(tcfg, seed)
  jmodel = jlm.TransformerLM(jcfg, jlm.ShardingConfig.data_parallel())
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  return jmodel, jparams, convert.load_jax_params(tlm.TransformerLM(tcfg),
                                                  tree)


@pytest.fixture(scope="module")
def pair():
  return _pair()


def _serve_both(pair, requests, shared_prefix=None, **kw):
  """The JAX and the port's server on the same (prompt, budget) list:
  (JAX results, port results, JAX server, port server)."""
  jmodel, jparams, tmodel = pair
  jserver = jsrv.LMServer(jmodel, jparams, **kw)
  tserver = tsrv.LMServer(tmodel, **kw)
  want = jserver.serve([jsrv.GenRequest(p, m) for p, m in requests],
                       shared_prefix=shared_prefix)
  got = tserver.serve([tsrv.GenRequest(p, m) for p, m in requests],
                      shared_prefix=shared_prefix)
  return want, got, jserver, tserver


def _assert_same_tokens(want, got):
  for i, (w, g) in enumerate(zip(want, got)):
    assert g.tokens == w.tokens, f"request {i}"
    assert (g.prompt_len, g.finished_by_eos, g.finished_by_stop) == (
        w.prompt_len, w.finished_by_eos, w.finished_by_stop), f"request {i}"


def _prompts(seed, lengths, low=1, high=97):
  rng = np.random.RandomState(seed)
  return [rng.randint(low, high, size=n).tolist() for n in lengths]


def test_server_token_exact_with_slot_reuse(pair):
  """5 requests through 2 slots: queued requests reuse freed slots; the
  busy slot-steps and steps are JAX's."""
  reqs = list(zip(_prompts(0, (3, 17, 9, 30, 5)), [13, 6, 21, 1, 9]))
  want, got, js, ts = _serve_both(pair, reqs, max_batch=2, max_seq_len=128,
                                  burst=4)
  _assert_same_tokens(want, got)
  assert (ts.steps, ts.busy_slot_steps) == (js.steps, js.busy_slot_steps)
  assert ts.busy_slot_steps > 0


class _TorchEosAt:
  """The port's model with token `eos` forced at query position `at_pos`
  (tests/test_lm_server.py's _EosAtPosition, for the port)."""

  def __init__(self, inner, eos, at_pos):
    self.inner, self.eos, self.at_pos = inner, eos, at_pos

  @property
  def device(self):
    return self.inner.device

  def init_cache(self, *a, **kw):
    return self.inner.init_cache(*a, **kw)

  def __call__(self, tokens, positions=None, **kw):
    b, t = tokens.shape
    if positions is None:
      positions = torch.arange(t).expand(b, t)
    logits, cache = self.inner(tokens, positions=positions, **kw)
    logits = logits.clone()
    logits[..., self.eos] += torch.where(positions == self.at_pos, 1e4, 0.0)
    return logits, cache


class _JaxEosAt:
  """The same for the JAX model (tests/test_lm_server.py's
  _EosAtPosition)."""

  def __init__(self, inner, eos, at_pos):
    self.inner, self.eos, self.at_pos = inner, eos, at_pos

  def init_cache(self, *a, **kw):
    return self.inner.init_cache(*a, **kw)

  def __call__(self, params, tokens, positions=None, **kw):
    b, t = tokens.shape
    if positions is None:
      positions = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    logits, cache = self.inner(params, tokens, positions=positions, **kw)
    bump = jnp.where(positions == self.at_pos, 1e4, 0.0)
    return logits.at[..., self.eos].add(bump), cache


def _forced(pair, forced):
  """pair with [(token, position), ...] forced in both packages."""
  jmodel, jparams, tmodel = pair
  for tok, at in forced:
    jmodel, tmodel = _JaxEosAt(jmodel, tok, at), _TorchEosAt(tmodel, tok, at)
  return jmodel, jparams, tmodel


def test_server_eos_early_stop(pair):
  """EOS (forced at position 10) frees the slot mid-burst; a prompt past
  position 10 runs its whole budget."""
  reqs = [(p, 12) for p in _prompts(1, (7, 12, 4), low=4)]
  want, got, _, _ = _serve_both(_forced(pair, [(3, 10)]), reqs,
                                max_batch=1, max_seq_len=128, burst=3,
                                eos_id=3)
  _assert_same_tokens(want, got)
  assert [len(r.tokens) for r in got] == [5, 12, 8]
  assert [r.finished_by_eos for r in got] == [True, False, True]


def test_server_logprobs_match_jax_and_teacher_forcing(pair):
  """want_logprobs: the port's per-token log-probs against JAX's server
  and against a teacher-forced forward of the port; without it, none."""
  prompt = [5, 9, 23, 2]
  want, got, _, _ = _serve_both(pair, [(prompt, 6)], max_batch=2,
                                max_seq_len=64, burst=4, want_logprobs=True)
  _assert_same_tokens(want, got)
  np.testing.assert_allclose(got[0].logprobs, want[0].logprobs, atol=1e-4)
  seq = torch.tensor([prompt + got[0].tokens])
  with torch.inference_mode():
    lsm = torch.log_softmax(pair[2](seq)[0], dim=-1)[0]
  forced = [float(lsm[len(prompt) - 1 + j, t])
            for j, t in enumerate(got[0].tokens)]
  np.testing.assert_allclose(got[0].logprobs, forced, atol=1e-4)
  plain = tsrv.LMServer(pair[2], max_batch=2, max_seq_len=64, burst=4)
  res = plain.serve([tsrv.GenRequest(prompt, 6)])[0]
  assert res.tokens == got[0].tokens and res.logprobs == []


def test_server_stop_sequences_across_and_inside_bursts(pair):
  """Stops from the model's own output (which may span the prompt), and a
  two-token stop forced at generated indices 6-7, inside the third burst
  of 3."""
  jmodel, jparams, tmodel = pair
  prompt = [5, 9, 23, 2]
  base = tsrv.LMServer(tmodel, max_batch=1, max_seq_len=64, burst=3).serve(
      [tsrv.GenRequest(prompt, 12)])[0].tokens
  want, got, _, _ = _serve_both(pair, [(prompt, 12)], max_batch=2,
                                max_seq_len=64, burst=3,
                                stop_sequences=[base[2:4]])
  _assert_same_tokens(want, got)
  assert got[0].finished_by_stop
  want, got, _, _ = _serve_both(_forced(pair, [(40, 9), (41, 10)]),
                                [(prompt, 12)], max_batch=1, max_seq_len=64,
                                burst=3, stop_sequences=[[40, 41]])
  _assert_same_tokens(want, got)
  assert got[0].tokens[-2:] == [40, 41] and len(got[0].tokens) == 8
  assert got[0].finished_by_stop and not got[0].finished_by_eos


def test_server_short_stop_fires_on_the_first_token(pair):
  """A one-token stop ends a request at its first token even when a longer
  stop widens the window (JAX's test_short_stop_fires_before_longest_stop_
  window, through the server's admission)."""
  first = tsrv.LMServer(pair[2], max_batch=1, max_seq_len=64).serve(
      [tsrv.GenRequest([5], 4)])[0].tokens[0]
  want, got, _, _ = _serve_both(pair, [([5], 8), ([7, 3], 8)], max_batch=2,
                                max_seq_len=64, burst=3,
                                stop_sequences=[[first], [90, 91, 92]])
  _assert_same_tokens(want, got)
  assert got[0].tokens == [first] and got[0].finished_by_stop


def test_chunked_prefill_token_exact(pair):
  """Prompts of 45, 70 and 23 tokens prefill in chunks of 16 (3 + 5 + 2
  chunk calls) between the bursts; tokens and the timeline are JAX's."""
  reqs = list(zip(_prompts(1, (45, 7, 70, 23)), [9, 14, 6, 11]))
  want, got, js, ts = _serve_both(pair, reqs, max_batch=2, max_seq_len=128,
                                  burst=4, prefill_chunk=16)
  _assert_same_tokens(want, got)
  kinds = [e["kind"] for e in ts.timeline]
  assert kinds.count("chunk") == 3 + 5 + 2
  assert ts.timeline == js.timeline


def test_batched_prefill_group_token_exact(pair):
  """Four prompts of bucket 16 admitted together: one prefill of group 4."""
  reqs = [(p, 8) for p in _prompts(2, (12, 9, 11, 14))]
  want, got, _, ts = _serve_both(pair, reqs, max_batch=4, max_seq_len=128,
                                 burst=4)
  _assert_same_tokens(want, got)
  prefills = [e for e in ts.timeline if e["kind"] == "prefill"]
  assert prefills[0]["group"] == 4


def test_timeline_and_request_events_match_jax(pair):
  """The device-call timeline and each request's first / done indices."""
  reqs = [(p, 5) for p in _prompts(3, (8, 8, 8))]
  want, got, js, ts = _serve_both(pair, reqs, max_batch=2, max_seq_len=64,
                                  burst=2)
  _assert_same_tokens(want, got)
  assert ts.timeline == js.timeline
  assert ts.request_events == js.request_events
  assert ts.request_events[2]["first"] > ts.request_events[0]["first"]


def test_prefix_caching_token_exact(pair):
  """shared_prefix: the template is built once and each admission
  prefills its own suffix (buckets <= 16); tokens equal JAX's and the
  port's own serving of the concatenations."""
  rng = np.random.RandomState(4)
  prefix = rng.randint(1, 97, size=19).tolist()
  prompts = [rng.randint(1, 97, size=n).tolist() for n in (5, 12, 3, 9, 7)]
  reqs = list(zip(prompts, [8, 5, 11, 6, 9]))
  want, got, js, ts = _serve_both(pair, reqs, shared_prefix=prefix,
                                  max_batch=2, max_seq_len=128, burst=4)
  _assert_same_tokens(want, got)
  assert ts.timeline == js.timeline
  assert [e["kind"] for e in ts.timeline].count("prefix") == 1
  concat = tsrv.LMServer(pair[2], max_batch=2, max_seq_len=128, burst=4)
  plain = concat.serve([tsrv.GenRequest(prefix + p, m) for p, m in reqs])
  assert [r.tokens for r in plain] == [r.tokens for r in got]


def test_prefix_caching_validations(pair):
  server = tsrv.LMServer(pair[2], max_batch=2, max_seq_len=64, burst=2)
  with pytest.raises(ValueError, match="at least one"):
    server.serve([tsrv.GenRequest([], 4)], shared_prefix=[1, 2, 3])
  with pytest.raises(ValueError, match="exceeds"):
    server.serve([tsrv.GenRequest([5], 60)], shared_prefix=[1, 2, 3, 4])


def _count_kernel_calls(monkeypatch):
  from automl_tpu_torch.ops import decode_attention as da
  calls = []
  real = da.decode_attention
  monkeypatch.setattr(da, "decode_attention",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  return calls


def test_server_decode_kernel_opt_in_token_exact(monkeypatch):
  """decode_kernel_min_s 16: the default server takes the dots (no kernel
  call), use_decode_kernel=True the kernel's plain version; both equal
  JAX's default and kernel servers."""
  pair = _pair(decode_kernel_min_s=16)
  reqs = list(zip(_prompts(1, (5, 11)), [7, 5]))
  calls = _count_kernel_calls(monkeypatch)
  for flag in (None, True):
    calls.clear()
    want, got, js, ts = _serve_both(pair, reqs, max_batch=2, max_seq_len=64,
                                    burst=4, use_decode_kernel=flag)
    _assert_same_tokens(want, got)
    assert bool(calls) == bool(flag)
    assert ts.model.cfg.use_decode_kernel == bool(flag)
    assert js.model.cfg.get("use_decode_kernel", True) == bool(flag)
  assert pair[2].cfg.use_decode_kernel      # the caller's config untouched


def test_server_kernel_flag_is_server_local(monkeypatch):
  """The ADVICE r5 divergence (ROADMAP Queue 3): JAX's LMServer with
  use_decode_kernel=True keeps a model whose config turned the kernel off,
  so no kernel runs; the port's server turns it on in its own config, and
  the caller's model and config stay as they were."""
  pair = _pair(decode_kernel_min_s=16, use_decode_kernel=False)
  jmodel, jparams, tmodel = pair
  jserver = jsrv.LMServer(jmodel, jparams, max_batch=2, max_seq_len=64,
                          use_decode_kernel=True)
  assert not jserver.model.cfg.get("use_decode_kernel", True)
  calls = _count_kernel_calls(monkeypatch)
  tserver = tsrv.LMServer(tmodel, max_batch=2, max_seq_len=64, burst=4,
                          use_decode_kernel=True)
  res = tserver.serve([tsrv.GenRequest([5, 9, 23], 6)])
  assert calls and tserver.model.cfg.use_decode_kernel
  assert not tmodel.cfg.use_decode_kernel and tserver.model is not tmodel
  want = jserver.serve([jsrv.GenRequest([5, 9, 23], 6)])
  _assert_same_tokens(want, res)


def test_server_casts_its_own_copy_of_the_weights():
  """cast_weights with bf16 activations casts the server's copy of the
  matmul weights; the caller's stay f32 (JAX's functional params)."""
  _, tcfg = _cfgs(activation_dtype="bfloat16")
  tmodel = convert.load_jax_params(tlm.TransformerLM(tcfg),
                                   convert.numpy_init(tcfg, 0))
  server = tsrv.LMServer(tmodel, max_batch=2, max_seq_len=64)
  served = dict(server.model.named_parameters())
  for name, p in tmodel.named_parameters():
    assert p.dtype == torch.float32, name
    cast = p.ndim >= 2 and name.split(".")[-1] != "embed"
    assert served[name].dtype == (torch.bfloat16 if cast else torch.float32)
    if not cast:
      assert served[name].data_ptr() == p.data_ptr(), name


def test_server_sampling_draws_from_its_generator(pair):
  """temperature > 0: tokens in the vocabulary, the budget emitted, and the
  same seed the same tokens (the draws are the server's torch.Generator's,
  not jax.random's: ROADMAP Queue 3)."""
  reqs = [tsrv.GenRequest(p, 9) for p in _prompts(5, (4, 6, 3))]
  runs = [[r.tokens for r in tsrv.LMServer(
      pair[2], max_batch=2, max_seq_len=64, burst=4, temperature=0.9,
      top_k=20, seed=seed).serve(reqs)] for seed in (7, 7, 8)]
  assert runs[0] == runs[1] != runs[2]
  for toks in runs[0]:
    assert len(toks) == 9 and all(0 <= t < 97 for t in toks)
