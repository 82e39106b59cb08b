"""Train -> serve with the port on the CPU: generate_lm --model_dir over the
run directories that the port's run_lm / main_lm write.

As the JAX package's tests/test_cli_smoke.py::test_generate_lm_cli_end_to_end
(every assertion, on the port's run directory of lm-test, 4 steps with a
checkpoint every 2), plus --step, the draft's directory, the refusals, a
pipeline-trained directory, and parity with the JAX package (JAX's own
run directory served too): JAX's run_lm
trains an untied lm-test, its load_model's params at steps 2 and 4 go
through convert into a port state.pt, the port's loader must give JAX's
params and prefill logits at each step, and the port's generate_lm JAX's
greedy text token for token, for a target and for a draft. Activations
are f32.
"""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from automl_tpu.cli import generate_lm as jgen
from automl_tpu.models import lm as jlm
from automl_tpu.train import lm_trainer as jtrainer
from automl_tpu_torch import convert
from automl_tpu_torch.cli import generate_lm as tgen
from automl_tpu_torch.config import Config
from automl_tpu_torch.data import lm_pipeline
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.train import checkpoint
from automl_tpu_torch.train import lm_trainer as ttrainer
from automl_tpu_torch.train import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = ["--prompt", "abcabc", "--max_new_tokens", "6"]


def _cfg(lib, **overrides):
  cfg = lib.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", **overrides))
  return cfg


def _gen(model_dir, *flags):
  return tgen.main(["--model_dir", model_dir, "--device=cpu", *flags])


def _restored(model_dir, step=None):
  """The model of model_dir's yaml with step `step`'s params, cast for
  serving as generate_lm casts them."""
  config = Config({}).update(os.path.join(model_dir,
                                          "experiment_config.yaml"))
  model = tlm.TransformerLM(config, device=torch.device("cpu"))
  checkpoint.restore_params(os.path.join(model_dir, "ckpt"),
                            dict(model.named_parameters()), step)
  return tlm.cast_lm_params_for_serving(model)


def _greedy_text(model, prompt, n):
  tok = lm_pipeline.ByteTokenizer()
  ids = tok.encode(prompt)
  out = tlm.greedy_generate(model, torch.tensor([ids]), n)
  return tok.decode(out[0, len(ids):].tolist())


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
  """The port's run_lm on lm-test: 4 steps, a checkpoint every 2."""
  d = str(tmp_path_factory.mktemp("train_to_serve") / "lm")
  ttrainer.run_lm(_cfg(tlm), d, 4, learning_rate=1e-3, ckpt_every=2,
                  device="cpu")
  return d


@pytest.fixture(scope="module")
def greedy(run_dir):
  return _gen(run_dir, *PROMPT)


@pytest.fixture
def no_process_group_left():
  """A sharded mode brings up a world of one; take it down after."""
  was_up = dist.is_initialized()
  yield
  if not was_up and dist.is_initialized():
    dist.destroy_process_group()


def test_run_directory_serves_its_latest_step(run_dir, greedy, capsys):
  assert checkpoint.all_checkpoint_steps(os.path.join(run_dir, "ckpt")) == [
      2, 4]
  assert len(greedy) == 1 and isinstance(greedy[0], str)
  assert greedy == [_greedy_text(_restored(run_dir), "abcabc", 6)]
  _gen(run_dir, *PROMPT)
  out = capsys.readouterr().out
  assert f"weights of {os.path.join(run_dir, 'ckpt')} at step 4" in out


def test_int8_sampling(run_dir):
  outs = _gen(run_dir, "--prompt", "xy", "--max_new_tokens", "4", "--int8",
              "--temperature", "0.7", "--top_k", "5")
  assert len(outs) == 1 and isinstance(outs[0], str)


def test_serve_slots_equal_greedy(run_dir, greedy):
  assert _gen(run_dir, *PROMPT, "--serve_slots", "2") == greedy


@pytest.mark.parametrize("slots", [[], ["--serve_slots", "2"]],
                         ids=["plain", "slots"])
@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_sharded_serving_equal_greedy(run_dir, greedy, mode, slots,
                                      no_process_group_left):
  """--serve_mode at a world of one: the model built on its mesh (a
  DTensor takes its part of each saved tensor), token-exact."""
  assert _gen(run_dir, *PROMPT, "--serve_mode", mode, *slots) == greedy


def test_stop_plain_and_slots_agree(run_dir, greedy):
  stop = ["--stop", greedy[0][:2]]
  plain = _gen(run_dir, *PROMPT, *stop)
  slots = _gen(run_dir, *PROMPT, *stop, "--serve_slots", "2")
  assert plain == slots
  assert greedy[0].startswith(plain[0].rstrip("\x00"))


def test_num_beams_and_its_refusal(run_dir):
  outs = _gen(run_dir, *PROMPT, "--num_beams", "3")
  assert len(outs) == 1 and isinstance(outs[0], str)
  with pytest.raises(ValueError, match="num_beams"):
    _gen(run_dir, "--prompt", "x", "--num_beams", "2", "--serve_slots", "2")


@pytest.mark.parametrize("slots", [[], ["--serve_slots", "2"]],
                         ids=["plain", "slots"])
def test_logprobs_leave_the_completion(run_dir, greedy, slots, capsys):
  assert _gen(run_dir, *PROMPT, "--logprobs", *slots) == greedy
  assert "logprobs:" in capsys.readouterr().out


@pytest.fixture(scope="module")
def untied_run_dir(tmp_path_factory):
  """lm-test untied, 4 steps, a checkpoint every 2. (Tied lm-test repeats
  the prompt's last byte at step 2 and at step 4 alike: its logits are led
  by the input token's own embedding.)"""
  d = str(tmp_path_factory.mktemp("train_to_serve") / "untied")
  ttrainer.run_lm(_cfg(tlm, tie_embeddings=False), d, 4, learning_rate=1e-3,
                  ckpt_every=2, device="cpu")
  return d


def test_step_serves_that_step(untied_run_dir, capsys):
  flags = ["--prompt", "abcabc", "--max_new_tokens", "8"]
  at2 = _gen(untied_run_dir, *flags, "--step", "2")
  at4 = _gen(untied_run_dir, *flags, "--step", "4")
  assert "at step 2" in capsys.readouterr().out
  assert at2 == [_greedy_text(_restored(untied_run_dir, 2), "abcabc", 8)]
  assert at4 == [_greedy_text(_restored(untied_run_dir, 4), "abcabc", 8)]
  assert at4 == _gen(untied_run_dir, *flags)          # the latest
  assert at2 != at4


def test_draft_model_dir_is_a_run_directory(run_dir, untied_run_dir,
                                            greedy, capsys):
  """The draft is read as --model_dir at its latest step (with --int8 as
  the target); greedy speculative decoding is token-exact."""
  assert _gen(run_dir, *PROMPT, "--draft_model_dir", untied_run_dir) == \
      greedy
  out = capsys.readouterr().out
  assert (f"weights of {os.path.join(untied_run_dir, 'ckpt')} at step 4"
          in out)
  assert len(_gen(run_dir, *PROMPT, "--draft_model_dir", untied_run_dir,
                  "--int8")) == 1


def test_restore_params_takes_the_stacked_layout(run_dir):
  """A pipeline model's [L, ...] parameters restored from the per-layer
  names of a checkpoint (names=lm.stacked_layers)."""
  ckpt = os.path.join(run_dir, "ckpt")
  saved = checkpoint.saved_params(ckpt, step=2)
  stacked = {k: torch.zeros_like(v)
             for k, v in tlm.stacked_layers(saved).items()}
  assert any(v.dim() and k.startswith("blocks.") and
             not k.split(".")[1].isdigit() for k, v in stacked.items())
  assert checkpoint.restore_params(ckpt, stacked, step=2,
                                   names=tlm.stacked_layers) == 2
  for k, v in tlm.stacked_layers(saved).items():
    assert torch.equal(stacked[k], v), k


def test_pipeline_trained_directory_serves(tmp_path, capsys):
  """main_lm with use_pipeline over two stages (two gloo processes, mesh
  (1, 1, 2)) writes per-layer names; the plain serving model reads them."""
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = str(tmp_path / "pp")
  store = file_store(str(tmp_path))
  env = dict(os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
  run_local(lambda r: [
      sys.executable, "-m", "automl_tpu_torch.cli.main_lm",
      f"--model_dir={d}", "--config_name=lm-test", "--device=cpu",
      "--mesh_shape=1,1,2", "--train_steps=2", "--log_every=1",
      "--experiment_config=use_pipeline=true,pipeline_microbatches=2,"
      "activation_dtype=float32",
      f"--coordinator_address={store}", "--num_processes=2",
      f"--process_id={r}"], nproc=2, timeout_secs=180, env=env)
  config, model = tgen.load_model(model_dir=d, device="cpu")
  assert config.use_pipeline and not model.stacked
  saved = checkpoint.saved_params(os.path.join(d, "ckpt"))
  assert "blocks.1.attn.wq" in saved
  for k, p in model.named_parameters():
    assert torch.equal(p.detach(), saved[k]), k
  outs = _gen(d, *PROMPT)
  assert outs == [_greedy_text(_restored(d), "abcabc", 6)]
  assert f"weights of {os.path.join(d, 'ckpt')} at step 2" in \
      capsys.readouterr().out


# --- the refusals ------------------------------------------------------------


def test_refuses_a_run_directory_without_a_checkpoint(tmp_path):
  _cfg(tlm).save_to_yaml(str(tmp_path / "experiment_config.yaml"))
  os.makedirs(tmp_path / "ckpt")
  with pytest.raises(FileNotFoundError, match=re.escape(
      f"no checkpoint under {tmp_path / 'ckpt'}")):
    _gen(str(tmp_path), *PROMPT)
  os.rmdir(tmp_path / "ckpt")
  with pytest.raises(FileNotFoundError, match="no checkpoint under"):
    _gen(str(tmp_path), *PROMPT)


def test_refuses_a_missing_step(run_dir):
  with pytest.raises(FileNotFoundError, match="no checkpoint of step 3"):
    _gen(run_dir, *PROMPT, "--step", "3")


def test_refuses_step_on_a_params_npz_directory(tmp_path):
  cfg = _cfg(tlm)
  convert.save_npz(str(tmp_path / "params.npz"), convert.numpy_init(cfg, 0))
  cfg.save_to_yaml(str(tmp_path / "experiment_config.yaml"))
  assert len(_gen(str(tmp_path), *PROMPT)) == 1
  with pytest.raises(ValueError, match="params.npz, which has no steps"):
    _gen(str(tmp_path), *PROMPT, "--step", "2")


def test_refuses_step_without_a_model_dir():
  with pytest.raises(ValueError, match="--step"):
    tgen.main(["--config_name=lm-test", "--device=cpu", "--prompt=a",
               "--step=2"])


# --- parity with the JAX package ---------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
  """{name: (JAX run directory, the port's run directory of the same
  params)} for a target and a draft (lm-test untied, seeds 0 and 1: tied
  lm-test repeats the prompt's last byte whatever its weights), each
  trained 4 steps by JAX's run_lm with a checkpoint every 2; the port's
  directory holds steps 2 and 4 of JAX's load_model."""
  root = tmp_path_factory.mktemp("jax_runs")
  runs = {}
  for name, seed in (("target", 0), ("draft", 1)):
    jdir, pdir = str(root / f"jax_{name}"), str(root / f"port_{name}")
    jtrainer.run_lm(_cfg(jlm, tie_embeddings=False), jdir, 4,
                    learning_rate=1e-3, ckpt_every=2, seed=seed)
    os.makedirs(pdir)
    with open(os.path.join(jdir, "experiment_config.yaml")) as f:
      yaml_text = f.read()
    with open(os.path.join(pdir, "experiment_config.yaml"), "w") as f:
      f.write(yaml_text)
    config = Config({}).update(os.path.join(pdir, "experiment_config.yaml"))
    tx = topt.build_optimizer(config.get("optimizer", "lion"),
                              lambda step: 1e-3)
    mngr = checkpoint.CheckpointManager(os.path.join(pdir, "ckpt"))
    for step in (2, 4):
      _, _, params = jgen.load_model(jdir, step=step)
      model = convert.load_jax_params(
          tlm.TransformerLM(config, device=torch.device("cpu")),
          jax.tree_util.tree_map(np.asarray, params))
      mngr.save(step, ttrainer.init_train_state(model, tx)._replace(
          step=step))
    runs[name] = (jdir, pdir)
  return runs


@pytest.mark.parametrize("step", [2, 4])
@pytest.mark.parametrize("name", ["target", "draft"])
def test_served_params_and_logits_match_jax(jax_runs, name, step):
  """The CLI's loader at --step against JAX's load_model at that step:
  every parameter (under convert's names) exactly, and one prefill's
  logits (f32) within 1e-5, so a wrong step or name fails."""
  jdir, pdir = jax_runs[name]
  _, jmodel, jparams = jgen.load_model(jdir, step=step)
  _, model = tgen.load_model(model_dir=pdir, device="cpu", step=step)
  want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
  got = {k: p.detach().numpy()
         for k, p in convert.load_jax_params(
             tlm.TransformerLM(model.cfg, device=torch.device("cpu")),
             convert.unflatten_tree(want)).named_parameters()}
  served = dict(model.named_parameters())
  assert sorted(got) == sorted(served)
  for k, v in got.items():
    np.testing.assert_array_equal(served[k].detach().numpy(), v, err_msg=k)
  tokens = np.random.default_rng(step).integers(0, 256, (2, 16))
  jlogits = np.asarray(jmodel.apply(jparams, jax.numpy.asarray(tokens))[0])
  with torch.no_grad():
    tlogits = model(torch.from_numpy(tokens))[0].numpy()
  np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
  other = 2 if step == 4 else 4
  _, _, jother = jgen.load_model(jdir, step=other)
  assert not np.allclose(
      np.asarray(jmodel.apply(jother, jax.numpy.asarray(tokens))[0]),
      tlogits, atol=1e-3)


@pytest.mark.parametrize("name", ["target", "draft"])
def test_greedy_text_matches_jax(jax_runs, name):
  jdir, pdir = jax_runs[name]
  flags = ["--prompt", "abcabc", "--max_new_tokens", "8"]
  want = jgen.main(["--model_dir", jdir, *flags])
  got = _gen(pdir, *flags)
  assert got == want
  tok = lm_pipeline.ByteTokenizer()
  assert tok.encode(got[0]) == tok.encode(want[0])


def test_speculative_with_a_draft_matches_jax(jax_runs):
  (jt, pt), (jd, pd) = jax_runs["target"], jax_runs["draft"]
  flags = ["--prompt", "the quick", "--max_new_tokens", "8"]
  want = jgen.main(["--model_dir", jt, "--draft_model_dir", jd, *flags])
  assert _gen(pt, "--draft_model_dir", pd, *flags) == want
  assert want == jgen.main(["--model_dir", jt, *flags])


def test_refuses_a_jax_orbax_run_directory(jax_runs):
  """Once refused, now served: JAX's run directory itself (orbax
  checkpoints) gives the tokens of JAX's generate_lm on it."""
  jdir, _ = jax_runs["target"]
  assert _gen(jdir, *PROMPT) == jgen.main(["--model_dir", jdir, *PROMPT])
