"""The JAX package's orbax run directories read and written by the port
(ckpt/ocdbt.py, ckpt/orbax.py, train/checkpoint.py) on the CPU, against
tensorstore and orbax (the oracles here; the port imports neither).

The JAX package writes every directory here: its run_lm (lm-test, float32
activations, untied, Lion; a target and a draft, 4 steps with a checkpoint
every 2), an LMTrainState sharded over conftest's 8 CPU devices (several
chunks per array, a bfloat16 momentum), its main_det (efficientdet-test
with EMA, fake data) and main_cls (efficientnetv2-test from TFFlowers-like
records; test_torch_data_cli.py's fixtures), and the committed fixture
tests/fixtures/jax_lm_test_run (make_jax_lm_test_run.py). The port must
read every OCDBT key and value as tensorstore does, every leaf bit for bit
as orbax's StandardRestore, serve and evaluate as JAX does on the same
directory (generate_lm tokens equal; COCO metrics within 1e-4), continue
JAX's runs (LM losses within the trajectory tests' rtol 1e-5; the
restored vision states bit-equal to convert's converters of orbax's
restore), and write directories that orbax and JAX's generate_lm read.
"""

import hashlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from automl_tpu import nn as jnn
from automl_tpu.cli import generate_lm as jgen
from automl_tpu.cli import main_cls as jmain_cls
from automl_tpu.cli import main_det as jmain_det
from automl_tpu.models import lm as jlm
from automl_tpu.train import checkpoint as jckpt
from automl_tpu.train import lm_trainer as jtrainer
from automl_tpu_torch import convert
from automl_tpu_torch.ckpt import ocdbt, orbax
from automl_tpu_torch.cli import generate_lm as tgen
from automl_tpu_torch.cli import main_cls as tmain_cls
from automl_tpu_torch.cli import main_det as tmain_det
from automl_tpu_torch.cli import main_lm as tmain_lm
from automl_tpu_torch.configs import effnet_configs as tcls_cfgs
from automl_tpu_torch.configs.efficientdet_configs import (
    get_efficientdet_config)
from automl_tpu_torch.data import datasets as tds
from automl_tpu_torch.models import efficientnet as teff
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.models.efficientdet import EfficientDet
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.train import checkpoint
from automl_tpu_torch.train import lm_trainer as ttrainer
from automl_tpu_torch.train import optimizers as topt
from automl_tpu_torch.train import runners as trun

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_data_cli import (  # noqa: E402,F401
    CLS_DATASET, CLS_HP, DET_HP, METRIC_ATOL, coco, imagenet)

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "jax_lm_test_run")
PROMPT = ["--prompt", "the quick", "--max_new_tokens", "8"]
LOSS_RTOL = 1e-5      # test_torch_lm_train's Lion trajectories


@pytest.fixture(autouse=True)
def f32_policy():
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def _lm_cfg():
  cfg = jlm.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", tie_embeddings=False))
  return cfg


def _flat(tree, path=()):
  """{'/'-joined path: leaf} of nested dicts and lists / tuples."""
  if isinstance(tree, dict):
    items = tree.items()
  elif isinstance(tree, (list, tuple)) and not hasattr(tree, "dtype"):
    items = enumerate(tree)
  else:
    return {"/".join(path): tree}
  out = {}
  for k, v in items:
    out.update(_flat(v, path + (str(k),)))
  return out


def _orbax_restore(step_dir):
  return ocp.StandardCheckpointer().restore(os.path.join(step_dir, "default"))


def _bits(x):
  """A leaf's bytes and dtype name (bfloat16 as its bits)."""
  if torch.is_tensor(x):
    name = "bfloat16" if x.dtype == torch.bfloat16 else str(
        x.numpy().dtype)
    arr = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else (
        x.numpy())
  else:
    arr = np.asarray(x)
    name = arr.dtype.name
  return name, tuple(arr.shape), np.ascontiguousarray(arr).tobytes()


def _assert_bit_equal_to_orbax(step_dir, tree=None):
  """orbax.read_step(step_dir) (or `tree`) equals orbax's restore leaf for
  leaf: dtype, shape and bytes; an empty leaf as orbax restores it."""
  got = _flat(orbax.read_step(step_dir) if tree is None else tree)
  want = _flat(_orbax_restore(step_dir))
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    g = got[k]
    if w is None or isinstance(w, (dict, list)):
      assert g == w or (g is None and w is None), k
    else:
      assert _bits(g) == _bits(w), k
  return got


def _tensorstore_items(root):
  kv = ts.KvStore.open({"driver": "ocdbt",
                        "base": "file://" + os.path.abspath(root) + "/"}
                       ).result()
  return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


# --- the directories the JAX package writes ---------------------------------


@pytest.fixture(scope="module")
def jax_lm_runs(tmp_path_factory):
  """{name: JAX run directory}: JAX's run_lm, target (seed 0) and draft
  (seed 1), 4 steps with a checkpoint every 2."""
  root = tmp_path_factory.mktemp("jax_lm")
  runs = {}
  for name, seed in (("target", 0), ("draft", 1)):
    runs[name] = str(root / name)
    jtrainer.run_lm(_lm_cfg(), runs[name], 4, learning_rate=1e-3,
                    ckpt_every=2, seed=seed)
  return runs


@pytest.fixture(scope="module")
def jax_lm_sharded(jax_lm_runs, tmp_path_factory):
  """The target's step-4 state on a (2, 4) mesh of conftest's 8 CPU
  devices (first axis over 'data', last over 'model' where they divide),
  its momentum in bfloat16, saved by JAX's CheckpointManager."""
  mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))

  def shard(x):
    x = np.asarray(x)
    spec = [None] * x.ndim
    if x.ndim and x.shape[0] % 2 == 0:
      spec[0] = "data"
    if x.ndim > 1 and x.shape[-1] % 4 == 0:
      spec[-1] = "model"
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))

  state = jax.tree_util.tree_map(
      shard, _orbax_restore(os.path.join(jax_lm_runs["target"], "ckpt", "4")))
  state["opt_state"][0]["momentum"] = jax.tree_util.tree_map(
      lambda x: x.astype(jnp.bfloat16), state["opt_state"][0]["momentum"])
  d = str(tmp_path_factory.mktemp("jax_lm_sharded") / "ckpt")
  mngr = jckpt.CheckpointManager(d)
  mngr.save(4, state)
  mngr.wait_until_finished()
  return os.path.join(d, "4")


@pytest.fixture(scope="module")
def jax_det_run(tmp_path_factory):
  """JAX's main_det: efficientdet-test, 2 steps from fake data (EMA on)."""
  d = str(tmp_path_factory.mktemp("jax_det") / "run")
  jmain_det.main(["--model_name=efficientdet-test", f"--model_dir={d}",
                  "--use_fake_data", "--train_steps=2",
                  f"--hparams={DET_HP}"])
  return d


def _cls_flags(model_dir):
  return ["--model_name=efficientnetv2-test", f"--model_dir={model_dir}",
          f"--dataset={CLS_DATASET}", f"--hparam_str={CLS_HP}"]


@pytest.fixture(scope="module")
def jax_cls_run(imagenet, tmp_path_factory):
  """JAX's main_cls: efficientnetv2-test on TFFlowers-like records, 2
  steps."""
  d = str(tmp_path_factory.mktemp("jax_cls") / "run")
  jmain_cls.main(_cls_flags(d) + [f"--data_dir={imagenet}",
                                  "--train_steps=2"])
  return d


# --- OCDBT ------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_node_store(tmp_path_factory):
  """A store tensorstore writes with 300-byte nodes (a B-tree of height 3)
  over 40 commits (versions in the manifest's version tree nodes too)."""
  root = str(tmp_path_factory.mktemp("small_nodes"))
  kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                        "config": {"max_decoded_node_bytes": 300}}).result()
  for i in range(40):
    kv.write(f"key{i:03d}", bytes([i]) * (i * 50)).result()
  return root


@pytest.mark.parametrize("which", ["lm_step", "lm_process_0", "small_nodes",
                                   "sharded", "det", "port_written"])
def test_ocdbt_keys_and_values_match_tensorstore(
    which, jax_lm_runs, jax_lm_sharded, jax_det_run, small_node_store,
    tmp_path):
  lm_step = os.path.join(jax_lm_runs["target"], "ckpt", "4", "default")
  root = {"lm_step": lm_step,
          "lm_process_0": os.path.join(lm_step, "ocdbt.process_0"),
          "small_nodes": small_node_store,
          "sharded": os.path.join(jax_lm_sharded, "default"),
          "det": os.path.join(jax_det_run, "ckpt", "2", "default"),
          "port_written": str(tmp_path / "store")}[which]
  if which == "port_written":
    rng = np.random.default_rng(0)
    ocdbt.write_store(root, [(f"k/{i}", rng.bytes(i * 37)) for i in range(60)]
                      + [("", b"empty key"), ("z", b"")])
  store = ocdbt.OcdbtStore(root)
  want = _tensorstore_items(root)
  assert store.list() == sorted(want)
  assert store.read_many(store.list()) == [want[k] for k in store.list()]


def test_ocdbt_faults_raise_value_errors(jax_lm_runs, tmp_path):
  with pytest.raises(ValueError, match="manifest.ocdbt"):
    ocdbt.OcdbtStore(str(tmp_path))
  src = os.path.join(jax_lm_runs["target"], "ckpt", "2", "default")
  for fault in ("crc", "truncate_node", "truncate_data"):
    d = tmp_path / fault
    shutil.copytree(src, d)
    if fault == "crc":
      path = d / "manifest.ocdbt"
      raw = bytearray(path.read_bytes())
      raw[20] ^= 1
      path.write_bytes(bytes(raw))
      with pytest.raises(ValueError, match="CRC32C"):
        ocdbt.OcdbtStore(str(d))
      continue
    if fault == "truncate_node":     # the root leaf, in the top store's d/
      path = next((d / "d").iterdir())
    else:                            # the largest file of values
      path = max((d / "ocdbt.process_0" / "d").iterdir(),
                 key=lambda p: p.stat().st_size)
    path.write_bytes(path.read_bytes()[:path.stat().st_size // 2])
    with pytest.raises(ValueError):
      store = ocdbt.OcdbtStore(str(d))
      store.read_many(store.list())


# --- leaves bit for bit ----------------------------------------------------


def test_committed_fixture_matches_its_digests_and_orbax():
  step_dir = os.path.join(FIXTURE, "ckpt", "3")
  with open(FIXTURE + "_leaves.json") as f:
    digests = json.load(f)
  got = _assert_bit_equal_to_orbax(step_dir)
  leaves = {k: v for k, v in got.items() if torch.is_tensor(v)}
  assert sorted(leaves) == sorted(digests)
  for k, v in leaves.items():
    name, shape, raw = _bits(v)
    assert digests[k] == {"dtype": name, "shape": list(shape),
                          "sha256": hashlib.sha256(raw).hexdigest()}, k


@pytest.mark.parametrize("which", ["lm", "lm_8_devices", "det_with_ema",
                                   "cls"])
def test_leaves_bit_equal_to_orbax_restore(which, jax_lm_runs, jax_lm_sharded,
                                           jax_det_run, jax_cls_run):
  step_dir = {"lm": os.path.join(jax_lm_runs["target"], "ckpt", "4"),
              "lm_8_devices": jax_lm_sharded,
              "det_with_ema": os.path.join(jax_det_run, "ckpt", "2"),
              "cls": os.path.join(jax_cls_run, "ckpt", "2")}[which]
  got = _assert_bit_equal_to_orbax(step_dir)
  if which == "lm_8_devices":
    keys = ocdbt.OcdbtStore(os.path.join(step_dir, "default")).list()
    assert "params.embed/1.3" in keys    # 2 x 4 chunks
    assert got["opt_state/0/momentum/embed"].dtype == torch.bfloat16
  if which == "det_with_ema":
    assert torch.is_tensor(got["ema_params/class_net/class-predict/"
                               "pointwise/kernel"])


# --- serving and evaluating JAX's directories -------------------------------


@pytest.mark.parametrize("flags", [[], ["--step", "2"],
                                   ["--draft_model_dir", "DRAFT"]],
                         ids=["latest", "step_2", "draft"])
def test_generate_lm_on_a_jax_run_matches_jax(jax_lm_runs, flags, capsys):
  flags = [jax_lm_runs["draft"] if f == "DRAFT" else f for f in flags]
  jdir = jax_lm_runs["target"]
  want = jgen.main(["--model_dir", jdir, *PROMPT, *flags])
  got = tgen.main(["--model_dir", jdir, "--device=cpu", *PROMPT, *flags])
  assert got == want
  step = "2" if "--step" in flags else "4"
  assert (f"weights of {os.path.join(jdir, 'ckpt')} at step {step}"
          in capsys.readouterr().out)


def test_committed_fixture_serves_as_jax_does():
  want = jgen.main(["--model_dir", FIXTURE, *PROMPT])
  assert tgen.main(["--model_dir", FIXTURE, "--device=cpu", *PROMPT]) == want


def test_main_cls_eval_of_a_jax_directory_matches_jax(jax_cls_run, imagenet):
  flags = _cls_flags(jax_cls_run) + [
      "--mode=eval", f"--val_file_pattern={imagenet}/tfflowers-val-*",
      "--eval_samples=6"]
  want = jmain_cls.main(flags)
  got = tmain_cls.main(flags + ["--device=cpu"])
  assert got["samples"] == 6
  for k in ("top1", "top5"):
    assert abs(got[k] - float(want[k])) <= METRIC_ATOL, (k, got, want)


def test_main_det_eval_of_a_jax_directory_matches_jax(jax_det_run, coco):
  flags = ["--mode=eval", "--model_name=efficientdet-test",
           f"--model_dir={jax_det_run}",
           f"--val_file_pattern={coco['pattern']}", "--eval_samples=8",
           f"--hparams={DET_HP}"]
  want = jmain_det.main(flags)
  got = tmain_det.main(flags + ["--device=cpu"])
  assert set(got) >= set(want) and want["ARmax100"] >= 0
  for k in want:
    assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


# --- the trainers continue JAX's runs ---------------------------------------


def _metrics(model_dir):
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  return {r["step"]: r for r in rows if "loss" in r}


def test_main_lm_continues_a_jax_run(jax_lm_runs, tmp_path):
  """JAX's run (4 steps) continued 2 steps by each package from copies of
  its directory: the same synthetic batches, losses within rtol 1e-5; the
  port's steps 5 and 6 land beside JAX's orbax steps as state.pt."""
  src = jax_lm_runs["target"]
  jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
  shutil.copytree(src, jdir)
  shutil.copytree(src, pdir)
  jtrainer.run_lm(_lm_cfg(), jdir, 6, learning_rate=1e-3, log_every=1)
  tmain_lm.main([f"--model_dir={pdir}", "--config_name=lm-test",
                 "--experiment_config=activation_dtype=float32,"
                 "tie_embeddings=false", "--learning_rate=1e-3",
                 "--train_steps=6", "--device=cpu", "--log_every=1",
                 "--compilation_cache_dir=auto"])
  want, got = _metrics(jdir), _metrics(pdir)
  for step in (5, 6):
    np.testing.assert_allclose(got[step]["loss"], want[step]["loss"],
                               rtol=LOSS_RTOL, err_msg=str(step))
  assert checkpoint.all_checkpoint_steps(os.path.join(pdir, "ckpt")) == [
      2, 4, 6]
  assert os.path.exists(os.path.join(pdir, "ckpt", "6", "state.pt"))


def test_lm_state_restored_from_jax_equals_the_converter(jax_lm_runs):
  """CheckpointManager.restore of JAX's step 4 into run_lm's template:
  step, params, Lion momentum and count bit-equal to
  convert.lion_state_from_jax of orbax's restore."""
  ckpt = os.path.join(jax_lm_runs["target"], "ckpt")
  cfg = tlm.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", tie_embeddings=False))
  tx = topt.build_optimizer("lion", lambda step: 1e-3)
  model = tlm.TransformerLM(cfg, device=torch.device("cpu"))
  got = checkpoint.CheckpointManager(ckpt).restore(
      ttrainer.init_train_state(model, tx))
  ref = jax.tree_util.tree_map(np.asarray,
                               _orbax_restore(os.path.join(ckpt, "4")))
  want = convert.lion_state_from_jax(
      tlm.TransformerLM(cfg, device=torch.device("cpu")), ref["step"],
      ref["params"], ref["opt_state"][0]["momentum"],
      ref["opt_state"][2]["count"])
  assert got.step == want.step == 4
  assert got.opt_state[2]["count"] == want.opt_state[2]["count"]
  assert got.opt_state[1] == {}
  for k, v in want.params.items():
    assert torch.equal(got.params[k], v), k
    assert torch.equal(got.opt_state[0]["momentum"][k],
                       want.opt_state[0]["momentum"][k]), k


def _assert_states_equal(got, want):
  assert got.step == want.step
  for field in ("params", "ema_params"):
    g, w = getattr(got, field), getattr(want, field)
    assert (g is None) == (w is None), field
    for k in (w or {}):
      assert torch.equal(g[k], w[k]), (field, k)
  flat_g = _flat(got.opt_state)
  flat_w = _flat(want.opt_state)
  assert sorted(flat_g) == sorted(flat_w)
  for k, w in flat_w.items():
    assert (torch.equal(flat_g[k], w) if torch.is_tensor(w)
            else flat_g[k] == w), k


def test_detection_resume_and_eval_template_restore_jax_state(jax_det_run,
                                                              tmp_path):
  """run_detection's template restored from JAX's step 2 equals
  convert.det_state_from_jax of orbax's restore bit for bit (params and BN
  statistics, momentum, count, EMA); main_det then continues the run to
  step 3 from a copy of the directory."""
  cfg = get_efficientdet_config("efficientdet-test")
  cfg.override(DET_HP)
  tprecision.set_policy("float32")
  ckpt = os.path.join(jax_det_run, "ckpt")
  template, _ = trun.detection_state(EfficientDet(cfg, device="cpu"), cfg)
  got = checkpoint.CheckpointManager(ckpt).restore(template)
  ref = jax.tree_util.tree_map(np.asarray,
                               _orbax_restore(os.path.join(ckpt, "2")))
  inner = ref["opt_state"]["inner_state"]
  want = convert.det_state_from_jax(
      EfficientDet(cfg, device="cpu"), ref["step"], ref["params"],
      checkpoint._no_none(inner[0]["trace"]), inner[1]["count"],
      ref["ema_params"], ref["normalizer"])
  _assert_states_equal(got, want)
  run = str(tmp_path / "det")
  shutil.copytree(jax_det_run, run)
  tmain_det.main(["--model_name=efficientdet-test", f"--model_dir={run}",
                  "--use_fake_data", "--train_steps=3", "--device=cpu",
                  f"--hparams={DET_HP}"])
  assert checkpoint.all_checkpoint_steps(os.path.join(run, "ckpt")) == [2, 3]


def test_classification_resume_restores_jax_state(jax_cls_run, tmp_path):
  """run_classification's template restored from JAX's step 2 equals
  convert.cls_state_from_jax of orbax's restore bit for bit (RMSProp's nu
  and momentum, count, EMA); main_cls continues the run to step 3."""
  cfg = tcls_cfgs.get_model_config("efficientnetv2-test")
  cfg.override(tds.get_dataset_config(CLS_DATASET).as_dict(),
               allow_new_keys=True)
  cfg.override(CLS_HP)
  tprecision.set_policy("float32")
  ckpt = os.path.join(jax_cls_run, "ckpt")
  template, _ = trun.classification_state(
      teff.EfficientNet(cfg.model, device="cpu"), cfg)
  got = checkpoint.CheckpointManager(ckpt).restore(template)
  ref = jax.tree_util.tree_map(np.asarray,
                               _orbax_restore(os.path.join(ckpt, "2")))
  inner = ref["opt_state"]["inner_state"]
  want = convert.cls_state_from_jax(
      teff.EfficientNet(cfg.model, device="cpu"), ref["step"], ref["params"],
      checkpoint._no_none(inner[0]["nu"]), inner[1]["count"],
      checkpoint._no_none(inner[2]["trace"]), ref["ema_params"])
  _assert_states_equal(got, want)
  run = str(tmp_path / "cls")
  shutil.copytree(jax_cls_run, run)
  tmain_cls.main(_cls_flags(run) + ["--train_steps=3", "--device=cpu"])
  assert checkpoint.all_checkpoint_steps(os.path.join(run, "ckpt")) == [2, 3]


def test_a_jax_step_that_vanishes_or_is_cut_short_raises_restore_errors(
    jax_lm_runs, tmp_path):
  """orbax's temporary step names are not steps; a step whose files are
  gone or cut short raises one of RESTORE_ERRORS (the eval skips it)."""
  ckpt = tmp_path / "ckpt"
  shutil.copytree(os.path.join(jax_lm_runs["target"], "ckpt"), ckpt)
  os.rename(ckpt / "2", ckpt / "2.orbax-checkpoint-tmp-123")
  assert checkpoint.all_checkpoint_steps(str(ckpt)) == [4]
  data = sorted((ckpt / "4" / "default" / "ocdbt.process_0" / "d").iterdir(),
                key=lambda p: p.stat().st_size)[-1]
  data.write_bytes(data.read_bytes()[:1000])
  with pytest.raises(checkpoint.RESTORE_ERRORS):
    checkpoint.saved_params(str(ckpt), 4)
  shutil.rmtree(ckpt / "4" / "default")
  with pytest.raises(checkpoint.RESTORE_ERRORS):
    checkpoint.saved_params(str(ckpt), 4)


# --- the writer -------------------------------------------------------------


def test_written_lm_run_is_read_by_orbax_and_jax(jax_lm_runs, tmp_path):
  """The port's state of JAX's step 4 written by orbax.write_step as a JAX
  run directory: orbax restores what was written bit for bit, and JAX's
  generate_lm serves it to the port's tokens."""
  src = jax_lm_runs["target"]
  cfg = tlm.get_lm_config("lm-test")
  cfg.override(dict(activation_dtype="float32", tie_embeddings=False))
  tx = topt.build_optimizer("lion", lambda step: 1e-3)
  model = tlm.TransformerLM(cfg, device=torch.device("cpu"))
  state = checkpoint.CheckpointManager(os.path.join(src, "ckpt")).restore(
      ttrainer.init_train_state(model, tx))
  jax_state = convert.lion_state_to_jax(state)
  tree = {"step": np.asarray(jax_state["step"], np.int32),
          "params": jax_state["params"],
          "opt_state": [{"momentum": jax_state["momentum"]}, None,
                        {"count": np.asarray(jax_state["count"], np.int32)}]}
  run = tmp_path / "run"
  os.makedirs(run / "ckpt")
  shutil.copy(os.path.join(src, "experiment_config.yaml"), run)
  orbax.write_step(str(run / "ckpt" / "4"), tree)
  _assert_bit_equal_to_orbax(str(run / "ckpt" / "4"), tree)
  _assert_bit_equal_to_orbax(str(run / "ckpt" / "4"))
  want = tgen.main(["--model_dir", src, "--device=cpu", *PROMPT])
  assert jgen.main(["--model_dir", str(run), *PROMPT]) == want
  assert tgen.main(["--model_dir", str(run), "--device=cpu", *PROMPT]) == want


def test_written_leaves_of_every_dtype_restore_in_orbax(tmp_path):
  """write_step of each zarr dtype the reader takes, scalars, an empty
  array, None and empty dicts / lists: orbax restores them bit for bit."""
  rng = np.random.default_rng(0)
  tree = {
      "f32": rng.normal(size=(3, 5)).astype(np.float32),
      "f16": torch.randn(4, dtype=torch.float16),
      "f64": rng.normal(size=(2,)),
      "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
      "i64": torch.arange(5),
      "u32": np.arange(3, dtype=np.uint32),
      "bool": np.array([True, False, True]),
      "bf16": torch.randn(7, 3).to(torch.bfloat16),
      "scalar": np.asarray(3, np.int32),
      "empty": np.zeros((0, 4), np.float32),
      "none": None, "no_dict": {}, "seq": [np.float32(1.5), None],
      "big": rng.normal(size=(300, 1000)).astype(np.float32),
  }
  step = str(tmp_path / "1")
  orbax.write_step(step, tree)
  _assert_bit_equal_to_orbax(step, tree)
  assert orbax.is_orbax_step(step)
  assert not os.path.exists(step + ".orbax-checkpoint-tmp")


def test_main_lm_accepts_compilation_cache_dir():
  args = tmain_lm.parse_args(["--model_dir=/tmp/x",
                              "--compilation_cache_dir=auto"])
  assert args.compilation_cache_dir == "auto"
