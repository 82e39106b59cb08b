"""automl_tpu_torch config, LM configs and parameter converter vs automl_tpu."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from automl_tpu import config as jconfig
from automl_tpu.models import lm as jlm
from automl_tpu_torch import config as tconfig
from automl_tpu_torch import convert
from automl_tpu_torch.models import lm as tlm

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("src", [
    "a=3,b.c=x,d=4*2,e=1|2*3,f=none,g=true",
    {"a": 1.5, "b": {"c": "y"}},
])
def test_config_update_and_override_match(src, tmp_path):
  base = {"a": 1, "b": {"c": "z", "k": 2.0}, "d": [1], "e": None,
          "f": 0, "g": False}
  j, t = jconfig.Config(base), tconfig.Config(base)
  assert j.override(src).as_dict() == t.override(src).as_dict()
  j.save_to_yaml(str(tmp_path / "c.yaml"))
  assert (tconfig.Config({}).update(str(tmp_path / "c.yaml")).as_dict()
          == jconfig.Config({}).update(str(tmp_path / "c.yaml")).as_dict())
  with pytest.raises(KeyError):
    t.override("nope=1")
  assert t.override("nope=1", allow_new_keys=True).nope == 1


@pytest.mark.parametrize("how", ["string", "dict", "yaml"])
def test_bool_key_takes_a_mode_word(how, tmp_path):
  """fused_softmax_loss defaults to False; an override of "pallas" or "scan"
  keeps the word in the port (so the fused loss is reached), and "true"
  gives True. automl_tpu's Config turns both words into False: a fault of
  the reference that the port does not copy (ROADMAP, Queue 3)."""
  def source(value):
    if how == "string":
      return f"fused_softmax_loss={value}"
    if how == "dict":
      return {"fused_softmax_loss": value}
    path = tmp_path / f"{value}.yaml"
    path.write_text(f"fused_softmax_loss: {value}\n")
    return str(path)

  for value, want in (("pallas", "pallas"), ("scan", "scan"), ("true", True)):
    t = tlm.get_lm_config("lm-test").override(source(value))
    assert t.fused_softmax_loss == want, value
    j = jlm.get_lm_config("lm-test").override(source(value))
    assert j.fused_softmax_loss == (want if value == "true" else False), value


@pytest.mark.parametrize("name", ["", "lm-test", "lm-flops2e17",
                                  "lm-flops1e18", "lm-flops1e19"])
def test_lm_configs_equal_jax(name):
  assert tlm.get_lm_config(name).as_dict() == jlm.get_lm_config(name).as_dict()
  assert tlm.lm_experiment_configs() == jlm.lm_experiment_configs()
  with pytest.raises(ValueError, match="unknown LM config"):
    tlm.get_lm_config("lm-nope")


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(n_kv_heads=2, use_post_ln=True, tie_embeddings=False,
         use_gated_ffn=False, use_per_dim_scale=False),
], ids=["lm-test", "variants"])
def test_numpy_torch_numpy_round_trip_is_identity(overrides, tmp_path):
  cfg = tlm.get_lm_config("lm-test")
  cfg.override(overrides)
  tree = convert.numpy_init(cfg, seed=3)
  model = convert.load_jax_params(tlm.TransformerLM(cfg), tree)
  back = convert.torch_to_jax_tree(model.state_dict())
  flat, flat_back = convert.flatten_tree(tree), convert.flatten_tree(back)
  assert set(flat) == set(flat_back)
  for path, value in flat.items():
    assert flat_back[path].dtype == value.dtype, path
    np.testing.assert_array_equal(flat_back[path], value)
  # the per-layer list layout (use_scan=False) converts to the same state
  layers = [jax.tree_util.tree_map(lambda a: a[i], tree["blocks"])
            for i in range(cfg.n_layers)]
  state = convert.jax_to_torch_state(dict(tree, blocks=layers))
  for k, v in model.state_dict().items():
    np.testing.assert_array_equal(state[k].numpy(), v.numpy())
  convert.save_npz(tmp_path / "params.npz", tree)
  loaded = convert.flatten_tree(convert.load_npz(tmp_path / "params.npz"))
  for path, value in flat.items():
    np.testing.assert_array_equal(loaded[path], value)


def test_param_count_and_shapes_match_jax_lm_flops1e19():
  """338,184,192 params: jax.eval_shape of the JAX init against the torch model
  on the meta device (neither allocates)."""
  jcfg, tcfg = jlm.get_lm_config("lm-flops1e19"), tlm.get_lm_config(
      "lm-flops1e19")
  shapes = jax.eval_shape(jlm.TransformerLM(jcfg).init, jax.random.key(0))
  model = tlm.TransformerLM(tcfg, device="meta")
  jax_count = sum(int(np.prod(s.shape))
                  for s in jax.tree_util.tree_leaves(shapes))
  assert sum(p.numel() for p in model.parameters()) == jax_count
  assert jax_count == 338_184_192
  params = dict(model.named_parameters())
  for path, s in convert.flatten_tree(shapes).items():
    shape = tuple(s.shape)
    if path.startswith("blocks/"):   # stacked [L, ...] -> one block's leaf
      assert shape[0] == tcfg.n_layers
      path, shape = "blocks/0/" + path.split("/", 1)[1], shape[1:]
    p = params[path.replace("/", ".")]
    assert (tuple(p.shape), str(p.dtype)) == (shape, f"torch.{s.dtype}"), path


def test_import_automl_tpu_torch_loads_no_jax():
  code = ("import sys\n"
          "import automl_tpu_torch\n"
          "from automl_tpu_torch import config, convert\n"
          "from automl_tpu_torch.models import lm\n"
          "from automl_tpu_torch.ops import attention, decode_attention, xent\n"
          "from automl_tpu_torch.ops import cuda_build\n"
          "from automl_tpu_torch.data import lm_pipeline\n"
          "from automl_tpu_torch.train import (checkpoint, lm_trainer,\n"
          "                                    metrics, optimizers, schedules)\n"
          "from automl_tpu_torch.cli import generate_lm, main_lm\n"
          "bad = sorted(m for m in sys.modules\n"
          "             if m.split('.')[0] in ('jax', 'jaxlib', 'automl_tpu'))\n"
          "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
