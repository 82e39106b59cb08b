"""Writes tests/fixtures/jax_lm_test_run/: a run directory of the JAX
package's main_lm (lm-test with untied embeddings and float32 activations,
Lion, 3 steps, one checkpoint at the end: experiment_config.yaml and
ckpt/3/, orbax's OCDBT store of zstd-compressed zarr chunks) and
leaves.json beside it: every leaf's dtype, shape and sha256 as orbax's
restore gives them.

  JAX_PLATFORMS=cpu python tests/fixtures/make_jax_lm_test_run.py
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jax_lm_test_run")
STEPS = 3


def leaf_digests(step_dir):
  """{'/'-joined path: {dtype, shape, sha256}} of orbax's restore."""
  import jax
  import numpy as np
  import orbax.checkpoint as ocp
  tree = ocp.StandardCheckpointer().restore(
      os.path.join(os.path.abspath(step_dir), "default"))
  out = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    arr = np.array(np.asarray(leaf), order="C")   # keeps a scalar 0-d
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
    out[key] = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
  return out


def main():
  sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
  from automl_tpu.cli import main_lm
  with tempfile.TemporaryDirectory() as tmp:
    main_lm.main([f"--model_dir={tmp}", "--config_name=lm-test",
                  f"--train_steps={STEPS}",
                  "--experiment_config=tie_embeddings=false,"
                  "activation_dtype=float32"])
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    shutil.copy(os.path.join(tmp, "experiment_config.yaml"), OUT)
    shutil.copytree(os.path.join(tmp, "ckpt"), os.path.join(OUT, "ckpt"))
  digests = leaf_digests(os.path.join(OUT, "ckpt", str(STEPS)))
  with open(os.path.join(HERE, "jax_lm_test_run_leaves.json"), "w") as f:
    json.dump(digests, f, indent=1, sort_keys=True)
    f.write("\n")


if __name__ == "__main__":
  main()
