"""automl_tpu_torch's multi-process runtime on the CPU: real gloo worlds.

Two processes per launch (parallel/launch.py run_local: a file://
rendezvous, a 60 s collective timeout in each process, a deadline on the
launch). The first brings the world up from JAX's environment variables
and checks local_slice, select_local_batch and build_global_array against
the global batch. The second runs `python -m automl_tpu_torch.cli.main_lm
--mesh_shape=1,2,1 --num_processes=2` for 3 steps of lm-test (f32) on a
text file, with a validation at step 3: its metrics.jsonl losses equal a
one-process run of the same global batches (rtol 1e-5); rank 0 alone writes the checkpoint, which resumes in one
process and gives the one-process run's step 4.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARGS = ["--config_name=lm-test", "--device=cpu", "--log_every=1",
           "--experiment_config=activation_dtype=float32"]


def _env(**kw):
  env = dict(os.environ, PYTHONPATH=ROOT)
  env.update(kw)
  return env


def _worker():
  """One process of the runtime launch (its rank and store come from JAX's
  environment variables)."""
  torch.set_num_threads(1)
  from automl_tpu_torch.data.lm_pipeline import select_local_batch
  from automl_tpu_torch.parallel import (build_global_array, create_mesh,
                                         distributed, local_slice)
  distributed.initialize(timeout_secs=60)
  distributed.initialize()                         # a second call: nothing
  rank = distributed.process_index()
  assert distributed.process_count() == 2
  global_batch = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
  sl = local_slice(16)
  assert (sl.start, sl.stop) == (8 * rank, 8 * rank + 8), sl
  local = select_local_batch({"x": global_batch})["x"]
  np.testing.assert_array_equal(local, global_batch[sl])
  mesh = create_mesh((1, 2, 1), device="cpu")
  arr = build_global_array(local, mesh)
  assert tuple(arr.shape) == (16, 3)
  assert float(arr.sum().full_tensor()) == float(global_batch.sum())
  np.testing.assert_array_equal(arr.full_tensor().numpy(), global_batch)
  print(f"rank {rank} OK")


def _losses(model_dir, key="loss"):
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    return {r["step"]: r[key] for r in map(json.loads, f) if key in r}


def test_initialize_without_a_world_does_nothing(monkeypatch):
  from automl_tpu_torch.parallel import distributed
  for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "MASTER_ADDR",
               "WORLD_SIZE"):
    monkeypatch.delenv(name, raising=False)
  distributed.initialize()
  assert not torch.distributed.is_initialized()
  assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_two_process_runtime(tmp_path):
  """initialize from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
  JAX_PROCESS_ID; local_slice, select_local_batch and build_global_array
  give each process its 8 rows and one [16, 3] global array."""
  from automl_tpu_torch.parallel.launch import file_store, run_local
  store = file_store(str(tmp_path))
  outs = run_local(lambda r: [sys.executable, __file__, "runtime"], 2,
                   timeout_secs=90,
                   env=lambda r: _env(JAX_COORDINATOR_ADDRESS=store,
                                      JAX_NUM_PROCESSES="2",
                                      JAX_PROCESS_ID=str(r)))
  assert "rank 0 OK" in outs[0] and "rank 1 OK" in outs[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """(2-process model_dir, 1-process model_dir) after 3 steps each."""
  from automl_tpu_torch.cli import main_lm
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = tmp_path_factory.mktemp("main_lm")
  store = file_store(str(d))
  two, one = str(d / "two"), str(d / "one")
  words = np.random.default_rng(0).choice(["sea", "fish", "blue", "deep"],
                                          3000)
  (d / "text.txt").write_text(" ".join(words) + "\n")
  data = [f"--train_file={d / 'text.txt'}", f"--valid_file={d / 'text.txt'}",
          "--eval_every=3", "--eval_steps=2"]
  run_local(lambda r: [sys.executable, "-m", "automl_tpu_torch.cli.main_lm",
                       f"--model_dir={two}", *LM_ARGS, *data,
                       "--train_steps=3", "--mesh_shape=1,2,1",
                       f"--coordinator_address={store}",
                       "--num_processes=2", f"--process_id={r}"],
            2, timeout_secs=120, env=_env(OMP_NUM_THREADS="1"), cwd=ROOT)
  main_lm.main([f"--model_dir={one}", *LM_ARGS, *data, "--train_steps=3"])
  return two, one


def test_two_process_main_lm_matches_one_process(runs):
  """Each step's loss of the (1, 2, 1) mesh run, and the validation loss
  at step 3 (each process its rows of the held-out batches), equal the
  one-process run's, rtol 1e-5."""
  two, one = runs
  got, want = _losses(two), _losses(one)
  assert sorted(got) == [1, 2, 3] == sorted(want)
  for step in want:
    np.testing.assert_allclose(got[step], want[step], rtol=1e-5)
  got, want = (_losses(d, "validation_loss") for d in runs)
  assert sorted(got) == [3] == sorted(want)
  np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
  assert "total_params ::" in open(os.path.join(two,
                                                "params_sharding.txt")).read()


def test_rank0_checkpoint_resumes_in_one_process(runs, tmp_path):
  """One state.pt (rank 0's, the one-process format) holds the 2-process
  run's step 3; a one-process run resumes from it to step 4 with the loss
  of the one-process run resumed the same way (rtol 1e-5)."""
  from automl_tpu_torch.cli import main_lm
  two, one = runs
  ckpt = os.path.join(two, "ckpt")
  assert sorted(os.listdir(ckpt)) == ["3"]
  assert os.listdir(os.path.join(ckpt, "3")) == ["state.pt"]
  saved = torch.load(os.path.join(ckpt, "3", "state.pt"), weights_only=True)
  assert saved["step"] == 3
  assert not any(type(v) is not torch.Tensor for v in saved["params"].values())
  resumed = {}
  for name, src in (("two", two), ("one", one)):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    main_lm.main([f"--model_dir={dst}", *LM_ARGS, "--train_steps=4"])
    resumed[name] = _losses(dst)
  assert 4 in resumed["two"]
  np.testing.assert_allclose(resumed["two"][4], resumed["one"][4], rtol=1e-5)


if __name__ == "__main__":
  if sys.argv[1] == "runtime":
    _worker()
