"""Resume under a hard kill (SIGKILL, no cleanup) for both port trainers.

The port's mirror of tests/test_crash_resume.py: for run_lm and
run_detection, train N steps straight against train k -> SIGKILL -> resume
-> N, on the same data stream. The final checkpoints must be exactly equal
(params, EMA, optimizer state, step), and metrics.jsonl must reach step N
with the same final loss: saves are atomic under interruption (written to
<step>.tmp, then renamed) and a rerun restarts from the latest complete
step bit for bit.

The kill comes from the data iterator: the child's stream yields one
constant batch (the straight and the resumed runs see the same data; the
detection step's random draws are seeded by the step) and SIGKILLs its own
process on the (k+1)-th request, right after step k saved its checkpoint.
The port saves synchronously, so that kill never lands inside a save; the
mid_save cases kill the child inside the save of step k + 1 instead, with
half of its file written. The children import only the port (no jax) and
run on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KILLER = textwrap.dedent("""
    import os, signal, sys
    import torch
    torch.set_num_threads(1)
    model_dir, kill_after, train_steps, kill_in_save = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

    def stream(batch):
      served = 0
      while True:
        served += 1
        if kill_after and served > kill_after:
          os.kill(os.getpid(), signal.SIGKILL)   # hard kill, no cleanup
        yield batch

    save = torch.save

    def save_and_die(obj, path):
      # The save of step kill_in_save: half its file written, then killed.
      save(obj, path)
      if f"{os.sep}{kill_in_save}.tmp{os.sep}" in str(path):
        with open(path, "r+b") as f:
          f.truncate(os.path.getsize(path) // 2)
        os.kill(os.getpid(), signal.SIGKILL)

    if kill_in_save:
      torch.save = save_and_die
""")

_DET_CHILD = _KILLER + textwrap.dedent("""
    from automl_tpu_torch.configs.efficientdet_configs import (
        get_efficientdet_config)
    from automl_tpu_torch.data import pipeline
    from automl_tpu_torch.train import runners

    template = next(iter(pipeline.SyntheticDetection(
        2, 64, max_instances=4, num_classes=3, seed=0)))
    cfg = get_efficientdet_config("efficientdet-test")
    runners.run_detection(cfg, model_dir, train_steps,
                          data_iter=stream(template), log_every=1,
                          ckpt_every=1, seed=0, device="cpu")
""")

_LM_CHILD = _KILLER + textwrap.dedent("""
    import numpy as np
    from automl_tpu_torch.models import lm as lm_lib
    from automl_tpu_torch.train import lm_trainer

    cfg = lm_lib.lm_defaults()
    cfg.override(dict(vocab_size=64, model_dim=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, head_dim=8, expand_factor=2, seq_len=16,
                      activation_dtype="float32"), allow_new_keys=True)
    batch = {"tokens": np.tile(np.arange(1, 18, dtype=np.int32),
                               (2, 1))[:, :17]}
    lm_trainer.run_lm(cfg, model_dir, train_steps, data_iter=stream(batch),
                      log_every=1, ckpt_every=1, warmup_steps=1, seed=0,
                      device="cpu")
""")


def _run_child(script: str, args, expect_kill: bool):
  env = dict(os.environ)
  env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
  proc = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                        env=env, capture_output=True, text=True, timeout=600)
  want = -signal.SIGKILL if expect_kill else 0
  assert proc.returncode == want, (proc.returncode, proc.stdout[-2000:],
                                   proc.stderr[-2000:])


def _read_metrics(model_dir):
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f if line.strip()]


def _assert_equal(a, b, where):
  """Nested dicts / lists / tuples of tensors and scalars, exactly equal."""
  assert type(a) is type(b), where
  if torch.is_tensor(a):
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert torch.equal(a, b), where
  elif isinstance(a, dict):
    assert set(a) == set(b), where
    for k in a:
      _assert_equal(a[k], b[k], f"{where}/{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_equal(x, y, f"{where}/{i}")
  else:
    assert a == b, where


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory):
  """family -> the model_dir of its straight run to N (one run each)."""
  runs = {}

  def run(family, child, n):
    if family not in runs:
      runs[family] = str(tmp_path_factory.mktemp(f"straight_{family}"))
      _run_child(child, [runs[family], 0, n, 0], expect_kill=False)
    return runs[family]
  return run


_DET_FIELDS = ("step", "params", "opt_state", "ema_params")
_LM_FIELDS = ("step", "params", "opt_state")


@pytest.mark.parametrize("family,child,fields,mid_save", [
    ("det", _DET_CHILD, _DET_FIELDS, False),
    ("lm", _LM_CHILD, _LM_FIELDS, False),
    ("det_mid_save", _DET_CHILD, _DET_FIELDS, True),
    ("lm_mid_save", _LM_CHILD, _LM_FIELDS, True),
], ids=["det", "lm", "det_mid_save", "lm_mid_save"])
def test_crash_resume_state_equivalence(tmp_path, straight_run, family,
                                        child, fields, mid_save):
  from automl_tpu_torch.train.checkpoint import all_checkpoint_steps

  n, k = 3, 2
  straight = straight_run(family.split("_")[0], child, n)
  crashed = str(tmp_path / "crashed")
  # 1) straight to N (shared by a family's cases); 2) SIGKILLed on the (k+1)-th batch request, right
  # after step k's save (mid_save: inside step k + 1's save); 3) the same
  # command again, resumed to N.
  _run_child(child, [crashed, 0, n, k + 1] if mid_save else
             [crashed, k, n, 0], expect_kill=True)
  ckpt = os.path.join(crashed, "ckpt")
  mid = all_checkpoint_steps(ckpt)
  assert mid and mid[-1] == k, mid
  partial = [d for d in os.listdir(ckpt) if d.endswith(".tmp")]
  assert partial == ([f"{k + 1}.tmp"] if mid_save else []), partial
  _run_child(child, [crashed, 0, n, 0], expect_kill=False)

  load = lambda d: torch.load(os.path.join(d, "ckpt", str(n), "state.pt"),
                              weights_only=True)
  st_a, st_b = load(straight), load(crashed)
  assert st_a["step"] == st_b["step"] == n
  for f in fields:
    assert st_a.get(f) is not None, f
  assert set(st_a) == set(st_b)
  _assert_equal(st_a, st_b, family)

  # The resumed run continues the step sequence to N and ends on the
  # straight run's loss (the same data and the same restored state). A
  # step logged before its save was cut short (the detection runner logs
  # step N before its final save) is trained and logged again.
  ma, mb = _read_metrics(straight), _read_metrics(crashed)
  assert ma[-1]["step"] == mb[-1]["step"] == n
  assert mb[-1]["loss"] == ma[-1]["loss"], (mb[-1], ma[-1])
  steps_b = [m["step"] for m in mb]
  assert steps_b[:k] == list(range(1, k + 1)), steps_b
  assert sorted(set(steps_b[k:])) == list(range(k + 1, n + 1)), steps_b
