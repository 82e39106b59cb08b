"""automl_tpu_torch's detection serving (inference/driver.py) and its CLIs
(cli/inspector.py, infer_cls --runmode=export) against automl_tpu's on
the CPU, on efficientdet-test and efficientnetv2-test in float32.

ServingDriver.serve is held against JAX's ServingDriver.serve from one
JAX-layout tree, for the three post modes, at 64 x 64 and at a non-square
75 x 100 (resized on the device), twice:
  teacher-forced  the port's serve program around a stand-in network that
                  returns JAX's own raw outputs: the preprocess within
                  atol 2e-6 of JAX's (tests/test_torch_postprocess.py),
                  and the detections within PR 11's postprocess limits:
                  valid_len and classes exact, boxes within 4 float32
                  steps of the largest coordinate, scores within atol
                  1e-6 after hard NMS (combined) and within rtol 1e-5
                  after gaussian NMS (per_class, global: PR 11's limit
                  for the soft methods, whose up to 100 decays compound
                  the last-bit differences of the two packages' exp);
  end to end      both networks: the confident detections (score > 0.5)
                  pair up, same class, scores within 1e-5 and boxes within
                  1e-3 px (PR 11's float32 limits for entry(); the two f32
                  forwards differ by a few 1e-6 in the logits, and the
                  gaussian tail below is chaotic across implementations).
The exported programs must equal the eager ones bit for bit on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from automl_tpu import nn as jnn
from automl_tpu.data import preprocessing as jpre
from automl_tpu.inference import driver as jdriver
from automl_tpu.inference import visualize as jvis
from automl_tpu_torch import convert
from automl_tpu_torch.cli import infer_cls as tinfer
from automl_tpu_torch.cli import inspector as tinspector
from automl_tpu_torch.cli import main_det as tmain_det
from automl_tpu_torch.inference import driver as tdriver
from automl_tpu_torch.nn import precision as tprecision
from automl_tpu_torch.ops import depthwise as tdw

torch.set_num_threads(1)
KEYS = ("boxes", "scores", "classes", "valid_len")


@pytest.fixture(autouse=True)
def restore_policy():
  """ServingDriver sets the process-wide policy, as JAX's does."""
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def _tree(model, seed=0):
  """A seeded JAX-layout tree whose class-predict bias is 0 (scores
  spread around 0.5, so every image keeps its 100 detections)."""
  tree = convert.det_numpy_init(model, seed)
  tree["class_net"]["class-predict"]["pointwise"]["bias"][:] = 0.0
  return tree


def _drivers(post_mode="per_class", batch_size=2, seed=0):
  td = tdriver.ServingDriver("efficientdet-test", batch_size=batch_size,
                             mixed_precision=False, post_mode=post_mode,
                             device="cpu")
  tree = _tree(td.model, seed)
  convert.load_det_params(td.model, tree)
  td._loaded()
  jd = jdriver.ServingDriver("efficientdet-test", batch_size=batch_size,
                             mixed_precision=False, post_mode=post_mode)
  jd.params = jax.tree_util.tree_map(jnp.asarray, tree)
  return td, jd, tree


def _assert_boxes_close(got, want, what=""):
  """tests/test_torch_postprocess.py's limit: 4 float32 steps of the
  largest coordinate."""
  atol = 4 * float(np.spacing(np.float32(np.abs(want).max())))
  np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _assert_confident_match(got, want, thresh=0.5, score_tol=1e-5,
                            box_tol=1e-3):
  """Every detection above `thresh` on either side has a partner on the
  other, in the same image, with the same class, its score within
  score_tol and every coordinate within box_tol px."""
  n = 0
  for src, dst in ((want, got), (got, want)):
    for b in range(src["scores"].shape[0]):
      for i in range(int(src["valid_len"][b])):
        if src["scores"][b, i] <= thresh:
          continue
        n += 1
        k = int(dst["valid_len"][b])
        ok = ((dst["classes"][b, :k] == src["classes"][b, i])
              & (np.abs(dst["scores"][b, :k] - src["scores"][b, i])
                 <= score_tol)
              & (np.abs(dst["boxes"][b, :k] - src["boxes"][b, i]).max(-1)
                 <= box_tol))
        assert ok.any(), (b, i, src["scores"][b, i])
  assert n >= 4


class _JaxOutputs(torch.nn.Module):
  """A stand-in network: records its input and returns fixed raw outputs
  (JAX's, NCHW)."""

  def __init__(self, config, cls_out, box_out):
    super().__init__()
    self.config = config
    self.outputs = (cls_out, box_out)
    self.inputs = []

  def forward(self, x, train=False):
    assert not train
    self.inputs.append(x)
    return self.outputs


def _nchw(levels):
  return [torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())
          for a in levels]


@pytest.mark.parametrize("hw", [(64, 64), (75, 100)], ids=["64x64",
                                                           "75x100"])
@pytest.mark.parametrize("post_mode", ["per_class", "global", "combined"])
def test_serve_matches_jax(post_mode, hw):
  """serve against JAX's serve, teacher-forced and end to end (module
  docstring): 2 random uint8 images, valid_len exact in both."""
  td, jd, _ = _drivers(post_mode)
  images = np.random.default_rng(hw[1]).integers(0, 256, (2, *hw, 3)).astype(
      np.uint8)
  want = jd.serve(images)
  got = td.serve(images)
  assert {k: got[k].shape for k in KEYS} == {k: want[k].shape for k in KEYS}
  np.testing.assert_array_equal(got["valid_len"], want["valid_len"])
  _assert_confident_match(got, want)

  cfg = jd.config
  size = 64
  normalized = jax.vmap(lambda im: jpre.det_eval_preprocess(
      im, size, cfg.mean_rgb, cfg.stddev_rgb)[0])(
          jnp.asarray(images, jnp.float32))
  cls_out, box_out = jax.jit(lambda p, x: jd.model(p, x, train=False))(
      jd.params, normalized)
  stub = _JaxOutputs(td.config, _nchw(cls_out), _nchw(box_out))
  with torch.no_grad():
    forced = tdriver.ServeProgram(stub, post_mode)(torch.from_numpy(images))
  np.testing.assert_allclose(stub.inputs[0].permute(0, 2, 3, 1).numpy(),
                             np.asarray(normalized), rtol=0, atol=2e-6)
  forced = {k: v.numpy() for k, v in zip(KEYS, forced)}
  np.testing.assert_array_equal(forced["valid_len"], want["valid_len"])
  assert int(want["valid_len"].min()) > 10
  _assert_boxes_close(forced["boxes"], want["boxes"], "boxes")
  np.testing.assert_array_equal(forced["classes"], want["classes"])
  tol = (dict(rtol=0, atol=1e-6) if post_mode == "combined"
         else dict(rtol=1e-5, atol=0))
  np.testing.assert_allclose(forced["scores"], want["scores"], **tol)


def test_driver_options_and_refusals():
  """post_mode is checked; serve before load raises; the policy follows
  mixed_precision; export_saved_model and export_tflite raise
  NotImplementedError naming TensorFlow; export with the K6 knob on
  raises a ValueError that says so."""
  with pytest.raises(ValueError, match="post_mode"):
    tdriver.ServingDriver("efficientdet-test", post_mode="soft",
                          device="cpu")
  td = tdriver.ServingDriver("efficientdet-test", device="cpu")
  assert tprecision.get_policy().compute_dtype == torch.bfloat16
  with pytest.raises(RuntimeError, match="load"):
    td.serve(np.zeros((1, 64, 64, 3), np.uint8))
  td = tdriver.ServingDriver("efficientdet-test", mixed_precision=False,
                             device="cpu").init_random(1)
  assert tprecision.get_policy().compute_dtype == torch.float32
  for fn in (td.export_saved_model, td.export_tflite):
    with pytest.raises(NotImplementedError, match="TensorFlow"):
      fn("/nonexistent")
  tdw.enable_pallas_filter_grad(True)
  try:
    with pytest.raises(ValueError, match="K6 knob"):
      td.export("/nonexistent")
  finally:
    tdw.enable_pallas_filter_grad(False)


def test_serve_files_visualize_and_inference_driver(tmp_path):
  """serve_files pads two files of different sizes onto one canvas (the
  detections equal serve's of that canvas), visualize draws image 0's, and
  InferenceDriver.inference writes the annotated PNG: pixel for pixel
  JAX's from the same tree."""
  td, jd, tree = _drivers(batch_size=1)
  rng = np.random.default_rng(4)
  a = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
  b = rng.integers(0, 256, (64, 40, 3)).astype(np.uint8)
  paths = []
  for name, img in (("a.png", a), ("b.png", b)):
    paths.append(str(tmp_path / name))
    Image.fromarray(img).save(paths[-1])
  dets = td.serve_files(paths)
  canvas = np.zeros((2, 64, 70, 3), np.uint8)
  canvas[0, :50, :70], canvas[1, :64, :40] = a, b
  ref = td.serve(canvas)
  for k in KEYS:
    np.testing.assert_array_equal(dets[k], ref[k])
  drawn = td.visualize(a, dets, 0)
  assert drawn.shape == a.shape and (drawn != a).any()

  tid = tdriver.InferenceDriver("efficientdet-test", mixed_precision=False,
                                device="cpu")
  convert.load_det_params(tid.driver.model, tree)
  jid = jdriver.InferenceDriver("efficientdet-test", mixed_precision=False)
  jid.driver.params = jd.params
  t_dets, t_img = tid.inference(paths[0], str(tmp_path / "torch"))
  j_dets, j_img = jid.inference(paths[0], str(tmp_path / "jax"))
  np.testing.assert_array_equal(t_dets["valid_len"], j_dets["valid_len"])
  png = [np.asarray(Image.open(tmp_path / d / "a.png"))
         for d in ("torch", "jax")]
  np.testing.assert_array_equal(png[0], png[1])
  np.testing.assert_array_equal(t_img, png[0])
  np.testing.assert_array_equal(
      jvis.visualize_image(a, t_dets["boxes"][0][:int(t_dets["valid_len"][0])],
                           t_dets["classes"][0][:int(t_dets["valid_len"][0])]
                           .astype(int),
                           t_dets["scores"][0][:int(t_dets["valid_len"][0])],
                           min_score_thresh=0.3), t_img)


def test_load_reads_a_main_det_checkpoint(tmp_path):
  """load() takes the params of the latest (or a given) step that main_det
  wrote, and those of the JAX package's orbax directory of the same
  params (bit for bit); an orbax step without its OCDBT manifest raises a
  ValueError naming it."""
  d = str(tmp_path / "det")
  tmain_det.main(["--model_name=efficientdet-test", "--device=cpu",
                  f"--model_dir={d}", "--use_fake_data", "--train_steps=2",
                  "--log_every=1", "--hparams=mixed_precision=false"])
  saved = torch.load(os.path.join(d, "ckpt", "2", "state.pt"),
                     weights_only=True)["params"]
  td = tdriver.ServingDriver("efficientdet-test", mixed_precision=False,
                             device="cpu").load(os.path.join(d, "ckpt"))
  for k, v in saved.items():
    assert torch.equal(td.params[k], v), k
  out = td.serve(np.zeros((1, 64, 64, 3), np.uint8))
  assert np.isfinite(out["boxes"]).all() and out["valid_len"][0] > 0
  with pytest.raises(FileNotFoundError):
    td.load(os.path.join(d, "ckpt"), step=7)
  orbax = tmp_path / "orbax" / "1"
  orbax.mkdir(parents=True)
  (orbax / "_CHECKPOINT_METADATA").write_text("{}")
  with pytest.raises(ValueError, match="manifest.ocdbt"):
    td.load(str(tmp_path / "orbax"))
  from automl_tpu.train.checkpoint import CheckpointManager as JMngr
  jdir = str(tmp_path / "jax")
  jm = JMngr(jdir)
  jm.save(5, {"params": jax.tree_util.tree_map(
      jnp.asarray, convert.det_torch_to_jax_tree(saved, td.model))})
  jm.wait_until_finished()
  tj = tdriver.ServingDriver("efficientdet-test", mixed_precision=False,
                             device="cpu").load(jdir)
  for k, v in saved.items():
    assert torch.equal(tj.params[k], v), k


def test_inspector_export_round_trip(tmp_path, capsys):
  """inspector --runmode=export writes serving.pt2 (the whole serve
  program, under mixed_bfloat16 as JAX's inspector serves) and JAX's
  config.json; the program loaded back equals the eager serve of the same
  weights bit for bit on 2 random batches; saved_model raises."""
  out = str(tmp_path / "export")
  ckpt = _port_ckpt(tmp_path)
  result = tinspector.main(["--runmode=export", "--model_name=efficientdet-test",
                            "--device=cpu", "--batch_size=2",
                            f"--ckpt_path={ckpt}", f"--export_dir={out}"])
  assert result == {"export_dir": out}
  assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
  assert json.load(open(os.path.join(out, "config.json"))) == {
      "model_name": "efficientdet-test", "image_size": [64, 64],
      "batch_size": 2}
  program = tdriver.load_exported(out)
  td = tdriver.ServingDriver("efficientdet-test", batch_size=2,
                             device="cpu").load(ckpt)
  for seed in (0, 1):
    x = np.random.default_rng(seed).integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    got = program(torch.from_numpy(x))
    want = td.serve(x)
    for k, g in zip(KEYS, got):
      np.testing.assert_array_equal(g.numpy(), want[k], err_msg=k)
  with pytest.raises(NotImplementedError, match="TensorFlow"):
    tinspector.main(["--runmode=saved_model", "--device=cpu",
                     "--model_name=efficientdet-test",
                     f"--export_dir={tmp_path / 'sm'}"])


def _port_ckpt(tmp_path):
  """A port checkpoint directory (step 1) of efficientdet-test with
  _tree's weights, whose detections clear the drawing threshold."""
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.train import runners
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  cfg = get_efficientdet_config("efficientdet-test")
  model = runners.seeded_detection_model(cfg, 0, "cpu")
  convert.load_det_params(model, _tree(model))
  state, _ = runners.detection_state(model, cfg)
  d = str(tmp_path / "ckpt")
  CheckpointManager(d).save(1, state)
  return d


def test_infer_cls_export_round_trip(tmp_path):
  """infer_cls --runmode=export saves predict (eval preprocess + forward)
  at uint8 [2, canvas, canvas, 3] as model.pt2; the program loaded back
  gives the eager predict's logits bit for bit."""
  out = str(tmp_path / "cls")
  hp = "--hparam_str=runtime.mixed_precision=false"
  assert tinfer.main(["--runmode=export", "--model_name=efficientnetv2-test",
                      "--device=cpu", "--batch_size=2", hp,
                      f"--export_dir={out}"]) == {"export_dir": out}
  program = torch.export.load(os.path.join(out, "model.pt2")).module()
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  from automl_tpu_torch.data import preprocessing
  from automl_tpu_torch.train import runners
  cfg = get_model_config("efficientnetv2-test")
  tprecision.set_policy("float32")
  model = runners.seeded_classification_model(cfg.model, 0, "cpu").eval()
  isize = int(cfg.eval.isize)
  norm, _ = preprocessing.norm_for_augname(cfg.data.get("augname"))
  x = torch.from_numpy(np.random.default_rng(0).integers(
      0, 256, (2, isize + 32, isize + 32, 3)).astype(np.uint8))
  with torch.no_grad():
    want = tinfer.Predict(model, isize, norm)(x)
    got = program(x)
  torch.testing.assert_close(got, want, rtol=0, atol=0)


def _conv_flops(model, x):
  """2 multiply-adds' worth per output element and input tap of every
  conv and dense layer, counted with forward hooks."""
  from automl_tpu_torch.nn import layers as L
  total = [0]

  def hook(mod, inputs, out):
    if isinstance(mod, L.Conv2D):
      k = mod.kernel
      total[0] += 2 * out.numel() * k.shape[1] * k.shape[2] * k.shape[3]
    else:
      total[0] += 2 * out.numel() * mod.in_dim

  handles = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (L.Conv2D, L.Dense))]
  try:
    with torch.no_grad():
      model(x, train=False)
  finally:
    for h in handles:
      h.remove()
  return total[0]


def test_inspector_params_flops():
  """params_flops: the parameter count equals JAX's (every parameter and
  BN statistic); the FLOPs are the convolutions' multiply-adds x 2, as
  forward hooks count them. XLA's cost_analysis, which JAX prints, also
  counts elementwise work: on efficientdet-test it gives more (a
  divergence, ROADMAP)."""
  import math
  from automl_tpu.models.efficientdet import build_detection_model as jbuild
  from automl_tpu_torch.models.efficientdet import build_detection_model
  got = tinspector.main(["--runmode=params_flops",
                         "--model_name=efficientdet-test"])
  jm = jbuild("efficientdet-test")
  shapes = jax.eval_shape(jm.init, jax.random.key(0))
  assert got["params"] == sum(math.prod(s.shape) for s in
                              jax.tree_util.tree_leaves(shapes)) == 17746
  model = build_detection_model("efficientdet-test", device="meta")
  assert got["flops"] == _conv_flops(model, torch.zeros((1, 3, 64, 64),
                                                        device="meta"))
  xla = jax.jit(lambda p, x: jm(p, x, train=False)).lower(
      shapes, jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)).compile(
      ).cost_analysis()["flops"]
  assert got["flops"] < xla < 2 * got["flops"]


@pytest.mark.parametrize("runmode", ["dry", "bm", "benchmark", "infer"])
def test_inspector_runmodes(runmode, tmp_path):
  """dry (JAX's keys), bm / benchmark (fps, latency_ms, batch_size; a
  Chrome trace of one call), infer (the annotated PNG)."""
  flags = [f"--runmode={runmode}", "--model_name=efficientdet-test",
           "--device=cpu", f"--ckpt_path={_port_ckpt(tmp_path)}"]
  if runmode == "dry":
    out = tinspector.main(flags + ["--batch_size=2"])
    assert out["ok"] is True and len(out["valid_len"]) == 2
  elif runmode in ("bm", "benchmark"):
    trace = str(tmp_path / "trace" / "serve.json")
    out = tinspector.main(flags + ["--bm_runs=2", "--batch_size=2",
                                   f"--trace_filename={trace}"])
    assert set(out) == {"fps", "latency_ms", "batch_size"}
    assert out["fps"] > 0 and out["batch_size"] == 2
    events = json.load(open(trace))["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
  else:
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    out = tinspector.main(flags + [f"--input_image={tmp_path / 'in.png'}",
                                   f"--output_image_dir={tmp_path / 'out'}"])
    assert out["detections"] > 0
    assert np.asarray(Image.open(tmp_path / "out" / "in.png")).shape == (
        40, 56, 3)


def test_inspector_video(tmp_path, monkeypatch):
  """video over a 3-frame mp4v clip: 3 frames out, each the driver's
  annotation of the decoded input frame, with boxes drawn (the written
  frames are recorded before the lossy encode)."""
  import cv2
  src = str(tmp_path / "in.mp4")
  writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 48))
  rng = np.random.default_rng(6)
  for _ in range(3):
    writer.write(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
  writer.release()
  written = []
  video_writer = cv2.VideoWriter

  class Recorder:
    """cv2.VideoWriter that keeps a copy of each frame written."""

    def __init__(self, *args):
      self.writer = video_writer(*args)

    def write(self, frame):
      written.append(frame.copy())
      self.writer.write(frame)

    def release(self):
      self.writer.release()

  monkeypatch.setattr(cv2, "VideoWriter", Recorder)
  dst = str(tmp_path / "out.mp4")
  ckpt = _port_ckpt(tmp_path)
  out = tinspector.main(["--runmode=video", "--model_name=efficientdet-test",
                         "--device=cpu", f"--ckpt_path={ckpt}",
                         f"--input_video={src}", f"--output_video={dst}"])
  assert out == {"frames": 3, "output": dst} and os.path.getsize(dst) > 0
  td = tdriver.ServingDriver("efficientdet-test", device="cpu").load(ckpt)
  cap = cv2.VideoCapture(src)
  for frame in written:
    ok, bgr = cap.read()
    assert ok
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    want = td.visualize(rgb, td.serve(rgb[None]), 0)
    assert (want != rgb).any()
    np.testing.assert_array_equal(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB),
                                  want)
  cap.release()
