"""The real-data paths of automl_tpu_torch's CLIs against automl_tpu's on
the CPU: the dataset converters, main_det and main_cls trained and
evaluated from TFRecord files, the continuous eval, test-dev output,
epochs in child processes, the profile, and infer_cls --runmode=eval.

A mini COCO (8 PIL JPEGs at small COCO-like aspect ratios, one grayscale,
with crowd boxes) goes through both packages' create_coco_tfrecord; the
port's records feed both readers. Evals are held to JAX's run with the
same parameters (the port's checkpoint converted to the JAX tree) over
JAX's tf.data reader: every COCO metric within 1e-4, top-1 and the
multi-label metrics within 1e-4 (the images agree to a level on a few
pixels, the forwards to float32 rounding). efficientdet-test and
efficientnetv2-test at the float32 policy.
"""

import glob
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from automl_tpu import nn as jnn
from automl_tpu.configs import efficientdet_configs as jdet_configs
from automl_tpu.configs import effnet_configs as jcls_configs
from automl_tpu.data import pipeline as jpipe
from automl_tpu.models import build_model as jbuild_model
from automl_tpu.models import efficientdet as jdet
from automl_tpu.train import runners as jrunners
from automl_tpu_torch import convert
from automl_tpu_torch.cli import create_coco_tfrecord as tcoco
from automl_tpu_torch.cli import create_pascal_tfrecord as tpascal
from automl_tpu_torch.cli import infer_cls as tinfer
from automl_tpu_torch.cli import main_cls as tmain_cls
from automl_tpu_torch.cli import main_det as tmain_det
from automl_tpu_torch.data import native_loader as tnl
from automl_tpu_torch.nn import precision as tprecision

METRIC_ATOL = 1e-4
DET_HP = "batch_size=2,mixed_precision=false"
CLS_DATASET = "TFFlowersFt"   # 5 classes: top-1 of random weights is not 0
CLS_HP = ("runtime.mixed_precision=false,model.num_classes=5,"
          "train.batch_size=2,eval.batch_size=2")
SIZES = [(96, 128), (128, 96), (85, 128), (100, 100), (120, 160), (60, 80),
         (128, 128), (90, 120)]


@pytest.fixture(autouse=True)
def f32_policy():
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def _image(rng, h, w):
  y, x = np.mgrid[:h, :w]
  img = np.stack([x * 2, y * 2, x + y], -1) + rng.randint(-20, 20, (h, w, 3))
  return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
  """A mini COCO: images/, ann.json, and the port's records (2 shards)."""
  d = tmp_path_factory.mktemp("coco")
  rng = np.random.RandomState(0)
  os.makedirs(d / "images")
  images, anns = [], []
  for i, (h, w) in enumerate(SIZES):
    im = Image.fromarray(_image(rng, h, w))
    (im.convert("L") if i == 3 else im).save(d / "images" / f"{i}.jpg",
                                             quality=90)
    images.append({"id": 100 + i, "file_name": f"{i}.jpg", "height": h,
                   "width": w})
    for j in range(1 + i % 3):
      bw, bh = rng.uniform(16, w / 2), rng.uniform(16, h / 2)
      anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                   "bbox": [rng.uniform(0, w - bw), rng.uniform(0, h - bh),
                            bw, bh],
                   "category_id": int(rng.randint(1, 4)),
                   "iscrowd": int(j == 2), "area": bw * bh})
  with open(d / "ann.json", "w") as f:
    json.dump({"images": images, "annotations": anns,
               "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]},
              f)
  tcoco.main([f"--image_dir={d / 'images'}",
              f"--object_annotations_file={d / 'ann.json'}",
              f"--output_file_prefix={d / 'rec' / 'coco'}", "--num_shards=2"])
  return {"dir": d, "pattern": str(d / "rec" / "coco-*")}


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
  """ImageNet-style records of TFFlowers' file names (tfflowers-train-*
  and tfflowers-val-*, 2 shards each) and ImageNet21k-style ones
  (imagenet21k-*), written by the port's writer."""
  d = tmp_path_factory.mktemp("imagenet")
  rng = np.random.RandomState(1)
  for split, n in (("tfflowers-train", 6), ("tfflowers-val", 6)):
    for s in range(2):
      with tnl.TFRecordWriter(str(d / f"{split}-{s:05d}-of-00002")) as w:
        for i in range(n // 2):
          h, w_ = SIZES[(i + s) % len(SIZES)]
          w.write(tnl.build_example({
              "image/encoded": [tnl.jpeg_encode_rgb(_image(rng, h, w_))],
              "image/class/label": [int(rng.randint(0, 5))]}))
  with tnl.TFRecordWriter(str(d / "imagenet21k-00000")) as w:
    for i in range(6):
      h, w_ = SIZES[i]
      w.write(tnl.build_example({
          "image": [tnl.jpeg_encode_rgb(_image(rng, h, w_))],
          "labels": [int(v) for v in rng.randint(0, 5, 1 + i % 3)]}))
  return d


@pytest.fixture(scope="module")
def det_run(coco, tmp_path_factory):
  """A model_dir trained 3 steps from the records (TF-free reader)."""
  d = str(tmp_path_factory.mktemp("det_run"))
  out = tmain_det.main([
      "--model_name=efficientdet-test", f"--model_dir={d}", "--device=cpu",
      f"--train_file_pattern={coco['pattern']}", "--train_steps=3",
      "--log_every=1", f"--hparams={DET_HP}"])
  return d, out


def test_create_coco_tfrecord_bytes_equal_jax(coco, tmp_path):
  from automl_tpu.cli import create_coco_tfrecord as jcoco
  jcoco.main([f"--image_dir={coco['dir'] / 'images'}",
              f"--object_annotations_file={coco['dir'] / 'ann.json'}",
              f"--output_file_prefix={tmp_path / 'coco'}", "--num_shards=2"])
  got = sorted(glob.glob(coco["pattern"]))
  want = sorted(glob.glob(str(tmp_path / "coco-*")))
  assert [os.path.basename(p) for p in got] == [os.path.basename(p)
                                                for p in want]
  for g, w in zip(got, want):
    assert open(g, "rb").read() == open(w, "rb").read()


def test_create_pascal_tfrecord_bytes_equal_jax(tmp_path):
  from automl_tpu.cli import create_pascal_tfrecord as jpascal
  voc = tmp_path / "VOC2012"
  for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
    os.makedirs(voc / sub)
  rng = np.random.RandomState(2)
  names = ["a", "b", "c"]
  for i, name in enumerate(names):
    h, w = SIZES[i]
    Image.fromarray(_image(rng, h, w)).save(voc / "JPEGImages" / f"{name}.jpg")
    objs = "".join(
        f"<object><name>{cls}</name><difficult>{j % 2}</difficult><bndbox>"
        f"<xmin>{2 + j}</xmin><ymin>{3 + j}</ymin><xmax>{40 + j}</xmax>"
        f"<ymax>{30 + j}</ymax></bndbox></object>"
        for j, cls in enumerate(("dog", "person", "unknown")))
    (voc / "Annotations" / f"{name}.xml").write_text(
        f"<annotation><filename>{name}.jpg</filename><size><width>{w}"
        f"</width><height>{h}</height></size>{objs}</annotation>")
  (voc / "ImageSets/Main/train.txt").write_text("\n".join(names) + "\n")
  for mod, out in ((tpascal, "port"), (jpascal, "jax")):
    assert mod.main([f"--data_dir={voc}", f"--output_path={tmp_path / out}",
                     "--num_shards=2"]) == 3
  for s in range(2):
    name = f"-{s:05d}-of-00002.tfrecord"
    assert (open(tmp_path / f"port{name}", "rb").read()
            == open(tmp_path / f"jax{name}", "rb").read())


@pytest.mark.parametrize("reader", ["tfrecord", "native", "autoaugment"])
def test_main_det_trains_from_files(coco, tmp_path, reader):
  """Both readers (and the TF-free one with box-aware AutoAugment v1):
  finite losses, falling where the order is seeded (the TF-free reader;
  the native loader's order depends on its workers' timing), and a
  checkpoint at the last step."""
  flags = ["--model_name=efficientdet-test", f"--model_dir={tmp_path}",
           "--device=cpu", f"--train_file_pattern={coco['pattern']}",
           "--train_steps=3", "--log_every=1"]
  hp = DET_HP + (",autoaugment_policy=v1" if reader == "autoaugment" else "")
  if reader == "native":
    flags += ["--native_loader", "--native_workers=2"]
  out = tmain_det.main(flags + [f"--hparams={hp}"])
  assert np.isfinite(out["loss"])
  losses = [json.loads(l)["loss"] for l in open(tmp_path / "metrics.jsonl")
            if "loss" in json.loads(l)]
  assert len(losses) == 3 and all(np.isfinite(losses))
  if reader != "native":
    assert losses[-1] < losses[0]
  assert os.path.exists(tmp_path / "ckpt" / "3" / "state.pt")


def _jax_det_eval(model_dir, pattern, eval_steps, step=None, testdev=None):
  """JAX's evaluate_detection on the EMA of the port's checkpoint (the
  latest, or `step`), over JAX's tf.data reader."""
  from automl_tpu_torch.configs import efficientdet_configs as tcfgs
  from automl_tpu_torch.models.efficientdet import EfficientDet
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  jnn.set_policy("float32")
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  step = mngr.latest_step() if step is None else step
  saved = torch.load(os.path.join(mngr.directory, str(step), "state.pt"),
                     weights_only=True)
  tcfg = tcfgs.get_efficientdet_config("efficientdet-test")
  tree = convert.det_torch_to_jax_tree(saved["ema_params"],
                                       EfficientDet(tcfg))
  jcfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  jcfg.override(DET_HP)
  return jrunners.evaluate_detection(
      jdet.EfficientDet(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
      jcfg, iter(jpipe.DetectionTFRecordLoader(
          pattern, False, 2, 64, jcfg.max_instances_per_image)),
      eval_steps, testdev_dir=testdev)


def test_main_det_eval_mode_matches_jax(coco, det_run):
  d, _ = det_run
  got = tmain_det.main([
      "--mode=eval", "--model_name=efficientdet-test", f"--model_dir={d}",
      "--device=cpu", f"--val_file_pattern={coco['pattern']}",
      "--eval_samples=8", f"--hparams={DET_HP}"])
  want = _jax_det_eval(d, coco["pattern"], 4)
  assert set(got) == set(want) and want["ARmax100"] >= 0
  for k in want:
    assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_main_det_train_and_eval_from_files(coco, tmp_path):
  """An eval every step over the val files; the last one equals JAX's on
  the final checkpoint."""
  tmain_det.main([
      "--mode=train_and_eval", "--model_name=efficientdet-test",
      f"--model_dir={tmp_path}", "--device=cpu",
      f"--train_file_pattern={coco['pattern']}",
      f"--val_file_pattern={coco['pattern']}", "--train_steps=2",
      "--eval_every=1", "--eval_samples=4", f"--hparams={DET_HP}"])
  evals = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")
           if "eval/AP" in l]
  assert len(evals) == 2
  want = _jax_det_eval(str(tmp_path), coco["pattern"], 2)
  for k in want:
    assert abs(evals[-1][f"eval/{k}"] - want[k]) <= METRIC_ATOL, k


def test_main_det_testdev_json_in_jaxs_format(coco, det_run, tmp_path):
  d, _ = det_run
  got = tmain_det.main([
      "--mode=eval", "--model_name=efficientdet-test", f"--model_dir={d}",
      "--device=cpu", f"--val_file_pattern={coco['pattern']}",
      "--eval_samples=8", f"--hparams={DET_HP}",
      f"--testdev_dir={tmp_path / 'port'}"])
  want = _jax_det_eval(d, coco["pattern"], 4, testdev=str(tmp_path / "jax"))
  assert got["AP"] == want["AP"] == -1.0
  assert (os.path.basename(got["detections_json"])
          == os.path.basename(want["detections_json"]))
  rows = [json.load(open(p)) for p in (got["detections_json"],
                                       want["detections_json"])]
  assert len(rows[0]) == len(rows[1]) > 0
  for g, w in zip(*rows):
    assert set(g) == set(w) == {"image_id", "category_id", "bbox", "score"}
    assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                 w["category_id"])
    # source pixels, rounded to 2 dp after image_scale (2 to 2.5 here)
    np.testing.assert_allclose(g["bbox"], w["bbox"], atol=0.05)
    assert abs(g["score"] - w["score"]) <= 1e-4


def test_main_det_eval_timeout_follows_a_trainer(coco, det_run, tmp_path,
                                                 capsys):
  """--eval_timeout while a thread saves checkpoints: one vanishes right
  after it appears, one is cut short (a truncated state.pt); each
  complete one is evaluated, and the result is the last one's."""
  src, _ = det_run
  state = os.path.join(src, "ckpt", "3", "state.pt")
  ckpt = tmp_path / "ckpt"
  os.makedirs(ckpt)

  def put(step, data):
    os.makedirs(ckpt / f"{step}.tmp")
    with open(ckpt / f"{step}.tmp" / "state.pt", "wb") as f:
      f.write(data)
    os.replace(ckpt / f"{step}.tmp", ckpt / str(step))

  data = open(state, "rb").read()

  def trainer():
    put(1, data)
    time.sleep(0.5)
    put(2, data[:len(data) // 2])              # cut short
    put(3, data)
    time.sleep(0.05)
    os.replace(ckpt / "3", tmp_path / "gone")  # vanishes
    time.sleep(1.0)
    put(4, data)

  t = threading.Thread(target=trainer)
  t.start()
  try:
    got = tmain_det.main([
        "--mode=eval", "--model_name=efficientdet-test",
        f"--model_dir={tmp_path}", "--device=cpu",
        f"--val_file_pattern={coco['pattern']}", "--eval_samples=4",
        f"--hparams={DET_HP}", "--eval_timeout=4"])
  finally:
    t.join(timeout=30)
  assert not t.is_alive()
  out = capsys.readouterr().out
  assert "step 1:" in out and "step 4:" in out and "checkpoint 2 vanished" \
      in out and "step 2:" not in out
  want = _jax_det_eval(src, coco["pattern"], 2)
  for k in want:
    assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_main_det_epochs_in_child_processes(coco, tmp_path):
  """2 epochs of 1 step, each in a child process with an eval child after
  it; this process never initialises CUDA; a child's failure propagates."""
  flags = ["--model_name=efficientdet-test", f"--model_dir={tmp_path}",
           "--device=cpu", f"--train_file_pattern={coco['pattern']}",
           f"--hparams={DET_HP}", "--num_examples_per_epoch=2",
           "--run_epoch_in_child_process", "--log_every=1"]
  out = tmain_det.main(flags + ["--mode=train_and_eval", "--train_steps=2",
                                f"--val_file_pattern={coco['pattern']}",
                                "--eval_samples=2"])
  assert out == {"train_steps": 2.0}
  assert not torch.cuda.is_initialized()
  assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2"]
  with pytest.raises(SystemExit) as e:
    tmain_det.main([f if not f.startswith("--train_file") else
                    f"--train_file_pattern={tmp_path}/none-*" for f in flags]
                   + ["--train_steps=3"])
  assert e.value.code != 0


def test_main_det_profile_writes_a_trace(tmp_path):
  tmain_det.main(["--model_name=efficientdet-test", f"--model_dir={tmp_path}",
                  "--device=cpu", "--use_fake_data", "--train_steps=11",
                  "--log_every=11", "--profile",
                  "--hparams=batch_size=1,mixed_precision=false"])
  (trace,) = glob.glob(str(tmp_path / "profile" / "*.json"))
  events = json.load(open(trace))["traceEvents"]
  assert any("conv" in e.get("name", "") for e in events)


def _cls_configs(hp=CLS_HP, dataset=CLS_DATASET):
  """The JAX and the port config: the model's, the dataset overlay, hp."""
  from automl_tpu.data import datasets as jds
  from automl_tpu_torch.configs import effnet_configs as tcfgs
  from automl_tpu_torch.data import datasets as tds
  out = []
  for cfgs, ds in ((jcls_configs, jds), (tcfgs, tds)):
    cfg = cfgs.get_model_config("efficientnetv2-test")
    cfg.override(ds.get_dataset_config(dataset).as_dict(),
                 allow_new_keys=True)
    cfg.override(hp)
    out.append(cfg)
  return out


def _cls_params_to_jax(model_dir):
  """The EMA of the port's latest classification checkpoint as a JAX
  tree, JAX's config and model for it."""
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  jnn.set_policy("float32")
  mngr = CheckpointManager(os.path.join(model_dir, "ckpt"))
  saved = torch.load(os.path.join(mngr.directory, str(mngr.latest_step()),
                                  "state.pt"), weights_only=True)
  jcfg, tcfg = _cls_configs()
  tree = convert.det_torch_to_jax_tree(saved["ema_params"],
                                       EfficientNet(tcfg.model))
  return jcfg, jbuild_model(jcfg.model), jax.tree_util.tree_map(jnp.asarray,
                                                               tree)


@pytest.mark.parametrize("source", ["data_dir", "native"])
def test_main_cls_trains_from_files_and_evals_like_jax(imagenet, tmp_path,
                                                       source):
  """--dataset=TFFlowersFt --data_dir (the TF-free reader) or
  --train_file_pattern --native_loader: 2 finite steps; then --mode=eval
  over the validation files equals JAX's evaluate_classification with the
  same params over JAX's reader."""
  d = str(tmp_path)
  flags = ["--model_name=efficientnetv2-test", f"--model_dir={d}",
           "--device=cpu", f"--dataset={CLS_DATASET}",
           f"--hparam_str={CLS_HP}"]
  if source == "data_dir":
    train = [f"--data_dir={imagenet}"]
  else:
    train = [f"--train_file_pattern={imagenet}/tfflowers-train-*",
             "--native_loader",
             "--native_workers=2"]
  out = tmain_cls.main(flags + train + ["--train_steps=2", "--log_every=1"])
  assert np.isfinite(out["loss"])
  got = tmain_cls.main(flags + [
      "--mode=eval", f"--val_file_pattern={imagenet}/tfflowers-val-*",
      "--eval_samples=6"])
  jcfg, jm, jparams = _cls_params_to_jax(d)
  isize = int(jcfg.eval.isize or jrunners.resolve_train_size(jcfg))
  want = jrunners.evaluate_classification(
      jm, jparams, jcfg, iter(jpipe.ImageNetTFRecordLoader(
          f"{imagenet}/tfflowers-val-*", False, 2, isize + 32, 5)), 3)
  assert got["samples"] == want["samples"] == 6
  for k in ("top1", "top5"):
    assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got, want)


def test_main_cls_eval_timeout_and_missing_checkpoint(imagenet, tmp_path):
  flags = ["--model_name=efficientnetv2-test", f"--model_dir={tmp_path}",
           "--device=cpu", f"--dataset={CLS_DATASET}",
           f"--hparam_str={CLS_HP}", "--mode=eval",
           f"--val_file_pattern={imagenet}/tfflowers-val-*",
           "--eval_samples=2"]
  with pytest.raises(FileNotFoundError, match="no checkpoint"):
    tmain_cls.main(flags)
  with pytest.raises(FileNotFoundError, match="no checkpoint"):
    tmain_cls.main(flags + ["--eval_timeout=0.5"])
  tmain_cls.main(flags[:5] + [f"--data_dir={imagenet}", "--train_steps=1"])
  out = tmain_cls.main(flags + ["--eval_timeout=0.5"])
  assert out["samples"] == 2


def _jax_infer_eval(capsys, jax_dir, flags):
  from automl_tpu.cli import infer_cls as jinfer
  capsys.readouterr()
  jinfer.main(flags + [f"--ckpt_path={jax_dir}"])
  return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _orbax(tmp_path, jparams):
  from automl_tpu.train.checkpoint import CheckpointManager as JMngr
  jax_dir = str(tmp_path / "jax")
  m = JMngr(jax_dir)
  m.save(1, {"params": jparams})
  m.wait_until_finished()
  return jax_dir


def test_infer_cls_eval_top1_matches_jax(imagenet, tmp_path, capsys):
  d = str(tmp_path / "run")
  tmain_cls.main(["--model_name=efficientnetv2-test", f"--model_dir={d}",
                  "--device=cpu", f"--dataset={CLS_DATASET}",
                  f"--data_dir={imagenet}", f"--hparam_str={CLS_HP}",
                  "--train_steps=2"])
  _, _, jparams = _cls_params_to_jax(d)
  flags = ["--runmode=eval", "--model_name=efficientnetv2-test",
           f"--dataset={CLS_DATASET}", f"--hparam_str={CLS_HP}",
           "--batch_size=4", f"--val_file_pattern={imagenet}/tfflowers-val-*"]
  want = _jax_infer_eval(capsys, _orbax(tmp_path, jparams), flags)
  got = tinfer.main(flags + [f"--ckpt_path={d}/ckpt", "--use_ema",
                             "--device=cpu"])
  assert got == want and got["samples"] == 6


def test_infer_cls_eval_multilabel_matches_jax(imagenet, tmp_path, capsys):
  """--dataset=imagenet21k (multi-label): AUC-PR and precision@1 of one
  set of weights (seeded, the head scaled so that the ranking is not a
  near tie) in both packages."""
  from automl_tpu_torch.configs import effnet_configs as tcfgs
  from automl_tpu_torch.train import optimizers as topt
  from automl_tpu_torch.train import runners as trunners
  from automl_tpu_torch.train import train_lib as ttrain
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  tprecision.set_policy("float32")
  tcfg = tcfgs.get_model_config("efficientnetv2-test")
  tcfg.override("model.num_classes=5")
  tm = trunners.seeded_classification_model(tcfg.model, 0, "cpu")
  with torch.no_grad():
    tm.head.fc.kernel.mul_(30.0)
  port_dir = str(tmp_path / "port")
  tx = topt.masked_for_params(topt.build_optimizer("rmsprop", 0.1))
  CheckpointManager(port_dir).save(1, ttrain.create_train_state(tm, tx))
  jparams = jax.tree_util.tree_map(
      jnp.asarray, convert.det_torch_to_jax_tree(convert.model_state(tm), tm))
  hp = CLS_HP + ",data.num_classes=5"
  flags = ["--runmode=eval", "--model_name=efficientnetv2-test",
           "--dataset=imagenet21k", f"--hparam_str={hp}",
           "--batch_size=4", f"--val_file_pattern={imagenet}/imagenet21k-*"]
  want = _jax_infer_eval(capsys, _orbax(tmp_path, jparams), flags)
  got = tinfer.main(flags + [f"--ckpt_path={port_dir}", "--device=cpu"])
  assert set(got) == set(want)
  for k, v in want.items():
    assert abs(got[k] - v) <= METRIC_ATOL, (k, got, want)
