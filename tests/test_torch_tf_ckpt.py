"""automl_tpu_torch's TF-checkpoint import (ckpt/tf_bundle.py,
ckpt/tf_compat.py) against TensorFlow's reader and automl_tpu's
converters on the CPU.

TensorFlow writes every checkpoint here; the port reads them without it.
The reader must equal tf.train.load_checkpoint (through JAX's
tf_compat.load_tf_checkpoint) key for key and bit for bit; the name maps
must equal JAX's; a conversion through the port must give a state bit-equal
to JAX's converter followed by the M0 converter (convert.load_det_params);
and the CLI flags that read TF checkpoints run end to end.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
import tensorflow as tf  # noqa: E402

from automl_tpu import nn as jnn  # noqa: E402
from automl_tpu.ckpt import tf_compat as jtf  # noqa: E402
from automl_tpu.configs import efficientdet_configs as jdet_configs  # noqa: E402
from automl_tpu.configs import effnet_configs as jeff_configs  # noqa: E402
from automl_tpu.models import build_model as jbuild  # noqa: E402
from automl_tpu.models import efficientdet as jdet  # noqa: E402
from automl_tpu_torch import convert  # noqa: E402
from automl_tpu_torch.ckpt import tf_bundle, tf_compat  # noqa: E402
from automl_tpu_torch.cli import infer_cls as tinfer  # noqa: E402
from automl_tpu_torch.cli import main_cls as tmain_cls  # noqa: E402
from automl_tpu_torch.cli import main_det as tmain_det  # noqa: E402
from automl_tpu_torch.configs import efficientdet_configs as tdet_configs  # noqa: E402
from automl_tpu_torch.configs import effnet_configs as teff_configs  # noqa: E402
from automl_tpu_torch.models import efficientdet as tdet  # noqa: E402
from automl_tpu_torch.models import efficientnet as teff  # noqa: E402
from automl_tpu_torch.nn import precision as tprecision  # noqa: E402
from automl_tpu_torch.train.checkpoint import saved_params  # noqa: E402

tf1 = tf.compat.v1
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def f32_policy():
  jnn.set_policy("float32")
  tprecision.set_policy("float32")
  try:
    yield
  finally:
    jnn.set_policy("mixed_bfloat16")
    tprecision.set_policy("mixed_bfloat16")


def write_tf_checkpoint(prefix: str, arrays: dict, dtypes: dict = None,
                        devices: int = 1) -> str:
  """A TF1 Saver checkpoint of {name: array} at `prefix` (each variable
  cast to dtypes[name] when given; with devices > 1, variables spread over
  that many CPU devices and saved sharded, one data file each)."""
  dtypes = dtypes or {}
  os.makedirs(os.path.dirname(prefix), exist_ok=True)
  with tf1.Graph().as_default():
    var_list = {}
    for i, (name, value) in enumerate(arrays.items()):
      with tf1.device(f"/device:CPU:{i % devices}"):
        init = tf.constant(value)
        if name in dtypes:
          init = tf.cast(init, dtypes[name])
        var_list[name] = tf1.Variable(init, name=f"v{i}")
    saver = tf1.train.Saver(var_list=var_list, sharded=devices > 1)
    config = tf1.ConfigProto(device_count={"CPU": devices})
    with tf1.Session(config=config) as sess:
      sess.run(tf1.global_variables_initializer())
      return saver.save(sess, prefix, write_meta_graph=False)


def _saver_ckpt(root):
  """A TF1 training checkpoint: 320 float32 variables whose names carry
  1,000 random letters each (so that the index outgrows one table block:
  several data blocks), float16 and bfloat16 ones, an int64
  global_step and EMA shadows, written by tf.train.ExponentialMovingAverage."""
  rng = np.random.default_rng(0)
  letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
  with tf1.Graph().as_default():
    vs = [tf1.get_variable(
        f"model/blocks_{i}/{''.join(rng.choice(letters, 1000))}/kernel",
        initializer=rng.standard_normal((3, 3, 4, 1 + i % 5)).astype(
            np.float32)) for i in range(320)]
    vs.append(tf1.get_variable("model/h16", initializer=rng.standard_normal(
        (7,)).astype(np.float16)))
    vs.append(tf1.get_variable("model/bf16", initializer=tf.cast(
        rng.standard_normal((3, 4)).astype(np.float32), tf.bfloat16)))
    tf1.train.get_or_create_global_step()
    ema = tf1.train.ExponentialMovingAverage(0.9).apply(vs[:4])
    with tf1.Session() as sess:
      sess.run(tf1.global_variables_initializer())
      sess.run(ema)
      return tf1.train.Saver().save(sess, os.path.join(root, "saver", "model"),
                                    write_meta_graph=False)


def _sharded_ckpt(root):
  rng = np.random.default_rng(1)
  arrays = {f"dev/v{i}": rng.standard_normal((4, i + 1)).astype(np.float32)
            for i in range(10)}
  return write_tf_checkpoint(os.path.join(root, "sharded", "model"), arrays,
                             devices=2)


def _object_ckpt(root):
  """A TF2 tf.train.Checkpoint with a model, an optimizer's slots and its
  object graph."""
  model = tf.Module()
  model.w = tf.Variable(np.arange(6, dtype=np.float32).reshape(3, 2))
  model.b = tf.Variable(np.zeros((2,), np.float64))
  opt = tf.keras.optimizers.Adam(0.1)
  with tf.GradientTape() as tape:
    loss = tf.reduce_sum(model.w * model.w)
  opt.apply_gradients(zip(tape.gradient(loss, [model.w]), [model.w]))
  return tf.train.Checkpoint(model=model, optimizer=opt).save(
      os.path.join(root, "object", "ckpt"))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("tf_ckpts"))
  return {"saver": _saver_ckpt(root), "sharded": _sharded_ckpt(root),
          "object": _object_ckpt(root)}


# ---------------------------------------------------------------------------
# The reader.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["saver", "sharded", "object"])
def test_reader_matches_tf(checkpoints, kind):
  """load_tf_checkpoint equals JAX's (tf.train.load_checkpoint, then its
  filter): the same names; each tensor's dtype, shape and bytes equal
  (bfloat16 widened to float32, exactly, on both sides). The Saver's index
  spans several data blocks; the sharded one two data files; the TF2
  checkpoint's object graph and optimizer slots are dropped. The
  checkpoint's directory reads as its latest prefix."""
  prefix = checkpoints[kind]
  want = jtf.load_tf_checkpoint(prefix)
  got = tf_compat.load_tf_checkpoint(prefix)
  assert set(got) == set(want)
  dtypes = set()
  for name, w in want.items():
    w = np.asarray(w)
    if w.dtype.name == "bfloat16":
      w = w.astype(np.float32)
    g = got[name]
    assert (g.dtype, g.shape) == (w.dtype, w.shape), name
    assert g.tobytes() == w.tobytes(), name
    dtypes.add(np.asarray(want[name]).dtype.name)
  reader = tf_bundle.load_checkpoint(os.path.dirname(prefix))
  assert reader.prefix == prefix
  shapes = reader.get_variable_to_shape_map()
  assert shapes == tf.train.load_checkpoint(prefix).get_variable_to_shape_map()
  if kind == "saver":
    assert len(got) == 327 and reader.data_blocks > 1
    assert {"float32", "float16", "bfloat16", "int64"} <= dtypes
    assert sum(n.endswith("/ExponentialMovingAverage") for n in got) == 4
  elif kind == "sharded":
    assert reader.num_shards == 2
    assert {e["shard_id"] for e in reader._entries.values()} == {0, 1}
  else:
    assert "_CHECKPOINTABLE_OBJECT_GRAPH" in shapes
    assert any("optimizer" in n for n in shapes)
    assert not any(n.startswith("_") or "optimizer" in n for n in got)
    with pytest.raises(ValueError, match="string tensor"):
      reader.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH")


def _corrupt(prefix, tmp_path, what):
  """A copy of the checkpoint with one fault; returns its prefix."""
  import shutil
  d = tmp_path / what
  d.mkdir()
  for f in os.listdir(os.path.dirname(prefix)):
    if f.startswith(os.path.basename(prefix) + "."):
      shutil.copy(os.path.join(os.path.dirname(prefix), f), d / f)
  out = str(d / os.path.basename(prefix))
  index = out + ".index"
  data = bytearray(open(index, "rb").read())
  if what == "flipped":
    reader = tf_bundle.load_checkpoint(out)
    e = reader._entries["model/h16"]
    path = reader.shard_path(e["shard_id"])
    blob = bytearray(open(path, "rb").read())
    blob[e["offset"] + 5] ^= 0x10
    open(path, "wb").write(bytes(blob))
  elif what == "truncated":
    open(index, "wb").write(bytes(data[:len(data) // 2]))
  elif what == "compressed":
    # the index block's trailer: its compression byte, 5 bytes before it
    # the footer's index handle points to
    footer = bytes(data[-tf_bundle.FOOTER_SIZE:])
    pos = 0
    for _ in range(2):
      _, pos = tf_bundle._varint(footer, pos)
    off, pos = tf_bundle._varint(footer, pos)
    size, _ = tf_bundle._varint(footer, pos)
    data[off + size] = 1
    open(index, "wb").write(bytes(data))
  elif what == "v1":
    os.remove(index)
    open(out, "wb").write(b"\0" * 64)
  return out


@pytest.mark.parametrize("what,match", [
    ("flipped", "model/h16: CRC mismatch"),
    ("truncated", "truncated"), ("compressed", "compression type 1"),
    ("v1", "V1 checkpoint")])
def test_reader_refuses_corrupt_files(checkpoints, tmp_path, what, match):
  """A flipped data byte raises a CRC error naming the tensor (the other
  tensors still read); a truncated index, a compressed block and a V1
  checkpoint raise ValueErrors that say so."""
  prefix = _corrupt(checkpoints["saver"], tmp_path, what)
  with pytest.raises(ValueError, match=match):
    tf_compat.load_tf_checkpoint(prefix)
  if what == "flipped":
    reader = tf_bundle.load_checkpoint(prefix)
    np.testing.assert_array_equal(
        reader.get_tensor("global_step"),
        tf.train.load_checkpoint(prefix).get_tensor("global_step"))


# ---------------------------------------------------------------------------
# The name maps.
# ---------------------------------------------------------------------------


def _probe():
  return np.random.default_rng(2).standard_normal((3, 3, 4, 5)).astype(
      np.float32)


@pytest.mark.parametrize("name", ["efficientnet-b0", "efficientnetv2-b0",
                                  "efficientnetv2-s"])
def test_effnet_var_map_matches_jax(name):
  """effnet_var_map on the port's EfficientNet equals JAX's: the same TF
  names in the same order, the same JAX paths, and each transform gives
  the same array."""
  want = jtf.effnet_var_map(jbuild(jeff_configs.get_model_config(name).model))
  got = tf_compat.effnet_var_map(teff.EfficientNet(
      teff_configs.get_model_config(name).model, device="meta"))
  assert list(got) == list(want)
  x = _probe()
  for k, (path, tr) in want.items():
    assert got[k][0] == path, k
    np.testing.assert_array_equal(got[k][1](x), tr(x))


def _setter_probe(setter, shape):
  rng = np.random.default_rng(len(shape))
  cur = rng.standard_normal(shape).astype(np.float32)
  kind = setter.__qualname__.split(".")[0]
  if kind == "_assign_wsm":
    val = np.float32(0.5)
  else:
    val_shape = shape[1:] if kind == "_assign_row" else shape
    val = rng.standard_normal(val_shape).astype(np.float32)
    if len(val_shape) == 4 and val_shape[2] == 1:   # depthwise: TF layout
      val = np.transpose(val, (0, 1, 3, 2))
  return cur, val


@pytest.mark.parametrize("name", ["efficientdet-d0", "efficientdet-lite0",
                                  "efficientdet-test"])
def test_effdet_var_map_matches_jax(name):
  """effdet_var_map on the port's EfficientDet equals JAX's: the same TF
  names in order, the same paths, and each setter writes the same leaf
  from the same (current leaf, checkpoint value) pair, the leaf shaped as
  JAX's tree holds it."""
  jm = jdet.EfficientDet(jdet_configs.get_efficientdet_config(name))
  tm = tdet.EfficientDet(tdet_configs.get_efficientdet_config(name),
                         device="meta")
  want, got = jtf.effdet_var_map(jm), tf_compat.effdet_var_map(tm)
  assert list(got) == list(want)
  shapes = convert.flatten_tree(jax.eval_shape(jm.init, jax.random.key(0)))
  for k, (path, setter) in want.items():
    assert got[k][0] == path, k
    cur, val = _setter_probe(setter, shapes["/".join(path)].shape)
    np.testing.assert_array_equal(got[k][1](cur.copy(), val),
                                  setter(cur.copy(), val))


# ---------------------------------------------------------------------------
# The conversions: the port's (TF-free) against JAX's (TF) then M0.
# ---------------------------------------------------------------------------


def _tf_arrays(var_map, jax_shapes, seed, ema_every=3, f16_every=7):
  """Random arrays in the TF layout for every name of a JAX var map (the
  shapes its converter accepts: a stacked leaf's row, a fusion scalar, a
  depthwise kernel as [k, k, C, 1]); an EMA shadow for every ema_every-th
  name; every f16_every-th stored as float16."""
  rng = np.random.default_rng(seed)
  arrays, dtypes = {}, {}
  for i, (name, (path, setter)) in enumerate(var_map.items()):
    shape = tuple(jax_shapes["/".join(path)].shape)
    kind = getattr(setter, "__qualname__", "").split(".")[0]
    if kind == "_assign_wsm":
      shape = ()
    elif kind == "_assign_row":
      shape = shape[1:]
    if name.endswith("depthwise_kernel"):
      shape = shape[:2] + shape[2:][::-1]
    draw = ((lambda: rng.uniform(0.5, 1.5, shape))
            if name.endswith("moving_variance")
            else (lambda: 0.5 * rng.standard_normal(shape)))
    arrays[name] = np.asarray(draw(), np.float32)
    if i % ema_every == 0:
      arrays[f"{name}/ExponentialMovingAverage"] = np.asarray(draw(),
                                                              np.float32)
    if i % f16_every == f16_every - 1:
      dtypes[name] = tf.float16
  return arrays, dtypes


def _state(model):
  return {k: v.clone() for k, v in convert.model_state(model).items()}


def _assert_states_equal(got, want):
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k


def _drop(arrays, name):
  return {k: v for k, v in arrays.items() if not k.startswith(name)}


CONVERSION_CASES = ["ema", "no_ema", "missing_strict", "missing_lenient"]


@pytest.mark.parametrize("case", CONVERSION_CASES + ["exclude_fc"])
def test_effnet_conversion_matches_jax(case, tmp_path):
  """convert_effnet_checkpoint (efficientnetv2-test, num_classes 10)
  through the port's reader gives the state that JAX's converter (TF's
  reader) gives after convert.load_det_params, bit for bit: with use_ema
  on and off, with exclude_prefixes=(("head", "fc"),) from a seeded
  template, and with a variable missing (strict: KeyError in both;
  lenient: the zeros template kept there in both)."""
  jcfg = jeff_configs.get_model_config("efficientnetv2-test").model
  jcfg.num_classes = 10
  tcfg = teff_configs.get_model_config("efficientnetv2-test").model
  tcfg.num_classes = 10
  jm = jbuild(jcfg)
  shapes = convert.flatten_tree(jax.eval_shape(jm.init, jax.random.key(0)))
  var_map = jtf.effnet_var_map(jm)
  arrays, dtypes = _tf_arrays(var_map, shapes, seed=3)
  missing = "efficientnetv2-test/blocks_1/conv2d/kernel"
  if case.startswith("missing"):
    arrays = _drop(arrays, missing)
  prefix = write_tf_checkpoint(str(tmp_path / "ckpt" / "model"), arrays,
                               dtypes)
  kw = dict(use_ema=case != "no_ema", strict=case != "missing_lenient")
  tm_want, tm_got = (teff.EfficientNet(tcfg) for _ in range(2))
  jparams = tparams = None
  if case == "exclude_fc":
    kw["exclude_prefixes"] = (("head", "fc"),)
    template = convert.det_numpy_init(tm_got, 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, template)
    tparams = convert.unflatten_tree(
        {k: v.copy() for k, v in convert.flatten_tree(template).items()})
  if case == "missing_strict":
    for fn, model in ((jtf.convert_effnet_checkpoint, jm),
                      (tf_compat.convert_effnet_checkpoint, tm_got)):
      with pytest.raises(KeyError, match="1 variables missing"):
        fn(prefix, model, **kw)
    return
  want = jtf.convert_effnet_checkpoint(prefix, jm, params=jparams, **kw)
  convert.load_det_params(tm_want, jax.tree_util.tree_map(np.asarray, want))
  tree = tf_compat.convert_effnet_checkpoint(prefix, tm_got, params=tparams,
                                             **kw)
  _assert_states_equal(_state(tm_got), _state(tm_want))
  stem = tree["stem"]["conv2d"]["kernel"]
  name = "efficientnetv2-test/stem/conv2d/kernel"
  src = arrays.get(name + "/ExponentialMovingAverage") if kw["use_ema"] \
      else None
  np.testing.assert_array_equal(stem, src if src is not None else arrays[name])
  if case == "missing_lenient":
    path = var_map[missing][0]
    assert not convert.flatten_tree(tree)["/".join(path)].any()
  if case == "exclude_fc":
    np.testing.assert_array_equal(tree["head"]["fc"]["kernel"],
                                  template["head"]["fc"]["kernel"])


@pytest.mark.parametrize("case", CONVERSION_CASES)
def test_effdet_conversion_matches_jax(case, tmp_path):
  """convert_effdet_checkpoint (efficientdet-test with 2 BiFPN cells and 2
  head repeats: stacked rows, fusion scalars, separable convs, float16
  variables) gives
  the state of JAX's converter followed by convert.load_det_params, bit
  for bit, with use_ema on and off and a missing variable under strict
  (KeyError in both) and not (the zeros template kept)."""
  repeats = dict(fpn_cell_repeats=2, box_class_repeats=2)
  jcfg = jdet_configs.get_efficientdet_config("efficientdet-test")
  jcfg.override(repeats)
  tcfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  tcfg.override(repeats)
  jm = jdet.EfficientDet(jcfg)
  shapes = convert.flatten_tree(jax.eval_shape(jm.init, jax.random.key(0)))
  var_map = jtf.effdet_var_map(jm)
  arrays, dtypes = _tf_arrays(var_map, shapes, seed=4)
  missing = "fpn_cells/cell_1/fnode0/op_after_combine5/conv/pointwise_kernel"
  assert missing in arrays
  if case.startswith("missing"):
    arrays = _drop(arrays, missing)
  prefix = write_tf_checkpoint(str(tmp_path / "ckpt" / "model"), arrays,
                               dtypes)
  kw = dict(use_ema=case != "no_ema", strict=case != "missing_lenient")
  tm_want, tm_got = (tdet.EfficientDet(tcfg) for _ in range(2))
  if case == "missing_strict":
    for fn, model in ((jtf.convert_effdet_checkpoint, jm),
                      (tf_compat.convert_effdet_checkpoint, tm_got)):
      with pytest.raises(KeyError, match="1 variables missing"):
        fn(prefix, model, **kw)
    return
  want = jtf.convert_effdet_checkpoint(prefix, jm, **kw)
  convert.load_det_params(tm_want, jax.tree_util.tree_map(np.asarray, want))
  tree = tf_compat.convert_effdet_checkpoint(prefix, tm_got, **kw)
  _assert_states_equal(_state(tm_got), _state(tm_want))
  if case == "missing_lenient":
    leaf = tree["fpn_cells"]["cells_rep"]["fnode0"]["op_after_combine"][
        "conv"]["pointwise"]["kernel"]
    assert not leaf[0].any()


# ---------------------------------------------------------------------------
# The flags.
# ---------------------------------------------------------------------------


def _effnet_ckpt(tmp_path, jmodel, seed, scope=None):
  """A TF checkpoint of every variable of JAX's effnet map of jmodel
  (random, TF layout; EMA shadows on every third)."""
  shapes = convert.flatten_tree(jax.eval_shape(jmodel.init,
                                               jax.random.key(0)))
  arrays, _ = _tf_arrays(jtf.effnet_var_map(jmodel, scope), shapes, seed,
                         f16_every=10 ** 9)
  return write_tf_checkpoint(str(tmp_path / "tf" / "model"), arrays), arrays


def test_main_cls_ft_init_ckpt(tmp_path):
  """main_cls --ft_init_ckpt (tests/test_datasets.py::
  test_finetune_smoke_from_converted_ckpt's recipe): a 50-class checkpoint
  finetunes a 10-class efficientnetv2-test; with lr 0 the saved step-1
  weights are the checkpoint's EMA shadows where it has them (else its
  values), the head's fc stays seeded, and the loss is finite."""
  jcfg = jeff_configs.get_model_config("efficientnetv2-test").model
  jcfg.num_classes = 50
  prefix, arrays = _effnet_ckpt(tmp_path, jbuild(jcfg), seed=6)
  d = str(tmp_path / "ft")
  out = tmain_cls.main([
      "--model_name=efficientnetv2-test", "--device=cpu", f"--model_dir={d}",
      "--train_steps=1", "--log_every=1", f"--ft_init_ckpt={prefix}",
      "--hparam_str=runtime.mixed_precision=false,model.num_classes=10,"
      "data.num_classes=10,train.lr_base=0,train.stages=0"])
  assert np.isfinite(out["loss"])
  params = saved_params(os.path.join(d, "ckpt"))
  name = "efficientnetv2-test/stem/conv2d/kernel"
  src = arrays.get(name + "/ExponentialMovingAverage", arrays[name])
  np.testing.assert_array_equal(params["stem.conv2d.kernel"].numpy(),
                                src.transpose(3, 2, 0, 1))
  tcfg = teff_configs.get_model_config("efficientnetv2-test").model
  tcfg.num_classes = 10
  seeded = convert.det_numpy_init(teff.EfficientNet(tcfg, device="meta"), 0)
  np.testing.assert_array_equal(params["head.fc.kernel"].numpy(),
                                seeded["head"]["fc"]["kernel"].T)


def test_main_det_init_backbone_ckpt(tmp_path):
  """main_det --init_backbone_ckpt: efficientdet-test's backbone
  (efficientnet-b0, scope backbone_name) from a TF checkpoint; with lr 0
  the saved step-1 backbone kernels are the checkpoint's (EMA shadows
  preferred), and the heads keep their seeded weights."""
  tcfg = tdet_configs.get_efficientdet_config("efficientdet-test")
  jm = jdet.EfficientDet(jdet_configs.get_efficientdet_config(
      "efficientdet-test"))
  prefix, arrays = _effnet_ckpt(tmp_path, jm.backbone, seed=7,
                                scope=tcfg.backbone_name)
  d = str(tmp_path / "det")
  out = tmain_det.main([
      "--model_name=efficientdet-test", "--device=cpu", f"--model_dir={d}",
      "--use_fake_data", "--train_steps=1", "--log_every=1",
      f"--init_backbone_ckpt={prefix}",
      "--hparams=learning_rate=0,lr_warmup_init=0"])
  assert np.isfinite(out["loss"])
  params = saved_params(os.path.join(d, "ckpt"))
  scope = tcfg.backbone_name
  for tf_name, key, dw in (
      (f"{scope}/stem/conv2d/kernel", "backbone.stem.conv2d.kernel", False),
      (f"{scope}/blocks_1/depthwise_conv2d/depthwise_kernel",
       "backbone.blocks_1.depthwise_conv2d.kernel", True)):
    src = arrays.get(tf_name + "/ExponentialMovingAverage", arrays[tf_name])
    want = src.transpose(2, 3, 0, 1) if dw else src.transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(params[key].numpy(), want)
  seeded = convert.det_numpy_init(tdet.EfficientDet(tcfg, device="meta"), 0)
  np.testing.assert_array_equal(
      params["class_net.class-predict.pointwise.kernel"].numpy(),
      seeded["class_net"]["class-predict"]["pointwise"]["kernel"].transpose(
          3, 2, 0, 1))


def test_infer_cls_tf_ckpt_matches_jax(tmp_path, capsys):
  """infer_cls --runmode=infer --tf_ckpt --use_ema on one TF checkpoint of
  efficientnetv2-test (10 classes, float32): the port's top-5 classes
  equal JAX's, probabilities within 1e-4."""
  from PIL import Image
  from automl_tpu.cli import infer_cls as jinfer
  jcfg = jeff_configs.get_model_config("efficientnetv2-test").model
  jcfg.num_classes = 10
  prefix, _ = _effnet_ckpt(tmp_path, jbuild(jcfg), seed=8)
  img = np.random.default_rng(3).integers(0, 256, (50, 70, 3), np.uint8)
  path = str(tmp_path / "x.png")
  Image.fromarray(img).save(path)
  flags = ["--runmode=infer", f"--input_image={path}",
           "--model_name=efficientnetv2-test", "--tf_ckpt", "--use_ema",
           f"--ckpt_path={prefix}",
           "--hparam_str=runtime.mixed_precision=false,model.num_classes=10"]
  jinfer.main(flags)
  want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  got = tinfer.main(flags + ["--device=cpu"])
  assert [c for c, _ in got["top5"]] == [c for c, _ in want["top5"]]
  np.testing.assert_allclose([p for _, p in got["top5"]],
                             [p for _, p in want["top5"]], atol=1e-4)
  assert max(p for _, p in want["top5"]) > 0.11   # not a field of ties
