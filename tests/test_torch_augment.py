"""automl_tpu_torch's augmentation and classification preprocessing against
automl_tpu's on the CPU.

The images come from numpy seeds; every random draw is JAX's (taken from
the keys JAX's functions split), fed into the port, which takes its draws
as inputs. Tolerances: integer ops (equalize, posterize, invert, solarize,
cutout) exact; float ops (blends, autocontrast, solarize_add, the bilinear
crops and resizes, normalization) atol 1e-3 on [0, 255] (1e-5 after
normalization);
nearest-neighbour warps (rotate, shear, translate) at most 0.1% of the
pixels apart (a source coordinate within an ulp of .5 may round either
way), the rest exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.data import augment as jaug
from automl_tpu.data import preprocessing as jpre
from automl_tpu_torch.data import augment as taug
from automl_tpu_torch.data import preprocessing as tpre

torch.set_num_threads(1)

FLOAT_ATOL = 1e-3
WARP_SHARE = 1e-3
EXACT_OPS = ("equalize", "posterize", "invert", "solarize", "cutout")
WARP_OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")


# The JAX functions jitted once (eagerly, a vmapped lax.switch dispatches
# every op of every branch: several times slower on the CPU).
_J_RANDAUG = jax.jit(jax.vmap(jaug.randaugment, in_axes=(0, 0, None, None)),
                     static_argnums=2)
_J_TRAIN = jax.jit(jpre.cls_train_preprocess, static_argnums=2,
                   static_argnames=("augname", "ra_num_layers"))
_J_FT = jax.jit(jpre.cls_finetune_preprocess, static_argnums=2,
                static_argnames=("augname", "ra_num_layers", "train"))


def _images(b, h, w, seed=0):
  return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                              dtype=np.uint8)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nhwc(t):
  return t.permute(0, 2, 3, 1).numpy()


def _ra_draws(keys, num_layers, h, w):
  """JAX's per-image RandAugment draws from its keys (randaugment's own
  splits): op index, sign and cutout centre per layer."""
  ops, signs, centres = [], [], []
  for key in keys:
    rng, o, s, c = key, [], [], []
    for _ in range(num_layers):
      rng, kop, kr = jax.random.split(rng, 3)
      o.append(int(jax.random.randint(kop, (), 0, len(taug.OPS))))
      s.append(bool(jax.random.bernoulli(kr)))
      ky, kx = jax.random.split(kr)
      c.append([int(jax.random.randint(ky, (), 0, h)),
                int(jax.random.randint(kx, (), 0, w))])
    ops.append(o)
    signs.append(s)
    centres.append(c)
  return {"op": torch.tensor(ops), "sign": torch.tensor(signs),
          "centre": torch.tensor(centres)}


def _keys_for_every_op(num_per_op=2):
  """Keys whose first RandAugment layer draws each of the 16 ops, with
  both signs: [16 * num_per_op] keys, op-major."""
  found = {}
  seed = 0
  while len(found) < len(taug.OPS) * num_per_op:
    key = jax.random.key(seed)
    seed += 1
    _, kop, kr = jax.random.split(key, 3)
    op = int(jax.random.randint(kop, (), 0, len(taug.OPS)))
    sign = bool(jax.random.bernoulli(kr))
    slot = (op, sign if num_per_op == 2 else 0)
    found.setdefault(slot, key)
  return [found[k] for k in sorted(found)]


def _assert_warp_close(got, want, what):
  """Nearest warps: at most WARP_SHARE of the pixels differ."""
  diff = np.any(got != want, axis=-1)
  assert diff.mean() <= WARP_SHARE, (what, diff.mean())


@pytest.mark.parametrize("magnitude", [10.0, 4.3])
def test_each_randaugment_op_matches_jax(magnitude):
  """Every op of RandAugment, each with both signs, through JAX's
  randaugment (one layer) and the port's from JAX's draws."""
  keys = _keys_for_every_op()
  h, w = 40, 36
  x = _images(len(keys), h, w, seed=1).astype(np.float32)
  want = np.asarray(_J_RANDAUG(jnp.asarray(x), jnp.stack(keys), 1,
                               magnitude))
  draws = _ra_draws(keys, 1, h, w)
  got = taug.randaugment(_t(x), draws, magnitude).numpy()
  for i, op in enumerate(draws["op"][:, 0].tolist()):
    name = taug.OPS[op]
    if name in EXACT_OPS:
      np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    elif name in WARP_OPS:
      _assert_warp_close(got[i], want[i], name)
    else:
      np.testing.assert_allclose(got[i], want[i], atol=FLOAT_ATOL, rtol=0,
                                 err_msg=name)
  assert sorted(set(draws["op"][:, 0].tolist())) == list(range(16))


def test_equalize_is_exact_on_skewed_histograms():
  """equalize against JAX on images whose channels have few levels, a
  single level (step 0) and a wide spread."""
  rng = np.random.default_rng(3)
  x = np.stack([rng.integers(0, 256, (20, 24, 3)),
                np.full((20, 24, 3), 77),
                rng.integers(100, 104, (20, 24, 3)),
                rng.choice([0, 255], (20, 24, 3))]).astype(np.float32)
  want = np.stack([np.asarray(jaug.equalize(jnp.asarray(im))) for im in x])
  np.testing.assert_array_equal(taug.equalize(_t(x)).numpy(), want)


def test_batched_randaugment_matches_jax():
  """Two layers on a batch of 8 at magnitude 15, JAX's per-image keys
  (batched_randaugment's split) and draws."""
  h, w, b = 32, 32, 8
  x = _images(b, h, w, seed=2).astype(np.float32)
  rng = jax.random.key(7)
  want = np.asarray(_J_RANDAUG(jnp.asarray(x), jax.random.split(rng, b), 2,
                               15.0))
  draws = _ra_draws(list(jax.random.split(rng, b)), 2, h, w)
  got = taug.randaugment(_t(x), draws, 15.0).numpy()
  close = np.isclose(got, want, atol=FLOAT_ATOL, rtol=0).all(-1)
  assert (~close).mean() <= WARP_SHARE


def test_randaugment_draws_cover_their_ranges():
  g = torch.Generator().manual_seed(0)
  d = taug.randaugment_draws(4096, 2, 13, 7, g)
  assert set(d["op"].flatten().tolist()) == set(range(16))
  assert d["centre"][..., 0].max() == 12 and d["centre"][..., 1].max() == 6
  assert d["centre"].min() == 0
  assert abs(d["sign"].float().mean() - 0.5) < 0.03


def _beta(key, alpha, n):
  return np.asarray(jax.random.beta(key, alpha, alpha, (n,)))


def test_mixup_and_cutmix_match_jax():
  """mixup, cutmix and mixing (both: half the batch each) with JAX's lam
  and boxes; images atol 1e-6, soft labels atol 1e-6."""
  b, h, w = 6, 16, 20
  x = np.random.default_rng(4).standard_normal((b, h, w, 3)).astype(
      np.float32)
  labels = np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 1]]
  key = jax.random.key(3)
  jm = jaug.mixup(jnp.asarray(x), jnp.asarray(labels), key, 0.2)
  tm = taug.mixup(_t(x), _t(labels), _t(_beta(key, 0.2, b)))
  k1, k2, k3 = jax.random.split(key, 3)
  centre = np.stack([np.asarray(jax.random.randint(k2, (b,), 0, h)),
                     np.asarray(jax.random.randint(k3, (b,), 0, w))], 1)
  jc = jaug.cutmix(jnp.asarray(x), jnp.asarray(labels), key, 1.0)
  tc = taug.cutmix(_t(x), _t(labels), _t(_beta(k1, 1.0, b)), _t(centre))
  ka, kb = jax.random.split(key)
  kb1, kb2, kb3 = jax.random.split(kb, 3)
  draws = {"mixup_lam": _t(_beta(ka, 0.2, b // 2)),
           "cutmix_lam": _t(_beta(kb1, 0.5, b - b // 2)),
           "cutmix_centre": _t(np.stack(
               [np.asarray(jax.random.randint(kb2, (b - b // 2,), 0, h)),
                np.asarray(jax.random.randint(kb3, (b - b // 2,), 0, w))],
               1))}
  jx = jaug.mixing(jnp.asarray(x), jnp.asarray(labels), key, 0.2, 0.5)
  tx = taug.mixing(_t(x), _t(labels), draws, 0.2, 0.5)
  for (ti, tl), (ji, jl) in ((tm, jm), (tc, jc), (tx, jx)):
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
  assert not np.allclose(tc[1].numpy(), labels)   # a box was pasted


def test_beta_draws_follow_the_beta_distribution():
  """The port's Beta(a, a) from a generator: mean 1/2, variance
  1 / (4 (2a + 1)), within 5 standard errors over 200k draws; in [0, 1];
  the same seed the same draws."""
  for alpha in (0.2, 1.0, 3.0):
    lam = taug.beta_draws(200_000, alpha, torch.Generator().manual_seed(1))
    var = 1 / (4 * (2 * alpha + 1))
    assert abs(float(lam.mean()) - 0.5) < 5 * np.sqrt(var / lam.numel())
    assert abs(float(lam.var()) - var) < 0.02 * var + 1e-4
    assert float(lam.min()) >= 0 and float(lam.max()) <= 1
  again = taug.beta_draws(10, 0.2, torch.Generator().manual_seed(1))
  np.testing.assert_array_equal(
      again.numpy(), taug.beta_draws(10, 0.2,
                                     torch.Generator().manual_seed(1)).numpy())


def test_gridmask_and_mosaic_match_jax():
  """gridmask with JAX's period and offsets (exact); mosaic with JAX's
  centre (image atol 1e-3, boxes atol 1e-4, classes exact)."""
  h, w = 48, 40
  x = _images(3, h, w, seed=5).astype(np.float32)
  keys = jax.random.split(jax.random.key(11), 3)
  want = np.stack([np.asarray(jaug.gridmask(jnp.asarray(im), k))
                   for im, k in zip(x, keys)])
  side = max(h, w)
  d, off = [], []
  for k in keys:
    k1, k2, k3 = jax.random.split(k, 3)
    dd = int(jax.random.randint(k1, (), max(1, side // 8), max(2, side // 2)))
    d.append(dd)
    off.append([int(jax.random.randint(k2, (), 0, max(dd, 1))),
                int(jax.random.randint(k3, (), 0, max(dd, 1)))])
  got = taug.gridmask(_t(x), {"d": torch.tensor(d), "offset": torch.tensor(
      off)})
  np.testing.assert_array_equal(got.numpy(), want)
  g = taug.gridmask_draws(2000, h, w, torch.Generator().manual_seed(0))
  assert g["d"].min() == side // 8 and g["d"].max() == side // 2 - 1
  assert (g["offset"] < g["d"][:, None]).all() and g["offset"].min() == 0

  imgs = _images(4, h, w, seed=6).astype(np.float32)
  rng = np.random.default_rng(7)
  y0, x0 = rng.uniform(0, 30, (4, 3)), rng.uniform(0, 25, (4, 3))
  boxes = np.stack([y0, x0, y0 + 15, x0 + 12], -1).astype(np.float32)
  classes = np.array([[1, 2, -1], [3, 1, 1], [2, -1, -1], [4, 4, 2]],
                     np.int32)
  key = jax.random.key(2)
  ji, jb, jc = jaug.mosaic(jnp.asarray(imgs), jnp.asarray(boxes),
                           jnp.asarray(classes), key)
  k1, k2 = jax.random.split(key)
  cu = torch.tensor([float(jax.random.uniform(k1, ())),
                     float(jax.random.uniform(k2, ()))])
  ti, tb, tc = taug.mosaic(_t(imgs), _t(boxes), _t(classes), cu)
  np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=FLOAT_ATOL)
  np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
  np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# Classification preprocessing.
# ---------------------------------------------------------------------------


def _crop_draws(keys):
  """random_resized_crop's four draws from each image's key."""
  out = []
  for k in keys:
    k1, k2, k3, k4 = jax.random.split(k, 4)
    out.append([float(jax.random.uniform(k1, (), minval=0.08, maxval=1.0)),
                float(jax.random.uniform(k2, (), minval=jnp.log(3 / 4),
                                         maxval=jnp.log(4 / 3))),
                float(jax.random.uniform(k3, ())),
                float(jax.random.uniform(k4, ()))])
  return torch.tensor(out, dtype=torch.float32)


def test_random_resized_crop_matches_jax():
  x = _images(6, 50, 44, seed=8)
  keys = jax.random.split(jax.random.key(4), 6)
  want = np.stack([np.asarray(jpre.random_resized_crop(jnp.asarray(im), k,
                                                       32))
                   for im, k in zip(x, keys)])
  got = tpre.random_resized_crop(_t(x), _crop_draws(keys), 32).numpy()
  np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, rtol=0)


@pytest.mark.parametrize("augname", ["randaug", "effnetv1_autoaug", None])
def test_cls_train_preprocess_matches_jax(augname):
  """The whole training preprocess (crop, flip, RandAugment m 10, the
  augname's normalization) from JAX's draws: atol 1e-5 after
  normalization, at most 0.1% of the pixels apart where a nearest warp
  rounds a tie the other way."""
  b, out = 6, 32
  x = _images(b, 40, 40, seed=9)
  rng = jax.random.key(5)
  want = np.asarray(_J_TRAIN(jnp.asarray(x), rng, out,
                                              augname=augname,
                                              ra_num_layers=2,
                                              ra_magnitude=10.0))
  keys = jax.random.split(rng, b * 3)
  draws = {"crop": _crop_draws(keys[:b]),
           "flip": torch.tensor([bool(jax.random.bernoulli(k))
                                 for k in keys[b:2 * b]]),
           "randaug": _ra_draws(list(keys[2 * b:]), 2, out, out)}
  got = tpre.cls_train_preprocess(_t(x), draws, out, augname=augname,
                                  ra_magnitude=10.0)
  assert got.shape == (b, 3, out, out)
  assert got.is_contiguous(memory_format=torch.channels_last)
  close = np.isclose(_nhwc(got), want, atol=1e-5, rtol=0).all(-1)
  assert (~close).mean() <= WARP_SHARE
  assert draws["flip"].any() and not draws["flip"].all()


def test_cls_finetune_preprocess_matches_jax():
  """ft: the antialiased downsize, flip, RandAugment (augname 'ft_randaug'
  has none; 'ft' a cutout of random values), normalization, from JAX's
  draws; atol 1e-5 after normalization. Eval mode: resize + normalize."""
  b, out = 4, 24
  x = _images(b, 61, 53, seed=10)
  rng = jax.random.key(6)
  keys = jax.random.split(rng, b * 3)
  cut = []
  for k in keys[2 * b:]:
    k1, k2 = jax.random.split(k)
    ky, kx = jax.random.split(k2)
    cut.append((np.asarray(jax.random.uniform(k1, (out, out, 3),
                                              jnp.float32, -1.0, 1.0)),
                [int(jax.random.randint(ky, (), 0, out)),
                 int(jax.random.randint(kx, (), 0, out))]))
  draws = {"flip": torch.tensor([bool(jax.random.bernoulli(k))
                                 for k in keys[:b]]),
           "randaug": _ra_draws(list(keys[b:2 * b]), 2, out, out),
           "cutout": torch.tensor([c for _, c in cut]),
           "replace": _t(np.stack([r for r, _ in cut]))}
  for augname in ("ft", "ft_randaug"):
    want = np.asarray(_J_FT(jnp.asarray(x), rng, out, augname=augname,
                            ra_magnitude=10.0))
    got = tpre.cls_finetune_preprocess(_t(x), draws, out, augname=augname,
                                       ra_magnitude=10.0)
    close = np.isclose(_nhwc(got), want, atol=1e-5, rtol=0).all(-1)
    assert (~close).mean() <= WARP_SHARE, augname
  want = np.asarray(jpre.cls_finetune_preprocess(jnp.asarray(x), rng, out,
                                                 train=False))
  got = tpre.cls_finetune_preprocess(_t(x), None, out, train=False)
  np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)
  # via cls_train_preprocess's dispatch
  got = tpre.cls_train_preprocess(_t(x), draws, out, augname="ft",
                                  ra_magnitude=10.0)
  want = np.asarray(_J_TRAIN(jnp.asarray(x), rng, out, augname="ft",
                             ra_magnitude=10.0))
  np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(70, 64), (20, 26), (32, 32)],
                         ids=["down", "up", "precropped"])
@pytest.mark.parametrize("norm", ["v2", "ft", "legacy"])
def test_cls_eval_preprocess_matches_jax(size, norm):
  """The centre crop + resize (no antialias) down and up, and the
  precropped path, in each norm family: atol 1e-5."""
  x = _images(3, *size, seed=11)
  want = np.asarray(jpre.cls_eval_preprocess(jnp.asarray(x), 32, norm=norm))
  got = tpre.cls_eval_preprocess(_t(x), 32, norm=norm)
  np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_norm_families_match_jax():
  x = _images(2, 5, 6, seed=12)
  for norm in ("v2", "ft", "legacy"):
    np.testing.assert_allclose(
        tpre.normalize_cls(_t(x), norm).numpy(),
        np.asarray(jpre.normalize_cls(jnp.asarray(x), norm)), atol=1e-6)
  for aug in ("effnetv1_autoaug", "ft", "ftrandaug", "randaug", None):
    assert tpre.norm_for_augname(aug) == jpre.norm_for_augname(aug)
  with pytest.raises(ValueError):
    tpre.normalize_cls(_t(x), "bogus")
