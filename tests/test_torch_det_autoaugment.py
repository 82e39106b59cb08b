"""Box-aware AutoAugment of automl_tpu_torch (data/det_autoaugment.py)
against automl_tpu's on the CPU, with JAX's draws fed in.

JAX draws inside the op from keys: a Bernoulli is uniform(key) < p, a sign
uniform(key) < 0.5, a cutout centre randint over the rows and columns of
split(key). The tests compute those from the same keys and hand them to
the port. Every op of v0-v3 at each of its levels, and the whole policy
switch of each policy (sub-policy index, Bernoulli and op draws per
image), are held on a batch of images with boxes (one of them padding).
Tolerances: images within IMAGE_ATOL of JAX's on [0, 255] (the warps take
the same nearest taps, the colour ops the same float32 arithmetic up to
the order of a few sums); boxes within BOX_ATOL pixels (the forward
affine is a float32 3 x 3 inverse, LAPACK's here and XLA's there); classes
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.data import det_autoaugment as jaa
from automl_tpu_torch.data import det_autoaugment as taa

IMAGE_ATOL = 1e-3
BOX_ATOL = 1e-3
H, W, G = 40, 48, 4
POLICIES = ("v0", "v1", "v2", "v3")


def _batch(b, seed=0):
  rng = np.random.RandomState(seed)
  y, x = np.mgrid[:H, :W]
  images = (rng.uniform(0, 255, (b, H, W, 3)) * 0.3
            + np.stack([x * 5, y * 6, x + y], -1)[None] * 0.7)
  images = np.round(images).astype(np.float32)
  y0 = rng.uniform(0, H * 0.5, (b, G))
  x0 = rng.uniform(0, W * 0.5, (b, G))
  boxes = np.stack([y0, x0, y0 + rng.uniform(4, H * 0.5, (b, G)),
                    x0 + rng.uniform(4, W * 0.5, (b, G))], -1)
  classes = rng.randint(1, 91, (b, G)).astype(np.int32)
  classes[:, -1] = -1
  boxes[:, -1] = 0.0
  return images, boxes.astype(np.float32), classes


def _op_draws(k_op):
  """(sign, centre) that JAX's op draws from its key."""
  ky, kx = jax.random.split(k_op)
  return (bool(jax.random.uniform(k_op) < 0.5),
          (int(jax.random.randint(ky, (), 0, H)),
           int(jax.random.randint(kx, (), 0, W))))


def _policy_draws(key, n_sub):
  """The port's draws from the keys distort_image_with_autoaugment
  splits."""
  k_sel, rng = jax.random.split(key)
  sub = int(jax.random.randint(k_sel, (), 0, n_sub))
  u, sign, centre = [], [], []
  for _ in range(taa.MAX_OPS):
    rng, k_p, k_op = jax.random.split(rng, 3)
    u.append(float(jax.random.uniform(k_p)))
    s, c = _op_draws(k_op)
    sign.append(s)
    centre.append(c)
  return sub, u, sign, centre


def _close(got, want):
  gi, gb, gc = (t.numpy() for t in got)
  wi, wb, wc = (np.asarray(t) for t in want)
  np.testing.assert_allclose(gi, wi, atol=IMAGE_ATOL, rtol=0)
  np.testing.assert_array_equal(gc, wc)
  np.testing.assert_allclose(gb, wb, atol=BOX_ATOL, rtol=0)


def test_policy_tables_are_jaxs():
  for name in POLICIES:
    assert taa.POLICIES[name] == getattr(jaa, f"POLICY_{name.upper()}")
  assert len(taa.POLICY_V1) == 14
  assert max(len(sp) for p in taa.POLICIES.values() for sp in p) == \
      taa.MAX_OPS


@pytest.mark.parametrize("policy", POLICIES)
def test_every_op_matches_jax(policy):
  ops = sorted({(name, level) for sp in taa.POLICIES[policy]
                for name, _, level in sp})
  b = 3
  images, boxes, classes = _batch(b)
  for i, (name, level) in enumerate(ops):
    keys = [jax.random.key(100 * i + k) for k in range(b)]
    want = [jaa._apply_op(name, float(level), jnp.asarray(images[k]),
                          jnp.asarray(boxes[k]), jnp.asarray(classes[k]),
                          keys[k]) for k in range(b)]
    want = [np.stack([np.asarray(w[j]) for w in want]) for j in range(3)]
    draws = [_op_draws(k) for k in keys]
    got = taa.apply_op(name, float(level), torch.from_numpy(images),
                       torch.from_numpy(boxes), torch.from_numpy(classes),
                       torch.tensor([d[0] for d in draws]),
                       torch.tensor([d[1] for d in draws]))
    try:
      _close(got, want)
    except AssertionError as e:
      raise AssertionError(f"{policy} {name} level {level}: {e}") from None


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_switch_matches_jax(policy):
  n_sub = len(taa.POLICIES[policy])
  b = 8
  images, boxes, classes = _batch(b, seed=1)
  keys = jax.random.split(jax.random.key(7), b)
  want = jax.jit(jax.vmap(
      lambda i, bx, c, k: jaa.distort_image_with_autoaugment(
          i, bx, c, k, policy)))(images, boxes, classes, keys)
  drawn = [_policy_draws(k, n_sub) for k in keys]
  draws = {"sub": torch.tensor([d[0] for d in drawn]),
           "u": torch.tensor([d[1] for d in drawn]),
           "sign": torch.tensor([d[2] for d in drawn]),
           "centre": torch.tensor([d[3] for d in drawn])}
  got = taa.distort(torch.from_numpy(images), torch.from_numpy(boxes),
                    torch.from_numpy(classes), draws, policy)
  _close(got, want)
  assert len(set(draws["sub"].tolist())) > 1


def test_draws_cover_their_ranges():
  g = torch.Generator().manual_seed(0)
  d = taa.autoaugment_draws(4096, "v1", 30, 50, g)
  assert d["sub"].min() == 0 and d["sub"].max() == 13
  assert len(set(d["sub"].tolist())) == 14
  assert 0.0 <= float(d["u"].min()) and float(d["u"].max()) < 1.0
  assert d["u"].shape == (4096, taa.MAX_OPS)
  assert 0.45 < d["sign"].float().mean() < 0.55
  c = d["centre"]
  assert c.shape == (4096, taa.MAX_OPS, 2)
  assert int(c[..., 0].min()) == 0 and int(c[..., 0].max()) == 29
  assert int(c[..., 1].min()) == 0 and int(c[..., 1].max()) == 49
  with pytest.raises(KeyError):
    taa.autoaugment_draws(1, "v9", 8, 8, g)
