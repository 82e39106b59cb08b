"""automl_tpu_torch's parallel layer against automl_tpu's on the CPU.

The mesh shapes (the -1 fill, the DCN fold) against JAX's create_mesh;
then one launch of 4 gloo processes (parallel/launch.py run_local, a
file:// rendezvous, a 60 s collective timeout in each process and a
deadline on the launch) runs every multi-rank case: shard_batch /
replicate and a global mean, ring attention on the mesh (1, 1, 4) forward
and backward, decode_attention_tp on 'model' axes of 2 and 4 and
decode_attention_sp on 2 and 4 (ragged S, a fully masked shard, every
shard masked), and merge_partials over a stacked dim. Each process saves
its results; the tests hold them against JAX's functions on as many of
the 8 simulated CPU devices (tests/conftest.py) on the same mesh. The
workers import no JAX. Inputs are numpy draws from fixed seeds, f32.
"""

import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
B, T, N, H = 2, 32, 2, 8                  # ring: T_local 8 on 4 ranks
SEG_BOUNDS = (12, 21)                     # segments 0 | 1 | 2, not chunk-aligned
RING_CASES = {"plain": {}, "cap": {"logit_cap": 50.0},
              "window": {"window": 7}, "segments": {"segments": True},
              "window_segments": {"window": 5, "segments": True}}
TP_CASES = [(m, n, n_kv) for m in (2, 4) for n, n_kv in ((4, 4), (8, 4))]
SP_S = 29                                 # a multiple of neither 2 nor 4
SP_MASKS = ("ragged", "shard_masked", "all_masked")


def _ring_inputs():
  rng = np.random.default_rng(3)
  q, k, v = (rng.standard_normal((B, T, N, H), dtype=np.float32)
             for _ in range(3))
  a, b = SEG_BOUNDS
  seg = np.concatenate([np.zeros((B, a), np.int32), np.ones((B, b - a),
                        np.int32), np.full((B, T - b), 2, np.int32)], 1)
  return q, k, v, seg


def _tp_inputs(n, n_kv, t=3, s=40):
  rng = np.random.default_rng(10 * n + n_kv)
  q = rng.standard_normal((B, t, n, H), dtype=np.float32) * H ** -0.5
  k = rng.standard_normal((n_kv, B, H, s), dtype=np.float32)
  v = rng.standard_normal((n_kv, B, s, H), dtype=np.float32)
  lens = np.array([17, 40])
  mask = np.arange(s)[None, None, :] < lens[:, None, None]
  return q, k, v, np.broadcast_to(mask, (B, t, s)).copy()


def _sp_inputs(kind, n=4, n_kv=2):
  rng = np.random.default_rng(7)
  q = rng.standard_normal((B, 1, n, H), dtype=np.float32) * H ** -0.5
  k = rng.standard_normal((B * n_kv, H, SP_S), dtype=np.float32)
  v = rng.standard_normal((B * n_kv, SP_S, H), dtype=np.float32)
  lens = {"ragged": [9, 29], "shard_masked": [6, 13],
          "all_masked": [0, 0]}[kind]
  mask = np.arange(SP_S)[None, None, :] < np.array(lens)[:, None, None]
  return q, k, v, mask, n_kv


def _worker(rank, world, store, out_dir):
  """One process of the launch: every multi-rank case, saved to
  out_dir/rank<rank>.pt."""
  torch.set_num_threads(1)
  from automl_tpu_torch.ops import decode_attention as da
  from automl_tpu_torch.ops.ring_attention import ring_attention_sharded
  from automl_tpu_torch.parallel import (create_mesh, distributed,
                                         local_slice, replicate, shard_batch)
  distributed.initialize(store, world, rank, backend="gloo",
                         timeout_secs=60)
  meshes = {m: create_mesh((1, world // m, m), device="cpu") for m in (2, 4)}
  res = {}

  mesh_d = create_mesh((1, world, 1), device="cpu")
  x = np.arange(16.0, dtype=np.float32).reshape(16, 1)
  sb = shard_batch(mesh_d, {"x": x[local_slice(16, mesh_d)]})
  res["global_mean"] = float(sb["x"].mean().full_tensor())
  res["global_shape"] = tuple(sb["x"].shape)
  rep = replicate(mesh_d, {"w": np.arange(3.0, dtype=np.float32)})
  res["replicated_sum"] = float(rep["w"].sum().full_tensor())

  q, k, v, seg = (torch.from_numpy(a) for a in _ring_inputs())
  for name, kw in RING_CASES.items():
    qq, kk, vv = (a.clone().requires_grad_() for a in (q, k, v))
    out = ring_attention_sharded(
        qq, kk, vv, meshes[4], segment_ids=seg if kw.get("segments") else None,
        window=kw.get("window"), logit_cap=kw.get("logit_cap", 0.0))
    torch.sum(torch.square(out)).backward()
    sl = slice(rank * T // world, (rank + 1) * T // world)
    res[f"ring_{name}"] = [out.detach()] + [a.grad[:, sl] for a in (qq, kk, vv)]

  for m, n, n_kv in TP_CASES:
    for cap in (0.0, 30.0):
      q, k, v, mask = (torch.from_numpy(a) for a in _tp_inputs(n, n_kv))
      res[f"tp_{m}_{n}_{n_kv}_{cap}"] = da.decode_attention_tp(
          q, k, v, mask, meshes[m], n_kv_heads=n_kv, logit_cap=cap)

  for m in (2, 4):
    for kind in SP_MASKS:
      q, k, v, mask, n_kv = _sp_inputs(kind)
      q, k, v, mask = (torch.from_numpy(a) for a in (q, k, v, mask))
      got = da.decode_attention_sp(q, k, v, mask, meshes[m], n_kv_heads=n_kv,
                                   logit_cap=30.0)
      res[f"sp_{m}_{kind}"] = got
      # The same merge over the shards stacked on one dim, on this rank.
      s_pad = -(-SP_S // m) * m
      pad = lambda a, d: torch.nn.functional.pad(
          a, (0, 0) * (a.ndim - 1 - d) + (0, s_pad - SP_S))
      kp, vp, mp = pad(k, 2), pad(v, 1), pad(mask, 2)
      sl = s_pad // m
      parts = [da.decode_attention(
          q, kp[..., i * sl:(i + 1) * sl].contiguous(),
          vp[:, i * sl:(i + 1) * sl].contiguous(),
          mp[..., i * sl:(i + 1) * sl].contiguous(), n_kv_heads=n_kv,
          logit_cap=30.0, return_stats=True) for i in range(m)]
      stacked = [torch.stack(x) for x in zip(*parts)]
      res[f"sp_stacked_{m}_{kind}"] = da.merge_partials(
          *stacked, lambda x: x.amax(0, keepdim=True),
          lambda x: x.sum(0, keepdim=True))[0]
  torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  from automl_tpu_torch.parallel.launch import file_store, run_local
  d = tmp_path_factory.mktemp("parallel")
  store = file_store(str(d))
  env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  run_local(lambda r: [sys.executable, __file__, str(r), str(WORLD), store,
                       str(d)], WORLD, timeout_secs=150, env=env)
  return [torch.load(d / f"rank{r}.pt", weights_only=False)
          for r in range(WORLD)]


def _jmesh(shape):
  import jax
  from automl_tpu.parallel import create_mesh as jcreate
  n = int(np.prod(shape))
  return jcreate(shape, devices=jax.devices()[:n])


@pytest.mark.parametrize("shape,dcn,n", [
    (None, None, 4), ((1, -1, 1), None, 8), ((1, 2, 2), None, 4),
    ((2, -1, 2), None, 8), ((1, 2, 2), (1, 2, 1), 8), ((1, 1, 2), (2, 1, 2), 8),
])
def test_mesh_shape_matches_jax(shape, dcn, n):
  """The mesh's shape and its ranks' order (row-major over the world, as
  JAX reshapes its CPU devices) against JAX's create_mesh on n devices."""
  import jax
  from automl_tpu.parallel import create_mesh as jcreate
  from automl_tpu_torch.parallel.mesh import mesh_shape_for
  jm = jcreate(shape, dcn_mesh_shape=dcn, devices=jax.devices()[:n])
  got = mesh_shape_for(shape, n, dcn_mesh_shape=dcn)
  assert got == jm.devices.shape
  ids = np.vectorize(lambda d: d.id)(jm.devices)
  np.testing.assert_array_equal(np.arange(n).reshape(got), ids - ids.min())


def test_mesh_that_misses_the_world_raises():
  from automl_tpu_torch.parallel.mesh import mesh_shape_for
  with pytest.raises(ValueError, match="the world has 4"):
    mesh_shape_for((1, 2, 1), 4)
  with pytest.raises(ValueError, match="does not name the axes"):
    mesh_shape_for((1, 4), 4)


def test_shard_batch_replicate_and_global_mean(ranks):
  """Each rank's 4 rows make one [16, 1] DTensor whose mean is the global
  7.5; a replicated value sums the same on every rank."""
  for res in ranks:
    assert res["global_shape"] == (16, 1)
    assert res["global_mean"] == 7.5
    assert res["replicated_sum"] == 3.0


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax(ranks, case):
  """ring_attention_sharded on 4 ranks against JAX's on 4 devices: the
  forward atol 2e-5 / rtol 1e-4, the gradients of sum(out^2) w.r.t. q, k,
  v atol 5e-5 / rtol 1e-3 (JAX's own ring tests' limits)."""
  import functools
  import jax
  import jax.numpy as jnp
  from automl_tpu.ops.ring_attention import ring_attention_sharded as jring
  kw = RING_CASES[case]
  q, k, v, seg = (jnp.asarray(a) for a in _ring_inputs())
  fn = functools.partial(jring, mesh=_jmesh((1, 1, WORLD)),
                         window=kw.get("window"),
                         logit_cap=kw.get("logit_cap", 0.0))
  segs = seg if kw.get("segments") else None
  want = jax.jit(lambda *a: fn(*a[:3], segment_ids=a[3]))(q, k, v, segs)
  grads = jax.jit(jax.grad(
      lambda *a: jnp.sum(jnp.square(fn(*a[:3], segment_ids=a[3]))),
      argnums=(0, 1, 2)))(q, k, v, segs)
  got = [torch.cat([r[f"ring_{case}"][i] for r in ranks], dim=1).numpy()
         for i in range(4)]
  np.testing.assert_allclose(got[0], np.asarray(want), atol=2e-5, rtol=1e-4)
  for g, w in zip(got[1:], grads):
    np.testing.assert_allclose(g, np.asarray(w), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("m,n,n_kv", TP_CASES,
                         ids=[f"m{m}_n{n}_kv{k}" for m, n, k in TP_CASES])
@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["nocap", "cap"])
def test_decode_attention_tp_matches_jax(ranks, m, n, n_kv, cap):
  """decode_attention_tp with heads over a 'model' axis of m: every rank
  returns all heads, equal to JAX's decode_attention_tp on m devices
  (its kernel in interpret mode), f32 atol / rtol 1e-5."""
  import functools
  import jax
  from automl_tpu.ops.decode_attention import decode_attention_tp as jtp
  q, k, v, mask = _tp_inputs(n, n_kv)
  want = np.asarray(jax.jit(functools.partial(
      jtp, mesh=_jmesh((1, 1, m)), n_kv_heads=n_kv, logit_cap=cap))(
          q, k, v, mask))
  for res in ranks:
    np.testing.assert_allclose(res[f"tp_{m}_{n}_{n_kv}_{cap}"].numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", SP_MASKS)
def test_decode_attention_sp_matches_jax(ranks, m, kind):
  """decode_attention_sp with S = 29 over a 'model' axis of m (padded to a
  shard multiple with masked keys): ragged rows, rows whose last shards
  are fully masked (l = 0 weighs nothing) and rows masked everywhere
  (zeros, not NaN), against JAX's on m devices, f32 atol / rtol 1e-5."""
  import functools
  import jax
  from automl_tpu.ops.decode_attention import decode_attention_sp as jsp
  q, k, v, mask, n_kv = _sp_inputs(kind)
  want = np.asarray(jax.jit(functools.partial(
      jsp, mesh=_jmesh((1, 1, m)), n_kv_heads=n_kv, logit_cap=30.0))(
          q, k, v, mask))
  for res in ranks:
    got = res[f"sp_{m}_{kind}"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
  if kind == "all_masked":
    assert not np.any(ranks[0][f"sp_{m}_{kind}"].numpy())


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", SP_MASKS)
def test_merge_partials_stacked_equals_all_reduce(ranks, m, kind):
  """merge_partials over the shards stacked on one dim (as the card's
  check merges them) equals the all-reduce path, atol / rtol 1e-6."""
  for res in ranks:
    np.testing.assert_allclose(res[f"sp_stacked_{m}_{kind}"].numpy(),
                               res[f"sp_{m}_{kind}"].numpy(), atol=1e-6,
                               rtol=1e-6)


if __name__ == "__main__":
  _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
