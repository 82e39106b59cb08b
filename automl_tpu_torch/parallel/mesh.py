"""Device mesh and placements: the port's one distribution layer.

The counterpart of automl_tpu/parallel/mesh.py. A mesh is a
torch.distributed DeviceMesh with the dim names ("replica", "data",
"model"), one process (one card, or one CPU rank under gloo) at each point.
Where JAX writes a PartitionSpec, the port writes P (the same entries) and
turns it into DTensor placements with `placements`: mesh axis `a` at tensor
dim `d` is Shard(d) on mesh dim `a`, a tuple entry shards its dim on each of
its axes (the first the major one, as in JAX), and an axis not named is
Replicate().

create_mesh brings up a world of one (gloo for the CPU, NCCL for CUDA) when
no process group exists, so that a mesh of one needs no launcher.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

DEFAULT_AXES = ("replica", "data", "model")


class P(tuple):
  """JAX's PartitionSpec: one entry per tensor dim, each None, a mesh axis
  name or a tuple of names. Its str is JAX's (params_sharding.txt)."""

  def __new__(cls, *entries):
    return super().__new__(cls, entries)

  def __repr__(self):
    def entry(e):
      if isinstance(e, tuple):
        return "(" + ", ".join(repr(a) for a in e) + ")"
      return repr(e)
    return "PartitionSpec(" + ", ".join(entry(e) for e in self) + ")"

  __str__ = __repr__


def world_size() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape_for(mesh_shape: Sequence[int] | None, n: int,
                   axis_names: Sequence[str] = DEFAULT_AXES,
                   dcn_mesh_shape: Sequence[int] | None = None) -> tuple:
  """The mesh's shape over n devices, as JAX's create_mesh makes it: None
  is (1, n, 1); one -1 takes what the others leave; a DCN shape is folded
  into the ICI axes (each axis times its DCN factor), as JAX does where the
  devices carry no slice index. Raises ValueError where the mesh does not
  cover the n devices exactly."""
  if mesh_shape is None:
    mesh_shape = [1, n, 1][:len(axis_names)]
  mesh_shape = list(mesh_shape)
  if -1 in mesh_shape:
    known = math.prod(d for d in mesh_shape if d != -1)
    mesh_shape[mesh_shape.index(-1)] = n // known
  if len(mesh_shape) != len(axis_names):
    raise ValueError(f"mesh shape {tuple(mesh_shape)} does not name the "
                     f"axes {tuple(axis_names)}")
  if dcn_mesh_shape is not None:
    if len(dcn_mesh_shape) != len(mesh_shape):
      raise ValueError(f"dcn mesh shape {tuple(dcn_mesh_shape)} does not "
                       f"fit mesh shape {tuple(mesh_shape)}")
    mesh_shape = [i * d for i, d in zip(mesh_shape, dcn_mesh_shape)]
  if math.prod(mesh_shape) != n:
    raise ValueError(f"mesh shape {tuple(mesh_shape)} has "
                     f"{math.prod(mesh_shape)} devices; the world has {n}")
  return tuple(mesh_shape)


def _ensure_world(device_type: str):
  """A world of one on an in-memory store where no process group exists."""
  if not dist.is_initialized():
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def create_mesh(mesh_shape: Sequence[int] | None = None,
                axis_names: Sequence[str] = DEFAULT_AXES,
                dcn_mesh_shape: Sequence[int] | None = None,
                device="cuda") -> DeviceMesh:
  """A named mesh over every rank of the world (mesh_shape_for's shape),
  ranks in row-major order as JAX's reshape of its device list. device:
  "cuda" (NCCL) or "cpu" (gloo)."""
  device_type = torch.device(device).type
  shape = mesh_shape_for(mesh_shape, world_size(), axis_names,
                         dcn_mesh_shape)
  _ensure_world(device_type)
  return init_device_mesh(device_type, shape,
                          mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
  """The size of a mesh axis (1 without a mesh, or for an axis it lacks)."""
  if mesh is None or axis not in (mesh.mesh_dim_names or ()):
    return 1
  return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh: DeviceMesh, pspec: P | None) -> tuple:
  """DTensor placements of a PartitionSpec on `mesh` (see the module)."""
  out = [Replicate()] * mesh.ndim
  for d, entry in enumerate(pspec or ()):
    if entry is None:
      continue
    for a in (entry if isinstance(entry, tuple) else (entry,)):
      out[mesh.mesh_dim_names.index(a)] = Shard(d)
  return tuple(out)


def pspec_of(mesh: DeviceMesh, placements_, ndim: int) -> P:
  """The PartitionSpec of DTensor placements (placements' inverse); the
  trailing Nones dropped, as JAX prints a NamedSharding's spec."""
  entries = [[] for _ in range(ndim)]
  for name, pl in zip(mesh.mesh_dim_names, placements_):
    if isinstance(pl, Shard):
      entries[pl.dim].append(name)
  spec = [None if not e else e[0] if len(e) == 1 else tuple(e)
          for e in entries]
  while spec and spec[-1] is None:
    spec.pop()
  return P(*spec)


def mesh_sharding(mesh: DeviceMesh, pspec: P | None) -> tuple:
  """JAX's NamedSharding(mesh, pspec): here the placements to give
  DTensor.from_local / distribute_tensor."""
  return placements(mesh, pspec)


def distribute(x: torch.Tensor, mesh: DeviceMesh, pspec: P | None):
  """A full tensor that every rank holds -> a DTensor of this rank's part
  (no communication)."""
  from torch.distributed.tensor import distribute_tensor
  return distribute_tensor(x.to(mesh.device_type), mesh,
                           placements(mesh, pspec), src_data_rank=None)


def shard_batch(mesh: DeviceMesh, batch, axes=("replica", "data")):
  """This rank's rows of a batch -> DTensors sharded over the data axes on
  the leading dim. One process holds one device, so, as JAX's
  multi-process path, `batch` holds this process's rows only (the global
  batch in a world of one): build_global_batch."""
  from automl_tpu_torch.parallel.distributed import build_global_batch
  axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
  return build_global_batch(batch, mesh, P(axes))


def replicate(mesh: DeviceMesh, tree):
  """Values every rank holds alike -> replicated DTensors."""
  def put(x):
    x = torch.as_tensor(x).to(mesh.device_type)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
  if isinstance(tree, dict):
    return {k: replicate(mesh, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(replicate(mesh, v) for v in tree)
  return put(tree)
