"""The multi-process runtime: one process for each card (or CPU rank).

The counterpart of automl_tpu/parallel/distributed.py. `initialize` brings
up torch.distributed where a run has more than one process, each process
feeds its slice of the global batch (data/lm_pipeline.py
select_local_batch), and `build_global_array` makes the per-process rows
one DTensor sharded over the mesh's data axes, which the sharded model and
train step take.

One process holds one device here (JAX's processes hold several), so a
process's rows are those of its coordinate on the data axes: ranks that
differ only on 'model' hold the same rows.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from automl_tpu_torch.parallel.mesh import P, placements, world_size


def _env_int(*names) -> Optional[int]:
  for name in names:
    if os.environ.get(name):
      return int(os.environ[name])
  return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_secs: float = 600.0) -> None:
  """Brings up torch.distributed; nothing for a one-process run.

  The arguments win; else JAX's JAX_COORDINATOR_ADDRESS /
  JAX_NUM_PROCESSES / JAX_PROCESS_ID, else torchrun's MASTER_ADDR +
  MASTER_PORT / WORLD_SIZE / RANK. With none of them, or a process group
  already up, it does nothing. coordinator_address is host:port (TCP) or a
  file:// URL. backend: "nccl" where CUDA is available, else "gloo". A
  CUDA process takes the card LOCAL_RANK (default: its rank modulo the
  cards)."""
  if dist.is_initialized():
    return
  if coordinator_address is None:
    coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
  if coordinator_address is None and os.environ.get("MASTER_ADDR"):
    coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
  if num_processes is None:
    num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
  if process_id is None:
    process_id = _env_int("JAX_PROCESS_ID", "RANK")
  if coordinator_address is None and num_processes is None:
    return
  if coordinator_address is None or num_processes is None \
      or process_id is None:
    raise ValueError("a multi-process run needs a coordinator address, the "
                     "number of processes and this process's id")
  if backend is None:
    backend = "nccl" if torch.cuda.is_available() else "gloo"
  if backend == "nccl":
    local = _env_int("LOCAL_RANK")
    torch.cuda.set_device(local if local is not None
                          else process_id % torch.cuda.device_count())
  init = (coordinator_address if "://" in coordinator_address
          else f"tcp://{coordinator_address}")
  dist.init_process_group(backend, init_method=init,
                          world_size=int(num_processes),
                          rank=int(process_id),
                          timeout=datetime.timedelta(seconds=timeout_secs))


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
  return world_size()


def barrier() -> None:
  """Waits for every process (nothing in a world of one)."""
  if dist.is_initialized() and dist.get_world_size() > 1:
    dist.barrier()


def batch_coordinate(mesh=None, axes=("replica", "data")) -> tuple:
  """(index, count) of this process on the mesh's data axes: which slice of
  the global batch it holds. Without a mesh, (rank, world)."""
  if mesh is None:
    return process_index(), process_count()
  idx, count = 0, 1
  for a in axes:
    if a in mesh.mesh_dim_names:
      n = mesh.size(mesh.mesh_dim_names.index(a))
      idx, count = idx * n + mesh.get_local_rank(a), count * n
  return idx, count


def local_slice(global_batch_size: int, mesh=None) -> slice:
  """This process's contiguous rows of the global batch."""
  i, n = batch_coordinate(mesh)
  if global_batch_size % n:
    raise ValueError(f"global batch {global_batch_size} does not split "
                     f"over {n} processes")
  per = global_batch_size // n
  return slice(i * per, (i + 1) * per)


def build_global_array(local_array, mesh, pspec: P = P(("replica", "data"))):
  """This process's rows -> one DTensor of the global batch, sharded over
  `mesh` by `pspec` (the leading dim over the data axes by default). Its
  global leading dim is the local one times the product of those axes."""
  local = torch.as_tensor(np.asarray(local_array)).to(mesh.device_type)
  lead = pspec[0] if len(pspec) else None
  lead = () if lead is None else lead if isinstance(lead, tuple) else (lead,)
  n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in lead)
  shape = (local.shape[0] * n,) + tuple(local.shape[1:])
  return DTensor.from_local(local, mesh, placements(mesh, pspec),
                            run_check=False, shape=torch.Size(shape),
                            stride=torch.empty(shape, device="meta").stride())


def build_global_batch(local_batch, mesh,
                       pspec: P = P(("replica", "data"))):
  """build_global_array over a dict / list / tuple of arrays."""
  if isinstance(local_batch, dict):
    return {k: build_global_batch(v, mesh, pspec)
            for k, v in local_batch.items()}
  if isinstance(local_batch, (list, tuple)):
    return type(local_batch)(build_global_batch(v, mesh, pspec)
                             for v in local_batch)
  return build_global_array(local_batch, mesh, pspec)
