"""Pipeline parallelism (the GPipe schedule) over a named mesh axis.

The counterpart of automl_tpu/parallel/pipeline.py. The stack of layers is
split into S stages over `axis` (stage s holds layers [s L/S, (s+1) L/S));
the batch into M microbatches. On tick t of M + S - 1, stage s runs
microbatch t - s through its layers and sends the result to stage s + 1
(comm.permute, a ring); stage 0 injects microbatch t, and the last stage
stores microbatch t - (S - 1). The outputs are broadcast from the last stage
by a sum over the axis of the masked buffer, as JAX's psum.

Every rank runs its stage on every tick, bubble ticks included, and picks
with masks (torch.where on its stage index), not with Python branches on
the rank: every rank's autograd graph then has the same shape, and the
backward of each permute (the reverse permute) runs in the same order on
every rank. The backward is autograd's, as JAX's is its autodiff. Bubble
ticks run zeros or earlier bubble outputs through the layers; what they
give is never stored, and their aux does not count.
"""

from __future__ import annotations

import torch

from automl_tpu_torch.parallel import comm
from automl_tpu_torch.parallel.mesh import axis_size


def _tree_index(tree, i: int, m: int):
  """Microbatch i of m of each tensor of a tuple (None stays None)."""
  def cut(e):
    if e is None:
      return None
    mb = e.shape[0] // m
    return e[i * mb:(i + 1) * mb]
  return tuple(cut(e) for e in tree)


def _stage(block_fn, stage_blocks, h, extras):
  """This stage's layers in turn; the aux summed over them."""
  aux = None
  for layer in stage_blocks:
    h, a = block_fn(layer, h, extras)
    aux = a if aux is None else aux + a
  if aux is None:
    aux = h.new_zeros((), dtype=torch.float32)
  return h, aux


def pipeline_blocks(x, stage_blocks, extras, block_fn, mesh, axis: str,
                    num_microbatches: int):
  """A stack of layers pipelined over the stages of `axis`.

  x: [B, ...] this rank's input rows, the same on every stage (stage 0
  injects them). stage_blocks: this stage's layers, each handed to
  block_fn(layer, h, extras_mb) -> (h, aux scalar). extras: a tuple of
  per-row side inputs with leading dim B (None entries allowed), cut per
  microbatch. Returns (outputs [B, ...] on every stage, aux): aux is the
  layers' aux summed over the stages and averaged over the microbatches,
  counted only on ticks where a stage runs a real microbatch. B must
  divide by num_microbatches."""
  s_count = axis_size(mesh, axis)
  me = mesh.get_local_rank(axis)
  b, m = x.shape[0], int(num_microbatches)
  if b % m:
    raise ValueError(f"batch {b} does not split into {m} microbatches")
  mb = b // m
  if s_count > 1:
    # x is the same on every stage, and so is its gradient (stage 0's).
    x = comm.copy_to_axis(x, mesh, axis)
  stream = x.reshape((m, mb) + tuple(x.shape[1:]))
  extras = tuple(extras or ())
  first = torch.tensor(me == 0, device=x.device)
  recv = torch.zeros_like(stream[0])
  ys = [torch.zeros_like(stream[0]) for _ in range(m)]
  aux_acc = x.new_zeros((), dtype=torch.float32)
  ticks = m + s_count - 1
  for t in range(ticks):
    act = torch.where(first, stream[min(t, m - 1)], recv)
    mine = t - me                       # the microbatch this stage runs
    out, aux = _stage(block_fn, stage_blocks, act,
                      _tree_index(extras, min(max(mine, 0), m - 1), m))
    valid = torch.tensor(0 <= mine < m, device=x.device)
    aux_acc = aux_acc + torch.where(valid, aux.float(),
                                    torch.zeros_like(aux_acc))
    done = t - (s_count - 1)
    if 0 <= done < m:                   # the same on every rank
      store = torch.tensor(me == s_count - 1, device=x.device)
      ys[done] = torch.where(store, out, ys[done])
    if t + 1 < ticks and s_count > 1:
      recv = comm.permute(out, mesh, axis, 1)
  ys = torch.stack(ys).reshape(x.shape)
  if s_count > 1:
    ys = comm.reduce_from_axis(ys, mesh, axis)
    aux_acc = comm.reduce_from_axis(aux_acc, mesh, axis)
  return ys, aux_acc / m


def pipeline_blocks_sharded(x, stage_blocks, extras, block_fn, mesh,
                            stage_axis: str = "model",
                            batch_axes=("replica", "data"),
                            num_microbatches: int = 4):
  """pipeline_blocks per data-parallel row: x and extras are this rank's
  rows of a batch split over `batch_axes` (each row of the mesh pipelines
  its own rows; dp x pp), stage_blocks its stage's layers. Returns
  (outputs, aux); aux is the mean over the batch axes of each row's aux (its
  gradient as it is: a caller on the token axes counts its share of it, as
  of the loss)."""
  out, aux = pipeline_blocks(x, stage_blocks, extras, block_fn, mesh,
                             stage_axis, num_microbatches)
  axes = tuple(a for a in batch_axes if axis_size(mesh, a) > 1)
  if axes:
    aux = comm.mean_over(aux, mesh, axes)
  return out, aux
