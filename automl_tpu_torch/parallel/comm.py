"""Collectives over one mesh axis, with the gradients the sharded model
needs: JAX's ppermute / psum / all_gather inside shard_map, here
torch.distributed calls on the axis's process group (NCCL for CUDA
tensors, gloo for CPU tensors).

  * permute(x, mesh, axis, shift): x to the rank `shift` further on the
    axis (a ring), the gradient back the other way (JAX's ppermute);
  * copy_to_axis / gather_dim: the pair around a region that each rank of
    an axis computes on its own slice (heads) while the code around it runs
    alike on every rank: identity forward and a sum of the gradient across
    the axis backward, then an all-gather forward and this rank's slice of
    the gradient backward (the conjugate operators of tensor-parallel
    layers);
  * reduce_from_axis: the other half of copy_to_axis's pair, around a
    region whose ranks each compute a part of a sum (their experts): a sum
    across the axis forward, the gradient as it is backward;
  * mean_over: a value each rank computes from its own tokens (or rows,
    or band) -> the mean over the ranks, whose backward is the mean of
    the ranks' gradients;
  * gather_param: a DTensor parameter -> its full tensor, whose gradient
    is summed over the axes that split the tokens (each rank's loss covers
    its own tokens) and cut back to the parameter's placements;
    local_param: the same for the rank's own part (experts, a pipeline
    stage's layers).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


def _ring_shift(x, mesh, axis: str, shift: int):
  g = mesh.get_group(axis)
  ranks = dist.get_process_group_ranks(g)
  n, r = len(ranks), mesh.get_local_rank(axis)
  x = x.contiguous()
  out = torch.empty_like(x)
  ops = [dist.P2POp(dist.isend, x, ranks[(r + shift) % n], g),
         dist.P2POp(dist.irecv, out, ranks[(r - shift) % n], g)]
  for req in dist.batch_isend_irecv(ops):
    req.wait()
  return out


class _Permute(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis, shift):
    ctx.args = (mesh, axis, shift)
    return _ring_shift(x, mesh, axis, shift)

  @staticmethod
  def backward(ctx, g):
    mesh, axis, shift = ctx.args
    return _ring_shift(g, mesh, axis, -shift), None, None, None


def permute(x, mesh, axis: str, shift: int = 1):
  """Ring permute over `axis`: returns the x of the rank `shift` before."""
  return _Permute.apply(x, mesh, axis, shift)


def all_reduce(x, mesh, axes, op=dist.ReduceOp.SUM):
  """x reduced in place over each named axis (of size above 1); returns x."""
  for a in axes:
    if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
      dist.all_reduce(x, op=op, group=mesh.get_group(a))
  return x


def all_gather_dims(x, mesh, axes_dims):
  """x gathered over each (axis, dim) in turn, in rank order (no
  gradient): the global layout of a value each rank holds a part of."""
  for a, d in axes_dims:
    if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
      x = _all_gather(x, mesh, a, d)
  return x


class _ReduceFromAxis(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis):
    return all_reduce(x.contiguous().clone(), mesh, (axis,))

  @staticmethod
  def backward(ctx, g):
    return g, None, None


def reduce_from_axis(x, mesh, axis: str):
  """The sum of x across `axis`; the gradient as it is (each rank's part
  of the sum meets the same gradient)."""
  return _ReduceFromAxis.apply(x, mesh, axis)


class _MeanOver(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axes, n):
    ctx.args = (mesh, axes, n)
    return all_reduce(x.contiguous().clone(), mesh, axes) / n

  @staticmethod
  def backward(ctx, g):
    mesh, axes, n = ctx.args
    return all_reduce(g.contiguous().clone(), mesh, axes) / n, None, None, \
        None


def mean_over(x, mesh, axes):
  """The mean of x over the ranks of `axes` (x itself for none); the
  gradient the mean of the ranks' gradients (each rank's loss covers its
  own part)."""
  axes = tuple(a for a in axes
               if mesh.size(mesh.mesh_dim_names.index(a)) > 1)
  if not axes:
    return x
  n = 1
  for a in axes:
    n *= mesh.size(mesh.mesh_dim_names.index(a))
  return _MeanOver.apply(x, mesh, axes, n)


class _CopyToAxis(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis):
    ctx.args = (mesh, axis)
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    mesh, axis = ctx.args
    return all_reduce(g.contiguous().clone(), mesh, (axis,)), None, None


def copy_to_axis(x, mesh, axis: str):
  """Identity; the gradient is summed across `axis`."""
  return _CopyToAxis.apply(x, mesh, axis)


def _all_gather(x, mesh, axis: str, dim: int):
  g = mesh.get_group(axis)
  parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
  dist.all_gather(parts, x.contiguous(), group=g)
  return torch.cat(parts, dim=dim)


class _GatherDim(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis, dim):
    ctx.args = (mesh, axis, dim, x.shape[dim])
    return _all_gather(x, mesh, axis, dim)

  @staticmethod
  def backward(ctx, g):
    mesh, axis, dim, n = ctx.args
    r = mesh.get_local_rank(axis)
    return g.narrow(dim, r * n, n).contiguous(), None, None, None


def gather_dim(x, mesh, axis: str, dim: int):
  """The slices of every rank of `axis` concatenated along `dim`, in rank
  order; the gradient is this rank's slice (the code after the gather runs
  alike on every rank of the axis)."""
  return _GatherDim.apply(x, mesh, axis, dim)


class _GatherParam(torch.autograd.Function):

  @staticmethod
  def forward(ctx, p, token_axes):
    ctx.args = (p.device_mesh, p.placements, token_axes)
    if _whole(p):
      return p.to_local().detach().view_as(p.to_local())
    return p.full_tensor()

  @staticmethod
  def backward(ctx, g):
    mesh, placements, token_axes = ctx.args
    g = all_reduce(g.contiguous().clone(), mesh, token_axes)
    return distribute_tensor(g, mesh, placements, src_data_rank=None), None


class _LocalParam(torch.autograd.Function):

  @staticmethod
  def forward(ctx, p, token_axes):
    ctx.args = (p.device_mesh, p.placements, tuple(p.shape), p.stride(),
                token_axes)
    return p.to_local().detach().view_as(p.to_local())

  @staticmethod
  def backward(ctx, g):
    mesh, placements, shape, stride, token_axes = ctx.args
    g = all_reduce(g.contiguous().clone(), mesh, token_axes)
    return DTensor.from_local(g, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride), None


def local_param(p, token_axes=()):
  """This rank's part of a DTensor parameter, its gradient summed over
  token_axes (anything else is returned as it is)."""
  if not isinstance(p, DTensor):
    return p
  if not torch.is_grad_enabled() or not p.requires_grad:
    return p.to_local()
  return _LocalParam.apply(p, tuple(token_axes))


def _whole(p) -> bool:
  """Does this rank's part of DTensor p hold all of it?"""
  mesh = p.device_mesh
  return all(isinstance(pl, Replicate) or mesh.size(i) == 1
             for i, pl in enumerate(p.placements))


def gather_param(p, token_axes=()):
  """A parameter as a full tensor: a DTensor is gathered (its gradient
  summed over token_axes, then cut to its placements); anything else is
  returned as it is."""
  if not isinstance(p, DTensor):
    return p
  if not torch.is_grad_enabled() or not p.requires_grad:
    return p.to_local() if _whole(p) else p.full_tensor()
  return _GatherParam.apply(p, tuple(token_axes))
