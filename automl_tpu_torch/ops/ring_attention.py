"""Ring attention: causal attention over a sequence sharded on a mesh axis.

The counterpart of automl_tpu/ops/ring_attention.py (plain jnp there, no
TPU kernel; plain torch here). Each rank holds a contiguous chunk of Q, K
and V. For `ring` steps it attends its Q chunk to the K/V block it holds
(the online-softmax recurrence of flash attention: running max, sum-exp
and weighted accumulator, all f32), then passes the block to the next rank
on the axis. Causality comes from global positions, so past blocks attend
fully, the diagonal block triangularly and future blocks not at all.
Segment ids ride the ring with their block. The gradient flows back
through the permutes (parallel/comm.py permute: the reverse ring).
"""

from __future__ import annotations

import torch

from automl_tpu_torch.parallel import comm

NEG_INF = -1e30


def _block_attend(q, k, v, mask, *, sm_scale: float, logit_cap: float,
                  m_prev, l_prev, acc_prev):
  """One (q-chunk, kv-block) step of the online softmax (JAX's
  _block_attend). q [B,Tq,N,H], k/v [B,Tk,N,H] f32; mask [Tq,Tk],
  [B,Tq,Tk] or None; m, l [B,Tq,N], acc [B,Tq,N,H]."""
  s = torch.einsum("bqnh,bknh->bqnk", q, k) * sm_scale
  if logit_cap:
    s = logit_cap * torch.tanh(s / logit_cap)
  mexp = None
  if mask is not None:
    mexp = mask[None, :, None, :] if mask.ndim == 2 else mask[:, :, None, :]
    s = torch.where(mexp, s, NEG_INF)
  m_new = torch.maximum(m_prev, s.amax(dim=-1))
  # a fully-masked row: exp(NEG_INF - NEG_INF) would be 1
  safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
  p = torch.exp(s - safe_m[..., None])
  if mexp is not None:
    p = torch.where(mexp, p, 0.0)
  correction = torch.exp(torch.where(m_prev <= NEG_INF / 2, NEG_INF,
                                     m_prev - safe_m))
  l_new = l_prev * correction + p.sum(dim=-1)
  acc_new = (acc_prev * correction[..., None]
             + torch.einsum("bqnk,bknh->bqnh", p, v))
  return m_new, l_new, acc_new


def ring_attention(q, k, v, segment_ids=None, *, mesh, axis_name: str,
                   causal: bool = True, window: int | None = None,
                   sm_scale: float | None = None, logit_cap: float = 0.0):
  """This rank's output chunk of attention over a sequence sharded along
  `axis_name` of `mesh`: q, k, v are its [B, T_local, N, H] chunks (rank i
  of the axis holds positions [i*T_local, (i+1)*T_local)). segment_ids:
  optional [B, T_local] packed-document ids. window: a key is visible iff
  q_pos - window < k_pos <= q_pos. GQA: repeat K/V heads first."""
  b, t, n, h = q.shape
  if sm_scale is None:
    sm_scale = h ** -0.5
  if window and not causal:
    raise ValueError("ring_attention: window implies causal "
                     "(q_pos - window < k_pos <= q_pos semantics)")
  ring = mesh.size(mesh.mesh_dim_names.index(axis_name))
  my = mesh.get_local_rank(axis_name)
  qf, k_blk, v_blk = q.float(), k.float(), v.float()
  k_seg = segment_ids
  m = torch.full((b, t, n), NEG_INF, dtype=torch.float32, device=q.device)
  l = torch.zeros((b, t, n), dtype=torch.float32, device=q.device)
  acc = torch.zeros((b, t, n, h), dtype=torch.float32, device=q.device)
  ar = torch.arange(t, device=q.device)
  for step in range(ring):
    src = (my - step) % ring
    mask = None
    if causal:
      qpos, kpos = my * t + ar, src * t + ar
      mask = kpos[None, :] <= qpos[:, None]
      if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    if segment_ids is not None:
      seg_ok = segment_ids[:, :, None] == k_seg[:, None, :]
      mask = seg_ok if mask is None else (mask[None] & seg_ok)
    m, l, acc = _block_attend(qf, k_blk, v_blk, mask, sm_scale=sm_scale,
                              logit_cap=logit_cap, m_prev=m, l_prev=l,
                              acc_prev=acc)
    if step < ring - 1:
      k_blk = comm.permute(k_blk, mesh, axis_name)
      v_blk = comm.permute(v_blk, mesh, axis_name)
      if segment_ids is not None:
        k_seg = comm.permute(k_seg, mesh, axis_name)
  out = acc / torch.clamp(l, min=1e-30)[..., None]
  return out.to(q.dtype)


def _local(x, mesh, dims):
  """This rank's block of a global tensor that every rank holds: dim d cut
  over the mesh axes dims[d] (a tuple, the first the major one)."""
  for d, axes in enumerate(dims):
    idx, count = 0, 1
    for a in axes:
      if a in mesh.mesh_dim_names:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        idx, count = idx * size + mesh.get_local_rank(a), count * size
    n = x.shape[d] // count
    x = x.narrow(d, idx * n, n)
  return x


def ring_attention_sharded(q, k, v, mesh, segment_ids=None, *,
                           seq_axis: str = "model",
                           batch_axes=("replica", "data"),
                           causal: bool = True, window: int | None = None,
                           sm_scale: float | None = None,
                           logit_cap: float = 0.0):
  """ring_attention over `mesh` from global tensors: q, k, v [B, T, N, H]
  (T a multiple of the ring), segment_ids optional [B, T], the same on
  every rank (or DTensors, whose local parts are taken as they are). Each
  rank takes its batch rows (batch_axes) and sequence chunk (seq_axis) and
  returns its [B_local, T_local, N, H] output chunk."""
  from torch.distributed.tensor import DTensor
  dims = (tuple(batch_axes), (seq_axis,))

  def local(x):
    if x is None:
      return None
    if isinstance(x, DTensor):
      return x.to_local()
    return _local(x, mesh, dims)

  return ring_attention(local(q), local(k), local(v), local(segment_ids),
                        mesh=mesh, axis_name=seq_axis, causal=causal,
                        window=window, sm_scale=sm_scale,
                        logit_cap=logit_cap)
