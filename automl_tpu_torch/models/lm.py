"""Decoder-only Transformer LM in PyTorch: training and serving.

The counterpart of automl_tpu/models/lm.py: configs, RoPE, masks, RMSNorm,
gated FFN, the MoE FFN with its load-balance loss, attention with GQA,
per-dim query scale and logit caps, chunked local attention, the combined
qkv projection, the rank-3 KV cache written at one offset or per row
(continuous batching), int8 weights, greedy / sampled generation, block
rematerialisation under the JAX model's remat policies, the LM losses
(plain, chunked, fused), distillation and the scaling summary.
The KV-cached attention runs through ops/decode_attention.py (the port of
the TPU decode kernel), the full-sequence attention with use_flash_attention
through ops/attention.py (the ports of the TPU flash forward and the fused
and split backward kernels), the fused loss through ops/xent.py (the ports
of the TPU xent kernels).

Parameters keep the JAX package's layouts, so one parameter tree drives
both packages (convert.py): wq/wk/wv/wo [d, n, h] (with use_combined_qkv,
wqkv [3, d, n, h] where the heads match, else wq and wkv [2, d, n_kv, h]),
per_dim_scale [h], w0/wg [d, f], w1 [f, d] (MoE: router [d, E] f32,
w0/wg [E, d, f], w1 [E, f, d]), norm scale [d], embed [V, d], unembed
[d, V]. An int8 weight (quantize_lm_params) is a QuantizedWeight
module in the parameter's place, {qvalue, scale} as in the JAX tree. The
module holds one TransformerBlock per layer where the JAX tree stacks them
on a leading [L] axis.

On a mesh (TransformerLM(cfg, sharding, mesh=...), parallel/mesh.py) the
parameters are DTensors in the placements of the ShardingConfig's
PartitionSpecs, gathered to full tensors where a layer uses them (their
gradients summed over the ranks that split the tokens and cut back to the
placements: parallel/comm.py gather_param). A rank's activations are its
batch rows (the 'replica' x 'data' coordinate), and with ring attention
active its chunk of the sequence on 'model'. Where the attention weights
put heads on 'model', each rank attends with its own heads and the heads
are gathered after; the rest of a block runs alike on the ranks of that
axis. Serving shards the KV cache over heads (serve_tp: the head-leading
cache and K4 head-major on each rank's heads) or over the sequence
(serve_sp: K4's partials on each rank's keys, merged across the axis).
A prefix-LM mask under ring attention takes the dense path: each rank
attends its own query rows against the keys and values gathered along the
sequence (JAX's GSPMD gathers them likewise). MoE experts are split over
'model' (expert parallelism): each rank runs its experts on its tokens'
slots and the parts are summed across the axis; the routing groups, each
slot's position within its expert and the load-balance loss are those of
the global batch. With use_pipeline on a 'model' axis above 1 the layers
are stacked [L, ...] (JAX's use_scan layout) and split over 'model' on the
layer axis: each rank runs its stage's layers in the GPipe schedule
(parallel/pipeline.py), each microbatch on its own (its own MoE routing).
Without a mesh, or with a 'model' axis of 1, each branch is the one-device
path, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy

from automl_tpu_torch.config import Config
# lax.top_k's order among ties (torch.topk promises none): the MoE router's.
from automl_tpu_torch.models.beam import _top_k
from automl_tpu_torch.ops import attention as attention_lib
from automl_tpu_torch.ops import decode_attention as decode_attention_lib
from automl_tpu_torch.ops import xent as xent_lib
from automl_tpu_torch.ops import ring_attention as ring_lib
from automl_tpu_torch.parallel import comm
from automl_tpu_torch.parallel import distributed as dist_lib
from automl_tpu_torch.parallel import mesh as mesh_lib
from automl_tpu_torch.parallel import pipeline as pipeline_lib
from automl_tpu_torch.parallel.mesh import P

ATTN_LOGIT_CAP = 50.0
FINAL_LOGIT_CAP = 30.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name) -> torch.dtype:
  if isinstance(name, torch.dtype):
    return name
  if name not in _DTYPES:
    raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
  return _DTYPES[name]


# ---------------------------------------------------------------------------
# Configs (the same dicts as automl_tpu/models/lm.py).
# ---------------------------------------------------------------------------


def lm_defaults() -> Config:
  return Config(dict(
      vocab_size=32000,
      model_dim=2048,
      n_layers=24,
      n_heads=16,
      n_kv_heads=16,          # < n_heads => GQA
      head_dim=128,
      expand_factor=4,        # ffn hidden = expand * model_dim
      use_gated_ffn=True,
      use_rmsnorm=True,
      use_pre_ln=True,
      use_post_ln=False,
      use_post_skip_ln=False,
      rope_theta=10000.0,
      window_size=None,       # sliding-window attention
      use_window_chunk=False,
      window_chunk_size=None,
      use_flash_attention=False,
      flash_bwd_fused=True,
      use_decode_kernel=True,     # KV-cached attention through the decode
                                  # kernel (ops/decode_attention.py);
                                  # False = plain batched dots
      decode_kernel_min_s=768,    # cache length below which the plain dots
                                  # run instead of the kernel
      serve_sp=False,
      serve_tp=False,
      use_combined_qkv=False,
      use_per_dim_scale=False,    # learned per-dim query scale in place of
                                  # 1/sqrt(hd); zero-init is exactly 1/sqrt(hd)
      use_ring_attention=False,
      use_pipeline=False,
      pipeline_microbatches=4,
      moe_num_experts=0,
      moe_top_k=1,
      moe_capacity_factor=1.25,
      moe_group_size=4096,
      moe_aux_loss_weight=0.01,
      tie_embeddings=True,
      fused_softmax_loss=False,
      loss_chunk_size=256,
      unembed_matmul_dtype="float32",  # "float32" | "bfloat16" |
                                       # "bfloat16_vjp" (same forward)
      use_scan=True,
      use_remat=True,
      remat_policy="full",
      seq_len=2048,
      attn_logit_cap=ATTN_LOGIT_CAP,
      final_logit_cap=FINAL_LOGIT_CAP,
      param_dtype="float32",
      activation_dtype="bfloat16",
  ))


def lm_experiment_configs() -> dict:
  """Named LM experiment configs: the C4 scaling ladder and a tiny test."""
  common = dict(
      n_heads=8, expand_factor=8, vocab_size=100_864, seq_len=2048,
      n_layers=8, use_gated_ffn=True, tie_embeddings=True,
      use_per_dim_scale=True,
      optimizer="lion", learning_rate=3e-3, weight_decay=1e-1,
      lr_schedule="cosine_decay", end_decay=0.1, warmup_steps=0,
      eval_every=500,
  )
  return {
      # 40.6M params
      "lm-flops2e17": dict(common, model_dim=256, head_dim=32,
                           n_kv_heads=8, batch_size=128,
                           num_train_steps=2588, eval_steps=16),
      # 110.6M params
      "lm-flops1e18": dict(common, model_dim=512, head_dim=64,
                           n_kv_heads=8, batch_size=256,
                           num_train_steps=3626, eval_steps=8),
      # 338.4M params
      "lm-flops1e19": dict(common, model_dim=1024, head_dim=128,
                           n_kv_heads=8, batch_size=512,
                           num_train_steps=5800, eval_steps=4,
                           warmup_steps=1000),
      "lm-test": dict(common, model_dim=32, head_dim=8, n_heads=4,
                      n_kv_heads=4, n_layers=2, expand_factor=4,
                      vocab_size=384, seq_len=64, batch_size=4,
                      num_train_steps=8, eval_steps=2, eval_every=0),
  }


def get_lm_config(name: str = "") -> Config:
  """lm_defaults() overlaid with a named experiment config (if given)."""
  cfg = lm_defaults()
  cfg.update(dict(optimizer="lion", learning_rate=1e-3, weight_decay=1e-1,
                  lr_schedule="cosine_decay", end_decay=0.1, warmup_steps=0,
                  batch_size=8, num_train_steps=100, eval_every=0,
                  eval_steps=8))
  if name:
    named = lm_experiment_configs()
    if name not in named:
      raise ValueError(f"unknown LM config {name!r}; "
                       f"have {sorted(named)}")
    cfg.update(named[name])
  return cfg


def _check_config(cfg: Config):
  if cfg.get("serve_sp") and cfg.get("serve_tp"):
    raise ValueError("serve_sp and serve_tp are mutually exclusive "
                     "(shard the cache over heads OR sequence, not both)")


# ---------------------------------------------------------------------------
# Sharding.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
  """PartitionSpecs over the mesh axes ('replica', 'data', 'model'), JAX's
  ShardingConfig: the default is its GSPMD layout; data_parallel,
  sequence_parallel (pair with use_ring_attention) and fsdp (weights over
  'data') are its other layouts."""
  embed: P = P("model", "data")
  attn_qkv: P = P("data", "model", None)     # [d, heads, head_dim]
  attn_o: P = P("data", "model", None)
  ffn0: P = P("data", "model")
  ffn1: P = P("model", "data")
  norm_scale: P = P()
  activation: P = P(("replica", "data"), None, "model")
  logits: P = P(("replica", "data"), None, "model")
  cache: P = P(("replica", "data"), None, "model", None)

  @classmethod
  def data_parallel(cls):
    none = P()
    act = P(("replica", "data"), None, None)
    return cls(embed=none, attn_qkv=none, attn_o=none, ffn0=none, ffn1=none,
               norm_scale=none, activation=act, logits=act,
               cache=P(("replica", "data"), None, None, None))

  @classmethod
  def sequence_parallel(cls):
    none = P()
    act = P(("replica", "data"), "model", None)
    return cls(embed=none, attn_qkv=none, attn_o=none, ffn0=none, ffn1=none,
               norm_scale=none, activation=act, logits=act,
               cache=P(("replica", "data"), "model", None, None))

  @classmethod
  def fsdp(cls):
    act = P(("replica", "data"), None, None)
    return cls(embed=P("data", None),
               attn_qkv=P("data", None, None),
               attn_o=P("data", None, None),
               ffn0=P("data", None),
               ffn1=P("data", None),
               norm_scale=P(),
               activation=act, logits=act,
               cache=P(("replica", "data"), None, None, None))


def param_spec(name: str, sh: ShardingConfig, moe: bool = False) -> P:
  """The PartitionSpec of a parameter (its name in named_parameters), as
  the JAX model constrains the leaf at use: MoE experts over 'model' (JAX's
  expert_spec); the router, per-dim scale and unembed unconstrained, and an
  int8 weight's qvalue and scale replicated."""
  parts = name.split(".")
  leaf = parts[-1]
  if leaf == "qvalue" or (leaf == "scale" and not parts[-2].endswith("norm")):
    return P()
  if leaf == "embed":
    return sh.embed
  if "attn" in parts:
    return {"wq": sh.attn_qkv, "wk": sh.attn_qkv, "wv": sh.attn_qkv,
            "wo": sh.attn_o, "wqkv": P(None, *sh.attn_qkv),
            "wkv": P(None, *sh.attn_qkv)}.get(leaf, P())
  if "ffn" in parts and leaf in ("w0", "wg", "w1"):
    if moe:
      return P("model", None, None)
    return sh.ffn1 if leaf == "w1" else sh.ffn0
  if leaf == "scale":
    return sh.norm_scale
  return P()


class _Mesh:
  """What the layers of a model on a mesh need to know of it: the mesh,
  the token axes (those that split the tokens, over which gradients are
  summed), whether ring attention splits the sequence on 'model', and
  whether each rank of 'model' attends with its own heads."""

  def __init__(self, mesh, sh: ShardingConfig, cfg: Config):
    self.mesh = mesh
    self.model = mesh_lib.axis_size(mesh, "model")
    self.ring = bool(cfg.get("use_ring_attention")) and self.model > 1
    self.token_axes = tuple(
        a for a in ("replica", "data") + (("model",) if self.ring else ())
        if mesh_lib.axis_size(mesh, a) > 1)
    self.heads = (self.model > 1 and len(sh.attn_qkv) > 1
                  and sh.attn_qkv[1] == "model")
    self.rank = mesh.get_local_rank("model")
    self.pipeline = bool(cfg.get("use_pipeline")) and self.model > 1
    if self.pipeline and self.ring:
      raise ValueError("use_pipeline and use_ring_attention both take mesh "
                       "axis 'model' (stages, sequence chunks)")
    if self.pipeline and not cfg.get("use_scan", True):
      raise ValueError("use_pipeline needs the stacked (use_scan) "
                       "parameter layout")
    if self.pipeline and cfg.n_layers % self.model:
      raise ValueError(f"use_pipeline: n_layers ({cfg.n_layers}) must be "
                       f"divisible by the {self.model} stages on mesh axis "
                       "'model'")

  def __deepcopy__(self, memo):
    return self      # a serving copy of the model shares the mesh


def _w(p, par: Optional[_Mesh]):
  """A parameter as the full tensor a layer multiplies by (gather_param on
  a mesh; the parameter itself otherwise)."""
  return comm.gather_param(p, par.token_axes) if par is not None else p


def _head_parallel(fn, par: Optional[_Mesh], q, k, v, *rest):
  """fn(q, k, v, *rest) -> [B, T, N, H]; on a mesh whose 'model' ranks
  split the heads, each rank runs fn on its own q heads and kv heads and
  the heads are gathered after (the gradients of q, k and v summed across
  the axis, as each rank's covers its own heads)."""
  if par is None or not par.heads:
    return fn(q, k, v, *rest)
  m, r = par.model, par.rank
  n, n_kv = q.shape[2], k.shape[2]
  if n % m or n_kv % m:
    raise ValueError(f"n_heads ({n}) and n_kv_heads ({n_kv}) must be "
                     f"divisible by mesh axis 'model' size {m}")
  q, k, v = (comm.copy_to_axis(x, par.mesh, "model") for x in (q, k, v))
  out = fn(q[:, :, r * n // m:(r + 1) * n // m],
           k[:, :, r * n_kv // m:(r + 1) * n_kv // m],
           v[:, :, r * n_kv // m:(r + 1) * n_kv // m], *rest)
  return comm.gather_dim(out, par.mesh, "model", 2)


# ---------------------------------------------------------------------------
# Positional encoding / masks.
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
  """Rotary embedding on [..., T, H, D] with positions [..., T].

  Pairs are interleaved, (x[..., 0::2], x[..., 1::2]), as in the JAX
  package; angles are computed in f32."""
  d = x.shape[-1]
  freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                 device=x.device) / d)
  angles = positions.to(torch.float32)[..., None, None] * freq
  sin, cos = torch.sin(angles), torch.cos(angles)
  xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
  out1 = xf1 * cos - xf2 * sin
  out2 = xf2 * cos + xf1 * sin
  return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_mask(q_positions, k_positions, window_size: Optional[int] = None,
                segment_ids_q=None, segment_ids_k=None,
                prefix_q=None, prefix_k=None):
  """[..., Tq, Tk] boolean mask, True = attend.

  prefix_q/prefix_k: optional [..., T] {0,1} prefix-LM markers; marked
  positions attend each other bidirectionally. The window bounds only the
  causal term; the segment constraint applies on top of everything."""
  dist = q_positions[..., :, None] - k_positions[..., None, :]
  mask = dist >= 0
  if window_size is not None:
    mask &= dist < window_size
  if prefix_q is not None:
    mask = mask | ((prefix_q[..., :, None] > 0) & (prefix_k[..., None, :] > 0))
  if segment_ids_q is not None:
    mask &= segment_ids_q[..., :, None] == segment_ids_k[..., None, :]
  return mask


def _param(shape, dtype, device):
  return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class QuantizedWeight(nn.Module):
  """An int8 weight in a parameter's place: qvalue int8 in the weight's
  shape and scale f32 [1, ..., 1, out], the weight being qvalue * scale
  (the JAX tree's {'qvalue', 'scale'} dict; quantize_lm_params)."""

  def __init__(self, qvalue, scale):
    super().__init__()
    self.qvalue = nn.Parameter(qvalue, requires_grad=False)
    self.scale = nn.Parameter(scale, requires_grad=False)


def _maybe_dequant(w, dtype, par: Optional[_Mesh] = None):
  """The weight in `dtype`: qvalue * scale, each cast first, for an int8
  weight (as JAX's _maybe_dequant), else w cast; on a mesh, gathered."""
  if isinstance(w, QuantizedWeight):
    return _w(w.qvalue, par).to(dtype) * _w(w.scale, par).to(dtype)
  return _w(w, par).to(dtype)


def _row_writes(cache_index, t: int, s_len: int, n_kv: int,
                head_major: bool = False):
  """Where a per-row cache write lands, without a host sync: (at, src, live)
  for the rank-3 cache's B * n_kv rows.

  cache_index [B]: row b writes its T tokens at cache_index[b] + arange(T);
  [B, T]: explicit positions. A position outside [0, S) is dropped (JAX's
  scatter mode="drop"). torch's scatter has no drop mode, and its order
  between equal indices is undefined, so no write may go to a position
  another write of the row takes with another value: a dropped token
  writes its row's first valid token's value at that token's position
  (the same bits twice), and a row with no valid token writes position 0's
  own old value back. at [R, T] is each write's position, src [R, T] the
  token whose value it writes, live [R, 1, 1] whether the row has a valid
  token (else the value is position 0's). head_major: the rows are
  r = h*B + b (serve_tp's head-leading cache), else r = b*n_kv + h."""
  if cache_index.ndim == 1:
    pos = cache_index[:, None] + torch.arange(t, device=cache_index.device)
  else:
    pos = cache_index
  pos = pos.long()
  valid = (pos >= 0) & (pos < s_len)
  first = valid.to(torch.int32).argmax(dim=1, keepdim=True)
  src = torch.where(valid, torch.arange(t, device=pos.device), first)
  live = valid.any(dim=1, keepdim=True)
  at = torch.where(live, pos.gather(1, src), 0)
  if head_major:
    rows = lambda x: x.repeat(n_kv, 1)
  else:
    rows = lambda x: x.repeat_interleave(n_kv, dim=0)
  return rows(at), rows(src), rows(live)[:, :, None]


def _write_cache(kc, vc, k, v, cache_index, head_major: bool = False):
  """Writes k, v [B, T, n_kv, hd] into the rank-3 cache in place: at one
  offset (an int), or per row (_row_writes' triple). head_major: rows
  r = h*B + b, else r = b*n_kv + h."""
  b, t, n_kv, hd = k.shape
  order = (2, 0) if head_major else (0, 2)
  kr = k.permute(*order, 3, 1).reshape(b * n_kv, hd, t).to(kc.dtype)
  vr = v.permute(*order, 1, 3).reshape(b * n_kv, t, hd).to(vc.dtype)
  if isinstance(cache_index, int):
    kc[:, :, cache_index:cache_index + t] = kr
    vc[:, cache_index:cache_index + t] = vr
    return
  at, src, live = cache_index
  at_k, at_v = at[:, None].expand(-1, hd, -1), at[..., None].expand(-1, -1, hd)
  k_val = torch.where(live, kr.gather(2, src[:, None].expand(-1, hd, -1)),
                      kc.gather(2, at_k))
  v_val = torch.where(live, vr.gather(1, src[..., None].expand(-1, -1, hd)),
                      vc.gather(1, at_v))
  kc.scatter_(2, at_k, k_val)
  vc.scatter_(1, at_v, v_val)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------


class Attention(nn.Module):
  """Multi-head attention with GQA, RoPE, soft cap and the rank-3 KV cache."""

  def __init__(self, cfg: Config, device=None, par=None):
    super().__init__()
    self.cfg = cfg
    self.par = par
    self.n_heads = cfg.n_heads
    self.n_kv = cfg.n_kv_heads
    self.head_dim = cfg.head_dim
    d, hd = cfg.model_dim, cfg.head_dim
    dt = _dtype(cfg.param_dtype)
    if cfg.get("use_combined_qkv") and self.n_kv == self.n_heads:
      self.wqkv = _param((3, d, self.n_heads, hd), dt, device)
    else:
      self.wq = _param((d, self.n_heads, hd), dt, device)
      if cfg.get("use_combined_qkv"):           # GQA: q apart, k and v stacked
        self.wkv = _param((2, d, self.n_kv, hd), dt, device)
      else:
        self.wk = _param((d, self.n_kv, hd), dt, device)
        self.wv = _param((d, self.n_kv, hd), dt, device)
    self.wo = _param((d, self.n_heads, hd), dt, device)
    if cfg.get("use_per_dim_scale"):
      self.per_dim_scale = _param((hd,), torch.float32, device)

  def _qkv(self, x, adt):
    w = lambda p: _maybe_dequant(p, adt, self.par)
    if hasattr(self, "wqkv"):
      return torch.einsum("btd,cdnh->cbtnh", x, w(self.wqkv)).unbind(0)
    q = torch.einsum("btd,dnh->btnh", x, w(self.wq))
    if hasattr(self, "wkv"):
      k, v = torch.einsum("btd,cdnh->cbtnh", x, w(self.wkv)).unbind(0)
    else:
      k = torch.einsum("btd,dnh->btnh", x, w(self.wk))
      v = torch.einsum("btd,dnh->btnh", x, w(self.wv))
    return q, k, v

  def forward(self, x, positions, mask, cache=None, cache_index=None,
              segment_ids=None):
    """x: [B, T, D]; mask: [B, T, S] bool, or None where the flash kernel
    masks by itself (causal, window and segment_ids [B, T]). cache: optional
    {k: [B*n_kv, hd, S], v: [B*n_kv, S, hd]} (TransformerLM.init_cache),
    written in place at cache_index: an int (every row at that offset), or
    _row_writes' triple for per-row positions (TransformerLM.forward makes
    it once for every layer). Returns (out [B, T, D], cache)."""
    cfg, par = self.cfg, self.par
    adt = _dtype(cfg.activation_dtype)
    x = x.to(adt)
    wo = _maybe_dequant(self.wo, adt, par)
    q, k, v = self._qkv(x, adt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.get("use_per_dim_scale"):
      # r_softplus_0 / sqrt(hd) * softplus(s), the constant rounded to the
      # activation dtype first and the product taken in f32, as in JAX.
      r_softplus_0 = 1.442695041
      pds = torch.tensor(r_softplus_0 / math.sqrt(self.head_dim), dtype=adt)
      pds = pds.float() * torch.logaddexp(
          _w(self.per_dim_scale, par).float(),
          torch.zeros((), device=x.device))
      q = (q.float() * pds).to(adt)
    else:
      q = q * (self.head_dim ** -0.5)
    project = lambda out: torch.einsum("bqnh,dnh->bqd", out.to(adt), wo)

    if cache is None:
      if mask is None and cfg.get("use_window_chunk") and \
          cfg.get("window_chunk_size"):
        # The two-chunk local attention, before the flash branch as in JAX:
        # with both options on, the chunk path runs.
        def chunk(q, k, v):
          return chunked_local_attn(q, self._repeat_kv(k), self._repeat_kv(v),
                                    positions, int(cfg.window_chunk_size),
                                    cfg.attn_logit_cap or 0.0,
                                    segment_ids=segment_ids)
        return project(_head_parallel(chunk, par, q, k, v)), None
      if mask is None and par is not None and par.ring:
        # Ring attention over the sequence chunks on 'model' (x holds this
        # rank's chunk); a 'model' axis of 1 falls through, as in JAX.
        out = ring_lib.ring_attention(
            q, self._repeat_kv(k), self._repeat_kv(v), segment_ids,
            mesh=par.mesh, axis_name="model", causal=True,
            window=cfg.window_size, sm_scale=1.0,
            logit_cap=cfg.attn_logit_cap or 0.0)
        return project(out), None
      if mask is None:
        # TransformerLM passes mask=None exactly when a fused path
        # should mask by itself (JAX: uses_fused_mask).
        def flash(q, k, v):
          return attention_lib.flash_attention(
              q, k, v, causal=True, window=cfg.window_size,
              logit_cap=cfg.attn_logit_cap or 0.0, sm_scale=1.0,
              segment_ids=segment_ids,
              bwd_fused=bool(cfg.get("flash_bwd_fused", False)))
        out = _head_parallel(flash, par, q, k, v)
        if cfg.get("use_remat") and cfg.get("remat_policy") == "dots_attn":
          # JAX names the output checkpoint_name(out, "attn_out") for this
          # policy; here the name costs a copy, so it is made only where the
          # policy saves it.
          out = checkpoint_name(out, "attn_out")
        return project(out), None
      if par is not None and par.ring:
        # A materialised mask (prefix-LM) under ring attention: this rank's
        # query rows against the keys and values of the whole sequence
        # (their gradients summed over the ranks, then cut to the chunk).
        k, v = (comm.copy_to_axis(comm.gather_dim(z, par.mesh, "model", 1),
                                  par.mesh, "model") for z in (k, v))
      return project(_head_parallel(
          lambda q, k, v: self._dense(q, k, v, mask, adt), par, q, k, v)), None

    if cfg.get("serve_tp"):
      return project(self._decode_tp(q, k, v, mask, cache, cache_index)), cache
    b, t = x.shape[0], x.shape[1]
    kc, vc = cache["k"], cache["v"]
    s_len = kc.shape[-1]
    if not isinstance(cache_index, tuple):
      cache_index = int(cache_index)
    # Written in place: the JAX model returns a new cache, the port keeps
    # one copy of it on the device.
    _write_cache(kc, vc, k, v, cache_index)
    if cfg.get("serve_sp"):
      # Sequence-parallel serving: this rank's keys of the cache (the
      # writes above were cut to them: TransformerLM.forward).
      if not cfg.get("use_decode_kernel", True):
        raise ValueError("serve_sp requires use_decode_kernel=True")
      cap = cfg.attn_logit_cap or 0.0
      if par is not None and par.model > 1:
        out = decode_attention_lib.decode_attention_sp(
            q, kc, vc, mask.contiguous(), par.mesh, n_kv_heads=self.n_kv,
            logit_cap=cap, local=True)
      else:   # one shard is the whole sequence
        out = decode_attention_lib.decode_attention(
            q, kc, vc, mask.contiguous(), n_kv_heads=self.n_kv,
            logit_cap=cap)
      return project(out), cache
    if cfg.get("use_decode_kernel", True) and \
        s_len >= int(cfg.get("decode_kernel_min_s", 768) or 0):
      out = decode_attention_lib.decode_attention(
          q, kc, vc, mask.contiguous(), n_kv_heads=self.n_kv,
          logit_cap=cfg.attn_logit_cap or 0.0)
      return project(out), cache

    # Plain rank-3 batched dots below the gate (masked with -1e9, as the
    # JAX model's dots path; the kernel masks with -1e30).
    kr, vr = kc, vc
    if self.n_kv != self.n_heads:
      rep = self.n_heads // self.n_kv
      kr = kr.reshape(b, self.n_kv, self.head_dim, s_len).repeat_interleave(
          rep, dim=1).reshape(-1, self.head_dim, s_len)
      vr = vr.reshape(b, self.n_kv, s_len, self.head_dim).repeat_interleave(
          rep, dim=1).reshape(-1, s_len, self.head_dim)
    qr = q.permute(0, 2, 1, 3).reshape(b * self.n_heads, t, self.head_dim)
    logits = torch.bmm(qr, kr.to(qr.dtype)).reshape(b, self.n_heads, t, s_len)
    logits = self._cap(logits)
    logits = logits.masked_fill(~mask[:, None], -1e9)
    probs = torch.softmax(logits, dim=-1).to(adt)
    out = torch.bmm(probs.reshape(b * self.n_heads, t, s_len), vr.to(adt))
    out = out.reshape(b, self.n_heads, t, self.head_dim).permute(0, 2, 1, 3)
    return torch.einsum("bqnh,dnh->bqd", out, wo), cache

  def _decode_tp(self, q, k, v, mask, cache, cache_index):
    """Tensor-parallel serving: the head-leading cache k [n_kv, B, hd, S],
    v [n_kv, B, S, hd] (this rank's n_kv / m heads on a mesh), written in
    place, then K4 head-major on the rank's heads (decode_attention_tp)."""
    cfg, par = self.cfg, self.par
    if not cfg.get("use_decode_kernel", True):
      raise ValueError("serve_tp requires use_decode_kernel=True")
    kc, vc = cache["k"], cache["v"]
    n_kv_l, b = kc.shape[0], kc.shape[1]
    m = par.model if par is not None else 1
    if m > 1:     # init_cache made this rank's heads: n_kv_l = n_kv / m
      k = k[:, :, par.rank * n_kv_l:(par.rank + 1) * n_kv_l]
      v = v[:, :, par.rank * n_kv_l:(par.rank + 1) * n_kv_l]
    # The rank-3 head-major view the kernel reads; a slot's view of the
    # cache (LMServer's chunked prefill) is strided: written through a
    # copy, copied back.
    whole = kc.is_contiguous() and vc.is_contiguous()
    k3 = kc.contiguous().view(n_kv_l * b, self.head_dim, kc.shape[-1])
    v3 = vc.contiguous().view(n_kv_l * b, vc.shape[2], self.head_dim)
    if not isinstance(cache_index, tuple):
      cache_index = int(cache_index)
    _write_cache(k3, v3, k, v, cache_index, head_major=True)
    if not whole:
      kc.copy_(k3.view(kc.shape))
      vc.copy_(v3.view(vc.shape))
    cap = self.cfg.attn_logit_cap or 0.0
    if m > 1:
      return decode_attention_lib.decode_attention_tp(
          q, k3.view(kc.shape), v3.view(vc.shape), mask.contiguous(),
          par.mesh, n_kv_heads=self.n_kv, logit_cap=cap, local=True)
    return decode_attention_lib.decode_attention(
        q, k3, v3, mask.contiguous(), n_kv_heads=self.n_kv, logit_cap=cap,
        layout="head_major")

  def _cap(self, logits):
    cap = self.cfg.attn_logit_cap
    if cap:
      return cap * torch.tanh(logits.float() / cap)
    return logits.float()

  def _repeat_kv(self, x):
    """[B, T, n_kv, hd] -> [B, T, n, hd] (GQA: each kv head repeated)."""
    rep = self.n_heads // self.n_kv
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)

  def _dense(self, q, k, v, mask, adt):
    """The no-cache path: dense softmax attention over [B, T, T]."""
    k, v = self._repeat_kv(k), self._repeat_kv(v)
    logits = self._cap(torch.einsum("bqnh,bknh->bnqk", q, k.to(q.dtype)))
    logits = logits.masked_fill(~mask[:, None], -1e9)
    probs = torch.softmax(logits, dim=-1).to(adt)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.to(adt))


def chunked_local_attn(q, k, v, positions, window_chunk_size: int,
                       attn_logit_cap: float = ATTN_LOGIT_CAP,
                       segment_ids=None):
  """Blockwise local attention (JAX's chunked_local_attn): chunk i attends
  to chunks i - 1 and i, causally, O(T * 2c) in place of O(T^2).

  q, k, v: [B, T, N, H] with T a multiple of the chunk (positions is
  unused, as in JAX). segment_ids: optional [B, T] packed-document ids (no
  attention across documents). With a cap the logits are capped in f32,
  else they stay in q's dtype, as in JAX. Returns [B, T, N, H]."""
  del positions
  b, t, n, h = q.shape
  c = window_chunk_size
  if t % c:
    raise ValueError(f"sequence length {t} is not a multiple of "
                     f"window_chunk_size {c}")
  nc = t // c
  qc = q.reshape(b, nc, c, n, h)
  kc = k.reshape(b, nc, c, n, h)
  vc = v.reshape(b, nc, c, n, h)
  # The previous chunk's k / v (zeros before chunk 0).
  kprev = F.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
  vprev = F.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
  k2 = torch.cat([kprev, kc], dim=2)                   # [B, nc, 2c, N, H]
  v2 = torch.cat([vprev, vc], dim=2)
  logits = torch.einsum("bgqnh,bgknh->bgnqk", qc, k2)
  if attn_logit_cap:
    logits = attn_logit_cap * torch.tanh(logits.float() / attn_logit_cap)
  # Query i of chunk g sits at c + i of its two-chunk window, key j at j:
  # attend where j <= c + i, and never to chunk 0's missing predecessor.
  qi = torch.arange(c, device=q.device)[:, None] + c
  kj = torch.arange(2 * c, device=q.device)[None, :]
  base = kj <= qi
  chunk_ids = torch.arange(nc, device=q.device)[:, None, None]
  mask = torch.where(chunk_ids == 0, base & (kj >= c), base)
  mask = mask[None].expand(b, nc, c, 2 * c)
  if segment_ids is not None:
    seg_c = segment_ids.reshape(b, nc, c)
    seg_prev = F.pad(seg_c, (0, 0, 1, 0), value=-1)[:, :-1]
    seg_k = torch.cat([seg_prev, seg_c], dim=2)        # [B, nc, 2c]
    mask = mask & (seg_c[..., :, None] == seg_k[..., None, :])
  logits = logits.masked_fill(~mask[:, :, None], -1e9)
  probs = torch.softmax(logits, dim=-1).to(v2.dtype)
  out = torch.einsum("bgnqk,bgknh->bgqnh", probs, v2)
  return out.reshape(b, t, n, h)


# ---------------------------------------------------------------------------
# Norm / FFN / Block.
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
  """normed(x) * (1 + scale), in f32, eps 1e-6."""

  def __init__(self, dim: int, device=None, par=None):
    super().__init__()
    self.par = par
    self.scale = _param((dim,), torch.float32, device)

  def forward(self, x):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + 1e-6)
    return (normed * (1.0 + _w(self.scale, self.par))).to(x.dtype)


class FFN(nn.Module):
  """Gated FFN: (silu(x wg) * x w0) w1; ungated: silu(x w0) w1."""

  def __init__(self, cfg: Config, device=None, par=None):
    super().__init__()
    self.cfg = cfg
    self.par = par
    d = cfg.model_dim
    hidden = cfg.expand_factor * d
    dt = _dtype(cfg.param_dtype)
    self.w0 = _param((d, hidden), dt, device)
    self.w1 = _param((hidden, d), dt, device)
    if cfg.use_gated_ffn:
      self.wg = _param((d, hidden), dt, device)

  def forward(self, x):
    adt = _dtype(self.cfg.activation_dtype)
    x = x.to(adt)
    w = lambda p: _maybe_dequant(p, adt, self.par)
    h = x @ w(self.w0)
    if self.cfg.use_gated_ffn:
      h = F.silu(x @ w(self.wg)) * h
    else:
      h = F.silu(h)
    return h @ w(self.w1)


class MoEFFN(nn.Module):
  """Mixture-of-experts FFN (JAX's MoEFFN): top-k routing with a static
  capacity per routing group; forward(x) -> (out, aux).

  The router logits are taken in full f32 (no TF32: a flipped expert
  changes the output), then the softmax and the top-k (lax.top_k's order
  among ties); the k gates are renormalised by max(sum, 1e-9). aux is the
  Switch load-balance loss from the top-1 choice, E * sum_e (share of
  tokens routed to e) * (mean probability of e), 1 at perfect balance.
  Tokens are routed in groups of the largest divisor of B * T that is at
  most moe_group_size; each expert takes capacity = max(1, int(cf * k *
  group / E)) slots of a group, filled in token-major order over the
  flattened [group * k] (token, choice) slots, and a slot past it is
  dropped. JAX dispatches and combines with one-hot einsums; here a gather
  takes each kept slot's activation to its (expert, position), and a
  gather takes each expert output back to its slot. A one-hot contraction
  has one non-zero term, so the values are the same: the expert input in
  the activation dtype, silu(x wg) * (x w0) (or silu(x w0)) then w1 per
  expert, the gated sum of the k slots in f32, cast to the activation
  dtype.

  On a mesh the routing is the global batch's (_global_slots: groups,
  capacity and positions over every rank's tokens) and aux the product of
  the two global means; where the ranks of 'model' hold the same tokens,
  each runs its E / m experts (JAX's expert_spec P('model', None, None))
  on the slots routed to them and the slots' outputs are summed across
  the axis (each from one rank) before the gates."""

  def __init__(self, cfg: Config, device=None, par=None):
    super().__init__()
    self.cfg = cfg
    self.par = par
    d = cfg.model_dim
    hidden = cfg.expand_factor * d
    e = self.num_experts = int(cfg.moe_num_experts)
    self.top_k = int(cfg.get("moe_top_k", 1) or 1)
    self.capacity_factor = float(cfg.get("moe_capacity_factor", 1.25))
    dt = _dtype(cfg.param_dtype)
    self.router = _param((d, e), torch.float32, device)
    self.w0 = _param((e, d, hidden), dt, device)
    self.w1 = _param((e, hidden, d), dt, device)
    if cfg.use_gated_ffn:
      self.wg = _param((e, d, hidden), dt, device)

  def routing(self, s: int):
    """(group size, capacity) for s = B * T tokens."""
    g_size = min(s, int(self.cfg.get("moe_group_size", 4096) or 4096))
    if s % g_size:
      g_size = max(g for g in range(1, g_size + 1) if s % g == 0)
    return g_size, max(1, int(self.capacity_factor * self.top_k * g_size
                              / self.num_experts))

  def route(self, x):
    """(gates [S, k] renormalised, experts [S, k], probs [S, E]) of x
    [B, T, D]."""
    xf = x.reshape(-1, x.shape[-1])
    with _full_f32_matmul():
      logits = xf.float() @ _w(self.router, self.par).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, self.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs

  def slots(self, idx, g_size: int, capacity: int, off: int = 0,
            earlier=None):
    """Where each of the S * k (token, choice) slots of idx ([S, k] or
    [B, T, k]) goes: its flat (group, expert, position) index, or groups *
    E * capacity (a spare row) where it is dropped; and whether it is kept.
    [S * k] each.

    The tokens are a contiguous run of the global batch from its off-th
    token; groups count from the first one the run falls in. A slot's
    position counts the same expert's slots before it in its group: the
    run's own, then earlier(counts), the slots of the global tokens before
    the run in the same groups ([groups, E], from the run's own [groups,
    E] counts; none without)."""
    e, k = self.num_experts, self.top_k
    flat_e = idx.reshape(-1)
    s = flat_e.shape[0] // k
    first = off // g_size
    groups = (off + s - 1) // g_size - first + 1
    lg = (off + torch.arange(s * k, device=idx.device) // k) // g_size - first
    onehot = F.one_hot(flat_e, e)
    counts = torch.zeros((groups, e), dtype=onehot.dtype,
                         device=idx.device).index_add_(0, lg, onehot)
    # The same expert's earlier slots of the run within the group.
    before = (torch.cumsum(onehot, 0) - onehot
              - (torch.cumsum(counts, 0) - counts)[lg])
    if earlier is not None:
      before = before + earlier(counts)[lg]
    pos = (before * onehot).sum(-1)
    keep = pos < capacity
    dest = torch.where(keep, (lg * e + flat_e) * capacity + pos,
                       groups * e * capacity)
    return dest, keep

  def _global_slots(self, idx):
    """(dest, keep, groups, capacity) of this rank's B * T * k slots
    within the routing of the global batch (slots; groups counts the groups
    the rank's tokens span).

    On a mesh the group size and the capacity follow from the global token
    count, and a group may span ranks. This rank's rows (with ring
    attention gathered whole over 'model' first) are a contiguous run of
    the global order, so the earlier ranks' slots in its groups are an
    exclusive prefix over the data ranks of the per-group per-expert counts
    (one all-gather of [groups, E]). Without a mesh the rows are the whole
    batch."""
    par, k, e = self.par, self.top_k, self.num_experts
    b, t = idx.shape[:2]
    rows, row, n_rows, earlier = idx, 0, 1, None
    if par is not None:
      if par.ring:
        rows = comm.all_gather_dims(idx, par.mesh, (("model", 1),))
      row, n_rows = dist_lib.batch_coordinate(par.mesh)
    s_rows = b * rows.shape[1]
    g_size, capacity = self.routing(s_rows * n_rows)
    off = row * s_rows
    first = off // g_size
    groups = (off + s_rows - 1) // g_size - first + 1
    if par is not None:
      def earlier(counts):
        mine = counts.new_zeros((s_rows * n_rows // g_size, e))
        mine[first:first + groups] = counts
        everyone = comm.all_gather_dims(mine[None], par.mesh,
                                        (("data", 0), ("replica", 0)))
        return everyone[:row].sum(0)[first:first + groups]
    dest, keep = self.slots(rows, g_size, capacity, off, earlier)
    if par is not None and par.ring:   # this rank's chunk of each row
      tg, dev = rows.shape[1], idx.device
      sel = ((torch.arange(b, device=dev)[:, None] * tg + par.rank * t
              + torch.arange(t, device=dev)[None, :]).reshape(-1, 1) * k
             + torch.arange(k, device=dev)).reshape(-1)
      dest, keep = dest[sel], keep[sel]
    return dest, keep, groups, capacity

  def _expert_w(self, p, adt, e0: int, n: int):
    """Experts [e0, e0 + n) of an expert weight in the activation dtype:
    on a mesh this rank's part (its gradient summed over the token axes),
    gathered whole where ring attention splits the tokens over 'model' (or
    an int8 weight is whole), cut to the range where it holds every
    expert."""
    par = self.par
    if par is None or par.ring or isinstance(p, QuantizedWeight):
      w = _maybe_dequant(p, adt, par)
    else:
      w = comm.local_param(p, par.token_axes).to(adt)
    return w if w.shape[0] == n else w[e0:e0 + n]

  def forward(self, x):
    adt = _dtype(self.cfg.activation_dtype)
    e, k, par = self.num_experts, self.top_k, self.par
    b, t, d = x.shape
    s = b * t
    gates, idx, probs = self.route(x)
    top1_mean = F.one_hot(idx[:, 0], e).float().mean(0)
    probs_mean = probs.mean(0)
    tok = par.token_axes if par is not None else ()
    if tok:
      # The aux of the global tokens: a product of two global means (its
      # value on every rank; a trainer counts this rank's share).
      top1_mean = comm.mean_over(top1_mean, par.mesh, tok)
      probs_mean = comm.mean_over(probs_mean, par.mesh, tok)
    aux = e * torch.sum(top1_mean * probs_mean)

    dest, keep, groups, capacity = self._global_slots(idx.reshape(b, t, k))
    # Expert parallelism, on any mesh: where the ranks of 'model' hold the
    # same tokens, each runs its E / m experts (all E at m = 1) on the
    # slots routed to them. With ring attention the tokens split 'model'
    # already: each rank gathers the experts whole.
    ep = par is not None and not par.ring
    m = par.model if ep else 1
    if e % m:
      raise ValueError(f"moe_num_experts ({e}) must be divisible by mesh "
                       f"axis 'model' size {m}")
    el = e // m
    e0 = par.rank * el if ep else 0
    if ep:
      cap_e = e * capacity
      grp, rem = dest // cap_e, dest % cap_e
      ex, pos = rem // capacity, rem % capacity
      mine = keep & (ex >= e0) & (ex < e0 + el)
      dest = torch.where(mine, (grp * el + ex - e0) * capacity + pos,
                         groups * el * capacity)
      xe = comm.copy_to_axis(x, par.mesh, "model")
    else:
      xe = x
    n_rows = groups * el * capacity
    # The slot each (group, expert, position) row takes its input from; the
    # spare slot index s * k (a zero row) where no slot lands.
    z = torch.arange(s * k, device=x.device)
    src = torch.full((n_rows + 1,), s * k, dtype=torch.long,
                     device=x.device).scatter_(0, dest, z)[:n_rows]
    x_slots = xe.reshape(s, d).to(adt).repeat_interleave(k, dim=0)
    x_slots = torch.cat([x_slots, x_slots.new_zeros(1, d)])
    expert_in = x_slots[src].reshape(groups, el, capacity, d)
    expert_in = expert_in.transpose(0, 1).reshape(el, groups * capacity, d)
    w = lambda p: self._expert_w(p, adt, e0, el)
    h = torch.bmm(expert_in, w(self.w0))
    if self.cfg.use_gated_ffn:
      h = F.silu(torch.bmm(expert_in, w(self.wg))) * h
    else:
      h = F.silu(h)
    out_e = torch.bmm(h, w(self.w1))   # [E_l, G*C, D]
    out_e = out_e.reshape(el, groups, capacity, d).transpose(0, 1)
    out_e = torch.cat([out_e.reshape(n_rows, d).float(),
                       out_e.new_zeros(1, d, dtype=torch.float32)])
    out_slots = out_e[dest]                               # [S*k, D] f32
    if ep:
      # Each slot's value comes from one rank (zeros on the others).
      out_slots = comm.reduce_from_axis(out_slots, par.mesh, "model")
    out = out_slots * (gates.reshape(-1) * keep.float())[:, None]
    return out.reshape(s, k, d).sum(1).reshape(b, t, d).to(adt), aux


class TransformerBlock(nn.Module):

  def __init__(self, cfg: Config, device=None, par=None):
    super().__init__()
    d = cfg.model_dim
    self.attn = Attention(cfg, device, par)
    self.is_moe = bool(cfg.get("moe_num_experts"))
    self.ffn = (MoEFFN if self.is_moe else FFN)(cfg, device, par)
    self.pre_attn_norm = RMSNorm(d, device, par)
    self.pre_ffn_norm = RMSNorm(d, device, par)
    self.post_attn_norm = RMSNorm(d, device, par) if cfg.use_post_ln else None
    self.post_ffn_norm = RMSNorm(d, device, par) if cfg.use_post_ln else None

  def forward(self, x, positions, mask, cache=None, cache_index=None,
              segment_ids=None):
    """-> (x, cache); an MoE block also returns its FFN's load-balance
    loss: (x, cache, aux)."""
    attn_out, new_cache = self.attn(self.pre_attn_norm(x), positions, mask,
                                    cache, cache_index, segment_ids)
    if self.post_attn_norm is not None:
      attn_out = self.post_attn_norm(attn_out)
    x = x + attn_out
    h = self.pre_ffn_norm(x)
    ffn_out, aux = self.ffn(h) if self.is_moe else (self.ffn(h), None)
    if self.post_ffn_norm is not None:
      ffn_out = self.post_ffn_norm(ffn_out)
    if self.is_moe:
      return x + ffn_out, new_cache, aux
    return x + ffn_out, new_cache


# ---------------------------------------------------------------------------
# Remat policies.
# ---------------------------------------------------------------------------


@torch.library.custom_op("automl_tpu_torch::checkpoint_name",
                         mutates_args=(), schema="(Tensor x, str name) -> Tensor")
def checkpoint_name(x, name):
  """JAX's checkpoint_name: x (a copy: an op's output may not alias its
  input) under a name that a remat policy can save."""
  return x.clone()


@checkpoint_name.register_fake
def _(x, name):
  return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))

_aten = torch.ops.aten
# The matrix products the blocks lower to: x @ w to mm, torch.einsum to bmm.
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default)


def _is_dot(op, args, no_batch: bool) -> bool:
  """A matrix product; with no_batch, only one without batch dims, as JAX
  classifies dot_general. torch.einsum lowers the projections
  ("btd,dnh->btnh") to a bmm with a batch of 1, which has none; the dense
  attention's "bnqk" products are bmms with a batch of B * N."""
  if op not in _DOTS:
    return False
  return not (no_batch and op is _aten.bmm.default and args[0].shape[0] > 1)


def _remat_policy(cfg):
  """cfg.remat_policy -> a torch.utils.checkpoint selective policy (None =
  "full": recompute all), as JAX's _remat_policy.

  "dots" saves every matrix product's output in the block (the projections,
  the FFN, the dense attention's products); the flash forward is not a
  product and runs again in the backward. "dots_no_batch" saves only the
  products without batch dims. "dots_flash" saves, besides, the flash
  forward's (out, lse) (the custom op automl_tpu_torch::flash_fwd), so the
  backward goes straight to the backward kernels. "dots_attn" saves the
  products and the attention output named "attn_out" (Attention); the
  backward still needs lse, so the flash forward runs again, as in JAX."""
  name = cfg.get("remat_policy") or "full"
  if name == "full":
    return None
  if name not in ("dots", "dots_no_batch", "dots_flash", "dots_attn"):
    raise ValueError(
        f"unknown remat_policy {name!r} "
        "(expected full | dots | dots_no_batch | dots_flash | dots_attn)")
  flash_op = torch.ops.automl_tpu_torch.flash_fwd.default
  name_op = torch.ops.automl_tpu_torch.checkpoint_name.default

  def policy(ctx, op, *args, **kwargs):
    del ctx, kwargs
    save = (_is_dot(op, args, name == "dots_no_batch")
            or (name == "dots_flash" and op is flash_op)
            or (name == "dots_attn" and op is name_op
                and args[1] == "attn_out"))
    return (CheckpointPolicy.MUST_SAVE if save
            else CheckpointPolicy.PREFER_RECOMPUTE)
  return policy


# ---------------------------------------------------------------------------
# LM.
# ---------------------------------------------------------------------------


def _stacked(block: nn.Module, n: int) -> nn.Module:
  """`block` with each parameter replaced by a stacked [n, ...] one (JAX's
  use_scan layout)."""
  for name, p in list(block.named_parameters()):
    owner_name, _, attr = name.rpartition(".")
    owner = block.get_submodule(owner_name) if owner_name else block
    setattr(owner, attr, nn.Parameter(torch.empty(
        (n,) + tuple(p.shape), dtype=p.dtype, device=p.device)))
  return block


def _call_with(module, params, *args):
  return torch.func.functional_call(module, params, args)


def per_layer(named: dict) -> dict:
  """{name: tensor} of a pipeline model (stacked blocks.<leaf> [L, ...])
  in the per-layer names of every other layout (blocks.<i>.<leaf>), which
  checkpoints keep; other entries as they are."""
  out = {}
  for k, v in named.items():
    parts = k.split(".")
    if parts[0] == "blocks" and not parts[1].isdigit():
      out.update((f"blocks.{i}.{'.'.join(parts[1:])}", v[i])
                 for i in range(v.shape[0]))
    else:
      out[k] = v
  return out


def stacked_layers(named: dict) -> dict:
  """The inverse of per_layer: blocks.<i>.<leaf> entries -> one stacked
  blocks.<leaf> [L, ...] each."""
  out, layers = {}, {}
  for k, v in named.items():
    parts = k.split(".")
    if parts[0] == "blocks" and parts[1].isdigit():
      layers.setdefault(".".join(parts[2:]), {})[int(parts[1])] = v
    else:
      out[k] = v
  for leaf, per in layers.items():
    out["blocks." + leaf] = torch.stack([per[i] for i in sorted(per)])
  return out


class TransformerLM(nn.Module):
  """forward(tokens, ...) -> (logits, cache).

  Parameters are allocated empty; load them from a JAX-layout tree with
  convert.load_jax_params. With a mesh (parallel/mesh.py create_mesh) each
  parameter is a DTensor in the placements of its PartitionSpec under
  `sharding` (default: the data-parallel layout, JAX's default without a
  mesh; param_spec), on the mesh's device."""

  def __init__(self, cfg: Config, sharding: Optional[ShardingConfig] = None,
               device=None, mesh=None):
    super().__init__()
    _check_config(cfg)
    self.cfg = cfg
    self.sh = sharding or ShardingConfig.data_parallel()
    self.mesh = mesh
    par = self.par = _Mesh(mesh, self.sh, cfg) if mesh is not None else None
    # GPipe's layout: the layers' parameters stacked [L, ...] and split over
    # the stages (checkpoints keep the per-layer names: per_layer).
    self.stacked = par is not None and par.pipeline
    if par is not None:
      device = torch.device(mesh.device_type, torch.cuda.current_device()
                            if mesh.device_type == "cuda" else None)
    dt = _dtype(cfg.param_dtype)
    self.embed = _param((cfg.vocab_size, cfg.model_dim), dt, device)
    if self.stacked:
      # The stages' layers: one block (one-device semantics inside a stage,
      # as in JAX's shard_map) whose parameters stack the layers [L, ...].
      self.blocks = _stacked(TransformerBlock(cfg, device, None),
                             cfg.n_layers)
    else:
      self.blocks = nn.ModuleList(TransformerBlock(cfg, device, par)
                                  for _ in range(cfg.n_layers))
    self.final_norm = RMSNorm(cfg.model_dim, device, par)
    if not cfg.tie_embeddings:
      self.unembed = _param((cfg.model_dim, cfg.vocab_size), dt, device)
    if mesh is not None:
      self._place()

  def _place(self):
    """Every parameter -> a DTensor in its PartitionSpec's placements."""
    moe = bool(self.cfg.get("moe_num_experts"))
    for name, p in list(self.named_parameters()):
      owner_name, _, attr = name.rpartition(".")
      owner = self.get_submodule(owner_name) if owner_name else self
      spec = (P("model") if self.stacked and name.startswith("blocks.")
              else param_spec(name, self.sh, moe))
      setattr(owner, attr, nn.Parameter(
          mesh_lib.distribute(p.data, self.mesh, spec),
          requires_grad=p.requires_grad))

  def param_placements(self) -> dict:
    """{name: PartitionSpec} of every parameter (P() without a mesh)."""
    from torch.distributed.tensor import DTensor
    return {name: (mesh_lib.pspec_of(self.mesh, p.placements, p.ndim)
                   if isinstance(p, DTensor) else P())
            for name, p in self.named_parameters()}

  @property
  def device(self) -> torch.device:
    scale = self.final_norm.scale
    return scale.to_local().device if self.mesh is not None else scale.device

  def forward(self, tokens, positions=None, segment_ids=None, cache=None,
              cache_index=None, kv_positions=None, causal_attention=None,
              return_aux=False, return_hidden=False):
    """tokens: [B, T] int. cache: optional per-layer tuple from init_cache,
    written at cache_index (an int, or a [B] / [B, T] tensor of per-row
    positions: Attention.forward). causal_attention: optional [B, T] {0,1}
    prefix-LM markers.

    Returns (logits [B, T, V] f32, cache or None); with return_hidden, the
    final-normed hidden states [B, T, D] in place of the logits; with
    return_aux, a third value: the layers' summed MoE load-balance loss
    (0 for dense FFNs, and with a cache, as in JAX)."""
    cfg, par = self.cfg, self.par
    adt = _dtype(cfg.activation_dtype)
    b, t = tokens.shape
    # With ring attention on a 'model' axis above 1 (and no cache), tokens
    # are this rank's chunk of the sequence: positions are global.
    ring = par is not None and par.ring and cache is None
    if positions is None:
      start = par.rank * t if ring else 0
      positions = (start + torch.arange(t, device=tokens.device)).expand(b, t)
    if kv_positions is None:
      kv_positions = positions
    if cache is not None and par is not None and par.ring and \
        not cfg.get("ring_decode_fallback") and not cfg.get("serve_sp"):
      raise NotImplementedError(
          "use_ring_attention with a KV cache: set serve_sp=True for "
          "sequence-parallel decode (the cache IS sequence-sharded over "
          "'model' and per-shard softmax partials are merged — "
          "ops/decode_attention.py decode_attention_sp). Alternatives: "
          "decode on a data-parallel mesh (model axis = 1), or set "
          "ring_decode_fallback=True to accept dense-attention decode "
          "with a replicated cache.")
    if isinstance(self.embed, QuantizedWeight):
      # int8: the rows are gathered first and only they are dequantised.
      x = (_w(self.embed.qvalue, par)[tokens].to(adt)
           * _w(self.embed.scale, par).to(adt)) * (cfg.model_dim ** 0.5)
    else:
      x = F.embedding(tokens, _w(self.embed, par)).to(adt) * (
          cfg.model_dim ** 0.5)
    # The flash kernel, the ring and the chunked local attention mask by
    # themselves (causal, window, segments); a prefix-LM mask or a cache
    # takes the materialised mask (JAX: uses_fused_mask).
    uses_fused_mask = causal_attention is None and cache is None and bool(
        ring or cfg.get("use_flash_attention")
        or (cfg.get("use_window_chunk") and cfg.get("window_chunk_size")))
    seg_k, prefix_k = segment_ids, causal_attention
    if ring and not uses_fused_mask:
      # The mask's columns span the whole sequence (Attention gathers the
      # keys along it); its rows are this rank's queries.
      def gather(z):
        return None if z is None else comm.all_gather_dims(
            z, par.mesh, (("model", 1),))
      kv_positions, seg_k, prefix_k = (gather(z) for z in (
          kv_positions, segment_ids, causal_attention))
    mask = None if uses_fused_mask else causal_mask(
        positions, kv_positions, cfg.window_size, segment_ids, seg_k,
        prefix_q=causal_attention, prefix_k=prefix_k)
    # Each block's forward runs again in the backward, but for what the
    # remat policy saves ("full": nothing, as jax.checkpoint with no policy).
    # The JAX model remats only its scanned layers, hence use_scan.
    remat = (cache is None and cfg.use_remat and cfg.get("use_scan", True)
             and torch.is_grad_enabled())
    remat_kw = {}
    if remat and (policy := _remat_policy(cfg)) is not None:
      remat_kw["context_fn"] = functools.partial(
          torch.utils.checkpoint.create_selective_checkpoint_contexts, policy)
    if cache is not None:
      mask, cache_index = self._cache_writes(mask, cache, cache_index, t)
    new_caches = []
    aux = None
    is_moe = bool(cfg.get("moe_num_experts"))
    if par is not None and par.pipeline and cache is None:
      # GPipe over the stages on 'model': this rank's layers, the extras
      # cut per microbatch (each routes its MoE tokens on its own).
      stacked = {k: comm.local_param(p, par.token_axes)
                 for k, p in self.blocks.named_parameters()}
      n_local = next(iter(stacked.values())).shape[0]
      layers = [{k: v[j] for k, v in stacked.items()} for j in range(n_local)]

      def block_fn(layer, h, extras):
        outs = torch.func.functional_call(
            self.blocks, layer, (h, extras[0], extras[1], None, None,
                                 extras[2]))
        return outs[0], (outs[2] if is_moe else h.new_zeros(
            (), dtype=torch.float32))
      if remat:
        fn = block_fn
        block_fn = lambda layer, h, extras: torch.utils.checkpoint.checkpoint(
            fn, layer, h, extras, use_reentrant=False, **remat_kw)
      x, pipe_aux = pipeline_lib.pipeline_blocks_sharded(
          x, layers, (positions, mask, segment_ids), block_fn, par.mesh,
          num_microbatches=int(cfg.get("pipeline_microbatches", 4)))
      aux = pipe_aux if is_moe else None
    else:
      for i, block in enumerate(self._layers()):
        if remat:
          # An MoE block's aux comes out of the checkpoint with its output.
          outs = torch.utils.checkpoint.checkpoint(
              block, x, positions, mask, None, None, segment_ids,
              use_reentrant=False, **remat_kw)
        else:
          outs = block(x, positions, mask,
                       None if cache is None else cache[i], cache_index,
                       segment_ids)
        x, nc = outs[:2]
        if is_moe and cache is None:
          aux = outs[2] if aux is None else aux + outs[2]
        new_caches.append(nc)
    new_cache = tuple(new_caches) if cache is not None else None
    x = self.final_norm(x)
    out = x if return_hidden else unembed_logits(self, x)
    if not return_aux:
      return out, new_cache
    if aux is None:
      aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return out, new_cache, aux

  def _layers(self):
    """The layers as callables: the blocks; for the stacked stage layers of
    a pipeline model (a KV cache's pass), each layer's slice of the
    gathered stacks."""
    if not self.stacked:
      return list(self.blocks)
    full = {k: comm.gather_param(p, self.par.token_axes)
            for k, p in self.blocks.named_parameters()}
    return [functools.partial(_call_with, self.blocks,
                              {k: v[i] for k, v in full.items()})
            for i in range(self.cfg.n_layers)]

  def _cache_writes(self, mask, cache, cache_index, t: int):
    """(mask, cache_index) as the layers take them: the per-row writes of a
    tensor cache_index made once for every layer (_row_writes), in the
    cache's row order; under serve_sp on a mesh, the mask cut to this
    rank's keys and every write shifted to them (a write to another rank's
    key is dropped)."""
    cfg, par = self.cfg, self.par
    k0 = cache[0]["k"]
    s_len, n_kv, head_major = k0.shape[-1], cfg.n_kv_heads, False
    if cfg.get("serve_tp"):
      n_kv, head_major = k0.shape[0], True
    if cfg.get("serve_sp") and par is not None and par.model > 1:
      start = par.rank * s_len
      mask = mask[..., start:start + s_len]
      b = mask.shape[0]
      if not torch.is_tensor(cache_index):
        cache_index = torch.full((b,), int(cache_index),
                                 device=mask.device)
      cache_index = cache_index - start
    if torch.is_tensor(cache_index) and cache_index.ndim >= 1:
      cache_index = _row_writes(cache_index, t, s_len, n_kv, head_major)
    return mask, cache_index

  def init_cache(self, batch_size: int, max_len: int):
    """Per-layer KV cache tuple in the activation dtype: {k: [B*n_kv, hd,
    S], v: [B*n_kv, S, hd]}, row r = b*n_kv + head. serve_tp: the
    head-leading {k: [n_kv, B, hd, S], v: [n_kv, B, S, hd]}, on a mesh this
    rank's n_kv / m heads ('model' of size m); serve_sp on a mesh: this
    rank's S / m keys (max_len a multiple of m, as greedy_generate and
    LMServer allocate it)."""
    cfg, par = self.cfg, self.par
    dt = _dtype(cfg.activation_dtype)
    m = par.model if par is not None else 1
    hd, n_kv = cfg.head_dim, cfg.n_kv_heads
    if cfg.get("serve_tp"):
      if n_kv % m or cfg.n_heads % m:
        raise ValueError(
            f"serve_tp: n_heads ({cfg.n_heads}) and n_kv_heads ({n_kv}) "
            f"must be divisible by mesh axis 'model' size {m}")
      shapes = ((n_kv // m, batch_size, hd, max_len),
                (n_kv // m, batch_size, max_len, hd))
    else:
      if cfg.get("serve_sp") and max_len % m:
        raise ValueError(f"serve_sp: the cache length {max_len} is not a "
                         f"multiple of mesh axis 'model' size {m}")
      s_len = max_len // m if cfg.get("serve_sp") else max_len
      rows = batch_size * n_kv
      shapes = ((rows, hd, s_len), (rows, s_len, hd))
    return tuple({"k": torch.zeros(shapes[0], dtype=dt, device=self.device),
                  "v": torch.zeros(shapes[1], dtype=dt, device=self.device)}
                 for _ in range(cfg.n_layers))

  def cache_len(self, total: int) -> int:
    """The cache length to allocate for `total` positions: under serve_sp
    on a mesh, rounded up to a multiple of the 'model' axis, so that the
    sharded cache never needs padding (the extra keys lie in the future
    and stay masked)."""
    m = self.par.model if self.par is not None else 1
    return -(-total // m) * m if self.cfg.get("serve_sp") else total


def cast_lm_params_for_serving(model: TransformerLM) -> TransformerLM:
  """Casts every matmul weight to the activation dtype once, in place.

  The layers cast each weight to the activation dtype at use, so this
  changes no result. Left alone, as in the JAX package: embed/unembed
  (they also feed the f32 logits matmul), the MoE router (f32 routing
  decisions), 1-D leaves (norm scales, per_dim_scale) and int8 weights
  (qvalue, scale)."""
  adt = _dtype(model.cfg.activation_dtype)
  for name, p in model.named_parameters():
    if name.split(".")[-1] in ("embed", "unembed", "router", "scale"):
      continue
    if p.ndim < 2 or not p.is_floating_point():
      continue
    p.data = p.data.to(adt)
  return model


def quantize_lm_params(model: TransformerLM, min_size: int = 1 << 12):
  """Int8 weights in place (JAX's quantize_lm_params): every parameter of at
  least 2 dims and min_size elements becomes a QuantizedWeight, symmetric
  with one scale per output channel (the last axis): scale = max |w| over
  the other axes / 127, at least 1e-8, qvalue = clip(round(w / scale),
  -127, 127), rounding half to even, all in f32. JAX's stacked block
  weights keep a scale per layer, which is what a per-layer parameter here
  has; an expert weight [E, d, f] reduces over E and d, as JAX's axes do.
  The layers dequantise at use (_maybe_dequant). The MoE router is never
  quantised: int8 rounding could flip a top-k routing decision."""
  for name, p in list(model.named_parameters()):
    owner_name, _, attr = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if (isinstance(owner, QuantizedWeight) or attr == "router"
        or p.ndim < 2 or p.numel() < min_size):
      continue
    # On a mesh the int8 weight is whole on every rank (replicated).
    w = (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().float()
    scale = (w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
             / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    delattr(owner, attr)
    setattr(owner, attr, QuantizedWeight(q, scale))
  return model


@contextlib.contextmanager
def _full_f32_matmul():
  """f32 matmuls on the card in full f32, not TF32, for the duration."""
  prev = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev


def _bf16_mm(a, b):
  """a @ b with bf16 operands and an f32 result. A bf16 product is exact in
  f32, so the operands are rounded to bf16 and multiplied in full f32 (a
  bf16 matmul would also round its output to bf16)."""
  with _full_f32_matmul():
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


class _UnembedBf16Vjp(torch.autograd.Function):
  """x @ w (or x @ w.T when tied, w [V, d]) with bf16 operands and an f32
  result, whose backward casts the cotangent to bf16 and takes both
  products with bf16 operands and f32 results: JAX's _unembed_mm_bf16.
  dx comes back in x's dtype, dw in w's (f32), each rounded once."""

  @staticmethod
  def forward(ctx, x, w, tied):
    ctx.save_for_backward(x.to(torch.bfloat16), w.to(torch.bfloat16))
    ctx.tied, ctx.dtypes = tied, (x.dtype, w.dtype)
    return _bf16_mm(x, w.t() if tied else w)

  @staticmethod
  def backward(ctx, g):
    xb, wb = ctx.saved_tensors
    gb = g.to(torch.bfloat16)
    x2, g2 = xb.reshape(-1, xb.shape[-1]), gb.reshape(-1, gb.shape[-1])
    if ctx.tied:                                  # w [V, d]
      dx, dw = _bf16_mm(gb, wb), _bf16_mm(g2.t(), x2)
    else:                                         # w [d, V]
      dx, dw = _bf16_mm(gb, wb.t()), _bf16_mm(x2.t(), g2)
    return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None


def _unembed_weight(model: TransformerLM, dtype):
  """The unembedding ([V, d] embed when tied, else [d, V] unembed): an int8
  one dequantised to `dtype`, a float one as it is."""
  w = model.embed if model.cfg.tie_embeddings else model.unembed
  return (_maybe_dequant(w, dtype, model.par)
          if isinstance(w, QuantizedWeight) else _w(w, model.par))


def unembed_logits(model: TransformerLM, x):
  """Final projection [B, T, d] -> f32 logits [B, T, V], then the soft cap.

  unembed_matmul_dtype "float32" (the default) multiplies f32 operands in
  full f32; the bf16 modes take bf16 operands and accumulate in f32.
  "bfloat16" differentiates by plain autograd (an f32 cotangent against the
  bf16-rounded operands); "bfloat16_vjp" casts the cotangent to bf16 too,
  as JAX's custom vjp does."""
  cfg = model.cfg
  tied = bool(cfg.tie_embeddings)
  mm_dtype = cfg.get("unembed_matmul_dtype", "float32") or "float32"
  w = _unembed_weight(model, torch.bfloat16 if mm_dtype == "bfloat16"
                      else torch.float32)    # [V, d] or [d, V]
  if mm_dtype == "bfloat16":
    logits = _bf16_mm(x, w.t() if tied else w)
  elif mm_dtype == "bfloat16_vjp":
    logits = _UnembedBf16Vjp.apply(x, w, tied)
  elif mm_dtype == "float32":
    with _full_f32_matmul():
      logits = x.float() @ (w.t() if tied else w).float()
  else:
    raise ValueError(f"unknown unembed_matmul_dtype: {mm_dtype!r}")
  if cfg.final_logit_cap:
    logits = cfg.final_logit_cap * torch.tanh(logits / cfg.final_logit_cap)
  return logits


def lm_loss(logits, targets, loss_weights=None):
  """Masked next-token cross-entropy in f32: the mean over tokens, or the
  loss_weights-weighted mean (weights summed to at least 1)."""
  logp = torch.log_softmax(logits.float(), dim=-1)
  nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
  if loss_weights is None:
    return nll.mean()
  w = loss_weights.float()
  return (nll * w).sum() / w.sum().clamp_min(1.0)


def lm_loss_fused(model: TransformerLM, x, targets, loss_weights=None,
                  chunk_size: int = 256):
  """Chunked unembed + xent over hidden states x [B, T, d] (JAX's
  lm_loss_fused): the math of lm_loss(unembed_logits(model, x), ...), taken
  one T-chunk at a time under a non-reentrant checkpoint, so that the
  forward keeps only running (sum of weighted nll, sum of weights) and the
  backward recomputes each chunk's [B, chunk, V] logits. The chunk is the
  largest divisor of T that is <= chunk_size."""
  b, t, _ = x.shape
  if loss_weights is None:
    loss_weights = torch.ones((b, t), dtype=torch.float32, device=x.device)
  cs = max(c for c in range(1, min(chunk_size, t) + 1) if t % c == 0)

  def body(xc, tc, wc):
    logp = torch.log_softmax(unembed_logits(model, xc), dim=-1)
    nll = -torch.gather(logp, -1, tc.long()[..., None])[..., 0]
    w = wc.float()
    return (nll * w).sum(), w.sum()

  sum_nll = sum_w = torch.zeros((), dtype=torch.float32, device=x.device)
  for i in range(0, t, cs):
    s = slice(i, i + cs)
    nll, w = torch.utils.checkpoint.checkpoint(
        body, x[:, s], targets[:, s], loss_weights[:, s], use_reentrant=False)
    sum_nll, sum_w = sum_nll + nll, sum_w + w
  return sum_nll / sum_w.clamp_min(1.0)


def lm_loss_fused_pallas(model: TransformerLM, x, targets, loss_weights=None):
  """The fused unembed + xent of JAX's lm_loss_fused_pallas, which here runs
  the hand-written CUDA kernels K3a-c (ops/xent.py) on the card and their
  plain versions on the CPU: the [B, T, V] logits never exist. The products
  take bf16 operands with f32 accumulation whatever unembed_matmul_dtype
  says, as in JAX."""
  cfg = model.cfg
  tied = bool(cfg.tie_embeddings)
  return xent_lib.fused_softmax_xent(
      x, _w(model.embed if tied else model.unembed, model.par), targets,
      loss_weights,
      tied=tied, logit_cap=float(cfg.final_logit_cap or 0.0),
      block_m=int(cfg.get("loss_block_m", 1024) or 1024),
      block_v=int(cfg.get("loss_block_v", 1024) or 1024))


def distill_loss(student_logits, teacher_logits, loss_weights=None,
                 temperature: float = 1.0):
  """Distillation: the cross-entropy of the student's softmax against the
  teacher's, both at `temperature`, in f32; the (weighted) mean over
  tokens times temperature^2."""
  t = temperature
  teacher = torch.softmax(teacher_logits.float() / t, dim=-1)
  logp = torch.log_softmax(student_logits.float() / t, dim=-1)
  per_tok = -torch.sum(teacher * logp, dim=-1)
  if loss_weights is None:
    return per_tok.mean() * t * t
  w = loss_weights.float()
  return (per_tok * w).sum() / w.sum().clamp_min(1.0) * t * t


def scaling_summary(cfg) -> dict:
  """Parameter and training-FLOPs-per-token counts of a config (JAX's
  scaling_summary: a dense FFN whatever moe_num_experts says; attention
  counted over the full sequence)."""
  d, l, v = cfg.model_dim, cfg.n_layers, cfg.vocab_size
  h = cfg.n_heads * cfg.head_dim
  hkv = cfg.n_kv_heads * cfg.head_dim
  ffn = cfg.expand_factor * d
  attn_params = d * h * 2 + d * hkv * 2          # wq, wo, wk, wv
  ffn_params = d * ffn * (3 if cfg.use_gated_ffn else 2)
  block_params = attn_params + ffn_params + 2 * d
  embed_params = v * d * (1 if cfg.tie_embeddings else 2)
  total = l * block_params + embed_params + d
  attn_flops = 2 * cfg.seq_len * h
  flops_per_token = 6 * (total - embed_params + v * d) + 2 * l * attn_flops
  return {"params": int(total), "embed_params": int(embed_params),
          "non_embed_params": int(total - embed_params),
          "flops_per_token_train": int(flops_per_token),
          "chinchilla_tokens": int(20 * (total - embed_params))}


# ---------------------------------------------------------------------------
# Sampling / generation.
# ---------------------------------------------------------------------------


def truncate_logits(logits, top_k: int = 0, top_p: float = 0.0):
  """Sets logits outside the top-k / top-p (nucleus) set to -1e9."""
  if top_k:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = torch.where(logits < kth, torch.full_like(logits, -1e9), logits)
  if top_p:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1,
                          cutoff_idx.clamp_max(logits.shape[-1] - 1))
    logits = torch.where(logits < cutoff, torch.full_like(logits, -1e9),
                         logits)
  return logits


def sample_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, generator=None):
  """Next token ids [B] from [B, V] logits: argmax at temperature 0, else a
  draw from the temperature-scaled, top-k/top-p truncated softmax."""
  logits = logits.float()
  if temperature == 0.0:
    return torch.argmax(logits, dim=-1)
  logits = truncate_logits(logits / temperature, top_k, top_p)
  return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                           generator=generator)[:, 0]


def chosen_logprob(logits, tok):
  """log softmax(logits)[tok] per row: [B, V], [B] -> [B] float32."""
  lp = torch.log_softmax(logits.float(), dim=-1)
  return torch.gather(lp, -1, tok[:, None])[:, 0]


def _match_stops(tokens, i_next: int, stops):
  """[B] bool: does tokens[:, :i_next] end with any stop sequence?

  stops: [N, K], left-padded with -1 (wildcard). The window is right-aligned
  at i_next, with -2 before the sequence start."""
  _, k = stops.shape
  idx = i_next - k + torch.arange(k, device=tokens.device)
  vals = tokens[:, idx.clamp(0, tokens.shape[1] - 1)]              # [B, K]
  window = torch.where(idx >= 0, vals, torch.full_like(vals, -2))
  eq = (stops[None] == window[:, None]) | (stops[None] < 0)
  return eq.all(dim=-1).any(dim=-1)


def _pack_stops(stop_sequences, device=None):
  """list of token-id lists -> [N, K] int64, left-padded with -1."""
  if any(len(s) == 0 for s in stop_sequences):
    raise ValueError("empty stop sequence (would match every suffix)")
  k = max(len(s) for s in stop_sequences)
  return torch.tensor([[-1] * (k - len(s)) + list(s) for s in stop_sequences],
                      dtype=torch.int64, device=device)


@torch.inference_mode()
def greedy_generate(model: TransformerLM, prompt_tokens, max_new_tokens: int,
                    generator=None, temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, eos_id: Optional[int] = None,
                    return_logprobs: bool = False, stop_sequences=None):
  """Prefill, then decode one token at a time into the KV cache.

  prompt_tokens: [B, T_prompt]. Returns [B, T_prompt + max_new_tokens]
  int64; with return_logprobs, (tokens, logprobs [B, max_new_tokens]): the
  chosen token's log-probability under the raw-logits softmax (finished
  rows report 0). With eos_id or stop_sequences, decoding stops once every
  row has finished, and finished rows emit pad (0). `generator` is the
  torch.Generator for sampling (temperature > 0)."""
  b, t0 = prompt_tokens.shape
  total = t0 + max_new_tokens
  device = prompt_tokens.device
  stops = (_pack_stops(stop_sequences, device) if stop_sequences else None)
  early_exit = eos_id is not None or stops is not None
  s_alloc = model.cache_len(total)
  cache = model.init_cache(b, s_alloc)
  kv_pos = torch.arange(s_alloc, device=device).expand(b, s_alloc)
  logits, cache = model(prompt_tokens,
                        positions=torch.arange(t0, device=device).expand(b, t0),
                        cache=cache, cache_index=0, kv_positions=kv_pos)
  next_tok = sample_logits(logits[:, t0 - 1], temperature, top_k, top_p,
                           generator)
  tokens = torch.zeros((b, total), dtype=torch.int64, device=device)
  tokens[:, :t0] = prompt_tokens
  tokens[:, t0] = next_tok
  lps = torch.zeros((b, max_new_tokens), dtype=torch.float32, device=device)
  if return_logprobs:
    lps[:, 0] = chosen_logprob(logits[:, t0 - 1], next_tok)
  done = torch.zeros((b,), dtype=torch.bool, device=device)
  if eos_id is not None:
    done |= next_tok == eos_id
  if stops is not None:
    done |= _match_stops(tokens, t0 + 1, stops)

  for i in range(t0, total - 1):
    if early_exit and bool(done.all()):
      break
    pos = torch.full((b, 1), i, dtype=torch.int64, device=device)
    logits, cache = model(tokens[:, i:i + 1], positions=pos, cache=cache,
                          cache_index=i, kv_positions=kv_pos)
    nxt = sample_logits(logits[:, 0], temperature, top_k, top_p, generator)
    if early_exit:
      nxt = torch.where(done, torch.zeros_like(nxt), nxt)
    if return_logprobs:
      lp = chosen_logprob(logits[:, 0], nxt)
      if early_exit:
        lp = torch.where(done, torch.zeros_like(lp), lp)
      lps[:, i + 1 - t0] = lp
    tokens[:, i + 1] = nxt
    if eos_id is not None:
      done |= nxt == eos_id
    if stops is not None:
      done |= _match_stops(tokens, i + 2, stops)
  if return_logprobs:
    return tokens, lps
  return tokens
