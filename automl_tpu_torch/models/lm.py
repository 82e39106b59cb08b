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

Options of the JAX model that this package has not ported yet raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
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


# Options of the JAX model not ported yet, with the ROADMAP item that ports
# each. A config that turns one on is refused rather than run another way.
_UNPORTED = (
    ("use_ring_attention", "M10 (ring attention)"),
    ("use_pipeline", "M10 (pipeline parallelism)"),
    ("serve_tp", "M10 (tensor-parallel serving, decode_attention_tp)"),
    ("serve_sp", "M10 (sequence-parallel serving, decode_attention_sp)"),
)


def _check_ported(cfg: Config):
  for key, item in _UNPORTED:
    if cfg.get(key):
      raise NotImplementedError(
          f"{key} is not ported to automl_tpu_torch yet: ROADMAP {item}")


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


def _maybe_dequant(w, dtype):
  """The weight in `dtype`: qvalue * scale, each cast first, for an int8
  weight (as JAX's _maybe_dequant), else w cast."""
  if isinstance(w, QuantizedWeight):
    return w.qvalue.to(dtype) * w.scale.to(dtype)
  return w.to(dtype)


def _row_writes(cache_index, t: int, s_len: int, n_kv: int):
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
  token (else the value is position 0's)."""
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
  rows = lambda x: x.repeat_interleave(n_kv, dim=0)
  return rows(at), rows(src), rows(live)[:, :, None]


def _write_cache(kc, vc, k, v, cache_index):
  """Writes k, v [B, T, n_kv, hd] into the rank-3 cache in place: at one
  offset (an int), or per row (_row_writes' triple)."""
  b, t, n_kv, hd = k.shape
  kr = k.permute(0, 2, 3, 1).reshape(b * n_kv, hd, t).to(kc.dtype)
  vr = v.permute(0, 2, 1, 3).reshape(b * n_kv, t, hd).to(vc.dtype)
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

  def __init__(self, cfg: Config, device=None):
    super().__init__()
    self.cfg = cfg
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
    if hasattr(self, "wqkv"):
      return torch.einsum("btd,cdnh->cbtnh", x,
                          _maybe_dequant(self.wqkv, adt)).unbind(0)
    q = torch.einsum("btd,dnh->btnh", x, _maybe_dequant(self.wq, adt))
    if hasattr(self, "wkv"):
      k, v = torch.einsum("btd,cdnh->cbtnh", x,
                          _maybe_dequant(self.wkv, adt)).unbind(0)
    else:
      k = torch.einsum("btd,dnh->btnh", x, _maybe_dequant(self.wk, adt))
      v = torch.einsum("btd,dnh->btnh", x, _maybe_dequant(self.wv, adt))
    return q, k, v

  def forward(self, x, positions, mask, cache=None, cache_index=None,
              segment_ids=None):
    """x: [B, T, D]; mask: [B, T, S] bool, or None where the flash kernel
    masks by itself (causal, window and segment_ids [B, T]). cache: optional
    {k: [B*n_kv, hd, S], v: [B*n_kv, S, hd]} (TransformerLM.init_cache),
    written in place at cache_index: an int (every row at that offset), or
    _row_writes' triple for per-row positions (TransformerLM.forward makes
    it once for every layer). Returns (out [B, T, D], cache)."""
    cfg = self.cfg
    adt = _dtype(cfg.activation_dtype)
    x = x.to(adt)
    wo = _maybe_dequant(self.wo, adt)
    q, k, v = self._qkv(x, adt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.get("use_per_dim_scale"):
      # r_softplus_0 / sqrt(hd) * softplus(s), the constant rounded to the
      # activation dtype first and the product taken in f32, as in JAX.
      r_softplus_0 = 1.442695041
      pds = torch.tensor(r_softplus_0 / math.sqrt(self.head_dim), dtype=adt)
      pds = pds.float() * torch.logaddexp(
          self.per_dim_scale.float(), torch.zeros((), device=x.device))
      q = (q.float() * pds).to(adt)
    else:
      q = q * (self.head_dim ** -0.5)

    if cache is None:
      if mask is None and cfg.get("use_window_chunk") and \
          cfg.get("window_chunk_size"):
        # The two-chunk local attention, before the flash branch as in JAX:
        # with both options on, the chunk path runs.
        kk, vv = self._repeat_kv(k), self._repeat_kv(v)
        out = chunked_local_attn(q, kk, vv, positions,
                                 int(cfg.window_chunk_size),
                                 cfg.attn_logit_cap or 0.0,
                                 segment_ids=segment_ids)
        return torch.einsum("bqnh,dnh->bqd", out.to(adt), wo), None
      if mask is None:
        # TransformerLM passes mask=None exactly when a fused path
        # should mask by itself (JAX: uses_fused_mask).
        out = attention_lib.flash_attention(
            q, k, v, causal=True, window=cfg.window_size,
            logit_cap=cfg.attn_logit_cap or 0.0, sm_scale=1.0,
            segment_ids=segment_ids,
            bwd_fused=bool(cfg.get("flash_bwd_fused", False)))
        if cfg.get("use_remat") and cfg.get("remat_policy") == "dots_attn":
          # JAX names the output checkpoint_name(out, "attn_out") for this
          # policy; here the name costs a copy, so it is made only where the
          # policy saves it.
          out = checkpoint_name(out, "attn_out")
        return torch.einsum("bqnh,dnh->bqd", out.to(adt), wo), None
      return self._dense(q, k, v, mask, wo, adt), None

    b, t = x.shape[0], x.shape[1]
    kc, vc = cache["k"], cache["v"]
    s_len = kc.shape[-1]
    if not isinstance(cache_index, tuple):
      cache_index = int(cache_index)
    # Written in place: the JAX model returns a new cache, the port keeps
    # one copy of it on the device.
    _write_cache(kc, vc, k, v, cache_index)
    if cfg.get("use_decode_kernel", True) and \
        s_len >= int(cfg.get("decode_kernel_min_s", 768) or 0):
      out = decode_attention_lib.decode_attention(
          q, kc, vc, mask.contiguous(), n_kv_heads=self.n_kv,
          logit_cap=cfg.attn_logit_cap or 0.0)
      return torch.einsum("bqnh,dnh->bqd", out.to(adt), wo), cache

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

  def _cap(self, logits):
    cap = self.cfg.attn_logit_cap
    if cap:
      return cap * torch.tanh(logits.float() / cap)
    return logits.float()

  def _repeat_kv(self, x):
    """[B, T, n_kv, hd] -> [B, T, n, hd] (GQA: each kv head repeated)."""
    if self.n_kv == self.n_heads:
      return x
    return x.repeat_interleave(self.n_heads // self.n_kv, dim=2)

  def _dense(self, q, k, v, mask, wo, adt):
    """The no-cache path: dense softmax attention over [B, T, T]."""
    k, v = self._repeat_kv(k), self._repeat_kv(v)
    logits = self._cap(torch.einsum("bqnh,bknh->bnqk", q, k.to(q.dtype)))
    logits = logits.masked_fill(~mask[:, None], -1e9)
    probs = torch.softmax(logits, dim=-1).to(adt)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v.to(adt))
    return torch.einsum("bqnh,dnh->bqd", out, wo)


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

  def __init__(self, dim: int, device=None):
    super().__init__()
    self.scale = _param((dim,), torch.float32, device)

  def forward(self, x):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + 1e-6)
    return (normed * (1.0 + self.scale)).to(x.dtype)


class FFN(nn.Module):
  """Gated FFN: (silu(x wg) * x w0) w1; ungated: silu(x w0) w1."""

  def __init__(self, cfg: Config, device=None):
    super().__init__()
    self.cfg = cfg
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
    h = x @ _maybe_dequant(self.w0, adt)
    if self.cfg.use_gated_ffn:
      h = F.silu(x @ _maybe_dequant(self.wg, adt)) * h
    else:
      h = F.silu(h)
    return h @ _maybe_dequant(self.w1, adt)


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
  dtype."""

  def __init__(self, cfg: Config, device=None):
    super().__init__()
    self.cfg = cfg
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
      logits = xf.float() @ self.router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, self.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs

  def slots(self, idx, g_size: int, capacity: int):
    """Where each of the S * k (token, choice) slots goes: its flat
    (group, expert, position) index, or groups * E * capacity (a spare
    row) where it is dropped; and whether it is kept. [S * k] each."""
    e, k = self.num_experts, self.top_k
    flat_e = idx.reshape(-1, g_size * k)                       # [G, Sg*k]
    onehot = F.one_hot(flat_e, e)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    group = torch.arange(flat_e.shape[0], device=idx.device)[:, None]
    dest = (group * e + flat_e) * capacity + pos
    spare = flat_e.shape[0] * e * capacity
    return torch.where(keep, dest, spare).reshape(-1), keep.reshape(-1)

  def forward(self, x):
    adt = _dtype(self.cfg.activation_dtype)
    e, k = self.num_experts, self.top_k
    b, t, d = x.shape
    s = b * t
    gates, idx, probs = self.route(x)
    top1 = F.one_hot(idx[:, 0], e).float()
    aux = e * torch.sum(top1.mean(0) * probs.mean(0))

    g_size, capacity = self.routing(s)
    groups = s // g_size
    dest, keep = self.slots(idx, g_size, capacity)
    n_rows = groups * e * capacity
    # The slot each (group, expert, position) row takes its input from; the
    # spare slot index s * k (a zero row) where no slot lands.
    z = torch.arange(s * k, device=x.device)
    src = torch.full((n_rows + 1,), s * k, dtype=torch.long,
                     device=x.device).scatter_(0, dest, z)[:n_rows]
    x_slots = x.reshape(s, d).to(adt).repeat_interleave(k, dim=0)
    x_slots = torch.cat([x_slots, x_slots.new_zeros(1, d)])
    expert_in = x_slots[src].reshape(groups, e, capacity, d)
    expert_in = expert_in.transpose(0, 1).reshape(e, groups * capacity, d)
    h = torch.bmm(expert_in, _maybe_dequant(self.w0, adt))
    if self.cfg.use_gated_ffn:
      h = F.silu(torch.bmm(expert_in, _maybe_dequant(self.wg, adt))) * h
    else:
      h = F.silu(h)
    out_e = torch.bmm(h, _maybe_dequant(self.w1, adt))   # [E, G*C, D]
    out_e = out_e.reshape(e, groups, capacity, d).transpose(0, 1)
    out_e = torch.cat([out_e.reshape(n_rows, d).float(),
                       out_e.new_zeros(1, d, dtype=torch.float32)])
    gate_flat = gates.reshape(-1) * keep.float()
    out = out_e[dest] * gate_flat[:, None]                # [S*k, D] f32
    return out.reshape(s, k, d).sum(1).reshape(b, t, d).to(adt), aux


class TransformerBlock(nn.Module):

  def __init__(self, cfg: Config, device=None):
    super().__init__()
    d = cfg.model_dim
    self.attn = Attention(cfg, device)
    self.is_moe = bool(cfg.get("moe_num_experts"))
    self.ffn = MoEFFN(cfg, device) if self.is_moe else FFN(cfg, device)
    self.pre_attn_norm = RMSNorm(d, device)
    self.pre_ffn_norm = RMSNorm(d, device)
    self.post_attn_norm = RMSNorm(d, device) if cfg.use_post_ln else None
    self.post_ffn_norm = RMSNorm(d, device) if cfg.use_post_ln else None

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


class TransformerLM(nn.Module):
  """forward(tokens, ...) -> (logits, cache).

  Parameters are allocated empty; load them from a JAX-layout tree with
  convert.load_jax_params."""

  def __init__(self, cfg: Config, device=None):
    super().__init__()
    _check_ported(cfg)
    self.cfg = cfg
    dt = _dtype(cfg.param_dtype)
    self.embed = _param((cfg.vocab_size, cfg.model_dim), dt, device)
    self.blocks = nn.ModuleList(TransformerBlock(cfg, device)
                                for _ in range(cfg.n_layers))
    self.final_norm = RMSNorm(cfg.model_dim, device)
    if not cfg.tie_embeddings:
      self.unembed = _param((cfg.model_dim, cfg.vocab_size), dt, device)

  @property
  def device(self) -> torch.device:
    return self.final_norm.scale.device

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
    cfg = self.cfg
    adt = _dtype(cfg.activation_dtype)
    b, t = tokens.shape
    if positions is None:
      positions = torch.arange(t, device=tokens.device).expand(b, t)
    if kv_positions is None:
      kv_positions = positions
    if isinstance(self.embed, QuantizedWeight):
      # int8: the rows are gathered first and only they are dequantised.
      x = (self.embed.qvalue[tokens].to(adt) * self.embed.scale.to(adt)
           ) * (cfg.model_dim ** 0.5)
    else:
      x = F.embedding(tokens, self.embed).to(adt) * (cfg.model_dim ** 0.5)
    # The flash kernel and the chunked local attention mask by themselves
    # (causal, window, segments); a prefix-LM mask or a cache takes the
    # materialised mask (JAX: uses_fused_mask).
    uses_fused_mask = causal_attention is None and cache is None and bool(
        cfg.get("use_flash_attention")
        or (cfg.get("use_window_chunk") and cfg.get("window_chunk_size")))
    mask = None if uses_fused_mask else causal_mask(
        positions, kv_positions, cfg.window_size, segment_ids, segment_ids,
        prefix_q=causal_attention, prefix_k=causal_attention)
    # Each block's forward runs again in the backward, but for what the
    # remat policy saves ("full": nothing, as jax.checkpoint with no policy).
    # The JAX model remats only its scanned layers, hence use_scan.
    remat = (cache is None and cfg.use_remat and cfg.get("use_scan", True)
             and torch.is_grad_enabled())
    remat_kw = {}
    if remat and (policy := _remat_policy(cfg)) is not None:
      remat_kw["context_fn"] = functools.partial(
          torch.utils.checkpoint.create_selective_checkpoint_contexts, policy)
    if (cache is not None and torch.is_tensor(cache_index)
        and cache_index.ndim >= 1):
      # Where each row's tokens land: once for every layer.
      cache_index = _row_writes(cache_index, t, cache[0]["k"].shape[-1],
                                cfg.n_kv_heads)
    new_caches = []
    aux = None
    for i, block in enumerate(self.blocks):
      if remat:
        # An MoE block's aux comes out of the checkpoint with its output.
        outs = torch.utils.checkpoint.checkpoint(
            block, x, positions, mask, None, None, segment_ids,
            use_reentrant=False, **remat_kw)
      else:
        outs = block(x, positions, mask, None if cache is None else cache[i],
                     cache_index, segment_ids)
      x, nc = outs[:2]
      if block.is_moe and cache is None:
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

  def init_cache(self, batch_size: int, max_len: int):
    """Per-layer KV cache tuple of {k: [B*n_kv, hd, S], v: [B*n_kv, S, hd]}
    in the activation dtype, row r = b*n_kv + head."""
    cfg = self.cfg
    dt = _dtype(cfg.activation_dtype)
    rows = batch_size * cfg.n_kv_heads
    return tuple(
        {"k": torch.zeros((rows, cfg.head_dim, max_len), dtype=dt,
                          device=self.device),
         "v": torch.zeros((rows, max_len, cfg.head_dim), dtype=dt,
                          device=self.device)}
        for _ in range(cfg.n_layers))


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
    w = p.detach().float()
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
  return _maybe_dequant(w, dtype) if isinstance(w, QuantizedWeight) else w


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
      x, model.embed if tied else model.unembed, targets, loss_weights,
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
  cache = model.init_cache(b, total)
  kv_pos = torch.arange(total, device=device).expand(b, total)
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
