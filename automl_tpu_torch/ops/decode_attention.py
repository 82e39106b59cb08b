"""KV-cached decode attention: hand-written CUDA kernels and plain versions.

The counterpart of automl_tpu/ops/decode_attention.py::decode_attention.
It works on the rank-3 cache that models/lm.py stores: k [B*n_kv, H, S],
v [B*n_kv, S, H], rows batch-major (r = b*n_kv + h) or head-major
(r = h*B + b). q [B, T, N, H] is already scaled; mask [B, T, S] is True
where a query attends. Scores are capped with tanh, masked, and
softmax-normalised over S in f32; a fully-masked row gives 0.

`decode_attention` takes a kernel for CUDA tensors and the plain version
for CPU tensors; there is no fallback from the one to the other. bf16 q and
cache with H <= 128 a multiple of 8 and S a multiple of 8 go to the Hopper
kernels of csrc/decode_attention_sm90.cu (split-S decode with a merge up to
16 query rows per kv row, wgmma prefill above); every other input to the
kernel of csrc/decode_attention.cu. `decode_attention.launches` counts
calls that launched a kernel, `launches_sm90` / `launches_simt` those of
each implementation. Beside decode_attention_reference, the plain version
of the split-S arithmetic (decode_attention_split_reference) and of the
prefill's pre-pass over the mask (mask_tile_classes_reference) are here for
the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_SM90_MAX_HEAD_DIM = 128
_SM90_DECODE_ROWS = 16   # query rows per kv row (T * N / n_kv) of split-S
_TILE = 64               # keys (and queries) of a kernel tile
_SPLIT_MAX_TILES = 32    # tiles of one split-S split


def _cdiv(a: int, d: int) -> int:
  return -(-a // d)


def _check(q, k_cache, v_cache, mask, n_kv_heads, layout):
  b, t, n, h = q.shape
  rows_kv, hk, s_len = k_cache.shape
  if rows_kv != b * n_kv_heads:
    raise ValueError(f"k_cache rows {rows_kv} != B*n_kv {b * n_kv_heads}")
  if n % n_kv_heads != 0:
    raise ValueError(f"GQA requires n_heads ({n}) divisible by "
                     f"n_kv_heads ({n_kv_heads})")
  if hk != h or tuple(v_cache.shape) != (rows_kv, s_len, h):
    raise ValueError(f"cache shapes k {tuple(k_cache.shape)}, "
                     f"v {tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
  if tuple(mask.shape) != (b, t, s_len):
    raise ValueError(f"mask shape {tuple(mask.shape)} != {(b, t, s_len)}")
  if layout not in ("batch_major", "head_major"):
    raise ValueError(f"unknown layout {layout!r}")


def _by_q_head(cache, b, n_kv, rep, layout):
  """[rows_kv, X, Y] cache -> [B, N, X, Y], each kv head repeated rep times."""
  x, y = cache.shape[1:]
  if layout == "head_major":
    c = cache.reshape(n_kv, b, x, y).transpose(0, 1)
  else:
    c = cache.reshape(b, n_kv, x, y)
  return c.repeat_interleave(rep, dim=1)


def _plain_parts(q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout):
  """(p @ v [B, T, N, H], m [B, T, N], l [B, T, N]), all f32, p not divided
  by l: m = max(-1e30, live scores), p = exp(s - m) on live keys and 0
  elsewhere, l = sum(p)."""
  b, t, n, h = q.shape
  rep = n // n_kv_heads
  k = _by_q_head(k_cache, b, n_kv_heads, rep, layout).float()  # [B, N, H, S]
  v = _by_q_head(v_cache, b, n_kv_heads, rep, layout).float()  # [B, N, S, H]
  s = torch.matmul(q.float().transpose(1, 2), k)               # [B, N, T, S]
  if logit_cap:
    s = logit_cap * torch.tanh(s / logit_cap)
  dead = ~mask[:, None]
  s = s.masked_fill(dead, NEG_INF)
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m).masked_fill(dead, 0.0)
  l = p.sum(dim=-1, keepdim=True)
  acc = torch.matmul(p, v)                                     # [B, N, T, H]
  return (acc.transpose(1, 2), m[..., 0].transpose(1, 2),
          l[..., 0].transpose(1, 2))


def decode_attention_reference(q, k_cache, v_cache, mask, *, n_kv_heads: int,
                               logit_cap: float = 0.0,
                               layout: str = "batch_major",
                               return_stats: bool = False):
  """Plain-PyTorch decode attention with the TPU kernel's semantics.

  The softmax is taken in one pass over S rather than online, which gives
  the same result: m = max(-1e30, live scores), p = exp(s - m) on live keys
  and 0 elsewhere, l = sum(p), out = (p @ v) / max(l, 1e-30). With
  return_stats, also returns m and the raw l, each [B, T, N] f32."""
  _check(q, k_cache, v_cache, mask, n_kv_heads, layout)
  acc, m, l = _plain_parts(q, k_cache, v_cache, mask, n_kv_heads, logit_cap,
                           layout)
  out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
  if return_stats:
    return out, m, l
  return out


def decode_attention_split_reference(q, k_cache, v_cache, mask, *,
                                     n_kv_heads: int, logit_cap: float = 0.0,
                                     layout: str = "batch_major",
                                     return_stats: bool = False,
                                     split_keys: int = _TILE):
  """The arithmetic of the split-S decode kernel in plain PyTorch.

  The plain version runs on each slice of `split_keys` keys and gives its
  f32 (acc = p @ v, m, l); the slices are merged in order 0, 1, ...:
  m* = max m_i, w_i = exp(m_i - m*) where l_i > 0 and exactly 0 where a
  slice has no live key, out = sum w_i acc_i / max(sum w_i l_i, 1e-30)
  (decode_attention_sp's merge, with acc_i = l_i out_i). With
  return_stats, also m* and the raw sum w_i l_i, each [B, T, N] f32."""
  _check(q, k_cache, v_cache, mask, n_kv_heads, layout)
  parts = [_plain_parts(q, k_cache[:, :, s0:s0 + split_keys],
                        v_cache[:, s0:s0 + split_keys],
                        mask[:, :, s0:s0 + split_keys], n_kv_heads,
                        logit_cap, layout)
           for s0 in range(0, k_cache.shape[-1], split_keys)]
  m_star = parts[0][1]
  for _, m_i, _ in parts[1:]:
    m_star = torch.maximum(m_star, m_i)
  num = torch.zeros_like(parts[0][0])
  den = torch.zeros_like(m_star)
  for acc_i, m_i, l_i in parts:
    w = torch.where(l_i > 0, torch.exp(m_i - m_star), 0.0)
    num = num + w[..., None] * acc_i
    den = den + w * l_i
  out = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
  if return_stats:
    return out, m_star, den
  return out


DEAD, MIXED, LIVE = 0, 1, 2


def mask_tile_classes_reference(mask, tile: int = _TILE):
  """The prefill pre-pass in plain PyTorch: mask [B, T, S] bool -> uint8
  [B, ceil(T / tile), ceil(S / tile)], per (b, query tile, key tile): DEAD
  (no live pair), LIVE (every pair live, and the key tile wholly inside S)
  or MIXED. Rows past T and keys past S are not pairs of the tile."""
  b, t, s = mask.shape
  qt, nk = _cdiv(t, tile), _cdiv(s, tile)
  live = torch.zeros((b, qt * tile, nk * tile), dtype=torch.int32,
                     device=mask.device)
  live[:, :t, :s] = mask.to(torch.int32)
  pairs = torch.zeros_like(live)
  pairs[:, :t, :s] = 1
  live = live.reshape(b, qt, tile, nk, tile).sum(dim=(2, 4))
  pairs = pairs.reshape(b, qt, tile, nk, tile).sum(dim=(2, 4))
  full_keys = torch.arange(nk, device=mask.device) * tile + tile <= s
  classes = torch.full((b, qt, nk), MIXED, dtype=torch.uint8,
                       device=mask.device)
  classes[live == 0] = DEAD
  classes[(live == pairs) & full_keys] = LIVE
  return classes


def takes_sm90(q_dtype, kv_dtype, head_dim: int, s_len: int) -> bool:
  """Whether a CUDA call goes to the Hopper kernels: by dtype and shape
  only (bf16 q and cache, H <= 128 a multiple of 8, S a multiple of 8)."""
  return (q_dtype == kv_dtype == torch.bfloat16 and
          head_dim <= _SM90_MAX_HEAD_DIM and head_dim % 8 == 0 and
          s_len % 8 == 0)


def decode_split_tiles(rows_kv: int, s_len: int, sm_count: int) -> int:
  """64-key tiles of one split-S split: enough splits that rows_kv x splits
  blocks fill the SMs about eight times over, at most one split a tile."""
  n_tiles = _cdiv(s_len, _TILE)
  splits = max(1, min(n_tiles, _cdiv(8 * sm_count, rows_kv)))
  return min(_SPLIT_MAX_TILES, _cdiv(n_tiles, splits))


@functools.cache
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel_fn():
  """The C entry point of csrc/decode_attention.cu, built and bound at first
  use."""
  from automl_tpu_torch.ops import cuda_build
  fn = cuda_build.load("decode_attention").automl_decode_attention
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  fn.argtypes = [ptr] * 7 + [i32, i32, i64, i64, i64] + [i32] * 7 + [
      ctypes.c_float, ptr]
  fn.restype = i32
  return fn


@functools.cache
def _sm90_fns():
  """(decode, prefill): the C entry points of csrc/decode_attention_sm90.cu."""
  from automl_tpu_torch.ops import cuda_build
  lib = cuda_build.load("decode_attention_sm90")
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  decode = lib.automl_decode_attention_sm90_decode
  decode.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 8 + [ctypes.c_float, ptr]
  prefill = lib.automl_decode_attention_sm90_prefill
  prefill.argtypes = [ptr] * 10 + [i64] * 3 + [i32] * 7 + [ctypes.c_float, ptr]
  for fn in (decode, prefill):
    fn.restype = i32
  return decode, prefill


def _aligned(x):
  """x, or a copy of it, at a 16-byte aligned address (what 16-byte copies
  and TMA need)."""
  return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_simt(q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout,
                 out, m, l):
  b, t, n, h = q.shape
  err = _kernel_fn()(
      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
      out.data_ptr(), m.data_ptr() if m is not None else None,
      l.data_ptr() if l is not None else None,
      _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype],
      q.stride(0), q.stride(1), q.stride(2),
      b, t, n, n_kv_heads, h, k_cache.shape[-1],
      int(layout == "head_major"), float(logit_cap or 0.0),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"decode_attention kernel launch failed: CUDA error "
                       f"{err}")
  decode_attention.launches_simt += 1


def _launch_sm90(q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout,
                 out, m, l):
  b, t, n, h = q.shape
  s_len = k_cache.shape[-1]
  decode, prefill = _sm90_fns()
  k_cache, v_cache, mask = (_aligned(x) for x in (k_cache, v_cache, mask))
  dev, f32 = q.device, torch.float32
  if t * (n // n_kv_heads) <= _SM90_DECODE_ROWS:
    tiles = decode_split_tiles(b * n_kv_heads, s_len, _sm_count(dev.index))
    splits = _cdiv(_cdiv(s_len, _TILE), tiles)
    part_acc = torch.empty((splits, b * t * n, h), dtype=f32, device=dev)
    part_ml = torch.empty((splits, b * t * n, 2), dtype=f32, device=dev)
    fn, scratch, extra = decode, (part_acc, part_ml), (tiles,)
  else:
    if q.data_ptr() % 16 or any(x % 8 for x in q.stride()[:3]):
      q = q.contiguous()  # a TMA descriptor's strides and base
    grid = (b, _cdiv(t, _TILE), _cdiv(s_len, _TILE))  # 64 x 64 tiles
    cls = torch.empty(grid, dtype=torch.uint8, device=dev)
    bits = torch.empty((*grid, _TILE), dtype=torch.int64, device=dev)
    order = torch.empty(b * _cdiv(t, 2 * _TILE), dtype=torch.int32,
                        device=dev)
    fn, scratch, extra = prefill, (cls, bits, order), ()
  err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           mask.data_ptr(), out.data_ptr(),
           m.data_ptr() if m is not None else None,
           l.data_ptr() if l is not None else None,
           *(x.data_ptr() for x in scratch),
           q.stride(0), q.stride(1), q.stride(2),
           b, t, n, n_kv_heads, h, s_len, int(layout == "head_major"),
           *extra, float(logit_cap or 0.0),
           torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("decode_attention Hopper kernel launch failed: " + (
        "a TMA tensor map could not be encoded" if err == -1
        else f"CUDA error {err}"))
  decode_attention.launches_sm90 += 1


def _launch(q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout,
            return_stats, simt):
  if q.dtype not in _DTYPE_CODES or k_cache.dtype not in _DTYPE_CODES:
    raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                    f"q and cache, got {q.dtype} and {k_cache.dtype}")
  if v_cache.dtype != k_cache.dtype or mask.dtype != torch.bool:
    raise TypeError("k and v caches must share a dtype and the mask must be "
                    f"bool; got {k_cache.dtype}, {v_cache.dtype}, {mask.dtype}")
  if any(x.device != q.device for x in (k_cache, v_cache, mask)):
    raise ValueError("decode_attention: q, caches and mask must share a device")
  if q.stride(-1) != 1 or not all(
      x.is_contiguous() for x in (k_cache, v_cache, mask)):
    raise ValueError("decode_attention kernel needs a unit head-dim stride "
                     "in q and contiguous caches and mask")
  b, t, n, h = q.shape
  if h > _MAX_HEAD_DIM:
    raise ValueError(f"decode_attention kernel takes head_dim <= "
                     f"{_MAX_HEAD_DIM}, got {h}")
  out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
  m = l = None
  if return_stats:
    m = torch.empty((b, t, n), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
  sm90 = not simt and takes_sm90(q.dtype, k_cache.dtype, h, k_cache.shape[-1])
  with torch.cuda.device(q.device):  # the launch goes to q's card
    (_launch_sm90 if sm90 else _launch_simt)(
        q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout, out, m, l)
  decode_attention.launches += 1
  return (out, m, l) if return_stats else out


def decode_attention(q, k_cache, v_cache, mask, *, n_kv_heads: int,
                     logit_cap: float = 0.0, layout: str = "batch_major",
                     return_stats: bool = False, _simt: bool = False):
  """KV-cached attention on the rank-3 decode cache.

  q: [B, T, N, H], already scaled (T = 1 for decode, the prompt length for
  prefill-with-cache). layout="batch_major": cache row r = b*n_kv + h,
  k_cache [B*n_kv, H, S], v_cache [B*n_kv, S, H]; layout="head_major":
  r = h*B + b. mask: [B, T, S] bool, True = attend.
  Returns [B, T, N, H] in q's dtype (f32 accumulation); with return_stats
  also the softmax max m and the raw normaliser l, each [B, T, N] f32.

  CPU tensors go to decode_attention_reference. CUDA tensors go to a
  kernel, which raises if it cannot be built or launched, routed by dtype
  and shape only (takes_sm90):
    * bf16 q and cache, H <= 128 a multiple of 8, S a multiple of 8: the
      Hopper kernels of csrc/decode_attention_sm90.cu, split-S with a
      fixed-order merge where T * N / n_kv <= 16 (decode, short chunks),
      wgmma tiles that skip dead ones above (prefill);
    * anything else (f32 q or cache, H > 128, a ragged H or S): the kernel
      of csrc/decode_attention.cu.
  _simt=True sends a call to the latter whatever its inputs (for
  comparisons; nothing on the model path passes it)."""
  if q.device.type == "cpu":
    return decode_attention_reference(
        q, k_cache, v_cache, mask, n_kv_heads=n_kv_heads,
        logit_cap=logit_cap, layout=layout, return_stats=return_stats)
  if q.device.type != "cuda":
    raise ValueError(f"decode_attention: no implementation on {q.device}")
  _check(q, k_cache, v_cache, mask, n_kv_heads, layout)
  return _launch(q, k_cache, v_cache, mask, n_kv_heads, logit_cap, layout,
                 return_stats, _simt)


decode_attention.launches = 0
decode_attention.launches_sm90 = 0
decode_attention.launches_simt = 0


# ---------------------------------------------------------------------------
# Sharded decode attention (JAX's decode_attention_tp / _sp): the kernel on
# each rank's shard of the cache, around it the collectives of the 'model'
# axis. A CUDA shard launches the kernel or raises, as decode_attention.
# ---------------------------------------------------------------------------


def merge_partials(out, m, l, reduce_max, reduce_sum):
  """Merges online-softmax partials of disjoint key sets:
  m* = max_i m_i, w_i = l_i exp(m_i - m*),
  out = sum_i w_i out_i / max(sum_i w_i, 1e-30), in out's dtype.

  out [..., H] and m, l [...] are one shard's (or a stack of shards');
  reduce_max / reduce_sum reduce a tensor over the shards: all-reduces
  across ranks, or reductions over a stacked dim (keepdim). A shard with
  no live key has l = 0 and weighs nothing; where no shard has one, the
  result is 0."""
  m_star = reduce_max(m)
  w = l * torch.exp(m - m_star)
  num = reduce_sum(w[..., None] * out.float())
  den = reduce_sum(w)
  return (num / torch.clamp(den[..., None], min=1e-30)).to(out.dtype)


def _is_dtensor(x) -> bool:
  from torch.distributed.tensor import DTensor
  return isinstance(x, DTensor)


def _local_part(x):
  return x.to_local() if _is_dtensor(x) else x


def decode_attention_tp(q, k_cache, v_cache, mask, mesh, *, n_kv_heads: int,
                        logit_cap: float = 0.0, axis: str = "model",
                        local: bool = False):
  """Tensor-parallel decode attention: heads sharded over a mesh axis.

  q: [B, T, N, H], the same on every rank. k_cache [n_kv, B, H, S] and
  v_cache [n_kv, B, S, H]: the head-leading cache (TransformerLM.init_cache
  with serve_tp), dim 0 over `axis`: with local=True (or DTensors) this
  rank's shard of n_kv / m heads, else the whole cache, of which the rank
  takes its heads. mask [B, T, S], the same on every rank. Each rank runs
  the kernel in its head-major layout (row r = h*B + b) on its own heads,
  and the heads are gathered across the axis: no key moves between ranks.
  Returns [B, T, N, H] on every rank. Requires n_heads % m == 0 and
  n_kv % m == 0 (m the axis's size), as in JAX."""
  from automl_tpu_torch.parallel import comm
  b, t, n, h = q.shape
  ax = mesh.mesh_dim_names.index(axis)
  m, r = mesh.size(ax), mesh.get_local_rank(axis)
  if n % m or n_kv_heads % m:
    raise ValueError(
        f"serve_tp: n_heads ({n}) and n_kv_heads ({n_kv_heads}) must be "
        f"divisible by mesh axis '{axis}' size {m}")
  nkv_l, n_l = n_kv_heads // m, n // m
  k_l, v_l = _local_part(k_cache), _local_part(v_cache)
  if not local and not _is_dtensor(k_cache):
    k_l, v_l = k_l[r * nkv_l:(r + 1) * nkv_l], v_l[r * nkv_l:(r + 1) * nkv_l]
  q_l = q[:, :, r * n_l:(r + 1) * n_l]
  out = decode_attention(
      q_l, k_l.reshape(nkv_l * b, h, k_l.shape[-1]),
      v_l.reshape(nkv_l * b, v_l.shape[2], h), mask, n_kv_heads=nkv_l,
      logit_cap=logit_cap, layout="head_major")
  if m == 1:
    return out
  return comm._all_gather(out, mesh, axis, dim=2)


def decode_attention_sp(q, k_cache, v_cache, mask, mesh, *, n_kv_heads: int,
                        logit_cap: float = 0.0, axis: str = "model",
                        local: bool = False):
  """Sequence-parallel decode attention: the cache sharded over S.

  q [B, T, N, H], the same on every rank. k_cache [B*n_kv, H, S], v_cache
  [B*n_kv, S, H] and mask [B, T, S], S over `axis`: with local=True (or
  DTensors) this rank's S / m keys, else the whole arrays, padded to a
  multiple of m with masked keys and cut to the rank's slice. Each rank
  runs the kernel with return_stats on its keys; merge_partials combines
  the shards with all-reduces (max, then sums). A shard with no live key
  weighs nothing; with none anywhere the output is 0, not NaN. Returns
  [B, T, N, H] on every rank."""
  from automl_tpu_torch.parallel import comm
  ax = mesh.mesh_dim_names.index(axis)
  m, r = mesh.size(ax), mesh.get_local_rank(axis)
  k_l, v_l, mask_l = (_local_part(x) for x in (k_cache, v_cache, mask))
  if not local and not _is_dtensor(k_cache):
    s = k_l.shape[-1]
    s_pad = -(-s // m) * m
    if s_pad != s:
      k_l = torch.nn.functional.pad(k_l, (0, s_pad - s))
      v_l = torch.nn.functional.pad(v_l, (0, 0, 0, s_pad - s))
      mask_l = torch.nn.functional.pad(mask_l, (0, s_pad - s))
    s_l = s_pad // m
    k_l = k_l[..., r * s_l:(r + 1) * s_l].contiguous()
    v_l = v_l[:, r * s_l:(r + 1) * s_l].contiguous()
    mask_l = mask_l[..., r * s_l:(r + 1) * s_l].contiguous()
  out, mx, l = decode_attention(q, k_l, v_l, mask_l, n_kv_heads=n_kv_heads,
                                logit_cap=logit_cap, return_stats=True)

  def reduce(op):
    return lambda x: comm.all_reduce(x.contiguous().clone(), mesh, (axis,),
                                     op)

  return merge_partials(out, mx, l, reduce(torch.distributed.ReduceOp.MAX),
                        reduce(torch.distributed.ReduceOp.SUM))
