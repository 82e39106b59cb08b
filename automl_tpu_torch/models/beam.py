"""Beam search with the KV cache and a per-step reorder of its rows.

The counterpart of automl_tpu/models/beam.py:

  * the prompt is prefilled once at batch B, then each cache row is
    replicated per beam, beams innermost: row (b * K + j) * n_kv + h;
  * each step scores every beam in one forward, takes the top K of the
    [K * V] joint (step 0 seeds the beams from the prompt's top K), and
    gathers the cache rows to the surviving parents;
  * a finished beam (eos) is frozen: it has one continuation, pad at no
    cost, so it competes as it is;
  * the pick: the highest score / length ** length_penalty per batch row
    (GNMT's length normalisation).

The top K is a stable descending sort, which keeps lax.top_k's order
among equal scores (the lower index first) where torch.topk's is
unspecified (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _top_k(x, k: int):
  """(values, indices) of the k largest along the last axis, the lower
  index first among equal values (lax.top_k's order)."""
  values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
  return values[..., :k], indices[..., :k]


def _replicate_cache_rows(cache, b: int, n_kv: int, beams: int):
  """[B * n_kv, ...] cache rows -> [(B * beams) * n_kv, ...], beams
  innermost."""
  def rep(x):
    return x.reshape(b, n_kv, *x.shape[1:]).repeat_interleave(
        beams, dim=0).reshape(b * beams * n_kv, *x.shape[1:])
  return tuple({name: rep(x) for name, x in layer.items()} for layer in cache)


def _gather_cache_rows(cache, row_parent, n_kv: int):
  """The cache rows of each surviving beam's parent: row_parent [B * beams]
  is the flat (batch, beam) index of each beam's parent."""
  idx = (row_parent[:, None] * n_kv
         + torch.arange(n_kv, device=row_parent.device)).reshape(-1)
  return tuple({name: x.index_select(0, idx) for name, x in layer.items()}
               for layer in cache)


@torch.inference_mode()
def beam_search_generate(model, prompt_tokens, max_new_tokens: int,
                         num_beams: int = 4, length_penalty: float = 0.6,
                         eos_id: Optional[int] = None):
  """Returns (tokens [B, T_prompt + max_new_tokens] int64, scores [B] f32):
  the best beam of each batch row (pad 0 after its eos) and its
  length-normalised log-probability."""
  b, t0 = prompt_tokens.shape
  k = int(num_beams)
  total = t0 + max_new_tokens
  n_kv = model.cfg.n_kv_heads
  device = prompt_tokens.device

  cache = model.init_cache(b, total)
  logits, cache = model(
      prompt_tokens, positions=torch.arange(t0, device=device).expand(b, t0),
      cache=cache, cache_index=0,
      kv_positions=torch.arange(total, device=device).expand(b, total))
  cache = _replicate_cache_rows(cache, b, n_kv, k)
  first_lp = torch.log_softmax(logits[:, t0 - 1].float(), dim=-1)   # [B, V]
  v = first_lp.shape[-1]

  scores, tok0 = _top_k(first_lp, k)                                # [B, K]
  tokens = torch.zeros((b, k, total), dtype=torch.int64, device=device)
  tokens[:, :, :t0] = prompt_tokens[:, None]
  tokens[:, :, t0] = tok0
  done = (tok0 == eos_id if eos_id is not None
          else torch.zeros((b, k), dtype=torch.bool, device=device))
  lengths = torch.ones((b, k), dtype=torch.int64, device=device)
  kv_pos = torch.arange(total, device=device).expand(b * k, total)
  pad_row = torch.full((v,), NEG_INF, device=device)
  pad_row[0] = 0.0
  batch_off = torch.arange(b, device=device)[:, None] * k

  for i in range(t0, total - 1):
    logits, cache = model(
        tokens[:, :, i].reshape(b * k, 1),
        positions=torch.full((b * k, 1), i, device=device), cache=cache,
        cache_index=i, kv_positions=kv_pos)
    lp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(b, k, v)
    # A finished beam has one continuation: pad, at no cost.
    lp = torch.where(done[:, :, None], pad_row, lp)
    scores, flat = _top_k((scores[:, :, None] + lp).reshape(b, k * v), k)
    parent, tok = flat // v, flat % v
    cache = _gather_cache_rows(cache, (batch_off + parent).reshape(-1), n_kv)
    tokens = tokens.gather(1, parent[:, :, None].expand(-1, -1, total))
    done = done.gather(1, parent)
    lengths = lengths.gather(1, parent)
    tok = torch.where(done, 0, tok)
    tokens[:, :, i + 1] = tok
    lengths = lengths + (~done).long()
    if eos_id is not None:
      done = done | (tok == eos_id)

  norm = scores / lengths.float().clamp_min(1.0) ** length_penalty
  best = norm.argmax(dim=1)                                          # [B]
  rows = torch.arange(b, device=device)
  return tokens[rows, best], norm[rows, best]
