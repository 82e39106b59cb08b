"""Speculative decoding: a cheap draft proposes, one target forward verifies.

The counterpart of automl_tpu/models/speculative.py (Leviathan et al. 2023;
Chen et al. 2023). Each iteration the draft model takes k + 1 single-token
steps (the last one only writes the k-th draft's K/V into the draft cache),
then the target scores [tok, d_1..d_k] in one forward at the row's offset:

  * temperature 0: a draft is accepted while it equals the target's
    argmax, so the output is token-exact against greedy_generate on the
    target whatever the draft is;
  * temperature > 0: draft x is accepted with probability min(1, p(x) /
    q(x)), else the next token is drawn from normalize(max(p - q, 0)) (at
    full acceptance, the bonus token from p), which keeps the target's
    warped distribution.

All rows advance by the batch-min accepted length + 1, so the cache offset
stays one int; stale K/V of rejected drafts are rewritten before any query
reads them. The loop is an eager while loop: the host reads the advance and
whether every row is done once per iteration (JAX's lax.while_loop reads
nothing). Draws come from a torch.Generator, so sampled tokens differ from
JAX's jax.random ones (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from automl_tpu_torch.models.lm import TransformerLM, truncate_logits


def _warp(logits, temperature: float, top_k: int, top_p: float):
  """sample_logits' temperature / top-k / top-p as a warp of f32 logits;
  temperature 0 returns the raw logits (callers take their argmax)."""
  logits = logits.float()
  if temperature == 0.0:
    return logits
  return truncate_logits(logits / temperature, top_k, top_p)


def _draw(logits, generator):
  """One draw per row of [..., V] logits: [...] int64."""
  probs = torch.softmax(logits, dim=-1)
  flat = probs.reshape(-1, probs.shape[-1])
  return torch.multinomial(flat, 1, generator=generator).reshape(
      probs.shape[:-1])


@torch.inference_mode()
def speculative_generate(model: TransformerLM, draft_model: TransformerLM,
                         prompt_tokens, max_new_tokens: int,
                         n_draft: int = 4, generator=None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 0.0, eos_id: Optional[int] = None,
                         return_stats: bool = False):
  """Decodes with draft-model speculation; greedy_generate's contract.

  prompt_tokens: [B, T0]. Returns [B, T0 + max_new_tokens] int64, and with
  return_stats a dict {iterations, emitted, accepted_drafts, accept_rate}
  of Python numbers. The draft shares the target's vocabulary. `generator`
  is the torch.Generator of the draws (temperature > 0)."""
  k = int(n_draft)
  if k < 1:
    raise ValueError(f"n_draft must be >= 1, got {n_draft}")
  b, t0 = prompt_tokens.shape
  total = t0 + max_new_tokens
  buf = total + k + 1                # room for the last verify's overshoot
  greedy = temperature == 0.0
  device = prompt_tokens.device

  t_cache = model.init_cache(b, buf)
  d_cache = draft_model.init_cache(b, buf)
  kv_pos = torch.arange(buf, device=device).expand(b, buf)
  pos0 = torch.arange(t0, device=device).expand(b, t0)
  # Prefill both caches; the first verify block feeds tokens[:, t0 - 1]
  # again, so the target's prefill logits are not needed.
  model(prompt_tokens, positions=pos0, cache=t_cache, cache_index=0,
        kv_positions=kv_pos)
  draft_model(prompt_tokens, positions=pos0, cache=d_cache, cache_index=0,
              kv_positions=kv_pos)
  tokens = torch.zeros((b, buf), dtype=torch.int64, device=device)
  tokens[:, :t0] = prompt_tokens
  off = torch.arange(k + 1, device=device)[None]           # [1, k+1]
  done = torch.zeros((b,), dtype=torch.bool, device=device)
  cur, all_done, iters, accepted = t0 - 1, False, 0, 0

  while cur < t0 - 1 + max_new_tokens and not all_done:
    # 1) k + 1 draft steps from tokens[:, cur]; the last one's output is
    #    dropped, its step writes the k-th draft's K/V.
    tok = tokens[:, cur]
    drafts, q_rows = [], []
    for j in range(k + 1):
      logits, _ = draft_model(
          tok[:, None], positions=torch.full((b, 1), cur + j, device=device),
          cache=d_cache, cache_index=cur + j, kv_positions=kv_pos)
      qlog = _warp(logits[:, 0], temperature, top_k, top_p)   # [B, V]
      tok = qlog.argmax(-1) if greedy else _draw(qlog, generator)
      drafts.append(tok)
      if not greedy:
        q_rows.append(torch.softmax(qlog, dim=-1))
    drafts = torch.stack(drafts[:k], dim=1)                    # [B, k]

    # 2) one target forward over [tokens[:, cur], d_1..d_k].
    chunk = torch.cat([tokens[:, cur:cur + 1], drafts], dim=1)
    vlogits, _ = model(chunk, positions=cur + off.expand(b, k + 1),
                       cache=t_cache, cache_index=cur, kv_positions=kv_pos)
    wlog = _warp(vlogits, temperature, top_k, top_p)           # [B, k+1, V]

    # 3) the leading run of accepted drafts, and the values to emit.
    if greedy:
      t_next = wlog.argmax(-1)                                 # [B, k+1]
      ok = (drafts == t_next[:, :k]).long()
      m = ok.cumprod(dim=1).sum(dim=1)                         # [B]
      vals = t_next      # accepted drafts equal the argmax: emit t_next
    else:
      q_full = torch.stack(q_rows[:k], dim=1)                  # [B, k, V]
      p_full = torch.softmax(wlog, dim=-1)                     # [B, k+1, V]
      p_d = p_full[:, :k].gather(-1, drafts[..., None])[..., 0]
      q_d = q_full.gather(-1, drafts[..., None])[..., 0]
      u = torch.rand((b, k), generator=generator, device=device)
      acc = (u * q_d.clamp_min(1e-20) < p_d).long()
      m = acc.cumprod(dim=1).sum(dim=1)
      # The correction at the first rejection: the residual max(p - q, 0);
      # with every draft accepted, the bonus token from p_k.
      p_at = p_full.gather(1, m[:, None, None].expand(-1, 1, p_full.shape[-1]))
      q_at = q_full.gather(1, m.clamp_max(k - 1)[:, None, None].expand(
          -1, 1, q_full.shape[-1]))
      q_at = torch.where((m < k)[:, None, None], q_at, 0.0)
      resid = (p_at[:, 0] - q_at[:, 0]).clamp_min(0.0)
      resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
      corr = _draw(torch.log(resid + 1e-20), generator)        # [B]
      drafts_p = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
      vals = torch.where(off < m[:, None], drafts_p, corr[:, None])

    a = (m + 1).min()                  # the batch-min advance, >= 1
    write = off < a
    if eos_id is not None:
      hit = (vals == eos_id) & write & ~done[:, None]
      excl = torch.cat([torch.zeros_like(hit[:, :1], dtype=torch.long),
                        hit.long().cumsum(dim=1)[:, :-1]], dim=1)
      vals = torch.where(done[:, None] | (excl > 0), 0, vals)  # pad after eos
      done = done | hit.any(dim=1)
    span = slice(cur + 1, cur + k + 2)
    tokens[:, span] = torch.where(write, vals, tokens[:, span])
    # The iteration's one host read: the advance and whether all are done.
    step, all_done = torch.stack([a, done.all().long()]).tolist()
    all_done = bool(all_done)
    cur, iters, accepted = cur + step, iters + 1, accepted + step - 1

  out = tokens[:, :total]
  if return_stats:
    return out, {"iterations": iters, "emitted": cur - (t0 - 1),
                 "accepted_drafts": accepted,
                 "accept_rate": accepted / max(iters * k, 1)}
  return out
