"""Continuous-batching LM server: decode slots over one persistent KV cache.

The counterpart of automl_tpu/inference/lm_server.py:

  * one cache of [B, S] per layer lives through the whole serve loop; each
    slot sits at its own offset, so the cache is written per row (the
    model's vector cache_index), and an inactive slot parks its write at
    index S, where it is dropped;
  * decode runs in bursts of `burst` steps. Within a burst the per-slot
    state (last token, lengths, active, remaining, the stop window) stays
    on the device and nothing is read back: a row that finishes mid-burst
    freezes as greedy_generate's rows do (emits pad, parks its writes).
    The host reads the burst's tokens and state once, after it (JAX's
    jitted scan);
  * prefill by power-of-two length bucket and power-of-two group: every
    free slot admits in one batched forward into a group-sized cache,
    whose real rows are copied into their slots' rows of the big cache;
  * prompts longer than `prefill_chunk` prefill in chunks, one chunk per
    loop turn, against their slot's rows of the big cache, between the
    decode bursts;
  * prefix caching: serve(requests, shared_prefix=ids) prefills the
    prefix once, and each admission starts from its K/V and prefills only
    its own suffix;
  * serve() records a `timeline` of device calls and, per request, the
    timeline index of its first token and of its completion, and counts
    `steps` and `busy_slot_steps`.

Greedy output is token-exact against greedy_generate per request. Sampling
(temperature / top_k / top_p) and eos_id are the server's; max_new_tokens
is the request's. Draws come from the server's torch.Generator (JAX's from
jax.random: another sequence, ROADMAP Queue 3).

use_decode_kernel: None means False, JAX's default (the plain dots even
above decode_kernel_min_s); True sends the bursts and the chunk prefills
through the decode kernel (K4) where the cache reaches
decode_kernel_min_s. The server runs its own copy of the model (sharing
the parameters until cast_weights casts its copy) under a copy of the
config with the flag set, so neither the caller's model nor its config
changes. JAX rebuilds the model only to turn the kernel off, so its True
cannot turn on a kernel that the config turned off; the port's can
(ROADMAP Queue 3).

Sharded serving (a model on a mesh, models/lm.py): serve_tp and serve_sp
decode through the kernel whatever use_decode_kernel says, as in JAX.
serve_tp's head-leading cache ([n_kv, B, hd, S], this rank's heads) takes
the same prefix-template copies and slot writes along its batch dim 1.
serve_sp rounds S up to a multiple of the 'model' axis; on an axis above
1 each rank holds its own keys of the cache, so a prompt prefills straight
into its slot's rows (one chunk of its bucket's length, through the
chunked-prefill path) rather than through a group cache whose keys would
sit on other ranks, and a shared prefix is prefilled with each prompt.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from automl_tpu_torch.models.lm import (_pack_stops,
                                        cast_lm_params_for_serving,
                                        chosen_logprob, sample_logits)


@dataclasses.dataclass
class GenRequest:
  """One generation request: a prompt and its decode budget."""
  prompt: Sequence[int]
  max_new_tokens: int = 64


@dataclasses.dataclass
class GenResult:
  tokens: list          # generated ids, EOS included when hit
  prompt_len: int
  finished_by_eos: bool
  logprobs: list = None  # per generated token (want_logprobs=True only)
  finished_by_stop: bool = False  # ended by a server stop_sequence


def _serving_model(model, use_decode_kernel: bool):
  """A copy of `model` whose config has use_decode_kernel set: new
  Parameter objects over the same tensors (so casting the copy leaves the
  caller's model alone) and a config of its own."""
  memo = {id(p): nn.Parameter(p.data, requires_grad=p.requires_grad)
          for p in model.parameters()}
  served = copy.deepcopy(model, memo)
  sharded = served.cfg.get("serve_tp") or served.cfg.get("serve_sp")
  served.cfg.update(dict(use_decode_kernel=bool(use_decode_kernel
                                                or sharded)))
  return served


class LMServer:
  """Slot-based continuous batching over one persistent [B, S] KV cache."""

  def __init__(self, model, max_batch: int = 8, max_seq_len: int = 2048,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               eos_id: Optional[int] = None, burst: int = 8, seed: int = 0,
               cast_weights: bool = True, stop_sequences=None,
               want_logprobs: bool = False,
               prefill_chunk: Optional[int] = None,
               use_decode_kernel: Optional[bool] = None):
    if getattr(model, "cfg", None) is not None:
      model = _serving_model(model, bool(use_decode_kernel))
      if cast_weights:
        cast_lm_params_for_serving(model)
    self.model = model
    self.device = model.device
    self.B, self.S = int(max_batch), int(max_seq_len)
    par = getattr(model, "par", None)
    if getattr(model, "cfg", None) is not None:
      self.S = model.cache_len(self.S)   # serve_sp: a shard multiple
    # serve_sp with its keys split across ranks: prefill into the slots.
    self._sp_split = bool(par is not None and par.model > 1
                          and model.cfg.get("serve_sp"))
    self.want_logprobs = bool(want_logprobs)
    self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
    self.eos_id = eos_id
    # Multi-token stops: a slot finishes once its output ends with one
    # (matched inside the burst on a rolling [B, K] window; the stop stays
    # in the output, like EOS).
    self.stop_seqs = [list(map(int, s)) for s in (stop_sequences or [])]
    self._stops = (_pack_stops(self.stop_seqs, self.device)
                   if self.stop_seqs else None)
    self._stop_k = int(self._stops.shape[1]) if self.stop_seqs else 1
    self.burst = int(burst)
    self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
    self._gen = torch.Generator(device=self.device).manual_seed(seed)

  # -- prefill ---------------------------------------------------------------

  def _prefill(self, cache, tokens, slots, true_lens, tpl, prefix_len):
    """`group` prompts (padded to `bucket`) in one forward into a group-sized
    cache, each real row's first P + true_len positions then copied into
    its slot's rows of the big cache (pad rows, true_len 0, write
    nothing). tokens [group, bucket] on the device; slots, true_lens host
    ints. With a prefix template of P positions (prefix caching), tokens
    are the suffixes and the group cache starts from the template's K/V.
    Returns the logits [group, V] of each row's last real token."""
    group, bucket = tokens.shape
    P, span, dev = prefix_len, prefix_len + bucket, self.device
    pos = (P + torch.arange(bucket, device=dev)).expand(group, bucket)
    kv_pos = torch.arange(span, device=dev).expand(group, span)
    if P and tpl[0]["k"].ndim == 4:      # serve_tp: [n_kv, 1, hd, P]
      tmp = tuple(
          {"k": torch.cat([t["k"].expand(-1, group, -1, -1), t["k"].new_zeros(
              (t["k"].shape[0], group, t["k"].shape[2], bucket))], dim=-1),
           "v": torch.cat([t["v"].expand(-1, group, -1, -1), t["v"].new_zeros(
              (t["v"].shape[0], group, bucket, t["v"].shape[3]))], dim=2)}
          for t in tpl)
    elif P:
      tmp = tuple(
          {"k": torch.cat([t["k"].repeat(group, 1, 1), t["k"].new_zeros(
              (group * t["k"].shape[0], t["k"].shape[1], bucket))], dim=-1),
           "v": torch.cat([t["v"].repeat(group, 1, 1), t["v"].new_zeros(
              (group * t["v"].shape[0], bucket, t["v"].shape[2]))], dim=1)}
          for t in tpl)
    else:
      tmp = self.model.init_cache(group, bucket)
    logits, tmp = self.model(tokens, positions=pos, cache=tmp, cache_index=P,
                             kv_positions=kv_pos)
    for g, (slot, true_len) in enumerate(zip(slots, true_lens)):
      if true_len == 0:
        continue
      n = P + true_len
      for big, t in zip(cache, tmp):
        if big["k"].ndim == 4:            # serve_tp: slot = batch column
          big["k"][:, slot, :, :n] = t["k"][:, g, :, :n]
          big["v"][:, slot, :n] = t["v"][:, g, :n]
          continue
        nkv = t["k"].shape[0] // group
        big["k"][slot * nkv:(slot + 1) * nkv, :, :n] = \
            t["k"][g * nkv:(g + 1) * nkv, :, :n]
        big["v"][slot * nkv:(slot + 1) * nkv, :n] = \
            t["v"][g * nkv:(g + 1) * nkv, :n]
    last = torch.tensor([max(n - 1, 0) for n in true_lens], device=dev)
    return logits[torch.arange(group, device=dev), last]

  def _template(self, tokens):
    """The shared prefix prefilled once: (per-layer K/V of one row, the
    last token's logits [V])."""
    p_len = tokens.shape[1]
    pos = torch.arange(p_len, device=self.device)[None]
    cache = self.model.init_cache(1, p_len)
    logits, cache = self.model(tokens, positions=pos, cache=cache,
                               cache_index=0, kv_positions=pos)
    return cache, logits[0, -1]

  def _chunk_prefill(self, cache, tokens, slot: int, start: int,
                     true_end: int, rel_last: int):
    """One prefill chunk of one slot, written into the slot's rows of the
    big cache, which hold the earlier chunks' K/V. tokens [1, chunk] at
    positions start..start + chunk - 1; positions >= true_end (the prompt's
    length) park at S. Returns the logits [V] at rel_last (the prompt's
    last token, on the last chunk)."""
    chunk, dev = tokens.shape[1], self.device
    pos = (start + torch.arange(chunk, device=dev))[None]
    write = torch.where(pos < true_end, pos, self.S)
    views = []
    for big in cache:
      if big["k"].ndim == 4:              # serve_tp: slot = batch column
        views.append({"k": big["k"][:, slot:slot + 1],
                      "v": big["v"][:, slot:slot + 1]})
        continue
      nkv = big["k"].shape[0] // self.B
      rows = slice(slot * nkv, (slot + 1) * nkv)
      views.append({"k": big["k"][rows], "v": big["v"][rows]})
    logits, _ = self.model(tokens, positions=pos, cache=tuple(views),
                           cache_index=write,
                           kv_positions=torch.arange(self.S, device=dev)[None])
    return logits[0, rel_last]

  def _bucket(self, n: int) -> int:
    b = 8
    while b < n:
      b *= 2
    return min(b, self.S)

  def _group_bucket(self, n: int) -> int:
    g = 1
    while g < n:
      g *= 2
    return min(g, self.B)

  # -- decode ----------------------------------------------------------------

  def _decode_burst(self, cache, tok, lengths, active, remaining, win):
    """`burst` decode steps for every slot, all on the device.

    tok: [B] each slot's last token (K/V not yet written); lengths: [B]
    tokens in each slot's cache rows; active: [B] bool (an inactive row
    emits 0 and parks its writes at S); remaining: [B] budget left.
    Returns (toks [B, burst], logprobs [B, burst], tok, lengths, active,
    remaining, win)."""
    kv_pos = torch.arange(self.S, device=self.device).expand(self.B, self.S)
    toks, lps = [], []
    for _ in range(self.burst):
      logits, cache = self.model(
          tok[:, None], positions=lengths[:, None], cache=cache,
          cache_index=torch.where(active, lengths, self.S),
          kv_positions=kv_pos)
      nxt = sample_logits(logits[:, 0], self.temperature, self.top_k,
                          self.top_p, self._gen)
      nxt = torch.where(active, nxt, 0)
      # Junk on inactive rows; the host keeps only what a row emitted.
      lps.append(chosen_logprob(logits[:, 0], nxt) if self.want_logprobs
                 else torch.zeros_like(nxt, dtype=torch.float32))
      lengths = lengths + active
      remaining = remaining - active.long()
      still = active & (remaining > 0)
      if self.eos_id is not None:
        still = still & (nxt != self.eos_id)
      win = torch.cat([win[:, 1:], nxt[:, None]], dim=1)
      if self._stops is not None:
        eq = (self._stops[None] == win[:, None]) | (self._stops[None] < 0)
        still = still & ~(eq.all(dim=-1).any(dim=-1) & active)
      active, tok = still, nxt
      toks.append(nxt)
    return (torch.stack(toks, dim=1), torch.stack(lps, dim=1), tok, lengths,
            active, remaining, win)

  # -- serve loop ------------------------------------------------------------

  @torch.inference_mode()
  def serve(self, requests: Sequence[GenRequest],
            shared_prefix: Optional[Sequence[int]] = None
            ) -> list[GenResult]:
    """Runs every request through the slot pool; results in request order.

    shared_prefix: token ids put before every request's prompt (a system
    prompt). Its K/V is computed once and seeds each admission, whose
    prefill covers its own prompt only; token-exact against serving the
    concatenations. Each request then needs at least one own token, and
    chunked prefill applies to serving without a prefix only."""
    B, S, dev = self.B, self.S, self.device
    queue = collections.deque(enumerate(requests))
    results: list[Optional[GenResult]] = [None] * len(requests)
    outputs: list[list[int]] = [[] for _ in requests]
    outlps: list[list[float]] = [[] for _ in requests]

    cache = self.model.init_cache(B, S)
    win = torch.full((B, self._stop_k), -2, dtype=torch.int64, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int64, device=dev)
    last_tok = torch.zeros((B,), dtype=torch.int64, device=dev)
    active = torch.zeros((B,), dtype=torch.bool, device=dev)
    remaining = torch.zeros((B,), dtype=torch.int64, device=dev)
    # Host copies of active and remaining, as of the last read-back.
    active_np = np.zeros((B,), bool)
    remaining_np = np.zeros((B,), np.int64)
    slot_req = [None] * B       # the request in each slot
    pending = {}                # slot -> chunked-prefill state
    self.steps = self.busy_slot_steps = 0
    self.timeline = []
    self.request_events = {i: {} for i in range(len(requests))}

    tpl, tpl_p, pfx = None, 0, None
    if shared_prefix is not None:
      pfx = [int(t) for t in shared_prefix]
      tpl_p = len(pfx)
      if not self._sp_split:
        tpl, _ = self._template(torch.tensor([pfx], dtype=torch.int64,
                                             device=dev))
        self.timeline.append({"kind": "prefix", "len": tpl_p})
    eff_prompts = {}  # ridx -> prefix + own prompt

    def finalize(ridx):
      toks = outputs[ridx]
      by_eos = (self.eos_id is not None and len(toks) > 0
                and toks[-1] == self.eos_id)
      seq = eff_prompts.get(
          ridx, [int(t) for t in requests[ridx].prompt]) + toks
      by_stop = any(len(seq) >= len(ss) and seq[-len(ss):] == ss
                    for ss in self.stop_seqs)
      results[ridx] = GenResult(tokens=toks, finished_by_eos=by_eos,
                                prompt_len=len(requests[ridx].prompt),
                                logprobs=outlps[ridx],
                                finished_by_stop=by_stop)
      self.request_events[ridx]["done"] = len(self.timeline)

    def activate(b, ridx, req, prompt, last_logits):
      """Draws the first token from last_logits [V] and puts the request
      into slot b, or finishes it at once."""
      first_t = sample_logits(last_logits[None], self.temperature,
                              self.top_k, self.top_p, self._gen)
      first = int(first_t[0])
      outputs[ridx].append(first)
      self.request_events[ridx]["first"] = len(self.timeline)
      if self.want_logprobs:
        outlps[ridx].append(float(chosen_logprob(last_logits[None],
                                                 first_t)[0]))
      seq = list(prompt) + [first]
      tail = seq[-self._stop_k:]
      hit_stop = any(len(seq) >= len(ss) and seq[-len(ss):] == ss
                     for ss in self.stop_seqs)
      if (req.max_new_tokens <= 1 or hit_stop
          or (self.eos_id is not None and first == self.eos_id)):
        finalize(ridx)
        return
      win[b] = torch.tensor([-2] * (self._stop_k - len(tail)) + tail,
                            dtype=torch.int64, device=dev)
      slot_req[b] = ridx
      lengths[b] = len(prompt)
      last_tok[b] = first
      active[b] = True
      remaining[b] = req.max_new_tokens - 1
      active_np[b], remaining_np[b] = True, req.max_new_tokens - 1

    while queue or pending or any(r is not None for r in slot_req):
      # Admit queued requests into free slots: long prompts become chunked
      # prefills, the rest prefill in per-bucket groups.
      admits = {}  # bucket -> [(slot, ridx, req, prompt)]
      for b in range(B):
        if slot_req[b] is not None or b in pending or not queue:
          continue
        ridx, req = queue.popleft()
        prompt = [int(t) for t in req.prompt]
        lp = len(prompt)
        if pfx is not None and lp < 1:
          raise ValueError(
              f"request {ridx}: shared_prefix serving needs at least one "
              "own prompt token per request")
        if tpl_p + lp + req.max_new_tokens > S:
          raise ValueError(
              f"request {ridx}: prefix ({tpl_p}) + prompt ({lp}) + "
              f"max_new_tokens ({req.max_new_tokens}) exceeds "
              f"max_seq_len ({S})")
        if self._sp_split:
          # The prefix (if any) prefills with the prompt, in one chunk.
          full = (pfx or []) + prompt
          if pfx is not None:
            eff_prompts[ridx] = full
          pending[b] = {"ridx": ridx, "req": req, "prompt": full,
                        "start": 0, "chunk": self._bucket(len(full))}
          continue
        if self.prefill_chunk and lp > self.prefill_chunk and tpl is None:
          pending[b] = {"ridx": ridx, "req": req, "prompt": prompt,
                        "start": 0, "chunk": self.prefill_chunk}
          continue
        admits.setdefault(self._bucket(lp), []).append((b, ridx, req, prompt))
      for bucket in sorted(admits):
        group = admits[bucket]
        g = self._group_bucket(len(group))
        tokens = np.zeros((g, bucket), np.int64)
        slots, true_lens = [0] * g, [0] * g   # pad rows: true_len 0
        for i, (b, ridx, req, prompt) in enumerate(group):
          tokens[i, :len(prompt)] = prompt
          slots[i], true_lens[i] = b, len(prompt)
        last_logits = self._prefill(
            cache, torch.from_numpy(tokens).to(dev), slots, true_lens, tpl,
            tpl_p)
        self.timeline.append({"kind": "prefill", "bucket": bucket,
                              "group": g, "prefix": tpl_p})
        for i, (b, ridx, req, prompt) in enumerate(group):
          if tpl is not None:
            eff_prompts[ridx] = pfx + prompt
          activate(b, ridx, req, eff_prompts.get(ridx, prompt),
                   last_logits[i])

      # One chunk of every pending chunked prefill: decode never waits
      # behind a long prompt for more than one chunk.
      for b in sorted(pending):
        st = pending[b]
        c = st["chunk"]
        lp, start = len(st["prompt"]), st["start"]
        piece = np.zeros((1, c), np.int64)
        n = min(c, lp - start)
        piece[0, :n] = st["prompt"][start:start + n]
        last_logits = self._chunk_prefill(
            cache, torch.from_numpy(piece).to(dev), b, start, lp,
            min(lp - 1 - start, c - 1))
        self.timeline.append({"kind": "chunk", "chunk": c})
        st["start"] = start + n
        if st["start"] >= lp:
          activate(b, st["ridx"], st["req"], st["prompt"], last_logits)
          del pending[b]

      if not active_np.any():
        continue
      busy = int(active_np.sum())
      toks, lps, last_tok, lengths, active, remaining, win = \
          self._decode_burst(cache, last_tok, lengths, active, remaining, win)
      self.timeline.append({"kind": "burst", "steps": self.burst,
                            "active": busy})
      # The burst's one read-back (f64 holds every token id, log-prob and
      # count exactly).
      back = torch.cat([toks.double(), lps.double(), active.double()[:, None],
                        remaining.double()[:, None]], dim=1).cpu().numpy()
      n_b = self.burst
      toks_np, lps_np = back[:, :n_b].astype(np.int64), back[:, n_b:2 * n_b]
      new_remaining = back[:, -1].astype(np.int64)
      emitted = remaining_np - new_remaining   # tokens each row emitted
      active_np, remaining_np = back[:, -2] > 0, new_remaining
      self.steps += self.burst
      self.busy_slot_steps += int(emitted.sum())
      for b in range(B):
        ridx = slot_req[b]
        if ridx is None:
          continue
        n = int(emitted[b])
        outputs[ridx].extend(int(t) for t in toks_np[b, :n])
        if self.want_logprobs:
          outlps[ridx].extend(float(v) for v in lps_np[b, :n])
        if not active_np[b]:
          finalize(ridx)
          slot_req[b] = None

    return results
