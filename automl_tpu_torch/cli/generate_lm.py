"""Text generation with the PyTorch LM (automl_tpu/cli/generate_lm.py).

The model comes from a directory holding experiment_config.yaml and a
params.npz of the JAX-layout parameter tree (keys joined with '/'), or from
a named config with seeded random weights. One generate per prompt
(greedy / sampled), or: length-penalised beam search (--num_beams),
speculative decoding with a draft model directory (--draft_model_dir), the
continuous-batching server over every prompt at once (--serve_slots, with
--prefill_chunk and a shared --system_prompt), each with int8 weights
(--int8).

Examples:
  python -m automl_tpu_torch.cli.generate_lm --model_dir=/tmp/lm \
    --prompt="Once upon a time" --max_new_tokens=128
  python -m automl_tpu_torch.cli.generate_lm --config_name=lm-test \
    --device=cpu --prompt="hi" --max_new_tokens=8 --temperature=0.8 --top_k=40
  printf 'a\nb\n' | python -m automl_tpu_torch.cli.generate_lm \
    --config_name=lm-test --device=cpu --serve_slots=2 --system_prompt=sys

--tokenizer takes 'byte' or the path of a SentencePiece .model.

Not ported yet: restoring an orbax checkpoint (it needs jax; ROADMAP M9)
and sharded serving (--serve_mode, --mesh_model; ROADMAP M10).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from automl_tpu_torch import convert
from automl_tpu_torch.config import Config
from automl_tpu_torch.data import lm_pipeline
from automl_tpu_torch.inference.lm_server import GenRequest, LMServer
from automl_tpu_torch.models import lm as lm_lib
from automl_tpu_torch.models.beam import beam_search_generate
from automl_tpu_torch.models.speculative import speculative_generate


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  src = p.add_mutually_exclusive_group(required=True)
  src.add_argument("--model_dir",
                   help="directory with experiment_config.yaml + params.npz")
  src.add_argument("--config_name",
                   help="named LM config (lm-test, lm-flops1e19, ...) with "
                        "seeded random weights")
  p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
  p.add_argument("--prompt", default=None,
                 help="prompt text; default: one prompt per stdin line")
  p.add_argument("--max_new_tokens", type=int, default=128)
  p.add_argument("--temperature", type=float, default=0.0,
                 help="0 = greedy")
  p.add_argument("--top_k", type=int, default=0)
  p.add_argument("--top_p", type=float, default=0.0)
  p.add_argument("--stop_at_eos", action="store_true",
                 help="stop decoding once every row emitted EOS")
  p.add_argument("--stop", action="append", default=None,
                 help="stop text (repeatable): generation ends once the "
                      "output ends with a stop's tokens (kept in the output)")
  p.add_argument("--logprobs", action="store_true",
                 help="print each generated token's log-probability")
  p.add_argument("--seed", type=int, default=0,
                 help="weights seed for --config_name, and sampling seed")
  p.add_argument("--tokenizer", default="byte",
                 help="'byte' or the path of a SentencePiece .model")
  p.add_argument("--int8", action="store_true",
                 help="serve with int8 weights (quantize_lm_params)")
  p.add_argument("--draft_model_dir", default=None,
                 help="directory of a small draft model (experiment_config."
                      "yaml + params.npz, the same vocabulary): speculative "
                      "decoding, token-exact against plain decoding at "
                      "temperature 0")
  p.add_argument("--n_draft", type=int, default=4,
                 help="drafted tokens per speculative iteration")
  p.add_argument("--num_beams", type=int, default=1,
                 help="> 1: length-penalised beam search (the sampling "
                      "flags are ignored; not with --serve_slots, "
                      "--draft_model_dir, --stop or --logprobs)")
  p.add_argument("--length_penalty", type=float, default=0.6,
                 help="GNMT length normalisation exponent for --num_beams")
  p.add_argument("--serve_slots", type=int, default=0,
                 help="N > 0: every prompt through the continuous-batching "
                      "server (N decode slots over one KV cache)")
  p.add_argument("--prefill_chunk", type=int, default=0,
                 help="with --serve_slots: prompts longer than this prefill "
                      "in chunks between decode bursts (0 = whole prompts)")
  p.add_argument("--system_prompt", default=None,
                 help="with --serve_slots: a shared prefix put before every "
                      "prompt, its K/V computed once (prefix caching)")
  p.add_argument("--serve_mode", choices=["none", "tp", "sp"],
                 default="none",
                 help="sharded serving: not ported yet (ROADMAP M10)")
  p.add_argument("--mesh_model", type=int, default=0,
                 help="'model' mesh axis for --serve_mode: not ported yet "
                      "(ROADMAP M10)")
  return p.parse_args(argv)


def load_model(model_dir=None, config_name=None, seed: int = 0,
               device="cuda"):
  """(config, model) from a model_dir, or a named config with weights drawn
  from `seed`; either way the JAX-layout tree goes through convert."""
  if model_dir:
    config = Config({}).update(
        os.path.join(model_dir, "experiment_config.yaml"))
    tree = convert.load_npz(os.path.join(model_dir, "params.npz"))
  else:
    config = lm_lib.get_lm_config(config_name)
    tree = convert.numpy_init(config, seed)
  model = lm_lib.TransformerLM(config, device=torch.device(device))
  convert.load_jax_params(model, tree)
  return config, model


def _check_flags(args):
  """The flags that do not compose, and those not ported yet."""
  if args.serve_mode != "none" or args.mesh_model:
    raise NotImplementedError(
        "sharded serving (--serve_mode, --mesh_model) is not ported to "
        "automl_tpu_torch yet: ROADMAP M10")
  if args.num_beams > 1 and (args.serve_slots or args.draft_model_dir
                             or args.stop or args.logprobs):
    raise ValueError("--num_beams > 1 runs standalone beam search; it does "
                     "not compose with --serve_slots, --draft_model_dir, "
                     "--stop or --logprobs")
  if args.draft_model_dir and (args.stop or args.logprobs):
    raise ValueError("--stop/--logprobs are not supported with "
                     "--draft_model_dir (speculative decoding verifies "
                     "whole chunks); drop one or the other")


def _serving_model(model_dir, config_name, args):
  config, model = load_model(model_dir, config_name, args.seed, args.device)
  if args.int8:
    lm_lib.quantize_lm_params(model)
  return config, lm_lib.cast_lm_params_for_serving(model)


def main(argv=None):
  args = parse_args(argv)
  _check_flags(args)
  tok = (lm_pipeline.ByteTokenizer() if args.tokenizer == "byte"
         else lm_pipeline.SentencePieceModel(args.tokenizer))
  config, model = _serving_model(args.model_dir, args.config_name, args)
  draft = (_serving_model(args.draft_model_dir, None, args)[1]
           if args.draft_model_dir else None)
  eos_id = lm_pipeline.EOS_ID if args.stop_at_eos else None
  prompts = ([args.prompt] if args.prompt is not None
             else [ln.rstrip("\n") for ln in sys.stdin if ln.strip()])
  stops = [tok.encode(t) for t in args.stop] if args.stop else None
  outputs = []
  if args.serve_slots > 0:
    server = LMServer(
        model, max_batch=args.serve_slots, max_seq_len=int(config.seq_len),
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed, eos_id=eos_id, stop_sequences=stops,
        want_logprobs=args.logprobs, prefill_chunk=args.prefill_chunk or None)
    reqs = [GenRequest(tok.encode(t), args.max_new_tokens) for t in prompts]
    prefix = (tok.encode(args.system_prompt) if args.system_prompt
              else None)
    for text, res in zip(prompts, server.serve(reqs, shared_prefix=prefix)):
      completion = tok.decode(res.tokens)
      outputs.append(completion)
      print(f"=== {text!r}\n{completion}")
      if args.logprobs:
        print("logprobs:", [round(v, 4) for v in res.logprobs])
    return outputs
  for i, text in enumerate(prompts):
    ids = tok.encode(text)
    prompt = torch.tensor([ids], dtype=torch.int64, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + i)
    lps = None
    if args.num_beams > 1:
      out, _ = beam_search_generate(
          model, prompt, args.max_new_tokens, num_beams=args.num_beams,
          length_penalty=args.length_penalty, eos_id=eos_id)
    elif draft is not None:
      out = speculative_generate(
          model, draft, prompt, args.max_new_tokens, n_draft=args.n_draft,
          generator=gen, temperature=args.temperature, top_k=args.top_k,
          top_p=args.top_p, eos_id=eos_id)
    else:
      out = lm_lib.greedy_generate(
          model, prompt, args.max_new_tokens, generator=gen,
          temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
          eos_id=eos_id, return_logprobs=args.logprobs, stop_sequences=stops)
      if args.logprobs:
        out, lps = out
    new_ids = out[0, len(ids):].tolist()
    if eos_id is not None or stops:
      # Finished rows emit pad (0) after the eos/stop: cut at the first
      # match, not at the zeros (a row may legitimately emit token 0).
      seq = ids + new_ids
      for j in range(len(new_ids)):
        end = len(ids) + j + 1
        at_eos = eos_id is not None and new_ids[j] == eos_id
        at_stop = stops and any(end >= len(s) and seq[end - len(s):end] == s
                                for s in stops)
        if at_eos or at_stop:
          new_ids = new_ids[:j + 1]
          break
    completion = tok.decode(new_ids)
    outputs.append(completion)
    print(f"=== {text!r}\n{completion}")
    if lps is not None:
      print("logprobs:", [round(float(v), 4) for v in lps[0].tolist()])
  return outputs


if __name__ == "__main__":
  main()
