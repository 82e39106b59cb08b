"""Text generation with the PyTorch LM (automl_tpu/cli/generate_lm.py).

The model comes from a run directory that main_lm / run_lm wrote
(experiment_config.yaml + ckpt/<step>/state.pt: the latest step, or the one
--step names; only its params are read), from a directory holding
experiment_config.yaml and a params.npz of the JAX-layout parameter tree
(keys joined with '/'; no ckpt/, no steps), or from a named config with
seeded random weights. A line before the output says which was read. One
generate per prompt (greedy / sampled), or: length-penalised beam search
(--num_beams), speculative decoding with a small draft model's directory
(--draft_model_dir, read as --model_dir at its latest step), the
continuous-batching server over every prompt at once (--serve_slots, with
--prefill_chunk and a shared --system_prompt), each with int8 weights
(--int8, the draft's too).

Examples:
  python -m automl_tpu_torch.cli.main_lm --model_dir=/tmp/lm \
    --config_name=lm-test --device=cpu --train_steps=8 --ckpt_every=4
  python -m automl_tpu_torch.cli.generate_lm --model_dir=/tmp/lm \
    --device=cpu --prompt="Once upon a time" --max_new_tokens=16 --step=4
  python -m automl_tpu_torch.cli.generate_lm --config_name=lm-test \
    --device=cpu --prompt="hi" --max_new_tokens=8 --temperature=0.8 --top_k=40
  printf 'a\nb\n' | python -m automl_tpu_torch.cli.generate_lm \
    --config_name=lm-test --device=cpu --serve_slots=2 --system_prompt=sys

--tokenizer takes 'byte' or the path of a SentencePiece .model.

Sharded serving: --serve_mode=tp (heads: the head-leading KV cache and the
decode kernel on each rank's heads) or sp (the cache sharded over the
sequence, the kernel's partials merged), over a mesh (1, world / m, m) of
the world's processes with m = --mesh_model (0: all of them). Run one
process per card under torchrun (parallel/distributed.py initialize reads
its environment); one process is a mesh of one. The model is built on its
mesh, then the weights are copied in (whole on every rank). Only rank 0
prints.

  torchrun --nproc_per_node=2 -m automl_tpu_torch.cli.generate_lm \
    --config_name=lm-flops1e19 --serve_mode=tp --mesh_model=2 --prompt=hi

--model_dir and --draft_model_dir also take the JAX package's run
directories (experiment_config.yaml and ckpt/<step>/ of orbax, read by
ckpt/orbax.py without orbax or tensorstore).
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
from automl_tpu_torch.train import checkpoint


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  src = p.add_mutually_exclusive_group(required=True)
  src.add_argument("--model_dir",
                   help="run directory of main_lm / run_lm (experiment_"
                        "config.yaml + ckpt/), or experiment_config.yaml + "
                        "params.npz (a JAX-layout tree)")
  src.add_argument("--config_name",
                   help="named LM config (lm-test, lm-flops1e19, ...) with "
                        "seeded random weights")
  p.add_argument("--step", type=int, default=None,
                 help="checkpoint step of --model_dir's ckpt/ (default: "
                      "the latest)")
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
                 help="directory of a small draft model, read as "
                      "--model_dir at its latest step (the same "
                      "vocabulary): speculative decoding, token-exact "
                      "against plain decoding at temperature 0")
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
                 help="sharded serving over a 'model'-axis mesh: tp = heads "
                      "sharded (serve_tp), sp = the KV cache sharded over "
                      "the sequence (serve_sp). Pair with --mesh_model.")
  p.add_argument("--mesh_model", type=int, default=0,
                 help="'model' mesh-axis size for --serve_mode "
                      "(0 = every process)")
  return p.parse_args(argv)


def load_model(model_dir=None, config_name=None, seed: int = 0,
               device="cuda", serve_mode: str = "none", mesh=None,
               step=None):
  """(config, model) from a model_dir, or a named config with weights drawn
  from `seed` (convert.numpy_init). A model_dir with ckpt/ is a run
  directory of either package: the params of checkpoint step `step`
  (default: the latest; a state.pt or JAX's orbax step) are copied into
  the model (checkpoint.restore_params); without ckpt/ its
  params.npz is read (no steps: `step` raises a ValueError). serve_mode
  "tp" / "sp" sets serve_tp / serve_sp; mesh puts the model on a mesh (its
  weights replicated). Prints (rank 0) which weights were read."""
  tree = None
  if model_dir:
    config = Config({}).update(
        os.path.join(model_dir, "experiment_config.yaml"))
    ckpt = os.path.join(model_dir, "ckpt")
    npz = os.path.join(model_dir, "params.npz")
    if not os.path.isdir(ckpt) and os.path.exists(npz):
      if step is not None:
        raise ValueError(f"--step {step}: {model_dir} holds params.npz, "
                         "which has no steps (a run directory of main_lm "
                         "has ckpt/)")
      tree = convert.load_npz(npz)
      source = npz
  else:
    config = lm_lib.get_lm_config(config_name)
    tree = convert.numpy_init(config, seed)
    source = f"{config_name}, weights drawn from seed {seed}"
  if serve_mode != "none":
    config.override({f"serve_{serve_mode}": True}, allow_new_keys=True)
  model = lm_lib.TransformerLM(config, device=torch.device(device),
                               mesh=mesh)
  if tree is not None:
    convert.load_jax_params(model, tree)
  else:
    step = checkpoint.restore_params(
        ckpt, dict(model.named_parameters()), step,
        names=lm_lib.stacked_layers if model.stacked else None)
    source = f"{ckpt} at step {step}"
  from automl_tpu_torch.parallel.distributed import process_index
  if process_index() == 0:
    print(f"generate_lm: weights of {source}")
  return config, model


def serving_mesh(args, config):
  """The mesh (1, world / m, m) of --serve_mode, m = --mesh_model (0: the
  world), or None without --serve_mode. Refuses, as JAX does, a serve_tp
  whose heads do not split over m and an m that does not divide the
  world."""
  if args.serve_mode == "none":
    return None
  from automl_tpu_torch.parallel import distributed, create_mesh
  distributed.initialize()
  world = distributed.process_count()
  m = args.mesh_model or world
  if args.serve_mode == "tp" and (config.n_heads % m or
                                  config.n_kv_heads % m):
    raise ValueError(
        f"serve_tp: n_heads ({config.n_heads}) and n_kv_heads "
        f"({config.n_kv_heads}) must be divisible by mesh axis 'model' "
        f"size {m}")
  if world % m:
    raise ValueError(f"--mesh_model {m} does not divide the {world} "
                     "available devices")
  return create_mesh((1, world // m, m), device=torch.device(args.device).type)


def _check_flags(args):
  """The flags that do not compose."""
  if args.num_beams > 1 and (args.serve_slots or args.draft_model_dir
                             or args.stop or args.logprobs):
    raise ValueError("--num_beams > 1 runs standalone beam search; it does "
                     "not compose with --serve_slots, --draft_model_dir, "
                     "--stop or --logprobs")
  if args.step is not None and not args.model_dir:
    raise ValueError("--step picks a checkpoint of --model_dir")
  if args.draft_model_dir and (args.stop or args.logprobs):
    raise ValueError("--stop/--logprobs are not supported with "
                     "--draft_model_dir (speculative decoding verifies "
                     "whole chunks); drop one or the other")


def _serving_model(model_dir, config_name, args, serve_mode="none",
                   step=None):
  if serve_mode == "none":
    config, model = load_model(model_dir, config_name, args.seed,
                               args.device, step=step)
  else:
    config = (Config({}).update(os.path.join(model_dir,
                                             "experiment_config.yaml"))
              if model_dir else lm_lib.get_lm_config(config_name))
    mesh = serving_mesh(args, config)
    config, model = load_model(model_dir, config_name, args.seed,
                               args.device, serve_mode, mesh, step)
  if args.int8:
    lm_lib.quantize_lm_params(model)
  return config, lm_lib.cast_lm_params_for_serving(model)


def main(argv=None):
  args = parse_args(argv)
  _check_flags(args)
  tok = (lm_pipeline.ByteTokenizer() if args.tokenizer == "byte"
         else lm_pipeline.SentencePieceModel(args.tokenizer))
  config, model = _serving_model(args.model_dir, args.config_name, args,
                                 args.serve_mode, args.step)
  draft = (_serving_model(args.draft_model_dir, None, args)[1]
           if args.draft_model_dir else None)
  eos_id = lm_pipeline.EOS_ID if args.stop_at_eos else None
  from automl_tpu_torch.parallel.distributed import process_index
  say = print if process_index() == 0 else (lambda *a, **k: None)
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
      say(f"=== {text!r}\n{completion}")
      if args.logprobs:
        say("logprobs:", [round(v, 4) for v in res.logprobs])
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
    say(f"=== {text!r}\n{completion}")
    if lps is not None:
      say("logprobs:", [round(float(v), 4) for v in lps[0].tolist()])
  return outputs


if __name__ == "__main__":
  main()
