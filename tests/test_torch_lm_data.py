"""automl_tpu_torch's LM input (prefix-LM packing, chat loss masks, the
SentencePiece reader) against automl_tpu's, on the CPU.

Every array is compared exactly (array-equal), and so are token ids,
decoded text and normalized text. The SentencePiece models are written by
the tests themselves (lm_pipeline.sentencepiece_model_proto, and a darts
double-array charsmap built here): no vocabulary file is read from outside
the repository. A prefix-LM training run goes through main_lm on the CPU.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automl_tpu.data import lm_pipeline as jdata
from automl_tpu.models import lm as jlm
from automl_tpu_torch import convert
from automl_tpu_torch.cli import generate_lm as tgen
from automl_tpu_torch.cli import main_lm as tcli
from automl_tpu_torch.data import lm_pipeline as tdata
from automl_tpu_torch.models import lm as tlm
from automl_tpu_torch.train import lm_trainer as ttrain

torch.set_num_threads(1)


def _examples(seed, n=12, v=300):
  rng = np.random.default_rng(seed)
  return [(rng.integers(3, v, rng.integers(0, 12)).tolist(),
           rng.integers(3, v, rng.integers(1, 15)).tolist())
          for _ in range(n)]


def _equal_rows(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      assert g[k].dtype == w[k].dtype, k
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --- prefix-LM ---------------------------------------------------------------


@pytest.mark.parametrize("add_bos", [True, False])
@pytest.mark.parametrize("seq_len", [16, 37])
def test_pack_prefix_lm_equals_jax(seq_len, add_bos):
  """Every row (tokens, segment_ids, causal_attention, loss_weights) and
  the padded tail array-equal to JAX's pack_prefix_lm."""
  ex = _examples(0)
  _equal_rows(tdata.pack_prefix_lm(iter(ex), seq_len, add_bos),
              jdata.pack_prefix_lm(iter(ex), seq_len, add_bos))


@pytest.mark.parametrize("repeat", [True, False])
def test_prefix_lm_loader_equals_jax(repeat):
  """Batches of PrefixLMLoader over text pairs (the byte tokenizer, two
  shards): the first 5 with repeat, all of them (the last padded) without."""
  rng = np.random.default_rng(1)
  words = ["alpha", "beta", "gamma", "délta", "ε", "zeta zeta"]
  pairs = [(" ".join(rng.choice(words, rng.integers(1, 4))),
            " ".join(rng.choice(words, rng.integers(1, 4))))
           for _ in range(23)]
  kw = dict(batch_size=3, seq_len=24, repeat=repeat, shard_index=1,
            num_shards=2)
  got = tdata.PrefixLMLoader(pairs, **kw)
  want = jdata.PrefixLMLoader(pairs, **kw)
  if repeat:
    it_g, it_w = iter(got), iter(want)
    got = [next(it_g) for _ in range(5)]
    want = [next(it_w) for _ in range(5)]
  _equal_rows(got, want)
  with pytest.raises(ValueError, match="no"):
    next(iter(tdata.PrefixLMLoader(pairs[:1], 2, 8, shard_index=1,
                                   num_shards=2)))


def test_prefix_lm_loader_reads_tsv_as_main_lm_does(tmp_path):
  """from_tsv_file takes `input<TAB>target` lines (the text after the
  first tab is the target; lines without a tab are skipped), as JAX's
  main_lm reads them."""
  path = tmp_path / "pairs.tsv"
  path.write_text("q1\ta1\nno tab here\nq2\ta2\tstill a2\n\nq3\t\n")
  got = list(tdata.PrefixLMLoader.from_tsv_file(str(path), 2, 12,
                                                repeat=False))
  want = list(jdata.PrefixLMLoader(
      [("q1", "a1"), ("q2", "a2\tstill a2"), ("q3", "")], 2, 12,
      repeat=False))
  _equal_rows(got, want)


@pytest.mark.parametrize("markers", [(7, 9), (9, 9)], ids=["two", "same"])
def test_chat_loss_masks_equal_jax(markers):
  """chat_loss_mask and add_chat_loss_mask array-equal to JAX's on rows
  with several turns, a turn left open, no marker at all, and (case
  'same') one id for both markers."""
  rng = np.random.default_rng(2)
  tokens = rng.integers(3, 12, (6, 40)).astype(np.int32)
  tokens[5] = 4                                  # no marker
  start, end = markers
  np.testing.assert_array_equal(tdata.chat_loss_mask(tokens, start, end),
                                jdata.chat_loss_mask(tokens, start, end))
  batch = {"tokens": tokens,
           "loss_weights": (rng.random((6, 40)) < 0.8).astype(np.float32)}
  got = tdata.add_chat_loss_mask(batch, start, end)
  want = jdata.add_chat_loss_mask(batch, start, end)
  _equal_rows([got], [want])
  assert got is not batch and "loss_weights" in batch


def test_prefix_lm_loss_and_grads_match_jax():
  """A packed prefix-LM batch (causal_attention markers, target-only loss
  weights) through the port's loss and grads against jax.value_and_grad of
  the JAX model on the same batch, with use_flash_attention on (the
  markers take the materialised mask in both): loss rtol 1e-5, every
  gradient leaf atol 1e-5, rtol 1e-4 (tests/test_torch_lm_train.py's)."""
  jcfg, tcfg = jlm.get_lm_config("lm-test"), tlm.get_lm_config("lm-test")
  for c in (jcfg, tcfg):
    c.override(dict(activation_dtype="float32", use_flash_attention=True))
  tree = convert.numpy_init(tcfg, 3)
  tmodel = convert.load_jax_params(tlm.TransformerLM(tcfg), tree)
  jmodel = jlm.TransformerLM(jcfg)
  rows = list(tdata.pack_prefix_lm(iter(_examples(4, n=20, v=384)), 64))[:2]
  batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
  b = {k: jnp.asarray(v) for k, v in batch.items()}

  def loss_fn(params):
    logits, _ = jmodel(params, b["tokens"][:, :-1],
                       segment_ids=b["segment_ids"][:, :-1],
                       causal_attention=b["causal_attention"][:, :-1])
    return jlm.lm_loss(logits, b["tokens"][:, 1:], b["loss_weights"][:, 1:])

  want_loss, want_grads = jax.value_and_grad(loss_fn)(
      jax.tree_util.tree_map(jnp.asarray, tree))
  loss, grads = ttrain.lm_loss_and_grads(
      tmodel, {k: torch.from_numpy(v) for k, v in batch.items()})
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
  got = convert.flatten_tree(convert.torch_to_jax_tree(grads))
  for path, w in convert.flatten_tree(want_grads).items():
    np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                               atol=1e-5, rtol=1e-4, err_msg=path)


# --- SentencePiece -----------------------------------------------------------


def _charsmap(mapping):
  """A NormalizerSpec precompiled_charsmap: {source: replacement} as a
  darts double-array trie over the sources' UTF-8 bytes (each node's
  children in a block of 256 units of its own) and a pool of
  NUL-terminated replacements."""
  pool, values = b"", {}
  for src, dst in mapping.items():
    values[src.encode("utf-8")] = len(pool)
    pool += dst.encode("utf-8") + b"\0"
  trie = {}
  for key, value in values.items():
    node = trie
    for c in key:
      node = node.setdefault(c, {})
    node[None] = value
  units = {}
  blocks = [0]

  def place(node, pos):
    """node's children go to a new block; units[pos] (the node's own unit,
    whose label is set by the parent) gets the offset and the leaf bit."""
    blocks[0] += 1
    base = blocks[0] * 256
    units[pos] = units.get(pos, 0) | ((pos ^ base) << 10) | (
        (1 << 8) if None in node else 0)
    if None in node:
      units[base] = node[None] | 0x80000000        # the leaf unit
    for c, child in node.items():
      if c is not None:
        units[base ^ c] = c
        place(child, base ^ c)

  place(trie, 0)
  image = np.zeros(max(units) + 1, "<u4")
  for pos, u in units.items():
    image[pos] = u
  return struct.pack("<I", image.nbytes) + image.tobytes() + pool


_SPECIALS = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<s>", 0.0, 3),
             ("<unk>", 0.0, 2)]
_BYTES = [(f"<0x{i:02X}>", 0.0, 6) for i in range(256)]
_WORDS = [("▁", -2.0, 1), ("▁the", -3.0, 1), ("▁th", -5.0, 1),
          ("e", -4.0, 1), ("t", -4.5, 1), ("h", -4.5, 1), ("▁fi", -4.0, 1),
          ("sh", -4.2, 1), ("fish", -6.0, 1), ("▁a", -3.5, 1),
          ("b", -5.0, 1), ("c", -5.0, 1), ("é", -6.0, 1), ("▁é", -5.5, 1),
          ("s", -5.0, 1), ("i", -5.0, 1), ("f", -5.0, 1), ("a", -5.0, 1)]
_USER = [("<tool>", 0.0, 4), ("[[x]]", 0.0, 4)]
_CHARSMAP = {"ｈ": "h", "ﬁ": "fi", "​": " ", "Ａ": "A", "é": "é",
             "\t": " ", "ÅÅ": "aa"}

MODELS = {
    "identity_bytes_user": dict(pieces=_SPECIALS + _BYTES + _WORDS + _USER),
    "nmt_nfkc_charsmap": dict(pieces=_SPECIALS + _BYTES + _WORDS + _USER,
                              normalizer_name="nmt_nfkc",
                              charsmap=_charsmap(_CHARSMAP)),
    "nfkc_no_charsmap_unk": dict(pieces=_SPECIALS + _WORDS,
                                 normalizer_name="nmt_nfkc"),
    "no_dummy_no_escape": dict(pieces=_SPECIALS + _BYTES + _WORDS,
                               add_dummy_prefix=False,
                               remove_extra_whitespaces=False,
                               escape_whitespaces=False),
}
TEXTS = ["the fish", "  the   fish  ", "ｈe ﬁsh​the", "abc é é",
         "Ａb\tc", "ÅÅ ÅÅÅ", "日本 the", "<tool>the[[x]] <tool>", "", "   ",
         "x y", "ﬁ"]


def _spm(tmp_path, name):
  path = tmp_path / f"{name}.model"
  path.write_bytes(tdata.sentencepiece_model_proto(**MODELS[name]))
  return str(path)


@pytest.mark.parametrize("name", list(MODELS))
def test_sentencepiece_equals_jax(tmp_path, name):
  """Every text's _normalize, encode ids and decode equal to JAX's
  SentencePieceModel on the same file, exactly; the special ids and the
  vocabulary size too. The charsmap case rewrites through the trie built
  here (fullwidth letters, a ligature, zero-width space, a combining
  accent, a two-character key), the byte pieces take characters no piece
  covers, the model without them the unknown piece."""
  path = _spm(tmp_path, name)
  got, want = tdata.SentencePieceModel(path), jdata.SentencePieceModel(path)
  for attr in ("vocab_size", "eos_id", "pad_id", "unk_id",
               "normalizer_name", "add_dummy_prefix",
               "remove_extra_whitespaces", "escape_whitespaces"):
    assert getattr(got, attr) == getattr(want, attr), attr
  for text in TEXTS:
    assert got._normalize(text) == want._normalize(text), text
    ids = got.encode(text)
    assert ids == want.encode(text), text
    assert got.decode(ids) == want.decode(ids), text
  if name == "nmt_nfkc_charsmap":
    assert got._normalize("ｈe ﬁsh​the") == "▁he▁fish▁the"
    assert got._charsmap.longest_match("ÅÅÅ".encode(), 0) == (4, "aa")
  if name == "identity_bytes_user":
    ids = got.encode("<tool>日")
    assert got.pieces[ids[1]] == "<tool>" and all(
        got.types[i] == 6 for i in ids[2:])
    assert got.decode(ids) == "<tool>日"


def test_sentencepiece_dummy_prefix_override(tmp_path):
  """add_dummy_prefix passed to the constructor wins over the spec's, in
  both packages."""
  path = _spm(tmp_path, "identity_bytes_user")
  for flag in (True, False):
    got = tdata.SentencePieceModel(path, add_dummy_prefix=flag)
    want = jdata.SentencePieceModel(path, add_dummy_prefix=flag)
    assert got.encode("the fish") == want.encode("the fish")


def test_main_lm_prefix_lm_with_sentencepiece_trains_on_cpu(tmp_path):
  """main_lm --prefix_lm --tokenizer=<model> from TSV files on the CPU:
  the vocabulary grows to max(config, tokenizer) as in JAX (lm-test's 384
  against the model's 282: 384), 6 steps log finite losses, the
  validation runs, and the config file records the prefix-LM run's
  vocabulary."""
  path = _spm(tmp_path, "nmt_nfkc_charsmap")
  rng = np.random.default_rng(5)
  words = ["the", "fish", "a", "bé", "ﬁsh", "cabs", "<tool>"]
  lines = [" ".join(rng.choice(words, 3)) + "\t" + " ".join(
      rng.choice(words, 2)) for _ in range(40)]
  (tmp_path / "train.tsv").write_text("\n".join(lines[:30]) + "\n")
  (tmp_path / "valid.tsv").write_text("\n".join(lines[30:]) + "\n")
  model_dir = tmp_path / "run"
  logs = tcli.main([f"--model_dir={model_dir}", "--config_name=lm-test",
                    "--device=cpu", "--prefix_lm", f"--tokenizer={path}",
                    f"--train_file={tmp_path / 'train.tsv'}",
                    f"--valid_file={tmp_path / 'valid.tsv'}",
                    "--train_steps=6", "--eval_every=6", "--eval_steps=2",
                    "--log_every=1", "--warmup_steps=1"])
  recs = [json.loads(l) for l in (model_dir / "metrics.jsonl").read_text()
          .splitlines()]
  losses = [r["loss"] for r in recs if "loss" in r]
  assert len(losses) == 6 and np.all(np.isfinite(losses))
  assert np.isfinite(logs["validation_loss"])
  assert "vocab_size: 384" in (model_dir / "experiment_config.yaml"
                               ).read_text()


def test_generate_lm_with_a_sentencepiece_tokenizer(tmp_path, capsys):
  """generate_lm --tokenizer=<model>: the prompt is encoded and the
  completion decoded by the SentencePiece model (lm-test's vocabulary
  holds its 282 ids)."""
  path = _spm(tmp_path, "identity_bytes_user")
  out = tgen.main(["--config_name=lm-test", "--device=cpu",
                   "--prompt=the fish", f"--tokenizer={path}",
                   "--max_new_tokens=4"])
  assert len(out) == 1 and isinstance(out[0], str)
  assert "=== 'the fish'" in capsys.readouterr().out
