"""LM data pipeline: tokenize -> pack -> fixed-shape batches, numpy only.

The counterpart of automl_tpu/data/lm_pipeline.py: the byte tokenizer,
pack_documents and PackedLMLoader. Not ported yet: PrefixLMLoader and
pack_prefix_lm (ROADMAP M6), SentencePieceModel (M6), select_local_batch
(multi-process input, M10), the chat loss masks (M6).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

import numpy as np

PAD_ID = 0
EOS_ID = 1
BOS_ID = 2
_NUM_SPECIALS = 3


class ByteTokenizer:
  """Byte-level tokenizer: vocab = 3 specials + 256 byte values."""

  vocab_size = _NUM_SPECIALS + 256

  def encode(self, text: str) -> list[int]:
    return [b + _NUM_SPECIALS for b in text.encode("utf-8")]

  def decode(self, ids) -> str:
    # skip specials and ids beyond the byte range: a model with a larger
    # vocab can emit such ids, and decoding them must degrade, not crash
    data = bytes(int(i) - _NUM_SPECIALS for i in ids
                 if _NUM_SPECIALS <= int(i) < _NUM_SPECIALS + 256)
    return data.decode("utf-8", errors="replace")


def pack_documents(token_streams: Iterable[list[int]], seq_len: int,
                   add_bos: bool = True) -> Iterator[dict]:
  """Packs documents into [seq_len + 1] token rows.

  Documents are concatenated, each as [BOS] tokens [EOS]; rows carry
  `segment_ids` (one id per document, 0 on pad) so attention stays within a
  document, and `loss_weights` that are 0 on pad."""
  width = seq_len + 1
  buf: list[int] = []
  seg: list[int] = []
  seg_id = 1
  for doc in token_streams:
    tokens = ([BOS_ID] if add_bos else []) + list(doc) + [EOS_ID]
    buf.extend(tokens)
    seg.extend([seg_id] * len(tokens))
    seg_id += 1
    while len(buf) >= width:
      row, buf = buf[:width], buf[width:]
      row_seg, seg = seg[:width], seg[width:]
      yield {
          "tokens": np.asarray(row, np.int32),
          "segment_ids": np.asarray(row_seg, np.int32),
          "loss_weights": (np.asarray(row, np.int32) != PAD_ID).astype(
              np.float32),
      }
  if buf:
    pad = width - len(buf)
    row = np.asarray(buf + [PAD_ID] * pad, np.int32)
    row_seg = np.asarray(seg + [0] * pad, np.int32)
    yield {"tokens": row, "segment_ids": row_seg,
           "loss_weights": (row != PAD_ID).astype(np.float32)}


class PackedLMLoader:
  """Text documents -> packed {tokens, segment_ids, loss_weights} batches of
  [batch_size, seq_len + 1]. shard_index / num_shards pick every
  num_shards-th document. With repeat=False the last partial batch is
  filled with all-pad rows (loss weight 0) and the iteration ends."""

  def __init__(self, documents: Iterable[str], batch_size: int, seq_len: int,
               tokenizer=None, repeat: bool = True,
               shard_index: int = 0, num_shards: int = 1):
    self.documents = list(documents)
    self.batch_size = batch_size
    self.seq_len = seq_len
    self.tokenizer = tokenizer or ByteTokenizer()
    self.repeat = repeat
    self.shard_index = shard_index
    self.num_shards = num_shards

  @classmethod
  def from_text_file(cls, path: str, batch_size: int, seq_len: int,
                     separator: str = "\n\n", **kw):
    with open(path) as f:
      docs = [d for d in f.read().split(separator) if d.strip()]
    return cls(docs, batch_size, seq_len, **kw)

  def __iter__(self):
    def doc_tokens():
      docs = self.documents[self.shard_index::self.num_shards]
      epoch = itertools.cycle(docs) if self.repeat else iter(docs)
      for doc in epoch:
        yield self.tokenizer.encode(doc)

    rows = pack_documents(doc_tokens(), self.seq_len)
    while True:
      batch = list(itertools.islice(rows, self.batch_size))
      if len(batch) < self.batch_size:
        if batch and not self.repeat:
          width = self.seq_len + 1
          pad_row = {
              "tokens": np.full((width,), PAD_ID, np.int32),
              "segment_ids": np.zeros((width,), np.int32),
              "loss_weights": np.zeros((width,), np.float32),
          }
          batch += [pad_row] * (self.batch_size - len(batch))
          yield {k: np.stack([r[k] for r in batch]) for k in batch[0]}
        return
      yield {k: np.stack([r[k] for r in batch]) for k in batch[0]}
