"""LM data pipeline: tokenize -> pack -> fixed-shape batches, numpy only.

The counterpart of automl_tpu/data/lm_pipeline.py: the byte tokenizer,
pack_documents and PackedLMLoader, the prefix-LM packing (pack_prefix_lm,
PrefixLMLoader), the SentencePiece reader (SentencePieceModel, which parses
the ModelProto itself: no protobuf or sentencepiece import) and the chat
loss masks. sentencepiece_model_proto writes a unigram ModelProto from
pieces made in code. Not ported yet: select_local_batch (multi-process
input, ROADMAP M10).
"""

from __future__ import annotations

import itertools
import struct
import unicodedata
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


def pack_prefix_lm(example_streams, seq_len: int,
                   add_bos: bool = True) -> Iterator[dict]:
  """Packs (input_ids, target_ids) examples into [seq_len + 1] prefix-LM rows.

  Each example becomes [BOS] inputs targets [EOS]. Rows carry, besides
  tokens and segment_ids, `causal_attention` (1 on the BOS + inputs
  prefix: the model lets those positions attend each other both ways,
  targets stay causal) and `loss_weights`, non-zero only on target tokens
  and EOS, never on the prefix or pad."""
  width = seq_len + 1
  buf: list[int] = []
  seg: list[int] = []
  pref: list[int] = []
  wts: list[float] = []
  seg_id = 1

  def emit(row, row_seg, row_pref, row_wts):
    tokens = np.asarray(row, np.int32)
    # The trainer takes weights[:, 1:]: the weight of token t + 1 is that
    # of predicting it.
    return {
        "tokens": tokens,
        "segment_ids": np.asarray(row_seg, np.int32),
        "causal_attention": np.asarray(row_pref, np.int32),
        "loss_weights": (np.asarray(row_wts, np.float32)
                         * (tokens != PAD_ID)),
    }

  for inputs, targets in example_streams:
    head = ([BOS_ID] if add_bos else []) + list(inputs)
    tail = list(targets) + [EOS_ID]
    buf.extend(head + tail)
    seg.extend([seg_id] * (len(head) + len(tail)))
    pref.extend([1] * len(head) + [0] * len(tail))
    wts.extend([0.0] * len(head) + [1.0] * len(tail))
    seg_id += 1
    while len(buf) >= width:
      yield emit(buf[:width], seg[:width], pref[:width], wts[:width])
      buf, seg = buf[width:], seg[width:]
      pref, wts = pref[width:], wts[width:]
  if buf:
    pad = width - len(buf)
    yield emit(buf + [PAD_ID] * pad, seg + [0] * pad, pref + [0] * pad,
               wts + [0.0] * pad)


class PrefixLMLoader:
  """(input_text, target_text) pairs -> packed prefix-LM batches {tokens,
  segment_ids, causal_attention, loss_weights} of [batch_size,
  seq_len + 1] (pack_prefix_lm). shard_index / num_shards pick every
  num_shards-th pair; repeat=False pads the last batch and ends."""

  def __init__(self, pairs, batch_size: int, seq_len: int, tokenizer=None,
               repeat: bool = True, shard_index: int = 0,
               num_shards: int = 1):
    self.pairs = list(pairs)
    self.batch_size = batch_size
    self.seq_len = seq_len
    self.tokenizer = tokenizer or ByteTokenizer()
    self.repeat = repeat
    self.shard_index = shard_index
    self.num_shards = num_shards

  @classmethod
  def from_tsv_file(cls, path: str, batch_size: int, seq_len: int, **kw):
    """Lines `input<TAB>target` (lines without a tab are skipped), as
    main_lm --prefix_lm reads --train_file / --valid_file."""
    with open(path) as f:
      pairs = [tuple(l.split("\t", 1)) for l in f.read().splitlines()
               if "\t" in l]
    return cls(pairs, batch_size, seq_len, **kw)

  def __iter__(self):
    def examples():
      mine = self.pairs[self.shard_index::self.num_shards]
      if not mine:
        raise ValueError("PrefixLMLoader: no (input, target) pairs for "
                         f"shard {self.shard_index}/{self.num_shards}")
      epoch = itertools.cycle(mine) if self.repeat else iter(mine)
      for inp, tgt in epoch:
        yield (self.tokenizer.encode(inp), self.tokenizer.encode(tgt))

    rows = pack_prefix_lm(examples(), self.seq_len)
    width = self.seq_len + 1
    pad_row = {
        "tokens": np.full((width,), PAD_ID, np.int32),
        "segment_ids": np.zeros((width,), np.int32),
        "causal_attention": np.zeros((width,), np.int32),
        "loss_weights": np.zeros((width,), np.float32),
    }
    while True:
      batch = list(itertools.islice(rows, self.batch_size))
      if len(batch) < self.batch_size:
        if batch and not self.repeat:
          batch += [pad_row] * (self.batch_size - len(batch))
          yield {k: np.stack([r[k] for r in batch]) for k in batch[0]}
        if not self.repeat:
          return
        continue
      yield {k: np.stack([r[k] for r in batch]) for k in batch[0]}


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


# ---------------------------------------------------------------------------
# SentencePiece: the .model reader and the unigram encoder.
#
# The serialized ModelProto is parsed by hand (protobuf wire format), and
# encoding is the unigram Viterbi segmentation over the piece scores. The
# normalization follows sentencepiece's normalizer.cc: the NormalizerSpec's
# precompiled charsmap (a darts_clone double-array trie over UTF-8 byte
# sequences and a pool of replacement strings) applied by longest match,
# with its dummy-prefix, extra-whitespace and whitespace-escape rules.
# ---------------------------------------------------------------------------

_PIECE_NORMAL = 1
_PIECE_UNKNOWN = 2
_PIECE_CONTROL = 3
_PIECE_USER_DEFINED = 4
_PIECE_BYTE = 6
_WS = "▁"  # SentencePiece's whitespace marker


class _CharsMapTrie:
  """The darts double-array trie of a NormalizerSpec precompiled_charsmap.

  The blob: a little-endian uint32 byte size of the trie image, the image
  (uint32 units), then a pool of NUL-terminated UTF-8 replacements. A unit
  u holds offset (u >> 10) << ((u & 0x200) >> 6), label u & 0x800000FF,
  has_leaf (u >> 8) & 1, and a leaf unit the value u & 0x7FFFFFFF (an
  offset into the pool)."""

  def __init__(self, blob: bytes):
    tsz = struct.unpack("<I", blob[:4])[0]
    self._units = np.frombuffer(blob[4:4 + tsz], dtype="<u4")
    self._pool = blob[4 + tsz:]

  def longest_match(self, data: bytes, start: int = 0):
    """The longest key matching data[start:]: (bytes matched, replacement),
    or None."""
    units = self._units
    unit = int(units[0])
    node_pos = (unit >> 10) << ((unit & 0x200) >> 6)
    best = None
    for i in range(start, len(data)):
      c = data[i]
      p = node_pos ^ c
      if p >= len(units):
        break
      unit = int(units[p])
      if (unit & 0x800000FF) != c:
        break
      node_pos = p ^ ((unit >> 10) << ((unit & 0x200) >> 6))
      if (unit >> 8) & 1:
        best = (i + 1 - start, int(units[node_pos]) & 0x7FFFFFFF)
    if best is None:
      return None
    length, v = best
    end = self._pool.index(b"\0", v)
    return length, self._pool[v:end].decode("utf-8")


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _iter_fields(buf: bytes):
  """(field number, wire type, value) of each field of a message body."""
  pos = 0
  n = len(buf)
  while pos < n:
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:           # varint
      value, pos = _read_varint(buf, pos)
    elif wire == 1:         # 64-bit
      value, pos = buf[pos:pos + 8], pos + 8
    elif wire == 2:         # length-delimited
      size, pos = _read_varint(buf, pos)
      value, pos = buf[pos:pos + size], pos + size
    elif wire == 5:         # 32-bit
      value, pos = buf[pos:pos + 4], pos + 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, value


class SentencePieceModel:
  """A unigram SentencePiece tokenizer read from a serialized .model file.

  encode(): the model's NormalizerSpec normalization, then the Viterbi
  segmentation of the largest summed piece score, with byte fallback for
  characters no piece covers when the model has <0xNN> byte pieces (else
  the unknown piece). decode() inverts it. vocab_size, eos_id, pad_id and
  unk_id come from the pieces."""

  def __init__(self, model_path: str, add_dummy_prefix: bool | None = None):
    with open(model_path, "rb") as f:
      blob = f.read()
    self.pieces: list[str] = []
    self.scores: list[float] = []
    self.types: list[int] = []
    # NormalizerSpec (ModelProto field 3); its proto2 defaults are all true.
    self.normalizer_name = "nmt_nfkc"
    self.remove_extra_whitespaces = True
    self.escape_whitespaces = True
    spec_dummy_prefix = True
    charsmap = b""
    for field, wire, value in _iter_fields(blob):
      if field == 1 and wire == 2:  # repeated SentencePiece
        piece, score, ptype = "", 0.0, _PIECE_NORMAL
        for f2, _, v2 in _iter_fields(value):
          if f2 == 1:
            piece = v2.decode("utf-8")
          elif f2 == 2:
            score = struct.unpack("<f", v2)[0]
          elif f2 == 3:
            ptype = v2
        self.pieces.append(piece)
        self.scores.append(score)
        self.types.append(ptype)
      elif field == 3 and wire == 2:  # NormalizerSpec
        for f2, _, v2 in _iter_fields(value):
          if f2 == 1:
            self.normalizer_name = v2.decode("utf-8")
          elif f2 == 2:
            charsmap = v2
          elif f2 == 3:
            spec_dummy_prefix = bool(v2)
          elif f2 == 4:
            self.remove_extra_whitespaces = bool(v2)
          elif f2 == 5:
            self.escape_whitespaces = bool(v2)
    self.vocab_size = len(self.pieces)
    self._charsmap = _CharsMapTrie(charsmap) if len(charsmap) > 4 else None
    self.add_dummy_prefix = (spec_dummy_prefix if add_dummy_prefix is None
                             else add_dummy_prefix)
    # User-defined pieces pass through unnormalized, the longest first.
    self._user_defined = sorted(
        (p.encode("utf-8") for p, t in zip(self.pieces, self.types)
         if t == _PIECE_USER_DEFINED), key=len, reverse=True)
    self._index = {}
    self._byte_ids = {}
    self.unk_id = 0
    self._max_piece_len = 1
    for i, (p, t) in enumerate(zip(self.pieces, self.types)):
      if t == _PIECE_UNKNOWN:
        self.unk_id = i
      elif t == _PIECE_BYTE:
        self._byte_ids[int(p[1:-1], 16)] = i  # "<0xNN>"
      elif t in (_PIECE_NORMAL, _PIECE_USER_DEFINED):
        self._index[p] = i
        self._max_piece_len = max(self._max_piece_len, len(p))
    self.eos_id = next((i for i, p in enumerate(self.pieces)
                        if p == "</s>"), EOS_ID)
    self.pad_id = next((i for i, p in enumerate(self.pieces)
                        if p == "<pad>"), PAD_ID)

  def _normalize_prefix(self, data: bytes, i: int) -> tuple[str, int]:
    """One normalization step at byte offset i: (replacement, bytes used).
    A user-defined piece verbatim, else the charsmap's longest match, else
    one UTF-8 character as it is (a malformed byte becomes U+FFFD)."""
    for u in self._user_defined:
      if data.startswith(u, i):
        return u.decode("utf-8"), len(u)
    if self._charsmap is not None:
      m = self._charsmap.longest_match(data, i)
      if m is not None:
        return m[1], m[0]
    b0 = data[i]
    n = 1 if b0 < 0xC0 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
    try:
      return data[i:i + n].decode("utf-8"), n
    except UnicodeDecodeError:
      return "�", 1

  def _normalize(self, text: str) -> str:
    """The charsmap rewriting and the spec's dummy-prefix, extra-whitespace
    and whitespace-escape rules. A model without a charsmap: 'identity'
    passes the text through, any other normalizer name takes NFKC."""
    if self._charsmap is None and self.normalizer_name != "identity":
      text = unicodedata.normalize("NFKC", text)
    data = text.encode("utf-8")
    n = len(data)
    i = 0
    if self.remove_extra_whitespaces:  # leading spaces
      while i < n:
        sp, consumed = self._normalize_prefix(data, i)
        if sp != " ":
          break
        i += consumed
    if i == n:
      return ""
    ws = _WS if self.escape_whitespaces else " "
    out: list[str] = []
    if self.add_dummy_prefix:
      out.append(ws)
    is_prev_space = self.remove_extra_whitespaces
    while i < n:
      sp, consumed = self._normalize_prefix(data, i)
      if is_prev_space:
        sp = sp.lstrip(" ")
      if sp:
        out.append(sp.replace(" ", ws) if self.escape_whitespaces else sp)
        is_prev_space = sp.endswith(" ")
      i += consumed
      if not self.remove_extra_whitespaces:
        is_prev_space = False
    s = "".join(out)
    if self.remove_extra_whitespaces:  # trailing spaces
      while s.endswith(ws):
        s = s[:-len(ws)]
    return s

  def encode(self, text: str) -> list[int]:
    s = self._normalize(text)
    n = len(s)
    neg = -1e18
    # Viterbi over character positions: best[i] is the largest score of a
    # segmentation of s[:i], back[i] the (start, piece id) of its last piece.
    best = [neg] * (n + 1)
    best[0] = 0.0
    back: list = [None] * (n + 1)
    for i in range(n):
      if best[i] <= neg:
        continue
      for l in range(1, min(self._max_piece_len, n - i) + 1):
        pid = self._index.get(s[i:i + l])
        if pid is None:
          continue
        cand = best[i] + self.scores[pid]
        if cand > best[i + l]:
          best[i + l] = cand
          back[i + l] = (i, pid)
      if back[i + 1] is None:
        # No piece of one character: its bytes (or the unknown piece),
        # scored low enough that any real piece wins.
        ch = s[i].encode("utf-8")
        ids = (tuple(self._byte_ids[b] for b in ch) if self._byte_ids
               else (self.unk_id,))
        cand = best[i] + sum(self.scores[j] for j in ids) - 100.0 * len(ids)
        if cand > best[i + 1]:
          best[i + 1] = cand
          back[i + 1] = (i, ids)
    out: list[int] = []
    i = n
    while i > 0:
      start, pid = back[i]
      if isinstance(pid, tuple):
        out.extend(reversed(pid))
      else:
        out.append(pid)
      i = start
    return out[::-1]

  def decode(self, ids) -> str:
    parts: list[bytes] = []
    for i in ids:
      i = int(i)
      t = self.types[i]
      if t in (_PIECE_UNKNOWN, _PIECE_CONTROL):
        continue
      if t == _PIECE_BYTE:
        parts.append(bytes([int(self.pieces[i][1:-1], 16)]))
      else:
        parts.append(self.pieces[i].encode("utf-8"))
    text = b"".join(parts).decode("utf-8", errors="replace")
    text = text.replace(_WS, " ")
    return text[1:] if text.startswith(" ") else text


def _varint(n: int) -> bytes:
  out = bytearray()
  while True:
    b = n & 0x7F
    n >>= 7
    if n:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _field(number: int, value) -> bytes:
  """One protobuf field: bytes / str length-delimited, float 32-bit, int
  (or bool) varint."""
  if isinstance(value, (bytes, str)):
    data = value.encode("utf-8") if isinstance(value, str) else value
    return _varint(number << 3 | 2) + _varint(len(data)) + data
  if isinstance(value, float):
    return _varint(number << 3 | 5) + struct.pack("<f", value)
  return _varint(number << 3) + _varint(int(value))


def sentencepiece_model_proto(pieces, normalizer_name: str = "identity",
                              charsmap: bytes = b"",
                              add_dummy_prefix: bool = True,
                              remove_extra_whitespaces: bool = True,
                              escape_whitespaces: bool = True) -> bytes:
  """A serialized ModelProto with the fields SentencePieceModel reads:
  pieces [(piece, score, type)] (type 1 normal, 2 unknown, 3 control, 4
  user-defined, 6 byte, as in sentencepiece_model.proto) and a
  NormalizerSpec. For vocabularies made in code (tests, chip_smoke.py);
  sentencepiece's own trainer writes such files too."""
  blob = b"".join(
      _field(1, _field(1, p) + _field(2, float(score)) + _field(3, t))
      for p, score, t in pieces)
  spec = (_field(1, normalizer_name)
          + (_field(2, charsmap) if charsmap else b"")
          + _field(3, add_dummy_prefix) + _field(4, remove_extra_whitespaces)
          + _field(5, escape_whitespaces))
  return blob + _field(3, spec)


# ---------------------------------------------------------------------------
# Chat loss masks.
# ---------------------------------------------------------------------------


def chat_loss_mask(token_ids: np.ndarray, mask_start_id: int,
                   mask_end_id: int) -> np.ndarray:
  """[B, T] 0/1 weights: 1 on the tokens strictly after a mask_start_id
  marker up to and including the next mask_end_id (training on assistant
  turns only). Each position takes the state before its own token, so the
  start marker itself has weight 0 and the end marker weight 1."""
  token_ids = np.asarray(token_ids)
  b, t = token_ids.shape
  marker = np.where(token_ids == mask_start_id, 1,
                    np.where(token_ids == mask_end_id, 0, -1))  # [B, T]
  idx = np.where(marker >= 0, np.arange(t)[None, :], -1)
  last = np.maximum.accumulate(idx, axis=1)       # the last marker at <= t
  state = np.where(last >= 0,
                   np.take_along_axis(marker, np.maximum(last, 0), axis=1),
                   0)                             # the state at position t
  out = np.zeros((b, t), np.float32)
  out[:, 1:] = state[:, :-1]
  return out


def add_chat_loss_mask(batch: dict, mask_start_id: int,
                       mask_end_id: int) -> dict:
  """The batch with loss_weights multiplied by chat_loss_mask(tokens)."""
  batch = dict(batch)
  batch["loss_weights"] = (
      chat_loss_mask(batch["tokens"], mask_start_id, mask_end_id)
      * batch["loss_weights"])
  return batch
