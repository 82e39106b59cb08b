"""The port's Zstandard decoder (csrc/host/zstd.cc through ckpt/zstd.py)
against the zstandard package on the CPU.

Every frame that zstandard writes (levels -5, 1, 3 and 19; with and
without a checksum and a content size; one-shot and streamed in several
blocks; empty, small, multi-block and random inputs; hypothesis-drawn
inputs) decodes to the same bytes. Concatenated and skippable frames are
taken in turn. Truncated and corrupted frames, a bad checksum and a frame
that needs a dictionary raise ValueError and never crash the process. The
raw-block frames the writer makes are read back by zstandard, and the
unmasked CRC32C equals the standard check value.
"""

import os

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from automl_tpu_torch.ckpt import zstd

LEVELS = [-5, 1, 3, 19]


def _inputs():
  rng = np.random.default_rng(0)
  text = open(os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "README.md"), "rb").read()
  words = rng.choice([b"alpha", b"beta", b"gamma", b"delta", b" ", b"\n"],
                     60_000)
  return {
      "empty": b"",
      "one": b"a",
      "text": text[:5000],
      "text_multiblock": text * 8,                      # > 128 KiB
      "words": b"".join(words),                         # repeats, offsets
      "random": rng.integers(0, 256, 40_000, np.uint8).tobytes(),
      "f32": rng.normal(size=50_000).astype(np.float32).tobytes(),
      "runs": (b"x" * 70_000 + bytes(range(256))) * 3,  # RLE blocks
  }


INPUTS = _inputs()


def _compress(data, level, checksum, content_size):
  return zstandard.ZstdCompressor(
      level=level, write_checksum=checksum,
      write_content_size=content_size).compress(data)


@pytest.mark.parametrize("content_size", [True, False],
                         ids=["with_size", "no_size"])
@pytest.mark.parametrize("checksum", [True, False], ids=["xxh64", "no_xxh"])
@pytest.mark.parametrize("level", LEVELS)
def test_frames_decode_as_zstandard_does(level, checksum, content_size):
  for name, data in INPUTS.items():
    frame = _compress(data, level, checksum, content_size)
    assert zstd.decompress(frame) == data, name


@pytest.mark.parametrize("level", LEVELS)
def test_streamed_frames_of_many_blocks(level):
  """A frame written in pieces with a block flush after each (no content
  size), and one whose window is smaller than its content."""
  data = INPUTS["text_multiblock"] + INPUTS["words"]
  cobj = zstandard.ZstdCompressor(level=level, write_checksum=True).compressobj()
  parts = [cobj.compress(data[i:i + 7000])
           + cobj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
           for i in range(0, len(data), 7000)]
  frame = b"".join(parts) + cobj.flush()
  assert zstd.decompress(frame) == data
  params = zstandard.ZstdCompressionParameters.from_level(
      max(level, 1), window_log=10, write_checksum=1)
  small = zstandard.ZstdCompressor(compression_params=params).compress(data)
  assert zstd.decompress(small) == data


def test_concatenated_and_skippable_frames():
  a, b = INPUTS["text"], INPUTS["words"]
  skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + (
      b"hello")
  frames = [skip, _compress(a, 3, True, True), skip,
            _compress(b, 19, False, False), _compress(b"", 1, True, True)]
  assert zstd.decompress(b"".join(frames)) == a + b
  assert zstd.decompress(skip) == b""


@settings(max_examples=150, deadline=None)
@given(data=st.one_of(
    st.binary(max_size=3000),
    st.lists(st.sampled_from([b"ab", b"abc", b"zzzz", b"0123456789", b"\0"]),
             max_size=2000).map(b"".join)),
       level=st.sampled_from(LEVELS), checksum=st.booleans())
def test_hypothesis_inputs_decode_as_zstandard_does(data, level, checksum):
  assert zstd.decompress(_compress(data, level, checksum, True)) == data


def test_truncated_and_corrupted_frames_raise():
  """Every truncation raises. Every byte of a checksummed frame XOR 0xFF
  either raises or (a bit the format ignores) decodes to the same bytes,
  and most raise."""
  data = INPUTS["words"][:20000]
  frame = _compress(data, 3, True, True)
  for n in list(range(0, 40)) + list(range(40, len(frame), 97)) + [
      len(frame) - 1]:
    with pytest.raises(ValueError):
      zstd.decompress(frame[:n])
  raised = 0
  for i in range(len(frame)):
    bad = bytearray(frame)
    bad[i] ^= 0xFF
    try:
      assert zstd.decompress(bytes(bad)) == data, i
    except ValueError:
      raised += 1
  assert raised >= 0.95 * len(frame)
  rng = np.random.default_rng(1)
  for _ in range(300):      # random bytes after a valid header: no crash
    junk = frame[:6] + rng.integers(0, 256, rng.integers(1, 400),
                                    np.uint8).tobytes()
    try:
      zstd.decompress(junk)
    except ValueError:
      pass


def test_bad_checksum_and_dictionary_raise():
  frame = bytearray(_compress(INPUTS["text"], 3, True, True))
  frame[-1] ^= 1
  with pytest.raises(ValueError, match="checksum"):
    zstd.decompress(bytes(frame))
  samples = [INPUTS["words"][i:i + 300] for i in range(0, 60_000, 300)]
  d = zstandard.train_dictionary(2048, samples)
  framed = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
  with pytest.raises(ValueError, match="dictionary"):
    zstd.decompress(framed)
  with pytest.raises(ValueError, match="magic"):
    zstd.decompress(b"not a frame")


@pytest.mark.parametrize("n", [0, 1, 131072, 131073, 400_000])
def test_raw_frames_read_back(n):
  data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
  frame = zstd.raw_frame(data).tobytes()
  assert zstandard.ZstdDecompressor().decompress(frame) == data
  assert zstd.decompress(frame) == data
  out = np.empty(n, np.uint8)
  assert zstd.decompress_into(frame, out) == n and out.tobytes() == data


def test_crc32c():
  """The standard check value, and a CRC continued across two pieces."""
  assert zstd.crc32c(b"123456789") == 0xE3069283
  data = INPUTS["random"]
  assert zstd.crc32c(data[1000:], zstd.crc32c(data[:1000])) == zstd.crc32c(
      data)


def test_build_failure_names_gxx_and_the_source(tmp_path, monkeypatch):
  bad = tmp_path / "zstd.cc"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(zstd, "SOURCE", bad)
  monkeypatch.setattr(zstd, "BUILD_DIR", tmp_path / "build")
  with pytest.raises(RuntimeError, match="g\\+\\+ failed .* csrc/host/zstd.cc"):
    zstd.build()
