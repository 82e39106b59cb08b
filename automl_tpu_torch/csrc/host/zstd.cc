// A Zstandard frame decoder written to RFC 8878, a writer of frames made of
// raw blocks, XXH64 and the unmasked CRC32C that OCDBT's manifests and
// B-tree nodes carry. Plain C interface, loaded with ctypes
// (ckpt/zstd.py builds it with g++ at first use).
//
// The decoder takes any sequence of Zstandard and skippable frames: frame
// headers with and without a content size, window descriptors and single
// segments; raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded
// in 1 or 4 streams and treeless (the previous block's table); sequences
// with predefined, RLE, FSE-coded and repeated tables; repeat offsets; and
// the XXH64 content checksum, verified when the frame carries one.
// Dictionaries are refused. Every read is bounds-checked: a malformed
// input returns a negative error code (zstd_error_name says which) and
// never reads or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>

namespace {

enum Err : int64_t {
  kTruncated = -1,
  kBadMagic = -2,
  kReservedBit = -3,
  kDictionary = -4,
  kBadBlock = -5,
  kBadLiterals = -6,
  kBadHuffman = -7,
  kBadFse = -8,
  kBadSequences = -9,
  kBadOffset = -10,
  kChecksum = -11,
  kContentSize = -12,
  kDstTooSmall = -13,
  kTooLarge = -14,
};

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }

constexpr int64_t kBlockMax = 128 << 10;

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le16(p) | (uint32_t(le16(p + 2)) << 16);
}
inline uint64_t le64(const uint8_t* p) {
  return le32(p) | (uint64_t(le32(p + 4)) << 32);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round1(uint64_t acc, uint64_t v) {
  return rotl(acc + v * P2, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  return (acc ^ round1(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round1(v1, le64(p));
      v2 = round1(v2, le64(p + 8));
      v3 = round1(v3, le64(p + 16));
      v4 = round1(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round1(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// Little-endian bits read forward (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  int64_t n;      // bytes
  int64_t pos;    // bits consumed
  uint32_t peek(int k) const {   // k <= 25; bits past the end read as 0
    uint32_t v = 0;
    int64_t byte = pos >> 3;
    for (int i = 0; i < 4; i++)
      if (byte + i < n) v |= uint32_t(p[byte + i]) << (8 * i);
    return (v >> (pos & 7)) & ((1u << k) - 1);
  }
  void skip(int k) { pos += k; }
};

// A backward bit stream (Huffman and FSE payloads): the last byte's highest
// set bit marks its end; bits are read from there toward the first byte.
// Bits before the first byte read as 0, and `pos` goes negative: the
// callers treat that as overflow.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;   // unread bits
  void init(const uint8_t* src, int64_t len, int64_t err) {
    if (len <= 0 || src[len - 1] == 0) fail(err);
    p = src;
    n = len;
    pos = (len - 1) * 8 + highbit(src[len - 1]);
  }
  uint64_t load(int64_t byte) const {   // 8 bytes from `byte`, 0 outside
    if (byte >= 0 && byte + 8 <= n) {
      uint64_t v;
      std::memcpy(&v, p + byte, 8);
      return v;
    }
    uint64_t v = 0;
    for (int i = 0; i < 8; i++)
      if (byte + i >= 0 && byte + i < n) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }
  // The k bits (k <= 32) below pos, as an integer.
  uint32_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = pos - k;
    if (lo >= 0) {
      return uint32_t((load(lo >> 3) >> (lo & 7)) & ((1ull << k) - 1));
    }
    if (pos <= 0) return 0;
    uint32_t v = uint32_t(load(0) & ((1ull << pos) - 1));
    return v << (-lo);
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseCell {
  uint16_t baseline;
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = -1;   // accuracy log; -1: no table yet
  FseCell cells[1 << 9];
};

// Reads a normalized distribution (RFC 8878 4.1.1) of at most max_symbol + 1
// symbols and accuracy log at most max_log; returns the bytes it took.
int64_t read_distribution(const uint8_t* src, int64_t len, int max_log,
                          int max_symbol, int16_t* counts, int* n_symbols,
                          int* log) {
  if (len < 1) fail(kBadFse);
  ForwardBits b{src, len, 0};
  int al = int(b.peek(4)) + 5;
  b.skip(4);
  if (al > max_log) fail(kBadFse);
  int remaining = (1 << al) + 1;
  int threshold = 1 << al;
  int nbits = al + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (sym > max_symbol) fail(kBadFse);
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = b.peek(2);
        b.skip(2);
        n0 += int(r);
        if (r != 3) break;
        if (b.pos > len * 8) fail(kBadFse);
      }
      if (n0 > max_symbol + 1) fail(kBadFse);
      while (sym < n0) counts[sym++] = 0;
      if (sym > max_symbol) fail(kBadFse);
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = b.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      b.skip(nbits - 1);
    } else {
      count = int(b.peek(nbits));
      if (count >= threshold) count -= max;
      b.skip(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    counts[sym++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < 1) fail(kBadFse);
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (b.pos > len * 8) fail(kBadFse);
  }
  if (remaining != 1 || b.pos > len * 8) fail(kBadFse);
  *n_symbols = sym;
  *log = al;
  return (b.pos + 7) >> 3;
}

void build_fse(const int16_t* counts, int n_symbols, int log, FseTable* t) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < n_symbols; s++) {
    if (counts[s] == -1) {
      t->cells[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(counts[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_symbols; s++) {
    for (int i = 0; i < counts[s]; i++) {
      t->cells[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail(kBadFse);
  for (int i = 0; i < size; i++) {
    int s = t->cells[i].symbol;
    int n = next[s]++;
    int bits = log - highbit(uint32_t(n));
    t->cells[i].bits = uint8_t(bits);
    t->cells[i].baseline = uint16_t((n << bits) - size);
  }
  t->log = log;
}

void rle_fse(uint8_t symbol, FseTable* t) {
  t->cells[0] = FseCell{0, symbol, 0};
  t->log = 0;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackBits* b) { state = b->read(t->log); }
  uint8_t symbol() const { return t->cells[state].symbol; }
  void update(BackBits* b) {
    const FseCell& c = t->cells[state];
    state = c.baseline + b->read(c.bits);
  }
};

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

struct HufTable {
  int max_bits = 0;   // 0: no table yet
  uint8_t symbol[1 << 11];
  uint8_t bits[1 << 11];
};

// Reads a Huffman tree description; returns the bytes it took.
int64_t read_huffman(const uint8_t* src, int64_t len, HufTable* t) {
  if (len < 1) fail(kBadHuffman);
  uint8_t weights[256];
  int n = 0;
  int64_t used;
  int header = src[0];
  if (header < 128) {
    used = 1 + header;
    if (used > len || header == 0) fail(kBadHuffman);
    int16_t counts[256];
    int n_symbols, log;
    int64_t d = read_distribution(src + 1, header, 6, 255, counts, &n_symbols,
                                  &log);
    FseTable table;
    build_fse(counts, n_symbols, log, &table);
    BackBits b;
    b.init(src + 1 + d, header - d, kBadHuffman);
    FseState s1{&table, 0}, s2{&table, 0};
    s1.init(&b);
    s2.init(&b);
    for (;;) {
      if (n > 253) fail(kBadHuffman);
      weights[n++] = s1.symbol();
      s1.update(&b);
      if (b.pos < 0) {
        weights[n++] = s2.symbol();
        break;
      }
      weights[n++] = s2.symbol();
      s2.update(&b);
      if (b.pos < 0) {
        weights[n++] = s1.symbol();
        break;
      }
    }
  } else {
    n = header - 127;
    used = 1 + (n + 1) / 2;
    if (used > len) fail(kBadHuffman);
    for (int i = 0; i < n; i++) {
      uint8_t byte = src[1 + i / 2];
      weights[i] = (i & 1) ? (byte & 15) : (byte >> 4);
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < n; i++) {
    if (weights[i] > 11) fail(kBadHuffman);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(kBadHuffman);
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (max_bits > 11 || (rest & (rest - 1)) != 0) fail(kBadHuffman);
  if (n > 255) fail(kBadHuffman);
  weights[n++] = uint8_t(highbit(rest) + 1);
  int pos = 0;
  for (int w = 1; w <= max_bits; w++) {
    for (int s = 0; s < n; s++) {
      if (weights[s] != w) continue;
      int span = 1 << (w - 1);
      for (int i = 0; i < span; i++) {
        t->symbol[pos + i] = uint8_t(s);
        t->bits[pos + i] = uint8_t(max_bits + 1 - w);
      }
      pos += span;
    }
  }
  t->max_bits = max_bits;
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* src, int64_t len,
                    uint8_t* out, int64_t count) {
  BackBits b;
  b.init(src, len, kBadLiterals);
  int mb = t.max_bits;
  for (int64_t i = 0; i < count; i++) {
    uint32_t idx = b.peek(mb);
    out[i] = t.symbol[idx];
    b.pos -= t.bits[idx];
    if (b.pos < 0) fail(kBadLiterals);
  }
  if (b.pos != 0) fail(kBadLiterals);
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,
    14, 15, 16, 18, 20, 22, 24, 28, 32,  40,  48,  64,   128,  256,
    512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,  131, 259, 515,  1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  const uint8_t* src;
  int64_t len;
  int64_t at = 0;          // bytes of src read
  uint8_t* dst;            // the frame's output starts here
  int64_t cap;
  int64_t out = 0;         // bytes written
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  uint8_t literals[kBlockMax];

  void need(int64_t n) const {
    if (n < 0 || at + n > len) fail(kTruncated);
  }
  void room(int64_t n) const {
    if (out + n > cap) fail(kDstTooSmall);
  }

  // The literals section at src[0, n); returns the bytes it took and sets
  // *count.
  int64_t read_literals(const uint8_t* p, int64_t n, int64_t* count) {
    if (n < 1) fail(kBadLiterals);
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
      int64_t size, h;
      if (sf == 0 || sf == 2) {
        h = 1;
        size = p[0] >> 3;
      } else if (sf == 1) {
        h = 2;
        if (n < 2) fail(kBadLiterals);
        size = (p[0] >> 4) + (int64_t(p[1]) << 4);
      } else {
        h = 3;
        if (n < 3) fail(kBadLiterals);
        size = (p[0] >> 4) + (int64_t(p[1]) << 4) + (int64_t(p[2]) << 12);
      }
      if (size > kBlockMax) fail(kBadLiterals);
      if (type == 0) {
        if (h + size > n) fail(kBadLiterals);
        std::memcpy(literals, p + h, size);
        *count = size;
        return h + size;
      }
      if (h + 1 > n) fail(kBadLiterals);
      std::memset(literals, p[h], size);
      *count = size;
      return h + 1;
    }
    int64_t h, regen, comp;
    bool four = sf != 0;
    if (sf < 2) {
      h = 3;
      if (n < 3) fail(kBadLiterals);
      uint32_t v = le24(p);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      h = 4;
      if (n < 4) fail(kBadLiterals);
      uint32_t v = le32(p);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
    } else {
      h = 5;
      if (n < 5) fail(kBadLiterals);
      uint64_t v = le32(p) | (uint64_t(p[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax || h + comp > n) fail(kBadLiterals);
    const uint8_t* q = p + h;
    int64_t m = comp;
    if (type == 2) {
      int64_t used = read_huffman(q, m, &huf);
      q += used;
      m -= used;
    } else if (huf.max_bits == 0) {
      fail(kBadLiterals);   // treeless with no previous table
    }
    if (!four) {
      huffman_stream(huf, q, m, literals, regen);
    } else {
      if (m < 6) fail(kBadLiterals);
      int64_t s1 = le16(q), s2 = le16(q + 2), s3 = le16(q + 4);
      int64_t s4 = m - 6 - s1 - s2 - s3;
      int64_t part = (regen + 3) / 4;
      int64_t last = regen - 3 * part;
      if (s4 < 0 || last < 0) fail(kBadLiterals);
      const uint8_t* r = q + 6;
      huffman_stream(huf, r, s1, literals, part);
      huffman_stream(huf, r + s1, s2, literals + part, part);
      huffman_stream(huf, r + s1 + s2, s3, literals + 2 * part, part);
      huffman_stream(huf, r + s1 + s2 + s3, s4, literals + 3 * part, last);
    }
    *count = regen;
    return h + comp;
  }

  int64_t read_table(const uint8_t* p, int64_t n, int mode,
                     const int16_t* defaults, int n_defaults, int default_log,
                     int max_log, int max_symbol, FseTable* t) {
    if (mode == 0) {
      build_fse(defaults, n_defaults, default_log, t);
      return 0;
    }
    if (mode == 1) {
      if (n < 1 || p[0] > max_symbol) fail(kBadSequences);
      rle_fse(p[0], t);
      return 1;
    }
    if (mode == 2) {
      int16_t counts[256];
      int n_symbols, log;
      int64_t used = read_distribution(p, n, max_log, max_symbol, counts,
                                       &n_symbols, &log);
      build_fse(counts, n_symbols, log, t);
      return used;
    }
    if (t->log < 0) fail(kBadSequences);   // repeat with no previous table
    return 0;
  }

  void block(const uint8_t* p, int64_t n) {
    if (n > kBlockMax) fail(kBadBlock);
    int64_t n_lit;
    int64_t used = read_literals(p, n, &n_lit);
    p += used;
    n -= used;
    if (n < 1) fail(kBadSequences);
    int64_t n_seq = p[0];
    int64_t h = 1;
    if (n_seq >= 128) {
      if (n_seq < 255) {
        if (n < 2) fail(kBadSequences);
        n_seq = ((n_seq - 128) << 8) + p[1];
        h = 2;
      } else {
        if (n < 3) fail(kBadSequences);
        n_seq = p[1] + (int64_t(p[2]) << 8) + 0x7F00;
        h = 3;
      }
    }
    p += h;
    n -= h;
    if (n_seq == 0) {
      if (n != 0) fail(kBadSequences);
      room(n_lit);
      std::memcpy(dst + out, literals, n_lit);
      out += n_lit;
      return;
    }
    if (n < 1) fail(kBadSequences);
    int modes = p[0];
    if (modes & 3) fail(kBadSequences);
    p++;
    n--;
    int64_t u = read_table(p, n, modes >> 6, kLLDefault, 36, 6, 9, 35, &ll);
    p += u;
    n -= u;
    u = read_table(p, n, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 31, &of);
    p += u;
    n -= u;
    u = read_table(p, n, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 52, &ml);
    p += u;
    n -= u;
    BackBits b;
    b.init(p, n, kBadSequences);
    FseState sl{&ll, 0}, so{&of, 0}, sm{&ml, 0};
    sl.init(&b);
    so.init(&b);
    sm.init(&b);
    int64_t lit = 0;
    int64_t block_start = out;
    for (int64_t i = 0; i < n_seq; i++) {
      int ofc = so.symbol(), llc = sl.symbol(), mlc = sm.symbol();
      if (ofc > 31 || llc > 35 || mlc > 52) fail(kBadSequences);
      uint32_t ofv = (1u << ofc) + b.read(ofc);
      uint32_t ml_len = kMLBase[mlc] + b.read(kMLBits[mlc]);
      uint32_t ll_len = kLLBase[llc] + b.read(kLLBits[llc]);
      if (b.pos < 0) fail(kBadSequences);
      uint32_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        int idx = int(ofv) - 1 + (ll_len == 0 ? 1 : 0);   // 0..3
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (offset == 0) fail(kBadOffset);
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < n_seq) {
        sl.update(&b);
        sm.update(&b);
        so.update(&b);
        if (b.pos < 0) fail(kBadSequences);
      }
      if (lit + ll_len > n_lit) fail(kBadSequences);
      if (out - block_start + ll_len + ml_len > kBlockMax) fail(kBadBlock);
      room(int64_t(ll_len) + ml_len);
      std::memcpy(dst + out, literals + lit, ll_len);
      out += ll_len;
      lit += ll_len;
      if (offset > out) fail(kBadOffset);
      uint8_t* o = dst + out;
      const uint8_t* from = o - offset;
      if (offset >= ml_len) {
        std::memcpy(o, from, ml_len);
      } else {
        for (uint32_t k = 0; k < ml_len; k++) o[k] = from[k];
      }
      out += ml_len;
    }
    if (b.pos != 0) fail(kBadSequences);
    int64_t rest = n_lit - lit;
    if (out - block_start + rest > kBlockMax) fail(kBadBlock);
    room(rest);
    std::memcpy(dst + out, literals + lit, rest);
    out += rest;
  }

  // Decodes the frame whose magic number starts src; returns the bytes of
  // src it took.
  int64_t run() {
    need(5);
    uint8_t fhd = src[4];
    at = 5;
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    bool checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    if (fhd & 8) fail(kReservedBit);
    if (!single) {
      need(1);
      uint8_t wd = src[at++];
      int exponent = wd >> 3;
      if (exponent > 31) fail(kTooLarge);   // windows past 2 GiB
    }
    static const int kDictBytes[4] = {0, 1, 2, 4};
    int db = kDictBytes[dict_flag];
    need(db);
    uint32_t dict = 0;
    for (int i = 0; i < db; i++) dict |= uint32_t(src[at + i]) << (8 * i);
    at += db;
    if (dict != 0) fail(kDictionary);
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    int fb = kFcsBytes[fcs_flag];
    if (fcs_flag == 0 && single) fb = 1;
    int64_t content = -1;
    if (fb) {
      need(fb);
      uint64_t v = 0;
      for (int i = 0; i < fb; i++) v |= uint64_t(src[at + i]) << (8 * i);
      if (fb == 2) v += 256;
      if (v > (uint64_t(1) << 62)) fail(kTooLarge);
      content = int64_t(v);
      at += fb;
    }
    if (content >= 0 && content > cap) fail(kDstTooSmall);
    for (;;) {
      need(3);
      uint32_t bh = le24(src + at);
      at += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 0) {
        need(size);
        room(size);
        std::memcpy(dst + out, src + at, size);
        out += size;
        at += size;
      } else if (type == 1) {
        need(1);
        if (size > kBlockMax) fail(kBadBlock);
        room(size);
        std::memset(dst + out, src[at], size);
        out += size;
        at += 1;
      } else if (type == 2) {
        need(size);
        block(src + at, size);
        at += size;
      } else {
        fail(kBadBlock);
      }
      if (last) break;
    }
    if (content >= 0 && out != content) fail(kContentSize);
    if (checksum) {
      need(4);
      uint32_t want = le32(src + at);
      at += 4;
      if (uint32_t(xxh64(dst, out, 0)) != want) fail(kChecksum);
    }
    return at;
  }
};

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// The end of the frame starting at src (a Zstandard frame) and an upper
// bound of its output, from its header and block headers alone.
int64_t frame_bound(const uint8_t* src, int64_t len, int64_t* bound) {
  if (len < 5) fail(kTruncated);
  uint8_t fhd = src[4];
  int64_t at = 5;
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail(kReservedBit);
  int64_t window = kBlockMax;
  if (!single) {
    if (at + 1 > len) fail(kTruncated);
    uint8_t wd = src[at++];
    int exponent = wd >> 3;
    if (exponent > 31) fail(kTooLarge);
    int64_t base = int64_t(1) << (10 + exponent);
    window = base + (base / 8) * (wd & 7);
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  at += kDictBytes[fhd & 3];
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fb = kFcsBytes[fcs_flag];
  if (fcs_flag == 0 && single) fb = 1;
  if (at + fb > len) fail(kTruncated);
  int64_t content = -1;
  if (fb) {
    uint64_t v = 0;
    for (int i = 0; i < fb; i++) v |= uint64_t(src[at + i]) << (8 * i);
    if (fb == 2) v += 256;
    if (v > (uint64_t(1) << 62)) fail(kTooLarge);
    content = int64_t(v);
    at += fb;
  }
  if (single) window = content;
  int64_t block_max = window < kBlockMax ? window : kBlockMax;
  int64_t sum = 0;
  for (;;) {
    if (at + 3 > len) fail(kTruncated);
    uint32_t bh = le24(src + at);
    at += 3;
    int type = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    if (type == 3) fail(kBadBlock);
    if (type == 1) {
      at += 1;
      sum += size;
    } else {
      at += size;
      sum += type == 0 ? size : block_max;
    }
    if (at > len) fail(kTruncated);
    if (bh & 1) break;
  }
  if ((fhd >> 2) & 1) at += 4;
  if (at > len) fail(kTruncated);
  *bound = content >= 0 ? content : sum;
  return at;
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8, unmasked.
// ---------------------------------------------------------------------------

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
      for (int i = 0; i < 256; i++)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const CrcTables kCrc;

}  // namespace

extern "C" {

// The total output of the frames in src (skippable frames give none): exact
// where every frame declares its content size, else an upper bound. A
// negative error code for a malformed input.
int64_t zstd_decompressed_bound(const uint8_t* src, int64_t len) {
  try {
    int64_t at = 0, total = 0;
    if (len == 0) fail(kTruncated);
    while (at < len) {
      if (len - at < 4) fail(kTruncated);
      uint32_t magic = le32(src + at);
      if (skippable(magic)) {
        if (len - at < 8) fail(kTruncated);
        int64_t size = le32(src + at + 4);
        if (size > len - at - 8) fail(kTruncated);
        at += 8 + size;
      } else if (magic == kMagic) {
        int64_t bound;
        at += frame_bound(src + at, len - at, &bound);
        total += bound;
      } else {
        fail(kBadMagic);
      }
    }
    return total;
  } catch (const Fail& f) {
    return f.code;
  }
}

// Decodes every frame of src into dst (cap bytes); returns the bytes
// written, or a negative error code.
int64_t zstd_decompress(const uint8_t* src, int64_t len, uint8_t* dst,
                        int64_t cap) {
  try {
    int64_t at = 0, out = 0;
    if (len == 0) fail(kTruncated);
    while (at < len) {
      if (len - at < 4) fail(kTruncated);
      uint32_t magic = le32(src + at);
      if (skippable(magic)) {
        if (len - at < 8) fail(kTruncated);
        int64_t size = le32(src + at + 4);
        if (size > len - at - 8) fail(kTruncated);
        at += 8 + size;
        continue;
      }
      if (magic != kMagic) fail(kBadMagic);
      Frame* f = new Frame;   // ~130 KiB: off the stack
      f->src = src + at;
      f->len = len - at;
      f->dst = dst + out;
      f->cap = cap - out;
      try {
        at += f->run();
      } catch (...) {
        delete f;
        throw;
      }
      out += f->out;
      delete f;
    }
    return out;
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kTruncated;
  }
}

const char* zstd_error_name(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated input";
    case kBadMagic: return "not a Zstandard or skippable frame (magic number)";
    case kReservedBit: return "reserved bit set in the frame header";
    case kDictionary: return "the frame needs a dictionary, which is not supported";
    case kBadBlock: return "corrupt block (type or size)";
    case kBadLiterals: return "corrupt literals section";
    case kBadHuffman: return "corrupt Huffman tree description";
    case kBadFse: return "corrupt FSE table description";
    case kBadSequences: return "corrupt sequences section";
    case kBadOffset: return "match offset beyond the decoded output";
    case kChecksum: return "content checksum (XXH64) mismatch";
    case kContentSize: return "decoded size differs from the frame's content size";
    case kDstTooSmall: return "output larger than its buffer";
    case kTooLarge: return "window or content size too large";
    default: return "unknown error";
  }
}

// The size of the frame zstd_write_raw_frame makes of n bytes.
int64_t zstd_raw_frame_size(int64_t n) {
  int64_t blocks = n == 0 ? 1 : (n + kBlockMax - 1) / kBlockMax;
  return 4 + 1 + 1 + 8 + 3 * blocks + n;
}

// One frame of raw blocks holding src[0, n): a content size of 8 bytes, a
// 128 KiB window, no checksum. dst has zstd_raw_frame_size(n) bytes.
int64_t zstd_write_raw_frame(const uint8_t* src, int64_t n, uint8_t* dst) {
  uint8_t* o = dst;
  uint32_t magic = kMagic;
  std::memcpy(o, &magic, 4);
  o[4] = 0xC0;               // 8-byte content size, not single segment
  o[5] = uint8_t(7 << 3);    // window 2^(10 + 7) = 128 KiB
  uint64_t size = uint64_t(n);
  std::memcpy(o + 6, &size, 8);
  o += 14;
  int64_t at = 0;
  do {
    int64_t k = n - at < kBlockMax ? n - at : kBlockMax;
    uint32_t bh = uint32_t(k << 3) | (at + k == n ? 1 : 0);
    o[0] = uint8_t(bh);
    o[1] = uint8_t(bh >> 8);
    o[2] = uint8_t(bh >> 16);
    std::memcpy(o + 3, src + at, k);
    o += 3 + k;
    at += k;
  } while (at < n);
  return o - dst;
}

// CRC32C of n bytes continuing from crc (0 to start), unmasked.
uint32_t crc32c_update(uint32_t crc, const uint8_t* data, int64_t n) {
  uint32_t c = ~crc;
  const auto& t = kCrc.t;
  while (n >= 8) {
    uint32_t lo = c ^ le32(data);
    uint32_t hi = le32(data + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) c = t[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
