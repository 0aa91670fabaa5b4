// The C++ stage of the port's Zstandard decoder (RFC 8878), for TIFF
// compression 50000 (nerf_pl_tpu_torch/data/zstd.py holds the plain version
// and the description): skippable frames, the frame header, raw, RLE and
// compressed blocks, Huffman literals (1 or 4 streams, direct or FSE-coded
// weights, treeless; read as libzstd's X1, X2 or fast decoders read them),
// FSE sequences (predefined, RLE, FSE and repeat
// modes, repeat offsets) and the XXH64 content checksum.  Built with g++ at
// first use and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Error {
  const char *msg;
};

const int kBlockMax = 128 * 1024;
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ------------------------------------------------------------------ XXH64
const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
               P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
               P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t round64(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round64(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= round64(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------ bitstreams
struct Forward {  // little-endian bits from the start
  const uint8_t *p;
  int64_t bit, end;
  uint32_t read(int n) {
    if (bit + n > end) throw Error{"an FSE table description past its block"};
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) v |= (uint32_t)((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
};

struct Backward {  // from the end toward the start, after the end mark
  const uint8_t *p;
  int64_t size;
  int64_t left;  // bits still to read (negative: read past the start)
  Backward(const uint8_t *data, int64_t n) : p(data), size(n) {
    if (n <= 0 || data[n - 1] == 0) throw Error{"a bitstream without its end mark"};
    int hb = 7;
    while (!(data[n - 1] >> hb)) --hb;
    left = (n - 1) * 8 + hb;
  }
  // HUF_initFastDStream's start: below the end mark, or from the top of a
  // last byte of 0
  Backward(const uint8_t *data, int64_t n, bool) : p(data), size(n), left(n * 8) {
    if (data[n - 1]) {
      int hb = 7;
      while (!(data[n - 1] >> hb)) --hb;
      left = (n - 1) * 8 + hb;
    }
  }
  inline uint64_t load(int64_t byte) const {  // little-endian, zeros past the end
    uint64_t w = 0;
    for (int i = 7; i >= 0; --i) w = (w << 8) | (byte + i < size ? p[byte + i] : 0);
    return w;
  }
  // the n bits below `left`, the highest first (zeros past the start)
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    int64_t hi = left;
    left -= n;
    if (left >= 0) return (uint32_t)((load(left >> 3) >> (left & 7)) & ((1ull << n) - 1));
    if (hi <= 0) return 0;
    return (uint32_t)((load(0) & ((1ull << hi) - 1)) << (n - hi));
  }
  bool overflowed() const { return left < 0; }
};

// ------------------------------------------------------------------ FSE
struct FseEnt {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};
typedef std::vector<FseEnt> Fse;

int read_distribution(const uint8_t *data, int64_t pos, int64_t end, int max_log,
                      int max_symbol, std::vector<int> &counts, int64_t *after) {
  Forward br{data, pos * 8, end * 8};
  int log = (int)br.read(4) + 5;
  if (log > max_log) throw Error{"an FSE accuracy log past the table's largest"};
  int remaining = (1 << log) + 1, symbol = 0;
  counts.clear();
  while (remaining > 1 && symbol <= max_symbol) {
    int bits = 0;
    while ((1 << bits) <= remaining) ++bits;
    int low = (1 << bits) - 1 - remaining;
    int v = (int)br.read(bits - 1);
    if (v >= low) {
      v |= (int)br.read(1) << (bits - 1);
      if (v >= 1 << (bits - 1)) v -= low;
    }
    int prob = v - 1;
    remaining -= prob < 0 ? -prob : prob;
    counts.push_back(prob);
    ++symbol;
    if (prob == 0) {
      for (;;) {
        int rep = (int)br.read(2);
        for (int i = 0; i < rep; ++i) counts.push_back(0);
        symbol += rep;
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 1 || symbol > max_symbol + 1)
    throw Error{"an FSE table description that does not sum up"};
  *after = (br.bit + 7) / 8;
  return log;
}

Fse fse_table(const std::vector<int> &counts, int log) {
  int size = 1 << log;
  std::vector<uint16_t> symbols(size, 0);
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s)
    if (counts[s] == -1) symbols[high--] = (uint16_t)s;
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (size_t s = 0; s < counts.size(); ++s)
    for (int i = 0; i < counts[s]; ++i) {
      symbols[pos] = (uint16_t)s;
      pos = (pos + step) & (size - 1);
      while (pos > high) pos = (pos + step) & (size - 1);
    }
  if (pos != 0) throw Error{"an FSE table that does not spread"};
  std::vector<int> next(counts.size());
  for (size_t s = 0; s < counts.size(); ++s) next[s] = counts[s] == -1 ? 1 : counts[s];
  Fse t(size);
  for (int st = 0; st < size; ++st) {
    int s = symbols[st], x = next[s]++;
    int hb = 31 - __builtin_clz((unsigned)x);
    int bits = log - hb;
    t[st] = FseEnt{(uint16_t)s, (uint8_t)bits, (uint16_t)((x << bits) - size)};
  }
  return t;
}

int table_log(const Fse &t) {
  int log = 0;
  while ((1u << log) < t.size()) ++log;
  return log;
}

// -------------------------------------------------------------- Huffman
struct Huff {
  std::vector<uint8_t> sym, bits;
  int max_bits = 0;
  bool present = false;
};

int64_t huffman_weights(const uint8_t *data, int64_t pos, int64_t end, std::vector<int> &w) {
  if (pos >= end) throw Error{"a Huffman tree description past its block"};
  int head = data[pos++];
  w.clear();
  if (head >= 128) {
    int n = head - 127, size = (n + 1) / 2;
    if (pos + size > end) throw Error{"Huffman weights past their block"};
    for (int i = 0; i < n; ++i) w.push_back(i & 1 ? data[pos + i / 2] & 15 : data[pos + i / 2] >> 4);
    return pos + size;
  }
  if (pos + head > end) throw Error{"Huffman weights past their block"};
  std::vector<int> counts;
  int64_t after;
  int log = read_distribution(data, pos, pos + head, 6, 255, counts, &after);
  Fse t = fse_table(counts, log);
  Backward br(data + after, pos + head - after);
  uint32_t s1 = br.read(log), s2 = br.read(log);
  for (;;) {
    w.push_back(t[s1].symbol);
    s1 = t[s1].base + br.read(t[s1].bits);
    if (br.overflowed()) {
      w.push_back(t[s2].symbol);
      break;
    }
    w.push_back(t[s2].symbol);
    s2 = t[s2].base + br.read(t[s2].bits);
    if (br.overflowed()) {
      w.push_back(t[s1].symbol);
      break;
    }
    if (w.size() > 255) throw Error{"too many Huffman weights"};
  }
  return pos + head;
}

void huffman_table(std::vector<int> w, Huff &h) {
  if (w.size() > 255) throw Error{"too many Huffman weights"};
  int64_t total = 0;
  for (int x : w)
    if (x) {
      if (x > 12) throw Error{"a Huffman weight past 12"};
      total += (int64_t)1 << (x - 1);
    }
  if (total == 0) throw Error{"Huffman weights all zero"};
  int max_bits = 0;
  while (((int64_t)1 << max_bits) <= total) ++max_bits;
  if (max_bits > 11) throw Error{"a Huffman tree deeper than 11 bits"};
  int64_t rest = ((int64_t)1 << max_bits) - total;
  if (rest & (rest - 1)) throw Error{"Huffman weights that leave no power of two"};
  int last = 0;
  while (((int64_t)1 << last) < rest) ++last;
  w.push_back(last + 1);
  int size = 1 << max_bits, pos = 0;
  h.sym.assign(size, 0);
  h.bits.assign(size, 0);
  for (int wt = 1; wt <= max_bits; ++wt)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == wt) {
        int n = 1 << (wt - 1);
        for (int i = 0; i < n; ++i) {
          h.sym[pos + i] = (uint8_t)s;
          h.bits[pos + i] = (uint8_t)(max_bits + 1 - wt);
        }
        pos += n;
      }
  if (pos != size) throw Error{"a Huffman table that does not fill"};
  h.max_bits = max_bits;
  h.present = true;
}

// libzstd's HUF_selectDecoder: the two-symbol decoder (X2) where its
// estimated time, less 1/32, beats the one-symbol decoder's (X1), by the
// share of compressed to regenerated bytes
const uint32_t kAlgoTime[16][2][2] = {
    {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}},
    {{170, 205}, {514, 112}}, {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
    {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}}, {{359, 188}, {1167, 109}},
    {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
    {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}},
    {{1412, 185}, {1695, 202}}};

bool select_x2(int64_t dst, int64_t src) {
  const uint32_t q = src >= dst ? 15 : (uint32_t)(src * 16 / dst);
  const uint32_t d256 = (uint32_t)(dst >> 8);
  const uint32_t t0 = kAlgoTime[q][0][0] + kAlgoTime[q][0][1] * d256;
  uint32_t t1 = kAlgoTime[q][1][0] + kAlgoTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// One stream of `count` literals.  X1 reads a symbol a lookup and must
// end on the stream's first bit.  X2 (HUF_decodeStreamX2) reads a pair of
// symbols where both codes fit in its 11-bit lookup (the tree's depth if
// deeper), else one: the same symbols and bits, but where one symbol is
// left and its lookup holds a pair, HUF_decodeLastSymbolX2 skips both
// codes' bits and stops at the stream's start, so the stream may end up
// to the second code's length early.
void huffman_stream(const uint8_t *data, int64_t n, const Huff &h, int64_t count,
                    std::vector<uint8_t> &out, bool x2) {
  Backward br(data, n);
  const int target = h.max_bits > 11 ? h.max_bits : 11;
  int64_t i = 0;
  while (i < count) {
    const int64_t at = br.left;
    const uint32_t first = br.read(h.max_bits);
    const int l1 = h.bits[first];
    out.push_back(h.sym[first]);
    ++i;
    br.left = at - l1;
    if (!x2) continue;
    const uint32_t second = br.read(h.max_bits);
    const int l2 = h.bits[second];
    br.left = at - l1;
    if (l1 + l2 > target) continue;
    if (i < count) {  // the pair
      out.push_back(h.sym[second]);
      ++i;
      br.left -= l2;
    } else if (at > 0) {  // the last symbol from a pair's entry
      br.left = at - l1 - l2 > 0 ? at - l1 - l2 : 0;
    } else {
      br.left = at;
    }
  }
  if (br.left != 0) throw Error{"a Huffman stream of the wrong length"};
}

// One stream as the fast 4-stream decoders (HUF_decompress4X*_usingDTable_
// internal_fast) read it: from the end of `n` bytes whose last are the
// stream's, on past its start into the bytes before (zeros past the
// first), with no check of where it ends.
void huffman_fast(const uint8_t *data, int64_t n, const Huff &h, int64_t count,
                  std::vector<uint8_t> &out) {
  Backward br(data, n, true);
  for (int64_t i = 0; i < count; ++i) {
    const int64_t at = br.left;
    const uint32_t peek = br.read(h.max_bits);
    out.push_back(h.sym[peek]);
    br.left = at - h.bits[peek];
  }
}

// ----------------------------------------------------------- the blocks
struct State {
  Huff huff;
  bool x2 = false;  // the decoder libzstd built the tree's table for
  Fse tables[3];  // ll, of, ml
  bool have[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
};

int64_t literals(const uint8_t *data, int64_t pos, int64_t end, State &st,
                 std::vector<uint8_t> &lits) {
  int b0 = data[pos];
  int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  lits.clear();
  if (kind < 2) {
    int64_t size;
    int head;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      head = 1;
    } else if (fmt == 1) {
      if (pos + 2 > end) throw Error{"a literals header past its block"};
      size = (b0 >> 4) + (data[pos + 1] << 4);
      head = 2;
    } else {
      if (pos + 3 > end) throw Error{"a literals header past its block"};
      size = (b0 >> 4) + (data[pos + 1] << 4) + ((int64_t)data[pos + 2] << 12);
      head = 3;
    }
    pos += head;
    if (kind == 0) {
      if (pos + size > end) throw Error{"raw literals past their block"};
      lits.assign(data + pos, data + pos + size);
      return pos + size;
    }
    if (pos >= end) throw Error{"RLE literals past their block"};
    lits.assign(size, data[pos]);
    return pos + 1;
  }
  static const int kHead[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
  int head = kHead[fmt], bits = kBits[fmt];
  if (pos + head > end) throw Error{"a literals header past its block"};
  uint64_t v = 0;
  for (int i = head - 1; i >= 0; --i) v = (v << 8) | data[pos + i];
  v >>= 4;
  int64_t regen = v & ((1u << bits) - 1), comp = v >> bits;
  int streams = fmt == 0 ? 1 : 4;
  pos += head;
  if (pos + comp > end) throw Error{"compressed literals past their block"};
  int64_t stop = pos + comp;
  if (kind == 2) {
    std::vector<int> w;
    pos = huffman_weights(data, pos, stop, w);
    huffman_table(w, st.huff);
    // one stream: HUF_decompress1X1; four: HUF_selectDecoder's pick; a
    // treeless block takes the table's decoder
    st.x2 = streams == 4 && regen > 0 && select_x2(regen, comp);
  } else if (!st.huff.present) {
    throw Error{"treeless literals without a previous tree"};
  }
  lits.reserve(regen);
  if (streams == 1) {
    huffman_stream(data + pos, stop - pos, st.huff, regen, lits, st.x2);
    return stop;
  }
  if (pos + 6 > stop) throw Error{"a jump table past its literals"};
  int64_t s1 = data[pos] | (data[pos + 1] << 8), s2 = data[pos + 2] | (data[pos + 3] << 8),
          s3 = data[pos + 4] | (data[pos + 5] << 8);
  pos += 6;
  int64_t each = (regen + 3) / 4;
  if (each * 3 > regen || pos + s1 + s2 + s3 > stop) throw Error{"literal streams of bad sizes"};
  int64_t b[5] = {pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop};
  if (s1 >= 8 && s2 >= 8 && s3 >= 8 && stop - b[3] >= 8 && 3 * each < regen) {
    for (int i = 0; i < 4; ++i)  // each stream from the jump table on
      huffman_fast(data + pos - 6, b[i + 1] - (pos - 6), st.huff,
                   i < 3 ? each : regen - 3 * each, lits);
    return stop;
  }
  for (int i = 0; i < 4; ++i)
    huffman_stream(data + b[i], b[i + 1] - b[i], st.huff, i < 3 ? each : regen - 3 * each, lits,
                   st.x2);
  return stop;
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};

std::vector<int> default_counts(int which) {
  std::vector<int> c;
  if (which == 0) {
    c.assign(kLLDefault, kLLDefault + 36);
  } else if (which == 1) {  // offsets
    c.assign(6, 1);
    c.insert(c.end(), 3, 2);
    c.insert(c.end(), 15, 1);
    c.insert(c.end(), 5, -1);
  } else {  // match lengths
    c = {1, 4, 3};
    c.insert(c.end(), 6, 2);
    c.insert(c.end(), 37, 1);
    c.insert(c.end(), 7, -1);
  }
  return c;
}

int64_t sequence_table(int which, int mode, const uint8_t *data, int64_t pos, int64_t end,
                       State &st) {
  static const int kMaxLog[3] = {9, 8, 9}, kMaxSym[3] = {35, 31, 52}, kDefLog[3] = {6, 5, 6};
  if (mode == 0) {
    st.tables[which] = fse_table(default_counts(which), kDefLog[which]);
  } else if (mode == 1) {
    if (pos >= end) throw Error{"an RLE sequence code past its block"};
    if (data[pos] > kMaxSym[which]) throw Error{"an RLE sequence code past the table's largest"};
    st.tables[which] = Fse(1, FseEnt{data[pos], 0, 0});
    ++pos;
  } else if (mode == 2) {
    std::vector<int> counts;
    int64_t after;
    int log = read_distribution(data, pos, end, kMaxLog[which], kMaxSym[which], counts, &after);
    st.tables[which] = fse_table(counts, log);
    pos = after;
  } else if (!st.have[which]) {
    throw Error{"a repeated sequence table without a previous one"};
  }
  st.have[which] = true;
  return pos;
}

void block(const uint8_t *data, int64_t pos, int64_t end, std::vector<uint8_t> &out,
           State &st) {
  std::vector<uint8_t> lits;
  pos = literals(data, pos, end, st, lits);
  if (pos >= end) throw Error{"a block without its sequences header"};
  int b0 = data[pos];
  int64_t nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) throw Error{"a sequences header past its block"};
    nseq = ((b0 - 128) << 8) + data[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) throw Error{"a sequences header past its block"};
    nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != end) throw Error{"bytes after a block's empty sequences"};
    out.insert(out.end(), lits.begin(), lits.end());
    return;
  }
  if (pos >= end) throw Error{"a sequences header past its block"};
  int flags = data[pos++];
  if (flags & 3) throw Error{"reserved sequence mode bits set"};
  pos = sequence_table(0, (flags >> 6) & 3, data, pos, end, st);
  pos = sequence_table(1, (flags >> 4) & 3, data, pos, end, st);
  pos = sequence_table(2, (flags >> 2) & 3, data, pos, end, st);
  if (pos > end) throw Error{"sequences past their block"};
  Backward br(data + pos, end - pos);
  const Fse &tl = st.tables[0], &to = st.tables[1], &tm = st.tables[2];
  uint32_t sl = br.read(table_log(tl)), so = br.read(table_log(to)), sm = br.read(table_log(tm));
  uint64_t *rep = st.rep;
  size_t lit = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    int ll_code = tl[sl].symbol, of_code = to[so].symbol, ml_code = tm[sm].symbol;
    if (of_code > 31) throw Error{"an offset code past 31"};
    uint64_t offset = ((uint64_t)1 << of_code) + br.read(of_code);
    uint64_t ml = kMLBase[ml_code] + br.read(kMLBits[ml_code]);
    uint64_t ll = kLLBase[ll_code] + br.read(kLLBits[ll_code]);
    uint64_t off;
    if (offset > 3) {
      off = offset - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    } else {
      int idx = (int)offset - 1 + (ll == 0);
      if (idx == 0) {
        off = rep[0];
      } else if (idx == 3) {
        off = rep[0] - 1;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        off = rep[idx];
        if (idx == 2) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      }
    }
    if (off == 0) throw Error{"an offset of 0"};
    if (lit + ll > lits.size()) throw Error{"sequences that take more literals than the block has"};
    out.insert(out.end(), lits.begin() + lit, lits.begin() + lit + ll);
    lit += ll;
    if (off > out.size()) throw Error{"an offset before the start of the frame"};
    size_t start = out.size() - off;
    for (uint64_t k = 0; k < ml; ++k) out.push_back(out[start + k]);
    if (i + 1 < nseq) {
      sl = tl[sl].base + br.read(tl[sl].bits);
      sm = tm[sm].base + br.read(tm[sm].bits);
      so = to[so].base + br.read(to[so].bits);
    }
  }
  if (br.left != 0) throw Error{"a sequence bitstream of the wrong length"};
  out.insert(out.end(), lits.begin() + lit, lits.end());
}

// Whether the frame's blocks (and checksum) from `pos` all lie in the data
// (ZSTD_findFrameCompressedSize).
bool whole(const uint8_t *data, int64_t n, int64_t pos, int checksum) {
  for (;;) {
    if (pos + 3 > n) return false;
    uint32_t head = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16);
    pos += 3 + (((head >> 1) & 3) == 1 ? 1 : (int64_t)(head >> 3));
    if (pos > n) return false;
    if (head & 1) return pos + 4 * checksum <= n;
  }
}

// The first frame as libtiff's loop over ZSTD_decompressStream takes it into
// `room` bytes (zstd.py's _decode).
std::vector<uint8_t> decode(const uint8_t *data, int64_t n, int64_t room) {
  std::vector<uint8_t> out;
  int64_t pos = 0;
  uint32_t magic;
  for (;;) {  // skippable frames
    if (pos + 4 > n) return out;
    magic = rd32(data + pos);
    if ((magic & 0xFFFFFFF0u) != 0x184D2A50u) break;
    if (pos + 8 > n) return out;
    pos += 8 + (int64_t)rd32(data + pos + 4);
  }
  if (magic != 0xFD2FB528u) throw Error{"not a Zstandard frame"};
  if (pos + 5 > n) return out;
  int fhd = data[pos + 4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  static const int kDict[4] = {0, 1, 2, 4};
  int dsize = kDict[dict_flag];
  int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + 5 + !single + dsize + fcs_size > n) return out;
  if ((fhd >> 3) & 1) throw Error{"a frame header's reserved bit set"};
  pos += 5;
  uint64_t window = 0;
  if (!single) {
    int wd = data[pos++];
    int log = 10 + (wd >> 3);
    window = ((uint64_t)1 << log) + (((uint64_t)1 << log) >> 3) * (wd & 7);
  }
  uint64_t did = 0;
  for (int i = dsize - 1; i >= 0; --i) did = (did << 8) | data[pos + i];
  if (did) throw Error{"a frame that needs a dictionary"};
  pos += dsize;
  bool have_size = fcs_size > 0;
  uint64_t size = 0;
  if (fcs_size) {
    for (int i = fcs_size - 1; i >= 0; --i) size = (size << 8) | data[pos + i];
    if (fcs_size == 2) size += 256;
    pos += fcs_size;
  }
  if (single) window = size;
  if (window > ((uint64_t)1 << 27)) throw Error{"a frame whose window is past libzstd's default limit"};
  bool one_pass = have_size && (room < 0 || (uint64_t)room >= size) && whole(data, n, pos, checksum);
  int64_t block_max = window < (uint64_t)kBlockMax ? (int64_t)window : kBlockMax;
  State st;
  bool extra = false;
  int last = 0;
  while (!last) {
    if (pos + 3 > n) return out;
    uint32_t head = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16);
    last = head & 1;
    int kind = (head >> 1) & 3;
    int64_t bsize = head >> 3;
    pos += 3;
    if (kind == 3) throw Error{"a reserved block type"};
    if (bsize > block_max) throw Error{"a block past the frame's largest"};
    if (pos + (kind == 1 ? 1 : bsize) > n) return out;
    if (kind == 1) {
      out.insert(out.end(), bsize, data[pos]);
      pos += 1;
    } else if (kind == 0) {
      out.insert(out.end(), data + pos, data + pos + bsize);
      pos += bsize;
    } else {
      size_t before = out.size();
      block(data, pos, pos + bsize, out, st);
      if (out.size() - before > (size_t)kBlockMax) throw Error{"a block of more than 128 KiB"};
      pos += bsize;
    }
    if (last && have_size && out.size() != size)
      throw Error{"a frame whose content is not its stated size"};
    if (!one_pass && room >= 0 && (int64_t)out.size() >= room) {
      if (extra || (int64_t)out.size() > room) return out;
      extra = true;  // the flush completed: one more block is read
    }
  }
  if (checksum) {
    if (pos + 4 > n) return out;
    if (rd32(data + pos) != (uint32_t)xxh64(out.data(), out.size()))
      throw Error{"a content checksum mismatch"};
  }
  return out;
}

}  // namespace

extern "C" {

// The first frame's content into out (its first `expected` bytes).  Returns
// the content's size, or -1 with `err` set where libzstd (or libtiff's
// "Not enough data") fails.
int64_t zstd_decompress(const uint8_t *data, int64_t len, uint8_t *out, int64_t expected,
                        char *err, int errlen) {
  try {
    std::vector<uint8_t> v = decode(data, len, expected);
    if ((int64_t)v.size() < expected) {
      if (err && errlen > 0)
        snprintf(err, errlen, "Not enough data: %lld of %lld bytes", (long long)v.size(),
                 (long long)expected);
      return -1;
    }
    memcpy(out, v.data(), expected);
    return (int64_t)v.size();
  } catch (const Error &e) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", e.msg);
    return -1;
  }
}

}  // extern "C"
