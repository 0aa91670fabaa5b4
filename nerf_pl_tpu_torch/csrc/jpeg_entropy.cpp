// The host stages of the port's JPEG reader (nerf_pl_tpu_torch/data/jpeg.py),
// built with g++ at first use and called through ctypes:
//
//   * jpeg_scan: one scan's entropy-coded data into per-component quantised
//     coefficient planes (int16, natural order, one 64-entry row a block):
//     Huffman or arithmetic coding (ITU T.81 Annex F and D; libjpeg's
//     jdhuff.c, jdphuff.c and jdarith.c), sequential or progressive (DC
//     first and refine, AC spectral selection, successive approximation,
//     EOB runs), restart intervals, and libjpeg-turbo's handling of a
//     corrupt stream (zero bits past a marker, resynchronisation, the bad
//     code's sentinel, overflows that warn);
//   * jpeg_lossless_scan: a lossless (SOF3) scan's Huffman-coded
//     differences, predictors 1-7 and the point transform, into samples;
//   * jpeg_idct_islow: libjpeg-turbo's integer inverse DCT as its x86 AVX2
//     code runs it, coefficient planes into sample planes;
//   * jpeg_ycc_rgb: jdcolor.c's fixed-point YCbCr -> RGB (and, with a 4th
//     plane, YCCK -> CMYK).
//
// Errors return a negative code and write a message into `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so a run past 63 in a corrupt stream stays in bounds
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  const char *msg;
};
// The data ran out where libjpeg waits for more: Pillow then raises "image
// file is truncated"
struct Suspend {};

// --------------------------------------------------------------- segments
// A scan's bytes, from its first byte to the end of the file, split at every
// marker libjpeg's readers stop at (0xFF then a code other than 0 or 0xFF;
// fill bytes skipped), with the stuffed zero after each 0xFF data byte
// removed.  Segment i's bytes are bytes[start[i], start[i + 1]); it ends at
// marker code[i] (-1: at the end of the file), whose code byte is at
// after[i] - 1.  For each byte, raw_end keeps the index in `data` of the
// last raw byte that reading it consumes.
struct Segments {
  std::vector<uint8_t> bytes;
  std::vector<int64_t> raw_end;
  std::vector<size_t> start;
  std::vector<int> code;
  std::vector<int64_t> after;
  const uint8_t *data;
  size_t n, next = 0;
  bool done = false;

  // Segments are split off as the decoder reaches them (a scan reads its
  // own and, past a faulty restart marker, a few more), into buffers
  // reserved for the whole file so that no pointer into them moves.
  Segments(const uint8_t *d, size_t len) : data(d), n(len) {
    bytes.reserve(n);
    raw_end.reserve(n);
    start.push_back(0);
  }
  void split() {
    size_t i = next;
    while (i < n) {
      uint8_t b = data[i];
      if (b != 0xFF) {
        bytes.push_back(b);
        raw_end.push_back((int64_t)i);
        ++i;
        continue;
      }
      size_t j = i + 1;
      while (j < n && data[j] == 0xFF) ++j;  // fill bytes
      if (j >= n) break;  // a 0xFF the file ends on holds no byte
      if (data[j] == 0x00) {
        bytes.push_back(0xFF);
        raw_end.push_back((int64_t)j);
        i = j + 1;
        continue;
      }
      code.push_back(data[j]);
      after.push_back((int64_t)j + 1);
      start.push_back(bytes.size());
      next = j + 1;
      return;
    }
    code.push_back(-1);
    after.push_back((int64_t)n);
    start.push_back(bytes.size());
    next = n;
    done = true;
  }
  // makes segment i known (the last one ends at the end of the file)
  void ensure(size_t i) {
    while (code.size() <= i && !done) split();
  }
  size_t size(size_t i) const { return start[i + 1] - start[i]; }
};

// libjpeg's markers between restart intervals (jdmarker.c
// read_restart_marker and jpeg_resync_to_restart) over the segments:
// `seg` is the segment the entropy decoder reads, `pending` says its
// terminating marker is left unread after a resync (the next interval
// then reads no data).
struct Restarts {
  Segments *sg;
  size_t seg = 0;
  bool pending = false;
  int next_num = 0;  // the RSTn expected next
  int64_t last_read = -1;  // the last raw byte a marker read touched

  int marker() {
    sg->ensure(seg);
    if (sg->code[seg] < 0) throw Suspend{};  // next_marker at the file's end
    last_read = std::max(last_read, sg->after[seg] - 1);
    return sg->code[seg];
  }
  // Returns whether the decoder goes on reading data (the marker consumed).
  bool read_restart_marker() {
    int m = marker();
    bool consumed;
    if (m == 0xD0 + next_num) {
      consumed = true;
    } else {
      for (;;) {  // jpeg_resync_to_restart
        int action;
        if (m < 0xC0)
          action = 2;
        else if (m < 0xD0 || m > 0xD7)
          action = 3;
        else if (m == 0xD0 + ((next_num + 1) & 7) || m == 0xD0 + ((next_num + 2) & 7))
          action = 3;
        else if (m == 0xD0 + ((next_num - 1) & 7) || m == 0xD0 + ((next_num - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          consumed = true;
          break;
        }
        if (action == 3) {
          consumed = false;
          break;
        }
        ++seg;  // next_marker: past the next segment's bytes
        m = marker();
      }
    }
    if (consumed) ++seg;
    pending = !consumed;
    next_num = (next_num + 1) & 7;
    return consumed;
  }
};

// ------------------------------------------------------------ bit reader
// libjpeg's Huffman bit buffer over one segment: bits past the segment's
// data read as zeros (jpeg_fill_bit_buffer after a marker) and mark the
// data as insufficient.  A segment that ends at the end of the file has no
// marker to stop at: there libjpeg suspends when a refill finds no byte, so
// the refills are counted as libjpeg makes them (`fetched` bytes; 57 bits
// in the slow path, 6 bytes when 16 bits or fewer are left in the fast one).
struct Bits {
  const uint8_t *p = nullptr;
  int64_t n = 0;
  bool at_eof = false;
  int64_t pos = 0;      // bits consumed
  int64_t fetched = 0;  // bytes moved into libjpeg's buffer
  bool fast = false;

  void reset(const uint8_t *data, int64_t len, bool eof) {
    p = data;
    n = len;
    at_eof = eof;
    pos = 0;
    fetched = 0;
    fast = false;
    base = -64;
  }
  int64_t left() const { return fetched * 8 - pos; }
  bool over() const { return pos > n * 8; }
  // jpeg_fill_bit_buffer, where a refill is due
  inline void fill_slow() {
    if (!at_eof) return;
    int64_t want = fetched + (57 - left() + 7) / 8;
    if (want > n) throw Suspend{};
    fetched = want;
  }
  inline void check(int k) {  // CHECK_BIT_BUFFER
    if (at_eof && !fast && left() < k) fill_slow();
  }
  inline void fill_fast() {  // FILL_BIT_BUFFER_FAST
    if (at_eof && left() <= 16) {
      fetched += 6;
      if (fetched > n) throw Suspend{};
    }
  }
  // 64 bits from the byte at `base` / 8 (zeros past the data), reloaded
  // where a peek runs past them
  uint64_t cache = 0;
  int64_t base = -64;
  inline void load(int64_t byte) {
    base = byte * 8;
    uint64_t w = 0;
    if (byte + 8 <= n) {
      for (int i = 0; i < 8; ++i) w = (w << 8) | p[byte + i];
    } else {
      for (int i = 0; i < 8; ++i) w = (w << 8) | (byte + i < n ? p[byte + i] : 0);
    }
    cache = w;
  }
  inline uint32_t peek(int k) {  // k <= 25
    int64_t off = pos - base;
    if (off < 0 || off + k > 64) {
      load(pos >> 3);
      off = pos - base;
    }
    return (uint32_t)((cache << off) >> (64 - k));
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    if (fast)
      fill_fast();
    else
      check(k);
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

// ------------------------------------------------------------- Huffman
// Canonical codes as jdhuff.c derives them: an 8-bit lookahead table, then
// the maxcode search one bit at a time.  A code no table entry matches
// reads 17 bits and decodes as 0, as libjpeg's sentinel makes it.
struct Huffman {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[256];
  uint8_t look_sym[256];

  // max_symbol: DC tables hold magnitude categories up to 15 (16 in a
  // lossless scan); jpeg_make_d_derived_tbl refuses larger ones
  void build(const uint8_t *counts, const uint8_t *symbols, int max_symbol) {
    int code = 0, k = 0;
    int huffcode[256], huffsize[256];
    for (int L = 1; L <= 16; ++L) {
      for (int i = 0; i < counts[L - 1]; ++i) {
        if (k >= 256) throw Error{"a Huffman table with more than 256 codes"};
        huffsize[k] = L;
        huffcode[k] = code++;
        vals[k] = symbols[k];
        if (symbols[k] > max_symbol)
          throw Error{"a DC Huffman table with a symbol above its largest category"};
        ++k;
      }
      // no code may be all ones (jdhuff.c)
      if (code >= (1 << L)) throw Error{"a Huffman table that overflows its codes"};
      code <<= 1;
    }
    int p = 0;
    for (int L = 1; L <= 16; ++L) {
      if (counts[L - 1]) {
        valoffset[L] = p - huffcode[p];
        p += counts[L - 1];
        maxcode[L] = huffcode[p - 1];
      } else {
        maxcode[L] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;  // the sentinel that ends a corrupt code
    for (int i = 0; i < 256; ++i) look_len[i] = 0;
    for (int i = 0; i < k; ++i) {
      if (huffsize[i] > 8) continue;
      int shift = 8 - huffsize[i];
      int lo = huffcode[i] << shift;
      for (int j = 0; j < (1 << shift); ++j) {
        look_len[lo + j] = (uint8_t)huffsize[i];
        look_sym[lo + j] = vals[i];
      }
    }
    present = true;
  }
  inline int decode(Bits &b) const {
    if (b.fast)
      b.fill_fast();
    else if (b.at_eof && b.left() < 8)
      b.fill_slow();
    uint32_t look = b.peek(8);
    if (look_len[look]) {
      b.pos += look_len[look];
      return look_sym[look];
    }
    b.check(9);
    int32_t code = (int32_t)b.peek(9);
    b.pos += 9;
    int l = 9;
    while (code > maxcode[l]) {
      b.check(1);
      code = (code << 1) | (int32_t)b.peek(1);
      b.pos += 1;
      ++l;
    }
    if (l > 16) return 0;
    return vals[(code + valoffset[l]) & 0xFF];
  }
};

// ------------------------------------------------------------ arithmetic
// T.81 Table D.2, packed as libjpeg's jaricom.c does: Qe << 16 | Next_MPS
// << 8 | Switch_MPS << 7 | Next_LPS; entry 113 is the fixed 0.5 estimate.
#define V(i, qe, lps, mps, sw) \
  (((int64_t)(qe) << 16) | ((int64_t)(mps) << 8) | ((int64_t)(sw) << 7) | (lps))
const int64_t kAriTab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),      V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),      V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),    V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),    V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),    V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),    V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),    V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),    V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),    V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),    V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),    V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),    V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),    V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),    V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),    V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),    V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),   V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0),  V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// The QM decoder of jdarith.c: C holds the interval's base and the next
// input bits, split at a floating point CT.
// Past the segment's bytes it reads zeros (the marker is left unread);
// past the end of the file it cannot suspend, and libjpeg raises.  `bad`
// is jdarith.c's ct == -1: a spectral or magnitude overflow stops the
// decoding until the next restart.
struct Arith {
  const uint8_t *p = nullptr;
  size_t n = 0, pos = 0;
  bool at_eof = false, bad = false;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset(const uint8_t *data, size_t len, bool eof) {
    p = data;
    n = len;
    at_eof = eof;
    bad = false;
    pos = 0;
    c = 0;
    a = 0;
    ct = -16;  // read 2 bytes first
  }
  inline int decode(uint8_t *st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        if (pos >= n && at_eof)
          throw Error{"an arithmetic-coded scan that runs past the end of the file"};
        int data = pos < n ? p[pos] : 0;
        ++pos;
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // got the 2 first bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    uint8_t nl = qe & 0xFF;
    qe >>= 8;
    uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = (sv & 0x80) ^ nm;
      } else {
        a = qe;
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      } else {
        *st = (sv & 0x80) ^ nm;
      }
    }
    return sv >> 7;
  }
};

// ------------------------------------------------------------ one scan
struct Comp {
  int16_t *coef;  // the component's plane: nby rows of nbx blocks of 64
  int nbx;        // blocks a row of the plane
  int bw, bh;     // blocks a non-interleaved scan covers
  int h, v;       // sampling factors
  int dc, ac;     // table numbers
};

// Huffman tables 0-3; arithmetic conditioning and statistics 0-15
// (libjpeg's NUM_HUFF_TBLS and NUM_ARITH_TBLS)
struct Scan {
  int ns, mcux, mcuy, ss, se, ah, al, restart, arith, progressive;
  int64_t left_in_file;  // bytes from the scan's start to the end of the file
  Comp comp[4];
  Huffman dc_huff[4], ac_huff[4];
  int dc_L[16], dc_U[16], ac_K[16];
};

struct State {
  Bits bits;
  Arith ar;
  bool insufficient;  // libjpeg's insufficient_data: the rest of the interval is skipped
  int pred[4];
  int dc_context[4];
  unsigned eobrun;
  uint8_t dc_stats[16][64];
  uint8_t ac_stats[16][256];
  uint8_t fixed_bin[4];
};

void restart_state(const Scan &s, State &st) {
  for (int i = 0; i < 4; ++i) st.pred[i] = st.dc_context[i] = 0;
  st.eobrun = 0;
  if (s.arith) {
    for (int i = 0; i < s.ns; ++i) {
      if (!s.progressive || (s.ss == 0 && s.ah == 0))
        memset(st.dc_stats[s.comp[i].dc], 0, 64);
      if (!s.progressive || s.ss)
        memset(st.ac_stats[s.comp[i].ac], 0, 256);
    }
    st.fixed_bin[0] = 113;
  }
}

// --- Huffman, sequential (jdhuff.c decode_mcu_slow / decode_mcu_fast): a
// run that carries k past 63 writes at jpeg_natural_order's padding, 63
void huff_block_seq(const Scan &s, State &st, int ci, int16_t *blk) {
  Bits &b = st.bits;
  const Huffman &dc = s.dc_huff[s.comp[ci].dc];
  const Huffman &ac = s.ac_huff[s.comp[ci].ac];
  int t = dc.decode(b);
  int diff = extend(b.get(t), t);
  st.pred[ci] += diff;
  blk[0] = (int16_t)st.pred[ci];
  for (int k = 1; k < 64; ++k) {
    int rs = ac.decode(b);
    int r = rs >> 4, z = rs & 15;
    if (z) {
      k += r;
      int v = extend(b.get(z), z);
      blk[kNatural[k]] = (int16_t)v;
    } else {
      if (r != 15) break;  // EOB
      k += 15;
    }
  }
}

// --- Huffman, progressive (jdphuff.c)
void huff_dc_first(const Scan &s, State &st, int ci, int16_t *blk) {
  Bits &b = st.bits;
  int t = s.dc_huff[s.comp[ci].dc].decode(b);
  st.pred[ci] += extend(b.get(t), t);
  blk[0] = (int16_t)((unsigned)st.pred[ci] << s.al);
}

void huff_dc_refine(const Scan &s, State &st, int16_t *blk) {
  if (st.bits.get(1)) blk[0] |= (int16_t)(1 << s.al);
}

void huff_ac_first(const Scan &s, State &st, int16_t *blk) {
  if (st.eobrun) {
    --st.eobrun;
    return;
  }
  Bits &b = st.bits;
  const Huffman &ac = s.ac_huff[s.comp[0].ac];
  for (int k = s.ss; k <= s.se; ++k) {
    int rs = ac.decode(b);
    int r = rs >> 4, z = rs & 15;
    if (z) {
      k += r;
      blk[kNatural[k]] = (int16_t)((unsigned)extend(b.get(z), z) << s.al);
    } else if (r == 15) {
      k += 15;
    } else {
      st.eobrun = 1u << r;
      if (r) st.eobrun += b.get(r);
      --st.eobrun;
      break;
    }
  }
}

// A new coefficient of magnitude other than 1 is a warning in libjpeg: it
// reads one sign bit and goes on.
void huff_ac_refine(const Scan &s, State &st, int16_t *blk) {
  Bits &b = st.bits;
  const Huffman &ac = s.ac_huff[s.comp[0].ac];
  const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
  int k = s.ss;
  if (st.eobrun == 0) {
    for (; k <= s.se; ++k) {
      int rs = ac.decode(b);
      int r = rs >> 4, z = rs & 15;
      int val = 0;
      if (z) {
        val = b.get(1) ? p1 : m1;
      } else if (r != 15) {
        st.eobrun = 1u << r;
        if (r) st.eobrun += b.get(r);
        break;
      }
      do {
        int16_t *c = blk + kNatural[k];
        if (*c) {
          if (b.get(1) && (*c & p1) == 0) *c += (int16_t)(*c >= 0 ? p1 : m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= s.se);
      if (val) blk[kNatural[k]] = (int16_t)val;
    }
  }
  if (st.eobrun) {
    for (; k <= s.se; ++k) {
      int16_t *c = blk + kNatural[k];
      if (*c && b.get(1) && (*c & p1) == 0) *c += (int16_t)(*c >= 0 ? p1 : m1);
    }
    --st.eobrun;
  }
}

// --- arithmetic (jdarith.c): an overflow sets `bad` and leaves the block
// as far as it got
// Decodes one DC difference with the statistics of table `tbl`.
int arith_dc_diff(const Scan &s, State &st, int ci, int tbl) {
  Arith &d = st.ar;
  uint8_t *stat = st.dc_stats[tbl] + st.dc_context[ci];
  if (d.decode(stat) == 0) {
    st.dc_context[ci] = 0;
    return 0;
  }
  int sign = d.decode(stat + 1);
  stat += 2 + sign;
  int m = d.decode(stat);
  if (m) {
    stat = st.dc_stats[tbl] + 20;
    while (d.decode(stat)) {
      if ((m <<= 1) == 0x8000) {
        d.bad = true;  // magnitude overflow
        return 0;
      }
      stat += 1;
    }
  }
  if (m < (int)((1L << s.dc_L[tbl]) >> 1))
    st.dc_context[ci] = 0;
  else if (m > (int)((1L << s.dc_U[tbl]) >> 1))
    st.dc_context[ci] = 12 + sign * 4;
  else
    st.dc_context[ci] = 4 + sign * 4;
  int v = m;
  stat += 14;
  while (m >>= 1)
    if (d.decode(stat)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// Decodes one AC magnitude and sign at position k (after the "nonzero"
// decision); `stat` points at the position's S0.
int arith_ac_value(const Scan &s, State &st, int tbl, int k, uint8_t *stat) {
  Arith &d = st.ar;
  int sign = d.decode(st.fixed_bin);
  stat += 2;
  int m = d.decode(stat);
  if (m) {
    if (d.decode(stat)) {
      m <<= 1;
      stat = st.ac_stats[tbl] + (k <= s.ac_K[tbl] ? 189 : 217);
      while (d.decode(stat)) {
        if ((m <<= 1) == 0x8000) {
          d.bad = true;  // magnitude overflow
          return 0;
        }
        stat += 1;
      }
    }
  }
  int v = m;
  stat += 14;
  while (m >>= 1)
    if (d.decode(stat)) v |= m;
  v += 1;
  return sign ? -v : v;
}

void arith_block_seq(const Scan &s, State &st, int ci, int16_t *blk) {
  int tbl = s.comp[ci].dc;
  int diff = arith_dc_diff(s, st, ci, tbl);
  if (st.ar.bad) return;
  st.pred[ci] = (st.pred[ci] + diff) & 0xFFFF;
  blk[0] = (int16_t)st.pred[ci];
  tbl = s.comp[ci].ac;
  Arith &d = st.ar;
  int k = 0;
  do {
    uint8_t *stat = st.ac_stats[tbl] + 3 * k;
    if (d.decode(stat)) break;  // EOB
    for (;;) {
      ++k;
      if (d.decode(stat + 1)) break;
      stat += 3;
      if (k >= 63) {
        d.bad = true;  // spectral overflow
        return;
      }
    }
    int v = arith_ac_value(s, st, tbl, k, stat);
    if (d.bad) return;
    blk[kNatural[k]] = (int16_t)v;
  } while (k < 63);
}

void arith_dc_first(const Scan &s, State &st, int ci, int16_t *blk) {
  int diff = arith_dc_diff(s, st, ci, s.comp[ci].dc);
  if (st.ar.bad) return;
  st.pred[ci] += diff;
  blk[0] = (int16_t)((unsigned)st.pred[ci] << s.al);
}

void arith_dc_refine(const Scan &s, State &st, int16_t *blk) {
  if (st.ar.decode(st.fixed_bin)) blk[0] |= (int16_t)(1 << s.al);
}

void arith_ac_first(const Scan &s, State &st, int16_t *blk) {
  int tbl = s.comp[0].ac;
  Arith &d = st.ar;
  for (int k = s.ss; k <= s.se; ++k) {
    uint8_t *stat = st.ac_stats[tbl] + 3 * (k - 1);
    if (d.decode(stat)) break;  // EOB
    while (d.decode(stat + 1) == 0) {
      stat += 3;
      if (++k > s.se) {
        d.bad = true;  // spectral overflow
        return;
      }
    }
    int v = arith_ac_value(s, st, tbl, k, stat);
    if (d.bad) return;
    blk[kNatural[k]] = (int16_t)((unsigned)v << s.al);
  }
}

void arith_ac_refine(const Scan &s, State &st, int16_t *blk) {
  int tbl = s.comp[0].ac;
  Arith &d = st.ar;
  const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
  int kex = s.se;
  for (; kex > 0; --kex)
    if (blk[kNatural[kex]]) break;
  for (int k = s.ss; k <= s.se; ++k) {
    uint8_t *stat = st.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && d.decode(stat)) break;  // EOB
    for (;;) {
      int16_t *c = blk + kNatural[k];
      if (*c) {
        if (d.decode(stat + 2)) *c += (int16_t)(*c < 0 ? m1 : p1);
        break;
      }
      if (d.decode(stat + 1)) {
        *c = (int16_t)(d.decode(st.fixed_bin) ? m1 : p1);
        break;
      }
      stat += 3;
      if (++k > s.se) {
        d.bad = true;  // spectral overflow
        return;
      }
    }
  }
}

void decode_block(const Scan &s, State &st, int ci, int16_t *blk) {
  if (!s.progressive) {
    if (s.arith)
      arith_block_seq(s, st, ci, blk);
    else
      huff_block_seq(s, st, ci, blk);
  } else if (s.ss == 0) {
    if (s.ah == 0)
      s.arith ? arith_dc_first(s, st, ci, blk) : huff_dc_first(s, st, ci, blk);
    else
      s.arith ? arith_dc_refine(s, st, blk) : huff_dc_refine(s, st, blk);
  } else {
    if (s.ah == 0)
      s.arith ? arith_ac_first(s, st, blk) : huff_ac_first(s, st, blk);
    else
      s.arith ? arith_ac_refine(s, st, blk) : huff_ac_refine(s, st, blk);
  }
}

// The entropy decoder's reading position moves to segment `i` of `seg`
// (`pending`: a marker is left unread there, so no data is read).
void start_reading(const Scan &s, Segments &seg, State &st, size_t i, bool pending) {
  seg.ensure(i);
  const uint8_t *p = seg.bytes.data() + seg.start[i];
  size_t n = pending ? 0 : seg.size(i);
  bool eof = !pending && seg.code[i] < 0;
  if (s.arith)
    st.ar.reset(p, n, eof);
  else
    st.bits.reset(p, (int64_t)n, eof);
}

// Decodes the scan as libjpeg-turbo does, faults included.  Returns in
// out[0] the index in `data` just past the code byte of the marker that
// follows the scan (-1: the file ends first) and in out[1] that marker's
// code; out[2] is the last byte an arithmetic decoder reads (-1: none, or
// a Huffman scan), which tells where a reader fed in blocks would need more;
// out[3] the iMCU row of the last MCU begun with data left (jdcoefct.c's
// last_good_iMCU_row; -1: none), which block smoothing reads.
void run_scan(const Scan &s, const uint8_t *data, size_t len, int64_t *out) {
  Segments seg(data, len);
  Restarts rs{&seg};
  State st;
  st.insufficient = false;
  int64_t last_read = -1;
  // the arithmetic decoder's reads: through the marker's code byte when it
  // read past a segment's bytes
  auto count_reads = [&]() {
    if (!s.arith || rs.pending) return;
    size_t n = seg.size(rs.seg);
    if (st.ar.pos > n)
      last_read = std::max(last_read, seg.after[rs.seg] - 1);
    else if (st.ar.pos > 0)
      last_read = std::max(last_read, seg.raw_end[seg.start[rs.seg] + st.ar.pos - 1]);
  };
  start_reading(s, seg, st, 0, false);
  restart_state(s, st);
  long units;
  if (s.ns == 1)
    units = (long)s.comp[0].bw * s.comp[0].bh;
  else
    units = (long)s.mcux * s.mcuy;
  int blocks = 0;
  for (int ci = 0; ci < s.ns; ++ci) blocks += s.ns == 1 ? 1 : s.comp[ci].h * s.comp[ci].v;
  int64_t last_good = -1;
  for (long u = 0; u < units; ++u) {
    // the coefficient controller notes the row before decode_mcu runs
    // (and before its restart processing)
    if (!st.insufficient)
      last_good = s.ns == 1 ? (u / s.comp[0].bw) / s.comp[0].v : u / s.mcux;
    if (s.restart && u && u % s.restart == 0) {  // process_restart
      count_reads();
      bool consumed = rs.read_restart_marker();
      start_reading(s, seg, st, rs.seg, rs.pending);
      restart_state(s, st);
      if (consumed) st.insufficient = false;
    }
    if (s.arith ? st.ar.bad : st.insufficient) continue;
    if (!s.arith && !s.progressive) {
      // decode_mcu_fast where 512 bytes a block are left in Pillow's buffer
      int64_t at = st.bits.fetched ? seg.raw_end[seg.start[rs.seg] + st.bits.fetched - 1] + 1
                                   : (int64_t)(rs.seg ? seg.after[rs.seg - 1] : 0);
      st.bits.fast = !s.restart && s.left_in_file - at >= 512L * blocks;
    }
    if (s.ns == 1) {
      const Comp &c = s.comp[0];
      long by = u / c.bw, bx = u % c.bw;
      decode_block(s, st, 0, c.coef + (by * c.nbx + bx) * 64);
    } else {
      long my = u / s.mcux, mx = u % s.mcux;
      for (int ci = 0; ci < s.ns && !(s.arith && st.ar.bad); ++ci) {
        const Comp &c = s.comp[ci];
        for (int yy = 0; yy < c.v && !(s.arith && st.ar.bad); ++yy)
          for (int xx = 0; xx < c.h && !(s.arith && st.ar.bad); ++xx)
            decode_block(s, st, ci,
                         c.coef + ((my * c.v + yy) * c.nbx + mx * c.h + xx) * 64);
      }
    }
    if (!s.arith && st.bits.over()) st.insufficient = true;
  }
  count_reads();
  last_read = std::max(last_read, rs.last_read);
  out[0] = seg.code[rs.seg] < 0 ? -1 : seg.after[rs.seg];
  out[1] = seg.code[rs.seg];
  out[2] = s.arith ? last_read : -1;
  out[3] = last_good;
}

void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg);
}

// ------------------------------------------------------------ the IDCT
// libjpeg-turbo's x86-64 islow IDCT (jidctint-avx2.asm), which Pillow's
// libjpeg-turbo runs on an AVX2 host: the products coefficient x step in
// 16-bit lanes (wrapping), the sums in0 +- in4, z3 = tmp0 + tmp2 and z4 =
// tmp1 + tmp3 in 16 bits too, the rest in 32; each pass's outputs packed
// to 16 bits with saturation, the second's then to 8 (so samples clamp
// where the C code's range-limit table wraps).  A block whose rows 1-7 are
// all zero takes the shortcut: pass 1 gives (dc x step) << 2 in 16 bits.
// For coefficients of a valid stream this is jidctint.c's arithmetic.
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
              F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
              F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline int16_t sat16(int64_t v) { return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }

// One pass of the AVX2 dodct on 16-bit inputs; o: 32-bit sums before the
// descale.
inline void idct_1d(const int16_t *x, int64_t o[8]) {
  int64_t tmp0 = (int64_t)wrap16((int)x[0] + x[4]) * 8192;
  int64_t tmp1 = (int64_t)wrap16((int)x[0] - x[4]) * 8192;
  int64_t tmp2 = x[2] * F0541 + x[6] * (F0541 - F1847);
  int64_t tmp3 = x[2] * (F0541 + F0765) + x[6] * F0541;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  int64_t z3 = wrap16(t0 + t2), z4 = wrap16(t1 + t3);
  int64_t Z3 = z3 * (F1175 - F1961) + z4 * F1175;
  int64_t Z4 = z3 * F1175 + z4 * (F1175 - F0390);
  int64_t T0 = t0 * (F0298 - F0899) - t3 * F0899 + Z3;
  int64_t T1 = t1 * (F2053 - F2562) - t2 * F2562 + Z4;
  int64_t T2 = -t1 * F2562 + t2 * (F3072 - F2562) + Z3;
  int64_t T3 = -t0 * F0899 + t3 * (F1501 - F0899) + Z4;
  o[0] = tmp10 + T3;
  o[7] = tmp10 - T3;
  o[1] = tmp11 + T2;
  o[6] = tmp11 - T2;
  o[2] = tmp12 + T1;
  o[5] = tmp12 - T1;
  o[3] = tmp13 + T0;
  o[4] = tmp13 - T0;
}

}  // namespace

extern "C" {

// params: ns, mcux, mcuy, ss, se, ah, al, restart, arith, progressive.
// geo: per scan component nbx, bw, bh, h, v, dc table, ac table, 0.
// huff: 8 tables (DC 0-3, AC 0-3) of 16 counts and 256 symbols; present:
// a bit a table.  cond: DC L (16), DC U (16), AC K (16).  data: the bytes
// from the scan's first to the end of the file.  out: see run_scan.
// Returns 0, -1 on a fault (libjpeg's error exit), -2 where the data ran
// out (libjpeg suspends).
int jpeg_scan(const uint8_t *data, int64_t len, const int32_t *params,
              const int32_t *geo, int16_t **planes, const uint8_t *huff,
              int32_t present, const int32_t *cond, int64_t *out,
              char *err, int errlen) {
  try {
    Scan s;
    s.ns = params[0];
    s.mcux = params[1];
    s.mcuy = params[2];
    s.ss = params[3];
    s.se = params[4];
    s.ah = params[5];
    s.al = params[6];
    s.restart = params[7];
    s.arith = params[8];
    s.progressive = params[9];
    s.left_in_file = len;
    if (s.ns < 1 || s.ns > 4) throw Error{"a scan of more than 4 components"};
    for (int i = 0; i < s.ns; ++i) {
      const int32_t *g = geo + 8 * i;
      s.comp[i] = Comp{planes[i], g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
    }
    for (int t = 0; t < 16; ++t) {
      s.dc_L[t] = cond[t];
      s.dc_U[t] = cond[16 + t];
      s.ac_K[t] = cond[32 + t];
    }
    if (!s.arith)  // the tables this scan reads (jdhuff.c, jdphuff.c start_pass)
      for (int i = 0; i < s.ns; ++i) {
        bool dc = !s.progressive || (s.ss == 0 && s.ah == 0);
        bool ac = !s.progressive || s.ss > 0;
        for (int k = 0; k < 2; ++k) {
          if (!(k ? ac : dc)) continue;
          int t = k ? s.comp[i].ac : s.comp[i].dc;
          if (t > 3 || !(present & (1 << (k * 4 + t))))
            throw Error{"a scan naming a missing Huffman table"};
          Huffman &h = k ? s.ac_huff[t] : s.dc_huff[t];
          const uint8_t *tab = huff + (k * 4 + t) * 272;
          h.build(tab, tab + 16, k ? 255 : 15);
        }
      }
    run_scan(s, data, (size_t)len, out);
    return 0;
  } catch (const Error &e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (const Suspend &) {
    set_err(err, errlen, "image file is truncated: the scan's data ends with the file");
    return -2;
  }
}

// A lossless (SOF3) scan: Huffman-coded differences (jdlhuff.c) and the
// predictor (jddiffct.c / jdpred.c), into the samples before the point
// transform (the caller shifts them left by pt).  params: ns, mcux, mcuy,
// predictor, pt, restart, precision.  geo: per component width, height (in
// samples), h, v, table.  out: per component uint16 planes, width x height.
// data and the return value as jpeg_scan's; next: out[0] and out[1] of
// run_scan.  A row of MCUs after the data ran out into a marker decodes no
// bits: its differences are 0 from a fresh first row, as libjpeg resets its
// undifferencer there.
int jpeg_lossless_scan(const uint8_t *data, int64_t len, const int32_t *params,
                       const int32_t *geo, uint16_t **out, const uint8_t *huff,
                       int32_t present, int64_t *next, char *err, int errlen) {
  try {
    const int ns = params[0], mcux = params[1], mcuy = params[2];
    const int psv = params[3], pt = params[4], restart = params[5],
              precision = params[6];
    Huffman tables[4];
    struct LComp {
      int w, h, hs, vs, tbl;
      uint16_t *p;
    } c[4];
    for (int i = 0; i < ns; ++i) {
      const int32_t *g = geo + 5 * i;
      c[i] = LComp{g[0], g[1], g[2], g[3], g[4], out[i]};
      int t = c[i].tbl;
      if (t > 3 || !(present & (1 << t)))
        throw Error{"a scan naming a missing Huffman table"};
      if (!tables[t].present) tables[t].build(huff + t * 272, huff + t * 272 + 16, 16);
    }
    Segments seg(data, (size_t)len);
    Restarts rs{&seg};
    Bits bits;
    bool insufficient = false;
    // Samples are decoded in MCU order; each is predicted from its left,
    // upper and upper-left neighbours in its own component, and the first
    // row of the scan and of each restart interval from the left one only
    // (its first sample from 2^(precision - pt - 1)), as T.81 H.1.2.1 says.
    const int one = 1 << (precision - pt - 1);
    long row_start[4] = {0, 0, 0, 0};
    auto reading = [&]() {
      size_t i = rs.seg;
      seg.ensure(i);
      bits.reset(seg.bytes.data() + seg.start[i], rs.pending ? 0 : (int64_t)seg.size(i),
                 !rs.pending && seg.code[i] < 0);
    };
    reading();
    long units = ns == 1 ? (long)c[0].w * c[0].h : (long)mcux * mcuy;
    long row_len = ns == 1 ? c[0].w : mcux;
    bool skipping = false;
    for (long u = 0; u < units; ++u) {
      if (restart && u && u % restart == 0) {
        bool consumed = rs.read_restart_marker();
        reading();
        if (consumed) insufficient = false;
      }
      bool fresh = restart && u % restart == 0;
      if (u % row_len == 0) {  // decode_mcus: a row of MCUs at a time
        skipping = insufficient;
        fresh |= skipping;
      }
      for (int ci = 0; ci < ns; ++ci) {
        LComp &k = c[ci];
        int bh = ns == 1 ? 1 : k.vs, bw = ns == 1 ? 1 : k.hs;
        long y0 = ns == 1 ? u / k.w : (u / mcux) * k.vs;
        long x0 = ns == 1 ? u % k.w : (u % mcux) * k.hs;
        if (fresh) row_start[ci] = y0;
        for (int yy = 0; yy < bh; ++yy)
          for (int xx = 0; xx < bw; ++xx) {
            long y = y0 + yy, x = x0 + xx;
            int diff = 0;
            if (!skipping) {
              int t = tables[k.tbl].decode(bits);
              diff = t == 16 ? 32768 : extend(bits.get(t), t);
            }
            if (y >= k.h || x >= k.w) continue;
            int pred;
            uint16_t *row = k.p + y * k.w;
            if (y == row_start[ci]) {
              pred = x == 0 ? one : row[x - 1];
            } else if (x == 0) {
              pred = row[x - k.w];
            } else {
              int ra = row[x - 1], rb = row[x - k.w], rc = row[x - k.w - 1];
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                case 7: pred = (ra + rb) >> 1; break;
                default: throw Error{"a lossless predictor outside 1-7"};
              }
            }
            row[x] = (uint16_t)((pred + diff) & 0xFFFF);
          }
      }
      if (bits.over()) insufficient = true;
    }
    next[0] = seg.code[rs.seg] < 0 ? -1 : seg.after[rs.seg];
    next[1] = seg.code[rs.seg];
    return 0;
  } catch (const Error &e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (const Suspend &) {
    set_err(err, errlen, "image file is truncated: the scan's data ends with the file");
    return -2;
  }
}

// coef: nby x nbx blocks of 64 natural-order coefficients; quant: 64
// natural-order steps; out: (nby * 8) x (nbx * 8) samples.
void jpeg_idct_islow(const int16_t *coef, const int32_t *quant, int64_t nbx,
                     int64_t nby, uint8_t *out) {
  const int64_t stride = nbx * 8;
  for (int64_t by = 0; by < nby; ++by)
    for (int64_t bx = 0; bx < nbx; ++bx) {
      const int16_t *in = coef + (by * nbx + bx) * 64;
      int16_t ws[64], x[8];
      int64_t o[8];
      bool ac_zero = true;
      for (int i = 8; i < 64; ++i) ac_zero &= in[i] == 0;
      for (int col = 0; col < 8; ++col) {
        if (ac_zero) {
          int16_t dc = wrap16(wrap16((int64_t)in[col] * quant[col]) * 4);
          for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
          continue;
        }
        bool col_zero = true;
        for (int r = 1; r < 8; ++r) col_zero &= in[r * 8 + col] == 0;
        if (col_zero) {  // what the full pass gives a column of one term
          int16_t dc = sat16((int64_t)wrap16((int64_t)in[col] * quant[col]) * 4);
          for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
          continue;
        }
        for (int r = 0; r < 8; ++r) x[r] = wrap16((int64_t)in[r * 8 + col] * quant[r * 8 + col]);
        idct_1d(x, o);
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = sat16((o[r] + 1024) >> 11);
      }
      uint8_t *dst = out + by * 8 * stride + bx * 8;
      for (int row = 0; row < 8; ++row) {
        const int16_t *w = ws + row * 8;
        uint8_t *d = dst + row * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {  // one term
          int64_t v = ((int64_t)w[0] * 8192 + (1 << 17)) >> 18;
          uint8_t px = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
          for (int c = 0; c < 8; ++c) d[c] = px;
          continue;
        }
        idct_1d(w, o);
        for (int c = 0; c < 8; ++c) {
          int64_t v = sat16((o[c] + (1 << 17)) >> 18);
          d[c] = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
        }
      }
    }
}

// jdcolor.c's ycc_rgb_convert (k == nullptr) or ycck_cmyk_convert: n
// samples of each plane; out: n x 3 (RGB) or n x 4 (CMYK).
void jpeg_ycc_rgb(const uint8_t *y, const uint8_t *cb, const uint8_t *cr,
                  const uint8_t *k, int64_t n, uint8_t *out) {
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static bool ready = false;
  if (!ready) {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double v) { return (int64_t)(v * 65536 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    ready = true;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  const int ch = k ? 4 : 3;
  for (int64_t i = 0; i < n; ++i) {
    int yy = y[i], b = cb[i], r = cr[i];
    int rr = yy + cr_r[r];
    int gg = yy + (int)((cb_g[b] + cr_g[r]) >> 16);
    int bb = yy + cb_b[b];
    uint8_t *o = out + i * ch;
    if (k) {
      o[0] = clamp(255 - rr);
      o[1] = clamp(255 - gg);
      o[2] = clamp(255 - bb);
      o[3] = k[i];
    } else {
      o[0] = clamp(rr);
      o[1] = clamp(gg);
      o[2] = clamp(bb);
    }
  }
}

}  // extern "C"
