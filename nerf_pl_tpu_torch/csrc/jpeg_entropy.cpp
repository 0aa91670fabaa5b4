// The host stages of the port's JPEG reader (nerf_pl_tpu_torch/data/jpeg.py),
// built with g++ at first use and called through ctypes:
//
//   * jpeg_scan: one scan's entropy-coded data into per-component quantised
//     coefficient planes (int16, natural order, one 64-entry row a block):
//     Huffman or arithmetic coding (ITU T.81 Annex F and D; libjpeg's
//     jdhuff.c, jdphuff.c and jdarith.c), sequential or progressive (DC
//     first and refine, AC spectral selection, successive approximation,
//     EOB runs), restart intervals;
//   * jpeg_lossless_scan: a lossless (SOF3) scan's Huffman-coded
//     differences, predictors 1-7 and the point transform, into samples;
//   * jpeg_idct_islow: libjpeg's integer inverse DCT (jidctint.c) with its
//     post-IDCT range-limit table, coefficient planes into sample planes;
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

// --------------------------------------------------------------- segments
// A scan's bytes split at its restart markers, with the stuffed zero after
// each 0xFF data byte removed.  Reading past a segment's end gives zeros,
// as libjpeg supplies once it meets a marker.  For each byte it keeps the
// index in `data` of the last raw byte that reading it consumes, and for
// each restart marker the index of its code byte.
struct Segments {
  std::vector<uint8_t> bytes;
  std::vector<int64_t> raw_end;
  std::vector<size_t> start;  // start[i] .. start[i + 1]: segment i
  std::vector<int64_t> rst_code;

  Segments(const uint8_t *data, size_t n) {
    bytes.reserve(n);
    raw_end.reserve(n);
    start.push_back(0);
    for (size_t i = 0; i < n; ++i) {
      uint8_t b = data[i];
      if (b != 0xFF) {
        bytes.push_back(b);
        raw_end.push_back((int64_t)i);
        continue;
      }
      size_t j = i + 1;
      while (j < n && data[j] == 0xFF) ++j;  // fill bytes
      if (j >= n) break;
      if (data[j] == 0x00) {
        bytes.push_back(0xFF);
        raw_end.push_back((int64_t)j);
      } else if (data[j] >= 0xD0 && data[j] <= 0xD7) {
        start.push_back(bytes.size());
        rst_code.push_back((int64_t)j);
      } else {
        break;  // the scan's end
      }
      i = j;
    }
    start.push_back(bytes.size());
  }
  size_t count() const { return start.size() - 1; }
};

// ------------------------------------------------------------ bit reader
struct Bits {
  const uint8_t *p = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int have = 0;

  void reset(const uint8_t *data, size_t len) {
    p = data;
    n = len;
    pos = 0;
    acc = 0;
    have = 0;
  }
  inline void fill() {
    while (have <= 56) {
      uint64_t b = pos < n ? p[pos] : 0;
      ++pos;
      acc |= b << (56 - have);
      have += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (have < k) fill();
    return (uint32_t)(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    have -= k;
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

// ------------------------------------------------------------- Huffman
// Canonical codes: a 9-bit lookahead table, then libjpeg's maxcode search.
struct Huffman {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t look_len[512];
  uint8_t look_sym[512];

  void build(const uint8_t *counts, const uint8_t *symbols) {
    present = true;
    int code = 0, k = 0;
    int huffcode[256], huffsize[256];
    for (int L = 1; L <= 16; ++L) {
      for (int i = 0; i < counts[L - 1]; ++i) {
        if (k >= 256) throw Error{"a Huffman table with more than 256 codes"};
        huffsize[k] = L;
        huffcode[k] = code++;
        vals[k] = symbols[k];
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
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 512; ++i) look_len[i] = 0;
    for (int i = 0; i < k; ++i) {
      if (huffsize[i] > 9) continue;
      int shift = 9 - huffsize[i];
      int lo = huffcode[i] << shift;
      for (int j = 0; j < (1 << shift); ++j) {
        look_len[lo + j] = (int16_t)huffsize[i];
        look_sym[lo + j] = vals[i];
      }
    }
  }
  inline int decode(Bits &b) const {
    uint32_t w = b.peek(16);
    int l = look_len[w >> 7];
    if (l) {
      b.skip(l);
      return look_sym[w >> 7];
    }
    int L = 10;
    while (L <= 16 && (int32_t)(w >> (16 - L)) > maxcode[L]) ++L;
    if (L > 16) throw Error{"a corrupt Huffman code"};
    b.skip(L);
    return vals[(int)(w >> (16 - L)) + valoffset[L]];
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
struct Arith {
  const uint8_t *p = nullptr;
  size_t n = 0, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset(const uint8_t *data, size_t len) {
    p = data;
    n = len;
    pos = 0;
    c = 0;
    a = 0;
    ct = -16;  // read 2 bytes first
  }
  inline int decode(uint8_t *st) {
    while (a < 0x8000) {
      if (--ct < 0) {
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
  Comp comp[4];
  Huffman dc_huff[4], ac_huff[4];
  int dc_L[16], dc_U[16], ac_K[16];
};

struct State {
  Bits bits;
  Arith ar;
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

// --- Huffman, sequential (jdhuff.c decode_mcu)
void huff_block_seq(const Scan &s, State &st, int ci, int16_t *blk) {
  Bits &b = st.bits;
  const Huffman &dc = s.dc_huff[s.comp[ci].dc];
  const Huffman &ac = s.ac_huff[s.comp[ci].ac];
  int t = dc.decode(b);
  if (t > 16) throw Error{"a DC magnitude category above 16"};
  int diff = extend(b.get(t), t);
  st.pred[ci] += diff;
  blk[0] = (int16_t)st.pred[ci];
  for (int k = 1; k < 64; ++k) {
    int rs = ac.decode(b);
    int r = rs >> 4, z = rs & 15;
    if (z) {
      k += r;
      int v = extend(b.get(z), z);
      if (k > 63) throw Error{"a block with more than 64 coefficients"};
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
  if (t > 16) throw Error{"a DC magnitude category above 16"};
  st.pred[ci] += extend(b.get(t), t);
  blk[0] = (int16_t)(st.pred[ci] * (1 << s.al));
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
      if (k > s.se) throw Error{"a band with more coefficients than its scan"};
      blk[kNatural[k]] = (int16_t)(extend(b.get(z), z) * (1 << s.al));
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
        if (z != 1) throw Error{"a refinement coefficient of magnitude above 1"};
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
      if (val) {
        if (k > 63) throw Error{"a band with more coefficients than its scan"};
        blk[kNatural[k]] = (int16_t)val;
      }
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

// --- arithmetic (jdarith.c)
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
      if ((m <<= 1) == 0x8000) throw Error{"an arithmetic-coded magnitude overflow"};
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
        if ((m <<= 1) == 0x8000) throw Error{"an arithmetic-coded magnitude overflow"};
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
  st.pred[ci] = (st.pred[ci] + arith_dc_diff(s, st, ci, tbl)) & 0xFFFF;
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
      if (k >= 63) throw Error{"an arithmetic-coded band overflow"};
    }
    blk[kNatural[k]] = (int16_t)arith_ac_value(s, st, tbl, k, stat);
  } while (k < 63);
}

void arith_dc_first(const Scan &s, State &st, int ci, int16_t *blk) {
  st.pred[ci] = (st.pred[ci] + arith_dc_diff(s, st, ci, s.comp[ci].dc)) & 0xFFFF;
  blk[0] = (int16_t)(st.pred[ci] * (1 << s.al));
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
      if (++k > s.se) throw Error{"an arithmetic-coded band overflow"};
    }
    int v = arith_ac_value(s, st, tbl, k, stat);
    blk[kNatural[k]] = (int16_t)(v * (1 << s.al));
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
      if (++k > s.se) throw Error{"an arithmetic-coded band overflow"};
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

// Decodes the scan; returns the index in `data` of the last byte libjpeg's
// arithmetic decoder reads (len: the marker after the data; -1: none, or a
// Huffman scan), which tells where a reader fed in blocks would need more.
int64_t run_scan(const Scan &s, const uint8_t *data, size_t len) {
  Segments seg(data, len);
  State st;
  size_t interval = 0;
  int64_t last_read = -1;
  // an interval followed by a restart marker is read through its code byte
  auto end_interval = [&](size_t i) {
    if (!s.arith) return;
    if (i + 1 < seg.count()) {
      last_read = seg.rst_code[i];
      return;
    }
    size_t n = seg.start[i + 1] - seg.start[i];
    if (st.ar.pos > n)
      last_read = (int64_t)len;
    else if (st.ar.pos > 0)
      last_read = std::max(last_read, seg.raw_end[seg.start[i] + st.ar.pos - 1]);
  };
  auto start_interval = [&](size_t i) {
    if (i >= seg.count())
      throw Error{"a scan with fewer restart intervals than its DRI asks for"};
    const uint8_t *p = seg.bytes.data() + seg.start[i];
    size_t n = seg.start[i + 1] - seg.start[i];
    if (s.arith)
      st.ar.reset(p, n);
    else
      st.bits.reset(p, n);
    restart_state(s, st);
  };
  start_interval(0);
  long units;
  if (s.ns == 1)
    units = (long)s.comp[0].bw * s.comp[0].bh;
  else
    units = (long)s.mcux * s.mcuy;
  for (long u = 0; u < units; ++u) {
    if (s.restart && u && u % s.restart == 0) {
      end_interval(interval);
      start_interval(++interval);
    }
    if (s.ns == 1) {
      const Comp &c = s.comp[0];
      long by = u / c.bw, bx = u % c.bw;
      decode_block(s, st, 0, c.coef + (by * c.nbx + bx) * 64);
    } else {
      long my = u / s.mcux, mx = u % s.mcux;
      for (int ci = 0; ci < s.ns; ++ci) {
        const Comp &c = s.comp[ci];
        for (int yy = 0; yy < c.v; ++yy)
          for (int xx = 0; xx < c.h; ++xx)
            decode_block(s, st, ci,
                         c.coef + ((my * c.v + yy) * c.nbx + mx * c.h + xx) * 64);
      }
    }
  }
  end_interval(interval);
  return last_read;
}

void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg);
}

// ------------------------------------------------------------ the IDCT
const int kConstBits = 13, kPass1Bits = 2;
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
              F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
              F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// The post-IDCT range limit of jdmaster.c (prepare_range_limit_table),
// indexed by (x & 1023) for x the IDCT output before its +128.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128)
        t[i] = (uint8_t)(i + 128);
      else if (i < 512)
        t[i] = 255;
      else if (i < 896)
        t[i] = 0;
      else
        t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// One 1-D pass; in[k * stride] for k = 0..7, results (unshifted) in o.
inline void idct_1d(const int64_t *x, int64_t o[8]) {
  int64_t z2 = x[2], z3 = x[6];
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 + z3 * -F1847;
  int64_t tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = (x[0] + x[4]) * ((int64_t)1 << kConstBits);
  int64_t tmp1 = (x[0] - x[4]) * ((int64_t)1 << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

}  // namespace

extern "C" {

// params: ns, mcux, mcuy, ss, se, ah, al, restart, arith, progressive.
// geo: per scan component nbx, bw, bh, h, v, dc table, ac table, 0.
// huff: 8 tables (DC 0-3, AC 0-3) of 16 counts and 256 symbols; present:
// a bit a table.  cond: DC L (16), DC U (16), AC K (16).  last_read: see
// run_scan.
int jpeg_scan(const uint8_t *data, int64_t len, const int32_t *params,
              const int32_t *geo, int16_t **planes, const uint8_t *huff,
              int32_t present, const int32_t *cond, int64_t *last_read,
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
    if (s.ns < 1 || s.ns > 4) throw Error{"a scan of more than 4 components"};
    for (int i = 0; i < s.ns; ++i) {
      const int32_t *g = geo + 8 * i;
      s.comp[i] = Comp{planes[i], g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
    }
    for (int t = 0; t < 8; ++t)
      if (present & (1 << t)) {
        Huffman &h = t < 4 ? s.dc_huff[t] : s.ac_huff[t - 4];
        h.build(huff + t * 272, huff + t * 272 + 16);
      }
    for (int t = 0; t < 16; ++t) {
      s.dc_L[t] = cond[t];
      s.dc_U[t] = cond[16 + t];
      s.ac_K[t] = cond[32 + t];
    }
    if (!s.arith)
      for (int i = 0; i < s.ns; ++i) {
        bool dc = !s.progressive || s.ss == 0, ac = !s.progressive || s.ss > 0;
        bool refine_dc = s.progressive && s.ss == 0 && s.ah > 0;
        if ((dc && !refine_dc && !s.dc_huff[s.comp[i].dc].present) ||
            (ac && !s.ac_huff[s.comp[i].ac].present))
          throw Error{"a scan naming a missing Huffman table"};
      }
    *last_read = run_scan(s, data, (size_t)len);
    return 0;
  } catch (const Error &e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// A lossless (SOF3) scan: Huffman-coded differences (jdlhuff.c) and the
// predictor (jddiffct.c / jdpred.c), into the samples before the point
// transform (the caller shifts them left by pt).  params: ns, mcux, mcuy,
// predictor, pt, restart, precision.  geo: per component width, height (in
// samples), h, v, table.  out: per component uint16 planes, width x height.
int jpeg_lossless_scan(const uint8_t *data, int64_t len, const int32_t *params,
                       const int32_t *geo, uint16_t **out, const uint8_t *huff,
                       int32_t present, char *err, int errlen) {
  try {
    const int ns = params[0], mcux = params[1], mcuy = params[2];
    const int psv = params[3], pt = params[4], restart = params[5],
              precision = params[6];
    Huffman tables[4];
    for (int t = 0; t < 4; ++t)
      if (present & (1 << t)) tables[t].build(huff + t * 272, huff + t * 272 + 16);
    struct LComp {
      int w, h, hs, vs, tbl;
      uint16_t *p;
    } c[4];
    for (int i = 0; i < ns; ++i) {
      const int32_t *g = geo + 5 * i;
      c[i] = LComp{g[0], g[1], g[2], g[3], g[4], out[i]};
      if (!tables[c[i].tbl].present)
        throw Error{"a scan naming a missing Huffman table"};
    }
    Segments seg(data, (size_t)len);
    Bits bits;
    size_t interval = 0;
    // Samples are decoded in MCU order; each is predicted from its left,
    // upper and upper-left neighbours in its own component, and the first
    // row of the scan and of each restart interval from the left one only
    // (its first sample from 2^(precision - pt - 1)), as T.81 H.1.2.1 says.
    const int one = 1 << (precision - pt - 1);
    long row_start[4] = {0, 0, 0, 0};
    bits.reset(seg.bytes.data(), seg.start[1]);
    long units = ns == 1 ? (long)c[0].w * c[0].h : (long)mcux * mcuy;
    for (long u = 0; u < units; ++u) {
      if (restart && u && u % restart == 0) {
        ++interval;
        if (interval >= seg.count())
          throw Error{"a scan with fewer restart intervals than its DRI asks for"};
        bits.reset(seg.bytes.data() + seg.start[interval],
                   seg.start[interval + 1] - seg.start[interval]);
      }
      bool fresh = restart && u % restart == 0;
      for (int ci = 0; ci < ns; ++ci) {
        LComp &k = c[ci];
        int bh = ns == 1 ? 1 : k.vs, bw = ns == 1 ? 1 : k.hs;
        long y0 = ns == 1 ? u / k.w : (u / mcux) * k.vs;
        long x0 = ns == 1 ? u % k.w : (u % mcux) * k.hs;
        if (fresh) row_start[ci] = y0;
        for (int yy = 0; yy < bh; ++yy)
          for (int xx = 0; xx < bw; ++xx) {
            long y = y0 + yy, x = x0 + xx;
            int t = tables[k.tbl].decode(bits);
            if (t > 16) throw Error{"a lossless difference category above 16"};
            int diff = t == 16 ? 32768 : extend(bits.get(t), t);
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
    }
    return 0;
  } catch (const Error &e) {
    set_err(err, errlen, e.msg);
    return -1;
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
      int32_t ws[64];
      int64_t x[8], o[8];
      for (int col = 0; col < 8; ++col) {
        bool ac_zero = true;
        for (int r = 1; r < 8; ++r) ac_zero &= in[r * 8 + col] == 0;
        if (ac_zero) {
          int32_t dc = (int32_t)((int64_t)in[col] * quant[col] * (1 << kPass1Bits));
          for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
          continue;
        }
        for (int r = 0; r < 8; ++r) x[r] = (int64_t)in[r * 8 + col] * quant[r * 8 + col];
        idct_1d(x, o);
        for (int r = 0; r < 8; ++r)
          ws[r * 8 + col] = (int32_t)descale(o[r], kConstBits - kPass1Bits);
      }
      uint8_t *dst = out + by * 8 * stride + bx * 8;
      for (int row = 0; row < 8; ++row) {
        const int32_t *w = ws + row * 8;
        uint8_t *d = dst + row * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
          uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
          for (int c = 0; c < 8; ++c) d[c] = v;
          continue;
        }
        for (int c = 0; c < 8; ++c) x[c] = w[c];
        idct_1d(x, o);
        for (int c = 0; c < 8; ++c)
          d[c] = kRange.t[descale(o[c], kConstBits + kPass1Bits + 3) & 1023];
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
