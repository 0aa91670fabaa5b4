// The JPEG 2000 decoder's stages (ITU-T T.800), as OpenJPEG 2.5 computes
// them under Pillow, bit for bit.  Bound by data/jpeg2000.py through
// ctypes; data/j2k_plain.py holds each stage's plain version, which the
// tests and chip_smoke.py hold these against.  Built with
// -ffp-contract=off: the 9/7 lifting and the ICT are separate float32
// multiplies and adds, as in OpenJPEG.
//
//   j2k_tier2  packet headers and bodies -> each code-block's bit-planes,
//              passes and bytes
//   j2k_tier1  the MQ decoder and the three coding passes -> coefficients
//              (units of half the lowest decoded bit-plane)
//   j2k_idwt   dequantisation and the inverse 5/3 or 9/7 wavelet
//   j2k_mct    inverse RCT / ICT, rounding, DC level shift, clamp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

// ------------------------------------------------------------------ tier-2
struct Bits {  // OpenJPEG's opj_bio: a byte after 0xFF carries 7 bits
  const uint8_t *d;
  int64_t p, end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (p < end) buf |= d[p++];
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) {
      if (ct == 0) bytein();
      --ct;
      v |= ((buf >> ct) & 1u) << i;
    }
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct TagTree {
  std::vector<int32_t> value, low, parent;
  TagTree(int w, int h) {
    std::vector<std::pair<int, int>> dims;
    while (true) {
      dims.push_back({w, h});
      if (w * h <= 1) break;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    }
    std::vector<int> bases;
    int n = 0;
    for (auto &d : dims) {
      bases.push_back(n);
      n += d.first * d.second;
    }
    // opj_tgt_reset's 999: a leaf whose bits never come (past the data
    // every bit reads 0) resolves at threshold 1000, so every decode loop
    // over thresholds ends, and such a code-block decodes to zeros
    value.assign(n, 999);
    low.assign(n, 0);
    parent.assign(n, -1);
    for (size_t lv = 0; lv + 1 < dims.size(); ++lv) {
      int dw = dims[lv].first, dh = dims[lv].second, pw = dims[lv + 1].first;
      for (int j = 0; j < dh; ++j)
        for (int i = 0; i < dw; ++i)
          parent[bases[lv] + j * dw + i] = bases[lv + 1] + (j / 2) * pw + i / 2;
    }
  }
  int decode(Bits &bits, int leaf, int threshold) {
    int stack[64], sp = 0, node = leaf;
    while (parent[node] >= 0) {
      stack[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    while (true) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bits.read(1)) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stack[--sp];
    }
    return value[node] < threshold ? 1 : 0;
  }
};

int num_passes(Bits &b) {
  if (!b.read(1)) return 1;
  if (!b.read(1)) return 2;
  uint32_t n = b.read(2);
  if (n != 3) return 3 + (int)n;
  n = b.read(5);
  if (n != 31) return 6 + (int)n;
  return 37 + (int)b.read(7);
}

int floorlog2(int v) {
  int n = 0;
  while (v > 1) {
    v >>= 1;
    ++n;
  }
  return n;
}

// ------------------------------------------------------------------ tier-1
const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                          13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                          37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                          20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                          34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
enum { CTX_RL = 17, CTX_UNI = 18 };

struct MQ {  // T.800 C.3; past the data it reads 0xFF 0xFF, a marker
  const uint8_t *d;
  int64_t n, bp = 0;
  uint32_t a, c;
  int ct;
  uint8_t state[19], mps[19];
  uint32_t at(int64_t p) const { return p < n ? d[p] : 0xFFu; }
  void bytein() {
    uint32_t nxt = at(bp + 1);
    if (at(bp) == 0xFF) {
      if (nxt > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += nxt << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += nxt << 8;
      ct = 8;
    }
  }
  MQ(const uint8_t *data, int64_t len) : d(data), n(len) {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[0] = 4;
    state[CTX_RL] = 3;
    state[CTX_UNI] = 46;
    c = at(0) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  int decode(int cx) {
    int st = state[cx];
    uint32_t qe = QE[st];
    int m = mps[cx], dd;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        dd = m;
        state[cx] = NMPS[st];
      } else {
        dd = 1 - m;
        if (SWITCH[st]) mps[cx] = 1 - m;
        state[cx] = NLPS[st];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return m;
      if (a < qe) {
        dd = 1 - m;
        if (SWITCH[st]) mps[cx] = 1 - m;
        state[cx] = NLPS[st];
      } else {
        dd = m;
        state[cx] = NMPS[st];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return dd;
  }
};

// flags of a coefficient: neighbour significance, neighbour signs, own state
enum : uint32_t {
  NW = 1u << 0, N_ = 1u << 1, NE = 1u << 2, W_ = 1u << 3, E_ = 1u << 4,
  SW = 1u << 5, S_ = 1u << 6, SE = 1u << 7,
  NEG_N = 1u << 8, NEG_S = 1u << 9, NEG_W = 1u << 10, NEG_E = 1u << 11,
  SIG = 1u << 12, NEG = 1u << 13, VIS = 1u << 14, REF = 1u << 15,
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256][2];  // indexed by N S W E sig (low 4) and signs (high 4)
  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int m = 0; m < 256; ++m) {
        int h = !!(m & W_) + !!(m & E_), v = !!(m & N_) + !!(m & S_);
        int d = !!(m & NW) + !!(m & NE) + !!(m & SW) + !!(m & SE);
        if (o == 1) std::swap(h, v);
        int n;
        if (o == 3) {
          int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        } else if (h == 0) {
          if (v == 0) n = d == 0 ? 0 : d == 1 ? 1 : 2;
          else n = v == 1 ? 3 : 4;
        } else if (h == 1) {
          n = v == 0 ? (d == 0 ? 5 : 6) : 7;
        } else {
          n = 8;
        }
        zc[o][m] = (uint8_t)n;
      }
    // sc index: bit0 N sig, bit1 S sig, bit2 W sig, bit3 E sig, bits 4-7 signs
    static const int CTX[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    for (int m = 0; m < 256; ++m) {
      auto con = [&](int sigbit, int negbit) {
        return (m & sigbit) ? ((m & negbit) ? -1 : 1) : 0;
      };
      int hc = con(4, 64) + con(8, 128), vc = con(1, 16) + con(2, 32);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      sc[m][0] = (uint8_t)CTX[1 - hc][1 - vc];
      sc[m][1] = (uint8_t)(hc < 0 || (hc == 0 && vc < 0));
    }
  }
};

const Luts &luts() {
  static const Luts L;
  return L;
}

inline int sc_index(uint32_t f) {
  return (int)(((f & N_) ? 1 : 0) | ((f & S_) ? 2 : 0) | ((f & W_) ? 4 : 0) |
               ((f & E_) ? 8 : 0) | ((f & NEG_N) ? 16 : 0) |
               ((f & NEG_S) ? 32 : 0) | ((f & NEG_W) ? 64 : 0) |
               ((f & NEG_E) ? 128 : 0));
}

struct Block {
  int w, h, W2;
  std::vector<uint32_t> flags;
  std::vector<int32_t> val;
  void reset(int w_, int h_) {
    w = w_;
    h = h_;
    W2 = w + 2;
    flags.assign((size_t)W2 * (h + 2), 0);
    val.assign((size_t)W2 * (h + 2), 0);
  }
  void make_sig(int i, int s, int32_t v) {
    val[i] = v;
    flags[i] |= SIG | (s ? NEG : 0);
    flags[i - W2 - 1] |= SE;
    flags[i - W2] |= S_ | (s ? NEG_S : 0);
    flags[i - W2 + 1] |= SW;
    flags[i - 1] |= E_ | (s ? NEG_E : 0);
    flags[i + 1] |= W_ | (s ? NEG_W : 0);
    flags[i + W2 - 1] |= NE;
    flags[i + W2] |= N_ | (s ? NEG_N : 0);
    flags[i + W2 + 1] |= NW;
  }
};

// decode one code-block into blk.val; returns 0 or -1 (bit-planes)
int decode_block(Block &blk, const uint8_t *seg, int64_t len, int orient,
                 int numbps, int passes) {
  if (numbps >= 31) return -1;
  const Luts &L = luts();
  MQ mq(seg, len);
  const uint8_t *zc = L.zc[orient];
  const int w = blk.w, h = blk.h, W2 = blk.W2;
  uint32_t *fl = blk.flags.data();
  int bp = numbps, kind = 2;
  auto sign = [&](int i, int32_t oph) {
    int si = sc_index(fl[i]);
    int s = mq.decode(L.sc[si][0]) ^ L.sc[si][1];
    blk.make_sig(i, s, s ? -oph : oph);
  };
  for (int pass = 0; pass < passes && bp >= 1; ++pass) {
    const int32_t one = 1 << bp, half = one >> 1, oph = one | half;
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int rows = std::min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        const int top = (y0 + 1) * W2 + x + 1;
        if (kind == 0) {
          for (int k = 0; k < rows; ++k) {
            int i = top + k * W2;
            uint32_t f = fl[i];
            if ((f & (SIG | VIS)) || !(f & 0xFF)) continue;
            if (mq.decode(zc[f & 0xFF])) sign(i, oph);
            fl[i] |= VIS;
          }
        } else if (kind == 1) {
          for (int k = 0; k < rows; ++k) {
            int i = top + k * W2;
            uint32_t f = fl[i];
            if ((f & (SIG | VIS)) != SIG) continue;
            int cx = (f & REF) ? 16 : ((f & 0xFF) ? 15 : 14);
            int v = mq.decode(cx);
            blk.val[i] += (v ^ (blk.val[i] < 0)) ? half : -half;
            fl[i] |= REF;
          }
        } else {
          int start = 0;
          bool run = rows == 4;
          if (run)
            for (int k = 0; k < 4; ++k)
              if (fl[top + k * W2] & (0xFF | SIG | VIS)) {
                run = false;
                break;
              }
          if (run) {
            if (mq.decode(CTX_RL)) {
              int r = mq.decode(CTX_UNI) << 1;
              r |= mq.decode(CTX_UNI);
              sign(top + r * W2, oph);
              for (int k = r + 1; k < 4; ++k) {
                int i = top + k * W2;
                if (mq.decode(zc[fl[i] & 0xFF])) sign(i, oph);
              }
            }
          } else {
            for (int k = start; k < rows; ++k) {
              int i = top + k * W2;
              uint32_t f = fl[i];
              if (f & (SIG | VIS)) continue;
              if (mq.decode(zc[f & 0xFF])) sign(i, oph);
            }
          }
          for (int k = 0; k < rows; ++k) fl[top + k * W2] &= ~VIS;
        }
      }
    }
    if (++kind == 3) {
      kind = 0;
      --bp;
    }
  }
  return 0;
}

// ------------------------------------------------------------------ DWT
inline int mirror(int p, int n) {
  if (p < 0) p = -p;
  if (p >= n) p = 2 * (n - 1) - p;
  return p;
}

inline int32_t half_trunc(int32_t v) { return v / 2; }

// one row (stride 1) or column: x holds low samples then high ones
void lift53(int32_t *x, int n, int sn, int cas, std::vector<int32_t> &t) {
  if (n == 1) {
    if (cas) x[0] = half_trunc(x[0]);
    return;
  }
  t.resize(n);
  for (int i = 0; i < sn; ++i) t[2 * i + cas] = x[i];
  for (int i = 0; i < n - sn; ++i) t[2 * i + 1 - cas] = x[sn + i];
  for (int p = cas; p < n; p += 2)
    t[p] = t[p] - ((t[mirror(p - 1, n)] + t[mirror(p + 1, n)] + 2) >> 2);
  for (int p = 1 - cas; p < n; p += 2)
    t[p] = t[p] + ((t[mirror(p - 1, n)] + t[mirror(p + 1, n)]) >> 1);
  std::memcpy(x, t.data(), sizeof(int32_t) * n);
}

const float K = 1.230174105f, TWO_INV_K = 1.625732422f;
const float STEPS[4] = {-0.443506852f, -0.882911075f, 0.052980118f,
                        1.586134342f};

void lift97(float *x, int n, int sn, int cas, std::vector<float> &t) {
  int dn = n - sn;
  if ((cas == 0 && !(dn > 0 || sn > 1)) || (cas == 1 && !(sn > 0 || dn > 1)))
    return;
  t.resize(n);
  for (int i = 0; i < sn; ++i) t[2 * i + cas] = x[i] * K;
  for (int i = 0; i < dn; ++i) t[2 * i + 1 - cas] = x[sn + i] * TWO_INV_K;
  for (int k = 0; k < 4; ++k) {
    const float c = STEPS[k];
    const int first = (k % 2 == 0) ? cas : 1 - cas;
    for (int p = first; p < n; p += 2) {
      float s = t[mirror(p - 1, n)] + t[mirror(p + 1, n)];
      float m = s * c;
      t[p] = t[p] + m;
    }
  }
  std::memcpy(x, t.data(), sizeof(float) * n);
}

// the vertical pass on whole rows: the same per-sample operations as
// lift53/lift97 on each column, in cache order
void vlift53(int32_t *a, int w, int rw, int n, int sn, int cas,
             std::vector<int32_t> &t) {
  if (n == 1) {
    if (cas)
      for (int x = 0; x < rw; ++x) a[x] = half_trunc(a[x]);
    return;
  }
  t.resize((size_t)n * rw);
  for (int i = 0; i < n; ++i) {
    int p = i < sn ? 2 * i + cas : 2 * (i - sn) + 1 - cas;
    std::memcpy(&t[(size_t)p * rw], a + (size_t)i * w, sizeof(int32_t) * rw);
  }
  for (int p = cas; p < n; p += 2) {
    int32_t *d = &t[(size_t)p * rw];
    const int32_t *l = &t[(size_t)mirror(p - 1, n) * rw];
    const int32_t *r = &t[(size_t)mirror(p + 1, n) * rw];
    for (int x = 0; x < rw; ++x) d[x] = d[x] - ((l[x] + r[x] + 2) >> 2);
  }
  for (int p = 1 - cas; p < n; p += 2) {
    int32_t *d = &t[(size_t)p * rw];
    const int32_t *l = &t[(size_t)mirror(p - 1, n) * rw];
    const int32_t *r = &t[(size_t)mirror(p + 1, n) * rw];
    for (int x = 0; x < rw; ++x) d[x] = d[x] + ((l[x] + r[x]) >> 1);
  }
  for (int p = 0; p < n; ++p)
    std::memcpy(a + (size_t)p * w, &t[(size_t)p * rw], sizeof(int32_t) * rw);
}

void vlift97(float *a, int w, int rw, int n, int sn, int cas,
             std::vector<float> &t) {
  int dn = n - sn;
  if ((cas == 0 && !(dn > 0 || sn > 1)) || (cas == 1 && !(sn > 0 || dn > 1)))
    return;
  t.resize((size_t)n * rw);
  for (int i = 0; i < n; ++i) {
    bool low = i < sn;
    int p = low ? 2 * i + cas : 2 * (i - sn) + 1 - cas;
    const float k = low ? K : TWO_INV_K;
    float *d = &t[(size_t)p * rw];
    const float *s = a + (size_t)i * w;
    for (int x = 0; x < rw; ++x) d[x] = s[x] * k;
  }
  for (int k = 0; k < 4; ++k) {
    const float c = STEPS[k];
    const int first = (k % 2 == 0) ? cas : 1 - cas;
    for (int p = first; p < n; p += 2) {
      float *d = &t[(size_t)p * rw];
      const float *l = &t[(size_t)mirror(p - 1, n) * rw];
      const float *r = &t[(size_t)mirror(p + 1, n) * rw];
      for (int x = 0; x < rw; ++x) {
        float s = l[x] + r[x];
        float m = s * c;
        d[x] = d[x] + m;
      }
    }
  }
  for (int p = 0; p < n; ++p)
    std::memcpy(a + (size_t)p * w, &t[(size_t)p * rw], sizeof(float) * rw);
}

template <typename T, typename F, typename V>
void idwt2(T *a, int w, int nres, const int32_t *res, F lift, V vlift) {
  std::vector<T> t;
  for (int r = 1; r < nres; ++r) {
    const int32_t *cur = res + 4 * r, *prev = res + 4 * (r - 1);
    int rw = cur[2] - cur[0], rh = cur[3] - cur[1];
    if (!rw || !rh) continue;
    int sn = prev[2] - prev[0], vn = prev[3] - prev[1];
    for (int y = 0; y < rh; ++y) lift(a + (size_t)y * w, rw, sn, cur[0] & 1, t);
    vlift(a, w, rw, rh, vn, cur[1] & 1, t);
  }
}

}  // namespace

extern "C" {

// pk: (n_pk, 3) layer, first, count into pb_list; pb: (n_pb, 3) cw, ch,
// first code-block; mb: each code-block's band Mb.  out receives every
// block's bytes joined in block order (at most len bytes).
int j2k_tier2(const uint8_t *data, int64_t len, int32_t sop, int32_t n_pk,
              const int32_t *pk, const int32_t *pb_list, int32_t n_pb,
              const int32_t *pb, int32_t n_cblk, const int32_t *mb,
              int32_t *numbps, int32_t *passes, int64_t *offsets,
              int32_t *lengths, uint8_t *out, char *err, int32_t errlen) {
  std::vector<int32_t> lblock(n_cblk, 3);
  std::vector<uint8_t> seen(n_cblk, 0);
  std::vector<TagTree *> incl(n_pb, nullptr), imsb(n_pb, nullptr);
  struct Chunk {
    int32_t cblk;
    int64_t pos;
    int64_t len;
  };
  std::vector<Chunk> chunks;
  std::vector<std::pair<int32_t, int64_t>> got;
  for (int i = 0; i < n_cblk; ++i) numbps[i] = passes[i] = 0;
  int64_t pos = 0;
  int rc = 0;
  for (int k = 0; k < n_pk && rc == 0; ++k) {
    const int layer = pk[3 * k], first = pk[3 * k + 1], count = pk[3 * k + 2];
    if (sop && len - pos >= 6 && data[pos] == 0xFF && data[pos + 1] == 0x91)
      pos += 6;
    Bits bits{data, pos, len};
    got.clear();
    if (bits.read(1)) {
      for (int e = 0; e < count && rc == 0; ++e) {
        const int b = pb_list[first + e];
        const int cw = pb[3 * b], ch = pb[3 * b + 1], c0 = pb[3 * b + 2];
        if (cw * ch == 0) continue;
        if (!incl[b]) {
          incl[b] = new TagTree(cw, ch);
          imsb[b] = new TagTree(cw, ch);
        }
        for (int j = 0; j < cw * ch; ++j) {
          const int ci = c0 + j;
          int inc = seen[ci] ? (int)bits.read(1)
                             : incl[b]->decode(bits, j, layer + 1);
          if (!inc) continue;
          if (!seen[ci]) {
            int i = 0;
            while (!imsb[b]->decode(bits, j, i)) ++i;
            numbps[ci] = mb[ci] + 1 - i;
            seen[ci] = 1;
          }
          int nnew = num_passes(bits);
          while (bits.read(1)) ++lblock[ci];
          if (passes[ci] + nnew > 109) {
            set_err(err, errlen, "more than 109 coding passes in a code-block");
            rc = -1;
            break;
          }
          int nbits = lblock[ci] + floorlog2(nnew);
          if (nbits > 32) {
            set_err(err, errlen, "a code-block length of more than 32 bits");
            rc = -1;
            break;
          }
          got.push_back({ci, (int64_t)bits.read(nbits)});
          passes[ci] += nnew;
        }
      }
    }
    if (rc) break;
    bits.align();
    pos = bits.p;
    for (auto &g : got) {
      if (pos + g.second > len) {
        char msg[128];
        std::snprintf(msg, sizeof msg,
                      "a code-block segment of %lld bytes runs past the "
                      "tile's data",
                      (long long)g.second);
        set_err(err, errlen, msg);
        rc = -1;
        break;
      }
      chunks.push_back({g.first, pos, g.second});
      pos += g.second;
    }
  }
  for (auto *t : incl) delete t;
  for (auto *t : imsb) delete t;
  if (rc) return rc;
  std::vector<int64_t> size(n_cblk, 0);
  for (auto &c : chunks) size[c.cblk] += c.len;
  int64_t o = 0;
  for (int i = 0; i < n_cblk; ++i) {
    offsets[i] = o;
    lengths[i] = (int32_t)size[i];
    o += size[i];
  }
  std::vector<int64_t> fill(offsets, offsets + n_cblk);
  for (auto &c : chunks) {
    std::memcpy(out + fill[c.cblk], data + c.pos, (size_t)c.len);
    fill[c.cblk] += c.len;
  }
  return 0;
}

// geo: (n, 5) px, py, w, h, orient; planes[comp[k]] is an int32 plane of
// row stride strides[comp[k]]; the blocks are shared among the host's cores
int j2k_tier1(const uint8_t *blob, int32_t n, const int32_t *comp,
              const int32_t *geo, const int32_t *numbps, const int32_t *passes,
              const int64_t *offsets, const int32_t *lengths,
              const uint64_t *planes, const int32_t *strides, char *err,
              int32_t errlen) {
  luts();
  int nt = (int)std::thread::hardware_concurrency();
  nt = std::max(1, std::min(nt, std::max(1, n / 16)));
  std::vector<int> bad(nt, 0);
  auto work = [&](int t) {
    Block blk;
    for (int k = t; k < n; k += nt) {
      if (passes[k] == 0) continue;
      const int px = geo[5 * k], py = geo[5 * k + 1], w = geo[5 * k + 2],
                h = geo[5 * k + 3], orient = geo[5 * k + 4];
      if (w == 0 || h == 0) continue;
      blk.reset(w, h);
      if (decode_block(blk, blob + offsets[k], lengths[k], orient, numbps[k],
                       passes[k])) {
        bad[t] = 1;
        return;
      }
      int32_t *plane = reinterpret_cast<int32_t *>(planes[comp[k]]);
      const int stride = strides[comp[k]];
      for (int y = 0; y < h; ++y)
        std::memcpy(plane + (size_t)(py + y) * stride + px,
                    blk.val.data() + (size_t)(y + 1) * blk.W2 + 1,
                    sizeof(int32_t) * w);
    }
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(work, t);
    for (auto &th : pool) th.join();
  }
  for (int b : bad)
    if (b) {
      set_err(err, errlen, "31 or more bit-planes in a code-block");
      return -1;
    }
  return 0;
}

// out: for the 5/3 a copy of coef (int32), for the 9/7 a float32 plane of
// zeros; band_rect (nb, 4) and step (nb) place and scale each band
int j2k_idwt(void *out, int32_t w, int32_t h, int32_t nres,
             const int32_t *res, int32_t reversible, const int32_t *band_rect,
             const float *step, int32_t nbands, const int32_t *coef) {
  if (reversible) {
    int32_t *a = static_cast<int32_t *>(out);
    for (size_t i = 0; i < (size_t)w * h; ++i) a[i] = half_trunc(a[i]);
    idwt2(a, w, nres, res, lift53, vlift53);
  } else {
    float *a = static_cast<float *>(out);
    for (int b = 0; b < nbands; ++b) {
      const int32_t *r = band_rect + 4 * b;
      const float s = step[b];
      for (int y = r[1]; y < r[3]; ++y)
        for (int x = r[0]; x < r[2]; ++x)
          a[(size_t)y * w + x] = (float)coef[(size_t)y * w + x] * s;
    }
    idwt2(a, w, nres, res, lift97, vlift97);
  }
  return 0;
}

// ptrs: ncomp sample planes (int32, or float32 where kinds[c]), then ncomp
// int32 outputs; kinds: is_float[ncomp], prec[ncomp], sgnd[ncomp]
int j2k_mct(int32_t ncomp, int64_t n, const uint64_t *ptrs, int32_t mct_on,
            const int32_t *kinds) {
  const int32_t *isf = kinds, *prec = kinds + ncomp, *sgnd = kinds + 2 * ncomp;
  std::vector<int32_t> ibuf;
  std::vector<float> fbuf;
  bool fl = isf[0] != 0;
  bool mct = mct_on && ncomp >= 3;
  if (mct && fl) {
    fbuf.resize((size_t)3 * n);
    const float *y = reinterpret_cast<const float *>(ptrs[0]);
    const float *u = reinterpret_cast<const float *>(ptrs[1]);
    const float *v = reinterpret_cast<const float *>(ptrs[2]);
    for (int64_t i = 0; i < n; ++i) {
      float yy = y[i], uu = u[i], vv = v[i];
      float vr = vv * 1.402f;
      float r = yy + vr;
      float ug = uu * 0.34413f, vg = vv * 0.71414f;
      float g = yy - ug;
      g = g - vg;
      float ub = uu * 1.772f;
      float b = yy + ub;
      fbuf[i] = r;
      fbuf[n + i] = g;
      fbuf[2 * n + i] = b;
    }
  } else if (mct) {
    ibuf.resize((size_t)3 * n);
    const int32_t *y = reinterpret_cast<const int32_t *>(ptrs[0]);
    const int32_t *u = reinterpret_cast<const int32_t *>(ptrs[1]);
    const int32_t *v = reinterpret_cast<const int32_t *>(ptrs[2]);
    for (int64_t i = 0; i < n; ++i) {
      int32_t g = y[i] - ((u[i] + v[i]) >> 2);
      ibuf[i] = v[i] + g;
      ibuf[n + i] = g;
      ibuf[2 * n + i] = u[i] + g;
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    const int bits = prec[c];
    const int64_t lo = sgnd[c] ? -(1LL << (bits - 1)) : 0;
    const int64_t hi = sgnd[c] ? (1LL << (bits - 1)) - 1 : (1LL << bits) - 1;
    const int64_t shift = sgnd[c] ? 0 : (1LL << (bits - 1));
    int32_t *o = reinterpret_cast<int32_t *>(ptrs[ncomp + c]);
    const bool from_mct = mct && c < 3;
    if (isf[c]) {
      const float *s = from_mct ? fbuf.data() + (size_t)c * n
                                : reinterpret_cast<const float *>(ptrs[c]);
      for (int64_t i = 0; i < n; ++i) {
        float v = s[i];
        int64_t q;
        if (v > 2147483647.0f) q = hi;
        else if (v < -2147483648.0f) q = lo;
        else q = std::min(hi, std::max(lo, (int64_t)std::lrintf(v) + shift));
        o[i] = (int32_t)q;
      }
    } else {
      const int32_t *s = from_mct ? ibuf.data() + (size_t)c * n
                                  : reinterpret_cast<const int32_t *>(ptrs[c]);
      for (int64_t i = 0; i < n; ++i)
        o[i] = (int32_t)std::min(hi, std::max(lo, (int64_t)s[i] + shift));
    }
  }
  return 0;
}

}  // extern "C"
