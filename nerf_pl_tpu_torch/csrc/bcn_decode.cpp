// The block stage of the port's DDS reader (nerf_pl_tpu_torch/data/dds.py),
// built with g++ at first use and called through ctypes.  It decodes BC1-BC7
// blocks as Pillow's BcnDecode.c does, bit for bit (the plain version,
// dds.decode_blocks_plain, is held against Pillow and against this file):
//
//   1 BC1: the 5-6-5 endpoints, 4 colours where c0 > c1, else 3 and a
//     transparent black; thirds and halves truncated;
//   2 BC2: BC1's colours always 4, a 4-bit alpha a pixel (v << 4 | v);
//   3 BC3: BC1's colours always 4, BC3's 8 or 6 interpolated alphas
//     (sevenths or fifths, truncated; 0 and 255 in the 6-level table);
//   4 BC4: one BC3 alpha block as L;
//   5 BC5: two as R and G, B 0 (signed: each endpoint's byte + 128, B 128);
//   6 BC6H: the 14 modes (Microsoft's bit layouts), deltas added modulo
//     the endpoint width, endpoints kept in 16 bits, unquantised, lerped
//     without rounding, finished to a half (31/64, or 31/32 signed),
//     clamped to [0, 1] and scaled by 255 in float32, truncated; a NaN gives
//     0 and the reserved modes black;
//   7 BC7: the 8 modes with their partitions, anchors, p-bits, rotations and
//     index selection; a first byte of 0 gives opaque black.
//
// bcn_decode writes (h, w, C) bytes: C = 4 for 1-3 and 7, 3 for 5-6, 1 for 4;
// the blocks run left to right, top to bottom, clipped at the edges.

#include <cstdint>
#include <cstring>

namespace {

struct Px {
  int v[4];
};

uint64_t load64(const uint8_t *p) {
  uint64_t v = 0;
  for (int k = 0; k < 8; ++k) v |= (uint64_t)p[k] << (8 * k);
  return v;
}

// 128 bits, least significant first
struct Bits {
  uint64_t lo, hi;
  int pos = 0;
  explicit Bits(const uint8_t *p) : lo(load64(p)), hi(load64(p + 8)) {}
  int at(int p) const { return (int)(p < 64 ? (lo >> p) & 1 : (hi >> (p - 64)) & 1); }
  int peek(int p, int n) const {
    int v = 0;
    for (int k = 0; k < n; ++k) v |= at(p + k) << k;
    return v;
  }
  int take(int n) {
    int v = peek(pos, n);
    pos += n;
    return v;
  }
};

void bc1_color(const uint8_t *s, bool separate_alpha, Px *out) {
  int c0 = s[0] | (s[1] << 8), c1 = s[2] | (s[3] << 8);
  uint32_t lut = (uint32_t)s[4] | ((uint32_t)s[5] << 8) | ((uint32_t)s[6] << 16) |
                 ((uint32_t)s[7] << 24);
  int p[4][4];
  int cs[2] = {c0, c1};
  for (int k = 0; k < 2; ++k) {
    int r = (cs[k] & 0xF800) >> 8, g = (cs[k] & 0x7E0) >> 3, b = (cs[k] & 0x1F) << 3;
    p[k][0] = r | (r >> 5);
    p[k][1] = g | (g >> 6);
    p[k][2] = b | (b >> 5);
    p[k][3] = 255;
  }
  bool four = c0 > c1 || separate_alpha;
  for (int c = 0; c < 3; ++c) {
    if (four) {
      p[2][c] = (2 * p[0][c] + p[1][c]) / 3;
      p[3][c] = (p[0][c] + 2 * p[1][c]) / 3;
    } else {
      p[2][c] = (p[0][c] + p[1][c]) / 2;
      p[3][c] = 0;
    }
  }
  p[2][3] = 255;
  p[3][3] = four ? 255 : 0;
  for (int n = 0; n < 16; ++n) {
    int sel = (lut >> (2 * n)) & 3;
    for (int c = 0; c < 4; ++c) out[n].v[c] = p[sel][c];
  }
}

void bc3_alpha(const uint8_t *s, bool sign, Px *out, int ch) {
  int a0 = sign ? (s[0] ^ 0x80) : s[0];
  int a1 = sign ? (s[1] ^ 0x80) : s[1];
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  uint64_t bits = 0;
  for (int k = 0; k < 6; ++k) bits |= (uint64_t)s[2 + k] << (8 * k);
  for (int n = 0; n < 16; ++n) out[n].v[ch] = a[(bits >> (3 * n)) & 7] & 0xFF;
}

const int kBc7Modes[8][10] = {
    // subsets, partition, rotation, index selection, colour, alpha bits,
    // p-bit per endpoint, per subset, index bits, second index bits
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t kP2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const uint32_t kP3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254};
const uint8_t kA2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                         15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                         15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                         6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kA3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                          3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                          8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                          3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kA3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                          15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                          15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                          15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int kW2[4] = {0, 21, 43, 64};
const int kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int *weights(int n) { return n == 2 ? kW2 : (n == 3 ? kW3 : kW4); }

int subset(int ns, int part, int i) {
  if (ns == 2) return (kP2[part] >> i) & 1;
  if (ns == 3) return (kP3[part] >> (2 * i)) & 3;
  return 0;
}

void bc7_block(const uint8_t *s, Px *out) {
  if (s[0] == 0) {
    for (int n = 0; n < 16; ++n) out[n] = Px{{0, 0, 0, 255}};
    return;
  }
  Bits bits(s);
  int mode = 0;
  while (!bits.take(1)) ++mode;
  const int *m = kBc7Modes[mode];
  int ns = m[0], cb = m[4], ab = m[5], ib = m[8], ib2 = m[9];
  int part = bits.take(m[1]), rot = bits.take(m[2]), isel = bits.take(m[3]);
  int nep = 2 * ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int e = 0; e < nep; ++e) ep[e][c] = bits.take(cb);
  for (int e = 0; e < nep; ++e) ep[e][3] = ab ? bits.take(ab) : 255;
  if (m[6] || m[7]) {
    ++cb;
    if (ab) ++ab;
    int pb[6];
    if (m[6]) {
      for (int e = 0; e < nep; ++e) pb[e] = bits.take(1);
    } else {
      for (int k = 0; k < ns; ++k) pb[2 * k] = pb[2 * k + 1] = bits.take(1);
    }
    for (int e = 0; e < nep; ++e)
      for (int c = 0; c < (ab ? 4 : 3); ++c) ep[e][c] = ((ep[e][c] << 1) | pb[e]) & 0xFF;
  }
  for (int e = 0; e < nep; ++e) {
    for (int c = 0; c < 4; ++c) {
      int n = c < 3 ? cb : ab;
      if (!n) continue;
      int v = (ep[e][c] << (8 - n)) & 0xFF;
      ep[e][c] = v | (v >> n);
    }
  }
  const int *cw = weights(ib);
  const int *aw = weights(ab && ib2 ? ib2 : ib);
  int cbit = bits.pos, abit = cbit + 16 * ib - ns;
  for (int i = 0; i < 16; ++i) {
    int sub = 2 * subset(ns, part, i);
    bool anchor = i == 0 || (ns == 2 && i == kA2[part]) ||
                  (ns == 3 && (i == kA3a[part] || i == kA3b[part]));
    int n = anchor ? ib - 1 : ib;
    int i0 = bits.peek(cbit, n);
    cbit += n;
    int wc, wa;
    if (ab && ib2) {
      int n2 = i == 0 ? ib2 - 1 : ib2;
      int i1 = bits.peek(abit, n2);
      abit += n2;
      wc = isel ? aw[i1] : cw[i0];
      wa = isel ? cw[i0] : aw[i1];
    } else {
      wc = wa = cw[i0];
    }
    const int *e0 = ep[sub], *e1 = ep[sub + 1];
    Px px;
    for (int c = 0; c < 3; ++c) px.v[c] = ((64 - wc) * e0[c] + wc * e1[c] + 32) >> 6;
    px.v[3] = ((64 - wa) * e0[3] + wa * e1[3] + 32) >> 6;
    if (rot) {
      int t = px.v[rot - 1];
      px.v[rot - 1] = px.v[3];
      px.v[3] = t;
    }
    out[i] = px;
  }
}

// BC6H: each mode's fields in stored order, {endpoint value, first bit,
// last bit} (the values rw gw bw rx gx bx ry gy by rz gz bz are 0-11), and
// {subsets, transformed, endpoint bits, delta bits r g b}
struct Field {
  int8_t idx, first, last;
};
enum { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ };
const Field kL0[] = {{GY, 4, 4}, {BY, 4, 4}, {BZ, 4, 4}, {RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9},
                     {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3},
                     {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4},
                     {BZ, 3, 3}};
const Field kL1[] = {{GY, 5, 5}, {GZ, 4, 4}, {GZ, 5, 5}, {RW, 0, 6}, {BZ, 0, 0}, {BZ, 1, 1},
                     {BY, 4, 4}, {GW, 0, 6}, {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 0, 6},
                     {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 5},
                     {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 5}, {RZ, 0, 5}};
const Field kL2[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 4}, {RW, 10, 10}, {GY, 0, 3},
                     {GX, 0, 3}, {GW, 10, 10}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10},
                     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}};
const Field kL3[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10}, {GZ, 4, 4},
                     {GY, 0, 3}, {GX, 0, 4}, {GW, 10, 10}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10},
                     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 0, 0}, {BZ, 2, 2}, {RZ, 0, 3},
                     {GY, 4, 4}, {BZ, 3, 3}};
const Field kL4[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10}, {BY, 4, 4},
                     {GY, 0, 3}, {GX, 0, 3}, {GW, 10, 10}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4},
                     {BW, 10, 10}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 1, 1}, {BZ, 2, 2}, {RZ, 0, 3},
                     {BZ, 4, 4}, {BZ, 3, 3}};
const Field kL5[] = {{RW, 0, 8}, {BY, 4, 4}, {GW, 0, 8}, {GY, 4, 4}, {BW, 0, 8}, {BZ, 4, 4},
                     {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3},
                     {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4},
                     {BZ, 3, 3}};
const Field kL6[] = {{RW, 0, 7}, {GZ, 4, 4}, {BY, 4, 4}, {GW, 0, 7}, {BZ, 2, 2}, {GY, 4, 4},
                     {BW, 0, 7}, {BZ, 3, 3}, {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 4},
                     {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 5},
                     {RZ, 0, 5}};
const Field kL7[] = {{RW, 0, 7}, {BZ, 0, 0}, {BY, 4, 4}, {GW, 0, 7}, {GY, 5, 5}, {GY, 4, 4},
                     {BW, 0, 7}, {GZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3},
                     {GX, 0, 5}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4},
                     {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}};
const Field kL8[] = {{RW, 0, 7}, {BZ, 1, 1}, {BY, 4, 4}, {GW, 0, 7}, {BY, 5, 5}, {GY, 4, 4},
                     {BW, 0, 7}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3},
                     {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 4},
                     {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}};
const Field kL9[] = {{RW, 0, 5}, {GZ, 4, 4}, {BZ, 0, 0}, {BZ, 1, 1}, {BY, 4, 4}, {GW, 0, 5},
                     {GY, 5, 5}, {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 0, 5}, {GZ, 5, 5},
                     {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 5},
                     {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 5}, {RZ, 0, 5}};
const Field kL10[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 9}, {GX, 0, 9}, {BX, 0, 9}};
const Field kL11[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 8}, {RW, 10, 10},
                      {GX, 0, 8}, {GW, 10, 10}, {BX, 0, 8}, {BW, 10, 10}};
const Field kL12[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 7}, {RW, 11, 10},
                      {GX, 0, 7}, {GW, 11, 10}, {BX, 0, 7}, {BW, 11, 10}};
const Field kL13[] = {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 15, 10},
                      {GX, 0, 3}, {GW, 15, 10}, {BX, 0, 3}, {BW, 15, 10}};
#define LAYOUT(L) {L, (int)(sizeof(L) / sizeof(L[0]))}
const struct {
  const Field *f;
  int n;
} kLayouts[14] = {LAYOUT(kL0),  LAYOUT(kL1),  LAYOUT(kL2),  LAYOUT(kL3),  LAYOUT(kL4),
                  LAYOUT(kL5),  LAYOUT(kL6),  LAYOUT(kL7),  LAYOUT(kL8),  LAYOUT(kL9),
                  LAYOUT(kL10), LAYOUT(kL11), LAYOUT(kL12), LAYOUT(kL13)};
#undef LAYOUT
const int kBc6Modes[14][6] = {{2, 1, 10, 5, 5, 5}, {2, 1, 7, 6, 6, 6},  {2, 1, 11, 5, 4, 4},
                              {2, 1, 11, 4, 5, 4}, {2, 1, 11, 4, 4, 5}, {2, 1, 9, 5, 5, 5},
                              {2, 1, 8, 6, 5, 5},  {2, 1, 8, 5, 6, 5},  {2, 1, 8, 5, 5, 6},
                              {2, 0, 6, 6, 6, 6},  {1, 0, 10, 10, 10, 10}, {1, 1, 11, 9, 9, 9},
                              {1, 1, 12, 8, 8, 8}, {1, 1, 16, 4, 4, 4}};

int sext(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v >> (bits - 1)) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
  }
  int x = sext(v, 16);
  if (bits >= 16) return x;
  bool neg = x < 0;
  if (neg) x = -x;
  if (x == 0) return 0;
  x = x >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (bits - 1);
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  int exp = (h >> 10) & 31, man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalise
      int e = -1;
      do {
        ++e;
        man <<= 1;
      } while (!(man & 0x400));
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((uint32_t)(man & 0x3FF) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | ((uint32_t)man << 13);
  } else {
    bits = sign | ((uint32_t)(exp - 15 + 127) << 23) | ((uint32_t)man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

int bc6_channel(int v, bool sign) {
  int h = sign ? (v < 0 ? 0x8000 | ((-v * 31) >> 5) : (v * 31) >> 5) : (v * 31) >> 6;
  float f = half_to_float((uint16_t)h);
  if (f > 1.0f) return 255;
  if (!(f > 0.0f)) return 0;
  return (int)(f * 255.0f);
}

void bc6_block(const uint8_t *s, bool sign, Px *out) {
  Bits bits(s);
  int m = bits.take(2), mode;
  if (m < 2) {
    mode = m;
  } else {
    m |= bits.take(3) << 2;
    if ((m & 3) == 2) {
      mode = 2 + (m >> 2);
    } else {
      mode = 10 + (m >> 2);
      if (mode > 13) {  // reserved: black
        for (int n = 0; n < 16; ++n) out[n] = Px{{0, 0, 0, 0}};
        return;
      }
    }
  }
  const int *md = kBc6Modes[mode];
  int ns = md[0], tr = md[1], epb = md[2];
  int e[12] = {0};
  for (int k = 0; k < kLayouts[mode].n; ++k) {
    const Field &f = kLayouts[mode].f[k];
    int step = f.last >= f.first ? 1 : -1;
    for (int b = f.first;; b += step) {
      e[f.idx] |= bits.take(1) << b;
      if (b == f.last) break;
    }
  }
  int part = ns == 2 ? bits.take(5) : 0;
  int nep = ns == 1 ? 6 : 12, mask = (1 << epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) e[c] = sext(e[c], epb);
  if (sign || tr)
    for (int i = 3; i < nep; ++i) e[i] = sext(e[i], md[3 + i % 3]);
  if (tr)
    for (int i = 3; i < nep; ++i) e[i] = (e[i] + e[i % 3]) & mask;
  int u[12];
  for (int i = 0; i < nep; ++i) u[i] = bc6_unquantize(e[i] & 0xFFFF, epb, sign);
  int ib = ns == 1 ? 4 : 3;
  const int *w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    int sub = 6 * subset(ns, part, i);
    int n = (i == 0 || (ns == 2 && i == kA2[part])) ? ib - 1 : ib;
    int k = w[bits.take(n)];
    Px px{{0, 0, 0, 0}};
    for (int c = 0; c < 3; ++c)
      px.v[c] = bc6_channel((u[sub + c] * (64 - k) + u[sub + 3 + c] * k) >> 6, sign);
    out[i] = px;
  }
}

}  // namespace

extern "C" {

int bcn_decode(const uint8_t *in, int64_t n_bytes, int kind, int sign, int32_t w, int32_t h,
               uint8_t *out) {
  if (kind < 1 || kind > 7) return -1;
  const int size = (kind == 1 || kind == 4) ? 8 : 16;
  const int ch = kind == 4 ? 1 : (kind == 5 || kind == 6 ? 3 : 4);
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (n_bytes < bw * bh * size) return -2;
  Px px[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t *s = in + (by * bw + bx) * size;
      switch (kind) {
        case 1:
          bc1_color(s, false, px);
          break;
        case 2:
          bc1_color(s + 8, true, px);
          for (int k = 0; k < 16; ++k) {
            int v = (s[k / 2] >> (4 * (k & 1))) & 15;
            px[k].v[3] = (v << 4) | v;
          }
          break;
        case 3:
          bc1_color(s + 8, true, px);
          bc3_alpha(s, false, px, 3);
          break;
        case 4:
          bc3_alpha(s, false, px, 0);
          break;
        case 5:
          for (int k = 0; k < 16; ++k) px[k].v[2] = sign ? 128 : 0;
          bc3_alpha(s, sign, px, 0);
          bc3_alpha(s + 8, sign, px, 1);
          break;
        case 6:
          bc6_block(s, sign, px);
          break;
        default:
          bc7_block(s, px);
      }
      for (int j = 0; j < 4; ++j) {
        int64_t y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; ++i) {
          int64_t x = bx * 4 + i;
          if (x >= w) break;
          uint8_t *d = out + (y * w + x) * ch;
          for (int c = 0; c < ch; ++c) d[c] = (uint8_t)px[j * 4 + i].v[c];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
