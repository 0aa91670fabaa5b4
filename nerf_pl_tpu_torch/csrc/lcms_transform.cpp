// The per-pixel stage of the port's LAB -> RGB conversion
// (nerf_pl_tpu_torch/data/lcms.py), built with g++ at first use and called
// through ctypes.
//
// LittleCMS 2.17 optimises Pillow's transform (the built-in Lab V2 profile
// to the built-in sRGB profile, perceptual, 8-bit input) into one 16-bit
// CLUT of 33 nodes an axis; each pixel then goes through cmsintrp.c's
// TetrahedralInterp16:
//
//   * each 8-bit channel is widened to 16 bits as x * 257, scaled to the
//     grid in 16.16 fixed point (_cmsToFixedDomain(x * 257 * 32)): the
//     node below and the fraction;
//   * the cube's six tetrahedra are told apart by the fractions' order,
//     and the output is c0 + ((r + (r >> 16)) >> 16) with
//     r = c1 rx + c2 ry + c3 rz + 0x8001;
//   * the 16-bit result narrows to 8 bits as (v * 65281 + 8388608) >> 24
//     (FROM_16_TO_8).
//
// lcms_lab_to_rgb reads n pixels of `stride` bytes (L, a, b first, as
// Pillow's core image holds them: a and b offset by 128) and writes n
// RGB triplets.  The table is (33, 33, 33, 3) uint16 in C order.

#include <cstdint>

namespace {

constexpr int kNodes = 33;

inline int32_t to_fixed_domain(int32_t a) { return a + ((a + 0x7fff) / 0xffff); }

}  // namespace

extern "C" {

void lcms_lab_to_rgb(const uint8_t *in, int64_t n, int64_t stride,
                     const uint16_t *clut, uint8_t *out) {
  // the grid position of each 8-bit value: node offset and 16-bit fraction
  int32_t node[256], rest[256];
  for (int v = 0; v < 256; ++v) {
    const int32_t f = to_fixed_domain(v * 257 * (kNodes - 1));
    node[v] = f >> 16;
    rest[v] = f & 0xffff;
  }
  const int32_t ox = 3 * kNodes * kNodes, oy = 3 * kNodes, oz = 3;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t *p = in + i * stride;
    const int32_t rx = rest[p[0]], ry = rest[p[1]], rz = rest[p[2]];
    // the next node along each axis; none past the last (input 0xFFFF)
    const int32_t x1 = p[0] == 255 ? 0 : ox;
    const int32_t y1 = p[1] == 255 ? 0 : oy;
    const int32_t z1 = p[2] == 255 ? 0 : oz;
    const uint16_t *t = clut + node[p[0]] * ox + node[p[1]] * oy + node[p[2]] * oz;
    uint8_t *o = out + 3 * i;
    for (int k = 0; k < 3; ++k, ++t) {
      const int32_t c0 = t[0];
      int32_t c1, c2, c3;
      if (rx >= ry) {
        if (ry >= rz) {
          c1 = t[x1] - c0;
          c2 = t[x1 + y1] - t[x1];
          c3 = t[x1 + y1 + z1] - t[x1 + y1];
        } else if (rz >= rx) {
          c1 = t[x1 + z1] - t[z1];
          c2 = t[x1 + y1 + z1] - t[x1 + z1];
          c3 = t[z1] - c0;
        } else {
          c1 = t[x1] - c0;
          c2 = t[x1 + y1 + z1] - t[x1 + z1];
          c3 = t[x1 + z1] - t[x1];
        }
      } else {
        if (rx >= rz) {
          c1 = t[x1 + y1] - t[y1];
          c2 = t[y1] - c0;
          c3 = t[x1 + y1 + z1] - t[x1 + y1];
        } else if (ry >= rz) {
          c1 = t[x1 + y1 + z1] - t[y1 + z1];
          c2 = t[y1] - c0;
          c3 = t[y1 + z1] - t[y1];
        } else {
          c1 = t[x1 + y1 + z1] - t[y1 + z1];
          c2 = t[y1 + z1] - t[z1];
          c3 = t[z1] - c0;
        }
      }
      // in 64 bits: LittleCMS's 32-bit sum never wraps on this table
      const int64_t r = int64_t{c1} * rx + int64_t{c2} * ry + int64_t{c3} * rz + 0x8001;
      const uint32_t v = static_cast<uint16_t>(c0 + ((r + (r >> 16)) >> 16));
      o[k] = static_cast<uint8_t>((v * 65281u + 8388608u) >> 24);
    }
  }
}

}  // extern "C"
