// The host stages of the port's TIFF reader (nerf_pl_tpu_torch/data/tiff.py),
// built with g++ at first use and called through ctypes:
//
//   * tiff_lzw: one strip or tile of LZW codes (libtiff's tif_lzw.c):
//     codes first bit first, 9 to 12 bits wide, widening one code early
//     (at 511, 1023, 2047), Clear 256 and EOI 257; a stream that starts
//     with a zero byte and an odd second byte is the old style libtiff
//     still reads (LZWDecodeCompat: codes lowest bit first, widening at
//     512, 1024, 2048);
//   * tiff_packbits: one strip or tile of PackBits runs (tif_packbits.c);
//   * psd_packbits: a PSD channel's PackBits rows as Pillow's
//     PackBitsDecode.c reads them (data/psd.py): each row of `row` bytes
//     takes whole packets, a packet's bytes past its row's end are dropped,
//     and a packet the data cuts short is an error;
//   * tiff_ycbcr: packed YCbCr (libtiff's tif_getimage.c, the RGBA
//     interface Pillow's decoder takes for YCbCr compressed other than as
//     JPEG) to RGB, as putcontig8bitYCbCr<hs><vs>tile puts one strip or
//     tile: each unit holds hs * vs Y samples (row by row) then Cb and Cr
//     for an hs x vs block; blocks that the edge cuts are put in part;
//     after each row of units the input skips what libtiff's `fromskew`
//     becomes ((fromskew / hs) * (hs * vs + 2), but 10 for 4x4, as
//     libtiff has it); each pixel goes through TIFFYCbCrtoRGB's tables.
//
// Each fills `out` (of `cap` bytes) and returns the bytes written, or a
// negative code with a message in `err`.  A stream that ends before `cap`
// bytes leaves the rest as it was (zero): libtiff's LZW then fails ("Not
// enough data", which the reader raises), its PackBits does not; LZW stops
// at `cap` bytes, as libtiff stops, whatever codes follow, and output past
// `cap` is dropped; psd_packbits returns -1 where the data ends first.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

int fail(const char *msg, char *err, int errlen) {
  snprintf(err, errlen, "%s", msg);
  return -1;
}

}  // namespace

extern "C" {

int64_t tiff_lzw(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap,
                 char *err, int errlen) {
  const bool compat = n >= 2 && in[0] == 0 && (in[1] & 1);
  // the table: each code's prefix code, last byte, first byte and length
  std::vector<int32_t> prefix(4096, -1);
  std::vector<uint8_t> last(4096), first(4096);
  std::vector<int32_t> length(4096, 1);
  for (int c = 0; c < 256; ++c) {
    last[c] = first[c] = (uint8_t)c;
  }
  int width = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t pos = 0, o = 0;
  std::vector<uint8_t> stack(4096);
  while (o < cap) {  // libtiff stops at the strip's size, codes or not
    while (nbits < width) {
      if (pos >= n) return o;  // the data ends without EOI
      if (compat) acc |= (uint64_t)in[pos++] << nbits;
      else acc = (acc << 8) | in[pos++];
      nbits += 8;
    }
    int code;
    if (compat) {
      code = (int)(acc & ((1u << width) - 1));
      acc >>= width;
    } else {
      code = (int)((acc >> (nbits - width)) & ((1u << width) - 1));
    }
    nbits -= width;
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    int emit;
    if (prev < 0) {
      if (code > 255) return fail("LZW: a first code past the literals", err, errlen);
      emit = code;
    } else {
      if (code > next || code == 256 || code == 257 || next >= 4096)
        return fail("LZW: a corrupt code", err, errlen);
      // the new entry: prev's string and the first byte of code's (of
      // prev's own when code is the entry being made)
      prefix[next] = prev;
      last[next] = code == next ? first[prev] : first[code];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      emit = code;
      ++next;
      int limit = compat ? (1 << width) : (1 << width) - 1;
      if (next >= limit && width < 12) ++width;
    }
    int len = length[emit];
    int c = emit;
    for (int k = len - 1; k >= 0; --k) {
      stack[k] = last[c];
      c = prefix[c];
    }
    for (int k = 0; k < len && o < cap; ++k) out[o++] = stack[k];
    prev = emit;
  }
  return o;
}

namespace {

// PackBits into `cap` bytes of `out`.  row == 0: the output runs on and a
// packet the data cuts short gives what it holds (libtiff).  row > 0: each
// row of `row` bytes ends its last packet (Pillow), and a packet the data
// cuts short returns -1.
int64_t packbits(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap, int64_t row) {
  int64_t pos = 0, o = 0;
  while (o < cap) {
    if (pos >= n) return row ? -1 : o;
    int h = (int8_t)in[pos++];
    if (h == -128) continue;
    const int64_t end = row ? (o / row + 1) * row : cap;
    if (h >= 0) {
      int64_t k = h + 1;
      if (pos + k > n) {
        if (row) return -1;
        k = n - pos;
      }
      const int64_t keep = o + k > end ? end - o : k;
      memcpy(out + o, in + pos, keep);
      o += keep;
      pos += h + 1;
    } else {
      if (pos >= n) return row ? -1 : o;
      const int64_t k = 1 - h;
      const int64_t keep = o + k > end ? end - o : k;
      memset(out + o, in[pos++], keep);
      o += keep;
    }
  }
  return o;
}

}  // namespace

int64_t tiff_packbits(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap,
                      char *err, int errlen) {
  (void)err;
  (void)errlen;
  return packbits(in, n, out, cap, 0);
}

int64_t psd_packbits(const uint8_t *in, int64_t n, uint8_t *out, int64_t row,
                     int64_t rows) {
  return packbits(in, n, out, row * rows, row);
}

// `w` x `h` pixels of packed units from `in` (n bytes) into `out` (RGB, rows
// `stride` bytes apart); `tabs` holds TIFFYCbCrToRGBInit's Y_tab, Cr_r_tab,
// Cb_b_tab, Cr_g_tab and Cb_g_tab, 256 each.  Returns the bytes read, or -1
// where the units run past `n`.
int64_t tiff_ycbcr(const uint8_t *in, int64_t n, int64_t w, int64_t h, int hs,
                   int vs, int64_t fromskew, const int32_t *tabs, uint8_t *out,
                   int64_t stride) {
  const int32_t *y_tab = tabs, *cr_r = tabs + 256, *cb_b = tabs + 512;
  const int32_t *cr_g = tabs + 768, *cb_g = tabs + 1024;
  const int64_t unit = hs * vs + 2;
  const int64_t across = (w + hs - 1) / hs, down = (h + vs - 1) / vs;
  const int64_t skew = (fromskew / hs) * (hs == 4 && vs == 4 ? 10 : unit);
  if (down > 0 && (down - 1) * (across * unit + skew) + across * unit > n) return -1;
  auto clamp = [](int32_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  const uint8_t *pp = in;
  for (int64_t by = 0; by < down; ++by) {
    for (int64_t bx = 0; bx < across; ++bx, pp += unit) {
      const int cb = pp[unit - 2], cr = pp[unit - 1];
      for (int dy = 0; dy < vs; ++dy) {
        const int64_t y = by * vs + dy;
        if (y >= h) break;
        for (int dx = 0; dx < hs; ++dx) {
          const int64_t x = bx * hs + dx;
          if (x >= w) break;
          const int32_t yv = y_tab[pp[dy * hs + dx]];
          uint8_t *o = out + y * stride + 3 * x;
          o[0] = clamp(yv + cr_r[cr]);
          o[1] = clamp(yv + ((cb_g[cb] + cr_g[cr]) >> 16));
          o[2] = clamp(yv + cb_b[cb]);
        }
      }
    }
    pp += skew;
  }
  return pp - in;
}

}  // extern "C"
