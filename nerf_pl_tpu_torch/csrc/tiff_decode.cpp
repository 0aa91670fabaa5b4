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
//     and a packet the data cuts short is an error.
//
// Each fills `out` (of `cap` bytes) and returns the bytes written, or a
// negative code with a message in `err`.  As libtiff, a stream that ends
// before `cap` bytes leaves the rest as it was (zero), and output past
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
  while (true) {
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

}  // extern "C"
