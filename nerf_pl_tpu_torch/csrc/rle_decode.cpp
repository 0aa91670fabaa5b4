// The byte-stream stages of the port's TGA, PCX, SGI and QOI readers
// (nerf_pl_tpu_torch/data/{tga,pcx,sgi,qoi}.py, bound in data/rle.py), built
// with g++ at first use and called through ctypes.  Each decodes as Pillow's
// decoder of that format does (TgaRleDecode.c, PcxDecode.c, SgiRleDecode.c,
// QoiImagePlugin.QoiDecoder); each module's *_plain function is the same
// stage in Python, which the tests hold this file against.
//
//   * tga_rle: packets of `depth`-byte pixels; a raw packet runs on into the
//     next row, a run packet that reaches past its row is an overrun;
//   * pcx_rle: rows of `row_bytes`; a byte of 0xC0 and up is a run of its
//     low 6 bits of the next byte, any other a literal; a run past its row
//     is an overrun (the rest of it dropped, the decode going on);
//   * sgi_rle: each row of each channel from its start and length (the
//     tables after the 512-byte header), 1 or 2 bytes a sample, into one row
//     buffer kept from row to row, channels interleaved; a count byte of 0
//     ends a row, one whose high bit is set copies, any other repeats; a row
//     whose last unit is not 0 ends the decode there, leaving the rest of
//     the image 0 (as Pillow);
//   * qoi_decode: the QOI op stream (index, diff, luma, run, RGB, RGBA) with
//     its 64-entry index of (3r + 5g + 7b + 11a) % 64, from (0, 0, 0, 255),
//     into RGBA; a run does not enter the index, an index op does, at its
//     value's own hash (an empty slot reads as 0, 0, 0, 0).
//
// Each returns 0, -1 where the data ends first (Pillow's "image file is
// truncated") or -2 for an overrun ("buffer overrun").

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int tga_rle(const uint8_t *in, int64_t n, int32_t w, int32_t h, int32_t depth, uint8_t *out) {
  const int64_t row = (int64_t)w * depth, total = row * h;
  int64_t pos = 0, o = 0;
  while (o < total) {
    if (pos >= n) return -1;
    const int c = in[pos];
    const int64_t count = (c & 0x7F) + 1, bytes = count * depth;
    if (c & 0x80) {
      if (pos + 1 + depth > n) return -1;
      if (o % row + bytes > row) return -2;
      for (int64_t k = 0; k < count; ++k) memcpy(out + o + k * depth, in + pos + 1, depth);
      o += bytes;
      pos += 1 + depth;
    } else {
      if (pos + 1 + bytes > n) return -1;
      const int64_t keep = bytes < total - o ? bytes : total - o;
      memcpy(out + o, in + pos + 1, keep);
      o += keep;
      pos += 1 + bytes;
    }
  }
  return 0;
}

int pcx_rle(const uint8_t *in, int64_t n, int64_t row_bytes, int32_t h, uint8_t *out) {
  int64_t pos = 0, x = 0, y = 0;
  int status = 0;
  while (y < h) {
    if (pos >= n) return -1;
    const int c = in[pos];
    if ((c & 0xC0) == 0xC0) {
      if (pos + 2 > n) return -1;
      int k = c & 0x3F;
      for (; k > 0; --k) {
        if (x >= row_bytes) {
          status = -2;
          break;
        }
        out[y * row_bytes + x++] = in[pos + 1];
      }
      pos += 2;
    } else {
      out[y * row_bytes + x++] = (uint8_t)c;
      ++pos;
    }
    if (x >= row_bytes) {
      x = 0;
      ++y;
    }
  }
  return status;
}

int sgi_rle(const uint8_t *data, int64_t n, int32_t xsize, int32_t ysize, int32_t zsize,
            int32_t bpc, const uint32_t *starts, const uint32_t *lengths, uint8_t *out) {
  const int64_t bufsize = n - 512;
  if (bufsize < 8 * (int64_t)zsize * ysize) return -2;
  const uint8_t *buf = data + 512;
  const int64_t stride = (int64_t)xsize * zsize * bpc;
  std::vector<uint8_t> line(stride, 0);
  for (int32_t y = 0; y < ysize; ++y) {
    for (int32_t z = 0; z < zsize; ++z) {
      int64_t off = starts[y + z * ysize];
      int64_t len = lengths[y + z * ysize];
      if (off < 512) return -2;
      off -= 512;
      int64_t src = off, x = 0;
      uint8_t *dst = line.data() + (int64_t)z * bpc;
      const int64_t step = (int64_t)zsize * bpc;
      for (; len > 0; --len) {
        if (src + (bpc - 1) > bufsize - 1) return -2;
        const int c = buf[src + bpc - 1];
        src += bpc;
        if (len == 1 && c != 0) return 0;  // Pillow stops here, no error
        const int count = c & 0x7F;
        if (!count) break;
        if (x + count > xsize) return -2;
        if (c & 0x80) {
          if (src + (int64_t)bpc * count > bufsize - 1) return -2;
          for (int k = 0; k < count; ++k) {
            memcpy(dst + (x + k) * step, buf + src, bpc);
            src += bpc;
          }
        } else {
          if (src + bpc - 1 > bufsize - 1) return -2;
          for (int k = 0; k < count; ++k) memcpy(dst + (x + k) * step, buf + src, bpc);
          src += bpc;
        }
        x += count;
      }
    }
    memcpy(out + (int64_t)y * stride, line.data(), stride);
  }
  return 0;
}

int qoi_decode(const uint8_t *in, int64_t n, int64_t npix, uint8_t *out) {
  uint8_t index[64][4];
  memset(index, 0, sizeof(index));
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 0, p = 0;
  while (p < npix) {
    if (pos >= n) return -1;
    const int b = in[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (pos + 3 > n) return -1;
      v[0] = in[pos];
      v[1] = in[pos + 1];
      v[2] = in[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (pos + 4 > n) return -1;
      memcpy(v, in + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      memcpy(v, index[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= n) return -1;
      const int b2 = in[pos++];
      const int dg = (b & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + ((b2 >> 4) & 15) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (b2 & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int k = (b & 63) + 1; k > 0 && p < npix; --k) memcpy(out + 4 * p++, prev, 4);
      continue;
    }
    memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    memcpy(prev, v, 4);
    memcpy(out + 4 * p++, v, 4);
  }
  return 0;
}

}  // extern "C"
