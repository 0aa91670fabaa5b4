// The byte-stream stages of the port's TGA, PCX, SGI, QOI, SUN, MSP, FLI and
// ICNS readers (nerf_pl_tpu_torch/data/{tga,pcx,sgi,qoi,sun,msp,fli,icns}.py,
// bound in data/rle.py), built with g++ at first use and called through
// ctypes.  Each decodes as Pillow's decoder of that format does
// (TgaRleDecode.c, PcxDecode.c, SgiRleDecode.c, QoiImagePlugin.QoiDecoder,
// SunRleDecode.c, MspImagePlugin.MspDecoder, FliDecode.c,
// IcnsImagePlugin.read_32); each module's *_plain function is the same stage
// in Python, which the tests hold this file against.
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
//   * sun_rle: rows of `row_bytes` (no padding); 0x80 0 is a literal 0x80,
//     0x80 n v a run of n + 1 bytes v, which goes on into the next rows,
//     any other byte a literal;
//   * msp_rows: MSP v2's row map (one little-endian word a row, after the
//     32-byte header) and its rows: a 0 type byte is a run (count, value),
//     any other a literal of that many bytes (fewer where the row ends
//     first); an empty row is a white row of ceil(w / 8) bytes.  The rows'
//     bytes are joined with nothing between them (Pillow reads them as one
//     raw stream); the first `cap` go to `out` and the count of all is
//     returned, or -1 (a short row map), -3 (a short row), -4 (a run past
//     its row);
//   * fli_frame: one FLI/FLC frame chunk (0xF1FA) of the bytes Pillow's
//     decoder holds, its subchunks COLOR (4, 11; skipped), SS2 (7), LC
//     (12), BLACK (13), BRUN (15), COPY (16) and PSTAMP (18; skipped) on a
//     zeroed P image; -2 where a chunk reads past the data or its lines,
//     -3 for another chunk type, -4 for a subchunk of size 0;
//   * icns_rgb: three channels of `npix` bytes, each a stream of runs (a
//     byte of 0x80 and up repeats the next byte `b - 125` times, any other
//     copies the next `b + 1` bytes); -2 where a channel's counts do not
//     end at `npix` (Pillow's "Error reading channel"), -1 where the bytes
//     run out inside a run (not enough image data).
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

int sun_rle(const uint8_t *in, int64_t n, int64_t row_bytes, int32_t h, uint8_t *out) {
  const int64_t total = row_bytes * h;
  int64_t pos = 0, o = 0;
  while (o < total) {
    if (pos >= n) return -1;
    if (in[pos] == 0x80) {
      if (pos + 2 > n) return -1;
      if (in[pos + 1] == 0) {
        out[o++] = 0x80;
        pos += 2;
      } else {
        if (pos + 3 > n) return -1;
        int64_t k = (int64_t)in[pos + 1] + 1;
        if (k > total - o) k = total - o;
        memset(out + o, in[pos + 2], k);
        o += k;
        pos += 3;
      }
    } else {
      out[o++] = in[pos++];
    }
  }
  return 0;
}

int64_t msp_rows(const uint8_t *in, int64_t n, int32_t w, int32_t h, int64_t cap, uint8_t *out) {
  if (32 + 2 * (int64_t)h > n) return -1;
  const int64_t blank = (w + 7) / 8;
  int64_t pos = 32 + 2 * (int64_t)h, o = 0;
  auto put = [&](const uint8_t *src, int64_t k, int fill) {
    for (int64_t i = 0; i < k; ++i, ++o)
      if (o < cap) out[o] = src ? src[i] : (uint8_t)fill;
  };
  for (int32_t y = 0; y < h; ++y) {
    const int64_t rowlen = in[32 + 2 * y] | (in[33 + 2 * y] << 8);
    if (rowlen == 0) {
      put(nullptr, blank, 0xFF);
      continue;
    }
    if (pos + rowlen > n) return -3;
    const uint8_t *row = in + pos;
    pos += rowlen;
    int64_t i = 0;
    while (i < rowlen) {
      const int type = row[i++];
      if (type == 0) {
        if (i + 2 > rowlen) return -4;
        put(nullptr, row[i], row[i + 1]);
        i += 2;
      } else {
        const int64_t k = i + type <= rowlen ? type : rowlen - i;
        put(row + i, k, 0);
        i += type;
      }
    }
  }
  return o;
}

static inline int i16le(const uint8_t *p) { return p[0] | (p[1] << 8); }
static inline int64_t i32le(const uint8_t *p) {
  return (int64_t)(int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

int fli_frame(const uint8_t *buf, int64_t bytes, int32_t w, int32_t h, uint8_t *im) {
  if (bytes < 8) return -2;
  if (i16le(buf + 4) != 0xF1FA) return -3;
  const int chunks = i16le(buf + 6);
  const uint8_t *ptr = buf + 16;
  bytes -= 16;
#define OOB(k) \
  if (data + (k) > ptr + bytes) return -2;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return -2;
    const uint8_t *data = ptr + 6;
    const int type = i16le(ptr + 4);
    if (type == 4 || type == 11 || type == 18) {
      // palette (read by the opener) and postage stamp: skipped
    } else if (type == 7) {  // SS2: word runs
      const int lines = i16le(data);
      data += 2;
      int l = 0, y = 0;
      for (; l < lines && y < h; ++l, ++y) {
        uint8_t *row = im + (int64_t)y * w;
        OOB(2)
        int packets = i16le(data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {
            y += 65536 - packets;
            if (y >= h) return -2;
            row = im + (int64_t)y * w;
          } else {
            row[w - 1] = (uint8_t)packets;
          }
          OOB(2)
          packets = i16le(data);
          data += 2;
        }
        int p = 0, x = 0;
        for (; p < packets; ++p) {
          OOB(2)
          x += data[0];
          if (data[1] >= 128) {
            OOB(4)
            const int k = 256 - data[1];
            if (x + k + k > w) break;
            for (int j = 0; j < k; ++j) {
              row[x++] = data[2];
              row[x++] = data[3];
            }
            data += 4;
          } else {
            const int k = 2 * data[1];
            if (x + k > w) break;
            OOB(2 + k)
            memcpy(row + x, data + 2, k);
            data += 2 + k;
            x += k;
          }
        }
        if (p < packets) break;
      }
      if (l < lines) return -2;
    } else if (type == 12) {  // LC: byte runs on a band of lines
      int y = i16le(data);
      const int ymax = y + i16le(data + 2);
      data += 4;
      for (; y < ymax && y < h; ++y) {
        uint8_t *row = im + (int64_t)y * w;
        OOB(1)
        const int packets = *data++;
        int p = 0, x = 0, k = 0;
        for (; p < packets; ++p, x += k) {
          OOB(2)
          x += data[0];
          if (data[1] & 0x80) {
            k = 256 - data[1];
            if (x + k > w) break;
            OOB(3)
            memset(row + x, data[2], k);
            data += 3;
          } else {
            k = data[1];
            if (x + k > w) break;
            OOB(2 + k)
            memcpy(row + x, data + 2, k);
            data += k + 2;
          }
        }
        if (p < packets) break;
      }
      if (y < ymax) return -2;
    } else if (type == 13) {  // BLACK
      memset(im, 0, (size_t)w * h);
    } else if (type == 15) {  // BRUN: byte runs on every line
      for (int y = 0; y < h; ++y) {
        uint8_t *row = im + (int64_t)y * w;
        data += 1;  // the packet count, ignored
        int x = 0, k = 0;
        for (; x < w; x += k) {
          OOB(2)
          if (data[0] & 0x80) {
            k = 256 - data[0];
            if (x + k > w) break;
            OOB(k + 1)
            memcpy(row + x, data + 1, k);
            data += k + 1;
          } else {
            k = data[0];
            if (x + k > w) break;
            memset(row + x, data[1], k);
            data += 2;
          }
        }
        if (x != w) return -2;
      }
    } else if (type == 16) {  // COPY
      if (data + (int64_t)w * h > ptr + bytes) return -1;
      memcpy(im, data, (size_t)w * h);
    } else {
      return -3;
    }
    const int64_t advance = i32le(ptr);
    if (advance == 0) return -4;
    if (advance < 0 || advance > bytes) return -2;
    ptr += advance;
    bytes -= advance;
  }
#undef OOB
  return 0;
}

int icns_rgb(const uint8_t *in, int64_t n, int64_t npix, uint8_t *out) {
  int64_t pos = 0;
  for (int band = 0; band < 3; ++band) {
    uint8_t *dst = out + band * npix;
    int64_t left = npix, o = 0;
    bool short_data = false;
    while (left > 0) {
      if (pos >= n) break;
      const int b = in[pos++];
      int64_t k;
      if (b & 0x80) {
        k = b - 125;
        if (pos < n) {
          for (int64_t i = 0; i < k && o < npix; ++i) dst[o++] = in[pos];
          ++pos;
        } else {
          short_data = true;
        }
      } else {
        k = b + 1;
        const int64_t got = pos + k <= n ? k : n - pos;
        for (int64_t i = 0; i < got && o < npix; ++i) dst[o++] = in[pos + i];
        if (got < k) short_data = true;
        pos += got;
      }
      left -= k;
    }
    if (left != 0) return -2;
    if (short_data || o < npix) return -1;
  }
  return 0;
}

}  // extern "C"
