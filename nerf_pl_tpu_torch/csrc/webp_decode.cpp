// The host stages of the port's WebP reader (nerf_pl_tpu_torch/data/webp.py),
// built with g++ at first use and called through ctypes.  Each decodes what
// libwebp's WebPDecode gives for one frame, bit for bit:
//
//   * webp_vp8l: a lossless (VP8L) bitstream into RGBA: the predictor,
//     cross-colour, subtract-green and colour-indexing transforms (with
//     pixel bundling), the colour cache, meta prefix codes, LZ77 with the
//     120-entry distance map (libwebp's src/dec/vp8l_dec.c);
//   * webp_vp8: a lossy (VP8, RFC 6386) key frame into RGB: the boolean
//     decoder, segments and their quantisers, 1/2/4/8 token partitions,
//     intra 16x16, 4x4 and chroma prediction from unfiltered neighbours
//     (libwebp's 127/129 borders and cached top row), dequantisation, the
//     inverse WHT and DCT, the simple and normal loop filters with
//     sharpness and per-segment and per-mode deltas (src/dec/frame_dec.c,
//     src/dsp/dec.c); then the default output path: fancy chroma
//     upsampling and the 14-bit fixed-point YUV -> RGB (src/dsp/upsampling.c,
//     src/dsp/yuv.h);
//   * webp_alpha: an ALPH chunk's payload (raw or VP8L-coded) with its
//     horizontal, vertical or gradient filter undone (src/dec/alpha_dec.c).
//
// Errors return a negative code and write a message into `err`; `seconds`,
// where not null, receives the time of each stage.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Error {
  const char *msg;
};

double now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Tables of RFC 6386 (VP8) and of the WebP lossless format, in libwebp's
// order of the intra 4x4 modes (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU).
static const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
  21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
  36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
  84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
  100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
  126, 97, 111, 80, 113, 127, 96, 112,
};

// ================================================================== VP8L
struct LBits {
  const uint8_t *d;
  size_t n, i = 0;
  uint64_t v = 0;
  int nb = 0;
  LBits(const uint8_t *data, size_t size) : d(data), n(size) {}
  void fill() {
    while (nb <= 56) {
      uint64_t b = i < n ? d[i] : 0;
      ++i;
      v |= b << nb;
      nb += 8;
    }
  }
  uint32_t peek(int k) {
    fill();
    return (uint32_t)(v & ((1ull << k) - 1));
  }
  void skip(int k) {
    v >>= k;
    nb -= k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t r = peek(k);
    skip(k);
    return r;
  }
  // libwebp's VP8LIsEndOfStream: more bits consumed than the data holds
  bool eos() const { return (int64_t)i * 8 - nb > (int64_t)n * 8; }
};

// A canonical prefix code, read first bit first from an LSB-first stream:
// a 256-entry root table on the next 8 bits, and second-level tables for
// the longer codes.  A code of one symbol reads no bits.
struct HEntry {
  uint16_t len, val;
};
struct Huff {
  std::vector<HEntry> t;
};

uint32_t reverse_bits(uint32_t c, int len) {
  uint32_t r = 0;
  for (int k = 0; k < len; ++k) r |= ((c >> k) & 1) << (len - 1 - k);
  return r;
}

bool build_huff(Huff &h, const int *lens, int n) {
  int cnt[16] = {0}, nsym = 0, last = -1;
  for (int s = 0; s < n; ++s) {
    if (lens[s] < 0 || lens[s] > 15) return false;
    if (lens[s]) {
      ++cnt[lens[s]];
      ++nsym;
      last = s;
    }
  }
  if (nsym == 0) return false;
  h.t.assign(256, HEntry{0, 0});
  if (nsym == 1) {
    for (auto &e : h.t) e = HEntry{0, (uint16_t)last};
    return true;
  }
  int left = 1;
  for (int l = 1; l <= 15; ++l) {
    left = 2 * left - cnt[l];
    if (left < 0) return false;
  }
  if (left != 0) return false;  // an incomplete code, as libwebp refuses
  int next[16] = {0}, code = 0;
  for (int l = 1; l <= 15; ++l) {
    code = (code + cnt[l - 1]) << 1;
    next[l] = code;
  }
  std::vector<uint32_t> rev(n, 0);
  int maxsub[256] = {0};
  for (int s = 0; s < n; ++s) {
    int l = lens[s];
    if (!l) continue;
    uint32_t r = reverse_bits(next[l]++, l);
    rev[s] = r;
    if (l <= 8) {
      for (uint32_t k = r; k < 256; k += 1u << l) h.t[k] = HEntry{(uint16_t)l, (uint16_t)s};
    } else if (l - 8 > maxsub[r & 255]) {
      maxsub[r & 255] = l - 8;
    }
  }
  for (int root = 0; root < 256; ++root) {
    if (!maxsub[root]) continue;
    h.t[root] = HEntry{(uint16_t)(16 + maxsub[root]), (uint16_t)h.t.size()};
    h.t.resize(h.t.size() + (1u << maxsub[root]));
  }
  for (int s = 0; s < n; ++s) {
    int l = lens[s];
    if (l <= 8) continue;
    HEntry root = h.t[rev[s] & 255];
    int sb = root.len - 16;
    for (uint32_t k = rev[s] >> 8; k < (1u << sb); k += 1u << (l - 8))
      h.t[root.val + k] = HEntry{(uint16_t)l, (uint16_t)s};
  }
  return true;
}

inline int read_sym(const Huff &h, LBits &br) {
  uint32_t p = br.peek(15);
  HEntry e = h.t[p & 255];
  if (e.len > 16) e = h.t[e.val + ((p >> 8) & ((1u << (e.len - 16)) - 1))];
  br.skip(e.len);
  return e.val;
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

void read_code(LBits &br, int alphabet, Huff &out) {
  std::vector<int> lens(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols of length 1
    int nsym = br.read(1) + 1;
    int s = br.read(br.read(1) ? 8 : 1);
    if (s < alphabet) lens[s] = 1;
    if (nsym == 2) {
      s = br.read(8);
      if (s < alphabet) lens[s] = 1;
    }
  } else {
    int cl[19] = {0};
    int ncodes = br.read(4) + 4;
    if (ncodes > 19) throw Error{"VP8L: too many code length codes"};
    for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huff lh;
    if (!build_huff(lh, cl, 19)) throw Error{"VP8L: bad code length code"};
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) throw Error{"VP8L: bad max_symbol"};
    }
    int prev = 8, s = 0;
    while (s < alphabet) {
      if (max_symbol-- == 0) break;
      int c = read_sym(lh, br);
      if (c < 16) {
        lens[s++] = c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int slot = c - 16;
        int rep = br.read(extra[slot]) + offset[slot];
        if (s + rep > alphabet) throw Error{"VP8L: code lengths overrun"};
        int v = c == 16 ? prev : 0;
        while (rep-- > 0) lens[s++] = v;
      }
    }
  }
  if (br.eos()) throw Error{"VP8L: truncated"};
  if (!build_huff(out, lens.data(), alphabet))
    throw Error{"VP8L: bad prefix code"};
}

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline int prefix_value(int sym, LBits &br) {
  if (sym < 4) return sym + 1;
  int extra = (sym - 2) >> 1;
  int offset = (2 + (sym & 1)) << extra;
  return offset + br.read(extra) + 1;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    int A = (a >> sh) & 0xff, B = (b >> sh) & 0xff, C = (c >> sh) & 0xff;
    s += std::abs(B - C) - std::abs(A - C);
  }
  return s <= 0 ? a : b;
}
inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    int v = (int)((a >> sh) & 0xff) + (int)((b >> sh) & 0xff) -
            (int)((c >> sh) & 0xff);
    r |= (uint32_t)clip255(v) << sh;
  }
  return r;
}
inline uint32_t add_sub_half(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    int A = (a >> sh) & 0xff, B = (b >> sh) & 0xff;
    r |= (uint32_t)clip255(A + (A - B) / 2) << sh;
  }
  return r;
}

uint32_t predict(int mode, const uint32_t *p, int w) {
  const uint32_t L = p[-1], T = p[-w], TL = p[-w - 1], TR = p[-w + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return add_sub_full(L, T, TL);
    case 13: return add_sub_half(avg2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp
  }
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct LDec {
  LBits br;
  unsigned seen = 0;
  double *sec;
  LDec(const uint8_t *d, size_t n, double *s) : br(d, n), sec(s) {}

  std::vector<uint32_t> stream(int xs, int ys, bool level0) {
    std::vector<Transform> tr;
    int txs = xs;
    if (level0) {
      while (br.read(1)) {
        Transform t;
        t.type = br.read(2);
        if (seen & (1u << t.type)) throw Error{"VP8L: a transform repeats"};
        seen |= 1u << t.type;
        t.xsize = txs;
        t.ysize = ys;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = br.read(3) + 2;
          t.data = stream(subsample(txs, t.bits), subsample(ys, t.bits), false);
        } else if (t.type == 3) {
          int ncolors = br.read(8) + 1;
          t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
          txs = subsample(txs, t.bits);
          std::vector<uint32_t> pal = stream(ncolors, 1, false);
          int final_n = 1 << (8 >> t.bits);
          t.data.assign(final_n, 0);
          t.data[0] = pal[0];
          for (int i = 1; i < ncolors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        }
        tr.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) throw Error{"VP8L: bad colour cache"};
    }
    int hbits = 0, hxs = 0;
    std::vector<uint32_t> meta;
    int ngroups = 1;
    if (level0 && br.read(1)) {
      hbits = br.read(3) + 2;
      hxs = subsample(txs, hbits);
      meta = stream(hxs, subsample(ys, hbits), false);
      for (auto &m : meta) {
        m = (m >> 8) & 0xffff;
        if ((int)m + 1 > ngroups) ngroups = m + 1;
      }
    }
    if (br.eos()) throw Error{"VP8L: truncated"};
    std::vector<Huff> codes(ngroups * 5);
    for (int g = 0; g < ngroups; ++g)
      for (int j = 0; j < 5; ++j) {
        int a = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(br, a, codes[g * 5 + j]);
      }
    double t0 = now();
    std::vector<uint32_t> px = image_data(txs, ys, cache_bits, hbits, hxs, meta,
                                          codes);
    double t1 = now();
    for (int k = (int)tr.size() - 1; k >= 0; --k) px = inverse(tr[k], px);
    if (level0 && sec) {
      sec[0] += t1 - t0;
      sec[1] += now() - t1;
    }
    return px;
  }

  std::vector<uint32_t> image_data(int w, int h, int cache_bits, int hbits,
                                   int hxs, const std::vector<uint32_t> &meta,
                                   const std::vector<Huff> &codes) {
    const size_t total = (size_t)w * h;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int cshift = 32 - cache_bits;
    size_t pos = 0, cached = 0;
    int x = 0, y = 0;
    while (pos < total) {
      const Huff *g = &codes[0];
      if (hbits) g = &codes[5 * meta[(y >> hbits) * hxs + (x >> hbits)]];
      int code = read_sym(g[0], br);
      if (code < 256) {
        int r = read_sym(g[1], br);
        int b = read_sym(g[2], br);
        int a = read_sym(g[3], br);
        px[pos++] = ((uint32_t)a << 24) | (r << 16) | (code << 8) | b;
        if (++x == w) {
          x = 0;
          ++y;
        }
      } else if (code < 256 + 24) {
        int len = prefix_value(code - 256, br);
        int dsym = read_sym(g[4], br);
        int dcode = prefix_value(dsym, br);
        size_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int c = kCodeToPlane[dcode - 1];
          long d = (long)(c >> 4) * w + (8 - (c & 15));
          dist = d >= 1 ? d : 1;
        }
        if (br.eos()) throw Error{"VP8L: truncated"};
        if (dist > pos || total - pos < (size_t)len)
          throw Error{"VP8L: a backward reference leaves the image"};
        for (int k = 0; k < len; ++k, ++pos) px[pos] = px[pos - dist];
        x += len;
        while (x >= w) {
          x -= w;
          ++y;
        }
      } else {
        int key = code - 256 - 24;
        if (!cache_bits || key >= (1 << cache_bits))
          throw Error{"VP8L: bad colour cache key"};
        while (cached < pos) {
          uint32_t c = px[cached++];
          cache[(0x1e35a7bdu * c) >> cshift] = c;
        }
        px[pos++] = cache[key];
        if (++x == w) {
          x = 0;
          ++y;
        }
      }
      if (cache_bits) {
        while (cached < pos) {
          uint32_t c = px[cached++];
          cache[(0x1e35a7bdu * c) >> cshift] = c;
        }
      }
      if ((pos & 4095) == 0 && br.eos()) throw Error{"VP8L: truncated"};
    }
    if (br.eos()) throw Error{"VP8L: truncated"};
    return px;
  }

  static std::vector<uint32_t> inverse(const Transform &t,
                                       std::vector<uint32_t> &in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // add green to red and blue
      for (auto &p : in) {
        uint32_t g = (p >> 8) & 0xff;
        uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross colour
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t m = t.data[(y >> t.bits) * tw + (x >> t.bits)];
          int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
                 r2b = (int8_t)((m >> 16) & 0xff);
          uint32_t &p = in[(size_t)y * w + x];
          int8_t green = (int8_t)(p >> 8);
          int r = (p >> 16) & 0xff, b = p & 0xff;
          r = (r + (((int)g2r * green) >> 5)) & 0xff;
          b += ((int)g2b * green) >> 5;
          b += ((int)r2b * (int8_t)r) >> 5;
          b &= 0xff;
          p = (p & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
        }
      return std::move(in);
    }
    if (t.type == 0) {  // predictors
      const int tw = subsample(w, t.bits);
      uint32_t *p = in.data();
      p[0] = add_pixels(p[0], 0xff000000u);
      for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t *row = p + (size_t)y * w;
        row[0] = add_pixels(row[0], row[-w]);
        const uint32_t *modes = &t.data[(y >> t.bits) * tw];
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 15;
          row[x] = add_pixels(row[x], predict(mode, row + x, w));
        }
      }
      return std::move(in);
    }
    // colour indexing, with 2, 4 or 8 pixels bundled in one green byte
    std::vector<uint32_t> out((size_t)w * h);
    const int bits = t.bits, pw = subsample(w, bits);
    const int bpp = 8 >> bits, per = 1 << bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t *src = &in[(size_t)y * pw];
      uint32_t *dst = &out[(size_t)y * w];
      if (bits == 0) {
        for (int x = 0; x < w; ++x) dst[x] = t.data[(src[x] >> 8) & 0xff];
      } else {
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per - 1)) == 0) packed = (src[x >> bits] >> 8) & 0xff;
          dst[x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
    }
    return out;
  }
};

// ================================================================== VP8
struct BoolDec {
  const uint8_t *d = nullptr;
  size_t n = 0, i = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  void init(const uint8_t *p, size_t len) {
    d = p;
    n = len;
    i = 0;
    value = 0;
    for (int k = 0; k < 2; ++k) value = (value << 8) | next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() { return i < n ? d[i++] : (++i, 0u); }
  inline int get(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int r;
    if (value >= big) {
      r = 1;
      range -= split;
      value -= big;
    } else {
      r = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return r;
  }
  int lit(int bits) {
    int v = 0;
    while (bits--) v = (v << 1) | get(128);
    return v;
  }
  int signed_lit(int bits) {
    int v = lit(bits);
    return get(128) ? -v : v;
  }
};

constexpr int B_DC = 0, B_TM = 1, B_VE = 2, B_HE = 3, B_RD = 4, B_VR = 5,
              B_LD = 6, B_VL = 7, B_HD = 8, B_HU = 9;
// 16x16 and chroma DC at the frame's edges
constexpr int DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6;

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

struct FInfo {
  int limit, ilevel, hev, inner;
};

struct VP8 {
  int w = 0, h = 0, mbw = 0, mbh = 0;
  BoolDec br, parts[8];
  int nparts = 1;
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0}, fstrength[4] = {0}, seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0}, filter_type = 0;
  struct Q {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  std::vector<uint8_t> Y, U, V;  // MB-padded planes, unfiltered until filter()
  int ys = 0, uvs = 0;
  std::vector<FInfo> finfo;     // per macroblock
  FInfo fstr[4][2];

  void headers(const uint8_t *d, size_t n) {
    if (n < 10) throw Error{"VP8: truncated frame header"};
    uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    if (bits & 1) throw Error{"VP8: not a key frame"};
    if (((bits >> 1) & 7) > 3) throw Error{"VP8: unknown profile"};
    if (!((bits >> 4) & 1)) throw Error{"VP8: frame not displayable"};
    size_t psize = bits >> 5;
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
      throw Error{"VP8: bad start code"};
    w = (d[6] | (d[7] << 8)) & 0x3fff;
    h = (d[8] | (d[9] << 8)) & 0x3fff;
    if (!w || !h) throw Error{"VP8: empty frame"};
    mbw = (w + 15) >> 4;
    mbh = (h + 15) >> 4;
    d += 10;
    n -= 10;
    if (psize > n) throw Error{"VP8: bad partition length"};
    br.init(d, psize);
    br.get(128);  // colour space
    br.get(128);  // clamping type
    use_segment = br.get(128);
    if (use_segment) {
      update_map = br.get(128);
      if (br.get(128)) {
        absolute_delta = br.get(128);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get(128) ? br.signed_lit(7) : 0;
        for (int s = 0; s < 4; ++s) fstrength[s] = br.get(128) ? br.signed_lit(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_proba[s] = br.get(128) ? br.lit(8) : 255;
    }
    simple = br.get(128);
    level = br.lit(6);
    sharpness = br.lit(3);
    use_lf_delta = br.get(128);
    if (use_lf_delta && br.get(128)) {
      for (int i = 0; i < 4; ++i)
        if (br.get(128)) ref_lf_delta[i] = br.signed_lit(6);
      for (int i = 0; i < 4; ++i)
        if (br.get(128)) mode_lf_delta[i] = br.signed_lit(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // token partitions
    const uint8_t *buf = d + psize;
    size_t left = n - psize;
    int last = (1 << br.lit(2)) - 1;
    nparts = last + 1;
    if (left < (size_t)3 * last) throw Error{"VP8: truncated partitions"};
    const uint8_t *sz = buf, *start = buf + 3 * last;
    left -= 3 * last;
    for (int p = 0; p < last; ++p) {
      size_t ps = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (ps > left) ps = left;
      parts[p].init(start, ps);
      start += ps;
      left -= ps;
      sz += 3;
    }
    parts[last].init(start, left);
    // quantisers
    int base_q0 = br.lit(7);
    int dq[5];
    for (int k = 0; k < 5; ++k) dq[k] = br.get(128) ? br.signed_lit(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s] + (absolute_delta ? 0 : base_q0);
      } else if (s > 0) {
        dqm[s] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      Q &m = dqm[s];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
    br.get(128);  // refresh entropy probabilities: ignored on a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = br.get(kCoeffsUpdateProba[i]) ? br.lit(8)
                                                               : kCoeffsProba0[i];
          }
    use_skip = br.get(128);
    if (use_skip) skip_p = br.lit(8);
  }

  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) base = fstrength[s] + (absolute_delta ? 0 : level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo &f = fstr[s][i4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lv + il;
          f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
          f.ilevel = 0;
          f.hev = 0;
        }
        f.inner = i4;
      }
    }
  }

  // GetCoeffs: returns the position after the last coefficient read
  int coeffs(BoolDec &tb, int type, int ctx, const int *dq, int n, int16_t *out) {
    const uint8_t *p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.get(p[0])) return n;
      while (!tb.get(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      int nb = kBands[n + 1];
      if (!tb.get(p[2])) {
        v = 1;
        p = proba[type][nb][1];
      } else {
        if (!tb.get(p[3])) {
          if (!tb.get(p[4])) v = 2;
          else v = 3 + tb.get(p[5]);
        } else if (!tb.get(p[6])) {
          if (!tb.get(p[7])) {
            v = 5 + tb.get(159);
          } else {
            v = 7 + 2 * tb.get(165);
            v += tb.get(145);
          }
        } else {
          int bit1 = tb.get(p[8]);
          int bit0 = tb.get(p[9 + bit1]);
          int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t *t = kCat3456[cat]; *t; ++t) v += v + tb.get(*t);
          v += 3 + (8 << cat);
        }
        p = proba[type][nb][2];
      }
      int sv = tb.get(128) ? -v : v;
      out[kZigzag[n]] = (int16_t)(sv * dq[n > 0]);
    }
    return 16;
  }

  void decode(const uint8_t *d, size_t n, double *sec) {
    double t0 = now();
    headers(d, n);
    filter_strengths();
    ys = mbw * 16;
    uvs = mbw * 8;
    Y.assign((size_t)ys * mbh * 16, 0);
    U.assign((size_t)uvs * mbh * 8, 0);
    V.assign((size_t)uvs * mbh * 8, 0);
    finfo.assign((size_t)mbw * mbh, FInfo{0, 0, 0, 0});
    std::vector<uint8_t> intra_t(4 * mbw, B_DC);
    std::vector<uint8_t> nz_top(mbw, 0), nz_dc_top(mbw, 0);
    for (int my = 0; my < mbh; ++my) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t nz_left = 0, nz_dc_left = 0;
      BoolDec &tb = parts[my & (nparts - 1)];
      for (int mx = 0; mx < mbw; ++mx) {
        // modes, from the first partition
        int seg = 0;
        if (update_map)
          seg = !br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                      : br.get(seg_proba[2]) + 2;
        int skip = use_skip ? br.get(skip_p) : 0;
        int is_i4 = !br.get(145);
        uint8_t imodes[16];
        uint8_t *top = &intra_t[4 * mx];
        if (!is_i4) {
          int ym = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                               : (br.get(163) ? B_VE : B_DC);
          imodes[0] = ym;
          memset(top, ym, 4);
          memset(intra_l, ym, 4);
        } else {
          uint8_t *modes = imodes;
          for (int y = 0; y < 4; ++y) {
            int ym = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t *pr = &kBModesProba[(top[x] * 10 + ym) * 9];
              ym = !br.get(pr[0]) ? B_DC
                   : !br.get(pr[1]) ? B_TM
                   : !br.get(pr[2]) ? B_VE
                   : !br.get(pr[3])
                       ? (!br.get(pr[4]) ? B_HE : (!br.get(pr[5]) ? B_RD : B_VR))
                       : (!br.get(pr[6]) ? B_LD
                          : (!br.get(pr[7]) ? B_VL
                                            : (!br.get(pr[8]) ? B_HD : B_HU)));
              top[x] = ym;
            }
            memcpy(modes, top, 4);
            modes += 4;
            intra_l[y] = ym;
          }
        }
        int uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE
                     : br.get(183) ? B_TM : B_HE;
        // residuals, from the row's token partition
        int16_t coef[384];
        memset(coef, 0, sizeof(coef));
        uint32_t nzy = 0, nzuv = 0;
        if (!skip) {
          const Q &q = dqm[seg];
          int first, ac_type;
          if (!is_i4) {
            int16_t dc[16] = {0};
            int ctx = nz_dc_top[mx] + nz_dc_left;
            int nz = coeffs(tb, 1, ctx, q.y2, 0, dc);
            nz_dc_top[mx] = nz_dc_left = nz > 0;
            if (nz > 1) {
              wht(dc, coef);
            } else {
              int dc0 = (dc[0] + 3) >> 3;
              for (int i = 0; i < 256; i += 16) coef[i] = (int16_t)dc0;
            }
            first = 1;
            ac_type = 0;
          } else {
            first = 0;
            ac_type = 3;
          }
          uint8_t tnz = nz_top[mx] & 0x0f, lnz = nz_left & 0x0f;
          int16_t *dst = coef;
          for (int y = 0; y < 4; ++y) {
            int l = lnz & 1;
            uint32_t nzc = 0;
            for (int x = 0; x < 4; ++x) {
              int ctx = l + (tnz & 1);
              int nz = coeffs(tb, ac_type, ctx, q.y1, first, dst);
              l = nz > first;
              tnz = (tnz >> 1) | (l << 7);
              nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
              dst += 16;
            }
            tnz >>= 4;
            lnz = (lnz >> 1) | (l << 7);
            nzy = (nzy << 8) | nzc;
          }
          uint32_t out_t = tnz, out_l = lnz >> 4;
          for (int ch = 0; ch < 4; ch += 2) {
            uint32_t nzc = 0;
            tnz = nz_top[mx] >> (4 + ch);
            lnz = nz_left >> (4 + ch);
            for (int y = 0; y < 2; ++y) {
              int l = lnz & 1;
              for (int x = 0; x < 2; ++x) {
                int ctx = l + (tnz & 1);
                int nz = coeffs(tb, 2, ctx, q.uv, 0, dst);
                l = nz > 0;
                tnz = (tnz >> 1) | (l << 3);
                nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
                dst += 16;
              }
              tnz >>= 2;
              lnz = (lnz >> 1) | (l << 5);
            }
            nzuv |= nzc << (4 * ch);
            out_t |= (tnz << 4) << ch;
            out_l |= (lnz & 0xf0) << ch;
          }
          nz_top[mx] = (uint8_t)out_t;
          nz_left = (uint8_t)out_l;
          skip = !(nzy | nzuv);
        } else {
          nz_top[mx] = nz_left = 0;
          if (!is_i4) nz_dc_top[mx] = nz_dc_left = 0;
        }
        if (filter_type > 0) {
          FInfo f = fstr[seg][is_i4];
          f.inner |= !skip;
          finfo[(size_t)my * mbw + mx] = f;
        }
        reconstruct(mx, my, is_i4, imodes, uvmode, coef);
      }
    }
    if (sec) sec[0] += now() - t0;
    double t1 = now();
    if (filter_type > 0)
      for (int my = 0; my < mbh; ++my)
        for (int mx = 0; mx < mbw; ++mx) filter_mb(mx, my);
    if (sec) sec[1] += now() - t1;
  }

  static void wht(const int16_t *in, int16_t *out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
      int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      int dc = tmp[0 + i * 4] + 3;
      int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
      out[0] = (int16_t)((a0 + a1) >> 3);
      out[16] = (int16_t)((a3 + a2) >> 3);
      out[32] = (int16_t)((a0 - a1) >> 3);
      out[48] = (int16_t)((a3 - a2) >> 3);
      out += 64;
    }
  }

  // the inverse DCT of one 4x4 block, added to dst (stride bps)
  static void idct_add(const int16_t *in, uint8_t *dst, int bps) {
    auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
    auto mul2 = [](int a) { return (a * 35468) >> 16; };
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) {
      int a = in[0] + in[8], b = in[0] - in[8];
      int c = mul2(in[4]) - mul1(in[12]);
      int d = mul1(in[4]) + mul2(in[12]);
      tmp[0] = a + d;
      tmp[1] = b + c;
      tmp[2] = b - c;
      tmp[3] = a - d;
      tmp += 4;
      ++in;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
      int dc = tmp[0] + 4;
      int a = dc + tmp[8], b = dc - tmp[8];
      int c = mul2(tmp[4]) - mul1(tmp[12]);
      int d = mul1(tmp[4]) + mul2(tmp[12]);
      dst[0] = clip8(dst[0] + ((a + d) >> 3));
      dst[1] = clip8(dst[1] + ((b + c) >> 3));
      dst[2] = clip8(dst[2] + ((b - c) >> 3));
      dst[3] = clip8(dst[3] + ((a - d) >> 3));
      ++tmp;
      dst += bps;
    }
  }

  // The work buffers hold a macroblock with its left column, top row and
  // (luma) four top-right samples, as libwebp's yuv_b_: BPS 32.
  static const int BPS = 32;

  static void true_motion(uint8_t *dst, int size) {
    const uint8_t *top = dst - BPS;
    int tl = top[-1];
    for (int y = 0; y < size; ++y) {
      int l = dst[-1];
      for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
      dst += BPS;
    }
  }

  static void fill(uint8_t *dst, int size, int v) {
    for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
  }

  static void pred_block(uint8_t *dst, int size, int mode) {
    int shift = size == 16 ? 5 : 4;
    switch (mode) {
      case B_DC: {
        int dc = size;
        for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
        fill(dst, size, dc >> shift);
        break;
      }
      case DC_NOTOP: {
        int dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      case DC_NOLEFT: {
        int dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      case DC_NOTOPLEFT: fill(dst, size, 0x80); break;
      case B_TM: true_motion(dst, size); break;
      case B_VE:
        for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
        break;
      case B_HE:
        for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
        break;
    }
  }

  static void pred4(uint8_t *dst, int mode) {
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
    const uint8_t *top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
              L = dst[-1 + 3 * BPS];
    switch (mode) {
      case B_DC: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= 3;
        for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc, 4);
        break;
      }
      case B_TM: true_motion(dst, 4); break;
      case B_VE: {
        const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                              AVG3(C, D, E)};
        for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
        break;
      }
      case B_HE:
        memset(dst, AVG3(X, I, J), 4);
        memset(dst + BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
      case B_RD:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
      case B_LD:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
      case B_VR:
        DST(0, 0) = DST(1, 2) = AVG2(X, A);
        DST(1, 0) = DST(2, 2) = AVG2(A, B);
        DST(2, 0) = DST(3, 2) = AVG2(B, C);
        DST(3, 0) = AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
      case B_VL:
        DST(0, 0) = AVG2(A, B);
        DST(1, 0) = DST(0, 2) = AVG2(B, C);
        DST(2, 0) = DST(1, 2) = AVG2(C, D);
        DST(3, 0) = DST(2, 2) = AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
      case B_HU:
        DST(0, 0) = AVG2(I, J);
        DST(2, 0) = DST(0, 1) = AVG2(J, K);
        DST(2, 1) = DST(0, 2) = AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = L;
        break;
      case B_HD:
        DST(0, 0) = DST(2, 1) = AVG2(I, X);
        DST(0, 1) = DST(2, 2) = AVG2(J, I);
        DST(0, 2) = DST(2, 3) = AVG2(K, J);
        DST(0, 3) = AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    }
#undef DST
#undef AVG3
#undef AVG2
  }

  static int check_mode(int mx, int my, int mode) {
    if (mode == B_DC) {
      if (mx == 0) return my == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return my == 0 ? DC_NOTOP : B_DC;
    }
    return mode;
  }

  // Loads a plane's block of `size` with its borders into buf (origin at
  // row 1, column 8 of a BPS-wide buffer), from the unfiltered frame.
  void load(const std::vector<uint8_t> &P, int stride, int size, int mx,
            int my, uint8_t *o) const {
    const int x0 = mx * size, y0 = my * size;
    if (my == 0) {
      memset(o - BPS - 1, 127, size + 1 + (size == 16 ? 4 : 0));
    } else {
      memcpy(o - BPS, &P[(size_t)(y0 - 1) * stride + x0], size);
      o[-BPS - 1] = mx == 0 ? 129 : P[(size_t)(y0 - 1) * stride + x0 - 1];
    }
    for (int j = 0; j < size; ++j)
      o[j * BPS - 1] = mx == 0 ? 129 : P[(size_t)(y0 + j) * stride + x0 - 1];
  }

  void store(std::vector<uint8_t> &P, int stride, int size, int mx, int my,
             const uint8_t *o) {
    for (int j = 0; j < size; ++j)
      memcpy(&P[(size_t)(my * size + j) * stride + mx * size], o + j * BPS,
             size);
  }

  void reconstruct(int mx, int my, int is_i4, const uint8_t *imodes,
                   int uvmode, const int16_t *coef) {
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t *yo = ybuf + BPS + 8, *uo = ubuf + BPS + 8, *vo = vbuf + BPS + 8;
    load(Y, ys, 16, mx, my, yo);
    load(U, uvs, 8, mx, my, uo);
    load(V, uvs, 8, mx, my, vo);
    if (is_i4) {
      uint8_t *tr = yo - BPS + 16;
      if (my > 0) {
        if (mx >= mbw - 1) {
          memset(tr, Y[(size_t)(my * 16 - 1) * ys + mx * 16 + 15], 4);
        } else {
          memcpy(tr, &Y[(size_t)(my * 16 - 1) * ys + mx * 16 + 16], 4);
        }
      }
      for (int k = 1; k <= 3; ++k) memcpy(tr + 4 * k * BPS, tr, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t *dst = yo + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        pred4(dst, imodes[n]);
        idct_add(coef + n * 16, dst, BPS);
      }
    } else {
      pred_block(yo, 16, check_mode(mx, my, imodes[0]));
      for (int n = 0; n < 16; ++n)
        idct_add(coef + n * 16, yo + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
    }
    int uvm = check_mode(mx, my, uvmode);
    pred_block(uo, 8, uvm);
    pred_block(vo, 8, uvm);
    for (int n = 0; n < 4; ++n) {
      int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      idct_add(coef + 256 + n * 16, uo + off, BPS);
      idct_add(coef + 320 + n * 16, vo + off, BPS);
    }
    store(Y, ys, 16, mx, my, yo);
    store(U, uvs, 8, mx, my, uo);
    store(V, uvs, 8, mx, my, vo);
  }

  // ------------------------------------------------------ loop filter
  static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
  static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

  static inline void do2(uint8_t *p, int s) {
    const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-s] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static inline void do4(uint8_t *p, int s) {
    const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * s] = clip8(p1 + a3);
    p[-s] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[s] = clip8(q1 - a3);
  }
  static inline void do6(uint8_t *p, int s) {
    const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    const int q0 = p[0], q1 = p[s], q2 = p[2 * s];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
              a3 = (9 * a + 63) >> 7;
    p[-3 * s] = clip8(p2 + a3);
    p[-2 * s] = clip8(p1 + a2);
    p[-s] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[s] = clip8(q1 - a2);
    p[2 * s] = clip8(q2 - a3);
  }
  static inline bool hev(const uint8_t *p, int s, int t) {
    return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
  }
  static inline bool needs(const uint8_t *p, int s, int t) {
    return 4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t;
  }
  static inline bool needs2(const uint8_t *p, int s, int t, int it) {
    const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
  }
  // hs: across the edge; vs: along it
  static void simple_edge(uint8_t *p, int hs, int vs, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vs)
      if (needs(p, hs, t2)) do2(p, hs);
  }
  static void loop26(uint8_t *p, int hs, int vs, int size, int thresh, int it,
                     int hv) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vs)
      if (needs2(p, hs, t2, it)) {
        if (hev(p, hs, hv)) do2(p, hs);
        else do6(p, hs);
      }
  }
  static void loop24(uint8_t *p, int hs, int vs, int size, int thresh, int it,
                     int hv) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vs)
      if (needs2(p, hs, t2, it)) {
        if (hev(p, hs, hv)) do2(p, hs);
        else do4(p, hs);
      }
  }

  void filter_mb(int mx, int my) {
    const FInfo &f = finfo[(size_t)my * mbw + mx];
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t *y = &Y[(size_t)my * 16 * ys + mx * 16];
    if (filter_type == 1) {
      if (mx > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
      if (my > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t *u = &U[(size_t)my * 8 * uvs + mx * 8];
    uint8_t *v = &V[(size_t)my * 8 * uvs + mx * 8];
    const int il = f.ilevel, hv = f.hev;
    if (mx > 0) {
      loop26(y, 1, ys, 16, limit + 4, il, hv);
      loop26(u, 1, uvs, 8, limit + 4, il, hv);
      loop26(v, 1, uvs, 8, limit + 4, il, hv);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) loop24(y + 4 * k, 1, ys, 16, limit, il, hv);
      loop24(u + 4, 1, uvs, 8, limit, il, hv);
      loop24(v + 4, 1, uvs, 8, limit, il, hv);
    }
    if (my > 0) {
      loop26(y, ys, 1, 16, limit + 4, il, hv);
      loop26(u, uvs, 1, 8, limit + 4, il, hv);
      loop26(v, uvs, 1, 8, limit + 4, il, hv);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        loop24(y + 4 * k * ys, ys, 1, 16, limit, il, hv);
      loop24(u + 4 * uvs, uvs, 1, 8, limit, il, hv);
      loop24(v + 4 * uvs, uvs, 1, 8, limit, il, hv);
    }
  }

  // ----------------------------------------- fancy upsampling, YUV -> RGB
  static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
  static inline uint8_t yuv_clip(int v) {
    return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
  }
  static inline void yuv_rgb(int y, int u, int v, uint8_t *rgb) {
    rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                      mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  }

  // UpsampleRgbaLinePair: one output row from luma row `yrow` and the
  // chroma rows `near` (weight 3) and `far` (weight 1).
  void upsample_row(const uint8_t *yrow, const uint8_t *nu, const uint8_t *nv,
                    const uint8_t *fu, const uint8_t *fv, uint8_t *out,
                    int stride_px) const {
    const int len = w, last_pair = (len - 1) >> 1;
    auto px = [&](int x) { return out + (size_t)x * stride_px; };
    int tl_u = nu[0], tl_v = nv[0], l_u = fu[0], l_v = fv[0];
    yuv_rgb(yrow[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, px(0));
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = nu[x], t_v = nv[x], u = fu[x], v = fv[x];
      const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
      const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
      yuv_rgb(yrow[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
              px(2 * x - 1));
      yuv_rgb(yrow[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, px(2 * x));
      tl_u = t_u;
      tl_v = t_v;
      l_u = u;
      l_v = v;
    }
    if (!(len & 1))
      yuv_rgb(yrow[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
              px(len - 1));
  }

  void to_rgb(uint8_t *rgba, double *sec) const {
    double t0 = now();
    const int uvh = (h + 1) / 2;
    for (int r = 0; r < h; ++r) {
      // row 0 and an even-height image's last row use one chroma row; an
      // odd row 2k-1 sits nearer chroma row k-1, an even row 2k nearer k
      int nk, fk;
      if (r == 0) {
        nk = fk = 0;
      } else if (r & 1) {
        nk = (r - 1) / 2;
        fk = nk + 1 < uvh ? nk + 1 : nk;
      } else {
        nk = r / 2;
        fk = nk - 1;
      }
      upsample_row(&Y[(size_t)r * ys], &U[(size_t)nk * uvs], &V[(size_t)nk * uvs],
                   &U[(size_t)fk * uvs], &V[(size_t)fk * uvs],
                   rgba + (size_t)r * w * 4, 4);
    }
    if (sec) sec[2] += now() - t0;
  }
};

// ================================================================== alpha
void unfilter(int method, uint8_t *a, int w, int h) {
  for (int y = 0; y < h; ++y) {
    uint8_t *row = a + (size_t)y * w;
    const uint8_t *prev = y ? row - w : nullptr;
    if (method == 1 || !prev) {  // horizontal, and every filter's row 0
      if (method == 0) continue;
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (method == 2) {
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else if (method == 3) {
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(row[x] + g);
        top_left = top;
        row[x] = (uint8_t)left;
      }
    }
  }
}

int fail(const char *msg, char *err, int errlen) {
  snprintf(err, errlen, "%s", msg);
  return -1;
}

}  // namespace

extern "C" {

// A VP8L bitstream (its 5-byte header included) of w x h into rgba.
int webp_vp8l(const uint8_t *data, int64_t size, int32_t w, int32_t h,
              uint8_t *rgba, double *seconds, char *err, int errlen) {
  try {
    if (size < 5 || data[0] != 0x2f) throw Error{"VP8L: bad signature"};
    LDec dec(data + 1, size - 1, seconds);
    int fw = dec.br.read(14) + 1, fh = dec.br.read(14) + 1;
    dec.br.read(1);  // alpha_is_used: a hint only
    if (dec.br.read(3) != 0) throw Error{"VP8L: unknown version"};
    if (fw != w || fh != h) throw Error{"VP8L: size differs from the container's"};
    std::vector<uint32_t> px = dec.stream(w, h, true);
    for (size_t i = 0; i < px.size(); ++i) {
      uint32_t p = px[i];
      rgba[4 * i] = (p >> 16) & 0xff;
      rgba[4 * i + 1] = (p >> 8) & 0xff;
      rgba[4 * i + 2] = p & 0xff;
      rgba[4 * i + 3] = p >> 24;
    }
    return 0;
  } catch (const Error &e) {
    return fail(e.msg, err, errlen);
  } catch (const std::bad_alloc &) {
    return fail("VP8L: out of memory", err, errlen);
  }
}

// A VP8 key frame of w x h into the RGB bytes of rgba (alpha untouched).
int webp_vp8(const uint8_t *data, int64_t size, int32_t w, int32_t h,
             uint8_t *rgba, double *seconds, char *err, int errlen) {
  try {
    VP8 dec;
    dec.decode(data, size, seconds);
    if (dec.w != w || dec.h != h) throw Error{"VP8: size differs from the container's"};
    dec.to_rgb(rgba, seconds);
    return 0;
  } catch (const Error &e) {
    return fail(e.msg, err, errlen);
  } catch (const std::bad_alloc &) {
    return fail("VP8: out of memory", err, errlen);
  }
}

// An ALPH chunk's payload into w x h alpha bytes.
int webp_alpha(const uint8_t *data, int64_t size, int32_t w, int32_t h,
               uint8_t *alpha, char *err, int errlen) {
  try {
    if (size < 1) throw Error{"ALPH: empty chunk"};
    const int method = data[0] & 3, filt = (data[0] >> 2) & 3,
              pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) throw Error{"ALPH: bad header"};
    const size_t n = (size_t)w * h;
    if (method == 0) {
      if ((size_t)size - 1 < n) throw Error{"ALPH: truncated raw alpha"};
      memcpy(alpha, data + 1, n);
    } else {
      LDec dec(data + 1, size - 1, nullptr);
      std::vector<uint32_t> px = dec.stream(w, h, true);
      for (size_t i = 0; i < n; ++i) alpha[i] = (px[i] >> 8) & 0xff;
    }
    unfilter(filt, alpha, w, h);
    return 0;
  } catch (const Error &e) {
    return fail(e.msg, err, errlen);
  } catch (const std::bad_alloc &) {
    return fail("ALPH: out of memory", err, errlen);
  }
}

}  // extern "C"
