// Shared device code of the fused NeRF MLP kernels: the packed weight
// layout, the activation stash layout, the positional encoding of a tile and
// the tile forward that kernels C, D (fused_mlp.cu) and F (fused_mlp_bwd.cu)
// run.  See fused_mlp.cu for the numerics and the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {

constexpr int CX = 63, CD = 27, W = 256, WH = 128, D = 8, SKIP = 4;
constexpr int TP = 64;        // points per CTA
constexpr int THREADS = 256;  // warp w owns points [8w, 8w + 8)
constexpr int ROW_H = CX;            // first activation row of h
constexpr int ROW_DIR = CX + W;      // first row of dir_emb
constexpr int ROWS = CX + W + CD;    // 346 activation rows

// Weight buffer: W_0..W_7, Wsig, Wfin, Wdir, Wrgb, each (fan_in, fan_out)
// row-major, concatenated.  Bias buffer (f32): b_0..b_7, bsig, bfin, bdir,
// brgb.  Every offset is a multiple of 8 elements (16-byte vector copies).
__host__ __device__ constexpr long long layer_size(int i) {
  return i == 0 ? 1LL * CX * W : (i == SKIP ? 1LL * (W + CX) * W : 1LL * W * W);
}
__host__ __device__ constexpr long long layer_off(int i) {
  long long o = 0;
  for (int j = 0; j < i; ++j) o += layer_size(j);
  return o;
}
constexpr long long OFF_SIG = layer_off(D);
constexpr long long OFF_FIN = OFF_SIG + W;
constexpr long long OFF_DIR = OFF_FIN + 1LL * W * W;
constexpr long long OFF_RGB = OFF_DIR + 1LL * (W + CD) * WH;
constexpr long long N_WEIGHTS = OFF_RGB + 1LL * WH * 3;
constexpr int BOFF_SIG = D * W, BOFF_FIN = BOFF_SIG + 1;
constexpr int BOFF_DIR = BOFF_FIN + W, BOFF_RGB = BOFF_DIR + WH;
constexpr int N_BIASES = BOFF_RGB + 3;
static_assert(N_WEIGHTS == 593408, "one multiply-add per weight per point");
static_assert(OFF_SIG % 8 == 0 && OFF_FIN % 8 == 0 && OFF_DIR % 8 == 0 &&
                  OFF_RGB % 8 == 0 && layer_off(1) % 8 == 0 &&
                  layer_off(SKIP + 1) % 8 == 0,
              "16-byte aligned weight blocks");

// Activation stash, one row of SC elements per point, in the weight type
// (nerf_pl_tpu/ops/fused_mlp.py:688-700): h1..h8 at (i - 1) * W, then fin
// and d in rgb mode.  Sigma-only rows stop after h8.
constexpr int S_FIN = D * W, S_D = S_FIN + W;
constexpr int SC_RGB = S_D + WH, SC_SIGMA = D * W;  // 2432, 2048

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int KC = 16; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int KC = 32; };

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (ROWS * TP + Cfg<T>::KC * W) + sizeof(float) * 4 * TP;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// 8 consecutive activations (one warp's points) -> f32
__device__ __forceinline__ void load8(const float* p, float (&a)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&a)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack2(u.x, a[0], a[1]); unpack2(u.y, a[2], a[3]);
  unpack2(u.z, a[4], a[5]); unpack2(u.w, a[6], a[7]);
}
// 4 consecutive weights (one lane's features) -> f32
__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&b)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack2(u.x, b[0], b[1]); unpack2(u.y, b[2], b[3]);
}
// 4 consecutive values of one point's stash row -> f32, and back
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// acc[i][g * 4 + j] = sum_k act[in_row + k][8 * warp + i] * w[k][n],
// n = g * 128 + 4 * lane + j, for k < K; w is (K, NG * 128) row-major,
// streamed through the shared stage ws, KC rows at a time.  Products and
// sums in f32, in order of k.  Ends with a barrier: every read of the input
// rows is done when it returns.
template <typename T, int NG>
__device__ __forceinline__ void dense_acc(const T* __restrict__ w, int K,
                                          const T* act, int in_row, T* ws,
                                          float (&acc)[8][NG * 4]) {
  constexpr int N = NG * 128;
  constexpr int KC = Cfg<T>::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the previous stage has been consumed
    const uint4* src = reinterpret_cast<const uint4*>(w + 1LL * k0 * N);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    const int nvec = kc * N * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < nvec; i += THREADS) dst[i] = src[i];
    __syncthreads();
    const T* arow = act + (in_row + k0) * TP + warp * 8;
    const T* wrow = ws + lane * 4;
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float a[8];
      load8(arow + kk * TP, a);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float b[4];
        load4(wrow + kk * N + g * 128, b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(a[i], b[j], acc[i][g * 4 + j]);
      }
    }
  }
  __syncthreads();  // every read of the input rows is done
}

// act rows [out_row, out_row + N) = act(rows [in_row, in_row + K)) @ w + bias,
// N = NG * 128, optional ReLU, rounded to T.  With a stash, each point's
// rounded outputs also go to its stash row at column scol (points past P
// are not stored).
template <typename T, int NG, bool STASH>
__device__ __forceinline__ void dense(const T* __restrict__ w,
                                      const float* __restrict__ bias, int K,
                                      T* act, int in_row, int out_row, T* ws,
                                      bool relu, T* stash, int sc, int scol,
                                      long long n_valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][NG * 4];
  dense_acc<T, NG>(w, K, act, in_row, ws, acc);
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = g * 128 + lane * 4 + j;
      const float bn = bias[n];
      T* orow = act + (out_row + n) * TP + warp * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = acc[i][g * 4 + j] + bn;
        if (relu) v = fmaxf(v, 0.0f);
        orow[i] = from_f<T>(v);
      }
    }
  if (STASH) {  // this thread's own outputs, read back from shared memory
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n0 = g * 128 + lane * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = warp * 8 + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = to_f(act[(out_row + n0 + j) * TP + p]);
        if (p < n_valid) store4(stash + 1LL * p * sc + scol + n0, v);
      }
    }
  }
  __syncthreads();
}

// Ray IO layout at the kernel boundary, a compile-time parameter: channel-
// major x and out (8, P), element (c, p) at c * P + p (kernels C-F), or
// row-major (P, 8), element (p, c) at p * 8 + c (kernels C'-F').  Only the
// loads of x and g and the store of out differ; the arithmetic is shared.
constexpr int IO = 8;  // channels of x, out and g
__host__ __device__ constexpr long long io_at(bool row_major, int c,
                                              long long p, long long P) {
  return row_major ? p * IO + c : c * P + p;
}

// Row-major only: copy the tile's (TP, 8) rows of x, 2 KB of contiguous
// f32, into xs in 16-byte vectors, zeros past P.  Ends with a barrier.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           long long P, long long p0,
                                           float* xs) {
  const long long n_valid = P - p0;
  for (int i = threadIdx.x; i < TP * IO / 4; i += THREADS) {
    const int p = i / (IO / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < n_valid) v = reinterpret_cast<const float4*>(x + p0 * IO)[i];
    reinterpret_cast<float4*>(xs)[i] = v;
  }
  __syncthreads();
}

// Embed the tile's points into act rows [0, CX) and, unless sigma-only,
// [ROW_DIR, ROW_DIR + CD).  Points past P embed zeros and are never stored.
// Row-major input is first staged in ws (the weight stage, free until the
// first product, whose opening barrier orders these reads before it).
template <typename T, bool ROW_MAJOR>
__device__ __forceinline__ void embed(const float* __restrict__ x,
                                      long long P, long long p0, T* act,
                                      T* ws, bool with_dir) {
  const float* src = x;  // element (c, p) of the tile at src[io_at(..)]
  long long ld = P, q0 = p0;
  if (ROW_MAJOR) {
    float* xs = reinterpret_cast<float*>(ws);
    stage_rows(x, P, p0, xs);
    src = xs;
    ld = TP;
    q0 = 0;
  }
  const int n_rows = with_dir ? CX + CD : CX;
  for (int i = threadIdx.x; i < n_rows * TP; i += THREADS) {
    const int r = i / TP, p = i - r * TP;
    const bool is_dir = r >= CX;
    const int c = is_dir ? r - CX : r;  // channel within its embedding
    const long long gp = p0 + p;
    float v = 0.0f;
    if (gp < P) {
      const int base = is_dir ? 3 : 0;
      if (c < 3) {
        v = src[io_at(ROW_MAJOR, base + c, q0 + p, ld)];
      } else {
        const int q = c - 3, k = q / 6, s = q - 6 * k;  // s: sin 0-2, cos 3-5
        const float t = src[io_at(ROW_MAJOR, base + s % 3, q0 + p, ld)] *
                        static_cast<float>(1 << k);
        v = s < 3 ? sinf(t) : cosf(t);
      }
    }
    act[(is_dir ? ROW_DIR + c : c) * TP + p] = from_f<T>(v);
  }
}

// The forward of one tile of TP points starting at p0.  Writes the output
// channels for the tile's points into out (8, P) or (P, 8) unless out is
// null, and, with a stash, each point's stash row (stash points at the
// tile's first row).  On return act rows [0, CX) and [ROW_DIR, ROW_DIR + CD)
// still hold the embedding.
template <typename T, bool SIGMA_ONLY, bool STASH, bool ROW_MAJOR>
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ x, float* __restrict__ out,
    const T* __restrict__ wts, const float* __restrict__ bias, long long P,
    long long p0, unsigned char* smem, T* stash) {
  T* act = reinterpret_cast<T*>(smem);
  T* ws = act + ROWS * TP;
  float* sig = reinterpret_cast<float*>(ws + Cfg<T>::KC * W);
  float* rgb = sig + TP;  // 3 rows of TP
  const int tid = threadIdx.x;
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long n_valid = P - p0;

  embed<T, ROW_MAJOR>(x, P, p0, act, ws, !SIGMA_ONLY);
  // layer 0 reads xyz_emb; the skip layer reads [xyz_emb | h] (rows 0..318);
  // layer i's output h_{i+1} goes to stash column i * W
  dense<T, 2, STASH>(wts, bias, CX, act, 0, ROW_H, ws, true, stash, SC, 0,
                     n_valid);
  for (int i = 1; i < D; ++i)
    dense<T, 2, STASH>(wts + layer_off(i), bias + i * W,
                       i == SKIP ? W + CX : W, act, i == SKIP ? 0 : ROW_H,
                       ROW_H, ws, true, stash, SC, i * W, n_valid);

  if (tid < TP) {  // sigma head: one thread per point
    float s = 0.0f;
    for (int k = 0; k < W; ++k)
      s = fmaf(to_f(act[(ROW_H + k) * TP + tid]), to_f(wts[OFF_SIG + k]), s);
    sig[tid] = s + bias[BOFF_SIG];
  }
  if (!SIGMA_ONLY) {
    // fin overwrites h (after dense's barrier: the sigma head has read it)
    dense<T, 2, STASH>(wts + OFF_FIN, bias + BOFF_FIN, W, act, ROW_H, ROW_H,
                       ws, false, stash, SC, S_FIN, n_valid);
    // dir head reads [fin | dir_emb] = rows ROW_H .. ROW_H + W + CD
    dense<T, 1, STASH>(wts + OFF_DIR, bias + BOFF_DIR, W + CD, act, ROW_H,
                       ROW_H, ws, true, stash, SC, S_D, n_valid);
    if (tid < 3 * TP) {  // rgb head: one thread per (channel, point)
      const int c = tid / TP, p = tid - c * TP;
      float v = 0.0f;
      for (int k = 0; k < WH; ++k)
        v = fmaf(to_f(act[(ROW_H + k) * TP + p]),
                 to_f(wts[OFF_RGB + 3 * k + c]), v);
      v += bias[BOFF_RGB + c];
      rgb[c * TP + p] = 1.0f / (1.0f + expf(-v));
    }
  }
  __syncthreads();
  if (out == nullptr) return;
  auto value = [&](int r, int p) {  // output channel r of point p
    if (SIGMA_ONLY) return r == 0 ? sig[p] : 0.0f;
    return r < 3 ? rgb[r * TP + p] : (r == 3 ? sig[p] : 0.0f);
  };
  if (ROW_MAJOR) {  // each point's 8 channels: two 16-byte stores
    for (int i = tid; i < TP * IO / 4; i += THREADS) {
      const int p = i / (IO / 4), r0 = (i % (IO / 4)) * 4;
      if (p0 + p >= P) continue;
      reinterpret_cast<float4*>(out + p0 * IO)[i] =
          make_float4(value(r0, p), value(r0 + 1, p), value(r0 + 2, p),
                      value(r0 + 3, p));
    }
    return;
  }
  for (int i = tid; i < IO * TP; i += THREADS) {
    const int r = i / TP, p = i - r * TP;
    const long long gp = p0 + p;
    if (gp >= P) continue;
    out[r * P + gp] = value(r, p);
  }
}

}  // namespace nerf
