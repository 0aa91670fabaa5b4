// Shared device code of the fused NeRF MLP kernels: the packed weight
// layout, the activation stash layout, the input of a tile (the positional
// encoding of raw rays, or pre-embedded rows) and the tile forward that
// kernels C, D (fused_mlp.cu), G (fused_mlp_wide.cu) and F, H
// (fused_mlp_bwd.cu) run.  See fused_mlp.cu for the numerics and the design.
//
// The network's geometry is a template parameter (struct Net): the trunk
// width W and the points per warp PPW (a CTA's tile is TP = 8 * PPW points).
// Kernels C-F and H run the reference geometry Ref = Net<256, 8>; kernel G
// runs W = 128..640 (Wide<W>).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {

constexpr int CX = 63, CD = 27, D = 8, SKIP = 4;
constexpr int THREADS = 256;  // 8 warps; warp w owns points [PPW w, PPW w + PPW)

template <typename T> struct Cfg;  // KC: weight rows per shared stage
template <> struct Cfg<float> { static constexpr int KC = 16; };
template <> struct Cfg<__nv_bfloat16> { static constexpr int KC = 32; };

// Weight buffer: W_0..W_7, Wsig, Wfin, Wdir, Wrgb, each (fan_in, fan_out)
// row-major, concatenated.  Bias buffer (f32): b_0..b_7, bsig, bfin, bdir,
// brgb.  Trunk layer i's block at width w:
__host__ __device__ constexpr long long block_size(int w, int i) {
  return i == 0 ? 1LL * CX * w
                : (i == SKIP ? 1LL * (w + CX) * w : 1LL * w * w);
}
__host__ __device__ constexpr long long block_off(int w, int i) {
  long long o = 0;
  for (int j = 0; j < i; ++j) o += block_size(w, j);
  return o;
}

// Activation rows of a tile in shared memory, in the weight type:
// [xyz_emb (CX) | h (W) | dir_emb (CD)], so the skip concat [xyz_emb, h] and
// the dir-head concat [fin, dir_emb] are contiguous row ranges.
template <int W_, int PPW_>
struct Net {
  static constexpr int W = W_, WH = W_ / 2, PPW = PPW_, TP = 8 * PPW_;
  static constexpr int ROW_H = CX;          // first activation row of h
  static constexpr int ROW_DIR = CX + W;    // first row of dir_emb
  static constexpr int ROWS = CX + W + CD;  // activation rows
  __host__ __device__ static constexpr long long layer_off(int i) {
    return block_off(W_, i);
  }
  static constexpr long long OFF_SIG = block_off(W_, D);
  static constexpr long long OFF_FIN = OFF_SIG + W;
  static constexpr long long OFF_DIR = OFF_FIN + 1LL * W * W;
  static constexpr long long OFF_RGB = OFF_DIR + 1LL * (W + CD) * WH;
  static constexpr long long N_WEIGHTS = OFF_RGB + 1LL * WH * 3;
  static constexpr int BOFF_SIG = D * W, BOFF_FIN = BOFF_SIG + 1;
  static constexpr int BOFF_DIR = BOFF_FIN + W, BOFF_RGB = BOFF_DIR + WH;
  static constexpr int N_BIASES = BOFF_RGB + 3;
  // every weight block starts on 8 elements (16-byte vector copies), and
  // every product's width is a multiple of 64 columns (see Lanes)
  static_assert(W % 128 == 0 && OFF_SIG % 8 == 0 && OFF_FIN % 8 == 0 &&
                    OFF_DIR % 8 == 0 && OFF_RGB % 8 == 0 &&
                    block_off(W_, 1) % 8 == 0 &&
                    block_off(W_, SKIP + 1) % 8 == 0,
                "16-byte aligned weight blocks");
  // shared memory: the activation rows, the weight stage (KC rows of the
  // widest product), then 4 f32 rows of TP (sigma, rgb)
  template <typename T>
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(T) * (ROWS * TP + Cfg<T>::KC * W) + sizeof(float) * 4 * TP;
  }
};

using Ref = Net<256, 8>;
// Kernel G's geometry: at W > 256 a warp owns 4 points (a 32-point tile), so
// a thread's accumulators, PPW x W / 32 floats, stay within 80 (W = 640)
// and every product is still accumulated in one pass.
template <int Width>
using Wide = Net<Width, (Width <= 256 ? 8 : 4)>;

// The reference geometry's names, used by kernels C-F and H.
constexpr int W = Ref::W, WH = Ref::WH, TP = Ref::TP;
constexpr int ROW_H = Ref::ROW_H, ROW_DIR = Ref::ROW_DIR, ROWS = Ref::ROWS;
__host__ __device__ constexpr long long layer_off(int i) {
  return Ref::layer_off(i);
}
constexpr long long OFF_SIG = Ref::OFF_SIG, OFF_FIN = Ref::OFF_FIN;
constexpr long long OFF_DIR = Ref::OFF_DIR, OFF_RGB = Ref::OFF_RGB;
constexpr long long N_WEIGHTS = Ref::N_WEIGHTS;
constexpr int BOFF_SIG = Ref::BOFF_SIG, BOFF_FIN = Ref::BOFF_FIN;
constexpr int BOFF_DIR = Ref::BOFF_DIR, BOFF_RGB = Ref::BOFF_RGB;
constexpr int N_BIASES = Ref::N_BIASES;
static_assert(N_WEIGHTS == 593408, "one multiply-add per weight per point");
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return Ref::smem_bytes<T>();
}

// Activation stash (reference geometry only), one row of SC elements per
// point, in the weight type (nerf_pl_tpu/ops/fused_mlp.py:688-700): h1..h8
// at (i - 1) * W, then fin and d in rgb mode.  Sigma-only rows stop after h8.
constexpr int S_FIN = D * W, S_D = S_FIN + W;
constexpr int SC_RGB = S_D + WH, SC_SIGMA = D * W;  // 2432, 2048

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

// n consecutive values of T -> f32 (one warp's points, or one lane's
// features), in one vector load
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
__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&b)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack2(u.x, b[0], b[1]); unpack2(u.y, b[2], b[3]);
}
__device__ __forceinline__ void load2(const float* p, float (&b)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  b[0] = u.x; b[1] = u.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&b)[2]) {
  unpack2(*reinterpret_cast<const uint32_t*>(p), b[0], b[1]);
}
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&a)[8]) { load8(p, a); }
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&a)[4]) { load4(p, a); }
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&a)[2]) { load2(p, a); }

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

// How a product's N output columns are spread over a warp's lanes: in
// groups of 32 * CPL columns, lane l holding columns [CPL l, CPL l + CPL) of
// each group.  N = 128 k takes CPL = 4 (the reference kernels' mapping);
// the wide dir heads (W / 2 = 64, 192, 320) and dx's 64 columns take 2.
template <int N>
struct Lanes {
  static_assert(N % 64 == 0, "a product's width is a multiple of 64");
  static constexpr int CPL = N % 128 == 0 ? 4 : 2;
  static constexpr int GW = 32 * CPL, NG = N / GW;
};

// acc[i][g * CPL + j] = sum_k act[in_row + k][PPW * warp + i] * w[k][n],
// n = g * GW + CPL * lane + j, for k < K; w is (K, N) row-major, streamed
// through the shared stage ws, KC rows at a time.  Products and sums in
// f32, in order of k.  act's rows are LDA elements apart (the tile's TP
// points unless a caller pads them).  Ends with a barrier: every read of
// the input rows is done when it returns.
template <class Geo, typename T, int N, int LDA = Geo::TP>
__device__ __forceinline__ void dense_acc(const T* __restrict__ w, int K,
                                          const T* act, int in_row, T* ws,
                                          float (&acc)[Geo::PPW][N / 32]) {
  constexpr int PPW = Geo::PPW, TPP = LDA;
  constexpr int CPL = Lanes<N>::CPL, GW = Lanes<N>::GW, NG = Lanes<N>::NG;
  constexpr int KC = Cfg<T>::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < PPW; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the previous stage has been consumed
    const uint4* src = reinterpret_cast<const uint4*>(w + 1LL * k0 * N);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    const int nvec = kc * N * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < nvec; i += THREADS) dst[i] = src[i];
    __syncthreads();
    const T* arow = act + (in_row + k0) * TPP + warp * PPW;
    const T* wrow = ws + lane * CPL;
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float a[PPW];
      loadv(arow + kk * TPP, a);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float b[CPL];
        loadv(wrow + kk * N + g * GW, b);
#pragma unroll
        for (int i = 0; i < PPW; ++i)
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            acc[i][g * CPL + j] = fmaf(a[i], b[j], acc[i][g * CPL + j]);
      }
    }
  }
  __syncthreads();  // every read of the input rows is done
}

// act rows [out_row, out_row + N) = act(rows [in_row, in_row + K)) @ w + bias,
// optional ReLU, rounded to T.  With a stash (reference geometry), each
// point's rounded outputs also go to its stash row at column scol (points
// past P are not stored).
template <class Geo, typename T, int N, bool STASH>
__device__ __forceinline__ void dense(const T* __restrict__ w,
                                      const float* __restrict__ bias, int K,
                                      T* act, int in_row, int out_row, T* ws,
                                      bool relu, T* stash, int sc, int scol,
                                      long long n_valid) {
  constexpr int PPW = Geo::PPW, TPP = Geo::TP;
  constexpr int CPL = Lanes<N>::CPL, GW = Lanes<N>::GW, NG = Lanes<N>::NG;
  static_assert(!STASH || (Geo::W == W && PPW == 8 && CPL == 4),
                "the stash is written at the reference geometry");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[PPW][N / 32];
  dense_acc<Geo, T, N>(w, K, act, in_row, ws, acc);
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int n = g * GW + lane * CPL + j;
      const float bn = bias[n];
      T* orow = act + (out_row + n) * TPP + warp * PPW;
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        float v = acc[i][g * CPL + j] + bn;
        if (relu) v = fmaxf(v, 0.0f);
        orow[i] = from_f<T>(v);
      }
    }
  if constexpr (STASH) {  // this thread's own outputs, read back from smem
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n0 = g * GW + lane * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = warp * 8 + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = to_f(act[(out_row + n0 + j) * TPP + p]);
        if (p < n_valid) store4(stash + 1LL * p * sc + scol + n0, v);
      }
    }
  }
  __syncthreads();
}

// The input of a tile at the kernel boundary, a compile-time parameter:
//   IO_CHANNEL  raw rays, channel-major x and out (8, P), element (c, p) at
//               c * P + p (kernels C-F);
//   IO_ROW      raw rays, row-major (P, 8), element (p, c) at p * 8 + c
//               (kernels C'-F');
//   IO_EMBEDDED pre-embedded rows x (P, x_cols) f32, x_cols = CX (xyz_emb)
//               or CX + CD ([xyz_emb | dir_emb]); out and g row-major
//               (P, 8) (kernels G and H).
enum Io : int { IO_CHANNEL = 0, IO_ROW = 1, IO_EMBEDDED = 2 };
constexpr int IO = 8;  // channels of raw x, out and g
__host__ __device__ constexpr long long io_at(bool row_major, int c,
                                              long long p, long long P) {
  return row_major ? p * IO + c : c * P + p;
}

// Row-major only: copy the tile's (TP, 8) rows of x, contiguous f32, into
// xs in 16-byte vectors, zeros past P.  Ends with a barrier.
template <class Geo>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           long long P, long long p0,
                                           float* xs) {
  const long long n_valid = P - p0;
  for (int i = threadIdx.x; i < Geo::TP * IO / 4; i += THREADS) {
    const int p = i / (IO / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < n_valid) v = reinterpret_cast<const float4*>(x + p0 * IO)[i];
    reinterpret_cast<float4*>(xs)[i] = v;
  }
  __syncthreads();
}

// Raw rays: embed the tile's points into act rows [0, CX) and, unless
// sigma-only, [ROW_DIR, ROW_DIR + CD).  Points past P embed zeros and are
// never stored.  Row-major input is first staged in ws (the weight stage,
// free until the first product, whose opening barrier orders these reads
// before it).
template <class Geo, typename T, bool ROW_MAJOR>
__device__ __forceinline__ void embed(const float* __restrict__ x,
                                      long long P, long long p0, T* act,
                                      T* ws, bool with_dir) {
  constexpr int TPP = Geo::TP;
  const float* src = x;  // element (c, p) of the tile at src[io_at(..)]
  long long ld = P, q0 = p0;
  if (ROW_MAJOR) {
    float* xs = reinterpret_cast<float*>(ws);
    stage_rows<Geo>(x, P, p0, xs);
    src = xs;
    ld = TPP;
    q0 = 0;
  }
  const int n_rows = with_dir ? CX + CD : CX;
  for (int i = threadIdx.x; i < n_rows * TPP; i += THREADS) {
    const int r = i / TPP, p = i - r * TPP;
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
    act[(is_dir ? Geo::ROW_DIR + c : c) * TPP + p] = from_f<T>(v);
  }
}

// Pre-embedded rows: the tile's rows of x (P, x_cols), rounded to T, into
// act rows [0, CX) and, unless sigma-only, [ROW_DIR, ROW_DIR + CD); a
// channel past x_cols (dir_emb of 63-column rows) and points past P are
// zeros.  Consecutive threads read consecutive floats of the tile's rows.
template <class Geo, typename T>
__device__ __forceinline__ void load_embedded(const float* __restrict__ x,
                                              int x_cols, long long P,
                                              long long p0, T* act,
                                              bool with_dir) {
  constexpr int TPP = Geo::TP;
  const int n_rows = with_dir ? CX + CD : CX;
  for (int i = threadIdx.x; i < n_rows * TPP; i += THREADS) {
    const int p = i / n_rows, c = i - p * n_rows;
    const long long gp = p0 + p;
    float v = 0.0f;
    if (gp < P && c < x_cols) v = x[gp * x_cols + c];
    act[(c < CX ? c : Geo::ROW_DIR + c - CX) * TPP + p] = from_f<T>(v);
  }
}

// The input rows of a tile, whatever the layout (see Io).
template <class Geo, typename T, int IN>
__device__ __forceinline__ void tile_input(const float* __restrict__ x,
                                           int x_cols, long long P,
                                           long long p0, T* act, T* ws,
                                           bool with_dir) {
  if constexpr (IN == IO_EMBEDDED)
    load_embedded<Geo, T>(x, x_cols, P, p0, act, with_dir);
  else
    embed<Geo, T, IN == IO_ROW>(x, P, p0, act, ws, with_dir);
}

// The forward of one tile of TP points starting at p0.  Writes the output
// channels for the tile's points into out (8, P) or (P, 8) unless out is
// null, and, with a stash, each point's stash row (stash points at the
// tile's first row).  On return act rows [0, CX) and [ROW_DIR, ROW_DIR + CD)
// still hold the tile's input embedding.  x_cols: the columns of
// pre-embedded x (IO_EMBEDDED), unused otherwise.
template <class Geo, typename T, bool SIGMA_ONLY, bool STASH, int IN>
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ x, float* __restrict__ out,
    const T* __restrict__ wts, const float* __restrict__ bias, long long P,
    long long p0, unsigned char* smem, T* stash, int x_cols) {
  constexpr int GW_ = Geo::W, TPP = Geo::TP, RH = Geo::ROW_H;
  T* act = reinterpret_cast<T*>(smem);
  T* ws = act + Geo::ROWS * TPP;
  float* sig = reinterpret_cast<float*>(ws + Cfg<T>::KC * GW_);
  float* rgb = sig + TPP;  // 3 rows of TP
  const int tid = threadIdx.x;
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long n_valid = P - p0;

  tile_input<Geo, T, IN>(x, x_cols, P, p0, act, ws, !SIGMA_ONLY);
  // layer 0 reads xyz_emb; the skip layer reads [xyz_emb | h] (rows
  // 0 .. CX + W); layer i's output h_{i+1} goes to stash column i * W
  dense<Geo, T, GW_, STASH>(wts, bias, CX, act, 0, RH, ws, true, stash, SC, 0,
                            n_valid);
  for (int i = 1; i < D; ++i)
    dense<Geo, T, GW_, STASH>(wts + Geo::layer_off(i), bias + i * GW_,
                              i == SKIP ? GW_ + CX : GW_, act,
                              i == SKIP ? 0 : RH, RH, ws, true, stash, SC,
                              i * GW_, n_valid);

  if (tid < TPP) {  // sigma head: one thread per point
    float s = 0.0f;
    for (int k = 0; k < GW_; ++k)
      s = fmaf(to_f(act[(RH + k) * TPP + tid]), to_f(wts[Geo::OFF_SIG + k]),
               s);
    sig[tid] = s + bias[Geo::BOFF_SIG];
  }
  if (!SIGMA_ONLY) {
    // fin overwrites h (after dense's barrier: the sigma head has read it)
    dense<Geo, T, GW_, STASH>(wts + Geo::OFF_FIN, bias + Geo::BOFF_FIN, GW_,
                              act, RH, RH, ws, false, stash, SC, S_FIN,
                              n_valid);
    // dir head reads [fin | dir_emb] = rows ROW_H .. ROW_H + W + CD
    dense<Geo, T, Geo::WH, STASH>(wts + Geo::OFF_DIR, bias + Geo::BOFF_DIR,
                                  GW_ + CD, act, RH, RH, ws, true, stash, SC,
                                  S_D, n_valid);
    if (tid < 3 * TPP) {  // rgb head: one thread per (channel, point)
      const int c = tid / TPP, p = tid - c * TPP;
      float v = 0.0f;
      for (int k = 0; k < Geo::WH; ++k)
        v = fmaf(to_f(act[(RH + k) * TPP + p]),
                 to_f(wts[Geo::OFF_RGB + 3 * k + c]), v);
      v += bias[Geo::BOFF_RGB + c];
      rgb[c * TPP + p] = 1.0f / (1.0f + expf(-v));
    }
  }
  __syncthreads();
  if (out == nullptr) return;
  auto value = [&](int r, int p) {  // output channel r of point p
    if (SIGMA_ONLY) return r == 0 ? sig[p] : 0.0f;
    return r < 3 ? rgb[r * TPP + p] : (r == 3 ? sig[p] : 0.0f);
  };
  if (IN != IO_CHANNEL) {  // each point's 8 channels: two 16-byte stores
    for (int i = tid; i < TPP * IO / 4; i += THREADS) {
      const int p = i / (IO / 4), r0 = (i % (IO / 4)) * 4;
      if (p0 + p >= P) continue;
      reinterpret_cast<float4*>(out + p0 * IO)[i] =
          make_float4(value(r0, p), value(r0 + 1, p), value(r0 + 2, p),
                      value(r0 + 3, p));
    }
    return;
  }
  for (int i = tid; i < IO * TPP; i += THREADS) {
    const int r = i / TPP, p = i - r * TPP;
    const long long gp = p0 + p;
    if (gp >= P) continue;
    out[r * P + gp] = value(r, p);
  }
}

}  // namespace nerf
