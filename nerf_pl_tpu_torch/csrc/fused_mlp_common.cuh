// Shared device code of the fused NeRF MLP kernels: the packed weight
// layout, the activation stash layout, the input of a tile (the positional
// encoding of raw rays, or pre-embedded rows), the tile forward that
// kernels C, D (fused_mlp.cu), G (fused_mlp_wide.cu) and F, H
// (fused_mlp_bwd.cu) run, and the rounding-tie repair of the tensor-core
// products (the forward's and the backward's dgrad sweep).  See
// fused_mlp.cu for the numerics and the design.
//
// The weight type T is float, __nv_bfloat16 or __half.  The two 16-bit
// types run the same tensor-core code (mma.sync m16n8k16 takes either, with
// the same fragments); they differ in the instruction's element type, the
// conversions, and where their rounding ties lie (near_tie below).
//
// The network's geometry is a template parameter (struct Net): the trunk
// width W and the points per warp PPW (a CTA's tile is TP = 8 * PPW points).
// Kernels C-F and H run the reference geometry Ref = Net<256, 8>; kernel G
// runs W = 128..640 (Wide<W>).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace nerf {

using bf16 = __nv_bfloat16;
using f16 = __half;
// 16-bit products run on the tensor cores (mma.sync); f32 runs on the CUDA
// cores (one fmaf chain an output, in order of k: TF32 would break its
// limits and its pinned bits)
template <typename T>
constexpr bool kTensorCores =
    std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

constexpr int CX = 63, CD = 27, D = 8, SKIP = 4;
constexpr int THREADS = 256;  // 8 warps; warp w owns points [PPW w, PPW w + PPW)

// KC: weight rows per shared stage of the 16-bit scalar loop (H's dx
// products)
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int KC = 32; };
template <> struct Cfg<__half> { static constexpr int KC = 32; };

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
  // The 16-bit tile on the tensor cores: the activation rows padded to
  // LDA_MMA points (ldmatrix.trans reads eight rows 16 (TP = 64) or 8 (TP = 32)
  // bytes past a multiple of 128 apart: distinct banks), their count to a
  // multiple of 16 (a product's last 16-row step stays inside the rows);
  // the weights stream through a ring of STAGES stages of KC_MMA rows, each
  // row padded to N + 8 elements (distinct banks again), a stage's slot
  // sized for the widest product; three stages where two CTAs still fit
  // an SM, else two.
  static constexpr int LDA_MMA = TP + 8;
  static constexpr int ACT_ROWS_MMA = (ROWS + 15) / 16 * 16;
  static constexpr int KC_MMA = W_ <= 256 ? 32 : 16;
  static constexpr int SLOT = KC_MMA * (W_ + 8);
  static constexpr int STAGES =
      2 * (ACT_ROWS_MMA * LDA_MMA + 3 * SLOT) + 16 * TP <= 112 * 1024 ? 3
                                                                        : 2;
  // The f32 tile on the CUDA cores: the activation rows padded to LDA_F32
  // points (TP + 4: the lanes of a quarter-warp store 4 points of output
  // columns 4 rows apart, which the pad spreads over two 16-byte bank
  // groups, not one, and a row stays 16-byte aligned for the vector
  // loads); the weights stream through a ring of STAGES_F32 stages of
  // KC_F32 rows of the widest product (W columns), by cp.async, the next
  // stage's copy in flight while one is consumed.  At W = 256 the tile's
  // forward and its backward's sweep (which adds 1,792 bytes) fit two CTAs
  // an SM.
  static constexpr int LDA_F32 = TP + 4;
  static constexpr int KC_F32 = W_ <= 256 ? 8 : 4;
  static constexpr int STAGES_F32 = 2;
  static constexpr int SLOT_F32 = KC_F32 * W_;
  // the activation rows' pitch, and the elements of T before the f32 rows
  template <typename T>
  __host__ __device__ static constexpr int lda() {
    return kTensorCores<T> ? LDA_MMA : LDA_F32;
  }
  template <typename T>
  __host__ __device__ static constexpr int act_elems() {
    return kTensorCores<T> ? ACT_ROWS_MMA * LDA_MMA : ROWS * LDA_F32;
  }
  template <typename T>
  __host__ __device__ static constexpr int ws_elems() {
    return kTensorCores<T> ? STAGES * SLOT : STAGES_F32 * SLOT_F32;
  }
  // shared memory: the activation rows, the weight ring, then 4 f32 rows of
  // TP (sigma, rgb)
  template <typename T>
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(T) * (act_elems<T>() + ws_elems<T>()) +
           sizeof(float) * 4 * TP;
  }
};

using Ref = Net<256, 8>;
// Kernel G's geometry: at W > 256 a warp owns 4 points (a 32-point tile), so
// a thread's accumulators, PPW x W / 32 floats, stay within 80 (W = 640)
// and every product is still accumulated in one pass.
template <int Width>
using Wide = Net<Width, (Width <= 256 ? 8 : 4)>;

// The weight type's code at the C interface (ops/fused_mlp.py DTYPE_CODES).
enum DType : int { DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_F16 = 2 };
// The weight types a library is built for, a bitmask of 1 << DType: the
// build (ops/native.py) compiles each fused source into a library of f32
// and bf16 kernels (3) and one of fp16 kernels (4), in parallel; a code the
// library is not built for is refused as any unknown code.
#if !defined(NERF_DTYPES) || (NERF_DTYPES != 3 && NERF_DTYPES != 4)
#error "NERF_DTYPES must be 3 (f32 and bf16) or 4 (fp16): see ops/native.py"
#endif
template <int DT>
constexpr bool kBuilt = ((NERF_DTYPES) >> DT) & 1;

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

// ReLU as jnp.maximum(v, 0) computes it: a NaN stays NaN (fmaxf would
// return 0 and hide a NaN weight or input from the caller).  max.NaN is one
// instruction, as fmaxf is; a compare and select instead made ptxas spill
// in the float32 stash kernels (D: 60 B stores, 172 B loads a thread).
__device__ __forceinline__ float relu_keep_nan(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.0f));
  return r;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}
// round to nearest even, fp16 subnormals kept and past 65,504 inf, as
// astype(float16) rounds (nvcc without fast math keeps the subnormals)
template <> __device__ __forceinline__ __half from_f(float v) {
  return __float2half_rn(v);
}

// a pair of 16-bit values (a 4-byte store), and two floats rounded into one
template <typename T> struct Pair16;
template <> struct Pair16<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static type make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <> struct Pair16<__half> {
  using type = __half2;
  __device__ static type make(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

// The remat route's scratch stash (kernels F, F' and H in fp16) must keep,
// for the backward's ReLU masks, which activations were positive before
// rounding: JAX's remat backward reads its masks from the f32 recompute
// (_acts_accessors), its stash backward from the rounded stash, and in fp16
// a positive activation below 2^-25 rounds to 0 (bf16 keeps f32's range).
// With KEEP_SIGN such an activation is stored as -0: an operand of 0 all
// the same (the wgrad and the next product add nothing for it), and a mask
// of 1 (act_positive).
template <typename T, bool KEEP_SIGN>
__device__ __forceinline__ T round_act(float v) {
  T r = from_f<T>(v);
  if constexpr (KEEP_SIGN) {
    if (v == 0.0f)
      r = from_f<T>(0.0f);  // a zero of either sign is +0: not positive
    else if (v > 0.0f && to_f(r) == 0.0f)
      r = from_f<T>(-0.0f);
  }
  return r;
}
template <typename T, bool KEEP_SIGN>
__device__ __forceinline__ typename Pair16<T>::type round_pair(float a,
                                                              float b) {
  auto r = Pair16<T>::make(a, b);
  if constexpr (KEEP_SIGN) {
    r.x = round_act<T, true>(a);
    r.y = round_act<T, true>(b);
  }
  return r;
}
// the backward's ReLU mask of a stashed activation m: m > 0, and with
// keep_sign (the remat route) also m = -0 (round_act)
__device__ __forceinline__ bool act_positive(float m, bool keep_sign) {
  return m > 0.0f || (keep_sign && __float_as_uint(m) == 0x80000000u);
}

__device__ __forceinline__ void unpack2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void unpack2h(uint32_t u, float& lo, float& hi) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u));
  lo = f.x;
  hi = f.y;
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
__device__ __forceinline__ void load8(const __half* p, float (&a)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack2h(u.x, a[0], a[1]); unpack2h(u.y, a[2], a[3]);
  unpack2h(u.z, a[4], a[5]); unpack2h(u.w, a[6], a[7]);
}
__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&b)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack2(u.x, b[0], b[1]); unpack2(u.y, b[2], b[3]);
}
__device__ __forceinline__ void load4(const __half* p, float (&b)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack2h(u.x, b[0], b[1]); unpack2h(u.y, b[2], b[3]);
}
__device__ __forceinline__ void load2(const float* p, float (&b)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  b[0] = u.x; b[1] = u.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&b)[2]) {
  unpack2(*reinterpret_cast<const uint32_t*>(p), b[0], b[1]);
}
__device__ __forceinline__ void load2(const __half* p, float (&b)[2]) {
  unpack2h(*reinterpret_cast<const uint32_t*>(p), b[0], b[1]);
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
template <typename T16>
__device__ __forceinline__ void store4_16(T16* p, const float (&v)[4]) {
  auto lo = Pair16<T16>::make(v[0], v[1]);
  auto hi = Pair16<T16>::make(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  store4_16(p, v);
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  store4_16(p, v);
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

// One k of an f32 product: the warp's PPW points of an activation row (a
// broadcast) times this lane's CPL columns of each group of a weight row.
template <int N, int PPW>
__device__ __forceinline__ void fma_row(const float* arow, const float* wrow,
                                        float (&acc)[PPW][N / 32]) {
  constexpr int CPL = Lanes<N>::CPL, GW = Lanes<N>::GW, NG = Lanes<N>::NG;
  float a[PPW];
  loadv(arow, a);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float b[CPL];
    loadv(wrow + g * GW, b);
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        acc[i][g * CPL + j] = fmaf(a[i], b[j], acc[i][g * CPL + j]);
  }
}

// acc[i][g * CPL + j] = sum_k act[in_row + k][PPW * warp + i] * w[k][n],
// n = g * GW + CPL * lane + j, for k < K; w is (K, N) row-major.  Products
// and sums in f32, one fmaf chain an output from 0 in order of k (the plain
// version's order).  act's rows are LDA elements apart (the tile's pitch
// unless a caller passes another).  Ends with a barrier: every read of the
// input rows and of ws is done when it returns.
//   f32 (the forward tile of C-D', G and the recompute of F, F', H; the
//   sweep; H's dx products): w streams through the ring ws, STAGES_F32
//   slots of KC_F32 rows, each stage a committed cp.async group of 16-byte
//   vectors (an empty one past the last stage, so that every thread counts
//   its groups alike); stage s + 1 is copied while stage s is consumed.  A
//   ragged last stage (K = 63, 283, 319) copies and sums only its live
//   rows.  The ring's first copies go out before any barrier: a caller
//   that has just read ws (the row-major input's staging) syncs first.
//   16-bit (H's dx products in bf16 and fp16): KC rows a stage of a shared
//   buffer, copied synchronously between two barriers.
template <class Geo, typename T, int N, int LDA = Geo::template lda<T>()>
__device__ __forceinline__ void dense_acc(const T* __restrict__ w, int K,
                                          const T* act, int in_row, T* ws,
                                          float (&acc)[Geo::PPW][N / 32]) {
  constexpr int PPW = Geo::PPW, TPP = LDA;
  constexpr int CPL = Lanes<N>::CPL, GW = Lanes<N>::GW, NG = Lanes<N>::NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < PPW; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.0f;

  if constexpr (std::is_same<T, float>::value) {
    constexpr int KC = Geo::KC_F32, S = Geo::STAGES_F32;
    static_assert(N <= Geo::W && S >= 2, "a stage's rows fit its slot");
    const int n_stages = (K + KC - 1) / KC;
    auto stage = [&](int s) {
      if (s < n_stages) {
        const int k0 = s * KC, nvec = min(KC, K - k0) * (N / 4);
        const float* src = w + 1LL * k0 * N;
        float* dst = ws + (s % S) * Geo::SLOT_F32;
        for (int i = threadIdx.x; i < nvec; i += THREADS)
          mma::cp_async16(dst + 4 * i, src + 4 * i);
      }
      mma::cp_async_commit();
    };
    for (int s = 0; s < S - 1; ++s) stage(s);
    for (int s = 0; s < n_stages; ++s) {
      mma::cp_async_wait<S - 2>();  // this thread's copies of stage s
      // every thread's copies of stage s have landed (and, at s = 0, the
      // input rows' last writes are visible); every warp is done with
      // stage s - 1, whose slot the next stage fills
      __syncthreads();
      stage(s + S - 1);
      const int k0 = s * KC, kc = min(KC, K - k0);
      const float* arow = act + (in_row + k0) * TPP + warp * PPW;
      const float* wrow = ws + (s % S) * Geo::SLOT_F32 + lane * CPL;
      if (kc == KC) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          fma_row<N>(arow + kk * TPP, wrow + kk * N, acc);
      } else {
        for (int kk = 0; kk < kc; ++kk)
          fma_row<N>(arow + kk * TPP, wrow + kk * N, acc);
      }
    }
  } else {
    constexpr int KC = Cfg<T>::KC;
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
  }
  __syncthreads();  // every read of the input rows and of ws is done
}

// act rows [out_row, out_row + N) = act(rows [in_row, in_row + K)) @ w +
// bias, optional ReLU, in f32 (the 16-bit types run mma_dense).  With a
// stash (reference geometry), each point's outputs also go to its stash row
// at column scol (points past P are not stored).  The outputs go to the
// activation rows as 16-byte vectors of the thread's PPW points down each
// of its columns, and to the stash from the registers as 16-byte vectors of
// its 4 columns of each point.
template <class Geo, typename T, int N, bool STASH>
__device__ __forceinline__ void dense(const T* __restrict__ w,
                                      const float* __restrict__ bias, int K,
                                      T* act, int in_row, int out_row, T* ws,
                                      bool relu, T* stash, int sc, int scol,
                                      long long n_valid) {
  static_assert(std::is_same<T, float>::value, "the f32 epilogue");
  constexpr int PPW = Geo::PPW, LD = Geo::LDA_F32;
  constexpr int CPL = Lanes<N>::CPL, GW = Lanes<N>::GW, NG = Lanes<N>::NG;
  static_assert(!STASH || (Geo::W == W && PPW == 8 && CPL == 4),
                "the stash is written at the reference geometry");
  static_assert(PPW % 4 == 0, "whole vectors of points");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[PPW][N / 32];
  dense_acc<Geo, T, N>(w, K, act, in_row, ws, acc);
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int n = g * GW + lane * CPL + j;
      const float bn = bias[n];
      float* orow = act + (out_row + n) * LD + warp * PPW;
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        float v = acc[i][g * CPL + j] + bn;
        if (relu) v = relu_keep_nan(v);
        acc[i][g * CPL + j] = v;
      }
#pragma unroll
      for (int i = 0; i < PPW; i += 4)
        *reinterpret_cast<float4*>(orow + i) =
            make_float4(acc[i][g * CPL + j], acc[i + 1][g * CPL + j],
                        acc[i + 2][g * CPL + j], acc[i + 3][g * CPL + j]);
    }
  if constexpr (STASH) {  // this thread's 4 columns of each of its points
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int p = warp * PPW + i;
        if (p < n_valid)
          *reinterpret_cast<float4*>(stash + 1LL * p * sc + scol + g * GW +
                                     lane * 4) =
              make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                          acc[i][g * 4 + 3]);
      }
  }
  __syncthreads();
}

// Ties.  The scalar loops sum each output in f32, one fused multiply-add a
// term in order of k (the order of dense_acc); the tensor cores sum 16 terms
// at a time in another order and precision, and each 16-term sum, started
// from zero, is then added in f32, so the f32 values differ in their last
// bits.  Where a value lies that close to a rounding tie of bf16, the
// rounded value would differ by one bf16 step, and such a step in a layer's
// input moves every later output of the point (down the forward's trunk, or
// down the backward's sweep).  So each tensor-core epilogue marks every
// output near a bf16 tie and recomputes it term by term in k order (fmaf
// from 0) from the product's own operands before rounding it.  Near: the tie
// of v's own bf16 interval (v's bits with the low 16 set to 0x8000) lies
// within TIE_ULPS f32 ulps of v (at least TIE_MARGIN |v|: the ties of the
// next intervals lie at least 2^-9 |v| away).  A relative margin misses an
// output whose terms cancel (|v| far below the sum of |terms|, which sets
// the f32 error of either order), so the forward also marks an output
// whose own tie lies within a floor, or that is below 256 floors (where
// bf16 steps are finer than twice the floor): TIE_FLOOR times the largest
// |output| of the warp's block of the product (the sweep's floor is 0).
// About one output in 150 is marked in the forward.  Each warp keeps up to
// FIXW marks a product in shared memory (past that, an output keeps its
// tensor-core value).  The rule's test: tests/test_torch_port_forward_tile.py.
constexpr unsigned TIE_ULPS = 256;
constexpr float TIE_MARGIN = 1.0f / 65536.0f;
static_assert(TIE_ULPS / 16777216.0f == TIE_MARGIN,
              "TIE_ULPS ulps of v (2^-24 |v| or more each) >= TIE_MARGIN |v|");
constexpr float TIE_FLOOR = 1.0f / 1048576.0f;
constexpr int FIXW = 64;

__device__ __forceinline__ bool near_tie(float v, float floor = 0.0f) {
  const uint32_t u = __float_as_uint(v);
  const float tie = __uint_as_float((u & 0xffff0000u) | 0x8000u);
  return (u & 0xffffu) - (0x8000u - TIE_ULPS + 1) < 2 * TIE_ULPS - 1 ||
         fabsf(v) < 256.0f * floor || fabsf(v - tie) < floor;
}

// The same rule for fp16, whose grid is another: a normal value (|v| >=
// 2^-14) keeps 10 of f32's 23 mantissa bits, so its step is 2^13 f32 ulps
// (bf16's 2^16) and its own tie is v's bits with the low 13 set to 0x1000;
// below 2^-14 the subnormals step by 2^-24 whatever v's exponent; and past
// 65,504 the next boundary is 65,520, above which astype(float16) gives
// inf.  So the fp16 rule measures v's distance to both boundaries of its
// rounding interval: the midpoints between v's rounded value r and r's two
// fp16 neighbours (exact in f32: two neighbouring fp16 values and their sum
// carry at most 12 significant bits), 65,520 above 65,504, and the
// symmetric -2^-25 below r = 0.  An output is marked where the nearer
// boundary lies within TIE_ULPS f32 ulps of v or within the floor (which
// also covers bf16's "below 256 floors" clause: that clause stands for the
// neighbouring interval's tie, which is measured here).  The margins are
// bf16's, taken in f32 ulps and in the warp's largest |output|: they bound
// the distance between the two f32 sum orders, which the format does not
// change.  What changes is how many outputs fall inside them: 2 TIE_ULPS
// of every 2^13 ulps, 1/16 of the normal outputs against bf16's 1/128, so
// a warp lists up to FIXW_F16 marks a product (a 256-column product gives a
// warp 2,048 outputs: 128 marks in the mean; the floor adds the outputs
// below about 2^-9 of the block's largest, where fp16 steps are finer than
// twice the floor).  Its marks go to the idle weight ring (the forward) or
// the idle dgrad ring (the sweep), which hold them at every width.
constexpr int FIXW_F16 = 320;
static_assert(2 * TIE_ULPS < (1u << 13) / 8,
              "the fp16 window is a small part of the fp16 step");
static_assert(2 * 2048 * (2 * TIE_ULPS) / (1u << 13) <= FIXW_F16,
              "FIXW_F16 lists twice a 256-column product's mean marks");
static_assert(2048.0f * TIE_FLOOR == 1.0f / 512.0f,
              "fp16 steps (2^-10 |v| at most) are finer than twice the floor "
              "below 2^11 floors, 2^-9 of the block's largest |output|");

__device__ __forceinline__ bool near_tie_f16(float v, float floor) {
  const float a = fabsf(v);
  const unsigned short h = __half_as_ushort(__float2half_rn(a));
  float lo, hi;  // the boundaries of a's rounding interval
  if (h >= 0x7c00u) {  // inf (a NaN is never marked: its gap is NaN)
    lo = 65520.0f;
    hi = __int_as_float(0x7f800000);
  } else {
    const float r = __half2float(__ushort_as_half(h));
    hi = h == 0x7bffu
             ? 65520.0f
             : 0.5f * (r + __half2float(__ushort_as_half(
                               static_cast<unsigned short>(h + 1))));
    lo = h == 0 ? -hi
                : 0.5f * (r + __half2float(__ushort_as_half(
                                  static_cast<unsigned short>(h - 1))));
  }
  const float gap = fminf(hi - a, a - lo);
  // TIE_ULPS f32 ulps of a: 2^(e - 23) each for a in [2^e, 2^(e + 1))
  const float ulps = __uint_as_float(__float_as_uint(a) & 0x7f800000u) *
                     (static_cast<float>(TIE_ULPS) / 8388608.0f);
  return gap < fmaxf(ulps, floor);
}

// The rule and the list's size for the weight type T (bf16 or fp16).
template <typename T>
__device__ __forceinline__ bool near_tie_t(float v, float floor = 0.0f) {
  if constexpr (std::is_same<T, f16>::value)
    return near_tie_f16(v, floor);
  else
    return near_tie(v, floor);
}
template <typename T>
constexpr int kFixW = std::is_same<T, f16>::value ? FIXW_F16 : FIXW;

// The warp's list of marks.  ties: this lane's marked outputs e (bit e % 64
// of word e / 64).  The lanes' marks are numbered by a prefix sum over the
// lanes, lane l's from slot `first` on in order of e, and fix_pn[slot] =
// pn(e) for every slot below CAP (kFixW of the weight type).  Returns the
// warp's count of listed marks (at most CAP).
template <int CAP, int MW, class PN>
__device__ __forceinline__ int list_marks(const unsigned long long (&ties)[MW],
                                          int* fix_pn, int& first, PN pn) {
  const int lane = threadIdx.x & 31;
  int count = 0;
#pragma unroll
  for (int w = 0; w < MW; ++w) count += __popcll(ties[w]);
  int upto = count;  // inclusive prefix sum over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, upto, d);
    if (lane >= d) upto += t;
  }
  first = upto - count;
  int slot = first;
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    unsigned long long rest = ties[w];
    for (; rest != 0 && slot < CAP; ++slot) {
      const int e = 64 * w + __ffsll(static_cast<long long>(rest)) - 1;
      rest &= rest - 1;
      fix_pn[slot] = pn(e);
    }
  }
  return min(__shfl_sync(0xffffffffu, upto, 31), CAP);
}

// f(e, slot) for each of this lane's listed marks, in the order and slots
// of list_marks.
template <int CAP, int MW, class F>
__device__ __forceinline__ void for_marks(const unsigned long long (&ties)[MW],
                                          int first, F f) {
  int slot = first;
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    unsigned long long rest = ties[w];
    for (; rest != 0 && slot < CAP; ++slot) {
      const int e = 64 * w + __ffsll(static_cast<long long>(rest)) - 1;
      rest &= rest - 1;
      f(e, slot);
    }
  }
}

// The 16-bit product of a tile on the tensor cores (mma.sync m16n8k16, bf16 or
// fp16 operands, f32 sums): the TP x K activation block (rows [in_row, in_row
// + K) of act, feature-major, pitch LDA_MMA) times w (K x N row-major, the
// packed layout).  Warp (wm, wn) = (warp / 4, warp % 4) owns points [TP / 2
// wm, TP / 2 (wm + 1)) and columns [N / 4 wn, N / 4 (wn + 1)); acc[mi][nt] is
// the m16n8 tile at point TP / 2 wm + 16 mi, column N / 4 wn + 8 nt: lane t
// holds its points t / 4 (acc[..][0], [1]) and t / 4 + 8 ([2], [3]), columns
// 2 (t % 4) and 2 (t % 4) + 1.
template <class Geo, int N>
struct MmaTile {
  static_assert(N % 64 == 0 && Geo::TP % 32 == 0, "whole 16 x 16 pairs");
  static constexpr int MI = Geo::TP / 32, NT = N / 32, E = MI * NT * 4;
  static constexpr int MW = (E + 63) / 64;  // words of tie bits a thread
  static constexpr int NPITCH = N + 8;      // a weight stage's row pitch
  static_assert(Geo::KC_MMA * NPITCH <= Geo::SLOT, "a stage fits its slot");
  __device__ static int point(int e) {  // output e = acc[..] index flat
    const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) >> 2;
    return wm * (Geo::TP / 2) + (e / (4 * NT)) * 16 + (lane >> 2) +
           ((e >> 1) & 1) * 8;
  }
  __device__ static int column(int e) {
    const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
    return wn * (N / 4) + ((e >> 2) % NT) * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// acc = act rows [in_row, in_row + K) (as the A operand, by ldmatrix.trans)
// @ w.  w's rows stream through the ring in stages of KC_MMA rows, each a
// committed cp.async group (an empty one past the last stage, so that every
// thread counts its groups alike), STAGES - 1 in flight while one is
// consumed; rows past K are zero-filled, and the A fragments' columns past
// K are zeroed in registers (the rows there may hold anything).  Each
// 16-term tensor-core sum starts from zero and is added to acc in f32.
// Ends with a barrier: every read of the input rows and the ring is done.
template <class Geo, typename T, int N>
__device__ __forceinline__ void mma_product(
    const T* __restrict__ w, int K, const T* act, int in_row, T* ring,
    float (&acc)[MmaTile<Geo, N>::MI][MmaTile<Geo, N>::NT][4]) {
  using Tile = MmaTile<Geo, N>;
  constexpr int MI = Tile::MI, NT = Tile::NT, NPITCH = Tile::NPITCH;
  constexpr int LDA = Geo::LDA_MMA, KC = Geo::KC_MMA, S = Geo::STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
  const int n_stages = (K + KC - 1) / KC;
  auto stage = [&](int s) {
    if (s < n_stages) {
      T* buf = ring + (s % S) * Geo::SLOT;
      for (int i = threadIdx.x; i < KC * (N / 8); i += THREADS) {
        const int r = i / (N / 8), c = (i - r * (N / 8)) * 8;
        const int k = s * KC + r;
        const bool live = k < K;
        // a dead row reads nothing; its address is any valid one
        mma::cp_async16_zfill(buf + r * NPITCH + c,
                              live ? w + 1LL * k * N + c : w, live ? 16 : 0);
      }
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) stage(s);
  // A (points x k): lanes 0-7 rows k..k+7 at points +0, 8-15 at +8, 16-31
  // rows k+8..k+15; B (k x n) of two n8 tiles: lanes 0-7 rows k..k+7 at
  // columns +0, 8-15 rows k+8..k+15, 16-31 the same at columns +8; .trans
  // turns both row-major blocks into the fragments
  const T* abase = act + ((lane & 7) + ((lane >> 4) & 1) * 8) * LDA +
                      wm * (Geo::TP / 2) + ((lane >> 3) & 1) * 8;
  const int boff = ((lane & 7) + ((lane >> 3) & 1) * 8) * NPITCH +
                   wn * (N / 4) + (lane >> 4) * 8;
  for (int s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<S - 2>();  // this thread's copies of stage s
    // every thread's copies of stage s have landed (and, at s = 0, the
    // input rows' last writes are visible); every warp is done with stage
    // s - 1, whose slot the next stage fills
    __syncthreads();
    stage(s + S - 1);
    const T* wb = ring + (s % S) * Geo::SLOT;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      const int k = s * KC + ks;
      if (k >= K) break;
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma::ldmatrix_x4_trans(a[mi], abase + (in_row + k) * LDA + mi * 16);
      if (k + 16 > K) {  // the ragged last step: zero the columns past K
        const int kq = k + 2 * (lane & 3);
        const uint32_t lo = (kq < K ? 0x0000ffffu : 0u) |
                            (kq + 1 < K ? 0xffff0000u : 0u);
        const uint32_t hi = (kq + 8 < K ? 0x0000ffffu : 0u) |
                            (kq + 9 < K ? 0xffff0000u : 0u);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          a[mi][0] &= lo; a[mi][1] &= lo; a[mi][2] &= hi; a[mi][3] &= hi;
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        mma::ldmatrix_x4_trans(b, wb + boff + ks * NPITCH + np * 16);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma::mma16<T>(t0, a[mi], b[0], b[1]);
          mma::mma16<T>(t1, a[mi], b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][2 * np][e] += t0[e];
            acc[mi][2 * np + 1][e] += t1[e];
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the ring and the input rows
}

// dense's 16-bit counterpart on the tensor cores: act rows [out_row, out_row
// + N) = act(rows [in_row, in_row + K)) @ w + bias, optional ReLU, rounded
// to T (bf16 or fp16), and with a stash each point's rounded outputs to its
// stash row at column scol (points past P are not stored).  Three phases
// around the product: (A) bias and ReLU into acc, and a tie bit for each
// output near a tie of T (the warp's marks listed in the idle ring); (B)
// each warp recomputes its marked outputs in k order from the input rows,
// still in place, and w (device memory); a barrier, after which the outputs
// may overwrite the inputs; (C) the rounded outputs to act and the stash in
// the fragment's column pairs, then each thread's marked outputs over them
// from (B).  The tie floor is TIE_FLOOR times the warp's largest |x| (x = acc +
// bias, before the ReLU); under the ReLU a negative x is marked only where
// |x| is below the floor (where the other order may cross 0).  Ends with a
// barrier.
template <class Geo, typename T, int N, bool STASH, bool KEEP_SIGN>
__device__ __forceinline__ void mma_dense(const T* __restrict__ w,
                                          const float* __restrict__ bias,
                                          int K, T* act, int in_row,
                                          int out_row, T* ring, bool relu,
                                          T* stash, int sc, int scol,
                                          long long n_valid) {
  using Tile = MmaTile<Geo, N>;
  using Pair = typename Pair16<T>::type;
  constexpr int MI = Tile::MI, NT = Tile::NT, MW = Tile::MW;
  constexpr int LDA = Geo::LDA_MMA, FIX = kFixW<T>;
  static_assert(!STASH || Geo::W == W, "the stash is written at the "
                "reference geometry");
  static_assert(2 * FIX * 8 * sizeof(int) <= Geo::STAGES * Geo::SLOT *
                                                  sizeof(T),
                "the marks fit the ring");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[MI][NT][4];
  mma_product<Geo, T, N>(w, K, act, in_row, ring, acc);
  int* fix_pn = reinterpret_cast<int*>(ring) + warp * 2 * FIX;
  float* fix_val = reinterpret_cast<float*>(fix_pn + FIX);

  // the outputs are rounded into 16-bit pairs as they are marked, so the
  // f32 accumulators die during the marking (fewer live registers)
  float amax = 0.0f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = Tile::column((mi * NT + nt) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        amax = fmaxf(amax, fabsf(acc[mi][nt][q] + bias[n + (q & 1)]));
    }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, d));
  const float floor = TIE_FLOOR * amax;
  unsigned long long ties[MW];
  Pair out[MI][NT][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) ties[i] = 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = Tile::column((mi * NT + nt) * 4);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = acc[mi][nt][q] + bias[n + (q & 1)];
        const bool mark =
            relu && x < 0.0f ? -x < floor : near_tie_t<T>(x, floor);
        const int e = (mi * NT + nt) * 4 + q;
        if (mark) ties[e / 64] |= 1ull << (e % 64);
        v[q] = relu ? relu_keep_nan(x) : x;
      }
      out[mi][nt][0] = round_pair<T, KEEP_SIGN>(v[0], v[1]);
      out[mi][nt][1] = round_pair<T, KEEP_SIGN>(v[2], v[3]);
    }
  int first;
  const int marks = list_marks<FIX>(ties, fix_pn, first, [](int e) {
    return (Tile::point(e) << 16) | Tile::column(e);
  });
  __syncwarp();
  for (int i = lane; i < marks; i += 32) {
    const int p = fix_pn[i] >> 16, n = fix_pn[i] & 0xffff;
    const T* a = act + in_row * LDA + p;
    const T* wn = w + n;
    float s = 0.0f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {  // 4 weight loads in flight at a time
      float wk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wk[u] = to_f(wn[1LL * (k + u) * N]);
#pragma unroll
      for (int u = 0; u < 4; ++u) s = fmaf(to_f(a[(k + u) * LDA]), wk[u], s);
    }
    for (; k < K; ++k) s = fmaf(to_f(a[k * LDA]), to_f(wn[1LL * k * N]), s);
    float v = s + bias[n];
    if (relu) v = relu_keep_nan(v);
    fix_val[i] = v;
  }
  __syncthreads();  // every read of the input rows is done
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int e = (mi * NT + nt) * 4 + 2 * h;
        const int p = Tile::point(e), n = Tile::column(e);
        const Pair r = out[mi][nt][h];
        act[(out_row + n) * LDA + p] = r.x;
        act[(out_row + n + 1) * LDA + p] = r.y;
        if (STASH && p < n_valid)
          *reinterpret_cast<Pair*>(stash + 1LL * p * sc + scol + n) = r;
      }
  for_marks<FIX>(ties, first, [&](int e, int slot) {
    const int p = Tile::point(e), n = Tile::column(e);
    const T r = round_act<T, KEEP_SIGN>(fix_val[slot]);
    act[(out_row + n) * LDA + p] = r;
    if (STASH && p < n_valid) stash[1LL * p * sc + scol + n] = r;
  });
  __syncthreads();  // the outputs are in place; the ring is idle again
}

// One layer of the tile forward: the tensor cores in bf16 and fp16, the
// CUDA cores in f32 (where no positive value rounds to 0, so KEEP_SIGN
// has nothing to keep).
template <class Geo, typename T, int N, bool STASH, bool KEEP_SIGN>
__device__ __forceinline__ void layer(const T* __restrict__ w,
                                      const float* __restrict__ bias, int K,
                                      T* act, int in_row, int out_row, T* ws,
                                      bool relu, T* stash, int sc, int scol,
                                      long long n_valid) {
  if constexpr (kTensorCores<T>)
    mma_dense<Geo, T, N, STASH, KEEP_SIGN>(w, bias, K, act, in_row, out_row,
                                           ws, relu, stash, sc, scol,
                                           n_valid);
  else
    dense<Geo, T, N, STASH>(w, bias, K, act, in_row, out_row, ws, relu, stash,
                            sc, scol, n_valid);
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
// never stored.  Row-major input is first staged in ws (the weight ring,
// free until the first product; forward_tile syncs before that product's
// first copies).
template <class Geo, typename T, bool ROW_MAJOR>
__device__ __forceinline__ void embed(const float* __restrict__ x,
                                      long long P, long long p0, T* act,
                                      T* ws, bool with_dir) {
  constexpr int TPP = Geo::TP, LD = Geo::template lda<T>();
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
    act[(is_dir ? Geo::ROW_DIR + c : c) * LD + p] = from_f<T>(v);
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
  constexpr int TPP = Geo::TP, LD = Geo::template lda<T>();
  const int n_rows = with_dir ? CX + CD : CX;
  for (int i = threadIdx.x; i < n_rows * TPP; i += THREADS) {
    const int p = i / n_rows, c = i - p * n_rows;
    const long long gp = p0 + p;
    float v = 0.0f;
    if (gp < P && c < x_cols) v = x[gp * x_cols + c];
    act[(c < CX ? c : Geo::ROW_DIR + c - CX) * LD + p] = from_f<T>(v);
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
template <class Geo, typename T, bool SIGMA_ONLY, bool STASH, int IN,
          bool KEEP_SIGN = false>
__device__ __forceinline__ void forward_tile(
    const float* __restrict__ x, float* __restrict__ out,
    const T* __restrict__ wts, const float* __restrict__ bias, long long P,
    long long p0, unsigned char* smem, T* stash, int x_cols) {
  constexpr int GW_ = Geo::W, TPP = Geo::TP, RH = Geo::ROW_H;
  constexpr int LD = Geo::template lda<T>();
  T* act = reinterpret_cast<T*>(smem);
  T* ws = act + Geo::template act_elems<T>();
  float* sig = reinterpret_cast<float*>(ws + Geo::template ws_elems<T>());
  float* rgb = sig + TPP;  // 3 rows of TP
  const int tid = threadIdx.x;
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long n_valid = P - p0;

  tile_input<Geo, T, IN>(x, x_cols, P, p0, act, ws, !SIGMA_ONLY);
  // the first weight copies of a product go out before any barrier of it
  // (the tensor cores' ring and the f32 ring alike): the row-major input
  // staged in ws must be read by then
  __syncthreads();
  // layer 0 reads xyz_emb; the skip layer reads [xyz_emb | h] (rows
  // 0 .. CX + W); layer i's output h_{i+1} goes to stash column i * W
  layer<Geo, T, GW_, STASH, KEEP_SIGN>(wts, bias, CX, act, 0, RH, ws, true,
                                       stash, SC, 0, n_valid);
  for (int i = 1; i < D; ++i)
    layer<Geo, T, GW_, STASH, KEEP_SIGN>(
        wts + Geo::layer_off(i), bias + i * GW_, i == SKIP ? GW_ + CX : GW_,
        act, i == SKIP ? 0 : RH, RH, ws, true, stash, SC, i * GW_, n_valid);

  if (tid < TPP) {  // sigma head: one thread per point
    float s = 0.0f;
    for (int k = 0; k < GW_; ++k)
      s = fmaf(to_f(act[(RH + k) * LD + tid]), to_f(wts[Geo::OFF_SIG + k]),
               s);
    sig[tid] = s + bias[Geo::BOFF_SIG];
  }
  if (!SIGMA_ONLY) {
    // fin overwrites h (after the layer's barrier: the sigma head has read
    // it)
    layer<Geo, T, GW_, STASH, KEEP_SIGN>(wts + Geo::OFF_FIN,
                                         bias + Geo::BOFF_FIN, GW_, act, RH,
                                         RH, ws, false, stash, SC, S_FIN,
                                         n_valid);
    // dir head reads [fin | dir_emb] = rows ROW_H .. ROW_H + W + CD
    layer<Geo, T, Geo::WH, STASH, KEEP_SIGN>(
        wts + Geo::OFF_DIR, bias + Geo::BOFF_DIR, GW_ + CD, act, RH, RH, ws,
        true, stash, SC, S_D, n_valid);
    if (tid < 3 * TPP) {  // rgb head: one thread per (channel, point)
      const int c = tid / TPP, p = tid - c * TPP;
      float v = 0.0f;
      for (int k = 0; k < Geo::WH; ++k)
        v = fmaf(to_f(act[(RH + k) * LD + p]),
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
