// Kernels E and F: the backward of the fused NeRF MLP on channel-major
// (8, P) input: the f32 gradient of every packed weight and bias, given the
// output cotangent g (8, P).  The input cotangent is zero (rays are data)
// and is not computed.  E' and F': the same on row-major (P, 8) x and g
// (the dgrad kernel's IO_ROW input).  H: F on pre-embedded rows x (P, 63)
// or (P, 90) and g (P, 8) (IO_EMBEDDED), which also returns dx.
//
// Replaces (TPU, Pallas): nerf_pl_tpu/ops/fused_mlp.py::_raw_t_bwd_call
// (:1140, pallas_call :1171) -> E: _bwd_kernel_raw_stash_t (:1052), which
// reads the activation stash that kernel D wrote; F: _bwd_kernel_raw_t
// (:1067), which recomputes the forward instead (the route past
// STASH_MAX_POINTS, or stash_blocks=None).  Both run _bwd_core (:209-289).
// Row-major: E': _fused_raw_stash_bwd_call (:775, pallas_call :788) ->
// _bwd_kernel_raw_stash (:727), reading the stash of D'; F':
// _fused_raw_bwd_rule (:884, pallas_call :899) -> _bwd_kernel_raw (:660).
// H: nerf_pl_tpu/ops/fused_mlp.py::_fused_bwd_rule (:387, pallas_call
// :400) -> _bwd_kernel (:327), _bwd_core with want_dx, the backward of
// fused_nerf_apply (the pre-embedded kernel G's forward, fused_mlp_wide.cu),
// at the reference width only (as in JAX, whose _bwd_core slices at W = 256).
// Bounds as E and F (the boundary IO is 64 bytes a point in either
// layout).  Only the loads of x
// (staged in 16-byte vectors, as in C') and of g (one 16-byte load per
// point) differ; the sweep, the wgrad and the reduction are shared, so E'
// and F' give E's and F's bits on the same points.  The TPU kernels' zero
// dx is not written: the input gets no gradient.
//
// Numerics of _bwd_core, layer by layer from the top:
//   g_pre = g_h * (h_out > 0)                      f32
//   dgrad  g_in = round(g_pre) @ W^T               f32 products and sums
//   wgrad  dW  += round(a_in)^T @ round(g_pre)     f32, over all P points
//   bias   db  += sum of the unrounded g_pre       f32
// rgb head: g_rgbpre = g_rgb * rgb * (1 - rgb), rgb recomputed from the
// stashed d with the forward's own loop; g_h8 = round(g_fin) @ Wfin^T +
// round(g_sigma) * Wsig, two f32 terms added.  The skip layer's wgrad covers
// [x_emb | h4] and only its h rows carry the gradient on; the dir head's
// covers [fin | dir_emb].  x_emb and dir_emb are recomputed from the 8 raw
// rows, as on the TPU.  round() is the weight type T (bf16 or f32).
//
// Bound on the H100: operations.  E: 4 x 593,408 FLOP per rgb point (dgrad
// and wgrad) against a 4,864-byte stash read in bf16 (2.4 us per 1,000
// points at the tensor rate against 1.5 us of bytes); F: 6 x 593,408 FLOP
// (the forward again) and no stash.
// Design (simple first; tensor cores come later).  On the TPU the grid runs
// in order and the f32 weight grads stay resident across it; on Hopper the
// blocks run in parallel, so the weight-grad sum over points is a second
// pass, deterministic and without atomics.  Points go in chunks of `chunk`:
//   1. dgrad kernel, one CTA of 256 threads per 64-point tile (F first runs
//      the forward tile of kernel C/D into a chunk-sized scratch stash).
//      The sweep reuses the forward's product loop (dense_acc) against the
//      transposed weights, so each layer's gradient tile stays in shared
//      memory.  Each layer's rounded g_pre, and the embeddings, go to a
//      (chunk, GC) buffer in T; the f32 bias partials of each tile go to
//      their own row.
//   2. wgrad kernel: every dW tile (64 x 64 outputs) of every layer, split
//      over `split` point ranges; each CTA stages 32 points of a_in and g_pre
//      in shared memory and accumulates 4 x 4 outputs per thread in f32.
//   3. reduce: the split partials, and the tiles' bias partials, are summed
//      in a fixed order into dW and db, accumulating over the chunks.
// Workspace (from the wrapper): in bf16 at a chunk of 262,144 points the
// G buffer is 1.33 GB and F's scratch stash 1.28 GB.
//
// Kernel H is F (the remat route) whose tile input is the pre-embedded rows
// (rounded to T, as _fwd_body rounds x) and whose dgrad sweep goes on to
// the input cotangent, as _bwd_core with want_dx (:229-289):
//   dx[:, 63:90] = round(g_dpre) @ Wdir[W:]^T          (rgb mode; else 0)
//   dx[:, :63]   = round(g_pre_4) @ W_4[:63]^T + round(g_pre_0) @ W_0^T
// each product f32, the two xyz terms added in that order (JAX adds the
// skip term to a zero and then layer 0's term, which gives the same bits).
// The three extra products, 2 x (63 x 256) + 27 x 128 = 35,712
// multiply-adds a point, run through the same product loop on transposed
// operands padded to 64 columns (DXC below), and each thread stores its own
// points' dx columns straight to device memory; layer 0 adds to the skip
// term that the same thread stored.  Bound: operations, 2 x (3 x 593,408 +
// 35,712) FLOP a point.
#include "fused_mlp_common.cuh"

#include <algorithm>

namespace {

using namespace nerf;

// G buffer: one row of GC elements of T per point of the chunk
constexpr int G_FIN = D * W;         // g_fin (256)
constexpr int G_DPRE = G_FIN + W;    // g_dpre (128)
constexpr int G_RGB = G_DPRE + WH;   // g_rgbpre (3)
constexpr int G_SIG = G_RGB + 8;     // g_sigma (1)
constexpr int G_XE = G_SIG + 8;      // x_emb (63)
constexpr int G_DE = G_XE + 64;      // dir_emb (27)
constexpr int GC = G_DE + 32;        // 2544

// Transposed weights (the dgrad operands), in T: for i = 1..7 the h rows of
// W_i, transposed (256 x 256) at (i - 1) * W * W; Wfin^T at WT_FIN; the fin
// rows of Wdir, transposed (128 x 256), at WT_DIR.
constexpr long long WT_FIN = 7LL * W * W, WT_DIR = 8LL * W * W;
constexpr long long N_WT = WT_DIR + 1LL * WH * W;
// Kernel H's dx operands, in T, each padded to DXC output columns (zeros
// past the live ones): the dir rows of Wdir transposed (WH x DXC, 27 live)
// at WX_DIR, the xyz rows of W_4 transposed (W x DXC, 63 live) at WX_SKIP,
// W_0 transposed (W x DXC, 63 live) at WX_0.
constexpr int DXC = 64;
constexpr long long WX_DIR = 0, WX_SKIP = WX_DIR + 1LL * WH * DXC;
constexpr long long WX_0 = WX_SKIP + 1LL * W * DXC;
constexpr long long N_WX = WX_0 + 1LL * W * DXC;

template <typename T>
constexpr size_t bwd_smem_bytes() {
  // the forward's layout, then the cotangent tile (4 rows), g_rgbpre
  // (3 rows, f32) and the bias-partial scratch (8 warps x 256)
  return smem_bytes<T>() + sizeof(float) * (4 * TP + 3 * TP + 8 * W);
}

// The gradient tile's epilogue after a dgrad product with 256 outputs:
//   v = acc (+ round(g_sigma[p]) * wsig[n]);  g_pre = v * (mask > 0)
// with the mask read from the stash column mcol (none when mcol < 0).  The
// rounded g_pre goes to act rows [ROW_H, ROW_H + 256) (the next product's
// operand) and to the G buffer at gcol; the tile's f32 sum of g_pre goes to
// bp (256 values).
template <typename T>
__device__ __forceinline__ void bwd_epilogue(
    const float (&acc)[8][8], const T* st, int sc, int mcol,
    const float* gsig, const T* wsig, T* act, T* gb, int gcol, float* red,
    float* bp, long long n_valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bsum[8];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int n0 = g * 128 + lane * 4;
    float wsn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (wsig != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wsn[j] = to_f(wsig[n0 + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bsum[g * 4 + j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = warp * 8 + i;
      const bool valid = p < n_valid;
      float m[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (mcol >= 0) {
        if (valid) {
          load4(st + 1LL * p * sc + mcol + n0, m);
        } else {
          m[0] = m[1] = m[2] = m[3] = 0.0f;
        }
      }
      const float gs =
          wsig != nullptr ? to_f(from_f<T>(gsig[p])) : 0.0f;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][g * 4 + j];
        if (wsig != nullptr) x += gs * wsn[j];
        x = (valid && m[j] > 0.0f) ? x : 0.0f;
        bsum[g * 4 + j] += x;
        const T r = from_f<T>(x);
        act[(ROW_H + n0 + j) * TP + p] = r;
        v[j] = to_f(r);
      }
      if (valid) store4(gb + 1LL * p * GC + gcol + n0, v);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    red[warp * W + (k / 4) * 128 + lane * 4 + (k % 4)] = bsum[k];
  __syncthreads();
  if (threadIdx.x < W) {
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += red[w * W + threadIdx.x];
    bp[threadIdx.x] = s;
  }
  __syncthreads();
}

// Kernel H: one dx product's outputs (from dense_acc with DXC columns:
// point 8 warp + i, column CPL lane + j) to dx's columns [col0, col0 +
// n_live) of the tile's points, or with accumulate added to what this
// thread stored there before (the same mapping).  Columns past x_cols (the
// dir columns of 63-column rows) and points past the chunk are not stored.
__device__ __forceinline__ void dx_store(const float (&ax)[8][DXC / 32],
                                         float* dx, long long p0,
                                         long long n_valid, int x_cols,
                                         int col0, int n_live,
                                         bool accumulate) {
  constexpr int CPL = Lanes<DXC>::CPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = warp * 8 + i;
    if (p >= n_valid) continue;
    float* row = dx + (p0 + p) * x_cols + col0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane * CPL + j;
      if (c < n_live && col0 + c < x_cols)
        row[c] = accumulate ? row[c] + ax[i][j] : ax[i][j];
    }
  }
}

// Pass 1: the gradient sweep of one 64-point tile of the chunk
// [p_begin, p_end).  stash: row 0 is point p_begin (E: kernel D's stash;
// F: the scratch that this kernel fills first).  gbuf: row 0 is point
// p_begin.  bpart: one row of N_BIASES partial sums per tile.  Kernel H
// (IO_EMBEDDED): x_cols, the dx operands wx and dx (P, x_cols) f32, whose
// columns it does not store stay as the caller zeroed them.
template <typename T, bool SIGMA_ONLY, bool REMAT, int IN>
__global__ void __launch_bounds__(THREADS, 2)
fused_nerf_dgrad_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const T* __restrict__ wts,
                        const float* __restrict__ bias,
                        const T* __restrict__ wt, long long P,
                        long long p_begin, long long p_end, T* stash,
                        T* gbuf, float* __restrict__ bpart, int x_cols,
                        const T* __restrict__ wx, float* dx) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  constexpr bool DX = IN == IO_EMBEDDED;  // kernel H: dx too
  T* act = reinterpret_cast<T*>(smem);
  T* ws = act + ROWS * TP;
  float* gout = reinterpret_cast<float*>(smem + smem_bytes<T>());
  float* grgb = gout + 4 * TP;  // g_rgbpre, f32
  float* red = grgb + 3 * TP;
  const int tid = threadIdx.x;
  const long long lp0 = 1LL * blockIdx.x * TP;  // first point in the chunk
  const long long p0 = p_begin + lp0;
  const long long n_valid = p_end - p0;
  T* st = stash + lp0 * SC;  // the tile's stash rows
  T* gb = gbuf + lp0 * GC;
  float* bp = bpart + 1LL * blockIdx.x * N_BIASES;

  if (REMAT) {
    // the stash rows are written and read back by this CTA only; the
    // barrier at the end of forward_tile orders them
    forward_tile<Ref, T, SIGMA_ONLY, true, IN>(x, nullptr, wts, bias, P, p0,
                                               smem, st, x_cols);
  } else {
    tile_input<Ref, T, IN>(x, x_cols, P, p0, act, ws, !SIGMA_ONLY);
  }
  // the cotangent's first 4 channels (rgb, sigma; sigma-only: sigma)
  if (IN != IO_CHANNEL) {  // (P, 8) rows: one 16-byte load per point
    for (int p = tid; p < TP; p += THREADS) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < n_valid)
        v = *reinterpret_cast<const float4*>(g + (p0 + p) * IO);
      gout[p] = v.x; gout[TP + p] = v.y;
      gout[2 * TP + p] = v.z; gout[3 * TP + p] = v.w;
    }
  } else {
    for (int i = tid; i < 4 * TP; i += THREADS) {
      const int r = i / TP, p = i - r * TP;
      gout[i] = p < n_valid ? g[r * P + p0 + p] : 0.0f;
    }
  }
  __syncthreads();
  // embeddings to the G buffer (wgrad of layer 0, the skip layer, dir head)
  for (int i = tid; i < TP * 64; i += THREADS) {
    const int p = i / 64, c = i - p * 64;
    if (p < n_valid && c < CX) gb[1LL * p * GC + G_XE + c] = act[c * TP + p];
  }
  if (!SIGMA_ONLY) {
    for (int i = tid; i < TP * 32; i += THREADS) {
      const int p = i / 32, c = i - p * 32;
      if (p < n_valid && c < CD)
        gb[1LL * p * GC + G_DE + c] = act[(ROW_DIR + c) * TP + p];
    }
  }
  // g_sigma: its bias partial and its G column
  const float* gsig = gout + (SIGMA_ONLY ? 0 : 3) * TP;
  if (tid == 0) {
    float s = 0.0f;
    for (int p = 0; p < TP; ++p) s += gsig[p];
    bp[BOFF_SIG] = s;
  }
  for (int p = tid; p < TP; p += THREADS)
    if (p < n_valid) gb[1LL * p * GC + G_SIG] = from_f<T>(gsig[p]);
  __syncthreads();  // act's embedding rows may now be overwritten

  float acc[8][8];
  if (SIGMA_ONLY) {
    for (int i = tid; i < N_BIASES - BOFF_FIN; i += THREADS)
      bp[BOFF_FIN + i] = 0.0f;  // no heads past sigma
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  } else {
    // stage d into act rows [ROW_H, ROW_H + WH)
    for (int i = tid; i < TP * WH; i += THREADS) {
      const int p = i / WH, k = i - p * WH;
      act[(ROW_H + k) * TP + p] =
          p < n_valid ? st[1LL * p * SC + S_D + k] : from_f<T>(0.0f);
    }
    __syncthreads();
    if (tid < 3 * TP) {  // rgb recompute, one thread per (channel, point)
      const int c = tid / TP, p = tid - c * TP;
      float v = 0.0f;
      for (int k = 0; k < WH; ++k)
        v = fmaf(to_f(act[(ROW_H + k) * TP + p]),
                 to_f(wts[OFF_RGB + 3 * k + c]), v);
      v += bias[BOFF_RGB + c];
      const float rgb = 1.0f / (1.0f + expf(-v));
      grgb[c * TP + p] = p < n_valid ? gout[c * TP + p] * rgb * (1.0f - rgb)
                                     : 0.0f;
    }
    __syncthreads();
    if (tid < 3) {
      float s = 0.0f;
      for (int p = 0; p < TP; ++p) s += grgb[tid * TP + p];
      bp[BOFF_RGB + tid] = s;
    }
    for (int i = tid; i < TP * 3; i += THREADS) {
      const int p = i / 3, c = i - p * 3;
      if (p < n_valid) gb[1LL * p * GC + G_RGB + c] = from_f<T>(grgb[c * TP + p]);
    }
    if (tid < WH) {  // g_d = round(g_rgbpre) @ Wrgb^T; g_dpre = g_d * (d > 0)
      const int k = tid;
      float wr[3];
      for (int c = 0; c < 3; ++c) wr[c] = to_f(wts[OFF_RGB + 3 * k + c]);
      float s = 0.0f;
      for (int p = 0; p < TP; ++p) {
        float gd = 0.0f;
        for (int c = 0; c < 3; ++c)
          gd = fmaf(to_f(from_f<T>(grgb[c * TP + p])), wr[c], gd);
        const float d = to_f(act[(ROW_H + k) * TP + p]);
        const float gdp = (p < n_valid && d > 0.0f) ? gd : 0.0f;
        s += gdp;
        const T r = from_f<T>(gdp);
        act[(ROW_H + k) * TP + p] = r;
        if (p < n_valid) gb[1LL * p * GC + G_DPRE + k] = r;
      }
      bp[BOFF_DIR + k] = s;
    }
    if constexpr (DX) {  // dx's dir columns = round(g_dpre) @ Wdir[W:]^T
      float ax[8][DXC / 32];
      dense_acc<Ref, T, DXC>(wx + WX_DIR, WH, act, ROW_H, ws, ax);
      dx_store(ax, dx, p0, n_valid, x_cols, CX, CD, false);
    }
    // g_fin = round(g_dpre) @ Wdir[:W]^T (no activation on fin)
    dense_acc<Ref, T, W>(wt + WT_DIR, WH, act, ROW_H, ws, acc);
    bwd_epilogue<T>(acc, st, SC, -1, nullptr, nullptr, act, gb, G_FIN, red,
                    bp + BOFF_FIN, n_valid);
    // g_h8 = round(g_fin) @ Wfin^T, plus the sigma term below
    dense_acc<Ref, T, W>(wt + WT_FIN, W, act, ROW_H, ws, acc);
  }
  // g_pre of layer 7 = (acc + round(g_sigma) * Wsig) * (h8 > 0)
  bwd_epilogue<T>(acc, st, SC, (D - 1) * W, gsig, wts + OFF_SIG, act, gb,
                  (D - 1) * W, red, bp + (D - 1) * W, n_valid);
  for (int i = D - 1; i >= 1; --i) {
    if constexpr (DX) {
      if (i == SKIP) {  // dx's xyz columns, the skip term
        float ax[8][DXC / 32];
        dense_acc<Ref, T, DXC>(wx + WX_SKIP, W, act, ROW_H, ws, ax);
        dx_store(ax, dx, p0, n_valid, x_cols, 0, CX, false);
      }
    }
    // g_h = round(g_pre_i) @ W_i[h rows]^T; g_pre_{i-1} = g_h * (h_i > 0)
    dense_acc<Ref, T, W>(wt + 1LL * (i - 1) * W * W, W, act, ROW_H, ws, acc);
    bwd_epilogue<T>(acc, st, SC, (i - 1) * W, nullptr, nullptr, act, gb,
                    (i - 1) * W, red, bp + (i - 1) * W, n_valid);
  }
  if constexpr (DX) {  // + layer 0's term, round(g_pre_0) @ W_0^T
    float ax[8][DXC / 32];
    dense_acc<Ref, T, DXC>(wx + WX_0, W, act, ROW_H, ws, ax);
    dx_store(ax, dx, p0, n_valid, x_cols, 0, CX, true);
  }
}

// Pass 2: dW[k][n] over a point range, for one 64 x 64 tile of one product
// a_in^T @ g_pre.  a_in is read from the stash (ld SC) or the G buffer.
struct WJob {
  int a_in_g, a_col, K, g_col, N, tiles_n, tile0;
  long long out;  // offset of row 0 of this product in the packed weights
};
struct WJobs {
  WJob job[16];  // 14 products in rgb mode, 10 sigma-only
  int n, tiles;
};

constexpr int WK = 64, WN = 64, WP = 32;  // output tile; points per stage

template <typename T, int SC>
__global__ void __launch_bounds__(256)
fused_nerf_wgrad_kernel(const T* __restrict__ stash,
                        const T* __restrict__ gbuf, long long n_points,
                        WJobs jobs, float* __restrict__ part) {
  __shared__ __align__(16) float As[WP][WK];
  __shared__ __align__(16) float Gs[WP][WN];
  const int tid = threadIdx.x;
  int j = 0;
  while (j + 1 < jobs.n && jobs.job[j + 1].tile0 <= static_cast<int>(blockIdx.x)) ++j;
  const WJob jb = jobs.job[j];
  const int local = blockIdx.x - jb.tile0;
  const int k0 = (local / jb.tiles_n) * WK, n0 = (local % jb.tiles_n) * WN;
  const long long per =
      ((n_points + gridDim.y - 1) / gridDim.y + WP - 1) / WP * WP;
  const long long pb = blockIdx.y * per;
  const long long pe = min(n_points, pb + per);
  const T* A = (jb.a_in_g ? gbuf : stash) + jb.a_col;
  const long long lda = jb.a_in_g ? GC : SC;
  const T* G = gbuf + jb.g_col;
  const int tk = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (long long q0 = pb; q0 < pe; q0 += WP) {
    for (int e = tid; e < WP * WK; e += 256) {
      const int pp = e / WK, c = e - pp * WK;
      const long long p = q0 + pp;
      const bool live = p < pe;
      As[pp][c] = (live && k0 + c < jb.K) ? to_f(A[p * lda + k0 + c]) : 0.0f;
      Gs[pp][c] = (live && n0 + c < jb.N) ? to_f(G[p * GC + n0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < WP; ++pp) {
      const float4 a = *reinterpret_cast<const float4*>(&As[pp][tk * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Gs[pp][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }
  float* out = part + blockIdx.y * N_WEIGHTS + jb.out;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = k0 + tk * 4 + u;
    if (k >= jb.K) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tn * 4 + v;
      if (n < jb.N) out[1LL * k * jb.N + n] = acc[u][v];
    }
  }
}

// Pass 3: out[g * n + j] = sum of part rows [g * rpg, (g + 1) * rpg), in
// order; with accumulate (one group) out[j] += that sum instead.
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part, int rows, long long n,
                   int rpg, int accumulate, float* __restrict__ out) {
  const long long j = 1LL * blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  const int r0 = blockIdx.y * rpg, r1 = min(rows, r0 + rpg);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += part[1LL * r * n + j];
  if (accumulate)
    out[j] += s;
  else
    out[blockIdx.y * n + j] = s;
}

WJobs make_jobs(bool sigma_only) {
  WJobs js{};
  auto add = [&js](int a_in_g, int a_col, int K, int g_col, int N,
                   long long out) {
    WJob& jb = js.job[js.n++];
    jb.a_in_g = a_in_g; jb.a_col = a_col; jb.K = K;
    jb.g_col = g_col; jb.N = N; jb.out = out;
    jb.tiles_n = (N + WN - 1) / WN;
    jb.tile0 = js.tiles;
    js.tiles += (K + WK - 1) / WK * jb.tiles_n;
  };
  add(1, G_XE, CX, 0, W, layer_off(0));
  for (int i = 1; i < D; ++i) {
    if (i == SKIP) {
      add(1, G_XE, CX, i * W, W, layer_off(i));  // rows of x_emb
      add(0, (i - 1) * W, W, i * W, W, layer_off(i) + 1LL * CX * W);
    } else {
      add(0, (i - 1) * W, W, i * W, W, layer_off(i));
    }
  }
  add(0, (D - 1) * W, W, G_SIG, 1, OFF_SIG);
  if (!sigma_only) {
    add(0, (D - 1) * W, W, G_FIN, W, OFF_FIN);
    add(0, S_FIN, W, G_DPRE, WH, OFF_DIR);  // rows of fin
    add(1, G_DE, CD, G_DPRE, WH, OFF_DIR + 1LL * W * WH);  // rows of dir_emb
    add(0, S_D, WH, G_RGB, 3, OFF_RGB);
  }
  return js;
}

constexpr int BIAS_RPG = 64;  // tiles per group in the bias reduction

int reduce(const float* part, int rows, long long n, float* tmp, float* out,
           cudaStream_t s) {
  const unsigned bx = static_cast<unsigned>((n + 255) / 256);
  if (tmp == nullptr) {
    reduce_rows_kernel<<<dim3(bx, 1), 256, 0, s>>>(part, rows, n, rows, 1,
                                                   out);
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = (rows + BIAS_RPG - 1) / BIAS_RPG;
  reduce_rows_kernel<<<dim3(bx, groups), 256, 0, s>>>(part, rows, n, BIAS_RPG,
                                                      0, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows_kernel<<<dim3(bx, 1), 256, 0, s>>>(tmp, groups, n, groups, 1,
                                                 out);
  return static_cast<int>(cudaGetLastError());
}

// Operands of one backward call (see nerf_fused_bwd).
struct BwdArgs {
  const void *x, *g, *w, *b, *wt;
  long long P;
  void *stash, *gbuf, *wpart, *bpart, *btmp, *dw, *db;
  long long chunk;
  int split, x_cols;
  const void* wx;
  void* dx;
};

template <typename T, bool SIGMA_ONLY, bool REMAT, int IN>
int run(const BwdArgs& a, cudaStream_t s) {
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long P = a.P, chunk = a.chunk;
  auto dgrad = fused_nerf_dgrad_kernel<T, SIGMA_ONLY, REMAT, IN>;
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      dgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const WJobs jobs = make_jobs(SIGMA_ONLY);
  for (long long p_begin = 0; p_begin < P; p_begin += chunk) {
    const long long p_end = std::min(P, p_begin + chunk);
    const long long n = p_end - p_begin;
    const int tiles = static_cast<int>((n + TP - 1) / TP);
    // E reads kernel D's stash at the chunk's rows; F fills its scratch
    T* st = static_cast<T*>(a.stash) + (REMAT ? 0 : p_begin * SC);
    dgrad<<<tiles, THREADS, smem, s>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.g),
        static_cast<const T*>(a.w), static_cast<const float*>(a.b),
        static_cast<const T*>(a.wt), P, p_begin, p_end, st,
        static_cast<T*>(a.gbuf), static_cast<float*>(a.bpart), a.x_cols,
        static_cast<const T*>(a.wx), static_cast<float*>(a.dx));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fused_nerf_wgrad_kernel<T, SC>
        <<<dim3(jobs.tiles, a.split), 256, 0, s>>>(
            st, static_cast<const T*>(a.gbuf), n, jobs,
            static_cast<float*>(a.wpart));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    int e = reduce(static_cast<const float*>(a.wpart), a.split, N_WEIGHTS,
                   nullptr, static_cast<float*>(a.dw), s);
    if (e != 0) return e;
    e = reduce(static_cast<const float*>(a.bpart), tiles, N_BIASES,
               static_cast<float*>(a.btmp), static_cast<float*>(a.db), s);
    if (e != 0) return e;
  }
  return 0;
}

template <typename T, int IN>
int run_t(int sigma_only, int remat, const BwdArgs& a, cudaStream_t s) {
  if (sigma_only)
    return remat ? run<T, true, true, IN>(a, s) : run<T, true, false, IN>(a, s);
  return remat ? run<T, false, true, IN>(a, s) : run<T, false, false, IN>(a, s);
}

template <typename T>
int run_io(int io, int sigma_only, int remat, const BwdArgs& a,
           cudaStream_t s) {
  switch (io) {
    case IO_CHANNEL:
      return run_t<T, IO_CHANNEL>(sigma_only, remat, a, s);
    case IO_ROW:
      return run_t<T, IO_ROW>(sigma_only, remat, a, s);
    case IO_EMBEDDED:  // kernel H: the remat route only, as in JAX
      if (!remat) break;
      return sigma_only ? run<T, true, true, IO_EMBEDDED>(a, s)
                        : run<T, false, true, IO_EMBEDDED>(a, s);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

long long nerf_bwd_weight_count() { return N_WEIGHTS; }
long long nerf_bwd_bias_count() { return N_BIASES; }
long long nerf_bwd_transposed_count() { return N_WT; }
long long nerf_bwd_dx_transposed_count() { return N_WX; }
int nerf_bwd_g_cols() { return GC; }
int nerf_bwd_points_per_cta() { return TP; }
int nerf_bwd_bias_rows_per_group() { return BIAS_RPG; }

// Kernels E (remat = 0; stash: kernel D's (P, SC) stash) and F (remat = 1;
// stash: a (chunk, SC) scratch) with io = 0 (x, g (8, P)); with io = 1, E'
// and F' (x and g (P, 8), 16-byte aligned); with io = 2 and remat = 1,
// kernel H (x (P, x_cols) pre-embedded, x_cols 63 or 90; g (P, 8), 16-byte
// aligned; wx (N_WX) in T; dx (P, x_cols) f32, zeroed).  w (N_WEIGHTS) and
// wt (N_WT) in T (bf16 = 1) or f32; b (N_BIASES) f32.  Workspace: gbuf
// (chunk, GC) T, wpart (split, N_WEIGHTS) f32, bpart (ceil(chunk / TP),
// N_BIASES) f32, btmp (ceil(ceil(chunk / TP) / BIAS_RPG), N_BIASES) f32.
// dw (N_WEIGHTS) and db (N_BIASES) f32 are accumulated into: zero them, and
// wpart too (sigma-only runs write no partials for the heads past sigma).
int nerf_fused_bwd(const void* x, const void* g, const void* w,
                   const void* b, const void* wt, long long P, int sigma_only,
                   int bf16, int remat, int io, void* stash, void* gbuf,
                   void* wpart, void* bpart, void* btmp, void* dw, void* db,
                   long long chunk, int split, int x_cols, const void* wx,
                   void* dx, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{x, g, w, b, wt, P, stash, gbuf, wpart, bpart, btmp,
                  dw, db, chunk, split, x_cols, wx, dx};
  if (bf16) return run_io<__nv_bfloat16>(io, sigma_only, remat, a, s);
  return run_io<float>(io, sigma_only, remat, a, s);
}

}  // extern "C"
