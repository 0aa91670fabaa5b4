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
// rows, as on the TPU.  round() is the weight type T (f32, bf16 or fp16),
// to nearest even from the f32 value as astype rounds: in fp16 a small
// cotangent keeps its subnormal (steps of 2^-24) or becomes 0 below 2^-25,
// and the product then takes that value, as _bwd_core's g.astype(cdt) does
// on the CPU (JAX flushes no fp16 subnormal there; the tests read it so).
// Weight grads are summed and returned in f32 in every type.  The ReLU
// masks follow JAX's two routes: E reads them from D's rounded stash, F (and
// H) from the f32 recompute, so in fp16 a positive activation that rounds
// to 0 masks its g in E and passes it in F; F's fp16 scratch stash keeps
// that sign as -0 (round_act, act_positive in fused_mlp_common.cuh).
//
// Bound on the H100: operations.  E: 4 x 593,408 FLOP per rgb point (dgrad
// and wgrad) against a 4,864-byte stash read in bf16 (2.4 us per 1,000
// points at the tensor rate against 1.5 us of bytes); F: 6 x 593,408 FLOP
// (the forward again) and no stash.
// Design.  On the TPU the grid runs in order and the f32 weight grads stay
// resident across it; on Hopper the blocks run in parallel, so the
// weight-grad sum over points is a second pass, deterministic and without
// atomics.  Points go in chunks of `chunk`:
//   1. dgrad kernel, one CTA of 256 threads per 64-point tile (F first runs
//      the forward tile of kernel C/D, the same code and so the same bits,
//      into a chunk-sized scratch stash).
//      Each layer's gradient tile stays in shared memory.  Each layer's
//      rounded g_pre, and the embeddings, go to a (chunk, GC) buffer in T;
//      the f32 bias partials of each tile go to their own row.
//   2. wgrad kernel: every dW tile of every layer, split over `split` point
//      ranges, each CTA summing its range in f32 over 32-point slabs of
//      a_in and g_pre.
//   3. reduce: the split partials, and the tiles' bias partials, are summed
//      in a fixed order into dW and db, accumulating over the chunks.
// In bf16 and fp16 the products of passes 1 and 2 run on the tensor cores
// (mma.sync m16n8k16, 16-bit operands, f32 sums; see mma.cuh), the same
// code for both types:
//   - the sweep's g tile is feature-major with rows padded to TPG points
//     (ldmatrix.trans gives the A fragments without bank conflicts), laid
//     over the forward's activation rows once the embeddings are in the G
//     buffer; the B operand of g_pre @ W^T is W's own row-major layout, so
//     the sweep streams the forward's packed weights in 32-column stages
//     through a two-stage cp.async ring (over the forward's own ring).
//     Warp (wm, wn) of the 2 x 4 grid
//     owns 32 points x 64 columns; each 16-term tensor-core sum starts from
//     zero and is added in f32.  The epilogue reads the ReLU mask from the
//     stash in the fragment's column pairs, sums the bias partials with quad
//     shuffles, then the two point halves in order, and recomputes in the
//     plain version's order each output that lies near a rounding tie
//     (see TIE_MARGIN: without it the rounded g_pre would depart from the
//     plain version's now and then, and each such step grows down the
//     layers);
//   - the wgrad CTA owns a 128 x 128 tile (8 warps as 2 x 4 of 64 x 32),
//     its 32-point slabs staged point-major by cp.async in 16-byte vectors
//     through a four-slab ring and read by ldmatrix.trans for both operands;
//     ragged columns (x_emb's 63, dir_emb's 27, whose pad columns in the G
//     buffer are never written) are zero-filled as they are staged.  The
//     sigma and rgb jobs (1 and 3 columns) run a narrow kernel, a warp a
//     slice of the points.
// In f32 (whose limits TF32 would break) every product runs on the CUDA
// cores, each output one fmaf chain in the plain version's order, so the
// f32 grads keep their bits whatever the tiling (chip_smoke.py pins them by
// digest): the sweep runs the forward tile's dense_acc (a cp.async ring of
// weight stages, rows padded to LDA_F32) against the transposed weights
// (wt), its bias partials' scratch over the idle ring, so that two CTAs fit
// an SM; the wgrad 128 x 128 tiles with 8 x 8 outputs a thread, its 32-point
// slabs staged by cp.async in 16-byte vectors through a three-slab ring
// (zero-filled past the live columns and points).  The wrapper builds the
// wgrad job table and marks each job's route.
// Workspace (from the wrapper): in a 16-bit type at a chunk of 262,144
// points the G buffer is 1.33 GB and F's scratch stash 1.28 GB.
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
#include "mma.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using namespace nerf;

// G buffer: one row of GC elements of T per point of the chunk; layer i's
// g_pre at column i * W (i < D)
constexpr int G_FIN = D * W;         // g_fin (256)
constexpr int G_DPRE = G_FIN + W;    // g_dpre (128)
constexpr int G_RGB = G_DPRE + WH;   // g_rgbpre (3)
constexpr int G_SIG = G_RGB + 8;     // g_sigma (1)
constexpr int G_XE = G_SIG + 8;      // x_emb (63)
constexpr int G_DE = G_XE + 64;      // dir_emb (27)
constexpr int GC = G_DE + 32;        // 2544

// Transposed weights (the f32 sweep's dgrad operands): for i = 1..7 the h
// rows of W_i, transposed (256 x 256) at (i - 1) * W * W; Wfin^T at WT_FIN;
// the fin rows of Wdir, transposed (128 x 256), at WT_DIR.  The 16-bit sweep
// reads the packed weights instead.
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

// The 16-bit sweep: the g tile's row pitch (TP points + 8: ldmatrix's eight
// row addresses, 144 bytes apart, fall in distinct banks; the forward's
// activation pitch); the weight stages of its products, DK columns of the
// 256 fan_in rows of W, rows padded to DKP (80 bytes: again distinct
// banks); the ring of DSTAGES stages, DSTAGES - 1 in flight while one is
// consumed, over the forward's weight ring (idle once the forward is done).
constexpr int TPG = Ref::LDA_MMA;
constexpr int DK = 32, DKP = DK + 8, DSTAGES = 2;
constexpr int RING = DSTAGES * W * DKP;
static_assert(W * TPG <= Ref::act_elems<bf16>() &&
                  W * TPG <= Ref::act_elems<f16>(),
              "the g tile fits over the activation rows");
static_assert(RING <= Ref::ws_elems<bf16>() && RING <= Ref::ws_elems<f16>(),
              "the sweep's ring fits over the forward's");

template <typename T>
constexpr size_t bwd_smem_bytes() {
  // the forward's layout, then the cotangent tile (4 rows), g_rgbpre
  // (3 rows, f32) and, in the 16-bit types, the bias-partial scratch (8
  // warps x 256; f32 lays it over the weight ring, idle between products)
  return smem_bytes<T>() +
         sizeof(float) * (4 * TP + 3 * TP + (kTensorCores<T> ? 8 * W : 0));
}
// two CTAs an SM: 228 KB of shared memory, 1 KB of it reserved a CTA
static_assert(2 * (bwd_smem_bytes<bf16>() + 1024) <= 228 * 1024 &&
                  2 * (bwd_smem_bytes<f16>() + 1024) <= 228 * 1024 &&
                  2 * (bwd_smem_bytes<float>() + 1024) <= 228 * 1024,
              "two dgrad CTAs fit an SM");
static_assert(8 * W <= Ref::ws_elems<float>(),
              "the f32 bias partials fit the weight ring");
static_assert(2 * (smem_bytes<float>() + 1024) <= 228 * 1024,
              "two f32 forward CTAs fit an SM");
// The sweep's list of tie marks (mma_epilogue): bf16's FIXW after the bias
// partials in red, fp16's longer FIXW_F16 over the idle dgrad ring
static_assert(2 * FIXW * 8 * sizeof(int) <= 6 * W * sizeof(float),
              "the bf16 marks fit red");
static_assert(2 * FIXW_F16 * 8 * sizeof(int) <= RING * sizeof(f16),
              "the fp16 marks fit the dgrad ring");

// The f32 sweep's epilogue after a dgrad product with 256 outputs:
//   v = acc (+ round(g_sigma[p]) * wsig[n]);  g_pre = v * (mask > 0)
// with the mask read from the stash column mcol (none when mcol < 0).  The
// rounded g_pre goes to act rows [ROW_H, ROW_H + 256) (the next product's
// operand, pitch LDA_F32: each column's 8 points as two 16-byte vectors)
// and to the G buffer at gcol; the tile's f32 sum of g_pre goes to bp (256
// values): each warp's 8 points in order, then the 8 warps' sums in order
// (red, 8 x 256, over the idle weight ring).
template <typename T>
__device__ __forceinline__ void bwd_epilogue(
    float (&acc)[8][8], const T* st, int sc, int mcol, const float* gsig,
    const T* wsig, T* act, T* gb, int gcol, float* red, float* bp,
    long long n_valid) {
  constexpr int LD = Ref::lda<T>();
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
        // the ReLU mask is a select, as XLA compiles JAX's g * (h > 0) and
        // as torch's relu backward: a NaN or Inf g under a zero mask is 0
        x = (valid && m[j] > 0.0f) ? x : 0.0f;
        bsum[g * 4 + j] += x;
        const T r = from_f<T>(x);
        acc[i][g * 4 + j] = r;
        v[j] = to_f(r);
      }
      if (valid) store4(gb + 1LL * p * GC + gcol + n0, v);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* col = act + (ROW_H + n0 + j) * LD + warp * 8;
      *reinterpret_cast<float4*>(col) =
          make_float4(acc[0][g * 4 + j], acc[1][g * 4 + j], acc[2][g * 4 + j],
                      acc[3][g * 4 + j]);
      *reinterpret_cast<float4*>(col + 4) =
          make_float4(acc[4][g * 4 + j], acc[5][g * 4 + j], acc[6][g * 4 + j],
                      acc[7][g * 4 + j]);
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

// One stage of a 16-bit dgrad product's weight stream: columns [k0, k0 +
// DK) of the 256 rows of the (256 x ld) row-major block w, to buf (pitch
// DKP), in 16-byte cp.async vectors; one committed group.
template <typename T>
__device__ __forceinline__ void dgrad_stage(const T* __restrict__ w, int ld,
                                            int k0, T* buf) {
  for (int i = threadIdx.x; i < W * DK / 8; i += THREADS) {
    const int n = i / (DK / 8), c = (i % (DK / 8)) * 8;
    mma::cp_async16(buf + n * DKP + c, w + 1LL * n * ld + k0 + c);
  }
  mma::cp_async_commit();
}

// The 16-bit sweep's product on the tensor cores (bf16 or fp16 operands):
// acc = g[:, :K] @ w[:, :K]^T
// for the tile's TP points, g the g tile (feature-major, element (k, p) at
// k * TPG + p), w the layer's 256 fan_in rows (row-major, ld apart), whose
// first K columns are the layer's outputs: for each output n, its k values
// are contiguous, the .col layout of mma's B operand.  Warp (wm, wn) =
// (warp / 4, warp % 4) owns points [32 wm, 32 wm + 32) and columns [64 wn,
// 64 wn + 64); acc[mi][nt] is the m16n8 tile at point 32 wm + 16 mi,
// column 64 wn + 8 nt.  The stages go through the ring, each a committed
// cp.async group (an empty one past the last stage, so that every thread
// counts its groups alike).  K is a multiple of DK.  Ends with a barrier
// and the ring idle: every read of g is done.
template <typename T>
__device__ __forceinline__ void mma_dgrad(const T* __restrict__ w, int ld,
                                          int K, const T* g, T* ring,
                                          float (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
  const int n_stages = K / DK;
  auto stage = [&](int s) {
    if (s < n_stages)
      dgrad_stage(w, ld, s * DK, ring + (s % DSTAGES) * W * DKP);
    else
      mma::cp_async_commit();
  };
  for (int s = 0; s < DSTAGES - 1; ++s) stage(s);
  for (int s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<DSTAGES - 2>();  // this thread's copies of stage s
    // every thread's copies of stage s have landed (and, at s = 0, the g
    // tile's last writes are visible); every warp is done with stage s - 1,
    // whose slot the next stage fills
    __syncthreads();
    stage(s + DSTAGES - 1);
    const T* wb = ring + (s % DSTAGES) * W * DKP;
#pragma unroll
    for (int ks = 0; ks < DK; ks += 16) {
      const int k = s * DK + ks;
      // A (points x k): lanes 0-7 rows k..k+7 at points +0, 8-15 at +8,
      // 16-31 rows k+8..k+15; .trans turns the k-major rows into the
      // row-major fragment
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma::ldmatrix_x4_trans(
            a[mi], g + (k + (lane & 7) + ((lane >> 4) & 1) * 8) * TPG +
                       wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B (k x n) of two n8 tiles: rows n of the stage, k halves
        uint32_t b[4];
        mma::ldmatrix_x4(b, wb + (wn * 64 + np * 16 + (lane & 7) +
                                  (lane >> 4) * 8) * DKP +
                                ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // each 16-term sum from zero, then added in f32 (round to
          // nearest): the tensor cores' own additions stay short
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
  __syncthreads();  // every warp is done with the ring and with g
}

// Ties: the plain version (and the f32 sweep) sums each dgrad output in
// f32, one fused multiply-add a term in order of k; mma_epilogue repairs
// the outputs near a tie of the type with the shared scheme (TIE_ULPS,
// near_tie and near_tie_f16, list_marks and for_marks in
// fused_mlp_common.cuh).

// The 16-bit sweep's epilogue, bwd_epilogue's arithmetic in mma_dgrad's
// fragment mapping: lane t holds points 32 wm + 16 mi + t / 4 (+ 8) and
// columns 64 wn + 8 nt + 2 (t % 4) (+ 1), so the mask is read from the
// stash, and g_pre written to the G buffer, as 4-byte pairs.  Output e =
// 32 mi + 16 h + 2 nt + j of the thread is acc[mi][nt][2 h + j].  Three
// phases around two barriers: (A) g_pre into acc, the bias partial of each
// column (the thread's four points, then the eight lanes of its quad
// position by xor shuffles, lanes 0-3 keeping the sums, each in a fixed
// order), and a bit for each output near a tie, the warp's marks numbered
// by a prefix sum over the lanes; (B) each warp recomputes its marked
// outputs, g (the product's input) still in place, w the product's (256 x
// ld) fan_in rows and K its depth, and the tile's bias partials are summed
// over the two point halves in order; (C) g_pre, rounded, to the g tile and
// the G buffer, then each thread's marked outputs over them from (B).  The
// marks are listed after the bias partials in red (bf16) or over the idle
// ring (fp16, whose list is longer: see FIXW_F16), and then a barrier ends
// the epilogue, as the next product refills the ring at once.
template <typename T>
__device__ __forceinline__ void mma_epilogue(
    float (&acc)[2][8][4], const T* __restrict__ w, int ld, int K,
    const T* st, int sc, int mcol, const float* gsig, const T* wsig, T* g,
    T* gb, int gcol, float* red, float* bp, T* ring, bool keep_sign,
    long long n_valid) {
  constexpr bool F16 = std::is_same<T, f16>::value;
  constexpr int FIX = kFixW<T>;
  using Pair = typename Pair16<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  int* fix_pn = (F16 ? reinterpret_cast<int*>(ring)
                     : reinterpret_cast<int*>(red + 2 * W)) +
                warp * 2 * FIX;
  float* fix_val = reinterpret_cast<float*>(fix_pn + FIX);
  // output e's point and column
  auto point = [&](int e) {
    return wm * 32 + (e >> 5) * 16 + (lane >> 2) + ((e >> 4) & 1) * 8;
  };
  auto column = [&](int e) {
    return wn * 64 + ((e >> 1) & 7) * 8 + (lane & 3) * 2 + (e & 1);
  };
  float bsum[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) bsum[nt][0] = bsum[nt][1] = 0.0f;
  unsigned long long ties[1] = {0};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = point(32 * mi + 16 * h);
      const bool valid = p < n_valid;
      const float gs =
          wsig != nullptr ? to_f(from_f<T>(gsig[p])) : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = column(2 * nt);
        float m[2] = {1.0f, 1.0f};
        if (mcol >= 0) {
          if (valid) {
            load2(st + 1LL * p * sc + mcol + n, m);
          } else {
            m[0] = m[1] = 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = acc[mi][nt][2 * h + j];
          if (wsig != nullptr) v += gs * to_f(wsig[n + j]);
          const float x = (valid && act_positive(m[j], keep_sign)) ? v : 0.0f;
          acc[mi][nt][2 * h + j] = x;
          bsum[nt][j] += x;
          if (near_tie_t<T>(x))
            ties[0] |= 1ull << (32 * mi + 16 * h + 2 * nt + j);
        }
      }
    }
  // the warp's marks: this lane's from slot `first` on, in order of e
  int first;
  const int marks = list_marks<FIX>(
      ties, fix_pn, first, [&](int e) { return (point(e) << 16) | column(e); });
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = bsum[nt][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[wm * W + wn * 64 + nt * 8 + lane * 2 + j] = v;
    }
  __syncthreads();
  for (int e = lane; e < marks; e += 32) {
    const int p = fix_pn[e] >> 16, n = fix_pn[e] & 0xffff;
    const T* wr = w + 1LL * n * ld;
    float s = 0.0f;
    for (int k = 0; k < K; k += 8) {
      float b[8];
      load8(wr + k, b);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        s = fmaf(to_f(g[(k + u) * TPG + p]), b[u], s);
    }
    if (wsig != nullptr) s += to_f(from_f<T>(gsig[p])) * to_f(wsig[n]);
    fix_val[e] = s;
  }
  if (threadIdx.x < W)
    bp[threadIdx.x] = red[threadIdx.x] + red[W + threadIdx.x];
  __syncthreads();  // every recompute has read the product's input
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = point(32 * mi + 16 * h);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = column(2 * nt);
        const Pair r =
            Pair16<T>::make(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        g[n * TPG + p] = r.x;
        g[(n + 1) * TPG + p] = r.y;
        if (p < n_valid)
          *reinterpret_cast<Pair*>(gb + 1LL * p * GC + gcol + n) = r;
      }
    }
  for_marks<FIX>(ties, first, [&](int e, int slot) {
    const int p = point(e), n = column(e);
    const T r = from_f<T>(fix_val[slot]);
    g[n * TPG + p] = r;
    if (p < n_valid) gb[1LL * p * GC + gcol + n] = r;
  });
  if constexpr (F16) __syncthreads();  // the ring's marks are read
}

// One layer of the sweep: the dgrad product g_in = round(g_pre) @ W^T
// over the g tile's first K rows (W's outputs; K = 0: no product, zeros),
// 256 outputs (W's fan_in rows), and its epilogue.  16-bit: on the tensor
// cores, from the packed weights wts at off (rows ld apart); f32: the
// scalar loop, from the transposed weights wt at wt_off.  The overloads
// follow the accumulator's shape.
template <typename X>
struct NoDeduce {  // a parameter that takes the type deduced elsewhere
  using type = X;
};
template <typename T>
__device__ __forceinline__ void sweep_layer(
    float (&acc)[2][8][4], const T* wts, long long off, int ld, const T*,
    long long, int K, T* act, T*, T* ring, const T* st, int sc, int mcol,
    const float* gsig, typename NoDeduce<const T*>::type wsig, T* gb,
    int gcol, float* red, float* bp, bool keep_sign, long long n_valid) {
  if (K > 0) {
    mma_dgrad(wts + off, ld, K, act, ring, acc);
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
  }
  mma_epilogue(acc, wts + off, ld, K, st, sc, mcol, gsig, wsig, act, gb, gcol,
               red, bp, ring, keep_sign, n_valid);
}
__device__ __forceinline__ void sweep_layer(
    float (&acc)[8][8], const float*, long long, int, const float* wt,
    long long wt_off, int K, float* act, float* ws, float*, const float* st,
    int sc, int mcol, const float* gsig, const float* wsig, float* gb,
    int gcol, float* red, float* bp, bool, long long n_valid) {
  if (K > 0) {
    dense_acc<Ref, float, W>(wt + wt_off, K, act, ROW_H, ws, acc);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  bwd_epilogue<float>(acc, st, sc, mcol, gsig, wsig, act, gb, gcol, red, bp,
                      n_valid);
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
// p_begin.  bpart: one row of N_BIASES partial sums per tile.  wt: the
// transposed weights (f32 only).  Kernel H (IO_EMBEDDED): x_cols, the dx
// operands wx and dx (P, x_cols) f32, whose columns it does not store stay
// as the caller zeroed them.
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
  constexpr bool TC = kTensorCores<T>;
  // the remat route's masks keep the sign of an activation that rounds to
  // 0 (round_act): in fp16 only, where a positive activation below 2^-25
  // does; bf16 keeps f32's range, so its kernels keep the plain code
  constexpr bool KEEP_SIGN = REMAT && std::is_same<T, f16>::value;
  constexpr int LDA = Ref::lda<T>();  // the forward's activation pitch
  T* act = reinterpret_cast<T*>(smem);
  T* ws = act + Ref::act_elems<T>();
  float* gout = reinterpret_cast<float*>(smem + smem_bytes<T>());
  float* grgb = gout + 4 * TP;  // g_rgbpre, f32
  // the bias partials' scratch: after the cotangent rows (16-bit), over the
  // weight ring (f32, whose sweep epilogue runs between two products)
  float* red = TC ? grgb + 3 * TP : reinterpret_cast<float*>(ws);
  T* ring = TC ? ws : nullptr;
  // the gradient rows of the sweep, element (k, p) at gt[k * LDG + p]: in
  // 16-bit types the padded g tile over the activation rows, in f32 act's h
  // rows (the forward's pitch)
  T* gt = TC ? act : act + ROW_H * LDA;
  constexpr int LDG = TC ? TPG : LDA;
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
    forward_tile<Ref, T, SIGMA_ONLY, true, IN, KEEP_SIGN>(x, nullptr, wts, bias,
                                                          P, p0, smem, st,
                                                          x_cols);
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
    if (p < n_valid && c < CX) gb[1LL * p * GC + G_XE + c] = act[c * LDA + p];
  }
  if (!SIGMA_ONLY) {
    for (int i = tid; i < TP * 32; i += THREADS) {
      const int p = i / 32, c = i - p * 32;
      if (p < n_valid && c < CD)
        gb[1LL * p * GC + G_DE + c] = act[(ROW_DIR + c) * LDA + p];
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
  __syncthreads();  // the activation rows may now be overwritten

  std::conditional_t<TC, float[2][8][4], float[8][8]> acc;
  if (SIGMA_ONLY) {
    for (int i = tid; i < N_BIASES - BOFF_FIN; i += THREADS)
      bp[BOFF_FIN + i] = 0.0f;  // no heads past sigma
  } else {
    // stage d into the gradient rows [0, WH)
    for (int i = tid; i < TP * WH; i += THREADS) {
      const int p = i / WH, k = i - p * WH;
      gt[k * LDG + p] =
          p < n_valid ? st[1LL * p * SC + S_D + k] : from_f<T>(0.0f);
    }
    __syncthreads();
    if (tid < 3 * TP) {  // rgb recompute, one thread per (channel, point)
      const int c = tid / TP, p = tid - c * TP;
      float v = 0.0f;
      for (int k = 0; k < WH; ++k)
        v = fmaf(to_f(gt[k * LDG + p]), to_f(wts[OFF_RGB + 3 * k + c]), v);
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
        const float d = to_f(gt[k * LDG + p]);
        const float gdp =
            (p < n_valid && act_positive(d, KEEP_SIGN)) ? gd : 0.0f;
        s += gdp;
        const T r = from_f<T>(gdp);
        gt[k * LDG + p] = r;
        if (p < n_valid) gb[1LL * p * GC + G_DPRE + k] = r;
      }
      bp[BOFF_DIR + k] = s;
    }
    if constexpr (DX) {  // dx's dir columns = round(g_dpre) @ Wdir[W:]^T
      float ax[8][DXC / 32];
      dense_acc<Ref, T, DXC, LDG>(wx + WX_DIR, WH, gt, 0, ws, ax);
      dx_store(ax, dx, p0, n_valid, x_cols, CX, CD, false);
    }
    // g_fin = round(g_dpre) @ Wdir[:W]^T (no activation on fin)
    sweep_layer(acc, wts, OFF_DIR, WH, wt, WT_DIR, WH, act, ws, ring, st, SC,
                -1, nullptr, nullptr, gb, G_FIN, red, bp + BOFF_FIN, KEEP_SIGN,
                n_valid);
  }
  // g_pre of layer 7 = (round(g_fin) @ Wfin^T + round(g_sigma) * Wsig) *
  // (h8 > 0); sigma-only: the sigma term alone
  sweep_layer(acc, wts, OFF_FIN, W, wt, WT_FIN, SIGMA_ONLY ? 0 : W, act, ws,
              ring, st, SC, (D - 1) * W, gsig, wts + OFF_SIG, gb, (D - 1) * W,
              red, bp + (D - 1) * W, KEEP_SIGN, n_valid);
  for (int i = D - 1; i >= 1; --i) {
    if constexpr (DX) {
      if (i == SKIP) {  // dx's xyz columns, the skip term
        float ax[8][DXC / 32];
        dense_acc<Ref, T, DXC, LDG>(wx + WX_SKIP, W, gt, 0, ws, ax);
        dx_store(ax, dx, p0, n_valid, x_cols, 0, CX, false);
      }
    }
    // g_h = round(g_pre_i) @ W_i[h rows]^T; g_pre_{i-1} = g_h * (h_i > 0)
    sweep_layer(acc, wts, layer_off(i) + (i == SKIP ? 1LL * CX * W : 0), W,
                wt, 1LL * (i - 1) * W * W, W, act, ws, ring, st, SC,
                (i - 1) * W, nullptr, nullptr, gb, (i - 1) * W, red,
                bp + (i - 1) * W, KEEP_SIGN, n_valid);
  }
  if constexpr (DX) {  // + layer 0's term, round(g_pre_0) @ W_0^T
    float ax[8][DXC / 32];
    dense_acc<Ref, T, DXC, LDG>(wx + WX_0, W, gt, 0, ws, ax);
    dx_store(ax, dx, p0, n_valid, x_cols, 0, CX, true);
  }
}

// Pass 2: dW[k][n] over a point range, for one output tile of one product
// a_in^T @ g_pre.  a_in is read from the stash (ld SC) or the G buffer.
struct WJob {
  int a_in_g, a_col, K, g_col, N, tiles_n, tile0;
  long long out;  // offset of row 0 of this product in the packed weights
};
struct WJobs {
  WJob job[16];  // 14 products in rgb mode, 10 sigma-only
  int n, tiles;
};

// the job of CTA column blockIdx.x, and its tile's first k and n
__device__ __forceinline__ WJob find_job(const WJobs& jobs, int tk, int tn,
                                         int& k0, int& n0) {
  int j = 0;
  while (j + 1 < jobs.n &&
         jobs.job[j + 1].tile0 <= static_cast<int>(blockIdx.x))
    ++j;
  const WJob jb = jobs.job[j];
  const int local = blockIdx.x - jb.tile0;
  k0 = (local / jb.tiles_n) * tk;
  n0 = (local % jb.tiles_n) * tn;
  return jb;
}

// The f32 wgrad: a WK x WN output tile a CTA, 8 x 8 outputs a thread (rows
// 4 tk + u and 64 + 4 tk + u, columns 4 tn + v and 64 + 4 tn + v of the
// tile, tk = thread / 16, tn = thread % 16: two 16-byte vectors of a_in and
// two of g_pre a point, the lanes of a quarter-warp on consecutive
// vectors).  The point range goes in slabs of WP points, a_in's and g_pre's
// tile columns staged point-major by cp.async in 16-byte vectors through a
// ring of WSTAGES_F32 slabs, WSTAGES_F32 - 1 in flight while one is
// consumed: thread t copies the vectors at column 4 (t % 32) of points t /
// 32 + 8 r (r < 4) of both.  A vector not wholly live (a point past the
// range, or columns past K or N, which may never have been written) reads
// only its live elements and is zero-filled: every output sums its range's
// points in order, one fmaf a point, the range's last slab padded with zero
// terms.
constexpr int WK = 128, WN = 128, WP = 32, WSTAGES_F32 = 3;
constexpr size_t WGRAD_F32_SMEM = sizeof(float) * WSTAGES_F32 * WP * (WK + WN);
static_assert(2 * (WGRAD_F32_SMEM + 1024) <= 228 * 1024,
              "two f32 wgrad CTAs fit an SM");
static_assert(WK == WN && WP * WK / 4 % 256 == 0,
              "a thread copies whole columns of vectors of both operands");

template <int SC>
__global__ void __launch_bounds__(256, 2)
fused_nerf_wgrad_kernel(const float* __restrict__ stash,
                        const float* __restrict__ gbuf, long long n_points,
                        WJobs jobs, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  // slab b: As[b] (a_in) and Gs[b] (g_pre), WP rows of WK and WN
  auto As = reinterpret_cast<float(*)[WP][WK]>(smem);
  auto Gs = reinterpret_cast<float(*)[WP][WN]>(As + WSTAGES_F32);
  const int tid = threadIdx.x;
  int k0, n0;
  const WJob jb = find_job(jobs, WK, WN, k0, n0);
  const long long per =
      ((n_points + gridDim.y - 1) / gridDim.y + WP - 1) / WP * WP;
  const long long pb = blockIdx.y * per;
  const long long pe = min(n_points, pb + per);
  const float* A = (jb.a_in_g ? gbuf : stash) + jb.a_col + k0;
  const long long lda = jb.a_in_g ? GC : SC;
  const float* G = gbuf + jb.g_col + n0;
  const int live_k = jb.K - k0, live_n = jb.N - n0;  // columns in the tile
  const int n_slabs = pe > pb ? static_cast<int>((pe - pb + WP - 1) / WP) : 0;

  // this thread's column of vectors, and its live elements in either
  // operand; a dead vector reads nothing (its address is any valid one)
  const int c = (tid % (WK / 4)) * 4, pp0 = tid / (WK / 4);
  const int live_a = max(0, min(4, live_k - c));
  const int live_g = max(0, min(4, live_n - c));
  auto stage = [&](int s) {
    if (s < n_slabs) {
      const long long q0 = pb + 1LL * s * WP;
      const int b = s % WSTAGES_F32;
#pragma unroll
      for (int r = 0; r < WP * WK / 4 / 256; ++r) {
        const int pp = pp0 + r * (256 / (WK / 4));
        const long long p = q0 + pp;
        const int na = p < pe ? live_a : 0, ng = p < pe ? live_g : 0;
        mma::cp_async16_zfill(&As[b][pp][c], na ? A + p * lda + c : G,
                              static_cast<int>(sizeof(float)) * na);
        mma::cp_async16_zfill(&Gs[b][pp][c], ng ? G + p * GC + c : G,
                              static_cast<int>(sizeof(float)) * ng);
      }
    }
    mma::cp_async_commit();
  };

  const int tk = tid / 16, tn = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  for (int s = 0; s < WSTAGES_F32 - 1; ++s) stage(s);
  for (int s = 0; s < n_slabs; ++s) {
    mma::cp_async_wait<WSTAGES_F32 - 2>();  // this thread's copies of slab s
    // every thread's copies of slab s have landed, and every warp is done
    // with slab s - 1, whose slot the next stage fills
    __syncthreads();
    stage(s + WSTAGES_F32 - 1);
    const int b = s % WSTAGES_F32;
#pragma unroll 4
    for (int pp = 0; pp < WP; ++pp) {
      float a[2][4], g[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load4(&As[b][pp][h * 64 + tk * 4], a[h]);
        load4(&Gs[b][pp][h * 64 + tn * 4], g[h]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          acc[u][v] = fmaf(a[u / 4][u % 4], g[v / 4][v % 4], acc[u][v]);
    }
  }
  float* out = part + blockIdx.y * N_WEIGHTS + jb.out;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int k = k0 + (u / 4) * 64 + tk * 4 + u % 4;
    if (k >= jb.K) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int n = n0 + (v / 4) * 64 + tn * 4 + v % 4;
      if (n < jb.N) out[1LL * k * jb.N + n] = acc[u][v];
    }
  }
}

// The 16-bit wgrad on the tensor cores: a TK x TN output tile a CTA, warp
// (wm, wn) = (warp / 4, warp % 4) owning rows [64 wm, 64 wm + 64) and
// columns [32 wn, 32 wn + 32) (acc[mi][nt]: the m16n8 tile at row 64 wm +
// 16 mi, column 32 wn + 8 nt).  The point range goes in slabs of TPS
// points, a_in's and g_pre's tile columns staged point-major (row pitch
// TLD: ldmatrix's row addresses 272 bytes apart, distinct banks) through a
// ring of WSTAGES slabs in dynamic shared memory, WSTAGES - 1 of them in
// flight by cp.async while one is consumed.  The mma's A operand is a_in^T
// and its B operand g_pre, both read by ldmatrix.trans from the slabs.
constexpr int TK = 128, TN = 128, TPS = 32, TLD = 128 + 8, WSTAGES = 4;
constexpr size_t WGRAD_SMEM = sizeof(bf16) * WSTAGES * 2 * TPS * TLD;
static_assert(sizeof(f16) == sizeof(bf16), "one ring for both 16-bit types");
static_assert(TPS == WP, "the wgrad kernels split the points alike");

template <typename T, int SC>
__global__ void __launch_bounds__(256, 2)
fused_nerf_wgrad_mma_kernel(const T* __restrict__ stash,
                            const T* __restrict__ gbuf,
                            long long n_points, WJobs jobs,
                            float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  // slab b: As[b] (a_in) then Gs[b] (g_pre), TPS rows of TLD each
  auto As = reinterpret_cast<T(*)[TPS][TLD]>(smem);
  auto Gs = As + WSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  int k0, n0;
  const WJob jb = find_job(jobs, TK, TN, k0, n0);
  const long long per =
      ((n_points + gridDim.y - 1) / gridDim.y + TPS - 1) / TPS * TPS;
  const long long pb = blockIdx.y * per;
  const long long pe = min(n_points, pb + per);
  const T* A = (jb.a_in_g ? gbuf : stash) + jb.a_col + k0;
  const long long lda = jb.a_in_g ? GC : SC;
  const T* G = gbuf + jb.g_col + n0;
  const int live_k = jb.K - k0, live_n = jb.N - n0;  // columns in the tile
  const int n_slabs = pe > pb ? static_cast<int>((pe - pb + TPS - 1) / TPS) : 0;

  // slab s into ring slot s % WSTAGES, one committed group (empty past the
  // last slab, so that every thread counts its groups alike): 8 columns a
  // vector; a vector that is not wholly live (past the point range, or
  // reaching past K or N into columns that may never have been written)
  // reads only its live elements and zero-fills the rest
  auto stage = [&](int s) {
    if (s < n_slabs) {
      const long long q0 = pb + 1LL * s * TPS;
      const int b = s % WSTAGES;
      for (int i = tid; i < 2 * TPS * (TK / 8); i += 256) {
        const bool is_g = i >= TPS * (TK / 8);
        const int r = is_g ? i - TPS * (TK / 8) : i;
        const int pp = r / (TK / 8), c = (r % (TK / 8)) * 8;
        const long long p = q0 + pp;
        const int live = is_g ? live_n : live_k;
        const T* src = is_g ? G + p * GC + c : A + p * lda + c;
        T* dst = is_g ? &Gs[b][pp][c] : &As[b][pp][c];
        const int n_live = p < pe ? max(0, min(8, live - c)) : 0;
        // a dead vector reads nothing; its address is any valid one
        mma::cp_async16_zfill(dst, n_live ? src : G,
                              static_cast<int>(sizeof(T)) * n_live);
      }
    }
    mma::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;

  for (int s = 0; s < WSTAGES - 1; ++s) stage(s);
  for (int s = 0; s < n_slabs; ++s) {
    mma::cp_async_wait<WSTAGES - 2>();  // this thread's copies of slab s
    // every thread's copies of slab s have landed, and every warp is done
    // with slab s - 1, whose slot the next stage fills
    __syncthreads();
    stage(s + WSTAGES - 1);
    const int b = s % WSTAGES;
#pragma unroll
    for (int ks = 0; ks < TPS; ks += 16) {
      // B (points x n): rows ks..ks+7 / ks+8..ks+15 of two n8 tiles
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, &Gs[b][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                  [wn * 32 + np * 16 + (lane >> 4) * 8]);
        bf[2 * np][0] = r[0]; bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2]; bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A (k x points): a_in^T, from the point-major slab by .trans
        uint32_t a[4];
        mma::ldmatrix_x4_trans(
            a, &As[b][ks + (lane & 7) + ((lane >> 4) & 1) * 8]
                  [wm * 64 + mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma::mma16<T>(acc[mi][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }
  float* out = part + blockIdx.y * N_WEIGHTS + jb.out;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wm * 64 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (k < jb.K && n < jb.N) out[1LL * k * jb.N + n] = acc[mi][nt][e];
      }
}

// The 16-bit wgrad of the narrow heads (sigma, N = 1; rgb, N = 3), one job a
// CTA column: warp w sums the w-th eighth of the CTA's point range in order
// of p, one fused multiply-add a term, lane l owning rows k = 8 l .. 8 l + 7
// of the job's dW (K <= 256): a point's a_in row is one 16-byte vector a
// lane, coalesced over the lanes, and its NARROW_N g_pre columns one 8-byte
// broadcast (the G buffer's columns past N are read and never used); then
// the eight warps' sums are added in order of w.
constexpr int NARROW_N = 4;

template <typename T, int SC>
__global__ void __launch_bounds__(256)
fused_nerf_wgrad_narrow_kernel(const T* __restrict__ stash,
                               const T* __restrict__ gbuf,
                               long long n_points, WJobs jobs,
                               float* __restrict__ part) {
  __shared__ float sums[8][256 * NARROW_N];
  const WJob jb = jobs.job[blockIdx.x];
  const long long per =
      ((n_points + gridDim.y - 1) / gridDim.y + WP - 1) / WP * WP;
  const long long pb = blockIdx.y * per;
  const long long pe = min(n_points, pb + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sub = pe > pb ? (pe - pb + 7) / 8 : 0;
  const long long q0 = pb + warp * sub, q1 = min(pe, q0 + sub);
  const bool live = 8 * lane < jb.K;
  const T* A = (jb.a_in_g ? gbuf : stash) + jb.a_col + 8 * lane;
  const long long lda = jb.a_in_g ? GC : SC;
  const T* G = gbuf + jb.g_col;
  float acc[8][NARROW_N];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n) acc[c][n] = 0.0f;
  if (live) {
#pragma unroll 4
    for (long long p = q0; p < q1; ++p) {
      float a[8], gv[NARROW_N];
      load8(A + p * lda, a);
      load4(G + p * GC, gv);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int n = 0; n < NARROW_N; ++n)
          acc[c][n] = fmaf(a[c], gv[n], acc[c][n]);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n)
      sums[warp][(8 * lane + c) * NARROW_N + n] = acc[c][n];
  __syncthreads();
  float* out = part + blockIdx.y * N_WEIGHTS + jb.out;
  for (int i = threadIdx.x; i < jb.K * jb.N; i += 256) {
    const int k = i / jb.N, n = i - k * jb.N;
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += sums[w][k * NARROW_N + n];
    out[i] = s;
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

// The wrapper's job table, JOB_FIELDS values a job: (a_in_g, a_col, K,
// g_col, N, out, route), split by route: ROUTE_SCALAR (f32 only: WK x WN
// tiles on the CUDA cores, 16-byte aligned columns), ROUTE_TC (16-bit only:
// TK x TN tiles on the tensor cores, 16-byte aligned columns) and
// ROUTE_NARROW (16-bit only: N <= NARROW_N, K <= 256 and a multiple of 8,
// 16-byte aligned a_in and 8-byte aligned g_pre columns; one CTA column a
// job).  Each job's columns must lie in its rows and its output block in
// the packed weights.
constexpr int JOB_FIELDS = 7;
enum Route : int { ROUTE_SCALAR = 0, ROUTE_TC = 1, ROUTE_NARROW = 2 };

struct JobLists {
  WJobs by_route[3];
};

int split_jobs(const long long* table, int n, bool tc_type, int sc,
               JobLists& lists) {
  lists = JobLists{};
  for (int i = 0; i < n; ++i) {
    const long long* f = table + 1LL * i * JOB_FIELDS;
    const long long route = f[6];
    const long long a_end = f[1] + f[2], lda = f[0] ? GC : sc;
    const bool bad_route =
        route < ROUTE_SCALAR || route > ROUTE_NARROW ||
        (route == ROUTE_SCALAR) == tc_type ||
        (route == ROUTE_TC && (f[1] % 8 || f[3] % 8)) ||
        (route == ROUTE_SCALAR && (f[1] % 4 || f[3] % 4)) ||
        (route == ROUTE_NARROW &&
         (f[4] > NARROW_N || f[2] > 256 || f[2] % 8 || f[1] % 8 || f[3] % 4 ||
          f[3] + NARROW_N > GC));
    if (bad_route || f[1] < 0 || f[2] < 1 || a_end > lda || f[3] < 0 ||
        f[4] < 1 || f[3] + f[4] > GC || f[5] < 0 ||
        f[5] + f[2] * f[4] > N_WEIGHTS)
      return static_cast<int>(cudaErrorInvalidValue);
    WJobs& js = lists.by_route[route];
    if (js.n == 16) return static_cast<int>(cudaErrorInvalidValue);
    const int tk = route == ROUTE_TC ? TK : route == ROUTE_SCALAR ? WK : 256;
    const int tn =
        route == ROUTE_TC ? TN : route == ROUTE_SCALAR ? WN : NARROW_N;
    WJob& jb = js.job[js.n++];
    jb.a_in_g = static_cast<int>(f[0]);
    jb.a_col = static_cast<int>(f[1]);
    jb.K = static_cast<int>(f[2]);
    jb.g_col = static_cast<int>(f[3]);
    jb.N = static_cast<int>(f[4]);
    jb.out = f[5];
    jb.tiles_n = (jb.N + tn - 1) / tn;
    jb.tile0 = js.tiles;
    js.tiles += (jb.K + tk - 1) / tk * jb.tiles_n;
  }
  return 0;
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
  const long long* jobs;
  int n_jobs;
};

template <typename T, bool SIGMA_ONLY, bool REMAT, int IN>
int run(const BwdArgs& a, cudaStream_t s) {
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long P = a.P, chunk = a.chunk;
  if (!kTensorCores<T> && a.wt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  JobLists jobs;
  int e = split_jobs(a.jobs, a.n_jobs, kTensorCores<T>, SC, jobs);
  if (e != 0) return e;
  auto dgrad = fused_nerf_dgrad_kernel<T, SIGMA_ONLY, REMAT, IN>;
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      dgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kTensorCores<T>)
    err = cudaFuncSetAttribute(fused_nerf_wgrad_mma_kernel<T, SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WGRAD_SMEM));
  else
    err = cudaFuncSetAttribute(fused_nerf_wgrad_kernel<SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WGRAD_F32_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const WJobs& tc = jobs.by_route[ROUTE_TC];
  const WJobs& narrow = jobs.by_route[ROUTE_NARROW];
  const WJobs& scalar = jobs.by_route[ROUTE_SCALAR];
  for (long long p_begin = 0; p_begin < P; p_begin += chunk) {
    const long long p_end = std::min(P, p_begin + chunk);
    const long long n = p_end - p_begin;
    const int tiles = static_cast<int>((n + TP - 1) / TP);
    // E reads kernel D's stash at the chunk's rows; F fills its scratch
    T* st = static_cast<T*>(a.stash) + (REMAT ? 0 : p_begin * SC);
    const T* gbuf = static_cast<const T*>(a.gbuf);
    float* wpart = static_cast<float*>(a.wpart);
    dgrad<<<tiles, THREADS, smem, s>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.g),
        static_cast<const T*>(a.w), static_cast<const float*>(a.b),
        static_cast<const T*>(a.wt), P, p_begin, p_end, st,
        static_cast<T*>(a.gbuf), static_cast<float*>(a.bpart), a.x_cols,
        static_cast<const T*>(a.wx), static_cast<float*>(a.dx));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if constexpr (kTensorCores<T>) {
      if (tc.n) {
        fused_nerf_wgrad_mma_kernel<T, SC>
            <<<dim3(tc.tiles, a.split), 256, WGRAD_SMEM, s>>>(st, gbuf, n, tc,
                                                             wpart);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
      }
      if (narrow.n) {
        fused_nerf_wgrad_narrow_kernel<T, SC>
            <<<dim3(narrow.n, a.split), 256, 0, s>>>(st, gbuf, n, narrow,
                                                     wpart);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
      }
    } else if (scalar.n) {
      fused_nerf_wgrad_kernel<SC>
          <<<dim3(scalar.tiles, a.split), 256, WGRAD_F32_SMEM, s>>>(
              st, gbuf, n, scalar, wpart);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    e = reduce(static_cast<const float*>(a.wpart), a.split, N_WEIGHTS,
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

// the weight types of MASK (NERF_DTYPES) that this library is built for
template <int MASK>
int run_dtype(int dtype, int io, int sigma_only, int remat, const BwdArgs& a,
              cudaStream_t s) {
  switch (dtype) {
    case DTYPE_F32:
      if constexpr ((MASK >> DTYPE_F32) & 1)
        return run_io<float>(io, sigma_only, remat, a, s);
      break;
    case DTYPE_BF16:
      if constexpr ((MASK >> DTYPE_BF16) & 1)
        return run_io<bf16>(io, sigma_only, remat, a, s);
      break;
    case DTYPE_F16:
      if constexpr ((MASK >> DTYPE_F16) & 1)
        return run_io<f16>(io, sigma_only, remat, a, s);
      break;
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
int nerf_bwd_job_fields() { return JOB_FIELDS; }
// the G buffer's columns: g_fin, g_dpre, g_rgbpre, g_sigma, x_emb, dir_emb,
// then the row length (i = 0..6)
int nerf_bwd_g_layout(int i) {
  const int cols[] = {G_FIN, G_DPRE, G_RGB, G_SIG, G_XE, G_DE, GC};
  return i >= 0 && i < 7 ? cols[i] : -1;
}

// Kernels E (remat = 0; stash: kernel D's (P, SC) stash) and F (remat = 1;
// stash: a (chunk, SC) scratch) with io = 0 (x, g (8, P)); with io = 1, E'
// and F' (x and g (P, 8), 16-byte aligned); with io = 2 and remat = 1,
// kernel H (x (P, x_cols) pre-embedded, x_cols 63 or 90; g (P, 8), 16-byte
// aligned; wx (N_WX) in T; dx (P, x_cols) f32, zeroed).  w (N_WEIGHTS) in T,
// the weight type named by dtype (DTYPE_F32, DTYPE_BF16 or DTYPE_F16, of
// those NERF_DTYPES builds; any other code is refused); wt (N_WT) in f32
// (null in the 16-bit types); b (N_BIASES) f32.
// jobs: n_jobs rows of JOB_FIELDS (host memory), the weight-grad products.
// Workspace: gbuf (chunk, GC) T, wpart (split, N_WEIGHTS) f32, bpart
// (ceil(chunk / TP), N_BIASES) f32, btmp (ceil(ceil(chunk / TP) /
// BIAS_RPG), N_BIASES) f32.  dw (N_WEIGHTS) and db (N_BIASES) f32 are
// accumulated into: zero them, and wpart too (sigma-only runs write no
// partials for the heads past sigma).
int nerf_fused_bwd(const void* x, const void* g, const void* w,
                   const void* b, const void* wt, long long P, int sigma_only,
                   int dtype, int remat, int io, void* stash, void* gbuf,
                   void* wpart, void* bpart, void* btmp, void* dw, void* db,
                   long long chunk, int split, int x_cols, const void* wx,
                   void* dx, const long long* jobs, int n_jobs,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{x, g, w, b, wt, P, stash, gbuf, wpart, bpart, btmp,
                  dw, db, chunk, split, x_cols, wx, dx, jobs, n_jobs};
  return run_dtype<NERF_DTYPES>(dtype, io, sigma_only, remat, a, s);
}

}  // extern "C"
