// Batched row-wise searchsorted: kernel A (rank) and kernel B (rank plus
// the two bin endpoints of the deterministic importance sampler).
//
// Replaces (TPU, Pallas):
//   A  nerf_pl_tpu/ops/searchsorted.py::searchsorted_pallas
//      -> _rank_kernel (:45)
//   B  nerf_pl_tpu/ops/searchsorted.py::searchsorted_interp_pallas
//      -> _rank_interp_kernel (:122)
//
// Semantics (searchsorted.py:34-42, 106-119), for row r = seq[b, :M] and
// query v = vals[b, k]:
//   rank = sum_m [v >= r[m]]            (side right; '>' for side left)
//   lo   = max over m < M-1 of (r[m] if v >= r[m] else 0)
//   hi   = min over m >= 1  of (r[M-1] if v >= r[m] else r[m]),
//          starting from r[M-1]
// The kernels do no arithmetic on the values, only compares and reads, so
// their results are bit-identical to the plain versions.
//
// Contract of A and B: every row is non-decreasing (r[m] <= r[m+1]; ties
// and plateaus allowed), and B's rows are also non-negative, as the
// importance sampler's CDF rows are: a float cumulative sum of
// non-negative terms after a leading zero (ops/sampling.py).  On such a
// row the set {m : r[m] <= v} ({m : r[m] < v} for side left) is a prefix,
// so the rank, its length, is what a bisection returns: both kernels make
// ceil(log2(M + 1)) branch-free halving steps (6 at M = 63) in place of the
// TPU kernels' M compares, and give the same count for any v, at ties, at
// 0, past the row's end and for a NaN (rank 0).  The hits form the prefix
// [0, rank), so B's masked max and min reduce to two reads of the row:
//   lo = r[j - 1] with j = min(rank, M - 1), or 0 when j = 0
//        (the largest hit below M - 1; no hit, or a hit of 0, gives 0)
//   hi = r[min(max(rank, 1), M - 1)]
//        (the first miss from m = 1 on, else r[M - 1])
// the very values the reductions select (nerf_pl_tpu/ops/searchsorted.py:
// 95-104 makes the same point), so the bits stay those of the plain
// versions.
//
// Bound on the H100: bytes, whatever the algorithm.  At the serving shape
// (B = 32000 rays, M = 63 CDF entries, K = 128 draws) both read 8 MB of
// rows and 16 MB of queries; A writes 16 MB of ranks (12 us at 3.35
// TB/s), B 49 MB of ranks and endpoints (73.6 MB in all, 22 us).
// Design: one kernel for both (INTERP adds the endpoints).  Several rows
// to a 256-thread CTA (32 threads a row at K = 128), the rows staged once
// in shared memory; each thread bisects 4 consecutive queries of its row,
// read and written as 16-byte vectors when K is a multiple of 4 and vals
// starts on 16 bytes (the wrapper passes the vector width; a view at
// another offset takes one query a thread), so loads and stores stay
// coalesced.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRankThreads = 256;
constexpr int kRankSmemFloats = 12 * 1024;  // the staged rows: 48 KB

// The block's rows [b0, b0 + rows) staged in shared memory; thread t
// bisects query groups j, j + tpr, ... of row t / tpr (j = t % tpr), VEC
// consecutive queries a group (VEC = 4: 16-byte vectors, which need vals
// and the outputs 16-byte aligned and K % 4 == 0).  top: the smallest power
// of two with 2 top - 1 >= M, so the halving steps can reach every count
// 0..M.  INTERP (side right only) also writes lo and hi.
template <bool RIGHT, int VEC, bool INTERP>
__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const float* __restrict__ seq, const float* __restrict__ vals,
            int32_t* __restrict__ out, float* __restrict__ lo_out,
            float* __restrict__ hi_out, long long B, int M, int K, int tpr,
            int top) {
  static_assert(RIGHT || !INTERP, "the endpoints are side right's");
  extern __shared__ float rows[];
  const int rpc = blockDim.x / tpr;  // rows per CTA
  const long long b0 = 1LL * blockIdx.x * rpc;
  const int n_rows = static_cast<int>(min(static_cast<long long>(rpc), B - b0));
  for (int i = threadIdx.x; i < n_rows * M; i += blockDim.x)
    rows[i] = seq[b0 * M + i];
  __syncthreads();
  const int r = threadIdx.x / tpr, j = threadIdx.x - r * tpr;
  if (r >= n_rows) return;
  const float* row = rows + r * M;
  const long long base_q = (b0 + r) * K;
  for (int q = j; q < K / VEC; q += tpr) {
    float v[VEC];
    if constexpr (VEC == 4) {
      const float4 u = reinterpret_cast<const float4*>(vals + base_q)[q];
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      v[0] = vals[base_q + q];
    }
    int res[VEC];
    float lo[VEC], hi[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // invariant: every m < base satisfies the compare
      int base = 0;
      for (int half = top; half > 0; half >>= 1) {
        const int probe = base + half;
        const float c = row[min(probe, M) - 1];
        const bool take = probe <= M && (RIGHT ? v[e] >= c : v[e] > c);
        base = take ? probe : base;
      }
      res[e] = base;
      if constexpr (INTERP) {
        const int jl = min(base, M - 1);
        lo[e] = jl > 0 ? row[jl - 1] : 0.0f;
        hi[e] = row[min(max(base, 1), M - 1)];
      }
    }
    if constexpr (VEC == 4) {
      reinterpret_cast<int4*>(out + base_q)[q] =
          make_int4(res[0], res[1], res[2], res[3]);
      if constexpr (INTERP) {
        reinterpret_cast<float4*>(lo_out + base_q)[q] =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
        reinterpret_cast<float4*>(hi_out + base_q)[q] =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
    } else {
      out[base_q + q] = res[0];
      if constexpr (INTERP) {
        lo_out[base_q + q] = lo[0];
        hi_out[base_q + q] = hi[0];
      }
    }
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

template <bool RIGHT, bool INTERP>
int launch_rank(const float* seq, const float* vals, int32_t* out, float* lo,
                float* hi, long long B, int M, int K, int vec_width,
                cudaStream_t s) {
  const bool vec = vec_width == 4;
  if (vec && (K % 4 || misaligned(vals) || misaligned(out) ||
              (INTERP && (misaligned(lo) || misaligned(hi)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int groups = vec ? K / 4 : K;
  int tpr = 1;
  while (tpr < groups && tpr < kRankThreads) tpr *= 2;
  const int rpc = std::min(kRankThreads / tpr, kRankSmemFloats / M);
  int top = 1;
  while (2 * top - 1 < M) top *= 2;
  const long long grid = (B + rpc - 1) / rpc;
  const size_t smem = sizeof(float) * static_cast<size_t>(rpc) * M;
  if (vec)
    rank_kernel<RIGHT, 4, INTERP>
        <<<static_cast<unsigned>(grid), rpc * tpr, smem, s>>>(
            seq, vals, out, lo, hi, B, M, K, tpr, top);
  else
    rank_kernel<RIGHT, 1, INTERP>
        <<<static_cast<unsigned>(grid), rpc * tpr, smem, s>>>(
            seq, vals, out, lo, hi, B, M, K, tpr, top);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel A.  seq (B, M) f32 with non-decreasing rows, vals (B, K) f32 ->
// out (B, K) int32; all contiguous, M <= 12288.  vec_width: 4 to move 4
// queries as one 16-byte vector (K % 4 == 0, vals and out 16-byte aligned;
// otherwise the call returns cudaErrorMisalignedAddress), or 1.
int searchsorted_rank(const void* seq, const void* vals, void* out,
                      long long B, int M, int K, int right, int vec_width,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto seq_f = static_cast<const float*>(seq);
  auto vals_f = static_cast<const float*>(vals);
  auto out_i = static_cast<int32_t*>(out);
  return right ? launch_rank<true, false>(seq_f, vals_f, out_i, nullptr,
                                          nullptr, B, M, K, vec_width, s)
               : launch_rank<false, false>(seq_f, vals_f, out_i, nullptr,
                                           nullptr, B, M, K, vec_width, s);
}

// Kernel B.  seq (B, M) f32 with non-decreasing, non-negative rows, vals
// (B, K) f32 -> ranks (B, K) int32, lo, hi (B, K) f32 (side right); the
// same layout and vec_width rule as A, the outputs aligned as out.
int searchsorted_rank_interp(const void* seq, const void* vals, void* ranks,
                             void* lo, void* hi, long long B, int M, int K,
                             int vec_width, void* stream) {
  return launch_rank<true, true>(
      static_cast<const float*>(seq), static_cast<const float*>(vals),
      static_cast<int32_t*>(ranks), static_cast<float*>(lo),
      static_cast<float*>(hi), B, M, K, vec_width,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
