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
// No arithmetic is done on the values, only compares, max and min, so the
// results are bit-identical to the plain versions.
//
// Contract of A: every row is non-decreasing (r[m] <= r[m+1]; ties and
// plateaus allowed), as the importance sampler's CDF rows are: a float
// cumulative sum of non-negative terms after a leading zero
// (ops/sampling.py).  On such a row the set {m : r[m] <= v} ({m : r[m] < v}
// for side left) is a prefix, so the rank, its length, is what a bisection
// returns: A makes ceil(log2(M + 1)) branch-free halving steps (6 at M = 63)
// in place of the TPU kernel's M compares, and gives the same count for any
// v, at ties, at 0 and past the row's end.  B keeps the fixed-length
// compare loop of the TPU kernel (it needs the whole row for lo and hi).
//
// Bound on the H100: bytes.  At the serving shape (B = 32000 rays, M = 63
// CDF entries, K = 128 draws) A reads 8 MB of rows and 16 MB of queries and
// writes 16 MB of ranks (12 us at 3.35 TB/s); B writes 49 MB of outputs
// and makes ~6 operations per (b, k, m), about as long at the f32 rate as
// its bytes take.
// Design.  A: several rows to a 256-thread CTA (32 threads a row at K =
// 128), the rows staged once in shared memory; each thread bisects 4
// consecutive queries of its row, read and written as 16-byte vectors when
// K is a multiple of 4 and vals starts on 16 bytes (the wrapper passes the
// vector width; a view at another offset takes one query a thread), so
// loads and stores stay coalesced.  B: one CTA per
// row, the row staged in shared memory and read back as a broadcast, one
// thread per query.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;     // kernel B
constexpr int kRankThreads = 256; // kernel A
constexpr int kRankSmemFloats = 12 * 1024;  // A's staged rows: 48 KB

// Kernel A: the block's rows [b0, b0 + rows) staged in shared memory;
// thread t bisects query groups j, j + tpr, ... of row t / tpr (j = t %
// tpr), VEC consecutive queries a group (VEC = 4: 16-byte vectors, which
// need vals 16-byte aligned and K % 4 == 0).  top: the smallest power of two
// with 2 top - 1 >= M, so the halving steps can reach every count 0..M.
template <bool RIGHT, int VEC>
__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const float* __restrict__ seq, const float* __restrict__ vals,
            int32_t* __restrict__ out, long long B, int M, int K, int tpr,
            int top) {
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
    }
    if constexpr (VEC == 4)
      reinterpret_cast<int4*>(out + base_q)[q] =
          make_int4(res[0], res[1], res[2], res[3]);
    else
      out[base_q + q] = res[0];
  }
}

template <bool RIGHT>
int launch_rank(const float* seq, const float* vals, int32_t* out,
                long long B, int M, int K, int vec_width, cudaStream_t s) {
  const bool vec = vec_width == 4;
  if (vec && (K % 4 || reinterpret_cast<uintptr_t>(vals) % 16 ||
              reinterpret_cast<uintptr_t>(out) % 16))
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
    rank_kernel<RIGHT, 4><<<static_cast<unsigned>(grid), rpc * tpr, smem, s>>>(
        seq, vals, out, B, M, K, tpr, top);
  else
    rank_kernel<RIGHT, 1><<<static_cast<unsigned>(grid), rpc * tpr, smem, s>>>(
        seq, vals, out, B, M, K, tpr, top);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
rank_interp_kernel(const float* __restrict__ seq,
                   const float* __restrict__ vals, int32_t* __restrict__ ranks,
                   float* __restrict__ lo_out, float* __restrict__ hi_out,
                   int M, int K) {
  extern __shared__ float row[];
  const long long b = blockIdx.x;
  const float* srow = seq + b * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) row[m] = srow[m];
  __syncthreads();
  const float last = row[M - 1];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = vals[b * K + k];
    int acc = 0;
    float lo = 0.0f, hi = last;
    for (int m = 0; m < M; ++m) {
      const float c = row[m];
      const bool hit = v >= c;
      acc += hit;
      if (m < M - 1) lo = fmaxf(lo, hit ? c : 0.0f);
      if (m >= 1) hi = fminf(hi, hit ? last : c);
    }
    ranks[b * K + k] = acc;
    lo_out[b * K + k] = lo;
    hi_out[b * K + k] = hi;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// seq (B, M) f32 with non-decreasing rows, vals (B, K) f32 -> out (B, K)
// int32; all contiguous, M <= 12288.  vec_width: 4 to move 4 queries as
// one 16-byte vector (K % 4 == 0, vals and out 16-byte aligned; otherwise
// the call returns cudaErrorMisalignedAddress), or 1.
int searchsorted_rank(const void* seq, const void* vals, void* out,
                      long long B, int M, int K, int right, int vec_width,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto seq_f = static_cast<const float*>(seq);
  auto vals_f = static_cast<const float*>(vals);
  auto out_i = static_cast<int32_t*>(out);
  return right
             ? launch_rank<true>(seq_f, vals_f, out_i, B, M, K, vec_width, s)
             : launch_rank<false>(seq_f, vals_f, out_i, B, M, K, vec_width,
                                  s);
}

// seq (B, M) f32, vals (B, K) f32 -> ranks (B, K) int32, lo, hi (B, K) f32.
int searchsorted_rank_interp(const void* seq, const void* vals, void* ranks,
                             void* lo, void* hi, long long B, int M, int K,
                             void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(M);
  rank_interp_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seq), static_cast<const float*>(vals),
      static_cast<int32_t*>(ranks), static_cast<float*>(lo),
      static_cast<float*>(hi), M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
