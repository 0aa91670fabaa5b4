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
// The same fixed-length, branch-free compare loop as the TPU kernels, so the
// results are bit-identical to the plain versions: no arithmetic is done on
// the values, only compares, max and min.
//
// Bound on the H100: bytes.  At the serving shape (B = 32000 rays, M = 63
// CDF entries, K = 128 draws) B reads 8 MB of rows and 16 MB of queries and
// writes 49 MB of outputs; the compares are ~6 operations per (b, k, m),
// about as long at the f32 rate as the bytes take at 3.35 TB/s.
// Design: one CTA per row.  The row is staged once in shared memory and read
// back as a broadcast by every thread, so each input byte is read from
// device memory once; one thread per query, with consecutive threads on
// consecutive queries, so loads and stores of vals/out are coalesced.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <bool RIGHT>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const float* __restrict__ seq, const float* __restrict__ vals,
            int32_t* __restrict__ out, int M, int K) {
  extern __shared__ float row[];
  const long long b = blockIdx.x;
  const float* srow = seq + b * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) row[m] = srow[m];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = vals[b * K + k];
    int acc = 0;
    for (int m = 0; m < M; ++m) acc += RIGHT ? (v >= row[m]) : (v > row[m]);
    out[b * K + k] = acc;
  }
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

// seq (B, M) f32, vals (B, K) f32 -> out (B, K) int32; all contiguous.
int searchsorted_rank(const void* seq, const void* vals, void* out,
                      long long B, int M, int K, int right, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(M);
  auto s = static_cast<cudaStream_t>(stream);
  auto seq_f = static_cast<const float*>(seq);
  auto vals_f = static_cast<const float*>(vals);
  auto out_i = static_cast<int32_t*>(out);
  if (right)
    rank_kernel<true><<<static_cast<unsigned>(B), kThreads, smem, s>>>(
        seq_f, vals_f, out_i, M, K);
  else
    rank_kernel<false><<<static_cast<unsigned>(B), kThreads, smem, s>>>(
        seq_f, vals_f, out_i, M, K);
  return static_cast<int>(cudaGetLastError());
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
