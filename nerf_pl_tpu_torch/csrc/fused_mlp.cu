// Kernels C and D: the fused NeRF MLP forward with in-kernel positional
// encoding, on channel-major (8, P) input and output; D also writes the
// activation stash that the backward kernel E reads.  C' and D': the same
// kernels on row-major (P, 8) input and output (the ROW_MAJOR flag).
//
// Replaces (TPU, Pallas): nerf_pl_tpu/ops/fused_mlp.py::fused_nerf_apply_raw_t
// (:1215) -> C: _raw_t_fwd_call (:1083) -> _fwd_kernel_raw_t (:1015);
//            D: _raw_t_stash_fwd_call (:1106) -> _fwd_kernel_raw_stash_t
//               (:1032);
// and fused_nerf_apply_raw (:1275) ->
//            C': _fused_raw_fwd_call (:853) -> _fwd_kernel_raw (:644);
//            D': _fused_raw_stash_fwd_call (:741) -> _fwd_kernel_raw_stash
//                (:707).
// The row-major variants differ only at the boundary: each tile's (64, 8)
// input rows, 2 KB of contiguous f32, are staged into shared memory in
// 16-byte loads before the embedding, and each point's 8 outputs leave as
// two 16-byte stores.  The arithmetic is the same code, so C' and D' give
// C's and D's bits on the same points.  Bounds as C and D (the boundary IO
// is 64 bytes a point in either layout).
//
// Computes, for each point p (column of x):
//   x rows [xyz(3) | dir(3) | 0 0]
//   xyz_emb (63) = [xyz, for k < 10: sin(2^k xyz), cos(2^k xyz)]
//   dir_emb (27) = [dir, for k < 4:  sin(2^k dir), cos(2^k dir)]
//   h = xyz_emb; for i < 8: h = relu([xyz_emb, h] (i == 4) or h) @ W_i + b_i
//   sigma = h @ Wsig + bsig
//   rgb   = sigmoid(relu([h @ Wfin + bfin, dir_emb] @ Wdir + bdir) @ Wrgb + brgb)
//   out rows [rgb(3) | sigma | 0 0 0 0]; sigma-only: [sigma | 0 x 7]
// D also writes, for each point, the stash row (P, 2432) in the weight type:
// h1..h8, then fin and d (sigma-only: (P, 2048), h1..h8), each value the
// same rounded activation that the next layer reads (fused_mlp.py:688-700).
// Numerics of _fwd_body (fused_mlp.py:155-181): each layer's input is rounded
// to the weight type T (f32, bf16 or fp16) before its product; products and
// sums in f32; bias, ReLU and sigmoid in f32.  Each rounding is to nearest
// even from the f32 sum, as astype rounds (fp16: subnormals kept, inf past
// 65,504).  Precise sinf/cosf (no fast math) and exact power-of-two scales;
// the TPU kernel's sin(t + pi/2) trick and its channel permutation (_raw_perm)
// are not needed: weights are read in the reference order, W_i as (fan_in,
// fan_out) row-major.
//
// Bound on the H100.  C: operations.  593,408 multiply-adds per rgb point
// (491,264 sigma-only) against 32 bytes of input and output per point; the
// ~1.2 MB bf16 weight set stays in the 50 MB L2.  At the bf16 tensor rate
// (989 TFLOP/s) a 6.1M-point fine chunk needs 7.4 ms; the 84 sinf/cosf per
// point are ~0.1% of the work.  D: bytes, by its stash write (4,864 B per
// rgb point in bf16 against 1.19 MFLOP: 1.46 us per 1,000 points at
// 3.35 TB/s against 1.20 us at the tensor rate).  fp16 has bf16's bytes
// and its dense tensor rate, so the same bounds.
// Design (wgmma/TMA come later): one CTA of 256 threads per tile of 64
// points.  The tile's embedded input and its current activation live in
// shared memory, stored in T: rows [xyz_emb 63 | h 256 | dir_emb 27],
// feature-major, so the skip concat [xyz_emb, h] and the dir-head concat
// [fin, dir_emb] are contiguous row ranges and need no copy.  Each layer's
// outputs overwrite its inputs only after a barrier.
//   bf16 and fp16: every product of the trunk, fin and the dir head runs on
//   the tensor cores (mma.sync m16n8k16, f32 sums; fused_mlp_common.cuh
//   mma_dense): the A operand is the activation rows (pitch 72 points, read
//   by ldmatrix.trans), the B operand W's own row-major layout, streamed
//   from L2 in 32-row stages through a three-stage cp.async ring (rows
//   padded to N + 8; ragged K zero-filled); warps as 2 x 4 of 32 points x
//   64 columns.  Each 16-term sum starts from zero and is added in f32, and
//   every output near a rounding tie of the type is recomputed in the
//   scalar loop's order (TIE_ULPS, TIE_FLOOR; near_tie for bf16,
//   near_tie_f16 for fp16's denser grid), so the rounded activations are
//   those of a sum in k order.  The sigma (N = 1) and rgb (N = 3) heads and
//   the sin/cos embedding stay scalar.
//   f32 (whose limits TF32 would break): the CUDA cores, each warp owning
//   8 points and each lane 8 (or 4) output features, f32 accumulators, one
//   fmaf chain an output in order of k (so the f32 bits are those of the
//   plain scalar loop; chip_smoke.py pins them by digest).  The weights
//   stream through a two-stage cp.async ring of 8-row stages (the next
//   stage's copy overlaps this one's FMAs); the activation rows are padded
//   to 68 points, and each thread stores its outputs as 16-byte vectors (4
//   points down a column into the rows, 4 columns of a point into the
//   stash, straight from the registers); 111,520 bytes of shared memory,
//   two CTAs an SM.
// D is C with the STASH flag: each layer's rounded outputs also go to the
// point's stash row (16-bit: each thread's column pairs, 4-byte stores; f32:
// each thread's 4 columns of a point, 16-byte stores).  The ragged tail of P
// is masked on load and store.  Shared device code: fused_mlp_common.cuh.
#include "fused_mlp_common.cuh"

namespace {

using namespace nerf;

template <typename T, bool SIGMA_ONLY, bool STASH, bool ROW_MAJOR>
__global__ void __launch_bounds__(THREADS, 2)
fused_nerf_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const T* __restrict__ wts,
                      const float* __restrict__ bias, long long P,
                      T* __restrict__ stash) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SC = SIGMA_ONLY ? SC_SIGMA : SC_RGB;
  const long long p0 = 1LL * blockIdx.x * TP;
  forward_tile<Ref, T, SIGMA_ONLY, STASH, ROW_MAJOR ? IO_ROW : IO_CHANNEL>(
      x, out, wts, bias, P, p0, smem, STASH ? stash + p0 * SC : nullptr, 0);
}

template <typename T, bool SIGMA_ONLY, bool STASH, bool ROW_MAJOR>
int launch(const void* x, void* out, const void* w, const void* b,
           long long P, void* stash, cudaStream_t stream) {
  auto kernel = fused_nerf_fwd_kernel<T, SIGMA_ONLY, STASH, ROW_MAJOR>;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (P + TP - 1) / TP;
  kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const T*>(w), static_cast<const float*>(b), P,
      static_cast<T*>(stash));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool STASH, bool RM>
int dispatch_mode(const void* x, void* out, const void* w, const void* b,
                  long long P, int sigma_only, void* stash, cudaStream_t s) {
  return sigma_only ? launch<T, true, STASH, RM>(x, out, w, b, P, stash, s)
                    : launch<T, false, STASH, RM>(x, out, w, b, P, stash, s);
}

template <bool STASH, bool RM>
int dispatch_io(const void* x, void* out, const void* w, const void* b,
                long long P, int sigma_only, int dtype, void* stash,
                cudaStream_t s) {
  switch (dtype) {
    case DTYPE_F32:
      if constexpr (kBuilt<DTYPE_F32>)
        return dispatch_mode<float, STASH, RM>(x, out, w, b, P, sigma_only,
                                               stash, s);
      break;
    case DTYPE_BF16:
      if constexpr (kBuilt<DTYPE_BF16>)
        return dispatch_mode<bf16, STASH, RM>(x, out, w, b, P, sigma_only,
                                              stash, s);
      break;
    case DTYPE_F16:
      if constexpr (kBuilt<DTYPE_F16>)
        return dispatch_mode<f16, STASH, RM>(x, out, w, b, P, sigma_only,
                                             stash, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool STASH>
int dispatch(const void* x, void* out, const void* w, const void* b,
             long long P, int sigma_only, int dtype, int row_major,
             void* stash, cudaStream_t s) {
  return row_major
             ? dispatch_io<STASH, true>(x, out, w, b, P, sigma_only, dtype,
                                        stash, s)
             : dispatch_io<STASH, false>(x, out, w, b, P, sigma_only, dtype,
                                         stash, s);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

long long nerf_fused_weight_count() { return N_WEIGHTS; }
long long nerf_fused_bias_count() { return N_BIASES; }
int nerf_fused_points_per_cta() { return TP; }
int nerf_fused_stash_cols(int sigma_only) {
  return sigma_only ? SC_SIGMA : SC_RGB;
}

// Kernel C (row_major = 0: x and out (8, P)) and C' (row_major = 1: x and
// out (P, 8), 16-byte aligned).  x f32 -> out f32; w: N_WEIGHTS elements of
// the weight type named by dtype (DTYPE_F32, DTYPE_BF16 or DTYPE_F16, of
// those NERF_DTYPES builds; any other code is refused), b: N_BIASES f32; all contiguous on the stream's
// device.
int nerf_fused_fwd(const void* x, void* out, const void* w, const void* b,
                   long long P, int sigma_only, int dtype, int row_major,
                   void* stream) {
  return dispatch<false>(x, out, w, b, P, sigma_only, dtype, row_major,
                         nullptr, static_cast<cudaStream_t>(stream));
}

// Kernels D and D'.  As C and C', and stash (P,
// nerf_fused_stash_cols(sigma_only)) in the weight type.
int nerf_fused_stash_fwd(const void* x, void* out, const void* w,
                         const void* b, long long P, int sigma_only,
                         int dtype, int row_major, void* stash,
                         void* stream) {
  return dispatch<true>(x, out, w, b, P, sigma_only, dtype, row_major, stash,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
