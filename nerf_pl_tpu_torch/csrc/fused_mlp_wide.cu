// Kernel G: the fused NeRF MLP forward on pre-embedded rows, at the
// reference width W = 256 and at the wide widths W = 128, 384, 512, 640
// (the --arch_width trunks whose W is a multiple of 128).
//
// Replaces (TPU, Pallas): nerf_pl_tpu/ops/fused_mlp.py::fused_nerf_apply
// (:495) -> _fused_apply_padded -> _fused_fwd_call (:358, pallas_call :363)
// -> _fwd_kernel (:184), body _fwd_body (:155).  It runs in the
// fused_wide_infer branch of ops/rendering.py::_query at a wide width and as
// the forward of fused_nerf_apply under autograd at W = 256, whose backward
// is kernel H (fused_mlp_bwd.cu).
//
// Computes, for each point p (row of x):
//   x rows [xyz_emb (63) | dir_emb (27)], or xyz_emb alone (63 columns;
//   dir_emb is then zeros, as JAX pads x with zero columns)
//   h = xyz_emb; for i < 8: h = relu([xyz_emb, h] (i == 4) or h) @ W_i + b_i
//   sigma = h @ Wsig + bsig
//   rgb   = sigmoid(relu([h @ Wfin + bfin, dir_emb] @ Wdir + bdir) @ Wrgb + brgb)
//   out (P, 8) f32 rows [rgb(3) | sigma | 0 0 0 0]; sigma-only: [sigma | 0 x 7]
// Numerics of _fwd_body: each layer's input, x included, is rounded to the
// weight type T (f32, bf16 or fp16) before its product; products and sums in
// f32; bias, ReLU and sigmoid in f32; din = [fin | dir_emb] is rounded before
// Wdir.  The TPU kernel's padding (x to 128 lanes, the heads to 128 output
// lanes) multiplies zeros only and is not reproduced: weights are read in the
// reference order, unpadded, W_i as (fan_in, fan_out) row-major.
//
// Bound on the H100: operations.  At W = 512, 2,300,928 multiply-adds per
// rgb point (1,900,032 sigma-only) against 360 bytes of input and 32 of
// output; the 4.6 MB bf16 weight set stays in the 50 MB L2.  At the bf16
// tensor rate (989 TFLOP/s) a 6.1M-point fine chunk needs 28.6 ms.
// Design: the same tile forward as C (fused_mlp_common.cuh), with the tile's
// input loaded from x's rows (consecutive threads read consecutive floats; a
// row of 63 or 90 floats is not 16-byte aligned, so no vector loads) and the
// width a template parameter.  At W <= 256 a tile is 64 points, at W > 256 32
// (so that the f32 loop's accumulators stay within 80 floats a thread).  bf16
// and fp16 run every product on the tensor cores as C does: 2 x 4 warps of TP
// / 2 points x N / 4 columns (1 or 2 m16 tiles, up to 20 n8 tiles a warp at W
// = 640), the weights streamed from L2 in stages of 32 rows (W <= 256) or 16
// through a ring of three stages (two at W = 640), every output near a tie of
// the type recomputed in k order.  Each tile reads the whole weight set from
// L2 (4.6 MB at W = 512).  f32 (W <= 384) runs C's f32 tile on the CUDA
// cores: a thread accumulates PPW points x W / 32 features, all of a layer's
// outputs in one pass (products whose width is not a multiple of 128, the dir
// heads W / 2 = 64, 192, give each lane 2 features per 64-column group), the
// weights through a two-stage cp.async ring of 8-row (W <= 256) or 4-row
// stages, the activation rows padded to TP + 4 points.  Shared memory per CTA
// stays below 113 KB, so two CTAs share an SM at every width.
#include "fused_mlp_common.cuh"

namespace {

using namespace nerf;

template <class Geo, typename T, bool SIGMA_ONLY>
__global__ void __launch_bounds__(THREADS, 2)
fused_nerf_wide_kernel(const float* __restrict__ x, int x_cols,
                       float* __restrict__ out, const T* __restrict__ wts,
                       const float* __restrict__ bias, long long P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long p0 = 1LL * blockIdx.x * Geo::TP;
  forward_tile<Geo, T, SIGMA_ONLY, false, IO_EMBEDDED>(
      x, out, wts, bias, P, p0, smem, nullptr, x_cols);
}

template <class Geo, typename T, bool SIGMA_ONLY>
int launch(const void* x, int x_cols, void* out, const void* w,
           const void* b, long long P, cudaStream_t stream) {
  auto kernel = fused_nerf_wide_kernel<Geo, T, SIGMA_ONLY>;
  constexpr size_t smem = Geo::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (P + Geo::TP - 1) / Geo::TP;
  kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
      static_cast<const float*>(x), x_cols, static_cast<float*>(out),
      static_cast<const T*>(w), static_cast<const float*>(b), P);
  return static_cast<int>(cudaGetLastError());
}

template <class Geo, typename T>
int launch_mode(const void* x, int x_cols, void* out, const void* w,
                const void* b, long long P, int sigma_only, cudaStream_t s) {
  return sigma_only ? launch<Geo, T, true>(x, x_cols, out, w, b, P, s)
                    : launch<Geo, T, false>(x, x_cols, out, w, b, P, s);
}

// The instantiated (width, type) pairs: every width that
// supports_fused_wide admits (its TPU weight budget: the 16-bit types both
// to W = 640, f32 to 384), and 256.
bool supported(int width, int dtype) {
  if (!(dtype == DTYPE_F32 && kBuilt<DTYPE_F32>) &&
      !(dtype == DTYPE_BF16 && kBuilt<DTYPE_BF16>) &&
      !(dtype == DTYPE_F16 && kBuilt<DTYPE_F16>))
    return false;
  switch (width) {
    case 128: case 256: case 384: return true;
    case 512: case 640: return dtype != DTYPE_F32;
    default: return false;
  }
}

// kernel G at one width in the weight type named by dtype (supported()
// has checked that this library is built for it)
template <class Geo>
int launch_type(const void* x, int x_cols, void* out, const void* w,
                const void* b, long long P, int sigma_only, int dtype,
                cudaStream_t s) {
  if constexpr (Geo::W <= 384 && kBuilt<DTYPE_F32>) {
    if (dtype == DTYPE_F32)
      return launch_mode<Geo, float>(x, x_cols, out, w, b, P, sigma_only, s);
  }
  if constexpr (kBuilt<DTYPE_F16>) {
    if (dtype == DTYPE_F16)
      return launch_mode<Geo, f16>(x, x_cols, out, w, b, P, sigma_only, s);
  }
  if constexpr (kBuilt<DTYPE_BF16>) {
    if (dtype == DTYPE_BF16)
      return launch_mode<Geo, bf16>(x, x_cols, out, w, b, P, sigma_only, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Geo>
long long geo_count(bool biases) {
  return biases ? Geo::N_BIASES : Geo::N_WEIGHTS;
}

long long count(int width, bool biases) {
  switch (width) {
    case 128: return geo_count<Wide<128>>(biases);
    case 256: return geo_count<Wide<256>>(biases);
    case 384: return geo_count<Wide<384>>(biases);
    case 512: return geo_count<Wide<512>>(biases);
    case 640: return geo_count<Wide<640>>(biases);
    default: return -1;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 if kernel G is built for this width and weight type (dtype: DTYPE_F32,
// DTYPE_BF16 or DTYPE_F16), else 0.
int nerf_wide_supported(int width, int dtype) {
  return supported(width, dtype) ? 1 : 0;
}
// The packed layout at a width: weights and biases (-1 for a width that is
// not built).
long long nerf_wide_weight_count(int width) { return count(width, false); }
long long nerf_wide_bias_count(int width) { return count(width, true); }

// Kernel G.  x (P, x_cols) f32, x_cols 63 or 90; out (P, 8) f32, 16-byte
// aligned; w: nerf_wide_weight_count(width) elements of the weight type
// named by dtype, b: nerf_wide_bias_count(width) f32; all contiguous on the
// stream's device.
int nerf_wide_fwd(const void* x, int x_cols, void* out, const void* w,
                  const void* b, long long P, int width, int sigma_only,
                  int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!supported(width, dtype) || (x_cols != CX && x_cols != CX + CD))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 128:
      return launch_type<Wide<128>>(x, x_cols, out, w, b, P, sigma_only,
                                    dtype, s);
    case 256:
      return launch_type<Wide<256>>(x, x_cols, out, w, b, P, sigma_only,
                                    dtype, s);
    case 384:
      return launch_type<Wide<384>>(x, x_cols, out, w, b, P, sigma_only,
                                    dtype, s);
    case 512:
      return launch_type<Wide<512>>(x, x_cols, out, w, b, P, sigma_only,
                                    dtype, s);
    default:  // 640, 16-bit (supported() above)
      return launch_type<Wide<640>>(x, x_cols, out, w, b, P, sigma_only,
                                    dtype, s);
  }
}

}  // extern "C"
