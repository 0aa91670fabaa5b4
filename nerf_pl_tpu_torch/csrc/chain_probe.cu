// Kernel I: the probe's chain of eight products of the NeRF MLP's shapes,
// x (P, 128) . W0 (128 x 256) . W (256 x 256) x 7, on the tensor cores.  A
// measurement of the ceiling that the fused MLP kernels are held against,
// not a part of the model.
//
// Replaces (TPU, Pallas): scripts/kernel_probe.py::chain (:76, pallas_call
// :83) -> _chain_kernel (:58).
//
// Computes, for each row p of x (f32):
//   pure:  h = bf16(bf16(x) @ W0); 7 times h = bf16(h @ W);
//          out = f32(h[:, :128])
//   fancy: h = relu(bf16(x) @ W0); 7 times h = relu(bf16(h) @ W + 0.1);
//          out = h[:, :128] (f32, not rounded)
// Every product takes bf16 operands and sums in f32 (the tensor cores'
// accumulate), as jnp.dot with preferred_element_type rounds: to bf16 after
// the sum in pure mode, f32 in fancy mode.
//
// Bound on the H100: operations.  2 x (128 x 256 + 7 x 256 x 256) = 983,040
// FLOP a row against 1,024 bytes of IO (512 in, 512 out); at P = 786,432,
// 7.73e11 FLOP, 0.78 ms at the bf16 tensor rate (989 TFLOP/s), against
// 0.24 ms of bytes.
// Design (mma.sync; wgmma and TMA are later work): one CTA of 8 warps per
// tile of 128 rows.  The tile's activation (128 x 256 bf16, 66 KB) stays in
// shared memory for all eight products; each warp owns 32 rows x 128
// columns of the product (2 x 16 tiles of m16n8k16, 128 f32 accumulators a
// thread).  Weights stream from L2 through a double-buffered shared stage
// of 32 rows (cp.async, 16 KB a stage), the next stage in flight while the
// current one is consumed, across layer boundaries too.  Operands reach the
// tensor cores by ldmatrix (A row-major, B row-major through .trans); rows
// are padded by 8 elements so the eight row addresses of each 8 x 8 matrix
// fall in distinct banks.  Between products the accumulators, rounded to
// bf16, overwrite the activation after a barrier; the last product writes
// its first 128 columns to out.  Rows past P load zeros and are not stored.
#include "mma.cuh"

namespace {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr int K0 = 128;    // x's columns, W0's rows
constexpr int N = 256;     // every product's width; W's rows
constexpr int OUT = 128;   // the columns of h kept in out
constexpr int LAYERS = 8;
constexpr int BM = 128;    // rows per CTA
constexpr int KC = 32;     // weight rows per stage
constexpr int LD = N + 8;  // shared row stride in elements (528 bytes)
constexpr int THREADS = 256;
constexpr int CHUNKS0 = K0 / KC, CHUNKS = N / KC;
constexpr int N_CHUNKS = CHUNKS0 + (LAYERS - 1) * CHUNKS;
constexpr size_t SMEM = sizeof(bf16) * (BM * LD + 2 * KC * LD);

// Stage c of the weight stream: W0's rows [32 c, 32 c + 32) for the first
// product, then W's rows, 8 stages a product, into a stage buffer.
__device__ __forceinline__ void load_stage(int c, const bf16* __restrict__ w0,
                                           const bf16* __restrict__ w,
                                           bf16* buf) {
  const bf16* src = c < CHUNKS0 ? w0 + 1LL * c * KC * N
                                : w + 1LL * ((c - CHUNKS0) % CHUNKS) * KC * N;
  for (int i = threadIdx.x; i < KC * N / 8; i += THREADS) {
    const int r = i / (N / 8), c8 = i - r * (N / 8);
    cp_async16(buf + r * LD + c8 * 8, src + r * N + c8 * 8);
  }
  cp_async_commit();
}

template <bool FANCY>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const float* __restrict__ x, const bf16* __restrict__ w0,
             const bf16* __restrict__ w, float* __restrict__ out,
             long long P) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* stage = act + BM * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps over the tile
  const long long row0 = 1LL * blockIdx.x * BM;

  load_stage(0, w0, w, stage);
  // x's rows, rounded to bf16, into act columns [0, 128)
  for (int i = threadIdx.x; i < BM * K0 / 4; i += THREADS) {
    const int r = i / (K0 / 4), c4 = i - r * (K0 / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < P)
      v = reinterpret_cast<const float4*>(x + (row0 + r) * K0)[c4];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(act + r * LD + c4 * 4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }

  float acc[2][16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;

  int c = 0;  // the stage being consumed
  for (int layer = 0; layer < LAYERS; ++layer) {
    const int n_stages = layer == 0 ? CHUNKS0 : CHUNKS;
    for (int kc = 0; kc < n_stages; ++kc, ++c) {
      // stage c has landed, and every warp is done with stage c - 1 (and,
      // at a layer's start, the epilogue's writes to act are visible)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (c + 1 < N_CHUNKS)
        load_stage(c + 1, w0, w, stage + ((c + 1) & 1) * KC * LD);
      const bf16* wb = stage + (c & 1) * KC * LD;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        const int k = kc * KC + ks;  // the act column of this step
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], act + (wm * 32 + mi * 16 + (lane & 15)) * LD +
                                 k + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wb + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                        LD +
                                    wn * 128 + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp has read this product's act
    const float bias = layer == 0 ? 0.0f : 0.1f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int r = wm * 32 + mi * 16 + (lane >> 2);
        const int col = wn * 128 + nt * 8 + (lane & 3) * 2;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = acc[mi][nt][e];
          if (FANCY) v[e] = fmaxf(v[e] + bias, 0.0f);
          acc[mi][nt][e] = 0.0f;
        }
        if (layer + 1 < LAYERS) {
          *reinterpret_cast<__nv_bfloat162*>(act + r * LD + col) =
              __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(act + (r + 8) * LD + col) =
              __floats2bfloat162_rn(v[2], v[3]);
        } else if (col < OUT) {
          if (!FANCY) {  // h is bf16 in pure mode
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
          }
          if (row0 + r < P)
            *reinterpret_cast<float2*>(out + (row0 + r) * OUT + col) =
                make_float2(v[0], v[1]);
          if (row0 + r + 8 < P)
            *reinterpret_cast<float2*>(out + (row0 + r + 8) * OUT + col) =
                make_float2(v[2], v[3]);
        }
      }
  }
}

template <bool FANCY>
int launch(const void* x, const void* w0, const void* w, void* out,
           long long P, cudaStream_t stream) {
  auto kernel = chain_kernel<FANCY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (P + BM - 1) / BM;
  kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w), static_cast<float*>(out), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel I.  x (P, 128) f32, w0 (128, 256) and w (256, 256) bf16, out
// (P, 128) f32; all contiguous and 16-byte aligned on the stream's device.
int nerf_chain(const void* x, const void* w0, const void* w, void* out,
               long long P, int fancy, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return fancy ? launch<true>(x, w0, w, out, P, s)
               : launch<false>(x, w0, w, out, P, s);
}

}  // extern "C"
