// Kernel I: the probe's chain of eight products of the NeRF MLP's shapes,
// x (P, 128) . W0 (128 x 256) . W (256 x 256) x 7, on Hopper's warpgroup
// tensor cores (wgmma) fed by TMA.  A measurement of the ceiling that the
// fused MLP kernels are held against, not a part of the model.
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
//
// Design.  A persistent grid, one CTA an SM, walks the rows 128 at a time.
// A CTA is three warpgroups: two consumers, each on its own 64 rows, and
// one producer warp.
//  * Products: wgmma.mma_async m64n256k16, bf16 in, f32 sums (128
//    accumulators a thread).  A comes from registers, B (the weights) from
//    shared memory through descriptors.  W is stored K x N row-major, which
//    is MN-major for B: the transpose bit takes it as it is.
//  * The activation never leaves the registers.  For a 16-bit type, the
//    m64nN accumulator's columns [16 k, 16 k + 16), rounded to bf16 in
//    pairs, are exactly the A fragment of k-step k (wgmma.cuh), so the
//    epilogue between two products is a bias, a ReLU and a conversion in
//    registers (64 A registers a thread); x's rows are read straight into
//    the first product's fragments, and the last product's first 128
//    columns go straight to out.
//  * The weights stream from L2 by TMA through a ring of STAGES stages of
//    64 weight rows (32 KB: four 64-column boxes with the 128-byte swizzle
//    that the descriptors name), W0's two stages and W's four for each of
//    the seven later products, across tiles without a break.  The
//    producer issues a stage once both consumers have released its slot
//    (an mbarrier each way, no CTA-wide barrier); each consumer waits for a
//    stage, issues its four k-steps, and releases the stage before once
//    those have retired (wgmma.wait_group 1), so one stage's products are
//    in flight while the next one lands.  setmaxnreg moves registers from
//    the producer (40) to the consumers (232).
//  * The two consumers share the tensor cores; when one is in its
//    epilogue or waits for x, the other's products run.
// What the stream costs: a 128-row tile does 128 FLOP for every weight byte
// it streams (960 KB a tile), so at the bound the card would read ~7.7 TB/s
// from L2, about what the L2 can give.  If the stream proves the limit, the
// lever is a 2-CTA cluster that multicasts each stage by TMA to both CTAs.
// Rows past P read zeros and are not stored.
#include <cuda_bf16.h>

#include "wgmma.cuh"

namespace {

constexpr int K0 = 128;   // x's columns, W0's rows
constexpr int N = 256;    // every product's width; W's rows
constexpr int OUT = 128;  // the columns of h kept in out
constexpr int BM = 128;   // rows a CTA step: two consumers of 64
constexpr int KS = 64;    // weight rows a stage
constexpr int BOX_COLS = 64;                    // one 128-byte swizzle atom
constexpr int BOX_BYTES = KS * BOX_COLS * 2;    // 8 KB, one TMA box
constexpr int STAGE_BYTES = KS * N * 2;         // 32 KB, four boxes
constexpr int STAGES = 6;
constexpr int STAGES_W0 = K0 / KS, STAGES_W = N / KS;
constexpr int STAGES_PER_TILE = STAGES_W0 + 7 * STAGES_W;  // 30
constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int CONSUMER_WARPS = 8;
// the ring, on the swizzle pattern's 1024-byte period
constexpr size_t SMEM = STAGES * STAGE_BYTES + 1024;
constexpr int ERR_ENCODE = 20000;  // + the CUresult of a failed encode

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Ring {
  uint32_t base;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One product of a consumer warpgroup: NS stages of 64 weight rows against
// the A fragments a[4 (4 s + kk) + r]; acc starts from zero.
template <int NS>
__device__ __forceinline__ void product(Ring& ring, const uint32_t (&a)[64],
                                        float (&acc)[128]) {
  const int lane = threadIdx.x & 31;
  int prev = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    wg::mbar_wait(&ring.full[ring.stage], ring.phase);
    const uint32_t stage_addr = ring.base + ring.stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < 128; ++i) wg::fence_operand(acc[i]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {a[16 * s + 4 * kk], a[16 * s + 4 * kk + 1],
                                a[16 * s + 4 * kk + 2],
                                a[16 * s + 4 * kk + 3]};
      // k-step kk: 16 weight rows, 2048 bytes into each box; the boxes
      // (64 columns each) BOX_BYTES apart, 8-row groups 1024 bytes apart
      const uint64_t desc =
          wg::desc_sw128(stage_addr + kk * 2048, BOX_BYTES, 1024);
      wg::mma_m64n256k16<1>(acc, frag, desc, s > 0 || kk > 0);
    }
    wg::commit();
#pragma unroll
    for (int i = 0; i < 128; ++i) wg::fence_operand(acc[i]);
    if (s > 0) {
      wg::wait<1>();  // the previous stage's products have retired
      if (lane == 0) wg::mbar_arrive(&ring.empty[prev]);
    }
    prev = ring.stage;
    ring.advance();
  }
  wg::wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) wg::fence_operand(acc[i]);
  if (lane == 0) wg::mbar_arrive(&ring.empty[prev]);
}

template <bool FANCY>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const __grid_constant__ CUtensorMap map_w0,
             const __grid_constant__ CUtensorMap map_w,
             const float* __restrict__ x, float* __restrict__ out,
             long long P, long long n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const uint32_t raw = wg::smem_addr(smem_raw);
  Ring ring{(raw + 1023) & ~1023u, full, empty};
  unsigned char* ring_ptr = smem_raw + (ring.base - raw);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 2) {
    // ---------------------------------------------------------- producer
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int c = 0; c < STAGES_PER_TILE; ++c) {
          wg::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
          wg::mbar_arrive_expect_tx(&ring.full[ring.stage], STAGE_BYTES);
          const bool first = c < STAGES_W0;
          const CUtensorMap* map = first ? &map_w0 : &map_w;
          const int row = (first ? c : (c - STAGES_W0) % STAGES_W) * KS;
          unsigned char* dst = ring_ptr + ring.stage * STAGE_BYTES;
#pragma unroll
          for (int b = 0; b < N / BOX_COLS; ++b)
            wg::tma_load_2d(dst + b * BOX_BYTES, map, &ring.full[ring.stage],
                            b * BOX_COLS, row);
          ring.advance();
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    wg::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int g = (t & 31) >> 2, q = t & 3;
    const int r16 = (t >> 5) * 16 + g;  // this thread's rows: r16, r16 + 8
    uint32_t a[64];
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long row0 = tile * BM + warpgroup * 64 + r16;
      // the next tile's rows of x (512 bytes each) into L2 while this one
      // runs: the four threads of a row pair take two 128-byte lines each
      const long long next = row0 + 8 * (q >> 1) + 1LL * gridDim.x * BM;
      if (next < P) {
        const float* line = x + next * K0 + (q & 1) * 64;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(line));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(line + 32));
      }
      // x's rows, rounded to bf16, as the first product's A fragments
#pragma unroll
      for (int k = 0; k < K0 / 16; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long row = row0 + 8 * (r & 1);
          float2 v = make_float2(0.0f, 0.0f);
          if (row < P)
            v = __ldg(reinterpret_cast<const float2*>(
                x + row * K0 + 16 * k + 8 * (r >> 1) + 2 * q));
          a[4 * k + r] = pack_bf16(v.x, v.y);
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) wg::fence_operand(a[i]);
#pragma unroll 1
      for (int layer = 0; layer < 8; ++layer) {
        if (layer == 0)
          product<STAGES_W0>(ring, a, acc);
        else
          product<STAGES_W>(ring, a, acc);
        const float bias = layer == 0 ? 0.0f : 0.1f;
        if (layer < 7) {
          // h, rounded to bf16, as the next product's A fragments
#pragma unroll
          for (int k = 0; k < 16; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float v0 = acc[8 * k + 2 * r], v1 = acc[8 * k + 2 * r + 1];
              if (FANCY) {  // ReLU keeping NaN, as jnp.maximum does
                v0 += bias;
                v1 += bias;
                v0 = v0 < 0.0f ? 0.0f : v0;
                v1 = v1 < 0.0f ? 0.0f : v1;
              }
              a[4 * k + r] = pack_bf16(v0, v1);
            }
#pragma unroll
          for (int i = 0; i < 64; ++i) wg::fence_operand(a[i]);
        } else {
#pragma unroll
          for (int j = 0; j < OUT / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
              if (FANCY) {
                v0 += bias;
                v1 += bias;
                v0 = v0 < 0.0f ? 0.0f : v0;
                v1 = v1 < 0.0f ? 0.0f : v1;
              } else {  // h is bf16 in pure mode
                v0 = __bfloat162float(__float2bfloat16_rn(v0));
                v1 = __bfloat162float(__float2bfloat16_rn(v1));
              }
              const long long row = row0 + 8 * h;
              if (row < P)
                *reinterpret_cast<float2*>(out + row * OUT + 8 * j + 2 * q) =
                    make_float2(v0, v1);
            }
        }
      }
    }
  }
}

template <bool FANCY>
int launch(const void* x, const void* w0, const void* w, void* out,
           long long P, cudaStream_t stream) {
  CUtensorMap map_w0, map_w;
  int err = wg::encode_bf16_sw128(&map_w0, w0, K0, N, KS, BOX_COLS);
  if (!err) err = wg::encode_bf16_sw128(&map_w, w, N, N, KS, BOX_COLS);
  if (err) return ERR_ENCODE + err;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = chain_kernel<FANCY>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_tiles = (P + BM - 1) / BM;
  const long long grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(
      map_w0, map_w, static_cast<const float*>(x), static_cast<float*>(out),
      P, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  if (err >= ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused the weights' tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel I.  x (P, 128) f32, w0 (128, 256) and w (256, 256) bf16, out
// (P, 128) f32; all contiguous and 16-byte aligned on the stream's device
// (TMA reads the weights: 16-byte base and row pitch).
int nerf_chain(const void* x, const void* w0, const void* w, void* out,
               long long P, int fancy, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return fancy ? launch<true>(x, w0, w, out, P, s)
               : launch<false>(x, w0, w, out, P, s);
}

}  // extern "C"
