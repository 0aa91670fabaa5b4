// The tensor-core building blocks of the kernels on Hopper's mma.sync path
// (the 16-bit forward tile and kernels E-F and H): cp.async copies into
// shared memory, ldmatrix fragment loads and the m16n8k16 bf16 and fp16
// products with f32 sums.  bf16 and fp16 share the fragment layout and the
// dense rate; only the element type named in the instruction differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// the same with only the first src_bytes (0..16) read, the rest of the 16
// bytes zeroed; with src_bytes = 0 nothing is read
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8 j .. 8 j + 7 give the row addresses of
// matrix j, whose fragment lands in r[j]: lane t holds row t / 4, columns
// 2 (t % 4) and 2 (t % 4) + 1 (with .trans, the transposed matrix's)
// (any 16-bit element type: the matrices are moved as b16)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major fragment) . b (16 x 8, column-major fragment):
// lane t holds c rows t / 4 (c[0], c[1]) and t / 4 + 8 (c[2], c[3]), columns
// 2 (t % 4) and 2 (t % 4) + 1
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same product on fp16 operands
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the product in the element type T (__nv_bfloat16 or __half)
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

}  // namespace mma
