// Warp-level bfloat16 tensor-core helpers shared by the bf16 kernels of
// flash_attention.cu and fused_xent.cu: the mma.sync m16n8k16 bf16 x bf16
// -> float32 product, fragment loads (32-bit pairs and ldmatrix .trans),
// round-to-nearest-even packing, reductions over the four lanes of a
// fragment row (a quad), and the 16-byte cp.async copy.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// c += a . b over one 16 x 8 x 16 tile; float32 accumulation of exact
// bf16 products.
__device__ __forceinline__ void MmaBf16(float c[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 values as one fragment register
__device__ __forceinline__ uint32_t Ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to nearest-even bf16; lo (the smaller column of a
// fragment) in the low half
__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix .x4 .trans: lane l addresses row (l & 7) of 8 x 8 matrix l >> 3
// and receives, of each matrix i, M_i[2 (l & 3)][l >> 2] and
// M_i[2 (l & 3) + 1][l >> 2]: the B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void LdMatrixX4T(uint32_t r[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ float QuadMax(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float QuadSum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes from global src to shared dst, asynchronously; !valid writes
// zeros and reads nothing.
__device__ __forceinline__ void CpAsyncBytes16(void* dst, const void* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

}  // namespace
