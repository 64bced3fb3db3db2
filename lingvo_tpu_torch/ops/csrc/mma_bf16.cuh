// bfloat16 fragment helpers shared by the wgmma kernels of
// flash_attention.cu and fused_xent.cu: round-to-nearest-even packing of
// two floats into one fragment register, and reductions over the four
// lanes of an accumulator row (a quad).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// two floats rounded to nearest-even bf16; lo (the smaller column of a
// fragment) in the low half
__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float QuadMax(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float QuadSum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
