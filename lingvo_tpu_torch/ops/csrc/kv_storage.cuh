// The storage formats of the KV pools and caches that the attention
// kernels read (ragged_block_attend.cu, block_decode.cu, flash_decode.cu),
// in one place. `kRoundsP` says whether a format rounds p (bfloat16 only).
//
// Every kernel is a template on the storage type T and reads K and V only
// through `Kv<T>`, which returns float32; everything after the load is
// the float32 code.
//  - float32: read as is.
//  - bfloat16 (`kv_cache_dtype='bfloat16'`): widened on load. Each
//    probability is rounded to bfloat16 before P.V (`RoundP`), as the
//    reference rounds p to the page's dtype (`p.astype(v_page.dtype)`);
//    the running sum l takes the unrounded p.
//  - int8 (`kv_cache_dtype='int8'`), with float32 scale sidecars
//    [NP, N, P]: each element is dequantized on load as
//    __fmul_rn(float(x), scale), the reference `_DequantPages`.
//    __fmul_rn is never contracted into the q.k or p.v FMA that follows,
//    so the int8 instantiation equals the float32 one on the
//    pre-dequantized pool bit for bit. `Scale` reads a slot's scale; a
//    kernel calls it only for a slot it reads (dead scales may hold NaN).
// The codes of `KvDtype` are the Python wrappers'
// (ragged_block_attend.KV_DTYPES). The query and output type is a second
// template parameter of each kernel (`Act<Q>`, below).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

enum KvDtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T>
struct Kv;

template <>
struct Kv<float> {
  static constexpr bool kRoundsP = false;  // RoundP is the identity
  __device__ static float Scale(const float*, size_t) { return 0.f; }
  // values 4i .. 4i + 3 of a row
  __device__ static float4 Load4(const float* row, int i, float) {
    return reinterpret_cast<const float4*>(row)[i];
  }
  __device__ static float Load(const float* row, int h, float) {
    return row[h];
  }
  __device__ static float RoundP(float p) { return p; }
};

template <>
struct Kv<__nv_bfloat16> {
  static constexpr bool kRoundsP = true;
  __device__ static float Scale(const float*, size_t) { return 0.f; }
  __device__ static float4 Load4(const __nv_bfloat16* row, int i, float) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[i];
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static float Load(const __nv_bfloat16* row, int h, float) {
    return __bfloat162float(row[h]);
  }
  __device__ static float RoundP(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
};

template <>
struct Kv<int8_t> {
  static constexpr bool kRoundsP = false;
  __device__ static float Scale(const float* scales, size_t at) {
    return scales[at];
  }
  __device__ static float4 Load4(const int8_t* row, int i, float sc) {
    const char4 c = reinterpret_cast<const char4*>(row)[i];
    return make_float4(__fmul_rn(static_cast<float>(c.x), sc),
                       __fmul_rn(static_cast<float>(c.y), sc),
                       __fmul_rn(static_cast<float>(c.z), sc),
                       __fmul_rn(static_cast<float>(c.w), sc));
  }
  __device__ static float Load(const int8_t* row, int h, float sc) {
    return __fmul_rn(static_cast<float>(row[h]), sc);
  }
  __device__ static float RoundP(float p) { return p; }
};

// The type of q and of the output (`Act<Q>`; the codes of `ActDtype` are
// the Python wrappers' `ragged_block_attend.Q_DTYPES`): float32, or
// bfloat16 under fprop_dtype=bfloat16. A bfloat16 q is widened on load,
// which is exact, so the scores are those of the float32 kernel on the
// widened q (the reference's `_DotF32` multiplies the same float32
// values). The output is rounded to bfloat16 once, to nearest even, after
// the float32 division acc / max(l, 1e-20): the reference's
// `_Finish(l, acc, q.dtype)`. Everything in between is the float32 code,
// so a bfloat16-q kernel equals the float32-q kernel on the widened q with
// its output rounded to bfloat16, bit for bit. Rows of q and out are
// 4-element aligned (H a multiple of 4): 16 bytes for float32, 8 for
// bfloat16.
enum ActDtype { kActF32 = 0, kActBF16 = 1 };

template <typename Q>
struct Act;

template <>
struct Act<float> {
  __device__ static float4 Load4(const float* row, int i) {
    return reinterpret_cast<const float4*>(row)[i];
  }
  __device__ static float Load(const float* row, int i) { return row[i]; }
  __device__ static void Store4(float* row, int i, float4 v) {
    reinterpret_cast<float4*>(row)[i] = v;
  }
  __device__ static void Store(float* row, int i, float v) { row[i] = v; }
};

template <>
struct Act<__nv_bfloat16> {
  __device__ static float4 Load4(const __nv_bfloat16* row, int i) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[i];
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static float Load(const __nv_bfloat16* row, int i) {
    return __bfloat162float(row[i]);
  }
  __device__ static void Store4(__nv_bfloat16* row, int i, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    reinterpret_cast<uint2*>(row)[i] = raw;
  }
  __device__ static void Store(__nv_bfloat16* row, int i, float v) {
    row[i] = __float2bfloat16_rn(v);
  }
};
