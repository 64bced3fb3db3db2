// Seeded temperature / top-k sampling on Hopper: one token per row of
// logits, drawn as the argmax of the scaled, masked logits plus threefry
// Gumbel noise, with JAX's bits.
//
// Replaces no pallas_call. The reference draws its tokens with
// jax.random.categorical (lingvo_tpu/core/sampling.py:34 SampleFromLogits),
// which XLA lowers to threefry2x32 bits, a uniform, -log(-log(u)), an add
// and an argmax. No PyTorch call draws JAX's threefry noise, so the port's
// streams can follow the reference's only through a kernel of its own.
//
// Row r of logits [R, V] float32:
//   key   = the base key folded in order with fold[r, 0..F-1]
//           (fold_in(key, d) = threefry2x32(key, (0, d)); F = 1 or 2);
//   bits  = b0 ^ b1 of threefry2x32(key, (0, c)) for column c (each row
//           its own stream, the reference's vmapped rows);
//   u     = ((bits >> 9) | 0x3f800000 as float) - 1, + tiny, floored at
//           tiny;
//   g     = -logf(-logf(u)), the accurate libdevice logf (no fast math);
//   z     = x * inv_t rounded (the reciprocal product that XLA makes of
//           the reference's logits / temperature), -inf where it is below
//           thr[r] (top-k; null = no mask), then g + z, every operation
//           rounded on its own (__fmul_rn / __fadd_rn: no contraction);
//   token = argmax of z over c, the lowest column on ties.
// One block of 256 threads a row; a thread takes columns tid, tid + 256,
// ... (coalesced loads) and keeps its best (z, c); warp shuffles, then one
// warp over the 8 warps' bests, reduce them. One launch a call.
//
// What bounds it: the integer work. Each element costs about 75 int32
// operations of threefry (20 rounds of add, funnel-shift rotate and xor,
// the key injections, the uniform's mantissa) against 4 bytes of logits,
// far beyond the card's balance of operations to bytes. The 43 rotates,
// xors and shifts run only on the ALU pipe (64 lanes an SM a clock); the
// adds can issue as IMAD on the FMA pipe beside them; and every
// instruction, the two logf's included, is issued at 128 lanes an SM a
// clock. A simple kernel first: the work is spread over every element
// with no shared state, which is all this bound asks of it.
//
// Plain C interface, loaded with ctypes by ops/sample_tokens.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;   // float32's smallest normal

__device__ __forceinline__ void Round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32 with 20 rounds: five groups of four, the key words
// injected after each group.
__device__ __forceinline__ uint2 Threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  Round(x0, x1, 17); Round(x0, x1, 29); Round(x0, x1, 16); Round(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  Round(x0, x1, 17); Round(x0, x1, 29); Round(x0, x1, 16); Round(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// (z, c) beats (best, arg): a larger z, or an equal z at a lower column.
__device__ __forceinline__ void Better(float z, int c, float& best,
                                       int& arg) {
  if (z > best || (z == best && c < arg)) {
    best = z;
    arg = c;
  }
}

__device__ __forceinline__ void WarpArgmax(float& best, int& arg) {
  for (int o = 16; o > 0; o >>= 1) {
    const float z = __shfl_xor_sync(~0u, best, o);
    const int c = __shfl_xor_sync(~0u, arg, o);
    Better(z, c, best, arg);
  }
}

__global__ void __launch_bounds__(kThreads) SampleTokensKernel(
    const float* __restrict__ logits, const int* __restrict__ fold, int f,
    const float* __restrict__ thr, uint32_t key0, uint32_t key1,
    float inv_t, int v, int* __restrict__ tokens,
    float* __restrict__ zmax) {
  __shared__ float s_best[kWarps];
  __shared__ int s_arg[kWarps];
  const int r = blockIdx.x;
  uint32_t k0 = key0, k1 = key1;
  for (int j = 0; j < f; ++j) {
    const uint2 y = Threefry(k0, k1, 0u, static_cast<uint32_t>(
        __ldg(fold + static_cast<long long>(r) * f + j)));
    k0 = y.x;
    k1 = y.y;
  }
  const float t = thr != nullptr ? __ldg(thr + r) : -INFINITY;
  const float* row = logits + static_cast<long long>(r) * v;
  float best = -INFINITY;
  int arg = v;   // no column yet: any column beats it, even at -inf
  for (int c = threadIdx.x; c < v; c += kThreads) {
    const uint2 y = Threefry(k0, k1, 0u, static_cast<uint32_t>(c));
    const uint32_t bits = y.x ^ y.y;
    const float m = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
    const float u = fmaxf(__fadd_rn(m, kTiny), kTiny);
    const float g = -logf(-logf(u));
    float z = __fmul_rn(__ldg(row + c), inv_t);
    if (z < t) z = -INFINITY;
    Better(__fadd_rn(g, z), c, best, arg);
  }
  WarpArgmax(best, arg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_best[warp] = best;
    s_arg[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_best[lane] : -INFINITY;
    arg = lane < kWarps ? s_arg[lane] : v;
    WarpArgmax(best, arg);
    if (lane == 0) {
      tokens[r] = arg < v ? arg : 0;
      zmax[r] = best;
    }
  }
}

}  // namespace

extern "C" {

// On `stream`: logits [r, v] float32 (rows contiguous), fold [r, f] int32
// (f = 1 or 2), thr [r] float32 or null, the base
// key (key0, key1), inv_t the float32 reciprocal of the temperature ->
// tokens [r] int32 and zmax [r] float32 (the winning perturbed value).
// One launch. Returns the cudaError_t of the launch (0 = ok).
int SampleTokens(const float* logits, const int* fold, int f,
                 const float* thr, unsigned key0, unsigned key1, float inv_t,
                 int r, int v, int* tokens, float* zmax, void* stream) {
  if (r <= 0 || v <= 0 || f < 1 || f > 2 || fold == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SampleTokensKernel<<<r, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, fold, f, thr, key0, key1, inv_t, v, tokens, zmax);
  return static_cast<int>(cudaGetLastError());
}

const char* SampleTokensErrorString(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
