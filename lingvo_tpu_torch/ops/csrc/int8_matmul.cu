// The int8-serving matmul on Hopper: y = (float(int8(x) . w8) * x_scale) *
// w_scale[n], the integer product of `Int8Einsum`.
//
// Replaces no pallas_call. The reference computes this product with an XLA
// dot_general with preferred_element_type=int32
// (lingvo_tpu/core/quant_utils.py:265 `Int8Einsum`), which the TPU runs on
// its matrix unit. On CUDA no PyTorch call computes it: torch.matmul has no
// integer kernel there, torch._int_mm refuses M <= 16 (every decode step)
// and neither applies the two-scale epilogue. So two hand kernels, each one
// counted launch a call:
//
// (a) Int8QuantizeKernel, the activation pre-pass. x [M, K] float32 ->
//     x_scale = max(amax(|x|) * float32(1 / 127), 1e-8) over the WHOLE x of
//     the call (the reference's amax / 127.0 as XLA compiles it inside the
//     jitted step: a product with the constant's float32 reciprocal), and
//     x8 [M, Kp] int8 = clip(rint(x / x_scale), -128, 127) with a true
//     (IEEE) division and round half to even, rows padded with zeros to Kp
//     = K rounded up to 16 bytes.
// (b) Int8GemmKernel, the product and its epilogue: int32 sums of x8 . w^T
//     (w [N, K] int8, K-major, the copy the serving theta keeps), then two
//     separate float32 multiplies in the reference's order, float(acc) *
//     x_scale, then * w_scale[n].
//
// What bounds them. At the serving shapes (M = 8 decode rows, M = 264
// packed tokens, K and N 2048 to 32000) (b) is bound by the weight's bytes,
// 1 a value; its 2 M K N operations sit far under the int8 tensor cores'
// 1979 TOP/s. (a) moves kilobytes to a few megabytes, so it is bound by
// latency: launch, one read of x, and the one max over the whole x that
// every quantized value waits for.
//
// What the design does about it.
// - (a) is one block, or one thread-block cluster of up to 16 blocks (8
//   where the card cannot place 16), sized to x (the host's
//   `QuantizePlan`): each block takes whole rows and reads them with 8
//   16-byte loads a thread in flight, keeping them in its shared memory
//   where they all fit; each block sends its max to every block of the
//   cluster by st.async (counted on the receiver's mbarrier), and each
//   quantizes what it holds without reading it again from device memory.
//   Rows that do not fit are read twice (from L2 where x fits it). The
//   quotient is the product with the scale's reciprocal, and the true
//   division where that product lies next to a half-integer (Quantize16):
//   the same bits. No grid barrier, no scratch. A cluster has at most 16
//   SMs, so a large x (264 x 8192) is read at what 16 SMs pull, not at the
//   card's rate: the price of having no grid barrier (PERF.md).
// - (b) streams the weight by TMA in 128-byte K stages (128-byte swizzle)
//   through a ring of 3 to 6 stages fed by a producer warp, and multiplies
//   on the tensor cores with wgmma.mma_async m64nNk32 s32.s8.s8, both
//   operands K-major. For M <= 64 the operands swap: the weight tile is the
//   64-row A operand and x8 the n-wide B operand (n = M rounded up to 8, 16,
//   32 or 64), so a decode step's 8 rows cost no 64-row tile; for larger M,
//   128 rows of x8 (two consumer warpgroups) times 128 rows of the weight,
//   the m tiles that share a weight tile launched side by side so the
//   weight comes from device memory once. Where the tiles alone would leave
//   the card idle, K is split over the blocks of a cluster (at most 8); the
//   splits write their int32 tiles into their own shared memory and each
//   block sums a share of the rows across the cluster's tiles in rank order
//   through distributed shared memory, then applies the epilogue: no global
//   partials, no tile counters, no memset. int32 sums are exact, so any
//   split gives the same bits. (b) is launched as a programmatic dependent
//   of (a): it issues its first weight stages before griddepcontrol.wait
//   and reads x8 and x_scale only after it, so the weight stream overlaps
//   (a). A weight whose rows are not a multiple of 16 bytes (TMA needs
//   16-byte strides) is copied into the same swizzled stages by the
//   producer warp's loads instead.
//
// Under fprop_dtype=bfloat16 x and y are bfloat16 (the reference
// quantizes x.astype(float32) and returns y.astype(x.dtype)): (a) has an
// instantiation that widens bfloat16 x on load (exact) and (b) one whose
// epilogue rounds y to bfloat16, to nearest even, after the two float32
// multiplies; the weight scales stay float32 tensors, the bfloat16-rounded
// scales widened exactly once by the wrapper. Nothing else changes with
// them, so the bits are those of the float32 kernels on the widened x,
// rounded.
//
// Plain C interface, loaded with ctypes by ops/int8_matmul.py, whose
// `QuantizePlan` and `GemmPlan` choose each launch from the shape alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kKB = 128;                // K bytes of a GEMM stage

// -- (a) the quantize pre-pass --

constexpr int kQThreads = 1024;
constexpr int kQUnroll = 8;             // 16-byte loads a thread has in flight
constexpr int kQMaxCluster = 16;        // with the non-portable size allowed
constexpr int kQHeader = 256;           // an mbarrier, scratch, the maxima
constexpr int kQHoldBytes = 224 << 10;  // x a block holds in shared memory

template <int kBlock>
__device__ __forceinline__ float BlockMax(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kBlock / 32 ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// clip(rint(v / scale), -128, 127) for 16 values, with the true (IEEE)
// quotient rounded half to even, given inv = RN(1 / scale). |v| <= amax and
// scale >= amax * RN(1 / 127) rounded, so |v / scale| < 127 (1 + 2^-22):
// rint is within [-127, 127] and the clip never binds.
// The product q = RN(v * inv) is within 2^-22.9 |v / scale| < 2^-15.9 of
// the quotient, and RN(v / scale) within 2^-17 of it: where q lies farther
// than 2^-14 from every half-integer the two round to the same integer.
// Next to one (about 1 value in 8000, and every exact tie) the 16 values
// take the true division. rint is RN(q + 1.5 2^23) - 1.5 2^23 (exact, half
// to even, for |q| < 2^22), on the FMA pipe rather than the conversion
// unit's quarter rate.
__device__ __forceinline__ void Quantize16(const float (&v)[16], float scale,
                                           float inv, int8_t (&out)[16]) {
  constexpr float kMagic = 0x1.8p23f;
  float q[16];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    q[j] = __fmul_rn(v[j], inv);
    const float r = __fsub_rn(__fadd_rn(q[j], kMagic), kMagic);
    near |= fabsf(__fsub_rn(q[j], r)) > 0.5f - 0x1p-14f;
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 16; ++j) q[j] = __fdiv_rn(v[j], scale);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)   // in [-127, 127]: the clip never binds
    out[j] = static_cast<int8_t>(__float_as_int(__fadd_rn(q[j], kMagic)) -
                                 0x4B400000);
}

// x of type X, float32 or bfloat16, widened to float32. The pointers may be
// global or shared (generic loads).
__device__ __forceinline__ float ToF(float v) { return v; }
__device__ __forceinline__ float ToF(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The largest |v| of 16 bytes of x.
template <typename X>
__device__ __forceinline__ float AbsMax16(uint4 raw);
template <>
__device__ __forceinline__ float AbsMax16<float>(uint4 raw) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(raw.x)),
                     fabsf(__uint_as_float(raw.y))),
               fmaxf(fabsf(__uint_as_float(raw.z)),
                     fabsf(__uint_as_float(raw.w))));
}
template <>
__device__ __forceinline__ float AbsMax16<__nv_bfloat16>(uint4 raw) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

// 16 values at p (aligned to 16 of them) widened to float32.
__device__ __forceinline__ void Load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void Load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[j]));
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint32_t Pack4(const int8_t (&q)[16], int i) {
  return static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i])) |
         static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[4 * i + 3])) << 24;
}

// One cluster of gridDim.x blocks (or one block): block `rank` takes rows
// [rank * rows, (rank + 1) * rows) of x and keeps the first `held` of them
// in shared memory as it reads them, kQUnroll 16-byte loads a thread in
// flight (a row of a whole number of 16-byte vectors; else every value
// alone). Each block folds the max of its rows, sends it to every block of
// the cluster, and quantizes its rows into x8, 16 columns (one 16-byte
// store) a thread at a time: the held rows from shared memory, the rest
// read again.
template <typename X>
__global__ void __launch_bounds__(kQThreads) Int8QuantizeKernel(
    const X* __restrict__ x, int8_t* __restrict__ x8,
    float* __restrict__ x_scale, int m, int k, int kp, int rows, int held_rows,
    int vec16) {
  GridDepLaunch();   // (b) may start streaming its weight now
  extern __shared__ __align__(16) unsigned char qsmem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(qsmem);          // the maxima in
  float* red = reinterpret_cast<float*>(qsmem + 16);           // [32]
  float* maxima = red + 32;                                    // [blocks]
  X* hx = reinterpret_cast<X*>(qsmem + kQHeader);
  constexpr int kV = 16 / sizeof(X);   // values in 16 bytes
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = blockIdx.x, blocks = gridDim.x;
  const int r0 = rank * rows;
  const int nrows = min(m, r0 + rows) - r0;
  const int held = min(held_rows, nrows);
  const long long hn = static_cast<long long>(held) * k;   // held values
  const long long all = static_cast<long long>(nrows) * k;
  const X* src = x + static_cast<long long>(r0) * k;
  if (blocks > 1) {   // every block's max arrives here by st.async
    if (tid == 0) {
      MbarInit(bar, 1);
      MbarArriveExpectTx(bar, 4 * blocks);
      MbarInitFence();
    }
    ClusterArriveRelaxed();   // 1: this block's barrier is set
  }

  float amax = 0.f;
  if (vec16) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
    uint4* h = reinterpret_cast<uint4*>(hx);
    const int nv = static_cast<int>(all / kV), hv = static_cast<int>(hn / kV);
    for (int v = tid; v < nv; v += kQThreads * kQUnroll) {
      uint4 r[kQUnroll];
#pragma unroll
      for (int u = 0; u < kQUnroll; ++u)
        if (v + u * kQThreads < nv) r[u] = __ldg(p + v + u * kQThreads);
#pragma unroll
      for (int u = 0; u < kQUnroll; ++u) {
        const int i = v + u * kQThreads;
        if (i < nv) {
          if (i < hv) h[i] = r[u];
          amax = fmaxf(amax, AbsMax16<X>(r[u]));
        }
      }
    }
  } else {
    for (long long i = tid; i < all; i += kQThreads) {
      const X v = src[i];
      if (i < hn) hx[i] = v;
      amax = fmaxf(amax, fabsf(ToF(v)));
    }
  }
  amax = BlockMax<kQThreads>(amax, red);   // its barrier: hx is whole
  float g = amax;
  if (blocks > 1) {
    ClusterWait();   // 1: every block's barrier is set
    if (tid < blocks)   // this block's max into slot `rank` of block tid
      StAsyncF(MapShared(maxima + rank, tid), amax, MapShared(bar, tid));
    MbarWaitCluster(bar, 0);
    g = lane < blocks ? maxima[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) g = fmaxf(g, __shfl_xor_sync(~0u, g, o));
    ClusterArriveRelaxed();   // 2: every max this block sent has landed
  }
  // the reference's amax / 127.0 as XLA compiles it in the jitted step: a
  // product with the float32 reciprocal of 127
  const float scale = fmaxf(__fmul_rn(g, 0x1.020408p-7f), 1e-8f);
  const float inv = __frcp_rn(scale);
  if (rank == 0 && tid == 0) *x_scale = scale;

  // (row, 16-column group) units, kQThreads apart, walked without division
  const int groups = kp / 16;
  const int step_rows = kQThreads / groups, step_groups = kQThreads % groups;
  const bool fast = (k & 15) == 0;   // 16 columns at a time, all below k
  int rr = tid / groups, grp = tid % groups;
  for (; rr < nrows; rr += step_rows, grp += step_groups) {
    if (grp >= groups) {
      grp -= groups;
      if (++rr >= nrows) break;
    }
    const int col = grp * 16;
    float v[16];
    if (fast) {
      if (rr < held)
        Load16(hx + static_cast<long long>(rr) * k + col, v);
      else
        Load16(src + static_cast<long long>(rr) * k + col, v);
    } else {   // zeros past k quantize to zeros
      const X* row = (rr < held ? hx : src) + static_cast<long long>(rr) * k;
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = col + j < k ? ToF(row[col + j]) : 0.f;
    }
    int8_t q[16];
    Quantize16(v, scale, inv, q);
    *reinterpret_cast<uint4*>(x8 + static_cast<long long>(r0 + rr) * kp +
                              col) =
        make_uint4(Pack4(q, 0), Pack4(q, 1), Pack4(q, 2), Pack4(q, 3));
  }
  if (blocks > 1) ClusterWait();   // 2: no block leaves while a max flies
}

// -- (b) the GEMM --

// A block's configuration. Normal orientation (kSwap false): A = 128 rows
// of x8 (two consumer warpgroups of 64), B = kNB = 128 rows of the weight.
// Swapped (M <= 64): A = 64 rows of the weight (one consumer warpgroup), B
// = kNB rows of x8, kNB in {8, 16, 32, 64}. A producer warp after the
// consumers. Mirrored by ops/int8_matmul.py `_GemmConfig`.
template <bool kSwap, int kNB>
struct GemmCfg {
  static constexpr int kWG = kSwap ? 1 : 2;
  static constexpr int kARows = 64 * kWG;
  static constexpr int kStages = kSwap ? 6 : 3;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kABytes = kARows * kKB;
  static constexpr int kStage = kABytes + kNB * kKB;
  static constexpr int kRing = kStages * kStage;
  // the output tile in y's orientation, and its int32 row in shared memory
  // (padded so the accumulators' stores hit distinct banks)
  static constexpr int kTileM = kSwap ? kNB : kARows;
  static constexpr int kTileN = kSwap ? kARows : kNB;
  static constexpr int kStride = kTileN + (kSwap ? 4 : 8);
  static constexpr int kSmem = 1024 + kRing + 2 * kStages * 8;
  // blocks an SM holds by shared memory (232448 + 1024 bytes an SM, 1024
  // kept per block), which the registers must allow too
  static constexpr int kPerSm = 233472 / (kSmem + 1024) < 2048 / kThreads
                                    ? 233472 / (kSmem + 1024)
                                    : 2048 / kThreads;
  static_assert(kTileM * kStride * 4 <= kRing, "the tile fits in the ring");
  static_assert(kStage % 1024 == 0 && kABytes % 1024 == 0,
                "stages keep the 1024-byte swizzle alignment");
};

struct GemmArgs {
  const int8_t* w;         // [n, k], read directly when w_tma == 0
  const float* x_scale;
  const float* w_scale;
  void* y;
  int m, k, n;
  int m_tiles;             // tiles along y's rows (1 when swapped)
  int cluster;             // K splits of a tile: the cluster's blocks
  int kblocks;             // 128-byte K blocks in all
  int kb_per_split;
  int w_tma;               // the weight's tensor map is valid
};

// One kRows x 128-byte weight box at (row0, col0) into dst in TMA's 128-byte
// swizzle (chunk c of row r at chunk c ^ (r % 8)), zeros past n and k: the
// producer warp's path for a weight whose rows are not a multiple of 16
// bytes.
template <int kRows>
__device__ __forceinline__ void CopyWeightBox(unsigned char* dst,
                                              const int8_t* __restrict__ w,
                                              int n, int k, int row0,
                                              int col0, int lane) {
  for (int p = lane; p < kRows * 8; p += 32) {
    const int r = p >> 3, c = p & 7;
    const bool live = row0 + r < n;
    const int8_t* src = w + static_cast<long long>(row0 + r) * k;
    uint32_t words[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + 16 * c + 4 * j + b;
        const uint32_t byte =
            live && col < k ? static_cast<uint8_t>(src[col]) : 0u;
        word |= byte << (8 * b);
      }
      words[j] = word;
    }
    *reinterpret_cast<uint4*>(dst + r * kKB + ((c ^ (r & 7)) << 4)) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

__device__ __forceinline__ void StoreY(float* p, float v) { *p = v; }
__device__ __forceinline__ void StoreY(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void StoreY4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void StoreY4(__nv_bfloat16* p,
                                        const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&a),
      *reinterpret_cast<const uint32_t*>(&b));
}

// grid: cluster x tiles blocks, clusters of `cluster` along x. Block b is
// split b % cluster of tile b / cluster; tile t is m tile t % m_tiles of n
// tile t / m_tiles (the m tiles that share a weight tile side by side).
template <bool kSwap, int kNB, typename Y>
__global__ void __launch_bounds__(GemmCfg<kSwap, kNB>::kThreads,
                                  GemmCfg<kSwap, kNB>::kPerSm)
    Int8GemmKernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const GemmArgs a) {
  using C = GemmCfg<kSwap, kNB>;
  // x8's and the weight's places in a stage, and their boxes' bytes
  constexpr int kXOff = kSwap ? C::kABytes : 0;
  constexpr int kWOff = kSwap ? 0 : C::kABytes;
  constexpr int kWRows = kSwap ? C::kARows : kNB;
  constexpr uint32_t kXBytes = (kSwap ? kNB : C::kARows) * kKB;
  constexpr uint32_t kWBytes = kWRows * kKB;
  extern __shared__ __align__(16) unsigned char gsmem[];
  unsigned char* sm = gsmem + ((1024 - (SmemAddr(gsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kRing);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % a.cluster;
  const int tile = blockIdx.x / a.cluster;
  const int m0 = (tile % a.m_tiles) * C::kTileM;
  const int n0 = (tile / a.m_tiles) * C::kTileN;
  const int kb0 = split * a.kb_per_split;
  const int nkb = min(a.kblocks - kb0, a.kb_per_split);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      MbarInit(&full[s], 1);
      MbarInit(&empty[s], C::kWG * 4);   // one arrival a consumer warp
    }
    MbarInitFence();
  }
  __syncthreads();

  int acc[kNB / 2];
#pragma unroll
  for (int i = 0; i < kNB / 2; ++i) acc[i] = 0;   // overwritten (scale_d 0)

  if (warp == C::kWG * 4) {   // the producer warp
    const void* xmap = &tm_x;
    const void* wmap = &tm_w;
    if (lane == 0) {
      PrefetchTensorMap(xmap);
      if (a.w_tma) PrefetchTensorMap(wmap);
    }
    // a stage's weight box (by TMA, or the warp's loads), then its x8 box
    const auto weight = [&](int i, uint32_t extra) {
      unsigned char* st = sm + (i % C::kStages) * C::kStage;
      uint64_t* bar = &full[i % C::kStages];
      if (a.w_tma) {
        if (lane == 0) {
          MbarArriveExpectTx(bar, kWBytes + extra);
          TmaLoad2(st + kWOff, wmap, bar, (kb0 + i) * kKB, n0);
        }
      } else {
        CopyWeightBox<kWRows>(st + kWOff, a.w, a.n, a.k, n0,
                              (kb0 + i) * kKB, lane);
        FenceProxyAsync();   // the wgmma reads them through the async proxy
        __syncwarp();
        if (lane == 0) MbarArriveExpectTx(bar, extra);
      }
    };
    const auto xbox = [&](int i) {
      if (lane == 0)
        TmaLoad2(sm + (i % C::kStages) * C::kStage + kXOff, xmap,
                 &full[i % C::kStages], (kb0 + i) * kKB, m0);
    };
    const int pre = min(nkb, C::kStages);
    for (int i = 0; i < pre; ++i) weight(i, kXBytes);
    GridDepWait();   // x8 is the previous grid's output
    for (int i = 0; i < pre; ++i) xbox(i);
    for (int i = pre; i < nkb; ++i) {
      MbarWait(&empty[i % C::kStages], ((i / C::kStages) & 1) ^ 1);
      weight(i, kXBytes);
      xbox(i);
    }
  } else {   // a consumer warpgroup: A rows 64 wg .. 64 wg + 63
    const int wg = warp >> 2;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % C::kStages;
      MbarWait(&full[s], (i / C::kStages) & 1);
      const unsigned char* st = sm + s * C::kStage;
      WgmmaFence();
#pragma unroll
      for (int kk = 0; kk < kKB / 32; ++kk)
        WgmmaS8(acc, SwizzledDesc(st + wg * 64 * kKB + 32 * kk, 16, 1024),
                SwizzledDesc(st + C::kABytes + 32 * kk, 16, 1024),
                i > 0 || kk > 0);
      WgmmaCommit();
      WgmmaWait<1>();   // the previous stage's products are done
      if (i > 0) {
        __syncwarp();
        if (lane == 0) MbarArrive(&empty[(i - 1) % C::kStages]);
      }
    }
    WgmmaWait<0>();
    FenceRegs(acc);
  }

  // the int32 tile, in y's orientation, over the consumed ring
  __syncthreads();
  int* tl = reinterpret_cast<int*>(sm);
  if (warp < C::kWG * 4) {
    const int r = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kNB / 8; ++j) {
      if (kSwap) {   // accumulator rows: weight rows (y columns)
        tl[(8 * j + c) * C::kStride + r] = acc[4 * j];
        tl[(8 * j + c + 1) * C::kStride + r] = acc[4 * j + 1];
        tl[(8 * j + c) * C::kStride + r + 8] = acc[4 * j + 2];
        tl[(8 * j + c + 1) * C::kStride + r + 8] = acc[4 * j + 3];
      } else {
        *reinterpret_cast<int2*>(tl + r * C::kStride + 8 * j + c) =
            make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(tl + (r + 8) * C::kStride + 8 * j + c) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  const bool cluster = a.cluster > 1;
  if (cluster) {
    ClusterArrive();
    ClusterWait();   // every split's tile is written
  } else {
    __syncthreads();
  }
  GridDepWait();   // x_scale is the previous grid's output
  const float xs = *a.x_scale;
  // this split's share of the tile's rows: the splits' sums in rank order,
  // then the epilogue, 4 columns a thread
  const int per = (C::kTileM + a.cluster - 1) / a.cluster;
  const int t0 = split * per, t1 = min(C::kTileM, t0 + per);
  constexpr int kQuads = C::kTileN / 4;
  const bool vec = (a.n & 3) == 0;
  Y* y = static_cast<Y*>(a.y);
  for (int e = tid; e < (t1 - t0) * kQuads; e += C::kThreads) {
    const int row = t0 + e / kQuads, c4 = (e % kQuads) * 4;
    const int gm = m0 + row, gn = n0 + c4;
    if (gm >= a.m || gn >= a.n) continue;
    const int* p = tl + row * C::kStride + c4;
    int sum[4] = {0, 0, 0, 0};
    if (cluster) {
      for (int q = 0; q < a.cluster; ++q) {
        const int4 v = LdSharedCluster4(MapShared(p, q));
        sum[0] += v.x;
        sum[1] += v.y;
        sum[2] += v.z;
        sum[3] += v.w;
      }
    } else {
      const int4 v = *reinterpret_cast<const int4*>(p);
      sum[0] = v.x;
      sum[1] = v.y;
      sum[2] = v.z;
      sum[3] = v.w;
    }
    const int live = min(4, a.n - gn);
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = j < live ? __fmul_rn(__fmul_rn(__int2float_rn(sum[j]), xs),
                                    a.w_scale[gn + j])
                        : 0.f;
    Y* dst = y + static_cast<long long>(gm) * a.n + gn;
    if (vec) {
      StoreY4(dst, out);
    } else {
      for (int j = 0; j < live; ++j) StoreY(dst + j, out[j]);
    }
  }
  if (cluster) {
    ClusterArrive();
    ClusterWait();   // no block leaves while another reads its tile
  }
}

// -- host side --

// The TMA map of an int8 [outer, inner] row-major matrix (rows of `inner`
// bytes, a multiple of 16) in boxes of box_rows rows x 128 bytes, 128-byte
// swizzled; rows past `outer` and bytes past `inner` read as zeros.
bool Int8BoxMap(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                int inner, int outer, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKB),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kSwap, int kNB, typename Y>
cudaError_t AllowGemmSmem() {
  return cudaFuncSetAttribute(Int8GemmKernel<kSwap, kNB, Y>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              GemmCfg<kSwap, kNB>::kSmem);
}

template <typename Y>
cudaError_t AllowGemmSmemAll() {
  cudaError_t err = AllowGemmSmem<false, 128, Y>();
  if (err == cudaSuccess) err = AllowGemmSmem<true, 8, Y>();
  if (err == cudaSuccess) err = AllowGemmSmem<true, 16, Y>();
  if (err == cudaSuccess) err = AllowGemmSmem<true, 32, Y>();
  if (err == cudaSuccess) err = AllowGemmSmem<true, 64, Y>();
  return err;
}

// Once per device: every kernel's dynamic shared memory limit.
cudaError_t Setup() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = AllowGemmSmemAll<float>();
  if (err == cudaSuccess) err = AllowGemmSmemAll<__nv_bfloat16>();
  const void* quantize[2] = {
      reinterpret_cast<const void*>(Int8QuantizeKernel<float>),
      reinterpret_cast<const void*>(Int8QuantizeKernel<__nv_bfloat16>)};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = cudaFuncSetAttribute(quantize[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kQHeader + kQHoldBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          quantize[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// The launch's attributes: clusters of `cluster` blocks along x (none for
// one: the kernels then skip their cluster barriers), and with pdl the
// programmatic dependence on the stream's previous kernel.
void ClusterLaunch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int cluster, bool pdl) {
  int n = 0;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg->attrs = attr;
  cfg->numAttrs = n;
}

template <bool kSwap, int kNB, typename Y>
cudaError_t LaunchGemm(const CUtensorMap& mx, const CUtensorMap& mw,
                       const GemmArgs& a, long long tiles, bool pdl,
                       cudaStream_t s) {
  using C = GemmCfg<kSwap, kNB>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * a.cluster));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  ClusterLaunch(&cfg, attr, a.cluster, pdl);
  return cudaLaunchKernelEx(&cfg, Int8GemmKernel<kSwap, kNB, Y>, mx, mw, a);
}

// (b)'s configurations: normal (nb 128), or swapped with nb = 8, 16, 32 or
// 64.
template <typename Y>
cudaError_t DispatchGemm(int swap, int nb, const CUtensorMap& mx,
                         const CUtensorMap& mw, const GemmArgs& a,
                         long long tiles, bool pdl, cudaStream_t s) {
  if (!swap) return LaunchGemm<false, 128, Y>(mx, mw, a, tiles, pdl, s);
  switch (nb) {
    case 8:
      return LaunchGemm<true, 8, Y>(mx, mw, a, tiles, pdl, s);
    case 16:
      return LaunchGemm<true, 16, Y>(mx, mw, a, tiles, pdl, s);
    case 32:
      return LaunchGemm<true, 32, Y>(mx, mw, a, tiles, pdl, s);
    default:
      return LaunchGemm<true, 64, Y>(mx, mw, a, tiles, pdl, s);
  }
}

template <bool kSwap, int kNB>
cudaError_t GemmOccupancy(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, Int8GemmKernel<kSwap, kNB, float>, GemmCfg<kSwap, kNB>::kThreads,
      GemmCfg<kSwap, kNB>::kSmem);
}

}  // namespace

extern "C" {

// (a) on `stream`: x [m, k] float32, or bfloat16 when bf16 != 0 -> x8 [m,
// kp] int8 and x_scale [1] float32. One cluster of `blocks` blocks (at most
// Int8QuantizeMaxBlocks; one block launches without a cluster), each
// `rows` rows of x (the last one fewer, none empty), each holding the first
// `held` of them in shared memory (from ops/int8_matmul.py
// `QuantizePlan`). x and x8 16-byte aligned. Returns the cudaError_t of the
// launch (0 = ok).
int Int8Quantize(const void* x, int8_t* x8, float* x_scale, int m, int k,
                 int kp, int blocks, int rows, int held, int bf16,
                 void* stream) {
  const long long itemsize = bf16 ? 2 : 4;
  const long long held_bytes = static_cast<long long>(held) * k * itemsize;
  if (m <= 0 || k <= 0 || kp < k || kp % 16 != 0 || blocks < 1 ||
      blocks > kQMaxCluster || rows < 1 ||
      static_cast<long long>(blocks - 1) * rows >= m ||
      static_cast<long long>(blocks) * rows < m || held < 0 ||
      held > rows || held_bytes > kQHoldBytes ||
      static_cast<long long>(rows) * k * itemsize / 16 > 2147483647LL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x8) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = (k * itemsize) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(kQHeader + (held_bytes + 15) / 16 * 16);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  ClusterLaunch(&cfg, attr, blocks, false);
  if (bf16)
    err = cudaLaunchKernelEx(&cfg, Int8QuantizeKernel<__nv_bfloat16>,
                             static_cast<const __nv_bfloat16*>(x), x8,
                             x_scale, m, k, kp, rows, held, vec16);
  else
    err = cudaLaunchKernelEx(&cfg, Int8QuantizeKernel<float>,
                             static_cast<const float*>(x), x8, x_scale, m, k,
                             kp, rows, held, vec16);
  return static_cast<int>(err);
}

// The most blocks (a)'s cluster may have on the current device: 16 where
// the device can place a 16-block cluster of the kernel at its largest
// shared memory, else 8 (the portable size). Into max_blocks; returns the
// cudaError_t (0 = ok).
int Int8QuantizeMaxBlocks(int* max_blocks) {
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kQMaxCluster);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = kQHeader + kQHoldBytes;
  cudaLaunchAttribute attr[2];
  ClusterLaunch(&cfg, attr, kQMaxCluster, false);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(Int8QuantizeKernel<float>),
      &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_blocks = clusters > 0 ? kQMaxCluster : kMaxCluster;
  return 0;
}

// (b) on `stream`: y [m, n] float32 (bfloat16 when bf16 != 0, rounded
// once) = (float(x8[:, :k] . w^T) * x_scale) * w_scale. x8 [m, kp] int8
// (from Int8Quantize), w [n, k] int8 K-major, w_scale [n] float32, x8 and w
// 16-byte aligned. The launch from ops/int8_matmul.py `GemmPlan`: swapped
// (m <= nb in {8, 16, 32, 64}) or not (nb 128); `cluster` K splits of
// `kb_per_split` 128-byte K blocks each, none empty. pdl != 0 launches it
// as a programmatic dependent of the stream's previous kernel (which must
// not write w or w_scale). Returns the cudaError_t (0 = ok).
int Int8Gemm(const int8_t* x8, const int8_t* w, const float* x_scale,
             const float* w_scale, void* y, int m, int k, int kp, int n,
             int swap, int nb, int cluster, int kb_per_split, int bf16,
             int pdl, void* stream) {
  const int kblocks = (k + kKB - 1) / kKB;
  const bool nb_ok = swap ? (nb == 8 || nb == 16 || nb == 32 || nb == 64) &&
                                m <= nb
                          : nb == 128;
  if (m <= 0 || k <= 0 || n <= 0 || kp < k || kp % 16 != 0 || !nb_ok ||
      cluster < 1 || cluster > kMaxCluster || kb_per_split < 1 ||
      static_cast<long long>(cluster - 1) * kb_per_split >= kblocks ||
      static_cast<long long>(cluster) * kb_per_split < kblocks ||
      reinterpret_cast<uintptr_t>(x8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_m = swap ? nb : 128, tile_n = swap ? 64 : 128;
  const long long m_tiles = (m + tile_m - 1) / tile_m;
  const long long tiles = m_tiles * ((n + tile_n - 1) / tile_n);
  if (tiles * cluster > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = TensorMapEncoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int w_tma = k % 16 == 0;
  CUtensorMap mx, mw = {};
  if (!Int8BoxMap(encode, &mx, x8, kp, m, tile_m) ||
      (w_tma && !Int8BoxMap(encode, &mw, w, k, n, swap ? 64 : 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const GemmArgs a = {w,       x_scale, w_scale,      y,     m,
                      k,       n,       static_cast<int>(m_tiles),
                      cluster, kblocks, kb_per_split, w_tma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? DispatchGemm<__nv_bfloat16>(swap, nb, mx, mw, a, tiles,
                                           pdl != 0, s)
             : DispatchGemm<float>(swap, nb, mx, mw, a, tiles, pdl != 0, s);
  return static_cast<int>(err);
}

// (a) then (b) on `stream` over one scratch of m * kp + 16 bytes (x8, then
// x_scale), (b) a programmatic dependent of (a): y [m, n] = the int8
// product of x [m, k] and w [n, k] int8 with its two scales; x and y
// float32, or both bfloat16 when bf16 != 0. The plans' arguments as above.
// Returns the first nonzero cudaError_t (0 = ok).
int Int8Matmul(const void* x, const int8_t* w, const float* w_scale,
               void* y, int8_t* scratch, int m, int k, int kp, int n,
               int q_blocks, int q_rows, int q_held, int swap, int nb,
               int cluster, int kb_per_split, int bf16, void* stream) {
  float* x_scale = reinterpret_cast<float*>(scratch +
                                            static_cast<long long>(m) * kp);
  const int rc = Int8Quantize(x, scratch, x_scale, m, k, kp, q_blocks,
                              q_rows, q_held, bf16, stream);
  if (rc != 0) return rc;
  return Int8Gemm(scratch, w, x_scale, w_scale, y, m, k, kp, n, swap, nb,
                  cluster, kb_per_split, bf16, 1, stream);
}

// Resident blocks per SM of (b)'s configuration (swap, nb) on the current
// device, into per_sm. Returns the cudaError_t (0 = ok).
int Int8GemmOccupancy(int swap, int nb, int* per_sm) {
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!swap && nb == 128)
    return static_cast<int>(GemmOccupancy<false, 128>(per_sm));
  switch (swap ? nb : 0) {
    case 8:
      return static_cast<int>(GemmOccupancy<true, 8>(per_sm));
    case 16:
      return static_cast<int>(GemmOccupancy<true, 16>(per_sm));
    case 32:
      return static_cast<int>(GemmOccupancy<true, 32>(per_sm));
    case 64:
      return static_cast<int>(GemmOccupancy<true, 64>(per_sm));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* Int8MatmulErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
