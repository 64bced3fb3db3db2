// The int8-serving matmul on Hopper: y = (float(int8(x) . w8) * x_scale) *
// w_scale[n], the integer product of `Int8Einsum`.
//
// Replaces no pallas_call. The reference computes this product with an XLA
// dot_general with preferred_element_type=int32
// (lingvo_tpu/core/quant_utils.py:265 `Int8Einsum`), which the TPU runs on
// its matrix unit. On CUDA no PyTorch call computes it: torch.matmul has no
// integer kernel there, torch._int_mm refuses M <= 16 (every decode step)
// and neither applies the two-scale epilogue. So two hand kernels:
//
// (a) Int8QuantizeKernel, the activation pre-pass. x [M, K] float32 ->
//     x_scale = max(amax(|x|) * float32(1 / 127), 1e-8) over the WHOLE x of
//     the call (the reference's amax / 127.0 as XLA compiles it inside the
//     jitted step: a product with the constant's float32 reciprocal), and
//     x8 [M, Kp] int8 = clip(rint(x / x_scale), -128, 127) with a true
//     (IEEE) division and round half to even, rows padded with zeros to Kp
//     = K rounded up to 16 bytes. A cooperative launch of at most one wave
//     of blocks: each block folds the max of its share (units of 256 quads
//     of one row), a grid barrier, then every block reads the blocks'
//     maxima (a max is exact in any order), forms the scale and quantizes
//     its share. The divisions are spread over the whole card.
// (b) Int8GemmKernel<BM>, the product and its epilogue. Tensor-core
//     mma.sync m16n8k32 s8.s8 -> s32 on BM x 128 tiles, both operands
//     K-major (x8 rows; w [N, K], the K-major copy the serving theta keeps)
//     and read from shared memory by ldmatrix, 64-byte K stages through a
//     3-stage cp.async ring. Small M gives few output tiles, so K is split
//     over blocks: each split stores its int32 partial tile, and the last
//     split of a tile to finish (a counter per tile) sums the tile's
//     partials with coalesced 16-byte loads. int32 sums are exact, so any
//     split and any order give the same bits. The epilogue is two separate
//     float32 multiplies, the reference's order: float(acc) * x_scale, then
//     * w_scale[n].
//
// What bounds it: at the serving shapes (M = 8 decode rows, M = 264 packed
// tokens) the weight's bytes. A step reads 1.27 GB of int8 weights, and
// 2 M K N operations at M <= a few hundred sit far under the int8 tensor
// cores' 1979 TOP/s.
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
// Plain C interface, loaded with ctypes by ops/int8_matmul.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // both kernels; a quantize unit
                                        // is one quad a thread
constexpr int kBK = 64;                 // K bytes of one stage
constexpr int kBN = 128;                // output columns of a block
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;
constexpr int kRowBytes = kBK + 16;     // a padded smem row: the 8 rows an
                                        // ldmatrix phase reads hit 8 bank
                                        // groups

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

__device__ __forceinline__ int8_t Quantize(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));   // half to even
  return static_cast<int8_t>(min(127, max(-128, q)));
}

// x of type X, float32 or bfloat16: 4 values of a row widened to float32
// (16-byte / 8-byte loads; rows of a multiple of 4 values are aligned to
// them), and one value.
__device__ __forceinline__ float4 Load4X(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 Load4X(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float LoadX(const float* p) { return __ldg(p); }
__device__ __forceinline__ float LoadX(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// y of type Y: float32, or bfloat16 rounded to nearest even
__device__ __forceinline__ void StoreY(float* p, float v) { *p = v; }
__device__ __forceinline__ void StoreY(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A unit is 256 quads (4 columns each) of one row of x8: unit u is row u /
// segs, quads (u % segs) * 256 + threadIdx.x. Block b takes units b, b +
// gridDim.x, ...; the grid is one cooperative wave.
template <typename X>
__global__ void __launch_bounds__(kThreads) Int8QuantizeKernel(
    const X* __restrict__ x, int8_t* __restrict__ x8,
    float* __restrict__ x_scale, float* __restrict__ block_max, int m, int k,
    int kp) {
  __shared__ float red[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int quads = kp / 4;
  const int segs = (quads + kThreads - 1) / kThreads;
  const int units = m * segs;
  const bool vec = (k & 3) == 0;
  float amax = 0.f;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / segs;
    const int col = ((u - row * segs) * kThreads + threadIdx.x) * 4;
    const X* src = x + static_cast<long long>(row) * k + col;
    if (vec && col < k) {
      const float4 v = Load4X(src);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    } else {
      for (int j = 0; j < 4 && col + j < k; ++j)
        amax = fmaxf(amax, fabsf(LoadX(src + j)));
    }
  }
  amax = BlockMax<kThreads>(amax, red);
  if (threadIdx.x == 0) block_max[blockIdx.x] = amax;
  grid.sync();   // every block's max is published
  float g = 0.f;
  for (int i = threadIdx.x; i < gridDim.x; i += kThreads)
    g = fmaxf(g, __ldcg(block_max + i));
  __syncthreads();   // red is reused
  g = BlockMax<kThreads>(g, red);
  // the reference's amax / 127.0 as XLA compiles it in the jitted step: a
  // product with the float32 reciprocal of 127
  const float scale = fmaxf(__fmul_rn(g, 0x1.020408p-7f), 1e-8f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *x_scale = scale;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / segs;
    const int quad = (u - row * segs) * kThreads + threadIdx.x;
    if (quad >= quads) continue;
    const int col = quad * 4;
    const X* src = x + static_cast<long long>(row) * k + col;
    char4 out;
    if (vec && col < k) {
      const float4 v = Load4X(src);
      out = make_char4(Quantize(v.x, scale), Quantize(v.y, scale),
                       Quantize(v.z, scale), Quantize(v.w, scale));
    } else {
      out.x = col + 0 < k ? Quantize(LoadX(src + 0), scale) : 0;
      out.y = col + 1 < k ? Quantize(LoadX(src + 1), scale) : 0;
      out.z = col + 2 < k ? Quantize(LoadX(src + 2), scale) : 0;
      out.w = col + 3 < k ? Quantize(LoadX(src + 3), scale) : 0;
    }
    *reinterpret_cast<char4*>(x8 + static_cast<long long>(row) * kp + col) =
        out;
  }
}

__device__ __forceinline__ void MmaS8(int (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 16-byte matrices of shared memory into the mma fragment
// registers: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void LdMatrix4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(SmemAddr(p)));
}

// Stage one 64-byte K chunk of the A tile (x8 rows) and the B tile (w rows).
// x8 rows are Kp-padded, so every 16-byte piece below Kp is whole. w rows are
// 16-byte copies when K is a multiple of 16, else byte loads.
template <int kBM>
__device__ __forceinline__ void LoadStage(
    int8_t* sa, int8_t* sb, const int8_t* __restrict__ x8,
    const int8_t* __restrict__ w, int m0, int n0, int chunk, int m, int n,
    int k, int kp, bool w_aligned) {
  const int k0 = chunk * kBK;
  for (int p = threadIdx.x; p < kBM * 4; p += kThreads) {
    const int row = p >> 2, kk = k0 + (p & 3) * 16;
    const bool valid = m0 + row < m && kk < kp;
    CpAsync16(sa + row * kRowBytes + (p & 3) * 16,
              valid ? x8 + static_cast<long long>(m0 + row) * kp + kk : x8,
              valid);
  }
  for (int p = threadIdx.x; p < kBN * 4; p += kThreads) {
    const int row = p >> 2, kk = k0 + (p & 3) * 16;
    int8_t* dst = sb + row * kRowBytes + (p & 3) * 16;
    const bool live = n0 + row < n;
    const int8_t* src = w + static_cast<long long>(n0 + row) * k + kk;
    if (w_aligned) {
      const bool valid = live && kk < k;
      CpAsync16(dst, valid ? src : w, valid);
    } else {
      uint32_t words[4];
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
        for (int b = 0; b < 4; ++b) {
          const int kb = kk + j * 4 + b;
          const uint32_t byte =
              live && kb < k ? static_cast<uint8_t>(src[j * 4 + b]) : 0u;
          word |= byte << (8 * b);
        }
        words[j] = word;
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

// grid (m tiles, n tiles, splits): the m tiles that share a weight tile run
// side by side, so the weight is streamed from device memory once. Y: the
// type of y (float32, or bfloat16 rounded at the store).
template <int kBM, typename Y>
__global__ void __launch_bounds__(kThreads) Int8GemmKernel(
    const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
    const float* __restrict__ x_scale, const float* __restrict__ w_scale,
    Y* __restrict__ y, int* ws, unsigned* tile_counters, int m, int k,
    int kp, int n, int chunks_per_split) {
  constexpr int kWM = kBM >= 64 ? 2 : 1;       // warps along M
  constexpr int kWN = 8 / kWM;                 // warps along N
  constexpr int kMT = kBM / kWM / 16;          // m16 tiles of a warp
  constexpr int kNT = kBN / kWN / 8;           // n8 tiles of a warp (even)
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                                 // [kStages][kBM rows]
  int8_t* sb = smem + kStages * kBM * kRowBytes;     // [kStages][kBN rows]
  __shared__ int last_split;

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int chunks = (k + kBK - 1) / kBK;
  const int c0 = split * chunks_per_split;
  const int nch = min(chunks, c0 + chunks_per_split) - c0;
  const bool w_aligned = (k % 16) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWN) * (kBM / kWM), wn = (warp % kWN) * (kBN / kWN);
  // ldmatrix row addresses: A rows lane % 16, bytes (lane / 16) * 16; B
  // rows lane % 8 of n8 tile lane / 16, bytes ((lane / 8) % 2) * 16
  const int a_off = (wm + (lane & 15)) * kRowBytes + (lane >> 4) * 16;
  const int b_off = (wn + (lane >> 4) * 8 + (lane & 7)) * kRowBytes +
                    ((lane >> 3) & 1) * 16;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch)
      LoadStage<kBM>(sa + s * kBM * kRowBytes, sb + s * kBN * kRowBytes, x8,
                     w, m0, n0, c0 + s, m, n, k, kp, w_aligned);
    CpAsyncCommit();
  }
  for (int i = 0; i < nch; ++i) {
    CpAsyncWait<kStages - 2>();
    __syncthreads();   // stage i landed; stage i - 1 is free to refill
    const int next = i + kStages - 1;
    if (next < nch)
      LoadStage<kBM>(sa + (next % kStages) * kBM * kRowBytes,
                     sb + (next % kStages) * kBN * kRowBytes, x8, w, m0, n0,
                     c0 + next, m, n, k, kp, w_aligned);
    CpAsyncCommit();
    const int8_t* a = sa + (i % kStages) * kBM * kRowBytes + a_off;
    const int8_t* b = sb + (i % kStages) * kBN * kRowBytes + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4], bf[kNT / 2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        LdMatrix4(af[mt], a + mt * 16 * kRowBytes + kk);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        LdMatrix4(bf[np], b + np * 16 * kRowBytes + kk);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t bb[2] = {bf[nt / 2][(nt & 1) * 2],
                                  bf[nt / 2][(nt & 1) * 2 + 1]};
          MmaS8(acc[mt][nt], af[mt], bb);
        }
    }
  }
  CpAsyncWait<0>();

  const float xs = *x_scale;
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + wm + mt * 16 + g + (r >> 1) * 8;
          const int col = n0 + wn + nt * 8 + t * 2 + (r & 1);
          if (row < m && col < n)
            StoreY(y + static_cast<long long>(row) * n + col,
                   __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][r]), xs),
                             w_scale[col]));
        }
    return;
  }
  // publish this split's partial tile; the tile's last split sums them
  int* mine = ws + static_cast<long long>(split) * m * n;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mt * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn + nt * 8 + t * 2 + (r & 1);
        if (row < m && col < n)
          mine[static_cast<long long>(row) * n + col] = acc[mt][nt][r];
      }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned done =
        atomicAdd(tile_counters + blockIdx.y * gridDim.x + blockIdx.x, 1u);
    last_split = done == static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  // the tile's sum, 4 columns a thread per pass, the splits' loads in
  // flight together
  const bool vec = (n & 3) == 0;
  const long long plane = static_cast<long long>(m) * n;
  for (int e = threadIdx.x; e < kBM * kBN / 4; e += kThreads) {
    const int row = m0 + e / (kBN / 4);
    const int col = n0 + (e % (kBN / 4)) * 4;
    if (row >= m || col >= n) continue;
    const long long at = static_cast<long long>(row) * n + col;
    int sum[4] = {0, 0, 0, 0};
    if (vec) {
#pragma unroll 4
      for (int s = 0; s < splits; ++s) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(ws + s * plane +
                                                            at));
        sum[0] += v.x;
        sum[1] += v.y;
        sum[2] += v.z;
        sum[3] += v.w;
      }
    } else {
      for (int s = 0; s < splits; ++s)
        for (int j = 0; j < 4 && col + j < n; ++j)
          sum[j] += __ldcg(ws + s * plane + at + j);
    }
    for (int j = 0; j < 4 && col + j < n; ++j)
      StoreY(y + at + j, __fmul_rn(__fmul_rn(__int2float_rn(sum[j]), xs),
                                   w_scale[col + j]));
  }
}

template <int kBM>
constexpr int GemmSmem() {
  return kStages * (kBM + kBN) * kRowBytes;
}

// Once per device: the GEMM kernels' dynamic shared memory, and the blocks
// of (a) that can be resident at once (the cooperative launch's limit).
cudaError_t Setup(int* quant_cap) {
  static int caps[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && caps[dev] > 0) {
    *quant_cap = caps[dev];
    return cudaSuccess;
  }
  const void* gemms[4] = {
      reinterpret_cast<const void*>(Int8GemmKernel<16, float>),
      reinterpret_cast<const void*>(Int8GemmKernel<64, float>),
      reinterpret_cast<const void*>(Int8GemmKernel<16, __nv_bfloat16>),
      reinterpret_cast<const void*>(Int8GemmKernel<64, __nv_bfloat16>)};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaFuncSetAttribute(gemms[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               i % 2 ? GemmSmem<64>() : GemmSmem<16>());
  // the one wave of (a) is the least of its two instantiations' waves
  int sms = 0, per_sm = 0, per_sm_bf16 = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, Int8QuantizeKernel<float>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_bf16, Int8QuantizeKernel<__nv_bfloat16>, kThreads, 0);
  if (err != cudaSuccess) return err;
  per_sm = per_sm < per_sm_bf16 ? per_sm : per_sm_bf16;
  *quant_cap = sms * per_sm;
  if (dev < kMaxDevices) caps[dev] = *quant_cap;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The grid (a) launches for [m, k] (kp: k rounded up to 16): one block a
// unit of 256 quads of a row, capped at one wave. Returns the cudaError_t
// of the device queries (0 = ok).
int Int8QuantizeGrid(int m, int kp, int* grid) {
  int cap = 0;
  const cudaError_t err = Setup(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units =
      static_cast<long long>(m) * ((kp / 4 + kThreads - 1) / kThreads);
  *grid = static_cast<int>(units < cap ? units : cap);
  return 0;
}

// (a) on `stream`: x [m, k] float32, or bfloat16 when bf16 != 0 -> x8 [m,
// kp] int8 and x_scale [1] float32; block_max: `grid` floats of scratch
// (from Int8QuantizeGrid). One cooperative launch. Returns the cudaError_t
// of the launch (0 = ok).
int Int8Quantize(const void* x, int8_t* x8, float* x_scale,
                 float* block_max, int m, int k, int kp, int grid, int bf16,
                 void* stream) {
  if (m <= 0 || k <= 0 || kp < k || kp % 16 != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &x8, &x_scale, &block_max, &m, &k, &kp};
  const void* kernel =
      bf16 ? reinterpret_cast<const void*>(Int8QuantizeKernel<__nv_bfloat16>)
           : reinterpret_cast<const void*>(Int8QuantizeKernel<float>);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// (b) on `stream`: y [m, n] float32 (bfloat16 when bf16 != 0, rounded
// once) = (float(x8[:, :k] . w^T) * x_scale) * w_scale. x8 [m, kp] int8
// (from Int8Quantize); w [n, k] int8, K-major;
// w_scale [n] float32. bm: 16 or 64 rows a block; splits: blocks along K,
// each `chunks_per_split` 64-byte chunks; ws: [splits, m, n] int32 and
// counters: one unsigned per (m tile, n tile), both scratch used only when
// splits > 1 (counters zeroed here). Returns the cudaError_t (0 = ok).
int Int8Gemm(const int8_t* x8, const int8_t* w, const float* x_scale,
             const float* w_scale, void* y, int* ws, unsigned* counters,
             int m, int k, int kp, int n, int bm, int splits,
             int chunks_per_split, int bf16, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || kp < k || kp % 16 != 0 ||
      (bm != 16 && bm != 64) || splits < 1 || splits > 65535 ||
      chunks_per_split < 1 || (splits > 1 && (ws == nullptr ||
                                              counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (m + bm - 1) / bm, n_tiles = (n + kBN - 1) / kBN;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  const cudaError_t setup = Setup(&cap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        counters, 0,
        sizeof(unsigned) * static_cast<size_t>(m_tiles) * n_tiles, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(m_tiles, n_tiles, splits);
#define INT8_GEMM_LAUNCH(BM, Y)                                             \
  Int8GemmKernel<BM, Y><<<grid, kThreads, GemmSmem<BM>(), s>>>(             \
      x8, w, x_scale, w_scale, static_cast<Y*>(y), ws, counters, m, k, kp, \
      n, chunks_per_split)
  if (bf16) {
    if (bm == 16)
      INT8_GEMM_LAUNCH(16, __nv_bfloat16);
    else
      INT8_GEMM_LAUNCH(64, __nv_bfloat16);
  } else {
    if (bm == 16)
      INT8_GEMM_LAUNCH(16, float);
    else
      INT8_GEMM_LAUNCH(64, float);
  }
#undef INT8_GEMM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The scratch Int8Matmul carves, in bytes, 16-byte aligned pieces: x8 [m,
// kp], x_scale, (a)'s `grid` block maxima, then with splits > 1 the tile
// counters and the [splits, m, n] int32 partials. Offsets in `at` (5).
long long Int8MatmulScratch(int m, int kp, int n, int grid, int bm,
                            int splits, long long* at) {
  const auto up16 = [](long long b) { return (b + 15) / 16 * 16; };
  const long long tiles =
      static_cast<long long>((m + bm - 1) / bm) * ((n + kBN - 1) / kBN);
  at[0] = 0;                                        // x8
  at[1] = static_cast<long long>(m) * kp;           // x_scale
  at[2] = at[1] + 16;                               // block maxima
  at[3] = at[2] + up16(4LL * grid);                 // tile counters
  at[4] = at[3] + (splits > 1 ? up16(4 * tiles) : 0);   // partials
  return at[4] + (splits > 1 ? 4LL * splits * m * n : 0);
}

// (a) then (b) on `stream` over one scratch of Int8MatmulScratch's bytes:
// y [m, n] = the int8 product of x [m, k] and w [n, k] int8 with its two
// scales; x and y float32, or both bfloat16 when bf16 != 0. Returns the
// first nonzero cudaError_t (0 = ok).
int Int8Matmul(const void* x, const int8_t* w, const float* w_scale,
               void* y, int8_t* scratch, int m, int k, int kp, int n,
               int grid, int bm, int splits, int chunks_per_split, int bf16,
               void* stream) {
  long long at[5];
  Int8MatmulScratch(m, kp, n, grid, bm, splits, at);
  int8_t* x8 = scratch + at[0];
  float* x_scale = reinterpret_cast<float*>(scratch + at[1]);
  const int rc = Int8Quantize(x, x8, x_scale,
                              reinterpret_cast<float*>(scratch + at[2]), m,
                              k, kp, grid, bf16, stream);
  if (rc != 0) return rc;
  return Int8Gemm(x8, w, x_scale, w_scale, y,
                  splits > 1 ? reinterpret_cast<int*>(scratch + at[4])
                             : nullptr,
                  splits > 1 ? reinterpret_cast<unsigned*>(scratch + at[3])
                             : nullptr,
                  m, k, kp, n, bm, splits, chunks_per_split, bf16, stream);
}

const char* Int8MatmulErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
