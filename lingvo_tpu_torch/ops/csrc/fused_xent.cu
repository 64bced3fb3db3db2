// Fused LM-head cross-entropy statistics for Hopper (sm_90a), float32 and
// bfloat16 (the bf16 kernel has its own section below).
//
// Replaces the Pallas TPU kernel `_FwdKernel` of lingvo_tpu/ops/fused_xent.py
// (pallas_call in `_PallasStats`; public entry `FusedXent`). It computes
// the same function, not the same blocks: for every row of x [M, D], the
// logits x . w[c] + b[c] over the whole vocabulary, tanh-capped when
// soft_cap > 0 (the reference's `_BlockLogits`), with the online
// statistics of `_BlockStats`: running max m and denominator l, the label
// logit, the sum of logits (only with label smoothing) and the
// first-occurrence argmax. Columns past V are masked, as the reference
// masks its zero-padded tail. Emits lse = m + log(max(l, 1e-37)), the
// label logit, the logit sum and the argmax per row; the [M, V] logits
// never exist.
//
// Bound: 2 M V D flops on the CUDA cores (float32, TF32 off): at the main
// path's shapes (M 8192, V 32000, D 2048) 1.07 TFLOP, 16.0 ms at 67
// TFLOP/s on an H100 SXM; the bytes (x and w read once, 0.33 GB) take 0.1
// ms, so the kernel is bound by operations, and the design is about
// keeping the float32 CUDA cores fed.
//
// Design (float32). The TPU kernel walks a (row tile, vocab block) grid in
// order and carries the statistics in VMEM scratch. Here the vocabulary is
// split across blocks: grid (M / 128 row tiles, S vocab splits), where
// split s owns the 128-column vocab tiles [s tps, (s + 1) tps) (S and tps
// from the Python `StatsGeometry`, which sizes the grid to fill the SMs
// for at least two waves). A block of 256 threads computes each of its
// 128 x 128 logit tiles over D in stages of kDepth = 32, staged by 16-byte
// cp.async copies into kStages = 2 buffers (the next stage's copy runs
// under this stage's math; 4-byte copies when a row is not 16-byte
// aligned; on the H100, 32 of D a stage beat 16, and a third stage did
// not help: the float32 cores, not the copies, set the pace).
// Thread (ty, tx) owns the 8 x 8 register patch of rows ty + 16 i and
// columns tx + 16 j ([V, D] layout; [D, V]: 4 tx + j and 64 + 4 tx + j):
// per 4 of D it reads 8 float4s of x (rows, along D: one address per
// quarter-warp) and 8 float4s of w, 64 FFMA per 16 floats, as the 4 FFMA
// per float loaded from shared memory that this card's float32 cores need.
// Both stages sit at a row stride of kDepth + 4 floats ([D, V]: the w stage
// as [kDepth][128 + 4]), so a quarter-warp's 8 float4 reads hit distinct
// banks. A tile's epilogue runs on the patch: bias, cap, then per row the
// tile's max, sum of exp(s - max), label logit, logit sum and smallest
// argmax index, reduced by shuffles over the 16 lanes (one half-warp) that
// share the row; lane tx = i folds row i's numbers into its running
// statistics (each lane keeps one row's: no shared memory, no barrier).
// Each block writes its rows' partial statistics (m, l, label logit, sum,
// argmax) to a float32 [5, S, M] scratch; `FusedXentCombineKernel` merges
// the splits of a row in split order. Across tiles and splits a strict >
// keeps the earlier argmax on ties and within a tile the smallest index
// wins, so the argmax is the first occurrence over the whole vocabulary.
// Tiles are folded with l rescaled from the tile's own max, which changes
// only the rounding of the rescaling against the reference's per-block
// update. No atomics: two calls give the same bits.
// What it leaves: the tensor cores (3xTF32 would re-open the parity bar),
// and every row tile streams its splits' weight tiles through L2 (x and w
// tiles of 1 MB per 67 MFLOP of logits).
//
// Limits (the Python wrapper raises outside them): float32 or bfloat16,
// contiguous tensors, labels in [0, V).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF
constexpr int kBigIdx = 1 << 30;     // the reference _BIG_IDX

constexpr int kTile = 128;      // rows and vocab columns of a logit tile
constexpr int kDepth = 32;      // D per cp.async stage
constexpr int kStages = 2;      // the ring of stages
constexpr int kThreads = 256;   // 16 x 16: ty row lane, tx column lane
constexpr int kLd = kDepth + 4;      // row stride of a [128][kDepth] stage
constexpr int kLdT = kTile + 4;      // row stride of a [kDepth][128] stage
constexpr int kStageFloats = 2 * kTile * kLd;   // x, then w
constexpr int kSmemBytes = kStages * kStageFloats * sizeof(float);
constexpr int kParts = 5;       // m, l, label logit, sum, argmax
constexpr int kCopies = kTile * kDepth / 4 / kThreads;  // float4s a thread

static_assert(kDepth * kLdT <= kTile * kLd, "the [D, V] stage must fit");

// reductions over the 16 lanes (a half-warp) that share a row
__device__ __forceinline__ float GroupMax(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float GroupSum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int GroupMin(int x) {
  for (int o = 8; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 4 floats of a row, src[0 .. 3] of which the first `n` (<= 4, may be <=
// 0) exist; vec: src is 16-byte aligned (and n is 0 or 4)
__device__ __forceinline__ void CopyFour(float* dst, const float* src, int n,
                                         bool vec) {
  if (vec) {
    CpAsync16(dst, src, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) CpAsync4(dst + e, src + (e < n ? e : 0), e < n);
  }
}

__device__ __forceinline__ float4 Ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a . b over one float4, summed in the order of d
__device__ __forceinline__ float Dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// column j of a thread's patch within its tile
template <bool kVd>
__device__ __forceinline__ int PatchCol(int tx, int j) {
  return kVd ? tx + 16 * j : (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
}

// grid (row tiles, splits). part: float32 [kParts, splits, M] (the argmax
// as int bits). kVd: w is [V, D]; else [D, V]. vec: 16-byte copies.
template <bool kVd>
__global__ void __launch_bounds__(kThreads, 2) FusedXentStatsKernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ labels,
    float* __restrict__ part, int m_rows, int d, int vocab,
    int tiles_per_split, int vec, float soft_cap, int need_sum) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kTile;
  const int split = blockIdx.y, splits = gridDim.y;
  const int col_tiles = (vocab + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int ntiles = min(tiles_per_split, col_tiles - t0);
  const int nks = (d + kDepth - 1) / kDepth;
  const int nsteps = ntiles * nks;
  const bool v16 = vec != 0;

  // the label of the row whose statistics this lane keeps (tx < 8)
  const int own_row = r0 + ty + 16 * tx;
  const int own_label = tx < 8 && own_row < m_rows ? labels[own_row] : -1;
  float st_m = kNegInf, st_l = 0.f, st_llog = 0.f, st_sum = 0.f;
  int st_amax = 0;

  // a thread's copies: kCopies of the stage's float4s of x and of w
  auto issue = [&](int step) {
    if (step < nsteps) {
      const int tile = t0 + step / nks, d0 = (step % nks) * kDepth;
      const int c0 = tile * kTile;
      float* xs = smem + (step % kStages) * kStageFloats;
      float* ws = xs + kTile * kLd;
#pragma unroll
      for (int it = 0; it < kCopies; ++it) {
        const int idx = tid + it * kThreads;
        const int r = idx / (kDepth / 4), q = idx % (kDepth / 4);
        const int row = r0 + r, dc = d0 + 4 * q;
        const int n = row < m_rows ? d - dc : 0;
        CopyFour(xs + r * kLd + 4 * q,
                 x + static_cast<size_t>(row < m_rows ? row : 0) * d +
                     (n > 0 ? dc : 0), n, v16);
        if (kVd) {
          const int col = c0 + r;
          const int nw = col < vocab ? d - dc : 0;
          CopyFour(ws + r * kLd + 4 * q,
                   w + static_cast<size_t>(col < vocab ? col : 0) * d +
                       (nw > 0 ? dc : 0), nw, v16);
        } else {
          const int dd = idx / (kTile / 4), cq = idx % (kTile / 4);
          const int col = c0 + 4 * cq, dr = d0 + dd;
          const int nw = dr < d ? vocab - col : 0;
          CopyFour(ws + dd * kLdT + 4 * cq,
                   w + static_cast<size_t>(dr < d ? dr : 0) * vocab +
                       (nw > 0 ? col : 0), nw, v16);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();   // this stage landed; the one refilled below is free
    issue(step + kStages - 1);
    const float* xs = smem + (step % kStages) * kStageFloats + ty * kLd;
    const float* ws = smem + (step % kStages) * kStageFloats + kTile * kLd;
#pragma unroll
    for (int k4 = 0; k4 < kDepth; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ld4(xs + 16 * i * kLd + k4);
      if (kVd) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = Ld4(ws + (tx + 16 * j) * kLd + k4);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = Dot4(a[i], b, acc[i][j]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 b0 = Ld4(ws + (k4 + e) * kLdT + 4 * tx);
          const float4 b1 = Ld4(ws + (k4 + e) * kLdT + 64 + 4 * tx);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ae = e == 0 ? a[i].x : e == 1 ? a[i].y
                           : e == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ae, b[j], acc[i][j]);
          }
        }
      }
    }
    if (step % nks != nks - 1) continue;
    // the tile's epilogue: bias and cap (`_BlockLogits`), then the row
    // statistics of `_BlockStats` over the tile's columns
    const int c0 = (t0 + step / nks) * kTile;
    int col[8];
    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = c0 + PatchCol<kVd>(tx, j);
      bj[j] = col[j] < vocab ? bias[col[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v[8];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = acc[i][j] + bj[j];
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        v[j] = col[j] < vocab ? s : kNegInf;
        m_cur = fmaxf(m_cur, v[j]);
        acc[i][j] = 0.f;
      }
      m_cur = GroupMax(m_cur);
      const int label = __shfl_sync(0xffffffffu, own_label,
                                    (tid & 16) + i);
      float psum = 0.f, lab = 0.f, tot = 0.f;
      int idx = kBigIdx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = col[j] < vocab;
        psum += ok ? expf(v[j] - m_cur) : 0.f;
        if (ok && col[j] == label) lab += v[j];
        if (ok) tot += v[j];
        if (ok && v[j] >= m_cur) idx = min(idx, col[j]);
      }
      psum = GroupSum(psum);
      lab = GroupSum(lab);
      if (need_sum) tot = GroupSum(tot);
      idx = GroupMin(idx);
      if (tx == i) {
        const float m_new = fmaxf(st_m, m_cur);
        st_l = st_l * expf(st_m - m_new) + psum * expf(m_cur - m_new);
        st_llog += lab;
        st_sum += tot;
        // first occurrence: strict > keeps the earlier tile on ties
        if (m_cur > st_m) st_amax = idx;
        st_m = m_new;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (tx < 8 && own_row < m_rows) {
    const size_t plane = static_cast<size_t>(splits) * m_rows;
    float* p = part + static_cast<size_t>(split) * m_rows + own_row;
    p[0] = st_m;
    p[plane] = st_l;
    p[2 * plane] = st_llog;
    p[3 * plane] = need_sum ? st_sum : 0.f;
    p[4 * plane] = __int_as_float(st_amax);
  }
}

// Merges the splits of each row in split order: the running max and the
// rescaled denominator, the sums, and the argmax of the first split whose
// max is strictly greater than every earlier split's.
__global__ void FusedXentCombineKernel(const float* __restrict__ part,
                                       int splits, int m_rows,
                                       float* __restrict__ lse_out,
                                       float* __restrict__ llog_out,
                                       float* __restrict__ sum_out,
                                       int* __restrict__ amax_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m_rows) return;
  const size_t plane = static_cast<size_t>(splits) * m_rows;
  float m = kNegInf, l = 0.f, llog = 0.f, sum = 0.f;
  int amax = 0;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + static_cast<size_t>(s) * m_rows + row;
    const float ms = p[0];
    const float m_new = fmaxf(m, ms);
    l = l * expf(m - m_new) + p[plane] * expf(ms - m_new);
    llog += p[2 * plane];
    sum += p[3 * plane];
    if (ms > m) amax = __float_as_int(p[4 * plane]);
    m = m_new;
  }
  lse_out[row] = m + logf(fmaxf(l, 1e-37f));
  llog_out[row] = llog;
  sum_out[row] = sum;
  amax_out[row] = amax;
}

// ---- bfloat16: warpgroup MMA fed by TMA ------------------------------------
//
// The bf16 half (x and w bf16, every statistic float32, as the reference's
// `_BlockLogits` / `_BlockStats`: s = f32(x . w) + f32(b), the tanh cap in
// float32). A bf16 x bf16 product is exact in float32, so the logits differ
// from the reference's only in the order of their sums; nothing inside is
// rounded to bf16. Takes the [V, D] (tied-table) layout and D a multiple of
// 8 (a TMA row stride is a multiple of 16 bytes).
//
// Bound: 2 M V D flops on the bf16 tensor cores, 1.07 TFLOP at the main
// path's shapes: 1.09 ms at 989 TFLOP/s; x and w (0.17 GB) take 0.05 ms.
//
// The first bf16 kernel (mma.sync m16n8k16, a block of 64 rows walking
// the whole vocabulary, fragments through 32-bit shared loads from a
// 2-stage cp.async buffer, 128 blocks for 132 SMs) reached 10% of the
// tensor cores' rate. This design:
//  - Vocab splits, as the float32 kernel's: grid (M / 128 row tiles, S
//    splits), split s owning the 128-column vocab tiles [s tps, (s + 1)
//    tps) (S and tps from the Python `StatsGeometry` at this kernel's one
//    block an SM); its partial statistics go to the [5, S, M] scratch and
//    `FusedXentCombineKernel` merges the splits in order.
//  - One producer warp keeps a ring of kXStages stages in flight with TMA
//    (each stage x [128 rows x 64 of D] and w [128 columns x 64 of D], 128-
//    byte swizzled, 32 KB), with a full and an empty mbarrier per stage:
//    the consumers issue no copy and take no block barrier.
//  - Two consumer warpgroups own 64 rows each and run wgmma m64n128k16
//    with both operands straight from the swizzled tiles (K-major), float32
//    accumulators in registers (64 a thread); a stage is released once the
//    next k-step's wgmmas are issued and its own have completed.
//  - After a tile's last k-step each warpgroup folds its 64 x 128 logits
//    in registers: bias, cap, then per row the tile's max, sum of exp(s -
//    m_safe), label logit, logit sum and smallest argmax index, reduced
//    over the 4 lanes of a row, into running statistics (the reference's
//    online update; a strict > across tiles keeps the first occurrence).
//    The two warpgroups drift apart by up to the ring's depth, so one
//    folds while the other's wgmmas run.
// What it leaves: the fold does not overlap the same warpgroup's next
// products, the x tile is streamed again (from L2) for every vocab tile,
// and the grid is not persistent.

typedef __nv_bfloat16 bf16;

constexpr int kXRows = 128;       // rows of x per block
constexpr int kXCols = 128;       // vocab columns per tile
constexpr int kXDepth = 64;       // D per stage: one 128-byte swizzle row
constexpr int kXStages = 4;       // the ring
constexpr int kXConsumers = 256;  // two warpgroups of 64 rows
constexpr int kXThreads = kXConsumers + 32;   // and the producer warp
constexpr int kXBox = kXRows * kXDepth * 2;   // bytes of an x (or w) box
constexpr int kXStage = 2 * kXBox;            // x box, then w box
constexpr int kXBars = kXStages * kXStage;    // offset of the barriers
constexpr size_t kXSmemBytes = 1024 + kXBars + 2 * kXStages * 8;

static_assert(kXRows == kXCols, "x and w boxes share one shape");

__device__ __forceinline__ int QuadMin(int x) {
  x = min(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return min(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One row's running statistics (every lane of the row's quad holds them).
struct RowStats {
  float m, l, sum, llog;
  int amax;
};

// Folds a tile's logits of this thread's two rows (acc[4 j + e], e < 2:
// row a, e >= 2: row b; columns c0 + 8 j + 2 tq + (e & 1)) into their
// statistics: bias, cap, then the reference's `_BlockStats` with every
// column past V masked.
__device__ __forceinline__ void FoldTile(float (&acc)[64], RowStats& sa,
                                         RowStats& sb, int c0, int vocab,
                                         int label_a, int label_b,
                                         const bf16* __restrict__ bias,
                                         float soft_cap, int need_sum) {
  const int tq = threadIdx.x & 3;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < kXCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * tq + e;
      float va = kNegInf, vb = kNegInf;
      if (col < vocab) {
        const float b = __bfloat162float(bias[col]);
        va = acc[4 * j + e] + b;
        vb = acc[4 * j + 2 + e] + b;
        if (soft_cap > 0.f) {
          va = soft_cap * tanhf(va / soft_cap);
          vb = soft_cap * tanhf(vb / soft_cap);
        }
      }
      acc[4 * j + e] = va;
      acc[4 * j + 2 + e] = vb;
      mx_a = fmaxf(mx_a, va);
      mx_b = fmaxf(mx_b, vb);
    }
  mx_a = QuadMax(mx_a);
  mx_b = QuadMax(mx_b);
  const float mn_a = fmaxf(sa.m, mx_a), mn_b = fmaxf(sb.m, mx_b);
  // all-masked-so-far rows: masked entries must give p = 0
  const float ms_a = mn_a <= kNegInf * 0.5f ? 0.f : mn_a;
  const float ms_b = mn_b <= kNegInf * 0.5f ? 0.f : mn_b;
  float ps_a = 0.f, ps_b = 0.f, lab_a = 0.f, lab_b = 0.f, tot_a = 0.f,
        tot_b = 0.f;
  int ix_a = kBigIdx, ix_b = kBigIdx;
#pragma unroll
  for (int j = 0; j < kXCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * tq + e;
      const float va = acc[4 * j + e], vb = acc[4 * j + 2 + e];
      ps_a += expf(va - ms_a);
      ps_b += expf(vb - ms_b);
      if (col < vocab) {
        if (col == label_a) lab_a += va;
        if (col == label_b) lab_b += vb;
        tot_a += va;
        tot_b += vb;
        if (va >= mx_a) ix_a = min(ix_a, col);
        if (vb >= mx_b) ix_b = min(ix_b, col);
      }
    }
  ps_a = QuadSum(ps_a);
  ps_b = QuadSum(ps_b);
  sa.llog += QuadSum(lab_a);
  sb.llog += QuadSum(lab_b);
  if (need_sum) {
    sa.sum += QuadSum(tot_a);
    sb.sum += QuadSum(tot_b);
  }
  ix_a = QuadMin(ix_a);
  ix_b = QuadMin(ix_b);
  sa.l = expf(sa.m - mn_a) * sa.l + ps_a;
  sb.l = expf(sb.m - mn_b) * sb.l + ps_b;
  // first occurrence: strict > keeps the earlier tile on ties
  if (mx_a > sa.m) sa.amax = ix_a;
  if (mx_b > sb.m) sb.amax = ix_b;
  sa.m = mn_a;
  sb.m = mn_b;
}

// grid (row tiles, splits); part: float32 [kParts, splits, M] (the argmax
// as int bits), merged by FusedXentCombineKernel.
__global__ void __launch_bounds__(kXThreads, 1) FusedXentStatsBf16Kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ bias,
    const int* __restrict__ labels, float* __restrict__ part, int m_rows,
    int d, int vocab, int tiles_per_split, float soft_cap, int need_sum) {
  extern __shared__ __align__(16) unsigned char xsmem[];
  unsigned char* sm = xsmem + ((1024 - (SmemAddr(xsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kXBars);
  uint64_t* empty = full + kXStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kXRows;
  const int split = blockIdx.y, splits = gridDim.y;
  const int col_tiles = (vocab + kXCols - 1) / kXCols;
  const int t0 = split * tiles_per_split;
  const int ntiles = min(tiles_per_split, col_tiles - t0);
  const int nks = (d + kXDepth - 1) / kXDepth;

  if (tid == 0) {
    for (int st = 0; st < kXStages; ++st) {
      MbarInit(&full[st], 1);
      MbarInit(&empty[st], kXConsumers / 32);  // one arrival per warp
    }
    MbarInitFence();
  }
  __syncthreads();

  if (warp == kXConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int t = 0; t < ntiles; ++t)
        for (int ks = 0; ks < nks; ++ks) {
          MbarWait(&empty[stage], phase ^ 1);
          unsigned char* st = sm + stage * kXStage;
          MbarArriveExpectTx(&full[stage], kXStage);
          TmaLoad2(st, &tm_x, &full[stage], ks * kXDepth, r0);
          TmaLoad2(st + kXBox, &tm_w, &full[stage], ks * kXDepth,
                   (t0 + t) * kXCols);
          if (++stage == kXStages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // a consumer warpgroup: rows wg_r0 .. wg_r0 + 63; this thread's rows
  // row_a and row_b = row_a + 8 (the accumulators' layout)
  const int wg = warp >> 2;
  const int row_a = r0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int row_b = row_a + 8;
  const int label_a = row_a < m_rows ? labels[row_a] : -1;
  const int label_b = row_b < m_rows ? labels[row_b] : -1;
  RowStats sa = {kNegInf, 0.f, 0.f, 0.f, 0};
  RowStats sb = sa;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;  // overwritten (scale_d 0)

  int stage = 0, phase = 0, prev = -1;
  for (int t = 0; t < ntiles; ++t) {
    for (int ks = 0; ks < nks; ++ks) {
      MbarWait(&full[stage], phase);
      const unsigned char* st = sm + stage * kXStage;
      WgmmaFence();
#pragma unroll
      for (int kk = 0; kk < kXDepth / 16; ++kk)
        WgmmaSS128(acc,
                   SwizzledDesc(st + wg * 64 * 128 + 32 * kk, 16, 1024),
                   SwizzledDesc(st + kXBox + 32 * kk, 16, 1024),
                   ks > 0 || kk > 0);
      WgmmaCommit();
      WgmmaWait<1>();  // the previous k-step's wgmmas are done
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) MbarArrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kXStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    WgmmaWait<0>();
    FenceRegs(acc);
    __syncwarp();
    if (lane == 0) MbarArrive(&empty[prev]);
    prev = -1;
    FoldTile(acc, sa, sb, (t0 + t) * kXCols, vocab, label_a, label_b, bias,
             soft_cap, need_sum);
  }
  if ((lane & 3) == 0) {
    const size_t plane = static_cast<size_t>(splits) * m_rows;
    const RowStats* sts[2] = {&sa, &sb};
    const int rows[2] = {row_a, row_b};
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= m_rows) continue;
      float* p = part + static_cast<size_t>(split) * m_rows + rows[i];
      p[0] = sts[i]->m;
      p[plane] = sts[i]->l;
      p[2 * plane] = sts[i]->llog;
      p[3 * plane] = need_sum ? sts[i]->sum : 0.f;
      p[4 * plane] = __int_as_float(sts[i]->amax);
    }
  }
}

// The TMA map of a bf16 [outer, inner] row-major matrix in boxes of
// kXRows rows x kXDepth columns, 128-byte swizzled; rows past `outer` and
// columns past `inner` read as zeros.
bool Bf16BoxMap(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                int inner, int outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) *
                                 sizeof(bf16)};
  const cuuint32_t box[2] = {kXDepth, kXRows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t AllowBf16Smem() {
  return cudaFuncSetAttribute(FusedXentStatsBf16Kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kXSmemBytes));
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// x [M, D]; w [V, D] (vd = 1) or [D, V] (vd = 0); bias [V]; labels [M]
// int32 in [0, V); outputs lse/llog/sum float32 [M], amax int32 [M]; part
// float32 [5, splits, M] scratch. All contiguous, on one device. sum is 0
// unless need_sum. splits, tiles_per_split, tile and stages come from the
// Python `StatsGeometry` (tile and stages must be this file's); vec: x and
// w start on 16-byte boundaries and their rows are whole float4s. Two
// kernels: the split statistics, then the combine.
int FusedXentStatsF32(const float* x, const float* w, const float* bias,
                      const int* labels, float* lse, float* llog,
                      float* sumlog, int* amax, float* part, int m_rows,
                      int d, int vocab, int vd, float soft_cap, int need_sum,
                      int splits, int tiles_per_split, int tile, int stages,
                      int vec, void* stream) {
  const int col_tiles = (vocab + kTile - 1) / kTile;
  if (m_rows <= 0 || d <= 0 || vocab <= 0 || tile != kTile ||
      stages != kStages || splits <= 0 || tiles_per_split <= 0 ||
      (splits - 1) * tiles_per_split >= col_tiles ||
      splits * tiles_per_split < col_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vd ? FusedXentStatsKernel<true> : FusedXentStatsKernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m_rows + kTile - 1) / kTile, splits);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(x, w, bias, labels, part, m_rows,
                                           d, vocab, tiles_per_split, vec,
                                           soft_cap, need_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  FusedXentCombineKernel<<<(m_rows + 255) / 256, 256, 0, s>>>(
      part, splits, m_rows, lse, llog, sumlog, amax);
  return static_cast<int>(cudaGetLastError());
}

// The float32 kernel's launch geometry on the current device: geo[0]
// threads, geo[1] shared bytes per block, geo[2] resident blocks per SM.
int FusedXentF32Geometry(int* geo) {
  cudaError_t err = cudaFuncSetAttribute(
      FusedXentStatsKernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, FusedXentStatsKernel<true>, kThreads, kSmemBytes);
  geo[0] = kThreads;
  geo[1] = kSmemBytes;
  geo[2] = per_sm;
  return static_cast<int>(err);
}

// The bfloat16 kernel: x [M, D], w [V, D] and bias [V] bf16 (the [V, D]
// layout only, D a multiple of 8, x and w 16-byte aligned), the rest as
// above; splits and tiles_per_split from `StatsGeometry` at this kernel's
// occupancy. Two kernels: the split statistics, then the combine.
int FusedXentStatsBF16(const void* x, const void* w, const void* bias,
                       const int* labels, float* lse, float* llog,
                       float* sumlog, int* amax, float* part, int m_rows,
                       int d, int vocab, float soft_cap, int need_sum,
                       int splits, int tiles_per_split, void* stream) {
  const int col_tiles = (vocab + kXCols - 1) / kXCols;
  if (m_rows <= 0 || d <= 0 || d % 8 != 0 || vocab <= 0 || splits <= 0 ||
      tiles_per_split <= 0 || (splits - 1) * tiles_per_split >= col_tiles ||
      splits * tiles_per_split < col_tiles ||
      (m_rows + kXRows - 1) / kXRows > 2147483647 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = TensorMapEncoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mw;
  if (!Bf16BoxMap(encode, &mx, x, d, m_rows) ||
      !Bf16BoxMap(encode, &mw, w, d, vocab))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = AllowBf16Smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m_rows + kXRows - 1) / kXRows, splits);
  FusedXentStatsBf16Kernel<<<grid, kXThreads, kXSmemBytes, s>>>(
      mx, mw, static_cast<const bf16*>(bias), labels, part, m_rows, d, vocab,
      tiles_per_split, soft_cap, need_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  FusedXentCombineKernel<<<(m_rows + 255) / 256, 256, 0, s>>>(
      part, splits, m_rows, lse, llog, sumlog, amax);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 kernel's launch geometry on the current device, as
// FusedXentF32Geometry.
int FusedXentBf16Geometry(int* geo) {
  cudaError_t err = AllowBf16Smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, FusedXentStatsBf16Kernel, kXThreads, kXSmemBytes);
  geo[0] = kXThreads;
  geo[1] = static_cast<int>(kXSmemBytes);
  geo[2] = per_sm;
  return static_cast<int>(err);
}

const char* FusedXentErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
