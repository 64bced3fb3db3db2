// Fused LM-head cross-entropy statistics for Hopper (sm_90a), float32 and
// bfloat16 (the bf16 kernel has its own section below).
//
// Replaces the Pallas TPU kernel `_FwdKernel` of lingvo_tpu/ops/fused_xent.py
// (pallas_call in `_PallasStats`; public entry `FusedXent`). It computes
// the same function, not the same blocks: for every row of x [M, D], the
// logits x . w[c] + b[c] over the whole vocabulary, tanh-capped when
// soft_cap > 0, streamed in vocab blocks of `block_size` (the reference's
// `_BlockLogits`) with the online statistics of `_BlockStats`: running max
// m and denominator l (with the m_safe guard), the label logit, the sum of
// logits (only with label smoothing) and the first-occurrence argmax. The
// overhang of the last block past V is masked, as the reference masks its
// zero-padded tail. Emits lse = m + log(max(l, 1e-37)), the label logit, the
// logit sum and the argmax per row; the [M, V] logits never exist.
//
// Design. The TPU kernel walks a (row tile, vocab block) grid in order and
// carries the statistics in VMEM scratch; here one block of 256 threads
// owns 64 rows and loops over every vocab block itself, in order. Inside a
// vocab block it computes 64 x 128 logit sub-tiles with a shared-memory
// tiled FFMA product over D (stages of 32: x as [32][65], w as [32][129],
// padded so that neither the transposing stores nor the reads conflict;
// both weight layouts, [V, D] and [D, V], load coalesced). Thread (ty, tx)
// owns rows ty*4 .. ty*4+3 and columns tx + 16 j, j < 8; the 16 threads of
// a row sit in one half-warp, and each sub-tile's statistics are folded in
// with shuffle reductions. Folding per 128-column sub-tile instead of per
// vocab block changes only the rounding of the rescaling: the smallest
// index within a sub-tile and a strict > across sub-tiles still give the
// first occurrence over the whole vocabulary. A sub-tile that lies wholly
// past V is skipped, which is exactly a no-op for every statistic.
//
// Bound: 2 M V D flops on the CUDA cores (float32, TF32 off): at the main
// path's shapes (M 8192, V 32000, D 2048) 1.07 TFLOP, 16 ms at 67 TFLOP/s
// on an H100 SXM; the bytes (x and w read once, 0.33 GB) take 0.1 ms, so
// the kernel is bound by operations. What this design leaves on the table:
// the tensor cores (wgmma), an x tile kept resident instead of re-read for
// every sub-tile, double buffering of the stages, and one block per SM of 8
// warps for 128 row tiles on 132 SMs. Every row tile streams the whole
// weight table, 128 x 262 MB of L2-to-SM traffic, which stays in L2 only as
// long as the blocks march through the vocabulary together.
//
// Limits (the Python wrapper raises outside them): float32 or bfloat16,
// contiguous tensors, labels in [0, V).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 64;       // rows of x per block
constexpr int kCols = 128;      // vocab columns per logit sub-tile
constexpr int kDepth = 32;      // D per shared-memory stage
constexpr int kThreads = 256;   // 16 x 16: ty row group, tx column lane
constexpr int kXs = kRows + 1;  // row stride of the [kDepth][kRows] x stage
constexpr int kWs = kCols + 1;  // row stride of the [kDepth][kCols] w stage
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF
constexpr int kBigIdx = 1 << 30;     // the reference _BIG_IDX

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

__global__ void __launch_bounds__(kThreads, 1) FusedXentStatsKernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ labels,
    float* __restrict__ lse_out, float* __restrict__ llog_out,
    float* __restrict__ sum_out, int* __restrict__ amax_out, int m_rows,
    int d, int vocab, int block_size, int vd, float soft_cap, int need_sum) {
  __shared__ float xs[kDepth * kXs];
  __shared__ float ws[kDepth * kWs];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kRows;

  int label[4], amax[4];
  float m[4], l[4], sumlog[4], llog[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    label[i] = row < m_rows ? labels[row] : -1;
    m[i] = kNegInf;
    l[i] = sumlog[i] = llog[i] = 0.f;
    amax[i] = 0;
  }
  const int num_blocks = (vocab + block_size - 1) / block_size;
  for (int blk = 0; blk < num_blocks; ++blk) {
    const int start = blk * block_size;
    const int end = min(start + block_size, vocab);  // valid columns
    for (int c0 = start; c0 < end; c0 += kCols) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int d0 = 0; d0 < d; d0 += kDepth) {
        __syncthreads();  // the previous stage is consumed
        for (int idx = tid; idx < kRows * kDepth; idx += kThreads) {
          const int r = idx / kDepth, dd = idx % kDepth;
          const int row = r0 + r, dc = d0 + dd;
          xs[dd * kXs + r] = (row < m_rows && dc < d)
                                 ? x[static_cast<size_t>(row) * d + dc]
                                 : 0.f;
        }
        if (vd) {  // w [V, D]: threads along D
          for (int idx = tid; idx < kCols * kDepth; idx += kThreads) {
            const int c = idx / kDepth, dd = idx % kDepth;
            const int col = c0 + c, dc = d0 + dd;
            ws[dd * kWs + c] = (col < vocab && dc < d)
                                   ? w[static_cast<size_t>(col) * d + dc]
                                   : 0.f;
          }
        } else {   // w [D, V]: threads along V
          for (int idx = tid; idx < kCols * kDepth; idx += kThreads) {
            const int dd = idx / kCols, c = idx % kCols;
            const int col = c0 + c, dc = d0 + dd;
            ws[dd * kWs + c] = (col < vocab && dc < d)
                                   ? w[static_cast<size_t>(dc) * vocab + col]
                                   : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int dd = 0; dd < kDepth; ++dd) {
          float a[4], b[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[dd * kXs + ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = ws[dd * kWs + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }
      }
      // bias and cap (`_BlockLogits`), then the statistics (`_BlockStats`)
      bool valid[8];
      int col[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        col[j] = c0 + tx + 16 * j;
        valid[j] = col[j] < end;
        const float bj = col[j] < vocab ? bias[col[j]] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = s[i][j] + bj;
          if (soft_cap > 0.f) v = soft_cap * tanhf(v / soft_cap);
          s[i][j] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sm[8];
        float m_cur = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sm[j] = valid[j] ? s[i][j] : kNegInf;
          m_cur = fmaxf(m_cur, sm[j]);
        }
        m_cur = GroupMax(m_cur);
        const float m_new = fmaxf(m[i], m_cur);
        // all-masked-so-far rows: masked entries must give p = 0
        const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
        float psum = 0.f, lab = 0.f, tot = 0.f;
        int idx = kBigIdx;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          psum += expf(sm[j] - m_safe);
          if (valid[j] && col[j] == label[i]) lab += s[i][j];
          if (valid[j]) tot += s[i][j];
          if (sm[j] >= m_cur) idx = min(idx, col[j]);
        }
        psum = GroupSum(psum);
        lab = GroupSum(lab);
        if (need_sum) sumlog[i] += GroupSum(tot);
        idx = GroupMin(idx);
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + psum;
        llog[i] += lab;
        // first occurrence: strict > keeps the earlier sub-tile on ties
        if (m_cur > m[i]) amax[i] = idx;
        m[i] = m_new;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      if (row >= m_rows) continue;
      lse_out[row] = m[i] + logf(fmaxf(l[i], 1e-37f));
      llog_out[row] = llog[i];
      sum_out[row] = sumlog[i];
      amax_out[row] = amax[i];
    }
  }
}

// ---- bfloat16: the tensor-core kernel -------------------------------------
//
// The bf16 half (x and w bf16, every statistic float32, as the reference's
// `_BlockLogits` / `_BlockStats`: s = f32(x . w) + f32(b), the tanh cap in
// float32). A bf16 x bf16 product is exact in float32, so the logits differ
// from the reference's only in the order of their sums; nothing inside is
// rounded to bf16. One block of 8 warps owns 64 rows and walks the whole
// vocabulary in 128-column sub-tiles; warp w computes rows 16 (w % 4) ..
// + 15 against columns 64 (w / 4) .. + 63 of each sub-tile with mma.sync
// m16n8k16 (bf16 -> f32), D in stages of 64 staged by 16-byte cp.async
// into a double buffer (row stride 72 elements: conflict-free 32-bit
// fragment loads). Each warp folds its sub-tile columns into running
// statistics of its rows (a row lives in the 4 lanes of a quad); at the
// end the two column warps of a row merge through shared memory (the
// smaller index wins a tie of maxima: the first occurrence).
//
// Bound: 2 M V D flops on the bf16 tensor cores, 1.07 TFLOP at the main
// path's shapes: 1.09 ms at 989 TFLOP/s; x and w (0.17 GB) take 0.05 ms.
// What it leaves: wgmma / TMA, and the x tile is re-read from L2 for every
// sub-tile. Takes the [V, D] (tied-table) layout and D a multiple of 8.

typedef __nv_bfloat16 bf16;

constexpr int kHRows = 64;        // rows of x per block
constexpr int kHCols = 128;       // vocab columns per sub-tile
constexpr int kHDepth = 64;       // D per stage
constexpr int kHThreads = 256;    // 8 warps: 4 row groups x 2 column groups
constexpr int kHLd = kHDepth + 8; // row stride (elements) of a staged tile
constexpr size_t kHStageElems = static_cast<size_t>(kHRows + kHCols) * kHLd;
constexpr size_t kHSmemBytes =
    2 * kHStageElems * sizeof(bf16) + kHRows * 5 * sizeof(float);

__device__ __forceinline__ int QuadMin(int x) {
  x = min(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return min(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One row's running statistics over the columns its warp sees.
struct RowStats {
  float m, l, sum, llog;
  int amax;
};

// Folds one sub-tile's 16 logits of a row (s[nt][e0], s[nt][e0 + 1],
// columns cbase + nt * 8 + 2 tig + {0, 1}) into st: bias, cap, then the
// reference's `_BlockStats` with every column past V masked.
__device__ __forceinline__ void FoldRow(RowStats& st, float s[8][4], int e0,
                                        int cbase, int vocab, int label,
                                        const bf16* __restrict__ bias,
                                        float soft_cap, int need_sum) {
  const int tig = threadIdx.x & 3;
  float m_cur = kNegInf;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cbase + nt * 8 + 2 * tig + e;
      float val = s[nt][e0 + e];
      if (col < vocab) {
        val += __bfloat162float(bias[col]);
        if (soft_cap > 0.f) val = soft_cap * tanhf(val / soft_cap);
      } else {
        val = kNegInf;
      }
      s[nt][e0 + e] = val;
      m_cur = fmaxf(m_cur, val);
    }
  m_cur = QuadMax(m_cur);
  const float m_new = fmaxf(st.m, m_cur);
  // all-masked-so-far rows: masked entries must give p = 0
  const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
  float psum = 0.f, lab = 0.f, tot = 0.f;
  int idx = kBigIdx;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cbase + nt * 8 + 2 * tig + e;
      const float val = s[nt][e0 + e];
      psum += expf(val - m_safe);
      if (col < vocab) {
        if (col == label) lab += val;
        tot += val;
        if (val >= m_cur) idx = min(idx, col);
      }
    }
  psum = QuadSum(psum);
  lab = QuadSum(lab);
  if (need_sum) st.sum += QuadSum(tot);
  idx = QuadMin(idx);
  const float alpha = expf(st.m - m_new);
  st.l = alpha * st.l + psum;
  st.llog += lab;
  // first occurrence: strict > keeps the earlier sub-tile on ties
  if (m_cur > st.m) st.amax = idx;
  st.m = m_new;
}

__global__ void __launch_bounds__(kHThreads) FusedXentStatsBf16Kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const int* __restrict__ labels,
    float* __restrict__ lse_out, float* __restrict__ llog_out,
    float* __restrict__ sum_out, int* __restrict__ amax_out, int m_rows,
    int d, int vocab, float soft_cap, int need_sum) {
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* stages = reinterpret_cast<bf16*>(hsmem);   // [2][(64 + 128) x 72]
  float* merge = reinterpret_cast<float*>(hsmem + 2 * kHStageElems *
                                          sizeof(bf16));   // [64][5]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int r0 = blockIdx.x * kHRows;
  const int lr_a = rg * 16 + g, lr_b = lr_a + 8;   // rows within the block
  const int label_a = r0 + lr_a < m_rows ? labels[r0 + lr_a] : -1;
  const int label_b = r0 + lr_b < m_rows ? labels[r0 + lr_b] : -1;
  RowStats st_a = {kNegInf, 0.f, 0.f, 0.f, 0};
  RowStats st_b = st_a;
  const int nds = (d + kHDepth - 1) / kHDepth;
  const int nsub = (vocab + kHCols - 1) / kHCols;
  const int nsteps = nsub * nds;

  auto prefetch = [&](int step, int stage) {
    if (step < nsteps) {
      const int sub = step / nds, d0 = (step - sub * nds) * kHDepth;
      bf16* xd = stages + stage * kHStageElems;
      bf16* wd = xd + kHRows * kHLd;
      for (int c = tid; c < (kHRows + kHCols) * (kHDepth / 8);
           c += kHThreads) {
        const int r = c >> 3, dc = d0 + 8 * (c & 7);
        if (r < kHRows) {
          const int row = r0 + r;
          const bool valid = row < m_rows && dc < d;
          CpAsyncBytes16(xd + r * kHLd + 8 * (c & 7),
                    x + (valid ? static_cast<size_t>(row) * d + dc : 0),
                    valid);
        } else {
          const int col = sub * kHCols + r - kHRows;
          const bool valid = col < vocab && dc < d;
          CpAsyncBytes16(wd + (r - kHRows) * kHLd + 8 * (c & 7),
                    w + (valid ? static_cast<size_t>(col) * d + dc : 0),
                    valid);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float s[8][4];
  prefetch(0, 0);
  for (int step = 0, stage = 0; step < nsteps; ++step, stage ^= 1) {
    prefetch(step + 1, stage ^ 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int sub = step / nds, dstep = step - sub * nds;
    if (dstep == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    const bf16* xt = stages + stage * kHStageElems;
    const bf16* wt = xt + kHRows * kHLd;
#pragma unroll
    for (int kk = 0; kk < kHDepth / 16; ++kk) {
      const bf16* ap = xt + lr_a * kHLd + kk * 16 + 2 * tig;
      const uint32_t a[4] = {Ld32(ap), Ld32(ap + 8 * kHLd), Ld32(ap + 8),
                             Ld32(ap + 8 * kHLd + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* bp = wt + (cg * 64 + nt * 8 + g) * kHLd + kk * 16 +
                         2 * tig;
        MmaBf16(s[nt], a, Ld32(bp), Ld32(bp + 8));
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
    if (dstep == nds - 1) {
      const int cbase = sub * kHCols + cg * 64;
      FoldRow(st_a, s, 0, cbase, vocab, label_a, bias, soft_cap, need_sum);
      FoldRow(st_b, s, 2, cbase, vocab, label_b, bias, soft_cap, need_sum);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  // merge the two column warps of each row (column group 1 hands over)
  if (cg == 1 && tig == 0) {
    const RowStats* sts[2] = {&st_a, &st_b};
    const int lrs[2] = {lr_a, lr_b};
    for (int i = 0; i < 2; ++i) {
      float* mrow = merge + lrs[i] * 5;
      mrow[0] = sts[i]->m;
      mrow[1] = sts[i]->l;
      mrow[2] = sts[i]->sum;
      mrow[3] = sts[i]->llog;
      mrow[4] = __int_as_float(sts[i]->amax);
    }
  }
  __syncthreads();
  if (cg == 0 && tig == 0) {
    const RowStats* sts[2] = {&st_a, &st_b};
    const int lrs[2] = {lr_a, lr_b};
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + lrs[i];
      if (row >= m_rows) continue;
      const float* mrow = merge + lrs[i] * 5;
      const float m0 = sts[i]->m, m1 = mrow[0];
      const int a0 = sts[i]->amax, a1 = __float_as_int(mrow[4]);
      const float mm = fmaxf(m0, m1);
      const float l = sts[i]->l * expf(m0 - mm) + mrow[1] * expf(m1 - mm);
      lse_out[row] = mm + logf(fmaxf(l, 1e-37f));
      llog_out[row] = sts[i]->llog + mrow[3];
      sum_out[row] = sts[i]->sum + mrow[2];
      amax_out[row] = m0 > m1 ? a0 : m1 > m0 ? a1 : min(a0, a1);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// x [M, D]; w [V, D] (vd = 1) or [D, V] (vd = 0); bias [V]; labels [M]
// int32 in [0, V); outputs lse/llog/sum float32 [M], amax int32 [M]. All
// contiguous, on one device. sum is 0 unless need_sum.
int FusedXentStatsF32(const float* x, const float* w, const float* bias,
                      const int* labels, float* lse, float* llog,
                      float* sumlog, int* amax, int m_rows, int d, int vocab,
                      int block_size, int vd, float soft_cap, int need_sum,
                      void* stream) {
  if (m_rows <= 0 || d <= 0 || vocab <= 0 || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((m_rows + kRows - 1) / kRows);
  FusedXentStatsKernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, labels, lse, llog, sumlog, amax, m_rows, d, vocab,
      block_size, vd, soft_cap, need_sum);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 kernel: x [M, D], w [V, D] and bias [V] bf16 (the [V, D]
// layout only, D a multiple of 8), the rest as above.
int FusedXentStatsBF16(const void* x, const void* w, const void* bias,
                       const int* labels, float* lse, float* llog,
                       float* sumlog, int* amax, int m_rows, int d, int vocab,
                       float soft_cap, int need_sum, void* stream) {
  if (m_rows <= 0 || d <= 0 || d % 8 != 0 || vocab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      FusedXentStatsBf16Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kHSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((m_rows + kHRows - 1) / kHRows);
  FusedXentStatsBf16Kernel<<<blocks, kHThreads, kHSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), labels, lse, llog, sumlog, amax,
      m_rows, d, vocab, soft_cap, need_sum);
  return static_cast<int>(cudaGetLastError());
}

const char* FusedXentErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
