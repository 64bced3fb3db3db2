// Fused LM-head cross-entropy statistics for Hopper (sm_90a), float32.
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
// Limits (the Python wrapper raises outside them): float32, contiguous
// tensors, labels in [0, V).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

const char* FusedXentErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
