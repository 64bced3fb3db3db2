// Flash attention with a causal and a segment mask for Hopper (sm_90a),
// float32: the forward pass and the two backward passes.
//
// Replaces the three Pallas TPU kernels of lingvo_tpu/ops/flash_attention.py:
//   FlashFwdKernel   <- `_FwdKernel`   (pallas_call in `_FlashForward`)
//   FlashDkDvKernel  <- `_DkDvKernel`  (first pallas_call in `_FlashBackward`)
//   FlashDqKernel    <- `_DqKernel`    (second pallas_call in `_FlashBackward`)
// It computes the same functions, not the same blocks: softmax attention
// over [b, t, n, h] tensors with s = (q . k) / sqrt(h), a causal mask and a
// segment mask (pairs with different ids never attend; padding carries 0),
// the float32 online softmax with the reference's m_safe guard, out =
// acc / max(l, 1e-20) and lse = m + log(max(l, 1e-20)); the backward
// recomputes p = exp(s - lse) and ds = p * (dp - delta) * sm_scale in ONE
// device function (`RecomputePandDs`, the reference `_RecomputePandDs`)
// shared by both backward kernels, with delta = rowsum(do * out) computed
// by the caller.
//
// Design. The TPU kernels walk a sequential grid and carry m / l / acc in
// VMEM scratch from one key block to the next; CUDA blocks run in no order,
// so the key (or query) loop moved inside the block. One block of 256
// threads per (64-row tile, batch x head): the forward and dQ blocks own 64
// queries and loop over 64-key tiles, the dK/dV block owns 64 keys and loops
// over 64-query tiles. q/k/v/do are read in their [b, t, n, h] layout by
// index (no transposed copies); lse and delta are [b, n, t]. Tiles are
// staged in dynamic shared memory (116 KB forward, 166 KB dK/dV, 150 KB dQ
// at h = 128) with a row stride of h + 1 so that the column reads of K are
// free of bank conflicts. Thread (ty, tx) of a 16 x 16 layout owns score
// rows ty*4 .. ty*4+3 and columns tx + 16 j; the 16 threads of a row sit in
// one half-warp and reduce with shuffles; m and l stay in registers, and
// each thread owns 4 rows x h/16 columns of the output accumulator. Tiles
// entirely in the causal future are never visited, and a tile whose
// segment-id range is disjoint from the block's is skipped (exactly a no-op
// in the online softmax: every pair of it is masked).
//
// Bound: every product is float32 on the CUDA cores (TF32 stays off for the
// parity bar), so at the main path's shapes these kernels are bound by
// operations: 4h (forward), 8h (dK/dV) and 6h (dQ) flops per attended pair
// over 67 TFLOP/s on an H100 SXM. What this simple design leaves on the
// table: no tensor cores (wgmma on bf16 or tf32 tiles would raise the
// ceiling ~15x), one block of 8 warps per SM (latency is hidden poorly), the
// scalar shared-memory loads of the inner products, no TMA or cp.async
// double buffering of the next tile, and rows of a segment boundary that
// fall inside a tile still pay for the masked half of that tile.
//
// Limits (the Python wrapper raises outside them): float32, contiguous
// [b, t, n, h] tensors, h a multiple of 16 and at most 128; any t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // queries of a q tile, keys of a k tile
constexpr int kThreads = 256;    // 16 x 16 threads: ty row group, tx lane
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDCols = kMaxHeadDim / 16;  // head-dim columns per thread
constexpr int kPs = kTile + 1;   // row stride of the [64, 64] p / ds tiles
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

struct Problem {
  int t, n, h, causal;
  float sm_scale;

  // start of row (bi, ti, ni, :) of a [b, t, n, h] tensor
  __device__ size_t Off(int bi, int ti, int ni) const {
    return ((static_cast<size_t>(bi) * t + ti) * n + ni) * h;
  }
  // element (bi, ni, ti) of a [b, n, t] row statistic
  __device__ size_t RowOff(int bi, int ni, int ti) const {
    return (static_cast<size_t>(bi) * n + ni) * t + ti;
  }
};

__device__ __forceinline__ float GroupMax(float x) {
  // over the 16 lanes of a half-warp (one score row); every lane gets it
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float GroupSum(float x) {
  // butterfly: each lane adds the same pairs, so all 16 get the same bits
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [start, start + 64) of head ni, batch bi of a [b, t, n, h] tensor
// into dst (row stride ld); rows past t read as 0.
__device__ void LoadTile(float* dst, int ld, const float* __restrict__ src,
                         const Problem& pb, int bi, int ni, int start) {
  const int h = pb.h;
  for (int idx = threadIdx.x; idx < kTile * h; idx += kThreads) {
    const int r = idx / h;
    const int d = idx - r * h;
    const int row = start + r;
    dst[r * ld + d] = row < pb.t ? src[pb.Off(bi, row, ni) + d] : 0.f;
  }
}

// Row statistics (lse or delta) of rows [start, start + 64); 0 past t.
__device__ void LoadRows(float* dst, const float* __restrict__ src,
                         const Problem& pb, int bi, int ni, int start) {
  const int row = start + threadIdx.x;
  if (threadIdx.x < kTile) dst[threadIdx.x] =
      row < pb.t ? src[pb.RowOff(bi, ni, row)] : 0.f;
}

// Segment ids of rows [start, start + 64) (0 without segments or past t).
__device__ void LoadSeg(int* dst, const int* __restrict__ seg,
                        const Problem& pb, int bi, int start) {
  const int row = start + threadIdx.x;
  if (threadIdx.x < kTile) dst[threadIdx.x] =
      (seg != nullptr && row < pb.t) ? seg[static_cast<size_t>(bi) * pb.t + row]
                                     : 0;
}

// [lo, hi] of a loaded id tile over its rows below t (every thread).
__device__ void SegRange(const int* ids, int start, int t, int* lo, int* hi) {
  int a = 0x7fffffff, z = -0x7fffffff - 1;
  const int rows = min(kTile, t - start);
  for (int r = 0; r < rows; ++r) {
    a = min(a, ids[r]);
    z = max(z, ids[r]);
  }
  *lo = a;
  *hi = z;
}

// s[i][j] = (q . k) * sm_scale for query q0 + ty*4 + i and key
// k0 + tx + 16 j where the pair is kept, else kNegInf (the reference's
// `_DotF32(q, k) * sm_scale`, then the causal and segment masks).
__device__ __forceinline__ void ScoreTile(
    float s[4][4], const float* qs, const float* ks, int ld, const int* segq,
    const int* segk, bool has_seg, const Problem& pb, int q0, int k0, int ty,
    int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < pb.h; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool keep = qi < pb.t && kj < pb.t && (!pb.causal || qi >= kj) &&
                        (!has_seg || segq[ty * 4 + i] == segk[tx + 16 * j]);
      s[i][j] = keep ? s[i][j] * pb.sm_scale : kNegInf;
    }
  }
}

// The backward recompute both backward kernels share: p = exp(s - lse) and
// ds = p * (dp - delta) * sm_scale with dp = do . v, for the thread's
// 4 x 4 patch (rows = queries, columns = keys).
__device__ __forceinline__ void RecomputePandDs(
    float p[4][4], float ds[4][4], const float* qs, const float* ks,
    const float* vs, const float* dos, int ld, const float* lse_s,
    const float* delta_s, const int* segq, const int* segk, bool has_seg,
    const Problem& pb, int q0, int k0, int ty, int tx) {
  ScoreTile(p, qs, ks, ld, segq, segk, has_seg, pb, q0, k0, ty, tx);
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
  for (int d = 0; d < pb.h; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = dos[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = vs[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lse = lse_s[ty * 4 + i];
    const float delta = delta_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = expf(p[i][j] - lse);
      ds[i][j] = p[i][j] * (dp[i][j] - delta) * pb.sm_scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) FlashFwdKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    float* __restrict__ out, float* __restrict__ lse, Problem pb) {
  extern __shared__ float smem[];
  const int h = pb.h, ld = h + 1, ndc = h / 16;
  float* qs = smem;                 // [64][h + 1]
  float* ks = qs + kTile * ld;      // [64][h + 1]
  float* vs = ks + kTile * ld;      // [64][h]
  float* ps = vs + kTile * h;       // [64][65]
  int* segq = reinterpret_cast<int*>(ps + kTile * kPs);
  int* segk = segq + kTile;
  const int q0 = blockIdx.x * kTile;
  const int bi = blockIdx.y / pb.n, ni = blockIdx.y % pb.n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool has_seg = seg != nullptr;

  LoadTile(qs, ld, q, pb, bi, ni, q0);
  LoadSeg(segq, seg, pb, bi, q0);
  __syncthreads();
  int qlo, qhi;
  SegRange(segq, q0, pb.t, &qlo, &qhi);

  float m[4], l[4], acc[4][kMaxDCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c) acc[i][c] = 0.f;
  }
  // key tiles entirely in the causal future are never visited
  const int k_end = pb.causal ? min(pb.t, q0 + kTile) : pb.t;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    LoadSeg(segk, seg, pb, bi, k0);
    __syncthreads();
    if (has_seg) {
      int klo, khi;
      SegRange(segk, k0, pb.t, &klo, &khi);
      if (khi < qlo || klo > qhi) continue;  // every pair masked: a no-op
    }
    LoadTile(ks, ld, k, pb, bi, ni, k0);
    LoadTile(vs, h, v, pb, bi, ni, k0);
    __syncthreads();
    float s[4][4];
    ScoreTile(s, qs, ks, ld, segq, segk, has_seg, pb, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m_cur = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      m_cur = GroupMax(m_cur);
      const float m_new = fmaxf(m[i], m_cur);
      // rows with no unmasked key yet: masked entries must give p = 0
      const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        ps[(ty * 4 + i) * kPs + tx + 16 * j] = p;
        psum += p;
      }
      psum = GroupSum(psum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int c = 0; c < kMaxDCols; ++c) {
        if (c < ndc) {
          const float vv = vs[kk * h + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= pb.t) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* o = out + pb.Off(bi, row, ni);
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c)
      if (c < ndc) o[tx + 16 * c] = acc[i][c] / denom;
    if (tx == 0) lse[pb.RowOff(bi, ni, row)] = m[i] + logf(denom);
  }
}

__global__ void __launch_bounds__(kThreads, 1) FlashDkDvKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, Problem pb) {
  extern __shared__ float smem[];
  const int h = pb.h, ld = h + 1, ndc = h / 16;
  float* ks = smem;                 // [64][h + 1], this block's keys
  float* vs = ks + kTile * ld;      // [64][h + 1]
  float* qs = vs + kTile * ld;      // [64][h + 1], the current query tile
  float* dos = qs + kTile * ld;     // [64][h + 1]
  float* ps = dos + kTile * ld;     // [64 queries][65]
  float* dss = ps + kTile * kPs;    // [64 queries][65]
  float* lse_s = dss + kTile * kPs;
  float* delta_s = lse_s + kTile;
  int* segq = reinterpret_cast<int*>(delta_s + kTile);
  int* segk = segq + kTile;
  const int k0 = blockIdx.x * kTile;
  const int bi = blockIdx.y / pb.n, ni = blockIdx.y % pb.n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool has_seg = seg != nullptr;

  LoadTile(ks, ld, k, pb, bi, ni, k0);
  LoadTile(vs, ld, v, pb, bi, ni, k0);
  LoadSeg(segk, seg, pb, bi, k0);
  __syncthreads();
  int klo, khi;
  SegRange(segk, k0, pb.t, &klo, &khi);

  // this thread's key rows ty*4 + i, head-dim columns tx + 16 c
  float dka[4][kMaxDCols], dva[4][kMaxDCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c) dka[i][c] = dva[i][c] = 0.f;
  // the first causally live query tile is the one holding query k0
  for (int q0 = pb.causal ? k0 : 0; q0 < pb.t; q0 += kTile) {
    __syncthreads();
    LoadSeg(segq, seg, pb, bi, q0);
    __syncthreads();
    if (has_seg) {
      int qlo, qhi;
      SegRange(segq, q0, pb.t, &qlo, &qhi);
      if (khi < qlo || klo > qhi) continue;
    }
    LoadTile(qs, ld, q, pb, bi, ni, q0);
    LoadTile(dos, ld, dout, pb, bi, ni, q0);
    LoadRows(lse_s, lse, pb, bi, ni, q0);
    LoadRows(delta_s, delta, pb, bi, ni, q0);
    __syncthreads();
    float p[4][4], ds[4][4];
    RecomputePandDs(p, ds, qs, ks, vs, dos, ld, lse_s, delta_s, segq, segk,
                    has_seg, pb, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty * 4 + i) * kPs + tx + 16 * j] = p[i][j];
        dss[(ty * 4 + i) * kPs + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dv += p^T do, dk += ds^T q over the tile's 64 queries
    for (int qq = 0; qq < kTile; ++qq) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = ps[qq * kPs + ty * 4 + i];
        dsk[i] = dss[qq * kPs + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < kMaxDCols; ++c) {
        if (c < ndc) {
          const float doc = dos[qq * ld + tx + 16 * c];
          const float qc = qs[qq * ld + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][c] = fmaf(pk[i], doc, dva[i][c]);
            dka[i][c] = fmaf(dsk[i], qc, dka[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= pb.t) continue;
    const size_t off = pb.Off(bi, row, ni);
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c) {
      if (c < ndc) {
        dk[off + tx + 16 * c] = dka[i][c];
        dv[off + tx + 16 * c] = dva[i][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) FlashDqKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, Problem pb) {
  extern __shared__ float smem[];
  const int h = pb.h, ld = h + 1, ndc = h / 16;
  float* qs = smem;                 // [64][h + 1], this block's queries
  float* dos = qs + kTile * ld;     // [64][h + 1]
  float* ks = dos + kTile * ld;     // [64][h + 1], the current key tile
  float* vs = ks + kTile * ld;      // [64][h + 1]
  float* dss = vs + kTile * ld;     // [64 queries][65]
  float* lse_s = dss + kTile * kPs;
  float* delta_s = lse_s + kTile;
  int* segq = reinterpret_cast<int*>(delta_s + kTile);
  int* segk = segq + kTile;
  const int q0 = blockIdx.x * kTile;
  const int bi = blockIdx.y / pb.n, ni = blockIdx.y % pb.n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool has_seg = seg != nullptr;

  LoadTile(qs, ld, q, pb, bi, ni, q0);
  LoadTile(dos, ld, dout, pb, bi, ni, q0);
  LoadRows(lse_s, lse, pb, bi, ni, q0);
  LoadRows(delta_s, delta, pb, bi, ni, q0);
  LoadSeg(segq, seg, pb, bi, q0);
  __syncthreads();
  int qlo, qhi;
  SegRange(segq, q0, pb.t, &qlo, &qhi);

  float dqa[4][kMaxDCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c) dqa[i][c] = 0.f;
  const int k_end = pb.causal ? min(pb.t, q0 + kTile) : pb.t;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    LoadSeg(segk, seg, pb, bi, k0);
    __syncthreads();
    if (has_seg) {
      int klo, khi;
      SegRange(segk, k0, pb.t, &klo, &khi);
      if (khi < qlo || klo > qhi) continue;
    }
    LoadTile(ks, ld, k, pb, bi, ni, k0);
    LoadTile(vs, ld, v, pb, bi, ni, k0);
    __syncthreads();
    float p[4][4], ds[4][4];
    RecomputePandDs(p, ds, qs, ks, vs, dos, ld, lse_s, delta_s, segq, segk,
                    has_seg, pb, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * kPs + tx + 16 * j] =
          ds[i][j];
    __syncthreads();
    // dq += ds k over the tile's 64 keys
    for (int kk = 0; kk < kTile; ++kk) {
      float dsq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsq[i] = dss[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int c = 0; c < kMaxDCols; ++c) {
        if (c < ndc) {
          const float kc = ks[kk * ld + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dqa[i][c] = fmaf(dsq[i], kc, dqa[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= pb.t) continue;
    float* o = dq + pb.Off(bi, row, ni);
#pragma unroll
    for (int c = 0; c < kMaxDCols; ++c)
      if (c < ndc) o[tx + 16 * c] = dqa[i][c];
  }
}

size_t FloatsBytes(size_t floats) { return floats * sizeof(float); }

bool BadShape(int b, int t, int n, int h) {
  return b <= 0 || t <= 0 || n <= 0 || h <= 0 || h % 16 != 0 ||
         h > kMaxHeadDim;
}

Problem MakeProblem(int t, int n, int h, int causal) {
  Problem pb;
  pb.t = t;
  pb.n = n;
  pb.h = h;
  pb.causal = causal;
  pb.sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(h)));
  return pb;
}

// Opts the kernel into `smem` bytes of dynamic shared memory (above the
// 48 KB default); returns that call's error.
template <typename Kernel>
cudaError_t AllowSmem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = ok). q/k/v/out/do/dq/dk/dv: contiguous [b, t, n, h] float32;
// lse/delta: [b, n, t] float32; seg: [b, t] int32 or NULL (no segments).

int FlashFwdF32(const float* q, const float* k, const float* v,
                const int* seg, float* out, float* lse, int b, int t, int n,
                int h, int causal, void* stream) {
  if (BadShape(b, t, n, h)) return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = FloatsBytes(2 * kTile * (h + 1) + kTile * h +
                                  kTile * kPs) + 2 * kTile * sizeof(int);
  cudaError_t err = AllowSmem(FlashFwdKernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FlashFwdKernel<<<dim3((t + kTile - 1) / kTile, b * n), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(q, k, v, seg, out,
                                                        lse, pb);
  return static_cast<int>(cudaGetLastError());
}

int FlashBwdDkDvF32(const float* q, const float* k, const float* v,
                    const int* seg, const float* dout, const float* lse,
                    const float* delta, float* dk, float* dv, int b, int t,
                    int n, int h, int causal, void* stream) {
  if (BadShape(b, t, n, h)) return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = FloatsBytes(4 * kTile * (h + 1) + 2 * kTile * kPs +
                                  2 * kTile) + 2 * kTile * sizeof(int);
  cudaError_t err = AllowSmem(FlashDkDvKernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FlashDkDvKernel<<<dim3((t + kTile - 1) / kTile, b * n), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, seg, dout, lse, delta, dk, dv, pb);
  return static_cast<int>(cudaGetLastError());
}

int FlashBwdDqF32(const float* q, const float* k, const float* v,
                  const int* seg, const float* dout, const float* lse,
                  const float* delta, float* dq, int b, int t, int n, int h,
                  int causal, void* stream) {
  if (BadShape(b, t, n, h)) return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = FloatsBytes(4 * kTile * (h + 1) + kTile * kPs +
                                  2 * kTile) + 2 * kTile * sizeof(int);
  cudaError_t err = AllowSmem(FlashDqKernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FlashDqKernel<<<dim3((t + kTile - 1) / kTile, b * n), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      q, k, v, seg, dout, lse, delta, dq, pb);
  return static_cast<int>(cudaGetLastError());
}

const char* FlashErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
