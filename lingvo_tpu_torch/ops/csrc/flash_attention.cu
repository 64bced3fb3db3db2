// Flash attention with a causal and a segment mask for Hopper (sm_90a),
// float32 and bfloat16: the forward pass and the two backward passes.
//
// Replaces the three Pallas TPU kernels of lingvo_tpu/ops/flash_attention.py:
//   FlashFwdKernel   <- `_FwdKernel`   (pallas_call in `_FlashForward`)
//   FlashDkDvKernel  <- `_DkDvKernel`  (first pallas_call in `_FlashBackward`)
//   FlashDqKernel    <- `_DqKernel`    (second pallas_call in `_FlashBackward`)
// It computes the same functions, not the same blocks: softmax attention
// over [b, t, n, h] tensors with s = (q . k) / sqrt(h), a causal mask and a
// segment mask (pairs with different ids never attend; padding carries 0),
// the float32 online softmax with the reference's m_safe guard, out =
// acc / max(l, 1e-20) and lse = m + log(max(l, 1e-20)); the float32
// backward recomputes p = exp(s - lse) and ds = p * (dp - delta) *
// sm_scale in ONE device function (`RecomputePandDs`, the reference
// `_RecomputePandDs`) shared by both of its kernels, with delta =
// rowsum(do * out) computed by the caller.
//
// Design. The TPU kernels walk a sequential grid and carry m / l / acc in
// VMEM scratch from one key block to the next; CUDA blocks run in no order,
// so the key (or query) loop moved inside the block. q/k/v/do are read in
// their [b, t, n, h] layout by index (no transposed copies); lse and delta
// are [b, n, t]. Tiles entirely in the causal future are never visited, and
// a tile whose segment-id range is disjoint from the block's is skipped
// (exactly a no-op in the online softmax: every pair of it is masked).
//
// Bound: every product is float32 on the CUDA cores (TF32 stays off for the
// parity bar), so at the main path's shapes these kernels are bound by
// operations: 4h (forward), 8h (dK/dV) and 6h (dQ) flops per attended pair
// over 67 TFLOP/s on an H100 SXM.
//
// The forward (FlashFwdKernel, redesigned for this card; its own section
// below says how): 128 threads per (64 queries, batch x head) over 32-key
// tiles, 4 x 4 score and 4 x h/8 output patches per thread fed by 16-byte
// shared loads (at least 4 FFMA per 4 bytes loaded), the next K/V tile
// copied with cp.async under this tile's math, 110 KB of shared memory at
// h = 128 so two blocks fit on an SM. What it leaves: no tensor cores
// (3xTF32 or bf16 wgmma, ROADMAP item 1.4), and rows of a segment boundary
// inside a tile still pay for the masked part of that tile.
//
// The backward (FlashDkDvKernel, FlashDqKernel, redesigned for this card;
// their own section below says how): one block of 256 threads per (64
// owned rows, batch x head), the heaviest causal blocks first. The dK/dV
// block owns 64 keys and streams 32-query tiles (Q, dO, lse, delta); the
// dQ block owns 64 queries and streams 64-key tiles (K, V). Every product
// reads float4s from shared memory into 8 x 8 register patches (the score
// patches split h over 4 or 2 lanes and sum the slices with shuffles): 4
// FFMA per float loaded, what the shared-memory port needs to keep the
// CUDA cores busy. The next tile's 16-byte cp.async copies run under this
// tile's math, and a live-tile bitmask built once per block skips the
// tiles of other segments without copying them. What it leaves: the CUDA
// cores' float32 rate (3xTF32 is ROADMAP item 13.7), one block of 8 warps
// per SM (two stages of the streamed tiles take 151 / 217 KiB at h =
// 128) and so little to hide latency with, the issue slots of the
// reductions, the recompute and the copies, and the masked half of each
// diagonal tile.
//
// The bfloat16 halves (FlashFwdBf16Kernel, FlashDkDvBf16Kernel,
// FlashDqBf16Kernel) have their own section below: all three are
// warpgroup MMA (wgmma) fed by TMA, with p and ds rounded to bf16 where
// the reference rounds them. The backward pair replaced an mma.sync pair
// that reached 9% of the dense bf16 rate; at [8, 1024, 16, 128] it is
// bound by bytes (0.0604 ms for dK/dV, 0.0504 ms for dQ), and its
// section says what the design does about that and what it leaves.
//
// Limits (the Python wrapper raises outside them): float32 or bfloat16,
// contiguous [b, t, n, h] tensors, h a multiple of 16 and at most 128; any
// t (below 64 x 65535 in the float32 backward, 128 x 65535 in bf16); the
// bf16 forward's reference block a multiple of 64 keys or all of t.

#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
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

// ---- the forward: register-blocked tiles with cp.async double buffering --
//
// One block of 128 threads per (64-query tile, batch x head), looping over
// 32-key tiles. Thread (ty, tx) of a 16 x 8 layout (tid = 8 ty + tx; the 8
// threads of one ty are 8 adjacent lanes of one warp) owns score rows
// ty + 16 i and keys tx + 8 j (i, j < 4), and output rows ty + 16 i times
// the float4 columns 4 (tx + 8 c) (c < h / 32). Q, K and V sit in shared
// memory in their [rows, h] layout (row stride h + 4 for Q and K, so the
// float4 reads of 4 or 8 adjacent rows hit distinct banks): the score
// product reads float4s along h, 8 loads of 16 bytes per 64 FFMA; P . V
// reads a float4 of p per row and of V per key, 20 loads per 256 FFMA. The
// next K/V tile's 16-byte cp.async copies run under this tile's math (two
// stages); rows past t are zero-filled by the copy and masked. A row's
// max and sum are reduced by shuffles over its 8 lanes, and its p row is
// written and read by that warp alone (__syncwarp). Per-tile segment-id
// ranges are reduced once per block into a bitmask of live key tiles, so a
// tile whose ids are disjoint from the query tile's is never copied.

constexpr int kFq = 64;          // queries of a forward block
constexpr int kFk = 32;          // keys of a forward key tile
constexpr int kFThreads = 128;
constexpr int kFChunks = kMaxHeadDim / 32;  // float4 output columns / thread
constexpr int kFPs = kFk + 8;    // row stride of the [64, 32] p tile

struct FwdSmem {
  int ldq, ldv;                  // row strides of Q/K and of V (floats)
  size_t q, k, v, p, live;       // offsets in floats
  size_t bytes;
};

__host__ __device__ inline FwdSmem FwdLayout(int t, int h) {
  FwdSmem s;
  s.ldq = h + 4;
  s.ldv = h;
  s.q = 0;
  s.k = s.q + static_cast<size_t>(kFq) * s.ldq;
  s.v = s.k + 2 * static_cast<size_t>(kFk) * s.ldq;
  s.p = s.v + 2 * static_cast<size_t>(kFk) * s.ldv;
  s.live = s.p + static_cast<size_t>(kFq) * kFPs;
  const int words = ((t + kFk - 1) / kFk + 31) / 32;
  s.bytes = (s.live + words) * sizeof(float);
  return s;
}

// Rows [start, start + rows) of head ni, batch bi into dst (row stride ld)
// with 16-byte async copies by a block of kN threads; rows past t are
// zero-filled.
template <int kN>
__device__ __forceinline__ void CopyRowsAsync(
    float* dst, int ld, const float* __restrict__ src, const Problem& pb,
    int bi, int ni, int start, int rows) {
  const int h4 = pb.h / 4;
  for (int c = threadIdx.x; c < rows * h4; c += kN) {
    const int r = c / h4, d4 = c - r * h4;
    const int row = start + r;
    const bool valid = row < pb.t;
    CpAsync16(dst + r * ld + 4 * d4,
              src + pb.Off(bi, valid ? row : 0, ni) + 4 * d4, valid);
  }
}

// max / sum over the 8 adjacent lanes of one score row; all get the bits
__device__ __forceinline__ float RowMax8(float x) {
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float RowSum8(float x) {
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// [lo, hi] of the segment ids of rows [start, start + n) below t, reduced
// over one warp (every lane gets it); start + n - 1 < start + 64.
__device__ __forceinline__ void WarpSegRange(const int* __restrict__ seg_row,
                                             int start, int n, int t, int* lo,
                                             int* hi) {
  const int lane = threadIdx.x & 31;
  int a = 0x7fffffff, z = -0x7fffffff - 1;
  for (int r = lane; r < n; r += 32) {
    if (start + r < t) {
      const int id = seg_row[start + r];
      a = min(a, id);
      z = max(z, id);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
    z = max(z, __shfl_xor_sync(0xffffffffu, z, o));
  }
  *lo = a;
  *hi = z;
}

// Bit i of `live` (over ntiles tiles of `tile` rows) is set when tile i's
// segment-id range meets [lo, hi]; every bit without segments. Every
// thread calls it; it ends with a barrier.
__device__ void LiveTiles(unsigned* live, const int* seg_row, int lo, int hi,
                          int tile, int ntiles, int t) {
  const int words = (ntiles + 31) / 32;
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    live[w] = seg_row != nullptr ? 0u : 0xffffffffu;
  __syncthreads();
  if (seg_row != nullptr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < ntiles; i += blockDim.x >> 5) {
      int a, z;
      WarpSegRange(seg_row, i * tile, tile, t, &a, &z);
      if (lane == 0 && !(z < lo || a > hi))
        atomicOr(&live[i >> 5], 1u << (i & 31));
    }
  }
  __syncthreads();
}

// The first live tile in [kt, end), or end.
__device__ __forceinline__ int NextLive(const unsigned* live, int kt,
                                        int end) {
  while (kt < end) {
    const unsigned word = live[kt >> 5] >> (kt & 31);
    if (word) return min(end, kt + __ffs(word) - 1);
    kt = (kt | 31) + 1;
  }
  return end;
}

// the reference's masks on one score: pair (row, col) kept?
__device__ __forceinline__ bool Keep(const Problem& pb, int qi, int kj,
                                     bool has_seg, int sq, int sk) {
  return qi < pb.t && kj < pb.t && (!pb.causal || qi >= kj) &&
         (!has_seg || sq == sk);
}

__global__ void __launch_bounds__(kFThreads, 2) FlashFwdKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    float* __restrict__ out, float* __restrict__ lse, Problem pb) {
  extern __shared__ __align__(16) float smem[];
  const int h = pb.h, h4 = h / 4;
  const FwdSmem lay = FwdLayout(pb.t, h);
  float* qs = smem + lay.q;
  float* ks = smem + lay.k;       // [2][32][h + 4]
  float* vs = smem + lay.v;       // [2][32][h]
  float* ps = smem + lay.p;       // [64][40]
  unsigned* live = reinterpret_cast<unsigned*>(smem + lay.live);
  const int q0 = blockIdx.x * kFq;
  const int bi = blockIdx.y / pb.n, ni = blockIdx.y % pb.n;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;

  CopyRowsAsync<kFThreads>(qs, lay.ldq, q, pb, bi, ni, q0, kFq);
  CpAsyncCommit();

  // key tiles entirely in the causal future are never visited; with
  // segments, neither is a tile whose id range is disjoint from the
  // query tile's (every pair masked: exactly a no-op)
  const int k_end = pb.causal ? min(pb.t, q0 + kFq) : pb.t;
  const int nkt = (k_end + kFk - 1) / kFk;
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    segq[i] = has_seg && row < pb.t ? seg_row[row] : 0;
  }
  if (has_seg) {
    for (int w = tid; w < (nkt + 31) / 32; w += kFThreads) live[w] = 0u;
    int qlo, qhi;
    WarpSegRange(seg_row, q0, kFq, pb.t, &qlo, &qhi);
    __syncthreads();
    for (int kt = warp; kt < nkt; kt += kFThreads / 32) {
      int klo, khi;
      WarpSegRange(seg_row, kt * kFk, kFk, pb.t, &klo, &khi);
      if (lane == 0 && !(khi < qlo || klo > qhi))
        atomicOr(&live[kt >> 5], 1u << (kt & 31));
    }
    __syncthreads();
  }
  auto next_live = [&](int kt) {
    if (!has_seg) return kt;
    while (kt < nkt) {
      const unsigned word = live[kt >> 5] >> (kt & 31);
      if (word) return kt + __ffs(word) - 1;
      kt = (kt | 31) + 1;
    }
    return nkt;
  };
  auto prefetch = [&](int kt, int stage) {
    if (kt < nkt) {
      CopyRowsAsync<kFThreads>(ks + stage * kFk * lay.ldq, lay.ldq, k, pb,
                               bi, ni, kt * kFk, kFk);
      CopyRowsAsync<kFThreads>(vs + stage * kFk * lay.ldv, lay.ldv, v, pb,
                               bi, ni, kt * kFk, kFk);
    }
    CpAsyncCommit();
  };

  float m[4], l[4], acc[4][kFChunks][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kFChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  int kt = next_live(0);
  prefetch(kt, 0);
  for (int stage = 0; kt < nkt; stage ^= 1) {
    const int k0 = kt * kFk;
    const int nxt = next_live(kt + 1);
    prefetch(nxt, stage ^ 1);
    // this tile's key segment ids, one per lane, in flight under the wait
    const int segk_lane = has_seg && k0 + lane < pb.t ? seg_row[k0 + lane]
                                                      : 0;
    CpAsyncWait<1>();
    __syncthreads();  // Q and this tile landed
    const float* kst = ks + stage * kFk * lay.ldq;
    const float* vst = vs + stage * kFk * lay.ldv;

    // s[i][j] = (q . k) * sm_scale for query q0 + ty + 16 i and key
    // k0 + tx + 8 j where the pair is kept, else kNegInf
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < h; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * lay.ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            kst + (tx + 8 * j) * lay.ldq + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
    int segk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      segk[j] = __shfl_sync(0xffffffffu, segk_lane, tx + 8 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool keep = qi < pb.t && kj < pb.t &&
                          (!pb.causal || qi >= kj) &&
                          (!has_seg || segq[i] == segk[j]);
        s[i][j] = keep ? s[i][j] * pb.sm_scale : kNegInf;
      }
    }
    // the online softmax of each row over its 8 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m_cur = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      m_cur = RowMax8(m_cur);
      const float m_new = fmaxf(m[i], m_cur);
      // rows with no unmasked key yet: masked entries must give p = 0
      const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        ps[(ty + 16 * i) * kFPs + tx + 8 * j] = p;
        psum += p;
      }
      psum = RowSum8(psum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kFChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncwarp();  // a row's p is written and read by its own warp
#pragma unroll 2
    for (int kk = 0; kk < kFk; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * kFPs + kk);
#pragma unroll
      for (int c = 0; c < kFChunks; ++c) {
        const int cc = tx + 8 * c;
        if (cc < h4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vst + (kk + u) * lay.ldv + 4 * cc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                            : u == 2 ? pr[i].z : pr[i].w;
              acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
    kt = nxt;
  }
  CpAsyncWait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= pb.t) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* o = out + pb.Off(bi, row, ni);
#pragma unroll
    for (int c = 0; c < kFChunks; ++c) {
      const int cc = tx + 8 * c;
      if (cc < h4)
        *reinterpret_cast<float4*>(o + 4 * cc) =
            make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                        acc[i][c][2] / denom, acc[i][c][3] / denom);
    }
    if (tx == 0) lse[pb.RowOff(bi, ni, row)] = m[i] + logf(denom);
  }
}

// ---- the float32 backward: register-blocked tiles, cp.async double
// buffering --------------------------------------------------------------
//
// Replaces `_DkDvKernel` and `_DqKernel` (lingvo_tpu/ops/flash_attention.py,
// the two pallas_calls in `_FlashBackward`). Bound at [8, 1024, 16, 128]
// with two causal segments of 512: 8h (dK/dV) and 6h (dQ) flops per
// attended pair over 67 TFLOP/s float32 (0.504 and 0.378 ms), well above
// the bytes line; so the design is about keeping the CUDA cores fed.
//
// Two things keep the CUDA cores below that rate. Shared memory: an SM
// serves one 128-byte wavefront per clock, a warp's 16-byte load takes 4
// when each quarter-warp reads 8 distinct float4s and 2 when the lanes
// share a few (copies across quarter-warps do not merge;
// tools/smem_probe.cu), so a thread needs about 4 FFMA per float it loads
// (the 4 warp-FFMAs an SM issues per clock), as an 8 x 8 outer product
// does. And issue slots: with 8 warps an SM, every non-FFMA instruction in
// a loop costs FFMA time, and a branch inside an FFMA loop compiles to
// convergence barriers (BSSY / BSYNC). A first version with 4 x 2 and
// 4 x 4 score patches and 4 x 8 accumulator patches (1.3 to 2.7 FFMA per
// float) ran at about half the rate of this one.
//
// One block of 256 threads (8 warps) owns 64 rows of one (batch, head) and
// streams tiles of the other side through a two-stage ring:
//  - FlashDkDvKernel owns 64 keys (K, V) and streams 32-query tiles (Q,
//    dO, lse, delta, segment ids).
//  - FlashDqKernel owns 64 queries (Q, dO, and each row's lse, delta and
//    segment id in registers) and streams 64-key tiles (K, V, ids).
// Per tile, scores: each warp takes 8 owned rows; lanes 0-15 sum s = q . k
// and lanes 16-31 dp = do . v, each lane an 8 x 8 patch (8 owned rows x 8
// streamed rows) over a slice of h (a quarter in dK/dV, where 4 lanes
// share a patch; a half in dQ), reading float4s along h: 16 loads for 256
// FFMA. Shuffles sum the slices, each step halving what a lane keeps, and
// trade halves between the s and dp lanes of a patch (each lane reads its
// patch's rows and columns in a rotated order, so that it always keeps
// its first half and sends the second: no selects); each lane then
// applies `RecomputePandDs` to its 8 (dK/dV) or 16 (dQ) pairs and writes
// p and ds (dK/dV) or ds^T (dQ) to shared memory. After one barrier the
// accumulations: dK/dV's warps 0-3 sum dv += p^T do and warps 4-7 dk +=
// ds^T q, dQ's warps dq += ds k over half of the tile's keys each (the two
// halves are added once, at the end); each thread an 8-row x 8-column
// patch (64 registers), 2 float4s of p or ds and 2 of the other operand
// per 64 FFMA, the next row's operands loaded under this row's FFMAs, no
// branch in the loop (a column past h reads a clamped one; kC, a template
// argument, is the number of float4 columns a thread owns). Q, K, V and
// dO sit in their [rows, h] layout at a row stride of h + 4, and the
// slices and rotations of the lanes of a quarter-warp are chosen so that
// their reads hit distinct banks.
//
// The next tile's 16-byte cp.async copies (4-byte ones for lse, delta and
// ids; rows past t zero-filled, so their p and ds are exactly 0) are
// issued right after the barrier that frees their stage and run under
// this tile's math: two barriers per tile. The segment-id ranges of all
// streamed tiles are reduced once per block into a bitmask of live tiles
// (`LiveTiles`), so a tile of other segments is never copied; tiles
// wholly in the causal future are never visited. The grid is (batch x
// head, row blocks) with the heaviest causal row blocks first (dK/dV: the
// first keys; dQ: the last queries). No atomics on floats: every sum is
// taken by fixed lanes in a fixed order, so two calls give the same bits.
//
// Shared memory at h = 128: dK/dV 151 KiB (K, V; two stages of Q, dO; p,
// ds), dQ 217 KiB (Q, dO; two stages of K, V; ds^T): one block per SM, as
// FA2's backward; the accumulators take 64 registers a thread, a score
// patch 64 more.

constexpr int kBThreads = 256;   // float32 backward: 8 warps
constexpr int kBOwn = 64;        // rows a block owns
constexpr int kBDkDvTile = 32;   // dK/dV: queries of a streamed tile
constexpr int kBDqTile = 64;     // dQ: keys of a streamed tile

struct BwdSmem {
  int ld, lds;   // row strides (floats) of the [rows, h] and p / ds tiles
  size_t own2, tile, tile2, p, ds, lse, delta, ids, live;  // float offsets
  size_t bytes;
};

// A float32 backward block's layout: the two [64, h] tiles it owns at 0,
// two stages of the two streamed [rows, h] tiles, the [rows, 64] p (dK/dV
// only) and ds tiles (one row per streamed row), two stages of the
// streamed rows' lse and delta (dK/dV only) and segment ids, then the
// live-tile bits.
__host__ __device__ inline BwdSmem BwdLayout(int t, int h, int rows,
                                             bool dkdv) {
  BwdSmem s;
  s.ld = h + 4;
  s.lds = kBOwn + 8;
  s.own2 = static_cast<size_t>(kBOwn) * s.ld;
  s.tile = 2 * s.own2;
  s.tile2 = s.tile + 2 * static_cast<size_t>(rows) * s.ld;
  s.p = s.tile2 + 2 * static_cast<size_t>(rows) * s.ld;
  s.ds = s.p + (dkdv ? static_cast<size_t>(rows) * s.lds : 0);
  s.lse = s.ds + static_cast<size_t>(rows) * s.lds;
  s.delta = s.lse + (dkdv ? 2 * rows : 0);
  s.ids = s.delta + (dkdv ? 2 * rows : 0);
  s.live = s.ids + 2 * rows;
  s.bytes = (s.live + ((t + rows - 1) / rows + 31) / 32) * sizeof(float);
  return s;
}

// A thread's share of a backward block's [rows, h] tile copies: float4
// column c of rows r0, r0 + step, ..., fixed once per thread so that no
// copy divides; a head dim whose float4 columns do not divide the block
// (step 0) takes CopyRowsAsync.
struct RowCopier {
  int r0, c, step;

  __device__ explicit RowCopier(int h4)
      : r0(threadIdx.x / h4), c(threadIdx.x % h4),
        step(kBThreads % h4 == 0 ? kBThreads / h4 : 0) {}

  // rows [start, start + rows) of head ni, batch bi into dst (row stride
  // ld) with 16-byte async copies; rows past t are zero-filled
  __device__ __forceinline__ void operator()(
      float* dst, int ld, const float* __restrict__ src, const Problem& pb,
      int bi, int ni, int start, int rows) const {
    if (step == 0) {
      CopyRowsAsync<kBThreads>(dst, ld, src, pb, bi, ni, start, rows);
      return;
    }
    const float* base = src + pb.Off(bi, 0, ni) + 4 * c;
    const size_t stride = static_cast<size_t>(pb.n) * pb.h;
    for (int r = r0; r < rows; r += step) {
      const int row = start + r;
      const bool valid = row < pb.t;
      CpAsync16(dst + r * ld + 4 * c, base + (valid ? row : 0) * stride,
                valid);
    }
  }
};

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

// acc += x * b
__device__ __forceinline__ void Axpy4(float x, float4 b, float4& acc) {
  acc.x = fmaf(x, b.x, acc.x);
  acc.y = fmaf(x, b.y, acc.y);
  acc.z = fmaf(x, b.z, acc.z);
  acc.w = fmaf(x, b.w, acc.w);
}

// acc[i][c] += w[r][i] * x[r][4 (cg + 16 c)] over rows r < kRows in
// order (w: 8 floats at row stride ldw; x: [kRows, h] at row stride ldx),
// the next row's operands loaded under this row's FFMAs. A column past h
// reads column h - 4 instead (no branch in the loop); its sums are never
// stored.
template <int kRows, int kC>
__device__ __forceinline__ void AccumulateTile(float4 (&acc)[8][kC],
                                               const float* w, int ldw,
                                               const float* x, int ldx,
                                               int cg, int h4) {
  int xo[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) xo[c] = 4 * min(cg + 16 * c, h4 - 1);
  float4 w0 = Ld4(w), w1 = Ld4(w + 4), xv[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) xv[c] = Ld4(x + xo[c]);
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const int nr = min(r + 1, kRows - 1);
    const float4 nw0 = Ld4(w + nr * ldw), nw1 = Ld4(w + nr * ldw + 4);
    float4 nx[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) nx[c] = Ld4(x + nr * ldx + xo[c]);
    const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) Axpy4(wr[i], xv[c], acc[i][c]);
    w0 = nw0;
    w1 = nw1;
#pragma unroll
    for (int c = 0; c < kC; ++c) xv[c] = nx[c];
  }
}

// The recompute both float32 backward kernels share (the reference's
// `_RecomputePandDs`), for one (query, key) pair with s = q . k and dp =
// do . v: p = exp(s * sm_scale - lse) where the masks keep the pair, else
// exp(NEG_INF - lse) = 0, and ds = p (dp - delta) sm_scale.
__device__ __forceinline__ void RecomputePandDs(float s, float dp, bool keep,
                                                float lse, float delta,
                                                float sm_scale, float* p,
                                                float* ds) {
  const float sv = keep ? s * sm_scale : kNegInf;
  *p = expf(sv - lse);
  *ds = *p * (dp - delta) * sm_scale;
}

// kC: the float4 columns of h a thread accumulates (1 up to h = 64, else 2)
template <int kC>
__global__ void __launch_bounds__(kBThreads, 1) FlashDkDvKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, Problem pb) {
  constexpr int kT = kBDkDvTile;
  extern __shared__ __align__(16) float smem[];
  const int h = pb.h, h4 = h / 4;
  const BwdSmem lay = BwdLayout(pb.t, h, kT, true);
  const int ld = lay.ld, lds = lay.lds;
  float* ks = smem;                  // [64][ld], this block's keys
  float* vs = smem + lay.own2;       // [64][ld]
  float* qs = smem + lay.tile;       // [2][32][ld], streamed queries
  float* dos = smem + lay.tile2;     // [2][32][ld]
  float* ps = smem + lay.p;          // [32 queries][lds]: p of this tile
  float* dss = smem + lay.ds;        // [32 queries][lds]: ds
  float* lse_s = smem + lay.lse;     // [2][32]
  float* delta_s = smem + lay.delta; // [2][32]
  int* segq_s = reinterpret_cast<int*>(smem + lay.ids);  // [2][32]
  unsigned* live = reinterpret_cast<unsigned*>(smem + lay.live);
  const int k0 = blockIdx.y * kBOwn;  // the first keys: the most queries
  const int bi = blockIdx.x / pb.n, ni = blockIdx.x % pb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;
  // scores: lanes 0-15 sum s = k . q, lanes 16-31 dp = v . do, each over
  // an h slice hs for keys 8 warp + (i ^ rot) and queries qg + 4 (j ^ cot)
  // (i, j < 8): the rotations put the sums a lane keeps through each
  // exchange below at j < 4, then i < 4, then i < 2 (rot is the same for
  // the lanes of a quarter-warp, and cot moves a row by 16: their reads
  // keep distinct banks)
  const bool is_dp = lane >= 16;
  const int hs = (lane >> 2) & 3, qg = lane & 3;
  const int rot = 4 * (hs >> 1) + 2 * is_dp, cot = 4 * (hs & 1);
  const float* sa = (is_dp ? vs : ks) + 8 * warp * ld;
  const float* sb = is_dp ? dos : qs;
  // after the reductions a lane owns keys ekey + ii (ii < 2) x queries
  // eq + 4 jj (jj < 4) of the tile
  const int ekey = 8 * warp + rot;
  const int eq = qg + 4 * cot;
  int segk[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int key = k0 + ekey + ii;
    segk[ii] = has_seg && key < pb.t ? seg_row[key] : 0;
  }
  // accumulators: warps 0-3 sum dv = p^T do, warps 4-7 dk = ds^T q, each
  // thread for keys 8 ag + i (i < 8) x float4 columns cg + 16 c
  const bool acc_dk = warp >= 4;
  const int ag = 2 * (warp & 3) + (lane >> 4), cg = lane & 15;
  const float* pa = (acc_dk ? dss : ps) + 8 * ag;
  const float* ob = acc_dk ? qs : dos;
  const RowCopier copy(h4);

  copy(ks, ld, k, pb, bi, ni, k0, kBOwn);
  copy(vs, ld, v, pb, bi, ni, k0, kBOwn);
  CpAsyncCommit();

  // the first causally live query tile is the one holding query k0
  const int nqt = (pb.t + kT - 1) / kT;
  const int qt0 = pb.causal ? k0 / kT : 0;
  int klo = 0, khi = 0;
  if (has_seg) WarpSegRange(seg_row, k0, kBOwn, pb.t, &klo, &khi);
  LiveTiles(live, seg_row, klo, khi, kT, nqt, pb.t);  // + a barrier
  auto prefetch = [&](int qt, int stage) {
    if (qt < nqt) {
      copy(qs + stage * kT * ld, ld, q, pb, bi, ni, qt * kT, kT);
      copy(dos + stage * kT * ld, ld, dout, pb, bi, ni, qt * kT, kT);
      if (tid < 3 * kT) {   // lse, delta and segment ids, one warp each
        const int r = tid % kT, row = qt * kT + r;
        const bool in = row < pb.t;
        const size_t off = pb.RowOff(bi, ni, in ? row : 0);
        if (tid < kT)
          CpAsync4(lse_s + stage * kT + r, lse + off, in);
        else if (tid < 2 * kT)
          CpAsync4(delta_s + stage * kT + r, delta + off, in);
        else if (has_seg)
          CpAsync4(segq_s + stage * kT + r, seg_row + (in ? row : 0), in);
      }
    }
    CpAsyncCommit();
  };

  float4 acc[8][kC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  int qt = NextLive(live, qt0, nqt);
  prefetch(qt, 0);
  for (int stage = 0; qt < nqt; stage ^= 1) {
    CpAsyncWait<0>();
    __syncthreads();   // this tile landed; the other stage and p, ds free
    const int nxt = NextLive(live, qt + 1, nqt);
    prefetch(nxt, stage ^ 1);   // runs under this tile's math
    const int qbase = qt * kT;

    // this lane's partial s (or dp) over its h slice: the slices of the
    // lanes of a quarter-warp take float4 columns 4 apart, so their reads
    // of 4 adjacent rows hit distinct banks
    float sp[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
    const float* sbt = sb + stage * kT * ld + qg * ld;
#pragma unroll 1
    for (int e = 0; e < h4 / 4; ++e) {
      const int f = 4 * ((h4 & 7) ? 4 * e + hs
                         : 8 * (e >> 1) + 4 * (hs & 1) + 2 * (hs >> 1) +
                               (e & 1));
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ld4(sa + (i ^ rot) * ld + f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = Ld4(sbt + 4 * (j ^ cot) * ld + f);
#pragma unroll
        for (int i = 0; i < 8; ++i) sp[i][j] = Dot4(a[i], b, sp[i][j]);
      }
    }
    // sum the four slices, each exchange halving what a lane keeps (the
    // partner keeps the other half), then trade halves between the s and
    // dp lanes of one patch
    float r1[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        r1[i][jj] = sp[i][jj] +
                    __shfl_xor_sync(0xffffffffu, sp[i][jj + 4], 4);
    float r2[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        r2[ii][jj] = r1[ii][jj] +
                     __shfl_xor_sync(0xffffffffu, r1[ii + 4][jj], 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = eq + 4 * jj;
      const float lse_q = lse_s[stage * kT + col];
      const float delta_q = delta_s[stage * kT + col];
      const int segq = has_seg ? segq_s[stage * kT + col] : 0;
      float p[2], ds[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float own = r2[ii][jj];
        const float got = __shfl_xor_sync(0xffffffffu, r2[ii + 2][jj], 16);
        const bool keep = Keep(pb, qbase + col, k0 + ekey + ii, has_seg,
                               segq, segk[ii]);
        RecomputePandDs(is_dp ? got : own, is_dp ? own : got, keep, lse_q,
                        delta_q, pb.sm_scale, &p[ii], &ds[ii]);
      }
      *reinterpret_cast<float2*>(ps + col * lds + ekey) =
          make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(dss + col * lds + ekey) =
          make_float2(ds[0], ds[1]);
    }
    __syncthreads();   // p and ds of the tile are written

    // dv += p^T do (or dk += ds^T q) over the tile's queries, in order
    AccumulateTile<kT, kC>(acc, pa, lds, ob + stage * kT * ld, ld, cg, h4);
    qt = nxt;
  }
  CpAsyncWait<0>();
  float* out = acc_dk ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * ag + i;
    if (key >= pb.t) continue;
    float* o = out + pb.Off(bi, key, ni);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int cc = cg + 16 * c;
      if (cc < h4) *reinterpret_cast<float4*>(o + 4 * cc) = acc[i][c];
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kBThreads, 1) FlashDqKernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, Problem pb) {
  constexpr int kT = kBDqTile;
  extern __shared__ __align__(16) float smem[];
  const int h = pb.h, h4 = h / 4;
  const BwdSmem lay = BwdLayout(pb.t, h, kT, false);
  const int ld = lay.ld, lds = lay.lds;
  float* qs = smem;                  // [64][ld], this block's queries
  float* dos = smem + lay.own2;      // [64][ld]
  float* ks = smem + lay.tile;       // [2][64][ld], streamed keys
  float* vs = smem + lay.tile2;      // [2][64][ld]
  float* dst = smem + lay.ds;        // [64 keys][lds]: ds^T of this tile
  int* segk_s = reinterpret_cast<int*>(smem + lay.ids);  // [2][64]
  unsigned* live = reinterpret_cast<unsigned*>(smem + lay.live);
  // the last queries first: they attend the most keys
  const int q0 = (pb.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) *
                 kBOwn;
  const int bi = blockIdx.x / pb.n, ni = blockIdx.x % pb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;
  // scores: lanes 0-15 sum s = q . k, lanes 16-31 dp = do . v, each over
  // a half hs of h for queries 8 warp + (i ^ rot) and keys kg + 8 (j ^ cot)
  // (i, j < 8): the rotations put the sums a lane keeps through each
  // exchange below at i < 4 and j < 4
  const bool is_dp = lane >= 16;
  const int hs = (lane >> 3) & 1, kg = lane & 7;
  const int rot = 4 * hs, cot = 4 * is_dp;
  const float* sa = (is_dp ? dos : qs) + 8 * warp * ld;
  const float* sb = is_dp ? vs : ks;
  // after the reductions a lane owns queries eq + ii (ii < 4) x keys
  // kg + 8 (jj + 4 is_dp) (jj < 4) of the tile
  const int eq = 8 * warp + 4 * hs;
  float lse_q[4], delta_q[4];
  int segq[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + eq + ii;
    const bool in = row < pb.t;
    lse_q[ii] = in ? lse[pb.RowOff(bi, ni, row)] : 0.f;
    delta_q[ii] = in ? delta[pb.RowOff(bi, ni, row)] : 0.f;
    segq[ii] = has_seg && in ? seg_row[row] : 0;
  }
  // accumulators: queries 8 ag + i (i < 8) x float4 columns cg + 16 c,
  // summed over the keys 32 kh .. 32 kh + 31 of each tile (the lanes of
  // kh 0 and 1 add their halves at the end)
  const int ag = warp, kh = lane >> 4, cg = lane & 15;
  const float* da = dst + 32 * kh * lds + 8 * ag;
  const RowCopier copy(h4);

  copy(qs, ld, q, pb, bi, ni, q0, kBOwn);
  copy(dos, ld, dout, pb, bi, ni, q0, kBOwn);
  CpAsyncCommit();

  const int k_end = pb.causal ? min(pb.t, q0 + kBOwn) : pb.t;
  const int nkt = (k_end + kT - 1) / kT;
  int qlo = 0, qhi = 0;
  if (has_seg) WarpSegRange(seg_row, q0, kBOwn, pb.t, &qlo, &qhi);
  LiveTiles(live, seg_row, qlo, qhi, kT, nkt, pb.t);  // + a barrier
  auto prefetch = [&](int kt, int stage) {
    if (kt < nkt) {
      copy(ks + stage * kT * ld, ld, k, pb, bi, ni, kt * kT, kT);
      copy(vs + stage * kT * ld, ld, v, pb, bi, ni, kt * kT, kT);
      if (has_seg && tid < kT) {
        const int key = kt * kT + tid;
        const bool in = key < pb.t;
        CpAsync4(segk_s + stage * kT + tid, seg_row + (in ? key : 0), in);
      }
    }
    CpAsyncCommit();
  };

  float4 acc[8][kC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  int kt = NextLive(live, 0, nkt);
  prefetch(kt, 0);
  for (int stage = 0; kt < nkt; stage ^= 1) {
    CpAsyncWait<0>();
    __syncthreads();   // this tile landed; the other stage and ds are free
    const int nxt = NextLive(live, kt + 1, nkt);
    prefetch(nxt, stage ^ 1);   // runs under this tile's math
    const int kbase = kt * kT;

    // this lane's partial s (or dp) over its half of h
    float sp[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
    const float* sbt = sb + stage * kT * ld + kg * ld;
#pragma unroll 1
    for (int e = 0; e < h4 / 2; ++e) {
      const int f = 4 * (2 * e + hs);
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ld4(sa + (i ^ rot) * ld + f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = Ld4(sbt + 8 * (j ^ cot) * ld + f);
#pragma unroll
        for (int i = 0; i < 8; ++i) sp[i][j] = Dot4(a[i], b, sp[i][j]);
      }
    }
    // sum the two halves (the partner keeps the other 32 sums), then
    // trade halves between the s and dp lanes of one patch
    float r1[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r1[ii][j] = sp[ii][j] +
                    __shfl_xor_sync(0xffffffffu, sp[ii + 4][j], 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = kg + 8 * (jj + 4 * is_dp);
      const int segk = has_seg ? segk_s[stage * kT + col] : 0;
      float ds[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float own = r1[ii][jj];
        const float got = __shfl_xor_sync(0xffffffffu, r1[ii][jj + 4], 16);
        const bool keep = Keep(pb, q0 + eq + ii, kbase + col, has_seg,
                               segq[ii], segk);
        float p;
        RecomputePandDs(is_dp ? got : own, is_dp ? own : got, keep,
                        lse_q[ii], delta_q[ii], pb.sm_scale, &p, &ds[ii]);
      }
      *reinterpret_cast<float4*>(dst + col * lds + eq) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();   // ds^T of the tile is written

    // dq += ds k over this lane's half of the tile's keys, in order
    AccumulateTile<kT / 2, kC>(acc, da, lds, ks + (stage * kT + 32 * kh) * ld,
                               ld, cg, h4);
    kt = nxt;
  }
  CpAsyncWait<0>();
  // add the two key halves: the kh 0 lane writes rows 0-3, kh 1 rows 4-7
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + 8 * ag + (kh ? ii + 4 : ii);
    float* o = dq + pb.Off(bi, row < pb.t ? row : 0, ni);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float4 sum = kh ? acc[ii + 4][c] : acc[ii][c];
      const float4 give = kh ? acc[ii][c] : acc[ii + 4][c];
      sum.x += __shfl_xor_sync(0xffffffffu, give.x, 16);
      sum.y += __shfl_xor_sync(0xffffffffu, give.y, 16);
      sum.z += __shfl_xor_sync(0xffffffffu, give.z, 16);
      sum.w += __shfl_xor_sync(0xffffffffu, give.w, 16);
      const int cc = cg + 16 * c;
      if (row < pb.t && cc < h4) *reinterpret_cast<float4*>(o + 4 * cc) = sum;
    }
  }
}

// ---- bfloat16: tensor-core kernels at the reference's rounding points ----
//
// The bf16 halves of the three kernels (the reference's `_DotF32` keeps
// native bf16 operands and accumulates in float32). Every product is a
// warpgroup MMA (wgmma) on the tensor cores, with its operands copied by
// TMA (a bf16 x bf16 product is exact in float32, so the sums differ from
// the reference's only in order). The forward and the backward pair each
// have their own section below. Outputs are stored in bf16; lse stays
// float32.
//
// The rounding points are the reference's (flash_attention.py `_FwdKernel`,
// `_DkDvKernel`, `_DqKernel`):
// - forward: p = exp(s - m_safe) is rounded to bf16 before P.V, with m the
//   running max through the END of the reference's key block (`block_k`,
//   the largest power of two <= 1024 dividing t); l sums the unrounded p;
//   out = bf16(acc / max(l, 1e-20)). A kernel that rounded against its own
//   64-key tile max would round elsewhere (about as far off as not rounding
//   at all), so each reference block takes two sweeps over its key tiles:
//   the first computes s and only the row maxima, then m, l and acc are
//   rescaled once (the reference's alpha), and the second recomputes s and
//   accumulates l and bf16(p) . V. The cost: q . k is computed twice, 6h
//   instead of 4h flops per attended pair. block_k must be a multiple of
//   the 64-key tile or cover all of t. (FlashFwdBf16Kernel's section.)
// - backward: p = exp(s - lse) is normalised (no running max); dp =
//   f32(do . v), ds = p (dp - delta) sm_scale; dv += bf16(p)^T do, dk +=
//   bf16(ds)^T q, dq += bf16(ds) k, each summed in float32 and rounded to
//   bf16 once at the end. (The backward's section.)

typedef __nv_bfloat16 bf16;

// -- the bf16 forward: warpgroup MMA fed by TMA (FlashFwdBf16Kernel) --
//
// Replaces `_FwdKernel` (lingvo_tpu/ops/flash_attention.py, pallas_call in
// `_FlashForward`) for bf16 q/k/v. Bound at [8, 1024, 16, 128] with two
// causal segments of 512: 134 MB of q, k, v and out (0.040 ms at 3.35
// TB/s) against 4h flops per attended pair of model work (0.017 ms at 989
// TFLOP/s): bytes, by a little; the tensor cores bound the executed work.
//
// The first bf16 forward (mma.sync m16n8k16, 64 queries per 4-warp
// block, each lane's K fragments from two scalar 32-bit shared loads per
// product, cp.async issued by the compute threads with a block barrier
// per tile, light causal tiles scheduled first) lost to SDPA by 1.5x.
// This design:
//  - One block per (128 queries, batch x head), the heaviest causal query
//    tiles first (grid (b * n, query tiles), tile index reversed). Two
//    consumer warpgroups own 64 query rows each; one producer warp keeps
//    the K and V tiles of 64 keys in flight with TMA into a 4-stage ring,
//    with a full and an empty mbarrier per stage (the consumers never
//    issue a copy or take a block barrier).
//  - S = Q K^T by wgmma m64n64k16, Q and K straight from the swizzled TMA
//    tiles in shared memory, float32 accumulators in registers.
//  - P V by wgmma m64n{64,128}k16 with P from registers: the S
//    accumulator's layout is the A fragment's, so p is rounded to bf16 in
//    the conversion; V is the MN-major B operand, read transposed.
//  - TMA boxes of 64 key rows x 64 head-dim columns (the 128-byte swizzle
//    takes 128-byte rows): h <= 64 is one box (columns past h read as 0),
//    64 < h <= 128 two (kBoxes, the template argument).
// The rounding point stays the reference's: p = exp(s - m_safe) with m the
// running max through the END of the reference key block (`block_k`, all
// of t = 1024 on DenseLm1B), which the kernel has not seen when it first
// meets a score. So each block still takes two sweeps over its key tiles:
// sweep A is pure wgmma q . k and a row max (no exp, no V: the producer
// loads only K), then m, l and acc are rescaled once (the reference's
// alpha), and sweep B recomputes s, sums l over the unrounded p and adds
// bf16(p) . V. Holding a block's float32 scores on chip instead would take
// 128 x 1024 x 4 bytes = 512 KB. Tiles whose segment ids cannot meet the
// block's are skipped (LiveTiles), and a warpgroup skips the math of a
// tile wholly in its causal future (both are exact no-ops).
// What it still leaves: sweep A (6h instead of 4h flops per pair), no
// overlap of one warpgroup's mask and exp with its own wgmma (the two
// warpgroups interleave only through the scheduler: issuing a tile's P V
// under the next tile's q . k, and ping-pong barriers between the
// warpgroups, were both slower), full-precision expf (the reference's
// exp, so p rounds to the same bf16), stores of out from registers
// (16-byte runs), and no persistent grid.

constexpr int kWq = 128;         // queries of a forward block
constexpr int kWk = 64;          // keys of a tile
constexpr int kWStages = 4;      // ring stages, each K and V of one tile
constexpr int kWConsumers = 256; // two warpgroups of 64 query rows
constexpr int kWThreads = kWConsumers + 32;  // and the producer warp
constexpr int kRowBytes = 128;   // one row of a TMA box: 64 bf16 columns

template <int kBoxes>
struct WLayout {   // byte offsets from a 1024-byte aligned base
  static constexpr int kQBox = kWq * kRowBytes;      // Q: kBoxes of these
  static constexpr int kKBox = kWk * kRowBytes;      // K or V: one box
  static constexpr int kRing = kBoxes * kQBox;
  static constexpr int kStage = 2 * kBoxes * kKBox;  // K boxes, V boxes
  static constexpr int kBars = kRing + kWStages * kStage;
  static constexpr int kLive = kBars + (2 * kWStages + 1) * 8;
  // dynamic shared memory at sequence length t, with 1 KB of slack to
  // align the base
  static size_t Bytes(int t) {
    return 1024 + kLive +
           ((t + kWk - 1) / kWk + 31) / 32 * sizeof(unsigned);
  }
};

// The steps of a forward block: for each reference key block with a live
// tile, sweep A (pass 0) over its live tiles, then sweep B (pass 1) over
// them again. The producer and the consumers walk the same steps.
struct FwdSchedule {
  const unsigned* live;
  int nkt, tpr, nrb;
  int rb, pass, kt;  // the current step; kt < 0 past the last

  __device__ int Hi(int r) const { return min(nkt, (r + 1) * tpr); }
  __device__ void From(int r0) {
    pass = 0;
    for (rb = r0; rb < nrb; ++rb) {
      kt = NextLive(live, rb * tpr, Hi(rb));
      if (kt < Hi(rb)) return;
    }
    kt = -1;
  }
  // the step is the last of its block's sweep A
  __device__ bool EndsSweepA() const {
    return pass == 0 && NextLive(live, kt + 1, Hi(rb)) == Hi(rb);
  }
  __device__ void Advance() {
    const int hi = Hi(rb);
    const int nk = NextLive(live, kt + 1, hi);
    if (nk < hi) {
      kt = nk;
    } else if (pass == 0) {
      pass = 1;
      kt = NextLive(live, rb * tpr, hi);
    } else {
      From(rb + 1);
    }
  }
};

template <int kBoxes>
__global__ void __launch_bounds__(kWThreads, 1) FlashFwdBf16Kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
    bf16* __restrict__ out, float* __restrict__ lse, Problem pb,
    int block_k) {
  typedef WLayout<kBoxes> L;
  constexpr int kN = 64 * kBoxes;  // head-dim columns of the P.V product
  extern __shared__ __align__(16) unsigned char wsmem[];
  unsigned char* sm = wsmem + ((1024 - (SmemAddr(wsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kWStages;
  uint64_t* qbar = empty + kWStages;
  unsigned* live = reinterpret_cast<unsigned*>(sm + L::kLive);

  const int ntq = gridDim.y;
  const int q0 = (pb.causal ? ntq - 1 - blockIdx.y : blockIdx.y) * kWq;
  const int bi = blockIdx.x / pb.n, ni = blockIdx.x % pb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;
  const int k_end = pb.causal ? min(pb.t, q0 + kWq) : pb.t;
  FwdSchedule sch;
  sch.live = live;
  sch.nkt = (k_end + kWk - 1) / kWk;
  // key tiles per reference block (block_k: a multiple of 64, or >= t)
  sch.tpr = block_k >= pb.t ? sch.nkt : block_k / kWk;
  sch.nrb = (sch.nkt + sch.tpr - 1) / sch.tpr;

  if (tid == 0) {
    for (int st = 0; st < kWStages; ++st) {
      MbarInit(&full[st], 1);
      MbarInit(&empty[st], kWConsumers / 32);  // one arrival per warp
    }
    MbarInit(qbar, 1);
    MbarInitFence();
  }
  int qlo = 0, qhi = 0;
  if (has_seg) WarpSegRange(seg_row, q0, kWq, pb.t, &qlo, &qhi);
  LiveTiles(live, seg_row, qlo, qhi, kWk, sch.nkt, pb.t);  // + a barrier

  if (warp == kWConsumers / 32) {  // the producer warp
    if (lane == 0) {
      MbarArriveExpectTx(qbar, kBoxes * L::kQBox);
      for (int bx = 0; bx < kBoxes; ++bx)
        TmaLoad4(sm + bx * L::kQBox, &tm_q, qbar, bx * 64, ni, q0, bi);
      int stage = 0, phase = 0;
      for (sch.From(0); sch.kt >= 0; sch.Advance()) {
        MbarWait(&empty[stage], phase ^ 1);
        unsigned char* st = sm + L::kRing + stage * L::kStage;
        const bool with_v = sch.pass == 1;  // sweep A reads no V
        MbarArriveExpectTx(&full[stage],
                           (with_v ? 2 : 1) * kBoxes * L::kKBox);
        for (int bx = 0; bx < kBoxes; ++bx) {
          TmaLoad4(st + bx * L::kKBox, &tm_k, &full[stage], bx * 64, ni,
                   sch.kt * kWk, bi);
          if (with_v)
            TmaLoad4(st + (kBoxes + bx) * L::kKBox, &tm_v, &full[stage],
                     bx * 64, ni, sch.kt * kWk, bi);
        }
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows wg_q0 .. wg_q0 + 63; this thread's
  // rows row_a and row_b = row_a + 8 (the accumulators' layout)
  const int wg = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int wg_q0 = q0 + 64 * wg;
  const int row_a = wg_q0 + 16 * (warp & 3) + g, row_b = row_a + 8;
  const int segq_a = has_seg && row_a < pb.t ? seg_row[row_a] : 0;
  const int segq_b = has_seg && row_b < pb.t ? seg_row[row_b] : 0;
  const unsigned char* qs = sm + wg * 64 * kRowBytes;  // in each Q box

  float o[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: partial
  float mb_a = kNegInf, mb_b = kNegInf;  // sweep A's row maxima (partial)
  float ms_a = 0.f, ms_b = 0.f;          // m_safe of sweep B

  MbarWait(qbar, 0);
  int stage = 0, phase = 0;
  for (sch.From(0); sch.kt >= 0;) {
    const bool ends_a = sch.EndsSweepA();
    const int k0 = sch.kt * kWk;
    MbarWait(&full[stage], phase);
    const unsigned char* st = sm + L::kRing + stage * L::kStage;
    if (!(pb.causal && k0 > wg_q0 + 63)) {  // else: all in the future
      // s = (q . k) * sm_scale where kept, else NEG_INF: 64 rows x 64 keys
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;  // overwritten (scale_d 0)
      // every k-step of the boxes: their columns past h were read as
      // zeros, so they add exact zeros (and no branch splits the chain)
      WgmmaFence();
#pragma unroll
      for (int kk = 0; kk < 4 * kBoxes; ++kk) {
        const int box_off = kk >> 2, col_off = (kk & 3) * 32;
        WgmmaSS64(s,
                  SwizzledDesc(qs + box_off * L::kQBox + col_off, 16, 1024),
                  SwizzledDesc(st + box_off * L::kKBox + col_off, 16, 1024),
                  kk > 0);
      }
      WgmmaCommit();
      int segk[16];  // the ids of this thread's 16 key columns
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int key = k0 + 8 * (c >> 1) + 2 * tq + (c & 1);
        segk[c] = has_seg && key < pb.t ? seg_row[key] : 0;
      }
      // every pair of this thread's kept: the tile is inside t, wholly in
      // both rows' causal past, and of their one segment
      bool all_kept = row_b < pb.t && k0 + kWk <= pb.t &&
                      (!pb.causal || k0 + kWk - 1 <= row_a) &&
                      segq_a == segq_b;
#pragma unroll
      for (int c = 0; c < 16; ++c) all_kept = all_kept && segk[c] == segq_a;
      WgmmaWait<0>();
      FenceRegs(s);
      if (all_kept) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= pb.sm_scale;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tq + (e & 1);
            const bool keep =
                Keep(pb, e < 2 ? row_a : row_b, k0 + col, has_seg,
                     e < 2 ? segq_a : segq_b, segk[2 * j + (e & 1)]);
            s[4 * j + e] = keep ? s[4 * j + e] * pb.sm_scale : kNegInf;
          }
      }
      if (sch.pass == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mb_a = fmaxf(mb_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mb_b = fmaxf(mb_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      } else {
        // p = exp(s - m_safe): l sums it unrounded, P.V takes bf16(p); the
        // A fragment of keys 16 kk .. 16 kk + 15 is S's columns j = 2 kk,
        // 2 kk + 1
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = expf(s[4 * j] - ms_a);
          const float p1 = expf(s[4 * j + 1] - ms_a);
          const float p2 = expf(s[4 * j + 2] - ms_b);
          const float p3 = expf(s[4 * j + 3] - ms_b);
          l_a += p0 + p1;
          l_b += p2 + p3;
          pa[j >> 1][2 * (j & 1)] = PackBf16(p0, p1);
          pa[j >> 1][2 * (j & 1) + 1] = PackBf16(p2, p3);
        }
        WgmmaFence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t vd = SwizzledDesc(
              st + kBoxes * L::kKBox + kk * 16 * kRowBytes, L::kKBox, 1024);
          if constexpr (kBoxes == 2) {
            WgmmaRS128(o, pa[kk], vd);
          } else {
            WgmmaRS64(o, pa[kk], vd);
          }
        }
        WgmmaCommit();
        WgmmaWait<0>();
        FenceRegs(o);
      }
    }
    __syncwarp();
    if (lane == 0) MbarArrive(&empty[stage]);  // this warp is done with it
    if (ends_a) {
      // the block's maxima are known: the reference's m_new and alpha
      mb_a = QuadMax(mb_a);
      mb_b = QuadMax(mb_b);
      const float mn_a = fmaxf(m_a, mb_a), mn_b = fmaxf(m_b, mb_b);
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
      m_a = mn_a;
      m_b = mn_b;
      // rows with no unmasked key yet: masked entries must give p = 0
      ms_a = m_a <= kNegInf * 0.5f ? 0.f : m_a;
      ms_b = m_b <= kNegInf * 0.5f ? 0.f : m_b;
      mb_a = mb_b = kNegInf;
    }
    if (++stage == kWStages) {
      stage = 0;
      phase ^= 1;
    }
    sch.Advance();
  }
  const float den_a = fmaxf(QuadSum(l_a), 1e-20f);
  const float den_b = fmaxf(QuadSum(l_b), 1e-20f);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col < pb.h) {
      if (row_a < pb.t)
        *reinterpret_cast<uint32_t*>(out + pb.Off(bi, row_a, ni) + col) =
            PackBf16(o[4 * j] / den_a, o[4 * j + 1] / den_a);
      if (row_b < pb.t)
        *reinterpret_cast<uint32_t*>(out + pb.Off(bi, row_b, ni) + col) =
            PackBf16(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
    }
  }
  if (tq == 0) {
    if (row_a < pb.t) lse[pb.RowOff(bi, ni, row_a)] = m_a + logf(den_a);
    if (row_b < pb.t) lse[pb.RowOff(bi, ni, row_b)] = m_b + logf(den_b);
  }
}

// -- the bf16 backward: warpgroup MMA fed by TMA (FlashDkDvBf16Kernel,
//    FlashDqBf16Kernel) --
//
// Replace `_DkDvKernel` and `_DqKernel` (lingvo_tpu/ops/flash_attention.py,
// the two pallas_calls in `_FlashBackward`; both recompute p and ds as
// `_RecomputePandDs` does) for bf16 q, k, v and do. Bound at [8, 1024, 16,
// 128] with two causal segments of 512: bytes, 0.0604 ms for dK/dV (q, k,
// v and do read, dk and dv written, lse, delta and the ids) and 0.0504 ms
// for dQ, at 3.35 TB/s, against 8h and 6h flops per attended pair of model
// work (0.034 and 0.026 ms at 989 TFLOP/s).
//
// The first bf16 backward (mma.sync m16n8k16 in 4-warp blocks of 64 owned
// rows, the streamed operand's fragments from scalar 32-bit shared loads,
// cp.async copies issued by the compute threads with two block barriers
// per 32-row tile, dQ's light causal tiles first) reached 9% of the dense
// bf16 rate; it is gone. This design, in both kernels:
//  - One block per (128 owned rows, batch x head); a block takes its (b,
//    n) and tile from its linear index, so that the blocks of one (b, n)
//    start together and share its streamed tiles in L2. Two consumer
//    warpgroups own 64 rows each. Thread 0 loads the owned rows of two
//    tensors (K and V for dK/dV, Q and dO for dQ) by TMA first of all; a
//    producer warp streams tiles of the other two (64 queries for dK/dV,
//    128 keys for dQ) into a ring with a full and an empty mbarrier per
//    stage, lane 0 by TMA, and the lanes
//    copy the tile's row data (segment ids and, for dK/dV, lse and delta;
//    a [b n, t] TMA would need t a multiple of 4) by 4-byte cp.async that
//    arrive on the stage's barrier when they land. The consumers never
//    issue a copy or take a block barrier.
//  - The score products are wgmma (m64n128k16 for dQ, m64n64k16 for
//    dK/dV) with both operands K-major from the swizzled boxes: S = Q K^T
//    and dP = dO V^T for dQ, and for dK/dV the transposes S^T = K Q^T and
//    dP^T = V dO^T, so that a thread's accumulator rows are keys. They
//    are two commit groups, and p is computed while dP runs; dK/dV issues
//    dV before it computes ds.
//  - p and ds are computed in the accumulators' registers and rounded to
//    bf16 in the conversion to A fragments (the accumulator's layout is
//    the A fragment's). dV += P^T dO, dK += dS^T Q and dQ += dS K take A
//    from those registers and read the streamed tile as the MN-major B
//    operand through the transposed descriptor: one swizzled tile serves
//    both of its products. The masks have no branch per element (ids,
//    lse and delta are read in pairs, the tests are bitwise, one branch a
//    tile for tiles kept whole): a branch per element serialized the exps.
//  - A thread holds 192 float32 accumulators at h = 128: S^T, dP^T, dK
//    and dV of 64 queries in dK/dV, S, dP and dQ of 128 keys in dQ (twice
//    the keys of a 64-key tile for the same waits, 8% to 15% faster
//    without segments). So the producer warp leads a whole warpgroup
//    that gives its registers to the consumers (setmaxnreg 24 / 240).
//  - The gradients leave through shared memory: a warpgroup writes its
//    rows, swizzled, over its own rows of the owned tiles (their last
//    product has read them), and one thread stores them by TMA. Stores
//    from the registers (4-byte words, 8 rows a warp instruction, each
//    n h apart) took a fifth of dK/dV's time.
//  - Heaviest causal tiles first: dK/dV's key tiles ascend, dQ's query
//    tiles are reversed. LiveTiles skips the tiles of other segments
//    without copying them, and a warpgroup skips the math of a tile wholly
//    in its causal future (both are exact no-ops).
//  - No atomics: each output element is summed by one thread in tile
//    order, so two calls give the same bits.
// What it still leaves, as measured on an H100 at the shapes above: about
// 2 us a 64-row tile in a steady state against 1 us of tensor-core work.
// Taking out the exps, the score products or the gradient products moved
// it by at most 12% each, and neither the ring's depth (2 to 4 stages) nor
// L2 reuse moved it; alternating the warpgroups' products by named
// barriers was slower, and waiting for a tile's last gradient product
// only in the next tile made ptxas serialize every wgmma (C7515). Also a
// block's owned loads are not overlapped with another block's compute (no
// persistent grid), expf is the full-precision one (the reference's exp,
// so p rounds to the same bf16), the masked half of each diagonal tile is
// computed, and dQ recomputes the scores (a dQ fused into dK/dV would sum
// it with float atomics, and give other bits from call to call).

constexpr int kBOwnBf16 = 128;   // rows a bf16 backward block owns
constexpr int kBt = 64;          // dK/dV: query rows of a streamed tile
constexpr int kDqT = 128;        // dQ: key rows of a streamed tile
constexpr int kDkvStages = 3;    // dK/dV ring: Q and dO of one query tile
constexpr int kDqStages = 2;     // dQ ring: K and V of one key tile
constexpr int kBConsumers = 256; // two consumer warpgroups of 64 rows
constexpr int kBwdThreads = kBConsumers + 128;  // and a producer warpgroup

template <int kBoxes, int kStages, int kTile>
struct BLayout {   // byte offsets from a 1024-byte aligned base
  static constexpr int kNumBoxes = kBoxes, kNumStages = kStages;
  static constexpr int kTileRows = kTile;
  static constexpr int kOwnBox = kBOwnBf16 * kRowBytes;  // owned rows, a box
  static constexpr int kTileBox = kTile * kRowBytes;     // streamed, a box
  static constexpr int kOwn = 2 * kBoxes * kOwnBox;      // two owned tensors
  static constexpr int kStage = 2 * kBoxes * kTileBox;   // two streamed ones
  // each stage's row data: kTile ids, then kTile lse and kTile delta
  // (dK/dV)
  static constexpr int kRows = kOwn + kStages * kStage;
  static constexpr int kRowStage = 3 * kTile * 4;
  static constexpr int kBars = kRows + kStages * kRowStage;
  static constexpr int kLive = kBars + (2 * kStages + 1) * 8;
  // dynamic shared memory at sequence length t, with 1 KB of slack to
  // align the base
  static size_t Bytes(int t) {
    return 1024 + kLive +
           ((t + kTile - 1) / kTile + 31) / 32 * sizeof(unsigned);
  }
};

// Without segments every stage's ids are 0: written once, before the
// block barrier of LiveTiles, and never copied.
template <class L>
__device__ __forceinline__ void ZeroIds(unsigned char* sm) {
  for (int i = threadIdx.x; i < L::kNumStages * L::kTileRows;
       i += blockDim.x) {
    int* ids = reinterpret_cast<int*>(sm + L::kRows +
                                      i / L::kTileRows * L::kRowStage);
    ids[i % L::kTileRows] = 0;
  }
}

// Thread 0 of a backward block, right after the barriers' initialisation:
// the block's owned rows own0 .. own0 + 127 of two tensors (maps own_a,
// own_b) by TMA, counted on own_bar. Issued before the live-tile scan,
// which the copy does not depend on.
template <class L>
__device__ __forceinline__ void LoadOwned(unsigned char* sm,
                                          const CUtensorMap* own_a,
                                          const CUtensorMap* own_b,
                                          uint64_t* own_bar, int own0, int bi,
                                          int ni) {
  MbarArriveExpectTx(own_bar, L::kOwn);
  for (int bx = 0; bx < L::kNumBoxes; ++bx) {
    TmaLoad4(sm + bx * L::kOwnBox, own_a, own_bar, bx * 64, ni, own0, bi);
    TmaLoad4(sm + (L::kNumBoxes + bx) * L::kOwnBox, own_b, own_bar, bx * 64,
             ni, own0, bi);
  }
}

// The producer warp of a backward block; lane 0 issues the TMA copies.
// For each live tile i in [lo, hi) it loads the rows kTile i .. kTile (i +
// 1) - 1 (kTile = L::kTileRows) of two streamed tensors (tile_a, tile_b)
// into the next free stage, with their row data by 4-byte cp.async
// (tracked by the stage's barrier, so the warp never waits for a load):
// segment ids (without segments they stay the zeros of ZeroIds) and,
// where lse is given, lse and delta (rows past t: 0).
template <class L>
__device__ __forceinline__ void BwdProducer(
    unsigned char* sm, const CUtensorMap* tile_a, const CUtensorMap* tile_b,
    const unsigned* live, int lo, int hi, const int* seg_row,
    const float* lse, const float* delta, const Problem& pb, int bi,
    int ni) {
  constexpr int kBoxes = L::kNumBoxes, kStages = L::kNumStages;
  constexpr int kTile = L::kTileRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31;
  int stage = 0, phase = 0;
  for (int i = NextLive(live, lo, hi); i < hi;
       i = NextLive(live, i + 1, hi)) {
    MbarWait(&empty[stage], phase ^ 1);
    unsigned char* st = sm + L::kOwn + stage * L::kStage;
    if (lane == 0) {
      MbarArriveExpectTx(&full[stage], L::kStage);
      for (int bx = 0; bx < kBoxes; ++bx) {
        TmaLoad4(st + bx * L::kTileBox, tile_a, &full[stage], bx * 64, ni,
                 i * kTile, bi);
        TmaLoad4(st + (kBoxes + bx) * L::kTileBox, tile_b, &full[stage],
                 bx * 64, ni, i * kTile, bi);
      }
    }
    int* ids = reinterpret_cast<int*>(sm + L::kRows + stage * L::kRowStage);
    for (int r = lane; r < kTile; r += 32) {
      const int row = i * kTile + r;
      const bool in = row < pb.t;
      const size_t at = pb.RowOff(bi, ni, in ? row : 0);
      if (seg_row != nullptr) CpAsync4(ids + r, seg_row + (in ? row : 0), in);
      if (lse != nullptr) {
        CpAsync4(ids + kTile + r, lse + at, in);
        CpAsync4(ids + 2 * kTile + r, delta + at, in);
      }
    }
    CpAsyncMbarArrive(&full[stage]);  // when this lane's copies land
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// d = A . B^T over every k-step of the boxes: A the 64 rows at a (boxes
// a_box bytes apart), B the kN rows at b (b_box apart), both K-major and
// swizzled. Columns past h were read as zeros, so they add exact zeros
// (and no branch splits the chain).
template <int kBoxes, int kN>
__device__ __forceinline__ void ScoreWgmma(float (&d)[kN / 2],
                                           const unsigned char* a, int a_box,
                                           const unsigned char* b,
                                           int b_box) {
#pragma unroll
  for (int kk = 0; kk < 4 * kBoxes; ++kk) {
    const int box = kk >> 2, col = (kk & 3) * 32;
    const uint64_t da = SwizzledDesc(a + box * a_box + col, 16, 1024);
    const uint64_t db = SwizzledDesc(b + box * b_box + col, 16, 1024);
    if constexpr (kN == 128) {
      WgmmaSS128(d, da, db, kk > 0);
    } else {
      WgmmaSS64(d, da, db, kk > 0);
    }
  }
}

// d += A . B over the kK rows of a streamed tile: A the bf16 fragments
// of its kK / 16 k-steps of 16 rows, B the tile at b, MN-major (boxes kK
// rows apart, read transposed) over the kBoxes x 64 head-dim columns.
template <int kBoxes, int kK>
__device__ __forceinline__ void GradWgmma(float (&d)[32 * kBoxes],
                                          uint32_t (&a)[kK / 16][4],
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint64_t bd =
        SwizzledDesc(b + kk * 16 * kRowBytes, kK * kRowBytes, 1024);
    if constexpr (kBoxes == 2) {
      WgmmaRS128(d, a[kk], bd);
    } else {
      WgmmaRS64(d, a[kk], bd);
    }
  }
}

// A warpgroup's 64 rows of a bf16 [b, t, n, h] gradient, rows row0 ..
// row0 + 63 of head ni, batch bi, written by TMA (map: boxes of 64 rows):
// each thread puts its accumulators (rows 16 (warp % 4) + g and + 8,
// columns 8 j + 2 tq, + 1) into `box`, the warpgroup's 64 rows of its
// owned tile (whose last product has read them), in the swizzled layout,
// and one thread stores the kBoxes boxes. Rows and columns past t and h
// are not written. Named barrier 1 + wg orders the warpgroup's writes
// before the store.
template <int kBoxes, int kOwnBox>
__device__ __forceinline__ void StoreRows(const CUtensorMap* map,
                                          unsigned char* box,
                                          const float (&d)[32 * kBoxes],
                                          int row0, int bi, int ni, int t,
                                          int wg) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8 * kBoxes; ++j) {
    unsigned char* at = box + (j >> 3) * kOwnBox + 4 * tq +
                        (((j & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint32_t*>(at + r * kRowBytes) =
        PackBf16(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(at + (r + 8) * kRowBytes) =
        PackBf16(d[4 * j + 2], d[4 * j + 3]);
  }
  FenceProxyAsync();
  NamedBarSync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0 && row0 < t) {
    for (int bx = 0; bx < kBoxes; ++bx)
      TmaStore4(map, box + bx * kOwnBox, bx * 64, ni, row0, bi);
    TmaStoreWaitRead();
  }
}

// dK/dV: a block owns 128 keys of one (batch, head) and streams the live
// query tiles from the one holding its first key (causal) or from 0.
template <int kBoxes>
__global__ void __launch_bounds__(kBwdThreads, 1) FlashDkDvBf16Kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dk,
    const __grid_constant__ CUtensorMap tm_dv, const int* __restrict__ seg,
    const float* __restrict__ lse, const float* __restrict__ delta,
    Problem pb) {
  typedef BLayout<kBoxes, kDkvStages, kBt> L;
  constexpr int kN = 64 * kBoxes;  // head-dim columns of dK and dV
  extern __shared__ __align__(16) unsigned char bsmem[];
  unsigned char* sm = bsmem + ((1024 - (SmemAddr(bsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kDkvStages;
  uint64_t* own_bar = empty + kDkvStages;
  unsigned* live = reinterpret_cast<unsigned*>(sm + L::kLive);

  // blocks start in launch order (x fastest): block lin takes key tile
  // lin % ntk of (batch x head) lin / ntk, so the key tiles of one (b, n)
  // run together and read its Q and dO tiles from L2 (b x n apart, every
  // tile would come from device memory again); tile 0, the heaviest
  // causal one, first
  const int ntk = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int k0 = (lin % ntk) * kBOwnBf16;
  const int bi = lin / ntk / pb.n, ni = lin / ntk % pb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;
  const int nqt = (pb.t + kBt - 1) / kBt;
  const int qt0 = pb.causal ? k0 / kBt : 0;  // holds query k0

  if (tid == 0) {
    for (int st = 0; st < kDkvStages; ++st) {
      MbarInit(&full[st], 1 + 32);  // lane 0's bytes, each lane's copies
      MbarInit(&empty[st], kBConsumers / 32);  // one arrival per warp
    }
    MbarInit(own_bar, 1);
    MbarInitFence();
    LoadOwned<L>(sm, &tm_k, &tm_v, own_bar, k0, bi, ni);
  }
  int klo = 0, khi = 0;
  if (has_seg)
    WarpSegRange(seg_row, k0, kBOwnBf16, pb.t, &klo, &khi);
  else
    ZeroIds<L>(sm);
  LiveTiles(live, seg_row, klo, khi, kBt, nqt, pb.t);  // + a barrier

  if (warp >= kBConsumers / 32) {  // the producer warpgroup
    MaxRegsDec<24>();
    if (warp == kBConsumers / 32)
      BwdProducer<L>(sm, &tm_q, &tm_do, live, qt0, nqt, seg_row, lse,
                     delta, pb, bi, ni);
    return;
  }
  MaxRegsInc<240>();

  // a consumer warpgroup: keys wk0 .. wk0 + 63; this thread's keys key_a
  // and key_b = key_a + 8 (the accumulators' rows)
  const int wg = warp >> 2;
  const int tq = lane & 3;
  const int wk0 = k0 + 64 * wg;
  const int key_a = wk0 + 16 * (warp & 3) + (lane >> 2), key_b = key_a + 8;
  const int segk_a = has_seg && key_a < pb.t ? seg_row[key_a] : 0;
  const int segk_b = has_seg && key_b < pb.t ? seg_row[key_b] : 0;
  const unsigned char* ks = sm + wg * 64 * kRowBytes;  // in each K box
  const unsigned char* vs = ks + kBoxes * L::kOwnBox;  // in each V box

  float dka[kN / 2], dva[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dka[i] = dva[i] = 0.f;

  MbarWait(own_bar, 0);
  int stage = 0, phase = 0;
  for (int qt = NextLive(live, qt0, nqt); qt < nqt;
       qt = NextLive(live, qt + 1, nqt)) {
    const int q0 = qt * kBt;
    MbarWait(&full[stage], phase);
    const unsigned char* qst = sm + L::kOwn + stage * L::kStage;
    const unsigned char* dost = qst + kBoxes * L::kTileBox;
    const int* ids =
        reinterpret_cast<const int*>(sm + L::kRows + stage * L::kRowStage);
    const float* lse_s = reinterpret_cast<const float*>(ids + kBt);
    const float* delta_s = lse_s + kBt;
    if (!(pb.causal && q0 + kBt - 1 < wk0)) {  // else: all in the past
      // s^T = k . q and dp^T = v . do: 64 keys x 64 queries
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;  // overwritten
      WgmmaFence();
      ScoreWgmma<kBoxes, kBt>(st, ks, L::kOwnBox, qst, L::kTileBox);
      WgmmaCommit();
      ScoreWgmma<kBoxes, kBt>(dpt, vs, L::kOwnBox, dost, L::kTileBox);
      WgmmaCommit();
      // every pair of this thread's kept: both keys inside t, the tile
      // inside t and wholly in their causal future, one segment (no
      // branch per element: the ids come in pairs, the tests are bitwise)
      bool all_kept = key_b < pb.t && q0 + kBt <= pb.t &&
                      (!pb.causal || q0 >= key_b) && segk_a == segk_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 sq = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * tq);
        all_kept &= (sq.x == segk_a) & (sq.y == segk_a);
      }
      WgmmaWait<1>();  // s^T has landed; dp^T may still run
      FenceRegs(st);
      if (all_kept) {
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] *= pb.sm_scale;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 sq = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * tq + (e & 1);
            const int key = e < 2 ? key_a : key_b;
            const bool keep = (q < pb.t) & (key < pb.t) &
                              (!pb.causal | (q >= key)) &
                              (!has_seg | ((e & 1 ? sq.y : sq.x) ==
                                           (e < 2 ? segk_a : segk_b)));
            st[4 * j + e] = keep ? st[4 * j + e] * pb.sm_scale : kNegInf;
          }
        }
      }
      // p = exp(s - lse) in place, rounded to bf16 in the A fragments of
      // the tile's 4 k-steps of 16 queries (columns j = 2 kk, 2 kk + 1 of
      // the accumulators)
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tq);
        st[4 * j] = expf(st[4 * j] - l.x);
        st[4 * j + 1] = expf(st[4 * j + 1] - l.y);
        st[4 * j + 2] = expf(st[4 * j + 2] - l.x);
        st[4 * j + 3] = expf(st[4 * j + 3] - l.y);
        pa[j >> 1][2 * (j & 1)] = PackBf16(st[4 * j], st[4 * j + 1]);
        pa[j >> 1][2 * (j & 1) + 1] = PackBf16(st[4 * j + 2], st[4 * j + 3]);
      }
      // dv += bf16(p)^T do over the tile's 64 queries, under ds's math
      WgmmaFence();
      GradWgmma<kBoxes, kBt>(dva, pa, dost);
      WgmmaCommit();
      WgmmaWait<1>();  // dp^T has landed; dv may still run
      FenceRegs(dpt);
      // ds = p (dp - delta) sm_scale, rounded to bf16 likewise
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * tq);
        dsa[j >> 1][2 * (j & 1)] =
            PackBf16(st[4 * j] * (dpt[4 * j] - d.x) * pb.sm_scale,
                     st[4 * j + 1] * (dpt[4 * j + 1] - d.y) * pb.sm_scale);
        dsa[j >> 1][2 * (j & 1) + 1] =
            PackBf16(st[4 * j + 2] * (dpt[4 * j + 2] - d.x) * pb.sm_scale,
                     st[4 * j + 3] * (dpt[4 * j + 3] - d.y) * pb.sm_scale);
      }
      // dk += bf16(ds)^T q over the tile's 64 queries
      WgmmaFence();
      GradWgmma<kBoxes, kBt>(dka, dsa, qst);
      WgmmaCommit();
      WgmmaWait<0>();
      FenceRegs(dva);
      FenceRegs(dka);
    }
    __syncwarp();
    if (lane == 0) MbarArrive(&empty[stage]);  // this warp is done with it
    if (++stage == kDkvStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // dk and dv through this warpgroup's K and V rows
  StoreRows<kBoxes, L::kOwnBox>(&tm_dk, sm + wg * 64 * kRowBytes, dka, wk0,
                                bi, ni, pb.t, wg);
  StoreRows<kBoxes, L::kOwnBox>(&tm_dv, sm + (kBoxes * L::kOwnBox) +
                                            wg * 64 * kRowBytes,
                                dva, wk0, bi, ni, pb.t, wg);
}

// dQ: a block owns 128 queries of one (batch, head) and streams the live
// 128-key tiles up to its last query (causal) or to t. A 128-key tile
// (s, dp and dq: 192 accumulators a thread, as in dK/dV) halves the
// waits per key of 64-key tiles and runs the score products as
// m64n128k16, which read less shared memory per flop.
template <int kBoxes>
__global__ void __launch_bounds__(kBwdThreads, 1) FlashDqBf16Kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dq, const int* __restrict__ seg,
    const float* __restrict__ lse, const float* __restrict__ delta,
    Problem pb) {
  typedef BLayout<kBoxes, kDqStages, kDqT> L;
  constexpr int kN = 64 * kBoxes;  // head-dim columns of dQ
  extern __shared__ __align__(16) unsigned char bsmem[];
  unsigned char* sm = bsmem + ((1024 - (SmemAddr(bsmem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kDqStages;
  uint64_t* own_bar = empty + kDqStages;
  unsigned* live = reinterpret_cast<unsigned*>(sm + L::kLive);

  // block lin takes query tile lin % ntq of (batch x head) lin / ntq, so
  // the query tiles of one (b, n) run together and share its K and V
  // tiles in L2 (as in dK/dV); reversed when causal, the heaviest first
  const int ntq = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int qt = lin % ntq;
  const int q0 = (pb.causal ? ntq - 1 - qt : qt) * kBOwnBf16;
  const int bi = lin / ntq / pb.n, ni = lin / ntq % pb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_seg = seg != nullptr;
  const int* seg_row = has_seg ? seg + static_cast<size_t>(bi) * pb.t
                               : nullptr;
  const int k_end = pb.causal ? min(pb.t, q0 + kBOwnBf16) : pb.t;
  const int nkt = (k_end + kDqT - 1) / kDqT;

  if (tid == 0) {
    for (int st = 0; st < kDqStages; ++st) {
      MbarInit(&full[st], 1 + 32);  // lane 0's bytes, each lane's copies
      MbarInit(&empty[st], kBConsumers / 32);  // one arrival per warp
    }
    MbarInit(own_bar, 1);
    MbarInitFence();
    LoadOwned<L>(sm, &tm_q, &tm_do, own_bar, q0, bi, ni);
  }
  int qlo = 0, qhi = 0;
  if (has_seg)
    WarpSegRange(seg_row, q0, kBOwnBf16, pb.t, &qlo, &qhi);
  else
    ZeroIds<L>(sm);
  LiveTiles(live, seg_row, qlo, qhi, kDqT, nkt, pb.t);  // + a barrier

  if (warp >= kBConsumers / 32) {  // the producer warpgroup
    MaxRegsDec<24>();
    if (warp == kBConsumers / 32)
      BwdProducer<L>(sm, &tm_k, &tm_v, live, 0, nkt, seg_row, nullptr,
                     nullptr, pb, bi, ni);
    return;
  }
  MaxRegsInc<240>();

  // a consumer warpgroup: queries wq0 .. wq0 + 63; this thread's rows
  // row_a and row_b = row_a + 8 (the accumulators' layout)
  const int wg = warp >> 2;
  const int tq = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int row_a = wq0 + 16 * (warp & 3) + (lane >> 2), row_b = row_a + 8;
  const bool in_a = row_a < pb.t, in_b = row_b < pb.t;
  const int segq_a = has_seg && in_a ? seg_row[row_a] : 0;
  const int segq_b = has_seg && in_b ? seg_row[row_b] : 0;
  const float lse_a = in_a ? lse[pb.RowOff(bi, ni, row_a)] : 0.f;
  const float lse_b = in_b ? lse[pb.RowOff(bi, ni, row_b)] : 0.f;
  const float delta_a = in_a ? delta[pb.RowOff(bi, ni, row_a)] : 0.f;
  const float delta_b = in_b ? delta[pb.RowOff(bi, ni, row_b)] : 0.f;
  const unsigned char* qs = sm + wg * 64 * kRowBytes;    // in each Q box
  const unsigned char* dos = qs + kBoxes * L::kOwnBox;   // in each dO box

  float dqa[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dqa[i] = 0.f;

  MbarWait(own_bar, 0);
  int stage = 0, phase = 0;
  for (int kt = NextLive(live, 0, nkt); kt < nkt;
       kt = NextLive(live, kt + 1, nkt)) {
    const int k0 = kt * kDqT;
    MbarWait(&full[stage], phase);
    const unsigned char* kst = sm + L::kOwn + stage * L::kStage;
    const unsigned char* vst = kst + kBoxes * L::kTileBox;
    const int* ids =
        reinterpret_cast<const int*>(sm + L::kRows + stage * L::kRowStage);
    if (!(pb.causal && k0 > wq0 + 63)) {  // else: all in the future
      // s = q . k and dp = do . v: 64 queries x 128 keys
      float s[64], dp[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.f;  // overwritten
      WgmmaFence();
      ScoreWgmma<kBoxes, kDqT>(s, qs, L::kOwnBox, kst, L::kTileBox);
      WgmmaCommit();
      ScoreWgmma<kBoxes, kDqT>(dp, dos, L::kOwnBox, vst, L::kTileBox);
      WgmmaCommit();
      // every pair of this thread's kept: the tile inside t, wholly in
      // both rows' causal past, and of their one segment (no branch per
      // element, as in dK/dV)
      bool all_kept = in_b && k0 + kDqT <= pb.t &&
                      (!pb.causal || k0 + kDqT - 1 <= row_a) &&
                      segq_a == segq_b;
#pragma unroll
      for (int j = 0; j < kDqT / 8; ++j) {
        const int2 sk = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * tq);
        all_kept &= (sk.x == segq_a) & (sk.y == segq_a);
      }
      WgmmaWait<1>();  // s has landed; dp may still run
      FenceRegs(s);
      if (all_kept) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= pb.sm_scale;
      } else {
#pragma unroll
        for (int j = 0; j < kDqT / 8; ++j) {
          const int2 sk = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * tq + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool keep = (row < pb.t) & (key < pb.t) &
                              (!pb.causal | (row >= key)) &
                              (!has_seg | ((e & 1 ? sk.y : sk.x) ==
                                           (e < 2 ? segq_a : segq_b)));
            s[4 * j + e] = keep ? s[4 * j + e] * pb.sm_scale : kNegInf;
          }
        }
      }
      // p = exp(s - lse) in place
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = expf(s[i] - (i & 2 ? lse_b : lse_a));
      WgmmaWait<0>();
      FenceRegs(dp);
      // ds = p (dp - delta) sm_scale, rounded to bf16 in the A fragments of
      // the tile's 8 k-steps of 16 keys
      uint32_t dsa[kDqT / 16][4];
#pragma unroll
      for (int j = 0; j < kDqT / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = s[4 * j + e] *
                  (dp[4 * j + e] - (e < 2 ? delta_a : delta_b)) * pb.sm_scale;
        dsa[j >> 1][2 * (j & 1)] = PackBf16(ds[0], ds[1]);
        dsa[j >> 1][2 * (j & 1) + 1] = PackBf16(ds[2], ds[3]);
      }
      // dq += bf16(ds) k over the tile's 128 keys
      WgmmaFence();
      GradWgmma<kBoxes, kDqT>(dqa, dsa, kst);
      WgmmaCommit();
      WgmmaWait<0>();
      FenceRegs(dqa);
    }
    __syncwarp();
    if (lane == 0) MbarArrive(&empty[stage]);  // this warp is done with it
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // dq through this warpgroup's Q rows
  StoreRows<kBoxes, L::kOwnBox>(&tm_dq, sm + wg * 64 * kRowBytes, dqa, wq0,
                                bi, ni, pb.t, wg);
}

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

// The float32 backward kernels' instantiation for head dim h.
decltype(&FlashDkDvKernel<1>) DkDvKernelFor(int h) {
  return h > 64 ? FlashDkDvKernel<2> : FlashDkDvKernel<1>;
}

decltype(&FlashDqKernel<1>) DqKernelFor(int h) {
  return h > 64 ? FlashDqKernel<2> : FlashDqKernel<1>;
}

// The TMA map of a bf16 [b, t, n, h] tensor in boxes of `rows` rows of one
// (batch, head) x 64 head-dim columns, 128-byte swizzled; rows past t and
// columns past h read as zeros.
bool BoxMap(EncodeTiledFn encode, CUtensorMap* map, const void* base, int b,
            int t, int n, int h, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(h) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * n, row * n * t};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 backward kernels' instantiation and shared memory for head
// dim h (kBoxes = 1 up to h = 64).
decltype(&FlashDkDvBf16Kernel<1>) DkDvBf16KernelFor(int h) {
  return h > 64 ? FlashDkDvBf16Kernel<2> : FlashDkDvBf16Kernel<1>;
}

decltype(&FlashDqBf16Kernel<1>) DqBf16KernelFor(int h) {
  return h > 64 ? FlashDqBf16Kernel<2> : FlashDqBf16Kernel<1>;
}

size_t DkDvBf16Smem(int t, int h) {
  return h > 64 ? BLayout<2, kDkvStages, kBt>::Bytes(t)
                : BLayout<1, kDkvStages, kBt>::Bytes(t);
}

size_t DqBf16Smem(int t, int h) {
  return h > 64 ? BLayout<2, kDqStages, kDqT>::Bytes(t)
                : BLayout<1, kDqStages, kDqT>::Bytes(t);
}

// geo[0..5] of one kernel for FlashBwdGeometry, after opting it into
// `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t KernelGeometry(Kernel kernel, int tiles, int threads,
                           size_t smem, int* geo) {
  cudaFuncAttributes attr;
  cudaError_t err = AllowSmem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&geo[3], kernel,
                                                        threads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  geo[0] = tiles;
  geo[1] = threads;
  geo[2] = static_cast<int>(smem);
  geo[4] = attr.numRegs;
  geo[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
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
  const size_t smem = FwdLayout(t, h).bytes;
  cudaError_t err = AllowSmem(FlashFwdKernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FlashFwdKernel<<<dim3((t + kFq - 1) / kFq, b * n), kFThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(q, k, v, seg, out,
                                                        lse, pb);
  return static_cast<int>(cudaGetLastError());
}

// The forward kernel's launch geometry at (t, h): threads and dynamic
// shared memory per block, and the blocks resident on one SM. Returns the
// cudaError_t.
int FlashFwdGeometry(int t, int h, int* threads, int* smem_bytes,
                     int* blocks_per_sm) {
  if (BadShape(1, t, 1, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FwdLayout(t, h).bytes;
  cudaError_t err = AllowSmem(FlashFwdKernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kFThreads;
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, FlashFwdKernel, kFThreads, smem));
}

int FlashBwdDkDvF32(const float* q, const float* k, const float* v,
                    const int* seg, const float* dout, const float* lse,
                    const float* delta, float* dk, float* dv, int b, int t,
                    int n, int h, int causal, void* stream) {
  if (BadShape(b, t, n, h) || (t + kBOwn - 1) / kBOwn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = BwdLayout(t, h, kBDkDvTile, true).bytes;
  const auto kernel = DkDvKernelFor(h);
  cudaError_t err = AllowSmem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b * n, (t + kBOwn - 1) / kBOwn), kBThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, v, seg, dout, lse,
                                                delta, dk, dv, pb);
  return static_cast<int>(cudaGetLastError());
}

int FlashBwdDqF32(const float* q, const float* k, const float* v,
                  const int* seg, const float* dout, const float* lse,
                  const float* delta, float* dq, int b, int t, int n, int h,
                  int causal, void* stream) {
  if (BadShape(b, t, n, h) || (t + kBOwn - 1) / kBOwn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = BwdLayout(t, h, kBDqTile, false).bytes;
  const auto kernel = DqKernelFor(h);
  cudaError_t err = AllowSmem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b * n, (t + kBOwn - 1) / kBOwn), kBThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, v, seg, dout, lse,
                                                delta, dq, pb);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 kernels (same conventions; q/k/v/out/do/dq/dk/dv bf16, lse
// and delta float32). block_k: the reference's key block, a multiple of 64
// or >= t.

int FlashFwdBF16(const void* q, const void* k, const void* v, const int* seg,
                 void* out, float* lse, int b, int t, int n, int h,
                 int causal, int block_k, void* stream) {
  if (BadShape(b, t, n, h) || block_k <= 0 ||
      (block_k < t && block_k % kWk != 0) || (t + kWq - 1) / kWq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = TensorMapEncoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!BoxMap(encode, &mq, q, b, t, n, h, kWq) ||
      !BoxMap(encode, &mk, k, b, t, n, h, kWk) ||
      !BoxMap(encode, &mv, v, b, t, n, h, kWk))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(b * n, (t + kWq - 1) / kWq);
  cudaError_t err;
  if (h <= 64) {
    const size_t smem = WLayout<1>::Bytes(t);
    err = AllowSmem(FlashFwdBf16Kernel<1>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    FlashFwdBf16Kernel<1><<<grid, kWThreads, smem, s>>>(
        mq, mk, mv, seg, static_cast<bf16*>(out), lse, pb, block_k);
  } else {
    const size_t smem = WLayout<2>::Bytes(t);
    err = AllowSmem(FlashFwdBf16Kernel<2>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    FlashFwdBf16Kernel<2><<<grid, kWThreads, smem, s>>>(
        mq, mk, mv, seg, static_cast<bf16*>(out), lse, pb, block_k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward kernel's launch geometry at (t, h), as FlashFwdGeometry.
int FlashFwdBf16Geometry(int t, int h, int* threads, int* smem_bytes,
                         int* blocks_per_sm) {
  if (BadShape(1, t, 1, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = h <= 64 ? WLayout<1>::Bytes(t) : WLayout<2>::Bytes(t);
  cudaError_t err = h <= 64 ? AllowSmem(FlashFwdBf16Kernel<1>, smem)
                            : AllowSmem(FlashFwdBf16Kernel<2>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kWThreads;
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(
      h <= 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, FlashFwdBf16Kernel<1>, kWThreads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, FlashFwdBf16Kernel<2>, kWThreads, smem));
}

int FlashBwdDkDvBF16(const void* q, const void* k, const void* v,
                     const int* seg, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int b, int t,
                     int n, int h, int causal, void* stream) {
  if (BadShape(b, t, n, h) || (t + kBOwnBf16 - 1) / kBOwnBf16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = TensorMapEncoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!BoxMap(encode, &mq, q, b, t, n, h, kBt) ||
      !BoxMap(encode, &mk, k, b, t, n, h, kBOwnBf16) ||
      !BoxMap(encode, &mv, v, b, t, n, h, kBOwnBf16) ||
      !BoxMap(encode, &mdo, dout, b, t, n, h, kBt) ||
      !BoxMap(encode, &mdk, dk, b, t, n, h, 64) ||
      !BoxMap(encode, &mdv, dv, b, t, n, h, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = DkDvBf16Smem(t, h);
  const auto kernel = DkDvBf16KernelFor(h);
  cudaError_t err = AllowSmem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b * n, (t + kBOwnBf16 - 1) / kBOwnBf16), kBwdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, mdk, mdv, seg, lse, delta, pb);
  return static_cast<int>(cudaGetLastError());
}

int FlashBwdDqBF16(const void* q, const void* k, const void* v,
                   const int* seg, const void* dout, const float* lse,
                   const float* delta, void* dq, int b, int t, int n, int h,
                   int causal, void* stream) {
  if (BadShape(b, t, n, h) || (t + kBOwnBf16 - 1) / kBOwnBf16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = TensorMapEncoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!BoxMap(encode, &mq, q, b, t, n, h, kBOwnBf16) ||
      !BoxMap(encode, &mk, k, b, t, n, h, kDqT) ||
      !BoxMap(encode, &mv, v, b, t, n, h, kDqT) ||
      !BoxMap(encode, &mdo, dout, b, t, n, h, kBOwnBf16) ||
      !BoxMap(encode, &mdq, dq, b, t, n, h, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb = MakeProblem(t, n, h, causal);
  const size_t smem = DqBf16Smem(t, h);
  const auto kernel = DqBf16KernelFor(h);
  cudaError_t err = AllowSmem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(b * n, (t + kBOwnBf16 - 1) / kBOwnBf16), kBwdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, mdq, seg, lse, delta, pb);
  return static_cast<int>(cudaGetLastError());
}

// The two backward kernels of one dtype (bf16 != 0: bfloat16, else
// float32) at (t, h): geo[0..5] for dK/dV, geo[6..11] for dQ, each the
// grid's tile count (grid y; grid x is b x n), threads, dynamic shared
// memory per block, blocks resident on one SM, registers per thread and
// local (spill) bytes per thread. Returns the cudaError_t.
int FlashBwdGeometry(int t, int h, int bf16, int* geo) {
  if (BadShape(1, t, 1, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16) {
    const int tiles = (t + kBOwnBf16 - 1) / kBOwnBf16;
    err = KernelGeometry(DkDvBf16KernelFor(h), tiles, kBwdThreads,
                         DkDvBf16Smem(t, h), geo);
    if (err == cudaSuccess)
      err = KernelGeometry(DqBf16KernelFor(h), tiles, kBwdThreads,
                           DqBf16Smem(t, h), geo + 6);
  } else {
    const int tiles = (t + kBOwn - 1) / kBOwn;
    err = KernelGeometry(DkDvKernelFor(h), tiles, kBThreads,
                         BwdLayout(t, h, kBDkDvTile, true).bytes, geo);
    if (err == cudaSuccess)
      err = KernelGeometry(DqKernelFor(h), tiles, kBThreads,
                           BwdLayout(t, h, kBDqTile, false).bytes, geo + 6);
  }
  return static_cast<int>(err);
}

const char* FlashErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
