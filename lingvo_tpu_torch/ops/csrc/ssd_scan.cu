// Chunked gated linear-recurrence scan (SSD form) for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel `_ScanKernel` of lingvo_tpu/ops/ssd_scan.py
// (pallas_call in `_ChunkedPallas`; public entry `SsdScan`). It computes
// what the reference's `_ChunkBody` computes under its chunk loop, not the
// same blocks. Per row r = (batch b, head n) and per chunk of Q steps:
//
//   cum   = prefix sum of the chunk's log-decays dl
//   y     = (c * exp(cum)) s_in^T
//           + ((c b^T) o exp(where(t >= t', cum_t - cum_t', -inf))) v
//   s_out = exp(cum_Q) s_in + (v * exp(cum_Q - cum))^T b
//
// with the [H, S] state carried from chunk to chunk (s_in of the first chunk
// is s0, or zeros).
//
// Design: one 256-thread block per row. The TPU grid (rows, chunks) carried
// the state in VMEM scratch along its sequential chunk axis; CUDA blocks run
// in no order, so the chunk loop runs inside the block and the state lives
// in shared memory for the whole row. Each chunk stages c (then v), b when
// it fits, and the masked Q x Q decay-weighted score matrix G in shared
// memory, and runs the four Q-wide products as register-tiled float32 FMA
// loops on the CUDA cores (no TF32: float32 is the parity bar). Each thread
// owns a 4 x 4 output tile whose rows and columns are strided by the tile
// counts, so a warp reads neighbouring shared-memory words; every staged
// row is padded by one word so the transposed reads are free of bank
// conflicts too. A thread adds the intra-chunk term to the very outputs it
// wrote as the inter-chunk term (the two products share one tile map), so y
// goes to device memory once per chunk with no second pass.
//
// Inputs are read in their [B, T, N, X] layout by stride and y is written
// in [B, T, N, H], so the wrapper copies nothing. The ragged tail of T is
// never padded in memory: the last chunk runs over its live steps only,
// which is what the reference's identity-step padding (dl = 0, b = c = v =
// 0) computes, since those steps add exact zeros and leave cum unchanged.
// Within a chunk the decays are differences of cumsums, as in the
// reference (a product of per-step exps would underflow differently), the
// masked upper triangle of G is exactly 0, and a reset is an ordinary
// decay of -60.
//
// Bound: the function needs 2 (2 Q S H + Q (Q + 1) / 2 (S + H))
// operations per chunk and row (the two Q x Q products count only their
// causal lower triangle; the upper one is masked to 0), about 21
// operations per byte moved at Q = S = H = 64, so at the serving shape
// (128 rows x 256 steps) the bound is the 67 TFLOP/s float32 peak
// (0.81 GFLOP, 0.0121 ms) over the bytes (37.9 MB, 0.0113 ms). The kernel
// computes the full Q x Q tiles and writes zeros above the diagonal. What
// this simple design leaves on the table: 128 rows give 128
// blocks, one per SM, each walking its chunks in turn with barriers between
// the products, so the card is latency-bound; and the products run on the
// CUDA cores. A later kernel should compute the chunks' local states in
// parallel, pass the chunk states in a short sequential scan, then compute
// the outputs in parallel, with the products on the tensor cores.
//
// Limits (the Python wrapper raises outside them): Q, S, H in [1, 128];
// contiguous float32 tensors; any T.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;
constexpr size_t kMaxSmem = 232448;   // what one block may opt in to on sm_90

// C[m, n] = sum_k A(m, k) B(k, n) for m < M, n < N, handed to epi(m, n, c).
// A(m, k) = a[m * am + k * ak], B(k, n) = b[k * bk + n * bn]. Thread i of the
// block owns the outputs (tm + i' * tmc, tn + j' * tnc), i', j' < 4, of tile
// (tm, tn); out-of-range rows and columns are read clamped and not written.
template <class Epi>
__device__ __forceinline__ void TileProduct(int M, int N, int K,
                                            const float* a, int am, int ak,
                                            const float* b, int bk, int bn,
                                            Epi epi) {
  const int tmc = (M + 3) / 4, tnc = (N + 3) / 4;
  for (int tile = threadIdx.x; tile < tmc * tnc; tile += kThreads) {
    const int tm = tile / tnc, tn = tile % tnc;
    int aoff[4], boff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aoff[i] = min(tm + i * tmc, M - 1) * am;
      boff[i] = min(tn + i * tnc, N - 1) * bn;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a[aoff[i] + k * ak];
        bv[i] = b[k * bk + boff[i]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tm + i * tmc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + j * tnc;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
    }
  }
}

// Copies rows x cols floats (row i at src + i * src_stride, cols contiguous)
// into shared memory at dst + i * dst_stride. Each thread issues its loads
// four at a time, as float4 where the rows allow it, so a thread has all of
// a chunk's loads in flight at once instead of waiting out one device
// memory latency per element.
__device__ __forceinline__ void StageRows(float* dst, int dst_stride,
                                          const float* __restrict__ src,
                                          size_t src_stride, int rows,
                                          int cols) {
  if ((cols & 3) == 0 && (src_stride & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = cols >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int r = i / c4, c = (i % c4) << 2;
      const float4 v =
          *reinterpret_cast<const float4*>(src + r * src_stride + c);
      float* d = dst + r * dst_stride + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * dst_stride + c] = src[r * src_stride + c];
    }
  }
}

struct Layout {
  int sp, qp, xp;    // padded row strides of the state, G and the c/v stage
  size_t floats;     // shared floats without the b stage
  size_t with_b;     // shared floats with the b stage
};

Layout MakeLayout(int q, int s, int h) {
  Layout l;
  l.sp = s + 1;
  l.qp = q + 1;
  l.xp = (s > h ? s : h) + 1;
  l.floats = static_cast<size_t>(h) * l.sp + static_cast<size_t>(q) * l.qp +
             static_cast<size_t>(q) * l.xp + 2 * static_cast<size_t>(q);
  l.with_b = l.floats + static_cast<size_t>(q) * l.sp;
  return l;
}

__global__ void __launch_bounds__(kThreads) SsdScanKernel(
    const float* __restrict__ dl, const float* __restrict__ bg,
    const float* __restrict__ cg, const float* __restrict__ vg,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ s_fin, int T, int N, int S, int H, int Q,
    int stage_b) {
  extern __shared__ float sm[];
  const int sp = S + 1, qp = Q + 1, xp = (S > H ? S : H) + 1;
  float* st = sm;               // [H][sp] the running state
  float* g = st + H * sp;       // [Q][qp] decay-weighted scores
  float* x = g + Q * qp;        // [Q][xp] c, then v, then v * exp(tot - cum)
  float* cum = x + Q * xp;      // [Q] the chunk's cumsum of dl
  float* wt = cum + Q;          // [Q] exp(tot - cum)
  float* bs = wt + Q;           // [Q][sp] b, when staged

  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int bi = r / N, ni = r % N;
  const size_t row_s = static_cast<size_t>(N) * S;   // one step of b / c
  const size_t row_h = static_cast<size_t>(N) * H;   // one step of v / y
  const float* dl_r = dl + static_cast<size_t>(bi) * T * N + ni;
  const float* b_r = bg + static_cast<size_t>(bi) * T * row_s +
                     static_cast<size_t>(ni) * S;
  const float* c_r = cg + static_cast<size_t>(bi) * T * row_s +
                     static_cast<size_t>(ni) * S;
  const float* v_r = vg + static_cast<size_t>(bi) * T * row_h +
                     static_cast<size_t>(ni) * H;
  float* y_r = y + static_cast<size_t>(bi) * T * row_h +
               static_cast<size_t>(ni) * H;
  const size_t state_off = static_cast<size_t>(r) * H * S;

  for (int i = tid; i < H * S; i += kThreads)
    st[(i / S) * sp + i % S] = s0 != nullptr ? s0[state_off + i] : 0.f;

  for (int t0 = 0; t0 < T; t0 += Q) {
    const int live = min(Q, T - t0);
    __syncthreads();   // the previous chunk is done with every buffer
    for (int i = tid; i < live; i += kThreads) cum[i] = dl_r[(t0 + i) * N];
    StageRows(x, xp, c_r + t0 * row_s, row_s, live, S);
    if (stage_b) StageRows(bs, sp, b_r + t0 * row_s, row_s, live, S);
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int i = 0; i < live; ++i) {
        acc += cum[i];
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float tot = cum[live - 1];
    const float* bsrc = stage_b ? bs : b_r + t0 * row_s;
    const int bstride = stage_b ? sp : static_cast<int>(row_s);

    // inter-chunk: y[t, h] = exp(cum_t) sum_s c[t, s] st[h, s]
    TileProduct(live, H, S, x, xp, 1, st, 1, sp,
                [&](int m, int n, float acc) {
                  y_r[(t0 + m) * row_h + n] = acc * expf(cum[m]);
                });
    // G[t, t'] = (c_t . b_t') exp(cum_t - cum_t') for t' <= t, else 0
    TileProduct(live, live, S, x, xp, 1, bsrc, 1, bstride,
                [&](int m, int n, float acc) {
                  g[m * qp + n] = n <= m ? acc * expf(cum[m] - cum[n]) : 0.f;
                });
    __syncthreads();   // c is dead and G complete: v replaces c
    StageRows(x, xp, v_r + t0 * row_h, row_h, live, H);
    for (int i = tid; i < live; i += kThreads) wt[i] = expf(tot - cum[i]);
    __syncthreads();
    // intra-chunk: y[t, h] += sum_t' G[t, t'] v[t', h] (the same tile map as
    // the inter-chunk product, so each thread adds to what it wrote)
    TileProduct(live, H, live, g, qp, 1, x, xp, 1,
                [&](int m, int n, float acc) {
                  y_r[(t0 + m) * row_h + n] += acc;
                });
    __syncthreads();   // every thread has read v
    for (int i = tid; i < live * H; i += kThreads) {
      const int t = i / H, h = i % H;
      x[t * xp + h] *= wt[t];
    }
    __syncthreads();
    // state out: st[h, s] = exp(tot) st[h, s] + sum_t (v * w)[t, h] b[t, s]
    const float decay_all = expf(tot);
    TileProduct(H, S, live, x, 1, xp, bsrc, bstride, 1,
                [&](int m, int n, float acc) {
                  st[m * sp + n] = decay_all * st[m * sp + n] + acc;
                });
  }
  __syncthreads();
  for (int i = tid; i < H * S; i += kThreads)
    s_fin[state_off + i] = st[(i / S) * sp + i % S];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// dl [B, T, N]; b, c [B, T, N, S]; v, y [B, T, N, H]; s0 (may be null for
// zeros), s_fin [B, N, H, S]; all contiguous float32 on one device.
int SsdScanF32(const float* dl, const float* b, const float* c,
               const float* v, const float* s0, float* y, float* s_fin,
               int batch, int T, int N, int S, int H, int Q, void* stream) {
  if (batch <= 0 || N <= 0) return 0;
  if (S < 1 || S > kMaxDim || H < 1 || H > kMaxDim || Q < 1 || Q > kMaxDim ||
      T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = T > 0 && T < Q ? T : Q;   // one chunk covers a short T
  const Layout l = MakeLayout(q, S, H);
  const int stage_b = l.with_b * sizeof(float) <= kMaxSmem ? 1 : 0;
  const size_t smem = (stage_b ? l.with_b : l.floats) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        SsdScanKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(batch) * N;
  SsdScanKernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dl, b, c, v, s0, y, s_fin, T, N, S, H, q, stage_b);
  return static_cast<int>(cudaGetLastError());
}

const char* SsdScanErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
