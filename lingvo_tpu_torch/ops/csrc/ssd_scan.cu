// Chunked gated linear-recurrence scan (SSD form) for Hopper (sm_90a),
// float32: the chunks of a row in parallel, the carry passed in order
// across a thread-block cluster, identity chunks skipped.
//
// Replaces the Pallas TPU kernel `_ScanKernel` of lingvo_tpu/ops/ssd_scan.py
// (pallas_call in `_ChunkedPallas`; public entry `SsdScan`). It computes
// what the reference's `_ChunkBody` computes under its chunk loop. Per row
// r = (batch b, head n) and chunk j of Q steps (the [H, S] state S_{j-1}
// comes in; S_{-1} is s0, or zeros):
//
//   cum   = prefix sum of the chunk's log-decays dl, tot = cum_Q
//   y     = (c o exp(cum)) S_{j-1}^T                                (inter)
//           + ((c b^T) o exp(where(t >= t', cum_t - cum_t', -inf))) v (intra)
//   U_j   = (v o exp(tot - cum))^T b
//   S_j   = exp(tot) S_{j-1} + U_j
//
// Bound (the least time of the same work on an H100 SXM at 700 W: 67
// TFLOP/s float32 outside the tensor cores, 3.35 TB/s): 2 (2 Q S H + Q (Q +
// 1) / 2 (S + H)) operations per chunk and row (the two Q x Q products
// count their causal lower triangle only). At the hybrid's serving shape
// ([8, 256, 16], S = H = 64, Q = 64) that is 0.81 GFLOP, 0.0121 ms, over
// 37.9 MB, 0.0113 ms; at its training shape ([8, 1024, 16]) 0.0483 ms of
// operations. What a call's data needs is less, and that live-work bound
// is the one chip_smoke.py reports for the kernel (the full one beside
// it): an identity chunk (every step dl = 0 and v = 0, the masking
// contract's padding) needs only y = c S_{j-1}^T and no b, and a live
// chunk needs b, U_j, G and the intra product only up to its last nonzero
// v. At the serving shape's mixed pack that is 0.40 GFLOP over 31.5 MB,
// 0.0094 ms of bytes; at a decode-only pack (1 live step a row) 0.0088
// ms; at the training shape 0.0473 ms of operations.
//
// Design. The first port walked a row's chunks in turn in one 256-thread
// block (128 blocks at serving, one per SM), each chunk a chain of four
// products with scalar shared loads, split by seven barriers: about 28 us
// of latency per chunk. Here, point by point (the numbers are PERF.md's,
// NVIDIA H100 80GB HBM3 at 700 W):
//  1. Chunks of a row in parallel. One cluster of C = min(8, ceil(chunks /
//     2)) blocks per row (and per group of at most 64 columns of H: the h
//     columns never mix, so H = 128 runs as two clusters that each
//     recompute the c b^T scores). Block k owns the contiguous run of
//     chunks [k nc / C, (k + 1) nc / C): two at serving and training, so
//     that 128 rows give 256 blocks, one wave at 2 blocks an SM, and the
//     second chunk's loads run under the first one's products. Phase 1
//     runs with no carry: each chunk's cum and U_j, folded from a zero
//     state into the run's local state L = exp(tot) L + U_j and decay D =
//     D exp(tot). The blocks then exchange one flag (does my run hold a
//     live chunk?) through distributed shared memory and a cluster
//     barrier. Phase 2 is the carry: the first live block takes s0, and
//     every live block sends S_out = D S_in + L into the shared memory of
//     every block up to and including the next live one, by st.async
//     stores that count their bytes on the receiver's mbarrier (an
//     identity block takes the carry that passes over it and sends
//     nothing); the last live block writes s_fin. With one chunk a block
//     this is the reference's own step, exp(tot) S_in + U_j; with several
//     it is the same chain with its products grouped per run. Phase 3
//     computes each chunk's outputs: G and the intra product first, then,
//     in the first chunk, the wait for the carry (a block whose carry is
//     late does its own products meanwhile), then the inter product onto
//     the same registers, y stored once, and S_j = exp(tot) S_{j-1} + U_j
//     within the run. Two calls give the same bits: every sum has a fixed
//     order and nothing is atomic. Any T: a run of three chunks or more
//     (a long T) reloads its chunks in phase 3 and recomputes their U_j
//     (the two-pass form).
//  2. The products (c b^T, (G o decay) v, U^T = b^T (v o w), (c o exp(cum))
//     S^T) run on 4 x 4 register patches, 256 threads (8 warps) a block,
//     2 blocks an SM. A 64 x 64 output is 16 values a thread, so 8 x 4 or
//     8 x 8 patches (2.7 or 4 FFMA per float loaded, against 2) need fewer
//     threads or a K split across warps; both were slower at the hybrid's
//     shapes: 8 x 4 on 128 threads, and 8 x 4 y patches on 256 threads
//     with K split over two warp halves, which needs about 200 registers
//     and so one block an SM (PERF.md, section 6). The patches are
//     fed by 16-byte shared loads: a warp's 4 load phases read 4
//     consecutive rows of A (4 bank groups) or one broadcast word, and 8
//     consecutive 16-byte words of B; the carry is kept transposed, [s][h],
//     so that the inter product reads it as rows. G is computed only in
//     16 x 32 tiles on or below the diagonal and only in the 8-column
//     groups below the chunk's last nonzero v; the intra product stops at
//     the diagonal tile.
//  3. dl, v and b come by cp.async into a two-stage ring (the next chunk's
//     dl and v load under this one's products), and c into its own
//     buffer, loaded under the previous chunk's stores. The cumsum is one
//     thread's loop in step order: a warp scan took as long, and after a
//     -60 reset its other rounding of cum put y 1.75e-4 from the plain
//     version at the mixed pack (in step order 4.8e-6).
//  4. Identity chunks are skipped exactly: the kernel reads dl and v, and
//     a chunk with no nonzero dl or v skips the b load, G, the intra
//     product and U_j; it writes y = c S_{j-1}^T and passes S_{j-1} on. By
//     `_ChunkBody`, cum = 0 there, so exp(cum) = 1 and the skipped terms
//     are exact zeros. Likewise, in a live chunk, steps after the last
//     nonzero v add only zeros to U_j and to the intra product (v = 0), so
//     both stop there. (Both skips assume finite b and c, as the
//     reference's own padding does.)
//  5. y goes to device memory once: the inter product accumulates onto
//     the intra product's registers.
//  6. Per-element roundings follow the reference: exp of cumsum
//     differences (never products of per-step exps), c o exp(cum), v o w
//     and G o exp(...) rounded before their products, exp(tot) S + U with
//     two roundings, the masked upper triangle exactly 0, a reset an
//     ordinary decay of -60. Only the order of float32 sums differs
//     (products, y's two terms and the per-run grouping of the carry).
//     chip_smoke.py prints the kernel's and the plain version's distance
//     from the same formulas in float64.
// What it leaves: the products are float32 on the CUDA cores (3xTF32 on
// the tensor cores is a later step) and near their issue rate when both
// blocks of an SM compute; at 2 blocks an SM the 256-thread kernel is held
// to 128 registers and spills a few words a thread (ptxas: 22 bytes
// stored, 28 loaded); most of a block's time is the first loads
// (every block starts at once: a burst at the memory's rate), the chunk's
// b load after its live check, the carry crossing the cluster in turn,
// and barriers.
//
// Limits (the Python wrapper raises outside them): Q, S, H in [1, 128];
// contiguous float32 tensors; any T.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 128;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kHGroup = 64;            // the widest h columns of one cluster
constexpr size_t kMaxSmem = 232448;    // what one block may opt in to on sm_90
constexpr int kMisc = 32;              // flags[8], warp maxima[16], mbarrier

__host__ __device__ inline int RoundUp(int x, int m) {
  return (x + m - 1) / m * m;
}

// The launch's shape, computed on the host and read by every block.
struct Plan {
  int q;                 // chunk length: Q, or T when T < Q
  int nc;                // chunks per row
  int cluster;           // blocks per row: the cluster size
  int pmax;              // most chunks a block owns
  int hg, hb;            // h groups (clusters per row) and their width
  int qp, sp, hp;        // q rounded up to 32; S, the widest group to 8
  int lds, ldh, ldbg;    // row strides (floats) of c, v / the carry, b / G
  int off_v, off_bg;     // in a stage: v and b / G (cum, exp(cum), w, and a
                         // header come first)
  int stage, stages;     // floats per stage; stages in the ring
  int off_c, off_st, off_misc;   // after the stages
  int threads;           // 256 (q, S <= 64) or 512
  size_t bytes;          // dynamic shared memory
};

Plan MakePlan(int T, int S, int H, int Q) {
  Plan pl = {};
  pl.q = T > 0 && T < Q ? T : Q;
  pl.nc = T > 0 ? (T + pl.q - 1) / pl.q : 0;
  // at least two chunks a block where the row has them, so that a block's
  // next chunk loads under this one's products
  pl.cluster = (pl.nc + 1) / 2 < 1 ? 1 : ((pl.nc + 1) / 2 < kMaxCluster
                                             ? (pl.nc + 1) / 2
                                             : kMaxCluster);
  pl.pmax = (pl.nc + pl.cluster - 1) / pl.cluster;
  pl.hg = (H + kHGroup - 1) / kHGroup;
  pl.hb = RoundUp((H + pl.hg - 1) / pl.hg, 4);
  pl.qp = RoundUp(pl.q, 32);   // whole 32-row tiles
  pl.sp = RoundUp(S, 8);
  pl.hp = RoundUp(pl.hb < H ? pl.hb : H, 8);
  pl.lds = pl.sp + 4;
  pl.ldh = pl.hp + 4;
  pl.ldbg = (pl.sp > pl.qp ? pl.sp : pl.qp) + 4;
  pl.off_v = 3 * pl.qp + 8;
  pl.off_bg = pl.off_v + pl.qp * pl.ldh;
  pl.stage = pl.off_bg + pl.qp * pl.ldbg;
  pl.threads = pl.qp > 64 || pl.sp > 64 ? 512 : 256;
  for (pl.stages = pl.pmax > 1 ? 2 : 1;; --pl.stages) {
    pl.off_c = pl.stages * pl.stage;
    pl.off_st = pl.off_c + pl.qp * pl.lds;
    pl.off_misc = pl.off_st + pl.sp * pl.ldh;
    pl.bytes = static_cast<size_t>(pl.off_misc + kMisc) * sizeof(float);
    if (pl.bytes <= kMaxSmem || pl.stages == 1) break;
  }
  return pl;
}

struct Params {
  const float* dl;
  const float* b;
  const float* c;
  const float* v;
  const float* s0;   // may be null: zeros
  float* y;
  float* s_fin;
  int T, N, S, H;
  int vec_s, vec_h, vec_fin;   // 16-byte copies of b / c, v / y, s_fin
  Plan pl;
};

// -- copies ------------------------------------------------------------------

// rows x cols floats (row i at src + i * stride) into dst (row stride ld),
// zero-filled out to rows_pad x cols_pad: the reference's identity padding
// (rows past T) and zero columns that add nothing to any product. Thread
// t copies column t % per_row of rows t / per_row, t / per_row + step, ...
// Kept out of line: it runs a few times a chunk, and its copies would
// otherwise fill the instruction cache.
__device__ __noinline__ void CopyRows(float* dst, int ld, const float* src,
                                      size_t stride, int rows, int rows_pad,
                                      int cols, int cols_pad, bool vec) {
  const int width = vec ? 4 : 1;                  // floats a copy
  const int per_row = cols_pad / width;
  const int step = blockDim.x / per_row;          // rows a pass
  const int c = (threadIdx.x % per_row) * width;
  const bool col_in = c < cols;
#pragma unroll 1
  for (int r = threadIdx.x < step * per_row ? threadIdx.x / per_row : rows_pad;
       r < rows_pad; r += step) {
    const bool in = col_in && r < rows;
    const float* from = in ? src + r * stride + c : src;
    if (vec)
      CpAsync16(dst + r * ld + c, from, in);
    else
      CpAsync4(dst + r * ld + c, from, in);
  }
}

// -- register patches --------------------------------------------------------
//
// A warp computes a 16-row x 32-column tile of an output, each lane a 4 x 4
// patch: lane l takes columns n0 + j, n0 = 32 wn + 4 (l % 8), and either
// rows m0 + 4 i, m0 = 16 wm + l / 8 (`RowPatch`: A read as rows along k,
// so the 4 load phases of a warp read 4 consecutive rows, 4 bank groups),
// or rows m0 + i, m0 = 16 wm + 4 (l / 8) (`ColPatch`: A read along m). The
// 8 lanes of a load phase share their A address (a broadcast) and read 8
// consecutive 16-byte words of B.

__device__ __forceinline__ float F4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void Zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a[i * lda + k] b[j * ldb + k] for j < kJ (K %
// 4 == 0): rows of A and of B along k
template <int kJ>
__device__ __forceinline__ void ProductNT(float (&acc)[4][4], const float* a,
                                          int lda, const float* b, int ldb,
                                          int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_{k < K} a[i * lda + k] b[k * ldb + j] (K % 4 == 0)
__device__ __forceinline__ void ProductNN(float (&acc)[4][4], const float* a,
                                          int lda, const float* b, int ldb,
                                          int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bv[kk] = *reinterpret_cast<const float4*>(b + (k + kk) * ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, F4(bv[0], j), s);
        s = fmaf(av[i].y, F4(bv[1], j), s);
        s = fmaf(av[i].z, F4(bv[2], j), s);
        s = fmaf(av[i].w, F4(bv[3], j), s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_{k < K} a[k * lda + i] (b[k * ldb + j] w[k])
__device__ __forceinline__ void ProductTNScaled(float (&acc)[4][4],
                                                const float* a, int lda,
                                                const float* b, int ldb,
                                                const float* w, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb);
    const float wk = w[k];
    const float bw[4] = {__fmul_rn(bv.x, wk), __fmul_rn(bv.y, wk),
                         __fmul_rn(bv.z, wk), __fmul_rn(bv.w, wk)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(F4(av, i), bw[j], acc[i][j]);
  }
}

struct Patch {
  int m0, n0;
  bool on;
};

// lane's patch of tile `tile` (tiles_n tiles a row) of an output with np
// columns: rows m0 + 4 i
__device__ __forceinline__ Patch RowPatch(int tile, int tiles_n, int np) {
  const int lane = threadIdx.x & 31;
  Patch p;
  p.m0 = (tile / tiles_n) * 16 + (lane >> 3);
  p.n0 = (tile % tiles_n) * 32 + (lane & 7) * 4;
  p.on = p.n0 < np;
  return p;
}

// the same with rows m0 + i, of an mp x np output
__device__ __forceinline__ Patch ColPatch(int tile, int tiles_n, int mp,
                                          int np) {
  const int lane = threadIdx.x & 31;
  Patch p;
  p.m0 = (tile / tiles_n) * 16 + (lane >> 3) * 4;
  p.n0 = (tile % tiles_n) * 32 + (lane & 7) * 4;
  p.on = p.m0 < mp && p.n0 < np;
  return p;
}

// -- the kernel --------------------------------------------------------------

// One block of a row's cluster (grid (C x rows, h groups), cluster (C, 1,
// 1)); see the head of this file.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 256 ? 2 : 1)
    SsdScanKernel(const __grid_constant__ Params p) {
  constexpr int kWarps = kThreads / 32;
  // lower 16 x 32 score tiles a warp computes: 6 tiles of q <= 64 over 8
  // warps, 20 of q <= 128 over 16
  constexpr int kGTiles = kThreads == 256 ? 1 : 2;
  extern __shared__ __align__(16) float sm[];
  const Plan& pl = p.pl;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = pl.cluster;
  const int k = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / C;
  const int bi = static_cast<int>(row / p.N), ni = static_cast<int>(row % p.N);
  const int h0 = blockIdx.y * pl.hb;
  const int hb = min(pl.hb, p.H - h0);
  const int j0 = static_cast<int>(static_cast<long long>(k) * pl.nc / C);
  const int P =
      static_cast<int>(static_cast<long long>(k + 1) * pl.nc / C) - j0;
  const bool cached = P <= pl.stages;   // phase 3 finds its chunks in the ring
  const bool ring = pl.stages == 2;
  const int qp = pl.qp, sp = pl.sp, hp = pl.hp;
  const int lds = pl.lds, ldh = pl.ldh, ldbg = pl.ldbg;
  const size_t row_s = static_cast<size_t>(p.N) * p.S;   // one step of b / c
  const size_t row_h = static_cast<size_t>(p.N) * p.H;   // one step of v / y
  const float* dl_r = p.dl + static_cast<size_t>(bi) * p.T * p.N + ni;
  const float* b_r = p.b + static_cast<size_t>(bi) * p.T * row_s +
                     static_cast<size_t>(ni) * p.S;
  const float* c_r = p.c + static_cast<size_t>(bi) * p.T * row_s +
                     static_cast<size_t>(ni) * p.S;
  const float* v_r = p.v + static_cast<size_t>(bi) * p.T * row_h +
                     static_cast<size_t>(ni) * p.H + h0;
  float* y_r = p.y + static_cast<size_t>(bi) * p.T * row_h +
               static_cast<size_t>(ni) * p.H + h0;
  const size_t state_off =
      static_cast<size_t>(row) * p.H * p.S + static_cast<size_t>(h0) * p.S;
  float* cbuf = sm + pl.off_c;   // [qp][lds] c, then c o exp(cum)
  float* st = sm + pl.off_st;    // [sp][ldh] the carry, transposed: S[h][s]
                                 // at st[s * ldh + h]
  int* flags = reinterpret_cast<int*>(sm + pl.off_misc);      // [8]
  int* wmax = flags + 8;                                      // [16]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + pl.off_misc + 24);

  // a stage: cum [qp] (dl until the scan), exp(cum) [qp], w = exp(tot -
  // cum) [qp], header {tot, exp(tot), live, kv4}, v [qp][ldh], b then G
  // [qp][ldbg]
  auto Stage = [&](int i) { return sm + (i % pl.stages) * pl.stage; };
  auto Rows = [&](int i) { return min(pl.q, p.T - (j0 + i) * pl.q); };

  auto IssueDlV = [&](int i) {
    float* sg = Stage(i);
    const int t0 = (j0 + i) * pl.q, qc = Rows(i);
    for (int t = tid; t < qp; t += kThreads)
      CpAsync4(sg + t, t < qc ? dl_r + static_cast<size_t>(t0 + t) * p.N
                              : dl_r,
               t < qc);
    CopyRows(sg + pl.off_v, ldh, v_r + t0 * row_h, row_h, qc, qp, hb, hp,
             p.vec_h);
  };
  auto IssueB = [&](int i) {
    CopyRows(Stage(i) + pl.off_bg, ldbg, b_r + (j0 + i) * pl.q * row_s,
             row_s, Rows(i), qp, p.S, sp, p.vec_s);
  };
  auto IssueC = [&](int i) {
    CopyRows(cbuf, lds, c_r + (j0 + i) * pl.q * row_s, row_s, Rows(i), qp,
             p.S, sp, p.vec_s);
  };
  auto IssueS0 = [&]() {   // s0 [h][s] into st [s][h], zero padded
    const int s = tid % sp, step = kThreads / sp;   // sp <= kThreads
#pragma unroll 1
    for (int h = tid < step * sp ? tid / sp : hp; h < hp; h += step) {
      const bool in = p.s0 != nullptr && h < hb && s < p.S;
      CpAsync4(st + s * ldh + h, in ? p.s0 + state_off + h * p.S + s : p.dl,
               in);
    }
  };

  // After the chunk's dl and v have landed (and a barrier): is the chunk
  // live (some dl or v nonzero), and how far do its values reach (the
  // rows up to the last nonzero v, rounded up to 4)? Written to the
  // stage's header for phase 3.
  auto Check = [&](int i, int& kv4) -> bool {
    float* sg = Stage(i);
    int last = 0;
    bool any = false;
    const int c4 = hp >> 2, step = kThreads / c4;   // hp <= 64: c4 <= 16
#pragma unroll 1
    for (int t = tid / c4; t < qp; t += step) {
      const float4 x = *reinterpret_cast<const float4*>(
          sg + pl.off_v + t * ldh + (tid % c4) * 4);
      if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f) last = t + 1;
    }
    for (int t = tid; t < qp; t += kThreads) any |= sg[t] != 0.f;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) wmax[warp] = last;
    const bool live = __syncthreads_or(any || last > 0) != 0;
    int kv = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) kv = max(kv, wmax[w]);
    kv4 = RoundUp(kv, 4);
    if (tid == 0) {
      int* hdr = reinterpret_cast<int*>(sg + 3 * qp);
      hdr[2] = live;
      hdr[3] = kv4;
    }
    return live;
  };

  // The chunk's cumsum (one thread, in step order), exp(cum), w = exp(tot
  // - cum), tot and exp(tot).
  auto Scan = [&](int i) {
    float* sg = Stage(i);
    if (tid == 0) {
      float run = 0.f;
#pragma unroll 4
      for (int t = 0; t < qp; t += 4) {   // qp % 32 == 0, sg 16-byte aligned
        float4 x = *reinterpret_cast<float4*>(sg + t);
        x.x = run = __fadd_rn(run, x.x);
        x.y = run = __fadd_rn(run, x.y);
        x.z = run = __fadd_rn(run, x.z);
        x.w = run = __fadd_rn(run, x.w);
        *reinterpret_cast<float4*>(sg + t) = x;
      }
    }
    __syncthreads();
    const float tot = sg[qp - 1];
    for (int t = tid; t < qp; t += kThreads) {
      sg[qp + t] = expf(sg[t]);
      sg[2 * qp + t] = expf(tot - sg[t]);
    }
    if (tid == 0) {
      sg[3 * qp] = tot;
      sg[3 * qp + 1] = expf(tot);
    }
  };

  // One chunk's loads and checks: wait for its dl and v (all but the last
  // `pending` copy groups), decide live, fetch b if live and the next
  // chunk's dl and v into the other stage, scan. On return b has landed
  // and the block has passed a barrier.
  auto Visit = [&](int i, int& kv4, int pending) -> bool {
    if (pending)
      CpAsyncWait<1>();
    else
      CpAsyncWait<0>();
    __syncthreads();
    const bool live = Check(i, kv4);
    if (live) {
      IssueB(i);
      CpAsyncCommit();
    }
    const bool next = ring && i + 1 < P;
    if (next) {
      IssueDlV(i + 1);
      CpAsyncCommit();
    }
    if (live) {
      Scan(i);
      if (next)
        CpAsyncWait<1>();
      else
        CpAsyncWait<0>();
    } else if (tid == 0) {
      float* sg = Stage(i);
      sg[3 * qp] = 0.f;
      sg[3 * qp + 1] = 1.f;
    }
    __syncthreads();
    return live;
  };

  // U_j^T [s][h] = sum_t b[t][s] (v[t][h] w[t]), this thread's patch
  const int tn_u = (hp + 31) / 32;
  Patch pu = ColPatch(warp, tn_u, sp, hp);
  pu.on = pu.on && warp < ((sp + 15) / 16) * tn_u;
  auto ComputeU = [&](int i, int kv4, float (&u)[4][4]) {
    Zero(u);
    const float* sg = Stage(i);
    if (pu.on)
      ProductTNScaled(u, sg + pl.off_bg + pu.m0, ldbg, sg + pl.off_v + pu.n0,
                      ldh, sg + 2 * qp, kv4);
  };

  if (tid == 0) {   // the carry's barrier completes when its bytes are in
    MbarInit(bar, 1);
    if (k > 0) MbarArriveExpectTx(bar, sp * hp * sizeof(float));
    MbarInitFence();
  }
  ClusterArriveRelaxed();   // 1: every block has started, the barrier is set

  if (P > 0) IssueDlV(0);
  if (k == 0) IssueS0();   // block 0 never waits for a carry
  CpAsyncCommit();
  if (P > 0 && cached) IssueC(0);   // a group of its own: b need not wait
  CpAsyncCommit();                  // for it

  // -- phase 1: the run's local state from zero ------------------------------
  float L[4][4], u[4][4];   // u: the run's first chunk's U_j, for phase 3
  Zero(L);
  Zero(u);
  float D = 1.f;
  bool run_live = false;
  for (int i = 0; i < P; ++i) {
    int kv4;
    if (Visit(i, kv4, i == 0 ? 1 : 0)) {   // c_0 may still be in flight
      float uj[4][4];
      ComputeU(i, kv4, uj);
      const float e = Stage(i)[3 * qp + 1];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          L[a][b] = __fadd_rn(__fmul_rn(e, L[a][b]), uj[a][b]);
          if (i == 0) u[a][b] = uj[a][b];
        }
      D = __fmul_rn(D, e);
      run_live = true;
    }
    if (!ring && i + 1 < P) {   // one stage: the next chunk loads now
      __syncthreads();
      IssueDlV(i + 1);
      CpAsyncCommit();
    }
  }
  if (!cached) {   // phase 3 reloads its chunks, starting with the first
    __syncthreads();
    IssueDlV(0);
    IssueC(0);
    CpAsyncCommit();
  }

  // -- phase 2: the carry ----------------------------------------------------
  ClusterWait();
  if (tid < C) *cluster.map_shared_rank(flags + k, tid) = run_live ? 1 : 0;
  ClusterArrive();   // 2: every block's flag is in every block
  ClusterWait();
  int src = -1, next = -1, last_live = -1;
  for (int r = 0; r < C; ++r) {
    if (!flags[r]) continue;
    if (r < k) src = r;
    if (r > k && next < 0) next = r;
    last_live = r;
  }
  const bool writes_fin = run_live ? next < 0 : last_live < 0 && k == C - 1;
  float* fin = p.s_fin + state_off;
  // S_out = D S_in + L into every block up to the next live one (or into
  // s_fin), float4 by float4 of this thread's patch
  auto Hop = [&]() {
    const int upto = next >= 0 ? next : C - 1;
    if (pu.on) {
      float4 o[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 x =
            *reinterpret_cast<const float4*>(st + (pu.m0 + a) * ldh + pu.n0);
        o[a] = make_float4(__fadd_rn(__fmul_rn(D, x.x), L[a][0]),
                           __fadd_rn(__fmul_rn(D, x.y), L[a][1]),
                           __fadd_rn(__fmul_rn(D, x.z), L[a][2]),
                           __fadd_rn(__fmul_rn(D, x.w), L[a][3]));
      }
      for (int r = k + 1; r <= upto; ++r) {
        const uint32_t rs = MapShared(st, r), rbar = MapShared(bar, r);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          StAsync(rs + ((pu.m0 + a) * ldh + pu.n0) * sizeof(float), o[a],
                  rbar);
      }
      if (writes_fin) {   // s_fin [h][s]: this thread's 4 s of 4 h
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (pu.n0 + b >= hb) break;
          const float4 f = make_float4(F4(o[0], b), F4(o[1], b), F4(o[2], b),
                                       F4(o[3], b));
          float* fp = fin + (pu.n0 + b) * p.S + pu.m0;
          if (p.vec_fin && pu.m0 + 4 <= p.S) {
            *reinterpret_cast<float4*>(fp) = f;
          } else {
#pragma unroll
            for (int a = 0; a < 4; ++a)
              if (pu.m0 + a < p.S) fp[a] = F4(f, a);
          }
        }
      }
    }
  };
  if (src < 0) {   // the carry is s0: pass it on now
    if (k != 0) {
      IssueS0();
      CpAsyncCommit();
    }
    CpAsyncWait<0>();
    __syncthreads();
    if (run_live) {
      Hop();
    } else if (writes_fin) {   // no live chunk in the row: s_fin = s0
      for (int i = tid; i < hb * p.S; i += kThreads)
        fin[i] = st[(i % p.S) * ldh + i / p.S];
    }
  }
  bool carried = src < 0;   // else: after the first chunk's intra product

  // -- phase 3: each chunk's outputs, the carry advanced within the run ------
  const int tq = qp / 16;   // 16-row tiles
  const int tn_y = (hp + 31) / 32;
  Patch py = RowPatch(warp, tn_y, hp);   // rows py.m0 + 4 a
  py.on = py.on && warp < tq * tn_y;
  const int y_k = min(qp, (warp / tn_y + 1) * 16);   // the diagonal tile's end
  for (int i = 0; i < P; ++i) {
    float* sg = Stage(i);
    int kv4;
    bool live;
    if (cached) {
      CpAsyncWait<0>();
      __syncthreads();
      const int* hdr = reinterpret_cast<const int*>(sg + 3 * qp);
      live = hdr[2] != 0;
      kv4 = hdr[3];
    } else {
      live = Visit(i, kv4, 0);
    }
    const int t0 = (j0 + i) * pl.q, qc = Rows(i);
    const bool advance = live && i + 1 < P;
    float* bg = sg + pl.off_bg;
    const float* cum = sg;
    if (advance && i > 0) ComputeU(i, kv4, u);   // chunk 0's is kept
    float acc[4][4];
    Zero(acc);
    if (live) {
      // G[t][t'] = (c_t . b_t') exp(cum_t - cum_t') on and below the
      // diagonal, for t' < kv4, into registers, then stored over b. Lane
      // l of a tile takes the columns 32 wn + l % 8 + 8 j, so the 8 lanes
      // of a load phase read 8 consecutive rows of b (8 bank groups).
      float g[kGTiles][4][4];
      int gm[kGTiles], gn[kGTiles];
      bool gon[kGTiles];
#pragma unroll
      for (int x = 0; x < kGTiles; ++x) {
        // the idx-th tile on or below the diagonal: 16-row block wm has
        // min(qp / 32, wm / 2 + 1) tiles of 32 columns
        int wm = 0, wn = warp + x * kWarps;
        while (wm < tq && wn >= min(qp / 32, wm / 2 + 1)) {
          wn -= min(qp / 32, wm / 2 + 1);
          ++wm;
        }
        gm[x] = wm * 16 + (lane >> 3);   // rows gm + 4 a
        gn[x] = wn * 32 + (lane & 7);    // columns gn + 8 j
        gon[x] = wm < tq && wn * 32 < kv4;
        Zero(g[x]);
        if (gon[x]) {
          const float* b_rows = bg + gn[x] * ldbg;   // rows gn + 8 j < qp
          // only the column groups below kv4: a decode row's chunk has
          // kv4 = 4, and needs 1 of a tile's 4
          const int need = kv4 - (gn[x] & ~31);
          const float* c_rows = cbuf + gm[x] * lds;
          if (need <= 8)
            ProductNT<1>(g[x], c_rows, 4 * lds, b_rows, 8 * ldbg, sp);
          else if (need <= 16)
            ProductNT<2>(g[x], c_rows, 4 * lds, b_rows, 8 * ldbg, sp);
          else
            ProductNT<4>(g[x], c_rows, 4 * lds, b_rows, 8 * ldbg, sp);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int t = gm[x] + 4 * a, tp = gn[x] + 8 * j;
              g[x][a][j] = tp <= t && tp < kv4
                               ? __fmul_rn(g[x][a][j], expf(cum[t] - cum[tp]))
                               : 0.f;
            }
        }
      }
      __syncthreads();   // every score tile has read all of b and c
#pragma unroll
      for (int x = 0; x < kGTiles; ++x) {
        if (!gon[x]) continue;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bg[(gm[x] + 4 * a) * ldbg + gn[x] + 8 * j] = g[x][a][j];
      }
      const int s4 = sp >> 2;
      for (int e = tid; e < qp * s4; e += kThreads) {   // c o exp(cum)
        const int t = e / s4;
        float4* cp = reinterpret_cast<float4*>(cbuf + t * lds) + (e - t * s4);
        const float ec = sg[qp + t];
        float4 x = *cp;
        x.x = __fmul_rn(x.x, ec);
        x.y = __fmul_rn(x.y, ec);
        x.z = __fmul_rn(x.z, ec);
        x.w = __fmul_rn(x.w, ec);
        *cp = x;
      }
      __syncthreads();
      // intra: y[t][h] = sum_{t' <= t} G[t][t'] v[t'][h]
      if (py.on)
        ProductNN(acc, bg + py.m0 * ldbg, 4 * ldbg, sg + pl.off_v + py.n0,
                  ldh, min(kv4, y_k));
    }
    if (!carried) {   // the previous live block's S_out has arrived
      MbarWaitCluster(bar, 0);
      if (run_live) Hop();
      carried = true;
    }
    // inter: y[t][h] += sum_s (c o exp(cum))[t][s] S[h][s] (an identity
    // chunk has cum = 0: c as it is)
    if (py.on)
      ProductNN(acc, cbuf + py.m0 * lds, 4 * lds, st + py.n0, ldh, sp);
    __syncthreads();   // c and the carry are read
    if (i + 1 < P) {   // the next chunk's c loads under the stores below
      IssueC(i + 1);
      CpAsyncCommit();
    }
    if (advance && pu.on) {   // S_j = exp(tot) S_{j-1} + U_j
      const float e = sg[3 * qp + 1];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* sp4 = reinterpret_cast<float4*>(st + (pu.m0 + a) * ldh +
                                                pu.n0);
        float4 x = *sp4;
        x.x = __fadd_rn(__fmul_rn(e, x.x), u[a][0]);
        x.y = __fadd_rn(__fmul_rn(e, x.y), u[a][1]);
        x.z = __fadd_rn(__fmul_rn(e, x.z), u[a][2]);
        x.w = __fadd_rn(__fmul_rn(e, x.w), u[a][3]);
        *sp4 = x;
      }
    }
    if (py.on) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = py.m0 + 4 * a;
        if (t >= qc) break;
        float* yp = y_r + static_cast<size_t>(t0 + t) * row_h + py.n0;
        if (p.vec_h && py.n0 < hb) {
          *reinterpret_cast<float4*>(yp) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (py.n0 + b < hb) yp[b] = acc[a][b];
        }
      }
    }
    if (!cached && !ring && i + 1 < P) {   // one stage: the next chunk now
      __syncthreads();
      IssueDlV(i + 1);
      CpAsyncCommit();
    }
  }
}

template <int kThreads>
cudaError_t AllowSmem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(SsdScanKernel<kThreads>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

void ClusterConfig(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   const Plan& pl, long long rows, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * pl.cluster),
                      static_cast<unsigned>(pl.hg));
  cfg->blockDim = dim3(pl.threads);
  cfg->dynamicSmemBytes = pl.bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int kThreads>
cudaError_t Launch(const Params& prm, long long rows, cudaStream_t stream) {
  cudaError_t err = AllowSmem<kThreads>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterConfig(&cfg, attr, prm.pl, rows, stream);
  err = cudaLaunchKernelEx(&cfg, SsdScanKernel<kThreads>, prm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t Geometry(const Plan& pl, int* geo) {
  cudaError_t err = AllowSmem<kThreads>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, SsdScanKernel<kThreads>);
  if (err != cudaSuccess) return err;
  geo[7] = attr.numRegs;
  geo[8] = static_cast<int>(attr.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &geo[9], SsdScanKernel<kThreads>, kThreads, pl.bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cattr[1];
  ClusterConfig(&cfg, cattr, pl, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(&geo[10], SsdScanKernel<kThreads>,
                                        &cfg);
}

bool Aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

bool BadDims(int T, int S, int H, int Q) {
  return S < 1 || S > kMaxDim || H < 1 || H > kMaxDim || Q < 1 ||
         Q > kMaxDim || T < 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// dl [B, T, N]; b, c [B, T, N, S]; v, y [B, T, N, H]; s0 (may be null for
// zeros), s_fin [B, N, H, S]; all contiguous float32 on one device. One
// kernel.
int SsdScanF32(const float* dl, const float* b, const float* c,
               const float* v, const float* s0, float* y, float* s_fin,
               int batch, int T, int N, int S, int H, int Q, void* stream) {
  if (batch <= 0 || N <= 0) return 0;
  if (BadDims(T, S, H, Q)) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.dl = dl;
  prm.b = b;
  prm.c = c;
  prm.v = v;
  prm.s0 = s0;
  prm.y = y;
  prm.s_fin = s_fin;
  prm.T = T;
  prm.N = N;
  prm.S = S;
  prm.H = H;
  prm.vec_s = S % 4 == 0 && Aligned(b) && Aligned(c);
  prm.vec_h = H % 4 == 0 && Aligned(v) && Aligned(y);
  prm.vec_fin = S % 4 == 0 && Aligned(s_fin);
  prm.pl = MakePlan(T, S, H, Q);
  if (prm.pl.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = prm.pl.threads == 256 ? Launch<256>(prm, rows, s)
                                                : Launch<512>(prm, rows, s);
  return static_cast<int>(err);
}

// The launch geometry of a call at (T, S, H, Q), into geo[11]: cluster
// size, chunks per row, most chunks a block owns, threads, dynamic shared
// bytes, ring stages, h groups, registers, local (spill) bytes per thread,
// resident blocks per SM, resident clusters on the card.
int SsdScanGeometry(int T, int S, int H, int Q, int* geo) {
  if (BadDims(T, S, H, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = MakePlan(T, S, H, Q);
  geo[0] = pl.cluster;
  geo[1] = pl.nc;
  geo[2] = pl.pmax;
  geo[3] = pl.threads;
  geo[4] = static_cast<int>(pl.bytes);
  geo[5] = pl.stages;
  geo[6] = pl.hg;
  const cudaError_t err =
      pl.threads == 256 ? Geometry<256>(pl, geo) : Geometry<512>(pl, geo);
  return static_cast<int>(err);
}

const char* SsdScanErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
