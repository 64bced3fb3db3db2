// Backward of the chunked gated linear-recurrence scan (SSD form) for
// Hopper (sm_90a), float32.
//
// Replaces no pallas_call. The reference binds its Pallas forward
// (`_PallasScan`, lingvo_tpu/ops/ssd_scan.py) to a jax.custom_vjp whose
// backward `_PallasScanBwd` (:260) is the VJP of the XLA chunked lowering
// `_ChunkedXla`, recomputed from the saved inputs: XLA ops, not a kernel.
// Without a kernel the card would run autograd over every chunk body's
// small eager ops. This file computes that VJP. Per row r = (batch b,
// head n) and chunk j of Q steps, with the chunk's incoming state S_in,
// the cotangents dy [Q, H] and dS_out [H, S] (the next chunk's dS_in, or
// the cotangent of s_fin for the last chunk; zeros when absent):
//
//   cum = prefix sum of dl within the chunk, tot = cum_{Q-1}, E_t = exp(cum_t)
//   L[t, p] = exp(cum_t - cum_p) for p <= t, else 0;  w_p = exp(tot - cum_p)
//   scores = c b^T, G = dy v^T (both [Q, Q], lower triangle)
//   dS_in = exp(tot) dS_out + ((c o E)^T dy)^T
//   dc    = E o (dy S_in) + (G o L) b
//   db    = (G o L)^T c + w o (v dS_out)
//   dv    = (scores o L)^T dy + w o (b dS_out^T)
//   dcum_t = rowsum_t(M) - colsum_t(M) + E_t sum_s c (dy S_in)
//            - w_t sum_h v (b dS_out^T) [+ dtot at t = Q - 1],
//     M = G o scores o L,  dtot = sum_p w_p sum_h v (b dS_out^T)
//                                 + exp(tot) <dS_out, S_in>
//   d dl  = reverse prefix sum of dcum within the chunk.
//
// cum restarts at every chunk, so nothing crosses a chunk boundary but the
// two states. Every exponent is a difference cum_t - cum_p (p <= t) or tot -
// cum_p, or cum_t itself, all <= 0 under the masking contract, and nothing
// is divided: after a RESET_LOG step exp underflows to 0 and every output
// stays finite. Identity chunks are not skipped (the forward skips them):
// backward they still pass dS through and still give dc = dy S_in.
//
// Design: three passes, two launches, one counted call.
//  1. SsdScanBwdSweepKernel: the state recurrences, each row of the [H, S]
//     state on its own (they never mix), so a block carries a slice of 32
//     state rows. Block (r, g), r < R, walks row r's chunks forward from
//     s0 and writes each chunk's incoming slice of S_in into a scratch of
//     [R, NC, H, S] float32 (the forward's states, recomputed: S_j =
//     exp(tot) S_{j-1} + (v o w)^T b); block (R + r, g) walks them
//     backward from the cotangent of s_fin and writes each chunk's dS_out
//     into a second scratch; after chunk 0 its slice is ds0's. 512 blocks
//     of 128 threads at the training shape. The slice stays in shared
//     memory; each chunk's two operands are staged beside it, already in
//     the layout the product reads with 16-byte loads.
//  2. SsdScanBwdChunkKernel, one block per (row, chunk): with both states
//     known, every chunk's gradients are independent. 2048 blocks at the
//     training shape ([8, 1024, 16], Q = 64). A block stages b, c, dy,
//     S_in and dS_out, and b, c, dy, v and dS_out transposed, so that
//     each product reads its 4 x 4 patch's operands of a k as two 16-byte
//     loads (all but (G o L) b, whose A is read by rows); 222 KB, one
//     block an SM. Two [Q, Q] matrices stay in shared memory: scores o L
//     and G, then G o L in place. d dl is held on its own: the row and
//     column sums of M and the per-step dots are kept in separate vectors
//     and combined by one thread in step order, then summed in reverse.
//     When the staged tiles do not fit (Q, S, H near 128), only the two
//     [Q, Q] matrices and one [Q, max(S, H)] buffer are kept there and the
//     tiles are read from device memory with scalar loads.
// Every product is a 4 x 4 register patch per thread over a plain k loop
// (the triangular ones cut at the diagonal); every sum has a fixed order
// and nothing is atomic, so two calls give the same bits.
//
// Bound (H100 SXM at 700 W: 67 TFLOP/s float32 outside the tensor cores,
// 3.35 TB/s): per chunk of q live steps 5 q H S + q (q + 1) / 2 (3 S + 2 H)
// FMAs (the two state sweeps, dy S_in, b dS_out^T, v dS_out, and the five
// triangular products); at [8, 1024, 16], S = H = 64, Q = 64 that is 8.0
// GFLOP, 0.120 ms, against 236 MB of inputs read once and gradients
// written once, 0.070 ms: bound by operations. The scratch states (2 x
// 33.5 MB at that shape) are the design's, not the function's, and stay
// mostly in L2. The products run on the CUDA cores from shared memory,
// two 16-byte loads per 16 FMAs of a patch; what is left for later: 3xTF32
// on the tensor cores, and the states kept on chip across a cluster as the
// forward keeps its carry.
//
// Limits (the Python wrapper raises outside them): Q, S, H in [1, 128];
// contiguous float32 tensors; any T.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 128;
constexpr int kThreads = 256;          // a chunk block
constexpr int kSweepThreads = 128;     // a sweep block
constexpr int kHGroup = 32;            // the state rows of a sweep block
constexpr size_t kMaxSmem = 232448;    // what one block may opt in to on sm_90

// A strided matrix view: element (i, j) at p[i * rs + j * cs]. It points
// into shared memory (staged tiles) or device memory.
struct Mat {
  const float* p;
  int rs;
  int cs;
  __device__ float At(int i, int j) const { return p[i * rs + j * cs]; }
  __device__ Mat T() const { return Mat{p, cs, rs}; }
};

// Which part of a product's k range can hold nonzeros.
enum Tri {
  kFull = 0,
  kKUpToM = 1,    // A(m, k) = 0 for k > m: k < m0 + 4
  kKFromM = 2,    // A(m, k) = 0 for k < m: k >= m0
  kLowerOut = 3,  // only outputs with n <= m are wanted: skip patches above
};

__host__ __device__ inline int Round4(int x) { return (x + 3) & ~3; }

// C[m, n] = sum_k A(m, k) B(k, n) over [M, N], K, one 4 x 4 patch per
// thread at a time; epi(m, n, value) stores each element. kAV: A is
// contiguous along m (A.rs == 1, A.cs a multiple of 4, 16-byte aligned),
// and the patch's four A values of a k are one 16-byte load; kBV the same
// for B along n. Such a load may read up to 3 elements past the edge (a
// row's padding); they only reach accumulators that are never stored.
// Scalar operands clamp rows and columns past the edge to the last one.
template <bool kAV, bool kBV, class Epi>
__device__ __forceinline__ void Product(int M, int N, int K, Mat A, Mat B,
                                        int tri, Epi epi) {
  const int pm = (M + 3) >> 2, pn = (N + 3) >> 2;
  for (int patch = threadIdx.x; patch < pm * pn; patch += blockDim.x) {
    const int m0 = (patch / pn) * 4, n0 = (patch % pn) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    int k0 = 0, k1 = K;
    if (tri == kKUpToM) k1 = min(K, m0 + 4);
    if (tri == kKFromM) k0 = m0;
    if (tri == kLowerOut && n0 > m0 + 3) k1 = 0;
    const float* ap[4];
    const float* bp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ap[i] = A.p + (kAV ? m0 : min(m0 + i, M - 1) * A.rs) + k0 * A.cs;
      bp[i] = B.p + (kBV ? n0 : min(n0 + i, N - 1) * B.cs) + k0 * B.rs;
    }
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float a[4], b[4];
      if (kAV) {
        const float4 x = *reinterpret_cast<const float4*>(ap[0]);
        a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
        ap[0] += A.cs;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *ap[i];
          ap[i] += A.cs;
        }
      }
      if (kBV) {
        const float4 x = *reinterpret_cast<const float4*>(bp[0]);
        b[0] = x.x, b[1] = x.y, b[2] = x.z, b[3] = x.w;
        bp[0] += B.rs;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = *bp[j];
          bp[j] += B.rs;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

__device__ __forceinline__ float WarpSum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const float* dl;      // [B, T, N]
  const float* b;       // [B, T, N, S]
  const float* c;       // [B, T, N, S]
  const float* v;       // [B, T, N, H]
  const float* s0;      // [B, N, H, S] or null (zeros)
  const float* dy;      // [B, T, N, H]
  const float* ds_fin;  // [B, N, H, S] or null (zeros)
  float* ddl;
  float* db;
  float* dc;
  float* dv;
  float* ds0;           // null: not wanted
  float* s_in;          // scratch [R, NC, H, S]: each chunk's incoming state
  float* ds_out;        // scratch [R, NC, H, S]: each chunk's dS_out
  int T, N, S, H, Q, NC;
};

// Copies rows [0, rows) x columns [0, w) (w <= 128) of a device matrix
// with row stride ld into shared memory through store(i, k, x). Each warp
// takes 8 rows at a time and issues all their loads (read-only, __ldg)
// before any store: a load through a generic pointer may not pass a store
// to shared memory, so a loop that alternates them waits out each load's
// latency in turn.
template <class Store>
__device__ __forceinline__ void CopyIn(const float* src, size_t ld, int rows,
                                       int w, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int t0 = warp * 8; t0 < rows; t0 += nw * 8) {
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = t0 + i, k = lane + 32 * c;
        x[i][c] = t < rows && k < w ? __ldg(src + t * ld + k) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = t0 + i, k = lane + 32 * c;
        if (t < rows && k < w) store(t, k, x[i][c]);
      }
  }
}

// The chunk's cumsum of dl in step order (the plain version's order), by
// one thread; the loads go ahead of the sums in groups of 8.
__device__ __forceinline__ void SerialCumSum(const float* dl, float* cum,
                                             int qv) {
  float s = 0.f;
  for (int t0 = 0; t0 < qv; t0 += 8) {
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = t0 + i < qv ? dl[t0 + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 + i < qv) {
        s += d[i];
        cum[t0 + i] = s;
      }
    }
  }
}

// Pass 1: block (r, g), r < R, the forward state sweep of row r over the
// state rows h in [32 g, 32 g + 32); block (R + r, g) the reverse
// cotangent sweep. The rows of the state never mix, so each block carries
// its own slice. Shared: the slice [32, S'] (S' = S rounded up to 4), X
// [Q, 32], Y [Q, S'], dl and cum [Q'].
__global__ void __launch_bounds__(kSweepThreads) SsdScanBwdSweepKernel(
    Args a) {
  extern __shared__ __align__(16) float sm[];
  const int R = gridDim.x / 2;
  const bool rev = static_cast<int>(blockIdx.x) >= R;
  const int r = rev ? blockIdx.x - R : blockIdx.x;
  const int bb = r / a.N, n = r % a.N;
  const int S = a.S, H = a.H, lds = Round4(S);
  const int h0 = blockIdx.y * kHGroup, hg = min(kHGroup, H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t HS = static_cast<size_t>(H) * S;
  float* st = sm;
  float* X = st + kHGroup * lds;
  float* Y = X + a.Q * kHGroup;
  float* dlv = Y + a.Q * lds;
  float* cum = dlv + Round4(a.Q);
  float* scratch = rev ? a.ds_out : a.s_in;
  const float* init = rev ? a.ds_fin : a.s0;
  for (int i = warp; i < hg; i += nw)
    for (int s = lane; s < S; s += 32)
      st[i * lds + s] = init ? init[r * HS + (h0 + i) * S + s] : 0.f;
  for (int it = 0; it < a.NC; ++it) {
    const int j = rev ? a.NC - 1 - it : it;
    const int t0 = j * a.Q, qv = min(a.Q, a.T - t0);
    const size_t step0 = static_cast<size_t>(bb) * a.T + t0;
    __syncthreads();   // the slice after the last chunk is complete
    float* out = scratch + (static_cast<size_t>(r) * a.NC + j) * HS;
    for (int i = warp; i < hg; i += nw)
      for (int s = lane; s < S; s += 32)
        out[(h0 + i) * S + s] = st[i * lds + s];
    for (int t = threadIdx.x; t < qv; t += blockDim.x)
      dlv[t] = a.dl[(step0 + t) * a.N + n];
    __syncthreads();
    if (threadIdx.x == 0) SerialCumSum(dlv, cum, qv);
    __syncthreads();
    const float tot = cum[qv - 1];
    // forward: X = v o w, Y = b; reverse: X = dy, Y = c o E
    const size_t g = step0 * a.N + n;
    const size_t NH = static_cast<size_t>(a.N) * H;
    const size_t NS = static_cast<size_t>(a.N) * S;
    if (rev) {
      CopyIn(a.dy + g * H + h0, NH, qv, hg,
             [&](int t, int k, float x) { X[t * kHGroup + k] = x; });
      CopyIn(a.c + g * S, NS, qv, S, [&](int t, int k, float x) {
        Y[t * lds + k] = x * expf(cum[t]);
      });
    } else {
      CopyIn(a.v + g * H + h0, NH, qv, hg, [&](int t, int k, float x) {
        X[t * kHGroup + k] = x * expf(tot - cum[t]);
      });
      CopyIn(a.b + g * S, NS, qv, S,
             [&](int t, int k, float x) { Y[t * lds + k] = x; });
    }
    __syncthreads();
    const float et = expf(tot);
    // slice[h, s] = exp(tot) slice[h, s] + sum_t X[t, h] Y[t, s]
    Product<true, true>(hg, S, qv, Mat{X, 1, kHGroup}, Mat{Y, lds, 1}, kFull,
                        [&](int h, int s, float acc) {
                          float* p = st + h * lds + s;
                          *p = __fadd_rn(__fmul_rn(et, *p), acc);
                        });
  }
  if (rev && a.ds0 != nullptr) {
    __syncthreads();
    for (int i = warp; i < hg; i += nw)
      for (int s = lane; s < S; s += 32)
        a.ds0[r * HS + (h0 + i) * S + s] = st[i * lds + s];
  }
}

// The chunk kernel's shared layout, in floats: dl, cum, rowM, colM, ci, vd
// [Q'] and 32 for a reduction; AL = scores o L and GL = G (then G o L),
// [Q, Q' + 4]; T1 [Q, max(S, H)']. Staged, the tiles as the products read
// them: b, c [Q, S'], dy [Q, H'], dy^T, v^T [H, Q' + 4], b^T, c^T [S, Q' +
// 4], S_in, dS_out [H, S'], dS_out^T [S, H' + 4] (x' = x rounded up to 4;
// the + 4 keeps the transposing writes to 4-way bank conflicts and the
// scalar row reads of GL free of them).
struct ChunkLayout {
  int ldp, ldt, lds, ldh, ldh2;
  size_t vec, al, gl, t1, b, c, dy, dyt, vt, bt, ct, sin, dso, dsot, floats;

  __host__ __device__ ChunkLayout(int S, int H, int Q, bool staged) {
    const int q4 = Round4(Q);
    ldp = q4 + 4;
    ldt = Round4(S > H ? S : H);
    lds = Round4(S);
    ldh = Round4(H);
    ldh2 = ldh + 4;
    vec = 0;
    al = vec + 6 * q4 + 32;
    gl = al + static_cast<size_t>(Q) * ldp;
    t1 = gl + static_cast<size_t>(Q) * ldp;
    b = t1 + static_cast<size_t>(Q) * ldt;
    if (!staged) {
      floats = b;
      c = dy = dyt = vt = bt = ct = sin = dso = dsot = b;
      return;
    }
    c = b + static_cast<size_t>(Q) * lds;
    dy = c + static_cast<size_t>(Q) * lds;
    dyt = dy + static_cast<size_t>(Q) * ldh;
    vt = dyt + static_cast<size_t>(H) * ldp;
    bt = vt + static_cast<size_t>(H) * ldp;
    ct = bt + static_cast<size_t>(S) * ldp;
    sin = ct + static_cast<size_t>(S) * ldp;
    dso = sin + static_cast<size_t>(H) * lds;
    dsot = dso + static_cast<size_t>(H) * lds;
    floats = dsot + static_cast<size_t>(S) * ldh2;
  }
};

size_t SweepBytes(int S, int Q) {
  return 4 * (static_cast<size_t>(kHGroup) * Round4(S) +
              static_cast<size_t>(Q) * (kHGroup + Round4(S)) + 2 * Round4(Q));
}

// Pass 2: one block per (row, chunk), every gradient of the chunk.
// kStaged: every tile in shared memory, the products fed by 16-byte loads
// (all but (G o L) b, whose A is read by rows); else only AL, GL and T1
// there and the tiles read from device memory with scalar loads.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) SsdScanBwdChunkKernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, j = blockIdx.y;
  const int bb = r / a.N, n = r % a.N;
  const int S = a.S, H = a.H, Q = a.Q, N = a.N;
  const int t0 = j * Q, qv = min(Q, a.T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t step0 = static_cast<size_t>(bb) * a.T + t0;
  const size_t states =
      (static_cast<size_t>(r) * a.NC + j) * static_cast<size_t>(H) * S;
  const ChunkLayout L(S, H, Q, kStaged);
  const int q4 = Round4(Q), ldp = L.ldp, ldt = L.ldt;
  float* dlv = sm;
  float* cum = dlv + q4;
  float* rowM = cum + q4;
  float* colM = rowM + q4;
  float* ci = colM + q4;
  float* vd = ci + q4;
  float* red = vd + q4;
  float* AL = sm + L.al;
  float* GL = sm + L.gl;
  float* T1 = sm + L.t1;
  // the device views: row t of the chunk at + t * N * (S or H)
  const float* b_g = a.b + (step0 * N + n) * S;
  const float* c_g = a.c + (step0 * N + n) * S;
  const float* v_g = a.v + (step0 * N + n) * H;
  const float* dy_g = a.dy + (step0 * N + n) * H;
  const float* sin_g = a.s_in + states;
  const float* dso_g = a.ds_out + states;
  const int NS = N * S, NH = N * H;
  float* b_s = sm + L.b;
  float* c_s = sm + L.c;
  float* dy_s = sm + L.dy;
  float* dyt = sm + L.dyt;
  float* vt = sm + L.vt;
  float* bt = sm + L.bt;
  float* ct = sm + L.ct;
  float* sin_s = sm + L.sin;
  float* dso_s = sm + L.dso;
  float* dsot = sm + L.dsot;
  if (kStaged) {
    const int lds = L.lds, ldh = L.ldh, ldh2 = L.ldh2;
    CopyIn(b_g, NS, qv, S, [&](int t, int k, float x) {
      b_s[t * lds + k] = x;
      bt[k * ldp + t] = x;
    });
    CopyIn(c_g, NS, qv, S, [&](int t, int k, float x) {
      c_s[t * lds + k] = x;
      ct[k * ldp + t] = x;
    });
    CopyIn(dy_g, NH, qv, H, [&](int t, int k, float x) {
      dy_s[t * ldh + k] = x;
      dyt[k * ldp + t] = x;
    });
    CopyIn(v_g, NH, qv, H,
           [&](int t, int k, float x) { vt[k * ldp + t] = x; });
    CopyIn(sin_g, S, H, S,
           [&](int h, int k, float x) { sin_s[h * lds + k] = x; });
    CopyIn(dso_g, S, H, S, [&](int h, int k, float x) {
      dso_s[h * lds + k] = x;
      dsot[k * ldh2 + h] = x;
    });
  }
  // the operands, as each product and dot reads them
  const Mat c_ts = kStaged ? Mat{c_s, L.lds, 1} : Mat{c_g, NS, 1};
  const Mat b_ps = kStaged ? Mat{b_s, L.lds, 1} : Mat{b_g, NS, 1};
  const Mat dy_th = kStaged ? Mat{dy_s, L.ldh, 1} : Mat{dy_g, NH, 1};
  const Mat v_ph = kStaged ? Mat{vt, 1, ldp} : Mat{v_g, NH, 1};
  const Mat sin_hs = kStaged ? Mat{sin_s, L.lds, 1} : Mat{sin_g, S, 1};
  const Mat dso_hs = kStaged ? Mat{dso_s, L.lds, 1} : Mat{dso_g, S, 1};
  const Mat cA = kStaged ? Mat{ct, 1, ldp} : c_ts;          // A(t, s)
  const Mat bB = kStaged ? Mat{bt, ldp, 1} : b_ps.T();      // B(s, p)
  const Mat dyA = kStaged ? Mat{dyt, 1, ldp} : dy_th;       // A(t, h)
  const Mat vB = kStaged ? Mat{vt, ldp, 1} : v_ph.T();      // B(h, p)
  const Mat bA = kStaged ? Mat{bt, 1, ldp} : b_ps;          // A(p, s)
  const Mat dsoB = kStaged ? Mat{dsot, L.ldh2, 1} : dso_hs.T();   // B(s, h)
  for (int t = threadIdx.x; t < qv; t += blockDim.x)
    dlv[t] = a.dl[(step0 + t) * N + n];
  __syncthreads();   // also the barrier after staging
  if (threadIdx.x == 0) SerialCumSum(dlv, cum, qv);
  __syncthreads();
  const float tot = cum[qv - 1];

  // AL = scores o L, GL = G: lower triangles, exact zeros above
  Product<kStaged, kStaged>(
      qv, qv, S, cA, bB, kLowerOut, [&](int t, int p, float acc) {
        AL[t * ldp + p] = p <= t ? acc * expf(cum[t] - cum[p]) : 0.f;
      });
  Product<kStaged, kStaged>(
      qv, qv, H, dyA, vB, kLowerOut, [&](int t, int p, float acc) {
        GL[t * ldp + p] = p <= t ? acc : 0.f;
      });
  // <dS_out, S_in>, per thread, then per warp
  float part = 0.f;
  for (int h = warp; h < H; h += nw)
    for (int s = lane; s < S; s += 32)
      part = fmaf(dso_hs.At(h, s), sin_hs.At(h, s), part);
  part = WarpSum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  // row and column sums of M = G o scores o L
  for (int t = warp; t < qv; t += nw) {
    float s = 0.f;
    for (int p = lane; p <= t; p += 32)
      s = fmaf(GL[t * ldp + p], AL[t * ldp + p], s);
    s = WarpSum(s);
    if (lane == 0) rowM[t] = s;
  }
  for (int p = threadIdx.x; p < qv; p += blockDim.x) {
    float s = 0.f;
    for (int t = p; t < qv; ++t)
      s = fmaf(GL[t * ldp + p], AL[t * ldp + p], s);
    colM[p] = s;
  }
  __syncthreads();
  for (int t = warp; t < qv; t += nw)   // GL = G o L
    for (int p = lane; p <= t; p += 32)
      GL[t * ldp + p] *= expf(cum[t] - cum[p]);
  __syncthreads();

  // dc = E o (dy S_in) + (G o L) b
  Product<kStaged, kStaged>(
      qv, S, H, dyA, sin_hs, kFull,
      [&](int t, int s, float acc) { T1[t * ldt + s] = acc; });
  __syncthreads();
  for (int t = warp; t < qv; t += nw) {
    float s = 0.f;
    for (int k = lane; k < S; k += 32)
      s = fmaf(T1[t * ldt + k], c_ts.At(t, k), s);
    s = WarpSum(s);
    if (lane == 0) ci[t] = s * expf(cum[t]);
  }
  Product<false, kStaged>(
      qv, S, qv, Mat{GL, ldp, 1}, b_ps, kKUpToM, [&](int t, int s, float acc) {
        a.dc[((step0 + t) * N + n) * S + s] =
            __fadd_rn(__fmul_rn(T1[t * ldt + s], expf(cum[t])), acc);
      });
  __syncthreads();

  // dv = (scores o L)^T dy + w o (b dS_out^T)
  Product<kStaged, kStaged>(
      qv, H, S, bA, dsoB, kFull,
      [&](int p, int h, float acc) { T1[p * ldt + h] = acc; });
  __syncthreads();
  for (int p = warp; p < qv; p += nw) {
    float s = 0.f;
    for (int k = lane; k < H; k += 32)
      s = fmaf(T1[p * ldt + k], v_ph.At(p, k), s);
    s = WarpSum(s);
    if (lane == 0) vd[p] = s * expf(tot - cum[p]);
  }
  Product<true, kStaged>(
      qv, H, qv, Mat{AL, 1, ldp}, dy_th, kKFromM,
      [&](int p, int h, float acc) {
        a.dv[((step0 + p) * N + n) * H + h] =
            __fadd_rn(__fmul_rn(T1[p * ldt + h], expf(tot - cum[p])), acc);
      });
  __syncthreads();

  // db = (G o L)^T c + w o (v dS_out)
  Product<kStaged, kStaged>(
      qv, S, H, v_ph, dso_hs, kFull,
      [&](int p, int s, float acc) { T1[p * ldt + s] = acc; });
  __syncthreads();
  Product<true, kStaged>(
      qv, S, qv, Mat{GL, 1, ldp}, c_ts, kKFromM,
      [&](int p, int s, float acc) {
        a.db[((step0 + p) * N + n) * S + s] =
            __fadd_rn(__fmul_rn(T1[p * ldt + s], expf(tot - cum[p])), acc);
      });

  // d dl: dcum in step order, then its reverse prefix sum
  if (threadIdx.x == 0) {
    float inner = 0.f;
    for (int w = 0; w < nw; ++w) inner += red[w];
    float dtot = 0.f;
    for (int p = 0; p < qv; ++p) dtot += vd[p];
    dtot += expf(tot) * inner;
    float acc = 0.f;
    for (int t = qv - 1; t >= 0; --t) {
      float d = rowM[t] - colM[t] + ci[t] - vd[t];
      if (t == qv - 1) d += dtot;
      acc += d;
      a.ddl[(step0 + t) * N + n] = acc;
    }
  }
}

template <class K>
cudaError_t AllowOne(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxSmem));
}

cudaError_t AllowSmem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = AllowOne(SsdScanBwdSweepKernel);
  if (err == cudaSuccess) err = AllowOne(SsdScanBwdChunkKernel<true>);
  if (err == cudaSuccess) err = AllowOne(SsdScanBwdChunkKernel<false>);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

bool BadDims(int T, int S, int H, int Q) {
  return S < 1 || S > kMaxDim || H < 1 || H > kMaxDim || Q < 1 ||
         Q > kMaxDim || T < 0;
}

// The chunk length actually used (the forward's: T itself when 0 < T < Q)
// and the chunk count.
void Chunks(int T, int Q, int* q, int* nc) {
  *q = (T > 0 && T < Q) ? T : Q;
  *nc = T > 0 ? (T + *q - 1) / *q : 0;
}

bool Staged(int S, int H, int q) {
  return 4 * ChunkLayout(S, H, q, true).floats <= kMaxSmem;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launches (0 = ok).
// Inputs as the forward's SsdScanF32 (s0 may be null for zeros); dy [B, T,
// N, H]; ds_fin [B, N, H, S] or null (zeros). Outputs ddl [B, T, N], db,
// dc [B, T, N, S], dv [B, T, N, H] and, unless null, ds0 [B, N, H, S].
// s_in and ds_out are scratch of [B N, NC, H, S] floats each, NC the chunk
// count of SsdScanBwdGeometry. All contiguous float32 on one device. Two
// kernels.
int SsdScanBwdF32(const float* dl, const float* b, const float* c,
                  const float* v, const float* s0, const float* dy,
                  const float* ds_fin, float* ddl, float* db, float* dc,
                  float* dv, float* ds0, float* s_in, float* ds_out,
                  int batch, int T, int N, int S, int H, int Q,
                  void* stream) {
  if (batch <= 0 || N <= 0) return 0;
  if (BadDims(T, S, H, Q)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = AllowSmem();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.dl = dl;
  a.b = b;
  a.c = c;
  a.v = v;
  a.s0 = s0;
  a.dy = dy;
  a.ds_fin = ds_fin;
  a.ddl = ddl;
  a.db = db;
  a.dc = dc;
  a.dv = dv;
  a.ds0 = ds0;
  a.s_in = s_in;
  a.ds_out = ds_out;
  a.T = T;
  a.N = N;
  a.S = S;
  a.H = H;
  Chunks(T, Q, &a.Q, &a.NC);
  const long long rows = static_cast<long long>(batch) * N;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 sweep_grid(static_cast<unsigned>(2 * rows),
                        static_cast<unsigned>((H + kHGroup - 1) / kHGroup));
  SsdScanBwdSweepKernel<<<sweep_grid, kSweepThreads, SweepBytes(S, a.Q),
                          st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.NC == 0) return static_cast<int>(err);
  const bool staged = Staged(S, H, a.Q);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(a.NC));
  const size_t bytes = 4 * ChunkLayout(S, H, a.Q, staged).floats;
  if (staged) {
    SsdScanBwdChunkKernel<true><<<grid, kThreads, bytes, st>>>(a);
  } else {
    SsdScanBwdChunkKernel<false><<<grid, kThreads, bytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at (T, S, H, Q), into geo[10]: chunk length, chunk
// count, the sweep's and the chunk kernel's dynamic shared bytes, whether
// the chunk kernel stages every tile (1) or reads them from device memory
// (0), the sweep's and that chunk kernel's registers and local (spill)
// bytes per thread, and the chunk kernel's resident blocks per SM.
int SsdScanBwdGeometry(int T, int S, int H, int Q, int* geo) {
  if (BadDims(T, S, H, Q)) return static_cast<int>(cudaErrorInvalidValue);
  int q = 0, nc = 0;
  Chunks(T, Q, &q, &nc);
  const bool staged = Staged(S, H, q);
  const size_t chunk_bytes = 4 * ChunkLayout(S, H, q, staged).floats;
  geo[0] = q;
  geo[1] = nc;
  geo[2] = static_cast<int>(SweepBytes(S, q));
  geo[3] = static_cast<int>(chunk_bytes);
  geo[4] = staged ? 1 : 0;
  cudaError_t err = AllowSmem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, SsdScanBwdSweepKernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  geo[5] = attr.numRegs;
  geo[6] = static_cast<int>(attr.localSizeBytes);
  err = staged ? cudaFuncGetAttributes(&attr, SsdScanBwdChunkKernel<true>)
               : cudaFuncGetAttributes(&attr, SsdScanBwdChunkKernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  geo[7] = attr.numRegs;
  geo[8] = static_cast<int>(attr.localSizeBytes);
  err = staged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &geo[9], SsdScanBwdChunkKernel<true>, kThreads,
                     chunk_bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &geo[9], SsdScanBwdChunkKernel<false>, kThreads,
                     chunk_bytes);
  return static_cast<int>(err);
}

const char* SsdScanBwdErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
