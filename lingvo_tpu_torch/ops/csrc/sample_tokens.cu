// Seeded temperature / top-k sampling on Hopper: one token per drawn row
// of logits, the argmax of the scaled, top-k-masked logits plus threefry
// Gumbel noise, with JAX's bits.
//
// Replaces no pallas_call. The reference draws its tokens with
// jax.random.categorical (lingvo_tpu/core/sampling.py:34 SampleFromLogits),
// which XLA lowers to a top-k threshold (lax.top_k of the scaled row),
// threefry2x32 bits, a uniform, -log(-log(u)), an add and an argmax. No
// PyTorch call draws JAX's threefry noise, so the port's streams can follow
// the reference's only through a kernel of its own.
//
// Drawn row i (row rows[i] of logits [R, V] float32, or row i without
// rows):
//   key   = the base key folded in order with fold[i, 0..F-1]
//           (fold_in(key, d) = threefry2x32(key, (0, d)); F = 1 or 2);
//   thr   = for 0 < top_k < V, kth * inv_t rounded, kth the top_k-th
//           largest raw logit of the row (duplicates counted): a product
//           by a positive float is monotone under rounding, so this is the
//           top_k-th largest scaled value bit for bit, the reference's
//           lax.top_k of the scaled row; -inf otherwise (no mask);
//   z     = x * inv_t rounded (the reciprocal product that XLA makes of
//           the reference's logits / temperature), -inf where z < thr (the
//           comparison is on the scaled value, as the reference's: a raw
//           comparison against kth differs where rounding makes two scaled
//           values equal; -0.0 and +0.0 compare equal);
//   bits  = b0 ^ b1 of threefry2x32(key, (0, c)) for column c;
//   u     = ((bits >> 9) | 0x3f800000 as float) - 1, + tiny, floored at
//           tiny;
//   g     = -logf(-logf(u)), the accurate libdevice logf (no fast math);
//   token = argmax over c of g + z, each operation rounded on its own
//           (__fmul_rn / __fadd_rn: no contraction), the lowest column on
//           ties.
//
// Design. A drawn row is split over a cluster of S blocks (ops/
// sample_tokens.py `Plan`: the largest S of one wave, else the smallest
// with 3 blocks resident on an SM; one block launches without the cluster
// attribute), each block owning a slice of `chunk` columns. Blocks of a
// cluster exchange data only by st.async into each other's shared memory,
// counted on the receiver's mbarrier: a cluster barrier costs more than
// the exchange itself. Two kernels, one launch a call:
//  - SampleTopKKernel (0 < top_k < V): the block copies its slice into
//    shared memory with cp.async (the row is read from device memory
//    once), then selects the threshold by radix select over the
//    order-preserving uint32 image of each value (every bit flipped when
//    the sign is set, only the sign bit otherwise), 8 bits a pass from the
//    top: a 256-bin histogram of the values that match the digits chosen
//    so far (per-warp shared atomics), sent to every block of the
//    cluster; each block sums the S histograms in rank order and picks the
//    same digit. Once the values of the chosen digits number at most 256 S
//    (after pass 0 on the serving shapes), each block sends those values'
//    keys to every block instead, and the remaining passes count them in
//    each block alone: two exchanges a select instead of four. Then each
//    block draws its live columns from its held slice.
//  - SampleAllKernel (top_k 0 or >= V, every column live): each thread
//    keeps kChains independent columns in flight, so that the 20 serial
//    rounds of one threefry chain hide the latency of the others.
// Each block reduces its best (z, c) and sends it to rank 0, which merges
// them (a total order on (z, -c), exact in any order) and writes the
// token.
//
// The skip (SampleTopKKernel): a column whose z is below thr is -inf
// whatever its noise, and g is finite (u lies in [tiny, 1 - 2^-23], so
// -log(u) lies in [1.19e-7, 87.34] and g in [-4.48, 15.95]), so g + z of
// a live column (z >= thr > -inf) is above -inf and beats every masked
// column. At least top_k columns are live (the top_k largest values are >=
// their own k-th value), so the winner is always a live column, and the
// masked ones need no bits, no uniform and no logarithm: they are skipped.
// thr = -inf only when the k-th value is -inf; then no column is below
// it, none is skipped, and the draw is the full row's.
//
// What bounds it. Masked (top_k 40 of 32000): the bytes of the drawn rows'
// logits; the select's passes over shared memory and its two exchanges
// are on-chip work and latency beside them, and the integer work of the
// ~k live columns is nothing. Full vocabulary: the integer work, about 75
// int32 operations of threefry per element (the rotates and xors only on
// the ALU pipe) and every instruction, the two logf's included, at the
// issue rate.
//
// Plain C interface, loaded with ctypes by ops/sample_tokens.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;          // one radix digit of 8 bits
constexpr int kChains = 4;          // columns in flight a thread (full row)
constexpr int kMaxCluster = 16;     // the non-portable cluster size
constexpr int kHoldBytes = 176 * 1024;   // the largest slice held
constexpr int kMaxDevices = 64;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;   // float32's smallest normal

static_assert(kThreads == kBins, "one thread a histogram bin");

struct Args {
  const float* logits;   // [r, v]
  const int* rows;       // [n] rows of logits to draw, or null (row i)
  const int* fold;       // [n, f]
  int* tokens;           // [n]
  float* zmax;           // [n]
  uint32_t key0, key1;
  float inv_t;
  int r, v, f, top_k;
  int cluster;           // S blocks a drawn row
  int chunk;             // columns a block (a multiple of 4)
  int vec16;             // the slices are 16-byte aligned (cp.async 16)
};

__device__ __forceinline__ void Round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32 with 20 rounds: five groups of four, the key words
// injected after each group.
__device__ __forceinline__ uint2 Threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  Round(x0, x1, 17); Round(x0, x1, 29); Round(x0, x1, 16); Round(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  Round(x0, x1, 17); Round(x0, x1, 29); Round(x0, x1, 16); Round(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  Round(x0, x1, 13); Round(x0, x1, 15); Round(x0, x1, 26); Round(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// The Gumbel noise of threefry's output y: the uniform in [tiny, 1), then
// -log(-log(u)).
__device__ __forceinline__ float Gumbel(uint2 y) {
  const uint32_t bits = y.x ^ y.y;
  const float m = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  const float u = fmaxf(__fadd_rn(m, kTiny), kTiny);
  return -logf(-logf(u));
}

// (z, c) beats (best, arg): a larger z, or an equal z at a lower column.
__device__ __forceinline__ void Better(float z, int c, float& best,
                                       int& arg) {
  if (z > best || (z == best && c < arg)) {
    best = z;
    arg = c;
  }
}

__device__ __forceinline__ void WarpArgmax(float& best, int& arg) {
  for (int o = 16; o > 0; o >>= 1) {
    const float z = __shfl_xor_sync(~0u, best, o);
    const int c = __shfl_xor_sync(~0u, arg, o);
    Better(z, c, best, arg);
  }
}

// The order-preserving uint32 image of a float, and back.
__device__ __forceinline__ uint32_t OrderKey(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) |
              0x80000000u);
}

__device__ __forceinline__ float FromOrderKey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k ^ 0x80000000u : ~k);
}

__device__ __forceinline__ uint32_t ClusterRank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// Row i's key: the base key folded with fold[i, 0..f-1].
__device__ __forceinline__ uint2 RowKey(const Args& a, int i) {
  uint32_t k0 = a.key0, k1 = a.key1;
  for (int j = 0; j < a.f; ++j) {
    const uint2 y = Threefry(k0, k1, 0u, static_cast<uint32_t>(
        __ldg(a.fold + static_cast<long long>(i) * a.f + j)));
    k0 = y.x;
    k1 = y.y;
  }
  return make_uint2(k0, k1);
}

struct Merge {
  float best[kWarps];
  int arg[kWarps];
  float4 slot[kMaxCluster];   // rank 0: each block's (best, arg bits)
  uint64_t bar;               // rank 0: counts the slots' bytes
};

// Sets the merge's barrier (rank 0 expects every block's slot) before the
// cluster's first barrier, which makes it visible to the other blocks.
__device__ __forceinline__ void MergeInit(Merge& s, int cluster, int rank) {
  if (cluster > 1 && threadIdx.x == 0) {
    MbarInit(&s.bar, 1);
    if (rank == 0) MbarArriveExpectTx(&s.bar, 16 * cluster);
  }
}

// The block's best (best, arg) over its threads, then the cluster's over
// its blocks: each block sends its best into rank 0's slot (st.async,
// counted on rank 0's barrier), rank 0 merges them and writes the token.
// A cluster's blocks must have passed a cluster barrier after MergeInit.
// Ends with a cluster barrier that rank 0 reaches after its slots have
// landed, so no block leaves while its best is in flight.
__device__ void ClusterArgmax(const Args& a, Merge& s, float best, int arg,
                              int i, int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpArgmax(best, arg);
  if (lane == 0) {
    s.best[warp] = best;
    s.arg[warp] = arg;
  }
  __syncthreads();
  if (warp != 0) {
    if (a.cluster > 1) {
      ClusterArrive();
      ClusterWait();
    }
    return;
  }
  best = lane < kWarps ? s.best[lane] : -INFINITY;
  arg = lane < kWarps ? s.arg[lane] : a.v;
  WarpArgmax(best, arg);
  if (a.cluster > 1) {
    if (lane == 0)
      StAsync(MapShared(&s.slot[rank], 0),
              make_float4(best, __int_as_float(arg), 0.f, 0.f),
              MapShared(&s.bar, 0));
    if (rank == 0) {
      MbarWaitCluster(&s.bar, 0);
      best = -INFINITY;
      arg = a.v;   // no column yet: any column beats it, even at -inf
      if (lane < a.cluster) {
        best = s.slot[lane].x;
        arg = __float_as_int(s.slot[lane].y);
      }
      WarpArgmax(best, arg);
    }
    ClusterArrive();
  }
  if (rank == 0 && lane == 0) {
    a.tokens[i] = arg < a.v ? arg : 0;
    a.zmax[i] = best;
  }
  if (a.cluster > 1) ClusterWait();
}

// The drawn row i's (row, rank, slice [c0, c1)), or false for a row index
// out of [0, r): then rank 0 writes token -1 and no block reads logits.
__device__ __forceinline__ bool Slice(const Args& a, int& i, int& rank,
                                      const float*& x, int& c0, int& c1) {
  rank = a.cluster > 1 ? static_cast<int>(ClusterRank()) : 0;
  i = blockIdx.x / a.cluster;
  const int row = a.rows != nullptr ? __ldg(a.rows + i) : i;
  if (row < 0 || row >= a.r) {
    if (rank == 0 && threadIdx.x == 0) {
      a.tokens[i] = -1;
      a.zmax[i] = NAN;
    }
    return false;
  }
  x = a.logits + static_cast<long long>(row) * a.v;
  c0 = rank * a.chunk;
  c1 = min(a.v, c0 + a.chunk);
  return true;
}

__global__ void __launch_bounds__(kThreads) SampleAllKernel(const Args a) {
  __shared__ Merge s_merge;
  int i, rank, c0, c1;
  const float* x;
  if (!Slice(a, i, rank, x, c0, c1)) return;   // uniform over the cluster
  MergeInit(s_merge, a.cluster, rank);
  if (a.cluster > 1) {
    MbarInitFence();
    ClusterArriveRelaxed();   // this block's barrier is set
  }
  const uint2 key = RowKey(a, i);
  float best = -INFINITY;
  int arg = a.v;
  // every column is live: kChains independent chains a thread at a time
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads * kChains) {
    float xs[kChains];
    uint2 y[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int cj = c + j * kThreads;
      xs[j] = cj < c1 ? __ldg(x + cj) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      y[j] = Threefry(key.x, key.y, 0u,
                      static_cast<uint32_t>(c + j * kThreads));
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int cj = c + j * kThreads;
      if (cj < c1)
        Better(__fadd_rn(Gumbel(y[j]), __fmul_rn(xs[j], a.inv_t)), cj, best,
               arg);
    }
  }
  if (a.cluster > 1) ClusterWait();   // every block's barrier is set
  ClusterArgmax(a, s_merge, best, arg, i, rank);
}

// Thread t holds `count`, the number of values whose digit is d = 255 - t
// among those that match the digits chosen so far. Returns the digit of
// the kr-th largest of them in s_sel[0], its rank among the values of that
// digit in s_sel[1] and their number in s_sel[2], read by every thread
// after the barrier that ends it.
__device__ __forceinline__ void SelectDigit(uint32_t count, uint32_t kr,
                                            uint32_t* s_scan,
                                            uint32_t* s_sel) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t incl = count;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) incl += w < warp ? s_scan[w] : 0u;
  const uint32_t above = incl - count;   // values above digit d
  if (above < kr && kr <= incl) {        // exactly one d: the k-th's
    s_sel[0] = static_cast<uint32_t>(kBins - 1 - tid);
    s_sel[1] = kr - above;
    s_sel[2] = count;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) SampleTopKKernel(const Args a) {
  // the block's slice, two receive buffers of S histograms, the candidates
  extern __shared__ __align__(16) float s_held[];
  __shared__ __align__(16) uint32_t s_sub[kWarps][kBins];   // each warp's
  __shared__ uint32_t s_scan[kWarps];
  __shared__ uint32_t s_sel[3];
  __shared__ uint32_t s_found;      // candidates this block has found
  __shared__ uint64_t s_bar[3];     // the receive buffers', the candidates'
  __shared__ Merge s_merge;
  int i, rank, c0, c1;
  const float* x;
  if (!Slice(a, i, rank, x, c0, c1)) return;   // uniform over the cluster
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = max(0, c1 - c0);
  const int n4 = (n + 3) / 4;   // the slice as float4 (chunk % 4 == 0)
  uint32_t* recv = reinterpret_cast<uint32_t*>(s_held + a.chunk);
  MergeInit(s_merge, a.cluster, rank);
  if (a.cluster > 1) {
    if (tid == 0)
      for (int b = 0; b < 3; ++b) MbarInit(&s_bar[b], 1);
    MbarInitFence();
    ClusterArriveRelaxed();   // this block's barriers are set
  }
  // the slice, read from device memory once
  if (a.vec16) {
    for (int q = tid; q < n4; q += kThreads)
      CpAsync16(s_held + 4 * q, x + c0 + 4 * q, true);
  } else {
    for (int e = tid; e < n; e += kThreads)
      CpAsync4(s_held + e, x + c0 + e, true);
  }
  CpAsyncCommit();
  const uint2 key = RowKey(a, i);   // beside the copy
  CpAsyncWait<0>();
  __syncthreads();
  if (a.cluster > 1) ClusterWait();   // every block's barriers are set
  const float4* held4 = reinterpret_cast<const float4*>(s_held);

  // the top_k-th largest raw value: radix select, 8 bits a pass, from the
  // top. prefix holds the digits chosen so far; kr is the rank of the k-th
  // value among the values that match them. Each pass's histogram is
  // summed over the cluster, until the values of the digits chosen so far
  // number at most 256 S: then every block gathers them all (`cand`) and
  // the remaining passes count those alone, in each block, with no more
  // exchanges.
  uint32_t prefix = 0;
  uint32_t kr = static_cast<uint32_t>(a.top_k);
  int pass = 0;
  for (; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    // a value matches the digits chosen so far when its key lies in
    // [base, base + span]
    const uint32_t base = pass == 0 ? 0u : prefix << (shift + 8);
    const uint32_t span = pass == 0 ? ~0u : (1u << (shift + 8)) - 1u;
    uint32_t* sub = s_sub[warp];
    for (int b = lane; b < kBins; b += 32) sub[b] = 0;
    __syncwarp();
    // four values a thread at a time, each one's test free of branches, and
    // one branch for the four (in passes 1-3 few values match)
#pragma unroll 2
    for (int q = tid; q < n4; q += kThreads) {
      const float4 v4 = held4[q];
      const uint32_t k[4] = {OrderKey(v4.x), OrderKey(v4.y), OrderKey(v4.z),
                             OrderKey(v4.w)};
      bool match[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        match[j] = 4 * q + j < n && k[j] - base <= span;
      if (match[0] | match[1] | match[2] | match[3]) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (match[j]) atomicAdd(sub + ((k[j] >> shift) & 0xFFu), 1u);
      }
    }
    __syncthreads();
    // the block's histogram into slot `rank` of every block's buffer
    // pass & 1. The others wrote this buffer two passes ago, and sent
    // this pass's counts only after they had this block's last ones, which
    // it sent after it had read this buffer.
    uint32_t* slots = recv + (pass & 1) * a.cluster * kBins;
    const int q = tid & 63;   // bins 4q..4q+3
    uint4 sum = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint4 v = reinterpret_cast<const uint4*>(s_sub[w])[q];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (a.cluster > 1) {
      uint64_t* bar = &s_bar[pass & 1];
      if (tid == 0) MbarArriveExpectTx(bar, a.cluster * kBins * 4);
      const float4 v = make_float4(__uint_as_float(sum.x),
                                   __uint_as_float(sum.y),
                                   __uint_as_float(sum.z),
                                   __uint_as_float(sum.w));
      for (int b = tid >> 6; b < a.cluster; b += kThreads / 64)
        StAsync(MapShared(slots + rank * kBins + 4 * q, b), v,
                MapShared(bar, b));
      MbarWaitCluster(bar, (pass >> 1) & 1);
    } else {
      if (tid < 64) reinterpret_cast<uint4*>(slots)[q] = sum;
      __syncthreads();
    }
    // thread t sums bin 255 - t over the blocks in rank order
    uint32_t count = 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b)
      if (b < a.cluster) count += slots[b * kBins + kBins - 1 - tid];
    SelectDigit(count, kr, s_scan, s_sel);
    const uint32_t digit = s_sel[0];
    prefix = (prefix << 8) | digit;
    kr = s_sel[1];
    const uint32_t total = s_sel[2];
    // the candidates go into the other receive buffer, which every block
    // read in the last pass, before it sent this pass's counts
    uint32_t* cand = recv + ((pass + 1) & 1) * a.cluster * kBins;
    if (pass == 3 || total > static_cast<uint32_t>(a.cluster * kBins))
      continue;
    // the values of the chosen digits are few: every block sends its own
    // into places off.. of every block's `cand` (off: the values the
    // blocks before it have), each place counted on the candidates'
    // barrier, whose one phase the blocks complete here
    uint32_t off = 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b)
      if (b < rank) off += slots[b * kBins + digit];
    if (tid == 0) {
      s_found = 0;
      if (a.cluster > 1) MbarArriveExpectTx(&s_bar[2], total * 4);
    }
    __syncthreads();
    // every lane of a warp runs the same trips (n4 is uniform), so that a
    // warp takes its places with one atomic
    for (int q0 = 0; q0 < n4; q0 += kThreads) {
      const int q4 = q0 + tid;
      const float4 v4 =
          q4 < n4 ? held4[q4] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t k[4] = {OrderKey(v4.x), OrderKey(v4.y), OrderKey(v4.z),
                             OrderKey(v4.w)};
      bool match[4];
      uint32_t mine = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        match[j] = 4 * q4 + j < n && (k[j] >> shift) == prefix;
        mine += match[j];
      }
      if (!__any_sync(~0u, mine != 0)) continue;
      uint32_t incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += y;
      }
      uint32_t first = 0;
      if (lane == 31) first = atomicAdd(&s_found, incl);
      uint32_t at = off + __shfl_sync(~0u, first, 31) + incl - mine;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!match[j]) continue;
        if (a.cluster > 1) {
          for (int b = 0; b < a.cluster; ++b)
            StAsyncF(MapShared(cand + at, b), __uint_as_float(k[j]),
                     MapShared(&s_bar[2], b));
        } else {
          cand[at] = k[j];
        }
        ++at;
      }
    }
    if (a.cluster > 1)
      MbarWaitCluster(&s_bar[2], 0);
    else
      __syncthreads();
    // the remaining passes over the candidates, in this block alone
    for (++pass; pass < 4; ++pass) {
      const int sh = 24 - 8 * pass;
      s_sub[0][tid] = 0;
      __syncthreads();
      for (uint32_t e = tid; e < total; e += kThreads) {
        const uint32_t k = cand[e];
        if ((k >> (sh + 8)) == prefix) atomicAdd(&s_sub[0][(k >> sh) & 0xFFu], 1u);
      }
      __syncthreads();
      SelectDigit(s_sub[0][kBins - 1 - tid], kr, s_scan, s_sel);
      prefix = (prefix << 8) | s_sel[0];
      kr = s_sel[1];
    }
  }
  const float thr = __fmul_rn(FromOrderKey(prefix), a.inv_t);

  // the draw: live columns only (the skip is exact, see the header)
  float best = -INFINITY;
  int arg = a.v;
  // four values a thread at a time, one branch for the four
  for (int q = tid; q < n4; q += kThreads) {
    const float4 v4 = held4[q];
    const float z[4] = {__fmul_rn(v4.x, a.inv_t), __fmul_rn(v4.y, a.inv_t),
                        __fmul_rn(v4.z, a.inv_t), __fmul_rn(v4.w, a.inv_t)};
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = 4 * q + j < n && !(z[j] < thr);
    if (live[0] | live[1] | live[2] | live[3]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
        const int c = c0 + 4 * q + j;
        const uint2 y = Threefry(key.x, key.y, 0u, static_cast<uint32_t>(c));
        Better(__fadd_rn(Gumbel(y), z[j]), c, best, arg);
      }
    }
  }
  ClusterArgmax(a, s_merge, best, arg, i, rank);
}

// The masked kernel's dynamic shared memory: the slice and two receive
// buffers of `cluster` histograms (one of them, once the values of the
// chosen digits are few, their gathered keys).
size_t TopKSmem(int chunk, int cluster) {
  return static_cast<size_t>(chunk) * 4 +
         static_cast<size_t>(2 * cluster * kBins) * 4;
}

// Once per device: the held slice's shared memory limit and the
// non-portable cluster size.
cudaError_t Setup() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(SampleTopKKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(TopKSmem(kHoldBytes / 4,
                                                       kMaxCluster)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        SampleTopKKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        SampleAllKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// The launch of `blocks` blocks in clusters of `cluster` (no cluster
// attribute for one: the kernels then take __syncthreads for the cluster
// barrier).
void Config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
            int cluster, size_t smem, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(blocks));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 0;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->numAttrs = 1;
  }
}

const void* Kernel(int masked) {
  return masked ? reinterpret_cast<const void*>(SampleTopKKernel)
                : reinterpret_cast<const void*>(SampleAllKernel);
}

}  // namespace

extern "C" {

// On `stream`: draws n rows of logits [r, v] float32 (rows contiguous):
// row rows[i] ([n] int32, or null: row i) with fold [n, f] int32 (f = 1
// or 2), the base key (key0, key1), inv_t the float32 reciprocal of the
// temperature and top_k (masked when 0 < top_k < v) -> tokens [n] int32
// and zmax [n] float32 (the winning perturbed value). A row index out of
// [0, r) gives token -1 and zmax NaN, the card's only signal of it (the
// wrapper does not read rows back). Each row is split over a cluster of `cluster`
// blocks of `chunk` columns (a multiple of 4; cluster * chunk >= v; the
// masked kernel holds a slice of 4 chunk bytes, at most kHoldBytes, and
// two receive buffers of `cluster` histograms), from
// ops/sample_tokens.py `Plan`. One launch. Returns the cudaError_t of the
// launch (0 = ok).
int SampleTokens(const float* logits, const int* rows, const int* fold,
                 int f, unsigned key0, unsigned key1, float inv_t, int top_k,
                 int r, int v, int n, int cluster, int chunk, int* tokens,
                 float* zmax, void* stream) {
  const int masked = top_k > 0 && top_k < v;
  if (r <= 0 || v <= 0 || n <= 0 || f < 1 || f > 2 || fold == nullptr ||
      top_k < 0 || cluster < 1 || cluster > kMaxCluster || chunk < 4 ||
      chunk % 4 != 0 || static_cast<long long>(cluster) * chunk < v ||
      static_cast<long long>(n) * cluster > 2147483647LL ||
      (masked && static_cast<long long>(chunk) * 4 > kHoldBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.logits = logits;
  a.rows = rows;
  a.fold = fold;
  a.tokens = tokens;
  a.zmax = zmax;
  a.key0 = key0;
  a.key1 = key1;
  a.inv_t = inv_t;
  a.r = r;
  a.v = v;
  a.f = f;
  a.top_k = top_k;
  a.cluster = cluster;
  a.chunk = chunk;
  a.vec16 = v % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Config(&cfg, attr, n * cluster, cluster,
         masked ? TopKSmem(chunk, cluster) : 0,
         static_cast<cudaStream_t>(stream));
  err = masked ? cudaLaunchKernelEx(&cfg, SampleTopKKernel, a)
               : cudaLaunchKernelEx(&cfg, SampleAllKernel, a);
  return static_cast<int>(err);
}

// What the card can hold of the kernel (masked: SampleTopKKernel with a
// slice of `chunk` columns; else SampleAllKernel): resident blocks an SM
// into blocks_per_sm, and whether a cluster of `cluster` blocks can be
// placed into fits (cudaOccupancyMaxActiveClusters > 0; 1 always fits).
// Returns the cudaError_t (0 = ok).
int SampleTokensFit(int masked, int chunk, int cluster, int* blocks_per_sm,
                    int* fits) {
  if (cluster < 1 || cluster > kMaxCluster || chunk < 4 ||
      (masked && static_cast<long long>(chunk) * 4 > kHoldBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = Setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = masked ? TopKSmem(chunk, cluster) : 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, Kernel(masked), kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *fits = 1;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    Config(&cfg, attr, cluster, cluster, smem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, Kernel(masked), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    *fits = clusters > 0;
  }
  return 0;
}

// The kernel's geometry, which ops/sample_tokens.py plans with and checks
// at load: threads a block, the largest cluster, the largest held slice.
void SampleTokensLimits(int* threads, int* max_cluster, int* hold_bytes) {
  *threads = kThreads;
  *max_cluster = kMaxCluster;
  *hold_bytes = kHoldBytes;
}

const char* SampleTokensErrorString(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
