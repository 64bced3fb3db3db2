// Length-aware paged flash decode over a dense KV cache, Hopper (sm_90a),
// float32 or bfloat16 cache, float32 arithmetic: split-K over each row's
// live slots with asynchronous copies.
//
// Replaces the Pallas TPU kernel `_DecodeKernel` of
// lingvo_tpu/ops/flash_decode.py (pallas_call in `_PallasDecode`; public
// entry `FlashDecode`). It computes the same function, not the same
// blocks: row b's one pre-scaled query attends its cache slots
// [0, time_step] that are not padded (cache_paddings < 0.5) with a float32
// online softmax (the reference `_PageAttend`: running m / l / acc, the
// m_safe guard, acc / max(l, 1e-20)). A row with nothing live writes exact
// zeros. Pages only bound the read: slots past time_step (and so every
// page past time_step // P) are never read, as in the reference.
//
// Bound: a gather far below the card's ridge point (4 flops per K/V
// element read), so bytes bound it: the live K/V slots of every row, the
// paddings up to time_step, q and out, over 3.35 TB/s on an H100 SXM. A
// row's slots for one head are 512-byte rows strided by N * H, and one
// block per (row, head) cannot keep enough of them in flight.
//
// Design (flash-decoding). Grid (B * N, splits); `splits` comes from the
// host (ops/flash_decode.py `NumSplits`: enough blocks for two waves of
// the resident blocks, never more than the tiles up to time_step).
//  1. Every block of a row scans the row's paddings up to time_step once
//     (L2-resident, all loads in flight) for the first live slot `lo`, so
//     wholly padded leading pages cost nothing and no host sync is needed.
//  2. The tiles of kTs = min(128, 2048 / H) slots from lo's tile to
//     time_step's are cut into `splits` equal shares in tile order; a
//     share may be empty when the live range is shorter than `splits`.
//  3. The block streams its tiles through a 3-stage ring of K and V tiles
//     in shared memory with cp.async (16-byte copies, 16 KB per stage,
//     two stages in flight while the third is consumed; 4 blocks of 128
//     threads fit on an SM, 128 KB in flight per SM). A masked slot's copy
//     has source size 0: the hardware writes zeros and its K/V bytes are
//     never read, so NaN in pads or past time_step cannot reach the
//     output.
//  4. Scores: groups of H / 4 lanes take a slot each, one float4 of K from
//     shared memory per lane and shuffles inside the group. Each warp
//     reduces the tile's max and probability sum by shuffles (every warp
//     the same bits); P . V: thread (part, d) owns acc[d] over the slots
//     part, part + 128 / H, ...
//  5. Each split writes its (acc[H], m, l) to a scratch tensor the wrapper
//     allocates; `FlashDecodeCombineKernel` merges a row's splits in split
//     order. No atomics: the output is bitwise the same from call to call.
// What it still leaves: two launches per call (the combine is ~1 us), and
// the scan of a row's paddings is repeated by each of its N * splits
// blocks (a few KB each, from L2).
//
// A bfloat16 cache (`kv_cache_dtype='bfloat16'`): FlashDecodeBf16Kernel,
// one launch, replacing the same `_DecodeKernel`. The reference rounds
// each probability to bfloat16 before P.V (`p.astype(v_page.dtype)`), and
// it rounds p = exp(s - M_j), where M_j is the running max of the scores
// through the end of the slot's page j (lingvo_tpu/ops/flash_decode.py
// `_DecodeKernel`, pages in order). bfloat16 rounding is relative and
// exp(M_j - m) is not a power of two, so p taken against any other max (a
// tile's, a split's) rounds to other values: a slot needs M_j, the max of
// every live score before it in the row and of the rest of its page.
// The first bf16 design paid for that with three launches per call (a
// scores pass that wrote float32 scores to a [B * N, S] scratch, a values
// pass that re-read them from L2 for the prefix maxima and streamed V,
// and the combine): K, V and the scores crossed the memory system
// separately, and it lost to SDPA on the same cache.
// Design: the splits of one (row, head) form one thread-block cluster
// (grid (splits, B * N), cluster (splits, 1, 1), splits <= 8, the portable
// cluster size), so they are co-resident and read each other's shared
// memory (distributed shared memory, cooperative_groups' map_shared_rank).
// Tiles of kTs = min(128, 4096 / H) slots (8 KB of K or of V), cut into
// `splits` equal shares in tile order, as the float32 split kernel does.
//  1. Scores. Each block streams its K tiles, then its V tiles, through
//     one 3-stage cp.async ring (a masked slot's copy has source size 0:
//     zeros are written and its K/V bytes are never read), so the first V
//     tiles load while the last scores are computed and across the
//     exchange below. A slot's row is stored with its 16-byte chunks
//     XOR-swizzled by the slot, so 4 lanes per slot (H = 128) read K with
//     16-byte loads free of bank conflicts. Its slots' float32 scores stay
//     in shared memory (NEG_INF where masked), with their running max (a
//     block scan).
//  2. Exchange. Each block publishes three numbers: the max of its scores,
//     the max of its scores in the page of its first slot, and that page
//     (-1 for an empty block). After one cluster barrier every block reads
//     its neighbours'. Slot i of page j then rounds against
//     M_j = max(the totals of every earlier block, its own running max
//     through the end of page j, and, for its last page only, the
//     first-page maxima of the later blocks that start inside that page):
//     a page may span several blocks (at page 128 a split holds about 144
//     slots). That is exactly the reference's running max.
//  3. P.V. p_i = exp(s_i - M_j) (the m_safe guard as the reference's) goes
//     into acc as bf16(p_i) * exp(M_j - m), against the row's final max m,
//     which every block now knows; l sums the unrounded p_i * exp(M_j - m).
//  4. Merge in the same launch. Each block leaves (acc[H], l) in its
//     shared memory; after a second cluster barrier block 0 sums them in
//     split order and writes out = acc / max(l, 1e-20); a third barrier
//     keeps every block's shared memory alive until block 0 has read it.
//     No scratch, no combine kernel, no atomics: the bits repeat.
// Kernel and reference round the same p whenever they compute the same
// score; they differ in the float32 sums only. Bound: bytes, 2 per K/V
// element of the live slots, plus the paddings, q and out. 27 KB of
// shared memory a block at GShardDecode's shapes, q in registers (80 a
// thread: 6 blocks an SM). What it still leaves: each block's pad scan
// (as the float32 kernel's), three cluster barriers and a chain of a few
// tiles per block (latency, not bandwidth, at the main shape: 4 to 8
// splits take about as long), and 16-byte copies (one bulk copy per slot
// row with an mbarrier per stage was slower, as were bulk L2 prefetches
// of the block's rows at its start). The scores need
// ceil(tiles / splits) x kTs x 8 bytes of shared memory, at most
// kMaxCtaSlots slots per block (the wrapper raises above it).
//
// q and out: float32, or bfloat16 under fprop_dtype=bfloat16 (`Act`,
// kv_storage.cuh: q widened on load, out rounded once at the division),
// a template parameter of the three kernels; nothing else changes with it.
//
// Limits (the Python wrapper raises outside them): head dim 4..128 with
// H / 4 a power of two (8..128 for bfloat16, so that a 16-byte copy never
// spans two slots), all tensors contiguous, float32 or bfloat16 q,
// float32 paddings.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kTileFloats = 2048;  // K (and V) floats of one tile (8 KB)
constexpr int kMaxTs = 128;        // slots of one tile, at most
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxCtaSlots = 8192; // bf16: slots whose scores a block holds
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

typedef __nv_bfloat16 bf16;

template <typename T>
__device__ __forceinline__ int TileSlots(int head_dim) {
  return min(kMaxTs, kTileFloats * static_cast<int>(sizeof(float) /
                                                    sizeof(T)) / head_dim);
}

int HostTileSlots(int head_dim, int itemsize) {
  return std::min(kMaxTs, kTileFloats * 4 / itemsize / head_dim);
}

__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float WarpMax(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float WarpSum(float x) {
  // butterfly: every lane adds the same pairs, so all get the same bits
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keep = (slot <= t) * (1 - pad) > 0.5, as the reference computes it
__device__ __forceinline__ bool Keep(const float* pad_row, int slot,
                                     int t_eff) {
  return slot <= t_eff && (pad_row == nullptr || 1.f - pad_row[slot] > 0.5f);
}

// The first live slot of a row in [0, t_eff], or t_eff + 1 if none;
// kUnroll independent loads in flight per thread.
template <int kUnroll>
__device__ int FirstLiveSlot(const float* pad_row, int t_eff, int* red) {
  if (pad_row == nullptr) return 0;
  int lo = t_eff + 1;
  for (int base = 0; base <= t_eff; base += kUnroll * kThreads) {
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      live[u] = Keep(pad_row, base + u * kThreads + threadIdx.x, t_eff);
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u)
      if (live[u]) lo = min(lo, base + u * kThreads + threadIdx.x);
  }
  for (int o = 16; o > 0; o >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = lo;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) lo = min(lo, red[w]);
  __syncthreads();  // red is free again
  return lo;
}

// [tile_begin, tile_end): split `split` of `splits`' equal share, in tile
// order, of the tiles of ts slots from the first live slot's tile to
// t_eff's (empty when nothing is live or the share is).
template <int kUnroll>
__device__ void SplitTiles(const float* pad_row, int t_eff, int ts,
                           int split, int splits, int* red, int* tile_begin,
                           int* tile_end) {
  *tile_begin = *tile_end = 0;
  if (t_eff < 0) return;
  const int lo = FirstLiveSlot<kUnroll>(pad_row, t_eff, red);
  if (lo > t_eff) return;
  const int first = lo / ts;
  const int nt = t_eff / ts - first + 1;
  *tile_begin = first + static_cast<int>(
      static_cast<long long>(split) * nt / splits);
  *tile_end = first + static_cast<int>(
      static_cast<long long>(split + 1) * nt / splits);
}

// One (row x head, split) block of the float32 cache: scores, tile
// softmax and P.V in one pass; writes its (acc[H], m, l) to `partial`.
// Q: the type of q (`Act`, kv_storage.cuh).
template <typename Q>
__global__ void __launch_bounds__(kThreads) FlashDecodeSplitKernel(
    const Q* __restrict__ q, const float* __restrict__ k_cache,
    const float* __restrict__ v_cache, const float* __restrict__ pad,
    float* __restrict__ partial, int seq_len, int num_heads, int head_dim,
    int time_step) {
  extern __shared__ __align__(16) float smem[];
  typedef float T;
  constexpr int kVec = 16 / sizeof(T);  // values of one 16-byte copy
  const int h = head_dim;
  const int ts = TileSlots<T>(h);
  float* kv = smem;                             // [kStages][2][kTileFloats]
  float* s_sh = kv + kStages * 2 * kTileFloats;  // [kMaxTs] scores
  float* p_sh = s_sh + kMaxTs;                  // [kMaxTs] probabilities
  float* keep_sh = p_sh + kMaxTs;               // [kStages][kMaxTs]
  float* red = keep_sh + kStages * kMaxTs;      // [kThreads]

  const int bn = blockIdx.x;
  const int row = bn / num_heads;
  const int head = bn % num_heads;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t slot_stride = static_cast<size_t>(num_heads) * h;
  // cache offset of (row, slot 0, head)
  const size_t row_off = static_cast<size_t>(row) * seq_len * slot_stride +
                         static_cast<size_t>(head) * h;
  const float* pad_row = pad ? pad + static_cast<size_t>(row) * seq_len
                             : nullptr;
  const int t_eff = min(time_step, seq_len - 1);

  // this split's tiles of the live range [lo, t_eff]
  int tile_begin, tile_end;
  SplitTiles<4>(pad_row, t_eff, ts, split, splits,
                reinterpret_cast<int*>(red), &tile_begin, &tile_end);

  const int g = h / 4;              // lanes of one slot's dot product
  const int glane = tid % g;
  const float4 qv = Act<Q>::Load4(q + static_cast<size_t>(bn) * h, glane);
  const int quads = ts * g;         // 4-value groups of a K (or V) tile
  const int gc = h / kVec;          // 16-byte copies of one slot's row
  const int copies = ts * gc;       // 16-byte copies of a K (or V) tile
  const int parts = kThreads / h;   // P . V: thread (part, d)
  const int d = tid % h, part = tid / h;

  // Starts the copies of tile `tile` into ring stage `stage` (if the
  // tile is this split's) and always commits a group.
  auto prefetch = [&](int tile, int stage) {
    if (tile < tile_end) {
      T* ks = reinterpret_cast<T*>(kv + stage * 2 * kTileFloats);
      T* vs = reinterpret_cast<T*>(kv + (stage * 2 + 1) * kTileFloats);
      const int slot0 = tile * ts;
      for (int c = tid; c < copies; c += kThreads) {
        const int p = c / gc;
        const int slot = slot0 + p;
        const bool keep = Keep(pad_row, slot, t_eff);
        const size_t off = row_off + static_cast<size_t>(keep ? slot : 0) *
                                         slot_stride + kVec * (c % gc);
        CpAsync16(ks + kVec * c, k_cache + off, keep);
        CpAsync16(vs + kVec * c, v_cache + off, keep);
        if (c % gc == 0) keep_sh[stage * kMaxTs + p] = keep ? 1.f : 0.f;
      }
    }
    CpAsyncCommit();
  };

  float m = kNegInf, l = 0.f, acc = 0.f;
  for (int i = 0; i < kStages - 1; ++i) prefetch(tile_begin + i, i);
  for (int tile = tile_begin, j = 0; tile < tile_end; ++tile, ++j) {
    const int stage = j % kStages;
    CpAsyncWait<kStages - 2>();
    __syncthreads();  // tile landed; the previous tile is consumed
    prefetch(tile + kStages - 1, (j + kStages - 1) % kStages);
    const T* ks = reinterpret_cast<const T*>(kv + stage * 2 * kTileFloats);
    const T* vs =
        reinterpret_cast<const T*>(kv + (stage * 2 + 1) * kTileFloats);
    const float* keep = keep_sh + stage * kMaxTs;
    for (int c = tid; c < quads; c += kThreads) {
      const float4 kq = Kv<T>::Load4(ks, c, 0.f);
      float part_dot =
          qv.x * kq.x + qv.y * kq.y + qv.z * kq.z + qv.w * kq.w;
      // groups never straddle a warp (g divides 32)
      for (int o = g / 2; o > 0; o >>= 1)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
      if (glane == 0) {
        const int p = c / g;
        s_sh[p] = keep[p] > 0.5f ? part_dot : kNegInf;
      }
    }
    __syncthreads();
    // every warp reduces the tile's max and sum: the same bits in each
    float sv[kMaxTs / 32];
    float m_cur = kNegInf;
#pragma unroll
    for (int i = 0; i < kMaxTs / 32; ++i) {
      const int p = lane + 32 * i;
      sv[i] = p < ts ? s_sh[p] : kNegInf;
      m_cur = fmaxf(m_cur, sv[i]);
    }
    m_cur = WarpMax(m_cur);
    const float m_new = fmaxf(m, m_cur);
    // all-masked-so-far: exp(s - m_new) would turn masked slots into 1
    const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxTs / 32; ++i) {
      const int p = lane + 32 * i;
      const float pr = p < ts ? expf(sv[i] - m_safe) : 0.f;
      if (tid < 32 && p < ts) p_sh[p] = pr;
      psum += pr;
    }
    psum = WarpSum(psum);
    l = alpha * l + psum;
    m = m_new;
    acc *= alpha;
    __syncthreads();  // p_sh is written
    for (int p = part; p < ts; p += parts)
      acc = fmaf(p_sh[p], Kv<T>::Load(vs, p * h + d, 0.f),
                 acc);  // masked: 0 x 0
  }
  CpAsyncWait<0>();  // the prologue's groups of an empty split

  // the parts' accumulators, summed in part order
  __syncthreads();
  red[tid] = acc;
  __syncthreads();
  if (tid < h) {
    float total = 0.f;
    for (int pp = 0; pp < parts; ++pp) total += red[pp * h + tid];
    float* out = partial + (static_cast<size_t>(bn) * splits + split) *
                               (h + 2);
    out[tid] = total;
    if (tid == 0) {
      out[h] = m;
      out[h + 1] = l;
    }
  }
}

// Merges a (row, head)'s splits in split order: out = sum_s acc_s e_s /
// max(sum_s l_s e_s, 1e-20) with e_s = exp(m_s - max_s m_s). A row with
// nothing live has every m_s = NEG_INF and l_s = 0: exact zeros. Q: the
// type of out.
template <typename Q>
__global__ void __launch_bounds__(kThreads) FlashDecodeCombineKernel(
    const float* __restrict__ partial, Q* __restrict__ out, int head_dim,
    int splits) {
  const int bn = blockIdx.x;
  const int h = head_dim;
  const int tid = threadIdx.x;
  if (tid >= h) return;
  const float* part = partial + static_cast<size_t>(bn) * splits * (h + 2);
  float m_g = kNegInf;
  for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, part[s * (h + 2) + h]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ps = part + s * (h + 2);
    const float e = expf(ps[h] - m_g);
    l = fmaf(ps[h + 1], e, l);
    acc = fmaf(ps[tid], e, acc);
  }
  Act<Q>::Store(out + static_cast<size_t>(bn) * h, tid,
                acc / fmaxf(l, 1e-20f));
}

// -- the bfloat16 cache: one launch, one cluster per (row, head) ----------

// What a block of the cluster shows its neighbours (at the same offset of
// every block's shared memory; its acc[H], the sum of bf16(p_i)
// exp(M_j - m) v_i, goes to the ring once the ring is free).
struct alignas(16) Exchange {
  float total;      // the max of its scores (NEG_INF: empty or all masked)
  float first_max;  // the max of its scores in the page of its first slot
  int first_page;   // that page; -1 for an empty block
  float l;          // its sum of p_i exp(M_j - m)
};

// The block's sum of x (every thread gets it), in a fixed order.
__device__ float BlockSum(float x, float* red) {
  x = WarpSum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// out[i] = max(x[0 .. i]) for i < n: each thread scans a contiguous run,
// the runs' maxima are scanned across the block. Ends with a barrier.
__device__ void RunningMax(const float* x, int n, float* out, float* red) {
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per, e0 = min(n, b0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mx = kNegInf;
  for (int i = b0; i < e0; ++i) mx = fmaxf(mx, x[i]);
  float incl = mx;  // inclusive scan of the runs' maxima in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = fmaxf(incl, y);
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float run = kNegInf;  // the max of every run before this thread's
  for (int w = 0; w < warp; ++w) run = fmaxf(run, red[w]);
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0) run = fmaxf(run, prev);
  for (int i = b0; i < e0; ++i) {
    run = fmaxf(run, x[i]);
    out[i] = run;
  }
  __syncthreads();
}

// One (split, row x head) block of a cluster of `splits` blocks (see the
// header). cta_slots: the capacity of its score arrays, at least its
// tiles x kTs. Q: the type of q and out.
template <typename Q>
__global__ void __launch_bounds__(kThreads) FlashDecodeBf16Kernel(
    const Q* __restrict__ q, const bf16* __restrict__ k_cache,
    const bf16* __restrict__ v_cache, const float* __restrict__ pad,
    Q* __restrict__ out, int seq_len, int num_heads, int head_dim,
    int time_step, int page_size, int cta_slots) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVec = 8;           // bf16 values of one 16-byte copy
  cg::cluster_group cluster = cg::this_cluster();
  Exchange* xch = reinterpret_cast<Exchange*>(smem);
  float* ring = smem + sizeof(Exchange) / sizeof(float);  // [kStages][tile]
  float* p_sh = ring + kStages * kTileFloats;       // [kMaxTs]
  float* red = p_sh + kMaxTs;                       // [kThreads]
  float* nb_total = red + kThreads;                 // [kMaxCluster] each
  float* nb_first = nb_total + kMaxCluster;
  int* nb_page = reinterpret_cast<int*>(nb_first + kMaxCluster);
  float* s_sh = nb_first + 2 * kMaxCluster;         // [cta_slots] scores
  float* pm_sh = s_sh + cta_slots;                  // [cta_slots] run max
  // [kStages][kMaxTs] keep flags of the K tiles in the ring
  unsigned char* keep_sh = reinterpret_cast<unsigned char*>(pm_sh + cta_slots);

  const int split = blockIdx.x;     // the block's rank in its cluster
  const int splits = gridDim.x;
  const int bn = blockIdx.y;
  const int row = bn / num_heads;
  const int head = bn % num_heads;
  const int h = head_dim;
  const int ts = TileSlots<bf16>(h);
  const int tid = threadIdx.x;
  const size_t slot_stride = static_cast<size_t>(num_heads) * h;
  const size_t row_off = static_cast<size_t>(row) * seq_len * slot_stride +
                         static_cast<size_t>(head) * h;
  const float* pad_row = pad ? pad + static_cast<size_t>(row) * seq_len
                             : nullptr;
  const int t_eff = min(time_step, seq_len - 1);

  int tile_begin, tile_end;  // 12 loads in flight: one pass up to 1536
  SplitTiles<12>(pad_row, t_eff, ts, split, splits,
                 reinterpret_cast<int*>(red), &tile_begin, &tile_end);
  const int n = tile_end - tile_begin;  // the block's tiles
  const int first_slot = tile_begin * ts;
  const int cnt = n * ts;               // the slots it holds scores of

  // A tile sits in the ring as ts rows of h values; the 16-byte chunk k
  // of slot row p is stored at chunk k ^ (p % chunks), so that the reads
  // below (8 slots' same chunk at once, or one slot's whole row) hit
  // distinct banks.
  const int chunks = h / kVec;            // 16-byte chunks of a slot row
  const int cpt = ts * chunks / kThreads;  // copies of a tile per thread
  const int copy_slot = tid * cpt / chunks;  // all of one slot's
  const int copy_chunk = tid * cpt % chunks;
  // scores: lps lanes per slot (4 at h = 128), each up to 4 chunks
  const int lps = max(1, h / 32);
  const int cpl = chunks / lps;           // chunks of a lane
  const int my_slot = tid / lps, my_part = tid % lps;
  float qr[32];  // this lane's q values (registers: q from shared memory
                 // costs two more loads per chunk)
#pragma unroll
  for (int j = 0; j < 32; ++j)
    qr[j] = j < cpl * kVec
                ? Act<Q>::Load(q + static_cast<size_t>(bn) * h,
                               my_part * cpl * kVec + j)
                : 0.f;
  // P . V: thread (part, cq) owns columns 4 cq .. 4 cq + 3 over the
  // slots part, part + parts, ...
  const int quads = h / 4;
  const int parts = kThreads / quads;
  const int cq = tid % quads, part = tid / quads;

  // Step i < n streams the K tile tile_begin + i, step n + i its V tile;
  // starts step i's copies into stage `stage` and always commits a group.
  auto prefetch = [&](int i, int stage) {
    if (i < 2 * n) {
      const bool is_v = i >= n;
      const bf16* src = is_v ? v_cache : k_cache;
      bf16* dst = reinterpret_cast<bf16*>(ring + stage * kTileFloats) +
                  copy_slot * h;
      const int slot = (tile_begin + (is_v ? i - n : i)) * ts + copy_slot;
      const bool keep = Keep(pad_row, slot, t_eff);
      const bf16* row = src + row_off + static_cast<size_t>(keep ? slot : 0) *
                                            slot_stride;
      for (int r = 0; r < cpt; ++r) {
        const int k = copy_chunk + r;
        CpAsync16(dst + kVec * (k ^ (copy_slot & (chunks - 1))),
                  row + kVec * k, keep);
      }
      if (!is_v && copy_chunk == 0)
        keep_sh[stage * kMaxTs + copy_slot] = keep;
    }
    CpAsyncCommit();
  };

  // 1. scores of the block's slots (NEG_INF where masked)
  for (int i = 0; i < kStages - 1; ++i) prefetch(i, i);
  for (int i = 0; i < n; ++i) {
    const int stage = i % kStages;
    CpAsyncWait<kStages - 2>();
    __syncthreads();  // step i landed; step i - 1 is consumed
    prefetch(i + kStages - 1, (i + kStages - 1) % kStages);
    const bf16* ks = reinterpret_cast<const bf16*>(ring + stage * kTileFloats);
    const unsigned char* keep = keep_sh + stage * kMaxTs;
    for (int p = my_slot; p < ts; p += kThreads / lps) {  // uniform trips
      const bf16* row = ks + p * h;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < cpl) {
          const int k = my_part * cpl + j;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              row + kVec * (k ^ (p & (chunks - 1))));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            dot = fmaf(qr[8 * j + 2 * e], kv.x, dot);
            dot = fmaf(qr[8 * j + 2 * e + 1], kv.y, dot);
          }
        }
      }
      for (int o = lps / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (my_part == 0) s_sh[i * ts + p] = keep[p] ? dot : kNegInf;
    }
  }
  __syncthreads();
  RunningMax(s_sh, cnt, pm_sh, red);

  // 2. exchange: (total, first-page max, first page) of every block
  const int first_page = first_slot / page_size;
  if (tid == 0) {
    const int first_end = min(cnt, (first_page + 1) * page_size - first_slot);
    xch->total = cnt > 0 ? pm_sh[cnt - 1] : kNegInf;
    xch->first_max = cnt > 0 ? pm_sh[first_end - 1] : kNegInf;
    xch->first_page = cnt > 0 ? first_page : -1;
  }
  cluster.sync();
  if (tid < splits) {
    const Exchange* other = cluster.map_shared_rank(xch, tid);
    nb_total[tid] = other->total;
    nb_first[tid] = other->first_max;
    nb_page[tid] = other->first_page;
  }
  __syncthreads();
  const int last_page = cnt > 0 ? (first_slot + cnt - 1) / page_size : -2;
  float before = kNegInf;  // every earlier block's scores
  float m_row = kNegInf;   // the row's max
  float tail = kNegInf;    // later blocks' scores in this block's last page
  for (int r = 0; r < splits; ++r) {
    m_row = fmaxf(m_row, nb_total[r]);
    if (r < split) before = fmaxf(before, nb_total[r]);
    if (r > split && nb_page[r] == last_page)
      tail = fmaxf(tail, nb_first[r]);
  }

  // 3. P . V against the row's max, p rounded against M_j
  float psum = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = n; i < 2 * n; ++i) {
    const int stage = i % kStages;
    const int j = i - n;
    CpAsyncWait<kStages - 2>();
    __syncthreads();
    prefetch(i + kStages - 1, (i + kStages - 1) % kStages);
    const bf16* vs = reinterpret_cast<const bf16*>(ring + stage * kTileFloats);
    for (int p = tid; p < ts; p += kThreads) {
      const int x = j * ts + p;  // the slot's index in s_sh
      const int page = (first_slot + x) / page_size;
      // M_j: through the end of page j, here and in the other blocks
      float m_j = fmaxf(before,
                        pm_sh[min(cnt, (page + 1) * page_size - first_slot)
                              - 1]);
      if (page == last_page) m_j = fmaxf(m_j, tail);
      // all-masked-so-far: exp(s - m_j) would turn masked slots into 1
      const float m_safe = m_j <= kNegInf * 0.5f ? 0.f : m_j;
      const float pr = expf(s_sh[x] - m_safe);
      const float e = expf(m_j - m_row);
      p_sh[p] = Kv<bf16>::RoundP(pr) * e;
      psum += pr * e;
    }
    __syncthreads();  // p_sh is written
    for (int p = part; p < ts; p += parts) {  // masked: 0 x 0
      const uint2 raw = *reinterpret_cast<const uint2*>(
          vs + p * h + kVec * ((cq >> 1) ^ (p & (chunks - 1))) +
          4 * (cq & 1));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      const float w = p_sh[p];
      acc[0] = fmaf(w, a.x, acc[0]);
      acc[1] = fmaf(w, a.y, acc[1]);
      acc[2] = fmaf(w, b.x, acc[2]);
      acc[3] = fmaf(w, b.y, acc[3]);
    }
  }
  CpAsyncWait<0>();  // the prologue's groups of an empty block

  // 4. merge: the parts' sums in part order (in the ring, free now), then
  // the blocks' in split order by block 0
  const float l = BlockSum(psum, red);
  float* parts_sh = ring;                    // [parts][h]
  float* acc_sh = ring + kThreads * 4;       // [h], read by block 0
#pragma unroll
  for (int e = 0; e < 4; ++e) parts_sh[part * h + 4 * cq + e] = acc[e];
  __syncthreads();
  if (tid < h) {
    float total = 0.f;
    for (int pp = 0; pp < parts; ++pp) total += parts_sh[pp * h + tid];
    acc_sh[tid] = total;
  }
  if (tid == 0) xch->l = l;
  cluster.sync();
  if (split == 0 && tid < h) {
    float a = 0.f, den = 0.f;
    for (int r = 0; r < splits; ++r) {
      a += cluster.map_shared_rank(acc_sh, r)[tid];
      den += cluster.map_shared_rank(xch, r)->l;
    }
    Act<Q>::Store(out + static_cast<size_t>(bn) * h, tid,
                  a / fmaxf(den, 1e-20f));
  }
  cluster.sync();  // every block's shared memory outlives block 0's reads
}

size_t SplitSmemBytes() {
  return sizeof(float) *
         (kStages * 2 * kTileFloats + 2 * kMaxTs + kStages * kMaxTs +
          kThreads);
}

size_t Bf16SmemBytes(int cta_slots) {
  return sizeof(Exchange) +
         sizeof(float) * (kStages * kTileFloats + kMaxTs + kThreads +
                          3 * kMaxCluster + 2 * cta_slots) +
         kStages * kMaxTs;
}

// The score capacity a bf16 block needs: ceil(tiles / splits) tiles,
// where the tiles run from slot 0 to t_eff (the first live slot is known
// only on the card).
int Bf16CtaSlots(int seq_len, int head_dim, int time_step, int splits) {
  const int t_eff = std::min(time_step, seq_len - 1);
  if (t_eff < 0) return 0;
  const int ts = HostTileSlots(head_dim, 2);
  const int tiles = t_eff / ts + 1;
  return (tiles + splits - 1) / splits * ts;
}

// Opts a kernel into `bytes` of dynamic shared memory (above the 48 KB
// default) once per device, not on every launch: the attribute call costs
// host time, and the decode step that calls this op is bound by the
// host's enqueue. Two threads racing here both set the same value, which
// is harmless. Each kernel is set once to the most it may take.
template <typename Kernel>
cudaError_t AllowSmemOnce(Kernel kernel, size_t bytes, bool* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  constexpr int kMaxDevices = 64;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <typename Q>
cudaError_t AllowSplitSmem() {
  static bool allowed[64] = {};
  return AllowSmemOnce(FlashDecodeSplitKernel<Q>, SplitSmemBytes(), allowed);
}

template <typename Q>
cudaError_t AllowBf16Smem() {
  static bool allowed[64] = {};
  return AllowSmemOnce(FlashDecodeBf16Kernel<Q>, Bf16SmemBytes(kMaxCtaSlots),
                       allowed);
}

bool BadHeadDim(int head_dim, int kv_dtype) {
  const int g = head_dim / 4;
  return head_dim < (kv_dtype == kBF16 ? 8 : 4) || head_dim > kMaxHeadDim ||
         head_dim % 4 != 0 || (g & (g - 1)) != 0;
}

template <typename Q>
cudaError_t LaunchF32(const Q* q, const float* k_cache,
                      const float* v_cache, const float* pad, Q* out,
                      float* partial, unsigned rows, int seq_len,
                      int num_heads, int head_dim, int time_step, int splits,
                      cudaStream_t s) {
  if (splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = AllowSplitSmem<Q>();
  if (err != cudaSuccess) return err;
  FlashDecodeSplitKernel<Q><<<dim3(rows, splits), kThreads,
                              SplitSmemBytes(), s>>>(
      q, k_cache, v_cache, pad, partial, seq_len, num_heads, head_dim,
      time_step);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  FlashDecodeCombineKernel<Q><<<rows, kThreads, 0, s>>>(partial, out,
                                                        head_dim, splits);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t LaunchBf16(const Q* q, const bf16* k_cache,
                       const bf16* v_cache, const float* pad, Q* out,
                       unsigned rows, int seq_len, int num_heads,
                       int head_dim, int time_step, int splits,
                       int page_size, cudaStream_t s) {
  // the wrapper's CtaSlots, which raises above kMaxCtaSlots
  const int cta_slots = Bf16CtaSlots(seq_len, head_dim, time_step, splits);
  if (splits > kMaxCluster || rows > 65535 || cta_slots > kMaxCtaSlots)
    return cudaErrorInvalidValue;
  cudaError_t err = AllowBf16Smem<Q>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Bf16SmemBytes(cta_slots);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, FlashDecodeBf16Kernel<Q>, q, k_cache,
                           v_cache, pad, out, seq_len, num_heads, head_dim,
                           time_step, page_size, cta_slots);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launches for a cache of `kv_dtype` and a q of type Q.
template <typename Q>
cudaError_t LaunchFor(int kv_dtype, const void* q, const void* k_cache,
                      const void* v_cache, const float* pad, void* out,
                      float* scratch, unsigned rows, int seq_len,
                      int num_heads, int head_dim, int time_step, int splits,
                      int page_size, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return LaunchF32<Q>(static_cast<const Q*>(q),
                          static_cast<const float*>(k_cache),
                          static_cast<const float*>(v_cache), pad,
                          static_cast<Q*>(out), scratch, rows, seq_len,
                          num_heads, head_dim, time_step, splits, s);
    case kBF16:
      return LaunchBf16<Q>(static_cast<const Q*>(q),
                           static_cast<const bf16*>(k_cache),
                           static_cast<const bf16*>(v_cache), pad,
                           static_cast<Q*>(out), rows, seq_len, num_heads,
                           head_dim, time_step, splits, page_size, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launches (0 = ok).
// q/out [B, N, H] of `q_dtype` (ActDtype: float32 or bfloat16);
// k_cache/v_cache [B, S, N, H] of `kv_dtype` (KvDtype: float32 or
// bfloat16); pad [B, S] float32 or null; scratch: float32,
// FlashDecodeScratchFloats(...) of them (none for bfloat16); all
// contiguous on one device. A float32 cache takes the split kernel and
// the combine (two launches), a bfloat16 cache one cluster launch with
// splits <= 8.
int FlashDecode(const void* q, const void* k_cache, const void* v_cache,
                const float* pad, void* out, float* scratch, int batch,
                int seq_len, int num_heads, int head_dim, int time_step,
                int splits, int page_size, int kv_dtype, int q_dtype,
                void* stream) {
  if (batch <= 0) return 0;
  if (BadHeadDim(head_dim, kv_dtype) || seq_len <= 0 || splits < 1 ||
      page_size < 1 || page_size > kMaxTs ||
      (q_dtype != kActF32 && q_dtype != kActBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>(batch) * num_heads;
  const cudaError_t err =
      q_dtype == kActBF16
          ? LaunchFor<bf16>(kv_dtype, q, k_cache, v_cache, pad, out, scratch,
                            rows, seq_len, num_heads, head_dim, time_step,
                            splits, page_size, s)
          : LaunchFor<float>(kv_dtype, q, k_cache, v_cache, pad, out,
                             scratch, rows, seq_len, num_heads, head_dim,
                             time_step, splits, page_size, s);
  return static_cast<int>(err);
}

// Floats of FlashDecode's scratch for these sizes and `kv_dtype`: the
// float32 splits' (acc, m, l); a bfloat16 cache needs none.
long long FlashDecodeScratchFloats(int batch, int seq_len, int num_heads,
                                   int head_dim, int splits, int kv_dtype) {
  if (kv_dtype != kF32) return 0;
  return static_cast<long long>(batch) * num_heads * splits * (head_dim + 2);
}

// The launch geometry for `kv_dtype`: threads and dynamic shared memory
// per block, and the blocks resident on one SM (bfloat16: with the score
// arrays of a 1024-slot cache over 8 splits), of the float32-q kernels. A
// bfloat16 q takes the same split count (`NumSplits` reads this), so its
// kernel splits the row where the float32-q kernel does. Returns the
// cudaError_t.
int FlashDecodeGeometry(int kv_dtype, int* threads, int* smem_bytes,
                        int* blocks_per_sm) {
  *threads = kThreads;
  cudaError_t err;
  switch (kv_dtype) {
    case kF32:
      *smem_bytes = static_cast<int>(SplitSmemBytes());
      err = AllowSplitSmem<float>();
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, FlashDecodeSplitKernel<float>, kThreads,
            SplitSmemBytes());
      break;
    case kBF16: {
      const size_t bytes =
          Bf16SmemBytes(Bf16CtaSlots(1024, 128, 1023, kMaxCluster));
      *smem_bytes = static_cast<int>(bytes);
      err = AllowBf16Smem<float>();
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, FlashDecodeBf16Kernel<float>, kThreads, bytes);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* FlashDecodeErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
