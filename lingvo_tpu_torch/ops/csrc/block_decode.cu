// Single-query block-table paged decode attention, Hopper (sm_90a):
// float32, bfloat16 and int8 page pools, float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_BlockDecodeKernel` of
// lingvo_tpu/ops/block_decode.py (pallas_call in `_PallasBlockDecode`;
// public entry `BlockDecode`). It computes the same function, not the
// same blocks: row b's one pre-scaled query attends its logical KV slots
// [0, seq_lens[b]), slot s living at pool page block_tables[b, s / P],
// offset s % P, with the float32 softmax of the reference's page loop
// (`_PageAttend`: the m_safe guard, acc / max(l, 1e-20)). seq_lens[b] <= 0
// marks an inactive row, which writes exact zeros and reads no page.
//
// Bound: a gather far below the card's ridge point (4 flops per K/V
// element read), so bytes bound it: each row's seq_len live K/V slots,
// its live table entries and length, q and out, over 3.35 TB/s on an H100
// SXM; 2 bytes per bfloat16 element, or 1 per int8 element plus 4 per
// live (slot, head) of each scale sidecar.
//
// The first design (one 128-thread block per (row, head), pages walked
// one after another with three block barriers and a serial scan of the
// page's scores each) was held by latency: 8 x 16 = 128 blocks on 132
// SMs, the longest row setting the time at about 6.8 us a page. This
// design (its CPU model is `SplitPages` / `SplitMaxima` in
// ops/block_decode.py):
//  - Split KV over a thread-block cluster. The S blocks of a cluster
//    (grid (S, B * N), cluster (S, 1, 1), S <= 8, the portable size) serve
//    one (row, head). S comes from the host (`NumSplits`: the table's
//    width and P, not seq_lens, so no host sync). Each block reads the
//    row's length and takes the contiguous run of live pages
//    [s live / S, (s + 1) live / S); a block with none takes part in the
//    cluster's barriers and adds nothing.
//  - Loads in flight without block barriers. Each warp owns every fourth
//    tile of the block's slots (a tile is wts = 512 / H slots, 2 KB of
//    float32 K or V) and streams its tiles through a ring of its own in
//    shared memory with 16-byte cp.async (kStages - 1 tiles in flight, the
//    K tiles, then the V tiles, so V loads start under the last scores),
//    synchronised by __syncwarp alone. A slot past seq_len is never
//    copied (zero-fill), nor its int8 scale, so NaN poison stays
//    harmless; a table entry past the row's live pages is never read.
//  - Scores: lps = min(8, H / 4) lanes per slot, each holding its q
//    quads in registers, summed by shuffles. The scores of the block's
//    slots stay in shared memory.
//  - The exchange. One warp per page reduces the page maxima; the block
//    publishes its max, and after one cluster barrier every block knows
//    the row's max m and the max of the blocks before it. A bfloat16 pool
//    rounds p where the reference does: p = exp(s - M_j), M_j the running
//    max through the end of the slot's page j in walk order = max(the
//    earlier blocks' maxima, the block's running max of its page maxima);
//    P.V then takes bf16(p) exp(M_j - m). float32 and int8 take M_j = m
//    (no rounding: the same value up to float32 rounding).
//  - Merge in the same launch. Each block sums its warps' acc[H] and l in
//    a fixed order; after a second cluster barrier rank 0 sums the ranks
//    in order and writes acc / max(l, 1e-20); a third keeps every block's
//    shared memory alive until rank 0 has read it. No scratch, no atomics,
//    one kernel node per call: the bits repeat.
// Storage: the kernel is a template on it and reads K and V only through
// `Kv` (kv_storage.cuh). The slot geometry (tiles, lanes per slot, the
// order of every sum) depends on H alone, never on the storage type, so
// the int8 kernel equals the float32 kernel on the pre-dequantized pool
// bit for bit (int8 is dequantized on load with an uncontracted
// __fmul_rn).
// q and out: float32, or bfloat16 under fprop_dtype=bfloat16 (`Act`,
// kv_storage.cuh: q widened on load, out rounded once at the division), a
// second template parameter; nothing else changes with it.
//
// Limits (the Python wrapper's `KernelLimitError` raises outside them):
// H a power of two in 4..128 with a slot row of at least 16 bytes (H >= 8
// bfloat16, H >= 16 int8), page_size 1..128, at most kMaxCtaSlots slots
// of scores per block, all tensors contiguous and 16-byte aligned,
// float32 or bfloat16 q, int32 tables and lengths.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // a warp's ring: kStages - 1 in flight
constexpr int kTileFloats = 512;    // float32 K (or V) values of a tile
constexpr int kMaxTileSlots = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxPageSize = 128;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kMaxCtaSlots = 8192;  // slots whose scores one block holds
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int TileSlots(int head_dim) {
  return kTileFloats / head_dim < kMaxTileSlots ? kTileFloats / head_dim
                                                : kMaxTileSlots;
}

__host__ __device__ inline size_t Align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The shared memory of a block, in byte offsets.
struct Layout {
  size_t ring;     // [kWarps][kStages][tile bytes] K / V tiles
  size_t scales;   // [kWarps][kStages][wts] int8 scales (else empty)
  size_t scores;   // [cta_slots] scores, then the P.V weights
  size_t pages;    // [3][cta_pages]: running page max, m_safe, exp(M - m)
  size_t table;    // [cta_pages] the block's page ids
  size_t misc;     // [kWarps] sums, [kMaxSplits] the ranks' maxima
  size_t xch;      // Exchange
  size_t bytes;
};

// What a block shows the other blocks of its cluster.
struct alignas(16) Exchange {
  float total;   // the max of its scores (NEG_INF: no page)
  float l;       // its sum of p exp(M_j - m)
};

__host__ __device__ inline Layout MakeLayout(int head_dim, int itemsize,
                                             bool int8, int cta_slots,
                                             int cta_pages) {
  Layout L;
  const size_t tile = static_cast<size_t>(TileSlots(head_dim)) * head_dim *
                      itemsize;
  L.ring = 0;
  L.scales = Align16(L.ring + kWarps * kStages * tile);
  L.scores = Align16(L.scales + (int8 ? kWarps * kStages *
                                            TileSlots(head_dim) * 4 : 0));
  L.pages = Align16(L.scores + static_cast<size_t>(cta_slots) * 4);
  L.table = Align16(L.pages + 3 * static_cast<size_t>(cta_pages) * 4);
  L.misc = Align16(L.table + static_cast<size_t>(cta_pages) * 4);
  L.xch = Align16(L.misc + (kWarps + kMaxSplits) * 4);
  L.bytes = L.xch + sizeof(Exchange);
  // the ring doubles as the merge's scratch: [kWarps * 128] + [H] floats
  const size_t merge = (kWarps * 128 + kMaxHeadDim) * 4;
  if (L.scales < merge) {
    const size_t grow = merge - L.scales;
    L.scales += grow;
    L.scores += grow;
    L.pages += grow;
    L.table += grow;
    L.misc += grow;
    L.xch += grow;
    L.bytes += grow;
  }
  return L;
}

__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
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
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc + a . b over one quad, summed in the order of its values
__device__ __forceinline__ float Dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One (split, row x head) block of a cluster of `splits` blocks (see the
// head of this file). cta_pages: the most pages a block takes,
// ceil(t_pages / splits); cta_slots = cta_pages * page_size. Q: the type
// of q and out (`Act`, kv_storage.cuh).
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads) BlockDecodeKernel(
    const Q* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ seq_lens, Q* __restrict__ out, int num_heads,
    int head_dim, int num_pool_pages, int page_size, int t_pages,
    int cta_slots, int cta_pages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInt8 = sizeof(T) == 1;
  const int h = head_dim;
  const Layout L = MakeLayout(h, sizeof(T), kInt8, cta_slots, cta_pages);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;
  const int bn = blockIdx.y;
  const int row = bn / num_heads, head = bn % num_heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t q_off = static_cast<size_t>(bn) * h;

  const int len = seq_lens[row];
  if (len <= 0) {  // the whole cluster returns: exact zeros, no page read
    if (split == 0 && tid < h) Act<Q>::Store(out + q_off, tid, 0.f);
    return;
  }
  // the block's run of live pages and its slots [s0, s0 + ns)
  const int live = min((len + page_size - 1) / page_size, t_pages);
  const int pb0 = static_cast<int>(static_cast<long long>(split) * live /
                                   splits);
  const int pb1 = static_cast<int>(static_cast<long long>(split + 1) * live /
                                   splits);
  const int np = pb1 - pb0;
  const int s0 = pb0 * page_size;
  const int ns = max(0, min(pb1 * page_size, len) - s0);

  float* s_sh = reinterpret_cast<float*>(smem + L.scores);
  float* pm = reinterpret_cast<float*>(smem + L.pages);  // running page max
  float* msafe = pm + cta_pages;
  float* ew = msafe + cta_pages;
  int* tbl = reinterpret_cast<int*>(smem + L.table);
  float* wsum = reinterpret_cast<float*>(smem + L.misc);  // [kWarps]
  float* nb = wsum + kWarps;                               // [kMaxSplits]
  Exchange* xch = reinterpret_cast<Exchange*>(smem + L.xch);

  for (int j = tid; j < np; j += kThreads)
    tbl[j] = min(max(tables[static_cast<size_t>(row) * t_pages + pb0 + j], 0),
                 num_pool_pages - 1);
  __syncthreads();

  // tiles: wts slots each; warp w owns tiles w, w + kWarps, ...
  const int wts = TileSlots(h);
  const int tile_bytes = wts * h * static_cast<int>(sizeof(T));
  const int chunks = tile_bytes / 16;      // 16-byte copies of a tile
  const int row_chunks = h * static_cast<int>(sizeof(T)) / 16;
  const int ntiles = (ns + wts - 1) / wts;
  const int my_tiles = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps
                                     : 0;
  const int steps = 2 * my_tiles;          // K tiles, then V tiles
  unsigned char* ring = smem + L.ring +
                        static_cast<size_t>(warp) * kStages * tile_bytes;
  float* sc_ring = reinterpret_cast<float*>(smem + L.scales) +
                   warp * kStages * wts;
  const size_t slot_stride = static_cast<size_t>(num_heads) * h;
  const size_t head_off = static_cast<size_t>(head) * h;

  // Starts step i's copies into stage i % kStages (if the step is this
  // warp's) and always commits a group.
  auto prefetch = [&](int i) {
    if (i < steps) {
      const bool is_v = i >= my_tiles;
      const int slot0 = (warp + kWarps * (is_v ? i - my_tiles : i)) * wts;
      const T* src = is_v ? v_pool : k_pool;
      unsigned char* dst = ring + (i % kStages) * tile_bytes;
      for (int c = lane; c < chunks; c += 32) {
        const int x = slot0 + c / row_chunks;   // block slot
        const bool keep = x < ns;
        const int pg = keep ? x / page_size : 0;
        const int off = keep ? x - pg * page_size : 0;
        const T* rowp = src + (static_cast<size_t>(tbl[pg]) * page_size +
                               off) * slot_stride + head_off;
        CpAsync16(dst + 16 * c,
                  reinterpret_cast<const unsigned char*>(rowp) +
                      16 * (c % row_chunks), keep);
      }
      if (kInt8) {   // the slots' scales, [NP, N, P]
        const float* sc = is_v ? v_scale : k_scale;
        float* sd = sc_ring + (i % kStages) * wts;
        for (int t = lane; t < wts; t += 32) {
          const int x = slot0 + t;
          const bool keep = x < ns;
          const int pg = keep ? x / page_size : 0;
          const int off = keep ? x - pg * page_size : 0;
          CpAsync4(sd + t, sc + (static_cast<size_t>(tbl[pg]) * num_heads +
                                 head) * page_size + off, keep);
        }
      }
    }
    CpAsyncCommit();
  };

  // scores: lps lanes per slot, lane part p holding quads p + lps j of q
  const int quads = h / 4;
  const int lps = quads < 8 ? quads : 8;
  const int my_slot = lane / lps, my_part = lane % lps;
  const int spr = 32 / lps;                  // slots of a round
  const int qpl = quads / lps;               // quads of a lane (<= 4)
  float4 qr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    qr[j] = j < qpl ? Act<Q>::Load4(q + q_off, my_part + lps * j)
                    : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < kStages - 1; ++i) prefetch(i);
  for (int i = 0; i < my_tiles; ++i) {
    CpAsyncWait<kStages - 2>();
    __syncwarp();  // step i landed for every lane; step i - 1 is consumed
    prefetch(i + kStages - 1);
    const T* st = reinterpret_cast<const T*>(ring + (i % kStages) *
                                                        tile_bytes);
    const float* sst = sc_ring + (i % kStages) * wts;
    const int slot0 = (warp + kWarps * i) * wts;
    for (int t = my_slot; t < wts; t += spr) {  // uniform trips
      const float sc = kInt8 ? sst[t] : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < qpl)
          dot = Dot4(qr[j], Kv<T>::Load4(st + t * h, my_part + lps * j, sc),
                     dot);
      for (int o = lps / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (my_part == 0 && slot0 + t < ns) s_sh[slot0 + t] = dot;
    }
  }
  __syncthreads();  // every score is written

  // the running max of the block's page maxima
  for (int j = warp; j < np; j += kWarps) {
    float mx = kNegInf;
    const int end = min((j + 1) * page_size, ns);
    for (int x = j * page_size + lane; x < end; x += 32)
      mx = fmaxf(mx, s_sh[x]);
    mx = WarpMax(mx);
    if (lane == 0) pm[j] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    float run = kNegInf;
    for (int j = 0; j < np; ++j) {
      run = fmaxf(run, pm[j]);
      pm[j] = run;
    }
    xch->total = run;
  }
  cluster.sync();  // 1: every block's max is published
  if (tid < splits) nb[tid] = cluster.map_shared_rank(xch, tid)->total;
  __syncthreads();
  float before = kNegInf, m_row = kNegInf;
  for (int r = 0; r < splits; ++r) {
    m_row = fmaxf(m_row, nb[r]);
    if (r < split) before = fmaxf(before, nb[r]);
  }
  for (int j = tid; j < np; j += kThreads) {
    // M_j: the reference's running max through the end of page j
    const float m_j = Kv<T>::kRoundsP ? fmaxf(before, pm[j]) : m_row;
    msafe[j] = m_j <= kNegInf * 0.5f ? 0.f : m_j;  // all masked so far
    ew[j] = expf(m_j - m_row);
  }
  __syncthreads();
  // the P.V weights bf16(p) exp(M_j - m) in place; l sums p exp(M_j - m)
  float psum = 0.f;
  for (int x = tid; x < ns; x += kThreads) {
    const int j = x / page_size;
    const float p = expf(s_sh[x] - msafe[j]);
    s_sh[x] = Kv<T>::RoundP(p) * ew[j];
    psum += p * ew[j];
  }
  __syncthreads();

  // P.V: lane (part, cq) owns columns 4 cq .. 4 cq + 3 over the slots
  // part, part + parts, ... of each of the warp's tiles
  const int parts = 32 / quads;
  const int cq = lane % quads, part = lane / quads;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = my_tiles; i < steps; ++i) {
    CpAsyncWait<kStages - 2>();
    __syncwarp();
    prefetch(i + kStages - 1);
    const T* st = reinterpret_cast<const T*>(ring + (i % kStages) *
                                                        tile_bytes);
    const float* sst = sc_ring + (i % kStages) * wts;
    const int slot0 = (warp + kWarps * (i - my_tiles)) * wts;
    for (int t = part; t < wts; t += parts) {
      const int x = slot0 + t;
      const float w = x < ns ? s_sh[x] : 0.f;  // past ns: 0 x zero-fill
      const float4 v = Kv<T>::Load4(st + t * h, cq, kInt8 ? sst[t] : 0.f);
      acc[0] = fmaf(w, v.x, acc[0]);
      acc[1] = fmaf(w, v.y, acc[1]);
      acc[2] = fmaf(w, v.z, acc[2]);
      acc[3] = fmaf(w, v.w, acc[3]);
    }
  }
  CpAsyncWait<0>();  // the prologue's groups of a warp with no tile

  // merge: the (warp, part) sums in order, then the ranks' by rank 0
  __syncthreads();   // every ring is consumed: it is the merge's scratch
  float* red = reinterpret_cast<float*>(smem + L.ring);  // [kWarps][128]
  float* acc_sh = red + kWarps * 128;                     // [H]
#pragma unroll
  for (int e = 0; e < 4; ++e)
    red[(warp * parts + part) * h + 4 * cq + e] = acc[e];
  psum = WarpSum(psum);
  if (lane == 0) wsum[warp] = psum;
  __syncthreads();
  if (tid < h) {
    float total = 0.f;
    for (int pp = 0; pp < kWarps * parts; ++pp) total += red[pp * h + tid];
    acc_sh[tid] = total;
  }
  if (tid == 0) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += wsum[w];
    xch->l = l;
  }
  cluster.sync();  // 2: every block's acc and l are published
  if (split == 0 && tid < h) {
    float a = 0.f, den = 0.f;
    for (int r = 0; r < splits; ++r) {
      a += cluster.map_shared_rank(acc_sh, r)[tid];
      den += cluster.map_shared_rank(xch, r)->l;
    }
    Act<Q>::Store(out + q_off, tid, a / fmaxf(den, 1e-20f));
  }
  cluster.sync();  // 3: every block's shared memory outlives rank 0's reads
}

bool BadShape(int head_dim, int itemsize, int page_size) {
  return head_dim < 4 || head_dim > kMaxHeadDim ||
         (head_dim & (head_dim - 1)) != 0 || head_dim * itemsize < 16 ||
         page_size < 1 || page_size > kMaxPageSize;
}

int Itemsize(int kv_dtype) {
  return kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
}

template <typename T>
size_t SmemBytes(int head_dim, int page_size, int t_pages, int splits) {
  const int cta_pages = (t_pages + splits - 1) / splits;
  return MakeLayout(head_dim, sizeof(T), sizeof(T) == 1,
                    cta_pages * page_size, cta_pages).bytes;
}

// Opts the kernel into the most dynamic shared memory it may take (above
// the 48 KB default), once per device: the attribute call costs host
// time, and the legacy decode step is bound by the host's enqueue.
template <typename T, typename Q>
cudaError_t AllowSmem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  // the largest layout: one slot a page, kMaxCtaSlots of them
  const size_t most = MakeLayout(kMaxHeadDim, sizeof(T), sizeof(T) == 1,
                                 kMaxCtaSlots, kMaxCtaSlots).bytes;
  err = cudaFuncSetAttribute(BlockDecodeKernel<T, Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

template <typename T, typename Q>
cudaError_t Launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* seq_lens, void* out,
                   int batch, int num_heads, int head_dim,
                   int num_pool_pages, int page_size, int t_pages,
                   int splits, cudaStream_t stream) {
  const int cta_pages = (t_pages + splits - 1) / splits;
  const long long rows = static_cast<long long>(batch) * num_heads;
  if (splits < 1 || splits > kMaxSplits ||
      cta_pages * page_size > kMaxCtaSlots || rows > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = AllowSmem<T, Q>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, static_cast<unsigned>(rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = SmemBytes<T>(head_dim, page_size, t_pages, splits);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, BlockDecodeKernel<T, Q>,
                           static_cast<const Q*>(q),
                           static_cast<const T*>(k_pool),
                           static_cast<const T*>(v_pool), k_scale, v_scale,
                           tables, seq_lens, static_cast<Q*>(out), num_heads,
                           head_dim,
                           num_pool_pages, page_size, t_pages,
                           cta_pages * page_size, cta_pages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t Geometry(int head_dim, int page_size, int t_pages, int splits,
                     int* geo) {
  const size_t bytes = SmemBytes<T>(head_dim, page_size, t_pages, splits);
  cudaError_t err = AllowSmem<T, float>();
  if (err != cudaSuccess) return err;
  geo[0] = kThreads;
  geo[1] = static_cast<int>(bytes);
  geo[2] = TileSlots(head_dim);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &geo[3], BlockDecodeKernel<T, float>, kThreads, bytes);
  return err;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q/out [B, N, H] of `q_dtype` (ActDtype: float32 or bfloat16);
// k_pool/v_pool [NP, P, N, H] of `kv_dtype` (KvDtype); k_scale/v_scale
// [NP, N, P] float32 for int8 pools, else null; tables [B, t_pages];
// seq_lens [B]; all contiguous, on one device. splits: the blocks of one
// (row, head)'s cluster, 1..8 (the Python `NumSplits`). One kernel.
int BlockDecode(const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, const int* tables,
                const int* seq_lens, void* out, int batch, int num_heads,
                int head_dim, int num_pool_pages, int page_size, int t_pages,
                int kv_dtype, int q_dtype, int splits, void* stream) {
  if (batch <= 0) return 0;
  if (kv_dtype < kF32 || kv_dtype > kI8 ||
      (q_dtype != kActF32 && q_dtype != kActBF16) ||
      BadShape(head_dim, Itemsize(kv_dtype), page_size) ||
      num_pool_pages < 1 || t_pages < 1 ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define BLOCK_DECODE_LAUNCH(T)                                              \
  (q_dtype == kActBF16                                                     \
       ? Launch<T, bf16>(q, k_pool, v_pool, k_scale, v_scale, tables,      \
                         seq_lens, out, batch, num_heads, head_dim,        \
                         num_pool_pages, page_size, t_pages, splits, s)    \
       : Launch<T, float>(q, k_pool, v_pool, k_scale, v_scale, tables,     \
                          seq_lens, out, batch, num_heads, head_dim,       \
                          num_pool_pages, page_size, t_pages, splits, s))
  switch (kv_dtype) {
    case kF32:
      err = BLOCK_DECODE_LAUNCH(float);
      break;
    case kBF16:
      err = BLOCK_DECODE_LAUNCH(bf16);
      break;
    default:
      err = BLOCK_DECODE_LAUNCH(int8_t);
      break;
  }
#undef BLOCK_DECODE_LAUNCH
  return static_cast<int>(err);
}

// The launch geometry for `kv_dtype` at (H, P, t_pages, splits): geo[0]
// threads, geo[1] dynamic shared bytes per block, geo[2] slots of a warp
// tile, geo[3] blocks resident on one SM. Returns the cudaError_t.
int BlockDecodeGeometry(int head_dim, int page_size, int t_pages, int splits,
                        int kv_dtype, int* geo) {
  if (kv_dtype < kF32 || kv_dtype > kI8 ||
      BadShape(head_dim, Itemsize(kv_dtype), page_size) || t_pages < 1 ||
      splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (kv_dtype) {
    case kF32:
      err = Geometry<float>(head_dim, page_size, t_pages, splits, geo);
      break;
    case kBF16:
      err = Geometry<bf16>(head_dim, page_size, t_pages, splits, geo);
      break;
    default:
      err = Geometry<int8_t>(head_dim, page_size, t_pages, splits, geo);
      break;
  }
  return static_cast<int>(err);
}

const char* BlockDecodeErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
