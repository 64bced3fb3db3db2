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
// What it still leaves: two launches per call (three for a bfloat16
// cache, below; the combine is ~1 us), and the scan of a row's paddings
// is repeated by each of its N * splits blocks (a few KB each, from L2).
//
// A bfloat16 cache (`kv_cache_dtype='bfloat16'`). The reference rounds
// each probability to bfloat16 before P.V (`p.astype(v_page.dtype)`), and
// it rounds p = exp(s - M_j), where M_j is the running max of the scores
// through the end of the slot's page j. bfloat16 rounding is relative and
// exp(M_j - m) is not a power of two, so p taken against any other max (a
// tile's, a split's) rounds to other values: to round where the reference
// does, a slot needs M_j, the max of every live score before it in the
// row, which the one-pass split kernel never sees. So the bfloat16 cache
// takes two passes of the same split design, with the same tiles and
// splits (a tile keeps its 8 KB of K or of V, so it holds twice the
// slots, kTs = min(128, 4096 / H); each 16-byte cp.async carries 8
// values, widened to float32 when read from shared memory):
//  a. `kScores`: each split streams its K tiles and writes the scores
//     of its slots (NEG_INF where masked) to a float32 scratch [B * N, S],
//     and split 0 the row's first live slot.
//  b. `kValues`: each split takes the max of the row's scores before its
//     first tile (from L2), then per tile loads the scores from the tile's
//     first slot to the end of its last page, takes their running max with
//     a warp scan, and gives slot i the reference's p_i = exp(s_i - M_j),
//     rounded to bfloat16. It accumulates against the tile's last M
//     (acc += R(p_i) exp(M_j - M_tile) v_i, l takes the unrounded p_i) and
//     streams only V tiles.
// The combine is the float32 path's. Kernel and reference then round the
// same p whenever they compute the same score; they differ in the float32
// sums only. Bytes bound it at 2 per element; the scores add 8 bytes per
// live (slot, head), the prefix maxima a few KB per block from L2.
//
// Limits (the Python wrapper raises outside them): head dim 4..128 with
// H / 4 a power of two (8..128 for bfloat16, so that a 16-byte copy never
// spans two slots), all tensors contiguous, float32 q and paddings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kTileFloats = 2048;  // K (and V) floats of one tile (8 KB)
constexpr int kMaxTs = 128;        // slots of one tile, at most
constexpr int kMaxSpan = 2 * kMaxTs;  // a tile's slots to its last page end
constexpr int kStages = 3;
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

// What one launch of the split kernel does: the float32 cache's one pass,
// or the bfloat16 cache's two (see the header).
enum Pass { kFused, kScores, kValues };

template <typename T>
__device__ __forceinline__ int TileSlots(int head_dim) {
  return min(kMaxTs, kTileFloats * static_cast<int>(sizeof(float) /
                                                    sizeof(T)) / head_dim);
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

// The first live slot of a row in [0, t_eff], or t_eff + 1 if none.
__device__ int FirstLiveSlot(const float* pad_row, int t_eff, int* red) {
  if (pad_row == nullptr) return 0;
  int lo = t_eff + 1;
  for (int base = 0; base <= t_eff; base += 4 * kThreads) {
    bool live[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)  // four independent loads in flight
      live[u] = Keep(pad_row, base + u * kThreads + threadIdx.x, t_eff);
#pragma unroll
    for (int u = 3; u >= 0; --u)
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

// The max of x[begin, end) over the block (every thread gets it).
__device__ float BlockMax(const float* x, int begin, int end, float* red) {
  float mx = kNegInf;
  for (int i = begin + threadIdx.x; i < end; i += kThreads)
    mx = fmaxf(mx, x[i]);
  mx = WarpMax(mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  return mx;
}

// Warp 0 writes the inclusive running max of x[0, n) (n <= kMaxSpan) to
// out[0, n).
__device__ void WarpPrefixMax(const float* x, int n, float* out) {
  constexpr int kPer = kMaxSpan / 32;
  const int lane = threadIdx.x & 31;
  float run[kPer];
  float mx = kNegInf;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane * kPer + u;
    mx = fmaxf(mx, i < n ? x[i] : kNegInf);
    run[u] = mx;
  }
  float incl = mx;  // scan of the lanes' maxima
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = fmaxf(incl, y);
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = kNegInf;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane * kPer + u < n) out[lane * kPer + u] = fmaxf(before, run[u]);
}

// One (row x head, split) block. kFused: the float32 pass (scores, tile
// softmax, P.V); kScores: scores to `scores` (and the first live slot to
// `first_live`); kValues: the reference's page-max softmax from `scores`
// and P.V. kFused and kValues write their (acc[H], m, l) to `partial`.
template <typename T, Pass kPass>
__global__ void __launch_bounds__(kThreads) FlashDecodeSplitKernel(
    const float* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const float* __restrict__ pad,
    float* __restrict__ partial, float* __restrict__ scores,
    int* __restrict__ first_live, int seq_len, int num_heads, int head_dim,
    int time_step, int page_size) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVec = 16 / sizeof(T);  // values of one 16-byte copy
  constexpr bool kReadK = kPass != kValues;
  constexpr bool kReadV = kPass != kScores;
  const int h = head_dim;
  const int ts = TileSlots<T>(h);
  float* kv = smem;                             // [kStages][2][kTileFloats]
  float* s_sh = kv + kStages * 2 * kTileFloats;  // [kMaxTs] scores
  float* p_sh = s_sh + kMaxTs;                  // [kMaxTs] probabilities
  float* keep_sh = p_sh + kMaxTs;               // [kStages][kMaxTs]
  float* red = keep_sh + kStages * kMaxTs;      // [kThreads]
  float* span_sh = red + kThreads;              // [kMaxSpan] kValues scores
  float* pm_sh = span_sh + kMaxSpan;            // [kMaxSpan] their run max

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
  float* s_row = scores + static_cast<size_t>(bn) * seq_len;  // kScores/kValues
  const int t_eff = min(time_step, seq_len - 1);

  // this split's tiles of the live range [lo, t_eff]
  int first = 0, tile_begin = 0, tile_end = 0;
  if (t_eff >= 0) {
    int lo;
    if constexpr (kPass == kValues) {
      lo = first_live[bn];
    } else {
      lo = FirstLiveSlot(pad_row, t_eff, reinterpret_cast<int*>(red));
      if (kPass == kScores && split == 0 && tid == 0) first_live[bn] = lo;
    }
    if (lo <= t_eff) {
      first = lo / ts;
      const int nt = t_eff / ts - first + 1;
      tile_begin = first + static_cast<int>(
          static_cast<long long>(split) * nt / splits);
      tile_end = first + static_cast<int>(
          static_cast<long long>(split + 1) * nt / splits);
    }
  }

  const int g = h / 4;              // lanes of one slot's dot product
  const int glane = tid % g;
  const float4 qv = reinterpret_cast<const float4*>(
      q + static_cast<size_t>(bn) * h)[glane];
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
        if (kReadK) CpAsync16(ks + kVec * c, k_cache + off, keep);
        if (kReadV) CpAsync16(vs + kVec * c, v_cache + off, keep);
        if (c % gc == 0) keep_sh[stage * kMaxTs + p] = keep ? 1.f : 0.f;
      }
    }
    CpAsyncCommit();
  };

  float m = kNegInf, l = 0.f, acc = 0.f;
  // kValues: the running max of the row's scores before the current tile
  float m_before = kNegInf;
  if (kPass == kValues && tile_begin < tile_end)
    m_before = BlockMax(s_row, first * ts, tile_begin * ts, red);
  for (int i = 0; i < kStages - 1; ++i) prefetch(tile_begin + i, i);
  for (int tile = tile_begin, j = 0; tile < tile_end; ++tile, ++j) {
    const int stage = j % kStages;
    CpAsyncWait<kStages - 2>();
    __syncthreads();  // tile landed; the previous tile is consumed
    prefetch(tile + kStages - 1, (j + kStages - 1) % kStages);
    const T* ks = reinterpret_cast<const T*>(kv + stage * 2 * kTileFloats);
    const T* vs =
        reinterpret_cast<const T*>(kv + (stage * 2 + 1) * kTileFloats);
    const int base = tile * ts;
    if constexpr (kPass != kValues) {
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
    }
    if constexpr (kPass == kScores) {
      for (int p = tid; p < ts && base + p <= t_eff; p += kThreads)
        s_row[base + p] = s_sh[p];
      continue;  // the next tile's first barrier orders the s_sh reuse
    }
    if constexpr (kPass == kFused) {
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
    }
    if constexpr (kPass == kValues) {
      // the scores from the tile's first slot to the end of the page of
      // its last live slot, and their running max
      const int last = min(base + ts, t_eff + 1) - 1;
      const int span =
          min((last / page_size + 1) * page_size, t_eff + 1) - base;
      for (int i = tid; i < span; i += kThreads) span_sh[i] = s_row[base + i];
      __syncthreads();
      if (tid < 32) WarpPrefixMax(span_sh, span, pm_sh);
      __syncthreads();
      // slot base + p takes M = the running max through its page's end
      const float m_tile = fmaxf(m_before, pm_sh[span - 1]);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxTs / 32; ++i) {
        const int p = lane + 32 * i;
        float w = 0.f;
        if (p < ts && base + p <= t_eff) {
          const int slot = base + p;
          const int page_end =
              min((slot / page_size + 1) * page_size, t_eff + 1);
          const float m_j = fmaxf(m_before, pm_sh[page_end - 1 - base]);
          // all-masked-so-far: exp(s - m_j) would turn masked slots into 1
          const float m_safe = m_j <= kNegInf * 0.5f ? 0.f : m_j;
          const float pr = expf(span_sh[p] - m_safe);
          const float e = expf(m_j - m_tile);  // 1 when m_j is the tile's
          w = Kv<T>::RoundP(pr) * e;
          psum += pr * e;
        }
        if (tid < 32 && p < ts) p_sh[p] = w;
      }
      psum = WarpSum(psum);
      const float alpha = expf(m - m_tile);
      l = alpha * l + psum;
      m = m_tile;
      acc *= alpha;
      m_before = fmaxf(m_before, pm_sh[min(ts, span) - 1]);
    }
    if constexpr (kPass != kScores) {
      __syncthreads();  // p_sh is written
      // kFused rounds nothing (float32); kValues rounded above
      for (int p = part; p < ts; p += parts)
        acc = fmaf(p_sh[p], Kv<T>::Load(vs, p * h + d, 0.f),
                   acc);  // masked: 0 x 0
    }
  }
  CpAsyncWait<0>();  // the prologue's groups of an empty split
  if constexpr (kPass == kScores) return;

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
// nothing live has every m_s = NEG_INF and l_s = 0: exact zeros.
__global__ void __launch_bounds__(kThreads) FlashDecodeCombineKernel(
    const float* __restrict__ partial, float* __restrict__ out, int head_dim,
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
  out[static_cast<size_t>(bn) * h + tid] = acc / fmaxf(l, 1e-20f);
}

size_t SplitSmemBytes() {
  return sizeof(float) *
         (kStages * 2 * kTileFloats + 2 * kMaxTs + kStages * kMaxTs +
          kThreads + 2 * kMaxSpan);
}

// Opts a split kernel into its dynamic shared memory (above the 48 KB
// default) once per device and instantiation, not on every launch: the
// attribute call costs host time, and the decode step that calls this op
// is bound by the host's enqueue. Two threads racing here both set the
// same value, which is harmless.
template <typename T, Pass kPass>
cudaError_t AllowSmemOnce() {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(FlashDecodeSplitKernel<T, kPass>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SplitSmemBytes()));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <typename T, Pass kPass>
cudaError_t LaunchSplit(const float* q, const void* k_cache,
                        const void* v_cache, const float* pad,
                        float* partial, float* scores, int* first_live,
                        unsigned rows, int seq_len, int num_heads,
                        int head_dim, int time_step, int splits,
                        int page_size, cudaStream_t s) {
  cudaError_t err = AllowSmemOnce<T, kPass>();
  if (err != cudaSuccess) return err;
  FlashDecodeSplitKernel<T, kPass><<<dim3(rows, splits), kThreads,
                                     SplitSmemBytes(), s>>>(
      q, static_cast<const T*>(k_cache), static_cast<const T*>(v_cache), pad,
      partial, scores, first_live, seq_len, num_heads, head_dim, time_step,
      page_size);
  return cudaGetLastError();
}

bool BadHeadDim(int head_dim, int kv_dtype) {
  const int g = head_dim / 4;
  return head_dim < (kv_dtype == kBF16 ? 8 : 4) || head_dim > kMaxHeadDim ||
         head_dim % 4 != 0 || (g & (g - 1)) != 0;
}

template <typename T, Pass kPass>
cudaError_t Occupancy(int* blocks_per_sm) {
  cudaError_t err = AllowSmemOnce<T, kPass>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, FlashDecodeSplitKernel<T, kPass>, kThreads,
      SplitSmemBytes());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launches (0 = ok).
// q/out [B, N, H] float32; k_cache/v_cache [B, S, N, H] of `kv_dtype`
// (KvDtype: float32 or bfloat16); pad [B, S] float32 or null; scratch:
// float32, FlashDecodeScratchFloats(...) of them; all contiguous on one
// device.
int FlashDecode(const float* q, const void* k_cache, const void* v_cache,
                const float* pad, float* out, float* scratch, int batch,
                int seq_len, int num_heads, int head_dim, int time_step,
                int splits, int page_size, int kv_dtype, void* stream) {
  if (batch <= 0) return 0;
  if (BadHeadDim(head_dim, kv_dtype) || seq_len <= 0 || splits < 1 ||
      splits > 65535 || page_size < 1 || page_size > kMaxTs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>(batch) * num_heads;
  // scratch: the splits' (acc, m, l), then (bfloat16) the scores [rows,
  // S] and the rows' first live slots
  float* partial = scratch;
  float* scores = partial + static_cast<size_t>(rows) * splits *
                                (head_dim + 2);
  int* first_live =
      reinterpret_cast<int*>(scores + static_cast<size_t>(rows) * seq_len);
  cudaError_t err;
  switch (kv_dtype) {
    case kF32:
      err = LaunchSplit<float, kFused>(
          q, k_cache, v_cache, pad, partial, nullptr, nullptr, rows, seq_len,
          num_heads, head_dim, time_step, splits, page_size, s);
      break;
    case kBF16:
      err = LaunchSplit<__nv_bfloat16, kScores>(
          q, k_cache, v_cache, pad, partial, scores, first_live, rows,
          seq_len, num_heads, head_dim, time_step, splits, page_size, s);
      if (err == cudaSuccess)
        err = LaunchSplit<__nv_bfloat16, kValues>(
            q, k_cache, v_cache, pad, partial, scores, first_live, rows,
            seq_len, num_heads, head_dim, time_step, splits, page_size, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  FlashDecodeCombineKernel<<<rows, kThreads, 0, s>>>(partial, out, head_dim,
                                                     splits);
  return static_cast<int>(cudaGetLastError());
}

// Floats of FlashDecode's scratch for these sizes and `kv_dtype`.
long long FlashDecodeScratchFloats(int batch, int seq_len, int num_heads,
                                   int head_dim, int splits, int kv_dtype) {
  const long long rows = static_cast<long long>(batch) * num_heads;
  long long n = rows * splits * (head_dim + 2);
  if (kv_dtype == kBF16) n += rows * seq_len + rows;  // scores, first slots
  return n;
}

// The split kernel's launch geometry for `kv_dtype`: threads and dynamic
// shared memory per block, and the blocks resident on one SM (for a
// bfloat16 cache, the fewer of its two passes'). Returns the cudaError_t.
int FlashDecodeGeometry(int kv_dtype, int* threads, int* smem_bytes,
                        int* blocks_per_sm) {
  *threads = kThreads;
  *smem_bytes = static_cast<int>(SplitSmemBytes());
  cudaError_t err;
  switch (kv_dtype) {
    case kF32:
      err = Occupancy<float, kFused>(blocks_per_sm);
      break;
    case kBF16: {
      int values = 0;
      err = Occupancy<__nv_bfloat16, kScores>(blocks_per_sm);
      if (err == cudaSuccess)
        err = Occupancy<__nv_bfloat16, kValues>(&values);
      if (err == cudaSuccess) *blocks_per_sm = min(*blocks_per_sm, values);
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
