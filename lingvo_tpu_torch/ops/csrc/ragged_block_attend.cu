// Packed-token ragged paged attention for Hopper (sm_90a): float32,
// bfloat16 and int8 page pools, float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_RaggedAttendKernel` of
// lingvo_tpu/ops/ragged_block_attend.py (pallas_call in
// `_PallasRaggedAttend`; public entry `RaggedAttend`). It computes the
// same function, not the same blocks: token t of the packed axis belongs
// to block-table row row_of[t] and attends over that row's KV slots
// [0, q_end[t]) with a float32 online softmax (the reference
// `_PageAttend`: running m / l / acc, the m_safe guard, acc / max(l, 1e-20)),
// under the optional 64-bit in-step ancestor mask (`_AncestorOk`).
//
// Bound: the work is a gather, far below the card's ridge point (4 flops
// per K/V element read), so it is bounded by bytes: each row's live K/V
// slots (up to its furthest q_end) and live table entries read once, plus
// q read and out written once, over 3.35 TB/s on an H100 SXM. The first
// design (one block per (token, head)) re-read a row's pages once per
// prefill token and walked a decode row's 50-odd pages in series in one
// block; this one is about reading each page once per tile and spreading
// a long row over many blocks.
//
// Design.
//  1. Tiles. `RaggedScheduleKernel` (one block) cuts the packed axis into
//     tiles of at most kQ = 16 consecutive live tokens of one row: a tile
//     starts at every multiple of kQ, where row_of changes and where a
//     padding token (q_end <= 0) ends. So a tile never holds two rows, and
//     nothing depends on a row's tokens being contiguous (a row whose
//     tokens are scattered gets more tiles). Padding tokens get no tile.
//  2. Split KV. A tile's live pages (up to its tokens' furthest q_end)
//     are cut into nsplit page ranges in order, nsplit = ceil(live slots /
//     split_slots) capped by max_splits and by the pages (the Python
//     `TileSchedule` mirrors this rule and passes the numbers), so a
//     decode row of 800 slots spreads over 8 blocks per head. Work items
//     (tile, split) are written to a workspace with their count; no host
//     sync is needed.
//  3. The main kernel is persistent: as many blocks as fit on the card
//     take (item, head) units from an atomic counter. A unit loads its
//     tile's q [kQ, H] and per-token q_end / q_start / ancestor masks, and
//     a bitmap of the slots that any of its tokens keeps (a masked slot of
//     every token is never loaded). It streams its pages in chunks of up
//     to C = min(P, 64, 4096 / H) slots, K chunks then V chunks of each
//     page, through a 3-stage cp.async ring (a slot no token keeps is
//     zero-filled without a read, and so is its scale). Scores, per group
//     of 16 slots of a chunk: 16 patch groups of 8 lanes each own 4 tokens
//     x 4 slots; lane hq sums those 16 dots over the float4 columns hq +
//     8 i of h (8 loads of 16 bytes per 64 FFMA, a quarter-warp's reads on
//     consecutive float4s) and shuffles halve them over the 8 lanes, each
//     lane keeping 2. A patch group whose tokens are past the tile's
//     length skips its dots, and a warp whose acc tokens are skips P.V, so
//     a one-token decode tile does not pay for 16. After a page's last K
//     chunk each token's page max updates its running max m, the
//     probabilities p go to shared memory (rounded by `Kv<T>::RoundP`), l
//     takes the unrounded p; then P.V: thread (tg, lane) owns tokens 4 tg
//     .. 4 tg + 3 and float4 columns lane + 32 c of acc, reading p as a
//     float4 over its tokens and V rows as float4s. The unit's table
//     entries are read once into shared memory at its start, so no copy
//     waits on a table read.
//  4. A tile with one split writes out = acc / max(l, 1e-20). Otherwise
//     each split writes (acc, m, l) per token to a scratch tensor, and
//     the split that finishes last (a per-(tile, head) counter, after a
//     fence) merges all splits in split order and writes out. The merge
//     order is fixed, so two calls give the same bits.
//  5. Padding tokens (q_end <= 0) get exact zeros from the main kernel's
//     blocks before they take work; they read no page.
// The schedule and the main kernel count as one launch.
// What it leaves: each unit pays its setup (item, q and table reads, the
// first chunk's latency) and a split its fence and merge, between pages
// that take little math; a one-token bfloat16 tile walks its row's pages
// in series; the products run on the CUDA cores.
//
// Pool storage: the kernel is a template on it and reads K and V only
// through `Kv` (kv_storage.cuh: float32, bfloat16 with p rounded to
// bfloat16 before P.V, int8 dequantized on load with __fmul_rn, so the
// int8 kernel equals the float32 one on the pre-dequantized pool bit for
// bit: both take the same tiles, splits and chunks). A bfloat16 pool
// rounds p at the running max through the end of the slot's page, which
// a KV split would break, so bfloat16 tiles are never split (allow_split
// 0): such a tile walks its row's pages in one block. A masked slot's
// scale is never loaded (dead scales may hold NaN), just as its K/V is
// never loaded. Bound: bytes as above, at 2 bytes per bfloat16 element,
// or 1 byte per int8 element plus 4 per live (slot, head) of each sidecar.
//
// q and out: float32, or bfloat16 under fprop_dtype=bfloat16 (`Act`,
// kv_storage.cuh: q widened on load, out rounded once at the division), a
// second template parameter; nothing else changes with it.
//
// Limits (the Python wrapper raises outside them): page_size 8..128,
// head dim a multiple of 4 up to 256, all tensors contiguous and 16-byte
// aligned, float32 or bfloat16 q, at most kMaxTokens packed tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 16;               // tokens of a tile
constexpr int kMaxHeadDim = 256;
constexpr int kMinPageSize = 8;
constexpr int kMaxPageSize = 128;
constexpr int kMaxChunk = 64;        // slots of a chunk, at most
constexpr int kChunkElems = 4096;    // K (or V) elements of a chunk, at most
constexpr int kStages = 3;
constexpr int kItemInts = 8;         // tok0, len, row, pb, pe, split, nsplit, tile
constexpr int kMaxTokens = 1 << 16;
constexpr int kSchedThreads = 1024;
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

__device__ __forceinline__ bool AncestorOk(int slot, int q_start, int lo,
                                           int hi) {
  // bit clip(slot - q_start, 0, 63) of (lo | hi << 32); chain rows carry
  // lo = hi = -1, so every bit reads 1
  const int cc = min(max(slot - q_start, 0), 63);
  const unsigned word = static_cast<unsigned>(cc < 32 ? lo : hi);
  const int sh = cc < 32 ? cc : cc - 32;
  return ((word >> sh) & 1u) == 1u;
}

__host__ __device__ inline int ChunkSlots(int page_size, int head_dim) {
  int c = kChunkElems / head_dim;
  c = c < kMaxChunk ? c : kMaxChunk;
  return c < page_size ? c : page_size;
}

// ---- the schedule ----------------------------------------------------------

// Inclusive sum over the block of one int per thread (kSchedThreads).
__device__ int BlockInclusiveSum(int x, int* scratch /* [32] */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = scratch[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? scratch[warp - 1] : 0;
  __syncthreads();   // scratch is reused by the next call
  return x + before;
}

// One block: ws[0] = the number of work items, ws[1] = 0 (the main
// kernel's unit counter), items from ws + 2 (kItemInts each, at most
// max_items), and the split counters of every tile and head zeroed.
__global__ void __launch_bounds__(kSchedThreads) RaggedScheduleKernel(
    const int* __restrict__ row_of, const int* __restrict__ q_end,
    int num_tokens, int num_rows, int t_pages, int page_size,
    int split_slots, int max_splits, int allow_split, int num_heads,
    int* __restrict__ ws, int* __restrict__ counters, int max_items) {
  __shared__ int scratch[32], chunk_total;
  __shared__ int row_sh[kSchedThreads], end_sh[kSchedThreads];
  int* items = ws + 2;
  int tiles_before = 0, items_before = 0;
  for (int base = 0; base < num_tokens; base += kSchedThreads) {
    // this chunk's row_of and q_end, one load each (a tile never crosses
    // a multiple of kQ, so none crosses a chunk)
    const int t = base + threadIdx.x;
    const int i = threadIdx.x;
    row_sh[i] = t < num_tokens ? row_of[t] : -1;
    end_sh[i] = t < num_tokens ? q_end[t] : 0;
    __syncthreads();
    const bool live = end_sh[i] > 0;
    const bool first = live && (t % kQ == 0 || end_sh[i - 1] <= 0 ||
                                row_sh[i] != row_sh[i - 1]);
    int len = 0, max_end = 0, pages = 0, nsplit = 0;
    if (first) {
      for (int u = i; u < kSchedThreads && (u == i || u % kQ != 0) &&
                      end_sh[u] > 0 && row_sh[u] == row_sh[i]; ++u) {
        max_end = max(max_end, end_sh[u]);
        ++len;
      }
      pages = min((max_end + page_size - 1) / page_size, t_pages);
      const int want = (pages * page_size + split_slots - 1) / split_slots;
      nsplit = allow_split ? max(1, min(want, min(max_splits, pages))) : 1;
    }
    // tiles in the low 16 bits, items above (a chunk holds at most
    // kSchedThreads tiles and kSchedThreads * max_splits items)
    const int packed = (first ? 1 : 0) | (nsplit << 16);
    const int incl = BlockInclusiveSum(packed, scratch);
    const int excl = incl - packed;
    if (first) {
      const int tile = tiles_before + (excl & 0xffff);
      const int item0 = items_before + (excl >> 16);
      const int row = min(max(row_sh[i], 0), num_rows - 1);
      for (int s = 0; s < nsplit && item0 + s < max_items; ++s) {
        int* it = items + static_cast<size_t>(item0 + s) * kItemInts;
        it[0] = t;
        it[1] = len;
        it[2] = row;
        it[3] = s * pages / nsplit;
        it[4] = (s + 1) * pages / nsplit;
        it[5] = s;
        it[6] = nsplit;
        it[7] = tile;
      }
    }
    if (threadIdx.x == kSchedThreads - 1) chunk_total = incl;
    __syncthreads();
    tiles_before += chunk_total & 0xffff;
    items_before += chunk_total >> 16;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tiles_before * num_heads; i += kSchedThreads)
    counters[i] = 0;
  if (threadIdx.x == 0) {
    ws[0] = min(items_before, max_items);
    ws[1] = 0;
  }
}

// ---- the attention ---------------------------------------------------------

// A block's shared memory, in bytes from its start.
struct Smem {
  int row_bytes;       // a staged K or V slot row: H elements + 16 bytes
  int stage_bytes;     // chunk rows, then the chunk's scales
  int q, ring, s, p, tok, keep, pid, bytes;
};

template <typename T>
__host__ __device__ inline Smem Layout(int head_dim, int page_size,
                                       int t_pages) {
  Smem m;
  const int c = ChunkSlots(page_size, head_dim);
  m.row_bytes = head_dim * static_cast<int>(sizeof(T)) + 16;
  m.stage_bytes = (c * m.row_bytes + c * 4 + 15) / 16 * 16;
  m.q = 0;                                              // [kQ][H + 4] f32
  m.ring = m.q + kQ * (head_dim + 4) * 4;               // kStages stages
  m.s = m.ring + kStages * m.stage_bytes;               // [kQ][P] scores
  m.p = m.s + kQ * page_size * 4;                       // [P][kQ] probs
  m.tok = m.p + page_size * kQ * 4;                     // 7 x [kQ] ints
  m.keep = m.tok + 7 * kQ * 4;                          // slot bitmap
  m.pid = m.keep + (t_pages * page_size + 31) / 32 * 4;  // [t_pages] pages
  m.bytes = m.pid + t_pages * 4 + 16;
  return m;
}

__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float Dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Adds the halves of v[0, 2 kHalf) held by the lanes that differ in bit
// kHalf / 2 of their index: a lane with that bit set keeps the upper half
// (into v[0, kHalf)), the other the lower half.
template <int kHalf>
__device__ __forceinline__ void Halve(float (&v)[16], bool up,
                                      unsigned mask) {
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    const float send = up ? v[e] : v[e + kHalf];
    const float keep = up ? v[e + kHalf] : v[e];
    v[e] = keep + __shfl_xor_sync(mask, send, kHalf / 2);
  }
}

struct Problem {
  int num_tokens, num_heads, head_dim, num_pool_pages, page_size, num_rows,
      t_pages;
};

// kC: float4 columns of acc a lane owns (1 up to H = 128, else 2); Q: the
// type of q and out (`Act`, kv_storage.cuh)
template <typename T, typename Q, int kC>
__global__ void __launch_bounds__(kThreads) RaggedAttendKernel(
    const Q* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_end, const int* __restrict__ q_start,
    const int* __restrict__ anc_lo, const int* __restrict__ anc_hi,
    Q* __restrict__ out, int* __restrict__ ws,
    int* __restrict__ counters, float* __restrict__ part, int max_splits,
    Problem pb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = pb.head_dim, P = pb.page_size, N = pb.num_heads;
  const int h4 = H / 4;
  const Smem lay = Layout<T>(H, P, pb.t_pages);
  const int C = ChunkSlots(P, H);
  const int nc = (P + C - 1) / C;   // chunks per page
  const int ldq = H + 4;
  float* q_sh = reinterpret_cast<float*>(smem + lay.q);
  float* s_sh = reinterpret_cast<float*>(smem + lay.s);   // [kQ][P]
  float* p_sh = reinterpret_cast<float*>(smem + lay.p);   // [P][kQ]
  int* tok_sh = reinterpret_cast<int*>(smem + lay.tok);
  int* end_sh = tok_sh;
  int* start_sh = tok_sh + kQ;
  int* lo_sh = tok_sh + 2 * kQ;
  int* hi_sh = tok_sh + 3 * kQ;
  float* alpha_sh = reinterpret_cast<float*>(tok_sh + 4 * kQ);
  float* m_sh = reinterpret_cast<float*>(tok_sh + 5 * kQ);
  float* l_sh = reinterpret_cast<float*>(tok_sh + 6 * kQ);
  unsigned* keep_sh = reinterpret_cast<unsigned*>(smem + lay.keep);
  int* pid_sh = reinterpret_cast<int*>(smem + lay.pid);
  __shared__ int unit_sh, last_sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t slot_stride = static_cast<size_t>(N) * H;

  // padding tokens: exact zeros, no page read
  for (int t = blockIdx.x; t < pb.num_tokens; t += gridDim.x) {
    if (q_end[t] > 0) continue;
    Q* o = out + t * slot_stride;
    for (int i = tid; i < static_cast<int>(slot_stride / 4); i += kThreads)
      Act<Q>::Store4(o, i, make_float4(0.f, 0.f, 0.f, 0.f));
  }

  const int n_units = ws[0] * N;
  const int* items = ws + 2;
  // score patch (per 16-slot group of a chunk): tokens 4 tq + {0..3} x
  // slots 4 sq + {0..3}, float4 columns hq + 8 i of h
  const int hq = lane & 7, pg = tid >> 3, tq = pg & 3, sq = pg >> 2;
  const unsigned gmask = 0xffu << (lane & 24);   // pg's 8 lanes
  // acc patch: tokens 4 tg + {0..3} x float4 columns lane + 32 c
  const int tg = tid >> 5;
  // softmax: token tid / 8, slots tid % 8 + 8 k of a page
  const int st = tid >> 3, ss = tid & 7;
  const bool vec16 = (H * static_cast<int>(sizeof(T))) % 16 == 0;
  const int piece = vec16 ? 16 : 4;
  const int row_pieces = H * static_cast<int>(sizeof(T)) / piece;
  // a thread's share of a chunk's copies, fixed once where the pieces of a
  // row divide the block (else a loop that divides)
  const int copy_piece = tid % row_pieces, copy_row = tid / row_pieces;
  const int copy_step = kThreads % row_pieces == 0 ? kThreads / row_pieces
                                                   : 0;

  // units come from an atomic counter; thread 0 takes the next one while
  // the block works on this one
  int next_unit = tid == 0 ? atomicAdd(ws + 1, 1) : 0;
  for (;;) {
    __syncthreads();   // the previous unit is done with shared memory
    if (tid == 0) unit_sh = next_unit;
    __syncthreads();
    const int unit = unit_sh;
    if (unit >= n_units) break;
    if (tid == 0) next_unit = atomicAdd(ws + 1, 1);
    const int* it = items + static_cast<size_t>(unit / N) * kItemInts;
    const int head = unit % N;
    const int tok0 = it[0], len = it[1], row = it[2], pg0 = it[3],
              pg1 = it[4], split = it[5], nsplit = it[6], tile = it[7];
    const int* table = tables + static_cast<size_t>(row) * pb.t_pages;

    if (tid < kQ) {
      const bool ok = tid < len;
      end_sh[tid] = ok ? q_end[tok0 + tid] : 0;
      start_sh[tid] = ok ? q_start[tok0 + tid] : 0;
      lo_sh[tid] = ok ? anc_lo[tok0 + tid] : -1;
      hi_sh[tid] = ok ? anc_hi[tok0 + tid] : -1;
    }
    for (int i = tid; i < kQ * h4; i += kThreads) {
      const int t = i / h4, c = i % h4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < len)
        v = Act<Q>::Load4(
            q + (tok0 + t) * slot_stride + static_cast<size_t>(head) * H, c);
      *reinterpret_cast<float4*>(q_sh + t * ldq + 4 * c) = v;
    }
    // this unit's live table entries, clamped (the entries past them are
    // never read)
    for (int j = pg0 + tid; j < pg1; j += kThreads)
      pid_sh[j] = min(max(table[j], 0), pb.num_pool_pages - 1);
    __syncthreads();
    // the slots of this unit's pages that some token of the tile keeps,
    // one bit each (a warp's ballot is one aligned word)
    const int slot0 = pg0 * P, slot1 = pg1 * P;
    for (int base = slot0 / 32 * 32; base < slot1; base += kThreads) {
      const int slot = base + tid;
      bool any = false;
      for (int t = 0; t < len && !any && slot < slot1; ++t)
        any = slot < end_sh[t] &&
              AncestorOk(slot, start_sh[t], lo_sh[t], hi_sh[t]);
      const unsigned bits = __ballot_sync(0xffffffffu, any);
      if (lane == 0 && slot < slot1) keep_sh[slot >> 5] = bits;
    }
    __syncthreads();
    auto kept = [&](int slot) {
      return ((keep_sh[slot >> 5] >> (slot & 31)) & 1u) != 0;
    };

    const int nsteps = (pg1 - pg0) * 2 * nc;
    // step: page pg0 + step / (2 nc); K chunks, then V chunks
    auto issue = [&](int step) {
      if (step < nsteps) {
        const int j = pg0 + step / (2 * nc), r = step % (2 * nc);
        const bool is_v = r >= nc;
        const int c0 = (is_v ? r - nc : r) * C;
        const int cn = min(C, P - c0);
        const int pid = pid_sh[j];
        const T* src = (is_v ? v_pool : k_pool) +
                       (static_cast<size_t>(pid) * P + c0) * slot_stride +
                       static_cast<size_t>(head) * H;
        unsigned char* dst = smem + lay.ring + (step % kStages) *
                                                   lay.stage_bytes;
        auto copy = [&](int sr, int pc) {
          const bool ok = kept(j * P + c0 + sr);
          const unsigned char* g = reinterpret_cast<const unsigned char*>(
              src + (ok ? sr : 0) * slot_stride) + pc * piece;
          void* d = dst + sr * lay.row_bytes + pc * piece;
          if (vec16)
            CpAsync16(d, g, ok);
          else
            CpAsync4(d, g, ok);
        };
        if (copy_step > 0) {   // this thread's piece of every copy_step-th row
          for (int sr = copy_row; sr < cn; sr += copy_step)
            copy(sr, copy_piece);
        } else {
          for (int i = tid; i < cn * row_pieces; i += kThreads)
            copy(i / row_pieces, i % row_pieces);
        }
        const float* scale = is_v ? v_scale : k_scale;
        if (scale != nullptr && tid < cn) {
          const bool ok = kept(j * P + c0 + tid);
          CpAsync4(dst + C * lay.row_bytes + 4 * tid,
                   scale + (static_cast<size_t>(pid) * N + head) * P + c0 +
                       (ok ? tid : 0),
                   ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

    float m_run = kNegInf, l_run = 0.f;   // token st's, in its 8 lanes
    float4 acc[4][kC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
    for (int st0 = 0; st0 < kStages - 1; ++st0) issue(st0);
    for (int step = 0; step < nsteps; ++step) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();   // this chunk landed; the one refilled is free
      issue(step + kStages - 1);
      const int j = pg0 + step / (2 * nc), r = step % (2 * nc);
      const unsigned char* stage =
          smem + lay.ring + (step % kStages) * lay.stage_bytes;
      const float* scales = reinterpret_cast<const float*>(
          stage + C * lay.row_bytes);
      if (r < nc) {
        // scores of chunk r of page j for every token of the tile
        const int c0 = r * C, cn = min(C, P - c0);
        for (int g = 0; 16 * g < cn; ++g) {
          // slot group g: 16 slots; lanes hq of patch group pg sum the
          // 4 x 4 dots of tokens 4 tq + i and slots 16 g + 4 sq + j over
          // their float4 columns of h, then halve them over the 8 lanes
          float v[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = 0.f;
          const bool busy = 4 * tq < len;   // the same for the 8 lanes
          if (busy) {
            const T* krow[4];
            float sc[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int sr = min(16 * g + 4 * sq + jj, cn - 1);
              krow[jj] = reinterpret_cast<const T*>(stage + sr * lay.row_bytes);
              sc[jj] = Kv<T>::Scale(scales, sr);
            }
            const float* qrow = q_sh + 4 * tq * ldq;
            for (int c = hq; c < h4; c += 8) {
              float4 qv[4], kv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(qrow + i * ldq + 4 * c);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                kv[jj] = Kv<T>::Load4(krow[jj], c, sc[jj]);
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  v[4 * i + jj] = Dot4(qv[i], kv[jj], v[4 * i + jj]);
            }
            // lane hq keeps dots 2 hq and 2 hq + 1 of the 16
            Halve<8>(v, (hq & 4) != 0, gmask);
            Halve<4>(v, (hq & 2) != 0, gmask);
            Halve<2>(v, (hq & 1) != 0, gmask);
          }
          const int t = 4 * tq + (hq >> 1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sr = 16 * g + 4 * sq + 2 * (hq & 1) + e;
            if (sr >= cn) continue;
            const int slot = j * P + c0 + sr;
            const bool keep = busy && slot < end_sh[t] &&
                              AncestorOk(slot, start_sh[t], lo_sh[t],
                                         hi_sh[t]);
            s_sh[t * P + c0 + sr] = keep ? v[e] : kNegInf;
          }
        }
        if (r == nc - 1) {
          __syncthreads();   // the page's scores are in
          // the page's online-softmax step for token st (8 lanes)
          float m_cur = kNegInf;
          for (int c = ss; c < P; c += 8) m_cur = fmaxf(m_cur, s_sh[st * P + c]);
          for (int o = 4; o > 0; o >>= 1)
            m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
          const float m_new = fmaxf(m_run, m_cur);
          // all-masked-so-far: exp(s - m_new) would turn masked slots into 1
          const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
          const float alpha = expf(m_run - m_new);
          float psum = 0.f;
          for (int c = ss; c < P; c += 8) {
            const float pp = expf(s_sh[st * P + c] - m_safe);
            psum += pp;
            p_sh[c * kQ + st] = Kv<T>::RoundP(pp);
          }
          for (int o = 4; o > 0; o >>= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, o);
          l_run = alpha * l_run + psum;
          m_run = m_new;
          if (ss == 0) alpha_sh[st] = alpha;
        }
      } else {
        const int c0 = (r - nc) * C, cn = min(C, P - c0);
        if (4 * tg >= len) continue;   // the warp's tokens are past the tile
        if (r == nc) {   // the page's first V chunk: rescale acc
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = alpha_sh[4 * tg + i];
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              acc[i][c].x *= a;
              acc[i][c].y *= a;
              acc[i][c].z *= a;
              acc[i][c].w *= a;
            }
          }
        }
        int col[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) col[c] = min(lane + 32 * c, h4 - 1);
        for (int sr = 0; sr < cn; ++sr) {
          const float4 pv = *reinterpret_cast<const float4*>(
              p_sh + (c0 + sr) * kQ + 4 * tg);
          const T* vrow = reinterpret_cast<const T*>(stage + sr * lay.row_bytes);
          const float sc = Kv<T>::Scale(scales, sr);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float4 v = Kv<T>::Load4(vrow, col[c], sc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][c].x = fmaf(pr[i], v.x, acc[i][c].x);
              acc[i][c].y = fmaf(pr[i], v.y, acc[i][c].y);
              acc[i][c].z = fmaf(pr[i], v.z, acc[i][c].z);
              acc[i][c].w = fmaf(pr[i], v.w, acc[i][c].w);
            }
          }
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    if (ss == 0) {
      m_sh[st] = m_run;
      l_sh[st] = l_run;
    }
    __syncthreads();
    if (nsplit == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
        if (t >= len) continue;
        const float denom = fmaxf(l_sh[t], 1e-20f);
        Q* o = out + (tok0 + t) * slot_stride + static_cast<size_t>(head) * H;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (lane + 32 * c >= h4) continue;
          const float4 a = acc[i][c];
          Act<Q>::Store4(o, lane + 32 * c,
                         make_float4(a.x / denom, a.y / denom, a.z / denom,
                                     a.w / denom));
        }
      }
      continue;
    }
    // a split: its (acc, m, l) per token, then the last split merges
    auto part_at = [&](int t, int s) {
      return part + ((static_cast<size_t>(tok0 + t) * max_splits + s) * N +
                     head) * (H + 4);
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * tg + i;
      if (t >= len) continue;
      float* pt = part_at(t, split);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (lane + 32 * c < h4)
          reinterpret_cast<float4*>(pt)[lane + 32 * c] = acc[i][c];
    }
    if (tid < len) {
      float* pt = part_at(tid, split);
      pt[H] = m_sh[tid];
      pt[H + 1] = l_sh[tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_sh = atomicAdd(counters + tile * N + head, 1) == nsplit - 1;
    __syncthreads();
    if (!last_sh) continue;
    __threadfence();
    for (int i = tid; i < len * h4; i += kThreads) {
      const int t = i / h4, c = i % h4;
      float m = kNegInf, l = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < nsplit; ++s) {
        const float* pt = part_at(t, s);
        const float ms = __ldcg(pt + H), ls = __ldcg(pt + H + 1);
        const float4 as = __ldcg(reinterpret_cast<const float4*>(pt) + c);
        const float m_new = fmaxf(m, ms);
        const float x = expf(m - m_new), y = expf(ms - m_new);
        l = l * x + ls * y;
        a.x = a.x * x + as.x * y;
        a.y = a.y * x + as.y * y;
        a.z = a.z * x + as.z * y;
        a.w = a.w * x + as.w * y;
        m = m_new;
      }
      const float denom = fmaxf(l, 1e-20f);
      Act<Q>::Store4(out + (tok0 + t) * slot_stride +
                         static_cast<size_t>(head) * H,
                     c, make_float4(a.x / denom, a.y / denom, a.z / denom,
                                    a.w / denom));
    }
  }
}

template <typename T, typename Q, int kC>
int Launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* q_end, const int* q_start, const int* anc_lo,
           const int* anc_hi, void* out, int* ws, int* counters,
           float* part, int max_splits, const Problem& pb, int blocks,
           cudaStream_t stream) {
  auto kernel = RaggedAttendKernel<T, Q, kC>;
  const Smem lay = Layout<T>(pb.head_dim, pb.page_size, pb.t_pages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, lay.bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scale, v_scale, tables, q_end,
      q_start, anc_lo, anc_hi, static_cast<Q*>(out), ws, counters, part,
      max_splits, pb);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for kv_dtype (KvDtype), q_dtype (ActDtype) and kc.
template <typename T>
int LaunchFor(int q_dtype, int kc, const void* q, const void* k_pool,
              const void* v_pool, const float* k_scale, const float* v_scale,
              const int* tables, const int* q_end, const int* q_start,
              const int* anc_lo, const int* anc_hi, void* out, int* ws,
              int* counters, float* part, int max_splits, const Problem& pb,
              int blocks, cudaStream_t stream) {
#define RAGGED_LAUNCH(Q, KC)                                                \
  Launch<T, Q, KC>(q, k_pool, v_pool, k_scale, v_scale, tables, q_end,     \
                   q_start, anc_lo, anc_hi, out, ws, counters, part,       \
                   max_splits, pb, blocks, stream)
  if (q_dtype == kActBF16)
    return kc == 1 ? RAGGED_LAUNCH(__nv_bfloat16, 1)
                   : RAGGED_LAUNCH(__nv_bfloat16, 2);
  return kc == 1 ? RAGGED_LAUNCH(float, 1) : RAGGED_LAUNCH(float, 2);
#undef RAGGED_LAUNCH
}

template <typename T>
const void* FloatQKernel(bool two) {
  return two ? reinterpret_cast<const void*>(RaggedAttendKernel<T, float, 2>)
             : reinterpret_cast<const void*>(RaggedAttendKernel<T, float, 1>);
}

}  // namespace

extern "C" {

// The tile schedule alone (the first of RaggedAttend's two kernels): ws
// int32 [2 + 8 max_items], counters int32 [T * N].
int RaggedSchedule(const int* row_of, const int* q_end, int num_tokens,
                   int num_rows, int t_pages, int page_size, int tile_tokens,
                   int split_slots, int max_splits, int allow_split,
                   int num_heads, int* ws, int* counters, int max_items,
                   void* stream) {
  // (the schedule packs a chunk's item count, at most kSchedThreads *
  // max_splits, above 16 bits of an int)
  if (num_tokens <= 0 || num_tokens > kMaxTokens || tile_tokens != kQ ||
      split_slots <= 0 || max_splits <= 0 || max_splits > 16 ||
      num_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RaggedScheduleKernel<<<1, kSchedThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      row_of, q_end, num_tokens, num_rows, t_pages, page_size, split_slots,
      max_splits, allow_split, num_heads, ws, counters, max_items);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q/out [T, N, H] of `q_dtype` (ActDtype: float32 or bfloat16);
// k_pool/v_pool [NP, P, N, H] of `kv_dtype` (KvDtype); k_scale/v_scale
// [NP, N, P] float32 for int8 pools, else null; tables [B, t_pages];
// row_of/q_end/q_start/anc_lo/anc_hi [T]; all contiguous, on one device.
// Scratch from the wrapper: ws int32 [2 + 8 T max_splits], counters int32
// [T N], part float32 [T max_splits N (H + 4)] (null for bfloat16 pools,
// whose tiles are never split). tile_tokens, split_slots and max_splits
// come from the Python `TileSchedule`'s rule (tile_tokens must be this
// file's kQ); blocks is the persistent grid, RaggedAttendGeometry's
// geo[3] (a launch takes no more than T N max_splits, the most work units
// there can be).
int RaggedAttend(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* row_of, const int* q_end,
                 const int* q_start, const int* anc_lo, const int* anc_hi,
                 void* out, int* ws, int* counters, float* part,
                 int num_tokens, int num_heads, int head_dim,
                 int num_pool_pages, int page_size, int num_rows,
                 int t_pages, int tile_tokens, int split_slots,
                 int max_splits, int kv_dtype, int q_dtype, int blocks,
                 void* stream) {
  if (num_tokens <= 0) return 0;
  if (head_dim > kMaxHeadDim || head_dim % 4 != 0 || blocks <= 0 ||
      (q_dtype != kActF32 && q_dtype != kActBF16) ||
      page_size > kMaxPageSize || page_size < kMinPageSize ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr) ||
      (kv_dtype != kBF16 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_items = num_tokens * max_splits;
  int rc = RaggedSchedule(row_of, q_end, num_tokens, num_rows, t_pages,
                          page_size, tile_tokens, split_slots, max_splits,
                          kv_dtype != kBF16, num_heads, ws, counters,
                          max_items, stream);
  if (rc != 0) return rc;
  const Problem pb{num_tokens, num_heads, head_dim, num_pool_pages,
                   page_size, num_rows, t_pages};
  const int kc = head_dim > 128 ? 2 : 1;
  blocks = min(blocks, max(max_items * num_heads, num_tokens));
  switch (kv_dtype) {
    case kF32:
      return LaunchFor<float>(q_dtype, kc, q, k_pool, v_pool, k_scale,
                              v_scale, tables, q_end, q_start, anc_lo,
                              anc_hi, out, ws, counters, part, max_splits,
                              pb, blocks, s);
    case kBF16:
      return LaunchFor<__nv_bfloat16>(q_dtype, kc, q, k_pool, v_pool,
                                      k_scale, v_scale, tables, q_end,
                                      q_start, anc_lo, anc_hi, out, ws,
                                      counters, part, max_splits, pb,
                                      blocks, s);
    case kI8:
      return LaunchFor<int8_t>(q_dtype, kc, q, k_pool, v_pool, k_scale,
                               v_scale, tables, q_end, q_start, anc_lo,
                               anc_hi, out, ws, counters, part, max_splits,
                               pb, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The main kernel's geometry for these shapes on the current device:
// geo[0] threads, geo[1] shared bytes per block, geo[2] resident blocks
// per SM, geo[3] blocks of a launch (the SMs times geo[2]).
int RaggedAttendGeometry(int head_dim, int page_size, int t_pages,
                         int kv_dtype, int* geo) {
  int bytes = 0;
  const void* fn = nullptr;
  const bool two = head_dim > 128;
  // the float32-q kernel's: a bfloat16-q launch takes the same persistent
  // grid (its units come from the atomic counter, resident or not)
  switch (kv_dtype) {
    case kF32:
      bytes = Layout<float>(head_dim, page_size, t_pages).bytes;
      fn = FloatQKernel<float>(two);
      break;
    case kBF16:
      bytes = Layout<__nv_bfloat16>(head_dim, page_size, t_pages).bytes;
      fn = FloatQKernel<__nv_bfloat16>(two);
      break;
    case kI8:
      bytes = Layout<int8_t>(head_dim, page_size, t_pages).bytes;
      fn = FloatQKernel<int8_t>(two);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      bytes);
  geo[0] = kThreads;
  geo[1] = bytes;
  geo[2] = per_sm;
  geo[3] = sms * per_sm;
  return static_cast<int>(err);
}

const char* RaggedAttendErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
