// Length-aware paged flash decode over a dense KV cache, Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel `_DecodeKernel` of
// lingvo_tpu/ops/flash_decode.py (pallas_call in `_PallasDecode`; public
// entry `FlashDecode`). It computes the same function, not the same
// blocks: row b's one pre-scaled query attends its cache slots
// [0, time_step] that are not padded (cache_paddings < 0.5), page by page
// with a float32 online softmax (the reference `_PageAttend`: running
// m / l / acc, the m_safe guard, acc / max(l, 1e-20)). A row with nothing
// live writes exact zeros.
//
// Design: one thread block per (row, head), 128 threads. The block walks
// only the row's live pages, min(time_step / P + 1, S / P) of them; pages
// past time_step are never read. Per page, groups of H / 4 lanes take one
// slot each: every lane loads one float4 of k, and shuffles inside the
// group reduce q . k over the head dim. A masked slot (past time_step or
// padded) is not read and scores NEG_INF. The page's scores go through
// shared memory; every thread then takes the page max, the guarded
// exponentials go back to shared memory, and thread h owns acc[h], reading
// V coalesced along the head dim and skipping slots whose probability is 0
// (masked), so a stale slot never reaches the output.
//
// Bound: a gather far below the card's ridge point (4 flops per K/V
// element read), so bytes bound it: the live K/V pages of every row, the
// paddings of those pages, q and out, over 3.35 TB/s on an H100 SXM. What
// this simple design leaves: B * N blocks (128 at 8 rows x 16 heads) fill
// one wave of 132 SMs with one block each, and each block walks its pages
// one after another with a barrier per page; a later kernel should split
// the pages of a row over several blocks (split-K, then a combine of the
// partial m / l / acc) and load pages with TMA.
//
// Limits (the Python wrapper raises outside them): head dim 4..128 with
// H / 4 a power of two, page_size 1..128, S a multiple of page_size, all
// tensors contiguous float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxPageSize = 128;
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

__global__ void __launch_bounds__(kThreads) FlashDecodeKernel(
    const float* __restrict__ q, const float* __restrict__ k_cache,
    const float* __restrict__ v_cache, const float* __restrict__ pad,
    float* __restrict__ out, int seq_len, int num_heads, int head_dim,
    int page_size, int time_step) {
  __shared__ __align__(16) float q_sh[kMaxHeadDim];
  __shared__ float s_sh[kMaxPageSize];  // a page's scores, then its probs

  const int row = blockIdx.x / num_heads;
  const int head = blockIdx.x % num_heads;
  const int tid = threadIdx.x;
  const size_t slot_stride = static_cast<size_t>(num_heads) * head_dim;
  const size_t q_off = static_cast<size_t>(row) * slot_stride +
                       static_cast<size_t>(head) * head_dim;
  // cache offset of (row, slot 0, head)
  const size_t row_off = static_cast<size_t>(row) * seq_len * slot_stride +
                         static_cast<size_t>(head) * head_dim;
  const float* pad_row = pad ? pad + static_cast<size_t>(row) * seq_len
                             : nullptr;
  if (tid < head_dim) q_sh[tid] = q[q_off + tid];
  __syncthreads();

  // slot groups: `group` lanes of one warp hold one slot's H / 4 float4s
  const int group = head_dim / 4;
  const int groups = kThreads / group;
  const int gid = tid / group;
  const int glane = tid % group;
  const float4 qv = reinterpret_cast<const float4*>(q_sh)[glane];

  float m = kNegInf, l = 0.f, acc = 0.f;
  const int num_live = time_step < 0 ? 0
      : min(time_step / page_size + 1, seq_len / page_size);
  for (int j = 0; j < num_live; ++j) {
    const int start = j * page_size;
    for (int p0 = 0; p0 < page_size; p0 += groups) {
      const int p = p0 + gid;
      const int slot = start + p;
      // keep = (slot <= t) * (1 - pad) > 0.5, as the reference computes it
      const bool keep = p < page_size && slot <= time_step &&
                        (pad_row == nullptr || 1.f - pad_row[slot] > 0.5f);
      float part = 0.f;
      if (keep) {
        const float4 kv = reinterpret_cast<const float4*>(
            k_cache + row_off + static_cast<size_t>(slot) * slot_stride)[glane];
        part = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
      // groups never straddle a warp (group divides 32), so the xor
      // partners of a lane are in its own group
      for (int o = group / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (p < page_size && glane == 0) s_sh[p] = keep ? part : kNegInf;
    }
    __syncthreads();
    float m_cur = kNegInf;
    for (int p = 0; p < page_size; ++p) m_cur = fmaxf(m_cur, s_sh[p]);
    const float m_new = fmaxf(m, m_cur);
    // all-masked-so-far: exp(s - m_new) would turn masked slots into 1
    const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    const float alpha = expf(m - m_new);
    __syncthreads();  // every thread has read the raw scores
    if (tid < page_size) s_sh[tid] = expf(s_sh[tid] - m_safe);
    __syncthreads();
    float psum = 0.f, pv = 0.f;
    const float* v = v_cache + row_off +
                     static_cast<size_t>(start) * slot_stride;
    for (int p = 0; p < page_size; ++p) {
      const float pp = s_sh[p];
      psum += pp;
      if (pp == 0.f) continue;  // masked (or underflowed): adds exactly 0
      if (tid < head_dim) pv += pp * v[p * slot_stride + tid];
    }
    l = alpha * l + psum;
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // the next page overwrites s_sh
  }
  if (tid < head_dim) out[q_off + tid] = acc / fmaxf(l, 1e-20f);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q/out [B, N, H]; k_cache/v_cache [B, S, N, H]; pad [B, S] or null; all
// contiguous float32 on one device.
int FlashDecodeF32(const float* q, const float* k_cache, const float* v_cache,
                   const float* pad, float* out, int batch, int seq_len,
                   int num_heads, int head_dim, int page_size, int time_step,
                   void* stream) {
  if (batch <= 0) return 0;
  const int group = head_dim / 4;
  if (head_dim < 4 || head_dim > kMaxHeadDim || head_dim % 4 != 0 ||
      (group & (group - 1)) != 0 || page_size < 1 ||
      page_size > kMaxPageSize || seq_len % page_size != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(batch) * num_heads;
  FlashDecodeKernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q, k_cache, v_cache, pad, out, seq_len, num_heads, head_dim, page_size,
      time_step);
  return static_cast<int>(cudaGetLastError());
}

const char* FlashDecodeErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
