// Single-query block-table paged decode attention, Hopper (sm_90a):
// float32, bfloat16 and int8 page pools, float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_BlockDecodeKernel` of
// lingvo_tpu/ops/block_decode.py (pallas_call in `_PallasBlockDecode`;
// public entry `BlockDecode`). It computes the same function, not the
// same blocks: row b's one pre-scaled query attends its logical KV slots
// [0, seq_lens[b]), slot s living at pool page block_tables[b, s / P],
// offset s % P, with a float32 online softmax page by page (the reference
// `_PageAttend`: running m / l / acc, the m_safe guard,
// acc / max(l, 1e-20)). seq_lens[b] <= 0 marks an inactive row, which
// writes exact zeros and reads no page.
//
// Design: one thread block per (row, head), 128 threads. The block loads
// its row's length and walks only its live pages, ceil(seq_len / P) of
// them (at most the table width), through the clamped table entry; a
// table entry past the row's last live page is never read, and neither is
// the K or V row of a slot past seq_len, so a stale or foreign page cannot
// reach the output. Per page, groups of H / 4 lanes take one slot each:
// every lane loads one float4 of k and shuffles inside the group reduce
// q . k over the head dim. The page's scores go through shared memory;
// every thread takes the page max, the guarded exponentials go back to
// shared memory, and thread h owns acc[h], reading V coalesced along the
// head dim and skipping slots whose probability is 0.
//
// Bound: a gather far below the card's ridge point (4 flops per K/V
// element read), so bytes bound it: each row's seq_len live K/V slots,
// its live table entries and length, q and out, over 3.35 TB/s on an H100
// SXM. What this simple design leaves: B * N blocks (128 at 8 rows x 16
// heads) fill one wave of 132 SMs with one block each, the longest row
// sets the time, and each block walks its pages one after another with a
// barrier per page; a later kernel should split a row's pages over several
// blocks (split-K with a combine of the partial m / l / acc) and load
// pages with TMA.
//
// Pool storage: the kernel is a template on it and reads K and V only
// through `Kv` (kv_storage.cuh: float32, bfloat16 with p rounded to
// bfloat16 before P.V, int8 dequantized on load with __fmul_rn, so the
// int8 kernel equals the float32 one on the pre-dequantized pool bit for
// bit). A slot past seq_len has neither its K/V nor its scales loaded
// (dead scales may hold NaN). Bytes bound it at 2 per bfloat16 element,
// or 1 per int8 element plus 4 per live (slot, head) of each sidecar.
//
// Limits (the Python wrapper raises outside them): head dim 4..128 with
// H / 4 a power of two, page_size 1..128, all tensors contiguous and
// 16-byte aligned, float32 q, int32 tables and lengths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxPageSize = 128;
constexpr float kNegInf = -1.0e30f;  // the reference NEG_INF

template <typename T>
__global__ void __launch_bounds__(kThreads) BlockDecodeKernel(
    const float* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ seq_lens, float* __restrict__ out, int num_heads,
    int head_dim, int num_pool_pages, int page_size, int t_pages) {
  __shared__ __align__(16) float q_sh[kMaxHeadDim];
  __shared__ float s_sh[kMaxPageSize];  // a page's scores, then its probs

  const int row = blockIdx.x / num_heads;
  const int head = blockIdx.x % num_heads;
  const int tid = threadIdx.x;
  const size_t slot_stride = static_cast<size_t>(num_heads) * head_dim;
  const size_t q_off = static_cast<size_t>(row) * slot_stride +
                       static_cast<size_t>(head) * head_dim;
  const int len = seq_lens[row];
  if (len <= 0) {  // inactive row: exact zeros, no page read
    if (tid < head_dim) out[q_off + tid] = 0.f;
    return;
  }
  if (tid < head_dim) q_sh[tid] = q[q_off + tid];
  __syncthreads();

  // slot groups: `group` lanes of one warp hold one slot's H / 4 float4s
  const int group = head_dim / 4;
  const int groups = kThreads / group;
  const int gid = tid / group;
  const int glane = tid % group;
  const float4 qv = reinterpret_cast<const float4*>(q_sh)[glane];

  float m = kNegInf, l = 0.f, acc = 0.f;
  const int live = min((len + page_size - 1) / page_size, t_pages);
  const int* row_table = tables + static_cast<size_t>(row) * t_pages;
  for (int j = 0; j < live; ++j) {
    const int pid = min(max(row_table[j], 0), num_pool_pages - 1);
    const size_t page_off =
        static_cast<size_t>(pid) * page_size * slot_stride +
        static_cast<size_t>(head) * head_dim;
    // scale[pid, head, p] of the sidecars (int8 pools only)
    const size_t scale_off =
        (static_cast<size_t>(pid) * num_heads + head) * page_size;
    for (int p0 = 0; p0 < page_size; p0 += groups) {
      const int p = p0 + gid;
      const bool keep = p < page_size && j * page_size + p < len;
      float part = 0.f;
      if (keep) {
        const float4 kv = Kv<T>::Load4(
            k_pool + page_off + static_cast<size_t>(p) * slot_stride, glane,
            Kv<T>::Scale(k_scale, scale_off + p));
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
    const T* v = v_pool + page_off;
    for (int p = 0; p < page_size; ++p) {
      const float pp = s_sh[p];
      psum += pp;
      if (pp == 0.f) continue;  // masked (or underflowed): adds exactly 0
      if (tid < head_dim)
        pv += Kv<T>::RoundP(pp) *
              Kv<T>::Load(v + p * slot_stride, tid,
                          Kv<T>::Scale(v_scale, scale_off + p));
    }
    l = alpha * l + psum;
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // the next page overwrites s_sh
  }
  if (tid < head_dim) out[q_off + tid] = acc / fmaxf(l, 1e-20f);
}

template <typename T>
void Launch(const float* q, const void* k_pool, const void* v_pool,
            const float* k_scale, const float* v_scale, const int* tables,
            const int* seq_lens, float* out, int batch, int num_heads,
            int head_dim, int num_pool_pages, int page_size, int t_pages,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(batch) * num_heads;
  BlockDecodeKernel<T><<<blocks, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      k_scale, v_scale, tables, seq_lens, out, num_heads, head_dim,
      num_pool_pages, page_size, t_pages);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q/out [B, N, H] float32; k_pool/v_pool [NP, P, N, H] of `kv_dtype`
// (KvDtype); k_scale/v_scale [NP, N, P] float32 for int8 pools, else
// null; tables [B, t_pages]; seq_lens [B]; all contiguous, on one device.
int BlockDecode(const float* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, const int* tables,
                const int* seq_lens, float* out, int batch, int num_heads,
                int head_dim, int num_pool_pages, int page_size, int t_pages,
                int kv_dtype, void* stream) {
  if (batch <= 0) return 0;
  const int group = head_dim / 4;
  if (head_dim < 4 || head_dim > kMaxHeadDim || head_dim % 4 != 0 ||
      (group & (group - 1)) != 0 || page_size < 1 ||
      page_size > kMaxPageSize || num_pool_pages < 1 || t_pages < 1 ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      Launch<float>(q, k_pool, v_pool, k_scale, v_scale, tables, seq_lens,
                    out, batch, num_heads, head_dim, num_pool_pages,
                    page_size, t_pages, s);
      break;
    case kBF16:
      Launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                            seq_lens, out, batch, num_heads, head_dim,
                            num_pool_pages, page_size, t_pages, s);
      break;
    case kI8:
      Launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, seq_lens,
                     out, batch, num_heads, head_dim, num_pool_pages,
                     page_size, t_pages, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* BlockDecodeErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
