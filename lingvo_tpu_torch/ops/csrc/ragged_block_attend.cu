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
// Design: one thread block per (token, head), 128 threads. The block loads
// its own row_of / q_end / q_start / anc_lo / anc_hi and walks only the
// token's live pages, ceil(q_end / P) of them, through
// block_tables[row, j] (row and table entry clamped into range as the
// reference does). A table entry past a token's last live page is never
// read, and neither is the K or V row of a masked slot, so stale or
// foreign pages cannot reach the output. A q_end == 0 token (padding)
// writes exact zeros and reads no page. Per page, each warp takes every
// fourth slot and reduces q.k over the head dim with shuffles; the page's
// probabilities go through shared memory; each thread then owns one or two
// head-dim columns of acc and reads V coalesced along the head dim.
//
// Bound: the work is a gather, far below the card's ridge point (4 flops
// per K/V element read), so it is bounded by bytes: each row's live K/V
// slots (up to its furthest q_end) and live table entries read once, plus
// q read and out written once, over 3.35 TB/s on an H100 SXM. What this
// simple design leaves on the table: a block per
// (token, head) re-reads a row's pages once per prefill token of that row
// (a 256-token prefill chunk reads its prefix 256 times, mostly from L2),
// and the dot products run on the CUDA cores. A later kernel should tile
// several query tokens of one row per block and run QK^T and PV on the
// tensor cores (wgmma over a multi-query tile), with TMA page loads.
//
// Pool storage: the kernel is a template on it and reads K and V only
// through `Kv` (kv_storage.cuh: float32, bfloat16 with p rounded to
// bfloat16 before P.V, int8 dequantized on load with __fmul_rn, so the
// int8 kernel equals the float32 one on the pre-dequantized pool bit for
// bit). A masked slot's scale is never loaded (dead scales may hold NaN),
// just as its K/V is never loaded. Bound: bytes as above, at 2 bytes per
// bfloat16 element, or 1 byte per int8 element plus 4 per live (slot,
// head) of each sidecar.
//
// Limits (the Python wrapper raises outside them): page_size 8..128,
// head dim <= 256, all tensors contiguous, float32 q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_storage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;   // two acc columns per thread
constexpr int kMaxPageSize = 128;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) RaggedAttendKernel(
    const float* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ row_of, const int* __restrict__ q_end,
    const int* __restrict__ q_start, const int* __restrict__ anc_lo,
    const int* __restrict__ anc_hi, float* __restrict__ out, int num_heads,
    int head_dim, int num_pool_pages, int page_size, int num_rows,
    int t_pages) {
  __shared__ float q_sh[kMaxHeadDim];
  __shared__ float s_sh[kMaxPageSize];  // a page's scores, then its probs

  const int token = blockIdx.x / num_heads;
  const int head = blockIdx.x % num_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t slot_stride = static_cast<size_t>(num_heads) * head_dim;
  const size_t tok_off = static_cast<size_t>(token) * slot_stride +
                         static_cast<size_t>(head) * head_dim;
  const int h0 = tid, h1 = tid + kThreads;

  const int end = q_end[token];
  if (end <= 0) {  // padding token: exact zeros, no page read
    if (h0 < head_dim) out[tok_off + h0] = 0.f;
    if (h1 < head_dim) out[tok_off + h1] = 0.f;
    return;
  }
  const int row = min(max(row_of[token], 0), num_rows - 1);
  const int start = q_start[token];
  const int lo = anc_lo[token];
  const int hi = anc_hi[token];
  if (h0 < head_dim) q_sh[h0] = q[tok_off + h0];
  if (h1 < head_dim) q_sh[h1] = q[tok_off + h1];
  __syncthreads();

  float m = kNegInf, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  const int live = min((end + page_size - 1) / page_size, t_pages);
  for (int j = 0; j < live; ++j) {
    const int pid = min(max(tables[row * t_pages + j], 0), num_pool_pages - 1);
    const size_t page_off = static_cast<size_t>(pid) * page_size * slot_stride +
                            static_cast<size_t>(head) * head_dim;
    // scale[pid, head, p] of the sidecars (int8 pools only)
    const size_t scale_off =
        (static_cast<size_t>(pid) * num_heads + head) * page_size;
    // scores: s = q . k for kept slots, NEG_INF for masked ones
    for (int p = warp; p < page_size; p += kWarps) {
      const int slot = j * page_size + p;
      float s = kNegInf;
      if (slot < end && AncestorOk(slot, start, lo, hi)) {  // warp-uniform
        const T* k = k_pool + page_off + p * slot_stride;
        const float sc = Kv<T>::Scale(k_scale, scale_off + p);
        float part = 0.f;
        for (int h = lane; h < head_dim; h += 32)
          part += q_sh[h] * Kv<T>::Load(k, h, sc);
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s = part;
      }
      if (lane == 0) s_sh[p] = s;
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
    float psum = 0.f, pv0 = 0.f, pv1 = 0.f;
    const T* v = v_pool + page_off;
    for (int p = 0; p < page_size; ++p) {
      const float pp = s_sh[p];
      psum += pp;
      if (pp == 0.f) continue;  // masked (or underflowed): adds exactly 0
      const T* vs = v + p * slot_stride;
      const float sc = Kv<T>::Scale(v_scale, scale_off + p);
      const float pr = Kv<T>::RoundP(pp);
      if (h0 < head_dim) pv0 += pr * Kv<T>::Load(vs, h0, sc);
      if (h1 < head_dim) pv1 += pr * Kv<T>::Load(vs, h1, sc);
    }
    l = alpha * l + psum;
    acc0 = acc0 * alpha + pv0;
    acc1 = acc1 * alpha + pv1;
    m = m_new;
    __syncthreads();  // the next page overwrites s_sh
  }
  const float denom = fmaxf(l, 1e-20f);
  if (h0 < head_dim) out[tok_off + h0] = acc0 / denom;
  if (h1 < head_dim) out[tok_off + h1] = acc1 / denom;
}

template <typename T>
void Launch(const float* q, const void* k_pool, const void* v_pool,
            const float* k_scale, const float* v_scale, const int* tables,
            const int* row_of, const int* q_end, const int* q_start,
            const int* anc_lo, const int* anc_hi, float* out, int num_tokens,
            int num_heads, int head_dim, int num_pool_pages, int page_size,
            int num_rows, int t_pages, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(num_tokens) * num_heads;
  RaggedAttendKernel<T><<<blocks, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      k_scale, v_scale, tables, row_of, q_end, q_start, anc_lo, anc_hi, out,
      num_heads, head_dim, num_pool_pages, page_size, num_rows, t_pages);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q/out [T, N, H] float32; k_pool/v_pool [NP, P, N, H] of `kv_dtype`
// (KvDtype); k_scale/v_scale [NP, N, P] float32 for int8 pools, else
// null; tables [B, t_pages]; row_of/q_end/q_start/anc_lo/anc_hi [T]; all
// contiguous, on one device.
int RaggedAttend(const float* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* row_of, const int* q_end,
                 const int* q_start, const int* anc_lo, const int* anc_hi,
                 float* out, int num_tokens, int num_heads, int head_dim,
                 int num_pool_pages, int page_size, int num_rows,
                 int t_pages, int kv_dtype, void* stream) {
  if (num_tokens <= 0) return 0;
  if (head_dim > kMaxHeadDim || page_size > kMaxPageSize || page_size < 1 ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      Launch<float>(q, k_pool, v_pool, k_scale, v_scale, tables, row_of,
                    q_end, q_start, anc_lo, anc_hi, out, num_tokens,
                    num_heads, head_dim, num_pool_pages, page_size, num_rows,
                    t_pages, s);
      break;
    case kBF16:
      Launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                            row_of, q_end, q_start, anc_lo, anc_hi, out,
                            num_tokens, num_heads, head_dim, num_pool_pages,
                            page_size, num_rows, t_pages, s);
      break;
    case kI8:
      Launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, row_of,
                     q_end, q_start, anc_lo, anc_hi, out, num_tokens,
                     num_heads, head_dim, num_pool_pages, page_size,
                     num_rows, t_pages, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* RaggedAttendErrorString(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
