// Hopper (sm_90a) building blocks of the bfloat16 flash-attention kernels
// (flash_attention.cu), the bfloat16 fused-xent statistics (fused_xent.cu),
// the SSD scan (ssd_scan.cu) and the int8 serving matmul (int8_matmul.cu),
// as inline PTX: cp.async copies, mbarriers (and cp.async copies that
// arrive on one), thread-block cluster barriers, loads from and stores into
// another block's shared memory, TMA tensor loads and stores (and the
// tensor maps' prefetch), warpgroup matrix multiplies (wgmma, bf16 and
// int8), named barriers, warpgroup register reallocation and programmatic
// dependent launch; and the host's tensor-map encoder.
//
// Conventions. Tiles are copied by TMA with the 128-byte swizzle: a box
// of R rows x 64 bf16 columns (128 bytes) lands as R rows of 128 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r % 8), from a 1024-byte
// aligned base. wgmma reads such a tile through a shared-memory matrix
// descriptor with the same swizzle (layout type 1):
//  - K-major (rows of the operand along M or N, the 16-element k-step
//    along the 128-byte row): stride between 8-row groups (SBO) 1024
//    bytes; the k-step kk starts 32 kk bytes into the row;
//  - MN-major (the operand's N along the 128-byte row, k along rows, the
//    B operand with its transpose flag set): SBO 1024 bytes between
//    groups of 8 k-rows, LBO the bytes between 64-column boxes.
// int8 tiles are the same bytes: a box of R rows x 128 int8 values of K
// (128 bytes), and the int8 wgmma's k-step of 32 values is 32 bytes, so
// its K-major descriptors are the bf16 ones (SBO 1024, the k-step kk 32 kk
// bytes into the row). The int8 wgmma takes K-major operands only.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cuTensorMapEncodeTiled, fetched from the driver at run time (so a
// library needs no -lcuda); null if the driver has none.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn TensorMapEncoder() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

__device__ __forceinline__ uint32_t SmemAddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async --

// 16 bytes of global src into shared dst, asynchronously; !valid writes
// zeros and reads nothing.
__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The same for 4 bytes.
__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Closes this thread's group of copies issued since the last commit.
__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are in
// flight (a barrier then makes every thread's copies visible).
template <int kPending>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- mbarriers --

__device__ __forceinline__ void MbarInit(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   SmemAddr(bar)),
               "r"(count));
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void MbarInitFence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void MbarArriveExpectTx(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          SmemAddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void MbarArrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          SmemAddr(bar))
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed (a
// fresh barrier counts the phase before its first as completed: a wait on
// parity 1 passes at once).
__device__ __forceinline__ void MbarWait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(SmemAddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// An arrival on `bar` once every cp.async copy this thread has issued so
// far has landed; it counts toward the barrier's expected arrivals.
__device__ __forceinline__ void CpAsyncMbarArrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          SmemAddr(bar))
      : "memory");
}

// -- thread-block clusters --

// Arrives on the cluster barrier with no memory ordering (e.g. "this block
// has started"); a later ClusterWait completes the phase.
__device__ __forceinline__ void ClusterArriveRelaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Arrives, releasing this thread's prior writes (to any block's shared
// memory) to the threads that pass the matching ClusterWait.
__device__ __forceinline__ void ClusterArrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ClusterWait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `p`'s address (the same offset) in the shared memory of the cluster's
// block `rank`.
__device__ __forceinline__ uint32_t MapShared(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(SmemAddr(p)), "r"(rank));
  return remote;
}

// 16 bytes into another block's shared memory at `remote` (from
// MapShared), counted in bytes on that block's mbarrier at `remote_bar`.
__device__ __forceinline__ void StAsync(uint32_t remote, float4 v,
                                        uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

// One float into another block's shared memory at `remote`, counted (4
// bytes) on that block's mbarrier at `remote_bar`.
__device__ __forceinline__ void StAsyncF(uint32_t remote, float v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(remote),
      "f"(v), "r"(remote_bar)
      : "memory");
}

// MbarWait that acquires at cluster scope: what other blocks' st.async
// stores or arrivals on this block's barrier released becomes visible.
__device__ __forceinline__ void MbarWaitCluster(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(SmemAddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes of the shared memory at `remote` (from MapShared: this or
// another block of the cluster) as 4 int32.
__device__ __forceinline__ int4 LdSharedCluster4(uint32_t remote) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// -- programmatic dependent launch --

// Waits until the grids this one depends on (the stream's previous kernel,
// when this grid was launched with programmatic stream serialization) have
// completed and their writes are visible; returns at once otherwise.
__device__ __forceinline__ void GridDepWait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the stream's next grid, if it was launched with programmatic stream
// serialization, start before this one ends (it waits in GridDepWait for
// this grid's writes).
__device__ __forceinline__ void GridDepLaunch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// -- TMA --

// Fetches the tensor map `map` (a __grid_constant__ kernel parameter)
// into the TMA unit's cache ahead of its first load.
__device__ __forceinline__ void PrefetchTensorMap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box at coordinates (c0, c1, c2, c3) (innermost first) of the 4-D
// tensor map `map` (a __grid_constant__ kernel parameter) into dst;
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void TmaLoad4(void* dst, const void* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(SmemAddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(SmemAddr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box at coordinates (c0, c1) (innermost first) of the 2-D tensor map
// `map` into dst; completion is counted on `bar` in bytes.
__device__ __forceinline__ void TmaLoad2(void* dst, const void* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(SmemAddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(SmemAddr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The box at shared src into the 4-D tensor map `map` at coordinates
// (c0, c1, c2, c3) (innermost first); rows and columns outside the tensor
// are not written. Completion is tracked in the thread's bulk groups.
__device__ __forceinline__ void TmaStore4(const void* map, const void* src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(SmemAddr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits the thread's TMA stores and waits until they have read their
// shared memory (the writes to global memory may still be in flight).
__device__ __forceinline__ void TmaStoreWaitRead() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy
// (a TMA store that reads them).
__device__ __forceinline__ void FenceProxyAsync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma --

// The shared-memory matrix descriptor of a 128-byte-swizzled tile at p
// (see the head of this file); lbo and sbo in bytes.
__device__ __forceinline__ uint64_t SwizzledDesc(const void* p, uint32_t lbo,
                                                 uint32_t sbo) {
  const uint64_t addr = SmemAddr(p);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void WgmmaFence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void WgmmaCommit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most kPending of the committed groups are in flight
template <int kPending>
__device__ __forceinline__ void WgmmaWait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Orders the compiler's use of accumulator registers after a wgmma wait:
// the asm "writes" each register, so no read of it moves above this point.
template <int kN>
__device__ __forceinline__ void FenceRegs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B^T over one m64n64k16 step: A [64 x 16] and B [64 x 16]
// K-major in shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void WgmmaSS64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T over one m64n128k16 step: A [64 x 16] and B [128 x 16]
// K-major in shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void WgmmaSS128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B over one m64n64k16 step: A [64 x 16] bf16 from registers
// (fragments in the accumulator's layout), B [16 x 64] MN-major in shared
// memory (descriptor db, transposed).
__device__ __forceinline__ void WgmmaRS64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B over one m64n128k16 step: A [64 x 16] bf16 from registers
// (fragments in the accumulator's layout), B [16 x 128] MN-major in shared
// memory (descriptor db, transposed).
__device__ __forceinline__ void WgmmaRS128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// FenceRegs for int32 accumulators.
template <int kN>
__device__ __forceinline__ void FenceRegs(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- int8 wgmma (s8 x s8 -> s32) --
//
// Both operands K-major from shared memory: rows of 128 int8 values of K in
// the 128-byte swizzle, as the bf16 tiles (see the head of this file). The
// overload is picked by the accumulator's size: an m64nNk32 product keeps
// N / 2 int32 a thread, in the float32 accumulators' layout (thread t of
// the warpgroup: rows 16 (t / 32) + (t % 32) / 4 and 8 more; d[4 j + e] and
// d[4 j + 2 + e] at column 8 j + 2 (t % 4) + e). int32 sums are exact.

// d (+)= A . B^T over one m64n8k32 step of int8: A [64 x 32] and B [8 x 32]
// K-major in shared memory (descriptors da, db), int32 sums; scale_d = 0
// overwrites d.
__device__ __forceinline__ void WgmmaS8(int (&d)[4], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T over one m64n16k32 step of int8: A [64 x 32] and B [16 x 32]
// K-major in shared memory (descriptors da, db), int32 sums; scale_d = 0
// overwrites d.
__device__ __forceinline__ void WgmmaS8(int (&d)[8], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T over one m64n32k32 step of int8: A [64 x 32] and B [32 x 32]
// K-major in shared memory (descriptors da, db), int32 sums; scale_d = 0
// overwrites d.
__device__ __forceinline__ void WgmmaS8(int (&d)[16], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T over one m64n64k32 step of int8: A [64 x 32] and B [64 x 32]
// K-major in shared memory (descriptors da, db), int32 sums; scale_d = 0
// overwrites d.
__device__ __forceinline__ void WgmmaS8(int (&d)[32], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T over one m64n128k32 step of int8: A [64 x 32] and B [128 x 32]
// K-major in shared memory (descriptors da, db), int32 sums; scale_d = 0
// overwrites d.
__device__ __forceinline__ void WgmmaS8(int (&d)[64], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}


// -- named barriers --

// Waits at hardware barrier `id` (1..15; 0 is __syncthreads') until
// `count` threads, a multiple of 32, have reached it.
__device__ __forceinline__ void NamedBarSync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- warpgroup register reallocation --

// Every thread of a warpgroup executes these together: the warpgroup's
// per-thread register limit rises to (or falls to) kRegs, a multiple of 8
// in [24, 256]. A rise waits until falls elsewhere in the block have freed
// enough registers.
template <int kRegs>
__device__ __forceinline__ void MaxRegsInc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void MaxRegsDec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

}  // namespace
