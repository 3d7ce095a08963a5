// Hopper (sm_90a) building blocks shared by the kernels that run on TMA and
// wgmma: the weight-gradient stage (wgrad.cu) and the SDF kernels' per-point
// passes (sdf_bwd_pass.cuh, K5 and K3; sdf_fwd_grad_pass.cuh, K4 and K2).
// mbarriers, TMA tile loads and stores and the L2 prefetch, wgmma's fences,
// groups and shared-memory descriptors, named barriers, setmaxnreg, and the
// host's tensor-map encoder (cuTensorMapEncodeTiled through the runtime's
// entry-point query, so no library needs -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fmov_hopper {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// mbar_arrive by the threads where pred holds, predicated inside the asm
// statement: no branch the compiler cannot prove convergent.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed.  A
// copy that never lands would hang the card: the wait traps instead, after
// far longer than any stage takes, so the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait with its spin inside one asm statement, so that to the compiler
// the code after it is not on a divergent path: a wgmma warpgroup's waits
// (ptxas serializes the wgmma that follow a loop it cannot prove
// convergent).  Traps after as long as mbar_wait.
__device__ __forceinline__ void mbar_wait_converged(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 1073741824;\n"
      "@p trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 2-D box of a tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// One 2-D box of shared memory at src into a tensor map's array, in this
// thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Brings bytes (a multiple of 16) of device memory at p into L2, asynchronously.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes)
               : "memory");
}

// prefetch_l2 by the threads where pred holds, predicated inside the asm.
__device__ __forceinline__ void prefetch_l2_if(const void* p, uint32_t bytes, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@q cp.async.bulk.prefetch.L2.global [%0], %1;\n"
      "}\n" ::"l"(p),
      "r"(bytes), "r"((int)pred)
      : "memory");
}

// Orders this thread's generic stores to shared memory before later reads
// of the async proxy (wgmma operands).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15) over `count` threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives at barrier `id` without waiting: `count` counts these threads and
// those that wait there with named_sync.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Sets the registers a thread of this warpgroup may hold (every thread of
// the warpgroup, at the top of its own branch of a warp-specialised kernel).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers
// (accumulators, A fragments) across the wgmma fences and waits around them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+r"(d[e])::"memory");
}

constexpr int A_ATOM = 64;                     // K columns of an A swizzle atom
constexpr int A_ATOM_BYTES = 64 * A_ATOM * 2;  // of a 64-row tile

// The wgmma descriptor of a K-major operand slice in shared memory with the
// 128-byte (A: 64-column atoms, 8-row groups 1024 bytes apart) or the
// 64-byte swizzle (B: 32-column stages, 8-row groups 512 bytes apart).  The
// leading offset is unused for swizzled K-major operands.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// The byte offset of (row r, column k) in a 64-row tile's A operand: 64-column
// atoms of 64 rows x 128 bytes, each row's 16-byte chunks swizzled by r % 8.
__device__ __forceinline__ int a_off(int r, int k) {
  return (k >> 6) * A_ATOM_BYTES + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [rows x cols] array with row stride ld elements, in boxes of
// box_rows x box_cols with the given swizzle; zeros past its edges.
inline bool tensor_map_2d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
                          int cols, int ld, int box_rows, int box_cols,
                          CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fmov_hopper
