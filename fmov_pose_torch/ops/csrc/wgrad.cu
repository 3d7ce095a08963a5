// The weight-gradient stage of K3, K5, K7 and K9, for Hopper (sm_90a):
// dW_l = A_l^T B_l over all rows of every layer l in one launch
// (wgrad_kernel), then the row splits' partial sums, the per-block bias
// sums and K5/K3's column-0 term added in a fixed order (reduce_kernel).
// The Python side is fmov_pose_torch/ops/wgrad.py (plan, plain version,
// launch); the backward wrappers of fused_sdf.py and fused_color.py launch
// it right after their per-point pass.
//
// It replaces no Pallas kernel of its own: the TPU kernels accumulate these
// products in their own bodies over the sequential grid (dws[l] in
// fmov_pose_tpu/ops/fused_sdf.py:499-525 for K3 and :845-871 for K5,
// fused_color.py:139 for K7 and :452 for K9).  Blocks on this card run in
// no order, so the per-point passes store the bf16 operands A_l [rows x
// lda] and B_l [rows x ldb] row-major in the workspace, and this stage
// reduces them over the rows: for K5 and K3, A_l = [FB_l; X_l] and B_l =
// [D_l; ZB_l] (Phase A and Phase B stacked over 2 M_pad rows; X and ZB
// alone for the last layer), for K7 and K9 A_l = X_l and B_l = ZB_l.
//
// What bounds it: the bytes.  At K5's shape (8x256, M = 65,536) the
// operands are 1.08 GB of bf16 against ~131 GFLOP: 0.324 ms at 3.35 TB/s
// against 0.133 ms at the bf16 tensor-core peak; the other three shapes
// have the same ratio.
//
// Design.  A block owns 128 columns of A (two consumer warpgroups of 64)
// by the whole width of B (up to 5 x 64 columns) over one of KS row
// ranges, so each row of A is read once and each row of B ceil(ni / 128)
// times (the i-tiles of one row range are neighbouring blocks, which run
// at the same time).  KS is the most splits that keep every block in one
// wave (wgrad.py split_k).  One thread of a producer
// warpgroup keeps a ring of 64-row stages full with TMA: 64 x 64 bf16 boxes with the
// 128-byte swizzle, zero-filled past ni, nj and the last row; full and
// empty mbarriers hand the stages over.  The consumers run wgmma
// m64n64k16 with both operands in shared memory, MN-major (the rows are
// the reduction dimension), one group in flight while they wait for the
// next stage.  Each block writes its f32 partial [128 x nj] of its split
// to DWPART; reduce_kernel sums the splits in order.  No atomics: the same
// bits every launch, eager or replayed from a CUDA graph (the tensor maps
// are kernel parameters, which a capture records by value).  The TMA,
// mbarrier and wgmma helpers are hopper.cuh's, shared with K5/K3's
// per-point pass.

#include "hopper.cuh"

namespace fmov_wg {

using namespace fmov_hopper;

constexpr int MAX_JOBS = 16;      // packing.MAX_LIN
constexpr int TILE_I = 128;       // columns of A a block
constexpr int WG_I = 64;          // columns of A a consumer warpgroup
constexpr int KR = 64;            // rows a stage
constexpr int BOX = 64;           // columns a TMA box: 128 bytes, the swizzle's span
constexpr int BOX_BYTES = KR * BOX * 2;
constexpr int MAX_NT = 5;         // 64-column chunks of B: nj <= 320
constexpr int MAX_STAGES = 8;
constexpr int THREADS = 3 * 128;        // two consumer warpgroups, one producer
// Registers: the launch gives each thread 168 (65,536 over 384); the
// producer warpgroup hands 128 of its own back and the consumers take them,
// 232 each, room for 5 x 32 f32 accumulators without spilling.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;      // an H100 block's opt-in shared memory
constexpr int ALIGN = 1024;             // the 128-byte swizzle's period (8 rows)

struct Job {
  int rows, ni, nj, out_off;  // out_off: the layer's block in a split's partial
  int tiles, task0, per, nt;  // i-tiles, first block, rows a split, B boxes
};

struct Args {
  CUtensorMap amap[MAX_JOBS];  // A_l [rows x ni], row stride lda
  CUtensorMap bmap[MAX_JOBS];  // B_l [rows x nj], row stride ldb
  Job job[MAX_JOBS];
  float* part;                 // [KS x total]
  int n_jobs, total, stages, stage_bytes;
};

// The wgmma descriptor of a 64-column, 16-row slice of a box: MN-major
// with the 128-byte swizzle, 8-row groups 1024 bytes apart.  A slice is
// one swizzle pattern wide, so the leading offset is never stepped; it is
// set to the same 1024 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(ALIGN >> 4) << 16) |
         ((uint64_t)(ALIGN >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d [64 x 64] += A^T B of a 16-row slice: both operands MN-major
// (transposed) bf16 in shared memory, f32 accumulators.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// A consumer warpgroup: columns i0 + 64 wg .. of A against NT boxes of B
// over the block's n_chunks stages, then its partial to out.  A warpgroup
// past ni only hands the stages back.
template <int NT>
__device__ __forceinline__ void consume(const Args& a, const Job& J, int i0,
                                        int n_chunks, uint32_t ring, uint32_t full,
                                        uint32_t empty, float* out) {
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const bool active = i0 + wg * WG_I < J.ni;
  float acc[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % a.stages;
    mbar_wait(full + 8 * s, (c / a.stages) & 1);
    if (active) {
      const uint32_t st = ring + s * a.stage_bytes;
      const uint32_t abox = st + wg * BOX_BYTES, bbox = st + 2 * BOX_BYTES;
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KR / 16; ++k) {
        const uint64_t da = smem_desc(abox + k * 16 * 128);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          wgmma_64x64x16(acc[t], da, smem_desc(bbox + t * BOX_BYTES + k * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
    }
    __syncwarp();
    if (c > 0 && lane == 0) mbar_arrive(empty + 8 * ((c - 1) % a.stages));
  }
  if (!active) return;
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);

  // accumulator (row, col) of register e: row 16 warp + lane / 4 (+ 8 for
  // e % 4 >= 2), col 8 (e / 4) + 2 (lane % 4) + e % 2
  const int row = i0 + wg * WG_I + warp * 16 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = t * BOX + n * 8 + (lane & 3) * 2;
      if (j >= J.nj) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = row + 8 * h;
        if (i < J.ni)
          *reinterpret_cast<float2*>(out + (size_t)i * J.nj + j) =
              make_float2(acc[t][4 * n + 2 * h], acc[t][4 * n + 2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    wgrad_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = (base + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t full = ring + a.stages * a.stage_bytes;
  const uint32_t empty = full + 8 * a.stages;

  int q = a.n_jobs - 1;
  while (q > 0 && (int)blockIdx.x < a.job[q].task0) --q;
  const Job& J = a.job[q];
  const int local = (int)blockIdx.x - J.task0;
  const int tile = local % J.tiles, split = local / J.tiles;
  const int i0 = tile * TILE_I;
  const int r_begin = split * J.per;
  const int r_end = min(J.rows, r_begin + J.per);
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + KR - 1) / KR : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const bool two = i0 + WG_I < J.ni;
      const uint32_t bytes = (uint32_t)((two ? 2 : 1) + J.nt) * BOX_BYTES;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % a.stages;
        if (c >= a.stages) mbar_wait(empty + 8 * s, ((c / a.stages) - 1) & 1);
        const uint32_t st = ring + s * a.stage_bytes, bar = full + 8 * s;
        const int r = r_begin + c * KR;
        mbar_expect_tx(bar, bytes);
        tma_load(st, &a.amap[q], bar, i0, r);
        if (two) tma_load(st + BOX_BYTES, &a.amap[q], bar, i0 + WG_I, r);
        for (int t = 0; t < J.nt; ++t)
          tma_load(st + (2 + t) * BOX_BYTES, &a.bmap[q], bar, t * BOX, r);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  float* out = a.part + (size_t)split * a.total + J.out_off;
  switch (J.nt) {
    case 1: consume<1>(a, J, i0, n_chunks, ring, full, empty, out); break;
    case 2: consume<2>(a, J, i0, n_chunks, ring, full, empty, out); break;
    case 3: consume<3>(a, J, i0, n_chunks, ring, full, empty, out); break;
    case 4: consume<4>(a, J, i0, n_chunks, ring, full, empty, out); break;
    default: consume<5>(a, J, i0, n_chunks, ring, full, empty, out); break;
  }
}

// dw[e] = sum_s part[s * total + e] (+ the column-0 term cb of one layer:
// sum_b cbpart[b * ncb + i] at e = cb_off + i * cb_ld); db[c] = sum_b
// dbpart[b * nb + c].  Fixed summation order.
__global__ void reduce_kernel(const float* part, int KS, int total, float* dw,
                              const float* dbpart, int G, int nb, float* db,
                              const float* cbpart, int ncb, int cb_off,
                              int cb_ld) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) {
    float s = 0.f;
    for (int k = 0; k < KS; ++k) s += part[(size_t)k * total + e];
    if (cbpart != nullptr && e >= cb_off && (e - cb_off) % cb_ld == 0 &&
        (e - cb_off) / cb_ld < ncb) {
      const int i = (e - cb_off) / cb_ld;
      float c = 0.f;
      for (int b = 0; b < G; ++b) c += cbpart[(size_t)b * ncb + i];
      s += c;
    }
    dw[e] = s;
  }
  if (e < nb) {
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += dbpart[(size_t)b * nb + e];
    db[e] = s;
  }
}

// A bf16 [rows x cols] array with row stride ld elements, in 64 x 64
// boxes with the 128-byte swizzle; zeros past its edges.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
                   int cols, int ld) {
  return tensor_map_2d(fn, map, ptr, rows, cols, ld, KR, BOX, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace fmov_wg

using namespace fmov_wg;

extern "C" {

const char* fmov_train_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// ptrs: A_0, B_0, A_1, B_1, ... (bf16, 16-byte aligned); dims: per job
// rows, lda, ldb, ni, nj (wgrad.py job_dims).  dwpart [KS x sum ni nj];
// dw: the [ni x nj] blocks concatenated; db [nb]; cbpart [G x ncb] or
// null.  Returns a cudaError_t (0 = launched).
int fmov_wgrad(const unsigned long long* ptrs, const int* dims, int n_jobs, int KS,
               float* dwpart, float* dw, const float* dbpart, int G, int nb,
               float* db, const float* cbpart, int ncb, int cb_off, int cb_ld,
               void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || KS < 1 || G < 1 || nb < 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  Args a;
  int total = 0, task = 0, nt_max = 1;
  for (int q = 0; q < n_jobs; ++q) {
    const int* d = dims + 5 * q;
    const int rows = d[0], lda = d[1], ldb = d[2], ni = d[3], nj = d[4];
    const void* pa = reinterpret_cast<const void*>(ptrs[2 * q]);
    const void* pb = reinterpret_cast<const void*>(ptrs[2 * q + 1]);
    if (rows < 1 || ni < 1 || nj < 1 || ni > lda || nj > ldb || ni % 16 ||
        nj % 16 || nj > MAX_NT * BOX || lda % 8 || ldb % 8 ||
        reinterpret_cast<uintptr_t>(pa) % 16 || reinterpret_cast<uintptr_t>(pb) % 16)
      return (int)cudaErrorInvalidValue;
    Job& J = a.job[q];
    J.rows = rows;
    J.ni = ni;
    J.nj = nj;
    J.out_off = total;
    J.tiles = (ni + TILE_I - 1) / TILE_I;
    J.task0 = task;
    J.per = ((rows + KS - 1) / KS + KR - 1) / KR * KR;
    J.nt = (nj + BOX - 1) / BOX;
    if (!encode(fn, &a.amap[q], pa, rows, ni, lda) ||
        !encode(fn, &a.bmap[q], pb, rows, nj, ldb))
      return (int)cudaErrorInvalidValue;
    task += J.tiles * KS;
    total += ni * nj;
    nt_max = J.nt > nt_max ? J.nt : nt_max;
  }
  a.part = dwpart;
  a.n_jobs = n_jobs;
  a.total = total;
  a.stage_bytes = (2 + nt_max) * BOX_BYTES;
  const int room = SMEM_LIMIT - ALIGN - 16 * MAX_STAGES;
  a.stages = room / a.stage_bytes < MAX_STAGES ? room / a.stage_bytes : MAX_STAGES;
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = ALIGN + a.stages * a.stage_bytes + 16 * a.stages;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<<<task, THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = total > nb ? total : nb;
  reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(dwpart, KS, total, dw, dbpart, G,
                                                 nb, db, cbpart, ncb, cb_off, cb_ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
