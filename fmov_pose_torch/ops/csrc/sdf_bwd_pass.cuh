// The per-point pass of the SDF's second-order backward, for Hopper
// (sm_90a): K5 (sdf_bwd.cu, sdf_bwd_kernel) and K3 (sdf_flat.cu,
// sdf_bwd_flat_kernel) each run sdf_bwd_block.  Notation in sdf_train.cuh;
// the math is the JAX kernels' (fmov_pose_tpu/ops/fused_sdf.py:407-434).
//
// A tile of 64 points runs 4 L - 3 products A [64 x K] @ W [K x N] (33 at
// 8x256): the forward to layer L-2, the reverse chain, Phase A and Phase B.
// Design:
//   * A TMA weight ring.  A block (one per SM, looping over its tiles) is
//     two consumer warpgroups and a producer warp.  One producer thread
//     streams every product's weights through a ring of up to 8 stages (32
//     reduction columns x up to 256 output columns, the 64-byte swizzle)
//     with full and empty mbarriers; the product loop has no
//     __syncthreads and no cp.async.  The ring runs on across products and
//     tiles.  B is the other packed block of the layer, K-major: the
//     forward and Phase A products read R_l (= F_l^T), the reverse and
//     Phase B ones F_l.
//   * wgmma products.  Both warpgroups take each stage: warpgroup w runs
//     wgmma m64n128k16 (m64n64k16 for a narrower share) over the output
//     columns [128 w, 128 w + 128) of the tile's product, bf16 in, f32
//     accumulators, 64 a thread.  A is the tile's operand in shared memory
//     (K-major, the 128-byte swizzle), written by the previous epilogue in
//     that layout.  An output wider than 256 columns (the skip layer's
//     input, 272) runs as two passes over the same A, the upper columns
//     first.  Epilogues run on the accumulator registers, whose (row,
//     column) layout is mma.sync's (train_common.cuh Frag), so the f32
//     arrays keep their fragment order (frag4); each thread has 64 of a
//     product's outputs, as in the forward kernels' pipeline.  Before a
//     product the block prefetches its epilogue's f32 inputs into L2.  The
//     bf16 operands of the weight-gradient stage are the next A operand:
//     TMA stores write them from shared memory to the workspace.
//   * Registers: nine warps give each thread 168 (an SM quarter holds
//     16,384 registers).  Each consumer thread holds 64 accumulators, not
//     128: one tile in flight, its columns split between the warpgroups.
//     Designs with 128 accumulators a thread and setmaxnreg spilled; why
//     ptxas kept them at 168 is not explained (PERF.md, Open questions).
//   * Determinism: fixed tiles per block; column sums per warp by
//     shuffles, then over the four warps in a fixed order, each column
//     owned by one warpgroup.  The same bits every launch, eager or
//     replayed (the tensor maps are kernel parameters).
//
// What bounds it (NVIDIA H100 80GB HBM3, PERF.md): the epilogues, which
// write and read back the per-point arrays, ~5.1 GB at M = 65,536 (K5),
// 1.5 ms at 3.35 TB/s; the products, 0.29 ms at the bf16 peak, do not
// overlap them.  The weight-gradient stage (wgrad.cu) reads the bf16
// operands once more.

#pragma once

#include "hopper.cuh"
#include "sdf_train.cuh"

namespace fmov_train {

using namespace fmov_hopper;

constexpr int BWD_WG = 2;                       // consumer warpgroups
constexpr int BWD_THREADS = BWD_WG * 128 + 32;  // and a producer warp
constexpr int BWD_SMEM_LIMIT = 232448;          // an H100 block's opt-in shared memory
constexpr int BWD_ALIGN = 1024;                 // the 128-byte swizzle's period
constexpr int BWD_NW = 256;                     // output columns a pass
constexpr int BWD_WG_N = BWD_NW / BWD_WG;       // a warpgroup's share of them
constexpr int ACC = BWD_WG_N / 2;               // f32 accumulators a consumer thread
constexpr int BWD_KS = 32;                      // reduction columns a ring stage
constexpr int BWD_BOX_ROWS = 64;                // output columns (B^T rows) a TMA box
constexpr int BWD_BOX_BYTES = BWD_BOX_ROWS * BWD_KS * 2;
constexpr int BWD_STAGE_BYTES = BWD_NW / BWD_BOX_ROWS * BWD_BOX_BYTES;
constexpr int BWD_MAX_STAGES = 8;
constexpr int BWD_MAX_SUB = 6 * MAX_LIN;        // passes of a tile's products
constexpr int BWD_SCR_BYTES = 4 * BWD_NW * 4;   // per-warp column sums of a product
constexpr int SYNC_ID = 1;                      // the consumers' named barrier
enum { OUT_X = 0, OUT_D = MAX_LIN, OUT_F = 2 * MAX_LIN, OUT_Z = 3 * MAX_LIN };

// One pass of one product, in ring order: B^T rows [n0, n0 + nw) of
// tensor map `map` (2 l: F_l, 2 l + 1: R_l) over reduction columns [0, k).
struct Sub {
  int map, n0, nw, k;
};

// Byte offsets of the shared memory, from its 1024-aligned base: the ring
// at 0, then the tile's A operand, DIN, XEB, the block's bias and column-0
// sums, the per-warp column sums of a product, and the barriers.
enum { LAY_A, LAY_DIN, LAY_XEB, LAY_DBACC, LAY_CBACC, LAY_SCR, LAY_BAR, LAY_N };

struct BwdArgs {
  SdfArgs s;
  CUtensorMap maps[2 * MAX_LIN];  // F_l [kp x np] and R_l [kr x kp], 32 x 64 boxes
  // the bf16 operands the epilogues write, as A is laid out (64 x 64
  // boxes, the 128-byte swizzle): OUT_X + l: X_l, OUT_D + l: D_l, OUT_F + l:
  // FB_l, OUT_Z + l: ZB_l, each its real width of the tile's rows
  CUtensorMap omaps[4 * MAX_LIN];
  Sub sub[BWD_MAX_SUB];
  int n_sub, stages;
  int lay[LAY_N];
  bf16* FB[MAX_LIN];     // fbar_l, row stride kp(l), l < L-1
  bf16* ZB[MAX_LIN];     // zbar_l, row stride np(l)
  float* ZC[MAX_LIN];    // Hessian term, width np(l), l < L-1
  const float* ct_out;   // [M x n_out]: K5 the cotangent of out, K3 ybar
  const float* ct_sdf;   // [M] (K5; null for K3, whose ybar is given)
  const float* ct_grad;  // [M x 3] (K5)
  float* xbar;           // [M x 3] (K5) or xebar [M x pe_dim] (K3)
  float* dbpart;         // [G x n_bias]
  float* cbpart;         // [G x np(L-2)]
  int n_out, n_bias;
};

__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int e = 0; e < ACC; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d [64 x N] += A [64 x 16] B [16 x N], N = 128 or 64: A and B^T K-major bf16 in
// shared memory (descriptors da, db), f32 accumulators d[0 .. N / 2).
__device__ __forceinline__ void wgmma_n128(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Stores the lane's 4 values as bf16 pairs at (r, n) and (r + 8, n) of A.
__device__ __forceinline__ void st_a(unsigned char* A, const Frag& f, float v0, float v1,
                                     float v2, float v3) {
  const int o = a_off(f.r, f.n);
  st_bf16x2(reinterpret_cast<bf16*>(A + o), v0, v1);
  st_bf16x2(reinterpret_cast<bf16*>(A + o + 8 * 128), v2, v3);
}

// A consumer thread's view of the block: the shared buffers, the ring's
// barriers, its warpgroup, and its cursors (stages consumed, next pass of
// the tile's sequence).
struct Bwd {
  unsigned char* A;  // the tile's A operand [TILE_M x K], a_off layout
  uint32_t a;        // its shared-memory address
  float* DIN;        // [TILE_M x pe_pad]
  float* XEB;        // [TILE_M x pe_pad]
  float* DBACC;      // [n_bias]: the block's bias sums
  float* CBACC;      // [np(L-2)]: its column-0 sums
  float* SCR;        // [4 x BWD_NW]: per-warp column sums of one product
  uint32_t ring, full, empty;
  int wg, c, sp;
};

// The consumers' barrier (both warpgroups, not the producer warp).
__device__ __forceinline__ void consumer_sync() { named_sync(SYNC_ID, BWD_WG * 128); }

// The barrier before the consumers write A: the stores of the previous A
// to the workspace have read it (thread 0 issued them).
__device__ __forceinline__ void sync_a() {
  if (threadIdx.x == 0) bulk_wait_read();
  consumer_sync();
}

// Thread 0 stores A's columns [0, w) of the tile's 64 rows to the
// workspace array of output map m, one 64-column atom a box, after the
// consumers' barrier that made A complete.
__device__ __forceinline__ void store_a(const BwdArgs& a, const Bwd& W, int m, int w,
                                        int row0) {
  if (threadIdx.x != 0) return;
  for (int c = 0; c < w; c += A_ATOM)
    tma_store(&a.omaps[m], W.a + (c / A_ATOM) * A_ATOM_BYTES, c, row0);
  bulk_commit();
}

// Waits for stage W.c of the ring and returns its slot.
__device__ __forceinline__ int take_stage(const BwdArgs& a, Bwd& W) {
  const int s = W.c % a.stages;
  mbar_wait(W.full + 8 * s, (W.c / a.stages) & 1);
  ++W.c;
  return s;
}

// Hands a consumed stage back to the producer: lane 0 of each warp.
__device__ __forceinline__ void release(const Bwd& W, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(W.empty + 8 * s);
}

// The warpgroup's output columns of a pass: [n0 + 128 wg, + cols).
__device__ __forceinline__ int wg_cols(const Bwd& W, const Sub& sb) {
  const int c = sb.nw - BWD_WG_N * W.wg;
  return c < 0 ? 0 : (c > BWD_WG_N ? BWD_WG_N : c);
}

// acc = A [TILE_M x sb.k] @ the warpgroup's columns of the pass, stage by
// stage: two k16 steps a stage, m64n128k16 for a full share, m64n64k16
// for 64 columns or fewer, none for an empty share (the stages are still
// taken and handed back).  One group in flight while the next stage is
// waited for; a stage goes back once its products are done.
__device__ __forceinline__ void bwd_mainloop(const BwdArgs& a, Bwd& W, const Sub& sb,
                                             float (&acc)[ACC]) {
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
  const int nb = (wg_cols(W, sb) + BWD_BOX_ROWS - 1) / BWD_BOX_ROWS;
  const uint32_t rows = W.wg * BWD_WG_N * BWD_KS * 2;  // the share's first B^T row
  int prev = -1;
  for (int k0 = 0; k0 < sb.k; k0 += BWD_KS) {
    const int s = take_stage(a, W);
    const uint32_t st = W.ring + s * BWD_STAGE_BYTES + rows;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_KS; kk += 16) {
      const int k = k0 + kk;
      if (k < sb.k && nb > 0) {
        const uint64_t da = desc_a(W.a + (k >> 6) * A_ATOM_BYTES + (k & 63) * 2);
        const uint64_t db = desc_b(st + kk * 2);
        if (nb == 2)
          wgmma_n128(acc, da, db);
        else
          wgmma_n64(acc, da, db);
      }
    }
    wgmma_commit();
    fence_acc(acc);
    if (prev >= 0) {
      wgmma_wait<1>();
      fence_acc(acc);
      release(W, prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(W, prev);
}

constexpr int EPI_JC = 2;  // 16-column tiles whose epilogue inputs load together

// The epilogue of EPI_JC 16-column tiles j0.. of the warpgroup's share
// (columns from c0), on the accumulators: in = pre(f) for their Frags
// first (the loads in flight together, none behind a store that may alias
// it), then epi(f, v, in), which may overwrite v with the values to add to
// the column sums.  kFull: every tile lies inside the share, so the chunk
// is one block without branches.  With scr set, each warp's sums over its
// 16 rows go to scr[warp][column - n0] (lanes 0-3, after shuffles in a
// fixed order).
template <bool kFull, class Pre, class Epi>
__device__ __forceinline__ void epi_chunk(float (&acc)[ACC], int j0, int c0, int n0,
                                          int cols, float* scr, Pre pre, Epi epi) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2);
  auto frag = [&](int jj, int h) {
    return Frag{warp, (c0 >> 4) + j0 + jj, h, r, c0 + (j0 + jj) * 16 + h * 8 + (lane & 3) * 2};
  };
  decltype(pre(Frag{})) in[EPI_JC][2];
#pragma unroll
  for (int jj = 0; jj < EPI_JC; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (kFull || (j0 + jj) * 16 < cols) in[jj][h] = pre(frag(jj, h));
#pragma unroll
  for (int jj = 0; jj < EPI_JC; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!kFull && (j0 + jj) * 16 >= cols) continue;
      const Frag f = frag(jj, h);
      const int g = 2 * (j0 + jj) + h;
      float v[4] = {acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]};
      epi(f, v, in[jj][h]);
      if (scr != nullptr) {
        float s0 = v[0] + v[2], s1 = v[1] + v[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4) {
          scr[warp * BWD_NW + f.n - n0] = s0;
          scr[warp * BWD_NW + f.n - n0 + 1] = s1;
        }
      }
    }
}

template <class Pre, class Epi>
__device__ __forceinline__ void bwd_epilogue(const Bwd& W, float (&acc)[ACC], const Sub& sb,
                                             float* scr, Pre pre, Epi epi) {
  const int cols = wg_cols(W, sb), c0 = sb.n0 + BWD_WG_N * W.wg;
#pragma unroll
  for (int j0 = 0; j0 < BWD_WG_N / 16; j0 += EPI_JC) {
    if (j0 * 16 >= cols) break;
    if ((j0 + EPI_JC) * 16 <= cols)
      epi_chunk<true>(acc, j0, c0, sb.n0, cols, scr, pre, epi);
    else
      epi_chunk<false>(acc, j0, c0, sb.n0, cols, scr, pre, epi);
  }
}

// One product: its passes (the upper columns first), each the main loop
// then its epilogue; the pass at column 0, which writes the next A
// operand, waits for both warpgroups' products on the current one (and
// the previous A's stores) first.  Then fin() completes the next A operand
// (the PE halves the epilogue does not produce); after a barrier its
// columns [0, out_w) go to the workspace array of output map `out` (none
// for -1), and the columns n < colsum_n of the per-warp sums are added to
// colsum in warp order.
template <class Pre, class Epi, class Fin>
__device__ __forceinline__ void bwd_product(const BwdArgs& a, Bwd& W, int row0, int out,
                                            int out_w, float* colsum, int colsum_n, Pre pre,
                                            Epi epi, Fin fin) {
  for (;;) {
    const Sub sb = a.sub[W.sp++];
    float acc[ACC];
    bwd_mainloop(a, W, sb, acc);
    if (sb.n0 == 0) sync_a();
    bwd_epilogue(W, acc, sb, sb.n0 == 0 && colsum != nullptr ? W.SCR : nullptr, pre, epi);
    if (sb.n0 == 0) break;
  }
  fin();
  fence_async_shared();
  consumer_sync();
  if (out >= 0) store_a(a, W, out, out_w, row0);
  if (colsum != nullptr)
    for (int n = threadIdx.x; n < colsum_n; n += BWD_WG * 128)
      colsum[n] += W.SCR[n] + W.SCR[BWD_NW + n] + W.SCR[2 * BWD_NW + n] +
                   W.SCR[3 * BWD_NW + n];
}

// Copies columns [c0, c0 + pe_pad) of the tile's rows of a row-major bf16
// workspace array (row stride ld), which the consumers wrote in the
// encoding stage, into columns [dst, dst + pe_pad) of A, 16 bytes at a time.
__device__ __forceinline__ void copy_pe(const SdfArgs& s, const Bwd& W, const bf16* src,
                                        int ld, int row0, int c0, int dst) {
  const int vpr = s.pe_pad / 8;
  for (int i = threadIdx.x; i < TILE_M * vpr; i += BWD_WG * 128) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    *reinterpret_cast<uint4*>(W.A + a_off(r, dst + c)) =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c0 + c);
  }
}

// One thread brings the tile's region of a per-point f32 array in fragment
// order (width w) into L2.
__device__ __forceinline__ void prefetch_tile(const float* base, int w, int row0) {
  if (threadIdx.x == 0 && base != nullptr)
    prefetch_l2(base + (size_t)row0 * w, (uint32_t)(TILE_M * w * 4));
}

// The tile's encoding into X_0 (A, the first product's operand, and the
// workspace) and the PE half of X_S, and gbar, the cotangent of DIN
// (ct_grad[dim] * PE' for the rays kernel, gbar_in for the flat one), into
// FB_0 and FB_S.  Zeroes DIN and XEB.
__device__ __forceinline__ void bwd_pe_stage(const BwdArgs& a, const Bwd& W, int row0) {
  const SdfArgs& s = a.s;
  const int kp0 = s.L[0].kp, kps = s.L[s.skip].kp;
  const int total = TILE_M * s.pe_pad;
  constexpr int T = BWD_WG * 128;
  constexpr int PB = 2;  // passes whose loads are in flight together
  for (int i0 = threadIdx.x; i0 < total; i0 += PB * T) {
    float u[PB], w[PB];  // flat: xe and gbar_in; rays: x and ct_grad at the dim
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * T;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      const int gr = row0 + r;
      u[k] = w[k] = 0.f;
      if (i < total && c < s.pe_dim && gr < s.M) {
        if (s.xe_in != nullptr) {
          u[k] = s.xe_in[(size_t)gr * s.pe_dim + c];
          w[k] = s.gbar_in[(size_t)gr * s.pe_dim + c];
        } else {
          int d, kind;
          float f;
          pe_col(c, d, kind, f);
          u[k] = s.x[(size_t)gr * 3 + d];
          w[k] = a.ct_grad[(size_t)gr * 3 + d];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * T;
      if (i >= total) break;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      const int gr = row0 + r;
      float v = 0.f, g = 0.f;
      if (c < s.pe_dim) {
        if (s.xe_in != nullptr) {
          v = u[k];
          g = w[k];
        } else {  // rows past M encode x = 0, with gbar 0
          int d, kind;
          float f, j, j2;
          pe_col(c, d, kind, f);
          pe_eval(kind, f, u[k] * s.scale, v, j, j2);
          g = w[k] * j;
        }
      }
      const bf16 bv = __float2bfloat16(v), bvs = __float2bfloat16(v * INV_SQRT2);
      const bf16 bg = __float2bfloat16(g), bgs = __float2bfloat16(g * INV_SQRT2);
      s.X[0][(size_t)gr * kp0 + c] = bv;
      s.X[s.skip][(size_t)gr * kps + s.hoff + c] = bvs;
      a.FB[0][(size_t)gr * kp0 + c] = bg;
      a.FB[s.skip][(size_t)gr * kps + s.hoff + c] = bgs;
      *reinterpret_cast<bf16*>(W.A + a_off(r, c)) = bv;
      W.DIN[i] = 0.f;
      W.XEB[i] = 0.f;
    }
  }
}

// Per tile, 4 L - 3 products in the order of the pass table (bwd_plan):
//   1. the encoding stage, with gbar into FB_0 and FB_S;
//   2. forward to layer L-2 (sig_l into SIG, X_{l+1} into the next A and
//      the workspace; at l = L-2, D_{L-2} = bf16(wlast sig) takes X_{L-1}'s
//      place in A) and the reverse chain (d_l into DS, D_{l-1} into the next
//      A and the workspace, the PE parts added to DIN for K5), recomputed
//      as the JAX kernels do;
//   3. Phase A, ascending l <= L-2: fbar_l (gbar at l = 0, [dbar/sqrt2 |
//      gbar/sqrt2] at S), ebar = fbar_l W_l, dbar_{l+1} = ebar sig_l, the
//      Hessian term ZC_l = ebar d_{l+1} 100 sig_l (1 - sig_l); at l = L-2
//      the column sums of dbar (the last layer's column-0 term) into CBACC;
//   4. Phase B, descending l: zbar_{L-1} = ybar (K5: [(ct_out0 + ct_sdf) /
//      scale, ct_out1..]; K3: ct_out as given); inpbar = zbar_l W_l^T; the
//      h part gives zbar_{l-1} = inpbar sig_{l-1} + ZC_{l-1}, the PE part
//      adds to XEB; bias gradients are column sums of zbar into DBACC;
//   5. K5: xbar = scale sum over the PE columns of (XEB PE' + ct_grad DIN
//      PE''); K3: xebar = XEB.
// The workspace gets X_l, FB_l, D_l and ZB_l for the weight-gradient stage.
template <bool kRays>
__device__ __forceinline__ void sdf_bwd_tile(const BwdArgs& a, Bwd& W, int row0) {
  const SdfArgs& s = a.s;
  const int last = s.n_lin - 1;
  const int t = threadIdx.x;  // a consumer thread
  constexpr int T = BWD_WG * 128;
  auto none = [] {};
  W.sp = 0;
  bwd_pe_stage(a, W, row0);
  fence_async_shared();
  consumer_sync();

  // forward l <= L-2
  for (int l = 0; l < last; ++l) {
    const Layer& Ly = s.L[l];
    const float* b = s.bias + Ly.b_off;
    const bool pre_last = l == last - 1;
    const float cx = l + 1 == s.skip ? INV_SQRT2 : 1.f;
    const int kp_next = s.L[l + 1].kp;
    bf16* X = s.X[l + 1] + (size_t)row0 * kp_next;  // X_{L-1}: not A's, stored here
    bwd_product(
        a, W, row0, pre_last ? OUT_D + l : OUT_X + l + 1,
        pre_last ? Ly.np : s.L[l + 1].in_w, nullptr, 0,
        [&](const Frag& f) {
          In2 in;
          in.a = make_float4(b[f.n], b[f.n + 1], 0.f, 0.f);
          if (pre_last) {
            in.a.z = s.wlast[f.n];
            in.a.w = s.wlast[f.n + 1];
          }
          return in;
        },
        [&](const Frag& f, float (&v)[4], const In2& in) {
          float sp[4], sig[4];
          act_pair(v[0] + in.a.x, sp[0], sig[0]);
          act_pair(v[1] + in.a.y, sp[1], sig[1]);
          act_pair(v[2] + in.a.x, sp[2], sig[2]);
          act_pair(v[3] + in.a.y, sp[3], sig[3]);
          *frag4(s.SIG[l], Ly.np, row0, f) = make_float4(sig[0], sig[1], sig[2], sig[3]);
          if (pre_last) {
            st_frag_bf16(X, kp_next, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
            const float w0 = in.a.z, w1 = in.a.w;
            const float d[4] = {w0 * sig[0], w1 * sig[1], w0 * sig[2], w1 * sig[3]};
            st_a(W.A, f, d[0], d[1], d[2], d[3]);
          } else {
            st_a(W.A, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
          }
        },
        [&] {
          if (l + 1 == s.skip) copy_pe(s, W, s.X[s.skip], kp_next, row0, s.hoff, s.hoff);
        });
  }

  // the reverse chain, l = L-2..0
  for (int l = last - 1; l >= 0; --l) {
    const Layer& Ly = s.L[l];
    const bool at_skip = l == s.skip;
    const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
    const int pe_off = at_skip ? s.hoff : 0;
    const bool din = kRays && (at_skip || l == 0);
    const float c2 = at_skip ? INV_SQRT2 : 1.f;
    const int np_prev = l > 0 ? s.L[l - 1].np : 0;
    if (l > 0) prefetch_tile(s.SIG[l - 1], np_prev, row0);
    bwd_product(
        a, W, row0, l > 0 ? OUT_D + l - 1 : -1, np_prev, nullptr, 0,
        [&](const Frag& f) {
          float4 sg = make_float4(0.f, 0.f, 0.f, 0.f);
          if (f.n < h_w) sg = *frag4(s.SIG[l - 1], np_prev, row0, f);
          return sg;
        },
        [&](const Frag& f, float (&v)[4], const float4& sg) {
          if (f.n < h_w) {  // h_w is a multiple of 16: whole fragments
            const float4 d = make_float4(v[0] * c2, v[1] * c2, v[2] * c2, v[3] * c2);
            *frag4(s.DS[l], np_prev, row0, f) = d;
            st_a(W.A, f, d.x * sg.x, d.y * sg.y, d.z * sg.z, d.w * sg.w);
          } else if (din) {
            add_pe(W.DIN, s.pe_pad, f, pe_off, v, c2);
          }
        },
        [&] {
          if (l == 0) copy_pe(s, W, a.FB[0], s.L[0].kp, row0, 0, 0);  // FB_0 = gbar
        });
  }

  // Phase A, ascending l
  for (int l = 0; l < last; ++l) {
    const Layer& Ly = s.L[l];
    const bool last_a = l == last - 1;
    const float cf = l + 1 == s.skip ? INV_SQRT2 : 1.f;
    const int kp_next = s.L[l + 1].kp;
    prefetch_tile(s.SIG[l], Ly.np, row0);
    if (!last_a) prefetch_tile(s.DS[l + 1], Ly.np, row0);
    bwd_product(
        a, W, row0, last_a ? -1 : OUT_F + l + 1, s.L[l + 1].in_w, last_a ? W.CBACC : nullptr,
        Ly.np,
        [&](const Frag& f) {
          In2 in;
          in.a = *frag4(s.SIG[l], Ly.np, row0, f);
          if (last_a) {
            const float w0 = s.wlast[f.n], w1 = s.wlast[f.n + 1];
            in.b = make_float4(w0, w1, w0, w1);
          } else {
            in.b = *frag4(s.DS[l + 1], Ly.np, row0, f);
          }
          return in;
        },
        [&](const Frag& f, float (&v)[4], const In2& in) {
          const float4 sp = in.a, dn = in.b;
          const float db[4] = {v[0] * sp.x, v[1] * sp.y, v[2] * sp.z, v[3] * sp.w};
          *frag4(a.ZC[l], Ly.np, row0, f) = make_float4(
              v[0] * dn.x * (100.f * sp.x * (1.f - sp.x)),
              v[1] * dn.y * (100.f * sp.y * (1.f - sp.y)),
              v[2] * dn.z * (100.f * sp.z * (1.f - sp.z)),
              v[3] * dn.w * (100.f * sp.w * (1.f - sp.w)));
          if (!last_a) st_a(W.A, f, db[0] * cf, db[1] * cf, db[2] * cf, db[3] * cf);
          const int g0 = row0 + f.r;
          const bool in0 = g0 < s.M, in1 = g0 + 8 < s.M;
          v[0] = in0 ? db[0] : 0.f;
          v[1] = in0 ? db[1] : 0.f;
          v[2] = in1 ? db[2] : 0.f;
          v[3] = in1 ? db[3] : 0.f;
        },
        [&] {
          if (l + 1 == s.skip) copy_pe(s, W, a.FB[s.skip], kp_next, row0, s.hoff, s.hoff);
        });
  }

  // Phase B: zbar_{L-1} = ybar into A and the workspace, and its column
  // sums (one thread a column, rows in order, the loads of RB rows in
  // flight together).  The last product's operand is free: both
  // warpgroups passed the barrier before its epilogue.
  {
    const Layer& Ly = s.L[last];
    constexpr int RB = 16;
    for (int n = t; n < Ly.np; n += T) {
      const bool real = n < a.n_out;
      const bool sdf_col = n == 0 && a.ct_sdf != nullptr;
      float sum = 0.f;
      for (int r0 = 0; r0 < TILE_M; r0 += RB) {
        float y[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int gr = row0 + r0 + k;
          y[k] = 0.f;
          if (real && gr < s.M) {
            y[k] = a.ct_out[(size_t)gr * a.n_out + n];
            if (sdf_col) y[k] = (y[k] + a.ct_sdf[gr]) / s.scale;
          }
        }
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int r = r0 + k;
          sum += y[k];
          *reinterpret_cast<bf16*>(W.A + a_off(r, n)) = __float2bfloat16(y[k]);
        }
      }
      W.DBACC[Ly.b_off + n] += sum;
    }
    fence_async_shared();
    consumer_sync();
    store_a(a, W, OUT_Z + last, Ly.np, row0);
  }
  for (int l = last; l >= 0; --l) {
    const Layer& Ly = s.L[l];
    const bool at_skip = l == s.skip;
    const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
    const int pe_off = at_skip ? s.hoff : 0;
    const bool has_pe = at_skip || l == 0;
    const float c2 = at_skip ? INV_SQRT2 : 1.f;
    const int np_prev = l > 0 ? s.L[l - 1].np : 0;
    if (l > 0) {
      prefetch_tile(s.SIG[l - 1], np_prev, row0);
      prefetch_tile(a.ZC[l - 1], np_prev, row0);
    }
    bwd_product(
        a, W, row0, l > 0 ? OUT_Z + l - 1 : -1, np_prev,
        l > 0 ? W.DBACC + s.L[l - 1].b_off : nullptr, h_w,
        [&](const Frag& f) {
          In2 in;
          in.a = in.b = make_float4(0.f, 0.f, 0.f, 0.f);
          if (f.n < h_w) {
            in.a = *frag4(s.SIG[l - 1], np_prev, row0, f);
            in.b = *frag4(a.ZC[l - 1], np_prev, row0, f);
          }
          return in;
        },
        [&](const Frag& f, float (&v)[4], const In2& in) {
          if (f.n < h_w) {
            const float4 sg = in.a, zc = in.b;
            const float zb[4] = {v[0] * c2 * sg.x + zc.x, v[1] * c2 * sg.y + zc.y,
                                 v[2] * c2 * sg.z + zc.z, v[3] * c2 * sg.w + zc.w};
            st_a(W.A, f, zb[0], zb[1], zb[2], zb[3]);
            const int g0 = row0 + f.r;
            const bool in0 = g0 < s.M, in1 = g0 + 8 < s.M;
            v[0] = in0 ? zb[0] : 0.f;
            v[1] = in0 ? zb[1] : 0.f;
            v[2] = in1 ? zb[2] : 0.f;
            v[3] = in1 ? zb[3] : 0.f;
            return;
          }
          if (has_pe) add_pe(W.XEB, s.pe_pad, f, pe_off, v, c2);
          v[0] = v[1] = v[2] = v[3] = 0.f;
        },
        none);
  }

  // the tile's outputs; DIN and XEB are complete (the last product's barrier)
  if (kRays) {
    // xbar = scale * sum_c (XEB PE' + ct_grad DIN PE'') over dim d's columns
    for (int i = t; i < TILE_M * 3; i += T) {
      const int r = i / 3, d = i % 3;
      const int gr = row0 + r;
      if (gr >= s.M) continue;
      const float xs = s.x[(size_t)gr * 3 + d] * s.scale;
      const float ctg = a.ct_grad[(size_t)gr * 3 + d];
      float g = 0.f;
      for (int c = 0; c < s.pe_dim; ++c) {
        int dc, kind;
        float f, v, j, j2;
        pe_col(c, dc, kind, f);
        if (dc != d) continue;
        pe_eval(kind, f, xs, v, j, j2);
        g += W.XEB[r * s.pe_pad + c] * j + ctg * W.DIN[r * s.pe_pad + c] * j2;
      }
      a.xbar[(size_t)gr * 3 + d] = g * s.scale;
    }
  } else {
    for (int i = t; i < TILE_M * s.pe_dim; i += T) {
      const int r = i / s.pe_dim, c = i % s.pe_dim;
      const int gr = row0 + r;
      if (gr < s.M) a.xbar[(size_t)gr * s.pe_dim + c] = W.XEB[r * s.pe_pad + c];
    }
  }
  sync_a();  // DIN, XEB and A free for the next tile
}

// The producer: the pass table's stages, tile after tile, into the ring
// (one thread).  A stage is refilled once every consumer warp gave it back.
__device__ __forceinline__ void bwd_produce(const BwdArgs& a, uint32_t ring, uint32_t full,
                                            uint32_t empty, int n_local) {
  int c = 0;
  for (int t = 0; t < n_local; ++t)
    for (int p = 0; p < a.n_sub; ++p) {
      const Sub sb = a.sub[p];
      const CUtensorMap* map = &a.maps[sb.map];
      const int nb = (sb.nw + BWD_BOX_ROWS - 1) / BWD_BOX_ROWS;
      for (int k0 = 0; k0 < sb.k; k0 += BWD_KS, ++c) {
        const int st = c % a.stages;
        if (c >= a.stages) mbar_wait(empty + 8 * st, ((c / a.stages) - 1) & 1);
        const uint32_t dst = ring + st * BWD_STAGE_BYTES, bar = full + 8 * st;
        mbar_expect_tx(bar, (uint32_t)(nb * BWD_BOX_BYTES));
        for (int b = 0; b < nb; ++b)
          tma_load(dst + b * BWD_BOX_BYTES, map, bar, k0, sb.n0 + b * BWD_BOX_ROWS);
      }
    }
}

// A block: its tiles blockIdx.x, + gridDim.x, ... in order; then the
// per-block bias and column-0 sums, for the reduction.
template <bool kRays>
__device__ __forceinline__ void sdf_bwd_block(const BwdArgs& a, unsigned char* smem) {
  const SdfArgs& s = a.s;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t pad = ((raw + BWD_ALIGN - 1) & ~(uint32_t)(BWD_ALIGN - 1)) - raw;
  unsigned char* base = smem + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t full = sbase + a.lay[LAY_BAR], empty = full + 8 * a.stages;
  const int n_tiles = s.M_pad / TILE_M;
  const int n_local = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int ncb = s.L[s.n_lin - 2].np;
  float* DBACC = reinterpret_cast<float*>(base + a.lay[LAY_DBACC]);
  float* CBACC = reinterpret_cast<float*>(base + a.lay[LAY_CBACC]);

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * BWD_WG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < a.n_bias; i += BWD_THREADS) DBACC[i] = 0.f;
  for (int i = threadIdx.x; i < ncb; i += BWD_THREADS) CBACC[i] = 0.f;
  __syncthreads();

  if (threadIdx.x >= BWD_WG * 128) {  // the producer warp; one thread issues
    if (threadIdx.x == BWD_WG * 128) bwd_produce(a, sbase, full, empty, n_local);
    return;
  }
  Bwd W;
  W.A = base + a.lay[LAY_A];
  W.a = sbase + a.lay[LAY_A];
  W.DIN = reinterpret_cast<float*>(base + a.lay[LAY_DIN]);
  W.XEB = reinterpret_cast<float*>(base + a.lay[LAY_XEB]);
  W.DBACC = DBACC;
  W.CBACC = CBACC;
  W.SCR = reinterpret_cast<float*>(base + a.lay[LAY_SCR]);
  W.ring = sbase;
  W.full = full;
  W.empty = empty;
  W.wg = threadIdx.x >> 7;
  W.c = W.sp = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    sdf_bwd_tile<kRays>(a, W, tile * TILE_M);
  if (threadIdx.x == 0) bulk_wait();  // the workspace stores complete

  for (int i = threadIdx.x; i < a.n_bias; i += BWD_WG * 128)
    a.dbpart[(size_t)blockIdx.x * a.n_bias + i] = DBACC[i];
  for (int i = threadIdx.x; i < ncb; i += BWD_WG * 128)
    a.cbpart[(size_t)blockIdx.x * ncb + i] = CBACC[i];
}

// The pass table, shared-memory layout and ring depth of a launch (also
// asked for alone through fmov_sdf_bwd_plan, sdf_bwd.cu); returns a
// cudaError_t, cudaErrorInvalidValue
// for a table the pass does not take: a hidden layer wider than one pass
// (its output is the next A operand, written by the pass at column 0), too
// many passes, or too little shared memory for two stages.  Per product,
// in tile order: forward l (map R_l, N = np, K = in_w), reverse l (F_l,
// N = in_w, K = np), Phase A l as forward, Phase B l as reverse; outputs
// wider than BWD_NW split into passes, the upper columns first.
inline int bwd_plan(BwdArgs& a) {
  const SdfArgs& s = a.s;
  const int last = s.n_lin - 1;
  int n = 0, max_k = 0;
  bool ok = true;
  auto add = [&](int map, int N, int K) {
    for (int n0 = (N - 1) / BWD_NW * BWD_NW; n0 >= 0; n0 -= BWD_NW) {
      if (n == BWD_MAX_SUB) {
        ok = false;
        return;
      }
      a.sub[n++] = Sub{map, n0, N - n0 < BWD_NW ? N - n0 : BWD_NW, K};
    }
    max_k = imax(max_k, K);
  };
  for (int l = 0; l < last; ++l)
    if (s.L[l].np > BWD_NW) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < last; ++l) add(2 * l + 1, s.L[l].np, s.L[l].in_w);
  for (int l = last - 1; l >= 0; --l) add(2 * l, s.L[l].in_w, s.L[l].np);
  for (int l = 0; l < last; ++l) add(2 * l + 1, s.L[l].np, s.L[l].in_w);
  for (int l = last; l >= 0; --l) add(2 * l, s.L[l].in_w, s.L[l].np);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.n_sub = n;

  int off = 0;
  auto take = [&](int part, size_t bytes) {
    a.lay[part] = off;
    off += (int)align128(bytes);
  };
  take(LAY_A, (size_t)(max_k + A_ATOM - 1) / A_ATOM * A_ATOM_BYTES);
  take(LAY_DIN, (size_t)TILE_M * s.pe_pad * 4);
  take(LAY_XEB, (size_t)TILE_M * s.pe_pad * 4);
  take(LAY_DBACC, (size_t)a.n_bias * 4);
  take(LAY_CBACC, (size_t)s.L[last - 1].np * 4);
  take(LAY_SCR, BWD_SCR_BYTES);
  a.stages = (BWD_SMEM_LIMIT - BWD_ALIGN - off) / (BWD_STAGE_BYTES + 16);
  if (a.stages > BWD_MAX_STAGES) a.stages = BWD_MAX_STAGES;
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  const int ring = a.stages * BWD_STAGE_BYTES;
  for (int part = LAY_A; part <= LAY_SCR; ++part) a.lay[part] += ring;
  a.lay[LAY_BAR] = ring + off;
  return 0;
}

inline int bwd_smem_bytes(const BwdArgs& a) {
  return BWD_ALIGN + a.lay[LAY_BAR] + 16 * a.stages;
}

// Host side of a backward launch: unpacks the workspace pointer table,
// plans the pass (bwd_plan), encodes each layer's two weight blocks as
// tensor maps (32 x 64 boxes, the 64-byte swizzle) and launches `kernel`
// (one block per SM at most).  The weight-gradient stage (wgrad.cu) runs
// next, launched by the caller.  ptrs: AB_0..AB_{L-1} ([FB_l; X_l], 2 M_pad
// rows of kp(l)), BB_0..BB_{L-1} ([D_l; ZB_l], 2 M_pad rows of np(l)),
// SIG_0..SIG_{L-2}, DS_1..DS_{L-2}, ZC_0..ZC_{L-2}, DBPART [G x n_bias],
// CBPART [G x np(L-2)], then DWPART, which only the stage reads (fused_sdf.py
// bwd_workspace_specs).  Returns a cudaError_t.
template <class Kernel>
inline int sdf_bwd_launch(Kernel kernel, BwdArgs& a, int n_bias,
                          const unsigned long long* ptrs, int G, cudaStream_t st) {
  SdfArgs& s = a.s;
  const int n_lin = s.n_lin;
  const int M_pad = s.M_pad;
  for (int l = 0; l < MAX_LIN; ++l) {
    a.FB[l] = a.ZB[l] = nullptr;
    a.ZC[l] = nullptr;
  }
  int p = 0;
  for (int l = 0; l < n_lin; ++l) {
    bf16* ab = reinterpret_cast<bf16*>(ptrs[p++]);
    a.FB[l] = ab;
    s.X[l] = ab + (size_t)M_pad * s.L[l].kp;
  }
  for (int l = 0; l < n_lin; ++l) {
    bf16* bb = reinterpret_cast<bf16*>(ptrs[p++]);
    s.D[l] = bb;
    a.ZB[l] = bb + (size_t)M_pad * s.L[l].np;
  }
  for (int l = 0; l < n_lin - 1; ++l) s.SIG[l] = reinterpret_cast<float*>(ptrs[p++]);
  for (int l = 1; l < n_lin - 1; ++l) s.DS[l] = reinterpret_cast<float*>(ptrs[p++]);
  for (int l = 0; l < n_lin - 1; ++l) a.ZC[l] = reinterpret_cast<float*>(ptrs[p++]);
  a.dbpart = reinterpret_cast<float*>(ptrs[p++]);
  a.cbpart = reinterpret_cast<float*>(ptrs[p++]);
  a.n_bias = n_bias;

  int e = bwd_plan(a);
  if (e) return e;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  for (int l = 0; l < n_lin; ++l) {
    const Layer& Ly = s.L[l];
    if (!tensor_map_2d(fn, &a.maps[2 * l], s.w + Ly.w_off, Ly.kp, Ly.np, Ly.np,
                       BWD_BOX_ROWS, BWD_KS, CU_TENSOR_MAP_SWIZZLE_64B) ||
        !tensor_map_2d(fn, &a.maps[2 * l + 1], s.w + Ly.r_off, Ly.kr, Ly.kp, Ly.kp,
                       BWD_BOX_ROWS, BWD_KS, CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  }
  // the bf16 operands the per-point pass writes through A (the first
  // halves of AB, the second halves of BB: FB_l, ZB_l; X_l, D_l)
  auto omap = [&](int m, const bf16* p, int w, int ld) {
    return tensor_map_2d(fn, &a.omaps[m], p, M_pad, w, ld, TILE_M, A_ATOM,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  };
  for (int l = 0; l < n_lin; ++l) {
    const Layer& Ly = s.L[l];
    if (!omap(OUT_X + l, s.X[l], Ly.in_w, Ly.kp) || !omap(OUT_D + l, s.D[l], Ly.np, Ly.np) ||
        !omap(OUT_F + l, a.FB[l], Ly.in_w, Ly.kp) || !omap(OUT_Z + l, a.ZB[l], Ly.np, Ly.np))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = bwd_smem_bytes(a);
  cudaError_t ce =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  if (s.M <= 0) return 0;
  kernel<<<G, BWD_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fmov_train
