// The per-point pipeline that the SDF training kernels (sdf_pipe.cuh: K4,
// K2, K5, K3) and the color MLP's backward (color_train.cuh: K9, K7) share.
//
// A block of 8 warps owns a 64-point tile at a time and runs the tile's
// fixed sequence of products A [64 x K] @ W [K x N], given as a type Seq
// with count(net) and product(net, p, off, K, N) (the weight block of
// product p); Net is the kernel's argument struct, read for its layer
// table L, n_lin, the packed weights w, ldb and M_pad.  Three parts:
//   * The weight ring.  The weights of that sequence are the same for
//     every tile, so they stream through a ring of RING chunk buffers
//     [KCHUNK x ldb] in shared memory with cp.async 16-byte copies, RING -
//     1 chunks ahead of the tensor cores, one barrier per chunk.  The ring
//     runs on across products and tiles: the next product's first chunks
//     are in flight during an epilogue, the next tile's during the output
//     stage.  Rows keep the SKEW pad, so ldmatrix is conflict-free.
//   * Register epilogues.  Products run on mma.sync m16n8k16 (bf16 in,
//     f32 accumulators; ldmatrix for A, ldmatrix.trans for the row-major
//     chunk).  Warp w owns the column tiles w, w + 8, w + 16 of every
//     product, so each accumulator register has a fixed (row, column), and
//     the epilogue functors run on registers.  Per-point f32 arrays that
//     only the owning block reads back can be stored in that fragment
//     order (frag4).  Each warp loads a column tile's epilogue inputs
//     before its stores, so the loads go out together.  Column sums: per
//     lane, then shuffles, in a fixed order.
//   * A operands on chip.  The caller keeps product p's A operand in one
//     of two shared-memory buffers, written by the epilogue of product p -
//     1 (or an input stage), so no product loads its A from device memory.

#pragma once

#include "train_common.cuh"

namespace fmov_train {

constexpr int RING = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The weight ring of one block over the sequence Seq.  Every thread keeps
// the same cursors: the next chunk to issue (product ip, chunk ic,
// block-local tile it) and the slots to issue into and consume from.
template <class Seq>
struct WRing {
  bf16* buf;  // RING x [KCHUNK x ldb]
  int ldb, n_prod, n_tiles;
  int ip, ic, it, islot, cslot;
};

// Issues the next chunk of the sequence into its slot (every thread its
// share of 16-byte copies) and commits a group, empty past the block's
// last tile.
template <class Seq, class Net>
__device__ __forceinline__ void ring_issue(const Net& s, WRing<Seq>& R) {
  if (R.it < R.n_tiles) {
    int off, K, N;
    Seq::product(s, R.ip, off, K, N);
    const bf16* src = s.w + off + (size_t)R.ic * KCHUNK * N;
    bf16* dst = R.buf + R.islot * (KCHUNK * R.ldb);
    const int vpr = N >> 3;
    for (int i = threadIdx.x; i < KCHUNK * vpr; i += THREADS) {
      const int r = i / vpr, c = (i - r * vpr) * 8;
      cp_async16(dst + r * R.ldb + c, src + (size_t)r * N + c);
    }
    if (++R.ic * KCHUNK == K) {
      R.ic = 0;
      if (++R.ip == R.n_prod) {
        R.ip = 0;
        ++R.it;
      }
    }
    R.islot = R.islot + 1 == RING ? 0 : R.islot + 1;
  }
  cp_async_commit();
}

// The ring at the start of a block, over the block's tiles (blockIdx.x,
// + gridDim.x, ...): RING - 1 chunks in flight.
template <class Seq, class Net>
__device__ __forceinline__ WRing<Seq> ring_start(const Net& s, bf16* buf) {
  const int n_tiles = s.M_pad / TILE_M;
  WRing<Seq> R;
  R.buf = buf;
  R.ldb = s.ldb;
  R.n_prod = Seq::count(s);
  R.n_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  R.ip = R.ic = R.it = R.islot = R.cslot = 0;
  for (int i = 0; i < RING - 1; ++i) ring_issue(s, R);
  return R;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a [16 x 16] b [16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One lane's share of a 16x8 accumulator tile of mma.sync: v[0], v[1] at
// (r, n), (r, n + 1) and v[2], v[3] at (r + 8, n), (r + 8, n + 1), with
// r = 16 i + lane / 4 and n = 16 j + 8 h + 2 (lane % 4).  Warp w owns the
// column tiles j = w, w + 8, w + 16 of every product, so an element's
// (warp, lane, register) depends on its (row, column) alone.
struct Frag {
  int i, j, h, r, n;
};

// The lane's float4 of a per-point f32 array in fragment order: the array
// [M_pad x W] is stored as [tile][W / 16][i, h][lane][4], so the group of
// 4 a lane holds is one 16-byte vector and a warp reads and writes whole
// 128-byte lines (fused_sdf.py bwd_workspace_specs gives it [M_pad / 64, 64 W]).
__device__ __forceinline__ float4* frag4(float* base, int W, int row0, const Frag& f) {
  const size_t grp = ((size_t)(row0 / TILE_M) * (W >> 4) + f.j) * 8 + f.i * 2 + f.h;
  return reinterpret_cast<float4*>(base + grp * 128) + (threadIdx.x & 31);
}

// What an epilogue loads for one Frag: up to two float4s of per-point
// arrays (or bias and last-layer weights).
struct In2 {
  float4 a, b;
};

__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc = A [TILE_M x K] (shared, row stride lda) @ the next K / KCHUNK
// chunks of the ring on mma.sync (ldmatrix for A, ldmatrix.trans for the
// row-major chunk), then the epilogue in registers, one column tile of
// the warp at a time: in = pre(f) for its 8 Frags first (the loads of
// all 8 in flight together, none behind a store that may alias it), then
// epi(f, v, in) for h = 0..1, i = 0..3 in that order, which may overwrite
// v with the values to add to the column sums.  When colsum is set, columns n < colsum_n get the sums of
// their 64 rows: per lane over its rows, then across the 8 lanes of a
// column by shuffles, in a fixed order.  Each chunk: wait for its copies,
// one barrier (the chunk visible to all, the slot consumed before free),
// issue the chunk RING - 1 ahead, multiply.  The first barrier comes
// before any product, so the block may still be writing A on entry.
template <class Seq, class Net, class Pre, class Epi>
__device__ __forceinline__ void pipe_gemm(const Net& s, WRing<Seq>& R, const bf16* A,
                                          int lda, int K, int N, float* colsum,
                                          int colsum_n, Pre pre, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncol = N >> 4;
  const int ldb = R.ldb;
  float acc[4][COLT][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < COLT; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][h][e] = 0.f;

  // ldmatrix row addresses: A rows lane % 16 at column 8 (lane / 16); B
  // (k x n) rows 8 ((lane / 8) % 2) + lane % 8 at column 8 (lane / 16)
  const unsigned a_lane = smem_u32(A + (lane & 15) * lda + (lane >> 4) * 8);
  const int b_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    cp_async_wait<RING - 2>();
    __syncthreads();
    ring_issue(s, R);
    const unsigned wb = smem_u32(R.buf + R.cslot * (KCHUNK * ldb) + b_lane);
    R.cslot = R.cslot + 1 == RING ? 0 : R.cslot + 1;
    if (warp < ncol) {
#pragma unroll
      for (int ks = 0; ks < KCHUNK; ks += 16) {
        unsigned b[COLT][4];
#pragma unroll
        for (int jj = 0; jj < COLT; ++jj) {
          const int j = warp + jj * WARPS;
          if (j < ncol) ldsm_x4_trans(b[jj], wb + (ks * ldb + j * 16) * 2);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned a[4];
          ldsm_x4(a, a_lane + (i * 16 * lda + k0 + ks) * 2);
#pragma unroll
          for (int jj = 0; jj < COLT; ++jj) {
            if (warp + jj * WARPS < ncol) {
              mma_bf16(acc[i][jj][0], a, b[jj][0], b[jj][1]);
              mma_bf16(acc[i][jj][1], a, b[jj][2], b[jj][3]);
            }
          }
        }
      }
    }
  }

  // The epilogue touches only this lane's elements: other warps may still
  // be in the K loop.
#pragma unroll
  for (int jj = 0; jj < COLT; ++jj) {
    const int j = warp + jj * WARPS;
    if (j >= ncol) continue;
    decltype(pre(Frag{})) in[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        in[h][i] = pre(Frag{i, j, h, i * 16 + (lane >> 2), j * 16 + h * 8 + (lane & 3) * 2});
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Frag f{i, j, h, i * 16 + (lane >> 2), j * 16 + h * 8 + (lane & 3) * 2};
        epi(f, acc[i][jj][h], in[h][i]);
        c0 += acc[i][jj][h][0] + acc[i][jj][h][2];
        c1 += acc[i][jj][h][1] + acc[i][jj][h][3];
      }
      if (colsum != nullptr) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        const int n = j * 16 + h * 8 + (lane & 3) * 2;
        if (lane < 4 && n < colsum_n) {
          colsum[n] += c0;
          colsum[n + 1] += c1;
        }
      }
    }
  }
}

// Stores the lane's 4 values as bf16 pairs at (r, n) and (r + 8, n) of a
// row-major array (workspace or shared memory) with row stride ld.
__device__ __forceinline__ void st_frag_bf16(bf16* P, size_t ld, const Frag& f,
                                             float v0, float v1, float v2, float v3) {
  st_bf16x2(P + f.r * ld + f.n, v0, v1);
  st_bf16x2(P + (f.r + 8) * ld + f.n, v2, v3);
}


// Zeros the columns [w, K) of a [TILE_M x K] A operand (row stride lda),
// so that the padded columns (whose weight rows are zero) hold no stale
// values.  All threads; w and K multiples of 8.
__device__ __forceinline__ void zero_a(bf16* An, int lda, int w, int K) {
  const int vpr = (K - w) / 8;
  for (int i = threadIdx.x; i < TILE_M * vpr; i += THREADS) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    *reinterpret_cast<uint4*>(An + r * lda + w + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace fmov_train
