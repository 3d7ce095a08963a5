// The per-point pass of the second-order SDF backward, K5 (sdf_bwd.cu)
// and K3 (sdf_flat.cu): sdf_bwd_tile and its launch.
//
// A block of 8 warps owns a 64-point tile at a time and runs the tile's
// fixed sequence of products A [64 x K] @ W [K x N] (bwd_product): the
// forward to layer L-2, the reverse chain, Phase A and Phase B, 4 L - 3
// products at L linears (33 at 8x256).  Three parts:
//   * The weight ring.  The weights of that sequence are the same for
//     every tile, so they stream through a ring of RING chunk buffers
//     [KCHUNK x ldb] in shared memory with cp.async 16-byte copies, RING -
//     1 chunks ahead of the tensor cores, one barrier per chunk.  The ring
//     runs on across products and tiles: the next product's first chunks
//     are in flight during an epilogue, the next tile's during the xbar /
//     xebar stage.  Rows keep the SKEW pad, so ldmatrix is conflict-free.
//   * Register epilogues.  Products run on mma.sync m16n8k16 (bf16 in,
//     f32 accumulators; ldmatrix for A, ldmatrix.trans for the row-major
//     chunk).  Warp w owns the column tiles w, w + 8, w + 16 of every
//     product, so each accumulator register has a fixed (row, column), and
//     the epilogue functors run on registers.  The f32 arrays that only the
//     owning block reads back (SIG, DS, ZC) are stored in that fragment
//     order (frag4): a lane reads back exactly the 16-byte vector it
//     wrote, a warp whole 128-byte lines.  Each warp loads a column tile's
//     epilogue inputs before its stores, so the loads go out together.
//     Column sums: per lane, then shuffles, in a fixed order.
//   * A operands on chip.  Product p reads its A from A + (p % 2) in shared
//     memory, written by the epilogue of product p - 1 (or the encoding and
//     ybar stages), which also writes the bf16 operands of the
//     weight-gradient product (X, D, FB, ZB) row-major to the workspace.
//
// What bounds it now (NVIDIA H100 80GB HBM3, PERF.md): the workspace
// traffic of the epilogues (~5 GB of f32 and bf16 per-point arrays at M =
// 65,536, 8x256), during which the tensor cores idle, and the weight
// stream from L2 (~4 MB a tile); the products themselves are a small part.

#pragma once

#include "sdf_train.cuh"

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

// Product p of a tile's sequence: the weight block (offset, K, N) it
// streams.  p < L-1: forward l = p; then the reverse chain l = L-2..0;
// Phase A l = 0..L-2; Phase B l = L-1..0.
__device__ __forceinline__ void bwd_product(const SdfArgs& s, int p, int& off,
                                            int& K, int& N) {
  const int L1 = s.n_lin - 1;
  int l;
  bool rev;
  if (p < L1) {
    l = p;
    rev = false;
  } else if (p < 2 * L1) {
    l = 2 * L1 - 1 - p;
    rev = true;
  } else if (p < 3 * L1) {
    l = p - 2 * L1;
    rev = false;
  } else {
    l = 4 * L1 - p;
    rev = true;
  }
  const Layer& Ly = s.L[l];
  off = rev ? Ly.r_off : Ly.w_off;
  K = rev ? Ly.kr : Ly.kp;
  N = rev ? Ly.kp : Ly.np;
}

// The weight ring of one block.  Every thread keeps the same cursors: the
// next chunk to issue (product ip, chunk ic, block-local tile it) and the
// slots to issue into and consume from.
struct WRing {
  bf16* buf;  // RING x [KCHUNK x ldb]
  int ldb, n_prod, n_tiles;
  int ip, ic, it, islot, cslot;
};

// Issues the next chunk of the sequence into its slot (every thread its
// share of 16-byte copies) and commits a group, empty past the block's
// last tile.
__device__ __forceinline__ void ring_issue(const SdfArgs& s, WRing& R) {
  if (R.it < R.n_tiles) {
    int off, K, N;
    bwd_product(s, R.ip, off, K, N);
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

// The ring at the start of a block: RING - 1 chunks in flight.
__device__ __forceinline__ WRing ring_start(const SdfArgs& s, bf16* buf, int n_tiles) {
  WRing R;
  R.buf = buf;
  R.ldb = s.ldb;
  R.n_prod = 4 * s.n_lin - 3;
  R.n_tiles = n_tiles;
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
// epi(f, v, in), which may overwrite v with the values to add to the
// column sums.  When colsum is set, columns n < colsum_n get the sums of
// their 64 rows: per lane over its rows, then across the 8 lanes of a
// column by shuffles, in a fixed order.  Each chunk: wait for its copies,
// one barrier (the chunk visible to all, the slot consumed before free),
// issue the chunk RING - 1 ahead, multiply.  The first barrier comes
// before any product, so the block may still be writing A on entry.
template <class Pre, class Epi>
__device__ __forceinline__ void pipe_gemm(const SdfArgs& s, WRing& R, const bf16* A,
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

struct BwdArgs {
  SdfArgs s;
  bf16* FB[MAX_LIN];     // fbar_l, row stride kp(l), l < L-1
  bf16* ZB[MAX_LIN];     // zbar_l, row stride np(l)
  float* ZC[MAX_LIN];    // Hessian term, row stride np(l), l < L-1
  const float* ct_out;   // [M x n_out]: K5 the cotangent of out, K3 ybar
  const float* ct_sdf;   // [M] (K5; null for K3, whose ybar is given)
  const float* ct_grad;  // [M x 3] (K5)
  float* xbar;           // [M x 3] (K5) or xebar [M x pe_dim] (K3)
  float* dbpart;         // [G x n_bias]
  float* cbpart;         // [G x np(L-2)]
  int n_out, n_bias;
};

// The shared memory of a backward block, in this order.
struct BwdSmem {
  bf16* A;       // 2 x [TILE_M x lda]: product p's A operand in A + (p % 2)
  bf16* ring;    // RING x [KCHUNK x ldb]
  float* DIN;    // [TILE_M x pe_pad]
  float* XEB;    // [TILE_M x pe_pad]
  bf16* PES;     // [TILE_M x pe_pad]: X_S's PE half, PE / sqrt2
  bf16* G0;      // [TILE_M x pe_pad]: FB_0 = gbar
  bf16* GS;      // [TILE_M x pe_pad]: FB_S's gbar half, gbar / sqrt2
  float* DBACC;  // [n_bias]
  float* CBACC;  // [np(L-2)]
};

inline size_t bwd_smem_bytes(const BwdArgs& a) {
  const SdfArgs& s = a.s;
  return 2 * align128((size_t)TILE_M * s.lda * 2) +
         align128((size_t)RING * KCHUNK * s.ldb * 2) +
         2 * align128((size_t)TILE_M * s.pe_pad * 4) +
         3 * align128((size_t)TILE_M * s.pe_pad * 2) + align128((size_t)a.n_bias * 4) +
         align128((size_t)s.L[s.n_lin - 2].np * 4);
}

__device__ __forceinline__ BwdSmem bwd_smem_carve(const BwdArgs& a,
                                                  unsigned char* smem) {
  const SdfArgs& s = a.s;
  BwdSmem m;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  const size_t a_bytes = (size_t)TILE_M * s.lda * 2;
  m.A = reinterpret_cast<bf16*>(take(2 * a_bytes));
  m.ring = reinterpret_cast<bf16*>(take((size_t)RING * KCHUNK * s.ldb * 2));
  m.DIN = reinterpret_cast<float*>(take((size_t)TILE_M * s.pe_pad * 4));
  m.XEB = reinterpret_cast<float*>(take((size_t)TILE_M * s.pe_pad * 4));
  m.PES = reinterpret_cast<bf16*>(take((size_t)TILE_M * s.pe_pad * 2));
  m.G0 = reinterpret_cast<bf16*>(take((size_t)TILE_M * s.pe_pad * 2));
  m.GS = reinterpret_cast<bf16*>(take((size_t)TILE_M * s.pe_pad * 2));
  m.DBACC = reinterpret_cast<float*>(take((size_t)a.n_bias * 4));
  m.CBACC = reinterpret_cast<float*>(take((size_t)s.L[s.n_lin - 2].np * 4));
  return m;
}

// The block's start: zeroed sums and the ring's first chunks in flight.
__device__ __forceinline__ WRing bwd_block_start(const BwdArgs& a, const BwdSmem& m) {
  const SdfArgs& s = a.s;
  const int ncb = s.L[s.n_lin - 2].np;
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS) m.DBACC[i] = 0.f;
  for (int i = threadIdx.x; i < ncb; i += THREADS) m.CBACC[i] = 0.f;
  const int n_tiles = s.M_pad / TILE_M;
  const int mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  return ring_start(s, m.ring, mine);
}

// Completes the next product's A operand An [TILE_M x K] after an
// epilogue wrote its columns [0, w): the PE half pe [TILE_M x pe_pad]
// (when set) into [w, w + pe_pad), and zeros up to K, so that the padded
// columns (whose weight rows are zero) hold no stale values.  All threads;
// disjoint from the epilogue's columns, so no barrier in between.
__device__ __forceinline__ void finish_a(const SdfArgs& s, bf16* An, int w,
                                         const bf16* pe, int K) {
  const int lda = s.lda;
  if (pe != nullptr) {
    const int vpr = s.pe_pad / 8;
    for (int i = threadIdx.x; i < TILE_M * vpr; i += THREADS) {
      const int r = i / vpr, c = (i - r * vpr) * 8;
      *reinterpret_cast<uint4*>(An + r * lda + w + c) =
          *reinterpret_cast<const uint4*>(pe + r * s.pe_pad + c);
    }
    w += s.pe_pad;
  }
  const int vpr = (K - w) / 8;
  for (int i = threadIdx.x; i < TILE_M * vpr; i += THREADS) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    *reinterpret_cast<uint4*>(An + r * lda + w + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The tile's encoding into X_0 (in A, product 0's operand, and the
// workspace) and the PE half of X_S, and gbar, the cotangent of DIN
// (ct_grad[dim] * PE' for the rays kernel, gbar_in for the flat one),
// into FB_0 and FB_S; the halves the later products need stay in PES, G0
// and GS.  Zeroes DIN and XEB.
__device__ __forceinline__ void bwd_pe_stage(const BwdArgs& a, int row0,
                                             const BwdSmem& m) {
  const SdfArgs& s = a.s;
  const int kp0 = s.L[0].kp, kps = s.L[s.skip].kp;
  const int total = TILE_M * s.pe_pad;
  constexpr int PB = 4;  // passes whose loads are in flight together
  for (int i0 = threadIdx.x; i0 < total; i0 += PB * THREADS) {
    float u[PB], w[PB];  // flat: xe and gbar_in; rays: x and ct_grad at the dim
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * THREADS;
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
      const int i = i0 + k * THREADS;
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
      m.A[r * s.lda + c] = bv;
      m.PES[i] = bvs;
      m.G0[i] = bg;
      m.GS[i] = bgs;
      m.DIN[i] = 0.f;
      m.XEB[i] = 0.f;
    }
  }
  finish_a(s, m.A, s.pe_pad, nullptr, kp0);
}

// Adds the lane's 4 values, times c, to a [TILE_M x pe_pad] f32 array at
// column c0 = f.n - off (the PE part of a reverse product).
__device__ __forceinline__ void add_pe(float* P, int pe_pad, const Frag& f, int off,
                                       const float (&v)[4], float c) {
  const int c0 = f.n - off;
  if (c0 < pe_pad) {
    P[f.r * pe_pad + c0] += v[0] * c;
    P[f.r * pe_pad + c0 + 1] += v[1] * c;
    P[(f.r + 8) * pe_pad + c0] += v[2] * c;
    P[(f.r + 8) * pe_pad + c0 + 1] += v[3] * c;
  }
}

// Stores the lane's 4 values as bf16 pairs at (r, n) and (r + 8, n) of a
// row-major array (workspace or shared memory) with row stride ld.
__device__ __forceinline__ void st_frag_bf16(bf16* P, size_t ld, const Frag& f,
                                             float v0, float v1, float v2, float v3) {
  st_bf16x2(P + f.r * ld + f.n, v0, v1);
  st_bf16x2(P + (f.r + 8) * ld + f.n, v2, v3);
}

// Forward layer l < L-1: z = X_l W_l + b_l (A = X_l); stores sig_l and
// X_{l+1} (into An and the workspace), or at l = L-2 X_{L-1} (workspace
// only) and D_{L-2} = bf16(wlast sig) (An and the workspace).
__device__ __forceinline__ void bwd_forward_layer(const SdfArgs& s, int l, int row0,
                                                  const bf16* A, bf16* An, WRing& R) {
  const Layer& Ly = s.L[l];
  const float* b = s.bias + Ly.b_off;
  const bool pre_last = l == s.n_lin - 2;
  const float cx = l + 1 == s.skip ? INV_SQRT2 : 1.f;
  const int kp_next = s.L[l + 1].kp;
  bf16* X = s.X[l + 1] + (size_t)row0 * kp_next;
  bf16* D = s.D[l] + (size_t)row0 * Ly.np;
  pipe_gemm(s, R, A, s.lda, Ly.kp, Ly.np, nullptr, 0,
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
              st_frag_bf16(X, kp_next, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
              if (pre_last) {
                const float w0 = in.a.z, w1 = in.a.w;
                const float d[4] = {w0 * sig[0], w1 * sig[1], w0 * sig[2], w1 * sig[3]};
                st_frag_bf16(D, Ly.np, f, d[0], d[1], d[2], d[3]);
                st_frag_bf16(An, s.lda, f, d[0], d[1], d[2], d[3]);
              } else {
                st_frag_bf16(An, s.lda, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
              }
            });
}

// Reverse-chain layer l <= L-2: f = D_l W_l^T (A = D_l); the h part gives
// d_l (kept in DS_l) and D_{l-1} = bf16(d_l sig_{l-1}) (An and the
// workspace); the PE part (l == S or l == 0) is added to DIN.
__device__ __forceinline__ void bwd_reverse_layer(const SdfArgs& s, int l, int row0,
                                                  const bf16* A, bf16* An, float* DIN,
                                                  WRing& R) {
  const Layer& Ly = s.L[l];
  const bool at_skip = l == s.skip;
  const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
  const int pe_off = at_skip ? s.hoff : 0;
  const bool has_pe = at_skip || l == 0;
  const float c2 = at_skip ? INV_SQRT2 : 1.f;
  const int np_prev = l > 0 ? s.L[l - 1].np : 0;
  bf16* D = l > 0 ? s.D[l - 1] + (size_t)row0 * np_prev : nullptr;
  pipe_gemm(s, R, A, s.lda, Ly.kr, Ly.kp, nullptr, 0,
            [&](const Frag& f) {
              float4 sg = make_float4(0.f, 0.f, 0.f, 0.f);
              if (f.n < h_w) sg = *frag4(s.SIG[l - 1], np_prev, row0, f);
              return sg;
            },
            [&](const Frag& f, float (&v)[4], const float4& sg) {
              if (f.n < h_w) {  // h_w is a multiple of 16: whole fragments
                const float4 d = make_float4(v[0] * c2, v[1] * c2, v[2] * c2, v[3] * c2);
                *frag4(s.DS[l], np_prev, row0, f) = d;
                const float e[4] = {d.x * sg.x, d.y * sg.y, d.z * sg.z, d.w * sg.w};
                st_frag_bf16(D, np_prev, f, e[0], e[1], e[2], e[3]);
                st_frag_bf16(An, s.lda, f, e[0], e[1], e[2], e[3]);
              } else if (has_pe) {
                add_pe(DIN, s.pe_pad, f, pe_off, v, c2);
              }
            });
}

// Per tile (derivation in the JAX module at ops/fused_sdf.py:407-434), 4 L
// - 3 products p in bwd_product's order, product p's A operand in
// A + (p % 2), written by the epilogue (or stage) before it:
//   1. the encoding stage, with gbar into FB_0 and FB_S;
//   2. forward to layer L-2 (sig_l, X_l) and the reverse chain (d_l, D_l,
//      DIN), recomputed as the JAX kernels do;
//   3. Phase A, ascending l <= L-2: fbar_l (gbar at l = 0, [dbar/sqrt2 |
//      gbar/sqrt2] at S), ebar = fbar_l W_l, dbar_{l+1} = ebar sig_l, the
//      Hessian term ZC_l = ebar d_{l+1} 100 sig_l (1 - sig_l); at l = L-2
//      the column sums of dbar (the last layer's column-0 term) into CBACC;
//   4. Phase B, descending l: zbar_{L-1} = ybar (K5: [(ct_out0 + ct_sdf) /
//      scale, ct_out1..]; K3: ct_out as given); inpbar = zbar_l W_l^T; the
//      h part gives zbar_{l-1} = inpbar sig_{l-1} + ZC_{l-1}, the PE part
//      adds to XEB; bias gradients are column sums of zbar into DBACC.
// The workspace gets X_l, FB_l, D_l and ZB_l for the weight-gradient
// product.  DIN and XEB hold the tile's d_inputs and xebar on return
// (after a barrier).
__device__ __forceinline__ void sdf_bwd_tile(const BwdArgs& a, int row0,
                                             const BwdSmem& m, WRing& R) {
  const SdfArgs& s = a.s;
  const int last = s.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * s.lda;
  int p = 0;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  __syncthreads();  // DIN, XEB, A free
  bwd_pe_stage(a, row0, m);

  for (int l = 0; l < last; ++l, ++p) {
    bwd_forward_layer(s, l, row0, buf(p), buf(p + 1), R);
    if (l + 1 == s.skip)
      finish_a(s, buf(p + 1), s.hoff, m.PES, s.L[l + 1].kp);
    else if (l + 1 < last)
      finish_a(s, buf(p + 1), s.L[l].np, nullptr, s.L[l + 1].kp);
    else
      finish_a(s, buf(p + 1), s.L[l].np, nullptr, s.L[l].kr);  // D_{L-2}
  }
  for (int l = last - 1; l >= 0; --l, ++p) {
    bwd_reverse_layer(s, l, row0, buf(p), buf(p + 1), m.DIN, R);
    if (l > 0)
      finish_a(s, buf(p + 1), s.L[l - 1].np, nullptr, s.L[l - 1].kr);
    else
      finish_a(s, buf(p + 1), 0, m.G0, s.L[0].kp);  // FB_0 = gbar
  }

  // Phase A: ascending l
  for (int l = 0; l < last; ++l, ++p) {
    const Layer& Ly = s.L[l];
    const bool last_a = l == last - 1;
    const float cf = l + 1 == s.skip ? INV_SQRT2 : 1.f;
    const int kp_next = s.L[l + 1].kp;
    bf16* F = last_a ? nullptr : a.FB[l + 1] + (size_t)row0 * kp_next;
    bf16* An = buf(p + 1);
    pipe_gemm(s, R, buf(p), s.lda, Ly.kp, Ly.np, last_a ? m.CBACC : nullptr, Ly.np,
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
                if (!last_a) {
                  st_frag_bf16(F, kp_next, f, db[0] * cf, db[1] * cf, db[2] * cf, db[3] * cf);
                  st_frag_bf16(An, s.lda, f, db[0] * cf, db[1] * cf, db[2] * cf,
                               db[3] * cf);
                }
                const int g0 = row0 + f.r;
                const bool in0 = g0 < s.M, in1 = g0 + 8 < s.M;
                v[0] = in0 ? db[0] : 0.f;
                v[1] = in0 ? db[1] : 0.f;
                v[2] = in1 ? db[2] : 0.f;
                v[3] = in1 ? db[3] : 0.f;
              });
    if (l + 1 == s.skip)
      finish_a(s, An, s.hoff, m.GS, kp_next);
    else if (!last_a)
      finish_a(s, An, Ly.np, nullptr, kp_next);
  }

  // Phase B: zbar_{L-1} = ybar into its A operand and the workspace, and
  // its column sums (one thread a column, rows in order, the loads of RB
  // rows in flight together).  The previous product reads the other
  // buffer, so no barrier comes first.
  {
    const Layer& Ly = s.L[last];
    bf16* An = buf(p);
    bf16* Z = a.ZB[last] + (size_t)row0 * Ly.np;
    constexpr int RB = 16;
    for (int n = threadIdx.x; n < Ly.np; n += THREADS) {
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
          const bf16 by = __float2bfloat16(y[k]);
          Z[(size_t)r * Ly.np + n] = by;
          An[r * s.lda + n] = by;
        }
      }
      m.DBACC[Ly.b_off + n] += sum;
    }
    finish_a(s, An, Ly.np, nullptr, Ly.kr);
  }
  for (int l = last; l >= 0; --l, ++p) {
    const Layer& Ly = s.L[l];
    const bool at_skip = l == s.skip;
    const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
    const int pe_off = at_skip ? s.hoff : 0;
    const bool has_pe = at_skip || l == 0;
    const float c2 = at_skip ? INV_SQRT2 : 1.f;
    const int np_prev = l > 0 ? s.L[l - 1].np : 0;
    float* cs = l > 0 ? m.DBACC + s.L[l - 1].b_off : nullptr;
    float* XEB = m.XEB;
    bf16* Z = l > 0 ? a.ZB[l - 1] + (size_t)row0 * np_prev : nullptr;
    bf16* An = buf(p + 1);
    pipe_gemm(s, R, buf(p), s.lda, Ly.kr, Ly.kp, cs, h_w,
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
                  st_frag_bf16(Z, np_prev, f, zb[0], zb[1], zb[2], zb[3]);
                  st_frag_bf16(An, s.lda, f, zb[0], zb[1], zb[2], zb[3]);
                  const int g0 = row0 + f.r;
                  const bool in0 = g0 < s.M, in1 = g0 + 8 < s.M;
                  v[0] = in0 ? zb[0] : 0.f;
                  v[1] = in0 ? zb[1] : 0.f;
                  v[2] = in1 ? zb[2] : 0.f;
                  v[3] = in1 ? zb[3] : 0.f;
                  return;
                }
                if (has_pe) add_pe(XEB, s.pe_pad, f, pe_off, v, c2);
                v[0] = v[1] = v[2] = v[3] = 0.f;
              });
    if (l > 0) finish_a(s, An, np_prev, nullptr, s.L[l - 1].kr);
  }
  __syncthreads();
}

// The block's end: no copy left in flight, and the per-block bias and
// column-0 sums written out for the reduction.
__device__ __forceinline__ void bwd_block_end(const BwdArgs& a, const BwdSmem& m) {
  cp_async_wait<0>();
  const int ncb = a.s.L[a.s.n_lin - 2].np;
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS)
    a.dbpart[(size_t)blockIdx.x * a.n_bias + i] = m.DBACC[i];
  for (int i = threadIdx.x; i < ncb; i += THREADS)
    a.cbpart[(size_t)blockIdx.x * ncb + i] = m.CBACC[i];
}

// Host side of a backward launch: unpacks the workspace pointer table,
// launches `kernel` (the per-point pass, one block per SM at most) and the
// weight-gradient product and reduction (train_common.cuh).
// ptrs: AB_0..AB_{L-1} ([FB_l; X_l], 2 M_pad rows of kp(l)), BB_0..BB_{L-1}
// ([D_l; ZB_l], 2 M_pad rows of np(l)), SIG_0..SIG_{L-2}, DS_1..DS_{L-2},
// ZC_0..ZC_{L-2}, DBPART [G x n_bias], CBPART [G x np(L-2)], DWPART
// [KS x sum in_w np] (fused_sdf.py _bwd_workspace).  Returns a
// cudaError_t.
template <class Kernel>
inline int sdf_bwd_launch(Kernel kernel, BwdArgs& a, int n_bias,
                          const unsigned long long* ptrs, int G, int KS,
                          float* dw, float* db, cudaStream_t st) {
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
  float* dwpart = reinterpret_cast<float*>(ptrs[p++]);
  a.n_bias = n_bias;

  const int ncb = s.L[n_lin - 2].np;
  const size_t smem = bwd_smem_bytes(a);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (s.M <= 0) return 0;
  kernel<<<G, THREADS, smem, st>>>(a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;

  AtbArgs t;
  t.n_jobs = n_lin;
  t.KS = KS;
  int total = 0;
  for (int l = 0; l < n_lin; ++l) {
    AtbJob& J = t.job[l];
    const Layer& L = s.L[l];
    const bool only_b = l == n_lin - 1;  // no Phase A product
    J.a = only_b ? s.X[l] : a.FB[l];
    J.b = only_b ? a.ZB[l] : s.D[l];
    J.rows = only_b ? M_pad : 2 * M_pad;
    J.lda = L.kp;
    J.ldb = L.np;
    J.ni = L.in_w;
    J.nj = L.np;
    J.out = dwpart + total;
    total += L.in_w * L.np;
  }
  const int cb_off = total - s.L[n_lin - 1].in_w * s.L[n_lin - 1].np;
  return weight_grads(t, dwpart, total, dw, a.dbpart, G, n_bias, db, a.cbpart,
                      ncb, cb_off, s.L[n_lin - 1].np, st);
}

}  // namespace fmov_train
