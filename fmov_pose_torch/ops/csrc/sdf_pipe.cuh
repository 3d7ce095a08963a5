// The per-point pipeline of K1 (sdf_fwd.cu), the gradient-free SDF
// forward: sdf_fwd_tile.  K4 and K2, the forward with its gradient chain,
// run a pass of their own (sdf_fwd_grad_pass.cuh), as do K5 and K3, the
// second-order backward (sdf_bwd_pass.cuh); both on TMA and wgmma.
//
// The pipeline itself (the weight ring over a product sequence type,
// mma.sync register epilogues, A operands in shared memory) is pipe.cuh's,
// shared with the color MLP's kernels (color_train.cuh).  The sequence
// here, FwdOnlySeq, is the forward alone: L products at L linears, 9 at
// 8x256, on a forward-only table.  K1 writes nothing per point but its
// output rows.
//
// What bounds it (NVIDIA H100 80GB HBM3, PERF.md): nothing overlaps.  The
// epilogues (activations, and the f32 rows of out) run while the tensor
// cores idle, and the mma.sync loop stops at a barrier every 32 weight rows.

#pragma once

#include "pipe.cuh"
#include "sdf_train.cuh"

namespace fmov_train {

// The product sequence of a tile: product p's weight block (offset, K,
// N).  The ring issues them in this order and the tile consumes them in
// the same order, product for product and chunk for chunk.
//
// K1: p < L: forward l = p, the last layer included; a forward-only table.
struct FwdOnlySeq {
  static __device__ __forceinline__ int count(const SdfArgs& s) { return s.n_lin; }
  static __device__ __forceinline__ void product(const SdfArgs& s, int p, int& off,
                                                 int& K, int& N) {
    off = s.L[p].w_off;
    K = s.L[p].kp;
    N = s.L[p].np;
  }
};

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
  zero_a(An, lda, w, K);
}

// Forward layer l < L-1: z = X_l W_l + b_l (A = X_l); stores X_{l+1} into
// An.
__device__ __forceinline__ void forward_layer(const SdfArgs& s, int l, const bf16* A,
                                              bf16* An, WRing<FwdOnlySeq>& R) {
  const Layer& Ly = s.L[l];
  const float* b = s.bias + Ly.b_off;
  const float cx = l + 1 == s.skip ? INV_SQRT2 : 1.f;
  pipe_gemm(s, R, A, s.lda, Ly.kp, Ly.np, nullptr, 0,
            [&](const Frag& f) {
              In2 in;
              in.a = make_float4(b[f.n], b[f.n + 1], 0.f, 0.f);
              return in;
            },
            [&](const Frag& f, float (&v)[4], const In2& in) {
              float sp[4], sig[4];
              act_pair(v[0] + in.a.x, sp[0], sig[0]);
              act_pair(v[1] + in.a.y, sp[1], sig[1]);
              act_pair(v[2] + in.a.x, sp[2], sig[2]);
              act_pair(v[3] + in.a.y, sp[3], sig[3]);
              st_frag_bf16(An, s.lda, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
            });
}

// The shared memory of a forward block, in this order.
struct FwdSmem {
  bf16* A;     // 2 x [TILE_M x lda]: product p's A operand in A + (p % 2)
  bf16* ring;  // RING x [KCHUNK x ldb]
  bf16* PES;   // [TILE_M x pe_pad]: X_S's PE half, PE / sqrt2
};

inline size_t fwd_smem_bytes(const SdfArgs& s) {
  return 2 * align128((size_t)TILE_M * s.lda * 2) +
         align128((size_t)RING * KCHUNK * s.ldb * 2) +
         align128((size_t)TILE_M * s.pe_pad * 2);
}

__device__ __forceinline__ FwdSmem fwd_smem_carve(const SdfArgs& s, unsigned char* smem) {
  FwdSmem m;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  m.A = reinterpret_cast<bf16*>(take(2 * (size_t)TILE_M * s.lda * 2));
  m.ring = reinterpret_cast<bf16*>(take((size_t)RING * KCHUNK * s.ldb * 2));
  m.PES = reinterpret_cast<bf16*>(take((size_t)TILE_M * s.pe_pad * 2));
  return m;
}

// The tile's encoding into X_0 (in A, product 0's operand) and the PE half
// of X_S (PES), computed from x (rows past M encode x = 0).
__device__ __forceinline__ void fwd_pe_stage(const SdfArgs& s, int row0, const FwdSmem& m) {
  const int total = TILE_M * s.pe_pad;
  constexpr int PB = 4;  // passes whose loads are in flight together
  for (int i0 = threadIdx.x; i0 < total; i0 += PB * THREADS) {
    float u[PB];  // x at the column's dim
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * THREADS;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      const int gr = row0 + r;
      u[k] = 0.f;
      if (i < total && c < s.pe_dim && gr < s.M) {
        int d, kind;
        float f;
        pe_col(c, d, kind, f);
        u[k] = s.x[(size_t)gr * 3 + d];
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= total) break;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      float v = 0.f;
      if (c < s.pe_dim) {
        int d, kind;
        float f, j, j2;
        pe_col(c, d, kind, f);
        pe_eval(kind, f, u[k] * s.scale, v, j, j2);
      }
      m.A[r * s.lda + c] = __float2bfloat16(v);
      m.PES[i] = __float2bfloat16(v * INV_SQRT2);
    }
  }
  finish_a(s, m.A, s.pe_pad, nullptr, s.L[0].kp);
}

// Per tile (notation in sdf_train.cuh), the L products of FwdOnlySeq,
// product p's A operand in A + (p % 2), written by the epilogue (or stage)
// before it: the encoding stage, the forward l = 0..L-2 (X_{l+1} into the
// next A, nothing to device memory), then the last layer's product z =
// X_{L-1} W_{L-1} + b, whose out = [z0 / scale, z1..] goes out for the real
// rows and columns as scalars: out's row stride (4 n_out bytes) need not be
// 8-byte aligned.
__device__ __forceinline__ void sdf_fwd_tile(const SdfArgs& s, int row0, const FwdSmem& m,
                                             WRing<FwdOnlySeq>& R, float* out, int n_out) {
  const int last = s.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * s.lda;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  __syncthreads();  // PES, A free
  fwd_pe_stage(s, row0, m);
  for (int l = 0; l < last; ++l) {
    forward_layer(s, l, buf(l), buf(l + 1), R);
    if (l + 1 == s.skip)
      finish_a(s, buf(l + 1), s.hoff, m.PES, s.L[l + 1].kp);
    else
      finish_a(s, buf(l + 1), s.L[l].np, nullptr, s.L[l + 1].kp);
  }

  const Layer& Ly = s.L[last];
  const float* b = s.bias + Ly.b_off;
  pipe_gemm(s, R, buf(last), s.lda, Ly.kp, Ly.np, nullptr, 0,
            [&](const Frag& f) { return make_float2(b[f.n], b[f.n + 1]); },
            [&](const Frag& f, float (&v)[4], const float2& bn) {
              if (f.n >= n_out) return;
              const bool c1 = f.n + 1 < n_out;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int gr = row0 + f.r + 8 * half;
                if (gr >= s.M) continue;
                float z0 = v[2 * half] + bn.x;
                if (f.n == 0) z0 = z0 / s.scale;
                float* o = out + (size_t)gr * n_out + f.n;
                o[0] = z0;
                if (c1) o[1] = v[2 * half + 1] + bn.y;
              }
            });
}

// Host side of a launch: launches `kernel` (one block per SM at most) with
// (s, args...).  Returns a cudaError_t.
template <class Kernel, class... Args>
inline int sdf_fwd_launch(Kernel kernel, SdfArgs& s, int G, cudaStream_t st, Args... args) {
  const size_t smem = fwd_smem_bytes(s);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (s.M <= 0) return 0;
  kernel<<<G, THREADS, smem, st>>>(s, args...);
  return (int)cudaGetLastError();
}

}  // namespace fmov_train
