// The per-point pipeline of the SDF kernels: K1 (sdf_fwd.cu), the
// gradient-free forward, runs sdf_fwd_tile; K4 (sdf_fwd_grad.cu) and K2
// (sdf_flat.cu), the forward with its gradient chain, run
// sdf_fwd_grad_tile; K5 (sdf_bwd.cu) and K3 (sdf_flat.cu), the second-order
// backward, run sdf_bwd_tile.
//
// The pipeline itself (the weight ring over a product sequence type,
// mma.sync register epilogues, A operands in shared memory) is pipe.cuh's,
// shared with the color MLP's kernels (color_train.cuh).  The sequences
// here: FwdOnlySeq, the forward alone, L products at L linears, 9 at
// 8x256; FwdSeq, the forward, the last layer included, and the reverse
// chain, 2 L - 1 products, 17 at 8x256; BwdSeq, the forward to layer L-2,
// the reverse chain, Phase A and Phase B, 4 L - 3 products, 33 at 8x256.
// The f32 arrays that only the owning block reads back (SIG, DS, ZC) are
// stored in fragment order (frag4).  The backward's layers also write the
// bf16 operands of its weight-gradient product (X, D, FB, ZB) row-major to
// the workspace; the forward with the gradient chain writes only SIG
// there, and K1 writes nothing per point but its output rows.
//
// What bounds them now (NVIDIA H100 80GB HBM3, PERF.md): nothing
// overlaps.  The epilogues (for K5/K3 ~5 GB of f32 and bf16 per-point
// arrays at M = 65,536, 8x256; for K4/K2 SIG, 0.53 GB, and the f32 rows of
// out) run while the tensor cores idle, and the mma.sync loop, the largest
// part, stops at a barrier every 32 weight rows.

#pragma once

#include "pipe.cuh"
#include "sdf_train.cuh"

namespace fmov_train {

// The product sequences of a tile: product p's weight block (offset, K,
// N).  The ring issues them in this order and the tile consumes them in
// the same order, product for product and chunk for chunk.  Two
// compile-time flags gate the stores only some sequences need (the
// backward kernels sit at the register limit): kChain, a gradient chain
// follows the forward, so the forward layers store sig_l (SIG) and the
// encoding stage zeroes its d_inputs (DIN); kOperands, the layers also
// store the weight-gradient product's operands (X_l, D_l, DS_l) in the
// workspace, which only the backward needs.
//
// K5/K3: p < L-1: forward l = p; then the reverse chain l = L-2..0; Phase
// A l = 0..L-2; Phase B l = L-1..0.
struct BwdSeq {
  static constexpr bool kChain = true;
  static constexpr bool kOperands = true;
  static __device__ __forceinline__ int count(const SdfArgs& s) { return 4 * s.n_lin - 3; }
  static __device__ __forceinline__ void product(const SdfArgs& s, int p, int& off,
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
};

// K4/K2: p < L: forward l = p, the last layer included; then the reverse
// chain l = L-2..0.
struct FwdSeq {
  static constexpr bool kChain = true;
  static constexpr bool kOperands = false;
  static __device__ __forceinline__ int count(const SdfArgs& s) { return 2 * s.n_lin - 1; }
  static __device__ __forceinline__ void product(const SdfArgs& s, int p, int& off,
                                                 int& K, int& N) {
    const bool rev = p >= s.n_lin;
    const Layer& Ly = s.L[rev ? 2 * s.n_lin - 2 - p : p];
    off = rev ? Ly.r_off : Ly.w_off;
    K = rev ? Ly.kr : Ly.kp;
    N = rev ? Ly.kp : Ly.np;
  }
};

// K1: p < L: forward l = p, the last layer included; a forward-only table.
struct FwdOnlySeq {
  static constexpr bool kChain = false;
  static constexpr bool kOperands = false;
  static __device__ __forceinline__ int count(const SdfArgs& s) { return s.n_lin; }
  static __device__ __forceinline__ void product(const SdfArgs& s, int p, int& off,
                                                 int& K, int& N) {
    off = s.L[p].w_off;
    K = s.L[p].kp;
    N = s.L[p].np;
  }
};

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
__device__ __forceinline__ WRing<BwdSeq> bwd_block_start(const BwdArgs& a,
                                                         const BwdSmem& m) {
  const SdfArgs& s = a.s;
  const int ncb = s.L[s.n_lin - 2].np;
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS) m.DBACC[i] = 0.f;
  for (int i = threadIdx.x; i < ncb; i += THREADS) m.CBACC[i] = 0.f;
  return ring_start<BwdSeq>(s, m.ring);
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
  zero_a(An, lda, w, K);
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

// Forward layer l < L-1: z = X_l W_l + b_l (A = X_l); stores X_{l+1} into
// An and, with Seq::kChain, sig_l (in fragment order).  With
// Seq::kOperands (the backward), X_{l+1} also goes to the workspace, and
// at l = L-2, which has no last-layer product after it, D_{L-2} =
// bf16(wlast sig) takes X_{L-1}'s place in An (and goes to the workspace).
template <class Seq>
__device__ __forceinline__ void forward_layer(const SdfArgs& s, int l, int row0,
                                              const bf16* A, bf16* An, WRing<Seq>& R) {
  constexpr bool ops = Seq::kOperands;
  const Layer& Ly = s.L[l];
  const float* b = s.bias + Ly.b_off;
  const bool pre_last = ops && l == s.n_lin - 2;
  const float cx = l + 1 == s.skip ? INV_SQRT2 : 1.f;
  const int kp_next = s.L[l + 1].kp;
  bf16* X = ops ? s.X[l + 1] + (size_t)row0 * kp_next : nullptr;
  bf16* D = ops ? s.D[l] + (size_t)row0 * Ly.np : nullptr;
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
              if (Seq::kChain)
                *frag4(s.SIG[l], Ly.np, row0, f) = make_float4(sig[0], sig[1], sig[2], sig[3]);
              if (ops)
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
// d_l and D_{l-1} = bf16(d_l sig_{l-1}) into An (with Seq::kOperands also
// d_l into DS_l and D_{l-1} into the workspace); the PE part (l == S or
// l == 0) is added to DIN.
template <class Seq>
__device__ __forceinline__ void reverse_layer(const SdfArgs& s, int l, int row0,
                                              const bf16* A, bf16* An, float* DIN,
                                              WRing<Seq>& R) {
  constexpr bool ops = Seq::kOperands;
  const Layer& Ly = s.L[l];
  const bool at_skip = l == s.skip;
  const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
  const int pe_off = at_skip ? s.hoff : 0;
  const bool has_pe = at_skip || l == 0;
  const float c2 = at_skip ? INV_SQRT2 : 1.f;
  const int np_prev = l > 0 ? s.L[l - 1].np : 0;
  bf16* D = ops && l > 0 ? s.D[l - 1] + (size_t)row0 * np_prev : nullptr;
  pipe_gemm(s, R, A, s.lda, Ly.kr, Ly.kp, nullptr, 0,
            [&](const Frag& f) {
              float4 sg = make_float4(0.f, 0.f, 0.f, 0.f);
              if (f.n < h_w) sg = *frag4(s.SIG[l - 1], np_prev, row0, f);
              return sg;
            },
            [&](const Frag& f, float (&v)[4], const float4& sg) {
              if (f.n < h_w) {  // h_w is a multiple of 16: whole fragments
                const float4 d = make_float4(v[0] * c2, v[1] * c2, v[2] * c2, v[3] * c2);
                if (ops) *frag4(s.DS[l], np_prev, row0, f) = d;
                const float e[4] = {d.x * sg.x, d.y * sg.y, d.z * sg.z, d.w * sg.w};
                if (ops) st_frag_bf16(D, np_prev, f, e[0], e[1], e[2], e[3]);
                st_frag_bf16(An, s.lda, f, e[0], e[1], e[2], e[3]);
              } else if (has_pe) {
                add_pe(DIN, s.pe_pad, f, pe_off, v, c2);
              }
            });
}

// Per tile (derivation in the JAX module at ops/fused_sdf.py:407-434), 4 L
// - 3 products p in BwdSeq's order, product p's A operand in
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
                                             const BwdSmem& m, WRing<BwdSeq>& R) {
  const SdfArgs& s = a.s;
  const int last = s.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * s.lda;
  int p = 0;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  __syncthreads();  // DIN, XEB, A free
  bwd_pe_stage(a, row0, m);

  for (int l = 0; l < last; ++l, ++p) {
    forward_layer(s, l, row0, buf(p), buf(p + 1), R);
    if (l + 1 == s.skip)
      finish_a(s, buf(p + 1), s.hoff, m.PES, s.L[l + 1].kp);
    else if (l + 1 < last)
      finish_a(s, buf(p + 1), s.L[l].np, nullptr, s.L[l + 1].kp);
    else
      finish_a(s, buf(p + 1), s.L[l].np, nullptr, s.L[l].kr);  // D_{L-2}
  }
  for (int l = last - 1; l >= 0; --l, ++p) {
    reverse_layer(s, l, row0, buf(p), buf(p + 1), m.DIN, R);
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

// Host side of a backward launch: unpacks the workspace pointer table and
// launches `kernel` (the per-point pass, one block per SM at most).  The
// weight-gradient stage (wgrad.cu) runs next, launched by the caller.
// ptrs: AB_0..AB_{L-1} ([FB_l; X_l], 2 M_pad rows of kp(l)), BB_0..BB_{L-1}
// ([D_l; ZB_l], 2 M_pad rows of np(l)), SIG_0..SIG_{L-2}, DS_1..DS_{L-2},
// ZC_0..ZC_{L-2}, DBPART [G x n_bias], CBPART [G x np(L-2)], then DWPART,
// which only the stage reads (fused_sdf.py bwd_workspace_specs).  Returns
// a cudaError_t.
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

  const size_t smem = bwd_smem_bytes(a);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (s.M <= 0) return 0;
  kernel<<<G, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward: alone (K1), and with its gradient chain (K4, K2)
// ---------------------------------------------------------------------------

// The shared memory of a forward block, in this order.
struct FwdSmem {
  bf16* A;     // 2 x [TILE_M x lda]: product p's A operand in A + (p % 2)
  bf16* ring;  // RING x [KCHUNK x ldb]
  float* DIN;  // [TILE_M x pe_pad] (Seq::kChain; else null)
  bf16* PES;   // [TILE_M x pe_pad]: X_S's PE half, PE / sqrt2
};

template <class Seq>
inline size_t fwd_smem_bytes(const SdfArgs& s) {
  return 2 * align128((size_t)TILE_M * s.lda * 2) +
         align128((size_t)RING * KCHUNK * s.ldb * 2) +
         (Seq::kChain ? align128((size_t)TILE_M * s.pe_pad * 4) : 0) +
         align128((size_t)TILE_M * s.pe_pad * 2);
}

template <class Seq>
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
  m.DIN = Seq::kChain ? reinterpret_cast<float*>(take((size_t)TILE_M * s.pe_pad * 4))
                      : nullptr;
  m.PES = reinterpret_cast<bf16*>(take((size_t)TILE_M * s.pe_pad * 2));
  return m;
}

// The tile's encoding into X_0 (in A, product 0's operand) and the PE half
// of X_S (PES): computed from x (rays kernels; rows past M encode x = 0),
// or read from xe_in (flat kernel).  Zeroes DIN (Seq::kChain).
template <class Seq>
__device__ __forceinline__ void fwd_pe_stage(const SdfArgs& s, int row0,
                                             const FwdSmem& m) {
  const int total = TILE_M * s.pe_pad;
  constexpr int PB = 4;  // passes whose loads are in flight together
  for (int i0 = threadIdx.x; i0 < total; i0 += PB * THREADS) {
    float u[PB];  // flat: xe; rays: x at the column's dim
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * THREADS;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      const int gr = row0 + r;
      u[k] = 0.f;
      if (i < total && c < s.pe_dim && gr < s.M) {
        if (s.xe_in != nullptr) {
          u[k] = s.xe_in[(size_t)gr * s.pe_dim + c];
        } else {
          int d, kind;
          float f;
          pe_col(c, d, kind, f);
          u[k] = s.x[(size_t)gr * 3 + d];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= total) break;
      const int r = i / s.pe_pad, c = i % s.pe_pad;
      float v = 0.f;
      if (c < s.pe_dim) {
        if (s.xe_in != nullptr) {
          v = u[k];
        } else {
          int d, kind;
          float f, j, j2;
          pe_col(c, d, kind, f);
          pe_eval(kind, f, u[k] * s.scale, v, j, j2);
        }
      }
      m.A[r * s.lda + c] = __float2bfloat16(v);
      m.PES[i] = __float2bfloat16(v * INV_SQRT2);
      if (Seq::kChain) m.DIN[i] = 0.f;
    }
  }
  finish_a(s, m.A, s.pe_pad, nullptr, s.L[0].kp);
}

// The tile's encoding and the forward l = 0..L-2 (X_{l+1} into the next
// A, and sig_l into SIG with Seq::kChain): products 0..L-2, the last
// layer's operand X_{L-1} in A + ((L-1) % 2) on return.
template <class Seq>
__device__ __forceinline__ void forward_hidden(const SdfArgs& s, int row0, const FwdSmem& m,
                                               WRing<Seq>& R) {
  const int last = s.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * s.lda;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  __syncthreads();  // DIN, PES, A free
  fwd_pe_stage<Seq>(s, row0, m);
  for (int l = 0; l < last; ++l) {
    forward_layer(s, l, row0, buf(l), buf(l + 1), R);
    if (l + 1 == s.skip)
      finish_a(s, buf(l + 1), s.hoff, m.PES, s.L[l + 1].kp);
    else
      finish_a(s, buf(l + 1), s.L[l].np, nullptr, s.L[l + 1].kp);
  }
}

// The last layer's product: z = X_{L-1} W_{L-1} + b (A = X_{L-1}); out =
// [z0 / scale, z1..] for the real rows and columns (and sdf = out[:, 0]
// when set), stored as scalars: out's row stride (4 n_out bytes) need not
// be 8-byte aligned.
template <class Seq>
__device__ __forceinline__ void last_out(const SdfArgs& s, int row0, const bf16* A,
                                         WRing<Seq>& R, float* out, int n_out, float* sdf) {
  const Layer& Ly = s.L[s.n_lin - 1];
  const float* b = s.bias + Ly.b_off;
  pipe_gemm(s, R, A, s.lda, Ly.kp, Ly.np, nullptr, 0,
            [&](const Frag& f) { return make_float2(b[f.n], b[f.n + 1]); },
            [&](const Frag& f, float (&v)[4], const float2& bn) {
              if (f.n >= n_out) return;
              const bool c1 = f.n + 1 < n_out;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int gr = row0 + f.r + 8 * half;
                if (gr >= s.M) continue;
                float z0 = v[2 * half] + bn.x;
                if (f.n == 0) {
                  z0 = z0 / s.scale;
                  if (sdf != nullptr) sdf[gr] = z0;
                }
                float* o = out + (size_t)gr * n_out + f.n;
                o[0] = z0;
                if (c1) o[1] = v[2 * half + 1] + bn.y;
              }
            });
}

// The last layer (last_out), then each warp writes D_{L-2} = bf16(wlast
// sig_{L-2}), the first reverse product's operand, into An for its column
// tiles of np(L-2): An held X_{L-2}, which no warp reads once all have
// passed this product's first barrier.
__device__ __forceinline__ void last_layer(const SdfArgs& s, int row0, const bf16* A,
                                           bf16* An, WRing<FwdSeq>& R, float* out,
                                           int n_out, float* sdf) {
  const int last = s.n_lin - 1;
  last_out(s, row0, A, R, out, n_out, sdf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npd = s.L[last - 1].np;
  float* sig = s.SIG[last - 1];
  for (int j = warp; j < npd >> 4; j += WARPS) {
    float4 sg[2][4];
    float2 w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = j * 16 + h * 8 + (lane & 3) * 2;
      w[h] = make_float2(s.wlast[n], s.wlast[n + 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sg[h][i] = *frag4(sig, npd, row0, Frag{i, j, h, i * 16 + (lane >> 2), n});
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Frag f{i, j, h, i * 16 + (lane >> 2), j * 16 + h * 8 + (lane & 3) * 2};
        const float4 g = sg[h][i];
        st_frag_bf16(An, s.lda, f, w[h].x * g.x, w[h].y * g.y, w[h].x * g.z, w[h].y * g.w);
      }
  }
}

// Per tile (notation in sdf_train.cuh), 2 L - 1 products p in FwdSeq's
// order, product p's A operand in A + (p % 2), written by the epilogue (or
// stage) before it:
//   1. the encoding stage;
//   2. the forward l = 0..L-2 (sig_l into SIG_l, X_{l+1} into the next A);
//   3. the last layer: out (and sdf), then D_{L-2};
//   4. the reverse chain l = L-2..0 (D_{l-1} into the next A, the PE parts
//      added to DIN).
// Only SIG goes to the workspace.  DIN holds the tile's d_inputs on return
// (after a barrier).
__device__ __forceinline__ void sdf_fwd_grad_tile(const SdfArgs& s, int row0,
                                                  const FwdSmem& m, WRing<FwdSeq>& R,
                                                  float* out, int n_out, float* sdf) {
  const int last = s.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * s.lda;
  int p = last;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  forward_hidden(s, row0, m, R);
  last_layer(s, row0, buf(p), buf(p + 1), R, out, n_out, sdf);
  finish_a(s, buf(p + 1), s.L[last - 1].np, nullptr, s.L[last - 1].kr);  // D_{L-2}
  ++p;
  for (int l = last - 1; l >= 0; --l, ++p) {
    reverse_layer(s, l, row0, buf(p), buf(p + 1), m.DIN, R);
    if (l > 0) finish_a(s, buf(p + 1), s.L[l - 1].np, nullptr, s.L[l - 1].kr);
  }
  __syncthreads();
}

// Per tile, K1: the L products of FwdOnlySeq, product p's A operand in A
// + (p % 2): the encoding stage, the forward l = 0..L-2 (X_{l+1} into the
// next A, nothing to the workspace), then the last layer's out rows.
__device__ __forceinline__ void sdf_fwd_tile(const SdfArgs& s, int row0, const FwdSmem& m,
                                             WRing<FwdOnlySeq>& R, float* out, int n_out) {
  const int last = s.n_lin - 1;
  forward_hidden(s, row0, m, R);
  last_out(s, row0, m.A + (last & 1) * (size_t)TILE_M * s.lda, R, out, n_out, nullptr);
}

// Host side of a forward launch: with Seq::kChain takes SIG_0..SIG_{L-2}
// from the pointer table (fused_sdf.py fwd_workspace_specs; K1 has none)
// and launches `kernel` (one block per SM at most) with (s, args...).
// Returns a cudaError_t.
template <class Seq, class Kernel, class... Args>
inline int sdf_fwd_launch(Kernel kernel, SdfArgs& s, const unsigned long long* ptrs,
                          int G, cudaStream_t st, Args... args) {
  if (Seq::kChain)
    for (int l = 0; l < s.n_lin - 1; ++l) s.SIG[l] = reinterpret_cast<float*>(ptrs[l]);
  const size_t smem = fwd_smem_bytes<Seq>(s);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (s.M <= 0) return 0;
  kernel<<<G, THREADS, smem, st>>>(s, args...);
  return (int)cudaGetLastError();
}

}  // namespace fmov_train
