// The per-point pipeline of the SDF forward kernels: K1 (sdf_fwd.cu), the
// gradient-free forward, runs sdf_fwd_tile; K4 (sdf_fwd_grad.cu) and K2
// (sdf_flat.cu), the forward with its gradient chain, run
// sdf_fwd_grad_tile.  The second-order backward (K5, K3) has a pipeline of
// its own, on TMA and wgmma (sdf_bwd_pass.cuh).
//
// The pipeline itself (the weight ring over a product sequence type,
// mma.sync register epilogues, A operands in shared memory) is pipe.cuh's,
// shared with the color MLP's kernels (color_train.cuh).  The sequences
// here: FwdOnlySeq, the forward alone, L products at L linears, 9 at
// 8x256; FwdSeq, the forward, the last layer included, and the reverse
// chain, 2 L - 1 products, 17 at 8x256.  The sigmoids, which only the
// owning block reads back, are stored in fragment order (frag4); K1
// writes nothing per point but its output rows.
//
// What bounds them now (NVIDIA H100 80GB HBM3, PERF.md): nothing overlaps.
// The epilogues (activations, and for K4/K2 SIG, 0.53 GB at M = 65,536,
// 8x256, and the f32 rows of out) run while the tensor cores idle, and the
// mma.sync loop stops at a barrier every 32 weight rows.

#pragma once

#include "pipe.cuh"
#include "sdf_train.cuh"

namespace fmov_train {

// The product sequences of a tile: product p's weight block (offset, K,
// N).  The ring issues them in this order and the tile consumes them in
// the same order, product for product and chunk for chunk.  kChain, a
// gradient chain follows the forward, so the forward layers store sig_l
// (SIG) and the encoding stage zeroes its d_inputs (DIN).
//
// K4/K2: p < L: forward l = p, the last layer included; then the reverse
// chain l = L-2..0.
struct FwdSeq {
  static constexpr bool kChain = true;
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
// An and, with Seq::kChain, sig_l (in fragment order).
template <class Seq>
__device__ __forceinline__ void forward_layer(const SdfArgs& s, int l, int row0,
                                              const bf16* A, bf16* An, WRing<Seq>& R) {
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
              if (Seq::kChain)
                *frag4(s.SIG[l], Ly.np, row0, f) = make_float4(sig[0], sig[1], sig[2], sig[3]);
              st_frag_bf16(An, s.lda, f, sp[0] * cx, sp[1] * cx, sp[2] * cx, sp[3] * cx);
            });
}

// Reverse-chain layer l <= L-2: f = D_l W_l^T (A = D_l); the h part gives
// d_l and D_{l-1} = bf16(d_l sig_{l-1}) into An; the PE part (l == S or
// l == 0) is added to DIN.
template <class Seq>
__device__ __forceinline__ void reverse_layer(const SdfArgs& s, int l, int row0,
                                              const bf16* A, bf16* An, float* DIN,
                                              WRing<Seq>& R) {
  const Layer& Ly = s.L[l];
  const bool at_skip = l == s.skip;
  const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
  const int pe_off = at_skip ? s.hoff : 0;
  const bool has_pe = at_skip || l == 0;
  const float c2 = at_skip ? INV_SQRT2 : 1.f;
  const int np_prev = l > 0 ? s.L[l - 1].np : 0;
  pipe_gemm(s, R, A, s.lda, Ly.kr, Ly.kp, nullptr, 0,
            [&](const Frag& f) {
              float4 sg = make_float4(0.f, 0.f, 0.f, 0.f);
              if (f.n < h_w) sg = *frag4(s.SIG[l - 1], np_prev, row0, f);
              return sg;
            },
            [&](const Frag& f, float (&v)[4], const float4& sg) {
              if (f.n < h_w) {  // h_w is a multiple of 16: whole fragments
                const float4 d = make_float4(v[0] * c2, v[1] * c2, v[2] * c2, v[3] * c2);
                const float e[4] = {d.x * sg.x, d.y * sg.y, d.z * sg.z, d.w * sg.w};
                st_frag_bf16(An, s.lda, f, e[0], e[1], e[2], e[3]);
              } else if (has_pe) {
                add_pe(DIN, s.pe_pad, f, pe_off, v, c2);
              }
            });
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
