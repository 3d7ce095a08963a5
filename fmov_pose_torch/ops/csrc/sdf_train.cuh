// The SDF pieces the per-point training kernels share: K4 (sdf_fwd_grad.cu)
// and K2 (sdf_flat.cu) run sdf_fwd_grad_tile, K5 (sdf_bwd.cu) and K3
// (sdf_flat.cu) run sdf_bwd_tile; they differ only in their input and
// output stages.  The rays kernels K4/K5 take x [M x 3] and run the
// positional encoding and its derivatives per tile; the flat kernels K2/K3
// take the encoding xe [M x pe_dim] (and K3 the cotangent gbar of the
// d_inputs) as given and return d_inputs / xebar [M x pe_dim], the JAX
// kernels' boundary (fmov_pose_tpu/ops/fused_sdf.py:587-680).
//
// Notation (fmov_pose_tpu/ops/fused_sdf.py:407-434), L linears, skip S:
//   X_0 = PE(x s);  X_l = [h_l | PE/sqrt2] at l == S, else h_l (bf16)
//   z_l = X_l W_l + b_l;  h_{l+1} = sp(z_l), sig_l = sp'(z_l)  (l < L-1)
//   d_{L-1} = W_{L-1}[:, 0] (wlast);  D_l = bf16(d_{l+1} sig_l)
//   f_l = D_l W_l^T;  d_l = f_l[h] (/sqrt2 at S);  DIN += f_l[pe] (/sqrt2)
// Per-point arrays live in device memory, [M_pad x width] each, written
// and read only by the block that owns the rows.

#pragma once

#include "train_common.cuh"

namespace fmov_train {

struct SdfArgs {
  Layer L[MAX_LIN];
  int n_lin, skip, pe_dim, pe_pad, hoff, M, M_pad, lda, ldb;
  float scale;
  const float* x;        // [M x 3] (rays kernels)
  const float* xe_in;    // [M x pe_dim] (flat kernels; x unused)
  const float* gbar_in;  // [M x pe_dim] cotangent of d_inputs (K3)
  const bf16* w;         // packed blocks
  const float* bias;     // packed biases
  const float* wlast;    // W_{L-1}[:, 0], padded to np(L-2)
  bf16* X[MAX_LIN];      // layer inputs, row stride kp(l)
  bf16* D[MAX_LIN];      // D_l, row stride np(l), l < L-1
  float* SIG[MAX_LIN];   // sig_l, row stride np(l), l < L-1
  float* DS[MAX_LIN];    // d_l (backward only, 1 <= l <= L-2), row stride np(l-1)
};

// Fills the shared fields; returns a cudaError_t.
inline int sdf_setup(SdfArgs& s, const int* meta, int n_lin, int skip,
                     int multires, int M, int M_pad, float scale, int* max_k,
                     int* max_n, int* n_bias) {
  int e = read_layers(meta, n_lin, s.L, max_k, max_n, n_bias);
  if (e) return e;
  if (skip < 1 || skip > n_lin - 2 || multires < 1 || M_pad % TILE_M ||
      M > M_pad || (M > 0 && M_pad - M >= TILE_M))
    return (int)cudaErrorInvalidValue;
  s.n_lin = n_lin;
  s.skip = skip;
  s.pe_dim = 3 * (1 + 2 * multires);
  s.pe_pad = (s.pe_dim + 15) / 16 * 16;
  s.hoff = s.L[skip - 1].np;
  if (s.L[0].in_w != s.pe_pad || s.L[skip].in_w != s.hoff + s.pe_pad)
    return (int)cudaErrorInvalidValue;
  for (int l = 1; l < n_lin; ++l)
    if (l != skip && s.L[l].in_w != s.L[l - 1].np) return (int)cudaErrorInvalidValue;
  s.M = M;
  s.M_pad = M_pad;
  s.scale = scale;
  s.lda = *max_k + SKEW;
  s.ldb = *max_n + SKEW;
  s.x = s.xe_in = s.gbar_in = nullptr;
  for (int l = 0; l < MAX_LIN; ++l) {
    s.X[l] = s.D[l] = nullptr;
    s.SIG[l] = s.DS[l] = nullptr;
  }
  return 0;
}

// The tile's encoding into X_0 and the PE half of X_S: computed from x, or
// read from xe_in (flat kernels).  For a backward (FB0 set) also the
// cotangent of DIN, gbar = ct_grad[dim] * PE' (rays) or gbar_in (flat),
// into FB_0 and FB_S.  Zeroes DIN (and XEB) [TILE_M x pe_pad].
__device__ __forceinline__ void sdf_pe_stage(const SdfArgs& s, int row0,
                                             float* DIN, float* XEB,
                                             const float* ct_grad, bf16* FB0,
                                             bf16* FBS) {
  const int kp0 = s.L[0].kp, kps = s.L[s.skip].kp;
  for (int i = threadIdx.x; i < TILE_M * s.pe_pad; i += THREADS) {
    const int r = i / s.pe_pad, c = i % s.pe_pad;
    const int gr = row0 + r;
    float v = 0.f, g = 0.f;
    if (c < s.pe_dim) {
      if (s.xe_in != nullptr) {
        if (gr < s.M) {
          v = s.xe_in[(size_t)gr * s.pe_dim + c];
          if (FB0 != nullptr) g = s.gbar_in[(size_t)gr * s.pe_dim + c];
        }
      } else {
        int d, kind;
        float f, j, j2;
        pe_col(c, d, kind, f);
        const float xs = gr < s.M ? s.x[(size_t)gr * 3 + d] * s.scale : 0.f;
        pe_eval(kind, f, xs, v, j, j2);
        if (ct_grad != nullptr && gr < s.M) g = ct_grad[(size_t)gr * 3 + d] * j;
      }
    }
    s.X[0][(size_t)gr * kp0 + c] = __float2bfloat16(v);
    s.X[s.skip][(size_t)gr * kps + s.hoff + c] = __float2bfloat16(v * INV_SQRT2);
    if (FB0 != nullptr) {
      FB0[(size_t)gr * kp0 + c] = __float2bfloat16(g);
      FBS[(size_t)gr * kps + s.hoff + c] = __float2bfloat16(g * INV_SQRT2);
    }
    DIN[i] = 0.f;
    if (XEB != nullptr) XEB[i] = 0.f;
  }
}

// Forward layer l < L-1: z = X_l W_l + b_l; stores sig_l and X_{l+1}
// (and D_{L-2} = bf16(wlast sig) at l = L-2).
__device__ __forceinline__ void sdf_forward_layer(const SdfArgs& s, int l,
                                                  int row0, bf16* Asm,
                                                  bf16* wbuf, float* scr) {
  const Layer& Ly = s.L[l];
  __syncthreads();  // X_l complete, Asm free
  load_tile(Asm, s.lda, s.X[l] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
  const float* b = s.bias + Ly.b_off;
  const bool pre_last = l == s.n_lin - 2;
  const bool skip_next = l + 1 == s.skip;
  const int kp_next = s.L[l + 1].kp;
  tile_gemm(Asm, s.lda, s.w + Ly.w_off, Ly.kp, Ly.np, wbuf, s.ldb, scr,
            nullptr, 0, [&](int r, int n, float v) -> float {
              const size_t gr = (size_t)(row0 + r);
              float sp, sig;
              act_pair(v + b[n], sp, sig);
              s.SIG[l][gr * Ly.np + n] = sig;
              s.X[l + 1][gr * kp_next + n] =
                  __float2bfloat16(skip_next ? sp * INV_SQRT2 : sp);
              if (pre_last) s.D[l][gr * Ly.np + n] = __float2bfloat16(s.wlast[n] * sig);
              return 0.f;
            });
}

// Reverse-chain layer l <= L-2: f = D_l W_l^T; the h part gives d_l (kept
// in DS_l when set) and D_{l-1} = bf16(d_l sig_{l-1}); the PE part (l == S
// or l == 0) is added to DIN [TILE_M x pe_pad].
__device__ __forceinline__ void sdf_reverse_layer(const SdfArgs& s, int l,
                                                  int row0, bf16* Asm,
                                                  bf16* wbuf, float* scr,
                                                  float* DIN) {
  const Layer& Ly = s.L[l];
  __syncthreads();  // D_l complete, Asm free
  load_tile(Asm, s.lda, s.D[l] + (size_t)row0 * Ly.np, Ly.np, Ly.np, Ly.kr);
  const bool at_skip = l == s.skip;
  const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
  const int pe_off = at_skip ? s.hoff : 0;
  const bool has_pe = at_skip || l == 0;
  const float c2 = at_skip ? INV_SQRT2 : 1.f;
  const int np_prev = l > 0 ? s.L[l - 1].np : 0;
  float* ds = l > 0 ? s.DS[l] : nullptr;
  tile_gemm(Asm, s.lda, s.w + Ly.r_off, Ly.kr, Ly.kp, wbuf, s.ldb, scr,
            nullptr, 0, [&](int r, int n, float v) -> float {
              const size_t gr = (size_t)(row0 + r);
              if (n < h_w) {
                const float d = v * c2;
                const size_t idx = gr * np_prev + n;
                if (ds != nullptr) ds[idx] = d;
                s.D[l - 1][idx] = __float2bfloat16(d * s.SIG[l - 1][idx]);
              } else if (has_pe) {
                const int c = n - pe_off;
                if (c < s.pe_pad) DIN[r * s.pe_pad + c] += v * c2;
              }
              return 0.f;
            });
}

// Dynamic shared memory of a per-point SDF kernel: Asm, wbuf, per-warp
// scratch, then `extra` bytes.
inline size_t sdf_smem(const SdfArgs& s, size_t extra) {
  return align128((size_t)TILE_M * s.lda * 2) + align128((size_t)KCHUNK * s.ldb * 2) +
         align128((size_t)WARPS * 256 * 4) + extra;
}

// The shared-memory carve-up of a per-point SDF kernel (sdf_smem's order).
struct SdfSmem {
  bf16* Asm;
  bf16* wbuf;
  float* scr;   // this warp's 16x16 scratch
  size_t off;   // first byte after the scratch
};

__device__ __forceinline__ SdfSmem sdf_smem_carve(const SdfArgs& s,
                                                  unsigned char* smem) {
  SdfSmem m;
  m.Asm = reinterpret_cast<bf16*>(smem);
  size_t off = align128((size_t)TILE_M * s.lda * 2);
  m.wbuf = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)KCHUNK * s.ldb * 2);
  m.scr = reinterpret_cast<float*>(smem + off) + (threadIdx.x >> 5) * 256;
  m.off = off + align128((size_t)WARPS * 256 * 4);
  return m;
}

// ---------------------------------------------------------------------------
// Forward + gradient chain of one tile (K4, K2)
// ---------------------------------------------------------------------------

// The encoding stage, the forward, out = [z0 / scale, z1..] of the last
// layer (and sdf = z0 / scale when set), then the reverse chain: DIN
// [TILE_M x pe_pad] holds the tile's d_inputs on return (after a barrier).
__device__ __forceinline__ void sdf_fwd_grad_tile(const SdfArgs& s, int row0,
                                                  const SdfSmem& m, float* DIN,
                                                  float* out, int n_out,
                                                  float* sdf) {
  const int last = s.n_lin - 1;
  __syncthreads();  // DIN free
  sdf_pe_stage(s, row0, DIN, nullptr, nullptr, nullptr, nullptr);
  for (int l = 0; l < last; ++l) sdf_forward_layer(s, l, row0, m.Asm, m.wbuf, m.scr);
  {
    const Layer& Ly = s.L[last];
    __syncthreads();
    load_tile(m.Asm, s.lda, s.X[last] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
    const float* b = s.bias + Ly.b_off;
    tile_gemm(m.Asm, s.lda, s.w + Ly.w_off, Ly.kp, Ly.np, m.wbuf, s.ldb, m.scr,
              nullptr, 0, [&](int r, int n, float v) -> float {
                const int gr = row0 + r;
                if (gr < s.M && n < n_out) {
                  const float z = v + b[n];
                  const float o = n == 0 ? z / s.scale : z;
                  out[(size_t)gr * n_out + n] = o;
                  if (n == 0 && sdf != nullptr) sdf[gr] = o;
                }
                return 0.f;
              });
  }
  for (int l = last - 1; l >= 0; --l)
    sdf_reverse_layer(s, l, row0, m.Asm, m.wbuf, m.scr, DIN);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Second-order backward of one tile (K5, K3)
// ---------------------------------------------------------------------------

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

// Shared memory of the backward beyond sdf_smem's: DIN, XEB, the
// per-block bias sums and the last layer's column-0 sums.
inline size_t sdf_bwd_extra(const BwdArgs& a) {
  const SdfArgs& s = a.s;
  return 2 * align128((size_t)TILE_M * s.pe_pad * 4) + align128((size_t)a.n_bias * 4) +
         align128((size_t)s.L[s.n_lin - 2].np * 4);
}

// Per tile (derivation in the JAX module at ops/fused_sdf.py:407-434):
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
// DIN and XEB [TILE_M x pe_pad] hold the tile's d_inputs and xebar on
// return (after a barrier).
__device__ __forceinline__ void sdf_bwd_tile(const BwdArgs& a, int row0,
                                             const SdfSmem& m, float* DIN,
                                             float* XEB, float* DBACC,
                                             float* CBACC) {
  const SdfArgs& s = a.s;
  const int last = s.n_lin - 1;
  __syncthreads();  // DIN, XEB free
  sdf_pe_stage(s, row0, DIN, XEB, a.ct_grad, a.FB[0], a.FB[s.skip]);
  for (int l = 0; l < last; ++l) sdf_forward_layer(s, l, row0, m.Asm, m.wbuf, m.scr);
  for (int l = last - 1; l >= 0; --l)
    sdf_reverse_layer(s, l, row0, m.Asm, m.wbuf, m.scr, DIN);

  // Phase A: ascending l
  for (int l = 0; l < last; ++l) {
    const Layer& Ly = s.L[l];
    __syncthreads();
    load_tile(m.Asm, s.lda, a.FB[l] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
    const bool last_a = l == last - 1;
    const bool skip_next = l + 1 == s.skip;
    const int kp_next = s.L[l + 1].kp;
    const float* sig = s.SIG[l];
    const float* dsn = last_a ? nullptr : s.DS[l + 1];
    float* zc = a.ZC[l];
    bf16* fbn = last_a ? nullptr : a.FB[l + 1];
    tile_gemm(m.Asm, s.lda, s.w + Ly.w_off, Ly.kp, Ly.np, m.wbuf, s.ldb, m.scr,
              last_a ? CBACC : nullptr, Ly.np,
              [&](int r, int n, float v) -> float {
                const int gr = row0 + r;
                const size_t idx = (size_t)gr * Ly.np + n;
                const float sp = sig[idx];
                const float dn = last_a ? s.wlast[n] : dsn[idx];
                const float dbar = v * sp;
                zc[idx] = v * dn * (100.f * sp * (1.f - sp));
                if (!last_a)
                  fbn[(size_t)gr * kp_next + n] =
                      __float2bfloat16(skip_next ? dbar * INV_SQRT2 : dbar);
                return (last_a && gr < s.M) ? dbar : 0.f;
              });
  }

  // Phase B: zbar_{L-1} = ybar, and its column sums (one thread a column)
  {
    const Layer& Ly = s.L[last];
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_M * Ly.np; i += THREADS) {
      const int r = i / Ly.np, n = i % Ly.np;
      const int gr = row0 + r;
      float y = 0.f;
      if (gr < s.M && n < a.n_out) {
        y = a.ct_out[(size_t)gr * a.n_out + n];
        if (n == 0 && a.ct_sdf != nullptr) y = (y + a.ct_sdf[gr]) / s.scale;
      }
      a.ZB[last][(size_t)gr * Ly.np + n] = __float2bfloat16(y);
    }
    for (int n = threadIdx.x; n < Ly.np; n += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < TILE_M; ++r) {
        const int gr = row0 + r;
        if (gr < s.M && n < a.n_out) {
          float y = a.ct_out[(size_t)gr * a.n_out + n];
          if (n == 0 && a.ct_sdf != nullptr) y = (y + a.ct_sdf[gr]) / s.scale;
          sum += y;
        }
      }
      DBACC[Ly.b_off + n] += sum;
    }
  }
  for (int l = last; l >= 0; --l) {
    const Layer& Ly = s.L[l];
    __syncthreads();  // ZB_l complete, Asm free
    load_tile(m.Asm, s.lda, a.ZB[l] + (size_t)row0 * Ly.np, Ly.np, Ly.np, Ly.kr);
    const bool at_skip = l == s.skip;
    const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
    const int pe_off = at_skip ? s.hoff : 0;
    const bool has_pe = at_skip || l == 0;
    const float c2 = at_skip ? INV_SQRT2 : 1.f;
    const int np_prev = l > 0 ? s.L[l - 1].np : 0;
    const float* sig = l > 0 ? s.SIG[l - 1] : nullptr;
    const float* zc = l > 0 ? a.ZC[l - 1] : nullptr;
    bf16* zbp = l > 0 ? a.ZB[l - 1] : nullptr;
    float* cs = l > 0 ? DBACC + s.L[l - 1].b_off : nullptr;
    tile_gemm(m.Asm, s.lda, s.w + Ly.r_off, Ly.kr, Ly.kp, m.wbuf, s.ldb, m.scr, cs,
              h_w, [&](int r, int n, float v) -> float {
                const int gr = row0 + r;
                if (n < h_w) {
                  const size_t idx = (size_t)gr * np_prev + n;
                  const float zb = v * c2 * sig[idx] + zc[idx];
                  zbp[idx] = __float2bfloat16(zb);
                  return gr < s.M ? zb : 0.f;
                }
                if (has_pe) {
                  const int c = n - pe_off;
                  if (c < s.pe_pad) XEB[r * s.pe_pad + c] += v * c2;
                }
                return 0.f;
              });
  }
  __syncthreads();
}

// The per-block bias and column-0 sums of sdf_bwd_tile, written out for
// the reduction.
__device__ __forceinline__ void sdf_bwd_store_sums(const BwdArgs& a,
                                                   const float* DBACC,
                                                   const float* CBACC) {
  const int ncb = a.s.L[a.s.n_lin - 2].np;
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS)
    a.dbpart[(size_t)blockIdx.x * a.n_bias + i] = DBACC[i];
  for (int i = threadIdx.x; i < ncb; i += THREADS)
    a.cbpart[(size_t)blockIdx.x * ncb + i] = CBACC[i];
}

// Host side of a backward launch: unpacks the workspace pointer table,
// launches `kernel` (the per-point pass, one block per SM at most) and the
// weight-gradient product and reduction (train_common.cuh).
// ptrs: AB_0..AB_{L-1} ([FB_l; X_l], 2 M_pad rows of kp(l)), BB_0..BB_{L-1}
// ([D_l; ZB_l], 2 M_pad rows of np(l)), SIG_0..SIG_{L-2}, DS_1..DS_{L-2},
// ZC_0..ZC_{L-2}, DBPART [G x n_bias], CBPART [G x np(L-2)], DWPART
// [KS x sum in_w np] (fused_sdf.py bwd_workspace).  Returns a cudaError_t.
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
  const size_t smem = sdf_smem(s, sdf_bwd_extra(a));
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
