// The SDF pieces K4 (sdf_fwd_grad.cu) and K5 (sdf_bwd.cu) share: the
// per-tile positional encoding, one forward layer, and one layer of the
// reverse chain of d(sdf)/dx.
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
  const float* x;        // [M x 3]
  const bf16* w;         // packed blocks
  const float* bias;     // packed biases
  const float* wlast;    // W_{L-1}[:, 0], padded to np(L-2)
  bf16* X[MAX_LIN];      // layer inputs, row stride kp(l)
  bf16* D[MAX_LIN];      // D_l, row stride np(l), l < L-1
  float* SIG[MAX_LIN];   // sig_l, row stride np(l), l < L-1
  float* DS[MAX_LIN];    // d_l (K5 only, 1 <= l <= L-2), row stride np(l-1)
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
  return 0;
}

// The tile's PE columns into X_0 and the PE half of X_S; for K5 also the
// gradient cotangent gbar = ct_grad[dim] * PE' into FB_0 and FB_S.
// Zeroes DIN (and XEB) [TILE_M x pe_pad].
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
      int d, kind;
      float f, j, j2;
      pe_col(c, d, kind, f);
      const float xs = gr < s.M ? s.x[(size_t)gr * 3 + d] * s.scale : 0.f;
      pe_eval(kind, f, xs, v, j, j2);
      if (ct_grad != nullptr && gr < s.M) g = ct_grad[(size_t)gr * 3 + d] * j;
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

}  // namespace fmov_train
