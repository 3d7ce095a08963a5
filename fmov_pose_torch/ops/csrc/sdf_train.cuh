// The SDF pieces the per-point kernels share: the SdfArgs, the layer
// table's checks and the notation.  K1 (sdf_fwd.cu) runs sdf_fwd_tile in
// sdf_pipe.cuh (a cp.async weight ring, mma.sync register epilogues, A
// operands in shared memory); K4 (sdf_fwd_grad.cu) and K2 (sdf_flat.cu)
// run sdf_fwd_grad_block in sdf_fwd_grad_pass.cuh (a TMA weight ring,
// wgmma products with A in registers, two tiles a block); K5 (sdf_bwd.cu)
// and K3 (sdf_flat.cu) run sdf_bwd_tile in sdf_bwd_pass.cuh (a TMA weight
// ring, wgmma products, the tile's columns split between two warpgroups).
// Each pair of the training kernels differs only in its input and output
// stages.  The rays
// kernels K4/K5 take x [M x 3] and run the positional encoding and its
// derivatives per tile; the flat kernels K2/K3 take the encoding xe [M x
// pe_dim] (and K3 the cotangent gbar of the d_inputs) as given and return
// d_inputs / xebar [M x pe_dim], the JAX kernels' boundary
// (fmov_pose_tpu/ops/fused_sdf.py:587-680).
//
// Notation (fmov_pose_tpu/ops/fused_sdf.py:407-434), L linears, skip S:
//   X_0 = PE(x s);  X_l = [h_l | PE/sqrt2] at l == S, else h_l (bf16)
//   z_l = X_l W_l + b_l;  h_{l+1} = sp(z_l), sig_l = sp'(z_l)  (l < L-1)
//   d_{L-1} = W_{L-1}[:, 0] (wlast);  D_l = bf16(d_{l+1} sig_l)
//   f_l = D_l W_l^T;  d_l = f_l[h] (/sqrt2 at S);  DIN += f_l[pe] (/sqrt2)
// Per-point arrays live in device memory, [M_pad x width] each (the f32
// ones in fragment order, train_common.cuh frag4), written and read only
// by the block that owns the rows.

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
  const float* wlast;    // W_{L-1}[:, 0], padded to np(L-2) (not K1)
  bf16* X[MAX_LIN];      // layer inputs, row stride kp(l) (backward)
  bf16* D[MAX_LIN];      // D_l, row stride np(l), l < L-1 (backward)
  float* SIG[MAX_LIN];   // sig_l, width np(l), l < L-1
  float* DS[MAX_LIN];    // d_l (backward, 1 <= l <= L-2), width np(l-1)
};

// Fills the shared fields; returns a cudaError_t.  reverse: the kernel
// runs the gradient chain, whose table has reverse blocks and whose skip
// layer is a hidden one (the chain starts from the last layer's column 0
// against the hidden width); else (K1) the table is forward-only and the
// skip may be the last linear (fused_sdf.py supported, the JAX entry's
// contract).
inline int sdf_setup(SdfArgs& s, const int* meta, int n_lin, int skip,
                     int multires, int M, int M_pad, float scale, int* max_k,
                     int* max_n, int* n_bias, bool reverse = true) {
  int e = read_layers(meta, n_lin, s.L, max_k, max_n, n_bias, reverse);
  if (e) return e;
  const int max_skip = reverse ? n_lin - 2 : n_lin - 1;
  if (skip < 1 || skip > max_skip || multires < 1 || M_pad % TILE_M ||
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

}  // namespace fmov_train
