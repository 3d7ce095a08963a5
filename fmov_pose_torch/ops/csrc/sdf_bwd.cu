// K5: the second-order backward of K4, for Hopper (sm_90a).  Replaces the
// Pallas kernel fmov_pose_tpu/ops/fused_sdf.py _make_bwd_rays_kernel
// (launched by _sdf_bwd_rays_impl through _sdf_rays_bwd); the Python side
// is fmov_pose_torch/ops/fused_sdf.py (launch_bwd).
//
// Given the cotangents of out [M x n_out], sdf [M] and grad [M x 3], per
// 64-point tile (notation in sdf_train.cuh, derivation in the JAX module
// at ops/fused_sdf.py:407-434):
//   1. PE, and gbar = ct_grad[dim] PE' (the cotangent of DIN);
//   2. forward to layer L-2 (sig_l, X_l) and the reverse chain (d_l, D_l,
//      DIN), recomputed as the JAX kernel does;
//   3. Phase A, ascending l <= L-2: fbar_l (gbar at l = 0, [dbar/sqrt2 |
//      gbar/sqrt2] at S), ebar = fbar_l W_l, dbar_{l+1} = ebar sig_l, the
//      Hessian term ZC_l = ebar d_{l+1} 100 sig_l (1 - sig_l); at l = L-2
//      the column sums of dbar (the last layer's column-0 term);
//   4. Phase B, descending l: zbar_{L-1} = ybar = [(ct_out0 + ct_sdf) /
//      scale, ct_out1..]; inpbar = zbar_l W_l^T; the h part gives
//      zbar_{l-1} = inpbar sig_{l-1} + ZC_{l-1}, the PE part adds to XEB;
//      bias gradients are column sums of zbar;
//   5. xbar = scale sum over the PE columns of (XEB PE' + ct_grad DIN PE'').
// The weight gradients are then dW_l = [FB_l; X_l]^T [D_l; ZB_l], the
// Phase A and Phase B terms stacked over 2 M_pad rows (X_{L-1}^T ZB_{L-1}
// for the last layer, plus the column-0 term), computed by atb_kernel and
// reduced with the per-block bias sums by reduce_kernel
// (train_common.cuh).  Three launches.
//
// The per-point pass (steps 1-4) is sdf_bwd_tile (sdf_bwd_pipe.cuh): the
// weights stream through a cp.async ring across products and tiles, the
// products run on mma.sync with their epilogues in registers, each
// product's A operand stays in shared memory (ping-pong), and the f32
// per-point arrays are stored in the warps' fragment order.
//
// What bounds it: ~4.4 MFLOP of per-point products and ~2.3 MFLOP of
// weight-gradient products a point at 8x256 would take ~0.45 ms at M =
// 65,536 at the bf16 peak; what sets the time is memory.  The per-point
// pass writes and reads back ~5 GB of intermediates (bf16 operands of the
// weight-gradient product, f32 sigmoids, d_l and Hessian terms) in the
// workspace, and its epilogues, where that traffic happens, do not overlap
// the tensor cores; the weight-gradient product reads the bf16 operands
// once more.  Determinism: one block per SM with fixed tiles, column sums
// in fixed order, split-K partials reduced in order.

#include "sdf_bwd_pipe.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    sdf_bwd_kernel(const __grid_constant__ BwdArgs a) {
  const SdfArgs& s = a.s;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem m = bwd_smem_carve(a, smem);
  const float* DIN = m.DIN;
  const float* XEB = m.XEB;
  WRing R = bwd_block_start(a, m);

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    sdf_bwd_tile(a, row0, m, R);

    // xbar = scale * sum_c (XEB PE' + ct_grad DIN PE'') over dim d's columns
    for (int i = threadIdx.x; i < TILE_M * 3; i += THREADS) {
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
        g += XEB[r * s.pe_pad + c] * j + ctg * DIN[r * s.pe_pad + c] * j2;
      }
      a.xbar[(size_t)gr * 3 + d] = g * s.scale;
    }
  }
  bwd_block_end(a, m);
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: the workspace table of sdf_bwd_launch (sdf_bwd_pipe.cuh).  dw: the
// padded per-layer [in_w x np] blocks, concatenated; db: the padded
// biases.  Returns a cudaError_t (0 = launched).
int fmov_sdf_bwd(const float* x, const float* ct_out, const float* ct_sdf,
                 const float* ct_grad, int M, int M_pad, int n_out, float scale,
                 const void* w, const float* bias, const float* wlast,
                 const int* meta, int n_lin, int skip, int multires,
                 const unsigned long long* ptrs, int G, int KS, float* xbar,
                 float* dw, float* db, void* stream) {
  BwdArgs a;
  SdfArgs& s = a.s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out != s.L[n_lin - 1].n || G < 1 || KS < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  a.ct_out = ct_out;
  a.ct_sdf = ct_sdf;
  a.ct_grad = ct_grad;
  a.xbar = xbar;
  a.n_out = n_out;
  return sdf_bwd_launch(sdf_bwd_kernel, a, n_bias, ptrs, G, KS, dw, db,
                        (cudaStream_t)stream);
}

}  // extern "C"
