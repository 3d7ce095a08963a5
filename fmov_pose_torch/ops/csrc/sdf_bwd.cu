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
// for the last layer, plus the column-0 term): the weight-gradient stage
// (wgrad.cu: wgrad_kernel on TMA and wgmma, then reduce_kernel with the
// per-block bias sums), which launch_bwd runs after this pass.  Three
// launches.
//
// The per-point pass (steps 1-5) is sdf_bwd_block (sdf_bwd_pass.cuh): a
// producer warp streams the weights through a TMA ring, two consumer
// warpgroups run each product on wgmma over half of its output columns,
// the A operand in shared memory, the epilogues on the accumulator
// registers, the f32 per-point arrays in fragment order, the bf16
// operands of the weight gradients stored from A by TMA.
//
// What bounds it: ~4.4 MFLOP of per-point products a point at 8x256 take
// ~0.29 ms at M = 65,536 at the bf16 peak; the epilogues write and read
// back ~5.1 GB of intermediates (bf16 operands of the weight-gradient
// product, f32 sigmoids, d_l and Hessian terms), 1.5 ms at 3.35 TB/s, and
// their activations and traffic take most of the pass, with the products
// in between (PERF.md).  The weight-gradient stage reads the 1.08 GB of
// bf16 operands once more and is bound by those bytes (wgrad.cu).
// Determinism: one block per SM with fixed tiles, sums in a fixed order.

#include "sdf_bwd_pass.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(BWD_THREADS, 1)
    sdf_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_bwd_block<true>(a, smem);
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: the workspace table of sdf_bwd_launch (sdf_bwd_pass.cuh).  The pass
// alone: the workspace's operands and partial sums are the weight-gradient
// stage's input.  Returns a cudaError_t (0 = launched).
int fmov_sdf_bwd(const float* x, const float* ct_out, const float* ct_sdf,
                 const float* ct_grad, int M, int M_pad, int n_out, float scale,
                 const void* w, const float* bias, const float* wlast,
                 const int* meta, int n_lin, int skip, int multires,
                 const unsigned long long* ptrs, int G, float* xbar,
                 void* stream) {
  BwdArgs a;
  SdfArgs& s = a.s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out != s.L[n_lin - 1].n || G < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  a.ct_out = ct_out;
  a.ct_sdf = ct_sdf;
  a.ct_grad = ct_grad;
  a.xbar = xbar;
  a.n_out = n_out;
  return sdf_bwd_launch(sdf_bwd_kernel, a, n_bias, ptrs, G, (cudaStream_t)stream);
}

// The launch plan of K5's and K3's per-point pass for a layer table
// (bwd_plan), without a launch: out[0] the dynamic shared memory in bytes,
// out[1] the ring's stages, out[2] the passes a tile, out[3] the threads a
// block.  Host code alone.  Returns a cudaError_t, cudaErrorInvalidValue
// for a table the pass does not take.
int fmov_sdf_bwd_plan(const int* meta, int n_lin, int skip, int multires, int* out) {
  BwdArgs a;
  int max_k, max_n, n_bias;
  int e = sdf_setup(a.s, meta, n_lin, skip, multires, TILE_M, TILE_M, 1.0f, &max_k, &max_n,
                    &n_bias);
  if (e) return e;
  a.n_bias = n_bias;
  e = bwd_plan(a);
  if (e) return e;
  out[0] = bwd_smem_bytes(a);
  out[1] = a.stages;
  out[2] = a.n_sub;
  out[3] = BWD_THREADS;
  return 0;
}

}  // extern "C"
