// K4: SDF forward and d(sdf)/dx per point, for Hopper (sm_90a).  Replaces
// the Pallas kernel fmov_pose_tpu/ops/fused_sdf.py _make_fwd_grad_rays_kernel
// (launched by _sdf_fwd_grad_rays_impl); the Python side is
// fmov_pose_torch/ops/fused_sdf.py (launch_fwd_grad), which packs the
// weights, lays out the workspace and checks every argument.
//
// Per 64-point tile: the PE (f32), the 9-linear forward (softplus beta=100,
// skip concat / sqrt2), out = [z0 / scale, z1..] of the last layer, then
// the reverse chain of d(sdf)/dx through the hidden layers and the PE
// Jacobian (scale cancels: the gradient is with respect to raw x).  The
// notation is in sdf_train.cuh.
//
// The per-point pass is sdf_fwd_grad_block (sdf_fwd_grad_pass.cuh), shared
// with K2: a producer warpgroup streams the weights of the tile's 17
// products (at 8x256) through a TMA ring, two consumer warpgroups each run
// a tile of their own on wgmma with the A operands in registers, taking
// turns at the tensor cores so that one tile's epilogue runs under the
// other's products.  What bounds it: ~2.2 MFLOP of bf16 products a point
// at 8x256 (0.13 ms at M = 65,536) and the sigmoids of 8 layers (8 KB a
// point in f32), which do not fit on chip: they go to the workspace in
// fragment order and come back in the reverse chain (0.53 GB each way at
// M = 65,536).  One block per SM loops over pairs of tiles.

#include "sdf_fwd_grad_pass.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(FG_THREADS, 1)
    sdf_fwd_grad_kernel(const __grid_constant__ FgArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_fwd_grad_block<true>(a, smem);
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: SIG_0..SIG_{L-2} (fused_sdf.py fwd_workspace_specs).  G blocks,
// each looping over pairs of 64-point tiles.  Returns a cudaError_t (0 =
// launched).
int fmov_sdf_fwd_grad(const float* x, int M, int M_pad, float scale,
                      const void* w, const float* bias, const float* wlast,
                      const int* meta, int n_lin, int skip, int multires,
                      const unsigned long long* ptrs, int G, float* out,
                      int n_out, float* sdf, float* grad, void* stream) {
  FgArgs a;
  SdfArgs& s = a.s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out > s.L[n_lin - 1].n || n_out < 1 || G < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  a.out = out;
  a.n_out = n_out;
  a.sdf = sdf;
  a.grad = grad;
  return sdf_fwd_grad_launch(sdf_fwd_grad_kernel, a, ptrs, G, (cudaStream_t)stream);
}

// The launch plan of K4's and K2's per-point pass for a layer table
// (fg_plan), without a launch: out[0] the dynamic shared memory in bytes,
// out[1] the ring's stages, out[2] the passes a tile, out[3] the threads a
// block, then (map, n0, nw, k) of each pass, out[4 + 4 p ..].  out holds 4
// + 4 FG_MAX_SUB ints.  Host code alone.  Returns a cudaError_t,
// cudaErrorInvalidValue for a table the pass does not take.
int fmov_sdf_fwd_grad_plan(const int* meta, int n_lin, int skip, int multires, int* out) {
  FgArgs a;
  int max_k, max_n, n_bias;
  int e = sdf_setup(a.s, meta, n_lin, skip, multires, TILE_M, TILE_M, 1.0f, &max_k, &max_n,
                    &n_bias);
  if (e) return e;
  e = fg_plan(a);
  if (e) return e;
  out[0] = fg_smem_bytes(a);
  out[1] = a.stages;
  out[2] = a.n_sub;
  out[3] = FG_THREADS;
  for (int p = 0; p < a.n_sub; ++p) {
    out[4 + 4 * p] = a.sub[p].map;
    out[5 + 4 * p] = a.sub[p].n0;
    out[6 + 4 * p] = a.sub[p].nw;
    out[7 + 4 * p] = a.sub[p].k;
  }
  return 0;
}

}  // extern "C"
