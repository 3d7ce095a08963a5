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
// The tile is sdf_fwd_grad_tile (sdf_pipe.cuh), shared with K2: the
// weights of its 17 products (at 8x256) stream through a cp.async ring
// across products and tiles, the products run on mma.sync with their
// epilogues in registers, and each product's A operand stays in shared
// memory (ping-pong).  What bounds it: ~2.2 MFLOP of bf16 products per
// point at 8x256 against 12 bytes in and 1,044 out, so the products would;
// what sets the time is the weight stream from L2 (~2.2 MB a tile) and the
// epilogues.  The sigmoids of 8 layers (8 KB a point in f32) do not fit in
// shared memory beside the A operands and the ring, so they go to the
// workspace in fragment order and come back in the reverse chain.  One
// block per SM loops over tiles.

#include "sdf_pipe.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    sdf_fwd_grad_kernel(const __grid_constant__ SdfArgs s, float* out,
                        int n_out, float* sdf, float* grad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem m = fwd_smem_carve(s, smem);
  const float* DIN = m.DIN;
  WRing<FwdSeq> R = ring_start<FwdSeq>(s, m.ring);

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    sdf_fwd_grad_tile(s, row0, m, R, out, n_out, sdf);

    // grad[d] = sum over the PE columns c of dim d of DIN[c] PE'(c)
    for (int i = threadIdx.x; i < TILE_M * 3; i += THREADS) {
      const int r = i / 3, d = i % 3;
      const int gr = row0 + r;
      if (gr >= s.M) continue;
      const float xs = s.x[(size_t)gr * 3 + d] * s.scale;
      float g = 0.f;
      for (int c = 0; c < s.pe_dim; ++c) {
        int dc, kind;
        float f, v, j, j2;
        pe_col(c, dc, kind, f);
        if (dc != d) continue;
        pe_eval(kind, f, xs, v, j, j2);
        g += DIN[r * s.pe_pad + c] * j;
      }
      grad[(size_t)gr * 3 + d] = g;
    }
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: SIG_0..SIG_{L-2} (fused_sdf.py fwd_workspace_specs).  Returns a
// cudaError_t (0 = launched).
int fmov_sdf_fwd_grad(const float* x, int M, int M_pad, float scale,
                      const void* w, const float* bias, const float* wlast,
                      const int* meta, int n_lin, int skip, int multires,
                      const unsigned long long* ptrs, int G, float* out,
                      int n_out, float* sdf, float* grad, void* stream) {
  SdfArgs s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out > s.L[n_lin - 1].n || n_out < 1 || G < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  return sdf_fwd_launch(sdf_fwd_grad_kernel, s, ptrs, G, (cudaStream_t)stream, out,
                        n_out, sdf, grad);
}

}  // extern "C"
