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
// notation and the shared layers are in sdf_train.cuh.
//
// What bounds it: ~2.2 MFLOP of bf16 products per point at 8x256 against
// 12 bytes in and 1,044 out, so the products bound it.  The sigmoids of 8
// layers (8 KB a point in f32) do not fit in shared memory beside the
// operand tile, so they go to the workspace in device memory and come
// back in the reverse chain; the weights stream from L2 per layer, as in
// K1.  One block per SM loops over tiles.

#include "sdf_train.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    sdf_fwd_grad_kernel(const __grid_constant__ SdfArgs s, float* out,
                        int n_out, float* sdf, float* grad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SdfSmem m = sdf_smem_carve(s, smem);
  float* DIN = reinterpret_cast<float*>(smem + m.off);

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    sdf_fwd_grad_tile(s, row0, m, DIN, out, n_out, sdf);

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
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: X_0..X_{L-1}, D_0..D_{L-2}, SIG_0..SIG_{L-2} (fused_sdf.py
// launch_fwd_grad).  Returns a cudaError_t (0 = launched).
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
  int p = 0;
  for (int l = 0; l < n_lin; ++l) s.X[l] = reinterpret_cast<bf16*>(ptrs[p++]);
  for (int l = 0; l < n_lin - 1; ++l) s.D[l] = reinterpret_cast<bf16*>(ptrs[p++]);
  for (int l = 0; l < n_lin - 1; ++l) s.SIG[l] = reinterpret_cast<float*>(ptrs[p++]);
  const size_t smem = sdf_smem(s, (size_t)TILE_M * s.pe_pad * 4);
  cudaError_t ce = cudaFuncSetAttribute(
      sdf_fwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (M <= 0) return 0;
  sdf_fwd_grad_kernel<<<G, THREADS, smem, (cudaStream_t)stream>>>(s, out, n_out,
                                                                  sdf, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
