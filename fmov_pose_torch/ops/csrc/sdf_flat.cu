// K2 and K3: the flat SDF forward + d_inputs and its second-order
// backward, for Hopper (sm_90a).  They replace the Pallas kernels of
// fmov_pose_tpu/ops/fused_sdf.py:
//   K2  _make_fwd_grad_kernel     (launched by _sdf_forward_grad_impl)
//   K3  _make_bwd_kernel_biased   (launched by _sdf_bwd_impl)
// which the training step reaches through sdf_apply_grad_fused below the
// rays gate (fused_sdf.MIN_SAMPLES_RAYS samples a step).  The Python side
// is fmov_pose_torch/ops/fused_sdf.py (launch_fwd_grad_flat,
// launch_bwd_flat): it packs the weights, lays out the workspace, checks
// every argument, and computes the positional encoding and its
// derivatives around the kernels, as the JAX entries do.
//
// They are K4 and K5 with other input and output stages (one tile each
// for two Pallas kernels of the same math, sdf_pipe.cuh and
// sdf_bwd_pass.cuh):
//   K2: xe [M x pe_dim] in, its rows loaded where K4 runs the encoding;
//       out [M x n_out] = [z0 / scale, z1..] and d_inputs [M x pe_dim] (the
//       reverse chain's cotangent of xe, before the encoding's Jacobian)
//       out, where K4 folds it into grad [M x 3].
//   K3: xe, ybar [M x n_out] (the cotangent of the raw last layer, its
//       sdf column already divided by scale) and gbar [M x pe_dim] (the
//       cotangent of d_inputs) in; xebar [M x pe_dim] and the padded
//       weight and bias gradients out.  The encoding's second-derivative
//       term stays outside, as in JAX.
//
// What bounds them: at 8x256, ~2.0 MFLOP of bf16 products a point for K2
// and ~5.8 for K3 (forward, chain, Phase A and B, and the weight-gradient
// products), against ~160 and ~1,340 bytes a point in and out.  K2 runs
// K4's tile on the per-point pipeline of sdf_pipe.cuh (a cp.async weight
// ring, mma.sync with register epilogues, A operands kept in shared
// memory) and stages only the sigmoids in the workspace; K3 runs K5's
// pass (sdf_bwd_pass.cuh: a TMA weight ring, wgmma products over two
// warpgroups' column halves), bound by the intermediates it stages there (sigmoids, the
// gradient chain, the Hessian term, the bf16 operands of the weight
// gradients, ~2.5 GB at M = 32,768: 0.75 ms at 3.35 TB/s), read back only
// by the block that wrote them.  Weight gradients: one product per layer
// over all points, the weight-gradient stage (wgrad.cu, bound by the bytes
// of those operands), which launch_bwd_flat runs after the pass; split
// over the rows and reduced in a fixed order, so run to run the result is
// the same (the Pallas kernel summed them over a sequential grid).

#include "sdf_bwd_pass.cuh"
#include "sdf_pipe.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    sdf_fwd_grad_flat_kernel(const __grid_constant__ SdfArgs s, float* out,
                             int n_out, float* d_inputs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem m = fwd_smem_carve<FwdSeq>(s, smem);
  const float* DIN = m.DIN;
  WRing<FwdSeq> R = ring_start<FwdSeq>(s, m.ring);

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    sdf_fwd_grad_tile(s, row0, m, R, out, n_out, nullptr);
    for (int i = threadIdx.x; i < TILE_M * s.pe_dim; i += THREADS) {
      const int r = i / s.pe_dim, c = i % s.pe_dim;
      const int gr = row0 + r;
      if (gr < s.M) d_inputs[(size_t)gr * s.pe_dim + c] = DIN[r * s.pe_pad + c];
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
    sdf_bwd_flat_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_bwd_block<false>(a, smem);
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// K2.  ptrs: SIG_0..SIG_{L-2} (fused_sdf.py fwd_workspace_specs).  Returns
// a cudaError_t (0 = launched).
int fmov_sdf_fwd_grad_flat(const float* xe, int M, int M_pad, float scale,
                           const void* w, const float* bias, const float* wlast,
                           const int* meta, int n_lin, int skip, int multires,
                           const unsigned long long* ptrs, int G, float* out,
                           int n_out, float* d_inputs, void* stream) {
  SdfArgs s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out > s.L[n_lin - 1].n || n_out < 1 || G < 1) return (int)cudaErrorInvalidValue;
  s.xe_in = xe;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  return sdf_fwd_launch<FwdSeq>(sdf_fwd_grad_flat_kernel, s, ptrs, G, (cudaStream_t)stream,
                                out, n_out, d_inputs);
}

// K3's per-point pass.  ptrs: the workspace table of sdf_bwd_launch
// (sdf_bwd_pass.cuh), whose operands and partial sums the weight-gradient
// stage reads next.  Returns a cudaError_t (0 = launched).
int fmov_sdf_bwd_flat(const float* xe, const float* ybar, const float* gbar,
                      int M, int M_pad, int n_out, float scale, const void* w,
                      const float* bias, const float* wlast, const int* meta,
                      int n_lin, int skip, int multires,
                      const unsigned long long* ptrs, int G, float* xebar,
                      void* stream) {
  BwdArgs a;
  SdfArgs& s = a.s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out != s.L[n_lin - 1].n || G < 1) return (int)cudaErrorInvalidValue;
  s.xe_in = xe;
  s.gbar_in = gbar;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  a.ct_out = ybar;
  a.ct_sdf = nullptr;
  a.ct_grad = nullptr;
  a.xbar = xebar;
  a.n_out = n_out;
  return sdf_bwd_launch(sdf_bwd_flat_kernel, a, n_bias, ptrs, G,
                        (cudaStream_t)stream);
}

}  // extern "C"
