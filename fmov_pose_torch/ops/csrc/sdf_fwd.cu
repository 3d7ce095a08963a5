// K1: the gradient-free SDF forward for Hopper (sm_90a): positional
// encoding, the 9-linear IDR SDF MLP with softplus(beta=100) and the skip
// concat, and out = [sdf / scale] or [sdf / scale, feature], in one kernel.
// Replaces the Pallas kernel fmov_pose_tpu/ops/fused_sdf.py
// _make_fwd_kernel (launched by _sdf_forward_impl); the Python side is
// fmov_pose_torch/ops/fused_sdf.py (FwdPack, launch), which packs the
// weights once per set of parameters and checks every argument.
//
// Arithmetic contract (the TPU kernel's): inputs, biases and outputs f32;
// every product rounds both operands to bf16 and accumulates in f32.
//
// The tile is sdf_fwd_tile (sdf_pipe.cuh), on the per-point pipeline that
// K6-K9 run too: one block per SM loops over its 64-point tiles, the weights
// of the tile's L products (FwdOnlySeq, 9 at 8x256; the forward blocks of
// a forward-only table, the last layer cut to its column 0 for the sdf
// alone) stream through a cp.async ring that runs on across products and
// tiles, the products run on mma.sync with their epilogues in registers,
// and each product's A operand stays in shared memory (ping-pong).  Nothing
// per point goes to device memory but the rows of out: no workspace.
//
// What bounds it: ~0.92 MFLOP of bf16 products a point at 8x256 for the
// sdf alone (~1.05 with the features) against 12 bytes in and 4 (or
// 1,028) out, so the products would; what sets the time is the mma.sync
// loop, its barrier every 32 weight rows and the epilogues, which nothing
// overlaps (PERF.md).

#include "sdf_pipe.cuh"

namespace fmov_train {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    sdf_fwd_kernel(const __grid_constant__ SdfArgs s, float* out, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem m = fwd_smem_carve(s, smem);
  WRing<FwdOnlySeq> R = ring_start<FwdOnlySeq>(s, m.ring);

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    sdf_fwd_tile(s, tile * TILE_M, m, R, out, n_out);
  cp_async_wait<0>();
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// meta: the forward-only layer table (packing.py pack_train, reverse
// False); n_out: the last layer's real width (1 or d_out).  Returns a
// cudaError_t (0 = launched).
int fmov_sdf_fwd(const float* x, int M, int M_pad, float scale, const void* w,
                 const float* bias, const int* meta, int n_lin, int skip,
                 int multires, int G, float* out, int n_out, void* stream) {
  SdfArgs s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias, false);
  if (e) return e;
  if (n_out != s.L[n_lin - 1].n || G < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = nullptr;
  return sdf_fwd_launch(sdf_fwd_kernel, s, G, (cudaStream_t)stream, out, n_out);
}

}  // extern "C"
