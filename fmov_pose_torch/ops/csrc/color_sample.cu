// K6 and K7: the per-sample IDR color MLP and its backward, for Hopper
// (sm_90a).  They replace the Pallas kernels of
// fmov_pose_tpu/ops/fused_color.py:
//   K6  _make_fwd_kernel   (launched by _color_fwd_impl)
//   K7  _make_bwd_kernel   (launched by _color_bwd_impl)
// which the training step reaches through color_fused_featfirst where the
// ray-composited K8/K9 cannot run: the NeRF++ background mixes per-sample
// colors, or the SDF takes the flat path.  The Python side is
// fmov_pose_torch/ops/fused_color.py (launch_fwd_sample,
// launch_bwd_sample): it packs the weights (RayPack, as for K8/K9), lays
// out the workspace and checks every argument; the entry builds the input
// rows xc [M x d_in] = [pts, PE(dirs), normals, feature] in PyTorch.
//
// They are K8/K9's math without the composite, so they are the same tile
// code on the per-point pipeline (color_train.cuh, pipe.cuh: the weight
// ring, mma.sync register epilogues, A operands in shared memory) with
// other input and output stages; the input stage reads xc rows straight
// into the first A (zero past d_in and past M):
//   K6: color_forward over ColorFwdSeq, the forward's 5 products at 4x256;
//       the last layer's epilogue writes rgb [M x 3] = sigmoid(p) at the
//       real rows and launches no composite.
//   K7: color_bwd_tile over ColorBwdSeq: it recomputes the forward through
//       the same function; zbar = ct c (1 - c) from a per-sample ct [M x
//       3]; the descent's layer-0 epilogue writes xcbar [M x d_in] rows
//       and splits nothing.  Weight gradients X_l^T ZB_l over all samples
//       and the bias sums are reduced in a fixed order, so they are the
//       same from run to run (the Pallas kernel summed them over a
//       sequential grid).
//
// Arithmetic: every product rounds both operands to bf16 and sums in f32;
// everything else is f32.  What bounds them at 4x256 on the 289-wide
// input: ~0.54 MFLOP of products a sample forward and ~1.6 backward,
// against ~1.2 KB (K6) and ~2.4 KB (K7) of rows in and out a sample, so
// the products.  Neither overlaps (the mma.sync loop stops at a barrier
// every 32 weight rows, and the tensor cores idle during the epilogues and
// the input stage), and K7's weight gradients are a second pass over the
// stored X_l and ZB_l (the weight-gradient stage, wgrad.cu, bound by
// those bytes).

#include "color_train.cuh"

namespace fmov_train {
namespace {

struct SampleArgs {
  ColorCore k;
  const float* xc;  // [M x d_in]
  const float* ct;  // [M x 3] (K7)
  float* rgb;       // [M x 3] (K6)
  float* xcbar;     // [M x d_in] (K7)
};

__global__ void __launch_bounds__(THREADS, 1)
    color_sample_fwd_kernel(const __grid_constant__ SampleArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorPipeSmem m = color_pipe_carve<ColorFwdSeq>(a.k, smem);
  WRing<ColorFwdSeq> R = color_block_start<ColorFwdSeq>(a.k, m);
  const int d_in = a.k.d_in, M = a.k.M;
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    color_forward(
        a.k, tile * TILE_M, m, R, [&](int gr, int c) { return a.xc[(size_t)gr * d_in + c]; },
        nullptr,
        // rgb rows (12 bytes: scalar stores), the real rows only
        [&](const Frag& f, int r0, const float (&c)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gr = r0 + f.r + 8 * (e >> 1), n = f.n + (e & 1);
            if (n < 3 && gr < M) a.rgb[(size_t)gr * 3 + n] = c[e];
          }
        });
  color_block_end<ColorFwdSeq>(a.k, m);
}

__global__ void __launch_bounds__(THREADS, 1)
    color_sample_bwd_kernel(const __grid_constant__ SampleArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorPipeSmem m = color_pipe_carve<ColorBwdSeq>(a.k, smem);
  WRing<ColorBwdSeq> R = color_block_start<ColorBwdSeq>(a.k, m);
  const int d_in = a.k.d_in, M = a.k.M;
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    color_bwd_tile(
        a.k, tile * TILE_M, m, R,
        [&](int gr, int c) { return a.xc[(size_t)gr * d_in + c]; },
        // ct at the rgb columns n, n + 1 of rows r, r + 8; w = 1
        [&](const Frag& f, int r0) {
          In2 in;
          in.a = make_float4(0.f, 0.f, 0.f, 0.f);
          in.b = make_float4(1.f, 1.f, 0.f, 0.f);
          const int g0 = r0 + f.r, g1 = g0 + 8;
          if (f.n < 3) {
            const bool c1 = f.n + 1 < 3;
            if (g0 < M) {
              in.a.x = a.ct[(size_t)g0 * 3 + f.n];
              in.a.y = c1 ? a.ct[(size_t)g0 * 3 + f.n + 1] : 0.f;
            }
            if (g1 < M) {
              in.a.z = a.ct[(size_t)g1 * 3 + f.n];
              in.a.w = c1 ? a.ct[(size_t)g1 * 3 + f.n + 1] : 0.f;
            }
          }
          return in;
        },
        [](const Frag&, int, const float (&)[4], const In2&) {},
        // xcbar rows (4 d_in bytes: scalar stores)
        [&](const Frag& f, int r0, const float (&v)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gr = r0 + f.r + 8 * (e >> 1), n = f.n + (e & 1);
            if (n < d_in && gr < M) a.xcbar[(size_t)gr * d_in + n] = v[e];
          }
        });
  }
  color_block_end<ColorBwdSeq>(a.k, m);
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// K6.  ptrs: the forward's workspace table, empty (fused_color.py
// launch_fwd_sample).  Returns a cudaError_t (0 = launched).
int fmov_color_sample_fwd(const float* xc, int d_in, int M, int M_pad,
                          const void* w, const float* bias, const int* meta,
                          int n_lin, const unsigned long long* ptrs, int G,
                          float* rgb, void* stream) {
  SampleArgs a;
  int p;
  int e = color_core_setup(a.k, w, bias, meta, n_lin, d_in, M, M_pad, ptrs, false, &p);
  if (e) return e;
  if (G < 1) return (int)cudaErrorInvalidValue;
  a.xc = xc;
  a.ct = nullptr;
  a.rgb = rgb;
  a.xcbar = nullptr;
  return color_pass_launch<ColorFwdSeq>(color_sample_fwd_kernel, a, a.k, 0, G,
                                        (cudaStream_t)stream);
}

// K7's per-point pass.  ptrs: X_0..X_{L-1}, ZB_0..ZB_{L-1}, DBPART [G x
// n_bias], then DWPART, which only the weight-gradient stage reads
// (fused_color.py launch_bwd_sample).  Returns a cudaError_t.
int fmov_color_sample_bwd(const float* xc, const float* ct, int d_in, int M,
                          int M_pad, const void* w, const float* bias,
                          const int* meta, int n_lin,
                          const unsigned long long* ptrs, int G, float* xcbar,
                          void* stream) {
  SampleArgs a;
  int p;
  int e = color_core_setup(a.k, w, bias, meta, n_lin, d_in, M, M_pad, ptrs, true, &p);
  if (e) return e;
  if (G < 1) return (int)cudaErrorInvalidValue;
  a.xc = xc;
  a.ct = ct;
  a.rgb = nullptr;
  a.xcbar = xcbar;
  return color_pass_launch<ColorBwdSeq>(color_sample_bwd_kernel, a, a.k, 0, G,
                                        (cudaStream_t)stream);
}

}  // extern "C"
