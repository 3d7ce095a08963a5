// K8 and K9: the ray-composited IDR color MLP and its backward, for Hopper
// (sm_90a).  Replace the Pallas kernels fmov_pose_tpu/ops/fused_color.py
// _make_ray_fwd_kernel (launched by _ray_fwd_impl) and
// _make_ray_bwd_kernel (_ray_bwd_impl); the Python side is
// fmov_pose_torch/ops/fused_color.py (launch_fwd, launch_bwd).
//
// Per 64-sample tile the input X_0 = [pts, PE(dirs), normals, feature]
// (idr order, the feature being columns 1.. of the raw SDF output) is
// built in f32 per element (color_input) and rounded to bf16 into the
// first A operand, then the ReLU layers and the sigmoid rgb c, all on the
// per-point pipeline (color_train.cuh, pipe.cuh).  K8 walks the forward's
// 5 products (ColorFwdSeq, at 4x256): its epilogue writes c to C [M_pad x
// 4] and a second launch composites each ray, color[b] = sum_j c w[b, j]
// (a ray's samples may span two tiles).  K9 runs color_bwd_tile: it
// recomputes the forward through the same function, then d_weights = c .
// ct[b], zbar = ct[b] w c (1 - c), and descends: inpbar = zbar_l W_l^T,
// zbar_{l-1} = inpbar [X_l > 0]; at layer 0 the input cotangent splits
// into pts, PE(dirs) (through PE'), normals (shared memory, for the ubar
// stage) and the feature columns (featbar).  Weight gradients X_l^T ZB_l
// over all samples and the bias sums are the weight-gradient stage
// (wgrad.cu), which launch_bwd runs after this pass.  This file holds the
// input and output stages.
//
// What bounds them: ~0.6 MFLOP of bf16 products per sample forward and
// ~1.8 backward at 4x256 (289 inputs), against ~1.1 KB of inputs per
// sample, so the products: 0.036 ms for K8 and 0.108 ms for K9 at M =
// 65,536 on an H100.  Far from it: the mma.sync loop stops at a barrier
// every 32 weight rows and the tensor cores idle through the epilogues
// and the input stage (PERF.md); K9's weight-gradient stage (wgrad.cu,
// TMA and wgmma, bound by those bytes) is a second pass over X_l and ZB_l.

#include "color_train.cuh"

namespace fmov_train {
namespace {

struct ColorArgs {
  ColorCore k;
  int mv, npe, d_sdf, N;
  const float* sdf_out;  // [M x d_sdf]
  const float* pts;      // [M x 3]
  const float* dirs;
  const float* nrm;
  const float* wts;      // [M] (= [B x N])
  const float* ct;       // [B x 3] (K9)
  float* C;              // [M_pad x 4] per-sample rgb (K8)
  float* featbar;        // [M x d_sdf] (K9)
  float* ubar;           // [M x 9] (K9)
  float* dweights;       // [M] (K9)
};

// Column c < d_in of X_0 at the real row gr: [pts | PE(dirs) | normals |
// feature].
__device__ __forceinline__ float color_input(const ColorArgs& a, int gr, int c) {
  if (c < 3) return a.pts[(size_t)gr * 3 + c];
  if (c < 3 + a.npe) {
    int d, kind;
    float f, v, j, j2;
    pe_col(c - 3, d, kind, f);
    pe_eval(kind, f, a.dirs[(size_t)gr * 3 + d], v, j, j2);
    return v;
  }
  if (c < 6 + a.npe) return a.nrm[(size_t)gr * 3 + c - 3 - a.npe];
  return a.sdf_out[(size_t)gr * a.d_sdf + 1 + c - 6 - a.npe];
}

__global__ void __launch_bounds__(THREADS, 1)
    color_fwd_kernel(const __grid_constant__ ColorArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorPipeSmem m = color_pipe_carve<ColorFwdSeq>(a.k, smem);
  WRing<ColorFwdSeq> R = color_block_start<ColorFwdSeq>(a.k, m);
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    color_forward(
        a.k, tile * TILE_M, m, R, [&](int gr, int c) { return color_input(a, gr, c); },
        nullptr,
        // c's rgb columns of rows r, r + 8 into C (rows of 16 bytes): a
        // pair at column 0, one value at column 2
        [&](const Frag& f, int r0, const float (&c)[4]) {
          if (f.n >= 3) return;
          float* C0 = a.C + (size_t)(r0 + f.r) * 4 + f.n;
          float* C1 = C0 + 8 * 4;
          if (f.n == 0) {
            *reinterpret_cast<float2*>(C0) = make_float2(c[0], c[1]);
            *reinterpret_cast<float2*>(C1) = make_float2(c[2], c[3]);
          } else {
            *C0 = c[0];
            *C1 = c[2];
          }
        });
  color_block_end<ColorFwdSeq>(a.k, m);
}

// color[b][ch] = sum_j C[b N + j][ch] w[b N + j], j in order.
__global__ void composite_kernel(const float* C, const float* wts, int B, int N,
                                 float* color) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * 3) return;
  const int b = e / 3, ch = e % 3;
  float s = 0.f;
  for (int j = 0; j < N; ++j) {
    const size_t m = (size_t)b * N + j;
    s += C[m * 4 + ch] * wts[m];
  }
  color[e] = s;
}

__global__ void __launch_bounds__(THREADS, 1)
    color_bwd_kernel(const __grid_constant__ ColorArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorPipeSmem m = color_pipe_carve<ColorBwdSeq>(a.k, smem);
  const int small = 6 + a.npe;  // pts, PE(dirs), normals
  float* XCB = reinterpret_cast<float*>(m.rest);  // [TILE_M x small]
  WRing<ColorBwdSeq> R = color_block_start<ColorBwdSeq>(a.k, m);

  const int M = a.k.M;
  const int lane = threadIdx.x & 31;
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    color_bwd_tile(
        a.k, row0, m, R,
        [&](int gr, int c) { return color_input(a, gr, c); },
        // ct[ray] at the rgb columns n, n + 1 of rows r, r + 8, and w there
        [&](const Frag& f, int r0) {
          In2 in;
          in.a = in.b = make_float4(0.f, 0.f, 0.f, 0.f);
          const int g0 = r0 + f.r, g1 = g0 + 8;
          if (f.n < 3) {
            const bool c1 = f.n + 1 < 3;
            if (g0 < M) {
              const float* ct = a.ct + (size_t)(g0 / a.N) * 3 + f.n;
              in.a.x = ct[0];
              in.a.y = c1 ? ct[1] : 0.f;
              in.b.x = a.wts[g0];
            }
            if (g1 < M) {
              const float* ct = a.ct + (size_t)(g1 / a.N) * 3 + f.n;
              in.a.z = ct[0];
              in.a.w = c1 ? ct[1] : 0.f;
              in.b.y = a.wts[g1];
            }
          }
          return in;
        },
        // d_weights = c . ct[ray]: a row's channels 0, 1 sit in lane 4q and
        // channel 2 in lane 4q + 1, all in h = 0
        [&](const Frag& f, int r0, const float (&c)[4], const In2& in) {
          if (f.h != 0) return;
          float d0 = c[0] * in.a.x + c[1] * in.a.y;
          float d1 = c[2] * in.a.z + c[3] * in.a.w;
          d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
          d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
          const int g0 = r0 + f.r;
          if ((lane & 3) == 0) {
            if (g0 < M) a.dweights[g0] = d0;
            if (g0 + 8 < M) a.dweights[g0 + 8] = d1;
          }
        },
        // the input cotangent: the small columns to XCB, the feature
        // columns to featbar (rows of 4 d_sdf bytes: scalar stores)
        [&](const Frag& f, int r0, const float (&v)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = f.r + 8 * (e >> 1), n = f.n + (e & 1);
            if (n < small) {
              XCB[r * small + n] = v[e];
            } else if (n < a.k.d_in && r0 + r < M) {
              a.featbar[(size_t)(r0 + r) * a.d_sdf + 1 + n - small] = v[e];
            }
          }
        });

    // featbar column 0; ubar = [pts, sum over PE(dirs) columns of
    // cot PE', normals]
    for (int i = threadIdx.x; i < TILE_M * 9; i += THREADS) {
      const int r = i / 9, k = i % 9;
      const int gr = row0 + r;
      if (gr >= M) continue;
      float u;
      if (k < 3) {
        u = XCB[r * small + k];
      } else if (k >= 6) {
        u = XCB[r * small + 3 + a.npe + k - 6];
      } else {
        const int d = k - 3;
        const float xs = a.dirs[(size_t)gr * 3 + d];
        u = 0.f;
        for (int c = 0; c < a.npe; ++c) {
          int dc, kind;
          float f, v, j, j2;
          pe_col(c, dc, kind, f);
          if (dc != d) continue;
          pe_eval(kind, f, xs, v, j, j2);
          u += XCB[r * small + 3 + c] * j;
        }
      }
      a.ubar[(size_t)gr * 9 + k] = u;
      if (k == 0) a.featbar[(size_t)gr * a.d_sdf] = 0.f;
    }
  }
  color_block_end<ColorBwdSeq>(a.k, m);
}

// Fills ColorArgs; returns a cudaError_t.
int color_setup(ColorArgs& a, const float* sdf_out, int d_sdf, const float* pts,
                const float* dirs, const float* nrm, const float* wts, int M,
                int M_pad, int N, const void* w, const float* bias,
                const int* meta, int n_lin, int mv,
                const unsigned long long* ptrs, bool backward, int G) {
  if (mv < 0 || N < 1 || M % N || G < 1) return (int)cudaErrorInvalidValue;
  a.mv = mv;
  a.npe = 3 * (1 + 2 * mv);
  a.d_sdf = d_sdf;
  a.N = N;
  int p;
  int e = color_core_setup(a.k, w, bias, meta, n_lin, 6 + a.npe + d_sdf - 1, M,
                           M_pad, ptrs, backward, &p);
  if (e) return e;
  a.sdf_out = sdf_out;
  a.pts = pts;
  a.dirs = dirs;
  a.nrm = nrm;
  a.wts = wts;
  a.ct = nullptr;
  a.C = a.featbar = a.ubar = a.dweights = nullptr;
  if (!backward) a.C = reinterpret_cast<float*>(ptrs[p]);
  return 0;
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: C [M_pad x 4] (fused_color.py launch_fwd).  Returns a cudaError_t
// (0 = launched).
int fmov_color_ray_fwd(const float* sdf_out, int d_sdf, const float* pts,
                       const float* dirs, const float* nrm, const float* wts,
                       int M, int M_pad, int N, const void* w, const float* bias,
                       const int* meta, int n_lin, int mv,
                       const unsigned long long* ptrs, int G, float* color,
                       void* stream) {
  ColorArgs a;
  int e = color_setup(a, sdf_out, d_sdf, pts, dirs, nrm, wts, M, M_pad, N, w,
                      bias, meta, n_lin, mv, ptrs, false, G);
  if (e) return e;
  cudaStream_t st = (cudaStream_t)stream;
  e = color_pass_launch<ColorFwdSeq>(color_fwd_kernel, a, a.k, 0, G, st);
  if (e || M <= 0) return e;
  const int B = M / N;
  composite_kernel<<<(B * 3 + 255) / 256, 256, 0, st>>>(a.C, wts, B, N, color);
  return (int)cudaGetLastError();
}

// K9's per-point pass.  ptrs: X_0..X_{L-1}, ZB_0..ZB_{L-1}, DBPART [G x
// n_bias], then DWPART, which only the weight-gradient stage reads
// (fused_color.py launch_bwd).  Returns a cudaError_t.
int fmov_color_ray_bwd(const float* sdf_out, int d_sdf, const float* pts,
                       const float* dirs, const float* nrm, const float* wts,
                       const float* ct, int M, int M_pad, int N, const void* w,
                       const float* bias, const int* meta, int n_lin, int mv,
                       const unsigned long long* ptrs, int G, float* featbar,
                       float* ubar, float* dweights, void* stream) {
  ColorArgs a;
  int e = color_setup(a, sdf_out, d_sdf, pts, dirs, nrm, wts, M, M_pad, N, w,
                      bias, meta, n_lin, mv, ptrs, true, G);
  if (e) return e;
  a.ct = ct;
  a.featbar = featbar;
  a.ubar = ubar;
  a.dweights = dweights;
  return color_pass_launch<ColorBwdSeq>(color_bwd_kernel, a, a.k,
                                        align128((size_t)TILE_M * (6 + a.npe) * 4), G,
                                        (cudaStream_t)stream);
}

}  // extern "C"
