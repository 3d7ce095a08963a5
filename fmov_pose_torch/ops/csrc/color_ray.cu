// K8 and K9: the ray-composited IDR color MLP and its backward, for Hopper
// (sm_90a).  Replace the Pallas kernels fmov_pose_tpu/ops/fused_color.py
// _make_ray_fwd_kernel (launched by _ray_fwd_impl) and
// _make_ray_bwd_kernel (_ray_bwd_impl); the Python side is
// fmov_pose_torch/ops/fused_color.py (launch_fwd, launch_bwd).
//
// Per 64-sample tile the input X_0 = [pts, PE(dirs), normals, feature]
// (idr order, the feature being columns 1.. of the raw SDF output) is
// built in f32 and rounded to bf16, then the ReLU layers and the sigmoid
// rgb c.  K8 writes c and composites each ray, color[b] = sum_j c w[b, j],
// in a second launch (a ray's samples may span two tiles).  K9 recomputes
// the forward (keeping X_l for the ReLU masks and the weight gradients),
// then d_weights = c . ct[b], zbar = ct[b] w c (1 - c), and descends:
// inpbar = zbar_l W_l^T, zbar_{l-1} = inpbar [X_l > 0]; at layer 0 the
// input cotangent splits into pts, PE(dirs) (through PE'), normals and the
// feature columns.  Weight gradients X_l^T ZB_l over all samples and the
// bias sums go through atb_kernel / reduce_kernel (train_common.cuh).  The
// layer loop, the descent and the weight gradients are color_train.cuh's,
// shared with K6/K7 (color_sample.cu); this file holds the input and
// output stages.
//
// What bounds them: ~0.6 MFLOP of bf16 products per sample forward and
// ~1.8 backward at 4x256 (289 inputs), against ~1.1 KB of inputs per
// sample, so the products.

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

// X_0 of the tile: [pts | PE(dirs) | normals | feature | 0 pad to in_w].
__device__ __forceinline__ void color_input_stage(const ColorArgs& a, int row0) {
  const Layer& L0 = a.k.L[0];
  for (int i = threadIdx.x; i < TILE_M * L0.in_w; i += THREADS) {
    const int r = i / L0.in_w, c = i % L0.in_w;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < a.k.M && c < a.k.d_in) {
      if (c < 3) {
        v = a.pts[(size_t)gr * 3 + c];
      } else if (c < 3 + a.npe) {
        int d, kind;
        float f, j, j2;
        pe_col(c - 3, d, kind, f);
        pe_eval(kind, f, a.dirs[(size_t)gr * 3 + d], v, j, j2);
      } else if (c < 6 + a.npe) {
        v = a.nrm[(size_t)gr * 3 + c - 3 - a.npe];
      } else {
        v = a.sdf_out[(size_t)gr * a.d_sdf + 1 + c - 6 - a.npe];
      }
    }
    a.k.X[0][(size_t)gr * L0.kp + c] = __float2bfloat16(v);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    color_fwd_kernel(const __grid_constant__ ColorArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorSmem m = color_carve(smem, a.k.lda, a.k.ldb);
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    __syncthreads();
    color_input_stage(a, row0);
    color_forward_tile(a.k, row0, m, nullptr, [&](int r, int n, float p) -> float {
      if (n < 3) a.C[(size_t)(row0 + r) * 4 + n] = color_sigmoid(p);
      return 0.f;
    });
  }
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
  const ColorSmem m = color_carve(smem, a.k.lda, a.k.ldb);
  const int small = 6 + a.npe;  // pts, PE(dirs), normals
  float* XCB = reinterpret_cast<float*>(m.rest);                 // [TILE_M x small]
  size_t off = align128((size_t)TILE_M * small * 4);
  float* Csm = reinterpret_cast<float*>(m.rest + off);           // [TILE_M x 4]
  off += align128((size_t)TILE_M * 4 * 4);
  float* DBACC = reinterpret_cast<float*>(m.rest + off);         // [n_bias]
  for (int i = threadIdx.x; i < a.k.n_bias; i += THREADS) DBACC[i] = 0.f;

  const int M = a.k.M;
  const int n_tiles = a.k.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    __syncthreads();
    color_input_stage(a, row0);
    // c and zbar = ct w c (1 - c)
    color_forward_cot(a.k, row0, m, DBACC, [&](int r, int gr, int n, float p) -> float {
      const float c = color_sigmoid(p);
      Csm[r * 4 + n] = c;
      const float cbar = a.ct[(size_t)(gr / a.N) * 3 + n] * a.wts[gr];
      return cbar * c * (1.f - c);
    });
    __syncthreads();
    for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
      const int gr = row0 + r;
      if (gr < M) {
        const float* ct = a.ct + (size_t)(gr / a.N) * 3;
        a.dweights[gr] = Csm[r * 4] * ct[0] + Csm[r * 4 + 1] * ct[1] + Csm[r * 4 + 2] * ct[2];
      }
    }

    color_descent(a.k, row0, m, DBACC, [&](int r, int gr, int n, float v) {
      if (n < small) {
        XCB[r * small + n] = v;
      } else if (gr < M) {
        a.featbar[(size_t)gr * a.d_sdf + 1 + n - small] = v;
      }
    });

    // featbar column 0; ubar = [pts, sum over PE(dirs) columns of
    // cot PE', normals]
    __syncthreads();
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
  color_store_bias_sums(a.k, DBACC);
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

size_t color_ray_smem(const ColorArgs& a, bool backward) {
  if (!backward) return color_smem(a.k, 0);
  return color_smem(a.k, align128((size_t)TILE_M * (6 + a.npe) * 4) +
                             align128((size_t)TILE_M * 16) +
                             align128((size_t)a.k.n_bias * 4));
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: X_0..X_{L-1}, C [M_pad x 4] (fused_color.py launch_fwd).  Returns a
// cudaError_t (0 = launched).
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
  const size_t smem = color_ray_smem(a, false);
  cudaError_t ce = cudaFuncSetAttribute(
      color_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  color_fwd_kernel<<<G, THREADS, smem, st>>>(a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const int B = M / N;
  composite_kernel<<<(B * 3 + 255) / 256, 256, 0, st>>>(a.C, wts, B, N, color);
  return (int)cudaGetLastError();
}

// ptrs: X_0..X_{L-1}, ZB_0..ZB_{L-1}, DBPART [G x n_bias], DWPART [KS x sum
// in_w np] (fused_color.py launch_bwd).  dw: the padded [in_w x np] blocks
// concatenated; db: the padded biases.  Returns a cudaError_t.
int fmov_color_ray_bwd(const float* sdf_out, int d_sdf, const float* pts,
                       const float* dirs, const float* nrm, const float* wts,
                       const float* ct, int M, int M_pad, int N, const void* w,
                       const float* bias, const int* meta, int n_lin, int mv,
                       const unsigned long long* ptrs, int G, int KS,
                       float* featbar, float* ubar, float* dweights, float* dw,
                       float* db, void* stream) {
  ColorArgs a;
  int e = color_setup(a, sdf_out, d_sdf, pts, dirs, nrm, wts, M, M_pad, N, w,
                      bias, meta, n_lin, mv, ptrs, true, G);
  if (e) return e;
  if (KS < 1) return (int)cudaErrorInvalidValue;
  a.ct = ct;
  a.featbar = featbar;
  a.ubar = ubar;
  a.dweights = dweights;
  float* dwpart = reinterpret_cast<float*>(ptrs[2 * n_lin + 1]);
  const size_t smem = color_ray_smem(a, true);
  cudaError_t ce = cudaFuncSetAttribute(
      color_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  color_bwd_kernel<<<G, THREADS, smem, st>>>(a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  return color_weight_grads(a.k, dwpart, G, KS, dw, db, st);
}

}  // extern "C"
