// Shared pieces of the per-point kernels for Hopper (sm_90a): K1-K9.
// Their per-point passes run on the pipeline of pipe.cuh (K1, K4, K2
// through sdf_pipe.cuh, the color kernels K6-K9 through color_train.cuh)
// or, for K5 and K3, on sdf_bwd_pass.cuh (TMA and wgmma); this file holds
// the constants, the packed layer table, the fragment order, the
// activations and the positional encoding they share.
//
// Arithmetic contract (the TPU kernels'): every product rounds both
// operands to bf16 and accumulates in f32; everything else is f32.
//
// A block owns a 64-point tile at a time.  Weights are bf16
// blocks of the packed weights (fmov_pose_torch/ops/packing.py): product
// l's forward block [kp x np] and its reverse block [kr x kp], rows padded
// to multiples of 32, columns to multiples of 16.  A forward-only table
// (K1's) has no reverse blocks: kr and r_off are 0.
//
// The backward passes (K3, K5, K7, K9) leave their weight gradients to a
// stage of their own, one product per layer over all points, A^T B with
// A [rows x ni] and B [rows x nj] bf16 arrays they wrote to the workspace:
// wgrad.cu (TMA ring and wgmma, row splits reduced in a fixed order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fmov_train {

typedef __nv_bfloat16 bf16;

constexpr int TILE_M = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KCHUNK = 32;
constexpr int COLT = 3;                      // column tiles per warp
constexpr int MAX_N = 16 * WARPS * COLT;     // widest product: 384
constexpr int SKEW = 8;                      // bf16 pad per shared-memory row
constexpr int MAX_LIN = 16;
constexpr int META = 8;
constexpr float INV_SQRT2 = 0.70710678118654752f;

// One packed layer (packing.py): forward block [kp x np] at w_off, reverse
// block [kr x kp] at r_off (kr = r_off = 0 in a forward-only table),
// biases at b_off, real output width n, padded input width in_w.
struct Layer {
  int kp, np, n, w_off, b_off, kr, r_off, in_w;
};

inline int imax(int p, int q) { return p > q ? p : q; }

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Reads and checks the layer table; returns a cudaError_t.  reverse: the
// table holds the reverse blocks, and the ring's chunks are as wide as the
// widest block of either kind (max_n); else it holds none (kr = r_off =
// 0), and max_n is the widest forward block.
inline int read_layers(const int* meta, int n_lin, Layer* out, int* max_k,
                       int* max_n, int* n_bias, bool reverse = true) {
  if (n_lin < 1 || n_lin > MAX_LIN) return (int)cudaErrorInvalidValue;
  *max_k = *max_n = 16;
  *n_bias = 0;
  for (int l = 0; l < n_lin; ++l) {
    const int* m = meta + META * l;
    Layer& L = out[l];
    L.kp = m[0];
    L.np = m[1];
    L.n = m[2];
    L.w_off = m[3];
    L.b_off = m[4];
    L.kr = m[5];
    L.r_off = m[6];
    L.in_w = m[7];
    const bool bad_rev = reverse ? (L.kr % KCHUNK || L.np > L.kr || L.r_off % 8)
                                 : (L.kr != 0 || L.r_off != 0);
    if (L.kp % KCHUNK || L.np % 16 || L.in_w % 16 || L.in_w > L.kp ||
        L.np > MAX_N || L.kp > MAX_N || L.n > L.np || L.w_off % 8 ||
        L.b_off != *n_bias || bad_rev)
      return (int)cudaErrorInvalidValue;
    *max_k = imax(*max_k, imax(L.kp, L.kr));
    *max_n = imax(*max_n, reverse ? imax(L.np, L.kp) : L.np);
    *n_bias += L.np;
  }
  return 0;
}

// One lane's share of a 16x8 block of a 64-row tile's accumulators, in the
// layout mma.sync (pipe.cuh) and wgmma (sdf_bwd_pass.cuh) share: v[0], v[1]
// at (r, n), (r, n + 1) and v[2], v[3] at (r + 8, n), (r + 8, n + 1), with
// r = 16 i + lane / 4 and n = 16 j + 8 h + 2 (lane % 4).  Each pipeline
// gives every element a fixed (warp, lane, register) by its (row, column)
// alone.
struct Frag {
  int i, j, h, r, n;
};

// The lane's float4 of a per-point f32 array in fragment order: the array
// [M_pad x W] is stored as [tile][W / 16][i, h][lane][4], so the group of
// 4 a lane holds is one 16-byte vector and a warp reads and writes whole
// 128-byte lines (fused_sdf.py bwd_workspace_specs gives it [M_pad / 64, 64 W]).
__device__ __forceinline__ float4* frag4(float* base, int W, int row0, const Frag& f) {
  const size_t grp = ((size_t)(row0 / TILE_M) * (W >> 4) + f.j) * 8 + f.i * 2 + f.h;
  return reinterpret_cast<float4*>(base + grp * 128) + (threadIdx.x & 31);
}

// What an epilogue loads for one Frag: up to two float4s of per-point
// arrays (or bias and last-layer weights).
struct In2 {
  float4 a, b;
};

__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stores the lane's 4 values as bf16 pairs at (r, n) and (r + 8, n) of a
// row-major array (workspace or shared memory) with row stride ld.
__device__ __forceinline__ void st_frag_bf16(bf16* P, size_t ld, const Frag& f,
                                             float v0, float v1, float v2, float v3) {
  st_bf16x2(P + f.r * ld + f.n, v0, v1);
  st_bf16x2(P + (f.r + 8) * ld + f.n, v2, v3);
}


__device__ __forceinline__ void act_pair(float z, float& sp, float& sig) {
  // softplus(100 z)/100 and sigmoid(100 z) from one exp (_act_pair)
  const float E = expf(-100.f * fabsf(z));
  sp = fmaxf(z, 0.f) + log1pf(E) * 0.01f;
  sig = z >= 0.f ? 1.f / (1.f + E) : E / (1.f + E);
}

// Column c of the positional encoding [x, sin(2^0 x), cos(2^0 x), ...] (3
// dims per block): its input dim, kind (0 identity, 1 sin, 2 cos) and
// frequency.
__device__ __forceinline__ void pe_col(int c, int& d, int& kind, float& f) {
  if (c < 3) {
    d = c;
    kind = 0;
    f = 1.f;
  } else {
    const int q = c - 3, r = q % 6;
    d = r % 3;
    kind = r < 3 ? 1 : 2;
    f = (float)(1 << (q / 6));
  }
}

// The column's value, first and second derivative at the input xs.
__device__ __forceinline__ void pe_eval(int kind, float f, float xs, float& v,
                                        float& j, float& j2) {
  if (kind == 0) {
    v = xs;
    j = 1.f;
    j2 = 0.f;
    return;
  }
  const float rf = xs * f;
  const float s = sinf(rf), c = cosf(rf);
  if (kind == 1) {
    v = s;
    j = f * c;
    j2 = -(f * f) * s;
  } else {
    v = c;
    j = -f * s;
    j2 = -(f * f) * c;
  }
}

}  // namespace fmov_train

extern "C" const char* fmov_train_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
