// Shared pieces of the per-point kernels for Hopper (sm_90a): K1-K9.
// Their per-point passes run on the pipeline of pipe.cuh (K1-K5 through
// sdf_pipe.cuh, the color kernels K6-K9 through color_train.cuh); this
// file holds the constants, the packed layer table, the activations and
// the positional encoding they share, and the weight gradients of K3, K5,
// K7 and K9 (atb_kernel, reduce_kernel).
//
// Arithmetic contract (the TPU kernels'): every product rounds both
// operands to bf16 and accumulates in f32; everything else is f32.
//
// A block of 8 warps owns a 64-point tile at a time.  Weights are bf16
// blocks of the packed weights (fmov_pose_torch/ops/packing.py): product
// l's forward block [kp x np] and its reverse block [kr x kp], rows padded
// to multiples of 32, columns to multiples of 16.  A forward-only table
// (K1's) has no reverse blocks: kr and r_off are 0.
//
// Weight gradients are one product per layer over all points, A^T B with
// A [rows x ni] and B [rows x nj] bf16 arrays the per-point kernels wrote:
// atb_kernel (wmma bf16 16x16x16) splits the rows into KS parts, each
// block writes a 64x64 f32 partial, and reduce_kernel adds the parts (and
// the per-block bias sums) in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fmov_train {

using namespace nvcuda;
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

// ---------------------------------------------------------------------------
// Weight gradients: out_l = A_l^T B_l over rows, split in KS row ranges.
// ---------------------------------------------------------------------------

struct AtbJob {
  const bf16* a;   // [rows x lda], columns [0, ni) used
  const bf16* b;   // [rows x ldb], columns [0, nj) used
  float* out;      // split s at out + s * split_stride, [ni x nj]
  int rows, lda, ldb, ni, nj, tj, task0;
};

struct AtbArgs {
  AtbJob job[MAX_LIN];
  int n_jobs, KS, split_stride;
};

constexpr int ATB_LD = 64 + SKEW;

__global__ void __launch_bounds__(THREADS)
    atb_kernel(const __grid_constant__ AtbArgs a) {
  __shared__ __align__(128) bf16 As[KCHUNK * ATB_LD];
  __shared__ __align__(128) bf16 Bs[KCHUNK * ATB_LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int q = a.n_jobs - 1;
  while (q > 0 && (int)blockIdx.x < a.job[q].task0) --q;
  const AtbJob& J = a.job[q];
  const int local = (int)blockIdx.x - J.task0;
  const int split = local % a.KS;
  const int tile = local / a.KS;
  const int i0 = (tile / J.tj) * 64, j0 = (tile % J.tj) * 64;
  const int per = ((J.rows + a.KS - 1) / a.KS + KCHUNK - 1) / KCHUNK * KCHUNK;
  const int r_begin = split * per;
  const int r_end = min(J.rows, r_begin + per);
  const int wi = warp >> 1, wj = (warp & 1) * 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = r_begin; k0 < r_end; k0 += KCHUNK) {
    __syncthreads();
    {
      const int r = tid >> 3, c = (tid & 7) * 8;  // 32 rows x 8 vectors
      const int row = k0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (row < r_end) {
        if (i0 + c < J.ni)
          va = *reinterpret_cast<const uint4*>(J.a + (size_t)row * J.lda + i0 + c);
        if (j0 + c < J.nj)
          vb = *reinterpret_cast<const uint4*>(J.b + (size_t)row * J.ldb + j0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * ATB_LD + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * ATB_LD + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KCHUNK; ks += 16) {
      // A^T tile: element (m, k) = As[ks + k][wi*16 + m] -> column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, As + ks * ATB_LD + wi * 16, ATB_LD);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + ks * ATB_LD + (wj + t) * 16, ATB_LD);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = i0 + wi * 16, j = j0 + (wj + t) * 16;
    if (i < J.ni && j < J.nj)
      wmma::store_matrix_sync(
          J.out + (size_t)split * a.split_stride + (size_t)i * J.nj + j, acc[t],
          J.nj, wmma::mem_row_major);
  }
}

// dw[e] = sum_s part[s * total + e] (+ the column-0 term cb of one layer:
// sum_b cbpart[b * ncb + i] at e = cb_off + i * cb_ld); db[c] = sum_b
// dbpart[b * nb + c].  Fixed summation order.
__global__ void reduce_kernel(const float* part, int KS, int total, float* dw,
                              const float* dbpart, int G, int nb, float* db,
                              const float* cbpart, int ncb, int cb_off,
                              int cb_ld) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) {
    float s = 0.f;
    for (int k = 0; k < KS; ++k) s += part[(size_t)k * total + e];
    if (cbpart != nullptr && e >= cb_off && (e - cb_off) % cb_ld == 0 &&
        (e - cb_off) / cb_ld < ncb) {
      const int i = (e - cb_off) / cb_ld;
      float c = 0.f;
      for (int b = 0; b < G; ++b) c += cbpart[(size_t)b * ncb + i];
      s += c;
    }
    dw[e] = s;
  }
  if (e < nb) {
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += dbpart[(size_t)b * nb + e];
    db[e] = s;
  }
}

// Fills the jobs' task ranges; returns the number of atb blocks.
inline int plan_atb(AtbArgs& a) {
  int task = 0;
  for (int q = 0; q < a.n_jobs; ++q) {
    AtbJob& J = a.job[q];
    J.tj = (J.nj + 63) / 64;
    J.task0 = task;
    task += ((J.ni + 63) / 64) * J.tj * a.KS;
  }
  return task;
}

// Launches atb_kernel and reduce_kernel; returns a cudaError_t.
inline int weight_grads(AtbArgs& a, float* part, int total, float* dw,
                        const float* dbpart, int G, int nb, float* db,
                        const float* cbpart, int ncb, int cb_off, int cb_ld,
                        cudaStream_t stream) {
  a.split_stride = total;
  const int blocks = plan_atb(a);
  if (blocks > 0) {
    atb_kernel<<<blocks, THREADS, 0, stream>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n = imax(total, nb);
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, a.KS, total, dw, dbpart, G, nb, db, cbpart, ncb, cb_off, cb_ld);
  return (int)cudaGetLastError();
}

}  // namespace fmov_train

extern "C" const char* fmov_train_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
