// Gradient-free SDF forward for Hopper (sm_90a): positional encoding, the
// 9-linear IDR SDF MLP with softplus(beta=100) and the skip concat, in one
// kernel.  Replaces the Pallas kernel fmov_pose_tpu/ops/fused_sdf.py
// _make_fwd_kernel (launched by _sdf_forward_impl); the Python side is
// fmov_pose_torch/ops/fused_sdf.py, which packs the weights and checks
// every argument before calling fmov_sdf_fwd.
//
// Arithmetic contract (the TPU kernel's): inputs, biases and outputs f32;
// every product rounds both operands to bf16 and accumulates in f32.
//
// Design.  One block of 8 warps owns TILE_M = 64 points.  Their activations
// stay in shared memory, as bf16, for all layers (two ping-pong buffers),
// and the f32 encoding is kept for the skip layer.  The weights (~1 MB in
// bf16 at 8x256) do not fit in shared memory, so each layer's W^T streams
// through a KCHUNK-row buffer.  Warp w owns output column tiles w, w+8,
// w+16 for all four 16-row tiles and accumulates them with wmma bf16
// 16x16x16 fragments in f32.  The epilogue goes through a per-warp 16x16
// f32 scratch: bias, softplus (then the 1/sqrt(2) of the skip concat when
// the next layer is the skip layer) and the bf16 rounding of the next
// layer's operand.  Odd widths arrive zero-padded from the host (39 -> 48,
// 217 -> 224, 257 -> 272; K to a multiple of KCHUNK), with the skip layer's
// rows re-mapped to the padded [h | xe] layout.  Rows past M are computed
// on zero points and never stored.
//
// What bounds it: ~1.05 MFLOP per point against 12 bytes in and 4 (or
// 1,028) bytes out, so the kernel is compute- and shared-memory-bound; the
// weights are re-read from L2 by every block (1 MB per 64 points).  The
// first version is plain synchronous wmma; cp.async/TMA double buffering,
// wgmma and larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE_M = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KCHUNK = 32;
constexpr int MAX_LIN = 16;
constexpr int COL_TILES_PER_WARP = 3;  // => at most 24 * 16 = 384 columns
constexpr int SKEW = 8;                // bf16 pad per shared-memory row

struct LayerDesc {
  int kp, np, n, w_off, b_off;  // padded K, padded N, real N, offsets
};

struct SdfArgs {
  LayerDesc layer[MAX_LIN];
  int n_lin, skip, pe_dim, pe_pad, lda, ldb;
  float scale;
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

inline int imax(int p, int q) { return p > q ? p : q; }

__device__ __forceinline__ float softplus100(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-100.f * fabsf(z))) * 0.01f;
}

__global__ void __launch_bounds__(THREADS)
    sdf_fwd_kernel(const float* __restrict__ x, int M,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   SdfArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t act_bytes = align128((size_t)TILE_M * a.lda * 2);
  const size_t w_bytes = align128((size_t)KCHUNK * a.ldb * 2);
  const size_t xe_bytes = align128((size_t)TILE_M * a.pe_pad * 4);
  __nv_bfloat16* act[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem),
      reinterpret_cast<__nv_bfloat16*>(smem + act_bytes)};
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + 2 * act_bytes);
  float* xe = reinterpret_cast<float*>(smem + 2 * act_bytes + w_bytes);
  float* scratch =
      reinterpret_cast<float*>(smem + 2 * act_bytes + w_bytes + xe_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * TILE_M;
  const float inv_sqrt2 = 0.70710678118654752f;

  // Padded activation columns meet zero weight rows; they only need to be
  // finite, so both buffers start at zero.
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < TILE_M * a.lda; i += THREADS) {
    act[0][i] = zero;
    act[1][i] = zero;
  }

  // Positional encoding in f32: [x, sin(2^k x), cos(2^k x), ...] per k.
  for (int i = tid; i < TILE_M * a.pe_pad; i += THREADS) {
    const int r = i / a.pe_pad, c = i % a.pe_pad;
    const int gr = row0 + r;
    float v = 0.f;
    if (c < a.pe_dim) {
      int d = c, kind = 0, k = 0;
      if (c >= 3) {
        const int q = c - 3;
        k = q / 6;
        kind = (q % 6) < 3 ? 1 : 2;
        d = (q % 6) % 3;
      }
      const float xs = gr < M ? x[(size_t)gr * 3 + d] * a.scale : 0.f;
      if (kind == 0) {
        v = xs;
      } else {
        const float arg = xs * (float)(1 << k);
        v = kind == 1 ? sinf(arg) : cosf(arg);
      }
    }
    xe[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < TILE_M * a.pe_pad; i += THREADS) {
    const int r = i / a.pe_pad, c = i % a.pe_pad;
    act[0][r * a.lda + c] = __float2bfloat16(xe[i]);
  }

  float* scr = scratch + warp * 256;
  for (int l = 0; l < a.n_lin; ++l) {
    const LayerDesc L = a.layer[l];
    __nv_bfloat16* in = act[l & 1];
    __nv_bfloat16* outb = act[(l + 1) & 1];
    const bool last = (l == a.n_lin - 1);
    const bool skip_next = (l + 1 == a.skip);
    const int ncol = L.np / 16;

    if (l == a.skip && l > 0) {
      // second half of the skip input: xe / sqrt(2) after the padded h
      const int off = a.layer[l - 1].np;
      for (int i = tid; i < TILE_M * a.pe_pad; i += THREADS) {
        const int r = i / a.pe_pad, c = i % a.pe_pad;
        in[r * a.lda + off + c] = __float2bfloat16(xe[i] * inv_sqrt2);
      }
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][COL_TILES_PER_WARP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < COL_TILES_PER_WARP; ++jj)
        wmma::fill_fragment(acc[i][jj], 0.f);

    const __nv_bfloat16* wl = w + L.w_off;
    const int vec_per_row = L.np / 8;  // 16-byte vectors of 8 bf16
    for (int k0 = 0; k0 < L.kp; k0 += KCHUNK) {
      __syncthreads();  // wbuf free, and this layer's input complete
      for (int i = tid; i < KCHUNK * vec_per_row; i += THREADS) {
        const int r = i / vec_per_row, c = i % vec_per_row;
        reinterpret_cast<uint4*>(wbuf + r * a.ldb)[c] =
            reinterpret_cast<const uint4*>(wl + (size_t)(k0 + r) * L.np)[c];
      }
      __syncthreads();
      if (warp < ncol) {
#pragma unroll
        for (int ks = 0; ks < KCHUNK; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wmma::load_matrix_sync(fa[i], in + i * 16 * a.lda + k0 + ks, a.lda);
#pragma unroll
          for (int jj = 0; jj < COL_TILES_PER_WARP; ++jj) {
            const int j = warp + jj * WARPS;
            if (j < ncol) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fb, wbuf + ks * a.ldb + j * 16, a.ldb);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                wmma::mma_sync(acc[i][jj], fa[i], fb, acc[i][jj]);
            }
          }
        }
      }
    }

    // Epilogue; other warps may still be in the K loop, but they read
    // `in` and `wbuf` only, and this writes `outb` or global memory.
    const float* bl = bias + L.b_off;
#pragma unroll
    for (int jj = 0; jj < COL_TILES_PER_WARP; ++jj) {
      const int j = warp + jj * WARPS;
      if (j >= ncol) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::store_matrix_sync(scr, acc[i][jj], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int e = lane * 8 + t;
          const int rr = i * 16 + (e >> 4);
          const int n = j * 16 + (e & 15);
          const float z = scr[e] + bl[n];
          if (!last) {
            float h = softplus100(z);
            if (skip_next) h *= inv_sqrt2;
            outb[rr * a.lda + n] = __float2bfloat16(h);
          } else {
            const int gr = row0 + rr;
            if (gr < M && n < L.n)
              out[(size_t)gr * L.n + n] = (n == 0) ? z / a.scale : z;
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" {

// meta: [n_lin, skip, multires, then per layer kp, np, n, w_off, b_off].
// Returns a cudaError_t (0 = launched).
int fmov_sdf_fwd(const float* x, int M, float scale, const void* w,
                 const float* bias, const int* meta, int n_meta, float* out,
                 void* stream) {
  SdfArgs a;
  if (n_meta < 3) return (int)cudaErrorInvalidValue;
  a.n_lin = meta[0];
  a.skip = meta[1];
  const int multires = meta[2];
  if (a.n_lin < 1 || a.n_lin > MAX_LIN || n_meta != 3 + 5 * a.n_lin)
    return (int)cudaErrorInvalidValue;
  a.pe_dim = 3 * (1 + 2 * multires);
  a.pe_pad = (a.pe_dim + 15) / 16 * 16;
  a.scale = scale;
  int max_w = a.pe_pad, max_np = 16;
  for (int l = 0; l < a.n_lin; ++l) {
    LayerDesc& L = a.layer[l];
    const int* m = meta + 3 + 5 * l;
    L.kp = m[0];
    L.np = m[1];
    L.n = m[2];
    L.w_off = m[3];
    L.b_off = m[4];
    if (L.kp % KCHUNK || L.np % 16 || L.np > 16 * WARPS * COL_TILES_PER_WARP ||
        L.n > L.np || L.w_off % 8)
      return (int)cudaErrorInvalidValue;
    max_w = imax(max_w, imax(L.kp, L.np));
    max_np = imax(max_np, L.np);
  }
  a.lda = max_w + SKEW;
  a.ldb = max_np + SKEW;
  const size_t smem = 2 * align128((size_t)TILE_M * a.lda * 2) +
                      align128((size_t)KCHUNK * a.ldb * 2) +
                      align128((size_t)TILE_M * a.pe_pad * 4) +
                      (size_t)WARPS * 256 * 4;
  cudaError_t e = cudaFuncSetAttribute(
      sdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0) return 0;
  const int grid = (M + TILE_M - 1) / TILE_M;
  sdf_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, M, static_cast<const __nv_bfloat16*>(w), bias, out, a);
  return (int)cudaGetLastError();
}

const char* fmov_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
