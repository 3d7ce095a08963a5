// The IDR color MLP's tile code, shared by K8/K9 (color_ray.cu) and K6/K7
// (color_sample.cu): the same math with other input and output stages.
//
// A block owns a 64-sample tile at a time.  Its caller writes the tile's
// input X_0 (bf16, row stride kp(0), zero past d_in); then the ReLU layers
// X_{l+1} = bf16(relu(X_l W_l + b_l)) go through tile_gemm
// (train_common.cuh), staged in device memory, and the last layer's
// pre-activation p reaches the caller's epilogue.  The backward recomputes
// that forward, takes the cotangent z of p from its caller (per sample
// rgb c = sigmoid(p), z = cbar c (1 - c)) and descends: inpbar = zbar_l
// W_l^T, zbar_{l-1} = inpbar [X_l > 0]; at layer 0 the caller's stage
// takes the input cotangent.  Weight gradients X_l^T ZB_l over all samples
// and the bias sums go through atb_kernel / reduce_kernel in a fixed
// order, so they are the same from run to run.

#pragma once

#include "train_common.cuh"

namespace fmov_train {

struct ColorCore {
  Layer L[MAX_LIN];
  int n_lin, d_in, M, M_pad, lda, ldb, n_bias;
  const bf16* w;
  const float* bias;
  bf16* X[MAX_LIN];   // layer inputs, row stride kp(l)
  bf16* ZB[MAX_LIN];  // output cotangents, row stride np(l) (backward)
  float* dbpart;      // [G x n_bias] (backward)
};

struct ColorSmem {
  bf16* Asm;
  bf16* wbuf;
  float* scr;
  unsigned char* rest;  // the caller's own shared memory
};

__device__ __forceinline__ ColorSmem color_carve(unsigned char* smem, int lda,
                                                 int ldb) {
  ColorSmem m;
  m.Asm = reinterpret_cast<bf16*>(smem);
  size_t off = align128((size_t)TILE_M * lda * 2);
  m.wbuf = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)KCHUNK * ldb * 2);
  m.scr = reinterpret_cast<float*>(smem + off) + (threadIdx.x >> 5) * 256;
  off += align128((size_t)WARPS * 256 * 4);
  m.rest = smem + off;
  return m;
}

// Bytes of shared memory: the carve above plus the caller's ``rest``.
inline size_t color_smem(const ColorCore& k, size_t rest) {
  return align128((size_t)TILE_M * k.lda * 2) + align128((size_t)KCHUNK * k.ldb * 2) +
         align128((size_t)WARPS * 256 * 4) + rest;
}

// Hidden layer l < L-1: X_{l+1} = bf16(relu(X_l W_l + b_l)).
__device__ __forceinline__ void color_hidden_layer(const ColorCore& k, int l,
                                                   int row0, const ColorSmem& m) {
  const Layer& Ly = k.L[l];
  __syncthreads();
  load_tile(m.Asm, k.lda, k.X[l] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
  const float* b = k.bias + Ly.b_off;
  bf16* xn = k.X[l + 1];
  const int kp_next = k.L[l + 1].kp;
  tile_gemm(m.Asm, k.lda, k.w + Ly.w_off, Ly.kp, Ly.np, m.wbuf, k.ldb, m.scr,
            nullptr, 0, [&](int r, int n, float v) -> float {
              xn[(size_t)(row0 + r) * kp_next + n] =
                  __float2bfloat16(fmaxf(v + b[n], 0.f));
              return 0.f;
            });
}

// The forward of a tile whose X_0 is written: epi(r, n, p) sees the last
// layer's pre-activation p = X_{L-1} W_{L-1} + b; its return values go to
// colsum[n] when colsum is set.
template <class Epi>
__device__ __forceinline__ void color_forward_tile(const ColorCore& k, int row0,
                                                   const ColorSmem& m,
                                                   float* colsum, Epi epi) {
  const int last = k.n_lin - 1;
  for (int l = 0; l < last; ++l) color_hidden_layer(k, l, row0, m);
  const Layer& Ly = k.L[last];
  __syncthreads();
  load_tile(m.Asm, k.lda, k.X[last] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
  const float* b = k.bias + Ly.b_off;
  tile_gemm(m.Asm, k.lda, k.w + Ly.w_off, Ly.kp, Ly.np, m.wbuf, k.ldb, m.scr,
            colsum, colsum != nullptr ? Ly.np : 0,
            [&](int r, int n, float v) -> float { return epi(r, n, v + b[n]); });
}

// The forward of a backward pass: the cotangent of the last layer's
// pre-activation, z = zfn(r, gr, n, p) for the rgb columns n < 3 of real
// samples gr < M (0 elsewhere), goes to ZB_{L-1} and to the bias sums
// DBACC.
template <class Z>
__device__ __forceinline__ void color_forward_cot(const ColorCore& k, int row0,
                                                  const ColorSmem& m, float* DBACC,
                                                  Z zfn) {
  const int last = k.n_lin - 1;
  bf16* zb = k.ZB[last];
  const int np = k.L[last].np;
  color_forward_tile(k, row0, m, DBACC + k.L[last].b_off,
                     [&](int r, int n, float p) -> float {
                       const int gr = row0 + r;
                       float z = 0.f;
                       if (n < 3 && gr < k.M) z = zfn(r, gr, n, p);
                       zb[(size_t)gr * np + n] = __float2bfloat16(z);
                       return z;
                     });
}

// The descent from ZB_{L-1}: inpbar_l = ZB_l W_l^T, ZB_{l-1} = inpbar_l
// [X_l > 0] (its column sums into DBACC), and in0(r, gr, n, v) for every
// input column n < d_in of layer 0 (padded rows included: gr may be >= M).
template <class In0>
__device__ __forceinline__ void color_descent(const ColorCore& k, int row0,
                                              const ColorSmem& m, float* DBACC,
                                              In0 in0) {
  for (int l = k.n_lin - 1; l >= 0; --l) {
    const Layer& Ly = k.L[l];
    __syncthreads();
    load_tile(m.Asm, k.lda, k.ZB[l] + (size_t)row0 * Ly.np, Ly.np, Ly.np, Ly.kr);
    const int h_w = l > 0 ? Ly.in_w : 0;
    const bf16* xl = k.X[l];
    bf16* zbp = l > 0 ? k.ZB[l - 1] : nullptr;
    const int np_prev = l > 0 ? k.L[l - 1].np : 0;
    float* cs = l > 0 ? DBACC + k.L[l - 1].b_off : nullptr;
    tile_gemm(m.Asm, k.lda, k.w + Ly.r_off, Ly.kr, Ly.kp, m.wbuf, k.ldb, m.scr, cs,
              h_w, [&](int r, int n, float v) -> float {
                const int gr = row0 + r;
                if (n < h_w) {
                  const bool on = __bfloat162float(xl[(size_t)gr * Ly.kp + n]) > 0.f;
                  const float z = on ? v : 0.f;
                  zbp[(size_t)gr * np_prev + n] = __float2bfloat16(z);
                  return gr < k.M ? z : 0.f;
                }
                if (l == 0 && n < k.d_in) in0(r, gr, n, v);
                return 0.f;
              });
  }
}

// After the block's last tile: its bias sums to dbpart[blockIdx.x].
__device__ __forceinline__ void color_store_bias_sums(const ColorCore& k,
                                                      const float* DBACC) {
  __syncthreads();
  for (int i = threadIdx.x; i < k.n_bias; i += THREADS)
    k.dbpart[(size_t)blockIdx.x * k.n_bias + i] = DBACC[i];
}

// Reads the layer table and the workspace table (X_0..X_{L-1}, then for
// the backward ZB_0..ZB_{L-1} and DBPART); *next is the index of the
// first pointer not read.  Returns a cudaError_t.
inline int color_core_setup(ColorCore& k, const void* w, const float* bias,
                            const int* meta, int n_lin, int d_in, int M, int M_pad,
                            const unsigned long long* ptrs, bool backward,
                            int* next) {
  int max_k, max_n;
  int e = read_layers(meta, n_lin, k.L, &max_k, &max_n, &k.n_bias);
  if (e) return e;
  if (n_lin < 2 || d_in < 1 || M_pad % TILE_M || M < 0 || M > M_pad ||
      (M > 0 && M_pad - M >= TILE_M) || k.L[0].in_w < d_in ||
      k.L[0].in_w - d_in >= 16 || k.L[n_lin - 1].n != 3)
    return (int)cudaErrorInvalidValue;
  for (int l = 1; l < n_lin; ++l)
    if (k.L[l].in_w != k.L[l - 1].np) return (int)cudaErrorInvalidValue;
  k.n_lin = n_lin;
  k.d_in = d_in;
  k.M = M;
  k.M_pad = M_pad;
  k.lda = max_k + SKEW;
  k.ldb = max_n + SKEW;
  k.w = static_cast<const bf16*>(w);
  k.bias = bias;
  for (int l = 0; l < MAX_LIN; ++l) k.X[l] = k.ZB[l] = nullptr;
  int p = 0;
  for (int l = 0; l < n_lin; ++l) k.X[l] = reinterpret_cast<bf16*>(ptrs[p++]);
  k.dbpart = nullptr;
  if (backward) {
    for (int l = 0; l < n_lin; ++l) k.ZB[l] = reinterpret_cast<bf16*>(ptrs[p++]);
    k.dbpart = reinterpret_cast<float*>(ptrs[p++]);
  }
  *next = p;
  return 0;
}

// Launches the weight-gradient products X_l^T ZB_l over the M_pad rows
// (dwpart: KS partial sums of the padded [in_w x np] blocks,
// concatenated) and the reduction into dw and db (the G bias partials).
// Returns a cudaError_t.
inline int color_weight_grads(const ColorCore& k, float* dwpart, int G, int KS,
                              float* dw, float* db, cudaStream_t st) {
  AtbArgs t;
  t.n_jobs = k.n_lin;
  t.KS = KS;
  int total = 0;
  for (int l = 0; l < k.n_lin; ++l) {
    AtbJob& J = t.job[l];
    const Layer& L = k.L[l];
    J.a = k.X[l];
    J.b = k.ZB[l];
    J.rows = k.M_pad;
    J.lda = L.kp;
    J.ldb = L.np;
    J.ni = L.in_w;
    J.nj = L.np;
    J.out = dwpart + total;
    total += L.in_w * L.np;
  }
  return weight_grads(t, dwpart, total, dw, k.dbpart, G, k.n_bias, db, nullptr, 0, 0,
                      1, st);
}

__device__ __forceinline__ float color_sigmoid(float p) { return 1.f / (1.f + expf(-p)); }

}  // namespace fmov_train
