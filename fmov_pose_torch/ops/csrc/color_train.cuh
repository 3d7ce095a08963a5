// The IDR color MLP's tile code, shared by K8/K9 (color_ray.cu) and K6/K7
// (color_sample.cu): the same math with other input and output stages.
//
// A block owns a 64-sample tile at a time and runs the tile's products on
// the per-point pipeline (pipe.cuh: the weight ring over a product
// sequence, mma.sync register epilogues, A operands in shared memory).
// The forward kernels K8/K6 walk ColorFwdSeq, the L products of the
// forward; the backward kernels K9/K7 walk ColorBwdSeq, the forward again
// and then the descent.  Both run the forward through one function,
// color_forward: the input stage writes X_0 (bf16, zero past d_in and past
// M) into the first A, the ReLU layers X_{l+1} = bf16(relu(X_l W_l + b_l))
// go from A to A, and the 16-wide last layer hands the per-sample rgb c =
// sigmoid(p) to the caller's epilogue.  Only the backward's sequence
// (kOperands) also stores X_l to the workspace, keeps each hidden layer's
// ReLU mask as bits in shared memory in the warps' fragment order, and
// takes the cotangent of the last pre-activation, z = cbar c (1 - c) (cbar
// from its caller), and the bias sums.  color_bwd_tile then descends:
// inpbar_l = ZB_l W_l^T, ZB_{l-1} = inpbar_l [X_l > 0]; at layer 0 the
// caller's stage takes the input cotangent.  ZB_l also goes row-major to
// the workspace, where the weight gradients X_l^T ZB_l over all samples are
// the weight-gradient stage's (wgrad.cu), which the Python wrappers launch
// after the pass; those and the bias sums are taken in a fixed order, so
// they are the same from run to run.  The forward
// writes nothing but its output.

#pragma once

#include "pipe.cuh"

namespace fmov_train {

struct ColorCore {
  Layer L[MAX_LIN];
  int n_lin, d_in, M, M_pad, lda, ldb, n_bias;
  const bf16* w;
  const float* bias;
  bf16* X[MAX_LIN];   // layer inputs, row stride kp(l) (backward)
  bf16* ZB[MAX_LIN];  // output cotangents, row stride np(l) (backward)
  float* dbpart;      // [G x n_bias] (backward)
};

__device__ __forceinline__ float color_sigmoid(float p) { return 1.f / (1.f + expf(-p)); }

// The product sequences of a tile: product p's weight block (offset, K,
// N).  The ring issues them in this order and the tile consumes them in
// the same order, product for product and chunk for chunk, across tiles.
// kOperands: the forward also keeps what the backward needs (X_l in the
// workspace, the ReLU mask bits, the last layer's cotangent and the bias
// sums), a compile-time flag.
//
// K8/K6: the forward l = 0..L-1, the 3-wide last layer included, L
// products, 5 at 4x256.
struct ColorFwdSeq {
  static constexpr bool kOperands = false;
  static __device__ __forceinline__ int count(const ColorCore& k) { return k.n_lin; }
  static __device__ __forceinline__ void product(const ColorCore& k, int p, int& off,
                                                 int& K, int& N) {
    const Layer& Ly = k.L[p];
    off = Ly.w_off;
    K = Ly.kp;
    N = Ly.np;
  }
};

// K9/K7: the forward, then the descent l = L-1..0 on the reverse blocks
// (inpbar_l = ZB_l W_l^T: K = kr, N = kp), 2 L products, 10 at 4x256.
struct ColorBwdSeq {
  static constexpr bool kOperands = true;
  static __device__ __forceinline__ int count(const ColorCore& k) { return 2 * k.n_lin; }
  static __device__ __forceinline__ void product(const ColorCore& k, int p, int& off,
                                                 int& K, int& N) {
    const bool rev = p >= k.n_lin;
    const Layer& Ly = k.L[rev ? 2 * k.n_lin - 1 - p : p];
    off = rev ? Ly.r_off : Ly.w_off;
    K = rev ? Ly.kr : Ly.kp;
    N = rev ? Ly.kp : Ly.np;
  }
};

// The shared memory of a block, in this order; MASK and DBACC only with
// Seq::kOperands.
struct ColorPipeSmem {
  bf16* A;         // 2 x [TILE_M x lda]: product p's A operand in A + (p % 2)
  bf16* ring;      // RING x [KCHUNK x ldb]
  unsigned* MASK;  // [L-1 x COLT x THREADS]: X_{l+1} > 0, a word a lane and column tile
  float* DBACC;    // [n_bias]
  unsigned char* rest;  // the caller's own shared memory
};

template <class Seq>
inline size_t color_pipe_smem(const ColorCore& k, size_t rest) {
  size_t s = 2 * align128((size_t)TILE_M * k.lda * 2) +
             align128((size_t)RING * KCHUNK * k.ldb * 2);
  if (Seq::kOperands)
    s += align128((size_t)(k.n_lin - 1) * COLT * THREADS * 4) + align128((size_t)k.n_bias * 4);
  return s + rest;
}

template <class Seq>
__device__ __forceinline__ ColorPipeSmem color_pipe_carve(const ColorCore& k,
                                                          unsigned char* smem) {
  ColorPipeSmem m;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = smem + off;
    off += align128(bytes);
    return p;
  };
  m.A = reinterpret_cast<bf16*>(take(2 * (size_t)TILE_M * k.lda * 2));
  m.ring = reinterpret_cast<bf16*>(take((size_t)RING * KCHUNK * k.ldb * 2));
  m.MASK = nullptr;
  m.DBACC = nullptr;
  if (Seq::kOperands) {
    m.MASK = reinterpret_cast<unsigned*>(take((size_t)(k.n_lin - 1) * COLT * THREADS * 4));
    m.DBACC = reinterpret_cast<float*>(take((size_t)k.n_bias * 4));
  }
  m.rest = smem + off;
  return m;
}

// The block's start: the ring's first chunks in flight (and, with
// Seq::kOperands, the bias sums zeroed).
template <class Seq>
__device__ __forceinline__ WRing<Seq> color_block_start(const ColorCore& k,
                                                        const ColorPipeSmem& m) {
  if (Seq::kOperands)
    for (int i = threadIdx.x; i < k.n_bias; i += THREADS) m.DBACC[i] = 0.f;
  return ring_start<Seq>(k, m.ring);
}

// The tile's input X_0 (bf16) into A, product 0's operand (and, with
// kStore, into the workspace for the weight-gradient product): load(gr, c)
// at the real rows gr < M and columns c < d_in, zero elsewhere up to in_w,
// and zeros in A up to kp(0).  Column pairs, the loads of PB pairs in
// flight together.
template <bool kStore, class Load>
__device__ __forceinline__ void color_x0_stage(const ColorCore& k, int row0, bf16* A,
                                               Load load) {
  const Layer& L0 = k.L[0];
  const int half = L0.in_w / 2;
  const int total = TILE_M * half;
  bf16* X0 = kStore ? k.X[0] + (size_t)row0 * L0.kp : nullptr;
  constexpr int PB = 4;
  for (int i0 = threadIdx.x; i0 < total; i0 += PB * THREADS) {
    float u[PB][2];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int i = i0 + q * THREADS;
      const int r = i / half, c = (i - r * half) * 2;
      const int gr = row0 + r;
      u[q][0] = u[q][1] = 0.f;
      if (i < total && gr < k.M) {
        if (c < k.d_in) u[q][0] = load(gr, c);
        if (c + 1 < k.d_in) u[q][1] = load(gr, c + 1);
      }
    }
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int i = i0 + q * THREADS;
      if (i >= total) break;
      const int r = i / half, c = (i - r * half) * 2;
      if (kStore) st_bf16x2(X0 + (size_t)r * L0.kp + c, u[q][0], u[q][1]);
      st_bf16x2(A + r * k.lda + c, u[q][0], u[q][1]);
    }
  }
  zero_a(A, k.lda, L0.in_w, L0.kp);
}

// The forward of a tile, products 0..L-1 of Seq, product p's A operand in
// A + (p % 2), written by the epilogue (or the input stage) before it:
//   1. color_x0_stage: X_0 from load(gr, c) into A; padded rows (gr >= M)
//      get zeros;
//   2. the layers l < L-1: X_{l+1} = bf16(relu(X_l W_l + b_l)) into the
//      next A;
//   3. the last layer: c = sigmoid(p + b), the per-sample rgb.  Warp 0
//      alone owns the 16-wide product; lanes 4q and 4q + 1 hold a row's
//      three channels (v[0], v[1] at columns n, n + 1 of row r, v[2],
//      v[3] of row r + 8).
// Without Seq::kOperands (K8, K6) last(f, row0, c) sees the rgb, and cot
// is not called.  With it (K9, K7) the forward also stores X_0..X_{L-1} to
// the workspace and each hidden layer's mask bits to MASK (the lane's bit
// (4 h + i) 4 + e of word l COLT + j / 8 is element e of Frag (i, j, h),
// the same register of the same lane in descent product l + 1); at the
// last layer cot(f, row0) loads ct (in.a) and w (in.b.x, in.b.y, for rows
// r and r + 8) of a Frag, last(f, row0, c, in) sees the rgb, and z = ct w
// c (1 - c) at the rgb columns of real rows, 0 elsewhere, goes into the
// next A, ZB_{L-1} and the bias sums.  Returns the products taken.
template <class Seq, class Load, class Cot, class Last>
__device__ __forceinline__ int color_forward(const ColorCore& k, int row0,
                                             const ColorPipeSmem& m, WRing<Seq>& R,
                                             Load load, Cot cot, Last last) {
  constexpr bool ops = Seq::kOperands;
  const int L1 = k.n_lin - 1;
  const size_t a_elems = (size_t)TILE_M * k.lda;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  int p = 0;
  __syncthreads();  // A and the caller's shared memory free
  color_x0_stage<ops>(k, row0, buf(0), load);

  for (int l = 0; l < L1; ++l, ++p) {
    const Layer& Ly = k.L[l];
    const float* b = k.bias + Ly.b_off;
    const int kp_next = k.L[l + 1].kp;
    bf16* X = ops ? k.X[l + 1] + (size_t)row0 * kp_next : nullptr;
    bf16* An = buf(p + 1);
    pipe_gemm(k, R, buf(p), k.lda, Ly.kp, Ly.np, nullptr, 0,
              [&](const Frag& f) { return make_float2(b[f.n], b[f.n + 1]); },
              [&](const Frag& f, float (&v)[4], const float2& bn) {
                const __nv_bfloat162 x0 = __floats2bfloat162_rn(fmaxf(v[0] + bn.x, 0.f),
                                                                fmaxf(v[1] + bn.y, 0.f));
                const __nv_bfloat162 x1 = __floats2bfloat162_rn(fmaxf(v[2] + bn.x, 0.f),
                                                                fmaxf(v[3] + bn.y, 0.f));
                if (ops) {
                  *reinterpret_cast<__nv_bfloat162*>(X + f.r * kp_next + f.n) = x0;
                  *reinterpret_cast<__nv_bfloat162*>(X + (f.r + 8) * kp_next + f.n) = x1;
                }
                *reinterpret_cast<__nv_bfloat162*>(An + f.r * k.lda + f.n) = x0;
                *reinterpret_cast<__nv_bfloat162*>(An + (f.r + 8) * k.lda + f.n) = x1;
                if (ops) {
                  const unsigned e = (__bfloat162float(x0.x) > 0.f ? 1u : 0u) |
                                     (__bfloat162float(x0.y) > 0.f ? 2u : 0u) |
                                     (__bfloat162float(x1.x) > 0.f ? 4u : 0u) |
                                     (__bfloat162float(x1.y) > 0.f ? 8u : 0u);
                  // The Frag's own nibble of its lane's word, whatever order
                  // pipe_gemm runs the Frags in: the word is whole once every
                  // Frag of its column tile has run.
                  const int s = (f.h * 4 + f.i) * 4;
                  unsigned* w = m.MASK + ((size_t)l * COLT + f.j / WARPS) * THREADS +
                                threadIdx.x;
                  *w = (*w & ~(0xFu << s)) | (e << s);
                }
              });
    zero_a(An, k.lda, Ly.np, kp_next);
  }

  // the last layer
  const Layer& Ly = k.L[L1];
  const float* b = k.bias + Ly.b_off;
  bf16* Z = ops ? k.ZB[L1] + (size_t)row0 * Ly.np : nullptr;
  bf16* An = buf(p + 1);
  pipe_gemm(k, R, buf(p), k.lda, Ly.kp, Ly.np, ops ? m.DBACC + Ly.b_off : nullptr,
            ops ? Ly.np : 0,
            [&](const Frag& f) {
              In2 in;
              if constexpr (ops) {
                in = cot(f, row0);
              } else {
                in.a = in.b = make_float4(0.f, 0.f, 0.f, 0.f);
              }
              in.b.z = b[f.n];
              in.b.w = b[f.n + 1];
              return in;
            },
            [&](const Frag& f, float (&v)[4], const In2& in) {
              float c[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                c[e] = color_sigmoid(v[e] + ((e & 1) ? in.b.w : in.b.z));
              if constexpr (ops) {
                const float ct[4] = {in.a.x, in.a.y, in.a.z, in.a.w};
                float z[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const bool real = f.n + (e & 1) < 3 && row0 + f.r + 8 * (e >> 1) < k.M;
                  const float w = (e >> 1) ? in.b.y : in.b.x;
                  z[e] = real ? ct[e] * w * c[e] * (1.f - c[e]) : 0.f;
                }
                last(f, row0, c, in);
                st_frag_bf16(Z, Ly.np, f, z[0], z[1], z[2], z[3]);
                st_frag_bf16(An, k.lda, f, z[0], z[1], z[2], z[3]);
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] = z[e];
              } else {
                last(f, row0, c);
              }
            });
  if (ops) zero_a(An, k.lda, Ly.np, Ly.kr);
  return p + 1;
}

// The backward of a tile, 2 L products in ColorBwdSeq's order, product
// p's A operand in A + (p % 2), written by the epilogue (or the input
// stage) before it: color_forward with its operands (load, cot and last
// as there), then the descent l = L-1..0: inpbar = ZB_l W_l^T; ZB_{l-1} =
// inpbar [X_l > 0] into the next A, the workspace and the bias sums; at l
// = 0, in0(f, row0, v) for the input cotangent (every row: its caller
// skips rows past M).  Padded rows (gr >= M) get z = 0, so their ZB are 0.
// The block may read what in0 wrote to shared memory after the barrier at
// the end.
template <class Load, class Cot, class Last, class In0>
__device__ __forceinline__ void color_bwd_tile(const ColorCore& k, int row0,
                                               const ColorPipeSmem& m,
                                               WRing<ColorBwdSeq>& R, Load load,
                                               Cot cot, Last last, In0 in0) {
  const size_t a_elems = (size_t)TILE_M * k.lda;
  auto buf = [&](int q) { return m.A + (q & 1) * a_elems; };
  auto word = [&](int q, const Frag& f) {
    return m.MASK + ((size_t)q * COLT + f.j / WARPS) * THREADS + threadIdx.x;
  };
  int p = color_forward(k, row0, m, R, load, cot, last);

  for (int l = k.n_lin - 1; l >= 0; --l, ++p) {
    const Layer& Ly = k.L[l];
    const int h_w = l > 0 ? Ly.in_w : 0;  // = np(l-1), a multiple of 16
    const int np_prev = l > 0 ? k.L[l - 1].np : 0;
    float* cs = l > 0 ? m.DBACC + k.L[l - 1].b_off : nullptr;
    bf16* Z = l > 0 ? k.ZB[l - 1] + (size_t)row0 * np_prev : nullptr;
    bf16* An = buf(p + 1);
    pipe_gemm(k, R, buf(p), k.lda, Ly.kr, Ly.kp, cs, h_w,
              [&](const Frag& f) { return f.n < h_w ? *word(l - 1, f) : 0u; },
              [&](const Frag& f, float (&v)[4], unsigned mask) {
                if (f.n < h_w) {
                  const unsigned e = mask >> ((f.h * 4 + f.i) * 4);
                  const float z[4] = {(e & 1u) ? v[0] : 0.f, (e & 2u) ? v[1] : 0.f,
                                      (e & 4u) ? v[2] : 0.f, (e & 8u) ? v[3] : 0.f};
                  st_frag_bf16(Z, np_prev, f, z[0], z[1], z[2], z[3]);
                  st_frag_bf16(An, k.lda, f, z[0], z[1], z[2], z[3]);
                  const int g0 = row0 + f.r;
                  const bool in0r = g0 < k.M, in1r = g0 + 8 < k.M;
                  v[0] = in0r ? z[0] : 0.f;
                  v[1] = in0r ? z[1] : 0.f;
                  v[2] = in1r ? z[2] : 0.f;
                  v[3] = in1r ? z[3] : 0.f;
                  return;
                }
                if (l == 0) in0(f, row0, v);
                v[0] = v[1] = v[2] = v[3] = 0.f;
              });
    if (l > 0) zero_a(An, k.lda, np_prev, k.L[l - 1].kr);
  }
  __syncthreads();
}

// The block's end: no copy left in flight (and, with Seq::kOperands, its
// bias sums to dbpart[blockIdx.x]).
template <class Seq>
__device__ __forceinline__ void color_block_end(const ColorCore& k,
                                                const ColorPipeSmem& m) {
  cp_async_wait<0>();
  if (!Seq::kOperands) return;
  __syncthreads();
  for (int i = threadIdx.x; i < k.n_bias; i += THREADS)
    k.dbpart[(size_t)blockIdx.x * k.n_bias + i] = m.DBACC[i];
}

// Reads the layer table and, for the backward, the workspace table
// (X_0..X_{L-1}, ZB_0..ZB_{L-1}, DBPART; a forward reads none of it);
// *next is the index of the first pointer not read.  Returns a
// cudaError_t.
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
  k.dbpart = nullptr;
  int p = 0;
  if (backward) {
    for (int l = 0; l < n_lin; ++l) k.X[l] = reinterpret_cast<bf16*>(ptrs[p++]);
    for (int l = 0; l < n_lin; ++l) k.ZB[l] = reinterpret_cast<bf16*>(ptrs[p++]);
    k.dbpart = reinterpret_cast<float*>(ptrs[p++]);
  }
  *next = p;
  return 0;
}

// Host side of the per-point pass: `kernel` on G blocks (one per SM at
// most) with the shared memory of Seq's carve and `rest` bytes of the
// caller's own.  Returns a cudaError_t.
template <class Seq, class Kernel, class Args>
inline int color_pass_launch(Kernel kernel, const Args& a, const ColorCore& k,
                             size_t rest, int G, cudaStream_t st) {
  const size_t smem = color_pipe_smem<Seq>(k, rest);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (k.M <= 0) return 0;
  kernel<<<G, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fmov_train
