// K5: the second-order backward of K4, for Hopper (sm_90a).  Replaces the
// Pallas kernel fmov_pose_tpu/ops/fused_sdf.py _make_bwd_rays_kernel
// (launched by _sdf_bwd_rays_impl through _sdf_rays_bwd); the Python side
// is fmov_pose_torch/ops/fused_sdf.py (launch_bwd).
//
// Given the cotangents of out [M x n_out], sdf [M] and grad [M x 3], per
// 64-point tile (notation in sdf_train.cuh, derivation in the JAX module
// at ops/fused_sdf.py:407-434):
//   1. PE, and gbar = ct_grad[dim] PE' (the cotangent of DIN);
//   2. forward to layer L-2 (sig_l, X_l) and the reverse chain (d_l, D_l,
//      DIN), recomputed as the JAX kernel does;
//   3. Phase A, ascending l <= L-2: fbar_l (gbar at l = 0, [dbar/sqrt2 |
//      gbar/sqrt2] at S), ebar = fbar_l W_l, dbar_{l+1} = ebar sig_l, the
//      Hessian term ZC_l = ebar d_{l+1} 100 sig_l (1 - sig_l); at l = L-2
//      the column sums of dbar (the last layer's column-0 term);
//   4. Phase B, descending l: zbar_{L-1} = ybar = [(ct_out0 + ct_sdf) /
//      scale, ct_out1..]; inpbar = zbar_l W_l^T; the h part gives
//      zbar_{l-1} = inpbar sig_{l-1} + ZC_{l-1}, the PE part adds to XEB;
//      bias gradients are column sums of zbar;
//   5. xbar = scale sum over the PE columns of (XEB PE' + ct_grad DIN PE'').
// The weight gradients are then dW_l = [FB_l; X_l]^T [D_l; ZB_l], the
// Phase A and Phase B terms stacked over 2 M_pad rows (X_{L-1}^T ZB_{L-1}
// for the last layer, plus the column-0 term), computed by atb_kernel and
// reduced with the per-block bias sums by reduce_kernel
// (train_common.cuh).  Three launches.
//
// What bounds it: ~4.4 MFLOP of per-point products and ~2.3 MFLOP of
// weight-gradient products per point at 8x256, so the products; the
// ~40 KB a point of intermediates (bf16 operands, f32 sigmoids, d_l and
// Hessian terms) are staged in the workspace in device memory, read back
// by the block that wrote them.  Determinism: one block per SM with fixed
// tiles, column sums in fixed order, split-K partials reduced in order.

#include "sdf_train.cuh"

namespace fmov_train {
namespace {

struct BwdArgs {
  SdfArgs s;
  bf16* FB[MAX_LIN];     // fbar_l, row stride kp(l), l < L-1
  bf16* ZB[MAX_LIN];     // zbar_l, row stride np(l)
  float* ZC[MAX_LIN];    // Hessian term, row stride np(l), l < L-1
  const float* ct_out;   // [M x n_out]
  const float* ct_sdf;   // [M]
  const float* ct_grad;  // [M x 3]
  float* xbar;           // [M x 3]
  float* dbpart;         // [G x n_bias]
  float* cbpart;         // [G x np(L-2)]
  int n_out, n_bias;
};

__global__ void __launch_bounds__(THREADS, 1)
    sdf_bwd_kernel(const __grid_constant__ BwdArgs a) {
  const SdfArgs& s = a.s;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Asm = reinterpret_cast<bf16*>(smem);
  size_t off = align128((size_t)TILE_M * s.lda * 2);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)KCHUNK * s.ldb * 2);
  float* scr = reinterpret_cast<float*>(smem + off) + (threadIdx.x >> 5) * 256;
  off += align128((size_t)WARPS * 256 * 4);
  float* DIN = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)TILE_M * s.pe_pad * 4);
  float* XEB = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)TILE_M * s.pe_pad * 4);
  float* DBACC = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)a.n_bias * 4);
  float* CBACC = reinterpret_cast<float*>(smem + off);

  const int last = s.n_lin - 1;
  const int ncb = s.L[last - 1].np;
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS) DBACC[i] = 0.f;
  for (int i = threadIdx.x; i < ncb; i += THREADS) CBACC[i] = 0.f;

  const int n_tiles = s.M_pad / TILE_M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    __syncthreads();  // DIN, XEB free
    sdf_pe_stage(s, row0, DIN, XEB, a.ct_grad, a.FB[0], a.FB[s.skip]);
    for (int l = 0; l < last; ++l) sdf_forward_layer(s, l, row0, Asm, wbuf, scr);
    for (int l = last - 1; l >= 0; --l)
      sdf_reverse_layer(s, l, row0, Asm, wbuf, scr, DIN);

    // Phase A: ascending l
    for (int l = 0; l < last; ++l) {
      const Layer& Ly = s.L[l];
      __syncthreads();
      load_tile(Asm, s.lda, a.FB[l] + (size_t)row0 * Ly.kp, Ly.kp, Ly.in_w, Ly.kp);
      const bool last_a = l == last - 1;
      const bool skip_next = l + 1 == s.skip;
      const int kp_next = s.L[l + 1].kp;
      const float* sig = s.SIG[l];
      const float* dsn = last_a ? nullptr : s.DS[l + 1];
      float* zc = a.ZC[l];
      bf16* fbn = last_a ? nullptr : a.FB[l + 1];
      tile_gemm(Asm, s.lda, s.w + Ly.w_off, Ly.kp, Ly.np, wbuf, s.ldb, scr,
                last_a ? CBACC : nullptr, Ly.np,
                [&](int r, int n, float v) -> float {
                  const int gr = row0 + r;
                  const size_t idx = (size_t)gr * Ly.np + n;
                  const float sp = sig[idx];
                  const float dn = last_a ? s.wlast[n] : dsn[idx];
                  const float dbar = v * sp;
                  zc[idx] = v * dn * (100.f * sp * (1.f - sp));
                  if (!last_a)
                    fbn[(size_t)gr * kp_next + n] =
                        __float2bfloat16(skip_next ? dbar * INV_SQRT2 : dbar);
                  return (last_a && gr < s.M) ? dbar : 0.f;
                });
    }

    // Phase B: zbar_{L-1} = ybar, and its column sums (one thread a column)
    {
      const Layer& Ly = s.L[last];
      __syncthreads();
      for (int i = threadIdx.x; i < TILE_M * Ly.np; i += THREADS) {
        const int r = i / Ly.np, n = i % Ly.np;
        const int gr = row0 + r;
        float y = 0.f;
        if (gr < s.M && n < a.n_out) {
          y = a.ct_out[(size_t)gr * a.n_out + n];
          if (n == 0) y = (y + a.ct_sdf[gr]) / s.scale;
        }
        a.ZB[last][(size_t)gr * Ly.np + n] = __float2bfloat16(y);
      }
      for (int n = threadIdx.x; n < Ly.np; n += THREADS) {
        float sum = 0.f;
        for (int r = 0; r < TILE_M; ++r) {
          const int gr = row0 + r;
          if (gr < s.M && n < a.n_out) {
            float y = a.ct_out[(size_t)gr * a.n_out + n];
            if (n == 0) y = (y + a.ct_sdf[gr]) / s.scale;
            sum += y;
          }
        }
        DBACC[Ly.b_off + n] += sum;
      }
    }
    for (int l = last; l >= 0; --l) {
      const Layer& Ly = s.L[l];
      __syncthreads();  // ZB_l complete, Asm free
      load_tile(Asm, s.lda, a.ZB[l] + (size_t)row0 * Ly.np, Ly.np, Ly.np, Ly.kr);
      const bool at_skip = l == s.skip;
      const int h_w = at_skip ? s.hoff : (l == 0 ? 0 : Ly.in_w);
      const int pe_off = at_skip ? s.hoff : 0;
      const bool has_pe = at_skip || l == 0;
      const float c2 = at_skip ? INV_SQRT2 : 1.f;
      const int np_prev = l > 0 ? s.L[l - 1].np : 0;
      const float* sig = l > 0 ? s.SIG[l - 1] : nullptr;
      const float* zc = l > 0 ? a.ZC[l - 1] : nullptr;
      bf16* zbp = l > 0 ? a.ZB[l - 1] : nullptr;
      float* cs = l > 0 ? DBACC + s.L[l - 1].b_off : nullptr;
      tile_gemm(Asm, s.lda, s.w + Ly.r_off, Ly.kr, Ly.kp, wbuf, s.ldb, scr, cs,
                h_w, [&](int r, int n, float v) -> float {
                  const int gr = row0 + r;
                  if (n < h_w) {
                    const size_t idx = (size_t)gr * np_prev + n;
                    const float zb = v * c2 * sig[idx] + zc[idx];
                    zbp[idx] = __float2bfloat16(zb);
                    return gr < s.M ? zb : 0.f;
                  }
                  if (has_pe) {
                    const int c = n - pe_off;
                    if (c < s.pe_pad) XEB[r * s.pe_pad + c] += v * c2;
                  }
                  return 0.f;
                });
    }

    // xbar = scale * sum_c (XEB PE' + ct_grad DIN PE'') over dim d's columns
    __syncthreads();
    for (int i = threadIdx.x; i < TILE_M * 3; i += THREADS) {
      const int r = i / 3, d = i % 3;
      const int gr = row0 + r;
      if (gr >= s.M) continue;
      const float xs = s.x[(size_t)gr * 3 + d] * s.scale;
      const float ctg = a.ct_grad[(size_t)gr * 3 + d];
      float g = 0.f;
      for (int c = 0; c < s.pe_dim; ++c) {
        int dc, kind;
        float f, v, j, j2;
        pe_col(c, dc, kind, f);
        if (dc != d) continue;
        pe_eval(kind, f, xs, v, j, j2);
        g += XEB[r * s.pe_pad + c] * j + ctg * DIN[r * s.pe_pad + c] * j2;
      }
      a.xbar[(size_t)gr * 3 + d] = g * s.scale;
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < a.n_bias; i += THREADS)
    a.dbpart[(size_t)blockIdx.x * a.n_bias + i] = DBACC[i];
  for (int i = threadIdx.x; i < ncb; i += THREADS)
    a.cbpart[(size_t)blockIdx.x * ncb + i] = CBACC[i];
}

}  // namespace
}  // namespace fmov_train

using namespace fmov_train;

extern "C" {

// ptrs: AB_0..AB_{L-1} ([FB_l; X_l], 2 M_pad rows of kp(l)), BB_0..BB_{L-1}
// ([D_l; ZB_l], 2 M_pad rows of np(l)), SIG_0..SIG_{L-2}, DS_1..DS_{L-2},
// ZC_0..ZC_{L-2}, DBPART [G x n_bias], CBPART [G x np(L-2)], DWPART
// [KS x sum in_w np] (fused_sdf.py launch_bwd).  dw: the padded per-layer
// [in_w x np] blocks, concatenated; db: the padded biases.  Returns a
// cudaError_t (0 = launched).
int fmov_sdf_bwd(const float* x, const float* ct_out, const float* ct_sdf,
                 const float* ct_grad, int M, int M_pad, int n_out, float scale,
                 const void* w, const float* bias, const float* wlast,
                 const int* meta, int n_lin, int skip, int multires,
                 const unsigned long long* ptrs, int G, int KS, float* xbar,
                 float* dw, float* db, void* stream) {
  BwdArgs a;
  SdfArgs& s = a.s;
  int max_k, max_n, n_bias;
  int e = sdf_setup(s, meta, n_lin, skip, multires, M, M_pad, scale, &max_k,
                    &max_n, &n_bias);
  if (e) return e;
  if (n_out != s.L[n_lin - 1].n || G < 1 || KS < 1) return (int)cudaErrorInvalidValue;
  s.x = x;
  s.w = static_cast<const bf16*>(w);
  s.bias = bias;
  s.wlast = wlast;
  for (int l = 0; l < MAX_LIN; ++l) {
    s.X[l] = s.D[l] = a.FB[l] = a.ZB[l] = nullptr;
    s.SIG[l] = s.DS[l] = a.ZC[l] = nullptr;
  }
  int p = 0;
  for (int l = 0; l < n_lin; ++l) {
    bf16* ab = reinterpret_cast<bf16*>(ptrs[p++]);
    a.FB[l] = ab;
    s.X[l] = ab + (size_t)M_pad * s.L[l].kp;
  }
  for (int l = 0; l < n_lin; ++l) {
    bf16* bb = reinterpret_cast<bf16*>(ptrs[p++]);
    s.D[l] = bb;
    a.ZB[l] = bb + (size_t)M_pad * s.L[l].np;
  }
  for (int l = 0; l < n_lin - 1; ++l) s.SIG[l] = reinterpret_cast<float*>(ptrs[p++]);
  for (int l = 1; l < n_lin - 1; ++l) s.DS[l] = reinterpret_cast<float*>(ptrs[p++]);
  for (int l = 0; l < n_lin - 1; ++l) a.ZC[l] = reinterpret_cast<float*>(ptrs[p++]);
  a.dbpart = reinterpret_cast<float*>(ptrs[p++]);
  a.cbpart = reinterpret_cast<float*>(ptrs[p++]);
  float* dwpart = reinterpret_cast<float*>(ptrs[p++]);
  a.ct_out = ct_out;
  a.ct_sdf = ct_sdf;
  a.ct_grad = ct_grad;
  a.xbar = xbar;
  a.n_out = n_out;
  a.n_bias = n_bias;

  const int ncb = s.L[n_lin - 2].np;
  const size_t pe_bytes = align128((size_t)TILE_M * s.pe_pad * 4);
  const size_t smem = sdf_smem(s, 2 * pe_bytes + align128((size_t)n_bias * 4) +
                                      align128((size_t)ncb * 4));
  cudaError_t ce = cudaFuncSetAttribute(
      sdf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  if (M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  sdf_bwd_kernel<<<G, THREADS, smem, st>>>(a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;

  AtbArgs t;
  t.n_jobs = n_lin;
  t.KS = KS;
  int total = 0;
  for (int l = 0; l < n_lin; ++l) {
    AtbJob& J = t.job[l];
    const Layer& L = s.L[l];
    const bool only_b = l == n_lin - 1;  // no Phase A product
    J.a = only_b ? s.X[l] : a.FB[l];
    J.b = only_b ? a.ZB[l] : s.D[l];
    J.rows = only_b ? M_pad : 2 * M_pad;
    J.lda = L.kp;
    J.ldb = L.np;
    J.ni = L.in_w;
    J.nj = L.np;
    J.out = dwpart + total;
    total += L.in_w * L.np;
  }
  const int cb_off = total - s.L[n_lin - 1].in_w * s.L[n_lin - 1].np;
  return weight_grads(t, dwpart, total, dw, a.dbpart, G, n_bias, db, a.cbpart,
                      ncb, cb_off, s.L[n_lin - 1].np, st);
}

}  // extern "C"
