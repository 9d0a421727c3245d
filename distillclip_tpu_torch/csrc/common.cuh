// Helpers shared by the port's Hopper kernels (built for sm_90a by
// distillclip_tpu_torch/ops/_build.py and bound with ctypes).
//
// Every exported entry point has a plain C interface: raw device pointers,
// ints, floats and the CUDA stream, and it returns cudaGetLastError() right
// after the launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DC_EXPORT extern "C" __attribute__((visibility("default")))

namespace dc {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 values moved as one 16-byte word.
__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) f[t] = __bfloat162float(h[t]);
}

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  __align__(16) bf16 h[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) h[t] = __float2bfloat16(f[t]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// 8 values stored as fp16 (round to nearest) in one 16-byte word.
__device__ __forceinline__ void store8(f16* p, const float (&f)[8]) {
  __align__(16) f16 h[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) h[t] = __float2half_rn(f[t]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// erfc(|u|/√2) = 2^P(|u|), for the exact GELU: P(s) = s·Q(s), Q of degree
// 4, the minimax fit of log2 erfc(s/√2) on s in [0, 5.5] weighted by erfc
// (past 5.5, erfc is below 4e-8).  One exponential (ex2.approx) and five
// FMAs, no branch: erf = 1 - erfc is within 1e-6 of the truth, far under the
// 2^-9 of the bf16 store, and cheaper than erff, which evaluates a
// polynomial for each of two ranges of |u|
// (tests/test_torch_dense_act_ln_rounding.py reads these constants).
__device__ __forceinline__ float erfc_abs_div_sqrt2(float u) {
  const float s = fminf(fabsf(u), 5.5f);
  float q = -5.201651365e-04f;
  q = fmaf(q, s, 7.395406254e-03f);
  q = fmaf(q, s, -5.255695060e-02f);
  q = fmaf(q, s, -4.592579007e-01f);
  q = fmaf(q, s, -1.151090384e+00f);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q * s));
  return r;
}

// The activations of the GEMM epilogues on the fp32 sum u: h, and the
// transcendental value e that a residual mode saves beside u (WANT_E).
// act 1, exact GELU: e = erf(u/√2) = sign(u)·(1 - r) with r = erfc(|u|/√2),
// and h = 0.5 u (1 + e) = max(u, 0) - 0.5 |u| r.  act 2, QuickGELU: e =
// σ(1.702 u), h = u e; σ takes the fast exponential and reciprocal, whose
// relative error, mostly the rounding of the exponent's argument (about
// 1.702 |u|·2^-24), is below 2^-17 for |u| < 50.  h comes out of the same
// operations in both modes, so the lean and the residual h agree.
template <int ACT, bool WANT_E>
__device__ __forceinline__ float activate(float u, float& e) {
  if (ACT == 1) {
    const float r = erfc_abs_div_sqrt2(u);
    if (WANT_E) e = copysignf(1.0f - r, u);
    return fmaf(-0.5f * fabsf(u), r, fmaxf(u, 0.0f));
  }
  e = __fdividef(1.0f, 1.0f + __expf(-1.702f * u));
  return u * e;
}

// out[j] = Σ_p partials[p·width + j] in a fixed order: the second pass of #9's
// reduction across blocks (dγ/dβ) and of #6's (dconv_l / dconv_w), so that the
// sums do not depend on the order in which blocks finish.  Defined in
// layer_norm.cu.
int reduce_partials(const float* partials, float* out, int nparts, int width,
                    cudaStream_t stream);

// The LN GEMMs' first launch (defined in layer_norm.cu): the rows' LayerNorm
// mean and rstd (fp32 [rows]) of x [rows, C] bf16, and w16 = fp16(w), w bf16
// of w_elems elements (a multiple of 8), for the product of dense_ln_wgmma.cu.
int ln_stats_w16(const void* x, float* mean, float* rstd, int rows, int C, float eps,
                 const void* w, void* w16, long long w_elems, cudaStream_t stream);

// The same over the first `width` of each row's C columns (the rest padding):
// the statistics launch of EVA-02's modes (width = C for the rotary and SwiGLU
// ones).
int ln_stats_width_w16(const void* x, float* mean, float* rstd, int rows, int C, int width,
                       float eps, const void* w, void* w16, long long w_elems,
                       cudaStream_t stream);

}  // namespace dc

DC_EXPORT const char* dc_error_string(int err);
