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

// The GEMM epilogues' activations on the fp32 sum u: act 1 exact GELU, 2
// QuickGELU, 0 none; act_e the transcendental value e that a residual mode
// saves beside u (erf(u/√2), sigmoid(1.702 u)).
template <int ACT>
__device__ __forceinline__ float activate(float u) {
  if (ACT == 1) return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
  if (ACT == 2) return u / (1.0f + expf(-1.702f * u));
  return u;
}

template <int ACT>
__device__ __forceinline__ float act_e(float u) {
  if (ACT == 1) return erff(u * 0.70710678118654752f);
  return 1.0f / (1.0f + expf(-1.702f * u));
}

// out[j] = Σ_p partials[p·width + j] in a fixed order: the second pass of #9's
// reduction across blocks (dγ/dβ) and of #6's (dconv_l / dconv_w), so that the
// sums do not depend on the order in which blocks finish.  Defined in
// layer_norm.cu.
int reduce_partials(const float* partials, float* out, int nparts, int width,
                    cudaStream_t stream);

// K1's first launch (defined in layer_norm.cu): the rows' LayerNorm mean and
// rstd (fp32 [rows]) of x [rows, C] bf16, and w16 = fp16(w), w bf16 of
// w_elems elements (a multiple of 8), for the product of dense_ln_wgmma.cu.
int ln_stats_w16(const void* x, float* mean, float* rstd, int rows, int C, float eps,
                 const void* w, void* w16, long long w_elems, cudaStream_t stream);

}  // namespace dc

DC_EXPORT const char* dc_error_string(int err);
