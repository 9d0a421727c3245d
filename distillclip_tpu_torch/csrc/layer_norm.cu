// K4: row LayerNorm, forward only, bf16 in and out with fp32 math.
//
// Replaces distillclip_tpu/ops/layer_norm.py:_ln_fwd_kernel (the Pallas
// forward behind layer_norm_rows).  On the serving path it normalises the
// pooled [B, C] rows of the students' final `norm`.
//
// Bound on the H100: bytes.  Each row is read from device memory once and
// written once (C = 768 bf16 values, 1.5 KB); the arithmetic is a few
// operations per value.  Design: one warp per row, 16-byte loads, warp
// shuffles for the two reductions and no shared memory.  The second and
// third passes over the row re-read it from L1, where the first pass left it.
// The mean and rstd that the TPU kernel also writes feed only its backward,
// which the port has not ported yet, so they are not written.
#include "common.cuh"

namespace dc {

constexpr int kLnThreads = 256;
constexpr int kLnRowsPerBlock = kLnThreads / 32;

__global__ void __launch_bounds__(kLnThreads)
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, bf16* __restrict__ y,
                       int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * C;
  bf16* yr = y + (size_t)row * C;
  const float inv_c = 1.0f / (float)C;

  float s = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += f[t];
  }
  const float mean = warp_sum(s) * inv_c;

  float v = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = f[t] - mean;
      v += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(v) * inv_c + eps);

  for (int c = lane * 8; c < C; c += 32 * 8) {
    float f[8], g[8], b[8];
    load8(xr + c, f);
    load8(gamma + c, g);
    load8(beta + c, b);
#pragma unroll
    for (int t = 0; t < 8; ++t) f[t] = (f[t] - mean) * rstd * g[t] + b[t];
    store8(yr + c, f);
  }
}

}  // namespace dc

// x, y: [rows, C] bf16; gamma, beta: [C] bf16; C % 8 == 0 (checked by the
// Python wrapper, which also checks contiguity and devices).
DC_EXPORT int dc_layer_norm_rows(const void* x, const void* gamma, const void* beta,
                                 void* y, int rows, int C, float eps, void* stream) {
  const int blocks = (rows + dc::kLnRowsPerBlock - 1) / dc::kLnRowsPerBlock;
  dc::layer_norm_rows_kernel<<<blocks, dc::kLnThreads, 0, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)beta, (dc::bf16*)y,
      rows, C, eps);
  return (int)cudaGetLastError();
}

DC_EXPORT const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
