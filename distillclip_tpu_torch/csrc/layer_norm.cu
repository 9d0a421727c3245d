// K4 and its backward: row LayerNorm, bf16 in and out with fp32 math.
//
// Forward replaces distillclip_tpu/ops/layer_norm.py:_ln_fwd_kernel (the
// Pallas forward behind layer_norm_rows); backward replaces :_ln_bwd_kernel.
// On the serving and training paths they normalise the pooled [B, C] rows of
// the students' final `norm`.
//
// Forward:   y = (x - mean) · rstd · γ + β, and (for the backward) mean and
//            rstd as fp32 [rows] when the caller passes buffers for them.
// Backward:  x̂ = (x - mean) · rstd,  gs = g · γ,
//            dx = rstd · (gs - mean_c(gs) - x̂ · mean_c(gs · x̂)),
//            dγ = Σ_rows g · x̂,  dβ = Σ_rows g        (fp32 [C])
//
// Bound on the H100: bytes.  Each row is read from device memory once and
// written once (C = 768 bf16 values, 1.5 KB); the arithmetic is a few
// operations per value.  Forward design: one warp per row, 16-byte loads, warp
// shuffles for the two reductions and no shared memory.  The second and
// third passes over the row re-read it from L1, where the first pass left it.
//
// Backward design: a block owns 32 rows.  Phase A is row-wise (a warp per row
// reduces the two row moments into shared memory); phase B is column-wise (a
// thread per pair of columns walks the block's rows, writes dx and keeps its
// columns' dγ/dβ sums in registers), so nothing is summed with atomics.  The
// TPU kernel carries dγ/dβ from one grid step to the next; here each block
// writes an fp32 partial and reduce_partials adds them in a fixed order.
#include "common.cuh"

namespace dc {

constexpr int kLnThreads = 256;
constexpr int kLnRowsPerBlock = kLnThreads / 32;
constexpr int kLnBwdRows = 32;

__global__ void __launch_bounds__(kLnThreads)
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, bf16* __restrict__ y,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
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
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

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

// partial: [blocks, 2·C] fp32, dγ then dβ of the block's rows.
__global__ void __launch_bounds__(kLnThreads)
layer_norm_rows_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                           const bf16* __restrict__ g, const float* __restrict__ mean,
                           const float* __restrict__ rstd, bf16* __restrict__ dx,
                           float* __restrict__ partial, int rows, int C) {
  __shared__ float s_mean[kLnBwdRows], s_rstd[kLnBwdRows], s_m1[kLnBwdRows], s_m2[kLnBwdRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kLnBwdRows;
  const int nrows = min(kLnBwdRows, rows - row0);
  const float inv_c = 1.0f / (float)C;

  // phase A: the two moments of each row
  for (int r = warp; r < nrows; r += kLnThreads / 32) {
    const bf16* xr = x + (size_t)(row0 + r) * C;
    const bf16* gr = g + (size_t)(row0 + r) * C;
    const float mu = mean[row0 + r], rs = rstd[row0 + r];
    float a1 = 0.f, a2 = 0.f;
    for (int c = lane * 8; c < C; c += 32 * 8) {
      float xf[8], gf[8], sf[8];
      load8(xr + c, xf);
      load8(gr + c, gf);
      load8(gamma + c, sf);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float gs = gf[t] * sf[t];
        a1 += gs;
        a2 += gs * (xf[t] - mu) * rs;
      }
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s_mean[r] = mu;
      s_rstd[r] = rs;
      s_m1[r] = a1 * inv_c;
      s_m2[r] = a2 * inv_c;
    }
  }
  __syncthreads();

  // phase B: a pair of columns per thread, down the block's rows
  float* part = partial + (size_t)blockIdx.x * 2 * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kLnThreads) {
    const float s0 = __bfloat162float(gamma[c]), s1 = __bfloat162float(gamma[c + 1]);
    float dg0 = 0.f, dg1 = 0.f, db0 = 0.f, db1 = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const size_t off = (size_t)(row0 + r) * C + c;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
      const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(g + off);
      const float g0 = __low2float(gv), g1 = __high2float(gv);
      const float h0 = (__low2float(xv) - s_mean[r]) * s_rstd[r];
      const float h1 = (__high2float(xv) - s_mean[r]) * s_rstd[r];
      const float d0 = s_rstd[r] * (g0 * s0 - s_m1[r] - h0 * s_m2[r]);
      const float d1 = s_rstd[r] * (g1 * s1 - s_m1[r] - h1 * s_m2[r]);
      *reinterpret_cast<__nv_bfloat162*>(dx + off) = __floats2bfloat162_rn(d0, d1);
      dg0 += g0 * h0;
      dg1 += g1 * h1;
      db0 += g0;
      db1 += g1;
    }
    part[c] = dg0;
    part[c + 1] = dg1;
    part[C + c] = db0;
    part[C + c + 1] = db1;
  }
}

__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int nparts, int width) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partials[(size_t)p * width + j];
  out[j] = s;
}

int reduce_partials(const float* partials, float* out, int nparts, int width,
                    cudaStream_t stream) {
  const int threads = 128;
  reduce_partials_kernel<<<(width + threads - 1) / threads, threads, 0, stream>>>(
      partials, out, nparts, width);
  return (int)cudaGetLastError();
}

}  // namespace dc

// x, y: [rows, C] bf16; gamma, beta: [C] bf16; mean, rstd: [rows] fp32, both
// NULL for the lean forward; C % 8 == 0 (checked by the Python wrapper, which
// also checks contiguity and devices).
DC_EXPORT int dc_layer_norm_rows(const void* x, const void* gamma, const void* beta,
                                 void* y, void* mean, void* rstd, int rows, int C,
                                 float eps, void* stream) {
  const int blocks = (rows + dc::kLnRowsPerBlock - 1) / dc::kLnRowsPerBlock;
  dc::layer_norm_rows_kernel<<<blocks, dc::kLnThreads, 0, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)beta, (dc::bf16*)y,
      (float*)mean, (float*)rstd, rows, C, eps);
  return (int)cudaGetLastError();
}

DC_EXPORT int dc_layer_norm_rows_bwd_blocks(int rows) {
  return (rows + dc::kLnBwdRows - 1) / dc::kLnBwdRows;
}

// x, g, dx: [rows, C] bf16; gamma: [C] bf16; mean, rstd: [rows] fp32;
// partial: [dc_layer_norm_rows_bwd_blocks(rows), 2·C] fp32 scratch;
// dgamma_dbeta: [2·C] fp32 (dγ then dβ).  C % 8 == 0.
DC_EXPORT int dc_layer_norm_rows_bwd(const void* x, const void* gamma, const void* g,
                                     const void* mean, const void* rstd, void* dx,
                                     void* partial, void* dgamma_dbeta, int rows, int C,
                                     void* stream) {
  const int blocks = dc_layer_norm_rows_bwd_blocks(rows);
  dc::layer_norm_rows_bwd_kernel<<<blocks, dc::kLnThreads, 0, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)g, (const float*)mean,
      (const float*)rstd, (dc::bf16*)dx, (float*)partial, rows, C);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return dc::reduce_partials((const float*)partial, (float*)dgamma_dbeta, blocks, 2 * C,
                             (cudaStream_t)stream);
}

DC_EXPORT const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
