// The backward of the LayerNorm-prologue GEMMs (K1 and K2's residual mode).
//
// Replaces distillclip_tpu/ops/fc1_act.py:_dln_bwd_kernel.  From du (the
// gradient of u = (LN(x)·γ + β) · W + b) it makes, in one pass,
//
//   dxn = du · Wᵀ                           [rows, C] fp32, never in device memory
//   x̂   = (x - mean) · rstd                 (mean, rstd saved by the forward)
//   xn  = x̂ · γ + β                         bf16 out, the operand of dW = xnᵀ · du
//   dγ  = Σ_rows dxn · x̂,   dβ = Σ_rows dxn  fp32 [C]
//   dx̂  = dxn · γ
//   dx  = rstd · (dx̂ - mean_c(dx̂) - x̂ · mean_c(dx̂ · x̂))        bf16 out
//
// dW, db and the GELU derivative stay outside, as in the JAX package.
//
// Layouts: x, dx, xn [rows, C]; W [C, N] row-major; du [rows, N]; γ, β [C];
// all bf16.  mean, rstd [rows] fp32.  W needs no transpose: for the product
// du · Wᵀ the contraction runs over N, along which a row of W is contiguous,
// so W as stored is the column-major B operand with leading dimension N.
//
// Precision: the tensor-core operands are bf16 (du has no bound on its range,
// unlike the LN output that the forward kernels feed as fp16); sums are fp32.
//
// Bound on the H100: operations (2·rows·C·N flops against ~2·rows·(2C+N) bytes
// for x, du, dx, xn).  Design: the two row moments need all C columns of a
// row, so a block owns BM = 32 whole rows and keeps their dxn in shared
// memory as fp32 (32 × 768 × 4 = 96 KB; 64 rows would not fit beside the
// operand slices).  It walks the C columns in tiles of BN = 256 and, for each,
// the N contraction in slices of BK = 64: the du slice [32, 64] and the W
// slice [256, 64] go through registers into one of two shared buffers while
// the tensor cores run bf16 WMMA (mma.sync, fp32 accumulators) on the other,
// one barrier per slice, as in dense_ln.cu.  Each of the 8 warps owns a
// 32 × 32 piece of the tile.  The epilogue is row-wise for dx and xn (a warp
// per row, two warp reductions) and column-wise for the block's dγ/dβ partial
// (a thread per column down the 32 rows), which reduce_partials then adds over
// the blocks in a fixed order; the TPU kernel carries these sums across its
// sequential grid instead.  With 32-row tiles every block re-reads all of W
// from L2; wgmma with larger tiles and TMA loads are later work.
#include <mma.h>

#include "common.cuh"

namespace dc {

namespace {

constexpr int BM = 32, BN = 256, BK = 64;
constexpr int kThreads = 256;
constexpr int kLds = BK + 8;   // operand slice row stride, bf16 elements
constexpr int kDpad = 4;       // fp32 elements of dxn row padding
constexpr int kBWords = BN * BK / 8 / kThreads;  // 16-byte words of a W slice per thread

__host__ __device__ inline size_t bwd_smem_bytes(int C) {
  return (size_t)BM * (C + kDpad) * sizeof(float)        // dxn
         + (size_t)2 * BM * kLds * sizeof(bf16)          // two du slices
         + (size_t)2 * BN * kLds * sizeof(bf16);         // two W slices
}

// du[row0.., k0..k0+BK) : one 16-byte word per thread; zero past rows or N.
__device__ __forceinline__ uint4 load_a_slice(const bf16* __restrict__ du, int rows, int N,
                                              int row0, int k0) {
  const int r = threadIdx.x / (BK / 8);
  const int k = k0 + (threadIdx.x % (BK / 8)) * 8;
  return (row0 + r < rows && k < N)
             ? *reinterpret_cast<const uint4*>(du + (size_t)(row0 + r) * N + k)
             : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void store_a_slice(bf16* As, const uint4& reg) {
  const int r = threadIdx.x / (BK / 8);
  const int k = (threadIdx.x % (BK / 8)) * 8;
  *reinterpret_cast<uint4*>(As + r * kLds + k) = reg;
}

// W[c0..c0+BN, k0..k0+BK): 8 words per thread; zero past row C or column N.
__device__ __forceinline__ void load_b_slice(const bf16* __restrict__ w, int C, int N, int c0,
                                             int k0, uint4 (&reg)[kBWords]) {
#pragma unroll
  for (int t = 0; t < kBWords; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    const int c = c0 + idx / (BK / 8);
    const int k = k0 + (idx % (BK / 8)) * 8;
    reg[t] = (c < C && k < N) ? *reinterpret_cast<const uint4*>(w + (size_t)c * N + k)
                              : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_b_slice(bf16* Bs, const uint4 (&reg)[kBWords]) {
#pragma unroll
  for (int t = 0; t < kBWords; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    *reinterpret_cast<uint4*>(Bs + (idx / (BK / 8)) * kLds + (idx % (BK / 8)) * 8) = reg[t];
  }
}

// 8 fp32 values from 16-byte aligned shared memory as two 16-byte words.
__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads)
dense_ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta, const bf16* __restrict__ w,
                    const bf16* __restrict__ du, const float* __restrict__ mean,
                    const float* __restrict__ rstd, bf16* __restrict__ dx,
                    bf16* __restrict__ xn, float* __restrict__ partial,
                    int rows, int C, int N) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mean[BM], s_rstd[BM];
  const int ldd = C + kDpad;
  float* Dx = reinterpret_cast<float*>(smem);                       // [BM, ldd]
  bf16* As = reinterpret_cast<bf16*>(Dx + (size_t)BM * ldd);        // two [BM, kLds]
  bf16* Bs = As + 2 * BM * kLds;                                    // two [BN, kLds]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;
  const int nrows = min(BM, rows - row0);
  if (threadIdx.x < BM) {
    const bool ok = threadIdx.x < nrows;
    s_mean[threadIdx.x] = ok ? mean[row0 + threadIdx.x] : 0.f;
    s_rstd[threadIdx.x] = ok ? rstd[row0 + threadIdx.x] : 0.f;
  }

  // ---- dxn = du · Wᵀ, one BN-column tile of it at a time into Dx.
  const int nk = (N + BK - 1) / BK;
  uint4 a_pre, b_pre[kBWords];
  for (int c0 = 0; c0 < C; c0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    a_pre = load_a_slice(du, rows, N, row0, 0);
    load_b_slice(w, C, N, c0, 0, b_pre);
    store_a_slice(As, a_pre);
    store_b_slice(Bs, b_pre);
    __syncthreads();
    for (int ks = 0; ks < nk; ++ks) {
      if (ks + 1 < nk) {
        a_pre = load_a_slice(du, rows, N, row0, (ks + 1) * BK);
        load_b_slice(w, C, N, c0, (ks + 1) * BK, b_pre);
      }
      const bf16* A = As + (ks & 1) * BM * kLds;
      const bf16* B = Bs + (ks & 1) * BN * kLds + warp * 32 * kLds;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], A + i * 16 * kLds + kk, kLds);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], B + j * 16 * kLds + kk, kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      if (ks + 1 < nk) {
        store_a_slice(As + ((ks + 1) & 1) * BM * kLds, a_pre);
        store_b_slice(Bs + ((ks + 1) & 1) * BN * kLds, b_pre);
      }
      __syncthreads();
    }
    // C % 32 == 0, so a warp's 32-column strip is wholly inside or outside.
    if (c0 + warp * 32 < C) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Dx + (size_t)(i * 16) * ldd + c0 + warp * 32 + j * 16,
                                  acc[i][j], ldd, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- rows: xn, the two moments of dx̂, dx.  Warp w takes rows w, w+8, ...
  const float inv_c = 1.0f / (float)C;
  for (int r = warp; r < nrows; r += kThreads / 32) {
    const size_t off = (size_t)(row0 + r) * C;
    const float* dr = Dx + (size_t)r * ldd;
    const float mu = s_mean[r], rs = s_rstd[r];
    float a1 = 0.f, a2 = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float xf[8], gm[8], bt[8], o[8], d[8];
      load8(x + off + c, xf);
      load8(gamma + c, gm);
      load8(beta + c, bt);
      load8f(dr + c, d);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xh = (xf[t] - mu) * rs;
        const float dxh = d[t] * gm[t];
        o[t] = xh * gm[t] + bt[t];
        a1 += dxh;
        a2 += dxh * xh;
      }
      store8(xn + off + c, o);
    }
    const float m1 = warp_sum(a1) * inv_c;
    const float m2 = warp_sum(a2) * inv_c;
    for (int c = lane * 8; c < C; c += 256) {
      float xf[8], gm[8], o[8], d[8];
      load8(x + off + c, xf);
      load8(gamma + c, gm);
      load8f(dr + c, d);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xh = (xf[t] - mu) * rs;
        o[t] = rs * (d[t] * gm[t] - m1 - xh * m2);
      }
      store8(dx + off + c, o);
    }
  }

  // ---- columns: the block's dγ and dβ, a thread per column down the rows.
  float* part = partial + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float xh = (__bfloat162float(x[(size_t)(row0 + r) * C + c]) - s_mean[r]) * s_rstd[r];
      const float d = Dx[(size_t)r * ldd + c];
      dg += d * xh;
      db += d;
    }
    part[c] = dg;
    part[C + c] = db;
  }
}

}  // namespace

}  // namespace dc

DC_EXPORT long long dc_dense_ln_bwd_smem_bytes(int C) {
  return (long long)dc::bwd_smem_bytes(C);
}

DC_EXPORT int dc_dense_ln_bwd_blocks(int rows) { return (rows + dc::BM - 1) / dc::BM; }

// x, dx, xn: [rows, C]; w: [C, N]; du: [rows, N]; gamma, beta: [C]; all bf16.
// mean, rstd: [rows] fp32.  partial: [dc_dense_ln_bwd_blocks(rows), 2·C] fp32
// scratch; dgamma_dbeta: [2·C] fp32 (dγ then dβ).  Requires C % 32 == 0,
// N % 8 == 0 and dc_dense_ln_bwd_smem_bytes(C) within the block limit.
DC_EXPORT int dc_dense_ln_bwd(const void* x, const void* gamma, const void* beta,
                              const void* w, const void* du, const void* mean,
                              const void* rstd, void* dx, void* xn, void* partial,
                              void* dgamma_dbeta, int rows, int C, int N, void* stream) {
  const size_t smem = dc::bwd_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(dc::dense_ln_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = dc_dense_ln_bwd_blocks(rows);
  dc::dense_ln_bwd_kernel<<<blocks, dc::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)beta, (const dc::bf16*)w,
      (const dc::bf16*)du, (const float*)mean, (const float*)rstd, (dc::bf16*)dx,
      (dc::bf16*)xn, (float*)partial, rows, C, N);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return dc::reduce_partials((const float*)partial, (float*)dgamma_dbeta, blocks, 2 * C,
                             (cudaStream_t)stream);
}
