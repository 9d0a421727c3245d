// K2 and K2's residual mode (#8): LayerNorm-prologue GEMMs with an activation
// (forward).  K1 (no activation) runs dense_ln_wgmma.cu.
//
//   K2 (act = 1):  h = GELU_exact((LN(x)·γ + β) · W + b)
//      (act = 2):  h = QuickGELU(...) = u · sigmoid(1.702 u)
//   residual mode of K2 (training): the same main loop, and the epilogue
//      writes u and e = erf(u/√2) (act 1) or sigmoid(1.702 u) (act 2) beside
//      h, all from the one fp32 sum, for the backward.
//   Every mode also writes the rows' LN mean and rstd (fp32 [rows]) when the
//   caller passes buffers for them; the backward kernel reads them.
//   The same GEMM without the LayerNorm (#10-#12) is dense_act.cu.
//
// Replaces distillclip_tpu/ops/fc1_act.py:_fc1_ln_h_kernel (K2, the lean
// no-grad norm2 + fc1 + GELU that writes h only) and :_fc1_ln_kernel (the
// residual mode; there h = recombine(u, e) is left to XLA, here the kernel
// writes it from the fp32 sum, bit-identical to K2's h).
//
// Layouts: x [rows, C], W [C, N] row-major (the Flax Dense layout, kept by
// the port's converter), γ, β [C], b [N], out [rows, N]; all bf16.
// The LN runs in fp32; the product accumulates in fp32, and the bias and
// activation are applied to the fp32 sum before the single bf16 rounding.
//
// Precision: the tensor-core operands are fp16, not bf16.  The TPU kernel
// rounds LN(x) to bf16 before its product; on the serving shapes that
// rounding alone costs as much error as the final bf16 store (mean ~5e-4 on
// outputs of std ~0.55), and the two together exceed a 1e-3 mean error
// against fp32.  fp16 keeps 3 more mantissa bits at the same tensor-core
// rate: every bf16 weight with |w| in [2^-14, 65504] converts to fp16
// exactly (smaller ones lose < 2^-25 each), and LN(x)·γ+β is bounded by
// sqrt(C)·|γ|+|β|, far inside fp16's range for any trained LayerNorm.
//
// Bound on the H100: at the serving shapes (rows = B·50 or B·77, C = 768,
// N = 2304 or 3072) the product is ~2·rows·C·N flops against ~2·rows·(C+N)
// bytes of activations, far above the card's ~295 flop/byte balance, so the
// tensor cores bound it once W reaches them fast enough.  Design: a block owns
// BM = 64 rows for the whole kernel.  It normalises them once into shared
// memory (64 × 768 fp16 = 96 KB), so the LN costs one read of x and no round
// trip through device memory, then walks every BN = 256-column tile of W in
// BK = 64-row slices.  A slice is converted to fp16 on its way into one of two
// shared buffers: while the tensor cores run fp16 WMMA (mma.sync, fp32
// accumulators) on one buffer, the next slice loads into registers and is
// stored into the other, so each slice costs one barrier and its L2 load
// overlaps the MMAs of the slice before.  Each of the 8 warps owns a 32 × 64
// piece of the 64 × 256 tile.  The fp32 tile goes through shared memory (the
// slice buffers, free by then) for the bias/activation epilogue so the bf16
// stores are 16-byte and coalesced.  wgmma and TMA are later work here:
// dense_ln_wgmma.cu's kernel takes the epilogue as a template parameter.
#include <mma.h>

#include "common.cuh"

namespace dc {

namespace {

constexpr int BM = 64, BN = 256, BK = 64;
constexpr int kThreads = 256;
constexpr int kApad = 8;           // fp16 elements of row padding (bank spread)
constexpr int kBld = BN + 8;       // W slice row stride, fp16 elements
constexpr int kCld = BN + 4;       // fp32 staging row stride
constexpr int kWWords = BK * BN / 8 / kThreads;  // 16-byte words of a slice per thread

// The fp32 staging of a finished tile reuses the two W slice buffers.
constexpr size_t kBsBytes = 2 * BK * kBld * sizeof(f16);
constexpr size_t kCsBytes = BM * kCld * sizeof(float);
static_assert(kCsBytes <= kBsBytes, "the staging tile must fit in the W buffers");

__host__ __device__ inline size_t smem_bytes(int C) {
  return (size_t)BM * (C + kApad) * sizeof(f16) + kBsBytes;
}

// One BK x BN slice of W (rows k0.., columns n0..) into registers, zero past
// row C or column N: 64 rows x 32 words of 8 bf16, 8 words per thread.
__device__ __forceinline__ void load_w_slice(const bf16* __restrict__ w, int C, int N,
                                             int k0, int n0, uint4 (&reg)[kWWords]) {
#pragma unroll
  for (int t = 0; t < kWWords; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    const int r = idx / (BN / 8);
    const int col = n0 + (idx % (BN / 8)) * 8;
    reg[t] = (k0 + r < C && col < N)
                 ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + col)
                 : make_uint4(0, 0, 0, 0);
  }
}

// Stores the prefetched bf16 slice as fp16 (exact for |w| in [2^-14, 65504]).
__device__ __forceinline__ void store_w_slice(f16* Bs, const uint4 (&reg)[kWWords]) {
#pragma unroll
  for (int t = 0; t < kWWords; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    float f[8];
    unpack8(reg[t], f);
    store8(Bs + r * kBld + c, f);
  }
}

// RES: also write u and e (out_u, out_e) beside out = h.
template <int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
dense_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                const bf16* __restrict__ beta, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ out,
                bf16* __restrict__ out_u, bf16* __restrict__ out_e,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int rows, int C, int N, float eps) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + kApad;
  f16* As = reinterpret_cast<f16*>(smem);
  f16* Bs = As + (size_t)BM * lda;                 // two [BK, kBld] slices
  float* Cs = reinterpret_cast<float*>(Bs);        // [BM, kCld], after the k loop

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;
  const float inv_c = 1.0f / (float)C;

  // The first slice of W is in flight while the LN runs.
  uint4 pre[kWWords];
  load_w_slice(w, C, N, 0, 0, pre);

  // ---- LN prologue: warp w normalises rows w, w+8, ... of the tile.  The
  // raw bf16 row is staged in its fp16 slot (same size) and each lane
  // overwrites only the words it staged.
  for (int r = warp; r < BM; r += kThreads / 32) {
    f16* ar = As + (size_t)r * lda;
    bf16* xs = reinterpret_cast<bf16*>(ar);
    const int g = row0 + r;
    if (g >= rows) {
      float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c = lane * 8; c < C; c += 256) store8(ar + c, z);
      continue;
    }
    const bf16* xr = x + (size_t)g * C;
    float s = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      *reinterpret_cast<uint4*>(xs + c) = *reinterpret_cast<const uint4*>(xr + c);
      float f[8];
      load8(xs + c, f);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += f[t];
    }
    const float mean = warp_sum(s) * inv_c;
    float v = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      load8(xs + c, f);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float d = f[t] - mean;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_c + eps);
    if (mean_out != nullptr && lane == 0) {
      mean_out[g] = mean;
      rstd_out[g] = rstd;
    }
    for (int c = lane * 8; c < C; c += 256) {
      float f[8], gm[8], bt[8];
      load8(xs + c, f);
      load8(gamma + c, gm);
      load8(beta + c, bt);
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = (f[t] - mean) * rstd * gm[t] + bt[t];
      store8(ar + c, f);
    }
  }

  // ---- GEMM over the column tiles of W.  Two slice buffers: while the
  // tensor cores work on slice k, slice k+1 is loading into registers and is
  // then stored into the other buffer, so each slice costs one barrier.
  const int wm = warp / 4;  // 2 warps down: rows wm*32 .. +32
  const int wn = warp % 4;  // 4 warps across: cols wn*64 .. +64
  const int nk = (C + BK - 1) / BK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    store_w_slice(Bs, pre);
    __syncthreads();
    for (int ks = 0; ks < nk; ++ks) {
      const int k0 = ks * BK;
      if (ks + 1 < nk) load_w_slice(w, C, N, k0 + BK, n0, pre);
      const f16* B = Bs + (ks & 1) * BK * kBld;
      const int kend = min(BK, C - k0);
      for (int kk = 0; kk < kend; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, f16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, f16, wmma::row_major> b;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (size_t)(wm * 32 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(b, B + kk * kBld + wn * 64 + j * 16, kBld);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
      if (ks + 1 < nk) store_w_slice(Bs + ((ks + 1) & 1) * BK * kBld, pre);
      __syncthreads();
    }
    // the next tile's first slice loads during this tile's epilogue
    if (n0 + BN < N) load_w_slice(w, C, N, 0, n0 + BN, pre);

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCld + wn * 64 + j * 16,
                                acc[i][j], kCld, wmma::mem_row_major);
    __syncthreads();

    // ---- epilogue: bias + activation in fp32, one bf16 rounding, 16-byte stores.
    for (int idx = threadIdx.x; idx < BM * (BN / 8); idx += kThreads) {
      const int r = idx / (BN / 8);
      const int c = (idx % (BN / 8)) * 8;
      const int g = row0 + r;
      const int col = n0 + c;
      if (g >= rows || col >= N) continue;
      float f[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = Cs[r * kCld + c + t];
      if (bias != nullptr) {
        float bb[8];
        load8(bias + col, bb);
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] += bb[t];
      }
      if (RES) {
        float e[8];
        store8(out_u + (size_t)g * N + col, f);
#pragma unroll
        for (int t = 0; t < 8; ++t) e[t] = act_e<ACT>(f[t]);
        store8(out_e + (size_t)g * N + col, e);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = activate<ACT>(f[t]);
      store8(out + (size_t)g * N + col, f);
    }
    __syncthreads();
  }
}

template <int ACT, bool RES>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* out, void* out_u, void* out_e, void* mean, void* rstd,
           int rows, int C, int N, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(dense_ln_kernel<ACT, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + BM - 1) / BM;
  dense_ln_kernel<ACT, RES><<<blocks, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const bf16*)w,
      (const bf16*)bias, (bf16*)out, (bf16*)out_u, (bf16*)out_e, (float*)mean,
      (float*)rstd, rows, C, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dc

// Shared memory one block needs for width C; the wrapper refuses C whose
// tile does not fit in the 232,448 bytes a Hopper block may use.
DC_EXPORT long long dc_dense_ln_smem_bytes(int C) { return (long long)dc::smem_bytes(C); }

// The lean K2: act 1 exact GELU, 2 QuickGELU.  mean and rstd ([rows] fp32)
// are both NULL or both buffers to fill.  Requires C % 32 == 0 and N % 8 == 0.
DC_EXPORT int dc_dense_ln(const void* x, const void* gamma, const void* beta,
                          const void* w, const void* bias, void* out, void* mean,
                          void* rstd, int rows, int C, int N, float eps, int act,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  void* no = nullptr;
  switch (act) {
    case 1:
      return dc::launch<1, false>(x, gamma, beta, w, bias, out, no, no, mean, rstd, rows, C,
                                  N, eps, s);
    case 2:
      return dc::launch<2, false>(x, gamma, beta, w, bias, out, no, no, mean, rstd, rows, C,
                                  N, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The residual mode of K2: h, u, e [rows, N] bf16 and mean, rstd [rows] fp32.
// act is 1 or 2; same shape rules as dc_dense_ln.
DC_EXPORT int dc_dense_act_ln_res(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, void* h, void* u, void* e,
                                  void* mean, void* rstd, int rows, int C, int N, float eps,
                                  int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case 1:
      return dc::launch<1, true>(x, gamma, beta, w, bias, h, u, e, mean, rstd, rows, C, N,
                                 eps, s);
    case 2:
      return dc::launch<2, true>(x, gamma, beta, w, bias, h, u, e, mean, rstd, rows, C, N,
                                 eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
