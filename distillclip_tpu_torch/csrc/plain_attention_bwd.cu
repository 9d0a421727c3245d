// Plain multi-head attention backward on the fused qkv projection.
//
// Replaces distillclip_tpu/ops/blockdiag_attention.py:_bd_bwd_kernel (behind
// _flash_bd_bwd) and the backward of distillclip_tpu/ops/flash_attention.py:
// _rows_bwd_kernel: the fused dqkv from qkv, the output gradient dO and the
// probabilities P that the forward saved (bf16 [B, H, N, N] at the true N).
//
// Per sample b and head h, all sums in fp32:
//   dV   = Pᵀ · dO
//   dP   = dO · Vᵀ
//   D[i] = Σ_j P[i, j] · dP[i, j]
//   dS   = scale · P ∘ (dP − D)
//   dQ   = dS · K,   dK = dSᵀ · Q
// written as dqkv [B·N, 3·H·d] bf16 (dq | dk | dv column blocks).  A masked
// key (causal, kv_len) has P exactly 0 in the saved buffer, so dS and its
// share of dV vanish with it and the kernel takes no mask.  P ∘ dP and dS
// stay fp32 (the TPU kernel rounds them to bf16 for its matrix unit).
//
// Heads do not couple and no sum crosses samples, so one block owns a sample
// and nothing leaves it but dqkv: no scratch in device memory, no atomics, no
// partials, and two runs give the same bits.  What does not fit in a block is
// a sample's [H, N, N] planes, so the block walks the sample twice in tiles of
// TQ <= 16 rows, with two [H, TQ, N] fp32 planes in shared memory:
//
//   pass 1, per query tile: dP = dO_tile · Vᵀ, P's rows, D (kept for pass 2 as
//     [H, N] in shared memory), dS, then dQ_tile = dS · K;
//   pass 2, per key tile:   dPᵀ = V_tile · dOᵀ, P's columns, dSᵀ from the kept
//     D, then dK_tile = dSᵀ · Q and dV_tile = Pᵀ · dO.
//
// dP is made twice (five products for the math's four); in exchange neither dK
// nor dV needs an [N, d] accumulator per head that outlives a tile, and any
// N <= 256 and d <= 128 fit.  The products run on the CUDA cores in fp32 with
// the routines of the head-transform kernels (the tile against rows streamed
// from device memory, L2-resident).  Bound on the H100: bytes, 0.046 ms at the
// image teacher's shape (B=256, H=12, d=64, N=50: 153 MB, 3.9 GFLOP); moving
// the products to the tensor cores is later work.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t pa_bwd_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)            // dO tile / V tile
         + (size_t)2 * H * tq * N * sizeof(float)     // two [H, tq, N] planes
         + (size_t)H * N * sizeof(float);             // D
}

__global__ void __launch_bounds__(kThreads)
plain_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const bf16* __restrict__ probs, bf16* __restrict__ dqkv, int N,
                           int H, int d, int tq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  const int HD3 = 3 * HD;
  const int plane = tq * N;
  bf16* Xs = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  float* T1 = reinterpret_cast<float*>(Xs + (size_t)tq * HD);    // [H, tq, N]
  float* T2 = T1 + (size_t)H * plane;                            // [H, tq, N]
  float* D = T2 + (size_t)H * plane;                             // [H, N]

  const int b = blockIdx.x;
  const bf16* base = qkv + (size_t)b * N * HD3;
  const bf16* dob = dout + (size_t)b * N * HD;
  const bf16* pb = probs + (size_t)b * H * N * N;
  bf16* gbase = dqkv + (size_t)b * N * HD3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // pass 1: query tiles.
  for (int i0 = 0; i0 < N; i0 += tq) {
    const int nq = min(tq, N - i0);
    load_row_tile(dob + (size_t)i0 * HD, HD, Xs, HD, tq, nq);
    // T2[h, i, j] = P[b, h, i0 + i, j]; rows past nq are zero.
    for (int idx = threadIdx.x; idx < H * plane; idx += kThreads) {
      const int h = idx / plane;
      const int rem = idx - h * plane;
      const int i = rem / N;
      const int j = rem - i * N;
      T2[idx] = i < nq ? __bfloat162float(pb[((size_t)h * N + i0 + i) * N + j]) : 0.f;
    }
    __syncthreads();
    // T1[h, i, j] = dO_h[i0 + i] · v_h[j]
    rows_dot(Xs, base + 2 * HD, HD3, T1, N, H, d, tq);
    __syncthreads();
    // D and dS, one warp per (head, query) row.
    for (int r = warp; r < H * tq; r += kWarps) {
      const int h = r / tq;
      const int il = r - h * tq;
      float* t1 = T1 + (size_t)r * N;
      const float* t2 = T2 + (size_t)r * N;
      float s = 0.f;
      for (int j = lane; j < N; j += 32) s += t2[j] * t1[j];
      s = warp_sum(s);
      if (lane == 0 && il < nq) D[h * N + i0 + il] = s;
      for (int j = lane; j < N; j += 32) t1[j] = scale * t2[j] * (t1[j] - s);
    }
    __syncthreads();
    // dQ_tile = dS · K
    plane_rows(T1, base + HD, HD3, gbase + (size_t)i0 * HD3, HD3, N, H, d, tq, nq);
    __syncthreads();
  }

  // pass 2: key tiles.
  for (int j0 = 0; j0 < N; j0 += tq) {
    const int nk = min(tq, N - j0);
    load_row_tile(base + 2 * HD + (size_t)j0 * HD3, HD3, Xs, HD, tq, nk);
    // T2[h, j, i] = P[b, h, i, j0 + j]; rows past nk are zero.
    for (int idx = threadIdx.x; idx < H * N * tq; idx += kThreads) {
      const int h = idx / (N * tq);
      const int rem = idx - h * N * tq;
      const int i = rem / tq;
      const int j = rem - i * tq;
      T2[(h * tq + j) * N + i] =
          j < nk ? __bfloat162float(pb[((size_t)h * N + i) * N + j0 + j]) : 0.f;
    }
    __syncthreads();
    // T1[h, j, i] = v_h[j0 + j] · dO_h[i]
    rows_dot(Xs, dob, HD, T1, N, H, d, tq);
    __syncthreads();
    // dSᵀ[h, j, i] = scale · Pᵀ · (dPᵀ − D[h, i])
    for (int idx = threadIdx.x; idx < H * plane; idx += kThreads) {
      const int h = idx / plane;
      const int i = (idx - h * plane) % N;
      T1[idx] = scale * T2[idx] * (T1[idx] - D[h * N + i]);
    }
    __syncthreads();
    // dK_tile = dSᵀ · Q,  dV_tile = Pᵀ · dO
    plane_rows(T1, base, HD3, gbase + HD + (size_t)j0 * HD3, HD3, N, H, d, tq, nk);
    plane_rows(T2, dob, HD, gbase + 2 * HD + (size_t)j0 * HD3, HD3, N, H, d, tq, nk);
    __syncthreads();
  }
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for tiles of tq rows.
DC_EXPORT long long dc_pa_bwd_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::pa_bwd_smem(N, H, d, tq);
}

// qkv, dqkv: [batch·N, 3·H·d]; dout: [batch·N, H·d]; probs: [batch, H, N, N];
// all bf16.  1 <= tq <= dc_tf_max_tq(), d % 8 == 0, dc_pa_bwd_smem_bytes(...)
// within the block limit (the Python wrapper checks all of these).
DC_EXPORT int dc_plain_attention_bwd(const void* qkv, const void* dout, const void* probs,
                                     void* dqkv, int batch, int N, int H, int d, int tq,
                                     float scale, void* stream) {
  const size_t smem = dc::pa_bwd_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::plain_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dc::plain_attention_bwd_kernel<<<batch, dc::tf::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)dout, (const dc::bf16*)probs, (dc::bf16*)dqkv, N,
      H, d, tq, scale);
  return (int)cudaGetLastError();
}
