// Plain multi-head attention forward on the fused qkv projection.
//
// Replaces distillclip_tpu/ops/blockdiag_attention.py:_bd_fwd_kernel (entry
// blockdiag_attention_rows_qkv, with and without saved probabilities) and the
// forward of distillclip_tpu/ops/flash_attention.py:_rows_fwd_kernel (entry
// flash_attention_rows_qkv), which the JAX package runs for the head shapes
// the first one rejects: one kernel here takes any head count.
//
// Per sample b, head h and query row i:
//   S_h[i, j] = scale · q_h[i] · k_h[j]        j < lim(i)
//   P_h[i, :] = softmax_j(S_h[i, :])            per-head max and sum, fp32
//   O_h[i, :] = Σ_j P_h[i, j] · v_h[j, :]       one rounding to bf16
// with lim(i) = min(kv_len, i + 1) under the causal mask and kv_len without.
// qkv is [B·N, 3·H·d] bf16 (q | k | v column blocks, head-major inside each),
// O is [B·N, H·d] bf16.  Given a buffer, the kernel also stores P as bf16
// [B, H, N, N] at the true N, from the same fp32 values that feed P·v; the
// output is the same bits either way.
//
// Masked keys are skipped columns, not a large negative bias: they never
// enter the max or the sum, and their probability is written as an exact 0
// (the JAX kernel adds a finite -1e9, whose exp underflows to the same 0).
// The backward kernel relies on those zeros and takes no mask of its own.
// Every row keeps at least its first key (kv_len >= 1), so no row is empty.
//
// What the TPU kernel does for its 128-lane matrix unit (packing 128/d heads
// per dot behind a block-diagonal mask, indicator dots for the denominators,
// a row max over the packed chunk) is not carried over: heads do not couple
// here, each is its own d-deep dot.
//
// Bound on the H100: bytes.  At the image teacher's shape (B=256, H=12, d=64,
// N=50) the function moves 78.6 MB and does 1.97 GFLOP, so device memory
// bounds it at 0.023 ms.  This first version runs the two products on the
// CUDA cores in fp32 with the routines of the head-transform kernel: a block
// takes one sample and TQ <= 16 query rows of all heads, stages the q tile,
// keeps the [H, TQ, N] fp32 scores in shared memory and streams K and V from
// device memory (L2-resident across the sample's blocks).  Under the causal
// mask a tile only visits the keys up to its last row, which skips about half
// of both products.  Moving the products to the tensor cores is later work.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t pa_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)          // q tile
         + (size_t)H * tq * N * sizeof(float);      // [H, tq, N] scores
}

__global__ void __launch_bounds__(kThreads)
plain_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                       bf16* __restrict__ probs, int N, int H, int d, int tq, float scale,
                       int causal, int kv_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  const int HD3 = 3 * HD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  float* S = reinterpret_cast<float*>(Qs + (size_t)tq * HD);     // [H, tq, N]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * tq;
  const int nq = min(tq, N - i0);
  // keys this tile can see: all valid ones, or those up to its last row
  const int nk = causal ? min(kv_len, i0 + nq) : kv_len;
  const bf16* base = qkv + (size_t)b * N * HD3;

  load_row_tile(base + (size_t)i0 * HD3, HD3, Qs, HD, tq, nq);
  __syncthreads();

  // 1) raw scores q_h · k_hᵀ for the keys j < nk.
  rows_dot(Qs, base + HD, HD3, S, N, nk, H, d, tq);
  __syncthreads();

  // 2) masked softmax of each (head, query) row: one warp per row.  Columns
  //    past the row's limit become exact zeros.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < H * tq; r += kWarps) {
    const int il = r % tq;
    if (il >= nq) continue;
    const int lim = causal ? min(kv_len, i0 + il + 1) : kv_len;
    float* t = S + (size_t)r * N;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < lim; j += 32) m = fmaxf(m, t[j] * scale);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < lim; j += 32) {
      const float e = expf(t[j] * scale - m);
      t[j] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    for (int j = lane; j < N; j += 32) t[j] = j < lim ? t[j] * inv : 0.f;
  }
  __syncthreads();

  // 2b) the probabilities, for the backward: P[b, h, i0 + i, :] as bf16,
  //     masked columns included (as zeros).
  if (probs != nullptr) {
    for (int idx = threadIdx.x; idx < H * nq * N; idx += kThreads) {
      const int h = idx / (nq * N);
      const int rem = idx - h * nq * N;
      const int i = rem / N;
      const int j = rem - i * N;
      probs[(((size_t)b * H + h) * N + i0 + i) * N + j] =
          __float2bfloat16(S[(h * tq + i) * N + j]);
    }
  }

  // 3) O_h = P_h · v_h over the keys j < nk.
  plane_rows(S, base + 2 * HD, HD3, out + ((size_t)b * N + i0) * HD, HD, N, nk, H, d, tq, nq);
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for a tile of tq query rows.
DC_EXPORT long long dc_pa_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::pa_smem(N, H, d, tq);
}

// qkv: [batch·N, 3·H·d]; out: [batch·N, H·d]; both bf16.  probs: NULL, or
// [batch, H, N, N] bf16 to fill.  1 <= tq <= dc_tf_max_tq(), d % 8 == 0,
// 1 <= kv_len <= N, dc_pa_smem_bytes(...) within the block limit (the Python
// wrapper checks all of these).
DC_EXPORT int dc_plain_attention(const void* qkv, void* out, void* probs, int batch, int N,
                                 int H, int d, int tq, float scale, int causal, int kv_len,
                                 void* stream) {
  const size_t smem = dc::pa_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::plain_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tq - 1) / tq, batch);
  dc::plain_attention_kernel<<<grid, dc::tf::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)qkv, (dc::bf16*)out, (dc::bf16*)probs, N, H, d, tq, scale, causal,
      kv_len);
  return (int)cudaGetLastError();
}
