// Plain multi-head attention forward on [B, H, N, d] operands, with the row
// logsumexp as the residual of its backward.
//
// Replaces distillclip_tpu/ops/flash_attention.py:_fwd_kernel (called by
// _plain_fwd behind flash_attention(q, k, v, ...) without head_transform): the
// attention of the towers when they collect hidden states.
//
// Per sample b, head h and query row i:
//   S_h[i, j] = scale · q_h[i] · k_h[j]          j < lim(i)
//   m, Σ      = max_j S_h[i, j],  Σ_j exp(S_h[i, j] − m)      fp32
//   O_h[i, :] = Σ_j exp(S_h[i, j] − m) / Σ · v_h[j, :]        one rounding to bf16
//   lse_h[i]  = m + log Σ                                      fp32 [B, H, N]
// with lim(i) = min(kv_len, i + 1) under the causal mask and kv_len without.
// The backward kernel (flash_attention_bwd.cu) recomputes the probabilities
// as exp(S − lse), so no [B, H, N, N] tensor is ever written.
//
// q, k, v and O are bf16 with unit stride in d and any batch, head and row
// strides (in elements, multiples of 8): a contiguous [B, H, N, d] tensor and
// the permuted view of a fused [B, N, 3, H, d] projection both work without a
// copy, and O can be laid out as [B, N, H·d] rows for the output projection.
//
// Masked keys are skipped columns: they never enter the max or the sum (the
// TPU kernel adds a finite -1e9, whose exp underflows to the same 0).  What
// the TPU kernel does for its matrix unit (G heads packed on sublanes into one
// [G·Np, G·Np] product behind a block-diagonal bias, N padded to 16) is not
// carried over: heads do not couple, each is its own d-deep dot at the true N.
//
// Bound on the H100: bytes.  At the image teacher's shape (B=256, H=12, d=64,
// N=50) the function moves 79.3 MB and does 1.97 GFLOP, so device memory
// bounds it at 0.024 ms.  This first version runs both products on the CUDA
// cores in fp32 with the routines of the head-transform kernel: a block takes
// one sample and TQ <= 16 query rows of all heads, stages the q tile, keeps
// the [H, TQ, N] fp32 scores in shared memory and streams K and V from device
// memory (L2-resident across the sample's blocks).  Under the causal mask a
// tile only visits the keys up to its last row.  Moving the products to the
// tensor cores is later work.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t fa_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)          // q tile
         + (size_t)H * tq * N * sizeof(float);      // [H, tq, N] scores
}

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                           Strides so, int N, int H, int d, int tq, float scale, int causal,
                           int kv_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  bf16* Qs = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  float* S = reinterpret_cast<float*>(Qs + (size_t)tq * HD);     // [H, tq, N]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * tq;
  const int nq = min(tq, N - i0);
  // keys this tile can see: all valid ones, or those up to its last row
  const int nk = causal ? min(kv_len, i0 + nq) : kv_len;

  load_row_tile(q + b * sq.b + i0 * sq.n, sq.n, sq.h, Qs, H, d, tq, nq);
  __syncthreads();

  // 1) raw scores q_h · k_hᵀ for the keys j < nk.
  rows_dot(Qs, k + b * sk.b, sk.n, sk.h, S, N, nk, H, d, tq);
  __syncthreads();

  // 2) masked softmax of each (head, query) row and its logsumexp: one warp
  //    per row.  Columns past the row's limit become exact zeros.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < H * tq; r += kWarps) {
    const int h = r / tq;
    const int il = r - h * tq;
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
    s = warp_sum(s);
    const float inv = 1.0f / s;
    for (int j = lane; j < N; j += 32) t[j] = j < lim ? t[j] * inv : 0.f;
    if (lane == 0) lse[((size_t)b * H + h) * N + i0 + il] = m + logf(s);
  }
  __syncthreads();

  // 3) O_h = P_h · v_h over the keys j < nk.
  plane_rows(S, v + b * sv.b, sv.n, sv.h, out + b * so.b + i0 * so.n, so.n, so.h, N, nk, H, d,
             tq, nq);
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for a tile of tq query rows.
DC_EXPORT long long dc_fa_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::fa_smem(N, H, d, tq);
}

// q, k, v, out: bf16 [batch, H, N, d] views with unit stride in d; strides is
// twelve element strides, (batch, head, row) of q, k, v and out in turn.
// lse: fp32 [batch, H, N], contiguous.  1 <= tq <= dc_tf_max_tq(), d % 8 == 0,
// every stride a multiple of 8, 1 <= kv_len <= N, dc_fa_smem_bytes(...) within
// the block limit (the Python wrapper checks all of these).
DC_EXPORT int dc_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const long long* strides, int batch, int N,
                                     int H, int d, int tq, float scale, int causal, int kv_len,
                                     void* stream) {
  const size_t smem = dc::fa_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::flash_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tq - 1) / tq, batch);
  dc::flash_attention_fwd_kernel<<<grid, dc::tf::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)q, (const dc::bf16*)k, (const dc::bf16*)v, (dc::bf16*)out, (float*)lse,
      dc::tf::strides_at(strides, 0), dc::tf::strides_at(strides, 1),
      dc::tf::strides_at(strides, 2), dc::tf::strides_at(strides, 3), N, H, d, tq, scale,
      causal, kv_len);
  return (int)cudaGetLastError();
}
