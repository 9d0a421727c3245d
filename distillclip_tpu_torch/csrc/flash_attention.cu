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
// bounds it at 0.024 ms.  The kernel reads each operand once into shared
// memory and runs both products on the tensor cores (mma.sync, bf16 operands,
// fp32 sums) with every intermediate in registers: the routine and its design
// are in mma_attention.cuh, shared with the fused-qkv forward
// (plain_attention.cu), which computes the same function.  Here its views are
// the caller's strides, and it writes lse beside O.
#include "mma_attention.cuh"

namespace dc {

namespace {

using mma_attn::Strides;

template <int KS>
__global__ void __launch_bounds__(mma_attn::kThreadsMax)
flash_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ out,
                               float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                               Strides so, int N, int H, int d, int G, float scale_log2,
                               int causal, int kv_len) {
  mma_attn::attention_block<KS>(q, k, v, out, nullptr, lse, sq, sk, sv, so, N, H, d, G,
                                scale_log2, causal, kv_len);
}

// The i-th (batch, head, row) triple of a host array of strides.
Strides strides_at(const long long* s, int i) {
  return Strides{(size_t)s[3 * i], (size_t)s[3 * i + 1], (size_t)s[3 * i + 2]};
}

}  // namespace

}  // namespace dc

// q, k, v, out: bf16 [batch, H, N, d] views with unit stride in d; strides is
// twelve element strides, (batch, head, row) of q, k, v and out in turn.
// lse: fp32 [batch, H, N], contiguous.  scale multiplies q·k; d % 8 == 0,
// d <= 128, 1 <= N <= 256, every stride a multiple of 8, 1 <= kv_len <= N (the
// Python wrapper checks all of these).
DC_EXPORT int dc_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const long long* strides, int batch, int N,
                                     int H, int d, float scale, int causal, int kv_len,
                                     void* stream) {
  // one instance for each padded head dim, pad16(d) = 16·KS
  decltype(&dc::flash_attention_fwd_mma_kernel<1>) const kernels[] = {
      dc::flash_attention_fwd_mma_kernel<1>, dc::flash_attention_fwd_mma_kernel<2>,
      dc::flash_attention_fwd_mma_kernel<3>, dc::flash_attention_fwd_mma_kernel<4>,
      dc::flash_attention_fwd_mma_kernel<5>, dc::flash_attention_fwd_mma_kernel<6>,
      dc::flash_attention_fwd_mma_kernel<7>, dc::flash_attention_fwd_mma_kernel<8>};
  const int ks = dc::mma_attn::pad16(d) / 16;
  if (ks < 1 || ks > 8) return (int)cudaErrorInvalidValue;
  const dc::mma_attn::Plan p = dc::mma_attn::plan(batch, N, H, d, false);
  return dc::mma_attn::launch(
      kernels[ks - 1], p, (cudaStream_t)stream, (const dc::bf16*)q, (const dc::bf16*)k,
      (const dc::bf16*)v, (dc::bf16*)out, (float*)lse, dc::strides_at(strides, 0),
      dc::strides_at(strides, 1), dc::strides_at(strides, 2), dc::strides_at(strides, 3), N, H,
      d, p.G, (float)(scale * 1.4426950408889634), causal, kv_len);
}
