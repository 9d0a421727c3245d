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
// bounds it at 0.023 ms; with saved P it writes 16.4 MB more.  The kernel
// reads each operand once into shared memory and runs both products on the
// tensor cores (mma.sync, bf16 operands, fp32 sums) with every intermediate
// in registers: the routine and its design are in mma_attention.cuh, shared
// with the [B, H, N, d] forward (flash_attention.cu).  Here its views are the
// q, k and v column blocks of the fused rows and O's [B·N, H·d] rows.
#include "mma_attention.cuh"

namespace dc {

namespace {

using mma_attn::Strides;

template <int KS>
__global__ void __launch_bounds__(mma_attn::kThreadsMax)
plain_attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                           bf16* __restrict__ probs, int N, int H, int d, int G,
                           float scale_log2, int causal, int kv_len) {
  const size_t HD = (size_t)H * d;
  const Strides rows{(size_t)N * 3 * HD, (size_t)d, 3 * HD};
  const Strides orows{(size_t)N * HD, (size_t)d, HD};
  mma_attn::attention_block<KS>(qkv, qkv + HD, qkv + 2 * HD, out, probs, nullptr, rows, rows,
                                rows, orows, N, H, d, G, scale_log2, causal, kv_len);
}

}  // namespace

}  // namespace dc

// qkv: [batch·N, 3·H·d]; out: [batch·N, H·d]; both bf16.  probs: NULL, or
// [batch, H, N, N] bf16 to fill.  scale multiplies q·k; d % 8 == 0, d <= 128,
// 1 <= N <= 256, 1 <= kv_len <= N (the Python wrapper checks all of these).
DC_EXPORT int dc_plain_attention(const void* qkv, void* out, void* probs, int batch, int N,
                                 int H, int d, float scale, int causal, int kv_len,
                                 void* stream) {
  // one instance for each padded head dim, pad16(d) = 16·KS
  decltype(&dc::plain_attention_mma_kernel<1>) const kernels[] = {
      dc::plain_attention_mma_kernel<1>, dc::plain_attention_mma_kernel<2>,
      dc::plain_attention_mma_kernel<3>, dc::plain_attention_mma_kernel<4>,
      dc::plain_attention_mma_kernel<5>, dc::plain_attention_mma_kernel<6>,
      dc::plain_attention_mma_kernel<7>, dc::plain_attention_mma_kernel<8>};
  const int ks = dc::mma_attn::pad16(d) / 16;
  if (ks < 1 || ks > 8) return (int)cudaErrorInvalidValue;
  const dc::mma_attn::Plan p = dc::mma_attn::plan(batch, N, H, d, probs != nullptr);
  return dc::mma_attn::launch(kernels[ks - 1], p, (cudaStream_t)stream, (const dc::bf16*)qkv,
                              (dc::bf16*)out, (dc::bf16*)probs, N, H, d, p.G,
                              (float)(scale * 1.4426950408889634), causal, kv_len);
}
