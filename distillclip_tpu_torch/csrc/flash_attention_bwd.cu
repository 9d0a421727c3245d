// Plain multi-head attention backward on [B, H, N, d] operands, from the row
// logsumexp.
//
// Replaces distillclip_tpu/ops/flash_attention.py:_bwd_kernel (called by
// _plain_bwd behind _flash_packed_bwd): dq, dk, dv from q, k, v, the forward's
// output O and logsumexp, and the output gradient dO.  No [B, H, N, N] tensor
// is read or written: the probabilities are recomputed as exp(S − lse), which
// is the difference from the fused-qkv backward (plain_attention_bwd.cu).
//
// All operands are bf16 views with unit stride in d and any batch, head and
// row strides (elements, multiples of 8): the permuted views of a fused qkv go
// in without a copy.  lse is fp32 [B, H, N].
//
// Bound on the H100: bytes, 0.047 ms at the image teacher's shape (B=256,
// H=12, d=64, N=50: 157.9 MB, 4.9 GFLOP).  The routine and its design (a
// block per sample and ceil(64/d) heads staged once, warps of 16 keys making
// dK and dV and warps of 16 queries making dQ, every product on the tensor
// cores through mma.sync with P and dS as bf16 hi + lo) are in
// mma_attention_bwd.cuh.
#include "mma_attention_bwd.cuh"

namespace dc {

namespace {

using mma_attn::Strides;
using mma_attn_bwd::Args;

template <int KS>
__global__ void __launch_bounds__(mma_attn::kThreadsMax, KS <= 4 ? 2 : 1)
flash_attention_bwd_mma_kernel(Args a, int N, int H, int d, int G, int R, float scale,
                               int causal, int kv_len) {
  mma_attn_bwd::attention_bwd_block<KS>(a, N, H, d, G, R, scale, causal, kv_len);
}

// The i-th (batch, head, row) triple of a host array of strides.
Strides strides_at(const long long* s, int i) {
  return Strides{(size_t)s[3 * i], (size_t)s[3 * i + 1], (size_t)s[3 * i + 2]};
}

}  // namespace

}  // namespace dc

// q, k, v, o, dout, dq, dk, dv: bf16 [batch, H, N, d] views with unit stride
// in d; strides is twenty-four element strides, (batch, head, row) of those
// eight in turn.  lse: fp32 [batch, H, N], contiguous.  d % 8 == 0, d <= 128,
// 1 <= N <= 256, every stride a multiple of 8, 1 <= kv_len <= N (the Python
// wrapper checks all of these).
DC_EXPORT int dc_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv, const long long* strides,
                                     int batch, int N, int H, int d, float scale, int causal,
                                     int kv_len, void* stream) {
  // one instance for each padded head dim, pad16(d) = 16·KS
  decltype(&dc::flash_attention_bwd_mma_kernel<1>) const kernels[] = {
      dc::flash_attention_bwd_mma_kernel<1>, dc::flash_attention_bwd_mma_kernel<2>,
      dc::flash_attention_bwd_mma_kernel<3>, dc::flash_attention_bwd_mma_kernel<4>,
      dc::flash_attention_bwd_mma_kernel<5>, dc::flash_attention_bwd_mma_kernel<6>,
      dc::flash_attention_bwd_mma_kernel<7>, dc::flash_attention_bwd_mma_kernel<8>};
  const int ks = dc::mma_attn::pad16(d) / 16;
  if (ks < 1 || ks > 8) return (int)cudaErrorInvalidValue;
  const dc::mma_attn_bwd::Plan p = dc::mma_attn_bwd::plan(batch, N, H, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernels[ks - 1], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dc::mma_attn_bwd::Args a{
      (const dc::bf16*)q, (const dc::bf16*)k, (const dc::bf16*)v, (const dc::bf16*)o,
      (const dc::bf16*)dout, (const float*)lse, (dc::bf16*)dq, (dc::bf16*)dk, (dc::bf16*)dv,
      dc::strides_at(strides, 0), dc::strides_at(strides, 1), dc::strides_at(strides, 2),
      dc::strides_at(strides, 3), dc::strides_at(strides, 4), dc::strides_at(strides, 5),
      dc::strides_at(strides, 6), dc::strides_at(strides, 7)};
  kernels[ks - 1]<<<dim3(p.blocks, p.chunks), p.threads, p.smem, (cudaStream_t)stream>>>(
      a, N, H, d, p.G, p.R, scale, causal, kv_len);
  return (int)cudaGetLastError();
}
