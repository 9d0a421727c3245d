// K3's second route: head-transform attention forward on the fused qkv
// projection, on the CUDA cores, for head shapes past the tensor-core kernel
// (transform_attention_mma.cu takes d % 8 == 0 with H up to 32 at d <= 32 and
// up to 16 at d <= 128).  The Python wrapper sends those shapes here by shape
// (ops/transform_attention.py): the lean forward as
// transform_attention_rows_qkv_wide, the training forward as
// transform_attention_save_p_wide (#5's second route), which also stores P_h,
// after the per-head normalisation and before the conv_w mix, as bf16
// [B, H, N, N] at the true N for the backward's second route
// (transform_attention_bwd_wide.cu).  The output is the same bits either way.
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_kernel (with its
// _build_mix_expansions), the Pallas forward behind
// transform_attention_rows_qkv, at those head shapes, without and with saved
// probabilities (the Pallas kernel's save_p mode, _tf_fwd_call(save_p=True)).
//
// Per sample b and query row i (scores never leave shared memory):
//   S_g[i, j]  = q_g[i] · k_g[j]                      g = 0..H-1, j = 0..N-1
//   L_h[i, j]  = scale · Σ_g Wl[h, g] · S_g[i, j]      (conv_l, pre-softmax)
//   P_h[i, :]  = softmax_j(L_h[i, :])                  per-head max and sum
//   P'_h[i, j] = Σ_g Ww[h, g] · P_g[i, j]              (conv_w, post-softmax)
//   O_h[i, :]  = Σ_j P'_h[i, j] · v_h[j, :]
// qkv is [B·N, 3·H·d] bf16 (q | k | v column blocks, head-major inside each),
// Wl and Ww are [H, H] bf16, O is [B·N, H·d] bf16.  All sums are fp32.
//
// This is the math, not the TPU's "colcat" form: that form inflates K and V
// H times to feed a 128×128 matrix unit, which only the TPU's large vector
// memory can hold.  The softmax takes a per-head max (the TPU kernel takes
// one max over all heads of a row and so also needs a 1e-30 underflow guard;
// the two agree unless a head underflows to zero there).
//
// Bound on the H100: shared memory and latency.  The [H, TQ, N] fp32 score
// tile of all heads has to be resident to mix across heads, twice (logits and
// probabilities), so a block takes one sample and TQ ≤ 16 query rows (fewer
// where the tile would not fit: the host picks TQ by dc_tf_smem_bytes), one
// block fills an SM, and K and V are streamed from device memory
// (L2-resident: each sample's K/V is read by its ceil(N/TQ) blocks), with
// only the q tile staged.  With 16 warps per SM the streamed loads cannot
// hide their latency one at a time, so each thread issues a batch of them
// (four 16-byte k chunks, eight bf16 pairs of v) before it uses any.  The
// head mixes are [H, H] × [H, TQ·N] products on the CUDA cores; a thread
// makes four output heads of one position from one read of each input head,
// with the four weights in one 16-byte read of the transposed mix.  N and H
// are runtime values, N needs no padding, and d only has to be a multiple of
// 8.  All products run on the CUDA cores in fp32.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t tf_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)             // q tile
         + (size_t)2 * H * pad4(H) * sizeof(float)     // Wlᵀ, Wwᵀ
         + (size_t)2 * H * tq * N * sizeof(float);     // two [H, tq, N] score buffers
}

__global__ void __launch_bounds__(kThreads)
transform_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wl,
                           const bf16* __restrict__ ww, bf16* __restrict__ out,
                           bf16* __restrict__ probs, int N, int H, int d, int tq,
                           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  const int HD3 = 3 * HD;
  const int plane = tq * N;
  const int H4 = pad4(H);
  bf16* Qs = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  float* Wl = reinterpret_cast<float*>(Qs + (size_t)tq * HD);    // [H, H4], Wlᵀ
  float* Ww = Wl + H * H4;                                       // [H, H4], Wwᵀ
  float* S = Ww + H * H4;                                        // [H, tq, N]
  float* T = S + (size_t)H * plane;                              // [H, tq, N]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * tq;
  const int nq = min(tq, N - i0);
  const bf16* base = qkv + (size_t)b * N * HD3;

  load_mix(wl, Wl, H, false);
  load_mix(ww, Ww, H, false);
  load_row_tile(base + (size_t)i0 * HD3, HD3, Qs, HD, tq, nq);
  __syncthreads();

  // 1) raw per-head scores S_g = q_g · k_gᵀ.
  rows_dot(Qs, base + HD, HD3, S, N, H, d, tq);
  __syncthreads();

  // 2) conv_l across heads, with the softmax scale.
  mix_heads(Wl, S, T, H, plane, scale);
  __syncthreads();

  // 3) softmax over the N keys of each (head, query) row: one warp per row.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < H * tq; r += kWarps) {
    float* t = T + (size_t)r * N;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < N; j += 32) m = fmaxf(m, t[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(t[j] - m);
      t[j] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    for (int j = lane; j < N; j += 32) t[j] *= inv;
  }
  __syncthreads();

  // 3b) the probabilities, for the backward: P[b, h, i0 + i, :] as bf16.
  if (probs != nullptr) {
    for (int idx = threadIdx.x; idx < H * nq * N; idx += kThreads) {
      const int h = idx / (nq * N);
      const int rem = idx - h * nq * N;
      const int i = rem / N;
      const int j = rem - i * N;
      probs[(((size_t)b * H + h) * N + i0 + i) * N + j] =
          __float2bfloat16(T[(h * tq + i) * N + j]);
    }
  }

  // 4) conv_w across heads on the probabilities.
  mix_heads(Ww, T, S, H, plane, 1.0f);
  __syncthreads();

  // 5) O_h = P'_h · v_h.
  plane_rows(S, base + 2 * HD, HD3, out + ((size_t)b * N + i0) * HD, HD, N, H, d, tq, nq);
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for a tile of tq query rows.
DC_EXPORT long long dc_tf_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::tf_smem(N, H, d, tq);
}

DC_EXPORT int dc_tf_max_tq() { return dc::tf::kTqMax; }

// qkv: [batch·N, 3·H·d]; wl, ww: [H, H]; out: [batch·N, H·d]; all bf16.
// probs: NULL, or [batch, H, N, N] bf16 to fill.  1 <= tq <= dc_tf_max_tq(),
// d % 8 == 0, dc_tf_smem_bytes(...) within the block limit (the Python
// wrapper checks all of these).
DC_EXPORT int dc_transform_attention(const void* qkv, const void* wl, const void* ww,
                                     void* out, void* probs, int batch, int N, int H, int d,
                                     int tq, float scale, void* stream) {
  const size_t smem = dc::tf_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::transform_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tq - 1) / tq, batch);
  dc::transform_attention_kernel<<<grid, dc::tf::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)wl, (const dc::bf16*)ww, (dc::bf16*)out,
      (dc::bf16*)probs, N, H, d, tq, scale);
  return (int)cudaGetLastError();
}
