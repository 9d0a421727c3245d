// Head-transform attention forward on [B, H, N, d] operands on the CUDA
// cores: #17's second route, for the head shapes its tensor-core kernel
// (flash_transform_attention_mma.cu: at most 32 heads at d <= 32, 16 at d <=
// 128) does not take; any head count whose planes fit a block, d up to 128.
//
// Replaces distillclip_tpu/ops/flash_attention.py:_tf_fwd_kernel (called by
// _tf_fwd behind flash_attention(q, k, v, head_transform=(Wl, Ww), ...)): the
// attention of the weight-share students when they collect hidden states.
//
// Per sample b and query row i (scores never leave shared memory):
//   S_g[i, j]  = q_g[i] · k_g[j]                      g = 0..H-1, j < lim(i)
//   L_h[i, j]  = scale · Σ_g Wl[h, g] · S_g[i, j]      (conv_l, pre-softmax)
//   P_h[i, :]  = softmax_j(L_h[i, :])                  per-head max and sum
//   P'_h[i, j] = Σ_g Ww[h, g] · P_g[i, j]              (conv_w, post-softmax)
//   O_h[i, :]  = Σ_j P'_h[i, j] · v_h[j, :]
// with lim(i) = min(kv_len, i + 1) under the causal mask and kv_len without.
// This is the math of the fused-qkv head-transform kernel (transform_attention.cu),
// with the masks that one lacks and on strided operands: q, k, v and O are
// bf16 with unit stride in d and any batch, head and row strides (elements,
// multiples of 8).  Wl and Ww are [H, H] bf16.  All sums are fp32.
//
// A masked position is masked for every head, so the mask commutes with both
// mixes: hidden columns are skipped in the softmax and written as exact zeros,
// which conv_w keeps (the TPU kernel adds a finite -1e9 after conv_l).  Its
// gradient is a recompute outside any kernel, as in the JAX package, so
// nothing but O is written.
//
// Bound on the H100: bytes (78.6 MB and 3.44 GFLOP at B=256, H=24, d=32,
// N=50: 0.024 ms), reached nowhere near: all heads of a sample's query tile
// must be resident for the two [H, H] mixes, so a block takes one sample and
// TQ <= 16 query rows with two [H, TQ, N] fp32 planes in shared memory, and
// every product runs on the CUDA cores in fp32 (0.4257 / 0.6306 ms at the
// students' shapes on an H100 SXM at 700 W, where the tensor-core kernel
// takes 0.15 / 0.17).  No published CLIP geometry has heads past the
// tensor-core kernel's (33 heads of 32, 17 of 64 and more).
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t fta_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)             // q tile
         + (size_t)2 * H * pad4(H) * sizeof(float)     // Wlᵀ, Wwᵀ
         + (size_t)2 * H * tq * N * sizeof(float);     // two [H, tq, N] score buffers
}

__global__ void __launch_bounds__(kThreads)
flash_transform_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, const bf16* __restrict__ wl,
                                     const bf16* __restrict__ ww, bf16* __restrict__ out,
                                     Strides sq, Strides sk, Strides sv, Strides so, int N,
                                     int H, int d, int tq, float scale, int causal,
                                     int kv_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
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
  const int nk = causal ? min(kv_len, i0 + nq) : kv_len;

  load_mix(wl, Wl, H, false);
  load_mix(ww, Ww, H, false);
  load_row_tile(q + b * sq.b + i0 * sq.n, sq.n, sq.h, Qs, H, d, tq, nq);
  // columns past nk are never computed; zero them so the mixes read no junk
  if (nk < N)
    for (int idx = threadIdx.x; idx < H * plane; idx += kThreads)
      if (idx % N >= nk) S[idx] = 0.f;
  __syncthreads();

  // 1) raw per-head scores S_g = q_g · k_gᵀ for the keys j < nk.
  rows_dot(Qs, k + b * sk.b, sk.n, sk.h, S, N, nk, H, d, tq);
  __syncthreads();

  // 2) conv_l across heads, with the softmax scale.
  mix_heads(Wl, S, T, H, plane, scale);
  __syncthreads();

  // 3) masked softmax over the keys of each (head, query) row: one warp per
  //    row; columns past the row's limit become exact zeros.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < H * tq; r += kWarps) {
    const int il = r % tq;
    const int lim = causal ? min(kv_len, i0 + il + 1) : kv_len;
    float* t = T + (size_t)r * N;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < lim; j += 32) m = fmaxf(m, t[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < lim; j += 32) {
      const float e = expf(t[j] - m);
      t[j] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    for (int j = lane; j < N; j += 32) t[j] = j < lim ? t[j] * inv : 0.f;
  }
  __syncthreads();

  // 4) conv_w across heads on the probabilities.
  mix_heads(Ww, T, S, H, plane, 1.0f);
  __syncthreads();

  // 5) O_h = P'_h · v_h over the keys j < nk.
  plane_rows(S, v + b * sv.b, sv.n, sv.h, out + b * so.b + i0 * so.n, so.n, so.h, N, nk, H, d,
             tq, nq);
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for a tile of tq query rows.
DC_EXPORT long long dc_fta_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::fta_smem(N, H, d, tq);
}

// q, k, v, out: bf16 [batch, H, N, d] views with unit stride in d; strides is
// twelve element strides, (batch, head, row) of q, k, v and out in turn.  wl,
// ww: [H, H] bf16.  1 <= tq <= dc_tf_max_tq(), d % 8 == 0, every stride a
// multiple of 8, 1 <= kv_len <= N, dc_fta_smem_bytes(...) within the block
// limit (the Python wrapper checks all of these).
DC_EXPORT int dc_flash_transform_attention_fwd(const void* q, const void* k, const void* v,
                                               const void* wl, const void* ww, void* out,
                                               const long long* strides, int batch, int N,
                                               int H, int d, int tq, float scale, int causal,
                                               int kv_len, void* stream) {
  const size_t smem = dc::fta_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::flash_transform_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tq - 1) / tq, batch);
  dc::flash_transform_attention_fwd_kernel<<<grid, dc::tf::kThreads, smem,
                                             (cudaStream_t)stream>>>(
      (const dc::bf16*)q, (const dc::bf16*)k, (const dc::bf16*)v, (const dc::bf16*)wl,
      (const dc::bf16*)ww, (dc::bf16*)out, dc::tf::strides_at(strides, 0),
      dc::tf::strides_at(strides, 1), dc::tf::strides_at(strides, 2),
      dc::tf::strides_at(strides, 3), N, H, d, tq, scale, causal, kv_len);
  return (int)cudaGetLastError();
}
