// K3: head-transform attention forward on the fused qkv projection.
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_kernel (with its
// _build_mix_expansions), the Pallas forward behind
// transform_attention_rows_qkv when no probabilities are saved.
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
// probabilities): 2·24·13·50·4 B = 125 KB for the image tower, 2·12·16·77·4 B
// = 118 KB for the text tower.  So a block takes one sample and TQ ≤ 16 query
// rows, one block fills an SM, and K and V are streamed from device memory
// (L2-resident: each sample's K/V is read by its ceil(N/TQ) blocks), with
// only the q tile staged.  With 16 warps per SM the streamed loads cannot
// hide their latency one at a time, so each thread issues a batch of them
// (four 16-byte k chunks, eight bf16 pairs of v) before it uses any.  The
// head mixes are [H, H] × [H, TQ·N] products on the CUDA cores; a thread
// makes four output heads of one position from one read of each input head,
// with the four weights in one 16-byte read of the transposed mix.  The
// host picks TQ so the tile fits (dc_tf_smem_bytes); N and H are runtime
// values, N needs no padding, and d only has to be a multiple of 8.  All
// products run on the CUDA cores in fp32 (~13 MFLOP per image sample);
// moving QKᵀ and PV to the tensor cores is later work.
#include "common.cuh"

namespace dc {

namespace {

constexpr int kTqMax = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Rows of the transposed head mixes, padded to whole 16-byte words.
__host__ __device__ inline int pad4(int H) { return (H + 3) & ~3; }

__host__ __device__ inline size_t tf_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)             // q tile
         + (size_t)2 * H * pad4(H) * sizeof(float)     // Wlᵀ, Wwᵀ
         + (size_t)2 * H * tq * N * sizeof(float);     // two [H, tq, N] score buffers
}

// T[h, p] = alpha · Σ_g W[h, g] · S[g, p] over the tq·N positions p.  WT is
// W transposed, [H, pad4(H)], zero past column H.  A thread makes heads
// h0..h0+3 of one position.
__device__ __forceinline__ void mix_heads(const float* __restrict__ WT,
                                          const float* __restrict__ S,
                                          float* __restrict__ T, int H, int plane,
                                          float alpha) {
  const int H4 = pad4(H);
  for (int idx = threadIdx.x; idx < (H4 / 4) * plane; idx += kThreads) {
    const int h0 = idx / plane * 4;
    const int p = idx - h0 / 4 * plane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < H; ++g) {
      const float s = S[g * plane + p];
      const float4 w = *reinterpret_cast<const float4*>(WT + g * H4 + h0);
      acc.x += w.x * s;
      acc.y += w.y * s;
      acc.z += w.z * s;
      acc.w += w.w * s;
    }
    float* t = T + h0 * plane + p;
    t[0] = alpha * acc.x;
    if (h0 + 1 < H) t[plane] = alpha * acc.y;
    if (h0 + 2 < H) t[2 * plane] = alpha * acc.z;
    if (h0 + 3 < H) t[3 * plane] = alpha * acc.w;
  }
}

__global__ void __launch_bounds__(kThreads)
transform_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wl,
                           const bf16* __restrict__ ww, bf16* __restrict__ out,
                           int N, int H, int d, int tq, float scale) {
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

  for (int idx = threadIdx.x; idx < H * H4; idx += kThreads) {
    const int g = idx / H4;
    const int h = idx - g * H4;
    Wl[idx] = h < H ? __bfloat162float(wl[h * H + g]) : 0.f;
    Ww[idx] = h < H ? __bfloat162float(ww[h * H + g]) : 0.f;
  }
  // q tile, 8 values per word; rows past the end of the sample are zero.
  for (int idx = threadIdx.x; idx < tq * (HD / 8); idx += kThreads) {
    const int i = idx / (HD / 8);
    const int c = (idx - i * (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < nq) v = *reinterpret_cast<const uint4*>(base + (size_t)(i0 + i) * HD3 + c);
    *reinterpret_cast<uint4*>(Qs + i * HD + c) = v;
  }
  __syncthreads();

  // 1) raw per-head scores: thread per (g, j) key row, all tq queries at once,
  //    so each k row is read from memory once per block; four 16-byte chunks
  //    of it are in flight before the first is used.
  for (int item = threadIdx.x; item < H * N; item += kThreads) {
    const int g = item / N;
    const int j = item - g * N;
    const bf16* kp = base + (size_t)j * HD3 + HD + g * d;
    const bf16* qp = Qs + g * d;
    float acc[kTqMax];
#pragma unroll
    for (int i = 0; i < kTqMax; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += 32) {
      uint4 kr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kr[u] = c0 + 8 * u < d ? *reinterpret_cast<const uint4*>(kp + c0 + 8 * u)
                               : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + 8 * u >= d) break;
        float kf[8];
        unpack8(kr[u], kf);
#pragma unroll
        for (int i = 0; i < kTqMax; ++i) {
          if (i < tq) {
            float qf[8];
            load8(qp + i * HD + c0 + 8 * u, qf);
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[i] += qf[t] * kf[t];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTqMax; ++i)
      if (i < tq) S[(g * tq + i) * N + j] = acc[i];
  }
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

  // 4) conv_w across heads on the probabilities.
  mix_heads(Ww, T, S, H, plane, 1.0f);
  __syncthreads();

  // 5) O_h = P'_h · v_h: thread per pair of output columns (one head, since
  //    d is even), all tq queries at once, so each v element is read from
  //    memory once per block; eight key rows of v are in flight at a time.
  for (int col = 2 * threadIdx.x; col < HD; col += 2 * kThreads) {
    const float* p = S + (size_t)(col / d) * plane;
    const bf16* vp = base + 2 * HD + col;
    float acc0[kTqMax], acc1[kTqMax];
#pragma unroll
    for (int i = 0; i < kTqMax; ++i) acc0[i] = acc1[i] = 0.f;
    for (int j0 = 0; j0 < N; j0 += 8) {
      __nv_bfloat162 vr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        vr[u] = j0 + u < N ? *reinterpret_cast<const __nv_bfloat162*>(vp + (size_t)(j0 + u) * HD3)
                           : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u >= N) break;
        const float v0 = __low2float(vr[u]);
        const float v1 = __high2float(vr[u]);
#pragma unroll
        for (int i = 0; i < kTqMax; ++i) {
          if (i < tq) {
            const float pv = p[i * N + j0 + u];
            acc0[i] += pv * v0;
            acc1[i] += pv * v1;
          }
        }
      }
    }
    bf16* o = out + ((size_t)b * N + i0) * HD + col;
#pragma unroll
    for (int i = 0; i < kTqMax; ++i)
      if (i < nq)
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)i * HD) =
            __floats2bfloat162_rn(acc0[i], acc1[i]);
  }
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for a tile of tq query rows.
DC_EXPORT long long dc_tf_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::tf_smem(N, H, d, tq);
}

DC_EXPORT int dc_tf_max_tq() { return dc::kTqMax; }

// qkv: [batch·N, 3·H·d]; wl, ww: [H, H]; out: [batch·N, H·d]; all bf16.
// 1 <= tq <= dc_tf_max_tq(), d % 8 == 0, dc_tf_smem_bytes(...) within the
// block limit (the Python wrapper checks all of these).
DC_EXPORT int dc_transform_attention(const void* qkv, const void* wl, const void* ww,
                                     void* out, int batch, int N, int H, int d, int tq,
                                     float scale, void* stream) {
  const size_t smem = dc::tf_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::transform_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tq - 1) / tq, batch);
  dc::transform_attention_kernel<<<grid, dc::kThreads, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)wl, (const dc::bf16*)ww, (dc::bf16*)out,
      N, H, d, tq, scale);
  return (int)cudaGetLastError();
}
