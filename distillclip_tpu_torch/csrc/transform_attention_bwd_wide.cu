// #6's second route: the backward of head-transform attention on the fused
// qkv projection on the CUDA cores, for the head shapes past the tensor-core
// backward (transform_attention_bwd.cu takes d % 8 == 0 with H <= 32 at d <=
// 32 and H <= 16 at d <= 128: here 48 heads of 8, 32 of 64 and the like).  The autograd function of ops/transform_attention.py picks
// the route by shape before its forward runs, and this route reads the P that
// the forward's second route (transform_attention.cu with its save-P flag)
// wrote: bf16 [B, H, N, N], element by element, so any row alignment.
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_bwd_kernel (behind
// _tf_bwd_call), the save-P backward, at those head shapes (the Pallas kernel
// takes every H >= 12; its one limit is its (h·np_len, HD) VMEM scratch).  From
// qkv, the output gradient do and the forward's saved probabilities P it makes
// dqkv (fused, bf16) and the gradients of the two head mixes, dconv_l and
// dconv_w ([H, H] fp32, summed over the batch).
//
// Per sample, with S_g = q_g k_gᵀ, S2_h = scale·Σ_g wl[h,g] S_g,
// P_h = softmax(S2_h) (saved), Pm_h = Σ_g ww[h,g] P_g, o_h = Pm_h v_h:
//   dPm_h = do_h v_hᵀ                     dv_h = Pm_hᵀ do_h
//   dww[h,g] = Σ_{i,j} dPm_h ∘ P_g        dP_g = Σ_h ww[h,g] dPm_h
//   dS2_g = P_g ∘ (dP_g − rowsum(P_g ∘ dP_g))
//   dwl[h,g] = scale · Σ_{i,j} dS2_h ∘ S_g
//   dS_g = scale · Σ_h wl[h,g] dS2_h      dq_g = dS_g k_g,   dk_g = dS_gᵀ q_g
//
// This is the math at the true N, not the TPU kernel's colcat form (K and V
// inflated H times, one-hot indicator products for the head sums).  The TPU
// kernel rounds P∘dP and dS to bf16 for its matrix unit; here every
// intermediate stays fp32 and only P (as saved) and the outputs are bf16.
//
// Two kernels and a reduction, because dq sums over keys while dk and dv sum
// over queries:
//
// 1. tf_bwd_wide_q_kernel, a block per (sample, tile of tq ≤ 16 query rows),
//    as in the forward.  All heads of the tile stay in shared memory as three
//    [H, tq, N] fp32 planes, so the mixes across heads need no exchange
//    between blocks; the host picks tq by dc_tf_bwd_wide_smem_bytes, and a
//    shape where one query row's three planes of all H heads do not fit is
//    refused before anything runs.  It recomputes the raw scores S (dwl needs
//    them), writes dq, and leaves Pm and dS of its rows in an fp32 scratch
//    [B, H, N, N] in device memory for the second kernel.  Its dwl/dww
//    contribution goes to an fp32 partial per block: a warp takes a head h
//    and four heads g at a time and reduces over the tile with shuffles.
// 2. tf_bwd_wide_kv_kernel, a block per (sample, tile of tq key rows): it
//    loads the key tile's columns of Pm, then of dS, transposed into one
//    [H, tq, N] plane, and makes dv = Pmᵀ do and dk = dSᵀ q with the
//    forward's P·v routine, so no sum crosses blocks and nothing needs
//    atomics.
// 3. reduce_partials (layer_norm.cu, shared with #9 and the tensor-core #6)
//    adds the dwl/dww partials in block order, so the result does not depend
//    on the order in which blocks finish: two runs give the same bits.
//
// Bound on the H100: operations on the CUDA cores.  Five [N, d] × [d, N]-sized
// products and five head mixes or head-pair reductions per sample, all fp32
// outside the tensor cores (67 TFLOP/s), and two fp32 [B, H, N, N] planes
// written and read back.  The tensor-core backward replaced this kernel at
// the head shapes that one takes, up to 32 heads of 32 and 16 of 128 (its
// row kernel holding the dO and q tiles in registers); putting the
// shapes past those on the tensor cores too (heads split over a cluster) is
// later work.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t tf_bwd_wide_smem(int N, int H, int d, int tq) {
  return (size_t)tq * H * d * sizeof(bf16)             // do tile, then q tile
         + (size_t)3 * H * pad4(H) * sizeof(float)     // Wwᵀ, Ww, Wl
         + (size_t)3 * H * tq * N * sizeof(float);     // three [H, tq, N] planes
}

__host__ __device__ inline size_t tf_bwd_wide_kv_smem(int N, int H, int tq) {
  return (size_t)H * tq * N * sizeof(float);
}

// out[h·H + g] = alpha · Σ_p X[h, p] · Y[g, p].  A warp takes one h and four
// g at a time; its lanes stride over p and reduce with shuffles.
__device__ __forceinline__ void head_pair_sums(const float* __restrict__ X,
                                               const float* __restrict__ Y,
                                               float* __restrict__ out, int H, int plane,
                                               float alpha) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quads = (H + 3) / 4;
  for (int item = warp; item < H * quads; item += kWarps) {
    const int h = item / quads;
    const int g0 = (item - h * quads) * 4;
    const float* x = X + (size_t)h * plane;
    // heads past H read head H-1 again; their sums are not stored
    const float* y0 = Y + (size_t)min(g0, H - 1) * plane;
    const float* y1 = Y + (size_t)min(g0 + 1, H - 1) * plane;
    const float* y2 = Y + (size_t)min(g0 + 2, H - 1) * plane;
    const float* y3 = Y + (size_t)min(g0 + 3, H - 1) * plane;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int p = lane; p < plane; p += 32) {
      const float xv = x[p];
      a0 += xv * y0[p];
      a1 += xv * y1[p];
      a2 += xv * y2[p];
      a3 += xv * y3[p];
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    a3 = warp_sum(a3);
    if (lane == 0) {
      out[h * H + g0] = alpha * a0;
      if (g0 + 1 < H) out[h * H + g0 + 1] = alpha * a1;
      if (g0 + 2 < H) out[h * H + g0 + 2] = alpha * a2;
      if (g0 + 3 < H) out[h * H + g0 + 3] = alpha * a3;
    }
  }
}

// Rows i < nq of a [H, tq, N] plane to scratch[b, h, i0 + i, :].
__device__ __forceinline__ void store_plane(const float* __restrict__ T,
                                            float* __restrict__ scratch, int b, int i0,
                                            int N, int H, int tq, int nq) {
  for (int idx = threadIdx.x; idx < H * nq * N; idx += kThreads) {
    const int h = idx / (nq * N);
    const int rem = idx - h * nq * N;
    const int i = rem / N;
    const int j = rem - i * N;
    scratch[(((size_t)b * H + h) * N + i0 + i) * N + j] = T[(h * tq + i) * N + j];
  }
}

__global__ void __launch_bounds__(kThreads)
tf_bwd_wide_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wl,
                     const bf16* __restrict__ ww, const bf16* __restrict__ dout,
                     const bf16* __restrict__ probs, bf16* __restrict__ dqkv,
                     float* __restrict__ pm_scratch, float* __restrict__ ds_scratch,
                     float* __restrict__ partial, int N, int H, int d, int tq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  const int HD3 = 3 * HD;
  const int plane = tq * N;
  const int H4 = pad4(H);
  bf16* Xs = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  float* WwT = reinterpret_cast<float*>(Xs + (size_t)tq * HD);   // [g][h] = ww[h,g]
  float* Ww = WwT + H * H4;                                      // [h][g] = ww[h,g]
  float* Wl = Ww + H * H4;                                       // [h][g] = wl[h,g]
  float* A = Wl + H * H4;                                        // [H, tq, N]
  float* B = A + (size_t)H * plane;
  float* C = B + (size_t)H * plane;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * tq;
  const int nq = min(tq, N - i0);
  const bf16* base = qkv + (size_t)b * N * HD3;
  const int HH = H * H;
  float* part = partial + ((size_t)b * gridDim.x + blockIdx.x) * 2 * HH;  // dwl, then dww

  load_mix(ww, WwT, H, false);
  load_mix(ww, Ww, H, true);
  load_mix(wl, Wl, H, true);
  load_row_tile(dout + ((size_t)b * N + i0) * HD, HD, Xs, HD, tq, nq);
  // A = P of the tile's rows (zero past nq)
  for (int idx = threadIdx.x; idx < H * plane; idx += kThreads) {
    const int h = idx / plane;
    const int rem = idx - h * plane;
    const int i = rem / N;
    const int j = rem - i * N;
    A[idx] = i < nq ? __bfloat162float(probs[(((size_t)b * H + h) * N + i0 + i) * N + j]) : 0.f;
  }
  __syncthreads();

  // B = dPm_h = do_h · v_hᵀ
  rows_dot(Xs, base + 2 * HD, HD3, B, N, H, d, tq);
  __syncthreads();

  // dww[h, g] = Σ dPm_h ∘ P_g;  C = Pm = conv_w(P), kept for dv
  head_pair_sums(B, A, part + HH, H, plane, 1.0f);
  mix_heads(WwT, A, C, H, plane, 1.0f);
  __syncthreads();
  store_plane(C, pm_scratch, b, i0, N, H, tq, nq);
  __syncthreads();

  // C = dP_g = Σ_h ww[h, g] dPm_h
  mix_heads(Ww, B, C, H, plane, 1.0f);
  // the q tile replaces the do tile, which only the first product read
  load_row_tile(base + (size_t)i0 * HD3, HD3, Xs, HD, tq, nq);
  __syncthreads();

  // C = dS2_g = P_g ∘ (dP_g − rowsum(P_g ∘ dP_g)): one warp per (g, i) row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < H * tq; r += kWarps) {
    const float* pr = A + (size_t)r * N;
    float* dr = C + (size_t)r * N;
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s += pr[j] * dr[j];
    s = warp_sum(s);
    for (int j = lane; j < N; j += 32) dr[j] = pr[j] * (dr[j] - s);
  }
  __syncthreads();

  // A = S_g = q_g · k_gᵀ, the raw scores again
  rows_dot(Xs, base + HD, HD3, A, N, H, d, tq);
  __syncthreads();

  // dwl[h, g] = scale · Σ dS2_h ∘ S_g;  B = dS_g = scale · Σ_h wl[h, g] dS2_h
  head_pair_sums(C, A, part, H, plane, scale);
  mix_heads(Wl, C, B, H, plane, scale);
  __syncthreads();
  store_plane(B, ds_scratch, b, i0, N, H, tq, nq);

  // dq_g = dS_g · k_g
  plane_rows(B, base + HD, HD3, dqkv + ((size_t)b * N + i0) * HD3, HD3, N, H, d, tq, nq);
}

// T[h, jj, i] = scratch[b, h, i, j0 + jj], zero past nk.
__device__ __forceinline__ void load_plane_transposed(const float* __restrict__ scratch,
                                                      float* __restrict__ T, int b, int j0,
                                                      int N, int H, int tq, int nk) {
  for (int idx = threadIdx.x; idx < H * N * tq; idx += kThreads) {
    const int h = idx / (N * tq);
    const int rem = idx - h * N * tq;
    const int i = rem / tq;
    const int jj = rem - i * tq;
    T[(h * tq + jj) * N + i] =
        jj < nk ? scratch[(((size_t)b * H + h) * N + i) * N + j0 + jj] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
tf_bwd_wide_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                      const float* __restrict__ pm_scratch, const float* __restrict__ ds_scratch,
                      bf16* __restrict__ dqkv, int N, int H, int d, int tq) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* T = reinterpret_cast<float*>(smem);  // [H, tq, N]
  const int HD = H * d;
  const int HD3 = 3 * HD;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * tq;
  const int nk = min(tq, N - j0);
  bf16* drow = dqkv + ((size_t)b * N + j0) * HD3;

  // dv_h[j] = Σ_i Pm_h[i, j] · do_h[i]
  load_plane_transposed(pm_scratch, T, b, j0, N, H, tq, nk);
  __syncthreads();
  plane_rows(T, dout + (size_t)b * N * HD, HD, drow + 2 * HD, HD3, N, H, d, tq, nk);
  __syncthreads();

  // dk_g[j] = Σ_i dS_g[i, j] · q_g[i]
  load_plane_transposed(ds_scratch, T, b, j0, N, H, tq, nk);
  __syncthreads();
  plane_rows(T, qkv + (size_t)b * N * HD3, HD3, drow + HD, HD3, N, H, d, tq, nk);
}

}  // namespace

}  // namespace dc

// Shared memory a block of the first kernel needs for a tile of tq rows (the
// second needs less).
DC_EXPORT long long dc_tf_bwd_wide_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::tf_bwd_wide_smem(N, H, d, tq);
}

// qkv, dqkv: [batch·N, 3·H·d]; dout: [batch·N, H·d]; wl, ww: [H, H];
// probs: [batch, H, N, N]; all bf16.  pm_scratch, ds_scratch: [batch, H, N, N]
// fp32; partial: [batch·ceil(N/tq), 2·H·H] fp32; dwl_dww: [2·H·H] fp32 (dconv_l
// then dconv_w).  1 <= tq <= dc_tf_max_tq(), d % 8 == 0 and
// dc_tf_bwd_wide_smem_bytes(...) within the block limit (the Python wrapper checks).
DC_EXPORT int dc_transform_attention_bwd_wide(const void* qkv, const void* wl, const void* ww,
                                              const void* dout, const void* probs, void* dqkv,
                                              void* pm_scratch, void* ds_scratch, void* partial,
                                              void* dwl_dww, int batch, int N, int H, int d,
                                              int tq, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem_q = dc::tf_bwd_wide_smem(N, H, d, tq);
  const size_t smem_kv = dc::tf_bwd_wide_kv_smem(N, H, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::tf_bwd_wide_q_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dc::tf_bwd_wide_kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + tq - 1) / tq;
  dim3 grid(tiles, batch);
  dc::tf_bwd_wide_q_kernel<<<grid, dc::tf::kThreads, smem_q, s>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)wl, (const dc::bf16*)ww, (const dc::bf16*)dout,
      (const dc::bf16*)probs, (dc::bf16*)dqkv, (float*)pm_scratch, (float*)ds_scratch,
      (float*)partial, N, H, d, tq, scale);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  dc::tf_bwd_wide_kv_kernel<<<grid, dc::tf::kThreads, smem_kv, s>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)dout, (const float*)pm_scratch,
      (const float*)ds_scratch, (dc::bf16*)dqkv, N, H, d, tq);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return dc::reduce_partials((const float*)partial, (float*)dwl_dww, tiles * batch,
                             2 * H * H, s);
}
