// Plain multi-head attention backward on [B, H, N, d] operands, from the row
// logsumexp.
//
// Replaces distillclip_tpu/ops/flash_attention.py:_bwd_kernel (called by
// _plain_bwd behind _flash_packed_bwd): dq, dk, dv from q, k, v, the forward's
// output O and logsumexp, and the output gradient dO.
//
// Per sample b and head h, all sums in fp32:
//   P    = exp(scale · Q·Kᵀ − lse)       recomputed; 0 at masked keys
//   δ[i] = Σ_c dO[i, c] · O[i, c]
//   dP   = dO · Vᵀ
//   dS   = scale · P ∘ (dP − δ)
//   dQ   = dS · K,   dK = dSᵀ · Q,   dV = Pᵀ · dO
// No [B, H, N, N] tensor is read or written: that is the difference from the
// fused-qkv backward (plain_attention_bwd.cu), which reads saved probabilities.
// The mask (kv_len, causal) is applied to the recomputed P.  P and dS stay
// fp32 (the TPU kernel rounds them to bf16 for its matrix unit).
//
// All operands are bf16 views with unit stride in d and any batch, head and
// row strides (elements, multiples of 8); lse is fp32 [B, H, N].
//
// dK and dV sum over queries and dQ over keys, heads do not couple and no sum
// crosses samples, so one block owns a sample and nothing leaves it but the
// three gradients: no scratch in device memory, no atomics, no partials, and
// two runs give the same bits.  A sample's [H, N, N] planes do not fit a
// block, so it walks the sample twice in tiles of TQ <= 16 rows, with two
// [H, TQ, N] fp32 planes and two [TQ, H·d] operand tiles in shared memory:
//
//   pass 1, per query tile: S = Q_tile · Kᵀ and dP = dO_tile · Vᵀ, δ from dO
//     and O (kept for pass 2 as [H, N]), P, dS, then dQ_tile = dS · K;
//   pass 2, per key tile:   Sᵀ = K_tile · Qᵀ and dPᵀ = V_tile · dOᵀ, Pᵀ from
//     the given lse, dSᵀ from the kept δ, then dK_tile = dSᵀ · Q and
//     dV_tile = Pᵀ · dO.
//
// S and dP are made twice (seven products for the math's five); in exchange
// no [N, d] accumulator per head outlives a tile, and any N <= 256 and
// d <= 128 fit.  The products run on the CUDA cores in fp32 with the routines
// of the head-transform kernels.  Bound on the H100: bytes, 0.047 ms at the
// image teacher's shape (B=256, H=12, d=64, N=50: 157.9 MB, 4.9 GFLOP); moving
// the products to the tensor cores is later work.
#include "transform_attention.cuh"

namespace dc {

namespace {

using namespace tf;

__host__ __device__ inline size_t fa_bwd_smem(int N, int H, int d, int tq) {
  return (size_t)2 * tq * H * d * sizeof(bf16)        // two operand tiles
         + (size_t)2 * H * tq * N * sizeof(float)     // two [H, tq, N] planes
         + (size_t)2 * H * N * sizeof(float);         // δ and lse
}

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_kernel(BwdArgs a, int N, int H, int d, int tq, float scale, int causal,
                           int kv_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * d;
  const int plane = tq * N;
  bf16* Xa = reinterpret_cast<bf16*>(smem);                      // [tq, HD]
  bf16* Xb = Xa + (size_t)tq * HD;                               // [tq, HD]
  float* T1 = reinterpret_cast<float*>(Xb + (size_t)tq * HD);    // [H, tq, N]
  float* T2 = T1 + (size_t)H * plane;                            // [H, tq, N]
  float* D = T2 + (size_t)H * plane;                             // [H, N]
  float* L = D + (size_t)H * N;                                  // [H, N]

  const int b = blockIdx.x;
  const bf16* qb = a.q + b * a.sq.b;
  const bf16* kb = a.k + b * a.sk.b;
  const bf16* vb = a.v + b * a.sv.b;
  const bf16* ob = a.o + b * a.so.b;
  const bf16* dob = a.dout + b * a.sdo.b;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < H * N; idx += kThreads)
    L[idx] = a.lse[(size_t)b * H * N + idx];

  // pass 1: query tiles.
  for (int i0 = 0; i0 < N; i0 += tq) {
    const int nq = min(tq, N - i0);
    const int nk = causal ? min(kv_len, i0 + nq) : kv_len;
    load_row_tile(dob + i0 * a.sdo.n, a.sdo.n, a.sdo.h, Xa, H, d, tq, nq);
    load_row_tile(qb + i0 * a.sq.n, a.sq.n, a.sq.h, Xb, H, d, tq, nq);
    __syncthreads();
    // δ[h, i0 + i] = dO_h[i] · O_h[i], one warp per (head, query) row.
    for (int r = warp; r < H * nq; r += kWarps) {
      const int h = r / nq;
      const int il = r - h * nq;
      const bf16* orow = ob + (size_t)(i0 + il) * a.so.n + h * a.so.h;
      const bf16* grow = Xa + il * HD + h * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32)
        s += __bfloat162float(grow[c]) * __bfloat162float(orow[c]);
      s = warp_sum(s);
      if (lane == 0) D[h * N + i0 + il] = s;
    }
    // T2[h, i, j] = q_h[i0 + i] · k_h[j],  T1[h, i, j] = dO_h[i0 + i] · v_h[j]
    rows_dot(Xb, kb, a.sk.n, a.sk.h, T2, N, nk, H, d, tq);
    rows_dot(Xa, vb, a.sv.n, a.sv.h, T1, N, nk, H, d, tq);
    __syncthreads();
    // P and dS, one warp per (head, query) row; hidden columns are zeros.
    for (int r = warp; r < H * tq; r += kWarps) {
      const int h = r / tq;
      const int il = r - h * tq;
      float* t1 = T1 + (size_t)r * N;
      const float* t2 = T2 + (size_t)r * N;
      if (il >= nq) {
        for (int j = lane; j < N; j += 32) t1[j] = 0.f;
        continue;
      }
      const int lim = causal ? min(kv_len, i0 + il + 1) : kv_len;
      const float l = L[h * N + i0 + il];
      const float dl = D[h * N + i0 + il];
      for (int j = lane; j < N; j += 32)
        t1[j] = j < lim ? scale * expf(t2[j] * scale - l) * (t1[j] - dl) : 0.f;
    }
    __syncthreads();
    // dQ_tile = dS · K
    plane_rows(T1, kb, a.sk.n, a.sk.h, a.dq + b * a.sdq.b + i0 * a.sdq.n, a.sdq.n, a.sdq.h, N,
               nk, H, d, tq, nq);
    __syncthreads();
  }

  // pass 2: key tiles.
  for (int j0 = 0; j0 < N; j0 += tq) {
    const int nk = min(tq, N - j0);
    load_row_tile(kb + j0 * a.sk.n, a.sk.n, a.sk.h, Xa, H, d, tq, nk);
    load_row_tile(vb + j0 * a.sv.n, a.sv.n, a.sv.h, Xb, H, d, tq, nk);
    __syncthreads();
    // T2[h, j, i] = k_h[j0 + j] · q_h[i],  T1[h, j, i] = v_h[j0 + j] · dO_h[i]
    rows_dot(Xa, qb, a.sq.n, a.sq.h, T2, N, N, H, d, tq);
    rows_dot(Xb, dob, a.sdo.n, a.sdo.h, T1, N, N, H, d, tq);
    __syncthreads();
    // Pᵀ[h, j, i] and dSᵀ[h, j, i] = scale · Pᵀ · (dPᵀ − δ[h, i]); a key the
    // query cannot see (past kv_len, past the tile, or after it under the
    // causal mask) gives zeros.
    for (int idx = threadIdx.x; idx < H * plane; idx += kThreads) {
      const int h = idx / plane;
      const int rem = idx - h * plane;
      const int j = rem / N;
      const int i = rem - j * N;
      const int key = j0 + j;
      const bool seen = j < nk && key < kv_len && (!causal || key <= i);
      const float p = seen ? expf(T2[idx] * scale - L[h * N + i]) : 0.f;
      T2[idx] = p;
      T1[idx] = scale * p * (T1[idx] - D[h * N + i]);
    }
    __syncthreads();
    // dK_tile = dSᵀ · Q,  dV_tile = Pᵀ · dO
    plane_rows(T1, qb, a.sq.n, a.sq.h, a.dk + b * a.sdk.b + j0 * a.sdk.n, a.sdk.n, a.sdk.h, N,
               N, H, d, tq, nk);
    plane_rows(T2, dob, a.sdo.n, a.sdo.h, a.dv + b * a.sdv.b + j0 * a.sdv.n, a.sdv.n, a.sdv.h,
               N, N, H, d, tq, nk);
    __syncthreads();
  }
}

}  // namespace

}  // namespace dc

// Shared memory a block needs for tiles of tq rows.
DC_EXPORT long long dc_fa_bwd_smem_bytes(int N, int H, int d, int tq) {
  return (long long)dc::fa_bwd_smem(N, H, d, tq);
}

// q, k, v, o, dout, dq, dk, dv: bf16 [batch, H, N, d] views with unit stride
// in d; strides is twenty-four element strides, (batch, head, row) of those
// eight in turn.  lse: fp32 [batch, H, N], contiguous.  1 <= tq <=
// dc_tf_max_tq(), d % 8 == 0, every stride a multiple of 8, 1 <= kv_len <= N,
// dc_fa_bwd_smem_bytes(...) within the block limit (the Python wrapper checks
// all of these).
DC_EXPORT int dc_flash_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv, const long long* strides,
                                     int batch, int N, int H, int d, int tq, float scale,
                                     int causal, int kv_len, void* stream) {
  using dc::tf::strides_at;
  const size_t smem = dc::fa_bwd_smem(N, H, d, tq);
  cudaError_t err = cudaFuncSetAttribute(dc::flash_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dc::BwdArgs a{(const dc::bf16*)q, (const dc::bf16*)k, (const dc::bf16*)v,
                (const dc::bf16*)o, (const dc::bf16*)dout, (const float*)lse,
                (dc::bf16*)dq, (dc::bf16*)dk, (dc::bf16*)dv,
                strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                strides_at(strides, 3), strides_at(strides, 4), strides_at(strides, 5),
                strides_at(strides, 6), strides_at(strides, 7)};
  dc::flash_attention_bwd_kernel<<<batch, dc::tf::kThreads, smem, (cudaStream_t)stream>>>(
      a, N, H, d, tq, scale, causal, kv_len);
  return (int)cudaGetLastError();
}
