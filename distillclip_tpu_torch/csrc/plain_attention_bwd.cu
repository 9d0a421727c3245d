// Plain multi-head attention backward on the fused qkv projection, from the
// probabilities the forward saved.
//
// Replaces distillclip_tpu/ops/blockdiag_attention.py:_bd_bwd_kernel (behind
// _bd_bwd_call and _flash_bd_bwd) and the backward of
// distillclip_tpu/ops/flash_attention.py:_rows_bwd_kernel: the fused dqkv from
// qkv, the output gradient dO and the probabilities P that the forward saved
// (bf16 [B, H, N, N] at the true N).
//
// Per sample b and head h, all sums in fp32:
//   dV   = Pᵀ · dO
//   dP   = dO · Vᵀ
//   D[i] = Σ_j P[i, j] · dP[i, j]
//   dS   = scale · P ∘ (dP − D)
//   dQ   = dS · K,   dK = dSᵀ · Q
// written as dqkv [B·N, 3·H·d] bf16 (dq | dk | dv column blocks).  A masked
// key (causal, kv_len) has P exactly 0 in the saved buffer, so dS and its
// share of dV vanish with it and the kernel takes no mask.
//
// Bound on the H100: bytes.  At the image teacher's shape (B=256, H=12, d=64,
// N=50) the function reads qkv, dO and P and writes dqkv, 153.0 MB, against
// 3.9 GFLOP for its four products (26 FLOP/B).  So it follows the design of
// the recomputing backward (#16, mma_attention_bwd.cuh), whose routines it
// uses: every operand is read once into shared memory and every intermediate
// stays in registers.
//
// * A block owns one sample and G = ceil(64 / d) heads (fewer where shared
//   memory runs out): 3072 blocks at the image student's shape.  q, k, v and
//   dO are column blocks of the fused rows (row stride 3·H·d, H·d for dO) and
//   are staged with 16-byte cp.async copies, rows padded by 16 bytes, zero
//   past N and past d's multiple of 16.  P rows are N·2 bytes and a head's
//   plane starts at a multiple of N² elements, so P is only 2-byte aligned,
//   but a block's P rows are one contiguous run per head: it is staged as
//   the 16-byte words that hold it, by cp.async beside the other copies, and
//   then laid out in shared memory into rows of pad16(N) + 8 elements (zero
//   past N).  Element loads, a row a warp, wait on one load after another:
//   only the streamed dK/dV phase, which needs P's columns, stages that way.
// * Every product is mma.sync.m16n8k16 with bf16 operands and fp32 sums, fed
//   by ldmatrix.  P is read from its plane straight as an A fragment:
//   ldmatrix for P (dQ items), ldmatrix.trans for Pᵀ (dK/dV items); the same
//   registers give its fp32 values in the accumulator layout (the A fragment
//   of m16n8k16 is two C fragments of m16n8), so no S is recomputed.
// * dQ items: a warp owns 16 queries of one head and walks the keys twice:
//   pass A makes dP = dO·Vᵀ and D = Σ_j P∘dP (quad shuffles), written to
//   shared memory; pass B makes dP again, then dS, then dQ += dS·K.
// * After a block barrier, dK/dV items: a warp owns 16 keys and walks the
//   queries: dPᵀ = V·dOᵀ, Pᵀ from the plane, dSᵀ from those and D, then
//   dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as A fragments.
// * Precision: P enters dV as one bf16 operand, since it is the saved bf16
//   value and nothing is lost; dS enters dQ and dK as bf16 hi + lo into one
//   fp32 sum; D stays fp32.  The TPU kernel rounds P∘dP and dS to bf16 once.
//   That is 8 tensor-core passes per (head, 16 x 16 tile): dP twice and dQ
//   (hi + lo) in the dQ items, dPᵀ, dV and dK (hi + lo) in the dK/dV items.
// * Streaming: where one head's planes do not fit (d >= 64 at N = 256) the
//   grid's second dimension cuts the rows into chunks of R.  A block stages k
//   and v whole, makes D of every row chunk by chunk (dO and P rows of each),
//   then dQ of its own queries (their q, dO and P rows), then stages q and dO
//   whole with its own k, v rows and P's columns of its keys, and makes their
//   dK, dV.  Otherwise one chunk holds everything, staged once.
// * No atomics, no partials, no scratch: two runs give the same bits.
#include "mma_attention_bwd.cuh"

namespace dc {

namespace {

using mma_attn::kMaxSmem;
using mma_attn::kMaxWarps;
using mma_attn::pad16;
using mma_attn::quad_sum;
using mma_attn::row_ld;
using mma_attn::Strides;
using mma_attn_bwd::ab_frag;
using mma_attn_bwd::ab_step;
using mma_attn_bwd::frag_values;
using mma_attn_bwd::p_frag;
using mma_attn_bwd::Plan;
using mma_attn_bwd::pt_frag;
using mma_attn_bwd::scores_from_planes;
using mma_attn_bwd::stage;
using mma_attn_bwd::store_rows;

// Row stride of a staged P plane of `cols` columns (a multiple of 16): + 8
// keeps the eight rows of an ldmatrix in different bank groups.
__host__ __device__ constexpr int p_ld(int cols) { return cols + 8; }

// Elements of a head's P run in the linear staging buffer: R rows of N, and
// the parts of the first and last 16-byte words outside the run.
__host__ __device__ constexpr int lin_len(int N, int R) { return R * N + 16; }

// Shared memory of a block of G heads and chunks of R rows: two planes of
// pad16(N) rows, two of R, P (R rows of pad16(N) or pad16(N) rows of R
// columns; the second is the larger), P's rows as staged and D.
__host__ inline size_t smem_bytes(int N, int d, int G, int R) {
  const int Np = pad16(N);
  return (size_t)G *
             ((size_t)(2 * Np + 2 * R) * row_ld(d) + (size_t)Np * p_ld(R) + lin_len(N, R)) *
             sizeof(bf16) +
         (size_t)G * Np * sizeof(float);
}

Plan pa_bwd_plan(int batch, int N, int H, int d) {
  const int Np = pad16(N);
  int G = (64 + d - 1) / d;
  if (G > H) G = H;
  while (G > 1 && smem_bytes(N, d, G, Np) > kMaxSmem) --G;
  int R = Np;
  while (R > 16 && smem_bytes(N, d, G, R) > kMaxSmem) R -= 16;
  const int chunks = (Np + R - 1) / R;
  R = pad16((Np + chunks - 1) / chunks);     // even chunks
  const int items = G * (R / 16);
  const int warps = items < kMaxWarps ? items : kMaxWarps;
  return Plan{G, R, warps * 32, smem_bytes(N, d, G, R),
              (unsigned)batch * ((H + G - 1) / G), (unsigned)chunks};
}

// Offset in elements of P's element (b, h, r, 0) from the 16-byte word that
// holds it.
__device__ __forceinline__ int p_lead(const bf16* probs, int b, int H, int h, int r, int N) {
  return (int)((reinterpret_cast<uintptr_t>(probs + (((size_t)b * H + h) * N + r) * N) & 15) >>
               1);
}

// Rows row0 .. row0 + nrows - 1 of the P planes of heads h0 .. h0 + Gb - 1
// are one run of N·nrows elements per head (rows past N excluded): the
// 16-byte words that hold it, by cp.async into runs of lin_len(N, R) elements
// at `lin` (the caller commits and waits), then by relayout_p into rows of
// the P plane.  A word may reach past the run, never past the allocation
// (whose size is a multiple of 16 bytes).
__device__ __forceinline__ void stage_p_rows(bf16* lin, int len, const bf16* __restrict__ probs,
                                             int b, int H, int h0, int Gb, int row0, int nrows,
                                             int N) {
  const int n = min(nrows, N - row0) * N;
  const int words = (n + 14) / 8;
  for (int idx = threadIdx.x; idx < Gb * words; idx += blockDim.x) {
    const int g = idx / words, w = idx - g * words;
    const int lead = p_lead(probs, b, H, h0 + g, row0, N);
    if (8 * w < lead + n)
      mma_attn::cp_async16(lin + g * len + 8 * w,
                           probs + (((size_t)b * H + h0 + g) * N + row0) * N - lead + 8 * w);
  }
}

__device__ __forceinline__ void relayout_p(bf16* dst, size_t plane, int ld, const bf16* lin,
                                           int len, const bf16* __restrict__ probs, int b,
                                           int H, int h0, int Gb, int row0, int nrows, int Np,
                                           int N) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(lin);
  unsigned short* out = reinterpret_cast<unsigned short*>(dst);
  const int lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < Gb * nrows; rr += blockDim.x >> 5) {
    const int g = rr / nrows, i = rr - g * nrows, r = row0 + i;
    const unsigned short* row = src + g * len + p_lead(probs, b, H, h0 + g, row0, N) + i * N;
    unsigned short* o = out + g * plane + (size_t)i * ld;
    for (int j = lane; j < Np; j += 32) o[j] = r < N && j < N ? row[j] : 0;
  }
}

// Columns col0 .. col0 + ncols - 1 of every row of the P planes of heads h0 ..
// h0 + Gb - 1 into planes of `plane` elements (row stride ld); zero past N.
// A warp takes a row, lanes consecutive elements (the streamed dK/dV phase).
__device__ __forceinline__ void stage_p_cols(bf16* dst, size_t plane, int ld,
                                             const bf16* __restrict__ probs, int b, int H,
                                             int h0, int Gb, int Np, int col0, int ncols,
                                             int N) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(probs);
  unsigned short* out = reinterpret_cast<unsigned short*>(dst);
  const int lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < Gb * Np; rr += blockDim.x >> 5) {
    const int g = rr / Np, r = rr - g * Np;
    const unsigned short* row = src + (((size_t)b * H + h0 + g) * N + r) * N + col0;
    unsigned short* o = out + g * plane + (size_t)r * ld;
    for (int j = lane; j < ncols; j += 32) o[j] = r < N && col0 + j < N ? row[j] : 0;
  }
}

// Pass A of a dQ item: D of queries (local) il .. il + 15 over T key tiles,
// dO rows at il of dOp, V whole, P rows at pr of its plane (row stride pld);
// returns the D of the thread's rows il + gid and il + gid + 8.
template <int KS>
__device__ __forceinline__ float2 delta_rows(const bf16* dOp, int il, const bf16* Vp,
                                             const bf16* P, int pld, int pr, int T, int lane) {
  float sa = 0.f, sb = 0.f;
  for (int st = 0; st < T; ++st) {
    float dp[2][4], p[2][4];
    uint32_t pf[4];
    scores_from_planes<KS>(dOp, il, Vp, st, lane, dp);     // dP = dO · Vᵀ
    p_frag(pf, P, pld, pr, st * 16, lane);
    frag_values(pf, p);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sa = fmaf(p[n][0], dp[n][0], fmaf(p[n][1], dp[n][1], sa));
      sb = fmaf(p[n][2], dp[n][2], fmaf(p[n][3], dp[n][3], sb));
    }
  }
  return make_float2(quad_sum(sa), quad_sum(sb));
}

// Pass B: dQ of those queries, dQ += dS · K with D = (da, db) of the rows.
template <int KS>
__device__ __forceinline__ void dq_rows(float (&dq)[2 * KS][4], const bf16* dOp, int il,
                                        const bf16* Vp, const bf16* Kp, const bf16* P, int pld,
                                        int pr, int T, float da, float db, float scale,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int st = 0; st < T; ++st) {
    float dp[2][4], p[2][4];
    uint32_t pf[4];
    scores_from_planes<KS>(dOp, il, Vp, st, lane, dp);
    p_frag(pf, P, pld, pr, st * 16, lane);
    frag_values(pf, p);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = scale * p[n][e] * (dp[n][e] - (e < 2 ? da : db));
    ab_step<KS>(dq, dp, Kp, st, lane);       // dQ += dS · K
  }
}

// dK, dV of keys (local) jl .. jl + 15: K, V rows at jl of their planes, Q
// and dO whole (T query tiles), Pᵀ from the P plane at columns pc (all rows),
// D of the head's queries.
template <int KS>
__device__ __forceinline__ void dkdv_rows(float (&dk)[2 * KS][4], float (&dv)[2 * KS][4],
                                          const bf16* Kp, const bf16* Vp, int jl,
                                          const bf16* Qp, const bf16* dOp, const bf16* P,
                                          int pld, int pc, const float* D, int T, float scale,
                                          int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int it = 0; it < T; ++it) {
    float ds[2][4], pt[2][4];
    uint32_t pf[4];
    scores_from_planes<KS>(Vp, jl, dOp, it, lane, ds);     // dPᵀ: keys x queries
    pt_frag(pf, P, pld, it * 16, pc, lane);
    frag_values(pf, pt);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float di = D[it * 16 + n * 8 + tig * 2 + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = r * 2 + c;
          ds[n][e] = scale * pt[n][e] * (ds[n][e] - di);
        }
      }
    }
    ab_frag<KS>(dv, pf, dOp, it, lane);        // dV += Pᵀ · dO
    ab_step<KS>(dk, ds, Qp, it, lane);         // dK += dSᵀ · Q
  }
}

// STREAM: row chunks over grid y.  Apart, the two modes keep their own
// registers; a streamed block fills an SM's shared memory alone, so it may
// take more of them.
template <int KS, bool STREAM>
__global__ void __launch_bounds__(mma_attn::kThreadsMax, KS <= 4 && !STREAM ? 2 : 1)
plain_attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                               const bf16* __restrict__ probs, bf16* __restrict__ dqkv, int N,
                               int H, int d, int G, int R, float scale) {
  constexpr int LD = 16 * KS + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Np = pad16(N), T = Np / 16;
  const size_t wplane = (size_t)Np * LD, oplane = (size_t)R * LD;
  const size_t pplane = (size_t)Np * p_ld(R);
  const int plen = lin_len(N, R);
  const int prow_ld = p_ld(Np);               // P by rows: all columns
  bf16* W1 = reinterpret_cast<bf16*>(smem);   // [G][Np][LD]: k (then q when streamed)
  bf16* W2 = W1 + G * wplane;                 // v (then dO)
  bf16* O1 = W2 + G * wplane;                 // [G][R][LD]: q rows (then k rows)
  bf16* O2 = O1 + G * oplane;                 // dO rows (then v rows)
  bf16* Pb = O2 + G * oplane;                 // [G][pplane]: P rows (then columns)
  bf16* Pl = Pb + G * pplane;                 // [G][plen]: P rows as staged
  float* D = reinterpret_cast<float*>(Pl + G * plen);      // [G][Np]

  const size_t HD = (size_t)H * d;
  const Strides sx{(size_t)N * 3 * HD, (size_t)d, 3 * HD};
  const Strides sdo{(size_t)N * HD, (size_t)d, HD};
  const bf16* q = qkv;
  const bf16* k = qkv + HD;
  const bf16* v = qkv + 2 * HD;
  const int ngroups = (H + G - 1) / G;
  const int b = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x - b * ngroups) * G;
  const int Gb = min(G, H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int gid = lane >> 2;
  float acc[2][2 * KS][4];

  if constexpr (!STREAM) {
    // everything staged once: k, v in W, q, dO in O (R = Np), P by rows
    stage<KS>(W1, wplane, k, sx, b, h0, Gb, 0, Np, N, d);
    stage<KS>(W2, wplane, v, sx, b, h0, Gb, 0, Np, N, d);
    stage<KS>(O1, oplane, q, sx, b, h0, Gb, 0, Np, N, d);
    stage<KS>(O2, oplane, dout, sdo, b, h0, Gb, 0, Np, N, d);
    stage_p_rows(Pl, plen, probs, b, H, h0, Gb, 0, Np, N);
    mma_attn::cp_async_commit();
    mma_attn::cp_async_wait<0>();
    __syncthreads();
    relayout_p(Pb, pplane, prow_ld, Pl, plen, probs, b, H, h0, Gb, 0, Np, Np, N);
    __syncthreads();
    for (int item = warp; item < Gb * T; item += nwarps) {
      const int g = item / T, i0 = 16 * (item - g * T);
      const bf16* P = Pb + g * pplane;
      const float2 dd = delta_rows<KS>(O2 + g * oplane, i0, W2 + g * wplane, P, prow_ld, i0,
                                       T, lane);
      if ((lane & 3) == 0) {
        D[g * Np + i0 + gid] = dd.x;
        D[g * Np + i0 + gid + 8] = dd.y;
      }
      dq_rows<KS>(acc[0], O2 + g * oplane, i0, W2 + g * wplane, W1 + g * wplane, P, prow_ld,
                  i0, T, dd.x, dd.y, scale, lane);
      store_rows<KS>(dqkv, sx, b, h0 + g, i0, N, d, acc[0], lane);
    }
    __syncthreads();
    for (int item = warp; item < Gb * T; item += nwarps) {
      const int g = item / T, j0 = 16 * (item - g * T);
      dkdv_rows<KS>(acc[0], acc[1], W1 + g * wplane, W2 + g * wplane, j0, O1 + g * oplane,
                    O2 + g * oplane, Pb + g * pplane, prow_ld, j0, D + g * Np, T, scale, lane);
      store_rows<KS>(dqkv + HD, sx, b, h0 + g, j0, N, d, acc[0], lane);
      store_rows<KS>(dqkv + 2 * HD, sx, b, h0 + g, j0, N, d, acc[1], lane);
    }
  } else {
    // streamed: D of every row, chunk by chunk, with k and v whole
    const int r0 = blockIdx.y * R;
    const int Tc = min(R, Np - r0) / 16;
    stage<KS>(W1, wplane, k, sx, b, h0, Gb, 0, Np, N, d);
    stage<KS>(W2, wplane, v, sx, b, h0, Gb, 0, Np, N, d);
    for (int c0 = 0; c0 < Np; c0 += R) {
      const int nc = min(R, Np - c0);
      stage<KS>(O2, oplane, dout, sdo, b, h0, Gb, c0, nc, N, d);
      stage_p_rows(Pl, plen, probs, b, H, h0, Gb, c0, nc, N);
      mma_attn::cp_async_commit();
      mma_attn::cp_async_wait<0>();
      __syncthreads();
      relayout_p(Pb, pplane, prow_ld, Pl, plen, probs, b, H, h0, Gb, c0, nc, Np, N);
      __syncthreads();
      for (int item = warp; item < Gb * (nc / 16); item += nwarps) {
        const int g = item / (nc / 16), il = 16 * (item - g * (nc / 16));
        const float2 dd = delta_rows<KS>(O2 + g * oplane, il, W2 + g * wplane, Pb + g * pplane,
                                         prow_ld, il, T, lane);
        if ((lane & 3) == 0) {
          D[g * Np + c0 + il + gid] = dd.x;
          D[g * Np + c0 + il + gid + 8] = dd.y;
        }
      }
      __syncthreads();
    }
    // dQ of this chunk's queries
    stage<KS>(O1, oplane, q, sx, b, h0, Gb, r0, Tc * 16, N, d);
    stage<KS>(O2, oplane, dout, sdo, b, h0, Gb, r0, Tc * 16, N, d);
    stage_p_rows(Pl, plen, probs, b, H, h0, Gb, r0, Tc * 16, N);
    mma_attn::cp_async_commit();
    mma_attn::cp_async_wait<0>();
    __syncthreads();
    relayout_p(Pb, pplane, prow_ld, Pl, plen, probs, b, H, h0, Gb, r0, Tc * 16, Np, N);
    __syncthreads();
    for (int item = warp; item < Gb * Tc; item += nwarps) {
      const int g = item / Tc, il = 16 * (item - g * Tc);
      const float* Dg = D + g * Np + r0 + il;
      dq_rows<KS>(acc[0], O2 + g * oplane, il, W2 + g * wplane, W1 + g * wplane, Pb + g * pplane,
                  prow_ld, il, T, Dg[gid], Dg[gid + 8], scale, lane);
      store_rows<KS>(dqkv, sx, b, h0 + g, r0 + il, N, d, acc[0], lane);
    }
    __syncthreads();
    // dK, dV of this chunk's keys: q, dO whole, P's columns of the chunk
    const int pcol_ld = p_ld(R);
    stage<KS>(W1, wplane, q, sx, b, h0, Gb, 0, Np, N, d);
    stage<KS>(W2, wplane, dout, sdo, b, h0, Gb, 0, Np, N, d);
    stage<KS>(O1, oplane, k, sx, b, h0, Gb, r0, Tc * 16, N, d);
    stage<KS>(O2, oplane, v, sx, b, h0, Gb, r0, Tc * 16, N, d);
    mma_attn::cp_async_commit();
    stage_p_cols(Pb, pplane, pcol_ld, probs, b, H, h0, Gb, Np, r0, Tc * 16, N);
    mma_attn::cp_async_wait<0>();
    __syncthreads();
    for (int item = warp; item < Gb * Tc; item += nwarps) {
      const int g = item / Tc, jl = 16 * (item - g * Tc);
      dkdv_rows<KS>(acc[0], acc[1], O1 + g * oplane, O2 + g * oplane, jl, W1 + g * wplane,
                    W2 + g * wplane, Pb + g * pplane, pcol_ld, jl, D + g * Np, T, scale, lane);
      store_rows<KS>(dqkv + HD, sx, b, h0 + g, r0 + jl, N, d, acc[0], lane);
      store_rows<KS>(dqkv + 2 * HD, sx, b, h0 + g, r0 + jl, N, d, acc[1], lane);
    }
  }
}

}  // namespace

}  // namespace dc

// qkv, dqkv: [batch·N, 3·H·d]; dout: [batch·N, H·d]; probs: [batch, H, N, N];
// all bf16, contiguous, qkv, dout and dqkv 16-byte aligned.  d % 8 == 0,
// d <= 128, 1 <= N <= 256 (the Python wrapper checks all of these).
DC_EXPORT int dc_plain_attention_bwd(const void* qkv, const void* dout, const void* probs,
                                     void* dqkv, int batch, int N, int H, int d, float scale,
                                     void* stream) {
  // one instance for each padded head dim, pad16(d) = 16·KS, whole and streamed
  decltype(&dc::plain_attention_bwd_mma_kernel<1, false>) const kernels[][2] = {
      {dc::plain_attention_bwd_mma_kernel<1, false>, dc::plain_attention_bwd_mma_kernel<1, true>},
      {dc::plain_attention_bwd_mma_kernel<2, false>, dc::plain_attention_bwd_mma_kernel<2, true>},
      {dc::plain_attention_bwd_mma_kernel<3, false>, dc::plain_attention_bwd_mma_kernel<3, true>},
      {dc::plain_attention_bwd_mma_kernel<4, false>, dc::plain_attention_bwd_mma_kernel<4, true>},
      {dc::plain_attention_bwd_mma_kernel<5, false>, dc::plain_attention_bwd_mma_kernel<5, true>},
      {dc::plain_attention_bwd_mma_kernel<6, false>, dc::plain_attention_bwd_mma_kernel<6, true>},
      {dc::plain_attention_bwd_mma_kernel<7, false>, dc::plain_attention_bwd_mma_kernel<7, true>},
      {dc::plain_attention_bwd_mma_kernel<8, false>, dc::plain_attention_bwd_mma_kernel<8, true>}};
  const int ks = dc::mma_attn::pad16(d) / 16;
  if (ks < 1 || ks > 8) return (int)cudaErrorInvalidValue;
  const dc::mma_attn_bwd::Plan p = dc::pa_bwd_plan(batch, N, H, d);
  const auto kernel = kernels[ks - 1][p.chunks > 1];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.blocks, p.chunks), p.threads, p.smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)qkv, (const dc::bf16*)dout, (const dc::bf16*)probs, (dc::bf16*)dqkv, N,
      H, d, p.G, p.R, scale);
  return (int)cudaGetLastError();
}
