// Plain attention backward on the tensor cores: the device routine of
// flash_attention_bwd.cu (#16 backward), written so that the fused-qkv
// backward (#14, plain_attention_bwd.cu) and the head-transform backward
// (#6, transform_attention_bwd.cu) can take up its routines.
//
// Per sample b, head h, from q, k, v, O, dO (bf16) and the forward's row
// logsumexp lse (fp32):
//   P    = exp(scale · Q·Kᵀ − lse)     recomputed; exactly 0 at masked keys
//   δ[i] = Σ_c dO[i, c] · O[i, c]       fp32, once per row
//   dP   = dO · Vᵀ
//   dS   = scale · P ∘ (dP − δ)
//   dQ   = dS · K,   dK = dSᵀ · Q,   dV = Pᵀ · dO     one rounding to bf16 each
// with the mask of the forward (mma_attention.cuh): key j is seen by query i
// when j < kv_len and, under the causal mask, j <= i.
//
// Bound on the H100: bytes.  At the image teacher's shape (B=256, H=12, d=64,
// N=50) the function reads q, k, v, O, dO, lse and writes dq, dk, dv, 157.9 MB,
// against 4.9 GFLOP for its five products (31 FLOP/B).  So, as in the forward,
// every operand is read once into shared memory and every intermediate stays
// in registers:
//
// * A block owns one sample and G = ceil(64 / d) heads (fewer where shared
//   memory runs out): 3072 blocks at the image student's shape.  Its q, dO, k
//   and v rows are staged once with 16-byte cp.async copies, rows padded by
//   16 bytes, zero past N and past d's multiple of 16.
// * Every product is mma.sync.m16n8k16 with bf16 operands and fp32 sums, fed
//   by ldmatrix (.trans where the operand is the product's K x N side).
// * dK/dV items: a warp owns 16 keys of one head and walks the queries 16 at a
//   time: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ and dSᵀ in fp32, and dV += Pᵀ·dO,
//   dK += dSᵀ·Q with Pᵀ and dSᵀ taken from the accumulator registers as A
//   fragments (the C fragment of m16n8 is the A fragment of m16n8k16).
// * dQ items: a warp owns 16 queries and recomputes S and dP against the keys
//   it can see: dQ += dS·K.  Seven products for five, and in exchange no
//   atomics, no partial sums and no scratch: two runs give the same bits.
// * Precision: P and dS enter their products as two bf16 operands, hi =
//   bf16(x) and lo = bf16(x − hi), into one fp32 sum, as e does in the forward.
//   The TPU kernel rounds P and dS to bf16 once; on inputs drawn as
//   chip_smoke.py draws them, at B = 256, that single rounding takes the text
//   teacher's dv 2.42e-2 from the fp32 plain version (limit 3e-2), where hi +
//   lo leaves only the final bf16 store (1.75e-2 there, the store of |dv| ~ 8):
//   `python tests/test_torch_attention_bwd_rounding.py 256` prints both, and
//   its tests hold them at B = 2.
// * Masked entries: rows past N get lse = +inf and δ = 0, so P = 0 there; keys
//   past kv_len or after the query (causal) are masked in registers, and a
//   query tile that every row of the key tile sees in full skips the mask.
//   Key tiles past kv_len write exact zeros.
// * Streaming: where one head's four [pad16(N), d] planes do not fit (d >= 96
//   at large N) the grid's second dimension cuts the rows into chunks of R.  A
//   block then stages q and dO whole with its chunk's k and v rows and makes
//   dK, dV of its keys; then k and v whole with its chunk's q and dO rows and
//   makes dQ of its queries.  Otherwise one chunk holds everything, staged once,
//   and the two kinds of items share the warps.
// * The outputs leave from the fragments as 4-byte stores of bf16 pairs; a
//   quad's stores fill 16 contiguous bytes of a row.
#pragma once

#include "mma_attention.cuh"

namespace dc {
namespace mma_attn_bwd {

using mma_attn::kMaxSmem;
using mma_attn::kMaxWarps;
using mma_attn::pad16;
using mma_attn::row_ld;
using mma_attn::Strides;

// Shared memory of a block of G heads: two planes of pad16(N) rows (staged
// whole), two of R rows (the block's own chunk), and lse, δ per row.
__host__ inline size_t smem_bytes(int N, int d, int G, int R) {
  return (size_t)G * (2 * pad16(N) + 2 * R) * row_ld(d) * sizeof(bf16) +
         (size_t)G * 2 * pad16(N) * sizeof(float);
}

// How a call is cut: G heads per block, R rows per chunk, warps, shared
// memory, blocks in x (samples x head groups) and chunks in y.
struct Plan {
  int G, R, threads;
  size_t smem;
  unsigned blocks, chunks;
};

__host__ inline Plan plan(int batch, int N, int H, int d) {
  const int Np = pad16(N);
  int G = (64 + d - 1) / d;
  if (G > H) G = H;
  while (G > 1 && smem_bytes(N, d, G, Np) > kMaxSmem) --G;
  int R = Np;
  while (R > 16 && smem_bytes(N, d, G, R) > kMaxSmem) R -= 16;
  const int chunks = (Np + R - 1) / R;
  R = pad16((Np + chunks - 1) / chunks);     // even chunks
  const int items = chunks == 1 ? 2 * G * (Np / 16) : G * (R / 16);
  const int warps = items < kMaxWarps ? items : kMaxWarps;
  return Plan{G, R, warps * 32, smem_bytes(N, d, G, R),
              (unsigned)batch * ((H + G - 1) / G), (unsigned)chunks};
}

using mma_attn::cp_async16;
using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::ex2;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma_bf16;
using mma_attn::pack2;
using mma_attn::split2;

// Rows row0 .. row0 + nrows - 1 of heads h0 .. h0 + Gb - 1 of a [B, H, N, d]
// view into planes of `plane` elements (row stride LD); zero past N and d.  A
// row's Gb·2KS 16-byte words are padded to 1 << sh slots, so that a slot's
// row and word come from shifts, not divisions.
template <int KS>
__device__ __forceinline__ void stage(bf16* dst, size_t plane, const bf16* __restrict__ src,
                                      Strides st, int b, int h0, int Gb, int row0, int nrows,
                                      int N, int d) {
  constexpr int LD = 16 * KS + 8;
  constexpr int CW = 2 * KS;      // 16-byte words of a staged row
  const int per_row = Gb * CW;
  int sh = 0;
  while ((1 << sh) < per_row) ++sh;
  for (int f = threadIdx.x; f < nrows << sh; f += blockDim.x) {
    const int j = f >> sh, w = f & ((1 << sh) - 1);
    if (w >= per_row) continue;
    const int g = w / CW;
    const int c = (w - g * CW) * 8;
    bf16* p = dst + g * plane + (size_t)j * LD + c;
    const int r = row0 + j;
    if (r < N && c < d)
      cp_async16(p, src + b * st.b + (h0 + g) * st.h + (size_t)r * st.n + c);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
  }
}

// s = (rows ar .. ar + 15 of plane A) · (rows 16·st .. 16·st + 15 of plane
// B)ᵀ, the A fragments loaded one k-step at a time (4 registers live, not 4·KS:
// the dK/dV accumulators at d = 64 take 64 a thread, and two blocks of 8 warps
// an SM leave 128)
template <int KS>
__device__ __forceinline__ void scores_from_planes(const bf16* A, int ar, const bf16* B, int st,
                                                   int lane, float (&s)[2][4]) {
  constexpr int LD = 16 * KS + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* arow = A + (size_t)(ar + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 8;
  const bf16* brow = B + (size_t)(st * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[4], bk[4];
    ldsm_x4(af, arow + ks * 16);
    ldsm_x4(bk, brow + ks * 16);
    mma_bf16(s[0], af, bk[0], bk[1]);
    mma_bf16(s[1], af, bk[2], bk[3]);
  }
}

// acc[16 x 16KS] += X · (rows 16·st .. 16·st + 15 of a staged plane), X the
// 16 x 16 tile whose C fragments are x[0] (columns 0-7) and x[1] (8-15), entered
// as bf16 hi + lo.
template <int KS>
__device__ __forceinline__ void ab_step(float (&acc)[2 * KS][4], const float (&x)[2][4],
                                        const bf16* plane, int st, int lane) {
  constexpr int LD = 16 * KS + 8;
  uint32_t hi[4], lo[4];
  split2(x[0][0], x[0][1], hi[0], lo[0]);
  split2(x[0][2], x[0][3], hi[1], lo[1]);
  split2(x[1][0], x[1][1], hi[2], lo[2]);
  split2(x[1][2], x[1][3], hi[3], lo[3]);
  // matrices: k 0-7 | n 0-7, k 8-15 | n 0-7, k 0-7 | n 8-15, k 8-15 | n 8-15
  const bf16* row = plane + (size_t)(st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, row + dt * 16);
    mma_bf16(acc[2 * dt], hi, bv[0], bv[1]);
    mma_bf16(acc[2 * dt], lo, bv[0], bv[1]);
    mma_bf16(acc[2 * dt + 1], hi, bv[2], bv[3]);
    mma_bf16(acc[2 * dt + 1], lo, bv[2], bv[3]);
  }
}

// The 16 x 16 tile at rows r, columns c of a staged bf16 plane (row stride
// ld), e.g. P (queries x keys), as an A fragment ...
__device__ __forceinline__ void p_frag(uint32_t (&a)[4], const bf16* P, int ld, int r, int c,
                                       int lane) {
  ldsm_x4(a, P + (size_t)(r + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c + (lane >> 4) * 8);
}

// ... and as the A fragment of its transpose Pᵀ (keys x queries).
__device__ __forceinline__ void pt_frag(uint32_t (&a)[4], const bf16* P, int ld, int r, int c,
                                        int lane) {
  ldsm_x4_trans(a, P + (size_t)(r + (lane & 7) + (lane >> 4) * 8) * ld + c +
                       ((lane >> 3) & 1) * 8);
}

// The fp32 values of an A fragment in the layout of the two C fragments of
// its columns 0-7 (x[0]) and 8-15 (x[1]).
__device__ __forceinline__ void frag_values(const uint32_t (&a)[4], float (&x)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t w = a[2 * n + r];
      x[n][2 * r] = __uint_as_float(w << 16);
      x[n][2 * r + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

// acc[16 x 16KS] += A · (rows 16·st .. 16·st + 15 of a staged plane), A a
// ready bf16 fragment: one product (the saved P needs no lo part; an
// operand held as bf16 hi + lo enters as two calls).
template <int KS>
__device__ __forceinline__ void ab_frag(float (&acc)[2 * KS][4], const uint32_t (&a)[4],
                                        const bf16* plane, int st, int lane) {
  constexpr int LD = 16 * KS + 8;
  const bf16* row = plane + (size_t)(st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, row + dt * 16);
    mma_bf16(acc[2 * dt], a, bv[0], bv[1]);
    mma_bf16(acc[2 * dt + 1], a, bv[2], bv[3]);
  }
}

// Rows row0 .. row0 + 15 of head h of a [B, H, N, d] output from a warp's
// fragments, rows below N only.
template <int KS>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, Strides so, int b, int h,
                                           int row0, int N, int d,
                                           const float (&acc)[2 * KS][4], int lane) {
  const int ra = row0 + (lane >> 2), rb = ra + 8;
  bf16* base = out + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    if (c >= d) continue;
    if (ra < N)
      *reinterpret_cast<uint32_t*>(base + (size_t)ra * so.n + c) = pack2(acc[n][0], acc[n][1]);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(base + (size_t)rb * so.n + c) = pack2(acc[n][2], acc[n][3]);
  }
}

// Operands of one call: views as Strides from their own base pointers.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;   // [B, H, N] fp32, contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

// dK, dV of keys j0 .. j0 + 15 of head h: K, V rows at local row jl of the
// own planes; Q, dO whole planes; L (lse·log2 e) and D (δ) of the head.
template <int KS>
__device__ __forceinline__ void dkdv_item(const Args& a, const bf16* Kp, const bf16* Vp,
                                          const bf16* Qp, const bf16* dOp, const float* L,
                                          const float* D, int b, int h, int j0, int jl, int N,
                                          int d, float scale, float scale_log2, int causal,
                                          int kv_len, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int T = pad16(N) / 16;
  // a key past kv_len is seen by no query; under the causal mask key j by
  // queries i >= j only
  const int first = j0 >= kv_len ? T : causal ? j0 / 16 : 0;
  const int ja = j0 + gid, jb = ja + 8;
  for (int it = first; it < T; ++it) {
    const int i0 = it * 16;
    float s[2][4], dp[2][4];
    scores_from_planes<KS>(Kp, jl, Qp, it, lane, s);     // Sᵀ: keys x queries
    scores_from_planes<KS>(Vp, jl, dOp, it, lane, dp);   // dPᵀ
    const bool full = j0 + 16 <= kv_len && (!causal || j0 + 15 <= i0);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + n * 8 + tig * 2 + c;
        const float li = L[i], di = D[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = r * 2 + c;
          const int j = r == 0 ? ja : jb;
          const bool seen = full || (j < kv_len && (!causal || j <= i));
          const float p = seen ? ex2(fmaf(s[n][e], scale_log2, -li)) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - di) * scale;
        }
      }
    }
    ab_step<KS>(dv, s, dOp, it, lane);         // dV += Pᵀ · dO
    ab_step<KS>(dk, dp, Qp, it, lane);         // dK += dSᵀ · Q
  }
  store_rows<KS>(a.dk, a.sdk, b, h, j0, N, d, dk, lane);
  store_rows<KS>(a.dv, a.sdv, b, h, j0, N, d, dv, lane);
}

// dQ of queries i0 .. i0 + 15 of head h: Q, dO rows at local row il of the
// own planes; K, V whole planes.
template <int KS>
__device__ __forceinline__ void dq_item(const Args& a, const bf16* Qp, const bf16* dOp,
                                        const bf16* Kp, const bf16* Vp, const float* L,
                                        const float* D, int b, int h, int i0, int il, int N,
                                        int d, float scale, float scale_log2, int causal,
                                        int kv_len, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  float dq[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const int ra = i0 + gid, rb = ra + 8;
  const float la = L[ra], lb = L[rb], da = D[ra], db = D[rb];
  const int lim_a = causal ? min(kv_len, ra + 1) : kv_len;
  const int lim_b = causal ? min(kv_len, rb + 1) : kv_len;
  // keys this tile can see, and the first `lo` that every row sees
  const int nk = causal ? min(kv_len, min(i0 + 16, N)) : kv_len;
  const int lo = causal ? min(kv_len, i0 + 1) : kv_len;
  for (int st = 0; st * 16 < nk; ++st) {
    float s[2][4], dp[2][4];
    scores_from_planes<KS>(Qp, il, Kp, st, lane, s);     // S
    scores_from_planes<KS>(dOp, il, Vp, st, lane, dp);   // dP
    const bool full = st * 16 + 16 <= lo;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = st * 16 + n * 8 + tig * 2 + (e & 1);
        const bool seen = full || j < (e < 2 ? lim_a : lim_b);
        const float p = seen ? ex2(fmaf(s[n][e], scale_log2, e < 2 ? -la : -lb)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? da : db)) * scale;
      }
    }
    ab_step<KS>(dq, dp, Kp, st, lane);         // dQ += dS · K
  }
  store_rows<KS>(a.dq, a.sdq, b, h, i0, N, d, dq, lane);
}

// The whole function for one block: sample and head group from blockIdx.x,
// row chunk from blockIdx.y (R rows; one chunk when everything fits).
template <int KS>
__device__ __forceinline__ void attention_bwd_block(const Args& a, int N, int H, int d, int G,
                                                    int R, float scale, int causal,
                                                    int kv_len) {
  constexpr int LD = 16 * KS + 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Np = pad16(N);
  const bool whole = gridDim.y == 1;
  const size_t wplane = (size_t)Np * LD, oplane = (size_t)R * LD;
  bf16* W1 = reinterpret_cast<bf16*>(smem);   // [G][Np][LD]: q, then k when streamed
  bf16* W2 = W1 + G * wplane;                 // dO, then v
  bf16* O1 = W2 + G * wplane;                 // [G][R][LD]: k chunk, then q chunk
  bf16* O2 = O1 + G * oplane;                 // v chunk, then dO chunk
  float* L = reinterpret_cast<float*>(O2 + G * oplane);   // [G][Np]
  float* D = L + G * Np;                                    // [G][Np]

  const int ngroups = (H + G - 1) / G;
  const int b = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x - b * ngroups) * G;
  const int Gb = min(G, H - h0);
  const int r0 = blockIdx.y * R;
  const int Rc = min(R, Np - r0);
  const float scale_log2 = scale * kLog2e;

  stage<KS>(W1, wplane, a.q, a.sq, b, h0, Gb, 0, Np, N, d);
  stage<KS>(W2, wplane, a.dout, a.sdo, b, h0, Gb, 0, Np, N, d);
  stage<KS>(O1, oplane, a.k, a.sk, b, h0, Gb, r0, Rc, N, d);
  stage<KS>(O2, oplane, a.v, a.sv, b, h0, Gb, r0, Rc, N, d);
  cp_async_commit();
  // lse in log2 units, +inf past N so that P is 0 on padded query rows
  for (int idx = threadIdx.x; idx < Gb * Np; idx += blockDim.x) {
    const int g = idx / Np, i = idx - g * Np;
    L[idx] = i < N ? a.lse[((size_t)b * H + h0 + g) * N + i] * kLog2e
                   : __int_as_float(0x7f800000);
  }
  cp_async_wait<0>();
  __syncthreads();
  // δ = rowsum(dO ∘ O) in fp32: one thread per row, dO from shared memory
  for (int idx = threadIdx.x; idx < Gb * Np; idx += blockDim.x) {
    const int g = idx / Np, i = idx - g * Np;
    float s = 0.f;
    if (i < N) {
      const bf16* orow = a.o + b * a.so.b + (h0 + g) * a.so.h + (size_t)i * a.so.n;
      const bf16* grow = W2 + g * wplane + (size_t)i * LD;
      for (int c = 0; c < d; c += 8) {
        float x[8], y[8];
        load8(orow + c, x);
        load8(grow + c, y);
#pragma unroll
        for (int t = 0; t < 8; ++t) s = fmaf(x[t], y[t], s);
      }
    }
    D[idx] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int Tc = Rc / 16;
  const int nkv = Gb * Tc;
  // dK / dV items (own planes: the k, v chunk; whole: q, dO), then with one
  // chunk the dQ items (own: q, dO; whole: k, v).  Two loops, so that the
  // registers of one kind of item are free in the other's.
  int item = warp;
  for (; item < nkv; item += nwarps) {
    const int g = item / Tc, t = item - g * Tc;
    dkdv_item<KS>(a, O1 + g * oplane, O2 + g * oplane, W1 + g * wplane, W2 + g * wplane,
                  L + g * Np, D + g * Np, b, h0 + g, r0 + 16 * t, 16 * t, N, d, scale,
                  scale_log2, causal, kv_len, lane);
  }
  if (whole) {
    for (; item < 2 * nkv; item += nwarps) {
      const int g = (item - nkv) / Tc, t = item - nkv - g * Tc;
      dq_item<KS>(a, W1 + g * wplane, W2 + g * wplane, O1 + g * oplane, O2 + g * oplane,
                  L + g * Np, D + g * Np, b, h0 + g, 16 * t, 16 * t, N, d, scale, scale_log2,
                  causal, kv_len, lane);
    }
    return;
  }

  // streamed: k, v whole and this chunk's q, dO rows, then the dQ items
  __syncthreads();
  stage<KS>(W1, wplane, a.k, a.sk, b, h0, Gb, 0, Np, N, d);
  stage<KS>(W2, wplane, a.v, a.sv, b, h0, Gb, 0, Np, N, d);
  stage<KS>(O1, oplane, a.q, a.sq, b, h0, Gb, r0, Rc, N, d);
  stage<KS>(O2, oplane, a.dout, a.sdo, b, h0, Gb, r0, Rc, N, d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (item = warp; item < nkv; item += nwarps) {
    const int g = item / Tc, t = item - g * Tc;
    dq_item<KS>(a, O1 + g * oplane, O2 + g * oplane, W1 + g * wplane, W2 + g * wplane,
                L + g * Np, D + g * Np, b, h0 + g, r0 + 16 * t, 16 * t, N, d, scale,
                scale_log2, causal, kv_len, lane);
  }
}

}  // namespace mma_attn_bwd
}  // namespace dc
