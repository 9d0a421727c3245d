// The backward of head-transform attention on the fused qkv projection (#6).
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_bwd_kernel (behind
// _tf_bwd_call), the save-P backward, and serves the factored route
// (transform_factored.py:_fa_bwd_call, #18): from qkv, the output gradient dO
// and the forward's saved probabilities P (bf16 [B, H, N, N]) it makes dqkv
// (fused, bf16) and the gradients of the two head mixes, dconv_l and dconv_w
// ([H, H] fp32, summed over the batch).
//
// Per sample, with S_g = q_g k_gᵀ, S2_h = scale·Σ_g wl[h,g] S_g,
// P_h = softmax(S2_h) (saved), Pm_h = Σ_g ww[h,g] P_g, o_h = Pm_h v_h:
//   G_h = dO_h v_hᵀ                       dv_h = Pm_hᵀ dO_h
//   dww[h,g] = Σ_{i,j} G_h ∘ P_g          dP_g = Σ_h ww[h,g] G_h
//   δ_g = rowsum(P_g ∘ dP_g),             dS2_g = P_g ∘ (dP_g − δ_g)
//   dwl[h,g] = scale · Σ_{i,j} dS2_h ∘ S_g
//   dS_g = scale · Σ_h wl[h,g] dS2_h      dq_g = dS_g k_g,   dk_g = dS_gᵀ q_g
// at the true N (the TPU kernel's colcat form inflates K and V H times and
// sums heads with one-hot products).
//
// Bound on the H100: bytes.  At the image student's shape (B=256, H=24, d=32,
// N=50) the function reads qkv, dO and P and writes dqkv, 168.4 MB, against
// 8.6 GFLOP (five per-head products and five head mixes or head-pair sums);
// the text student's (H=12, d=64, N=77) 248.4 MB against 13.8 GFLOP.  What
// held the CUDA-core version at 0.03 of that bound was arithmetic: every
// product and mix in fp32 on the CUDA cores, and two fp32 [B, H, N, N]
// planes (Pm and dS) written and read back.  Here every product, mix and
// head-pair sum is mma.sync.m16n8k16 (bf16 operands, fp32 sums), and one
// scratch plane, dS as bf16 hi and lo, goes through device memory.  Four
// launches:
//
// 1. tf_bwd_rows_kernel, a block of 16 warps per (16 query rows, sample): the
//    mixes couple the heads at each (query, key) position, so it holds all H
//    heads of a chunk of 16 keys ([16 x 16] planes per head, so any N fits)
//    and walks the keys.  Warp w owns query row w in the mixes and head-pair
//    sums: a mix is an [H, H] x [H, 16 positions] product (heads on M and K,
//    padded to 16 or 32, the weights as ldmatrix A fragments), a head-pair
//    sum an [H, 16 positions] x [16 positions, H] product whose sums stay in
//    the warp's registers over the chunks and are then added in warp order.
//    δ needs whole rows, so the kernel walks the keys twice.  Pass A: G =
//    dO·vᵀ per head and M[h, g](row) = Σ_j G_h ∘ P_g, which give dww (summed
//    over the rows) and δ_g = Σ_h ww[h, g]·M[h, g] (no dP in pass A).  Pass B:
//    G and S = q·kᵀ again, dP = ww-mix of G, dS2 (in the mix's registers,
//    which are also the A fragments of dwl's head-pair sums), dwl, dS =
//    wl-mix of dS2, stored as bf16 hi and lo planes [B, H, N, pad16(N)].
// 2. tf_bwd_qk_kernel, a block of 8 warps per (sample, 1-2 heads): q, k and dS
//    of its heads staged whole (dS in row chunks where it would not fit),
//    then dq = dS·k and dk = dSᵀ·q, every operand read once.
// 3. tf_bwd_cols_kernel, a block per (16 keys, sample): Pm of its keys from P
//    by one ww mix (no Pm plane in device memory), dv = Pmᵀ·dO over the
//    query chunks.
// 4. reduce_partials (layer_norm.cu, shared with #9) adds the row kernel's
//    per-block dwl / dww partials in a fixed order.
//
// * Latency: a row or column block fills an SM's shared memory, so each
//   hides its copies itself: the next chunk's operands are copied (cp.async)
//   while the current one is worked on, double-buffered where a pass leaves
//   buffers free (pass A; the column kernel) and otherwise issued as soon as a
//   buffer has been read.  P's rows are N·2 bytes, only 2-byte aligned: a
//   chunk row is copied as the three 16-byte words that hold it and read at
//   its offset in the first.  Index arithmetic is shifts where it can be,
//   and the students' head counts (24 heads of 32, 12 of 64) have instances
//   with H fixed at compile time (7% and 11% faster at those shapes on an
//   H100 SXM at 700 W than the instances that take H from the call): the row
//   section of a warp is bound by its instruction count.
// * Shapes: every head of a 16 x 16 tile lives in one block: d % 8 == 0, H <=
//   32 at d <= 32, H <= 16 at d <= 128, N <= 256; the Python wrapper, and the
//   save-P forward before it, refuse the rest.  Staged as planes beside the
//   v and k chunks, the dO and q tiles would take four [H][16][LD] planes
//   with X and Y past a block (296 448 bytes at 32 heads of 32, 343 808 at
//   16 of 128), so the row kernel keeps the two tiles as A fragments in
//   registers: warp w makes G and S of heads w and w + 16 and of no other, so
//   it needs only its own heads' fragments, loaded once from device memory
//   (dO's at the start, q's for pass B).  That leaves 214 528 and 204 544
//   bytes and keeps the mixes within the block (every head's G, S and dS2 in
//   its own X and Y), with no exchange between the blocks of a cluster; it
//   costs registers (the generic 32-head instance at its 128 with 92 bytes
//   spilled).  At the students' shapes, where the planes fit, the fragments
//   were 4% and 2% faster than the planes on an H100 SXM at 700 W (0.4391
//   against 0.4567 ms, 0.5081 against 0.5181).  Past d = 64 the dq / dk
//   kernel takes 64 columns of d a block (grid z), reading dS once per half.
//   dS stays in device memory as bf16 hi / lo planes only.
// * Precision: an fp32 operand of a product enters as two bf16 operands, hi =
//   bf16(x) and lo = bf16(x − hi), into one fp32 sum (G and dS2 into the
//   mixes; G, dS2 and S into the head-pair sums; dS into dq and dk; Pm into
//   dv), as in PRs 6–8; P, dO, q, k, v and the mixes' weights are exact in
//   bf16 and enter once.  `tests/test_torch_transform_attention_bwd_rounding.py`
//   writes this arithmetic out: one bf16 rounding of dS doubles dq's and dk's
//   error against fp32, one of the head-pair sums' operands takes dwl to 0.9
//   of its 6e-3 limit at the text shape.
// * Deterministic: the head-pair sums of a block are added in warp order, the
//   blocks' partials in block order, and nothing is summed by an atomic: two
//   runs give the same bits.
#include "mma_attention_bwd.cuh"

namespace dc {

namespace {

using mma_attn::ldsm_x4;
using mma_attn::mma_bf16;
using mma_attn::pad16;
using mma_attn::Strides;
using mma_attn::split2;
using mma_attn_bwd::ab_frag;
using mma_attn_bwd::p_frag;
using mma_attn_bwd::pt_frag;
using mma_attn_bwd::stage;
using mma_attn_bwd::store_rows;

// The row and column kernels: 16 warps, warp w owning query row w of its 16.
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
// fp32 chunk planes X, Y: a head's [16 x 16] with rows of 24 and planes of
// 392 floats (≡ 8 mod 32 banks, so that 16 heads' rows fall apart).
constexpr int kXL = 24;
constexpr int kXP = 16 * kXL + 8;
// bf16 chunk planes (P's words, hi / lo planes): rows of 24, planes of 392.
constexpr int kBL = 24;
constexpr int kBP = 16 * kBL + 8;

// W1, W2 (HP x HP, row stride HP + 8, bf16) with W[r][c] = w[r·H + c] or, with
// `transpose`, w[c·H + r]; zero past H.  Each thread's loads of both are in
// flight together.
__device__ __forceinline__ void load_mixes(bf16* W1, const bf16* __restrict__ w1, bf16* W2,
                                           const bf16* __restrict__ w2, int H, int HP,
                                           bool transpose) {
  for (int base = threadIdx.x; base < HP * HP; base += 2 * blockDim.x) {
    bf16 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + (u >> 1) * blockDim.x;
      const int r = idx / HP, c = idx - r * HP;
      const bf16* w = u & 1 ? w2 : w1;
      v[u] = idx < HP * HP && r < H && c < H && w != nullptr
                 ? w[transpose ? c * H + r : r * H + c] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + (u >> 1) * blockDim.x;
      bf16* W = u & 1 ? W2 : W1;
      if (idx < HP * HP && W != nullptr) W[(idx / HP) * (HP + 8) + idx % HP] = v[u];
    }
  }
}

// A fragment (rows 16·mt, columns 16·kt) of a staged [HP x HP] bf16 matrix.
__device__ __forceinline__ void w_frag(uint32_t (&a)[4], const bf16* W, int HP, int mt, int kt,
                                       int lane) {
  ldsm_x4(a, W + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (HP + 8) + kt * 16 +
                 (lane >> 4) * 8);
}

// A warp's 16 x 16 C fragments s into a [16 x 16] fp32 plane (rows of kXL).
__device__ __forceinline__ void store_tile(float* T, const float (&s)[2][4], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    *reinterpret_cast<float2*>(T + gid * kXL + n * 8 + 2 * tig) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(T + (gid + 8) * kXL + n * 8 + 2 * tig) =
        make_float2(s[n][2], s[n][3]);
  }
}

// P's rows are N·2 bytes, so a row of P is only 2-byte aligned.  The 16
// elements P[b, g, r, j0 .. j0 + 15] of a chunk row lie in the three 16-byte
// words from the one holding the first, which cp.async copies into the row's
// 24-element slot of a staging plane; a reader finds element j of the row at
// slot + p_lead + j.  P must be 16-byte aligned (the Python wrapper checks).
__device__ __forceinline__ size_t p_elem(int b, int H, int g, int r, int N, int j0) {
  return (((size_t)b * H + g) * N + r) * N + j0;
}

__device__ __forceinline__ int p_lead(int b, int H, int g, int r, int N, int j0) {
  // mod 8 survives the wraparound of 32-bit arithmetic
  return (int)((((unsigned)b * H + g) * N + r) * (unsigned)N + j0) & 7;
}

// cp.async of the first `bytes` (0 .. 16) bytes of a 16-byte word, the rest
// of the destination word zero-filled: nothing past `bytes` is read.
__device__ __forceinline__ void cp_async_part(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma_attn::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The words of chunk rows (g, r0 + i) into slots g·gs + i·kBL of `dst`, for
// rows r0 + i < N and the pairs (g, i) this thread takes from `first` in
// steps of `step` over H·rows (rows 16, or 1), three words a pair: a word that
// starts past P's last element is not read (nothing it holds is needed), and
// of the word that holds P's last element only P's part is read.
__device__ __forceinline__ void p_words(bf16* dst, int gs, const bf16* __restrict__ probs, int b,
                                        int H, int N, int r0, int rows, int j0, int first,
                                        int step, size_t total) {
  for (int pair = first; pair < H * rows; pair += step) {
    const int g = rows == 1 ? pair : pair >> 4, i = rows == 1 ? 0 : pair & 15;
    if (r0 + i >= N) continue;
    const size_t e = p_elem(b, H, g, r0 + i, N, j0) & ~(size_t)7;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const size_t w = e + 8 * t;
      if (w + 8 <= total)
        mma_attn::cp_async16(dst + g * gs + i * kBL + 8 * t, probs + w);
      else if (w < total)
        cp_async_part(dst + g * gs + i * kBL + 8 * t, probs + w, (int)(total - w) * 2);
    }
  }
}

// Two staged elements of P as one bf16 pair (the first in the low half):
// row slot `r`, elements j and j + 1 past the lead, zero where `ok` fails.
__device__ __forceinline__ uint32_t p_pair(const bf16* r, int j, bool ok0, bool ok1) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(r);
  return (ok0 ? (uint32_t)u[j] : 0u) | ((ok1 ? (uint32_t)u[j + 1] : 0u) << 16);
}

// m[mt][nt] = Σ_h W[g][h] · X[h][row, pos] for g = 16·mt + (rows of the C
// fragment), pos = 8·nt + (its columns): the weights' A fragments from the
// staged W (M = g, K = h), X's values (K = h, N = pos) entered as bf16 hi + lo.
template <int HPW>
__device__ __forceinline__ void mix_row(float (&m)[HPW][2][4], const bf16* W, const float* X,
                                        int row, int H, int lane) {
  const int gid = lane >> 2, tig = lane & 3, HP = 16 * HPW;
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) m[mt][nt][0] = m[mt][nt][1] = m[mt][nt][2] = m[mt][nt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < HPW; ++kt) {
    uint32_t a[HPW][4];
#pragma unroll
    for (int mt = 0; mt < HPW; ++mt) w_frag(a[mt], W, HP, mt, kt, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = kt * 16 + 2 * tig + (r & 1) + (r >> 1) * 8;
        x[r] = h < H ? X[h * kXP + row * kXL + nt * 8 + gid] : 0.f;
      }
      uint32_t hi0, lo0, hi1, lo1;
      split2(x[0], x[1], hi0, lo0);
      split2(x[2], x[3], hi1, lo1);
#pragma unroll
      for (int mt = 0; mt < HPW; ++mt) {
        mma_bf16(m[mt][nt], a[mt], hi0, hi1);
        mma_bf16(m[mt][nt], a[mt], lo0, lo1);
      }
    }
  }
}

// The A fragments (hi, lo) of X's heads 16·mt .. (M) at the 16 positions of
// a row (K): X[h][row][0 .. 15].
__device__ __forceinline__ void heads_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* X,
                                           int row, int mt, int H, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = mt * 16 + gid + (r & 1) * 8;
    float2 v = make_float2(0.f, 0.f);
    if (h < H)
      v = *reinterpret_cast<const float2*>(X + h * kXP + row * kXL + (r >> 1) * 8 + 2 * tig);
    split2(v.x, v.y, hi[r], lo[r]);
  }
}

// acc[mt][nt][.] (h = 16·mt + rows, g = 8·nt + columns) += Σ_pos X[h][row,
// pos] · P[g][row, pos] over the row's 16 positions, P (exact in bf16) from
// its staged words (slots PW[g·kBP + row·kBL]); `rowok`: the row is below N,
// `nj`: keys of the chunk below N.  H <= 8·NP (the row kernel's NP = 2·HPW).
template <int HPW, int NP>
__device__ __forceinline__ void pair_sums_p(float (&acc)[HPW][NP][4], const float* X,
                                            const bf16* PW, int row, int H, int b, int r, int N,
                                            int j0, bool rowok, int nj, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t bp[NP][2];
#pragma unroll
  for (int nt = 0; nt < NP; ++nt) {
    const int g = nt * 8 + gid;
    const bool ok = rowok && g < H;
    const bf16* slot = PW + g * kBP + row * kBL + (ok ? p_lead(b, H, g, r, N, j0) : 0);
    const int j = 2 * tig;
    bp[nt][0] = p_pair(slot, j, ok && j < nj, ok && j + 1 < nj);
    bp[nt][1] = p_pair(slot, j + 8, ok && j + 8 < nj, ok && j + 9 < nj);
  }
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt) {
    if (mt * 16 >= H) break;
    uint32_t hi[4], lo[4];
    heads_frag(hi, lo, X, row, mt, H, lane);
#pragma unroll
    for (int nt = 0; nt < NP; ++nt) {
      mma_bf16(acc[mt][nt], hi, bp[nt][0], bp[nt][1]);
      mma_bf16(acc[mt][nt], lo, bp[nt][0], bp[nt][1]);
    }
  }
}

// acc += A · Y[g][row][0 .. 15]ᵀ with A given as fragments (hi, lo) per mt and
// Y fp32 (hi·hi + lo·hi + hi·lo).
template <int HPW, int NP>
__device__ __forceinline__ void pair_sums_y(float (&acc)[HPW][NP][4],
                                            const uint32_t (&ahi)[HPW][4],
                                            const uint32_t (&alo)[HPW][4], const float* Y,
                                            int row, int H, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NP; ++nt) {
    const int g = nt * 8 + gid;
    float2 y0 = make_float2(0.f, 0.f), y1 = y0;
    if (g < H) {
      const float* y = Y + g * kXP + row * kXL + 2 * tig;
      y0 = *reinterpret_cast<const float2*>(y);
      y1 = *reinterpret_cast<const float2*>(y + 8);
    }
    uint32_t bh0, bl0, bh1, bl1;
    split2(y0.x, y0.y, bh0, bl0);
    split2(y1.x, y1.y, bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < HPW; ++mt) {
      mma_bf16(acc[mt][nt], ahi[mt], bh0, bh1);
      mma_bf16(acc[mt][nt], alo[mt], bh0, bh1);
      mma_bf16(acc[mt][nt], ahi[mt], bl0, bl1);
    }
  }
}

// out[h·H + g] = alpha · Σ_w (warp w's acc), in warp order: each warp leaves
// its fragments in red ([kWarps][16·HPW][16·HPW]), then the block adds them.
// Called by every thread; red must be free, and is free again on return.
template <int HPW, int NP>
__device__ __forceinline__ void reduce_pair_sums(const float (&acc)[HPW][NP][4],
                                                 float* red, float* __restrict__ out, int H,
                                                 float alpha) {
  constexpr int S = 16 * HPW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* mine = red + warp * S * S;
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(mt * 16 + gid + (e >> 1) * 8) * S + nt * 8 + 2 * tig + (e & 1)] = acc[mt][nt][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * H; idx += blockDim.x) {
    const int h = idx / H, g = idx - h * H;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * S * S + h * S + g];
    out[idx] = alpha * s;
  }
  __syncthreads();
}

// dS hi and lo of the tile's rows, from their slots in shared memory (row
// (g, i): hi at g·2kXP + i·2kXL, lo kXL further) to [B, H, N, Np] in 16-byte
// words: rows i0 + i < N, keys j0 .. j0 + 15.
__device__ __forceinline__ void store_ds(const bf16* DS, bf16* __restrict__ ds_hi,
                                         bf16* __restrict__ ds_lo, int b, int H, int N, int Np,
                                         int i0, int j0) {
  for (int idx = threadIdx.x; idx < H * 64; idx += blockDim.x) {
    const int g = idx >> 6, i = (idx >> 2) & 15, lo = (idx >> 1) & 1, w = idx & 1;
    if (i0 + i >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(DS + g * 2 * kXP + i * 2 * kXL +
                                                    lo * kXL + w * 8);
    *reinterpret_cast<uint4*>((lo ? ds_lo : ds_hi) + (((size_t)b * H + g) * N + i0 + i) * Np +
                              j0 + w * 8) = v;
  }
}

// Shared memory of the row kernel: X and Y (whose space also holds the warps'
// head-pair sums between the passes), δ, P's words, the v and k chunks, wwᵀ
// and wlᵀ.
__host__ __device__ inline size_t rows_xy_bytes(int H, int HPW) {
  const size_t xy = (size_t)2 * H * kXP * 4, red = (size_t)kWarps * (16 * HPW) * (16 * HPW) * 4;
  return xy > red ? xy : red;
}

__host__ inline size_t rows_smem(int H, int d, int HPW) {
  const int LD = pad16(d) + 8, HP = pad16(H);
  return rows_xy_bytes(H, HPW) + (size_t)16 * HP * 4 + (size_t)H * kBP * 2 +
         (size_t)H * 2 * 16 * LD * 2 + (size_t)2 * HP * (HP + 8) * 2;
}

// The A fragments of query rows i0 .. i0 + 15 of head g, straight from the
// [B·N, ld] bf16 rows (the head's columns g·d ..): zero past N and past d.
template <int KS>
__device__ __forceinline__ void tile_frags(uint32_t (&a)[KS][4], const bf16* __restrict__ src,
                                           size_t ld, int b, int N, int i0, int g, int d,
                                           int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + gid + (r & 1) * 8, c = ks * 16 + (r >> 1) * 8 + 2 * tig;
      a[ks][r] = i < N && c < d ? __ldg(reinterpret_cast<const unsigned int*>(
                                      src + ((size_t)b * N + i) * ld + g * d + c))
                                : 0u;
    }
}

// s = A · (rows 16·st .. 16·st + 15 of a staged plane)ᵀ, A given as fragments.
template <int KS>
__device__ __forceinline__ void scores_from_frags(const uint32_t (&a)[KS][4], const bf16* B,
                                                  int lane, float (&s)[2][4]) {
  constexpr int LD = 16 * KS + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* brow = B + (size_t)((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bk[4];
    ldsm_x4(bk, brow + ks * 16);
    mma_bf16(s[0], a[ks], bk[0], bk[1]);
    mma_bf16(s[1], a[ks], bk[2], bk[3]);
  }
}

// The row kernel: a block per (tile of 16 query rows, sample); warp w owns row
// w of the tile in the mixes and head-pair sums.  Pass A, which uses neither
// the k chunk nor Y, keeps two chunks in flight: v in Cv and Ck, P's words in
// P and Y, the next chunk's copies issued before the current chunk is worked
// on.  Pass B copies the next chunk's v and k as soon as the products have
// read them, and a warp its next P row after its last read of it.  The dO and
// q tiles are not staged: warp w makes G and S of heads w, w + 16 from their A
// fragments, held in its registers (dO's from the start, q's from pass B), and
// the head-pair sums span NP = 2·HPW tiles of 8 heads.
template <int KS, int HPW, int NH>
__global__ void __launch_bounds__(kThreads, 1)
tf_bwd_rows_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wl,
                   const bf16* __restrict__ ww, const bf16* __restrict__ dout,
                   const bf16* __restrict__ probs, bf16* __restrict__ ds_hi,
                   bf16* __restrict__ ds_lo, float* __restrict__ partial, int N, int H_, int d,
                   float scale) {
  const int H = NH > 0 ? NH : H_;
  constexpr int LD = 16 * KS + 8;
  constexpr int PL = 16 * LD;             // a head's 16 staged rows
  constexpr int HP = 16 * HPW;
  constexpr int NP = 2 * HPW;                       // tiles of 8 heads in the pair sums
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);        // [H][kXP]: G, then dS2
  float* Y = X + H * kXP;                           // [H][kXP]: S, then dS hi | lo
  float* red = X;                                   // between the passes: head-pair sums
  float* Dl = reinterpret_cast<float*>(smem + rows_xy_bytes(H, HPW));   // δ [16][HP]
  bf16* P = reinterpret_cast<bf16*>(Dl + 16 * HP);  // [H][kBP]: P's words
  bf16* Cv = P + H * kBP;                           // [H][16][LD]: v rows of the chunk
  bf16* Ck = Cv + H * PL;                           // k rows of the chunk
  bf16* WWT = Ck + H * PL;                          // [HP][HP + 8]: wwᵀ
  bf16* WLT = WWT + HP * (HP + 8);                  // wlᵀ

  const int Np = pad16(N), T = Np / 16;
  const int b = blockIdx.y, i0 = blockIdx.x * 16;
  const size_t HD = (size_t)H * d;
  const size_t total = (size_t)gridDim.y * H * N * N;
  const Strides sx{(size_t)N * 3 * HD, (size_t)d, 3 * HD};
  const bf16* q = qkv;
  const bf16* k = qkv + HD;
  const bf16* v = qkv + 2 * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = warp, r = i0 + row;
  const bool rowok = r < N;
  const int HH = H * H;
  float* part = partial + ((size_t)b * gridDim.x + blockIdx.x) * 2 * HH;  // dwl, then dww

  // the fragments of the warp's heads' dO rows, the first chunk's v and P
  uint32_t da[HPW][KS][4], qa[HPW][KS][4];
#pragma unroll
  for (int it = 0; it < HPW; ++it)
    if (warp + it * kWarps < H) tile_frags<KS>(da[it], dout, HD, b, N, i0, warp + it * kWarps, d,
                                               lane);
  stage<KS>(Cv, PL, v, sx, b, 0, H, 0, 16, N, d);
  p_words(P, kBP, probs, b, H, N, i0, 16, 0, threadIdx.x, blockDim.x, total);
  mma_attn::cp_async_commit();
  load_mixes(WWT, ww, WLT, wl, H, HP, true);

  // pass A: M[h, g](row) = Σ_j G_h ∘ P_g over the row's keys, in the warp's
  // registers (rows h = 16·mt + gid + 8·(e / 2), columns g = 8·nt + 2·tig + e % 2)
  float acc[HPW][NP][4];
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NP; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;
  for (int jt = 0; jt < T; ++jt) {
    const int j0 = jt * 16;
    bf16* const vc = jt & 1 ? Ck : Cv;                       // this chunk's v and P
    bf16* const pc = jt & 1 ? reinterpret_cast<bf16*>(Y) : P;
    if (jt + 1 < T) {
      stage<KS>(jt & 1 ? Cv : Ck, PL, v, sx, b, 0, H, j0 + 16, 16, N, d);
      p_words(jt & 1 ? P : reinterpret_cast<bf16*>(Y), kBP, probs, b, H, N, i0, 16, j0 + 16,
              threadIdx.x, blockDim.x, total);
    }
    mma_attn::cp_async_commit();
    mma_attn::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int it = 0; it < HPW; ++it) {                       // G_g, heads g ≡ warp
      const int g = warp + it * kWarps;
      if (g >= H) continue;
      float s[2][4];
      scores_from_frags<KS>(da[it], vc + g * PL, lane, s);
      store_tile(X + g * kXP, s, lane);
    }
    __syncthreads();
    pair_sums_p<HPW, NP>(acc, X, pc, row, H, b, r, N, j0, rowok, N - j0, lane);
    __syncthreads();
  }
  // pass B's first chunk, copied while δ and dww are made
  stage<KS>(Cv, PL, v, sx, b, 0, H, 0, 16, N, d);
  stage<KS>(Ck, PL, k, sx, b, 0, H, 0, 16, N, d);
  p_words(P, kBP, probs, b, H, N, i0, 16, 0, threadIdx.x, blockDim.x, total);
  mma_attn::cp_async_commit();
#pragma unroll
  for (int it = 0; it < HPW; ++it)
    if (warp + it * kWarps < H) tile_frags<KS>(qa[it], q, 3 * HD, b, N, i0, warp + it * kWarps, d,
                                               lane);
  // δ_g(row) = Σ_h ww[h, g] · M[h, g](row): the lane's rows h, then the warp's
  // lanes of one column (xor over gid)
#pragma unroll
  for (int nt = 0; nt < NP; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = nt * 8 + 2 * tig + c;
      float t = 0.f;
#pragma unroll
      for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = mt * 16 + gid + 8 * half;
          t = fmaf(__bfloat162float(WWT[g * (HP + 8) + h]), acc[mt][nt][2 * half + c], t);
        }
      t += __shfl_xor_sync(0xffffffffu, t, 4);
      t += __shfl_xor_sync(0xffffffffu, t, 8);
      t += __shfl_xor_sync(0xffffffffu, t, 16);
      if (gid == 0 && g < HP) Dl[row * HP + g] = t;
    }
  reduce_pair_sums<HPW, NP>(acc, red, part + HH, H, 1.0f);               // dww
  float dl[HPW][2];
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt) {
    dl[mt][0] = Dl[row * HP + mt * 16 + gid];
    dl[mt][1] = Dl[row * HP + mt * 16 + gid + 8];
  }

  // pass B: dS2, dwl and dS (to device memory as hi + lo)
#pragma unroll
  for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NP; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;
  bf16* DS = reinterpret_cast<bf16*>(Y);     // row (g, r): hi at g·2kXP + r·2kXL, lo + kXL
  for (int jt = 0; jt < T; ++jt) {
    const int j0 = jt * 16, nj = N - j0;
    const bool more = jt + 1 < T;
    mma_attn::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int it = 0; it < HPW; ++it) {                       // G_g and S_g, heads g ≡ warp
      const int g = warp + it * kWarps;
      if (g >= H) continue;
      float s[2][4];
      scores_from_frags<KS>(da[it], Cv + g * PL, lane, s);
      store_tile(X + g * kXP, s, lane);
      scores_from_frags<KS>(qa[it], Ck + g * PL, lane, s);
      store_tile(Y + g * kXP, s, lane);
    }
    __syncthreads();
    if (more) {
      stage<KS>(Cv, PL, v, sx, b, 0, H, j0 + 16, 16, N, d);
      stage<KS>(Ck, PL, k, sx, b, 0, H, j0 + 16, 16, N, d);
    }
    float m[HPW][2][4];
    mix_row<HPW>(m, WWT, X, row, H, lane);                              // dP
    // dS2 = P ∘ (dP − δ) in the mix's C fragments: into X for the wl mix, and
    // as the A fragments (hi, lo) of dwl's head-pair sums (rows h, 16 keys)
    uint32_t ahi[HPW][4], alo[HPW][4];
#pragma unroll
    for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int g = mt * 16 + gid + half * 8;
        const bool ok = rowok && g < H;
        const bf16* slot = P + g * kBP + row * kBL + (ok ? p_lead(b, H, g, r, N, j0) : 0);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = nt * 8 + 2 * tig;
          const uint32_t pp = p_pair(slot, c, ok && c < nj, ok && c + 1 < nj);
          const float dd = dl[mt][half];
          const float s0 = __uint_as_float(pp << 16) * (m[mt][nt][2 * half] - dd);
          const float s1 = __uint_as_float(pp & 0xffff0000u) * (m[mt][nt][2 * half + 1] - dd);
          if (g < H) *reinterpret_cast<float2*>(X + g * kXP + row * kXL + c) = make_float2(s0, s1);
          split2(s0, s1, ahi[mt][nt * 2 + half], alo[mt][nt * 2 + half]);
        }
      }
    __syncwarp();
    if (more) p_words(P + row * kBL, kBP, probs, b, H, N, r, 1, j0 + 16, lane, 32, total);
    mma_attn::cp_async_commit();
    pair_sums_y<HPW, NP>(acc, ahi, alo, Y, row, H, lane);               // dwl / scale
    mix_row<HPW>(m, WLT, X, row, H, lane);                              // dS / scale
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int g = mt * 16 + gid + half * 8;
          if (g >= H) continue;
          uint32_t hi, lo;
          split2(scale * m[mt][nt][2 * half], scale * m[mt][nt][2 * half + 1], hi, lo);
          bf16* t = DS + g * 2 * kXP + row * 2 * kXL + nt * 8 + 2 * tig;
          *reinterpret_cast<uint32_t*>(t) = hi;
          *reinterpret_cast<uint32_t*>(t + kXL) = lo;
        }
    __syncthreads();
    store_ds(DS, ds_hi, ds_lo, b, H, N, Np, i0, j0);
  }
  __syncthreads();
  reduce_pair_sums<HPW, NP>(acc, red, part, H, scale);                   // dwl
}

// The dq / dk kernel: a block of kQkWarps warps per (sample, G heads) stages
// the heads' q and k rows whole and dS hi / lo in chunks of R query rows
// (R = pad16(N) where it fits, so dS is read once), and makes dq of each
// chunk's query tiles and dk of every key tile, whose accumulators stay in
// registers across the chunks: a warp owns up to two (head, key tile) items.
// Past d = 64 the grid's third dimension takes 64 columns of d a block (the
// KS = 4 instance), each reading dS again: two items' dk of 128 columns would
// take 128 registers a thread.
constexpr int kQkWarps = 8;

struct QkPlan {
  int G, R;
  size_t smem;
};

__host__ inline size_t qk_bytes(int N, int d, int G, int R) {
  const int Np = pad16(N), LD = pad16(d) + 8;
  return (size_t)G * (2 * Np * LD + 2 * R * (Np + 8)) * 2;
}

// G = 2 heads where their dk items fit the warps' slots and two blocks fit an
// SM, else 1 with the largest chunk that fits; G = 0 where nothing fits (more
// than 2·kQkWarps key tiles, or N past what shared memory holds).
__host__ inline QkPlan qk_plan(int N, int H, int d) {
  const int Np = pad16(N), T = Np / 16;
  if (H >= 2 && 2 * T <= 2 * kQkWarps && qk_bytes(N, d, 2, Np) <= mma_attn::kMaxSmem / 2)
    return QkPlan{2, Np, qk_bytes(N, d, 2, Np)};
  if (T > 2 * kQkWarps) return QkPlan{0, 0, 0};
  int R = Np;
  while (R > 16 && qk_bytes(N, d, 1, R) > mma_attn::kMaxSmem) R -= 16;
  if (qk_bytes(N, d, 1, R) > mma_attn::kMaxSmem) return QkPlan{0, 0, 0};
  return QkPlan{1, R, qk_bytes(N, d, 1, R)};
}

template <int KS>
__global__ void __launch_bounds__(kQkWarps * 32, 2)
tf_bwd_qk_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ ds_hi,
                 const bf16* __restrict__ ds_lo, bf16* __restrict__ dqkv, int N, int H, int d,
                 int G, int R) {
  constexpr int LD = 16 * KS + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Np = pad16(N), T = Np / 16, dl = Np + 8;
  const size_t wplane = (size_t)Np * LD, dplane = (size_t)R * dl;
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [G][Np][LD]: q rows
  bf16* Ks = Qs + G * wplane;                 // k rows
  bf16* D = Ks + G * wplane;                  // [G][hi, lo][R][Np + 8]: dS rows of the chunk
  const int b = blockIdx.x, h0 = blockIdx.y * G, Gb = min(G, H - h0);
  const size_t HD = (size_t)H * d;
  const Strides sx{(size_t)N * 3 * HD, (size_t)d, 3 * HD};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the block's columns of d: c0 .. c0 + dn - 1
  const int c0 = blockIdx.z * 16 * KS, dn = min(16 * KS, d - c0);
  stage<KS>(Qs, wplane, qkv + c0, sx, b, h0, Gb, 0, Np, N, dn);
  stage<KS>(Ks, wplane, qkv + HD + c0, sx, b, h0, Gb, 0, Np, N, dn);
  float dk[2][2 * KS][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      dk[sl][n][0] = dk[sl][n][1] = dk[sl][n][2] = dk[sl][n][3] = 0.f;
  // a dS row is Np / 8 words, padded to 1 << wsh slots
  const int words = Np / 8;
  int wsh = 0;
  while ((1 << wsh) < words) ++wsh;
  for (int r0 = 0; r0 < Np; r0 += R) {
    const int Rc = min(R, Np - r0);
    for (int gl = 0; gl < 2 * Gb; ++gl) {                   // (head, hi / lo) planes
      const bf16* src = ((gl & 1) ? ds_lo : ds_hi) + ((size_t)b * H + h0 + (gl >> 1)) * N * Np;
      for (int f = threadIdx.x; f < Rc << wsh; f += blockDim.x) {
        const int i = f >> wsh, w = f & ((1 << wsh) - 1);
        if (w >= words) continue;
        bf16* dst = D + (size_t)gl * dplane + (size_t)i * dl + w * 8;
        if (r0 + i < N)
          mma_attn::cp_async16(dst, src + (size_t)(r0 + i) * Np + w * 8);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    mma_attn::cp_async_commit();
    mma_attn::cp_async_wait<0>();
    __syncthreads();
    // dq of the chunk's query tiles: dq = dS · k over every key tile
    for (int item = warp; item < Gb * (Rc / 16); item += kQkWarps) {
      const int g = item / (Rc / 16), t = item - g * (Rc / 16);
      float acc[2 * KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int kt = 0; kt < T; ++kt) {
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          uint32_t a[4];
          p_frag(a, D + (size_t)(2 * g + lo) * dplane, dl, t * 16, kt * 16, lane);
          ab_frag<KS>(acc, a, Ks + g * wplane, kt, lane);
        }
      }
      store_rows<KS>(dqkv + c0, sx, b, h0 + g, r0 + t * 16, N, dn, acc, lane);
    }
    // dk of the warp's (head, key tile) items += dSᵀ · q over the chunk's queries
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int item = warp + sl * kQkWarps;
      if (item >= Gb * T) continue;
      const int g = item / T, jt = item - g * T;
      for (int t = 0; t < Rc / 16; ++t) {
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          uint32_t a[4];
          pt_frag(a, D + (size_t)(2 * g + lo) * dplane, dl, t * 16, jt * 16, lane);
          ab_frag<KS>(dk[sl], a, Qs + g * wplane, r0 / 16 + t, lane);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int item = warp + sl * kQkWarps;
    if (item >= Gb * T) continue;
    const int g = item / T, jt = item - g * T;
    store_rows<KS>(dqkv + HD + c0, sx, b, h0 + g, jt * 16, N, dn, dk[sl], lane);
  }
}

// Shared memory of the column kernel: two dO chunks, two planes of P's words,
// Pm hi / lo, ww.
__host__ inline size_t cols_smem(int H, int d) {
  const int LD = pad16(d) + 8, HP = pad16(H);
  return (size_t)H * (2 * 16 * LD + 4 * kBP) * 2 + (size_t)HP * (HP + 8) * 2;
}

// The column kernel: dv_h = Pm_hᵀ · dO_h with Pm = Σ_g ww[h, g] P_g made here, a
// block per (tile of 16 keys, sample), walking the queries 16 at a time with
// the next chunk's dO and P in flight; warp w owns query row w of each chunk in
// the mix (M = h, K = g, N = keys) and heads w, w + 16 in dv.
template <int KS, int HPW, int NH>
__global__ void __launch_bounds__(kThreads, 1)
tf_bwd_cols_kernel(const bf16* __restrict__ ww, const bf16* __restrict__ dout,
                   const bf16* __restrict__ probs, bf16* __restrict__ dqkv, int N, int H_,
                   int d) {
  const int H = NH > 0 ? NH : H_;
  constexpr int LD = 16 * KS + 8;
  constexpr int PL = 16 * LD;
  constexpr int HP = 16 * HPW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Cd = reinterpret_cast<bf16*>(smem);   // [2][H][16][LD]: dO rows of the chunks
  bf16* PW = Cd + 2 * H * PL;                 // [2][H][kBP]: P's words [head][query]
  bf16* MH = PW + 2 * H * kBP;                // [H][kBP]: Pm hi [query][key]
  bf16* ML = MH + H * kBP;                    // Pm lo
  bf16* W = ML + H * kBP;                     // [HP][HP + 8]: ww

  const int Np = pad16(N), T = Np / 16;
  const int b = blockIdx.y, j0 = blockIdx.x * 16, nj = N - j0;
  const size_t HD = (size_t)H * d;
  const size_t total = (size_t)gridDim.y * H * N * N;
  const Strides sx{(size_t)N * 3 * HD, (size_t)d, 3 * HD};
  const Strides sdo{(size_t)N * HD, (size_t)d, HD};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = warp;

  stage<KS>(Cd, PL, dout, sdo, b, 0, H, 0, 16, N, d);
  p_words(PW, kBP, probs, b, H, N, 0, 16, j0, threadIdx.x, blockDim.x, total);
  mma_attn::cp_async_commit();
  load_mixes(W, ww, nullptr, nullptr, H, HP, false);
  float dv[HPW][2 * KS][4];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      dv[hh][n][0] = dv[hh][n][1] = dv[hh][n][2] = dv[hh][n][3] = 0.f;

  for (int it = 0; it < T; ++it) {
    const int i0 = it * 16, r = i0 + row, cur = it & 1;
    if (it + 1 < T) {
      stage<KS>(Cd + (cur ^ 1) * H * PL, PL, dout, sdo, b, 0, H, i0 + 16, 16, N, d);
      p_words(PW + (cur ^ 1) * H * kBP, kBP, probs, b, H, N, i0 + 16, 16, j0, threadIdx.x,
              blockDim.x, total);
    }
    mma_attn::cp_async_commit();
    mma_attn::cp_async_wait<1>();
    __syncthreads();
    // Pm[h][row][j] = Σ_g ww[h][g] · P[g][row][j]: P's pairs (g, g + 1) at key
    // gid of each 8 as B fragments, from the staged words
    {
      const bf16* pw = PW + cur * H * kBP + row * kBL;
      float m[HPW][2][4];
#pragma unroll
      for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          m[mt][nt][0] = m[mt][nt][1] = m[mt][nt][2] = m[mt][nt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < HPW; ++kt) {
        unsigned short e[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int g = kt * 16 + 2 * tig + (q & 1) + (q >> 1) * 8;
          const bool ok = r < N && g < H;
          const unsigned short* u = reinterpret_cast<const unsigned short*>(
              pw + g * kBP + (ok ? p_lead(b, H, g, r, N, j0) : 0));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            e[q][nt] = ok && nt * 8 + gid < nj ? u[nt * 8 + gid] : (unsigned short)0;
        }
#pragma unroll
        for (int mt = 0; mt < HPW; ++mt) {
          uint32_t a[4];
          w_frag(a, W, HP, mt, kt, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_bf16(m[mt][nt], a, (uint32_t)e[0][nt] | ((uint32_t)e[1][nt] << 16),
                     (uint32_t)e[2][nt] | ((uint32_t)e[3][nt] << 16));
        }
      }
#pragma unroll
      for (int mt = 0; mt < HPW; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int h = mt * 16 + gid + half * 8;
            if (h >= H) continue;
            uint32_t hi, lo;
            split2(m[mt][nt][2 * half], m[mt][nt][2 * half + 1], hi, lo);
            const int o = h * kBP + row * kBL + nt * 8 + 2 * tig;
            *reinterpret_cast<uint32_t*>(MH + o) = hi;
            *reinterpret_cast<uint32_t*>(ML + o) = lo;
          }
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {                       // dv += Pmᵀ · dO
      const int h = warp + hh * kWarps;
      if (h >= H) continue;
      const bf16* cd = Cd + cur * H * PL + h * PL;
      uint32_t a[4];
      pt_frag(a, MH + h * kBP, kBL, 0, 0, lane);
      ab_frag<KS>(dv[hh], a, cd, 0, lane);
      pt_frag(a, ML + h * kBP, kBL, 0, 0, lane);
      ab_frag<KS>(dv[hh], a, cd, 0, lane);
    }
    __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp + hh * kWarps;
    if (h < H) store_rows<KS>(dqkv + 2 * HD, sx, b, h, j0, N, d, dv[hh], lane);
  }
}

// The instances: KS = pad16(d) / 16 up to 8, heads a warp owns HPW = 1 (H <=
// 16) or 2 (H <= 32, then KS <= 2: the dv accumulators of two heads and the
// row kernel's head-pair sums and tile fragments at KS = 4 would not fit 128
// registers a thread).  NH > 0 fixes the head count at compile time (the
// students' 24 heads of 32 and 12 of 64), so that the head guards and offsets
// of the row and column kernels fold into constants; NH = 0 takes H from the
// call.  The dq / dk kernel runs its KS <= 4 instance on 64 columns of d a
// block.
template <int KS, int HPW, int NH>
int launch_bwd(const bf16* qkv, const bf16* wl, const bf16* ww, const bf16* dout,
               const bf16* probs, bf16* dqkv, bf16* ds_hi, bf16* ds_lo, float* partial,
               float* dwl_dww, int batch, int N, int H, int d, float scale, cudaStream_t s) {
  constexpr int QKS = KS < 4 ? KS : 4;
  const size_t sr = rows_smem(H, d, HPW), sc = cols_smem(H, d);
  const QkPlan qp = qk_plan(N, H, d < 64 ? d : 64);
  if (qp.G == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tf_bwd_rows_kernel<KS, HPW, NH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sr);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tf_bwd_cols_kernel<KS, HPW, NH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tf_bwd_qk_kernel<QKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)qp.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(pad16(N) / 16, batch);
  tf_bwd_rows_kernel<KS, HPW, NH><<<grid, kThreads, sr, s>>>(
      qkv, wl, ww, dout, probs, ds_hi, ds_lo, partial, N, H, d, scale);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  tf_bwd_qk_kernel<QKS><<<dim3(batch, (H + qp.G - 1) / qp.G, (KS + 3) / 4), kQkWarps * 32,
                          qp.smem, s>>>(qkv, ds_hi, ds_lo, dqkv, N, H, d, qp.G, qp.R);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  tf_bwd_cols_kernel<KS, HPW, NH><<<grid, kThreads, sc, s>>>(ww, dout, probs, dqkv, N, H,
                                                            d);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_partials(partial, dwl_dww, (int)grid.x * batch, 2 * H * H, s);
}

// Heads a warp owns, 0 where the kernels do not take (H, d): d % 8 == 0, up
// to 32 heads at d <= 32 and 16 at d <= 128.
__host__ inline int heads_per_warp(int H, int d) {
  const int ks = pad16(d) / 16, hpw = (H + kWarps - 1) / kWarps;
  if (H < 1 || H > 32 || d < 8 || d % 8 || ks > 8 || (hpw == 2 && ks > 2)) return 0;
  return hpw;
}

}  // namespace

}  // namespace dc

// Shared memory the largest of the kernels needs at (N, H, d), or -1 where
// they do not take (N, H, d): d % 8 == 0, up to 32 heads at d <= 32 and 16 at
// d <= 128, N up to 256.
DC_EXPORT long long dc_tf_bwd_smem_bytes(int N, int H, int d) {
  const int hpw = dc::heads_per_warp(H, d);
  if (hpw == 0) return -1;
  const dc::QkPlan qp = dc::qk_plan(N, H, d < 64 ? d : 64);
  if (qp.G == 0) return -1;
  size_t m = dc::rows_smem(H, d, hpw);
  if (dc::cols_smem(H, d) > m) m = dc::cols_smem(H, d);
  if (qp.smem > m) m = qp.smem;
  return (long long)m;
}

// qkv, dqkv: [batch·N, 3·H·d]; dout: [batch·N, H·d]; wl, ww: [H, H]; probs:
// [batch, H, N, N]; all bf16, qkv, dout, dqkv and probs 16-byte aligned.
// ds_hi, ds_lo: [batch, H, N, pad16(N)] bf16 scratch; partial:
// [batch·pad16(N)/16, 2·H·H] fp32 scratch; dwl_dww: [2·H·H] fp32 (dconv_l then
// dconv_w).  dc_tf_bwd_smem_bytes(N, H, d) must be within the block limit (the
// Python wrapper checks).  Four launches: the row kernel (dS, the mix
// gradients' partials), the dq / dk kernel, the column kernel (dv) and the
// reduction of the partials.
DC_EXPORT int dc_transform_attention_bwd(const void* qkv, const void* wl, const void* ww,
                                         const void* dout, const void* probs, void* dqkv,
                                         void* ds_hi, void* ds_lo, void* partial,
                                         void* dwl_dww, int batch, int N, int H, int d,
                                         float scale, void* stream) {
  using dc::bf16;
  // [heads a warp owns - 1][KS - 1]
  decltype(&dc::launch_bwd<1, 1, 0>) const launchers[2][8] = {
      {dc::launch_bwd<1, 1, 0>, dc::launch_bwd<2, 1, 0>, dc::launch_bwd<3, 1, 0>,
       dc::launch_bwd<4, 1, 0>, dc::launch_bwd<5, 1, 0>, dc::launch_bwd<6, 1, 0>,
       dc::launch_bwd<7, 1, 0>, dc::launch_bwd<8, 1, 0>},
      {dc::launch_bwd<1, 2, 0>, dc::launch_bwd<2, 2, 0>}};
  const int hpw = dc::heads_per_warp(H, d), ks = dc::mma_attn::pad16(d) / 16;
  if (hpw == 0) return (int)cudaErrorInvalidValue;
  const auto launch = H == 24 && ks == 2   ? dc::launch_bwd<2, 2, 24>
                      : H == 12 && ks == 4 ? dc::launch_bwd<4, 1, 12>
                                           : launchers[hpw - 1][ks - 1];
  return launch((const bf16*)qkv, (const bf16*)wl, (const bf16*)ww, (const bf16*)dout,
                (const bf16*)probs, (bf16*)dqkv, (bf16*)ds_hi, (bf16*)ds_lo, (float*)partial,
                (float*)dwl_dww, batch, N, H, d, scale, (cudaStream_t)stream);
}
