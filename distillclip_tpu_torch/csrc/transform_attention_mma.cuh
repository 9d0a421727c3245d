// The tensor-core head-transform attention forward: the tile loop shared by
// K3 / #5 (transform_attention_mma.cu, q, k, v as the column blocks of the
// fused qkv rows, O as [B·N, H·d] rows, optionally the saved P) and #17
// (flash_transform_attention_mma.cu, q, k, v and O as strided [B, H, N, d]
// views, a key limit and the causal mask, O only).  Per sample and query row i:
//   S_g[i, j]  = q_g[i] · k_g[j]                       g = 0..H-1, j < lim(i)
//   L_h[i, j]  = scale · Σ_g wl[h, g] · S_g[i, j]       (conv_l, pre-softmax)
//   P_h[i, :]  = softmax_j(L_h[i, :])                   per-head max and sum
//   P'_h[i, j] = Σ_g ww[h, g] · P_g[i, j]               (conv_w, post-softmax)
//   O_h[i, :]  = Σ_j P'_h[i, j] · v_h[j, :]
// with lim(i) = N for K3 / #5, and for #17 kv_len, min(kv_len, i + 1) under
// the causal mask.  wl and ww are bf16 [H, H], every sum fp32.
//
// * Persistent blocks of 16 warps, one an SM (the planes take 214 KB at 24
//   heads of 32), each taking tiles of 16 query rows of one sample with all
//   H heads in turn, walking the keys in chunks of 16, so any N fits.  A tile
//   stages its q rows once (16-byte cp.async into rows padded to pad16(d) + 8,
//   zero past N and past d); the next tile's q is copied as soon as the last
//   scores of this one have read them, and its first k and v chunks during
//   this one's last chunk, so a tile's start waits for nothing.
// * k and v chunks come by TMA, two buffers each, on mbarriers; the copies of
//   chunk c + 1 are issued while chunk c is worked on.  An issue holds its
//   warp for hundreds of cycles, so the boxes are spread over the warps that
//   have one score head fewer (H % 16 .. 15).  K3 / #5: boxes of 16 rows x 64
//   columns of the fused rows (128-byte swizzle, zero past N); a box row runs
//   on into the next head where d is not a multiple of 16: q is zero there,
//   so those products add nothing, and the output columns past d are not
//   stored.  #17: a 4-D map (d, N, H, B) per operand with the view's strides.
//   Up to d = 64, boxes of 16 rows of 64 / d heads, landing as [head][16
//   rows][d] with the swizzle as wide as a row (128, 64, 32 bytes at d = 64,
//   32, 16; none at other d, where the k-step past d reads the next row, or
//   the zeroed 16 bytes after the last).  Past d = 64, a head's rows come as
//   ceil(d / 64) boxes of 16 rows x 64 columns with the 128-byte swizzle, as
//   K3's (zero past d): unswizzled 256-byte rows would put the eight rows of
//   an ldmatrix in the same banks.
// * The mixes couple the heads at each (query, key) position.  Head items
//   (warp w: heads w, w + 16) make S_g = q_g·k_gᵀ for the chunk into a fp32
//   plane X[row][key][head]; then warp w owns query row w and mixes with the
//   positions as M and the heads as N and K: Lᵀ = Sᵀ·wlᵀ, [16 keys x H] ·
//   [H x H], the weights as B fragments (ldmatrix of the staged [H, H]; with
//   H fixed at 24, only its three tiles of 8 heads).  The C fragment of those
//   products is the A fragment of the next one, so P goes from the softmax
//   into P'ᵀ = Pᵀ·wwᵀ without leaving the registers.  P' (bf16 hi and lo
//   planes, [head][row][key]) then feeds O_h += P'_h·v_h, an item per (head,
//   16 columns of d), v through ldmatrix.trans.
// * Masks: a warp owns one query row in the mixes and the softmax, so its key
//   limit is one scalar.  Past it P is an exact zero for every head, so the
//   ww mix keeps those positions zero and O never reads them.  A #17 tile
//   walks only the ceil(nk / 16) chunks its rows see (nk = kv_len, under the
//   causal mask min(kv_len, i0 + 16)); key 0 of every chunk it walks is below
//   every one of its rows' limits, so each chunk's row max is finite.
// * Two passes over the keys.  Pass 1 makes S and L per chunk and keeps, per
//   (row, head), the running max m and the sum Σ of 2^(L − m), rescaled as m
//   moves (the positions are the fragment's rows: quad columns are reduced
//   across its eight row groups by shuffles).  Pass 2 makes S and L again
//   (FLOPs the card has to spare), P = 2^(L − m − log2 Σ) in fp32, P' and
//   P'·V.  A one-pass form would keep [H, 16, N] fp32 logits (78 KB at the
//   image shape, 196 KB at 24 heads and N = 256): it does not fit beside the
//   buffers, and it would not take N up to 256.
// * Precision (tests/test_torch_transform_attention_rounding.py and
//   tests/test_torch_flash_transform_rounding.py write this arithmetic out):
//   q, k, v and the mixes are exact in bf16 and enter once; S enters the wl
//   mix, P the ww mix and P' the product with v as two bf16 operands, hi =
//   bf16(x) and lo = bf16(x − hi), into one fp32 sum; O and the saved P are
//   each rounded once to bf16.
// * Shapes (K3 / #5 and #17 alike): d % 8 == 0 up to 64, H up to 24 (16 with
//   d > 32) with P' in planes of its own; past that up to 32 heads at d <= 32
//   and 16 at d <= 128 (PIX: 32 heads of 32, 12 of 128), where those planes,
//   q's and the double-buffered k / v chunks pass a block's 227 KB (263 KB at
//   32 heads of 32, 350 KB at 16 of 128).  There a warp writes P' of its
//   query row into its own row of X, which it alone reads (the mixes) and which
//   nothing reads again before the next chunk's scores: P' costs no shared
//   memory, and the mixes mask X's head columns past H (they then hold P', not
//   zeros).  Where two k and two v chunks still do not fit beside the q tile
//   (12 and 16 heads of 128, 16 of 80) the block keeps one of each: the next
//   chunk's k is copied once every warp has made its scores, its v once every
//   warp has used this chunk's.  O leaves through X where its [16][H·d + 8]
//   bf16 rows fit, else from the fragments as 4-byte pairs (#17: through O's
//   strides).  The O accumulators of 16 heads of 128 take 64 registers a
//   thread; every other head shape goes to the CUDA-core kernels.
#pragma once

#include "mma_attention_bwd.cuh"
#include "wgmma_gemm.cuh"

namespace dc {
namespace tf_mma {

using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::ex2;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma_bf16;
using mma_attn::pack2;
using mma_attn::pad16;
using mma_attn::split2;
using mma_attn::Strides;
using mma_attn_bwd::p_frag;
using mma_attn_bwd::stage;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
// bf16 [16 x 16] planes of a head (P' hi, P' lo): rows of 24 and planes of
// 392 elements, so that ldmatrix's eight rows and the row warps' stores fall
// in different banks
constexpr int kPL = 24;
constexpr int kPP = 16 * kPL + 8;

// The chunk's scores X[row][key][head] in fp32: a key's heads padded to HP
// and 8 more, a row's 16 keys and 2 more (the A fragments' float2 reads are
// free of bank conflicts, the head warps' stores two-way).  With P' in X
// (PIX) 4 more, so that each row starts on 16 bytes for ldmatrix (and the
// eight rows it reads fall in different banks; the stores are four-way).
__host__ __device__ constexpr int x_stride(int HP) { return HP + 8; }
__host__ __device__ constexpr int x_row(int HP, bool pix = false) {
  return 16 * x_stride(HP) + (pix ? 4 : 2);
}

// K3 / #5: a chunk's k (or v) rows as TMA boxes of 16 rows x 64 columns (128
// bytes, swizzled: 16-byte word w of row r at word w ^ (r % 8)) over the H·d
// columns of the k or v block, and the 8 past them when d is not a multiple of
// 16 (the last head's k-step reads them; q is zero there).
__host__ __device__ inline int boxes(int H, int d) { return (H * d + d % 16 + 63) / 64; }

// #17: a box holds 16 rows of view_cols(d) columns (d, or 64 past d = 64) of
// view_box_heads heads; a head's row takes view_col_boxes(d) boxes side by
// side (one up to d = 64, two past it), view_boxes of them a chunk.
__host__ __device__ inline int view_cols(int d) { return d < 64 ? d : 64; }
__host__ __device__ inline int view_col_boxes(int d) { return (d + 63) / 64; }
__host__ __device__ inline int view_box_heads(int H, int d) {
  const int hb = d < 64 ? 64 / d : 1;
  return hb < H ? hb : H;
}
__host__ __device__ inline int view_boxes(int H, int d) {
  const int hb = view_box_heads(H, d);
  return (H + hb - 1) / hb * view_col_boxes(d);
}
__host__ __device__ inline uint32_t view_box_bytes(int H, int d) {
  return (uint32_t)view_box_heads(H, d) * 32 * view_cols(d);
}
// The swizzle of a #17 buffer as the mask of the 16-byte word bits that byte
// offset bits 7.. flip: a box row of 128, 64, 32 bytes is swizzled as wide
// (TMA's 128-, 64-, 32-byte modes), other rows not at all.
__host__ __device__ inline int view_swizzle(int d) {
  return d >= 64 ? 7 : d == 32 ? 3 : d == 16 ? 1 : 0;
}
// The zero bytes after a #17 buffer's boxes, which the last head's k-step
// reads where d < 64 is not a multiple of 16 (past 64 TMA zeroes the columns
// past d in the last box).
__host__ __device__ inline int view_tail(int d) { return d < 64 && d % 16 ? 16 : 0; }
// A #17 k or v buffer: the boxes and the tail.
__host__ __device__ inline size_t view_buffer(int H, int d) {
  const size_t data = (size_t)view_boxes(H, d) * view_box_bytes(H, d);
  return (data + view_tail(d) + 1023) / 1024 * 1024;
}

// Byte offsets of the regions of a block's shared memory, from a base
// aligned to 1024 bytes (the swizzle's period); `bufs` k buffers and as many v
// buffers (one each only with PIX, where two do not fit), and whether O's
// staged rows fit the X and P' regions.
struct Layout {
  size_t q, v, x, ph, pl, wl, ww, bar, total;
  int bufs;
  bool o_fits;
};

__host__ __device__ inline Layout layout(int H, int d, bool views = false, bool pix = false) {
  const size_t kv = views ? view_buffer(H, d) : (size_t)boxes(H, d) * 2048;  // a k or v buffer
  const size_t pp = pix ? 0 : (size_t)H * kPP * 2;
  const int HP = pad16(H);
  const size_t q = (size_t)H * 16 * (pad16(d) + 8) * 2, x = (size_t)16 * x_row(HP, pix) * 4;
  const size_t w = (size_t)HP * (HP + 8) * 2;
  const size_t rest = q + x + 2 * pp + 2 * w + 4 * 8 + 1024;
  Layout s;
  s.bufs = pix && 4 * kv + rest > mma_attn::kMaxSmem ? 1 : 2;
  s.v = s.bufs * kv;                   // the k buffers at 0, then the v buffers
  s.q = s.v + s.bufs * kv;             // [H][16][LD] bf16
  s.x = s.q + q;
  s.ph = s.x + x;
  s.pl = s.ph + pp;
  s.wl = s.pl + pp;
  s.ww = s.wl + w;
  s.bar = s.ww + w;                    // four mbarriers
  s.total = s.bar + 4 * 8 + 1024;      // and room to align the base
  s.o_fits = (size_t)16 * (H * d + 8) * 2 <= s.wl - s.x;
  return s;
}

// Heads a warp's items span (pad16(H) / 16) with P' in planes of its own, 0
// where that layout does not take (H, d): d % 8 == 0 up to 64, H up to 24, 16
// with d > 32.
__host__ inline int heads_per_warp(int H, int d) {
  const int ks = pad16(d) / 16, hpw = (H + 15) / 16;
  if (H < 1 || H > 24 || d < 8 || d % 8 || ks > 4 || (hpw == 2 && ks > 2)) return 0;
  return hpw;
}

// The same for the forward (K3 / #5 and #17), which also takes, with P' in X
// (p_in_x), up to 32 heads at d <= 32 and up to 16 at d <= 128; 0 past that.
__host__ inline bool p_in_x(int H, int d) { return heads_per_warp(H, d) == 0; }

__host__ inline int fwd_heads_per_warp(int H, int d) {
  const int ks = pad16(d) / 16, hpw = (H + 15) / 16;
  if (H < 1 || H > 32 || d < 8 || d % 8 || ks > 8 || (hpw == 2 && ks > 2)) return 0;
  return hpw;
}

// The 16-byte word of (row, column col, a multiple of 8) in a K3 chunk's boxes.
__device__ __forceinline__ const bf16* box_at(const unsigned char* base, int row, int col) {
  return reinterpret_cast<const bf16*>(base + (col >> 6) * 2048 + row * 128 +
                                       ((((col >> 3) & 7) ^ (row & 7)) << 4));
}

// The 16-byte word of (head h, row, column col, a multiple of 8) in a #17
// chunk's buffer: [head][col / 64][16 rows][view_cols(d)], swizzled by `swz`
// (view_swizzle); up to d = 64 that is [head][16 rows][d].
__device__ __forceinline__ const bf16* view_at(const unsigned char* base, int h, int row, int col,
                                               int d, int swz) {
  const int w = view_cols(d);
  const int o = ((h * view_col_boxes(d) + (col >> 6)) * 16 + row) * 2 * w + (col & 63) * 2;
  return reinterpret_cast<const bf16*>(base + (o ^ (((o >> 7) & swz) << 4)));
}

// c[n] (positions as rows, heads 8·n + columns) += A · Wᵀ over the heads
// 16·kt .. 16·kt + 15 for the first NT n-tiles: A (16 positions x 16 heads)
// as bf16 hi + lo fragments, W [HP][HP + 8] bf16 with W[h][g] the weight of
// head g in h.
template <int HPW, int NT>
__device__ __forceinline__ void mix_step(float (&c)[2 * HPW][4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const bf16* W, int kt,
                                         int lane) {
  constexpr int WL = 16 * HPW + 8;
#pragma unroll
  for (int np = 0; np < HPW; ++np) {
    uint32_t bw[4];
    ldsm_x4(bw, W + (np * 16 + (lane & 7) + (lane >> 4) * 8) * WL + kt * 16 +
                    ((lane >> 3) & 1) * 8);
    mma_bf16(c[2 * np], hi, bw[0], bw[1]);
    mma_bf16(c[2 * np], lo, bw[0], bw[1]);
    if (2 * np + 1 < NT) {
      mma_bf16(c[2 * np + 1], hi, bw[2], bw[3]);
      mma_bf16(c[2 * np + 1], lo, bw[2], bw[3]);
    }
  }
}

// c = Xr · Wᵀ: the row's [16 keys x HP heads] fp32 scores (from X) mixed;
// tiles past NT stay zero.  MASK: X's head columns past H hold P', not zeros,
// and enter as 0.
template <int HPW, int NT, bool MASK = false>
__device__ __forceinline__ void mix_scores(float (&c)[2 * HPW][4], const float* Xr,
                                           const bf16* W, int H, int lane) {
  constexpr int XS = x_stride(16 * HPW);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * HPW; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < HPW; ++kt) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = kt * 16 + (r >> 1) * 8 + 2 * tig;
      float2 x = *reinterpret_cast<const float2*>(Xr + (gid + (r & 1) * 8) * XS + col);
      if (MASK) {
        x.x = col < H ? x.x : 0.f;
        x.y = col + 1 < H ? x.y : 0.f;
      }
      split2(x.x, x.y, hi[r], lo[r]);
    }
    mix_step<HPW, NT>(c, hi, lo, W, kt, lane);
  }
}

// S_g = q_g · k_gᵀ of the chunk for the warp's heads, into X[row][key][g]: q
// rows from their planes (rows of LD), k rows from the chunk's boxes (K3) or
// buffer (#17, VIEWS).
template <int KS, int HPW, bool VIEWS, bool PIX>
__device__ __forceinline__ void chunk_scores(const bf16* Qs, const unsigned char* Kc, float* X,
                                             int H, int d, int swz, int warp, int lane) {
  constexpr int LD = 16 * KS + 8, PL = 16 * LD;
  constexpr int XS = x_stride(16 * HPW), XR = x_row(16 * HPW, PIX);
  const int gid = lane >> 2, tig = lane & 3;
  // A: rows 0-7 | d 0-7, rows 8-15 | d 0-7, rows 0-7 | d 8-15, rows 8-15 | d 8-15;
  // B: keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7, keys 8-15 | d 8-15
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + i * kWarps;
    if (g >= H) continue;
    float s[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4], bk[4];
      ldsm_x4(af, Qs + g * PL + arow * LD + acol + ks * 16);
      if constexpr (VIEWS)
        ldsm_x4(bk, view_at(Kc, g, krow, kcol + ks * 16, d, swz));
      else
        ldsm_x4(bk, box_at(Kc, krow, g * d + kcol + ks * 16));
      mma_bf16(s[0], af, bk[0], bk[1]);
      mma_bf16(s[1], af, bk[2], bk[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        X[(gid + (e >> 1) * 8) * XR + (n * 8 + 2 * tig + (e & 1)) * XS + g] = s[n][e];
  }
}

// A K3 chunk's k or v rows, j0 .. j0 + 15 of sample b: the boxes from column
// col0 of the fused rows (zero past N), completing on `bar`.  Called by the
// warps first .. first + count − 1: lane 0 of the first arrives expecting the
// bytes, and lane 0 of each issues every count-th box (an issue holds its
// warp for hundreds of cycles, so no one warp issues them all; a box may land
// before the arrival: the barrier's transaction count is below zero until
// then).
__device__ __forceinline__ void fill(unsigned char* dst, const CUtensorMap* map, int col0,
                                     int j0, int b, int nbox, uint64_t* bar, int first,
                                     int count) {
  const int w = (threadIdx.x >> 5) - first;
  if ((threadIdx.x & 31) != 0 || w < 0 || w >= count) return;
  if (w == 0) wg::mbar_expect_tx(bar, (uint32_t)nbox * 2048);
  for (int bx = w; bx < nbox; bx += count)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(wg::smem_u32(dst + bx * 2048)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(col0 + bx * 64), "r"(j0), "r"(b),
        "r"(wg::smem_u32(bar))
        : "memory");
}

// A #17 chunk's k or v rows, j0 .. j0 + 15 of sample b, from the view's 4-D
// map (d, N, H, B): nbox boxes of hb heads and 64 columns from column 64·(bx %
// kc) (box_bytes each; zero past d, N and H), issued as `fill` issues them.
__device__ __forceinline__ void fill_view(unsigned char* dst, const CUtensorMap* map, int j0,
                                          int b, int nbox, int hb, int kc, uint32_t box_bytes,
                                          uint64_t* bar, int first, int count) {
  const int w = (threadIdx.x >> 5) - first;
  if ((threadIdx.x & 31) != 0 || w < 0 || w >= count) return;
  if (w == 0) wg::mbar_expect_tx(bar, (uint32_t)nbox * box_bytes);
  for (int bx = w; bx < nbox; bx += count)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(wg::smem_u32(dst + bx * box_bytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bx % kc * 64), "r"(j0), "r"(bx / kc * hb),
        "r"(b),
        "r"(wg::smem_u32(bar))
        : "memory");
}

// #17's operands beside the maps: q and O as views (element strides), the key
// limit and the causal mask.  K3 / #5 pass none.
struct Views {
  const bf16* q;
  bf16* out;
  Strides sq, so;
  int causal, kv_len;
};

// The kernel's body: persistent blocks of 16 warps, one an SM, each taking
// tiles of 16 query rows of a sample in turn (tile t: sample t / T, rows
// 16·(t % T), T = ceil(N / 16); block i takes tiles i, i + grid, ..).  KS =
// pad16(d) / 16, HPW = pad16(H) / 16; NH > 0 and ND > 0 fix H and d at compile
// time (the mixes then make only H's ceil(H / 8) tiles of 8 heads).  K3 / #5
// (VIEWS false): kmap = vmap, the fused qkv as [B][N][3·H·d]; probs null: the
// lean forward.  #17 (VIEWS): the views' maps and `vw`; probs unused.  PIX:
// P' in X, one k and one v buffer where two do not fit.
template <int KS, int HPW, int NH, int ND, bool VIEWS, bool PIX = false>
__device__ __forceinline__ void tf_fwd_tiles(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                             const bf16* __restrict__ qkv, Views vw,
                                             const bf16* __restrict__ wl,
                                             const bf16* __restrict__ ww,
                                             bf16* __restrict__ out, bf16* __restrict__ probs,
                                             int batch, int N, int H_, int d_,
                                             float scale_log2) {
  const int H = NH > 0 ? NH : H_;
  const int d = ND > 0 ? ND : d_;
  constexpr int LD = 16 * KS + 8;
  constexpr int PL = 16 * LD;             // a head's 16 staged q rows
  constexpr int HP = 16 * HPW;
  constexpr int XS = x_stride(HP), XR = x_row(HP, PIX), WL = HP + 8;
  // (head, 16 columns of d) items of P'·V a warp owns, at the most heads
  constexpr int HMAX = NH > 0 ? NH : (HPW == 1 ? 16 : PIX ? 32 : 24);
  constexpr int IPW = (HMAX * KS + kWarps - 1) / kWarps;
  constexpr int NT = NH > 0 ? (NH + 7) / 8 : 2 * HPW;    // tiles of 8 heads in the mixes
  // X's head columns past H hold P' (PIX): the mixes mask them
  constexpr bool MASK = PIX && (NH == 0 || NH % 16 != 0);
  // P' hi / lo of head h, query row r at PH / PLo + h·PHS + r·PRS: planes of
  // their own, or (PIX) row r's [head][16 keys] in its own X row
  constexpr int PHS = PIX ? 16 : kPP, PRS = PIX ? 2 * XR : kPL;
  const float kNegInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char tf_fwd_smem[];
  // aligned by an offset from the array, so that the compiler keeps every
  // pointer below in the shared window
  unsigned char* smem = tf_fwd_smem + ((1024 - (wg::smem_u32(tf_fwd_smem) & 1023)) & 1023);
  const Layout lay = layout(H, d, VIEWS, PIX);
  const bool dbl = !PIX || lay.bufs == 2;   // two k and two v buffers
  const int nbox = VIEWS ? view_boxes(H, d) : boxes(H, d);
  const int hb = VIEWS ? view_box_heads(H, d) : 0, kc = VIEWS ? view_col_boxes(d) : 0;
  const uint32_t vbytes = VIEWS ? view_box_bytes(H, d) : 0;   // a #17 box
  const int swz = VIEWS ? view_swizzle(d) : 0;
  const size_t KB = lay.v / lay.bufs;                   // a k or v buffer
  unsigned char* Ks = smem;                             // bufs x a chunk's k boxes
  unsigned char* Vs = smem + lay.v;                     // bufs x a chunk's v boxes
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);     // [H][16][LD]: q rows of the tile
  float* X = reinterpret_cast<float*>(smem + lay.x);    // [16][XR]: S of the chunk (then O)
  bf16* PH = reinterpret_cast<bf16*>(smem + (PIX ? lay.x : lay.ph));   // P' hi
  bf16* PLo = PH + (PIX ? 16 * H : H * kPP);            // P' lo
  bf16* Wl = reinterpret_cast<bf16*>(smem + lay.wl);    // [HP][HP + 8]: wl[h][g]
  bf16* Ww = reinterpret_cast<bf16*>(smem + lay.ww);    // ww[h][g]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);   // k buffers 0 / 1, v 0 / 1

  const int T = (N + 15) / 16, tiles = T * batch;
  const int HD = H * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // the warps with one score head fewer (all where H is a multiple of 16)
  // issue the copies of the next chunk in the time the others' heads take
  const int light = H % kWarps, nlight = kWarps - light;
  // the 16 q rows from row0 of sample bb: K3's q is the first column block of
  // the fused rows
  auto stage_q = [&](int bb, int row0) {
    if constexpr (VIEWS)
      stage<KS>(Qs, PL, vw.q, vw.sq, bb, 0, H, row0, 16, N, d);
    else
      stage<KS>(Qs, PL, qkv, Strides{(size_t)N * 3 * HD, (size_t)d, (size_t)3 * HD}, bb, 0, H,
                row0, 16, N, d);
  };
  auto fill_k = [&](unsigned char* dst, int j0, int b, uint64_t* br, int first, int count) {
    if constexpr (VIEWS)
      fill_view(dst, kmap, j0, b, nbox, hb, kc, vbytes, br, first, count);
    else
      fill(dst, kmap, HD, j0, b, nbox, br, first, count);
  };
  auto fill_v = [&](unsigned char* dst, int j0, int b, uint64_t* br, int first, int count) {
    if constexpr (VIEWS)
      fill_view(dst, vmap, j0, b, nbox, hb, kc, vbytes, br, first, count);
    else
      fill(dst, vmap, 2 * HD, j0, b, nbox, br, first, count);
  };
  // a tile takes 2Tk k chunks (pass 1, pass 2; Tk = T but for #17's masks),
  // chunk c in buffer c & 1, and Tk v chunks, chunk jt in buffer (vb0 + jt) &
  // 1 (vb0 flips from tile to tile when Tk is odd); the phase parity of each
  // buffer's barrier in kph / vph
  uint32_t kph = 0, vph = 0, vb0 = 0;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(kmap)) : "memory");
    if constexpr (VIEWS)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(vmap))
                   : "memory");
    for (int i = 0; i < 4; ++i) wg::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (VIEWS) {
    // each k and v buffer's tail (view_tail): zero (TMA never writes it)
    if (view_tail(d) && threadIdx.x < 2 * lay.bufs)
      *reinterpret_cast<uint4*>(smem + threadIdx.x * KB + (size_t)nbox * vbytes) =
          make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (blockIdx.x < tiles) {
    const int b0 = blockIdx.x / T;
    fill_k(Ks, 0, b0, &bar[0], 0, kWarps);
    fill_v(Vs, 0, b0, &bar[2], 0, kWarps);
    // the q tile (zero past N and past d)
    stage_q(b0, (blockIdx.x - b0 * T) * 16);
    cp_async_commit();
  }
  for (int idx = threadIdx.x; idx < HP * HP; idx += kThreads) {
    const int r = idx / HP, c = idx - r * HP;
    const bool ok = r < H && c < H;
    Wl[r * WL + c] = ok ? wl[r * H + c] : __float2bfloat16(0.f);
    Ww[r * WL + c] = ok ? ww[r * H + c] : __float2bfloat16(0.f);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / T, i0 = (tile - b * T) * 16;
    // the keys the warp's query row sees (below lim) and the chunks the tile walks
    int lim = N, Tk = T;
    if constexpr (VIEWS) {
      lim = vw.causal ? min(vw.kv_len, i0 + warp + 1) : vw.kv_len;
      Tk = ((vw.causal ? min(vw.kv_len, i0 + 16) : vw.kv_len) + 15) / 16;
    }
    // X's head columns past H are never written by the scores: zero, for the
    // mixes' A operand (again after a tile's O went through X); with P' in X
    // the mixes mask them instead
    if (!PIX)
      for (int idx = threadIdx.x; idx < 16 * 16 * (HP - H); idx += kThreads) {
        const int rk = idx / (HP - H), g = H + idx - rk * (HP - H);
        X[(rk >> 4) * XR + (rk & 15) * XS + g] = 0.f;
      }
    cp_async_wait<0>();   // this tile's q

    // pass 1: per (row, head) column of the warp's fragments, the running max
    // m of the logits in log2 units and this thread's part of Σ 2^(L − m)
    float m[2 * HPW][2], l[2 * HPW][2];
#pragma unroll
    for (int n = 0; n < 2 * HPW; ++n) m[n][0] = m[n][1] = kNegInf, l[n][0] = l[n][1] = 0.f;
    for (int jt = 0; jt < Tk; ++jt) {
      __syncthreads();    // X free; the next k buffer read by the previous chunk
      const int kb = dbl ? jt & 1 : 0;
      wg::mbar_wait(&bar[kb], (kph >> kb) & 1);
      kph ^= 1u << kb;
      chunk_scores<KS, HPW, VIEWS, PIX>(Qs, Ks + kb * KB, X, H, d, swz, warp, lane);
      // the next chunk's k rows (after the last, chunk 0's again for pass 2):
      // into the other buffer, or into this one once every warp has read it
      const int nk = jt + 1 < Tk ? 16 * (jt + 1) : 0;
      if (dbl) fill_k(Ks + (kb ^ 1) * KB, nk, b, &bar[kb ^ 1], light, nlight);
      __syncthreads();
      if (!dbl) fill_k(Ks, nk, b, &bar[0], 0, kWarps);
      float c[2 * HPW][4];
      mix_scores<HPW, NT, MASK>(c, X + warp * XR, Wl, H, lane);
      const bool ok0 = 16 * jt + gid < lim, ok1 = 16 * jt + gid + 8 < lim;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float x0 = ok0 ? c[n][cc] * scale_log2 : kNegInf;
          const float x1 = ok1 ? c[n][2 + cc] * scale_log2 : kNegInf;
          float mx = fmaxf(x0, x1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[n][cc], mx);   // key 0 of the chunk is below lim
          l[n][cc] = l[n][cc] * ex2(m[n][cc] - mn) + ex2(x0 - mn) + ex2(x1 - mn);
          m[n][cc] = mn;
        }
    }
    // m + log2 Σ: P = 2^(L − m − log2 Σ)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float t = l[n][cc];
        t += __shfl_xor_sync(0xffffffffu, t, 4);
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        m[n][cc] += __log2f(t);
      }

    // pass 2: S and L again, P, P' and O_h += P'_h · v_h
    float o[IPW][2][4];
#pragma unroll
    for (int it = 0; it < IPW; ++it)
#pragma unroll
      for (int n = 0; n < 2; ++n) o[it][n][0] = o[it][n][1] = o[it][n][2] = o[it][n][3] = 0.f;
    __syncthreads();      // X free
    for (int jt = 0; jt < Tk; ++jt) {
      const int j0 = 16 * jt;
      const int kb = dbl ? (Tk + jt) & 1 : 0, vb = dbl ? (vb0 + jt) & 1 : 0;
      const int next = tile + gridDim.x;    // the block's next tile, if below tiles
      // the next chunk's k and v rows: this tile's, or the next tile's first
      const bool more = jt + 1 < Tk || next < tiles;
      const int rows = jt + 1 < Tk ? j0 + 16 : 0, bs = jt + 1 < Tk ? b : next / T;
      wg::mbar_wait(&bar[kb], (kph >> kb) & 1);
      kph ^= 1u << kb;
      chunk_scores<KS, HPW, VIEWS, PIX>(Qs, Ks + kb * KB, X, H, d, swz, warp, lane);
      if (dbl && more) {
        fill_k(Ks + (kb ^ 1) * KB, rows, bs, &bar[kb ^ 1], light, nlight);
        fill_v(Vs + (vb ^ 1) * KB, rows, bs, &bar[2 + (vb ^ 1)], light, nlight);
      }
      __syncthreads();
      if (!dbl && more) fill_k(Ks, rows, bs, &bar[0], 0, kWarps);
      // after the tile's last scores, the next tile's q rows
      if (jt + 1 == Tk && next < tiles) {
        const int nb = next / T;
        stage_q(nb, (next - nb * T) * 16);
        cp_async_commit();
      }
      {
        float c1[2 * HPW][4];
        mix_scores<HPW, NT, MASK>(c1, X + warp * XR, Wl, H, lane);
        const bool ok0 = j0 + gid < lim, ok1 = j0 + gid + 8 < lim;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c1[n][e] = (e < 2 ? ok0 : ok1) ? ex2(c1[n][e] * scale_log2 - m[n][e & 1]) : 0.f;
        // save-P: P[b, h, r, j0 + key] from the fragments, the keys of a head
        // in eight neighbouring lanes.  At an even N every pair of keys 2i,
        // 2i + 1 is a 4-byte word: lanes gid, gid ^ 1 swap a value, the even
        // one stores its head 2·tig's pair, the odd one head 2·tig + 1's.
        const int r = i0 + warp;
        if (!VIEWS && probs != nullptr && r < N) {
          bf16* prow = probs + (((size_t)b * H * N + r) * N + j0);
          const size_t hs = (size_t)N * N;
          if (N % 2 == 0) {
            const int odd = gid & 1;
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const float v0 = c1[n][2 * half], v1 = c1[n][2 * half + 1];
                const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
                const int h = n * 8 + 2 * tig + odd, key = gid - odd + 8 * half;
                if (h < H && j0 + key < N)
                  *reinterpret_cast<uint32_t*>(prow + h * hs + key) =
                      odd ? pack2(got, v1) : pack2(v0, got);
              }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h = n * 8 + 2 * tig + (e & 1);
                if (h < H && (e < 2 ? ok0 : ok1))
                  prow[h * hs + gid + (e >> 1) * 8] = __float2bfloat16_rn(c1[n][e]);
              }
          }
        }
        // P'ᵀ = Pᵀ · wwᵀ: P's C fragments (heads 16·kt ..) as A fragments
        float c2[2 * HPW][4];
#pragma unroll
        for (int n = 0; n < 2 * HPW; ++n) c2[n][0] = c2[n][1] = c2[n][2] = c2[n][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < HPW; ++kt) {
          uint32_t hi[4], lo[4];
          split2(c1[2 * kt][0], c1[2 * kt][1], hi[0], lo[0]);
          split2(c1[2 * kt][2], c1[2 * kt][3], hi[1], lo[1]);
          split2(c1[2 * kt + 1][0], c1[2 * kt + 1][1], hi[2], lo[2]);
          split2(c1[2 * kt + 1][2], c1[2 * kt + 1][3], hi[3], lo[3]);
          mix_step<HPW, NT>(c2, hi, lo, Ww, kt, lane);
        }
        if (PIX) __syncwarp();   // every lane's reads of the warp's X row made
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = n * 8 + 2 * tig + (e & 1);
            if (h >= H) continue;
            const bf16 hi = __float2bfloat16_rn(c2[n][e]);
            const int at = h * PHS + warp * PRS + gid + (e >> 1) * 8;
            PH[at] = hi;
            PLo[at] = __float2bfloat16_rn(c2[n][e] - __bfloat162float(hi));
          }
      }
      __syncthreads();
      wg::mbar_wait(&bar[2 + vb], (vph >> vb) & 1);        // this chunk's v
      vph ^= 1u << vb;
      const unsigned char* Vc = Vs + vb * KB;
#pragma unroll
      for (int it = 0; it < IPW; ++it) {
        const int item = warp + it * kWarps;
        const int h = item / KS, dt = item - h * KS;
        if (h >= H) continue;
        uint32_t ahi[4], alo[4], bv[4];
        p_frag(ahi, PH + h * PHS, PRS, 0, 0, lane);
        p_frag(alo, PLo + h * PHS, PRS, 0, 0, lane);
        // matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 8-15
        if constexpr (VIEWS)
          ldsm_x4_trans(bv, view_at(Vc, h, (lane & 7) + ((lane >> 3) & 1) * 8,
                                    (lane >> 4) * 8 + dt * 16, d, swz));
        else
          ldsm_x4_trans(bv, box_at(Vc, (lane & 7) + ((lane >> 3) & 1) * 8,
                                   h * d + (lane >> 4) * 8 + dt * 16));
        mma_bf16(o[it][0], ahi, bv[0], bv[1]);
        mma_bf16(o[it][0], alo, bv[0], bv[1]);
        mma_bf16(o[it][1], ahi, bv[2], bv[3]);
        mma_bf16(o[it][1], alo, bv[2], bv[3]);
      }
      __syncthreads();    // P', X and this v buffer free
      if (!dbl && more) fill_v(Vs, rows, bs, &bar[2], 0, kWarps);
    }

    if (!lay.o_fits) {
      // O from the fragments as bf16 pairs, rows below N (X is not touched):
      // into the [B·N, H·d] rows, or (#17) through O's strides
      const size_t rs = VIEWS ? vw.so.n : (size_t)HD;   // a row's stride
#pragma unroll
      for (int it = 0; it < IPW; ++it) {
        const int item = warp + it * kWarps;
        const int h = item / KS, dt = item - h * KS;
        if (h >= H) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int cc = dt * 16 + n * 8 + 2 * tig;
          if (cc >= d) continue;
          bf16* o0 = VIEWS ? vw.out + b * vw.so.b + h * vw.so.h + (size_t)(i0 + gid) * rs + cc
                           : out + ((size_t)b * N + i0 + gid) * HD + h * d + cc;
          if (i0 + gid < N)
            *reinterpret_cast<uint32_t*>(o0) = pack2(o[it][n][0], o[it][n][1]);
          if (i0 + gid + 8 < N)
            *reinterpret_cast<uint32_t*>(o0 + 8 * rs) = pack2(o[it][n][2], o[it][n][3]);
        }
      }
      vb0 ^= Tk & 1;
      continue;
    }
    // O: bf16 pairs through the free X and P' planes as [16][H·d + 8], then
    // 16-byte stores of the rows below N
    const int OL = HD + 8;
    bf16* Os = reinterpret_cast<bf16*>(X);
#pragma unroll
    for (int it = 0; it < IPW; ++it) {
      const int item = warp + it * kWarps;
      const int h = item / KS, dt = item - h * KS;
      if (h >= H) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int cc = dt * 16 + n * 8 + 2 * tig;
        if (cc >= d) continue;
        *reinterpret_cast<uint32_t*>(Os + gid * OL + h * d + cc) =
            pack2(o[it][n][0], o[it][n][1]);
        *reinterpret_cast<uint32_t*>(Os + (gid + 8) * OL + h * d + cc) =
            pack2(o[it][n][2], o[it][n][3]);
      }
    }
    __syncthreads();
    const int words = HD / 8;
    if constexpr (VIEWS) {
      // through O's strides: word w of a row is head w / (d / 8), columns
      // 8·(w % (d / 8))
      for (int idx = threadIdx.x; idx < 16 * words; idx += kThreads) {
        const int r = idx / words, w = idx - r * words, h = w / (d / 8);
        if (i0 + r < N)
          *reinterpret_cast<uint4*>(vw.out + b * vw.so.b + h * vw.so.h +
                                    (size_t)(i0 + r) * vw.so.n + (w * 8 - h * d)) =
              *reinterpret_cast<const uint4*>(Os + r * OL + w * 8);
      }
    } else {
      for (int idx = threadIdx.x; idx < 16 * words; idx += kThreads) {
        const int r = idx / words, w = idx - r * words;
        if (i0 + r < N)
          *reinterpret_cast<uint4*>(out + ((size_t)b * N + i0 + r) * HD + w * 8) =
              *reinterpret_cast<const uint4*>(Os + r * OL + w * 8);
      }
    }
    __syncthreads();      // X free for the next tile
    vb0 ^= Tk & 1;
  }
}

}  // namespace tf_mma
}  // namespace dc
