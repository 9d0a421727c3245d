// K3 and #5 on the tensor cores: head-transform attention forward on the
// fused qkv projection, without and with saved probabilities.
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_kernel (behind
// _tf_fwd_call), the Pallas forward of transform_attention_rows_qkv, lean and
// with save_p (the training forward, :467).  Per sample and query row i:
//   S_g[i, j]  = q_g[i] · k_g[j]                       g = 0..H-1, j < N
//   L_h[i, j]  = scale · Σ_g wl[h, g] · S_g[i, j]       (conv_l, pre-softmax)
//   P_h[i, :]  = softmax_j(L_h[i, :])                   per-head max and sum
//   P'_h[i, j] = Σ_g ww[h, g] · P_g[i, j]               (conv_w, post-softmax)
//   O_h[i, :]  = Σ_j P'_h[i, j] · v_h[j, :]
// qkv bf16 [B·N, 3·H·d] (q | k | v column blocks, head-major inside each), wl
// and ww bf16 [H, H], O bf16 [B·N, H·d].  With save-P the kernel also stores
// P (after the softmax, before the ww mix: what transform_attention_bwd.cu
// reads) as bf16 [B, H, N, N] at the true N.  O is the same bits either way.
//
// Bound on the H100: bytes.  At the image student's shape (B=256, H=24, d=32,
// N=50) the function reads qkv and writes O, 78.6 MB (save-P: + 30.7 MB of P),
// against 3.4 GFLOP of products and mixes; the text student's (H=12, d=64,
// N=77) 121.1 MB (+ 36.4 MB) against 4.7 GFLOP.  The CUDA-core version
// (transform_attention.cu, now the route for head shapes past this kernel's)
// ran every product in fp32 on the CUDA cores and held two whole-row [H, tq,
// N] fp32 planes per block.  Here every product and mix is
// mma.sync.m16n8k16 (bf16 operands, fp32 sums), a block holds one 16-key
// chunk at a time, and its time goes to the per-row mixes and the barriers
// between the head-wise and row-wise steps (latency, not bytes):
//
// * Persistent blocks of 16 warps, one an SM (the planes take 214 KB at 24
//   heads of 32), each taking tiles of 16 query rows of one sample with all
//   H heads in turn, walking the keys in chunks of 16, so any N fits.  A tile
//   stages its q rows once (16-byte cp.async into rows padded to pad16(d) + 8,
//   zero past N and past d); the next tile's q is copied as soon as the last
//   scores of this one have read them, and its first k and v chunks during
//   this one's last chunk, so a tile's start waits for nothing.
// * k and v chunks come by TMA (cp.async.bulk.tensor, boxes of 16 rows x 64
//   columns of the fused rows, 128-byte swizzle, zero past N), two buffers
//   each, on mbarriers; the copies of chunk c + 1 are issued while chunk c is
//   worked on.  An issue holds its warp for hundreds of cycles, so the boxes
//   are spread over the warps that have one score head fewer (H % 16 .. 15).
//   A box row runs on into the next head where d is not a multiple of 16: q
//   is zero there, so those products add nothing, and the output columns past
//   d are not stored.
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
// * Two passes over the keys.  Pass 1 makes S and L per chunk and keeps, per
//   (row, head), the running max m and the sum Σ of 2^(L − m), rescaled as m
//   moves (the positions are the fragment's rows: quad columns are reduced
//   across its eight row groups by shuffles).  Pass 2 makes S and L again
//   (FLOPs the card has to spare), P = 2^(L − m − log2 Σ) in fp32, P' and
//   P'·V.  A one-pass form would keep [H, 16, N] fp32 logits (78 KB at the
//   image shape, 196 KB at 24 heads and N = 256): it does not fit beside the
//   buffers, and it would not take N up to 256.
// * Save-P: P as bf16 from the fragments straight to device memory, a head's
//   16 keys of a row in eight neighbouring lanes; at an even N as 4-byte pairs
//   (neighbouring lanes swap a value), at an odd N as 2-byte values.  A row of
//   P is N·2 bytes, not 16-byte aligned at N = 50 or 77.  A head's 16 rows
//   are one run of device memory, and staging the H runs in shared memory
//   (H·16·N·2 bytes: 29.6 KB at the text student's shape; it does not fit
//   beside the image student's 214 KB) to store them as 16-byte words at the
//   tile's end was 2% slower at the text shape on an H100 (SXM, 700 W):
//   0.1800 against 0.1766 ms at B = 256, spill-free, in an instance of its
//   own.  The stores from the fragments overlap the next chunk's work; the
//   runs' copy-out waits at the tile's end.
// * Precision (tests/test_torch_transform_attention_rounding.py writes this
//   arithmetic out): q, k, v and the mixes are exact in bf16 and enter once; S
//   enters the wl mix, P the ww mix and P' the product with v as two bf16
//   operands, hi = bf16(x) and lo = bf16(x − hi), into one fp32 sum; O and the
//   saved P are each rounded once to bf16.  A single bf16 P' (the TPU
//   kernel's pb) adds up to 2^-9·|v| to each term of O.
// * Shapes: d % 8 == 0 up to 64, H up to 24 (16 with d > 32), as the
//   backward takes them: every head of a 16 x 16 tile lives in one block and
//   a warp's O accumulators in its registers.  The Python wrapper sends the
//   lean forward at other head shapes to the CUDA-core kernel; the students'
//   shapes (24 heads of 32, 12 of 64) have instances with H and d fixed at
//   compile time, which on an H100 (SXM, 700 W) at B = 256 take 12% off the
//   generic instance's time at 24 heads of 32 (the mixes make three tiles of
//   8 heads, not four) and 4-5% at 12 of 64 (the loops over d and H unroll).
#include "mma_attention_bwd.cuh"
#include "wgmma_gemm.cuh"

namespace dc {

namespace {

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
// free of bank conflicts, the head warps' stores two-way).
__host__ __device__ constexpr int x_stride(int HP) { return HP + 8; }
__host__ __device__ constexpr int x_row(int HP) { return 16 * x_stride(HP) + 2; }

// A chunk's k (or v) rows as TMA boxes of 16 rows x 64 columns (128 bytes,
// swizzled: 16-byte word w of row r at word w ^ (r % 8)) over the H·d columns
// of the k or v block, and the 8 past them when d is not a multiple of 16 (the
// last head's k-step reads them; q is zero there).
__host__ __device__ inline int boxes(int H, int d) { return (H * d + d % 16 + 63) / 64; }

// Byte offsets of the regions of a block's shared memory, from a base
// aligned to 1024 bytes (the swizzle's period).
struct Layout {
  size_t q, v, x, ph, pl, wl, ww, bar, total;
};

__host__ __device__ inline Layout layout(int H, int d) {
  const size_t kv = (size_t)boxes(H, d) * 2048;                // a chunk's k or v boxes
  const size_t pp = (size_t)H * kPP * 2;
  const int HP = pad16(H);
  Layout s;
  s.v = 2 * kv;                        // two k buffers at 0, then two v buffers
  s.q = s.v + 2 * kv;                  // [H][16][LD] bf16
  s.x = s.q + (size_t)H * 16 * (pad16(d) + 8) * 2;
  s.ph = s.x + (size_t)16 * x_row(HP) * 4;
  s.pl = s.ph + pp;
  s.wl = s.pl + pp;
  s.ww = s.wl + (size_t)HP * (HP + 8) * 2;
  s.bar = s.ww + (size_t)HP * (HP + 8) * 2;    // four mbarriers
  s.total = s.bar + 4 * 8 + 1024;              // and room to align the base
  return s;
}

// The 16-byte word of (row, column col, a multiple of 8) in a chunk's boxes.
__device__ __forceinline__ const bf16* box_at(const unsigned char* base, int row, int col) {
  return reinterpret_cast<const bf16*>(base + (col >> 6) * 2048 + row * 128 +
                                       ((((col >> 3) & 7) ^ (row & 7)) << 4));
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
// tiles past NT stay zero.
template <int HPW, int NT>
__device__ __forceinline__ void mix_scores(float (&c)[2 * HPW][4], const float* Xr,
                                           const bf16* W, int lane) {
  constexpr int XS = x_stride(16 * HPW);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * HPW; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < HPW; ++kt) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 x = *reinterpret_cast<const float2*>(
          Xr + (gid + (r & 1) * 8) * XS + kt * 16 + (r >> 1) * 8 + 2 * tig);
      split2(x.x, x.y, hi[r], lo[r]);
    }
    mix_step<HPW, NT>(c, hi, lo, W, kt, lane);
  }
}

// S_g = q_g · k_gᵀ of the chunk for the warp's heads, into X[row][key][g]: q
// rows from their planes (rows of LD), k rows from the chunk's boxes.
template <int KS, int HPW>
__device__ __forceinline__ void chunk_scores(const bf16* Qs, const unsigned char* Kc, float* X,
                                             int H, int d, int warp, int lane) {
  constexpr int LD = 16 * KS + 8, PL = 16 * LD;
  constexpr int XS = x_stride(16 * HPW), XR = x_row(16 * HPW);
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

// A chunk's k or v rows, j0 .. j0 + 15 of sample b: the boxes from column
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

// The kernel: persistent blocks of 16 warps, one an SM, each taking tiles of
// 16 query rows of a sample in turn (tile t: sample t / T, rows 16·(t % T),
// T = ceil(N / 16); block i takes tiles i, i + grid, ..).  KS = pad16(d) / 16,
// HPW = pad16(H) / 16; NH > 0 and ND > 0 fix H and d at compile time (the
// mixes then make only H's ceil(H / 8) tiles of 8 heads).  probs null: the
// lean forward.  `map`: the fused qkv as [B][N][3·H·d] for TMA.
template <int KS, int HPW, int NH, int ND>
__global__ void __launch_bounds__(kThreads, 1)
tf_fwd_mma_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ qkv,
                  const bf16* __restrict__ wl, const bf16* __restrict__ ww,
                  bf16* __restrict__ out, bf16* __restrict__ probs, int batch, int N, int H_,
                  int d_, float scale_log2) {
  const int H = NH > 0 ? NH : H_;
  const int d = ND > 0 ? ND : d_;
  constexpr int LD = 16 * KS + 8;
  constexpr int PL = 16 * LD;             // a head's 16 staged q rows
  constexpr int HP = 16 * HPW;
  constexpr int XS = x_stride(HP), XR = x_row(HP), WL = HP + 8;
  // (head, 16 columns of d) items of P'·V a warp owns, at the most heads
  constexpr int HMAX = NH > 0 ? NH : (HPW == 1 ? 16 : 24);
  constexpr int IPW = (HMAX * KS + kWarps - 1) / kWarps;
  constexpr int NT = NH > 0 ? (NH + 7) / 8 : 2 * HPW;    // tiles of 8 heads in the mixes
  const float kNegInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char tf_fwd_smem[];
  // aligned by an offset from the array, so that the compiler keeps every
  // pointer below in the shared window
  unsigned char* smem = tf_fwd_smem + ((1024 - (wg::smem_u32(tf_fwd_smem) & 1023)) & 1023);
  const Layout lay = layout(H, d);
  const int nbox = boxes(H, d);
  const size_t KB = (size_t)nbox * 2048;               // a k or v buffer
  unsigned char* Ks = smem;                             // 2 x a chunk's k boxes
  unsigned char* Vs = smem + lay.v;                     // 2 x a chunk's v boxes
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);     // [H][16][LD]: q rows of the tile
  float* X = reinterpret_cast<float*>(smem + lay.x);    // [16][XR]: S of the chunk (then O)
  bf16* PH = reinterpret_cast<bf16*>(smem + lay.ph);    // [H][kPP]: P' hi [row][key]
  bf16* PLo = reinterpret_cast<bf16*>(smem + lay.pl);   // P' lo
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
  // a tile takes 2T k chunks (pass 1, pass 2), chunk c in buffer c & 1, and T
  // v chunks, chunk jt in buffer (vb0 + jt) & 1 (vb0 flips from tile to tile
  // when T is odd); the phase parity of each buffer's barrier in kph / vph
  uint32_t kph = 0, vph = 0, vb0 = 0;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
    for (int i = 0; i < 4; ++i) wg::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (blockIdx.x < tiles) {
    const int b0 = blockIdx.x / T;
    fill(Ks, &map, HD, 0, b0, nbox, &bar[0], 0, kWarps);
    fill(Vs, &map, 2 * HD, 0, b0, nbox, &bar[2], 0, kWarps);
    // the q tile (zero past N and past d)
    stage<KS>(Qs, PL, qkv, Strides{(size_t)N * 3 * HD, (size_t)d, (size_t)3 * HD}, b0, 0, H,
              (blockIdx.x - b0 * T) * 16, 16, N, d);
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
    // X's head columns past H are never written by the scores: zero, for the
    // mixes' A operand (again after a tile's O went through X)
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
    for (int jt = 0; jt < T; ++jt) {
      __syncthreads();    // X free; the next k buffer read by the previous chunk
      const int kb = jt & 1;
      wg::mbar_wait(&bar[kb], (kph >> kb) & 1);
      kph ^= 1u << kb;
      chunk_scores<KS, HPW>(Qs, Ks + kb * KB, X, H, d, warp, lane);
      // the next chunk's k rows (after the last, chunk 0's again for pass 2)
      fill(Ks + (kb ^ 1) * KB, &map, HD, jt + 1 < T ? 16 * (jt + 1) : 0, b, nbox,
           &bar[kb ^ 1], light, nlight);
      __syncthreads();
      float c[2 * HPW][4];
      mix_scores<HPW, NT>(c, X + warp * XR, Wl, lane);
      const bool ok0 = 16 * jt + gid < N, ok1 = 16 * jt + gid + 8 < N;
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
          const float mn = fmaxf(m[n][cc], mx);   // key 0 of the chunk is below N
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
    for (int jt = 0; jt < T; ++jt) {
      const int j0 = 16 * jt, kb = (T + jt) & 1, vb = (vb0 + jt) & 1;
      const int next = tile + gridDim.x;    // the block's next tile, if below tiles
      wg::mbar_wait(&bar[kb], (kph >> kb) & 1);
      kph ^= 1u << kb;
      chunk_scores<KS, HPW>(Qs, Ks + kb * KB, X, H, d, warp, lane);
      // the next chunk's k and v rows: this tile's, or the next tile's first
      if (jt + 1 < T || next < tiles) {
        const int rows = jt + 1 < T ? j0 + 16 : 0, bs = jt + 1 < T ? b : next / T;
        fill(Ks + (kb ^ 1) * KB, &map, HD, rows, bs, nbox, &bar[kb ^ 1], light, nlight);
        fill(Vs + (vb ^ 1) * KB, &map, 2 * HD, rows, bs, nbox, &bar[2 + (vb ^ 1)], light,
             nlight);
      }
      __syncthreads();
      // after the tile's last scores, the next tile's q rows
      if (jt + 1 == T && next < tiles) {
        const int nb = next / T;
        stage<KS>(Qs, PL, qkv, Strides{(size_t)N * 3 * HD, (size_t)d, (size_t)3 * HD}, nb, 0,
                  H, (next - nb * T) * 16, 16, N, d);
        cp_async_commit();
      }
      {
        float c1[2 * HPW][4];
        mix_scores<HPW, NT>(c1, X + warp * XR, Wl, lane);
        const bool ok0 = j0 + gid < N, ok1 = j0 + gid + 8 < N;
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
        if (probs != nullptr && r < N) {
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
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = n * 8 + 2 * tig + (e & 1);
            if (h >= H) continue;
            const bf16 hi = __float2bfloat16_rn(c2[n][e]);
            const int at = h * kPP + warp * kPL + gid + (e >> 1) * 8;
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
        p_frag(ahi, PH + h * kPP, kPL, 0, 0, lane);
        p_frag(alo, PLo + h * kPP, kPL, 0, 0, lane);
        // matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 8-15
        ldsm_x4_trans(bv, box_at(Vc, (lane & 7) + ((lane >> 3) & 1) * 8,
                                 h * d + (lane >> 4) * 8 + dt * 16));
        mma_bf16(o[it][0], ahi, bv[0], bv[1]);
        mma_bf16(o[it][0], alo, bv[0], bv[1]);
        mma_bf16(o[it][1], ahi, bv[2], bv[3]);
        mma_bf16(o[it][1], alo, bv[2], bv[3]);
      }
      __syncthreads();    // P', X and this v buffer free
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
    for (int idx = threadIdx.x; idx < 16 * words; idx += kThreads) {
      const int r = idx / words, w = idx - r * words;
      if (i0 + r < N)
        *reinterpret_cast<uint4*>(out + ((size_t)b * N + i0 + r) * HD + w * 8) =
            *reinterpret_cast<const uint4*>(Os + r * OL + w * 8);
    }
    __syncthreads();      // X free for the next tile
    vb0 ^= T & 1;
  }
}

template <int KS, int HPW, int NH, int ND>
int launch_fwd(const bf16* qkv, const bf16* wl, const bf16* ww, bf16* out, bf16* probs,
               int batch, int N, int H, int d, float scale, cudaStream_t s) {
  constexpr float kLog2e = 1.4426950408889634f;
  const size_t smem = layout(H, d).total;
  // qkv as [batch][N][3·H·d]: boxes of 64 columns x 16 rows of one sample
  const cuuint64_t dims[3] = {(cuuint64_t)3 * H * d, (cuuint64_t)N, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * H * d * 2, (cuuint64_t)N * 3 * H * d * 2};
  const cuuint32_t box[3] = {64, 16, 1};
  CUtensorMap map;
  if (!wg::make_tensor_map_nd(&map, qkv, 3, dims, strides, box)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tf_fwd_mma_kernel<KS, HPW, NH, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = pad16(N) / 16 * batch;
  tf_fwd_mma_kernel<KS, HPW, NH, ND><<<tiles < sms ? tiles : sms, kThreads, smem, s>>>(
      map, qkv, wl, ww, out, probs, batch, N, H, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

// Heads a warp's items span (pad16(H) / 16), 0 where the kernel does not take
// (H, d): d % 8 == 0 up to 64, H up to 24, 16 with d > 32.
__host__ inline int heads_per_warp(int H, int d) {
  const int ks = pad16(d) / 16, hpw = (H + 15) / 16;
  if (H < 1 || H > 24 || d < 8 || d % 8 || ks > 4 || (hpw == 2 && ks > 2)) return 0;
  return hpw;
}

}  // namespace

}  // namespace dc

// Shared memory of a block at (H, d), or -1 where the kernel does not take
// them (d % 8 == 0 up to 64, H up to 24, 16 with d > 32; any N).
DC_EXPORT long long dc_tf_fwd_mma_smem_bytes(int H, int d) {
  if (dc::heads_per_warp(H, d) == 0) return -1;
  return (long long)dc::layout(H, d).total;
}

// qkv: [batch·N, 3·H·d]; wl, ww: [H, H]; out: [batch·N, H·d]; all bf16, qkv
// and out 16-byte aligned.  probs: NULL, or [batch, H, N, N] bf16, 4-byte
// aligned, to fill.  dc_tf_fwd_mma_smem_bytes(H, d) must be >= 0 (the Python
// wrapper checks).
DC_EXPORT int dc_transform_attention_mma(const void* qkv, const void* wl, const void* ww,
                                         void* out, void* probs, int batch, int N, int H,
                                         int d, float scale, void* stream) {
  using dc::bf16;
  decltype(&dc::launch_fwd<1, 1, 0, 0>) const launchers[2][4] = {
      {dc::launch_fwd<1, 1, 0, 0>, dc::launch_fwd<2, 1, 0, 0>, dc::launch_fwd<3, 1, 0, 0>,
       dc::launch_fwd<4, 1, 0, 0>},
      {dc::launch_fwd<1, 2, 0, 0>, dc::launch_fwd<2, 2, 0, 0>, nullptr, nullptr}};
  const int hpw = dc::heads_per_warp(H, d), ks = dc::mma_attn::pad16(d) / 16;
  if (hpw == 0) return (int)cudaErrorInvalidValue;
  const auto launch = H == 24 && d == 32   ? dc::launch_fwd<2, 2, 24, 32>
                      : H == 12 && d == 64 ? dc::launch_fwd<4, 1, 12, 64>
                                           : launchers[hpw - 1][ks - 1];
  return launch((const bf16*)qkv, (const bf16*)wl, (const bf16*)ww, (bf16*)out, (bf16*)probs,
                batch, N, H, d, scale, (cudaStream_t)stream);
}
