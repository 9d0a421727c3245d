// The LN GEMMs on wgmma and TMA, one kernel template for K1, K2 and #8:
//   K1 (act 0):            u = (LN(x)·γ + β) · W (+ b)
//   K2 (act 1 / 2):        h = act((LN(x)·γ + β) · W + b), exact GELU or
//                          QuickGELU, h only
//   #8 (act 1 / 2, RES):   h, and beside it u and e = erf(u/√2) or σ(1.702 u)
// and, in every mode, the rows' LN mean and rstd (fp32 [rows]) for the
// backward.
//
// Replaces distillclip_tpu/ops/fc1_act.py:_dense_ln_kernel (K1: the students'
// norm1 + qkv projection, and the teachers' ln_1 + qkv; K1 with its
// statistics also serves fc1 under the fc1_res "u" knob), :_fc1_ln_h_kernel
// (K2: the lean norm2 + fc1 + activation of the frozen teachers and of
// serving) and :_fc1_ln_kernel (#8: the same under a gradient, with u, e,
// mean and rstd saved; the JAX package recombines h from the rounded (u, e)
// outside its kernel, here the epilogue writes it from the fp32 sum, the
// same bits as K2's h).
//
// Layouts: x [rows, C], W [C, N] row-major (the Flax Dense layout, kept by the
// port's converter), γ, β [C], b [N], h, u, e [rows, N]; all bf16.  mean,
// rstd [rows] fp32, written in every mode (into the caller's scratch in the
// lean ones), so that the lean and the statistics or residual modes run the
// same launches and give the same bits.
//
// Bound on the H100: operations, except #8, which writes three outputs.  At
// the image qkv (rows 12800, C 768, N 2304) the product is 45.3 GFLOP against
// 82 MB (0.046 ms at 989 TFLOP/s); at the image fc1 (N 3072) 60.4 GFLOP
// against 103 MB for K2 (0.061 ms) and 260 MB for #8 (0.078 ms at 3.35 TB/s).
//
// Design, two launches:
// 1. ln_stats_w16 (layer_norm.cu): the rows' mean and rstd, K4's design
//    without y (a warp a row, read once into registers); in blocks of the same
//    launch, W converted to an fp16 copy (3.5 MB in and out at qkv).  A GEMM
//    block owns 128 rows but one 256-column tile of N, so statistics computed
//    in the GEMM would be computed again by each of the N / 256 column blocks.
// 2. The product on wgmma_gemm.cuh's ring: 128 x 256 output tiles, 64 deep,
//    four TMA stages with 128-byte swizzle, one producer warpgroup and two
//    consumers.  TMA brings the raw bf16 x tile and the fp16 W slice.  Each
//    consumer thread loads its A fragment of each 16-deep step from the
//    swizzled x tile (ldmatrix), normalises it in fp32 with its two rows'
//    mean and rstd (fixed for the whole K loop, in registers) and the γ, β
//    of its columns (staged once in shared memory as their bf16 bits, a
//    fragment's four columns in one 16-byte word), two fp32 FMAs an element,
//    rounds it to fp16 and issues wgmma m64n256k16 with A from registers and
//    B = W16 from shared memory (MN-major), a stage's four as one group.  The
//    next stage's four fragments are made while a group runs (two stages of
//    fragments, 32 registers); a stage is released when its group has
//    completed.  The epilogue is dense_act.cu's (wg::epilogue_store<ACT,
//    RES>): bias and activation on the fp32 sums, one bf16 rounding of each
//    output, written as 64 x 256 slices into the freed ring (three a
//    warpgroup with RES, which fill it; γ/β sit past it) and stored as
//    16-byte words along rows.
//
// Precision, the constraint that decides the operand type: wgmma takes A and
// B of one type.  The TPU kernel rounds LN(x) to bf16 before its product;
// with the final bf16 store that exceeds a 1e-3 mean error against fp32 at
// the qkv width (tests/test_torch_dense_ln_rounding.py: about 1.0e-3 at C =
// 768, N = 2304, for rows of mean 0.5 and of mean 4).  fp16 keeps 3 more
// mantissa bits at the same tensor-core rate: LN(x)·γ + β is bounded by
// sqrt(C)·|γ| + |β|, far inside fp16's range, and every bf16 weight with |w|
// in [2^-14, 65504] converts to fp16 exactly (smaller ones lose < 2^-25 each).
// The same test (run as a script with 2048 rows) puts this route (fp16 A and
// W, fp32 sums, one bf16 store) at a mean error of 6.45e-4 and a largest
// error of 7.98e-3, against the limits 1e-3 and 1e-2; bf16 A as hi + lo (two
// products a step), which leaves little but the store's rounding, reads
// 6.32e-4 and 7.81e-3 for twice the tensor-core work.  The LN runs as
// ((x - mean)·rstd)·γ + β, never as a fold of mean into a column sum of W,
// whose error grows with |mean| / std of a row.  (x - mean)·rstd is formed
// in fp32 as x·rstd - mean·rstd (an off-centre row loses |mean|·rstd·2^-24,
// far below fp16's 2^-11), and the whole of ((x - mean)·rstd)·γ + β is
// rounded once.  γ and β applied in fp16 after an fp16 rounding of
// (x - mean)·rstd would take a third of the operations off a fragment, at
// the price of a second rounding of A: 1e-5 more mean error, and unit-scale
// outputs that cancel drift past 1e-2.
#include "wgmma_gemm.cuh"

namespace dc {

namespace {

using wg::BK;
using wg::BM;
using wg::BN;

// γ and β as bf16 pairs, zero past C up to the K loop's padded depth: slot
// 4g + j (g a 16-column group, j < 4) holds {γ, β} of columns 16g + 2j, + 1
// and of columns 16g + 2j + 8, + 9, the four columns of a fragment's lane.
__host__ __device__ inline int gb_slots(int C) { return (C + BK - 1) / BK * BK / 4; }

__host__ __device__ inline size_t k1_smem_bytes(int C) {
  return wg::kSmemBytes + (size_t)gb_slots(C) * sizeof(uint4);
}

// Two bf16 of one row (a register of an A fragment) normalised (nmr is
// -mean·rstd), scaled and shifted by the bf16 pairs γ2, β2 of their columns
// and rounded to an fp16 pair: lo is the smaller column.
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float nmr, float rstd, uint32_t g2,
                                            uint32_t b2) {
  const float lo = fmaf(fmaf(__uint_as_float(v << 16), rstd, nmr), __uint_as_float(g2 << 16),
                        __uint_as_float(b2 << 16));
  const float hi = fmaf(fmaf(__uint_as_float(v & 0xffff0000u), rstd, nmr),
                        __uint_as_float(g2 & 0xffff0000u), __uint_as_float(b2 & 0xffff0000u));
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment (m16n8k16 layout, the warp's 16 rows) of the 16-deep step
// kk of the x tile at `tile`, normalised.  `row_off` is the byte offset of
// this lane's ldmatrix row in the tile, `sw` that row's swizzle (row % 8),
// `half` which 8 columns the lane addresses; `col` the fragment's first
// column of x (c = col, col + 1 in a[0], a[1]; col + 8, col + 9 in a[2],
// a[3]); rows r and r + 8 in a[0], a[2] and a[1], a[3].
__device__ __forceinline__ void ln_fragment(const unsigned char* tile, int row_off, int sw,
                                            int half, int kk, int col, const uint4* gb,
                                            const float (&nmr)[2], const float (&rstd)[2],
                                            uint32_t (&a)[4]) {
  const uint32_t addr = wg::smem_u32(tile + row_off + (((2 * kk + half) ^ sw) << 4));
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr)
               : "memory");
  const uint4 g = gb[((col >> 4) << 2) | ((col >> 1) & 3)];   // its four columns' γ, β
  a[0] = ln_pair(x[0], nmr[0], rstd[0], g.x, g.y);
  a[1] = ln_pair(x[1], nmr[1], rstd[1], g.x, g.y);
  a[2] = ln_pair(x[2], nmr[0], rstd[0], g.z, g.w);
  a[3] = ln_pair(x[3], nmr[1], rstd[1], g.z, g.w);
}

// Where a consumer thread's fragments come from in a stage's x tile.
struct FragPlace {
  int row_off;   // byte offset of this lane's ldmatrix row in the tile
  int sw;        // that row's swizzle (row % 8)
  int half;      // which 8 columns of a 16-deep step the lane addresses
  int q2;        // the first of the lane's two columns in a fragment
};

// The four A fragments of stage kt (its x tile in ring slot kt % STAGES).
__device__ __forceinline__ void ln_stage(const wg::Ring& ring, const FragPlace& at, int kt,
                                         const uint4* gb, const float (&nmr)[2],
                                         const float (&rstd)[2], uint32_t (&a)[4][4]) {
  const unsigned char* tile = ring.base + (kt % wg::STAGES) * wg::kStageBytes;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    ln_fragment(tile, at.row_off, at.sw, at.half, kk, kt * BK + 16 * kk + at.q2, gb, nmr, rstd,
                a[kk]);
}

// One stage of the K loop with its fragments in a[P]: issue its four wgmma
// as one group; once the stage before has completed, release that stage and
// make the next stage's fragments in a[P ^ 1] while this group runs.
template <int P>
__device__ __forceinline__ void ln_step(const wg::Ring& ring, const FragPlace& at, int kt,
                                        int nk, const uint4* gb, const float (&nmr)[2],
                                        const float (&rstd)[2], uint32_t (&a)[2][4][4],
                                        float (&d)[128]) {
  const unsigned char* b = ring.base + (kt % wg::STAGES) * wg::kStageBytes + wg::kABytes;
  wg::fence_sums(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    // B: 8-row (k) groups 1024 bytes apart, 64-column boxes 8 KB apart, k16 =
    // two groups on
    wg::wgmma_m64n256k16_rs_f16(d, a[P][kk], wg::desc(b + kk * 2048, wg::kBBox, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wg::hold(a[P ^ 1]);
  if (kt > 0) wg::mbar_arrive(&ring.empty[(kt - 1) % wg::STAGES]);
  if (kt + 1 < nk) {
    wg::mbar_wait(&ring.full[(kt + 1) % wg::STAGES], ((kt + 1) / wg::STAGES) & 1);
    ln_stage(ring, at, kt + 1, gb, nmr, rstd, a[P ^ 1]);
  }
}

// Consumer warpgroup cw: its 64 rows of the tile over K = C, A normalised in
// registers, B = W16 from the ring.
__device__ __forceinline__ void ln_consume(const wg::Ring& ring, int cw, int C,
                                           const uint4* gb, const float (&nmr)[2],
                                           const float (&rstd)[2], float (&d)[128]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // ldmatrix: lanes 0-15 give rows 0-15 of the warp's 16 at a step's first 8
  // columns, lanes 16-31 the same rows at the next 8
  const int lrow = 16 * warp + (lane & 15);
  const FragPlace at{cw * (64 * BK * 2) + lrow * 128, lrow & 7, lane >> 4, 2 * (lane & 3)};
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  const int nk = (C + BK - 1) / BK;
  uint32_t a[2][4][4] = {};
  wg::mbar_wait(&ring.full[0], 0);
  ln_stage(ring, at, 0, gb, nmr, rstd, a[0]);
  for (int kt = 0; kt < nk; kt += 2) {
    ln_step<0>(ring, at, kt, nk, gb, nmr, rstd, a, d);
    if (kt + 1 < nk) ln_step<1>(ring, at, kt + 1, nk, gb, nmr, rstd, a, d);
  }
  wg::end_mainloop(d);
  wg::hold(a[0]);   // read by the last groups, which end_mainloop waited for
  wg::hold(a[1]);
}

// A consumer's part of the block up to its epilogue: γ and β staged in shared
// memory while the first stages load, its rows' statistics, the main loop; its
// sums in d.  Every kernel below keeps the producer's branch, with its return,
// in its own body: with one if and no path back, ptxas gives the consumers'
// code the registers that setmaxnreg grants them.
__device__ __forceinline__ void ln_consumer_sums(const wg::Ring& ring,
                                                 const bf16* __restrict__ gamma,
                                                 const bf16* __restrict__ beta,
                                                 const float* __restrict__ mean,
                                                 const float* __restrict__ rstd, int rows,
                                                 int C, int m0, float (&d)[128]) {
  const int t = threadIdx.x - 128, cw = t >> 7, lane = t & 31;
  uint4* gb = reinterpret_cast<uint4*>(wg::after_ring());
  for (int i = t; i < gb_slots(C); i += 256) {
    const int p = (i >> 2) * 8 + (i & 3);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = 2 * (p + 4 * k);
      if (c < C) {
        w[2 * k] = *reinterpret_cast<const uint32_t*>(gamma + c);
        w[2 * k + 1] = *reinterpret_cast<const uint32_t*>(beta + c);
      }
    }
    gb[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // this thread's rows of the accumulator and of its A fragments
  const int g0 = m0 + 64 * cw + 16 * ((t >> 5) & 3) + (lane >> 2);
  float nmr[2], rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = g0 + 8 * r < rows;     // past rows x is TMA's zeros
    rs[r] = in ? rstd[g0 + 8 * r] : 0.f;
    nmr[r] = in ? -mean[g0 + 8 * r] * rs[r] : 0.f;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");     // gb is written
  ln_consume(ring, cw, C, gb, nmr, rs, d);
}

template <int ACT, bool RES>
__global__ void __launch_bounds__(wg::kThreads, 1)
dense_ln_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, bf16* __restrict__ out_u,
                      bf16* __restrict__ out_e, int rows, int C, int N) {
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<false>(ring, &tx, &tw, m0, n0, C);
    return;
  }
  wg::consumer_regs();
  float d[128];
  ln_consumer_sums(ring, gamma, beta, mean, rstd, rows, C, m0, d);
  wg::epilogue_store<ACT, RES>(d, bias, out, out_u, out_e, m0, n0, rows, N);
}

// The product of K1, K2, #8 or one of EVA-02's modes: `kernel` on the grid of
// BM x BN output tiles, with the tensor maps of x and of W's fp16 copy, the
// ring and γ/β's staging in shared memory, and `args` after the two maps.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const void* x, const void* w16, int rows, int C, int N,
           cudaStream_t s, Args... args) {
  CUtensorMap tx, tw;
  if (!wg::make_tensor_map(&tx, x, C, rows, BK, BM) ||
      !wg::make_tensor_map(&tw, w16, N, C, 64, BK, CU_TENSOR_MAP_DATA_TYPE_FLOAT16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k1_smem_bytes(C);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (rows + BM - 1) / BM);
  kernel<<<grid, wg::kThreads, smem, s>>>(tx, tw, args...);
  return (int)cudaGetLastError();
}

// ---- EVA-02's modes ------------------------------------------------------------
//
// The blocks of EVA-02-CLIP's vision tower (arXiv:2303.11331) take three more
// forward modes of the LN GEMM, each a kernel of its own so that the trace
// tells them apart and the instances above stay as they are:
//   rotary (K1r):  u = (LN(x)·γ + β)·W + b, then the 2-D rotary embedding on
//                  the q and k columns of the fused rows, on the fp32 sums
//                  before the one bf16 rounding (EVA rounds q and k to bf16,
//                  rotates, and rounds again);
//   SwiGLU (K2g):  over W = [W1 | W2] interleaved column by column, each sum
//                  pair (x1_j, x2_j) becomes h_j = silu(x1_j + b1_j)·(x2_j + b2_j),
//                  written at half width;
//   width (K1w):   K1 over rows padded with zeros past their true width, the
//                  LayerNorm's moments over the true width (EVA's LN_ffn over
//                  the 2730 SwiGLU channels, padded to 2752 for the tiles).
// The main loop is K1's, with the LN applied to the A fragments in registers;
// K1r's and K2g's epilogues are their own, K1w's is K1's.  The three take
// their statistics (and W's fp16 copy) from a launch of their own,
// ln_stats_width_w16 (layer_norm.cu: the moments over a width, which is C for
// K1r and K2g), so that the trace charges it to them and not to K1.  Bound as
// K1 and K2: operations (at EVA-L's 263,168 rows, qkv 1.66 TFLOP against
// 2.2 GB; fc 2.97 TFLOP against 2.0 GB; w3 1.48 TFLOP against 2.0 GB).

// Where a consumer thread's sums lie: rows ra, ra + 8 of its warpgroup's 64
// (row m0 + 64·cw + ra of the output), columns c = 8j + 2q, c + 1 of the tile
// in d[4j + 2r], d[4j + 2r + 1] (r the row of the two), as epilogue_store has
// them.
struct SumPlace {
  int cw, ti, q, ra;
};

__device__ __forceinline__ SumPlace sum_place() {
  const int t = threadIdx.x - 128, lane = t & 31;
  return {t >> 7, t & 127, lane & 3, ((t >> 5) & 3) * 16 + (lane >> 2)};
}

// K1r's epilogue: u = sum + b on every column, then on the columns below
// `rot` (the q and k of the fused rows) each pair (2i, 2i + 1) of a head of
// `hd` columns, in the row of patch p = row % seq - 1 (the class row, p = -1,
// is not turned), turned by the angle whose (cos, sin) is cs[p·hd/2 + i]:
//   u'_2i = u_2i·cos - u_2i+1·sin,   u'_2i+1 = u_2i+1·cos + u_2i·sin
// (EVA's rotate_half on interleaved pairs).  A pair is a thread's own two sums.
__device__ __forceinline__ void epilogue_store_rope(const float (&d)[128],
                                                    const bf16* __restrict__ bias,
                                                    const float2* __restrict__ cs,
                                                    bf16* __restrict__ out, int m0, int n0,
                                                    int rows, int N, int seq, int hd,
                                                    int rot) {
  const SumPlace at = sum_place();
  bf16* bh = wg::epilogue_buffer(0, at.cw);
  int patch[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = m0 + 64 * at.cw + at.ra + 8 * r;
    patch[r] = g < rows ? g % seq - 1 : -1;
  }
  const int half = hd >> 1;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * at.q, n = n0 + c;
    float b0 = 0.f, b1 = 0.f;
    if (n < N) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n);
      b0 = __low2float(bb);
      b1 = __high2float(bb);
    }
    const int pair = n < rot ? (n % hd) >> 1 : -1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float u0 = d[4 * j + 2 * r] + b0, u1 = d[4 * j + 2 * r + 1] + b1;
      if (pair >= 0 && patch[r] >= 0) {
        const float2 f = cs[patch[r] * half + pair];
        const float v0 = u0 * f.x - u1 * f.y;
        u1 = u1 * f.x + u0 * f.y;
        u0 = v0;
      }
      *reinterpret_cast<__nv_bfloat162*>(bh + wg::epilogue_index(at.ra + 8 * r, c)) =
          __floats2bfloat162_rn(u0, u1);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + at.cw) : "memory");
  wg::store_slice(bh, out, m0 + 64 * at.cw, n0, rows, N, at.ti);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
dense_ln_rope_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           const bf16* __restrict__ bias, const float2* __restrict__ cs,
                           bf16* __restrict__ out, int rows, int C, int N, int seq, int hd,
                           int rot) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<false>(ring, &tx, &tw, m0, n0, C);
    return;
  }
  wg::consumer_regs();
  float d[128];
  ln_consumer_sums(ring, gamma, beta, mean, rstd, rows, C, m0, d);
  epilogue_store_rope(d, bias, cs, out, m0, n0, rows, N, seq, hd, rot);
}

// Element (r, c) of a half-width epilogue slice: 64 rows of BN / 2 bf16, the
// 16-byte word c / 8 of row r at word (c / 8) ^ (r % 8).
__device__ __forceinline__ int half_index(int r, int c) {
  return r * (BN / 2) + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// K2g's epilogue: the thread's sum pair (c, c + 1) is (x1_j, x2_j) of output
// column j = (n0 + c) / 2; h_j = silu(x1_j + b1_j)·(x2_j + b2_j) in fp32, one
// bf16 rounding, into a half-width slice stored along rows of out [rows, N / 2].
__device__ __forceinline__ void epilogue_store_swiglu(const float (&d)[128],
                                                      const bf16* __restrict__ bias,
                                                      bf16* __restrict__ out, int m0, int n0,
                                                      int rows, int N) {
  const SumPlace at = sum_place();
  bf16* bh = wg::epilogue_buffer(0, at.cw);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * at.q;
    float b0 = 0.f, b1 = 0.f;
    if (n0 + c < N) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c);
      b0 = __low2float(bb);
      b1 = __high2float(bb);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x1 = d[4 * j + 2 * r] + b0, x2 = d[4 * j + 2 * r + 1] + b1;
      bh[half_index(at.ra + 8 * r, c >> 1)] = __float2bfloat16(x1 / (1.f + __expf(-x1)) * x2);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + at.cw) : "memory");
  const int nh = N >> 1, m0w = m0 + 64 * at.cw;
#pragma unroll 4
  for (int idx = at.ti; idx < 64 * (BN / 16); idx += 128) {
    const int r = idx / (BN / 16), c = idx % (BN / 16);
    const int g = m0w + r, col = (n0 >> 1) + c * 8;
    if (g < rows && col < nh)
      *reinterpret_cast<uint4*>(out + (size_t)g * nh + col) =
          *reinterpret_cast<const uint4*>(bh + r * (BN / 2) + ((c ^ (r & 7)) << 3));
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1)
dense_swiglu_ln_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw,
                             const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             const bf16* __restrict__ bias, bf16* __restrict__ out, int rows,
                             int C, int N) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<false>(ring, &tx, &tw, m0, n0, C);
    return;
  }
  wg::consumer_regs();
  float d[128];
  ln_consumer_sums(ring, gamma, beta, mean, rstd, rows, C, m0, d);
  epilogue_store_swiglu(d, bias, out, m0, n0, rows, N);
}

// K1w's product: K1's (act 0, with a bias) behind the statistics over the true
// width, under a name of its own so that the trace tells it from K1's.
__global__ void __launch_bounds__(wg::kThreads, 1)
dense_ln_width_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap tw,
                            const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                            const float* __restrict__ mean, const float* __restrict__ rstd,
                            const bf16* __restrict__ bias, bf16* __restrict__ out, int rows,
                            int C, int N) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<false>(ring, &tx, &tw, m0, n0, C);
    return;
  }
  wg::consumer_regs();
  float d[128];
  ln_consumer_sums(ring, gamma, beta, mean, rstd, rows, C, m0, d);
  wg::epilogue_store<0, false>(d, bias, out, nullptr, nullptr, m0, n0, rows, N);
}

}  // namespace

}  // namespace dc

// Shared memory of the product's block for width C; the wrapper refuses a C
// whose γ/β staging does not fit beside the ring.
DC_EXPORT long long dc_dense_ln_wgmma_smem_bytes(int C) { return (long long)dc::k1_smem_bytes(C); }

// The LN GEMM: out [rows, N] = u = (LN(x)·γ + β)·W (+ b) with act 0 (K1), h =
// act(u) with act 1 (exact GELU) or 2 (QuickGELU) (K2), and with res 1 (act 1
// or 2 only, #8) also u and e into out_u and out_e; mean, rstd [rows] fp32 in
// every mode.  x [rows, C], w [C, N], gamma, beta [C], bias [N] (NULL only with
// act 0), outputs: bf16, 16-byte aligned; w16 [C, N] fp16 scratch; C % 32 ==
// 0, N % 8 == 0, 1 <= rows <= 65535·128 (the Python wrapper checks these).
// Two launches: the statistics (with W's fp16 copy), then the product.
DC_EXPORT int dc_dense_ln_wgmma(const void* x, const void* gamma, const void* beta,
                                const void* w, void* w16, const void* bias, void* out,
                                void* out_u, void* out_e, void* mean, void* rstd, int rows,
                                int C, int N, float eps, int act, int res, void* stream) {
  using namespace dc;
  if (act < 0 || act > 2 || res < 0 || res > 1 || (act == 0 && res))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = ln_stats_w16(x, (float*)mean, (float*)rstd, rows, C, eps, w, w16,
                         (long long)C * N, s);
  if (err != 0) return err;
  const auto run = [&](auto kernel) {
    return launch(kernel, x, w16, rows, C, N, s, (const bf16*)gamma, (const bf16*)beta,
                  (const float*)mean, (const float*)rstd, (const bf16*)bias, (bf16*)out,
                  (bf16*)out_u, (bf16*)out_e, rows, C, N);
  };
  switch (act * 2 + res) {
    case 0: return run(dense_ln_wgmma_kernel<0, false>);
    case 2: return run(dense_ln_wgmma_kernel<1, false>);
    case 3: return run(dense_ln_wgmma_kernel<1, true>);
    case 4: return run(dense_ln_wgmma_kernel<2, false>);
    default: return run(dense_ln_wgmma_kernel<2, true>);
  }
}

// K1r: out [rows, N] = (LN(x)·γ + β)·W + b with the rotary turn on the
// columns below rot (a multiple of hd): rows are seq tokens a sample, the
// first the class token; cs [seq - 1, hd / 2] (cos, sin) fp32 pairs.  Takes
// what dc_dense_ln_wgmma takes with act 0 and a bias, and hd even.
DC_EXPORT int dc_dense_ln_rope_wgmma(const void* x, const void* gamma, const void* beta,
                                     const void* w, void* w16, const void* bias,
                                     const void* cs, void* out, void* mean, void* rstd,
                                     int rows, int C, int N, float eps, int seq, int hd,
                                     int rot, void* stream) {
  using namespace dc;
  if (bias == nullptr || seq < 1 || hd < 2 || hd % 2 || rot % hd || rot > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = ln_stats_width_w16(x, (float*)mean, (float*)rstd, rows, C, C, eps, w, w16,
                               (long long)C * N, s);
  if (err != 0) return err;
  return launch(dense_ln_rope_wgmma_kernel, x, w16, rows, C, N, s, (const bf16*)gamma,
                (const bf16*)beta, (const float*)mean, (const float*)rstd, (const bf16*)bias,
                (const float2*)cs, (bf16*)out, rows, C, N, seq, hd, rot);
}

// K2g: out [rows, N / 2], h_j = silu(u_2j)·u_2j+1 with u = (LN(x)·γ + β)·W + b,
// W's columns W1 and W2 interleaved (and b's); N % 16 == 0, otherwise as
// dc_dense_ln_wgmma with a bias.
DC_EXPORT int dc_dense_swiglu_ln_wgmma(const void* x, const void* gamma, const void* beta,
                                       const void* w, void* w16, const void* bias, void* out,
                                       void* mean, void* rstd, int rows, int C, int N,
                                       float eps, void* stream) {
  using namespace dc;
  if (bias == nullptr || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = ln_stats_width_w16(x, (float*)mean, (float*)rstd, rows, C, C, eps, w, w16,
                               (long long)C * N, s);
  if (err != 0) return err;
  return launch(dense_swiglu_ln_wgmma_kernel, x, w16, rows, C, N, s, (const bf16*)gamma,
                (const bf16*)beta, (const float*)mean, (const float*)rstd, (const bf16*)bias,
                (bf16*)out, rows, C, N);
}

// K1w: out [rows, N] = (LN_width(x)·γ + β)·W + b, the moments over each row's
// first `width` columns of C (zero past it, as γ, β and W's rows there);
// otherwise as dc_dense_ln_wgmma with act 0 and a bias.
DC_EXPORT int dc_dense_ln_width_wgmma(const void* x, const void* gamma, const void* beta,
                                      const void* w, void* w16, const void* bias, void* out,
                                      void* mean, void* rstd, int rows, int C, int N,
                                      float eps, int width, void* stream) {
  using namespace dc;
  if (bias == nullptr || width < 1 || width > C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = ln_stats_width_w16(x, (float*)mean, (float*)rstd, rows, C, width, eps, w, w16,
                               (long long)C * N, s);
  if (err != 0) return err;
  return launch(dense_ln_width_wgmma_kernel, x, w16, rows, C, N, s, (const bf16*)gamma,
                (const bf16*)beta, (const float*)mean, (const float*)rstd, (const bf16*)bias,
                (bf16*)out, rows, C, N);
}
