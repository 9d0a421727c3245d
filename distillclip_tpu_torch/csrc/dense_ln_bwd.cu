// #9, the backward of the LayerNorm-prologue GEMMs (K1 and K2's residual
// mode), on wgmma and TMA, with its row sums across a thread-block cluster.
//
// Replaces distillclip_tpu/ops/fc1_act.py:_dln_bwd_kernel.  From du (the
// gradient of u = (LN(x)·γ + β) · W + b) it makes, in one pass,
//
//   dxn = du · Wᵀ                           [rows, C] fp32, never in device memory
//   x̂   = (x - mean) · rstd                 (mean, rstd saved by the forward)
//   xn  = x̂ · γ + β                         bf16 out, the operand of dW = xnᵀ · du
//   dγ  = Σ_rows dxn · x̂,   dβ = Σ_rows dxn  fp32 [C]
//   dx̂  = dxn · γ
//   dx  = rstd · (dx̂ - m1 - x̂ · m2),  m1 = mean_c(dx̂), m2 = mean_c(dx̂ · x̂)   bf16 out
//
// In its activation mode (K2's backward: ACT 1, exact GELU, or 2, QuickGELU)
// it takes dh, the gradient of h = act(u), with u and, with HAS_E, the saved
// e = erf(u/√2) or σ(1.702 u) (without it, e is recomputed from u in fp32),
// and makes du = bf16(dh · act'(u)) itself, in registers, as the A operand of
// du · Wᵀ, with the fp32 formula of the JAX package's _dense_act_ln_bwd; the
// cluster's rank-0 block also stores that du, the same bits, for dW.  The
// JAX package forms du in XLA before its kernel.  dW and db stay outside, as
// in the JAX package.
//
// Layouts: x, dx, xn [rows, C]; W [C, N] row-major; du (or dh, u, e) [rows,
// N]; γ, β [C]; all bf16.  mean, rstd [rows] fp32.  For du · Wᵀ the
// contraction runs over N, along which a row of W is contiguous: W as stored
// is a K-major B operand [C rows of N], read by TMA in boxes of 64 (N) x 256
// (C).  Operands bf16 (du has no bound on its range), sums fp32.
//
// Bound on the H100: operations (2·rows·C·N flops against ~2·rows·(3C + N)
// bytes of x, du, dx, xn; ~2·rows·(3C + 4N) in the activation mode).  A
// block reads its band's A tiles and W's slice from L2, so L2 bandwidth, not
// HBM, is what the blocks share.
//
// Design: the main loop is wgmma_gemm.cuh's (128 x 256 output tiles of dxn,
// 64 deep, a four-stage TMA ring, one producer and two consumer warpgroups;
// A = du K-major, B = W K-major).  In the activation mode the A side of a
// stage is two or three tiles (dh, u, e), so A and B take rings of their
// own (three stages of A tiles, two of W slices: 208 KB with e), filled by
// two producer threads: a stage's A tiles are released as soon as the
// consumers have made their fragments from them (ldmatrix, the fp32 formula,
// one bf16 rounding), while its W slice waits for its wgmma group; the next
// stage's fragments are made while a group runs, as in K1
// (dense_ln_wgmma.cu).  Every block of a cluster makes the band's du from its
// own loads (the peers' loads of the same tiles hit L2).  The two row moments
// need all C columns of
// a row, and a 128 x 256 tile already fills a consumer's registers, so the
// ⌈C/256⌉ blocks of a 128-row band form one thread-block cluster along C (3
// at C = 768; at most 8, C <= 2048).  The epilogue runs on the fp32 sums in
// registers.  TMA brings the block's 128 x 256 x tile into the freed ring (it
// asked for it to be brought into L2 as the block started); γ and β were
// staged in shared memory while the first stages loaded.  It writes xn, and
// forms
// * the tile's row partials of dx̂ and dx̂·x̂, summed in a thread, then over
//   its quad, into the block's shared memory; after a cluster barrier each
//   block reads its peers' partials through distributed shared memory and
//   adds them in cluster-rank order, so that every block of the cluster gets
//   the same m1 and m2 bits; then it writes dx from the registers (dx̂ kept
//   in place of dxn) over the x tile, and stores it from there.  A second
//   cluster barrier before exit keeps every block's shared memory alive while
//   a peer may read it;
// * the tile's column partials of dxn·x̂ and dxn: a thread's two rows, then a
//   reduce-scatter over the eight row groups of a warp (shuffles, each sum
//   formed by one lane), then the eight warps in order, into [⌈rows/128⌉, 2C]
//   fp32, which reduce_partials (layer_norm.cu) adds over the bands in a
//   fixed order.  Two calls give the same bits.
// dx is formed from the fp32 dxn with one bf16 rounding: a partial dx rounded
// to bf16 and corrected later could be one bf16 step off at |dx| in [4, 8).
// The TPU kernel carries dγ/dβ across its sequential grid and holds whole
// rows in VMEM; blocks here run in no order and hold 256 columns each.
#include "wgmma_gemm.cuh"

namespace dc {

namespace {

using wg::BK;
using wg::BM;
using wg::BN;

// Blocks a cluster may hold without the non-portable size.
constexpr int kMaxCluster = 8;
// Past the ring: the block's row partials {Σ dx̂, Σ dx̂·x̂} per row of the
// tile, γ and β of its columns, the x tile's mbarrier.
constexpr int kExtraBytes = BM * sizeof(float2) + (BN / 2) * sizeof(float4) + 16;

// ---- the activation mode's rings ---------------------------------------------

constexpr int kAStages = 3, kBStages = 2;
constexpr int kBSlice = BN * BK * 2;      // W's 256 x 64 K-major slice: 32 KB
constexpr float kInvSqrt2 = 0.70710678118654752f, kInvSqrt2Pi = 0.39894228040143268f;

// A stages of dh, u and (HAS_E) e tiles, 128 x 64 each; B stages of W
// slices; then full / empty mbarriers of each.  The empty ones count the
// 256 consumer threads.  Places are offsets from the ring's base, which the
// compiler forms again where it needs them rather than keeping them live.
template <bool HAS_E>
struct ActRing {
  static constexpr int kAStageBytes = (HAS_E ? 3 : 2) * wg::kABytes;
  static constexpr int kBOffset = kAStages * kAStageBytes;
  static constexpr int kBarOffset = kBOffset + kBStages * kBSlice;
  static constexpr size_t kBytes = kBarOffset + 2 * (kAStages + kBStages) * 8;

  __device__ static unsigned char* a(int s) { return wg::ring_base() + s * kAStageBytes; }
  __device__ static unsigned char* b(int s) { return wg::ring_base() + kBOffset + s * kBSlice; }
  __device__ static uint64_t* bar(int i) {
    return reinterpret_cast<uint64_t*>(wg::ring_base() + kBarOffset) + i;
  }
  __device__ static uint64_t* full_a(int s) { return bar(s); }
  __device__ static uint64_t* empty_a(int s) { return bar(kAStages + s); }
  __device__ static uint64_t* full_b(int s) { return bar(2 * kAStages + s); }
  __device__ static uint64_t* empty_b(int s) { return bar(2 * kAStages + kBStages + s); }
};

// The ring and its barriers of a kernel instance (ACT 0: wgmma_gemm.cuh's).
template <int ACT, bool HAS_E>
__host__ __device__ constexpr size_t ring_bytes() {
  return ACT == 0 ? (size_t)wg::STAGES * wg::kStageBytes + 2 * wg::STAGES * 8
                  : ActRing<HAS_E>::kBytes;
}

template <int ACT, bool HAS_E>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<ACT, HAS_E>() + kExtraBytes + 1024;
}

static_assert(smem_bytes<1, true>() <= 232448, "the activation mode's rings fit a block");
static_assert(ActRing<false>::kBytes >= 4 * (64 * BN * 2) + 2 * 8 * BN * 4,
              "the epilogue's x tile, xn slices and column partials fit the rings");

// Initialise the rings' barriers; a block-wide barrier, as wg::ring_init.
template <bool HAS_E>
__device__ __forceinline__ void act_ring_init() {
  using R = ActRing<HAS_E>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      wg::mbar_init(R::full_a(s), 1);
      wg::mbar_init(R::empty_a(s), 256);
    }
    for (int s = 0; s < kBStages; ++s) {
      wg::mbar_init(R::full_b(s), 1);
      wg::mbar_init(R::empty_b(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Producer thread 0: the band's dh, u (and e) tiles, rows m0.., over N.
template <bool HAS_E>
__device__ __forceinline__ void act_produce_a(const CUtensorMap* tdh, const CUtensorMap* tu,
                                              const CUtensorMap* te, int m0, int N) {
  using R = ActRing<HAS_E>;
  const int nk = (N + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kAStages;
    if (kt >= kAStages) wg::mbar_wait(R::empty_a(s), ((kt / kAStages) - 1) & 1);
    unsigned char* st = R::a(s);
    wg::mbar_expect_tx(R::full_a(s), R::kAStageBytes);
    wg::tma_load(st, tdh, kt * BK, m0, R::full_a(s));
    wg::tma_load(st + wg::kABytes, tu, kt * BK, m0, R::full_a(s));
    if (HAS_E) wg::tma_load(st + 2 * wg::kABytes, te, kt * BK, m0, R::full_a(s));
  }
}

// Producer thread 32: W's slices of the block's columns c0.., over N.
template <bool HAS_E>
__device__ __forceinline__ void act_produce_b(const CUtensorMap* tw, int c0, int N) {
  using R = ActRing<HAS_E>;
  const int nk = (N + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kBStages;
    if (kt >= kBStages) wg::mbar_wait(R::empty_b(s), ((kt / kBStages) - 1) & 1);
    wg::mbar_expect_tx(R::full_b(s), kBSlice);
    wg::tma_load(R::b(s), tw, kt * BK, c0, R::full_b(s));
  }
}

// du = dh · act'(u) in fp32, each operation rounded as the plain version's
// eager ones (no contraction into FMAs); e recomputed from u without HAS_E.
template <int ACT, bool HAS_E>
__device__ __forceinline__ float du_of(float dh, float u, float e) {
  if (ACT == 1) {
    if (!HAS_E) e = erff(__fmul_rn(u, kInvSqrt2));
    const float a = __fmul_rn(0.5f, __fadd_rn(1.0f, e));
    const float g = __fmul_rn(__fmul_rn(u, expf(__fmul_rn(__fmul_rn(-0.5f, u), u))),
                              kInvSqrt2Pi);
    return __fmul_rn(dh, __fadd_rn(a, g));
  }
  if (!HAS_E) e = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, u))));
  const float g = __fmul_rn(__fmul_rn(__fmul_rn(1.702f, u), e), __fsub_rn(1.0f, e));
  return __fmul_rn(dh, __fadd_rn(e, g));
}

// A register of bf16 pairs (lo the smaller column) from the same places of
// dh, u and e.
template <int ACT, bool HAS_E>
__device__ __forceinline__ uint32_t du_pair(uint32_t h, uint32_t u, uint32_t e) {
  const float lo = du_of<ACT, HAS_E>(__uint_as_float(h << 16), __uint_as_float(u << 16),
                                     __uint_as_float(e << 16));
  const float hi = du_of<ACT, HAS_E>(__uint_as_float(h & 0xffff0000u),
                                     __uint_as_float(u & 0xffff0000u),
                                     __uint_as_float(e & 0xffff0000u));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix4(const unsigned char* p, uint32_t (&x)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(wg::smem_u32(p))
               : "memory");
}

// Where a consumer thread's du fragments come from and go to.
struct DuPlace {
  int row_off;   // byte offset of this lane's ldmatrix row in an A tile
  int sw;        // that row's swizzle (row % 8)
  int half;      // which 8 columns of a 16-deep step the lane addresses
  int q2;        // the first of the lane's two columns in a fragment
  int g0;        // the first of the fragment's two rows (g0, g0 + 8) in du
  int rows, N;
  bf16* du;      // where du is stored (the cluster's rank 0), else null
};

// The four du fragments (m16n8k16 A layout) of stage kt, from its dh, u and
// e tiles (ring slot kt % kAStages); stored too where at.du is set.
template <int ACT, bool HAS_E>
__device__ __forceinline__ void act_stage(const DuPlace& at, int kt, uint32_t (&a)[4][4]) {
  const unsigned char* tile = ActRing<HAS_E>::a(kt % kAStages) + at.row_off;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int off = ((2 * kk + at.half) ^ at.sw) << 4;
    uint32_t h[4], u[4], e[4] = {0u, 0u, 0u, 0u};
    ldmatrix4(tile + off, h);
    ldmatrix4(tile + wg::kABytes + off, u);
    if (HAS_E) ldmatrix4(tile + 2 * wg::kABytes + off, e);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = du_pair<ACT, HAS_E>(h[i], u[i], e[i]);
    if (at.du != nullptr) {
      // a[kk][i]: row g0 + 8 (i % 2), columns col + 8 (i / 2), + 1
      const int col = kt * BK + 16 * kk + at.q2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = at.g0 + 8 * (i & 1), c = col + 8 * (i >> 1);
        if (g < at.rows && c < at.N)
          *reinterpret_cast<uint32_t*>(at.du + (size_t)g * at.N + c) = a[kk][i];
      }
    }
  }
}

// One stage of the K loop with its fragments in a[P]: issue its four wgmma
// as one group once its W slice is in; once the stage before has completed,
// release that W slice, and make the next stage's fragments in a[P ^ 1]
// while this group runs, releasing their A tiles.
template <int ACT, bool HAS_E, int P>
__device__ __forceinline__ void act_step(const DuPlace& at, int kt, int nk,
                                         uint32_t (&a)[2][4][4], float (&d)[128]) {
  using R = ActRing<HAS_E>;
  const int sb = kt % kBStages;
  wg::mbar_wait(R::full_b(sb), (kt / kBStages) & 1);
  const unsigned char* b = R::b(sb);
  wg::fence_sums(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    // a K-major B: rows of 128 bytes, 8-row groups 1024 bytes apart, k16 = 32 bytes on
    wg::wgmma_m64n256k16_rs_bf16_kmajor(d, a[P][kk], wg::desc(b + kk * 32, 16, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wg::hold(a[P ^ 1]);
  if (kt > 0) wg::mbar_arrive(R::empty_b((kt - 1) % kBStages));
  if (kt + 1 < nk) {
    const int sa = (kt + 1) % kAStages;
    wg::mbar_wait(R::full_a(sa), ((kt + 1) / kAStages) & 1);
    act_stage<ACT, HAS_E>(at, kt + 1, a[P ^ 1]);
    wg::mbar_arrive(R::empty_a(sa));
  }
}

// Consumer warpgroup cw in the activation mode: its 64 rows of dxn over K =
// N, A = du made in registers, B = W from the ring; d as wg::consume's.
template <int ACT, bool HAS_E>
__device__ __forceinline__ void act_consume(int cw, int m0, int rows, int N, bf16* du,
                                            float (&d)[128]) {
  using R = ActRing<HAS_E>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // ldmatrix: lanes 0-15 give rows 0-15 of the warp's 16 at a step's first 8
  // columns, lanes 16-31 the same rows at the next 8
  const int lrow = 16 * warp + (lane & 15);
  const DuPlace at{cw * (64 * BK * 2) + lrow * 128, lrow & 7, lane >> 4, 2 * (lane & 3),
                   m0 + 64 * cw + 16 * warp + (lane >> 2), rows, N, du};
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  const int nk = (N + BK - 1) / BK;
  uint32_t a[2][4][4] = {};
  wg::mbar_wait(R::full_a(0), 0);
  act_stage<ACT, HAS_E>(at, 0, a[0]);
  wg::mbar_arrive(R::empty_a(0));
  for (int kt = 0; kt < nk; kt += 2) {
    act_step<ACT, HAS_E, 0>(at, kt, nk, a, d);
    if (kt + 1 < nk) act_step<ACT, HAS_E, 1>(at, kt + 1, nk, a, d);
  }
  wg::end_mainloop(d);
  wg::hold(a[0]);   // read by the last groups, which end_mainloop waited for
  wg::hold(a[1]);
}

// The warps' column partials after the main loop, in the ring past the two
// output slices of each warpgroup: [8 warps][dγ, dβ][BN] fp32 (16 KB).
__device__ __forceinline__ float* column_partials() {
  return reinterpret_cast<float*>(wg::ring_base() + 4 * (64 * BN * 2));
}

// v[4·js + q] (q: dγ at columns c and c + 1, dβ at c and c + 1; js the pair's
// two column groups j = 2·jp + js) summed over the eight lanes of a warp that
// share lane % 4, one sum a lane: lane bit 4 picks js, bit 3 q / 2, bit 2 q % 2.
// Each sum is added by one lane, in one order.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? v[i] : v[i + 4];
    w4[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? w4[i] : w4[i + 2];
    w2[i] = (b3 ? w4[i + 2] : w4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? w2[0] : w2[1];
  return (b2 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Byte offset of element (r, col) of the block's x tile as TMA lays it in
// shared memory: four boxes of 128 rows x 64 columns, 128-byte swizzle.
__device__ __forceinline__ int x_offset(int r, int col) {
  return (col >> 6) * (BM * 128) + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// ACT 0: du from device memory (tdu), tu and te unused; ACT 1 / 2: tdu is dh,
// and du_out (the cluster's rank 0 stores du) is set.
template <int ACT, bool HAS_E>
__global__ void __launch_bounds__(wg::kThreads, 1)
dense_ln_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tdu,
                          const __grid_constant__ CUtensorMap tw,
                          const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tu,
                          const __grid_constant__ CUtensorMap te,
                          const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                          const float* __restrict__ mean, const float* __restrict__ rstd,
                          bf16* __restrict__ dx, bf16* __restrict__ xn,
                          bf16* __restrict__ du_out, float* __restrict__ partial, int rows,
                          int C, int N) {
  // the cluster is the grid's x extent: every column tile of a row band
  const int cs = gridDim.x;
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  unsigned char* extra = wg::ring_base() + ring_bytes<ACT, HAS_E>();
  float2* rowpart = reinterpret_cast<float2*>(extra);
  float4* gb = reinterpret_cast<float4*>(extra + BM * sizeof(float2));
  uint64_t* xbar = reinterpret_cast<uint64_t*>(extra + kExtraBytes - 16);
  if (threadIdx.x == 0) {
    wg::mbar_init(xbar, 1);
    // the epilogue's x tile, into L2 while the main loop runs
    for (int b = 0; b < BN / 64; ++b) wg::tma_prefetch_l2(&tx, c0 + 64 * b, m0);
  }
  wg::Ring ring;
  if constexpr (ACT == 0) ring = wg::ring_init();
  else act_ring_init<HAS_E>();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if constexpr (ACT == 0) {
      if (threadIdx.x == 0) wg::produce<true>(ring, &tdu, &tw, m0, c0, N);
    } else {
      if (threadIdx.x == 0) act_produce_a<HAS_E>(&tdu, &tu, &te, m0, N);
      if (threadIdx.x == 32) act_produce_b<HAS_E>(&tw, c0, N);
    }
    __syncwarp();
    // the producer's warps take part in both cluster barriers
    wg::cluster_arrive();
    wg::cluster_wait();
    wg::cluster_arrive();
    wg::cluster_wait();
    return;
  }
  wg::consumer_regs();
  const int t = threadIdx.x - 128, cw = t >> 7, ti = t & 127, lane = t & 31;
  const int ra = 64 * cw + ((t >> 5) & 3) * 16 + (lane >> 2);   // rows ra, ra + 8 of the tile
  const int cq = 2 * (lane & 3);           // d[4j ..] holds columns 8j + cq, + 1
  // γ and β of the block's columns as fp32 {γ_c, γ_c+1, β_c, β_c+1}, while
  // the first stages load
  if (t < BN / 2) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + 2 * t < C) {
      const float2 g = load_pair(gamma + c0 + 2 * t), b = load_pair(beta + c0 + 2 * t);
      v = make_float4(g.x, g.y, b.x, b.y);
    }
    gb[t] = v;
  }
  float d[128];
  // the main loop's closing barrier also publishes gb
  if constexpr (ACT == 0) wg::consume<true>(ring, cw, N, d);
  else act_consume<ACT, HAS_E>(cw, m0, rows, N, blockIdx.x == 0 ? du_out : nullptr, d);
  float mu[2], rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = m0 + ra + 8 * r < rows;    // past rows du and x are TMA's zeros
    mu[r] = in ? mean[m0 + ra + 8 * r] : 0.f;
    rs[r] = in ? rstd[m0 + ra + 8 * r] : 0.f;
  }

  // ---- the x tile into the freed ring (from L2)
  unsigned char* X = wg::ring_base();
  if (t == 0) {
    wg::mbar_expect_tx(xbar, BM * BN * 2);
    for (int b = 0; b < BN / 64; ++b) wg::tma_load(X + b * (BM * 128), &tx, c0 + 64 * b, m0, xbar);
  }
  wg::mbar_wait(xbar, 0);
  // x̂ at (row ra + 8r, columns c, c + 1 of the tile)
  auto xhat = [&](int r, int c) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(X + x_offset(ra + 8 * r, c)));
    return make_float2((v.x - mu[r]) * rs[r], (v.y - mu[r]) * rs[r]);
  };
  bf16* bxn = wg::epilogue_buffer(1, cw);   // past the x tile
  float* colpart = column_partials();
  const int warp = t >> 5;                 // 0 .. 7
  const int rs0 = ra - 64 * cw;            // the rows' place in the warpgroup's slice

  // ---- pass 1: xn, the row partials, the column partials; dxn -> dx̂ in place
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int jp = 0; jp < BN / 16; ++jp) {
    float v[8];
#pragma unroll
    for (int js = 0; js < 2; ++js) {
      const int j = 2 * jp + js, c = 8 * j + cq;
      const float4 g = gb[c >> 1];         // zero past C
      float dg0 = 0.f, dg1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 h = xhat(r, c);
        float& d0 = d[4 * j + 2 * r];
        float& d1 = d[4 * j + 2 * r + 1];
        dg0 += d0 * h.x;
        dg1 += d1 * h.y;
        db0 += d0;
        db1 += d1;
        d0 *= g.x;     // dx̂
        d1 *= g.y;
        s1[r] += d0 + d1;
        s2[r] += d0 * h.x + d1 * h.y;
        *reinterpret_cast<__nv_bfloat162*>(bxn + wg::epilogue_index(rs0 + 8 * r, c)) =
            __floats2bfloat162_rn(h.x * g.x + g.z, h.y * g.y + g.w);
      }
      v[4 * js] = dg0;
      v[4 * js + 1] = dg1;
      v[4 * js + 2] = db0;
      v[4 * js + 3] = db1;
    }
    const float sum = reduce_scatter8(v, lane);
    const int q = (lane >> 3) & 1, j = 2 * jp + ((lane >> 4) & 1);
    colpart[(warp * 2 + q) * BN + 8 * j + cq + ((lane >> 2) & 1)] = sum;
  }
  // the quad's four lanes hold the row's 256 columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 1);
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 2);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 1);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 2);
    if ((lane & 3) == 0) rowpart[ra + 8 * r] = make_float2(s1[r], s2[r]);
  }
  wg::cluster_arrive();
  wg::cluster_wait();

  // ---- the block's column partials, the eight warps in order
  for (int e = t; e < 2 * BN; e += 256) {
    const int q = e / BN, col = e % BN;
    if (c0 + col < C) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += colpart[(w * 2 + q) * BN + col];
      partial[(size_t)blockIdx.y * 2 * C + (size_t)q * C + c0 + col] = s;
    }
  }

  // ---- the row moments: every block adds the cluster's partials in rank order
  const float inv_c = 1.0f / (float)C;
  float m1[2], m2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float2 p = wg::ld_cluster_f2(rowpart + ra + 8 * r, k);
      a1 += p.x;
      a2 += p.y;
    }
    m1[r] = a1 * inv_c;
    m2[r] = a2 * inv_c;
  }
  wg::cluster_arrive();     // done with the peers' shared memory

  // ---- pass 2: dx from dx̂ in registers, into the x tile in place
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 h = xhat(r, c);
      const float o0 = rs[r] * (d[4 * j + 2 * r] - m1[r] - h.x * m2[r]);
      const float o1 = rs[r] * (d[4 * j + 2 * r + 1] - m1[r] - h.y * m2[r]);
      *reinterpret_cast<__nv_bfloat162*>(X + x_offset(ra + 8 * r, c)) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  wg::store_slice(bxn, xn, m0 + 64 * cw, c0, rows, C, ti);
  // the warpgroup's rows of dx from the tile, 16-byte words along rows
#pragma unroll 4
  for (int idx = ti; idx < 64 * (BN / 8); idx += 128) {
    const int r = 64 * cw + idx / (BN / 8), col = (idx % (BN / 8)) * 8;
    if (m0 + r < rows && c0 + col < C)
      *reinterpret_cast<uint4*>(dx + (size_t)(m0 + r) * C + c0 + col) =
          *reinterpret_cast<const uint4*>(X + x_offset(r, col));
  }
  wg::cluster_wait();
}

// The launch shape for width C: one cluster of ⌈C/256⌉ blocks per 128 rows.
cudaLaunchConfig_t launch_config(int rows, int C, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int cs = (C + BN - 1) / BN;
  cfg.gridDim = dim3(cs, (rows + BM - 1) / BM, 1);
  cfg.blockDim = dim3(wg::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int ACT, bool HAS_E>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(dense_ln_bwd_wgmma_kernel<ACT, HAS_E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<ACT, HAS_E>());
}

template <int ACT, bool HAS_E>
int launch(const CUtensorMap& tdu, const CUtensorMap& tw, const CUtensorMap& tx,
           const CUtensorMap& tu, const CUtensorMap& te, const void* gamma, const void* beta,
           const void* mean, const void* rstd, void* dx, void* xn, void* du, void* partial,
           int rows, int C, int N, cudaStream_t stream) {
  cudaError_t err = set_smem<ACT, HAS_E>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(rows, C, smem_bytes<ACT, HAS_E>(), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, dense_ln_bwd_wgmma_kernel<ACT, HAS_E>, tdu, tw, tx, tu, te,
                           (const bf16*)gamma, (const bf16*)beta, (const float*)mean,
                           (const float*)rstd, (bf16*)dx, (bf16*)xn, (bf16*)du,
                           (float*)partial, rows, C, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dc

// The widest row the kernel takes: a cluster of at most 8 blocks of 256 columns.
DC_EXPORT int dc_dense_ln_bwd_max_c() { return dc::kMaxCluster * dc::BN; }

// Row bands of 128: the rows of the dγ/dβ partials.
DC_EXPORT int dc_dense_ln_bwd_blocks(int rows) { return (rows + dc::BM - 1) / dc::BM; }

// Clusters of the kernel at width C that the card holds at once (the cluster
// size is ⌈C/256⌉), or -(CUDA error); act 0 the du mode, 1 the activation
// mode (with e, its largest shared memory).
DC_EXPORT int dc_dense_ln_bwd_max_clusters(int C, int act) {
  using namespace dc;
  cudaError_t err = act ? set_smem<1, true>() : set_smem<0, false>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(
      BM, C, act ? smem_bytes<1, true>() : smem_bytes<0, false>(), nullptr, &attr);
  int n = 0;
  err = act ? cudaOccupancyMaxActiveClusters(&n, dense_ln_bwd_wgmma_kernel<1, true>, &cfg)
            : cudaOccupancyMaxActiveClusters(&n, dense_ln_bwd_wgmma_kernel<0, false>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// x, dx, xn: [rows, C]; w: [C, N]; g, u, e, du: [rows, N]; gamma, beta: [C];
// all bf16, 16-byte aligned.  mean, rstd: [rows] fp32.  partial:
// [dc_dense_ln_bwd_blocks(rows), 2·C] fp32 scratch; dgamma_dbeta: [2·C] fp32
// (dγ then dβ).  act 0: g is du, and u, e, du are NULL.  act 1 (exact GELU)
// or 2 (QuickGELU): g is dh, the gradient of h = act(u); u is required, e
// (the saved erf(u/√2) or σ(1.702 u)) may be NULL, and du = dh · act'(u) is
// written.  Requires C % 32 == 0, C <= dc_dense_ln_bwd_max_c(), N % 8 == 0,
// 1 <= rows <= 65535·128.  Two launches: the cluster kernel, then
// reduce_partials.
DC_EXPORT int dc_dense_ln_bwd(const void* x, const void* gamma, const void* beta,
                              const void* w, const void* g, const void* u, const void* e,
                              void* du, const void* mean, const void* rstd, void* dx, void* xn,
                              void* partial, void* dgamma_dbeta, int rows, int C, int N,
                              int act, void* stream) {
  using namespace dc;
  if (C > dc_dense_ln_bwd_max_c() || act < 0 || act > 2 ||
      (act != 0) != (u != nullptr && du != nullptr) || (act == 0 && e != nullptr))
    return (int)cudaErrorInvalidValue;
  // the maps of absent operands repeat g's, which those instances never read
  CUtensorMap tg, tw, tx, tu, te;
  if (!wg::make_tensor_map(&tg, g, N, rows, BK, BM) ||
      !wg::make_tensor_map(&tw, w, N, C, BK, BN) ||
      !wg::make_tensor_map(&tx, x, C, rows, 64, BM) ||
      !wg::make_tensor_map(&tu, act ? u : g, N, rows, BK, BM) ||
      !wg::make_tensor_map(&te, e ? e : g, N, rows, BK, BM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (act * 2 + (e != nullptr)) {
    case 0: err = launch<0, false>(tg, tw, tx, tu, te, gamma, beta, mean, rstd, dx, xn, du,
                                   partial, rows, C, N, s); break;
    case 2: err = launch<1, false>(tg, tw, tx, tu, te, gamma, beta, mean, rstd, dx, xn, du,
                                   partial, rows, C, N, s); break;
    case 3: err = launch<1, true>(tg, tw, tx, tu, te, gamma, beta, mean, rstd, dx, xn, du,
                                  partial, rows, C, N, s); break;
    case 4: err = launch<2, false>(tg, tw, tx, tu, te, gamma, beta, mean, rstd, dx, xn, du,
                                   partial, rows, C, N, s); break;
    default: err = launch<2, true>(tg, tw, tx, tu, te, gamma, beta, mean, rstd, dx, xn, du,
                                   partial, rows, C, N, s); break;
  }
  if (err != 0) return err;
  return reduce_partials((const float*)partial, (float*)dgamma_dbeta,
                         dc_dense_ln_bwd_blocks(rows), 2 * C, s);
}
