// Plain multi-head attention forward past 256 tokens, on the fused qkv rows:
// the EVA-02-CLIP teacher's 257-token attention (#13L beside #13).
//
// No TPU kernel is replaced.  The JAX package's Pallas kernels stop at 256
// tokens, and past that its towers materialise the attention with XLA
// (distillclip_tpu/models/layers.py, flash_ok); the port's EVA-02 tower has
// no JAX counterpart, and this kernel takes its attention past 256 tokens.
//
// Per sample b, head h and query row i < N, unmasked:
//   S[i, j] = scale · q[i] · k[j]                       j < N, fp32
//   O[i, :] = Σ_j softmax_j(S[i, :]) · v[j, :]          one rounding to bf16
// qkv is [B·N, 3·H·64] bf16 (q | k | v column blocks, head-major inside each),
// O is [B·N, H·64] bf16.  d = 64, 1 <= N <= 1024.
//
// Bound on the H100: bytes.  At the EVA cell's shape (B = 1024, H = 16, N =
// 257) one launch reads qkv, 1.617 GB, and writes O, 0.539 GB: 0.644 ms at
// 3.35 TB/s, against 0.277 TFLOP (0.280 ms at 989 TFLOP/s).  #13's design
// (mma_attention.cuh: a head's k and v resident, two passes of mma.sync over
// the keys) was made for N <= 77; at 257 tokens it would hold one block of 8
// warps an SM and leave its loads unoverlapped.  So the design streams:
//
// * A work item is one (sample, head); the grid is persistent (one block an
//   SM, items b·H + h in turn), so the 16 heads of a sample, which share its
//   rows, are read by neighbouring blocks at about the same time.
// * One producer thread (warp 0 of warpgroup 0) brings q, k and v by TMA
//   from one 3-D map of qkv, [B][N][3·H·64], in 64 x 64 boxes (128-byte
//   swizzle) at columns h·64, (H + h)·64 and (2H + h)·64.  The map ends each
//   sample at N, so a box that runs past a sample's last row is zero-filled
//   there and never reads the next sample.  q comes as the item's 64-row
//   tiles, up to six at once (a pass of 384 rows; two sets, so the next
//   item's q lands while this one runs); k and v as 64-key tiles through a
//   ring of six stages on mbarriers.  The producer runs ahead across items:
//   one item's loads overlap the previous item's products and stores.
// * Three consumer warpgroups each hold up to two q tiles of the pass (q tile
//   t goes to warpgroup t mod 3); for every key tile, each runs S = q·kᵀ
//   (wgmma m64n64k16, both operands from shared memory, fp32 sums), the
//   online softmax in fp32 (running max and sum per row, one exp2 a score,
//   the sum kept per thread and added across the row's quad at the end), and
//   O += P·v with P straight from the registers (wgmma's register form: the
//   fp32 S fragment, rounded to bf16, is the A fragment), v from shared memory
//   as an MN-major B.  Nothing N x N leaves the registers.  A tile's P·v is
//   left in flight while the next tile's S = q·kᵀ is issued; one wait retires
//   both.  The warpgroup and warp indices come through a shuffle, so that the
//   compiler sees them uniform across a warp (without it, it serialised the
//   wgmma and spilled).
// * The ragged tail, 257 = 4·64 + 1: keys at or past N are set to -inf before
//   the max, so they enter neither the max nor the sum (their P is an exact
//   0), and a key tile's P·v stops at the last 16 keys that hold one; a warp
//   whose 16 query rows all lie at or past N skips its softmax.
// * O leaves through shared memory: each warpgroup writes its tiles,
//   normalised and rounded to bf16, over their own q tiles in the TMA layout,
//   and one thread stores them with TMA through a 3-D map of O, [B][N][H·64],
//   which drops the rows at or past N.
//
// A single bf16 P holds #13's limit here: past 256 unmasked keys no one
// probability dominates a row as it does in #13's first causal rows, and the
// rounding of P (2^-9 relative, of random sign) averages over the row.  The
// row sums are taken over the rounded P that P·v uses, so the weights of a
// row add to 1 and a component common to the row's v passes through exactly
// (with #13's hi / lo split of P, which costs a second product, the kernel
// took 1.87 ms against 1.37 at the EVA cell's shape on an H100 SXM at 700 W).
#include "wgmma_gemm.cuh"

namespace dc {
namespace long_attn {

constexpr int D = 64;                               // head dim
constexpr int T = 64;                               // rows of a q tile, keys of a key tile
constexpr int kConsumers = 3;                       // consumer warpgroups
constexpr int kTilesEach = 2;                       // q tiles a warpgroup holds at once
constexpr int kPassTiles = kConsumers * kTilesEach; // q tiles of a pass: 384 rows
constexpr int kStages = 6;                          // the ring of k / v tiles
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxSeq = 1024;
constexpr int kTileBytes = T * D * 2;               // one 64 x 64 box: 8 KB
constexpr int kQSetBytes = kPassTiles * kTileBytes; // 48 KB
constexpr int kRingOffset = 2 * kQSetBytes;
constexpr int kBarOffset = kRingOffset + kStages * 2 * kTileBytes;
constexpr int kBars = 2 * kStages + 4;
constexpr size_t kSmemBytes = (size_t)kBarOffset + kBars * 8 + 1024;

// The block's dynamic shared memory, aligned to 1024 bytes (the period of the
// 128-byte swizzle) by an offset from the array, so that derived pointers stay
// shared-memory pointers.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024u - (wg::smem_u32(smem_raw) & 1023u)) & 1023u);
}

// One 64 x 64 box at (c0 column, c1 row, c2 sample) of a 3-D map into shared
// memory, completing its bytes on `bar`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(wg::smem_u32(bar))
      : "memory");
}

// The box at (c0, c1, c2) of a 3-D map from shared memory; TMA drops what lies
// outside the map.
__device__ __forceinline__ void store_box(const CUtensorMap* map, const void* src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

#define DC_LA_ACC                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DC_LA_OPS(c, d)                                                                  \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),      \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),    \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),   \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define DC_LA_W(x) "=f"(x)
#define DC_LA_RW(x) "+f"(x)

// s[64 x 64] (=, or += with ACC) q[64 x 16] · kᵀ[16 x 64], both K-major from
// shared memory.
template <bool ACC>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t desc_q, uint64_t desc_k) {
  if (ACC) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DC_LA_ACC
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DC_LA_OPS(DC_LA_RW, s)
        : "l"(desc_q), "l"(desc_k), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DC_LA_ACC
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DC_LA_OPS(DC_LA_W, s)
        : "l"(desc_q), "l"(desc_k), "r"(0));
  }
}

// o[64 x 64] += P[64 x 16] · v[16 x 64]: P from registers (the m16n8k16 A
// fragment of each warp's 16 rows, two bf16 a register), v MN-major from
// shared memory.
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DC_LA_ACC
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DC_LA_OPS(DC_LA_RW, o)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

// Keep the compiler from moving accesses of 32 sums across a wgmma wait.
__device__ __forceinline__ void fence32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of `keys` valid keys into a q tile's running state.  s holds
// the thread's scores (s[4j + 2r + e]: row g + 8r of its warp's 16, column 8j
// + 2·tq + e of the tile); m (raw scores) and l (the thread's part of the
// row's sum of the rounded P) per row r; o's rows are scaled to the new max;
// P leaves as the A fragments of the tile's four 16-key steps.
__device__ __forceinline__ void online_softmax(float (&s)[32], int keys, int tq,
                                               float scale_log2, float (&m)[2], float (&l)[2],
                                               float (&o)[32], uint32_t (&pf)[4][4]) {
  if (keys < T) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * tq + e >= keys) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float corr[2], neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * scale_log2);   // 0 at the first tile (m = -inf)
    m[r] = mx[r];
    neg[r] = -mx[r] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j < keys) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[4 * j + i] = ex2(fmaf(s[4 * j + i], scale_log2, neg[i >> 1]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[4 * j + i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pf[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
    pf[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
    pf[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
    pf[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
  }
  // the row sums of the rounded P that P·v takes, so that its weights add to 1
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      sum[w & 1] += __uint_as_float(pf[k][w] << 16) + __uint_as_float(pf[k][w] & 0xffff0000u);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], sum[r]);
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
}

__global__ void __launch_bounds__(kThreads, 1)
plain_attention_long_kernel(const __grid_constant__ CUtensorMap tqkv,
                            const __grid_constant__ CUtensorMap tout, int batch, int N, int H,
                            float scale_log2) {
  unsigned char* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int q = 0; q < 2; ++q) {
      wg::mbar_init(&q_full[q], 1);
      wg::mbar_init(&q_empty[q], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = batch * H;
  const int tiles = (N + T - 1) / T;                   // q tiles, and key tiles
  const int passes = (tiles + kPassTiles - 1) / kPassTiles;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int kv = 0, unit = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / H, h = item % H;
        for (int pass = 0; pass < passes; ++pass, ++unit) {
          const int qs = unit & 1;
          if (unit >= 2) wg::mbar_wait(&q_empty[qs], ((unit >> 1) - 1) & 1);
          const int t0 = pass * kPassTiles, nq = min(kPassTiles, tiles - t0);
          wg::mbar_expect_tx(&q_full[qs], (uint32_t)nq * kTileBytes);
          for (int i = 0; i < nq; ++i)
            load_box(base + qs * kQSetBytes + i * kTileBytes, &tqkv, h * D, (t0 + i) * T, b,
                     &q_full[qs]);
          for (int j = 0; j < tiles; ++j, ++kv) {
            const int s = kv % kStages;
            if (kv >= kStages) wg::mbar_wait(&empty[s], (kv / kStages - 1) & 1);
            unsigned char* st = base + kRingOffset + s * 2 * kTileBytes;
            wg::mbar_expect_tx(&full[s], 2 * kTileBytes);
            load_box(st, &tqkv, (H + h) * D, j * T, b, &full[s]);
            load_box(st + kTileBytes, &tqkv, (2 * H + h) * D, j * T, b, &full[s]);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  // warpgroup and warp indices through a shuffle, so that the compiler sees
  // them uniform across a warp
  const int cw = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128) - 1, 0);
  const int t = threadIdx.x & 127, lane = t & 31;
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  const int g = lane >> 2, tq = lane & 3;
  int kv = 0, unit = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / H, h = item % H;
    for (int pass = 0; pass < passes; ++pass, ++unit) {
      const int qs = unit & 1;
      unsigned char* qset = base + qs * kQSetBytes;
      int rows[kTilesEach];                             // valid rows of each q tile held
      float o[kTilesEach][32], m[kTilesEach][2], l[kTilesEach][2];
#pragma unroll
      for (int i = 0; i < kTilesEach; ++i) {
        rows[i] = min(T, max(0, N - (pass * kPassTiles + cw + kConsumers * i) * T));
#pragma unroll
        for (int e = 0; e < 32; ++e) o[i][e] = 0.f;
        m[i][0] = m[i][1] = -INFINITY;
        l[i][0] = l[i][1] = 0.f;
      }
      wg::mbar_wait(&q_full[qs], (unit >> 1) & 1);
      for (int j = 0; j < tiles; ++j, ++kv) {
        const int s = kv % kStages;
        wg::mbar_wait(&full[s], (kv / kStages) & 1);
        const unsigned char* kt = base + kRingOffset + s * 2 * kTileBytes;
        const unsigned char* vt = kt + kTileBytes;
        const int keys = min(T, N - j * T);
        uint32_t pf[kTilesEach][4][4];
#pragma unroll
        for (int i = 0; i < kTilesEach; ++i) {
          if (rows[i] == 0) continue;
          const unsigned char* qt = qset + (cw + kConsumers * i) * kTileBytes;
          float sc[32];
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // K-major operands: rows of 128 bytes, 8-row groups 1024 bytes
          // apart, a 16-deep step 32 bytes on
          wgmma_qk<false>(sc, wg::desc(qt, 16, 1024), wg::desc(kt, 16, 1024));
#pragma unroll
          for (int kk = 1; kk < D / 16; ++kk)
            wgmma_qk<true>(sc, wg::desc(qt + kk * 32, 16, 1024), wg::desc(kt + kk * 32, 16, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // also retires the previous q tile's P·v, issued before
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence32(sc);
          if (i > 0) {
            fence32(o[i - 1]);
            wg::hold(pf[i - 1]);
          }
          if (16 * warp < rows[i]) {
            online_softmax(sc, keys, tq, scale_log2, m[i], l[i], o[i], pf[i]);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) pf[i][k][0] = pf[i][k][1] = pf[i][k][2] = pf[i][k][3] = 0u;
          }
          fence32(o[i]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // v as an MN-major B: 8-key groups 1024 bytes apart, a 16-key step
          // two groups on; left in flight
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk)
            if (16 * kk < keys) wgmma_pv(o[i], pf[i][kk], wg::desc(vt + kk * 2048, 8192, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        }
        // the last q tile's P·v: then the stage may be refilled
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < kTilesEach; ++i) fence32(o[i]);
        if (rows[kTilesEach - 1] > 0) wg::hold(pf[kTilesEach - 1]);
        else if (rows[0] > 0) wg::hold(pf[0]);
        wg::mbar_arrive(&empty[s]);
      }
      // O over the warpgroup's own q tiles, in the TMA layout of a 128-byte
      // swizzled box: the 16-byte word c of row r at word c ^ (r % 8)
#pragma unroll
      for (int i = 0; i < kTilesEach; ++i) {
        if (rows[i] == 0) continue;
        unsigned char* ot = qset + (cw + kConsumers * i) * kTileBytes;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = l[i][r];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float inv = 1.f / sum;
          const int row = 16 * warp + g + 8 * r;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            *reinterpret_cast<uint32_t*>(ot + row * 128 + ((c ^ g) << 4) + 4 * tq) =
                pack_bf16(o[i][4 * c + 2 * r] * inv, o[i][4 * c + 2 * r + 1] * inv);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < kTilesEach; ++i)
          if (rows[i] > 0)
            store_box(&tout, qset + (cw + kConsumers * i) * kTileBytes, h * D,
                      (pass * kPassTiles + cw + kConsumers * i) * T, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the tiles have been read out: the q set may be refilled
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        wg::mbar_arrive(&q_empty[qs]);
      }
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace long_attn
}  // namespace dc

// qkv: [batch·N, 3·H·64]; out: [batch·N, H·64]; both bf16, 16-byte aligned.
// scale multiplies q·k; d must be 64 and 1 <= N <= 1024 (the Python wrapper
// checks all of these).
DC_EXPORT int dc_plain_attention_long(const void* qkv, void* out, int batch, int N, int H,
                                      int d, float scale, void* stream) {
  using namespace dc::long_attn;
  if (d != D || N < 1 || N > kMaxSeq || H < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  // qkv as [batch][N][3·H·64] and O as [batch][N][H·64]: 64 x 64 boxes of one sample
  const cuuint64_t qdims[3] = {(cuuint64_t)3 * H * D, (cuuint64_t)N, (cuuint64_t)batch};
  const cuuint64_t qstrides[2] = {(cuuint64_t)3 * H * D * 2, (cuuint64_t)N * 3 * H * D * 2};
  const cuuint64_t odims[3] = {(cuuint64_t)H * D, (cuuint64_t)N, (cuuint64_t)batch};
  const cuuint64_t ostrides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)N * H * D * 2};
  const cuuint32_t box[3] = {D, T, 1};
  CUtensorMap tq, to;
  if (!dc::wg::make_tensor_map_nd(&tq, qkv, 3, qdims, qstrides, box) ||
      !dc::wg::make_tensor_map_nd(&to, out, 3, odims, ostrides, box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(plain_attention_long_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int items = batch * H;
  plain_attention_long_kernel<<<items < sms ? items : sms, kThreads, kSmemBytes,
                                (cudaStream_t)stream>>>(tq, to, batch, N, H,
                                                        (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}
