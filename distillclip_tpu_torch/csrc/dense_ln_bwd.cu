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
// dW, db and the GELU derivative stay outside, as in the JAX package.
//
// Layouts: x, dx, xn [rows, C]; W [C, N] row-major; du [rows, N]; γ, β [C];
// all bf16.  mean, rstd [rows] fp32.  For du · Wᵀ the contraction runs over
// N, along which a row of W is contiguous: W as stored is a K-major B operand
// [C rows of N], read by TMA in boxes of 64 (N) x 256 (C).  Operands bf16
// (du has no bound on its range), sums fp32.
//
// Bound on the H100: operations (2·rows·C·N flops against ~2·rows·(3C + N)
// bytes of x, du, dx, xn).
//
// Design: the main loop is wgmma_gemm.cuh's (128 x 256 output tiles of dxn,
// 64 deep, a four-stage TMA ring, one producer and two consumer warpgroups;
// A = du K-major, B = W K-major).  The two row moments need all C columns of
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
constexpr size_t kBwdSmemBytes = wg::kSmemBytes + kExtraBytes;

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

__global__ void __launch_bounds__(wg::kThreads, 1)
dense_ln_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tdu,
                          const __grid_constant__ CUtensorMap tw,
                          const __grid_constant__ CUtensorMap tx,
                          const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                          const float* __restrict__ mean, const float* __restrict__ rstd,
                          bf16* __restrict__ dx, bf16* __restrict__ xn,
                          float* __restrict__ partial, int rows, int C, int N) {
  // the cluster is the grid's x extent: every column tile of a row band
  const int cs = gridDim.x;
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  unsigned char* extra = wg::after_ring();
  float2* rowpart = reinterpret_cast<float2*>(extra);
  float4* gb = reinterpret_cast<float4*>(extra + BM * sizeof(float2));
  uint64_t* xbar = reinterpret_cast<uint64_t*>(extra + kExtraBytes - 16);
  if (threadIdx.x == 0) {
    wg::mbar_init(xbar, 1);
    // the epilogue's x tile, into L2 while the main loop runs
    for (int b = 0; b < BN / 64; ++b) wg::tma_prefetch_l2(&tx, c0 + 64 * b, m0);
  }
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<true>(ring, &tdu, &tw, m0, c0, N);
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
  wg::consume<true>(ring, cw, N, d);    // its closing barrier also publishes gb
  float mu[2], rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = m0 + ra + 8 * r < rows;    // past rows du and x are TMA's zeros
    mu[r] = in ? mean[m0 + ra + 8 * r] : 0.f;
    rs[r] = in ? rstd[m0 + ra + 8 * r] : 0.f;
  }

  // ---- the x tile into the freed ring (from L2)
  unsigned char* X = ring.base;
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
cudaLaunchConfig_t launch_config(int rows, int C, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int cs = (C + BN - 1) / BN;
  cfg.gridDim = dim3(cs, (rows + BM - 1) / BM, 1);
  cfg.blockDim = dim3(wg::kThreads, 1, 1);
  cfg.dynamicSmemBytes = kBwdSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_smem() {
  return cudaFuncSetAttribute(dense_ln_bwd_wgmma_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmemBytes);
}

}  // namespace

}  // namespace dc

// The widest row the kernel takes: a cluster of at most 8 blocks of 256 columns.
DC_EXPORT int dc_dense_ln_bwd_max_c() { return dc::kMaxCluster * dc::BN; }

// Row bands of 128: the rows of the dγ/dβ partials.
DC_EXPORT int dc_dense_ln_bwd_blocks(int rows) { return (rows + dc::BM - 1) / dc::BM; }

// Clusters of the kernel at width C that the card holds at once (the cluster
// size is ⌈C/256⌉), or -(CUDA error).
DC_EXPORT int dc_dense_ln_bwd_max_clusters(int C) {
  cudaError_t err = dc::set_smem();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = dc::launch_config(dc::BM, C, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, dc::dense_ln_bwd_wgmma_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// x, dx, xn: [rows, C]; w: [C, N]; du: [rows, N]; gamma, beta: [C]; all bf16,
// 16-byte aligned.  mean, rstd: [rows] fp32.  partial: [dc_dense_ln_bwd_blocks(rows),
// 2·C] fp32 scratch; dgamma_dbeta: [2·C] fp32 (dγ then dβ).  Requires C % 32
// == 0, C <= dc_dense_ln_bwd_max_c(), N % 8 == 0, 1 <= rows <= 65535·128.
// Two launches: the cluster kernel, then reduce_partials.
DC_EXPORT int dc_dense_ln_bwd(const void* x, const void* gamma, const void* beta,
                              const void* w, const void* du, const void* mean,
                              const void* rstd, void* dx, void* xn, void* partial,
                              void* dgamma_dbeta, int rows, int C, int N, void* stream) {
  using namespace dc;
  if (C > dc_dense_ln_bwd_max_c()) return (int)cudaErrorInvalidValue;
  CUtensorMap tdu, tw, tx;
  if (!wg::make_tensor_map(&tdu, du, N, rows, BK, BM) ||
      !wg::make_tensor_map(&tw, w, N, C, BK, BN) || !wg::make_tensor_map(&tx, x, C, rows, 64, BM))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(rows, C, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, dense_ln_bwd_wgmma_kernel, tdu, tw, tx, (const bf16*)gamma,
                           (const bf16*)beta, (const float*)mean, (const float*)rstd,
                           (bf16*)dx, (bf16*)xn, (float*)partial, rows, C, N);
  if (err != cudaSuccess) return (int)err;
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_partials((const float*)partial, (float*)dgamma_dbeta,
                         dc_dense_ln_bwd_blocks(rows), 2 * C, (cudaStream_t)stream);
}
