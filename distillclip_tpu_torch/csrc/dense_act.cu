// The fc1 GEMM without a LayerNorm, on wgmma and TMA:
//   #12 (act 1/2):          h = act(x·W + b)
//   #10 (act 1/2, residual): h, u = x·W + b and e = erf(u/√2) or σ(1.702 u)
//   #11 (act 0):            u = x·W + b
//
// Replaces distillclip_tpu/ops/fc1_act.py:_fc1_h_kernel (#12, the primal of
// dense_act), :_fc1_kernel (#10, u and e; the JAX package recombines h outside
// the kernel, here it is written from the fp32 sum) and :_fc1_u_kernel (#11).
//
// Layouts: x [rows, C], W [C, N] row-major (the Flax Dense layout, kept by the
// port's converter), b [N], outputs [rows, N]; all bf16.  Operands stay bf16:
// x is any activation, which fp16's range does not hold.  The product sums in
// fp32; bias and activation are applied to the fp32 sum before the single bf16
// rounding of each output, so the three modes share one main loop and their u
// and h are the same bits.
//
// Bound on the H100: operations.  At the image fc1 (rows 12800, C 768, N 3072)
// the product is 60.4 GFLOP against 103 MB (0.061 ms at 989 TFLOP/s).  The
// main loop is wgmma_gemm.cuh's: output tiles of 128 x 256, a four-stage TMA
// ring with 128-byte swizzle, one producer and two consumer warpgroups issuing
// wgmma m64n256k16.  The epilogue (wg::epilogue_store, shared with K1, K2
// and #8) adds the bias and applies the activation to the sums in registers,
// writes each output tile as bf16 into the free ring, and stores it as
// 16-byte words along rows.  h comes out of the same operations in both
// modes (common.cuh's activate), so the lean and the residual h agree.
#include "wgmma_gemm.cuh"

namespace dc {

namespace {

template <int ACT, bool RES>
__global__ void __launch_bounds__(wg::kThreads, 1)
dense_act_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ bias,
                       bf16* __restrict__ out, bf16* __restrict__ out_u,
                       bf16* __restrict__ out_e, int rows, int C, int N) {
  const int n0 = blockIdx.x * wg::BN;
  const int m0 = blockIdx.y * wg::BM;
  const wg::Ring ring = wg::ring_init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    if (threadIdx.x == 0) wg::produce<false>(ring, &tx, &tw, m0, n0, C);
    return;
  }
  wg::consumer_regs();
  float d[128];
  wg::consume<false>(ring, threadIdx.x / 128 - 1, C, d);
  wg::epilogue_store<ACT, RES>(d, bias, out, out_u, out_e, m0, n0, rows, N);
}

template <int ACT, bool RES>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const void* bias, void* h, void* u,
           void* e, int rows, int C, int N, cudaStream_t stream) {
  auto kernel = dense_act_wgmma_kernel<ACT, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + wg::BN - 1) / wg::BN, (rows + wg::BM - 1) / wg::BM);
  kernel<<<grid, wg::kThreads, wg::kSmemBytes, stream>>>(
      tx, tw, (const bf16*)bias, (bf16*)h, (bf16*)u, (bf16*)e, rows, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dc

// x·W + b with x [rows, C], W [C, N], b [N] bf16, each 16-byte aligned;
// C % 32 == 0, N % 8 == 0, 1 <= rows <= 65535·128 (the Python wrapper checks
// these).  act 0 with res 0 writes u only (into h); act 1 or 2 writes h, and
// with res 1 also u and e.
DC_EXPORT int dc_dense_act(const void* x, const void* w, const void* bias, void* h, void* u,
                           void* e, int rows, int C, int N, int act, int res, void* stream) {
  CUtensorMap tx, tw;
  if (!dc::wg::make_tensor_map(&tx, x, C, rows, dc::wg::BK, dc::wg::BM) ||
      !dc::wg::make_tensor_map(&tw, w, N, C, 64, dc::wg::BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act * 2 + res) {
    case 0: return dc::launch<0, false>(tx, tw, bias, h, u, e, rows, C, N, s);
    case 2: return dc::launch<1, false>(tx, tw, bias, h, u, e, rows, C, N, s);
    case 3: return dc::launch<1, true>(tx, tw, bias, h, u, e, rows, C, N, s);
    case 4: return dc::launch<2, false>(tx, tw, bias, h, u, e, rows, C, N, s);
    case 5: return dc::launch<2, true>(tx, tw, bias, h, u, e, rows, C, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
