// K3 and #5 on the tensor cores: head-transform attention forward on the
// fused qkv projection, without and with saved probabilities.
//
// Replaces distillclip_tpu/ops/transform_attention.py:_tf_kernel (behind
// _tf_fwd_call), the Pallas forward of transform_attention_rows_qkv, lean and
// with save_p (the training forward, :467).  The function, the design and the
// arithmetic are those of transform_attention_mma.cuh (tf_fwd_tiles), which
// #17 shares; here q, k and v are the column blocks of qkv bf16 [B·N, 3·H·d]
// (q | k | v, head-major inside each), wl and ww bf16 [H, H], O bf16
// [B·N, H·d].  With save-P the kernel also stores P (after the softmax,
// before the ww mix: what transform_attention_bwd.cu reads) as bf16
// [B, H, N, N] at the true N.  O is the same bits either way.
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
// between the head-wise and row-wise steps (latency, not bytes).
//
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
// * A single bf16 P' (the TPU kernel's pb) adds up to 2^-9·|v| to each term
//   of O; P' enters as hi + lo.
// * Shapes: d % 8 == 0 up to 64, H up to 24 (16 with d > 32) with P' in
//   planes of its own, and past that, with P' in X (tf_fwd_tiles' PIX), up to
//   32 heads at d <= 32 and 16 at d <= 128, as the backward takes them.  The
//   Python wrapper sends the lean forward at other head shapes to the
//   CUDA-core kernel; the students' shapes (24 heads of 32, 12 of 64) have
//   instances with H and d fixed at compile time, which on an H100 (SXM, 700
//   W) at B = 256 take 12% off the generic instance's time at 24 heads of 32
//   (the mixes make three tiles of 8 heads, not four) and 4-5% at 12 of 64
//   (the loops over d and H unroll).
#include "transform_attention_mma.cuh"

namespace dc {

namespace {

using namespace tf_mma;

// The kernel: K3 / #5's instance of tf_fwd_tiles.  `map`: the fused qkv as
// [B][N][3·H·d] for TMA; probs null: the lean forward.
template <int KS, int HPW, int NH, int ND, bool PIX>
__global__ void __launch_bounds__(kThreads, 1)
tf_fwd_mma_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ qkv,
                  const bf16* __restrict__ wl, const bf16* __restrict__ ww,
                  bf16* __restrict__ out, bf16* __restrict__ probs, int batch, int N, int H_,
                  int d_, float scale_log2) {
  tf_fwd_tiles<KS, HPW, NH, ND, false, PIX>(&map, &map, qkv, Views{}, wl, ww, out, probs, batch,
                                            N, H_, d_, scale_log2);
}

template <int KS, int HPW, int NH, int ND, bool PIX = false>
int launch_fwd(const bf16* qkv, const bf16* wl, const bf16* ww, bf16* out, bf16* probs,
               int batch, int N, int H, int d, float scale, cudaStream_t s) {
  constexpr float kLog2e = 1.4426950408889634f;
  const size_t smem = layout(H, d, false, PIX).total;
  // qkv as [batch][N][3·H·d]: boxes of 64 columns x 16 rows of one sample
  const cuuint64_t dims[3] = {(cuuint64_t)3 * H * d, (cuuint64_t)N, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * H * d * 2, (cuuint64_t)N * 3 * H * d * 2};
  const cuuint32_t box[3] = {64, 16, 1};
  CUtensorMap map;
  if (!wg::make_tensor_map_nd(&map, qkv, 3, dims, strides, box)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tf_fwd_mma_kernel<KS, HPW, NH, ND, PIX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = pad16(N) / 16 * batch;
  tf_fwd_mma_kernel<KS, HPW, NH, ND, PIX><<<tiles < sms ? tiles : sms, kThreads, smem, s>>>(
      map, qkv, wl, ww, out, probs, batch, N, H, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dc

// Shared memory of a block at (H, d), or -1 where the kernel does not take
// them (d % 8 == 0, up to 32 heads at d <= 32, 16 at d <= 128; any N).
DC_EXPORT long long dc_tf_fwd_mma_smem_bytes(int H, int d) {
  if (dc::tf_mma::fwd_heads_per_warp(H, d) == 0) return -1;
  return (long long)dc::tf_mma::layout(H, d, false, dc::tf_mma::p_in_x(H, d)).total;
}

// qkv: [batch·N, 3·H·d]; wl, ww: [H, H]; out: [batch·N, H·d]; all bf16, qkv
// and out 16-byte aligned.  probs: NULL, or [batch, H, N, N] bf16, 4-byte
// aligned, to fill.  dc_tf_fwd_mma_smem_bytes(H, d) must be >= 0 (the Python
// wrapper checks).
DC_EXPORT int dc_transform_attention_mma(const void* qkv, const void* wl, const void* ww,
                                         void* out, void* probs, int batch, int N, int H,
                                         int d, float scale, void* stream) {
  using dc::bf16;
  // [P' in X][heads a warp spans - 1][KS - 1]
  decltype(&dc::launch_fwd<1, 1, 0, 0>) const launchers[2][2][8] = {
      {{dc::launch_fwd<1, 1, 0, 0>, dc::launch_fwd<2, 1, 0, 0>, dc::launch_fwd<3, 1, 0, 0>,
        dc::launch_fwd<4, 1, 0, 0>},
       {dc::launch_fwd<1, 2, 0, 0>, dc::launch_fwd<2, 2, 0, 0>}},
      {{nullptr, nullptr, nullptr, nullptr, dc::launch_fwd<5, 1, 0, 0, true>,
        dc::launch_fwd<6, 1, 0, 0, true>, dc::launch_fwd<7, 1, 0, 0, true>,
        dc::launch_fwd<8, 1, 0, 0, true>},
       {dc::launch_fwd<1, 2, 0, 0, true>, dc::launch_fwd<2, 2, 0, 0, true>}}};
  const int hpw = dc::tf_mma::fwd_heads_per_warp(H, d), ks = dc::mma_attn::pad16(d) / 16;
  if (hpw == 0) return (int)cudaErrorInvalidValue;
  const auto launch = H == 24 && d == 32   ? dc::launch_fwd<2, 2, 24, 32>
                      : H == 12 && d == 64 ? dc::launch_fwd<4, 1, 12, 64>
                                           : launchers[dc::tf_mma::p_in_x(H, d)][hpw - 1][ks - 1];
  return launch((const bf16*)qkv, (const bf16*)wl, (const bf16*)ww, (bf16*)out, (bf16*)probs,
                batch, N, H, d, scale, (cudaStream_t)stream);
}
