// #17 on the tensor cores: head-transform attention forward on [B, H, N, d]
// views, with a key limit and the causal mask, O only.
//
// Replaces distillclip_tpu/ops/flash_attention.py:_tf_fwd_kernel (its
// pl.pallas_call in _tf_fwd, behind flash_attention(q, k, v,
// head_transform=(Wl, Ww), ...)): the attention of the weight-share students
// when they collect hidden states.  Its gradient is a recompute outside any
// kernel, as in the JAX package, so nothing but O is written.  The function,
// the design and the arithmetic are K3's (transform_attention_mma.cuh,
// tf_fwd_tiles with VIEWS): q, k, v and O are bf16 views with unit stride in
// d and any batch, head and row strides (multiples of 8 elements), wl and ww
// bf16 [H, H]; the keys j >= kv_len are hidden, and under the causal mask also
// j > i.  q is staged by cp.async through its strides, O stored through its
// own; k and v come by TMA from one 4-D map each, (d, N, H, B) with the view's
// strides, so the views of a fused qkv projection and contiguous tensors go in
// alike.  A tile walks only the key chunks its rows see.
//
// Bound on the H100: bytes.  At the image student's shape (B=256, H=24, d=32,
// N=50) the function reads q, k, v and writes O, 78.6 MB, against 3.4 GFLOP of
// products and mixes; the text student's (H=12, d=64, N=77) 121.1 MB against
// 4.7 GFLOP; a 32-head student's (B=256, H=32, d=32, N=197) 413.1 MB against
// 81.4 GFLOP.  The CUDA-core version (flash_transform_attention.cu, now the
// route for head shapes past this kernel's) ran every product in fp32 on the
// CUDA cores with one block per (sample, 16 rows) holding two [H, 16, N] fp32
// planes.  Here, as in K3, every product and mix is mma.sync.m16n8k16 in
// persistent blocks of one 16-key chunk at a time.
//
// Shapes: K3's.  d % 8 == 0, up to 32 heads at d <= 32 and 16 at d <= 128, any
// N.  Up to 24 heads (16 with d > 32) and d = 64, P' has planes of its own;
// past that the PIX instances keep P' in each warp's row of the score plane,
// one k and one v buffer where two do not fit (12 and 16 heads of 128, 16 of
// 80), and O leaves from the fragments through its strides where its rows do
// not fit the free planes (past 16 x H·d = 768 columns at 16 heads).  The
// students' shapes (24 heads of 32, 12 of 64) have instances with H and d fixed
// at compile time, as K3's.
#include "transform_attention_mma.cuh"

namespace dc {

namespace {

using namespace tf_mma;

template <int KS, int HPW, int NH, int ND, bool PIX>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf_fwd_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Views vw,
                        const bf16* __restrict__ wl, const bf16* __restrict__ ww, int batch,
                        int N, int H_, int d_, float scale_log2) {
  tf_fwd_tiles<KS, HPW, NH, ND, true, PIX>(&kmap, &vmap, nullptr, vw, wl, ww, nullptr, nullptr,
                                           batch, N, H_, d_, scale_log2);
}

// The view at t with element strides st (batch, head, row) as TMA reads it:
// dims (d, N, H, batch), boxes of view_cols(d) x 16 rows x view_box_heads
// heads, swizzled as view_swizzle(d) reads them, zero past d, N and H.  A
// stride of a dim of size one is never applied; it is given as 16 bytes where
// the view's is 0.
bool view_map(CUtensorMap* map, const bf16* t, const long long* st, int batch, int N, int H,
              int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)batch};
  auto bytes = [](long long s) { return (cuuint64_t)(s > 0 ? s * 2 : 16); };
  const cuuint64_t strides[3] = {bytes(st[2]), bytes(st[1]), bytes(st[0])};
  const cuuint32_t box[4] = {(cuuint32_t)view_cols(d), 16, (cuuint32_t)view_box_heads(H, d), 1};
  const int swz = view_swizzle(d);
  const CUtensorMapSwizzle mode = swz == 7   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swz == 3 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : swz == 1 ? CU_TENSOR_MAP_SWIZZLE_32B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE;
  return wg::make_tensor_map_nd(map, t, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                mode);
}

template <int KS, int HPW, int NH, int ND, bool PIX = false>
int launch_views(const bf16* q, const bf16* k, const bf16* v, const bf16* wl, const bf16* ww,
                 bf16* out, const long long* st, int batch, int N, int H, int d, float scale,
                 int causal, int kv_len, cudaStream_t s) {
  constexpr float kLog2e = 1.4426950408889634f;
  const size_t smem = layout(H, d, true, PIX).total;
  CUtensorMap kmap, vmap;
  if (!view_map(&kmap, k, st + 3, batch, N, H, d) || !view_map(&vmap, v, st + 6, batch, N, H, d))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tf_fwd_mma_kernel<KS, HPW, NH, ND, PIX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Views vw{q, out, Strides{(size_t)st[0], (size_t)st[1], (size_t)st[2]},
                 Strides{(size_t)st[9], (size_t)st[10], (size_t)st[11]}, causal, kv_len};
  const int tiles = pad16(N) / 16 * batch;
  flash_tf_fwd_mma_kernel<KS, HPW, NH, ND, PIX><<<tiles < sms ? tiles : sms, kThreads, smem, s>>>(
      kmap, vmap, vw, wl, ww, batch, N, H, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dc

// Shared memory of a block at (H, d), or -1 where the kernel does not take
// them (d % 8 == 0, up to 32 heads at d <= 32, 16 at d <= 128; any N).
DC_EXPORT long long dc_flash_tf_fwd_mma_smem_bytes(int H, int d) {
  if (dc::tf_mma::fwd_heads_per_warp(H, d) == 0) return -1;
  return (long long)dc::tf_mma::layout(H, d, true, dc::tf_mma::p_in_x(H, d)).total;
}

// q, k, v, out: bf16 [batch, H, N, d] views with unit stride in d, 16-byte
// aligned; strides is twelve element strides, (batch, head, row) of q, k, v
// and out in turn, each a multiple of 8.  wl, ww: [H, H] bf16.  1 <= kv_len
// <= N; dc_flash_tf_fwd_mma_smem_bytes(H, d) must be >= 0 (the Python wrapper
// checks all of these).
DC_EXPORT int dc_flash_transform_attention_mma(const void* q, const void* k, const void* v,
                                               const void* wl, const void* ww, void* out,
                                               const long long* strides, int batch, int N,
                                               int H, int d, float scale, int causal,
                                               int kv_len, void* stream) {
  using dc::bf16;
  // [P' in X][heads a warp spans - 1][KS - 1]
  decltype(&dc::launch_views<1, 1, 0, 0>) const launchers[2][2][8] = {
      {{dc::launch_views<1, 1, 0, 0>, dc::launch_views<2, 1, 0, 0>,
        dc::launch_views<3, 1, 0, 0>, dc::launch_views<4, 1, 0, 0>},
       {dc::launch_views<1, 2, 0, 0>, dc::launch_views<2, 2, 0, 0>}},
      {{nullptr, nullptr, nullptr, nullptr, dc::launch_views<5, 1, 0, 0, true>,
        dc::launch_views<6, 1, 0, 0, true>, dc::launch_views<7, 1, 0, 0, true>,
        dc::launch_views<8, 1, 0, 0, true>},
       {dc::launch_views<1, 2, 0, 0, true>, dc::launch_views<2, 2, 0, 0, true>}}};
  const int hpw = dc::tf_mma::fwd_heads_per_warp(H, d), ks = dc::mma_attn::pad16(d) / 16;
  if (hpw == 0) return (int)cudaErrorInvalidValue;
  const auto launch = H == 24 && d == 32   ? dc::launch_views<2, 2, 24, 32>
                      : H == 12 && d == 64 ? dc::launch_views<4, 1, 12, 64>
                                           : launchers[dc::tf_mma::p_in_x(H, d)][hpw - 1][ks - 1];
  return launch((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)wl,
                (const bf16*)ww, (bf16*)out, strides, batch, N, H, d, scale, causal, kv_len,
                (cudaStream_t)stream);
}
