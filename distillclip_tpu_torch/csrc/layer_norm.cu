// K4 and its backward: row LayerNorm, bf16 in and out with fp32 math.
//
// Forward replaces distillclip_tpu/ops/layer_norm.py:_ln_fwd_kernel (the
// Pallas forward behind layer_norm_rows); backward replaces :_ln_bwd_kernel.
// On the serving and training paths they normalise the pooled [B, C] rows of
// the students' final `norm`, and under fc1_ln "0" every norm of the towers.
//
// Forward:   y = (x - mean) · rstd · γ + β, and (for the backward) mean and
//            rstd as fp32 [rows] when the caller passes buffers for them.
// Backward:  x̂ = (x - mean) · rstd,  gs = g · γ,
//            dx = rstd · (gs - mean_c(gs) - x̂ · mean_c(gs · x̂)),
//            dγ = Σ_rows g · x̂,  dβ = Σ_rows g        (fp32 [C])
//
// Bound on the H100: bytes.  Each row is read from device memory once and
// written once (C = 768 bf16 values, 1.5 KB); the arithmetic is a few
// operations per value.
//
// Forward design: a warp owns a row at a time and reads it once, as 16-byte
// words held in registers (NCH = C / 256 words a lane up to C = 768, lane l
// holding words k·32 + l, the layout of the backward below); the mean and then
// the variance come from those registers in two passes (no E[x²] − mean²), y
// is written from them.  γ and β stay in registers, as 16-byte words, for
// every row the warp takes, and the next row's words are loaded before the
// current row is reduced, so a warp always has a row in flight.  A warp takes
// rows w, w + W, w + 2W, ... (W warps in the grid), and the Python wrapper
// picks W and the block size from the row count: at most as many warps as the
// card holds at once, so that the all-rows calls run one full wave in which
// every warp takes the same number of rows, and blocks of two warps for calls
// too small to fill the card, so that they spread over as many SMs as
// possible.  C past 768 (NCH = 0) reads the row in 16-byte words from L1 on
// each pass.  The lean and the statistics modes run the same arithmetic, so y
// is the same bits in both.
//
// Backward design: one kernel launch and no other device operation (the
// result buffers come from torch.empty); the partial sums of the blocks are
// added by the blocks that finish last.  The Python wrapper picks the rows a
// block takes: at least 16 (a row a warp), and no more blocks than SMs (a
// block fills one), since every block writes a [2·C] fp32 partial that has
// to be read again.  A block has 16 warps.  A warp owns a row at a time and
// holds its x and g in registers (16-byte loads, 24 values a lane at C = 768)
// with the next row's in flight: it reduces the two moments with shuffles and
// writes dx from the same registers, so a row is read once, and adds its g·x̂
// and g into its own slice of shared memory (in registers they would take 48
// a lane, and 16 warps an SM leave 128).  The warps' slices leave the block
// as one partial, added in warp order.  Then each block takes a ticket of its
// group of 16 blocks (atomicAdd on a device counter): the one that draws the
// group's last adds the group's partials in block order, and the one of those
// that draws the last group ticket adds the groups' sums in group order.  So
// no float is summed by an atomic, two runs give the same bits, and no block
// reads more than 16 partials.  The block that draws a counter's last ticket
// sets it back to 0 for the next launch (or graph replay); each (device,
// stream) has its own counters, so calls on two streams do not meet.  The TPU
// kernel carries dγ/dβ from one grid step to the next; blocks here run in no
// order.
#include <algorithm>

#include "common.cuh"

namespace dc {

// Forward: at most 8 warps a block, and registers for 3 such blocks an SM
// (2 at C > 512, whose three words a lane of x, the next x, γ and β spill at 3).
constexpr int kLnThreads = 256;
constexpr int ln_min_blocks(int nch) { return nch == 3 ? 2 : 3; }

// A lane's words k·32 + lane (k < NCH) of a row, zero past C.
template <int NCH>
__device__ __forceinline__ void load_row_words(const bf16* __restrict__ row, int C, int lane,
                                               uint4 (&w)[NCH]) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = (k * 32 + lane) * 8;
    w[k] = c < C ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0, 0, 0, 0);
  }
}

// A row's mean and rstd from a lane's words of it (load_row_words): the mean,
// then the variance about it, both in fp32 from the registers.
template <int NCH>
__device__ __forceinline__ void row_moments(const uint4 (&xw)[NCH], int C, int lane,
                                            float inv_c, float eps, float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    float f[8];
    unpack8(xw[k], f);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += f[t];
  }
  mean = warp_sum(s) * inv_c;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    if ((k * 32 + lane) * 8 >= C) continue;
    float f[8];
    unpack8(xw[k], f);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = f[t] - mean;
      v += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(v) * inv_c + eps);
}

// The same for a row of any width, read from L1 on each pass.
__device__ __forceinline__ void row_moments_l1(const bf16* __restrict__ xr, int C, int lane,
                                               float inv_c, float eps, float& mean,
                                               float& rstd) {
  float s = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += f[t];
  }
  mean = warp_sum(s) * inv_c;
  float v = 0.f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = f[t] - mean;
      v += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(v) * inv_c + eps);
}

// NCH > 0: C <= 256·NCH, rows in registers; NCH == 0: any C % 8 == 0.
template <int NCH>
__global__ void __launch_bounds__(kLnThreads, ln_min_blocks(NCH))
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, bf16* __restrict__ y,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float inv_c = 1.0f / (float)C;

  if constexpr (NCH > 0) {
    uint4 gw[NCH], bw[NCH], xw[NCH];
    load_row_words<NCH>(gamma, C, lane, gw);
    load_row_words<NCH>(beta, C, lane, bw);
    load_row_words<NCH>(x + (size_t)r * C, C, lane, xw);
    for (; r < rows; r += nwarps) {
      uint4 xn[NCH];
      if (r + nwarps < rows) load_row_words<NCH>(x + (size_t)(r + nwarps) * C, C, lane, xn);
      float mean, rstd;
      row_moments<NCH>(xw, C, lane, inv_c, eps, mean, rstd);
      if (mean_out != nullptr && lane == 0) {
        mean_out[r] = mean;
        rstd_out[r] = rstd;
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c = (k * 32 + lane) * 8;
        if (c >= C) continue;
        float f[8], g[8], b[8];
        unpack8(xw[k], f);
        unpack8(gw[k], g);
        unpack8(bw[k], b);
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = (f[t] - mean) * rstd * g[t] + b[t];
        store8(y + (size_t)r * C + c, f);
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) xw[k] = xn[k];
    }
  } else {
    for (; r < rows; r += nwarps) {
      const bf16* xr = x + (size_t)r * C;
      bf16* yr = y + (size_t)r * C;
      float mean, rstd;
      row_moments_l1(xr, C, lane, inv_c, eps, mean, rstd);
      if (mean_out != nullptr && lane == 0) {
        mean_out[r] = mean;
        rstd_out[r] = rstd;
      }
      for (int c = lane * 8; c < C; c += 32 * 8) {
        float f[8], g[8], b[8];
        load8(xr + c, f);
        load8(gamma + c, g);
        load8(beta + c, b);
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = (f[t] - mean) * rstd * g[t] + b[t];
        store8(yr + c, f);
      }
    }
  }
}

// The forward's instance for rows of C values.
inline decltype(&layer_norm_rows_kernel<0>) layer_norm_rows_instance(int C) {
  decltype(&layer_norm_rows_kernel<0>) const kernels[] = {
      layer_norm_rows_kernel<0>, layer_norm_rows_kernel<1>, layer_norm_rows_kernel<2>,
      layer_norm_rows_kernel<3>};
  return kernels[C <= 768 ? (C + 255) / 256 : 0];
}

// The first launch of the LN GEMMs K1, K2 and #8 (dense_ln_wgmma.cu): the
// rows' mean and rstd as the forward above computes them (a warp a row, read
// once into registers, the next row in flight), without y; and, in the blocks
// past `stat_blocks`, W converted to the fp16 copy that their product reads
// (w_words 16-byte words).
template <int NCH>
__global__ void __launch_bounds__(kLnThreads, ln_min_blocks(NCH))
ln_stats_w16_kernel(const bf16* __restrict__ x, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int rows, int C, float eps, int stat_blocks,
                    const bf16* __restrict__ w, f16* __restrict__ w16, long long w_words) {
  if ((int)blockIdx.x >= stat_blocks) {
    const long long step = (long long)(gridDim.x - stat_blocks) * kLnThreads;
    for (long long i = (long long)(blockIdx.x - stat_blocks) * kLnThreads + threadIdx.x;
         i < w_words; i += step) {
      float f[8];
      unpack8(reinterpret_cast<const uint4*>(w)[i], f);
      store8(w16 + 8 * i, f);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = stat_blocks * (kLnThreads >> 5);
  int r = blockIdx.x * (kLnThreads >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float inv_c = 1.0f / (float)C;
  float mean, rstd;
  if constexpr (NCH > 0) {
    uint4 xw[NCH];
    load_row_words<NCH>(x + (size_t)r * C, C, lane, xw);
    for (; r < rows; r += nwarps) {
      uint4 xn[NCH];
      if (r + nwarps < rows) load_row_words<NCH>(x + (size_t)(r + nwarps) * C, C, lane, xn);
      row_moments<NCH>(xw, C, lane, inv_c, eps, mean, rstd);
      if (lane == 0) {
        mean_out[r] = mean;
        rstd_out[r] = rstd;
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) xw[k] = xn[k];
    }
  } else {
    for (; r < rows; r += nwarps) {
      row_moments_l1(x + (size_t)r * C, C, lane, inv_c, eps, mean, rstd);
      if (lane == 0) {
        mean_out[r] = mean;
        rstd_out[r] = rstd;
      }
    }
  }
}

int ln_stats_w16(const void* x, float* mean, float* rstd, int rows, int C, float eps,
                 const void* w, void* w16, long long w_elems, cudaStream_t stream) {
  const int nch = C <= 768 ? (C + 255) / 256 : 0;
  decltype(&ln_stats_w16_kernel<0>) const kernels[] = {
      ln_stats_w16_kernel<0>, ln_stats_w16_kernel<1>, ln_stats_w16_kernel<2>,
      ln_stats_w16_kernel<3>};
  // one wave of statistics warps at most: the SMs and the instance's blocks
  // an SM, asked once per instance
  static int sms = 0, per_sm[4] = {0, 0, 0, 0};
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm[nch] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[nch], kernels[nch], kLnThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int warps = kLnThreads / 32;
  const int stat_blocks = std::max(1, std::min((rows + warps - 1) / warps, sms * per_sm[nch]));
  const long long words = w_elems / 8;
  const int conv_blocks =
      (int)std::min<long long>((words + kLnThreads - 1) / kLnThreads, 2LL * sms);
  kernels[nch]<<<stat_blocks + conv_blocks, kLnThreads, 0, stream>>>(
      (const bf16*)x, mean, rstd, rows, C, eps, stat_blocks, (const bf16*)w, (f16*)w16, words);
  return (int)cudaGetLastError();
}

// The first launch of EVA-02's modes of the LN GEMM (dense_ln_wgmma.cu): the
// moments over the first `width` of the C columns only (EVA-02's LN_ffn
// normalises the 2730 SwiGLU channels of rows padded to 2752 for the product's
// tiles; the rotary and SwiGLU modes pass width = C), each row read from L1 as
// row_moments_l1 reads it, every element past `width` masked; W's fp16 copy in
// the blocks past `stat_blocks`, as above.  A kernel of its own, so that
// ln_stats_w16_kernel's instances stay as they are and the trace charges
// these launches to the modes, not to K1.
__global__ void __launch_bounds__(kLnThreads)
ln_stats_width_w16_kernel(const bf16* __restrict__ x, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int rows, int C, int width, float eps,
                          int stat_blocks, const bf16* __restrict__ w, f16* __restrict__ w16,
                          long long w_words) {
  if ((int)blockIdx.x >= stat_blocks) {
    const long long step = (long long)(gridDim.x - stat_blocks) * kLnThreads;
    for (long long i = (long long)(blockIdx.x - stat_blocks) * kLnThreads + threadIdx.x;
         i < w_words; i += step) {
      float f[8];
      unpack8(reinterpret_cast<const uint4*>(w)[i], f);
      store8(w16 + 8 * i, f);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = stat_blocks * (kLnThreads >> 5);
  const float inv_w = 1.0f / (float)width;
  for (int r = blockIdx.x * (kLnThreads >> 5) + (threadIdx.x >> 5); r < rows; r += nwarps) {
    const bf16* xr = x + (size_t)r * C;
    float s = 0.f;
    for (int c = lane * 8; c < width; c += 32 * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += c + t < width ? f[t] : 0.f;
    }
    const float mean = warp_sum(s) * inv_w;
    float v = 0.f;
    for (int c = lane * 8; c < width; c += 32 * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float d = f[t] - mean;
        v += c + t < width ? d * d : 0.f;
      }
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_w + eps);
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

int ln_stats_width_w16(const void* x, float* mean, float* rstd, int rows, int C, int width,
                       float eps, const void* w, void* w16, long long w_elems,
                       cudaStream_t stream) {
  static int sms = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_stats_width_w16_kernel,
                                                        kLnThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int warps = kLnThreads / 32;
  const int stat_blocks = std::max(1, std::min((rows + warps - 1) / warps, sms * per_sm));
  const long long words = w_elems / 8;
  const int conv_blocks =
      (int)std::min<long long>((words + kLnThreads - 1) / kLnThreads, 2LL * sms);
  ln_stats_width_w16_kernel<<<stat_blocks + conv_blocks, kLnThreads, 0, stream>>>(
      (const bf16*)x, mean, rstd, rows, C, width, eps, stat_blocks, (const bf16*)w,
      (f16*)w16, words);
  return (int)cudaGetLastError();
}

constexpr int kLnBwdThreads = 512;
// Blocks whose partials one block adds: the last of a group adds its group's
// partials, and the last group's adder adds the groups' sums.
constexpr int kLnBwdGroup = 16;
constexpr int kLnBwdMaxBlocks = kLnBwdGroup * kLnBwdGroup;
// Ticket counters, one row per (device, stream) that calls the backward (the
// Python wrapper assigns the rows): [0] counts groups, [1 + i] the blocks of
// group i.  Zero when the library loads; each counter is set back to 0 by the
// block that draws its last ticket, for the next launch (or graph replay).
constexpr int kLnBwdSlots = 64;
__device__ unsigned int g_ln_bwd_tickets[kLnBwdSlots][1 + kLnBwdGroup];

// Column of float4 q of a warp's dγ (or dβ) sums: NCH > 0 keeps them in the
// order (word k, half, lane), so that a warp's 16-byte accesses fall on
// consecutive addresses; NCH == 0 in column order.
template <int NCH>
__device__ __forceinline__ int sum_col(int q) {
  if (NCH == 0) return 4 * q;
  return ((q >> 6) * 32 + (q & 31)) * 8 + ((q >> 5) & 1) * 4;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// out[j] = Σ_p partial[first + p·stride, j] over p = 0 .. n - 1 ascending,
// 4 columns a thread.
__device__ __forceinline__ void add_partials(const float* partial, int C2, int first,
                                             int stride, int n, float* out) {
  for (int j = threadIdx.x * 4; j < C2; j += blockDim.x * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int p = 0; p < n; ++p)
      add4(s, __ldcg(reinterpret_cast<const float4*>(
                  partial + (size_t)(first + p * stride) * C2 + j)));
    *reinterpret_cast<float4*>(out + j) = s;
  }
}

// dx, and dγ/dβ through per-block partials ([gridDim.x, 2·C] fp32) added in
// two fixed-order levels by the blocks that finish last.  A block owns rows
// row0 .. row0 + rpb - 1; warp w takes rows row0 + w, row0 + w + warps, ...
// NCH > 0: a lane holds 16-byte words k·32 + lane (k < NCH) of its row, of
// the next row (prefetched) and of γ in registers (C <= 256·NCH <= 768: at
// 1024 the registers would spill); NCH == 0:
// any C, the row read twice.  Each warp adds its rows' g·x̂ and g into its own
// slice of shared memory ([warps][2·Q] float4, Q = 64·NCH or C / 4).
template <int NCH>
__global__ void __launch_bounds__(kLnBwdThreads)
layer_norm_rows_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                           const bf16* __restrict__ g, const float* __restrict__ mean,
                           const float* __restrict__ rstd, bf16* __restrict__ dx,
                           float* __restrict__ partial, float* __restrict__ out, int rows,
                           int C, int rpb, int slot) {
  extern __shared__ __align__(16) float4 sums[];
  __shared__ unsigned int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int row0 = blockIdx.x * rpb;
  const int row1 = min(rows, row0 + rpb);
  const float inv_c = 1.0f / (float)C;
  const int Q = NCH > 0 ? 64 * NCH : C / 4;
  float4* mine = sums + (size_t)warp * 2 * Q;
  for (int q = lane; q < 2 * Q; q += 32) mine[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  __syncwarp();

  if constexpr (NCH > 0) {
    uint4 sw[NCH], xw[NCH], gw[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * 32 + lane) * 8;
      if (c < C) sw[k] = *reinterpret_cast<const uint4*>(gamma + c);
    }
    auto load_row = [&](int r, uint4(&xr)[NCH], uint4(&gr)[NCH]) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c = (k * 32 + lane) * 8;
        if (c < C) {
          xr[k] = *reinterpret_cast<const uint4*>(x + (size_t)r * C + c);
          gr[k] = *reinterpret_cast<const uint4*>(g + (size_t)r * C + c);
        }
      }
    };
    int r = row0 + warp;
    float mu = 0.f, rs = 0.f;
    if (r < row1) {
      load_row(r, xw, gw);
      mu = mean[r];
      rs = rstd[r];
    }
    for (; r < row1; r += nw) {
      uint4 xn[NCH], gn[NCH];
      float mun = 0.f, rsn = 0.f;
      if (r + nw < row1) {
        load_row(r + nw, xn, gn);
        mun = mean[r + nw];
        rsn = rstd[r + nw];
      }
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if ((k * 32 + lane) * 8 >= C) continue;
        float xf[8], gf[8], sf[8];
        unpack8(xw[k], xf);
        unpack8(gw[k], gf);
        unpack8(sw[k], sf);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float gs = gf[t] * sf[t];
          a1 += gs;
          a2 += gs * (xf[t] - mu) * rs;
        }
      }
      const float m1 = warp_sum(a1) * inv_c, m2 = warp_sum(a2) * inv_c;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c = (k * 32 + lane) * 8;
        if (c >= C) continue;
        float xf[8], gf[8], sf[8], o[8], h[8];
        unpack8(xw[k], xf);
        unpack8(gw[k], gf);
        unpack8(sw[k], sf);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          h[t] = (xf[t] - mu) * rs;
          o[t] = rs * (gf[t] * sf[t] - m1 - h[t] * m2);
        }
        store8(dx + (size_t)r * C + c, o);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = (k * 2 + half) * 32 + lane;
          const int t = 4 * half;
          add4(mine[q], make_float4(gf[t] * h[t], gf[t + 1] * h[t + 1], gf[t + 2] * h[t + 2],
                                    gf[t + 3] * h[t + 3]));
          add4(mine[Q + q], make_float4(gf[t], gf[t + 1], gf[t + 2], gf[t + 3]));
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        xw[k] = xn[k];
        gw[k] = gn[k];
      }
      mu = mun;
      rs = rsn;
    }
  } else {
    float* dg = reinterpret_cast<float*>(mine);
    float* db = dg + 4 * Q;
    for (int r = row0 + warp; r < row1; r += nw) {
      const bf16* xr = x + (size_t)r * C;
      const bf16* gr = g + (size_t)r * C;
      const float mu = mean[r], rs = rstd[r];
      float a1 = 0.f, a2 = 0.f;
      for (int c = lane * 8; c < C; c += 32 * 8) {
        float xf[8], gf[8], sf[8];
        load8(xr + c, xf);
        load8(gr + c, gf);
        load8(gamma + c, sf);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float gs = gf[t] * sf[t];
          a1 += gs;
          a2 += gs * (xf[t] - mu) * rs;
        }
      }
      const float m1 = warp_sum(a1) * inv_c, m2 = warp_sum(a2) * inv_c;
      for (int c = lane * 8; c < C; c += 32 * 8) {
        float xf[8], gf[8], sf[8], o[8];
        load8(xr + c, xf);
        load8(gr + c, gf);
        load8(gamma + c, sf);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float h = (xf[t] - mu) * rs;
          o[t] = rs * (gf[t] * sf[t] - m1 - h * m2);
          dg[c + t] += gf[t] * h;
          db[c + t] += gf[t];
        }
        store8(dx + (size_t)r * C + c, o);
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps' sums in warp order
  const int C2 = 2 * C;
  for (int q = threadIdx.x; q < 2 * Q; q += blockDim.x) {
    const int part = q >= Q, c = sum_col<NCH>(q - part * Q);
    if (c >= C) continue;
    float4 s = sums[q];
    for (int w = 1; w < nw; ++w) add4(s, sums[(size_t)w * 2 * Q + q]);
    *reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * C2 + part * C + c) = s;
  }
  // the last block of a group adds the group's partials in block order (into
  // the group's first row), the last of those the groups' sums in group order
  unsigned int* tickets = g_ln_bwd_tickets[slot];
  const int nblocks = gridDim.x, grp = blockIdx.x / kLnBwdGroup;
  const int ngroups = (nblocks + kLnBwdGroup - 1) / kLnBwdGroup;
  const int first = grp * kLnBwdGroup, gsize = min(kLnBwdGroup, nblocks - first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[1 + grp], 1u) == (unsigned)gsize - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  add_partials(partial, C2, first, 1, gsize,
               ngroups == 1 ? out : partial + (size_t)first * C2);
  if (threadIdx.x == 0) tickets[1 + grp] = 0;
  if (ngroups == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[0], 1u) == (unsigned)ngroups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  add_partials(partial, C2, 0, kLnBwdGroup, ngroups, out);
  if (threadIdx.x == 0) tickets[0] = 0;
}

// The second pass of #9's reduction across blocks, and #6's: a block of
// kReduceWarps warps takes 32 columns, warp w the parts p ≡ w (mod
// kReduceWarps) in ascending order, then the warps' sums are added in warp
// order.  No atomics: the same bits every run.
constexpr int kReduceWarps = 16;

__global__ void __launch_bounds__(kReduceWarps * 32)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out, int nparts,
                       int width) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < width) {
#pragma unroll 8
    for (int p = warp; p < nparts; p += kReduceWarps) s += __ldg(partials + (size_t)p * width + j);
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < width) {
    float t = 0.f;
    for (int w = 0; w < kReduceWarps; ++w) t += sums[w][lane];
    out[j] = t;
  }
}

int reduce_partials(const float* partials, float* out, int nparts, int width,
                    cudaStream_t stream) {
  reduce_partials_kernel<<<(width + 31) / 32, kReduceWarps * 32, 0, stream>>>(partials, out,
                                                                             nparts, width);
  return (int)cudaGetLastError();
}

}  // namespace dc

// x, y: [rows, C] bf16; gamma, beta: [C] bf16; mean, rstd: [rows] fp32, both
// NULL for the lean forward; C % 8 == 0 (checked by the Python wrapper, which
// also checks contiguity and devices).  `blocks` blocks of `threads` (a
// multiple of 32, at most 256) threads: warp w of the grid takes rows w, w + W,
// ... (W warps in all); the wrapper picks both from the row count.
DC_EXPORT int dc_layer_norm_rows(const void* x, const void* gamma, const void* beta,
                                 void* y, void* mean, void* rstd, int rows, int C,
                                 float eps, int threads, int blocks, void* stream) {
  if (threads < 32 || threads > dc::kLnThreads || threads % 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  dc::layer_norm_rows_instance(C)<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)beta, (dc::bf16*)y,
      (float*)mean, (float*)rstd, rows, C, eps);
  return (int)cudaGetLastError();
}

// Warps of the forward's instance for rows of C values that one SM holds at
// once in blocks of 256 threads (registers and the block limit).
DC_EXPORT int dc_layer_norm_rows_warps_per_sm(int C) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dc::layer_norm_rows_instance(C), dc::kLnThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return blocks * dc::kLnThreads / 32;
}

// x, g, dx: [rows, C] bf16; gamma: [C] bf16; mean, rstd: [rows] fp32;
// partial: [blocks, 2·C] fp32 scratch, blocks = max(1, ceil(rows /
// rows_per_block)) <= 256; dgamma_dbeta: [2·C] fp32 (dγ then dβ), every
// element written.  C % 8 == 0 and C <= dc_layer_norm_rows_bwd_max_c(); slot
// < 64, one per (device, stream) (the Python wrapper checks all of these).
// One kernel launch, nothing else on the device.
DC_EXPORT int dc_layer_norm_rows_bwd(const void* x, const void* gamma, const void* g,
                                     const void* mean, const void* rstd, void* dx,
                                     void* partial, void* dgamma_dbeta, int rows, int C,
                                     int rows_per_block, int slot, void* stream) {
  constexpr size_t kMaxSmem = 232448;
  const int blocks = rows > 0 ? (rows + rows_per_block - 1) / rows_per_block : 1;
  const int nch = C <= 768 ? (C + 255) / 256 : 0;
  const size_t per_warp = (size_t)2 * (nch > 0 ? 64 * nch : C / 4) * 4 * sizeof(float);
  int warps = dc::kLnBwdThreads / 32;
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem || slot < 0 || slot >= dc::kLnBwdSlots ||
      blocks > dc::kLnBwdMaxBlocks)
    return (int)cudaErrorInvalidValue;
  decltype(&dc::layer_norm_rows_bwd_kernel<0>) const kernels[] = {
      dc::layer_norm_rows_bwd_kernel<0>, dc::layer_norm_rows_bwd_kernel<1>,
      dc::layer_norm_rows_bwd_kernel<2>, dc::layer_norm_rows_bwd_kernel<3>};
  const auto kernel = kernels[nch];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const dc::bf16*)x, (const dc::bf16*)gamma, (const dc::bf16*)g, (const float*)mean,
      (const float*)rstd, (dc::bf16*)dx, (float*)partial, (float*)dgamma_dbeta, rows, C,
      rows_per_block, slot);
  return (int)cudaGetLastError();
}

// The widest row the backward takes: one warp's dγ/dβ sums in shared memory.
DC_EXPORT int dc_layer_norm_rows_bwd_max_c() {
  return (int)(232448 / (2 * sizeof(float)));
}

DC_EXPORT const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
