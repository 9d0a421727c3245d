// Device routines shared by the head-transform attention forwards
// (transform_attention.cu, flash_transform_attention.cu).
//
// All of them work on a block's tile in shared memory: `tq` rows (at most
// kTqMax) of one sample, all H heads, as [H, tq, N] fp32 planes, and they are
// called by every thread of a kThreads-wide block.
//
// A streamed operand is one sample's [N, H, d] values with unit stride in d:
// row j of head g starts at Y + j·ystride + g·yhs.  The fused-qkv kernels read
// rows of [B·N, 3·H·d] (heads side by side: yhs = d, the overloads without a
// head stride); the [B, H, N, d] kernels pass both strides of whatever view
// they were given.
#pragma once

#include "common.cuh"

namespace dc {
namespace tf {

constexpr int kTqMax = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Element strides of a [B, H, N, d] view with unit stride in d.
struct Strides {
  size_t b, h, n;
};

// The i-th (batch, head, row) triple of a host array of strides.
inline Strides strides_at(const long long* s, int i) {
  return Strides{(size_t)s[3 * i], (size_t)s[3 * i + 1], (size_t)s[3 * i + 2]};
}

// Rows of the head mixes, padded to whole 16-byte words.
__host__ __device__ inline int pad4(int H) { return (H + 3) & ~3; }

// M[b·H4 + a] = W[row a, column b] (a < H, zero past it), from bf16 W [H, H]
// with element (r, c) at w[r·H + c]; `transpose` swaps the roles of r and c.
__device__ __forceinline__ void load_mix(const bf16* __restrict__ w, float* __restrict__ M,
                                         int H, bool transpose) {
  const int H4 = pad4(H);
  for (int idx = threadIdx.x; idx < H * H4; idx += kThreads) {
    const int b = idx / H4;
    const int a = idx - b * H4;
    M[idx] = a < H ? __bfloat162float(transpose ? w[b * H + a] : w[a * H + b]) : 0.f;
  }
}

// T[a, p] = alpha · Σ_b M[b·H4 + a] · S[b, p] over the `plane` positions p of
// each head.  A thread makes heads a0..a0+3 of one position from one read of
// each input head, with the four weights in one 16-byte read.
__device__ __forceinline__ void mix_heads(const float* __restrict__ M,
                                          const float* __restrict__ S,
                                          float* __restrict__ T, int H, int plane,
                                          float alpha) {
  const int H4 = pad4(H);
  for (int idx = threadIdx.x; idx < (H4 / 4) * plane; idx += kThreads) {
    const int h0 = idx / plane * 4;
    const int p = idx - h0 / 4 * plane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < H; ++g) {
      const float s = S[g * plane + p];
      const float4 w = *reinterpret_cast<const float4*>(M + g * H4 + h0);
      acc.x += w.x * s;
      acc.y += w.y * s;
      acc.z += w.z * s;
      acc.w += w.w * s;
    }
    float* t = T + h0 * plane + p;
    t[0] = alpha * acc.x;
    if (h0 + 1 < H) t[plane] = alpha * acc.y;
    if (h0 + 2 < H) t[2 * plane] = alpha * acc.z;
    if (h0 + 3 < H) t[3 * plane] = alpha * acc.w;
  }
}

// A [tq, H·d] bf16 tile of rows i0.. of `src` (row stride `stride`) into
// shared memory, 8 values per word; rows past nq are zero.
__device__ __forceinline__ void load_row_tile(const bf16* __restrict__ src, size_t stride,
                                              bf16* __restrict__ Xs, int HD, int tq, int nq) {
  for (int idx = threadIdx.x; idx < tq * (HD / 8); idx += kThreads) {
    const int i = idx / (HD / 8);
    const int c = (idx - i * (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < nq) v = *reinterpret_cast<const uint4*>(src + (size_t)i * stride + c);
    *reinterpret_cast<uint4*>(Xs + i * HD + c) = v;
  }
}

// The same tile from a strided operand: head g of row i starts at
// src + i·stride + g·hstride.  The tile in shared memory is [tq, H·d] as above.
__device__ __forceinline__ void load_row_tile(const bf16* __restrict__ src, size_t stride,
                                              size_t hstride, bf16* __restrict__ Xs, int H,
                                              int d, int tq, int nq) {
  const int HD = H * d;
  const int dw = d / 8;
  for (int idx = threadIdx.x; idx < tq * (HD / 8); idx += kThreads) {
    const int i = idx / (HD / 8);
    const int w = idx - i * (HD / 8);
    const int g = w / dw;
    const int c = (w - g * dw) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < nq) v = *reinterpret_cast<const uint4*>(src + (size_t)i * stride + g * hstride + c);
    *reinterpret_cast<uint4*>(Xs + i * HD + g * d + c) = v;
  }
}

// S[g, i, j] = Xs[i, g·d ..] · Y[j, head g] for the tile's tq rows i, every
// head g and the first nk rows j of Y (device memory, row stride ystride,
// head stride yhs);
// the rows of S are N wide and columns past nk are left as they are.  A thread
// takes one (g, j) row of Y against all tq tile rows at once, so each Y row
// is read from memory once per block; four 16-byte chunks of it are in flight
// before the first is used.
__device__ __forceinline__ void rows_dot(const bf16* __restrict__ Xs,
                                         const bf16* __restrict__ Y, size_t ystride,
                                         size_t yhs, float* __restrict__ S, int N, int nk,
                                         int H, int d, int tq) {
  const int HD = H * d;
  for (int item = threadIdx.x; item < H * nk; item += kThreads) {
    const int g = item / nk;
    const int j = item - g * nk;
    const bf16* yp = Y + (size_t)j * ystride + g * yhs;
    const bf16* xp = Xs + g * d;
    float acc[kTqMax];
#pragma unroll
    for (int i = 0; i < kTqMax; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += 32) {
      uint4 yr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        yr[u] = c0 + 8 * u < d ? *reinterpret_cast<const uint4*>(yp + c0 + 8 * u)
                               : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + 8 * u >= d) break;
        float yf[8];
        unpack8(yr[u], yf);
#pragma unroll
        for (int i = 0; i < kTqMax; ++i) {
          if (i < tq) {
            float xf[8];
            load8(xp + i * HD + c0 + 8 * u, xf);
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[i] += xf[t] * yf[t];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTqMax; ++i)
      if (i < tq) S[(g * tq + i) * N + j] = acc[i];
  }
}

// Heads side by side in a row (yhs = d).
__device__ __forceinline__ void rows_dot(const bf16* __restrict__ Xs,
                                         const bf16* __restrict__ Y, size_t ystride,
                                         float* __restrict__ S, int N, int nk, int H, int d,
                                         int tq) {
  rows_dot(Xs, Y, ystride, (size_t)d, S, N, nk, H, d, tq);
}

// All N rows of Y.
__device__ __forceinline__ void rows_dot(const bf16* __restrict__ Xs,
                                         const bf16* __restrict__ Y, size_t ystride,
                                         float* __restrict__ S, int N, int H, int d, int tq) {
  rows_dot(Xs, Y, ystride, S, N, N, H, d, tq);
}

// out[i, col] = Σ_{j < nk} P[head(col), i, j] · Y[j, col] for the tile's rows
// i < nq and all H·d columns; the rows of P are N wide.  Y and out are
// strided like rows_dot's operand (head strides yhs, ohs).  A thread takes a pair
// of columns (one head, since d is even) against all tq tile rows at once, so
// each Y element is read from memory once per block; eight rows of Y are in
// flight at a time.
__device__ __forceinline__ void plane_rows(const float* __restrict__ P,
                                           const bf16* __restrict__ Y, size_t ystride,
                                           size_t yhs, bf16* __restrict__ out, size_t ostride,
                                           size_t ohs, int N, int nk, int H, int d, int tq,
                                           int nq) {
  const int HD = H * d;
  const int plane = tq * N;
  for (int col = 2 * threadIdx.x; col < HD; col += 2 * kThreads) {
    const int g = col / d;
    const int c = col - g * d;
    const float* p = P + (size_t)g * plane;
    const bf16* yp = Y + g * yhs + c;
    bf16* op = out + g * ohs + c;
    float acc0[kTqMax], acc1[kTqMax];
#pragma unroll
    for (int i = 0; i < kTqMax; ++i) acc0[i] = acc1[i] = 0.f;
    for (int j0 = 0; j0 < nk; j0 += 8) {
      __nv_bfloat162 yr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        yr[u] = j0 + u < nk ? *reinterpret_cast<const __nv_bfloat162*>(yp + (size_t)(j0 + u) * ystride)
                           : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u >= nk) break;
        const float v0 = __low2float(yr[u]);
        const float v1 = __high2float(yr[u]);
#pragma unroll
        for (int i = 0; i < kTqMax; ++i) {
          if (i < tq) {
            const float pv = p[i * N + j0 + u];
            acc0[i] += pv * v0;
            acc1[i] += pv * v1;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTqMax; ++i)
      if (i < nq)
        *reinterpret_cast<__nv_bfloat162*>(op + (size_t)i * ostride) =
            __floats2bfloat162_rn(acc0[i], acc1[i]);
  }
}

// Heads side by side in a row of Y and of out.
__device__ __forceinline__ void plane_rows(const float* __restrict__ P,
                                           const bf16* __restrict__ Y, size_t ystride,
                                           bf16* __restrict__ out, size_t ostride,
                                           int N, int nk, int H, int d, int tq, int nq) {
  plane_rows(P, Y, ystride, (size_t)d, out, ostride, (size_t)d, N, nk, H, d, tq, nq);
}

// All N columns of P.
__device__ __forceinline__ void plane_rows(const float* __restrict__ P,
                                           const bf16* __restrict__ Y, size_t ystride,
                                           bf16* __restrict__ out, size_t ostride,
                                           int N, int H, int d, int tq, int nq) {
  plane_rows(P, Y, ystride, out, ostride, N, N, H, d, tq, nq);
}

}  // namespace tf
}  // namespace dc
