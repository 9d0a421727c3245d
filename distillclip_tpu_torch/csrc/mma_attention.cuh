// Plain attention forward on the tensor cores: the device routine of
// plain_attention.cu (#13, lean and save-P) and flash_attention.cu (#16
// forward), which compute the same function and differ only in their
// operands' layout and in what they write beside O.
//
// Per sample b, head h and query row i:
//   S[i, j] = scale · q[i] · k[j]                      j < lim(i), fp32
//   m, Σ    = max_j S[i, j],  Σ_j exp(S[i, j] − m)      fp32
//   P[i, j] = exp(S[i, j] − m) / Σ,  0 for j >= lim(i)
//   O[i, :] = Σ_j P[i, j] · v[j, :]                    one rounding to bf16
// with lim(i) = min(kv_len, i + 1) under the causal mask and kv_len without.
// Masked keys are skipped columns: they enter neither the max nor the sum and
// their P is an exact 0 (#14's backward relies on those zeros).
//
// Bound on the H100: bytes.  At the image teacher's shape (B=256, H=12, d=64,
// N=50) the function reads q, k, v and writes O, 78.6 MB, against 1.97 GFLOP:
// 25 FLOP/B, far under the 295 at which the tensor cores would bound it.  So
// the design reads each operand once, into shared memory, and keeps every
// intermediate on chip:
//
// * A block owns one sample and G heads, G = ceil(64 / d) (fewer where shared
//   memory runs out), so that a row of q, k or v it reads is at least 128
//   contiguous bytes when heads lie side by side in a row (the fused qkv and
//   its views).  Its q, k and v rows are staged once with 16-byte cp.async
//   copies; rows past N and d past its multiple of 16 are zero-filled, so no
//   0 × garbage can make a NaN.  Rows are padded by 16 bytes, so the eight
//   rows one ldmatrix reads fall in eight different bank groups.
// * A warp owns 16 query rows of one head.  Both products are warp-level
//   mma.sync.m16n8k16 with bf16 operands and fp32 sums, fed from shared
//   memory by ldmatrix (.trans for V).  wgmma needs 64-row warpgroup tiles
//   and descriptor layouts and buys nothing at N <= 77, where a head has at
//   most five 16-row tiles and the work is bound by bytes.
// * Two passes over the keys, 16 at a time, with K and V resident.  q and k
//   land first, so pass 1 runs while v is still on its way.  Pass 1 computes
//   QKᵀ and keeps each row's max (quad shuffles).  Pass 2 computes QKᵀ again
//   (FLOPs the card has to spare) and e = exp(S − m) in fp32, one exp per
//   score; it sums e by row and feeds e to P·V as the A operand straight from
//   the accumulator registers (the C fragment of m16n8 is the A fragment of
//   m16n8k16), so nothing goes through shared memory.  O = (e·V) / Σ at the
//   end.  A key step that every row of the tile sees in full skips the mask.
//   Under the causal mask a warp visits only the keys up to its last row.
// * e enters P·V as two bf16 operands, hi = bf16(e) and lo = bf16(e − hi),
//   with two products into one fp32 sum: e keeps 16 significant bits, and O
//   equals the product of the fp32 P to well under its bf16 rounding.  A
//   single bf16 P (the TPU kernels' pb) adds up to 2^-9·|v| per output, and
//   at B=256 that takes the text teacher's causal O 1.2e-2 from its fp32
//   value, past the 8e-3 the kernels are held to.  Lean and save-P run the
//   same arithmetic for O, so O is the same bits in both.
// * O goes out through shared memory (the warp's own q rows) as 16-byte
//   stores in the caller's layout; lse (#16) as fp32 m + log Σ.  With saved P
//   a third pass makes the same e again once Σ is known and gathers P =
//   bf16(e / Σ) of the warp's 16 rows in shared memory: they are one run of
//   device memory, stored as 16-byte words (a row alone is N·2 bytes, not a
//   multiple of 16 at N = 50, 77).
#pragma once

#include "common.cuh"

namespace dc {
namespace mma_attn {

constexpr int kMaxWarps = 8;
constexpr int kThreadsMax = kMaxWarps * 32;
// Dynamic shared memory one block may use on Hopper.
constexpr size_t kMaxSmem = 232448;

// Element strides of a [B, H, N, d] view with unit stride in d.
struct Strides {
  size_t b, h, n;
};

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }

// Row stride of a staged head in elements: d padded to 16, plus 8.
__host__ __device__ constexpr int row_ld(int d) { return pad16(d) + 8; }

// Elements of a warp's saved-P tile: 16 rows of N, flat as in device memory,
// with 8 to spare for aligning it to its destination.
__host__ __device__ constexpr int p_tile(int N) { return (16 * N + 8 + 7) & ~7; }

// Shared memory of a block of G heads and `warps` warps: q, k and v planes of
// pad16(N) rows, and with saved P a tile per warp.
__host__ inline size_t smem_bytes(int N, int d, int G, int warps, bool save_p) {
  return ((size_t)3 * G * pad16(N) * row_ld(d) + (save_p ? (size_t)warps * p_tile(N) : 0)) *
         sizeof(bf16);
}

// How a call is cut: G heads per block, warps per block, shared memory, blocks.
struct Plan {
  int G, threads;
  size_t smem;
  unsigned blocks;
};

__host__ inline Plan plan(int batch, int N, int H, int d, bool save_p) {
  const int T = pad16(N) / 16;
  int G = (64 + d - 1) / d;
  if (G > H) G = H;
  int warps = G * T < kMaxWarps ? G * T : kMaxWarps;
  while (G > 1 && smem_bytes(N, d, G, warps, save_p) > kMaxSmem) {
    --G;
    warps = G * T < kMaxWarps ? G * T : kMaxWarps;
  }
  while (warps > 1 && smem_bytes(N, d, G, warps, save_p) > kMaxSmem) --warps;
  return Plan{G, warps * 32, smem_bytes(N, d, G, warps, save_p),
              (unsigned)batch * ((H + G - 1) / G)};
}

// One launch of `kernel` as `p` cuts it, on `stream`; the CUDA error of the
// launch, 0 if none.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& p, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a · b, a 16 x 16 (row), b 16 x 8 (col), bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as one bf16 pair, x in the low half.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as hi = the bf16 pair and lo = the bf16 pair of the remainders.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x - __low2float(h), y - __high2float(h));
}

// 2^x for x <= 0 (ex2.approx: 2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Raw scores of the warp's 16 rows against keys 16·st .. 16·st + 15: s[n] is
// the C fragment of keys 16·st + 8·n ...
template <int KS>
__device__ __forceinline__ void score_step(const uint32_t (&qf)[KS][4],
                                           const bf16* __restrict__ Kg, int st, int lane,
                                           float (&s)[2][4]) {
  constexpr int LD = 16 * KS + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // matrices: keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7, keys 8-15 | d 8-15
  const bf16* row = Kg + (size_t)(st * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bk[4];
    ldsm_x4(bk, row + ks * 16);
    mma_bf16(s[0], qf[ks], bk[0], bk[1]);
    mma_bf16(s[1], qf[ks], bk[2], bk[3]);
  }
}

// The whole function for one block (one sample, G heads): q, k, v, O views
// as Strides from their own base pointers; probs (save-P, [B, H, N, N] bf16)
// and lse ([B, H, N] fp32) may be null.  KS = pad16(d) / 16.
template <int KS>
__device__ __forceinline__ void attention_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, bf16* __restrict__ probs, float* __restrict__ lse, Strides sq,
    Strides sk, Strides sv, Strides so, int N, int H, int d, int G, float scale_log2,
    int causal, int kv_len) {
  constexpr int DP = 16 * KS;     // d padded to the k-step
  constexpr int LD = DP + 8;
  constexpr int DT = DP / 8;      // n8 tiles of O
  constexpr int CW = DP / 8;      // 16-byte words of a staged row
  const float kNegInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char smem[];
  const int Np = pad16(N);
  const size_t plane = (size_t)Np * LD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + G * plane;
  bf16* Vs = Ks + G * plane;
  bf16* Ps = Vs + G * plane;      // saved P: a tile per warp

  const int ngroups = (H + G - 1) / G;
  const int b = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x - b * ngroups) * G;
  const int Gb = min(G, H - h0);

  // Stage q and k in one cp.async group and v in a second, so that pass 1
  // runs while v lands; by row, then head, then 16-byte word, so that
  // neighbouring threads read neighbouring words of a row.
  {
    const int per_row = Gb * CW;
    const int dj = blockDim.x / per_row, dw = blockDim.x - dj * per_row;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      int j = threadIdx.x / per_row, w = threadIdx.x - j * per_row;
      for (; j < Np; j += dj, w += dw) {
        if (w >= per_row) {
          w -= per_row;
          if (++j >= Np) break;
        }
        const int g = w / CW;
        const int c = (w - g * CW) * 8;
#pragma unroll
        for (int t = part == 0 ? 0 : 2; t < (part == 0 ? 2 : 3); ++t) {
          const bf16* src0 = t == 0 ? q : t == 1 ? k : v;
          const Strides st = t == 0 ? sq : t == 1 ? sk : sv;
          bf16* dst = (t == 0 ? Qs : t == 1 ? Ks : Vs) + g * plane + (size_t)j * LD + c;
          if (j < N && c < d)
            cp_async16(dst, src0 + b * st.b + (h0 + g) * st.h + (size_t)j * st.n + c);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;      // the fragment's row (and row + 8)
  const int tig = lane & 3;       // its column pair
  const int T = Np / 16;
  const int nwarps = blockDim.x >> 5;
  const int items = Gb * T;
  // rounds of one item per warp: every warp meets the barrier of round 0
  for (int r = 0; r * nwarps < items; ++r) {
    const int item = r * nwarps + warp;
    const bool active = item < items;
    const int g = active ? item / T : 0;
    const int i0 = (item - g * T) * 16;
    const int h = h0 + g;
    bf16* Qg = Qs + g * plane;
    const bf16* Kg = Ks + g * plane;
    const bf16* Vg = Vs + g * plane;
    // keys this tile can see: all valid ones, or those up to its last row;
    // every row of the tile sees the first `lo` keys, so a key step below
    // `lo` needs no mask
    const int nk = causal ? min(kv_len, min(i0 + 16, N)) : kv_len;
    const int lo = causal ? min(kv_len, i0 + 1) : kv_len;
    const int nks = (nk + 15) / 16;
    const int r0 = i0 + gid, r1 = r0 + 8;
    const int lim0 = causal ? min(kv_len, r0 + 1) : kv_len;
    const int lim1 = causal ? min(kv_len, r1 + 1) : kv_len;

    // q rows as A fragments: rows 0-7 | d 0-7, rows 8-15 | d 0-7, rows 0-7 | d 8-15, ...
    uint32_t qf[KS][4];
    // pass 1: each row's max score (this thread's columns, then the quad's)
    float m0 = kNegInf, m1 = kNegInf;
    if (active) {
      const bf16* row = Qg + (size_t)(i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], row + ks * 16);
      for (int st = 0; st < nks; ++st) {
        float s[2][4];
        score_step<KS>(qf, Kg, st, lane, s);
        const bool full = st * 16 + 16 <= lo;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = st * 16 + n * 8 + tig * 2 + (e & 1);
            const float x = full || j < (e < 2 ? lim0 : lim1) ? s[n][e] : kNegInf;
            if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
          }
        }
      }
      // in log2 units; scale > 0, so the max of the scaled scores.  Key 0 is
      // seen by every row, so both are finite.
      m0 = quad_max(m0) * scale_log2;
      m1 = quad_max(m1) * scale_log2;
    }
    if (r == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    // pass 2: e = 2^(S·scale·log2 e − m) in fp32, its row sums, and e·V with
    // e as bf16 hi + lo
    float o[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int st = 0; st < nks; ++st) {
      float s[2][4];
      score_step<KS>(qf, Kg, st, lane, s);
      const bool full = st * 16 + 16 <= lo;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = st * 16 + n * 8 + tig * 2 + (e & 1);
          const float x = ex2(fmaf(s[n][e], scale_log2, e < 2 ? -m0 : -m1));
          s[n][e] = full || j < (e < 2 ? lim0 : lim1) ? x : 0.f;
          if (e < 2) l0 += s[n][e]; else l1 += s[n][e];
        }
      }
      uint32_t ph[4], pl[4];
      split2(s[0][0], s[0][1], ph[0], pl[0]);
      split2(s[0][2], s[0][3], ph[1], pl[1]);
      split2(s[1][0], s[1][1], ph[2], pl[2]);
      split2(s[1][2], s[1][3], ph[3], pl[3]);
      // matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 8-15
      const bf16* row = Vg + (size_t)(st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, row + dt * 16);
        mma_bf16(o[2 * dt], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dt], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dt + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * dt + 1], pl, bv[2], bv[3]);
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t prow = ((size_t)b * H + h) * N;    // row 0 of this head's P and lse

    if (probs != nullptr) {
      // pass 3 (saved P only): the same e again, P = bf16(e / Σ) into the
      // warp's tile.  The tile's rows below N are one run of device memory;
      // the tile starts at the run's offset modulo 16 bytes, so the run
      // leaves as 16-byte words with single values at its two ends.
      const size_t p0 = (prow + i0) * N;
      bf16* Pw = Ps + warp * p_tile(N) + (p0 & 7);
      for (int st = 0; st < nks; ++st) {
        float s[2][4];
        score_step<KS>(qf, Kg, st, lane, s);
        const bool full = st * 16 + 16 <= lo;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = st * 16 + n * 8 + tig * 2 + (e & 1);
            const float x = ex2(fmaf(s[n][e], scale_log2, e < 2 ? -m0 : -m1));
            if (j < N)
              Pw[(gid + (e < 2 ? 0 : 8)) * N + j] = __float2bfloat16_rn(
                  full || j < (e < 2 ? lim0 : lim1) ? x * (e < 2 ? inv0 : inv1) : 0.f);
          }
        }
      }
      // columns past the visited keys (causal tiles) are zeros
      const int seen = nks * 16;
      for (int idx = lane; seen < N && idx < 16 * (N - seen); idx += 32)
        Pw[(idx / (N - seen)) * N + seen + idx % (N - seen)] = __float2bfloat16_rn(0.f);
      __syncwarp();
      const int count = min(16, N - i0) * N;
      const int head = min(count, (int)((8 - (p0 & 7)) & 7));
      bf16* dst = probs + p0;
      for (int e = lane; e < head; e += 32) dst[e] = Pw[e];
      const int words = (count - head) / 8;
      for (int e = lane; e < words; e += 32)
        *reinterpret_cast<uint4*>(dst + head + 8 * e) =
            *reinterpret_cast<const uint4*>(Pw + head + 8 * e);
      for (int e = head + 8 * words + lane; e < count; e += 32) dst[e] = Pw[e];
    }
    if (lse != nullptr && tig == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      if (r0 < N) lse[prow + r0] = (m0 + log2f(l0)) * kLn2;
      if (r1 < N) lse[prow + r1] = (m1 + log2f(l1)) * kLn2;
    }

    // O = (e·V) / Σ: bf16 into the warp's own q rows (read into registers
    // above), then 16-byte stores of the rows below N
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = n * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(Qg + (size_t)r0 * LD + c) =
          pack2(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(Qg + (size_t)r1 * LD + c) =
          pack2(o[n][2] * inv1, o[n][3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int idx = lane; idx < 16 * CW; idx += 32) {
      const int rl = idx / CW;
      const int c = (idx - rl * CW) * 8;
      if (c < d && i0 + rl < N)
        *reinterpret_cast<uint4*>(out + b * so.b + h * so.h + (size_t)(i0 + rl) * so.n + c) =
            *reinterpret_cast<const uint4*>(Qg + (size_t)(i0 + rl) * LD + c);
    }
    __syncwarp();
  }
}

}  // namespace mma_attn
}  // namespace dc
