// A bf16 GEMM main loop on Hopper's wgmma and TMA: D[rows, N] = X[rows, C] ·
// W[C, N] with fp32 sums, one BM x BN output tile per block, for a kernel
// that brings its own epilogue.  dense_act.cu (#10-#12) is its first user; the
// LN-GEMMs (dense_ln.cu, dense_ln_bwd.cu) are meant to take it up.
//
// Layouts: X row-major (C contiguous: a K-major A operand), W row-major [C, N]
// (N contiguous, the Flax Dense layout the converter keeps: an MN-major B
// operand, which wgmma takes for bf16 through its transpose bit).
//
// Design (sm_90a):
// * Tiles of BM = 128 rows by BN = 256 columns, BK = 64 deep: the grid covers
//   output tiles, so a block reads its 128 rows of X and its 256 columns of W
//   once (W from L2, which holds all of it).
// * A ring of four K-stages in shared memory (48 KB each: the 128 x 64 X tile
//   as one TMA box, the 64 x 256 W slice as four boxes of 64 columns), both
//   with 128-byte swizzle, filled by TMA and completed on one mbarrier per
//   stage (`full`); the consumers release a stage on a second (`empty`).
// * Warpgroup 0 is the producer: one thread issues the loads, the others
//   leave.  Warpgroups 1 and 2 are consumers: each issues wgmma.mma_async
//   m64n256k16 (bf16 x bf16 -> fp32) on its 64 rows, four per stage, from the
//   two shared-memory descriptors, and holds its 64 x 256 fp32 sums in 128
//   registers a thread.
//   A consumer keeps one stage's wgmma group in flight while it issues the
//   next, and releases a stage once its group has completed.
// * TMA zero-fills what lies past rows, C or N, so ragged tiles need no mask
//   in the main loop; the epilogue masks its stores.
// * After the main loop the ring is free: epilogue_buffer() hands each
//   consumer warpgroup 32 KB slices of it for bf16 output tiles, so that the
//   stores leave as 16-byte words along rows.
//
// Tensor maps are built on the host per call (make_tensor_map: the driver's
// cuTensorMapEncodeTiled, found through the runtime's driver entry point, so
// the library needs no -lcuda) and passed as __grid_constant__ parameters.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace dc {
namespace wg {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int kThreads = 384;                       // producer + two consumer warpgroups
constexpr int kABytes = BM * BK * 2;                // 16 KB
constexpr int kBBox = BK * 64 * 2;                  // one 64-column box of W: 8 KB
constexpr int kStageBytes = kABytes + (BN / 64) * kBBox;   // 48 KB
// the ring, two mbarriers per stage, and room to align the ring to 1024 bytes
constexpr size_t kSmemBytes = (size_t)STAGES * kStageBytes + 2 * STAGES * 8 + 1024;

// A 2-D row-major bf16 tensor [outer, inner] as TMA reads it: boxes of
// box_inner x box_outer elements, 128-byte swizzle, zeros past its edges.
// False when the driver refuses it.
__host__ inline bool make_tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                                     uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring: the block's dynamic shared memory, aligned to 1024 bytes (the
// period of the 128-byte swizzle).
__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box at (c0 inner, c1 outer) of `map` into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keep the compiler from moving accesses of the sums across the wgmma fences.
__device__ __forceinline__ void fence_sums(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] · B[16 x 256]: A K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The block's tile: rows m0 .. m0 + BM - 1, columns n0 .. n0 + BN - 1, over
// K = C.  Consumer threads return true with their sums in d: warpgroup w
// (1 or 2) holds rows m0 + 64 (w - 1) .. + 63, warp i of it rows 16i .. 16i +
// 15 of those, and d[4j .. 4j + 3] are the m16n8 C fragment of columns 8j ..
// 8j + 7 (rows lane/4 and lane/4 + 8, columns 2 (lane % 4) and + 1).  The
// producer's threads return false.
__device__ __forceinline__ bool gemm_tile(const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                          int n0, int K, float (&d)[128]) {
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * kStageBytes);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int role = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;

  if (role == 0) {
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        unsigned char* st = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(st, ta, kt * BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(st + kABytes + j * kBBox, tb, n0 + 64 * j, kt * BK, &full[s]);
      }
    }
    return false;
  }

  const int cw = role - 1;
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a = ring + s * kStageBytes + cw * (64 * BK * 2);
    const unsigned char* b = ring + s * kStageBytes + kABytes;
    fence_sums(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: rows of 128 bytes, 8-row groups 1024 bytes apart, k16 = 32 bytes on;
      // B: 8-row (k) groups 1024 bytes apart, 64-column boxes 8 KB apart, k16 =
      // two groups on
      wgmma_m64n256k16(d, desc(a + kk * 32, 16, 1024), desc(b + kk * 2048, kBBox, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's group has completed: its stage is free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_sums(d);
  // both consumer warpgroups are past their last wgmma: the ring may be reused
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  return true;
}

// Output slice k (0 .. 2) of consumer warpgroup cw (0, 1): 64 rows of BN bf16
// (32 KB), the 16-byte word c of row r at word c ^ (r % 8), so that both the
// fragment writes and the row reads are free of bank conflicts.
__device__ __forceinline__ bf16* epilogue_buffer(int k, int cw) {
  static_assert(3 * 2 * 64 * BN * 2 <= STAGES * kStageBytes, "three outputs fit the ring");
  return reinterpret_cast<bf16*>(ring_base() + (k * 2 + cw) * (64 * BN * 2));
}

// Element (r, c) of an epilogue slice (c even: a bf16 pair stays in one word).
__device__ __forceinline__ int epilogue_index(int r, int c) {
  return r * BN + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// Rows of a finished slice to out [rows, N] (row m0w of the slice is row m0w
// of out), 16-byte words by 128 threads (t = 0 .. 127), rows below `rows` and
// columns below N only.
__device__ __forceinline__ void store_slice(const bf16* buf, bf16* __restrict__ out, int m0w,
                                            int n0, int rows, int N, int t) {
#pragma unroll 4
  for (int idx = t; idx < 64 * (BN / 8); idx += 128) {
    const int r = idx / (BN / 8), c = idx % (BN / 8);
    const int g = m0w + r, col = n0 + c * 8;
    if (g < rows && col < N)
      *reinterpret_cast<uint4*>(out + (size_t)g * N + col) =
          *reinterpret_cast<const uint4*>(buf + r * BN + ((c ^ (r & 7)) << 3));
  }
}

}  // namespace wg
}  // namespace dc
