// A GEMM main loop on Hopper's wgmma and TMA: D[rows, N] = X[rows, K] · B
// with fp32 sums, one BM x BN output tile per block, for a kernel that brings
// its own epilogue.  Its users: dense_act.cu (#10-#12), dense_ln_wgmma.cu (K1,
// K2 and #8, with the LayerNorm applied to the A fragments in registers) and
// dense_ln_bwd.cu (#9, B K-major, its row sums across a thread-block cluster;
// in its activation mode A = du made in registers from dh, u and e).
//
// Layouts: X row-major (K contiguous: a K-major A operand).  B is either
// W[K, N] row-major (N contiguous, the Flax Dense layout the converter keeps:
// an MN-major B operand, which wgmma takes through its transpose bit), or,
// with KMAJOR_B, W[N, K] row-major (K contiguous: the B of du·Wᵀ, whose
// contraction runs along the rows of the stored W).
//
// Design (sm_90a):
// * Tiles of BM = 128 rows by BN = 256 columns, BK = 64 deep: the grid covers
//   output tiles, so a block reads its 128 rows of X and its 256 columns of B
//   once (B from L2, which holds all of it).
// * A ring of four K-stages in shared memory (48 KB each: the 128 x 64 X tile
//   as one TMA box; the 64 x 256 B slice as four boxes of 64 columns, or as
//   one 256-row box of 64 K-values with KMAJOR_B), all with 128-byte swizzle,
//   filled by TMA and completed on one mbarrier per stage (`full`); the
//   consumers release a stage on a second (`empty`).
// * Warpgroup 0 is the producer: one thread issues the loads, the others
//   wait.  Warpgroups 1 and 2 are consumers: each issues wgmma.mma_async
//   m64n256k16 (-> fp32) on its 64 rows, four per stage, and holds its
//   64 x 256 fp32 sums in 128 registers a thread.  The shared-memory form
//   (consume) keeps one stage's wgmma group in flight while it issues the
//   next, and releases a stage once its group has completed; a kernel that
//   transforms A on its way to the tensor cores runs its own loop on the same
//   ring with A from registers (wgmma_m64n256k16_rs_f16).
// * TMA zero-fills what lies past rows, K or N, so ragged tiles need no mask
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
constexpr int kBBox = BK * 64 * 2;                  // one 64-column box of an MN-major B: 8 KB
constexpr int kStageBytes = kABytes + (BN / 64) * kBBox;   // 48 KB
// the ring, two mbarriers per stage, and room to align the ring to 1024 bytes
constexpr size_t kSmemBytes = (size_t)STAGES * kStageBytes + 2 * STAGES * 8 + 1024;

// A tensor of 2-byte elements with `rank` dimensions as TMA reads it (dims
// innermost first, the byte strides of the outer ones): boxes of `box`
// elements, 128-byte swizzle unless `swizzle` says otherwise, zeros past its
// edges.  False when cuTensorMapEncodeTiled refuses it.
__host__ inline bool make_tensor_map_nd(
    CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
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
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D row-major tensor [outer, inner] of 2-byte elements, as above.
__host__ inline bool make_tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                                     uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return make_tensor_map_nd(map, ptr, 2, dims, strides, box, type);
}

// The ring: the block's dynamic shared memory, aligned to 1024 bytes (the
// period of the 128-byte swizzle).
__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

// Shared memory past the ring and its barriers, for what a kernel keeps
// beside it (16-byte aligned).
__device__ __forceinline__ unsigned char* after_ring() {
  return ring_base() + STAGES * kStageBytes + 2 * STAGES * 8;
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

// Ask for the box at (c0 inner, c1 outer) of `map` to be brought into L2.
__device__ __forceinline__ void tma_prefetch_l2(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
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

// The 128 sums of a thread as the wgmma's D operands.
#define DC_WG_ACC                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                   \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"          \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"  \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119," \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define DC_WG_ACC_OPS(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),                \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),              \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),          \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),          \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),          \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),          \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),          \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),          \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),          \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),          \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),        \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),    \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),    \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),    \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),    \
  "+f"(d[126]), "+f"(d[127])

// d[64 x 256] += A[64 x 16] · B[16 x 256], bf16 from shared memory: A
// K-major; B MN-major (TRANS_B 1) or K-major (TRANS_B 0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DC_WG_ACC
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : DC_WG_ACC_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d[64 x 256] += A[64 x 16] · B[16 x 256], fp16: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows, two fp16 a register), B
// MN-major from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_rs_f16(float (&d)[128], const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " DC_WG_ACC
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : DC_WG_ACC_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same in bf16 with B K-major (the B of du·Wᵀ).
__device__ __forceinline__ void wgmma_m64n256k16_rs_bf16_kmajor(float (&d)[128],
                                                                const uint32_t (&a)[4],
                                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DC_WG_ACC
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : DC_WG_ACC_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Keep a stage's A fragment registers as they are up to here: a wgmma that
// reads them runs on after it is issued, until a wait_group says it has
// completed.
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Registers a thread: the producer warpgroup gives most of its share to the
// two consumer warpgroups, whose 128 fp32 sums and epilogue need more than the
// 168 a thread that 384 threads an SM start with (40 + 2 · 232 = 3 · 168).
// Each is called by a whole warpgroup, on paths that do not meet again.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// The ring of a block and its barriers.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
};

// Initialise the ring's barriers; a block-wide barrier, so everything the
// block wrote to shared memory before it is visible after it.
__device__ __forceinline__ Ring ring_init() {
  Ring r;
  r.base = ring_base();
  r.full = reinterpret_cast<uint64_t*>(r.base + STAGES * kStageBytes);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer (one thread): X rows m0.., B columns n0.., over K.
template <bool KMAJOR_B>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* ta,
                                        const CUtensorMap* tb, int m0, int n0, int K) {
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES) mbar_wait(&r.empty[s], ((kt / STAGES) - 1) & 1);
    unsigned char* st = r.base + s * kStageBytes;
    mbar_expect_tx(&r.full[s], kStageBytes);
    tma_load(st, ta, kt * BK, m0, &r.full[s]);
    if (KMAJOR_B) {
      tma_load(st + kABytes, tb, kt * BK, n0, &r.full[s]);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load(st + kABytes + j * kBBox, tb, n0 + 64 * j, kt * BK, &r.full[s]);
    }
  }
}

// Both consumer warpgroups are past their last wgmma: the ring may be reused.
__device__ __forceinline__ void end_mainloop(float (&d)[128]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_sums(d);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Consumer warpgroup cw (0, 1): its 64 rows of the tile, rows m0 + 64 cw ..
// + 63 of X, over K, A and B from the ring.  In d, warp i of the warpgroup
// holds rows 16i .. 16i + 15 of those, and d[4j .. 4j + 3] are the m16n8 C
// fragment of columns 8j .. 8j + 7 (rows lane/4 and lane/4 + 8, columns
// 2 (lane % 4) and + 1).
//
// A kernel on this ring: ring_init(); then warpgroup 0 calls producer_regs()
// and its thread 0 produce(), warpgroups 1 and 2 consumer_regs() and
// consume(), on two paths that do not meet again (setmaxnreg).
template <bool KMAJOR_B>
__device__ __forceinline__ void consume(const Ring& r, int cw, int K, float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&r.full[s], (kt / STAGES) & 1);
    const unsigned char* a = r.base + s * kStageBytes + cw * (64 * BK * 2);
    const unsigned char* b = r.base + s * kStageBytes + kABytes;
    fence_sums(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A (and a K-major B): rows of 128 bytes, 8-row groups 1024 bytes apart,
      // k16 = 32 bytes on; an MN-major B: 8-row (k) groups 1024 bytes apart,
      // 64-column boxes 8 KB apart, k16 = two groups on
      const uint64_t db = KMAJOR_B ? desc(b + kk * 32, 16, 1024)
                                   : desc(b + kk * 2048, kBBox, 1024);
      wgmma_m64n256k16<KMAJOR_B ? 0 : 1>(d, desc(a + kk * 32, 16, 1024), db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's group has completed: its stage is free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0) mbar_arrive(&r.empty[(kt - 1) % STAGES]);
  }
  end_mainloop(d);
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

// The GEMMs' epilogue on a consumer's sums: bias (with act 0, none where
// bias is NULL) and activation on the fp32 sum u, then one bf16 rounding of
// each output: act 0 writes u into out; act 1 (exact GELU) or 2 (QuickGELU)
// writes h = 0.5 u (1 + e) or u e into out, with e = erf(u/√2) or σ(1.702 u)
// (common.cuh's activate), and with RES also u and e into out_u and out_e.
template <int ACT, bool RES>
__device__ __forceinline__ void epilogue_store(const float (&d)[128],
                                               const bf16* __restrict__ bias,
                                               bf16* __restrict__ out, bf16* __restrict__ out_u,
                                               bf16* __restrict__ out_e, int m0, int n0,
                                               int rows, int N) {
  const int t = threadIdx.x - 128;            // consumer threads 0 .. 255
  const int cw = t >> 7, ti = t & 127;        // warpgroup, thread in it
  const int lane = t & 31;
  const int ra = ((t >> 5) & 3) * 16 + (lane >> 2);   // rows ra, ra + 8 of the slice
  bf16* bu = epilogue_buffer(0, cw);
  bf16* be = epilogue_buffer(1, cw);
  bf16* bh = epilogue_buffer(RES ? 2 : 0, cw);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    // past N the sums are zeros (TMA) and the columns are not stored; only
    // act 0 (K1) may come without a bias (the check costs the activations'
    // epilogues registers)
    float b0 = 0.f, b1 = 0.f;
    if ((ACT != 0 || bias != nullptr) && n0 + c < N) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c);
      b0 = __low2float(bb);
      b1 = __high2float(bb);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = epilogue_index(ra + 8 * r, c);
      const float u0 = d[4 * j + 2 * r] + b0, u1 = d[4 * j + 2 * r + 1] + b1;
      if (ACT == 0) {
        *reinterpret_cast<__nv_bfloat162*>(bh + at) = __floats2bfloat162_rn(u0, u1);
        continue;
      }
      float e0, e1;
      const float h0 = activate<ACT, RES>(u0, e0), h1 = activate<ACT, RES>(u1, e1);
      if (RES) {
        *reinterpret_cast<__nv_bfloat162*>(bu + at) = __floats2bfloat162_rn(u0, u1);
        *reinterpret_cast<__nv_bfloat162*>(be + at) = __floats2bfloat162_rn(e0, e1);
      }
      *reinterpret_cast<__nv_bfloat162*>(bh + at) = __floats2bfloat162_rn(h0, h1);
    }
  }
  // the warpgroup's slices are written
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  const int m0w = m0 + 64 * cw;
  store_slice(bh, out, m0w, n0, rows, N, ti);
  if (RES) {
    store_slice(bu, out_u, m0w, n0, rows, N, ti);
    store_slice(be, out_e, m0w, n0, rows, N, ti);
  }
}

// ---- thread-block clusters ----------------------------------------------------

// Every thread of every block of the cluster; the release orders this block's
// shared-memory writes before the peers' reads after their wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float2 at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float2 ld_cluster_f2(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

}  // namespace wg
}  // namespace dc
