// The tensor-core pieces shared by K1's bf16/int8 screen (union_groupmin.cu)
// and K2's "default"/int8 sweep (groupmin.cu): both score a 128-query x
// 256-row tile with wgmma (sm_90a) out of a shared-memory ring that TMA
// fills, and reduce the accumulators to group minima in registers.
//
// * Operands.  The queries are wgmma's A (M) and the corpus rows its B
//   (N), both K-major as they lie in memory (d contiguous; the 8-bit wgmma
//   requires it), in the 128-byte swizzle.  A CTA of two warpgroups
//   computes a 128-query x 256-row tile: each warpgroup one m64n256
//   product (k16 bf16, k32 int8), accumulated over d in steps of 128 bytes
//   a row, the width of the swizzle.
// * A stage holds one such step of the 128 queries and the 256 rows, and
//   the rows' norms (loaded with a tile's last step).  One thread fills it
//   with two 2D TMA boxes (zero past the matrix) and one bulk copy of the
//   norms, all completing on the stage's mbarrier.
// * Tensor maps are encoded on the host through the driver entry point
//   (no -lcuda).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg_gm {

constexpr int WM = 128;           // queries per tile: two warpgroups of m64
constexpr int WN = 256;           // corpus rows per tile: one n256 wgmma
constexpr int KB = 128;           // bytes of d per stage (the swizzle row)
constexpr int STAGES = 4;         // ring depth
constexpr int DIST = STAGES - 2;  // steps loaded ahead of the tensor cores
constexpr int WT = 256;           // threads: two consumer warpgroups

struct __align__(1024) Stage {
  uint8_t a[WM * KB];  // queries, 128 rows x 128 B, 128-byte swizzle
  uint8_t b[WN * KB];  // corpus rows, 256 rows x 128 B, 128-byte swizzle
  float xn[WN];        // the 256 rows' norms (loaded with the last d stage)
};
constexpr int STAGE_TX = (WM + WN) * KB;  // TMA bytes of a stage, norms aside
// the ring, its "full" mbarriers, alignment slack
constexpr size_t WG_SMEM = STAGES * sizeof(Stage) + STAGES * sizeof(uint64_t) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 B, 8-row core groups 1024 B apart (SBO); LBO is unused for swizzled
// K-major layouts.  The tile base is 1024-aligned; advancing k by 32 bytes
// adds 2 to the start address (the swizzle acts on the absolute address).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// an mbarrier whose phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the one arrival of a stage's phase, expecting `bytes` of copies
__device__ __forceinline__ void arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// 2D TMA load of one box into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) into
// shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait for the phase of parity `parity` of mbarrier `bar` (parity 1 on a
// fresh barrier: at once); a copy that never lands traps (a launch error)
// instead of hanging the card
__device__ __forceinline__ void wait_full(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 26)) __trap();
  }
}

#define WG_D128                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "              \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "              \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "              \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "              \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "              \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "            \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "            \
  "%124, %125, %126, %127}"
#define WG_R1(C, i) C(d[i])
#define WG_R8(C, i)                                                                    \
  WG_R1(C, i), WG_R1(C, i + 1), WG_R1(C, i + 2), WG_R1(C, i + 3), WG_R1(C, i + 4),     \
      WG_R1(C, i + 5), WG_R1(C, i + 6), WG_R1(C, i + 7)
#define WG_R128(C)                                                                     \
  WG_R8(C, 0), WG_R8(C, 8), WG_R8(C, 16), WG_R8(C, 24), WG_R8(C, 32), WG_R8(C, 40),    \
      WG_R8(C, 48), WG_R8(C, 56), WG_R8(C, 64), WG_R8(C, 72), WG_R8(C, 80),           \
      WG_R8(C, 88), WG_R8(C, 96), WG_R8(C, 104), WG_R8(C, 112), WG_R8(C, 120)
#define WG_F(x) "+f"(x)
#define WG_I(x) "+r"(x)

// D(64x256 f32) (+)= A(64x16 bf16) * B(256x16 bf16)^T, both K-major
__device__ __forceinline__ void wgmma_k(float (&d)[128], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_R128(WG_F)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64x256 s32) (+)= A(64x32 s8) * B(256x32 s8)^T, both K-major
__device__ __forceinline__ void wgmma_k(int (&d)[128], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_D128
      ", %128, %129, p;\n}\n"
      : WG_R128(WG_I)
      : "l"(da), "l"(db), "r"(accumulate));
}

// keep the compiler from moving accumulator reads across the async MMAs
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+f"(d[j])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (rows, row_bytes) byte matrix read in boxes of box_rows x 128 bytes,
// 128-byte swizzled, zero past the matrix
inline bool byte_map(CUtensorMap* map, const void* base, int row_bytes, long long rows,
                     int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace wg_gm
