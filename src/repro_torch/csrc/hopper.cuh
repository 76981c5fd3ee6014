// Hopper building blocks shared by the port's tensor-core kernels
// (redmule_gemm_tc.cu, flash_attention_tc.cu): mbarriers, TMA tile loads,
// wgmma shared-memory descriptors and the wgmma instructions the kernels
// issue, plus the host-side lookup of cuTensorMapEncodeTiled.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4D tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart. For a K-major tile the
// leading byte offset is unused; for an MN-major one (read with the
// transpose bit) it is the distance between 64-element column blocks.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes = 16) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;  // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;                  // stride byte offset: next 8-row group
  d |= (uint64_t)1 << 62;                            // 128-byte swizzle
  return d;
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define HOPPER_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_OUT32                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])
#define HOPPER_OUT64                                                                    \
  HOPPER_OUT32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A.B for one m64n128k16 step, both operands K-major in shared
// memory (descriptors da, db); scale_d = 0 starts d afresh. BF16 picks the
// operand type (fp16 otherwise).
template <bool BF16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (BF16) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_OUT64 : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HOPPER_D64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_OUT64 : "l"(da), "l"(db), "r"(scale_d));
  }
}

// The same for one m64n64k16 step (d: 32 accumulators a thread).
template <bool BF16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  if constexpr (BF16) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_OUT32 : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_OUT32 : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (+)= A.B for one m64nNk16 step (N = 128 or 64 by d's size): A from
// registers (four packed 16-bit pairs a thread, the m16n8k16 A fragment of
// the thread's warp's 16 rows), B MN-major in shared memory (the transpose
// bit set); scale_d = 0 starts d afresh.
#define HOPPER_RS(OUTS, OPERANDS)                                                        \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " OPERANDS "\n}\n"                     \
               : OUTS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define HOPPER_RS128(SHAPE)                                                              \
  HOPPER_RS(HOPPER_OUT64,                                                                \
            "%69, 0;\n wgmma.mma_async.sync.aligned." SHAPE " " HOPPER_D64              \
            ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;")
#define HOPPER_RS64(SHAPE)                                                               \
  HOPPER_RS(HOPPER_OUT32,                                                                \
            "%37, 0;\n wgmma.mma_async.sync.aligned." SHAPE " " HOPPER_D32              \
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;")

template <bool BF16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  if constexpr (BF16) {
    HOPPER_RS128("m64n128k16.f32.bf16.bf16");
  } else {
    HOPPER_RS128("m64n128k16.f32.f16.f16");
  }
}

template <bool BF16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  if constexpr (BF16) {
    HOPPER_RS64("m64n64k16.f32.bf16.bf16");
  } else {
    HOPPER_RS64("m64n64k16.f32.f16.f16");
  }
}

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point
// query, so the library links against neither libcuda nor a stub.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
