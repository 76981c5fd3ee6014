// Element loads and stores shared by the port's kernels.
//
// Operands arrive in any storage format of the precision policies (fp32,
// fp16, bf16, E4M3, E5M2), named by a runtime code that matches
// repro_torch.kernels._build.DTYPE_CODE. Every load widens to fp32, which
// is exact for all five formats; rounding happens only where the
// reference rounds (to the compute format, and at the output cast).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_E4M3 = 3, DT_E5M2 = 4 };

__device__ __forceinline__ float fp8_to_float(uint8_t bits, __nv_fp8_interpretation_t kind) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)bits, kind);
  return __half2float(__half(h));
}

__device__ __forceinline__ float load_as_float(const void* p, long long i, int dt) {
  switch (dt) {
    case DT_F32: return static_cast<const float*>(p)[i];
    case DT_F16: return __half2float(static_cast<const __half*>(p)[i]);
    case DT_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_E4M3: return fp8_to_float(static_cast<const uint8_t*>(p)[i], __NV_E4M3);
    default: return fp8_to_float(static_cast<const uint8_t*>(p)[i], __NV_E5M2);
  }
}

// Round an fp32 value to the compute format and widen it back.
__device__ __forceinline__ float round_to(float v, int dt) {
  switch (dt) {
    case DT_F16: return __half2float(__float2half_rn(v));
    case DT_BF16: return __bfloat162float(__float2bfloat16_rn(v));
    default: return v;
  }
}

// The output cast unit. E4M3 follows the reference's rule, not the
// hardware's saturating one: |v| > 464 (past the midpoint between 448 and
// the absent 480), +-inf and NaN become NaN with the input's sign; the
// rest rounds to nearest even through the non-saturating conversion.
__device__ __forceinline__ void store_from_float(void* p, long long i, int dt, float v) {
  switch (dt) {
    case DT_F32: static_cast<float*>(p)[i] = v; break;
    case DT_F16: static_cast<__half*>(p)[i] = __float2half_rn(v); break;
    case DT_BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v); break;
    case DT_E4M3: {
      uint8_t bits = fabsf(v) <= 464.0f
          ? (uint8_t)__nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3)
          : (uint8_t)(signbit(v) ? 0xFF : 0x7F);
      static_cast<uint8_t*>(p)[i] = bits;
      break;
    }
    default:
      static_cast<uint8_t*>(p)[i] = (uint8_t)__nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E5M2);
  }
}
