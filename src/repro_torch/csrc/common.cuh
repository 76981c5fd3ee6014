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

// Table-1 operators; the codes match repro_torch.core.semiring.OP_CODE.
enum OpCode { OP_MUL = 0, OP_ADD = 1, OP_MIN = 2, OP_MAX = 3 };

__device__ __forceinline__ int dtype_bytes(int dt) {
  return dt == DT_F32 ? 4 : dt <= DT_BF16 ? 2 : 1;
}

// min and max as jnp.minimum / jnp.maximum compute them: NaN propagates and
// -0 orders below +0 (IEEE 754-2019 minimum / maximum), one instruction each.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One operator in fp32, rounded once (no contraction into an FMA).
template <int OP>
__device__ __forceinline__ float op_f32(float a, float b) {
  if constexpr (OP == OP_MUL) return __fmul_rn(a, b);
  else if constexpr (OP == OP_ADD) return __fadd_rn(a, b);
  else if constexpr (OP == OP_MIN) return fmin_nan(a, b);
  else return fmax_nan(a, b);
}

// The same for an operator known only at run time (the split-K combine).
__device__ __forceinline__ float op_f32(int op, float a, float b) {
  switch (op) {
    case OP_MUL: return __fmul_rn(a, b);
    case OP_ADD: return __fadd_rn(a, b);
    case OP_MIN: return fmin_nan(a, b);
    default: return fmax_nan(a, b);
  }
}

template <int OP>
__device__ __forceinline__ float identity_f32() {
  if constexpr (OP == OP_ADD) return 0.0f;
  else if constexpr (OP == OP_MIN) return __int_as_float(0x7f800000);  // +inf
  else if constexpr (OP == OP_MAX) return __int_as_float(0xff800000);  // -inf
  else return 1.0f;
}

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
