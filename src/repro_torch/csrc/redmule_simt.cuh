// The tiled forms of the GEMM-Op kernel's SIMT schedule (redmule_gemm.cu
// has the schedule's note): operand staging through a cp.async ring, the
// conversion into the compute tile, and the tile kernel, shared by
// redmule_gemm.cu (the f32 form) and redmule_gemm_h2.cu (the h2 form) so
// that the two compile in parallel.
#pragma once

#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace redmule_simt {

constexpr int BM = 64, BN = 128, BK = 16, BK_LOG = 4, THREADS = 128;  // tiled forms
template <int R> constexpr int R_LOG = R == 64 ? 6 : 7;  // log2 of BM, BN
constexpr int PAD = 4;  // words a compute-tile row is padded by: conversion stores 2-way at most

enum Form { FORM_WARP = 0, FORM_F32 = 1, FORM_H2 = 2 };

// One operand as the SIMT forms read it: rows (M for X, N for W) of K
// elements, in its storage format.
struct Operand {
  const uint8_t* p;
  int dt, es;                // storage code and bytes an element
  int rows, k;
  long long s1, s2, sr, sk;  // element strides: batch levels, row, K
  int kfast;                 // staged with K fastest (else rows fastest)
  int vec;                   // 16-byte cp.async requests along the fast axis
};

struct GemmArgs {
  Operand x, w;
  const void* y;  // null: no Y (with split > 1 the combine folds Y)
  void* z;        // contiguous (b1, b2, m, n)
  float* ws;      // (b1 * b2, split, m, n) fp32 partials when split > 1
  int y_dt, z_dt;
  int b2, m, n, k, split, k_per_split;
  long long sy1, sy2, sym, syn;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t load_bits(const uint8_t* p, long long i, int es) {
  if (es == 1) return p[i];
  if (es == 2) return reinterpret_cast<const uint16_t*>(p)[i];
  return reinterpret_cast<const uint32_t*>(p)[i];
}

__device__ __forceinline__ void store_bits(uint8_t* p, int i, int es, uint32_t v) {
  if (es == 1) p[i] = static_cast<uint8_t>(v);
  else if (es == 2) reinterpret_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v);
  else reinterpret_cast<uint32_t*>(p)[i] = v;
}

// Two fp8 elements widened to fp16 by one packed conversion (exact).
__device__ __forceinline__ __half2 fp8x2_to_half2(uint32_t e0, uint32_t e1, int dt) {
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(e0 | (e1 << 8)), dt == DT_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half2(r);
}

// Two storage elements widened to fp32 (exact for every format).
__device__ __forceinline__ float2 widen_pair(uint32_t e0, uint32_t e1, int dt) {
  switch (dt) {
    case DT_F32: return make_float2(__uint_as_float(e0), __uint_as_float(e1));
    case DT_F16:
      return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(e0))),
                         __half2float(__ushort_as_half(static_cast<unsigned short>(e1))));
    case DT_BF16:
      return make_float2(__bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(e0))),
                         __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(e1))));
    default: return __half22float2(fp8x2_to_half2(e0, e1, dt));
  }
}

// The packed 16-bit compute formats of the h2 form.
template <int CT> struct H2;

template <> struct H2<DT_F16> {
  using T = __half2;
  static __device__ __forceinline__ T from_pair(uint32_t e0, uint32_t e1, int dt) {
    if (dt == DT_E4M3 || dt == DT_E5M2) return fp8x2_to_half2(e0, e1, dt);
    if (dt == DT_F16) {
      return __halves2half2(__ushort_as_half(static_cast<unsigned short>(e0)),
                            __ushort_as_half(static_cast<unsigned short>(e1)));
    }
    return __float22half2_rn(widen_pair(e0, e1, dt));  // fp32, bf16: rounded once
  }
  static __device__ __forceinline__ T splat(unsigned short bits) {
    return __halves2half2(__ushort_as_half(bits), __ushort_as_half(bits));
  }
  static constexpr unsigned short INF = 0x7C00;  // +inf; | 0x8000 for -inf
};

template <> struct H2<DT_BF16> {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T from_pair(uint32_t e0, uint32_t e1, int dt) {
    if (dt == DT_BF16) {
      return __halves2bfloat162(__ushort_as_bfloat16(static_cast<unsigned short>(e0)),
                                __ushort_as_bfloat16(static_cast<unsigned short>(e1)));
    }
    return __float22bfloat162_rn(widen_pair(e0, e1, dt));  // fp8 exact; fp32, fp16 rounded once
  }
  static __device__ __forceinline__ T splat(unsigned short bits) {
    return __halves2bfloat162(__ushort_as_bfloat16(bits), __ushort_as_bfloat16(bits));
  }
  static constexpr unsigned short INF = 0x7F80;
};

template <int OP, typename T>
__device__ __forceinline__ T op_h2(T a, T b) {
  if constexpr (OP == OP_MUL) return __hmul2(a, b);
  else if constexpr (OP == OP_ADD) return __hadd2(a, b);
  else if constexpr (OP == OP_MIN) return __hmin2_nan(a, b);
  else return __hmax2_nan(a, b);
}

// {v.lo, v.lo} and {v.hi, v.hi}.
__device__ __forceinline__ __half2 dup_lo(__half2 v) { return __low2half2(v); }
__device__ __forceinline__ __half2 dup_hi(__half2 v) { return __high2half2(v); }
__device__ __forceinline__ __nv_bfloat162 dup_lo(__nv_bfloat162 v) { return __low2bfloat162(v); }
__device__ __forceinline__ __nv_bfloat162 dup_hi(__nv_bfloat162 v) { return __high2bfloat162(v); }

template <typename T>
__device__ __forceinline__ T bits_as(uint32_t u) {
  T t;
  memcpy(&t, &u, sizeof(T));
  return t;
}

template <typename T>
__device__ __forceinline__ uint32_t as_bits(T t) {
  uint32_t u;
  memcpy(&u, &t, sizeof(T));
  return u;
}

// Start the loads of one operand tile (R rows x BK of K from (r0, k0)) into
// a raw stage, laid out with the operand's fast axis fastest.
template <int R>
__device__ __forceinline__ void stage(uint8_t* raw, const Operand& o, long long boff, int r0,
                                      int k0) {
  const uint8_t* base = o.p + boff * o.es;
  if (o.vec) {
    const int ce_log = o.es == 4 ? 2 : o.es == 2 ? 3 : 4;  // log2 of the elements a request
    const int ce = 1 << ce_log;
    const int line_log = (o.kfast ? BK_LOG : R_LOG<R>) - ce_log;  // log2 of requests a line
    for (int c = threadIdx.x; c < (R * BK) >> ce_log; c += THREADS) {
      const int line = c >> line_log, at = (c & ((1 << line_log) - 1)) << ce_log;
      int r, kk, valid;
      if (o.kfast) {
        r = line;
        kk = at;
        valid = r0 + r < o.rows ? min(max(o.k - (k0 + kk), 0), ce) : 0;
      } else {
        kk = line;
        r = at;
        valid = k0 + kk < o.k ? min(max(o.rows - (r0 + r), 0), ce) : 0;
      }
      const uint8_t* src =
          valid > 0 ? base + ((long long)(r0 + r) * o.sr + (long long)(k0 + kk) * o.sk) * o.es
                    : base;
      cp_async16(raw + (o.kfast ? r * BK + kk : kk * R + r) * o.es, src, valid * o.es);
    }
  } else {
    for (int e = threadIdx.x; e < R * BK; e += THREADS) {
      const int r = o.kfast ? e / BK : e % R;
      const int kk = o.kfast ? e % BK : e / R;
      uint32_t v = 0;
      if (r0 + r < o.rows && k0 + kk < o.k) {
        v = load_bits(base, (long long)(r0 + r) * o.sr + (long long)(k0 + kk) * o.sk, o.es);
      }
      store_bits(raw, o.kfast ? r * BK + kk : kk * R + r, o.es, v);
    }
  }
}

// Convert a raw stage into the compute tile, one pair of rows at a time:
// consecutive threads take consecutive elements of the raw tile's fast
// axis, so its loads do not conflict. F32: tile[kk][r] = float. H2 and X:
// tile[kk][r] = {x, x}; H2 and W: tile[kk][r / 2] = {w(r), w(r + 1)}.
// ES (bytes an element) and KFAST (the raw layout) are compile-time here.
template <int FORM, int CT, int R, bool IS_X, int ES, bool KFAST>
__device__ __forceinline__ void convert_as(const uint8_t* raw, int dt, uint32_t* tile) {
  constexpr int PITCH = (FORM == FORM_H2 && !IS_X ? R / 2 : R) + PAD;
  for (int u = threadIdx.x; u < R / 2 * BK; u += THREADS) {
    const int kk = KFAST ? u % BK : u / (R / 2);
    const int r = 2 * (KFAST ? u / BK : u % (R / 2));
    uint32_t e0, e1;
    if constexpr (KFAST) {  // rows r and r + 1 are BK elements apart
      e0 = load_bits(raw, r * BK + kk, ES);
      e1 = load_bits(raw, (r + 1) * BK + kk, ES);
    } else if constexpr (ES == 4) {  // adjacent: one load of the pair
      const uint2 v = *reinterpret_cast<const uint2*>(raw + (kk * R + r) * 4);
      e0 = v.x;
      e1 = v.y;
    } else {
      const uint32_t v = ES == 2 ? *reinterpret_cast<const uint32_t*>(raw + (kk * R + r) * 2)
                                 : *reinterpret_cast<const uint16_t*>(raw + kk * R + r);
      e0 = v & (ES == 2 ? 0xFFFFu : 0xFFu);
      e1 = v >> (8 * ES);
    }
    if constexpr (FORM == FORM_F32) {
      const float2 f = ES == 4 ? make_float2(__uint_as_float(e0), __uint_as_float(e1))
                               : widen_pair(e0, e1, dt);
      *reinterpret_cast<uint2*>(&tile[kk * PITCH + r]) =
          make_uint2(__float_as_uint(round_to(f.x, CT)), __float_as_uint(round_to(f.y, CT)));
    } else {
      using T = typename H2<CT>::T;
      const T v = H2<CT>::from_pair(e0, e1, dt);
      if constexpr (IS_X) {
        *reinterpret_cast<uint2*>(&tile[kk * PITCH + r]) =
            make_uint2(as_bits(dup_lo(v)), as_bits(dup_hi(v)));
      } else {
        tile[kk * PITCH + r / 2] = as_bits(v);
      }
    }
  }
}

template <int FORM, int CT, int R, bool IS_X>
__device__ __forceinline__ void convert(const uint8_t* raw, const Operand& o, uint32_t* tile) {
  switch (o.es * 2 + o.kfast) {  // uniform across the block
    case 2: convert_as<FORM, CT, R, IS_X, 1, false>(raw, o.dt, tile); break;
    case 3: convert_as<FORM, CT, R, IS_X, 1, true>(raw, o.dt, tile); break;
    case 4: convert_as<FORM, CT, R, IS_X, 2, false>(raw, o.dt, tile); break;
    case 5: convert_as<FORM, CT, R, IS_X, 2, true>(raw, o.dt, tile); break;
    case 8: convert_as<FORM, CT, R, IS_X, 4, false>(raw, o.dt, tile); break;
    default: convert_as<FORM, CT, R, IS_X, 4, true>(raw, o.dt, tile);
  }
}

// Thread (ty, tx) of a tiled block owns rows ty*4 + {0..3} and 32 + ty*4 +
// {0..3}; in the f32 form columns tx*4 + {0..3} and 64 + tx*4 + {0..3}, in
// the h2 form the packed pairs of columns tx*8 + {0..7}. Each group of 4
// is one 16-byte shared-memory load that the warp's threads read without
// conflicts.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i < 4 ? 0 : 28) + ty * 4 + i; }
__device__ __forceinline__ int f32_col(int tx, int j) { return (j < 4 ? 0 : 60) + tx * 4 + j; }

// Fold Y with star and store through the output cast unit, or write the
// fp32 partial of this K split.
template <int STAR>
__device__ __forceinline__ void finish(const GemmArgs& a, int bz, int b1, int b2, int split_idx,
                                       int m, int n, float v) {
  if (a.split > 1) {
    a.ws[(((long long)bz * a.split + split_idx) * a.m + m) * a.n + n] = v;
    return;
  }
  if (a.y != nullptr) {
    v = op_f32<STAR>(load_as_float(a.y, b1 * a.sy1 + b2 * a.sy2 + m * a.sym + n * a.syn, a.y_dt),
                     v);
  }
  store_from_float(a.z, ((long long)bz * a.m + m) * a.n + n, a.z_dt, v);
}

template <int FORM, int CIRC, int STAR, int CT>
__global__ void __launch_bounds__(THREADS, 4) tile_kernel(const GemmArgs a) {
  constexpr bool GEMM = CIRC == OP_MUL && STAR == OP_ADD;
  constexpr int XP = BM + PAD;                                  // X tile pitch (words)
  constexpr int WP = (FORM == FORM_H2 ? BN / 2 : BN) + PAD;     // W tile pitch (words)
  __shared__ __align__(16) uint8_t raw_x[2][BM * BK * 4];
  __shared__ __align__(16) uint8_t raw_w[2][BN * BK * 4];
  __shared__ __align__(16) uint32_t xs[BK * XP];
  __shared__ __align__(16) uint32_t ws[BK * WP];

  const int n_tiles = (a.n + BN - 1) / BN;
  const int split_idx = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN, m0 = blockIdx.y * BM;
  const int bz = blockIdx.z, b1 = bz / a.b2, b2 = bz % a.b2;
  const long long xoff = b1 * a.x.s1 + b2 * a.x.s2, woff = b1 * a.w.s1 + b2 * a.w.s2;
  const int k_lo = split_idx * a.k_per_split, k_hi = min(a.k, k_lo + a.k_per_split);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  using T = typename std::conditional<FORM == FORM_H2, typename H2<CT == DT_F32 ? DT_F16 : CT>::T,
                                      float>::type;
  constexpr int NJ = FORM == FORM_H2 ? 4 : 8;  // accumulator columns (packed pairs in h2)
  T acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (FORM == FORM_H2) {
        using P = H2<CT == DT_F32 ? DT_F16 : CT>;
        constexpr unsigned short inf = P::INF | (STAR == OP_MIN ? 0 : 0x8000);  // the identity
        acc[i][j] = P::splat(inf);
      } else {
        acc[i][j] = identity_f32<STAR>();
      }
    }
  }

  auto load_stage = [&](int t) {
    const int k0 = k_lo + t * BK;
    stage<BM>(raw_x[t & 1], a.x, xoff, m0, k0);
    stage<BN>(raw_w[t & 1], a.w, woff, n0, k0);
  };
  auto step = [&](int kk) {
    const uint4 xa = *reinterpret_cast<const uint4*>(&xs[kk * XP + ty * 4]);
    const uint4 xb = *reinterpret_cast<const uint4*>(&xs[kk * XP + 32 + ty * 4]);
    const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    if constexpr (FORM == FORM_H2) {
      const uint4 wv = *reinterpret_cast<const uint4*>(&ws[kk * WP + tx * 4]);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = op_h2<STAR>(acc[i][j], op_h2<CIRC>(bits_as<T>(xw[i]), bits_as<T>(ww[j])));
        }
      }
    } else {
      const uint4 wa = *reinterpret_cast<const uint4*>(&ws[kk * WP + tx * 4]);
      const uint4 wb = *reinterpret_cast<const uint4*>(&ws[kk * WP + 64 + tx * 4]);
      const uint32_t ww[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = __uint_as_float(xw[i]), wv = __uint_as_float(ww[j]);
          if constexpr (GEMM) {
            acc[i][j] = fmaf(xv, wv, acc[i][j]);
          } else {
            acc[i][j] = op_f32<STAR>(acc[i][j], op_f32<CIRC>(xv, wv));
          }
        }
      }
    }
  };

  if (steps > 0) load_stage(0);
  cp_async_commit();
  if (steps > 1) load_stage(1);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<1>();  // stage t has landed (t + 1 may be in flight)
    __syncthreads();     // ... for every thread; the previous step is done with the tile
    convert<FORM, CT, BM, true>(raw_x[t & 1], a.x, xs);
    convert<FORM, CT, BN, false>(raw_w[t & 1], a.w, ws);
    __syncthreads();  // the tile is ready and raw stage t & 1 is free
    if (t + 2 < steps) load_stage(t + 2);
    cp_async_commit();
    const int kmax = min(BK, k_hi - (k_lo + t * BK));  // lanes past the split never reach star
    if (kmax == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < kmax; ++kk) step(kk);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= a.m) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (FORM == FORM_H2) {
        const float2 v = make_float2(__low2float(acc[i][j]), __high2float(acc[i][j]));
        const int n = n0 + tx * 8 + 2 * j;
        if (n < a.n) finish<STAR>(a, bz, b1, b2, split_idx, m, n, v.x);
        if (n + 1 < a.n) finish<STAR>(a, bz, b1, b2, split_idx, m, n + 1, v.y);
      } else {
        const int n = n0 + f32_col(tx, j);
        if (n < a.n) finish<STAR>(a, bz, b1, b2, split_idx, m, n, acc[i][j]);
      }
    }
  }
}

template <int FORM, int CIRC, int STAR, int CT>
cudaError_t launch_tile(const GemmArgs& a, dim3 grid, cudaStream_t st) {
  tile_kernel<FORM, CIRC, STAR, CT><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// The h2 form's launch for one (circ, star) pair and 16-bit compute format
// (redmule_gemm_h2.cu).
cudaError_t launch_h2(int circ, int star, int compute_dt, const GemmArgs& a, dim3 grid,
                      cudaStream_t st);

}  // namespace redmule_simt
