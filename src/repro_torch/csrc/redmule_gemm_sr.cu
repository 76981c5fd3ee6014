// The GEMM-Op kernel's small-row schedule for (mul, add) on fp8 operands,
// its split-K combine, and the K-major copy that the tensor-core and
// small-row schedules use for operands whose strides are not K-major. The
// schedule, its bound and its numerics are described in the source note of
// redmule_gemm.cu; this file holds the kernels and their launchers.
//
// Small rows (M <= 16, the decode step): every weight byte is streamed
// once. W is the A operand of mma.sync.m16n8k32 (16 weight rows n, 32 of
// K) and X the B operand (8 rows of X a tile, one or two tiles), so the
// 4-row decode fills half of the 8-wide side instead of 4 of 64 rows. Each
// warp owns 16 rows of W and walks its block's K range 64 bytes at a time:
// a thread loads 16 contiguous bytes of each of its two weight rows (one
// 16-byte load per row, four lanes covering 64 bytes of a row), and the
// fragment's K order is permuted to match those bytes on both operands,
// which the sum does not see. X's rows are staged in shared memory per
// chunk of K. Every mma starts from zero and its four outputs are added to
// fp32 registers (promotion every 32 of K). K is split across blocks so
// that every shape fills the card; each split writes fp32 partials to a
// workspace and a second kernel sums them in split order, so a run always
// gives the same bits.
#include "common.cuh"

namespace {

constexpr int SR_THREADS = 128;  // four warps, 16 weight rows each
constexpr int SR_BLOCK_N = 64;
constexpr int SR_MAX_M = 16;      // rows: one or two eight-row halves
constexpr int SR_STEP = 64;       // K bytes a warp covers per step
constexpr int SR_UNROLL = 4;      // steps whose loads are in flight together
constexpr int SR_CHUNK = 2048;    // K bytes of X staged in shared memory at once
constexpr int SR_XS = SR_CHUNK + 16;  // padded row of the staged X
constexpr int COPY_THREADS = 256;  // K-major copy: a 64 x 64 tile a block

enum Kind { K_E4M3 = 0, K_E5M2 = 1 };

template <int WK, int XK>
__device__ __forceinline__ void mma_fp8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
#define SR_MMA(TYPES)                                                                     \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.f32." TYPES ".f32 "                     \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"   \
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])                           \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(z))
  if constexpr (WK == K_E4M3 && XK == K_E4M3) {
    SR_MMA("e4m3.e4m3");
  } else if constexpr (WK == K_E4M3 && XK == K_E5M2) {
    SR_MMA("e4m3.e5m2");
  } else if constexpr (WK == K_E5M2 && XK == K_E4M3) {
    SR_MMA("e5m2.e4m3");
  } else {
    SR_MMA("e5m2.e5m2");
  }
#undef SR_MMA
}

struct SrArgs {
  const uint8_t* x;
  const uint8_t* w;   // K-major: row n of K bytes at n * swn, 16-byte aligned
  const void* y;
  void* z;            // contiguous (b1, b2, m, n), written when split == 1
  float* ws;          // (b1 * b2, split, m, n) fp32 partials when split > 1
  int y_dt, z_dt;
  int b2, m, n, k, split, k_per_split;
  int x_vec;          // X rows are K-contiguous and 16-byte aligned
  long long sx1, sx2, sxm, sxk;
  long long sw1, sw2, swn;
  long long sy1, sy2, sym, syn;
};

__device__ __forceinline__ uint4 load_row16(const uint8_t* row, int k, int k_end, bool live) {
  if (!live || k >= k_end) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(row + k));
}

template <int WK, int XK, int NT>
__global__ void __launch_bounds__(SR_THREADS) redmule_gemm_sr_kernel(const SrArgs a) {
  __shared__ __align__(16) uint8_t xs[NT * 8 * SR_XS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bz = blockIdx.z, b1 = bz / a.b2, b2 = bz % a.b2;
  const int split = blockIdx.y;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.k, k_begin + a.k_per_split);
  const int n0 = blockIdx.x * SR_BLOCK_N + warp * 16;
  const uint8_t* w = a.w + b1 * a.sw1 + b2 * a.sw2;
  const uint8_t* row0 = w + (long long)(n0 + g) * a.swn;
  const uint8_t* row1 = w + (long long)(n0 + g + 8) * a.swn;
  const bool live0 = n0 + g < a.n, live1 = n0 + g + 8 < a.n;
  const uint8_t* x = a.x + b1 * a.sx1 + b2 * a.sx2;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kc0 = k_begin; kc0 < k_end; kc0 += SR_CHUNK) {
    const int kc1 = min(kc0 + SR_CHUNK, k_end);
    const int width = (kc1 - kc0 + SR_STEP - 1) / SR_STEP * SR_STEP;
    __syncthreads();  // the previous chunk's readers are done
    // Stage X rows [0, 8 NT) x [kc0, kc0 + width), zeros past M and K.
    if (a.x_vec) {
      const int per_row = width / 16;
      for (int e = threadIdx.x; e < NT * 8 * per_row; e += SR_THREADS) {
        const int r = e / per_row, c = (e % per_row) * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < a.m && kc0 + c < a.k) {
          v = __ldg(reinterpret_cast<const uint4*>(x + r * a.sxm + kc0 + c));
        }
        *reinterpret_cast<uint4*>(xs + r * SR_XS + c) = v;
      }
    } else {
      for (int e = threadIdx.x; e < NT * 8 * width; e += SR_THREADS) {
        const int r = e / width, c = e % width;
        uint8_t v = 0;
        if (r < a.m && kc0 + c < a.k) v = x[r * a.sxm + (long long)(kc0 + c) * a.sxk];
        xs[r * SR_XS + c] = v;
      }
    }
    __syncthreads();
    for (int kk = kc0; kk < kc1; kk += SR_STEP * SR_UNROLL) {
      uint4 wa[SR_UNROLL], wb[SR_UNROLL];
#pragma unroll
      for (int u = 0; u < SR_UNROLL; ++u) {
        const int k = kk + u * SR_STEP + 16 * t;
        const bool step_live = kk + u * SR_STEP < kc1;
        wa[u] = load_row16(row0, k, a.k, live0 && step_live);
        wb[u] = load_row16(row1, k, a.k, live1 && step_live);
      }
#pragma unroll
      for (int u = 0; u < SR_UNROLL; ++u) {
        if (kk + u * SR_STEP >= kc1) break;  // uniform across the warp
        const int c = kk + u * SR_STEP - kc0 + 16 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + (j * 8 + g) * SR_XS + c);
          float d[4];
          mma_fp8<WK, XK>(d, wa[u].x, wb[u].x, wa[u].y, wb[u].y, xv.x, xv.y);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += d[i];
          mma_fp8<WK, XK>(d, wa[u].z, wb[u].z, wa[u].w, wb[u].w, xv.z, xv.w);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += d[i];
        }
      }
    }
  }

  // acc[j][i]: weight row n0 + g + 8 (i / 2), X row 8 j + 2 t + i % 2.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 8 * j + 2 * t + (i % 2), n = n0 + g + 8 * (i / 2);
      if (m >= a.m || n >= a.n) continue;
      if (a.split > 1) {
        a.ws[(((long long)bz * a.split + split) * a.m + m) * a.n + n] = acc[j][i];
      } else {
        float v = acc[j][i];
        if (a.y != nullptr) {
          v += load_as_float(a.y, b1 * a.sy1 + b2 * a.sy2 + m * a.sym + n * a.syn, a.y_dt);
        }
        store_from_float(a.z, ((long long)bz * a.m + m) * a.n + n, a.z_dt, v);
      }
    }
  }
}

// Z = star(Y, star of the split partials), folded in split order: the sum
// of the small-row and SIMT (mul, add) splits, min or max of the SIMT
// semiring splits (NaN propagating, -0 below +0; any order gives their bits).
__global__ void splitk_combine_kernel(const float* ws, const void* y, int y_dt, void* z, int z_dt,
                                      int star, int b2, int m, int n, int split, long long total,
                                      long long sy1, long long sy2, long long sym, long long syn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long mn = (long long)m * n;
  const long long bz = i / mn, r = i % mn;
  const float* p = ws + bz * split * mn + r;
  float v = p[0];
  for (int s = 1; s < split; ++s) v = op_f32(star, v, p[s * mn]);
  if (y != nullptr) {
    const int mm = (int)(r / n), nn = (int)(r % n);
    const int b1 = (int)(bz / b2), bb2 = (int)(bz % b2);
    v = op_f32(star, load_as_float(y, b1 * sy1 + bb2 * sy2 + mm * sym + nn * syn, y_dt), v);
  }
  store_from_float(z, i, z_dt, v);
}

// dst (b1, b2, rows, kp) contiguous = src (b1, b2, rows, k) through its
// strides, zeros in [k, kp). Bytes are copied as they are (fp8 exactly),
// or, with WIDEN (an fp8 kind), each fp8 byte becomes its fp16 value, which
// is exact too. A 64 x 64 tile goes through shared memory, read along the
// source's unit-stride axis and written along K, so both sides stay
// coalesced.
template <typename T, typename TO, int WIDEN>
__global__ void __launch_bounds__(COPY_THREADS)
kmajor_copy_kernel(const T* src, TO* dst, int b2, int rows, int k, int kp, long long s1,
                   long long s2, long long sr, long long sk) {
  __shared__ T tile[64][65];
  const int bz = blockIdx.z, b1 = bz / b2, bb2 = bz % b2;
  const int r0 = blockIdx.y * 64, k0 = blockIdx.x * 64;
  const T* s = src + b1 * s1 + bb2 * s2;
  const bool rows_fast = sr == 1 && sk != 1;
#pragma unroll
  for (int e = threadIdx.x; e < 64 * 64; e += COPY_THREADS) {
    const int rr = rows_fast ? e % 64 : e / 64, kk = rows_fast ? e / 64 : e % 64;
    const int r = r0 + rr, kx = k0 + kk;
    tile[rr][kk] = (r < rows && kx < k) ? s[r * sr + kx * sk] : T(0);
  }
  __syncthreads();
  TO* d = dst + (long long)bz * rows * kp;
#pragma unroll
  for (int e = threadIdx.x; e < 64 * 64; e += COPY_THREADS) {
    const int rr = e / 64, kk = e % 64;
    const int r = r0 + rr, kx = k0 + kk;
    if (r < rows && kx < kp) {
      if constexpr (WIDEN < 0) {
        d[(long long)r * kp + kx] = tile[rr][kk];
      } else {
        d[(long long)r * kp + kx] = __nv_cvt_fp8_to_halfraw(
            (__nv_fp8_storage_t)tile[rr][kk], WIDEN == K_E4M3 ? __NV_E4M3 : __NV_E5M2).x;
      }
    }
  }
}

// The widening copy of an operand that is K-major already, with rows of
// whole 16-byte groups: 16 fp8 values in, 16 fp16 values out, per thread.
template <int WIDEN>
__global__ void __launch_bounds__(COPY_THREADS)
kmajor_widen_rows_kernel(const uint8_t* src, uint16_t* dst, int b2, int rows, int k, int kp,
                         long long s1, long long s2, long long sr) {
  constexpr __nv_fp8_interpretation_t kind = WIDEN == K_E4M3 ? __NV_E4M3 : __NV_E5M2;
  const int chunks = k / 16;
  const long long e = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (e >= (long long)rows * chunks) return;
  const int bz = blockIdx.z, b1 = bz / b2, bb2 = bz % b2;
  const int r = (int)(e / chunks), c = (int)(e % chunks);
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + b1 * s1 + bb2 * s2 + r * sr + 16 * c));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw a = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] & 0xFFFF), kind);
    const __half2_raw b = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] >> 16), kind);
    h[2 * i] = (uint32_t)a.x | ((uint32_t)a.y << 16);
    h[2 * i + 1] = (uint32_t)b.x | ((uint32_t)b.y << 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst + ((long long)bz * rows + r) * kp + 16 * c);
  d[0] = make_uint4(h[0], h[1], h[2], h[3]);
  d[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

template <int WK, int XK>
cudaError_t launch_sr(const SrArgs& a, dim3 grid, cudaStream_t st) {
  if (a.m <= 8) {
    redmule_gemm_sr_kernel<WK, XK, 1><<<grid, SR_THREADS, 0, st>>>(a);
  } else {
    redmule_gemm_sr_kernel<WK, XK, 2><<<grid, SR_THREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Small-row schedule. x: (b1, b2, m, k) fp8, any strides; w: the K x N
// operand K-major, row n at n * swn; m <= 16. With split > 1, ws receives
// fp32 partials and redmule_splitk_combine_launch finishes Z.
extern "C" int redmule_gemm_sr_launch(
    int x_kind, int w_kind, const void* x, const void* w, const void* y, int y_dt,
    void* z, int z_dt, void* ws, int b1, int b2, int m, int n, int k, int split,
    int k_per_split, int x_vec,
    long long sx1, long long sx2, long long sxm, long long sxk,
    long long sw1, long long sw2, long long swn,
    long long sy1, long long sy2, long long sym, long long syn, void* stream) {
  if (m < 1 || m > SR_MAX_M || k_per_split % SR_STEP != 0 || swn % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  SrArgs a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), y, z,
           static_cast<float*>(ws), y_dt, z_dt, b2, m, n, k, split, k_per_split, x_vec,
           sx1, sx2, sxm, sxk, sw1, sw2, swn, sy1, sy2, sym, syn};
  const dim3 grid((n + SR_BLOCK_N - 1) / SR_BLOCK_N, split, b1 * b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_kind * 2 + x_kind) {
    case K_E4M3 * 2 + K_E4M3: return launch_sr<K_E4M3, K_E4M3>(a, grid, st);
    case K_E4M3 * 2 + K_E5M2: return launch_sr<K_E4M3, K_E5M2>(a, grid, st);
    case K_E5M2 * 2 + K_E4M3: return launch_sr<K_E5M2, K_E4M3>(a, grid, st);
    case K_E5M2 * 2 + K_E5M2: return launch_sr<K_E5M2, K_E5M2>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// star: the OpCode of the pair's star (OP_ADD for the (mul, add) splits).
extern "C" int redmule_splitk_combine_launch(
    const void* ws, const void* y, int y_dt, void* z, int z_dt, int star, int b1, int b2, int m,
    int n, int split, long long sy1, long long sy2, long long sym, long long syn, void* stream) {
  const long long total = (long long)b1 * b2 * m * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  splitk_combine_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), y, y_dt, z, z_dt, star, b2, m, n, split, total,
      sy1, sy2, sym, syn);
  return cudaGetLastError();
}

// widen: -1 copies the elements as they are; an fp8 kind (0 E4M3, 1 E5M2)
// writes each byte's fp16 value. kp counts output elements.
extern "C" int kmajor_copy_launch(const void* src, void* dst, int elem_bytes, int widen, int b1,
                                  int b2, int rows, int k, int kp, long long s1, long long s2,
                                  long long sr, long long sk, void* stream) {
  const dim3 grid((kp + 63) / 64, (rows + 63) / 64, b1 * b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s8 = static_cast<const uint8_t*>(src);
  const bool rows_aligned = sk == 1 && k % 16 == 0 && kp == k && (rows == 1 || sr % 16 == 0) &&
                            s1 % 16 == 0 && s2 % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (elem_bytes == 1 && widen >= 0 && rows_aligned) {
    const dim3 g((unsigned)(((long long)rows * (k / 16) + COPY_THREADS - 1) / COPY_THREADS), 1,
                 b1 * b2);
    if (widen == K_E4M3) {
      kmajor_widen_rows_kernel<K_E4M3><<<g, COPY_THREADS, 0, st>>>(
          s8, static_cast<uint16_t*>(dst), b2, rows, k, kp, s1, s2, sr);
    } else {
      kmajor_widen_rows_kernel<K_E5M2><<<g, COPY_THREADS, 0, st>>>(
          s8, static_cast<uint16_t*>(dst), b2, rows, k, kp, s1, s2, sr);
    }
  } else if (elem_bytes == 1 && widen == K_E4M3) {
    kmajor_copy_kernel<uint8_t, uint16_t, K_E4M3><<<grid, COPY_THREADS, 0, st>>>(
        s8, static_cast<uint16_t*>(dst), b2, rows, k, kp, s1, s2, sr, sk);
  } else if (elem_bytes == 1 && widen == K_E5M2) {
    kmajor_copy_kernel<uint8_t, uint16_t, K_E5M2><<<grid, COPY_THREADS, 0, st>>>(
        s8, static_cast<uint16_t*>(dst), b2, rows, k, kp, s1, s2, sr, sk);
  } else if (elem_bytes == 1 && widen < 0) {
    kmajor_copy_kernel<uint8_t, uint8_t, -1><<<grid, COPY_THREADS, 0, st>>>(
        s8, static_cast<uint8_t*>(dst), b2, rows, k, kp, s1, s2, sr, sk);
  } else if (elem_bytes == 2 && widen < 0) {
    kmajor_copy_kernel<uint16_t, uint16_t, -1><<<grid, COPY_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst), b2, rows, k, kp,
        s1, s2, sr, sk);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
