// The GEMM-Op kernel's tensor-core schedule for (mul, add): Z = Y + X.W on
// Hopper's wgmma, fed by TMA. The schedule, its bounds and its numerics are
// described in the source note of redmule_gemm.cu; this file holds the
// kernel and its launcher.
//
// One block computes a 128 x 128 output tile with three warpgroups:
//  - warpgroup 2 is the producer: one thread keeps TMA loads of the X and
//    W tiles (128 rows x 128 bytes of K each) in flight into a ring of
//    shared-memory stages, each guarded by a "full" and an "empty" mbarrier;
//  - warpgroups 0 and 1 are consumers: each runs wgmma.mma_async on its 64
//    rows of the tile against all 128 columns (m64n128k16, fp16 or bf16
//    operands, fp32 accumulators), waits for a stage's instructions and
//    adds their sum into a separate fp32 register accumulator (promotion
//    every 128 of K for fp8 operands, every 64 for 16-bit ones).
// fp16/bf16 operands go from the TMA tile (128-byte swizzle) straight to
// wgmma. fp8 operands (which the wrapper hands over when Z is one tile high
// or wide; above that it widens them once with the K-major copy) are
// widened to fp16 in shared memory first, exactly (every E4M3 and E5M2
// value is an fp16 value): the consumers convert each TMA stage into one of
// two fp16 tiles in wgmma's K-major 128-byte-swizzled layout while the
// tensor cores work on the other. fp8 wgmma would take the
// bytes as they are at twice the rate, but it keeps only about 14 bits of
// the running sum, even within one k32 instruction: measured on the H100
// it moved a fifth of the fp16 outputs of a 64 x 4096 x 12800 GEMM off the
// fp32 sum by 1 ulp or more, and the error grew through E4M3/E5M2
// requantisation into 9% of the logits and whole gradients over two
// layers. fp16 wgmma on the same values gives the plain version's bits.
// Both operands are K-major (the wrapper copies an operand first where its
// strides are not). TMA fills the ragged M, N and K edges and the rows
// past each batch's M with zeros, the identity of (mul, add).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK_BYTES = 128;
constexpr int THREADS = 384;  // two consumer warpgroups, one producer
constexpr int GROUP_M = 16;   // row tiles of Z a group of blocks walks together
constexpr int A_BYTES = BM * BK_BYTES, B_BYTES = BN * BK_BYTES;  // one TMA stage
// 16-bit operands: four TMA stages. fp8 operands: three TMA stages and two
// fp16 tiles (A and B, 128 x 128 elements each: 64 KB) for the tensor cores.
constexpr int STAGES_16 = 4, STAGES_8 = 3;
constexpr int F16_TILE = 2 * (A_BYTES + B_BYTES);
constexpr int smem_bytes(bool fp8) {
  return fp8 ? STAGES_8 * (A_BYTES + B_BYTES) + 2 * F16_TILE + 2 * STAGES_8 * 8 + 1024
             : STAGES_16 * (A_BYTES + B_BYTES) + 2 * STAGES_16 * 8 + 1024;
}

// Operand kinds of the tensor-core schedules (repro_torch.kernels.redmule_gemm.MMA_KIND).
enum Kind { K_E4M3 = 0, K_E5M2 = 1, K_F16 = 2, K_BF16 = 3 };

using namespace hopper;

struct TcArgs {
  const void* y;  // null: Z = X.W
  void* z;        // contiguous (b1, b2, m, n)
  int y_dt, z_dt;
  int b2, m, n, k;
  int x_b1, x_b2, w_b1, w_b2;  // 1: the operand's map walks this batch level; 0: broadcast
  long long sy1, sy2, sym, syn;
};

// One output element: kept out of line, so that the 64 stores of the
// epilogue do not each inline both format switches.
__device__ __noinline__ void store_out(float v, const void* y, long long yi, int y_dt, void* z,
                                       long long zi, int z_dt) {
  if (y != nullptr) v += load_as_float(y, yi, y_dt);
  store_from_float(z, zi, z_dt, v);
}

// 16 fp8 values of one kind as 16 fp16 values (exact), two 16-byte chunks.
template <int KIND>
__device__ __forceinline__ void fp8x16_to_f16(uint4 v, uint4& lo, uint4& hi) {
  constexpr __nv_fp8_interpretation_t kind = KIND == K_E4M3 ? __NV_E4M3 : __NV_E5M2;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2_raw a = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] & 0xFFFF), kind);
    __half2_raw b = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] >> 16), kind);
    h[2 * i] = (uint32_t)a.x | ((uint32_t)a.y << 16);
    h[2 * i + 1] = (uint32_t)b.x | ((uint32_t)b.y << 16);
  }
  lo = make_uint4(h[0], h[1], h[2], h[3]);
  hi = make_uint4(h[4], h[5], h[6], h[7]);
}

// Widen one TMA stage (A then B, 128 rows x 128 fp8 each, row-major) into
// an fp16 tile: per operand two K halves of 128 rows x 64 fp16 (128 bytes),
// each in wgmma's 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)).
// The 256 consumer threads take 8 of the 2048 16-byte chunks each.
template <int AK, int BK>
__device__ __forceinline__ void widen_stage(uint32_t stage, uint32_t f16_tile, int ctid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int op = i / 4, e = ctid + 256 * (i % 4);  // op 0: X's tile, 1: W's
    const int r = e / 8, j = e % 8;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stage + op * A_BYTES + r * BK_BYTES + 16 * j));
    uint4 lo, hi;
    if (op == 0) {
      fp8x16_to_f16<AK>(v, lo, hi);
    } else {
      fp8x16_to_f16<BK>(v, lo, hi);
    }
    const uint32_t half = f16_tile + op * 2 * A_BYTES + (j / 4) * A_BYTES + r * BK_BYTES;
    const int c0 = 2 * (j % 4);
    const uint32_t d0 = half + (((c0) ^ (r % 8)) << 4), d1 = half + (((c0 + 1) ^ (r % 8)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(d0), "r"(lo.x), "r"(lo.y), "r"(lo.z), "r"(lo.w) : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(d1), "r"(hi.x), "r"(hi.y), "r"(hi.z), "r"(hi.w) : "memory");
  }
  // Make the generic-proxy stores visible to wgmma's async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void promote(float (&acc)[64], float (&d)[64]) {
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += d[i];  // the fp32 promotion
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
}

// Eight k16 steps over one 128 x 128 tile pair held as two K halves each
// (the fp16 tile of an fp8 stage), or four over one 128-byte TMA stage.
template <int WK>
__device__ __forceinline__ void mma_tile(float (&d)[64], uint32_t a_tile, uint32_t b_tile,
                                         uint32_t half_bytes, int steps) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < steps) {
      const uint32_t off = (kk / 4) * half_bytes + 32 * (kk % 4);
      wgmma_ss_n128<WK == K_BF16>(d, make_desc(a_tile + off), make_desc(b_tile + off), kk > 0);
    }
  }
}

template <int AK, int BK>
__global__ void __launch_bounds__(THREADS, 1)
redmule_gemm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const TcArgs a) {
  constexpr bool FP8 = AK == K_E4M3 || AK == K_E5M2;
  constexpr int STAGES = FP8 ? STAGES_8 : STAGES_16;
  constexpr int ELEM = FP8 ? 1 : 2;
  constexpr int BK_ELEMS = BK_BYTES / ELEM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte tiles
  const uint32_t stages = base;
  const uint32_t f16_tiles = base + STAGES * (A_BYTES + B_BYTES);
  const uint32_t full_bar = f16_tiles + (FP8 ? 2 * F16_TILE : 0);
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int tid = threadIdx.x, wg = tid / 128;
  const int bz = blockIdx.z, b1 = bz / a.b2, b2 = bz % a.b2;
  // Tiles in groups of GROUP_M row tiles, rows fastest: the blocks in
  // flight at once cover a compact patch of Z, so the X and W tiles they
  // share stay in L2 instead of crossing device memory once per row tile.
  const int tiles_m = (a.m + BM - 1) / BM, tiles_n = (a.n + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n, group = blockIdx.x / per_group;
  const int first_m = group * GROUP_M, rows_in_group = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_in_group) * BM, n0 = (in_group / rows_in_group) * BN;
  const int nk = (a.k + BK_ELEMS - 1) / BK_ELEMS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t st = stages + s * (A_BYTES + B_BYTES);
        mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, A_BYTES + B_BYTES);
        tma_load_4d(st, &xmap, full_bar + 8 * s, kt * BK_ELEMS, m0, b2 * a.x_b2, b1 * a.x_b1);
        tma_load_4d(st + A_BYTES, &wmap, full_bar + 8 * s, kt * BK_ELEMS, n0, b2 * a.w_b2,
                    b1 * a.w_b1);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  constexpr int WK = FP8 ? K_F16 : AK;  // the wgmma operand type
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  if constexpr (FP8) {
    // Widen stage kt + 1 while the tensor cores run on stage kt's fp16 tile.
    if (nk > 0) {
      mbar_wait(full_bar, 0);
      widen_stage<AK, BK>(stages, f16_tiles, tid);
      mbar_arrive(empty_bar);
      consumer_sync();
    }
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t tile = f16_tiles + (kt & 1) * F16_TILE;
      fence_operands(d);
      wgmma_fence();
      mma_tile<WK>(d, tile + wg * 64 * BK_BYTES, tile + 2 * A_BYTES, A_BYTES, 8);
      wgmma_commit();
      if (kt + 1 < nk) {
        const int s = (kt + 1) % STAGES;
        mbar_wait(full_bar + 8 * s, ((kt + 1) / STAGES) & 1);
        widen_stage<AK, BK>(stages + s * (A_BYTES + B_BYTES), f16_tiles + ((kt + 1) & 1) * F16_TILE,
                            tid);
        mbar_arrive(empty_bar + 8 * s);
      }
      wgmma_wait_all();
      promote(acc, d);
      consumer_sync();  // tile kt + 1 is written and tile kt is free
    }
  } else {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      const uint32_t st = stages + s * (A_BYTES + B_BYTES);
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      fence_operands(d);
      wgmma_fence();
      mma_tile<WK>(d, st + wg * 64 * BK_BYTES, st + A_BYTES, 0, 4);
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty_bar + 8 * s);
      promote(acc, d);
    }
  }
  // Epilogue: Y added in fp32, one rounding at the output cast unit.
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  if (a.y == nullptr && a.z_dt == DT_F16 && a.n % 2 == 0) {
    // The common case, fp16 out without Y: pairs of columns as one store.
    __half* z = static_cast<__half*>(a.z) + (long long)bz * a.m * a.n;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = row + 8 * ((i / 2) % 2);
      const int n = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (m < a.m && n < a.n) {
        *reinterpret_cast<__half2*>(z + (long long)m * a.n + n) =
            __floats2half2_rn(acc[i], acc[i + 1]);
      }
    }
    return;
  }
  const long long yb = b1 * a.sy1 + b2 * a.sy2;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = row + 8 * ((i / 2) % 2);
    const int n = n0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    if (m < a.m && n < a.n) {
      store_out(acc[i], a.y, yb + m * a.sym + n * a.syn, a.y_dt, a.z,
                ((long long)bz * a.m + m) * a.n + n, a.z_dt);
    }
  }
}

// A 4D map {K, rows, b2, b1} of a K-major operand, box 128 bytes x 128
// rows: swizzled for wgmma for 16-bit operands, plain rows for fp8 ones
// (which the consumers widen). A batch level the operand broadcasts over (stride 0) becomes a
// dimension of size 1 (coordinate 0). Strides are in elements.
int encode_operand(CUtensorMap* map, int kind, const void* ptr, int k, int rows, int b1, int b2,
                   long long s_row, long long s2, long long s1, int* walk_b1, int* walk_b2) {
  const int es = (kind == K_F16 || kind == K_BF16) ? 2 : 1;
  const long long row_bytes = ((long long)k * es + 15) / 16 * 16;
  const long long sr = rows > 1 ? s_row * es : row_bytes;
  *walk_b2 = (b2 > 1 && s2 != 0);
  *walk_b1 = (b1 > 1 && s1 != 0);
  const long long st2 = *walk_b2 ? s2 * es : sr * rows;
  const long long st1 = *walk_b1 ? s1 * es : st2 * (*walk_b2 ? b2 : 1);
  if (sr % 16 || st2 % 16 || st1 % 16 || reinterpret_cast<uintptr_t>(ptr) % 16) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)rows,
                              (cuuint64_t)(*walk_b2 ? b2 : 1), (cuuint64_t)(*walk_b1 ? b1 : 1)};
  const cuuint64_t strides[3] = {(cuuint64_t)sr, (cuuint64_t)st2, (cuuint64_t)st1};
  const cuuint32_t box[4] = {(cuuint32_t)(BK_BYTES / es), 128, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -2;
  CUresult r = fn(map, es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  es == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int AK, int BK>
cudaError_t launch_tc(const CUtensorMap& xm, const CUtensorMap& wm, const TcArgs& a, dim3 grid,
                      cudaStream_t st) {
  constexpr int bytes = smem_bytes(AK == K_E4M3 || AK == K_E5M2);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(redmule_gemm_tc_kernel<AK, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  redmule_gemm_tc_kernel<AK, BK><<<grid, THREADS, bytes, st>>>(xm, wm, a);
  return cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t, -1 for an operand that is not a K-major
// 16-byte-aligned view, -2 without cuTensorMapEncodeTiled, or 1000 + the
// CUresult of a refused tensor map. x: (b1, b2, m, k) with unit K stride;
// w: (b1, b2, n, k) with unit K stride (the K x N operand, K-major); every
// stride is in elements, 0 for a broadcast batch level.
extern "C" int redmule_gemm_tc_launch(
    int x_kind, int w_kind, const void* x, const void* w, const void* y, int y_dt,
    void* z, int z_dt, int b1, int b2, int m, int n, int k,
    long long sx1, long long sx2, long long sxm,
    long long sw1, long long sw2, long long swn,
    long long sy1, long long sy2, long long sym, long long syn, void* stream) {
  CUtensorMap xm, wm;
  TcArgs a{y, z, y_dt, z_dt, b2, m, n, k, 0, 0, 0, 0, sy1, sy2, sym, syn};
  int r = encode_operand(&xm, x_kind, x, k, m, b1, b2, sxm, sx2, sx1, &a.x_b1, &a.x_b2);
  if (r != 0) return r;
  r = encode_operand(&wm, w_kind, w, k, n, b1, b2, swn, sw2, sw1, &a.w_b1, &a.w_b2);
  if (r != 0) return r;
  const dim3 grid(((n + BN - 1) / BN) * ((m + BM - 1) / BM), 1, b1 * b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_kind * 4 + w_kind) {
    case K_E4M3 * 4 + K_E4M3: return launch_tc<K_E4M3, K_E4M3>(xm, wm, a, grid, st);
    case K_E4M3 * 4 + K_E5M2: return launch_tc<K_E4M3, K_E5M2>(xm, wm, a, grid, st);
    case K_E5M2 * 4 + K_E4M3: return launch_tc<K_E5M2, K_E4M3>(xm, wm, a, grid, st);
    case K_E5M2 * 4 + K_E5M2: return launch_tc<K_E5M2, K_E5M2>(xm, wm, a, grid, st);
    case K_F16 * 4 + K_F16: return launch_tc<K_F16, K_F16>(xm, wm, a, grid, st);
    case K_BF16 * 4 + K_BF16: return launch_tc<K_BF16, K_BF16>(xm, wm, a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}
