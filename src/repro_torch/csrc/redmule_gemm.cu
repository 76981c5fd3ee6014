// RedMulE GEMM-Op kernel for Hopper (sm_90a): Z = star(Y, star_k circ(X, W)).
//
// Replaces the TPU kernel repro/kernels/redmule_gemm.py::redmule_gemm_pallas
// (body _kernel): the same function for all seven Table-1 (circ, star)
// pairs. Three schedules compute it; the wrapper's planner
// (repro_torch.kernels.redmule_gemm.plan_gemm) picks one from the shapes,
// the formats and the strides alone, never as a retry:
//
//  - tensor cores (redmule_gemm_tc.cu), for (mul, add) with more than 16
//    rows: prefill, every training GEMM, the attention products. Bound by
//    operations once M reaches a few hundred rows, by the weight bytes
//    below that. A producer warp keeps TMA loads of X and W tiles in flight
//    through a ring of shared-memory stages; two consumer warpgroups run
//    wgmma.mma_async (m64n128k16, fp16 or bf16 operands) on a 128 x 128
//    output tile. fp8 operands are widened to fp16 first (exact): in
//    shared memory when Z is one tile high or wide, else once for the whole
//    operand by the K-major copy (so that no tile is widened once per tile
//    of the other operand). The schedule runs at the fp16 tensor-core
//    rate: see the numerics below for why not at the fp8 one.
//  - small rows (redmule_gemm_sr.cu), for (mul, add) on fp8 operands with
//    at most 16 rows: the decode step. Bound by the weight bytes (8
//    operations a byte at M = 4, far below the card's ridge), so each
//    weight byte is read once with 16-byte loads, by enough blocks to fill
//    the 132 SMs (K split across blocks, partials combined in a fixed
//    order), and multiplied on the tensor cores (mma.sync m16n8k32 on the
//    fp8 bytes, W as the 16-row operand).
//  - SIMT (this file), for the six semiring pairs and every (mul, add)
//    whose operands the tensor cores cannot take exactly: an fp32 compute
//    format (the tensor cores have no fp32 products) or operands that the
//    compute cast would round. Three forms, below.
//
// Numerics of the tensor-core schedules. The reference rounds the operands
// to the compute format and sums their products in fp32
// (dot_general(..., preferred_element_type=f32)). For the operands routed
// to them that cast is the identity (E4M3/E5M2 -> fp16/bf16, or fp16/bf16
// already in the compute format), and the products of those values are
// exact. The sum must stay an fp32 sum. fp8 wgmma does not keep one: it
// holds only about 14 bits of the running sum (DeepSeek-V3 technical
// report, "Increasing Accumulation Precision"), and measured on the H100 it
// moved a fifth of the fp16 outputs of a 64 x 4096 x 12800 E4M3 GEMM off
// the fp32 sum, even with every k32 instruction promoted on its own; two
// layers of E4M3/E5M2 requantisation grew that into 9% of the logits and
// whole gradients. fp16 wgmma on the same (widened) values and the fp8
// mma.sync of the small-row schedule gave the fp32 sum's bits in every
// case measured. Each schedule still adds its MMA results into separate
// fp32 registers: every 128 of K in the tensor-core schedule (one TMA
// stage: 128 fp8 or 64 16-bit elements), every 32 of K in the small-row
// schedule. Y is added in fp32 in the epilogue and Z rounds once, at the
// output cast unit, with the reference's E4M3 NaN rule
// (store_from_float). Zero fill at the ragged edges is exact only for
// (mul, add), the one pair these schedules take.
//
// Non-K-major operands. wgmma reads fp8 operands K-major only (the
// transpose operand exists for 16-bit types alone), the small-row loads
// read 16-byte rows of K, and TMA wants 16-byte-aligned rows. The planner
// names every operand whose view is not K-major with rows of whole
// 16-byte groups; the wrapper copies it once per call with
// kmajor_copy_kernel (redmule_gemm_sr.cu: bytes copied exactly, rows
// padded to 16 bytes with zeros), an auxiliary launch with its own
// counter. On the serving path no weight is copied: E4M3 weights are made
// once as (N, K) tensors presented as their (K, N) views.
//
// The SIMT schedule. Each form computes the reference's VPU branch for the
// semiring pairs (circ in the compute format, widened to the fp32
// accumulator, star over K, Y folded with star, the output cast last) and
// dot_general with an fp32 sum for (mul, add); the planner (plan_gemm)
// picks the form and the K split from shapes, formats and strides.
//
//  - h2: the semiring pairs under a 16-bit compute format (redmule_hfp8,
//    redmule_fp16, tpu_bf16). Bound by the packed CUDA-core instruction rate:
//    one HADD2/HMUL2/HMNMX2 for circ and one HMNMX2 for star per two
//    (circ, star) pairs, so about half the fp32 form's instructions. circ
//    runs on __half2 / __nv_bfloat162 (__hadd2, __hmul2, __hmin2_nan,
//    __hmax2_nan): the sum or product of two fp16 values rounded once equals
//    the reference's fp32 result rounded to fp16, since fp32's 24 bits are
//    at least 2 * 11 + 2 (bf16: 2 * 8 + 2), and min and max only pick. Every
//    star of these pairs is min or max, so star stays in the same 16-bit
//    registers exactly; the accumulator is widened to fp32 in the epilogue,
//    where Y is folded with star (associative and commutative, so folding
//    it last equals folding it first). The _nan variants propagate NaN as
//    jnp.minimum / jnp.maximum do (the plain ones return the other input).
//  - f32: fp32 compute (the fp32 policy, the closure examples), and (mul,
//    add) on operands that the 16-bit compute cast rounds. Bound by the
//    fp32 FMA peak for (mul, add) (one fmaf a pair) and by two instructions
//    a pair for the semirings (circ rounded once, then min.NaN.f32 or
//    max.NaN.f32 for star: one instruction, no isnan branches). Hopper's
//    DPX instructions are integer-only and compute no floating-point
//    semiring, so they are not used.
//  - warp: fp32 compute with few outputs, the MoE router (4 or 64 rows, N =
//    32, K = 1024) among them. One tile would leave all but one SM idle and
//    walk K serially; the product is bound by launch latency and by how
//    fast the SMs that run it pull W's bytes. For an N-contiguous W (the
//    router's) a lane takes a column of one row (up to 8 rows) or of 4
//    rows (so W is read once for 4), the warps of a block and the 8 blocks
//    of a thread-block cluster split K (so W's 128 KB spread over 8 SMs),
//    each lane starts its loads for 16 steps of K before it folds them,
//    and the partials fold in warp order, then in cluster-rank order
//    through distributed shared memory. For any other W one warp takes an output,
//    its lanes split K and reduce with xor shuffles. The order is fixed
//    either way, so an eager call and a graph replay give the same bits.
//
// Both tiled forms: a 64 x 128 output tile per block of 128 threads, each
// thread an 8 x 8 register tile (so two 16-byte shared-memory loads of X
// and one or two of W feed 64 pairs), K in steps of 16. X and W tiles are
// staged in their storage format through a ring of two shared-memory stages
// filled by cp.async with 16-byte requests (zero-filled at ragged edges)
// while the previous stage computes; an operand whose unit-stride axis is
// not 16-byte aligned is loaded element by element into the same ring.
// Each staged element is then converted once into the compute tile: fp8
// pairs widened to fp16 with the packed conversion
// (__nv_cvt_fp8x2_to_halfraw2, exact; to bf16 exactly from there), fp32 or
// mismatched 16-bit operands rounded to the compute format. X goes into
// the h2 tile duplicated ({x, x}) so that one register feeds a packed pair
// of columns. Lanes of K past the split's end never reach star, so ragged
// K needs no padding value. Where the output tiles are too few to fill the
// card (the 64-row apsp product: 100 tiles), K is split across blocks until
// the grid comes nearest one wave of 4 resident blocks on each of the 132
// SMs (100 tiles: 5 splits, 500 blocks); each split writes fp32 partials
// and the split-K combine (redmule_gemm_sr.cu) folds them with star in
// split order, then Y, then the output cast: min and max give the same
// bits in any order, and (mul, add) sums in a fixed one. Every operand has
// explicit batch, row and K strides (two batch levels); a batch stride of
// 0 shares the weight, and transposed views need no copy. The tiled forms'
// staging, conversion and kernel are in redmule_simt.cuh, shared with
// redmule_gemm_h2.cu, which holds the h2 launches so that the two sources
// compile in parallel.
#include <cooperative_groups.h>

#include "redmule_simt.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace redmule_simt;

constexpr int WARP_THREADS = 256;  // warp form, lanes over K: 8 outputs a block
constexpr int WARP_BATCH = 32;     // ... loads a lane starts before it folds them
constexpr int WN_WARPS = 8;        // warp form, lanes over N: K slices (warps) a block,
constexpr int WN_CLUSTER = 8;      // ... blocks a cluster, each a share of K,
constexpr int WN_ROWS = 4;         // ... rows a block above WN_ONE_ROW_M rows (else 1),
constexpr int WN_ONE_ROW_M = 8;
constexpr int WN_BATCH = 16;       // ... and K steps a lane loads before it folds them

// One lane's fold over k = k_begin, k_begin + stride, ... (< k_end), in
// that order. The loads go out in batches of WARP_BATCH before their
// operations, so a lane waits for memory once a batch and not once an
// element; fp32 operands (F32IN) are read as floats, others widened.
template <bool F32IN>
__device__ __forceinline__ float warp_load(const Operand& o, long long i) {
  if constexpr (F32IN) return __ldg(reinterpret_cast<const float*>(o.p) + i);
  else return load_as_float(o.p, i, o.dt);
}

template <int CIRC, int STAR, bool F32IN>
__device__ __forceinline__ float warp_fold(const GemmArgs& a, long long xo, long long wo,
                                           int k_begin, int k_end, int stride) {
  float acc = identity_f32<STAR>();
  for (int k0 = k_begin; k0 < k_end; k0 += WARP_BATCH * stride) {
    float xv[WARP_BATCH], wv[WARP_BATCH];
#pragma unroll
    for (int j = 0; j < WARP_BATCH; ++j) {
      const long long k = k0 + j * stride;
      const bool in = k < k_end;
      xv[j] = in ? warp_load<F32IN>(a.x, xo + k * a.x.sk) : 0.0f;
      wv[j] = in ? warp_load<F32IN>(a.w, wo + k * a.w.sk) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < WARP_BATCH; ++j) {
      if (k0 + j * stride >= k_end) break;
      if constexpr (CIRC == OP_MUL && STAR == OP_ADD) {
        acc = fmaf(xv[j], wv[j], acc);
      } else {
        acc = op_f32<STAR>(acc, op_f32<CIRC>(xv[j], wv[j]));
      }
    }
  }
  return acc;
}

// The warp form, for a W whose N axis is its unit-stride one (the router's
// (d, E) weight): a block takes ROWS rows and 32 columns, a lane a column
// (W rows read whole, once for all the rows; X broadcast), a warp a
// K slice folded in order, and K split across the WN_CLUSTER blocks of a
// thread-block cluster, so that W's bytes spread over that many SMs. Each
// block folds its warps' slices in warp order; then block 0 of the
// cluster folds the blocks' partials in rank order out of their shared
// memory (distributed shared memory) and stores. One launch, a fixed
// order. fp32 compute only.
template <int CIRC, int STAR, int ROWS, bool F32IN>
__device__ __forceinline__ void warp_n_fold(const GemmArgs& a, const long long (&xo)[ROWS],
                                            long long wo, int k0, int k1, float (&acc)[ROWS]) {
  for (int kb = k0; kb < k1; kb += WN_BATCH) {
    float xv[ROWS][WN_BATCH], wv[WN_BATCH];
#pragma unroll
    for (int j = 0; j < WN_BATCH; ++j) {
      const bool in = kb + j < k1;
      wv[j] = in ? warp_load<F32IN>(a.w, wo + (long long)(kb + j) * a.w.sk) : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xv[r][j] = in && xo[r] >= 0 ? warp_load<F32IN>(a.x, xo[r] + (long long)(kb + j) * a.x.sk)
                                    : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < WN_BATCH; ++j) {
      if (kb + j >= k1) break;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if constexpr (CIRC == OP_MUL && STAR == OP_ADD) {
          acc[r] = fmaf(xv[r][j], wv[j], acc[r]);
        } else {
          acc[r] = op_f32<STAR>(acc[r], op_f32<CIRC>(xv[r][j], wv[j]));
        }
      }
    }
  }
}

template <int CIRC, int STAR, int ROWS>
__global__ void __cluster_dims__(1, 1, WN_CLUSTER) __launch_bounds__(WN_WARPS * 32)
    warp_n_kernel(const GemmArgs a) {
  __shared__ float part[WN_WARPS][ROWS][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane, m0 = blockIdx.y * ROWS, bz = blockIdx.z / WN_CLUSTER;
  const int b1 = bz / a.b2, b2 = bz % a.b2;
  const int slices = WN_CLUSTER * WN_WARPS, slice = (blockIdx.z % WN_CLUSTER) * WN_WARPS + wid;
  const int ks = (a.k + slices - 1) / slices, k0 = slice * ks, k1 = min(a.k, k0 + ks);
  float acc[ROWS];
  long long xo[ROWS];  // -1: a row past M
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r] = identity_f32<STAR>();
    xo[r] = m0 + r < a.m ? b1 * a.x.s1 + b2 * a.x.s2 + (long long)(m0 + r) * a.x.sr : -1;
  }
  if (n < a.n) {
    const long long wo = b1 * a.w.s1 + b2 * a.w.s2 + (long long)n * a.w.sr;
    if (a.x.dt == DT_F32 && a.w.dt == DT_F32) {
      warp_n_fold<CIRC, STAR, ROWS, true>(a, xo, wo, k0, k1, acc);
    } else {
      warp_n_fold<CIRC, STAR, ROWS, false>(a, xo, wo, k0, k1, acc);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) part[wid][r][lane] = acc[r];
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int w = 1; w < WN_WARPS; ++w) acc[r] = op_f32<STAR>(acc[r], part[w][r][lane]);
      part[0][r][lane] = acc[r];
    }
  }
  cluster.sync();  // every block's partials are in its shared memory
  if (cluster.block_rank() == 0 && wid == 0 && n < a.n) {
#pragma unroll
    for (int rank = 1; rank < WN_CLUSTER; ++rank) {
      const float* other = cluster.map_shared_rank(&part[0][0][0], rank);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = op_f32<STAR>(acc[r], other[r * 32 + lane]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (xo[r] >= 0) finish<STAR>(a, bz, b1, b2, 0, m0 + r, n, acc[r]);
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// The warp form for any other W: one warp an output, K split across its
// lanes (lane l takes k = l, l + 32, ...) and folded by xor shuffles in a
// fixed order. fp32 compute only.
template <int CIRC, int STAR>
__global__ void __launch_bounds__(WARP_THREADS) warp_kernel(const GemmArgs a, long long total) {
  const long long o = ((long long)blockIdx.x * WARP_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (o >= total) return;
  const int n = (int)(o % a.n), m = (int)(o / a.n % a.m), bz = (int)(o / a.n / a.m);
  const int b1 = bz / a.b2, b2 = bz % a.b2;
  const long long xo = b1 * a.x.s1 + b2 * a.x.s2 + (long long)m * a.x.sr;
  const long long wo = b1 * a.w.s1 + b2 * a.w.s2 + (long long)n * a.w.sr;
  float acc = a.x.dt == DT_F32 && a.w.dt == DT_F32
                  ? warp_fold<CIRC, STAR, true>(a, xo, wo, lane, a.k, 32)
                  : warp_fold<CIRC, STAR, false>(a, xo, wo, lane, a.k, 32);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    acc = op_f32<STAR>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) finish<STAR>(a, bz, b1, b2, 0, m, n, acc);
}

Operand make_operand(const void* p, int dt, int rows, int k, int b1, int b2, long long s1,
                     long long s2, long long sr, long long sk) {
  const int es = dt == DT_F32 ? 4 : dt <= DT_BF16 ? 2 : 1;
  Operand o{static_cast<const uint8_t*>(p), dt, es, rows, k, s1, s2, sr, sk, 0, 0};
  o.kfast = sk == 1 || sr != 1;
  const bool unit = o.kfast ? sk == 1 : true;
  const long long other = o.kfast ? sr : sk;
  const int other_extent = o.kfast ? rows : k;
  o.vec = unit && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
          (other_extent <= 1 || other * es % 16 == 0) && (b1 <= 1 || s1 * es % 16 == 0) &&
          (b2 <= 1 || s2 * es % 16 == 0);
  return o;
}

template <int CIRC, int STAR>
cudaError_t launch_pair(int form, int ct, const GemmArgs& a, int b1, cudaStream_t st) {
  constexpr bool GEMM = CIRC == OP_MUL && STAR == OP_ADD;
  if (form == FORM_WARP) {
    if (ct != DT_F32 || a.split != 1) return cudaErrorInvalidValue;
    if (a.w.sr == 1 && a.w.sk != 1 && b1 * a.b2 * WN_CLUSTER <= 65535) {
      // Few rows: one a block, for more blocks; more: WN_ROWS a block, so
      // that W is read once for WN_ROWS rows.
      const int rows = a.m <= WN_ONE_ROW_M ? 1 : WN_ROWS;
      const dim3 grid((a.n + 31) / 32, (a.m + rows - 1) / rows, b1 * a.b2 * WN_CLUSTER);
      if (rows == 1) {
        warp_n_kernel<CIRC, STAR, 1><<<grid, WN_WARPS * 32, 0, st>>>(a);
      } else {
        warp_n_kernel<CIRC, STAR, WN_ROWS><<<grid, WN_WARPS * 32, 0, st>>>(a);
      }
      return cudaGetLastError();
    }
    const long long total = (long long)b1 * a.b2 * a.m * a.n;
    const unsigned blocks = (unsigned)((total + WARP_THREADS / 32 - 1) / (WARP_THREADS / 32));
    warp_kernel<CIRC, STAR><<<blocks, WARP_THREADS, 0, st>>>(a, total);
    return cudaGetLastError();
  }
  const dim3 grid(((a.n + BN - 1) / BN) * a.split, (a.m + BM - 1) / BM, b1 * a.b2);
  if (form == FORM_F32) {
    if (ct == DT_F32) return launch_tile<FORM_F32, CIRC, STAR, DT_F32>(a, grid, st);
    if constexpr (GEMM) {
      if (ct == DT_F16) return launch_tile<FORM_F32, CIRC, STAR, DT_F16>(a, grid, st);
      if (ct == DT_BF16) return launch_tile<FORM_F32, CIRC, STAR, DT_BF16>(a, grid, st);
    }
    return cudaErrorInvalidValue;
  }
  if (form == FORM_H2) return launch_h2(CIRC, STAR, ct, a, grid, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). form: 0 warp, 1
// f32, 2 h2 (repro_torch.kernels.redmule_gemm.SIMT_FORMS). z must be a
// contiguous (b1, b2, m, n) buffer; with split > 1 the kernel writes the
// fp32 partials to ws instead and the split-K combine makes z. Every
// stride is in elements.
extern "C" int redmule_gemm_launch(
    int circ, int star, int compute_dt, int form,
    const void* x, int x_dt, const void* w, int w_dt, const void* y, int y_dt,
    void* z, int z_dt, void* ws, int b1, int b2, int m, int n, int k, int split,
    int k_per_split,
    long long sx1, long long sx2, long long sxm, long long sxk,
    long long sw1, long long sw2, long long swk, long long swn,
    long long sy1, long long sy2, long long sym, long long syn,
    void* stream) {
  if (split < 1 || (split > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  GemmArgs a{make_operand(x, x_dt, m, k, b1, b2, sx1, sx2, sxm, sxk),
             make_operand(w, w_dt, n, k, b1, b2, sw1, sw2, swn, swk),
             y, z, static_cast<float*>(ws), y_dt, z_dt, b2, m, n, k, split, k_per_split,
             sy1, sy2, sym, syn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (circ * 4 + star) {
    case OP_MUL * 4 + OP_ADD: return launch_pair<OP_MUL, OP_ADD>(form, compute_dt, a, b1, st);
    case OP_ADD * 4 + OP_MAX: return launch_pair<OP_ADD, OP_MAX>(form, compute_dt, a, b1, st);
    case OP_ADD * 4 + OP_MIN: return launch_pair<OP_ADD, OP_MIN>(form, compute_dt, a, b1, st);
    case OP_MUL * 4 + OP_MAX: return launch_pair<OP_MUL, OP_MAX>(form, compute_dt, a, b1, st);
    case OP_MUL * 4 + OP_MIN: return launch_pair<OP_MUL, OP_MIN>(form, compute_dt, a, b1, st);
    case OP_MAX * 4 + OP_MIN: return launch_pair<OP_MAX, OP_MIN>(form, compute_dt, a, b1, st);
    case OP_MIN * 4 + OP_MAX: return launch_pair<OP_MIN, OP_MAX>(form, compute_dt, a, b1, st);
    default: return cudaErrorInvalidValue;
  }
}
