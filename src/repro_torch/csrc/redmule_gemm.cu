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
//    compute cast would round. Bound by the fp32 peak of the CUDA cores.
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
// The SIMT design: a shared-memory-tiled kernel, a 64x64 output tile per
// block of 256 threads, each thread a 4x4 register micro-tile, K in steps
// of 16. The fp32 accumulator lives in registers and starts from Y or from
// the star identity. Operands are loaded in their storage format, widened
// to fp32 and rounded to the compute format in the tile (the paper's
// input cast unit); for the semiring pairs circ is rounded to the compute
// format before star, as the reference's VPU path does. Every operand has
// explicit batch, row and column strides (two batch levels); a batch
// stride of 0 shares the weight across the batch, and transposed views
// need no copy: the tile loader walks the unit-stride axis fastest. The
// ragged edge is masked here.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = 256;  // 16 x 16 threads, each TM x TN outputs

enum OpCode { OP_MUL = 0, OP_ADD = 1, OP_MIN = 2, OP_MAX = 3 };

template <int OP>
__device__ __forceinline__ float apply_op(float a, float b) {
  if (OP == OP_MUL) return a * b;
  if (OP == OP_ADD) return a + b;
  // min and max propagate NaN, as jnp.minimum / jnp.maximum do.
  if (isnan(a) || isnan(b)) return a + b;
  return OP == OP_MIN ? fminf(a, b) : fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == OP_ADD) return 0.0f;
  if (OP == OP_MIN) return __int_as_float(0x7f800000);  // +inf
  if (OP == OP_MAX) return __int_as_float(0xff800000);  // -inf
  return 1.0f;
}

struct GemmArgs {
  const void* x;
  const void* w;
  const void* y;  // null: the accumulator starts from the star identity
  void* z;        // contiguous (b1, b2, m, n)
  int x_dt, w_dt, y_dt, z_dt;
  int b2, m, n, k;
  long long sx1, sx2, sxm, sxk;
  long long sw1, sw2, swk, swn;
  long long sy1, sy2, sym, syn;
};

template <int CIRC, int STAR, int CT>
__global__ void __launch_bounds__(THREADS) redmule_gemm_kernel(const GemmArgs a) {
  __shared__ float xs[BK][BM + 4];  // X tile, k-major
  __shared__ float ws[BK][BN + 4];  // W tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b1 = blockIdx.z / a.b2, b2 = blockIdx.z % a.b2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long xoff = b1 * a.sx1 + b2 * a.sx2;
  const long long woff = b1 * a.sw1 + b2 * a.sw2;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      acc[i][j] = identity<STAR>();
      if (a.y != nullptr && m < a.m && n < a.n) {
        acc[i][j] = load_as_float(
            a.y, b1 * a.sy1 + b2 * a.sy2 + m * a.sym + n * a.syn, a.y_dt);
      }
    }
  }

  const bool x_k_fast = a.sxk == 1;
  const bool w_n_fast = a.swn == 1;
  for (int k0 = 0; k0 < a.k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = x_k_fast ? e / BK : e % BM;
      const int kk = x_k_fast ? e % BK : e / BM;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.0f;
      if (m < a.m && k < a.k) {
        v = round_to(load_as_float(a.x, xoff + m * a.sxm + k * a.sxk, a.x_dt), CT);
      }
      xs[kk][mm] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = w_n_fast ? e / BN : e % BK;
      const int nn = w_n_fast ? e % BN : e / BK;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.0f;
      if (k < a.k && n < a.n) {
        v = round_to(load_as_float(a.w, woff + k * a.swk + n * a.swn, a.w_dt), CT);
      }
      ws[kk][nn] = v;
    }
    __syncthreads();
    const int kmax = min(BK, a.k - k0);  // lanes past K never reach star
    for (int kk = 0; kk < kmax; ++kk) {
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (CIRC == OP_MUL && STAR == OP_ADD) {
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
          } else {
            const float c = round_to(apply_op<CIRC>(xv[i], wv[j]), CT);
            acc[i][j] = apply_op<STAR>(acc[i][j], c);
          }
        }
      }
    }
    __syncthreads();
  }

  const long long zoff = (long long)blockIdx.z * a.m * a.n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < a.m && n < a.n) store_from_float(a.z, zoff + (long long)m * a.n + n, a.z_dt, acc[i][j]);
    }
  }
}

template <int CIRC, int STAR>
cudaError_t launch_pair(int compute_dt, const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  switch (compute_dt) {
    case DT_F32: redmule_gemm_kernel<CIRC, STAR, DT_F32><<<grid, THREADS, 0, stream>>>(a); break;
    case DT_F16: redmule_gemm_kernel<CIRC, STAR, DT_F16><<<grid, THREADS, 0, stream>>>(a); break;
    case DT_BF16: redmule_gemm_kernel<CIRC, STAR, DT_BF16><<<grid, THREADS, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). z must be a
// contiguous (b1, b2, m, n) buffer; every stride is in elements.
extern "C" int redmule_gemm_launch(
    int circ, int star, int compute_dt,
    const void* x, int x_dt, const void* w, int w_dt, const void* y, int y_dt,
    void* z, int z_dt, int b1, int b2, int m, int n, int k,
    long long sx1, long long sx2, long long sxm, long long sxk,
    long long sw1, long long sw2, long long swk, long long swn,
    long long sy1, long long sy2, long long sym, long long syn,
    void* stream) {
  GemmArgs a{x, w, y, z, x_dt, w_dt, y_dt, z_dt, b2, m, n, k,
             sx1, sx2, sxm, sxk, sw1, sw2, swk, swn, sy1, sy2, sym, syn};
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, b1 * b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (circ * 4 + star) {
    case OP_MUL * 4 + OP_ADD: return launch_pair<OP_MUL, OP_ADD>(compute_dt, a, grid, st);
    case OP_ADD * 4 + OP_MAX: return launch_pair<OP_ADD, OP_MAX>(compute_dt, a, grid, st);
    case OP_ADD * 4 + OP_MIN: return launch_pair<OP_ADD, OP_MIN>(compute_dt, a, grid, st);
    case OP_MUL * 4 + OP_MAX: return launch_pair<OP_MUL, OP_MAX>(compute_dt, a, grid, st);
    case OP_MUL * 4 + OP_MIN: return launch_pair<OP_MUL, OP_MIN>(compute_dt, a, grid, st);
    case OP_MAX * 4 + OP_MIN: return launch_pair<OP_MAX, OP_MIN>(compute_dt, a, grid, st);
    case OP_MIN * 4 + OP_MAX: return launch_pair<OP_MIN, OP_MAX>(compute_dt, a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}
