// RedMulE GEMM-Op kernel for Hopper (sm_90a): Z = star(Y, star_k circ(X, W)).
//
// Replaces the TPU kernel repro/kernels/redmule_gemm.py::redmule_gemm_pallas
// (body _kernel): the same function for all seven Table-1 (circ, star)
// pairs, one template instantiated per pair and compute format.
//
// Design, and what it does about this card:
//  - A shared-memory-tiled SIMT kernel: a 64x64 output tile per block of
//    256 threads, each thread a 4x4 register micro-tile, K in steps of 16.
//    The fp32 accumulator lives in registers and starts from Y or from the
//    star identity. Pallas' sequential K grid axis becomes the K loop
//    inside the block: blocks on Hopper run in no order, so nothing
//    carries between them.
//  - Operands are loaded in their storage format (fp8 crosses device
//    memory at one byte an element), widened to fp32 and rounded to the
//    compute format in the tile: the paper's input cast unit. For the
//    (mul, add) pair the products of compute-format values are exact in
//    fp32 and summed there, as the reference's dot_general with an fp32
//    preferred type does. For the semiring pairs circ is rounded to the
//    compute format before star, as the reference's VPU path does.
//  - Every operand has explicit batch, row and column strides (two batch
//    levels). A batch stride of 0 shares the weight across the batch, and
//    transposed views (attention's swapped keys, the tied unembedding's
//    table.T) need no copy: the tile loader walks the unit-stride axis
//    fastest to keep loads coalesced. The ragged edge is masked here, so
//    the reference's padding step has no counterpart.
//  - What bounds it: decode rows (M = the slot count) are bound by the
//    weight bytes; prefill rows (M = the prompt bucket) by the operations.
//    This first kernel runs on the CUDA cores; wgmma, TMA and fp8 tensor
//    cores are later work, recorded in PERF.md.
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
