// Dense flash attention on Hopper's CUDA cores (sm_90a): online-softmax
// attention with a top-left causal mask, softcap, GQA and ragged sequence
// lengths, register-tiled in fp32. The route planner
// (repro_torch.kernels.flash_attention.plan_flash) sends fp32 at every
// head dim here, and fp16 and bf16 at the head dims the tensor-core kernel
// (flash_attention_tc.cu) has no instance for.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py::flash_attention.
//
// Design, and what it does about this card:
//  - What bounds it: the operations (4 * Sq * Sk * hd a head, halved by
//    the causal mask), in fp32 FMA on the CUDA cores (no TF32: its 10-bit
//    products would not keep the reference's fp32 arithmetic). q/k/v/o
//    move ~48 MB at granite's shape, far below that. So the design keeps
//    the FMA pipes fed: each thread owns an RM x 4 score micro-tile (RM =
//    8 query rows, 4 at hd 256) and reads shared memory as float4: 12
//    16-byte loads for every 128 FMAs (8 for 64 at hd 256), the Q loads
//    broadcast within a half-warp; the product loops unrolled 8 steps
//    deep (the fastest of 1, 2, 4, 8, 16 and 32 on the card).
//  - One block of 256 threads (16 x 16) per (batch x query head, BQ-row
//    query tile): BQ = 128 rows (64 at hd 256, so that O stays in
//    registers), walking the keys in tiles of 64. The grid's slow axis
//    walks the query tiles from the last, so the causal tiles with the
//    most keys start first. Thread (ty, tx) owns keys tx + 16 j and head
//    dims tx * W + 16 W c + e (W = min(4, hd / 16)); a warp owns a run of
//    2 RM rows, its two half-warps' rows interleaved. Keys and rows are so
//    placed that a warp's Q, K and P reads hit distinct banks, dims in
//    16-byte runs so that V reads are contiguous; a warp whose rows all
//    lie before a causal key tile skips its products (the block's other
//    warps get the issue slots).
//  - The tiles lie row-major in shared memory as they lie in memory, each
//    row padded by 4 floats (a 16-byte bank shift a row). The Q tile is
//    loaded once; K and V tiles come by 16-byte cp.async, each load
//    issued as soon as its buffer is free and overlapped with the other
//    product: K_{j+1} streams in during tile j's softmax and P.V, V_{j+1}
//    during tile j+1's Q.K^T and softmax. (Two stages of each would not
//    fit 227 KB beside the 64 KB Q tile at hd 128 and 256.)
//  - The scores stay in registers through the softmax: scale, softcap,
//    mask, the row max by 4 shuffles across the half-warp that shares a
//    row, p = exp2 in log2 units; l is kept as per-thread partial sums
//    reduced once at the end. p goes through shared memory only for the
//    P.V product (8 or 4 float4 rows read a 4-key step); O accumulates in
//    registers, rescaled once a tile.
//  - The (acc, m, l) state that Pallas carried in VMEM scratch along its
//    sequential kj grid axis lives in registers: blocks on this card run in
//    no order and nothing carries between them.
//  - Layout is the entry point's own: q (B, Sq, Hq, hd), k/v (B, Sk, Hkv,
//    hd), read in place; the KV head of query head h is h / G (the L2
//    cache serves the G query heads that read one KV head). Causal tiles
//    past the block's last live row are never loaded; ragged Sq and Sk
//    are zero-filled by the loads and masked on the true lengths.
//  - Instances: hd 32, 64, 128 and 256. fp32 at exactly those widths
//    takes the cp.async loads; every other case (fp16 and bf16 inputs,
//    other widths up to 256) takes the smallest instance that holds its
//    width, with loads that widen each element to fp32 and zero-fill the
//    dims past hd (``kernels/flash_attention.py::simt_tile`` names each).
//  - Numerics of the reference kernel: fp32 scores scaled by 1/sqrt(hd),
//    then softcap * tanh(s / softcap); masked scores are NEG_INF = -0.7 *
//    FLT_MAX, not -inf; p is rounded to v's format before the PV product;
//    the output is acc / max(l, 1e-30), cast to q's format.
#include "common.cuh"

namespace {

constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int UNROLL = 8;      // steps of the two product loops unrolled together
constexpr int PAD = 4;         // floats of padding a tile row
constexpr int PK = BK + 16;    // a P row: 80 floats, so a warp's two rows fall on other banks
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int rows() { return HD == 256 ? 64 : 128; }

template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return rows<HD>() * (HD + PAD) + 2 * BK * (HD + PAD) + rows<HD>() * PK;
}
static_assert(smem_floats<256>() * 4 <= 232448 && smem_floats<128>() * 4 <= 232448,
              "a block takes at most 227 KB of shared memory");

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int dt;  // storage code of q, k, v and out
  int b, sq, sk, hq, hkv, hd;
  int causal, n_qtiles;
  float softcap, scale;  // softcap <= 0: none
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  }
}

// ``n`` rows of a (B, S, H, hd) tensor from row ``r0`` of head ``head``
// into a padded row-major tile (HD + PAD floats a row). ASYNC: fp32 with hd
// == HD, by 16-byte cp.async (committed by the caller); rows past ``len``
// are zero-filled. Otherwise each element is widened to fp32, and rows
// past ``len`` and dims past hd are zeros.
template <int HD, bool ASYNC>
__device__ __forceinline__ void load_tile(float* tile, const void* src, int n, int r0, int len,
                                          long long row_base, int row_stride, int hd, int dt) {
  constexpr int HP = HD + PAD;
  if constexpr (ASYNC) {
    const float* s = static_cast<const float*>(src);
    for (int e = threadIdx.x; e < n * (HD / 4); e += THREADS) {
      const int r = e / (HD / 4), c = 4 * (e % (HD / 4));
      const bool live = r0 + r < len;
      const float* from = live ? s + row_base + (long long)(r0 + r) * row_stride + c : s;
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(tile + r * HP + c)), from, live);
    }
  } else {
    for (int e = threadIdx.x; e < n * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      float x = 0.0f;
      if (r0 + r < len && c < hd) x = load_as_float(src, row_base + (long long)(r0 + r) * row_stride + c, dt);
      tile[r * HP + c] = x;
    }
  }
}

template <int HD, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(const AttnArgs a) {
  constexpr int BQ = rows<HD>();
  constexpr int RM = BQ / 16;                 // query rows a thread
  constexpr int KN = BK / 16;                 // keys a thread
  constexpr int DV = HD / 16;                 // head dims a thread
  constexpr int W = DV < 4 ? DV : 4;          // contiguous dims a run
  constexpr int NC = DV / W;                  // runs a thread
  constexpr int HP = HD + PAD;
  extern __shared__ float smem[];
  float* qs = smem;                 // (BQ, HP)
  float* ks = qs + BQ * HP;         // (BK, HP)
  float* vs = ks + BK * HP;         // (BK, HP)
  float* ps = vs + BK * HP;         // (BQ, PK): p, rounded to v's format

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // This thread's rows of the tile: r0 + 2 i. A warp (ty = 2w, 2w + 1)
  // owns 2 RM rows in a run, its two halves a row apart (so their Q and P
  // reads fall on other banks); under the causal mask a warp whose last
  // row lies before a key tile skips that tile's products.
  const int r0 = 2 * RM * (ty / 2) + ty % 2;
  const int warp_last = 2 * RM * (ty / 2) + 2 * RM - 1;
  const int bh = blockIdx.x, bi = bh / a.hq, h = bh % a.hq, hk = h / (a.hq / a.hkv);
  const int q0 = (a.n_qtiles - 1 - (int)blockIdx.y) * BQ;  // the longest tiles first
  const int q_end = min(q0 + BQ, a.sq);
  const int k_end = a.causal ? min(a.sk, q_end) : a.sk;   // later keys are masked for every row
  const int nk = (k_end + BK - 1) / BK;
  const long long q_base = ((long long)bi * a.sq * a.hq + h) * a.hd;
  const long long kv_base = ((long long)bi * a.sk * a.hkv + hk) * a.hd;
  const int q_stride = a.hq * a.hd, kv_stride = a.hkv * a.hd;

  load_tile<HD, ASYNC>(qs, a.q, BQ, q0, a.sq, q_base, q_stride, a.hd, a.dt);
  if (nk > 0) load_tile<HD, ASYNC>(ks, a.k, BK, 0, a.sk, kv_base, kv_stride, a.hd, a.dt);
  if constexpr (ASYNC) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (nk > 0) load_tile<HD, ASYNC>(vs, a.v, BK, 0, a.sk, kv_base, kv_stride, a.hd, a.dt);
  if constexpr (ASYNC) cp_async_commit();

  float o[RM][DV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int d = 0; d < DV; ++d) o[i][d] = 0.0f;
  }
  float m_run[RM], l_part[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) m_run[i] = NEG_INF, l_part[i] = 0.0f;
  const float scale_log2 = a.scale * LOG2E;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    const bool live = !a.causal || k0 <= q0 + warp_last;  // a warp's rows see a key here
    // S = Q.K^T: RM x KN scores a thread, over hd in float4 steps.
    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int n = 0; n < KN; ++n) s[i][n] = 0.0f;
    }
#pragma unroll UNROLL
    for (int d = 0; d < HD; d += 4) {
      if (!live) break;
      float qv[RM][4], kv[KN][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) load_vec<4>(qs + (r0 + 2 * i) * HP + d, qv[i]);
#pragma unroll
      for (int n = 0; n < KN; ++n) load_vec<4>(ks + (tx + 16 * n) * HP + d, kv[n]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int n = 0; n < KN; ++n) s[i][n] = fmaf(qv[i][e], kv[n][e], s[i][n]);
        }
      }
    }
    __syncthreads();  // every thread is done with K_j
    const bool more = j + 1 < nk;
    if (more) {
      load_tile<HD, ASYNC>(ks, a.k, BK, k0 + BK, a.sk, kv_base, kv_stride, a.hd, a.dt);
      if constexpr (ASYNC) cp_async_commit();
    }

    // Scale, softcap and mask, in log2 units; the online softmax by rows.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (!live) break;
      const int row = q0 + r0 + 2 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        const int key = k0 + tx + 16 * n;
        float x = a.softcap > 0.0f ? a.softcap * tanhf(s[i][n] * a.scale / a.softcap) * LOG2E
                                   : s[i][n] * scale_log2;
        const bool ok = key < a.sk && (!a.causal || key <= row);
        x = ok ? x : NEG_INF;
        s[i][n] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        const float p = fast_exp2(s[i][n] - m_new);
        sum += p;
        ps[(r0 + 2 * i) * PK + tx + 16 * n] = round_to(p, a.dt);  // p rounded to v's format
      }
      l_part[i] = l_part[i] * alpha + sum;
#pragma unroll
      for (int d = 0; d < DV; ++d) o[i][d] *= alpha;
    }
    if constexpr (ASYNC) {  // V_j landed (K_{j+1}, if any, may still stream)
      if (more) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    __syncthreads();  // p and V_j visible to every thread

    // O += P.V_j: 4 keys a step, RM float4 of p and 4 x NC runs of V.
#pragma unroll UNROLL
    for (int t = 0; t < BK; t += 4) {
      if (!live) break;
      float pv[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) load_vec<4>(ps + (r0 + 2 * i) * PK + t, pv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[NC][W];
#pragma unroll
        for (int c = 0; c < NC; ++c) load_vec<W>(vs + (t + e) * HP + tx * W + 16 * W * c, vv[c]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int w = 0; w < W; ++w) o[i][c * W + w] = fmaf(pv[i][e], vv[c][w], o[i][c * W + w]);
          }
        }
      }
    }
    if constexpr (ASYNC) cp_async_wait<0>();  // K_{j+1} landed
    __syncthreads();  // every thread is done with P and V_j; K_{j+1} visible
    if (more) {
      load_tile<HD, ASYNC>(vs, a.v, BK, k0 + BK, a.sk, kv_base, kv_stride, a.hd, a.dt);
      if constexpr (ASYNC) cp_async_commit();
    }
  }

  // l over the half-warp that shares the rows, then out = acc / max(l, 1e-30).
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = l_part[i];
#pragma unroll
    for (int off = 1; off < 16; off *= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    l = fmaxf(l, 1e-30f);
    const int row = q0 + r0 + 2 * i;
    if (row >= a.sq) continue;
    const long long base = q_base + (long long)row * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = tx * W + 16 * W * c;
      if constexpr (ASYNC && W == 4) {
        float4 t = make_float4(o[i][c * W] / l, o[i][c * W + 1] / l, o[i][c * W + 2] / l,
                               o[i][c * W + 3] / l);
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + base + d0) = t;
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (d0 + w < a.hd) store_from_float(a.out, base + d0 + w, a.dt, o[i][c * W + w] / l);
        }
      }
    }
  }
}

template <int HD, bool ASYNC>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * 4;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.b * a.hq, a.n_qtiles);
  flash_attention_kernel<HD, ASYNC><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool ASYNC>
cudaError_t launch_width(int width, AttnArgs& a, cudaStream_t st) {
  const int bq = width == 256 ? 64 : 128;
  a.n_qtiles = (a.sq + bq - 1) / bq;
  if (a.n_qtiles > 65535) return cudaErrorInvalidValue;
  switch (width) {
    case 32: return launch<32, ASYNC>(a, st);
    case 64: return launch<64, ASYNC>(a, st);
    case 128: return launch<128, ASYNC>(a, st);
    default: return launch<256, ASYNC>(a, st);
  }
}

}  // namespace

// q and out: contiguous (b, sq, hq, hd); k, v: contiguous (b, sk, hkv, hd),
// all in the storage format dt (fp32, fp16 or bf16); hq a multiple of hkv,
// hd <= 256. The instance is the smallest of hd 32, 64, 128 and 256 that
// holds hd; fp32 at exactly that width loads by cp.async, which needs
// 16-byte aligned pointers. Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dt,
    int b, int sq, int sk, int hq, int hkv, int hd, int causal,
    float softcap, float scale, void* stream) {
  if (hd > 256 || hd < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0 ||
      (long long)b * hq > 2147483647LL || (dt != DT_F32 && dt != DT_F16 && dt != DT_BF16)) {
    return cudaErrorInvalidValue;
  }
  const int width = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  AttnArgs a{q, k, v, out, dt, b, sq, sk, hq, hkv, hd, causal, 0, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (dt == DT_F32 && hd == width) {
    if (!aligned) return cudaErrorMisalignedAddress;
    return launch_width<true>(width, a, st);
  }
  return launch_width<false>(width, a, st);
}
