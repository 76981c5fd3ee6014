// Dense flash attention on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA, for fp16 and bf16 with head dim 64, 128 or 256. The route planner
// (repro_torch.kernels.flash_attention.plan_flash) sends fp32 and every
// other head dim to the register-tiled CUDA-core kernel in
// flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py::flash_attention.
//
// Design, and what it does about this card:
//  - One block per (batch x query head, 128-row query tile); the grid's
//    slow axis walks the query tiles from the last, so the causal tiles
//    with the most keys start first and the short ones fill the tail.
//  - Warp specialisation, as the GEMM's tensor-core schedule: warpgroup 2
//    is the producer, one thread of which loads the Q tile once and keeps
//    TMA loads of K and V tiles (BKEYS keys x hd) in flight into a ring of
//    stages, with a "full" and an "empty" mbarrier each for K and V. The
//    tiles are read in place from the (B, S, H, hd) layout
//    through 4D tensor maps {hd, H, S, B}: the KV head of query head h is
//    h / G, and no repeat of the KV heads is made.
//  - Warpgroups 0 and 1 are consumers, 64 query rows each. S = Q.K^T by
//    wgmma m64nBKEYSk16 (fp32 accumulators, both tiles K-major as they
//    lie, 128-byte swizzle). The online softmax runs on the S fragment in
//    registers: each row lives in the four threads of a quad, so its max
//    is two shuffles, and l is kept as per-thread partial sums reduced once
//    at the end. p is rounded to v's format in registers and is the A
//    operand of O += P.V (wgmma with A from registers, N = hd in steps of
//    at most 128); V is the B operand read MN-major through the
//    descriptor's transpose bit, so no transposed copy is made. The two
//    groups take turns on the tensor cores (named barriers): in its turn a
//    group issues its S_j and its O += P_{j-1}.V_{j-1}, then runs tile j's
//    softmax (the exponentials on the special-function units) while the
//    other group's products run.
//  - hd 256 (gemma2, recurrentgemma) takes 64-key tiles: its 64 KB Q tile
//    and two stages of 32 + 32 KB K/V tiles fit the 227 KB a block may
//    have (193 KB), and a consumer's 128 O and 32 S accumulators fit the
//    240 registers setmaxnreg gives it (the producer keeps 24). hd 64 and
//    128 keep 128-key tiles (4 and 2 stages).
//  - Only tiles that cross the diagonal or the ragged key end are masked.
//    Causal tiles past the diagonal are never loaded. Ragged Sq and Sk come
//    from TMA's zero fill plus the mask on the true lengths.
//  - Numerics of the reference kernel: fp32 scores of exact fp16/bf16
//    products, scaled by 1/sqrt(hd), then softcap * tanh(s / softcap);
//    masked scores are NEG_INF = -0.7 * FLT_MAX, not -inf; l sums the fp32
//    p; p is rounded to v's format before PV; out = acc / max(l, 1e-30),
//    cast to q's format.
//  - What bounds it: the operations (4 * Sq * Sk * hd a head, about half
//    of that under the causal mask) at the fp16 tensor-core peak; q/k/v/o
//    move ~24 MB at granite's shape, far below that.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;           // query rows a block: two consumer warpgroups of 64
constexpr int BKEYS = 128;        // keys a K/V tile at hd 64 and 128
constexpr int BKEYS_HD256 = 64;   // keys a K/V tile at hd 256
constexpr int THREADS = 384;      // two consumer warpgroups, one producer
constexpr int ROW_BYTES = 128;    // a TMA box row: 64 elements, swizzled
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int bkeys() { return HD == 256 ? BKEYS_HD256 : BKEYS; }

template <int HD>
__host__ __device__ constexpr int stages() { return HD == 64 ? 4 : 2; }

// Registers a thread after setmaxnreg: the consumers take what the
// producer gives back, so 256 * consumer + 128 * producer stays the
// 384 x 168 the block launched with.
template <int HD>
__host__ __device__ constexpr int consumer_regs() { return HD == 256 ? 240 : 232; }
template <int HD>
__host__ __device__ constexpr int producer_regs() { return HD == 256 ? 24 : 40; }
static_assert(256 * consumer_regs<256>() + 128 * producer_regs<256>() == THREADS * 168, "");
static_assert(256 * consumer_regs<128>() + 128 * producer_regs<128>() == THREADS * 168, "");

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  // 1024 for the alignment the swizzle wants; Q, then K and V per stage;
  // the barriers: Q full, then K full, V full, K empty and V empty per stage.
  return 1024 + (HD / 64) * ROW_BYTES * (BQ + 2 * stages<HD>() * bkeys<HD>()) +
         (1 + 4 * stages<HD>()) * 8;
}
static_assert(smem_bytes<64>() <= 232448 && smem_bytes<128>() <= 232448 &&
              smem_bytes<256>() <= 232448, "a block takes at most 227 KB of shared memory");

struct TcAttnArgs {
  void* out;  // contiguous (b, sq, hq, hd), q's format
  int b, sq, sk, hq, hkv, causal, n_qtiles;
  float softcap, scale;  // softcap <= 0: none
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi, bool bf16) {
  if (bf16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
// (a p that small is far below the output's last place).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (bar.sync by the waiting group, bar.arrive by the
// other: 256 threads each).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// O += P.V over one tile: 16 keys a step (2048 bytes of a V box), hd in
// column blocks of at most 128 (two 64-element boxes, LBO one box apart).
template <int HD, bool BF16>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2], const uint32_t (&p16)[bkeys<HD>() / 4],
                                       uint32_t vt) {
  constexpr int BOX_KV = bkeys<HD>() * ROW_BYTES;
#pragma unroll
  for (int kk = 0; kk < bkeys<HD>() / 16; ++kk) {
    const uint32_t frag[4] = {p16[4 * kk], p16[4 * kk + 1], p16[4 * kk + 2], p16[4 * kk + 3]};
    if constexpr (HD <= 128) {
      wgmma_rs_tb<BF16>(o, frag, make_desc(vt + 2048 * kk, BOX_KV), 1);
    } else {
#pragma unroll
      for (int c = 0; c < HD / 128; ++c) {
        float(&oc)[64] = *reinterpret_cast<float(*)[64]>(&o[64 * c]);
        wgmma_rs_tb<BF16>(oc, frag, make_desc(vt + 2 * c * BOX_KV + 2048 * kk, BOX_KV), 1);
      }
    }
  }
}

template <int HD, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const TcAttnArgs a) {
  constexpr int H = HD / 64;       // 128-byte column blocks of a row
  constexpr int NK = bkeys<HD>();  // keys a tile
  constexpr int NS = NK / 2;       // score accumulators a thread
  constexpr int BOX_Q = BQ * ROW_BYTES, BOX_KV = NK * ROW_BYTES;
  constexpr int TILE_Q = H * BOX_Q, TILE = H * BOX_KV;  // the Q tile; one K or V tile
  constexpr int ST = stages<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base, kv = base + TILE_Q;
  const uint32_t bars = kv + ST * 2 * TILE;
  const uint32_t q_full = bars;
  // Per stage: K full, V full, K empty, V empty. K and V are released
  // apart: a tile's K when its scores are done, its V one turn later.
  auto bar = [&](int kind, int s) { return bars + 8 + 8 * (kind * ST + s); };
  auto k_tile = [&](int s) { return kv + s * 2 * TILE; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.x, bi = bh / a.hq, h = bh % a.hq, hk = h / (a.hq / a.hkv);
  const int q0 = (a.n_qtiles - 1 - (int)blockIdx.y) * BQ;  // the longest tiles first
  const int k_end = a.causal ? min(a.sk, q0 + BQ) : a.sk;   // later keys are masked for every row
  const int nk = (k_end + NK - 1) / NK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), 256);
      mbar_init(bar(3, s), 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(producer_regs<HD>()));
    if (tid == 256) {
      mbar_expect_tx(q_full, TILE_Q);
      for (int c = 0; c < H; ++c) tma_load_4d(q_tile + c * BOX_Q, &qmap, q_full, 64 * c, h, q0, bi);
      for (int j = 0; j < nk; ++j) {
        const int s = j % ST;
        const uint32_t free_parity = ((j / ST) & 1) ^ 1;
        mbar_wait(bar(2, s), free_parity);
        mbar_expect_tx(bar(0, s), TILE);
        for (int c = 0; c < H; ++c) {
          tma_load_4d(k_tile(s) + c * BOX_KV, &kmap, bar(0, s), 64 * c, hk, j * NK, bi);
        }
        mbar_wait(bar(3, s), free_parity);
        mbar_expect_tx(bar(1, s), TILE);
        for (int c = 0; c < H; ++c) {
          tma_load_4d(k_tile(s) + TILE + c * BOX_KV, &vmap, bar(1, s), 64 * c, hk, j * NK, bi);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(consumer_regs<HD>()));
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  float s[NS], o[HD / 2];
  uint32_t p16[NS / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.0f, 0.0f};
  // Scores in log2 units: exp(s * scale - m) = exp2(s * scale * log2(e) - m').
  const float scale_log2 = a.scale * LOG2E;

  // Ping-pong: in its turn a warpgroup issues S_j = Q.K_j^T and O +=
  // P_{j-1}.V_{j-1}, then passes the tensor cores to the other group and
  // runs tile j's softmax on the CUDA cores while they work for it.
  mbar_wait(q_full, 0);
  if (wg == 1) turn_pass(1);  // warpgroup 0 takes the first turn
  for (int j = 0; j < nk; ++j) {
    const int st = j % ST, prev = (j + ST - 1) % ST;
    mbar_wait(bar(0, st), (j / ST) & 1);
    if (j > 0) mbar_wait(bar(1, prev), ((j - 1) / ST) & 1);
    turn_wait(1 + wg);
    fence_operands(s);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // 32 bytes a k16 step inside a 128-byte block
      const uint32_t qa = q_tile + wg * 64 * ROW_BYTES + (kk / 4) * BOX_Q + 32 * (kk % 4);
      const uint32_t ka = k_tile(st) + (kk / 4) * BOX_KV + 32 * (kk % 4);
      if constexpr (NK == 128) {
        wgmma_ss_n128<BF16>(s, make_desc(qa), make_desc(ka), kk > 0);
      } else {
        wgmma_ss_n64<BF16>(s, make_desc(qa), make_desc(ka), kk > 0);
      }
    }
    if (j > 0) mma_pv<HD, BF16>(o, p16, k_tile(prev) + TILE);
    wgmma_commit();
    turn_pass(2 - wg);
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(o);
    mbar_arrive(bar(2, st));                // K_j is read
    if (j > 0) mbar_arrive(bar(3, prev));   // V_{j-1} is read

    // Scale, softcap and mask; s[i] is row row0 + 8 * ((i / 2) % 2), key
    // j * NK + 8 * (i / 4) + 2 * (lane % 4) + i % 2.
    const bool edge = (j + 1) * NK > a.sk || (a.causal && j * NK + NK - 1 > q0 + wg * 64);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x;
      if (a.softcap > 0.0f) {
        x = a.softcap * tanhf(s[i] * a.scale / a.softcap) * LOG2E;
      } else {
        x = s[i] * scale_log2;
      }
      if (edge) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int key = j * NK + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const bool ok = key < a.sk && (!a.causal || key <= row);
        x = ok ? x : NEG_INF;
      }
      s[i] = x;
    }
    // Online softmax, rows in the quad's registers.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2], m_new[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = fast_exp2(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i / 2) % 2;
      const float p0 = fast_exp2(s[i] - m_new[r]), p1 = fast_exp2(s[i + 1] - m_new[r]);
      sum[r] += p0 + p1;
      p16[i / 2] = pack2(p0, p1, BF16);  // p rounded to v's format
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  }
  // The last tile's PV, outside the turns; then take the turn the other
  // group passed last, so every pass is matched.
  if (nk > 0) {
    const int last = (nk - 1) % ST;
    mbar_wait(bar(1, last), ((nk - 1) / ST) & 1);
    fence_operands(o);
    wgmma_fence();
    mma_pv<HD, BF16>(o, p16, k_tile(last) + TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    mbar_arrive(bar(3, last));
  }
  if (wg == 0) turn_wait(1);

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l_part[r]), 1e-30f);
  using T2 = typename std::conditional<BF16, __nv_bfloat162, __half2>::type;
  T2* out = static_cast<T2*>(a.out);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = (i / 2) % 2, row = row0 + 8 * r;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < a.sq) {
      const long long idx = ((((long long)bi * a.sq + row) * a.hq + h) * HD + col) / 2;
      if constexpr (BF16) {
        out[idx] = __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
      } else {
        out[idx] = __floats2half2_rn(o[i] / l[r], o[i + 1] / l[r]);
      }
    }
  }
}

// A 4D map {hd, heads, seq, batch} of a contiguous (batch, seq, heads, hd)
// 16-bit tensor, box 64 elements (128 bytes) x 1 head x ``rows`` rows,
// with the 128-byte swizzle wgmma reads. Rows past seq read as zeros.
int encode_bshd(CUtensorMap* map, const void* ptr, int b, int seq, int heads, int hd, int rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -2;
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int HD, bool BF16>
cudaError_t launch_tc(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                      const TcAttnArgs& a, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_tc_kernel<HD, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.b * a.hq, a.n_qtiles);
  flash_attention_tc_kernel<HD, BF16><<<grid, THREADS, bytes, st>>>(qm, km, vm, a);
  return cudaGetLastError();
}

}  // namespace

// q and out: contiguous (b, sq, hq, hd); k, v: contiguous (b, sk, hkv, hd);
// all fp16 or all bf16 (dt), hd 64, 128 or 256, hq a multiple of hkv. Returns
// 0, a cudaError_t, -1 for a pointer that is not 16-byte aligned, -2
// without cuTensorMapEncodeTiled, or 1000 + the CUresult of a refused map.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out, int dt,
    int b, int sq, int sk, int hq, int hkv, int hd, int causal,
    float softcap, float scale, void* stream) {
  if ((hd != 64 && hd != 128 && hd != 256) || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      (dt != DT_F16 && dt != DT_BF16) || (sq + BQ - 1) / BQ > 65535) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm;
  const int nk = hd == 256 ? BKEYS_HD256 : BKEYS;
  int r = encode_bshd(&qm, q, b, sq, hq, hd, BQ);
  if (r == 0) r = encode_bshd(&km, k, b, sk, hkv, hd, nk);
  if (r == 0) r = encode_bshd(&vm, v, b, sk, hkv, hd, nk);
  if (r != 0) return r;
  const TcAttnArgs a{out, b, sq, sk, hq, hkv, causal, (sq + BQ - 1) / BQ, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dt == DT_BF16;
  if (hd == 64) return bf16 ? launch_tc<64, true>(qm, km, vm, a, st) : launch_tc<64, false>(qm, km, vm, a, st);
  if (hd == 128) {
    return bf16 ? launch_tc<128, true>(qm, km, vm, a, st) : launch_tc<128, false>(qm, km, vm, a, st);
  }
  return bf16 ? launch_tc<256, true>(qm, km, vm, a, st) : launch_tc<256, false>(qm, km, vm, a, st);
}
