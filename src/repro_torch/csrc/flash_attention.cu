// Dense flash attention for Hopper (sm_90a): online-softmax attention with
// a top-left causal mask, softcap, GQA and ragged sequence lengths.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py::flash_attention.
//
// Design, and what it does about this card:
//  - One block per (batch x query head, 64-row query tile); the K/V loop
//    runs inside the block in 32-key tiles. The (acc, m, l) state that
//    Pallas carried in VMEM scratch along its sequential kj grid axis lives
//    here in registers (acc: each of the 256 threads owns 4 rows x hd/16
//    head dims) and shared memory (m, l, alpha per row), since blocks on
//    this card run in no order and nothing carries between them.
//  - Layout is the entry point's own: q (B, Sq, Hq, hd), k/v (B, Sk, Hkv,
//    hd), read in place. The KV head of query head h is h / G, read
//    directly: the reference wrapper's jnp.repeat of the KV heads has no
//    counterpart, and the G query heads of one KV head read the same tiles
//    (the L2 cache serves the repeats).
//  - Causal tiles past the block's last live row are never loaded. Ragged
//    Sq and Sk are masked against the true lengths here, so the wrapper
//    pads nothing (the reference pads to block multiples).
//  - Numerics of the reference kernel: fp32 scores scaled by 1/sqrt(hd),
//    then softcap * tanh(s / softcap); masked scores are NEG_INF = -0.7 *
//    FLT_MAX, not -inf; p is rounded to v's format before the PV product;
//    the output is acc / max(l, 1e-30), cast to q's format. hd <= 256.
//  - What bounds it: the operations (4 * Sq * Sk * hd a head, halved by
//    the causal mask) against fp32 on the CUDA cores; at granite's shape
//    q/k/v/o are ~24 MB, far below that. This first kernel runs on the
//    CUDA cores; wgmma on fp16/bf16 tiles fed by TMA is later work,
//    recorded in PERF.md.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: rows ty + 16 i, keys tx + 16 j, dims tx + 16 j
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // as the reference

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int dt;  // storage code of q, k, v and out
  int b, sq, sk, hq, hkv, hd;
  int causal;
  float softcap, scale;  // softcap <= 0: none
};

size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)hd * (BQ + 1) + (size_t)hd * (BK + 1) + (size_t)BK * hd + BQ * (BK + 1) + 3 * BQ);
}

template <int DJ>  // head dims per thread: hd <= 16 * DJ
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(const AttnArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  float* qs = smem;                 // (hd, BQ + 1): d-major, padded against bank conflicts
  float* ks = qs + hd * (BQ + 1);   // (hd, BK + 1): d-major
  float* vs = ks + hd * (BK + 1);   // (BK, hd)
  float* ps = vs + BK * hd;         // (BQ, BK + 1): scores, then probabilities
  float* m_s = ps + BQ * (BK + 1);  // (BQ) running max
  float* l_s = m_s + BQ;            // (BQ) running sum
  float* alpha_s = l_s + BQ;        // (BQ) rescale of this tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bi = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_end = min(q0 + BQ, a.sq);  // one past the block's last live row

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int row = q0 + r;
    qs[d * (BQ + 1) + r] =
        row < a.sq ? load_as_float(a.q, (((long long)bi * a.sq + row) * a.hq + h) * hd + d, a.dt) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  bool dim_live[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dim_live[j] = tx + 16 * j < hd;
  __syncthreads();

  // Keys at or past q_end are masked for every row of a causal block.
  const int k_end = a.causal ? min(a.sk, q_end) : a.sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      const int key = k0 + t;
      float kv = 0.0f, vv = 0.0f;
      if (key < a.sk) {
        const long long idx = (((long long)bi * a.sk + key) * a.hkv + hk) * hd + d;
        kv = load_as_float(a.k, idx, a.dt);
        vv = load_as_float(a.v, idx, a.dt);
      }
      ks[d * (BK + 1) + t] = kv;
      vs[t * hd + d] = vv;
    }
    __syncthreads();

    // Scores: a 4 x 2 register tile per thread, summed over hd in fp32.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, t = tx + 16 * j;
        const int row = q0 + r, key = k0 + t;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = key < a.sk && row < a.sq;
        if (a.causal) ok = ok && key <= row;
        ps[r * (BK + 1) + t] = ok ? x : NEG_INF;
      }
    }
    __syncthreads();

    // Online-softmax statistics, one thread per row. l sums the fp32 p;
    // the PV product reads p rounded to v's format, as the reference does.
    if (tid < BQ) {
      float* prow = ps + tid * (BK + 1);
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < BK; ++t) m_new = fmaxf(m_new, prow[t]);
      float sum = 0.0f;
      for (int t = 0; t < BK; ++t) {
        const float p = expf(prow[t] - m_new);
        sum += p;
        prow[t] = round_to(p, a.dt);
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
    }
    for (int t = 0; t < BK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BK + 1) + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        if (dim_live[j]) {
          const float vv = vs[t * hd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row < a.sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      const long long base = (((long long)bi * a.sq + row) * a.hq + h) * hd;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        if (dim_live[j]) store_from_float(a.out, base + tx + 16 * j, a.dt, acc[i][j] / l);
      }
    }
  }
}

template <int DJ>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.hq);
  flash_attention_kernel<DJ><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q and out: contiguous (b, sq, hq, hd); k, v: contiguous (b, sk, hkv, hd),
// all in the storage format dt (fp32, fp16 or bf16); hq a multiple of hkv.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dt,
    int b, int sq, int sk, int hq, int hkv, int hd, int causal,
    float softcap, float scale, void* stream) {
  if (hd > 256 || hd < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || (long long)b * hq > 65535 ||
      (dt != DT_F32 && dt != DT_F16 && dt != DT_BF16)) {
    return cudaErrorInvalidValue;
  }
  AttnArgs a{q, k, v, out, dt, b, sq, sk, hq, hkv, hd, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<4>(a, st);
  if (hd <= 128) return launch<8>(a, st);
  return launch<16>(a, st);
}
