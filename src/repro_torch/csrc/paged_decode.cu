// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// paged_flash_decode_pallas (body _paged_decode_kernel): one query token per
// slot against the flat (n_pages * page_size, Hkv, hd) KV token pools,
// read through the slot's page table, with an online softmax across pages.
//
// Design, and what it does about this card:
//  - One block per (slot, KV head) computes all G query heads of that KV
//    head, so a KV page is read once for the whole GQA group and never
//    repeated per query head. The block loads its own page-table row and
//    the slot's position and active flag: Pallas' scalar prefetch becomes
//    plain loads inside the block.
//  - The block walks the slot's pages in position order and carries the
//    online-softmax state (m, l per head in shared memory, the output
//    accumulator in registers), where Pallas carried it in VMEM scratch
//    along its sequential page axis. Dead pages are skipped by the
//    reference's rules: NULL page-table entries, pages past the decode
//    position and pages wholly outside the sliding window. An inactive
//    slot writes exact zeros and reads nothing.
//  - Pages are dequantized (E4M3, E5M2, bf16, fp16 or fp32 storage) to
//    fp32 on the way into shared memory; all arithmetic is fp32, as in the
//    reference. Softcap and the window mask apply per score.
//  - What bounds it: the bytes of the live KV pages. With few slots the
//    grid is small (4 slots x 8 KV heads = 32 blocks on 132 SMs); a
//    split-K flash-decoding pass with a combine step is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_G = 16;   // query heads per KV head
constexpr int MAX_DPT = 2;  // head dims per thread: hd <= 256
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // as the reference

struct DecodeArgs {
  const void* q;
  void* out;
  const void* kp;
  const void* vp;
  const int* page_table;
  const int* seq_lens;
  const int* active;
  int q_dt, kv_dt;
  int hkv, g, hd, pages, page_size, window;  // window <= 0: none
  float softcap, scale;                       // softcap <= 0: none
};

__global__ void __launch_bounds__(THREADS) paged_decode_kernel(const DecodeArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                       // (g, hd)
  float* ks = qs + a.g * a.hd;            // (page_size, hd)
  float* vs = ks + a.page_size * a.hd;    // (page_size, hd)
  float* ss = vs + a.page_size * a.hd;    // (g, page_size) scores, then probs
  __shared__ float m_s[MAX_G], l_s[MAX_G], alpha_s[MAX_G];

  const int slot = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long long qbase = ((long long)slot * a.hkv + h) * a.g * a.hd;

  if (a.active[slot] == 0) {
    for (int e = tid; e < a.g * a.hd; e += THREADS) store_from_float(a.out, qbase + e, a.q_dt, 0.0f);
    return;
  }
  const int q_len = a.seq_lens[slot];
  for (int e = tid; e < a.g * a.hd; e += THREADS) qs[e] = load_as_float(a.q, qbase + e, a.q_dt);
  if (tid < a.g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[MAX_G][MAX_DPT];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
#pragma unroll
    for (int j = 0; j < MAX_DPT; ++j) acc[gi][j] = 0.0f;
  }
  __syncthreads();

  const int* row = a.page_table + (long long)slot * a.pages;
  for (int lp = 0; lp < a.pages; ++lp) {
    const int page = row[lp];
    const int base = lp * a.page_size;
    bool live = page != 0 && base <= q_len;
    if (a.window > 0) live = live && (base + a.page_size - 1 > q_len - a.window);
    if (!live) continue;  // uniform across the block

    for (int e = tid; e < a.page_size * a.hd; e += THREADS) {
      const int t = e / a.hd, d = e % a.hd;
      const long long idx = (((long long)page * a.page_size + t) * a.hkv + h) * a.hd + d;
      ks[e] = load_as_float(a.kp, idx, a.kv_dt);
      vs[e] = load_as_float(a.vp, idx, a.kv_dt);
    }
    __syncthreads();

    // Scores: one warp per (head, token) dot product over hd.
    for (int r = warp; r < a.g * a.page_size; r += THREADS / 32) {
      const int gi = r / a.page_size, t = r % a.page_size;
      float part = 0.0f;
      for (int d = lane; d < a.hd; d += 32) part += qs[gi * a.hd + d] * ks[t * a.hd + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        float s = part * a.scale;
        if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
        const int pos = base + t;
        bool ok = pos <= q_len;
        if (a.window > 0) ok = ok && pos > q_len - a.window;
        ss[r] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online-softmax statistics: one thread per query head.
    if (tid < a.g) {
      float* srow = ss + tid * a.page_size;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < a.page_size; ++t) m_new = fmaxf(m_new, srow[t]);
      float sum = 0.0f;
      for (int t = 0; t < a.page_size; ++t) {
        const float p = expf(srow[t] - m_new);
        srow[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, each thread owning head dims tid + 128 j.
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < a.g) {
#pragma unroll
        for (int j = 0; j < MAX_DPT; ++j) {
          const int d = tid + j * THREADS;
          if (d < a.hd) {
            float pv = 0.0f;
            for (int t = 0; t < a.page_size; ++t) pv += ss[gi * a.page_size + t] * vs[t * a.hd + d];
            acc[gi][j] = acc[gi][j] * alpha_s[gi] + pv;
          }
        }
      }
    }
    __syncthreads();  // the next page overwrites ks, vs and ss
  }

#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    if (gi < a.g) {
      const float inv_l = 1.0f / fmaxf(l_s[gi], 1e-30f);
#pragma unroll
      for (int j = 0; j < MAX_DPT; ++j) {
        const int d = tid + j * THREADS;
        if (d < a.hd) store_from_float(a.out, qbase + gi * a.hd + d, a.q_dt, acc[gi][j] * inv_l);
      }
    }
  }
}

}  // namespace

// q and out: contiguous (s, hkv, g, hd); pools: contiguous
// (n_pages * page_size, hkv, hd); page_table: contiguous (s, pages) int32;
// seq_lens, active: (s,) int32. Returns the cudaError_t of the launch.
extern "C" int paged_decode_launch(
    const void* q, int q_dt, const void* kp, const void* vp, int kv_dt,
    const int* page_table, const int* seq_lens, const int* active, void* out,
    int s, int hkv, int g, int hd, int pages, int page_size, int window,
    float softcap, float scale, void* stream) {
  if (g > MAX_G || hd > MAX_DPT * THREADS || s == 0) return cudaErrorInvalidValue;
  DecodeArgs a{q, out, kp, vp, page_table, seq_lens, active, q_dt, kv_dt,
               hkv, g, hd, pages, page_size, window, softcap, scale};
  const size_t smem = sizeof(float) * ((size_t)g * hd + 2 * (size_t)page_size * hd + (size_t)g * page_size);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_kernel<<<dim3(s, hkv), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
