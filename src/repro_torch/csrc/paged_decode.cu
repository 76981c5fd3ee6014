// Paged flash-decode attention for Hopper (sm_90a), with the page walk
// split across blocks (flash-decoding).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// paged_flash_decode_pallas (body _paged_decode_kernel): one query token per
// slot against the flat (n_pages * page_size, Hkv, hd) KV token pools,
// read through the slot's page table, with an online softmax across pages.
//
// Design, and what it does about this card:
//  - The grid is (slot, KV head x head group, split). A block computes up
//    to four query heads of one KV head (a head group; G <= 4 is one group),
//    so a KV page is read once for the whole group. A split walks a
//    contiguous range of the slot's logical pages; the split count comes
//    from the wrapper's planner (decode_splits), from shapes alone, so
//    that the blocks fill the card when (slot, KV head) pairs are few.
//  - A block first lists the live pages of its range (warp ballots): NULL
//    entries, pages past the decode position and pages wholly outside the
//    sliding window are dropped by the reference's rules, and the rest are
//    walked in position order, several pages a step. Each step's K and V
//    rows (strided by Hkv * hd in the pools) come in by 16-byte cp.async
//    into one of two buffers while the block computes on the other.
//  - Scores: a thread takes one token and 16 head dims for the block's
//    four heads with q in registers, and the partial dots are summed over
//    the dims' lanes by a transposing shuffle reduction. The softmax is one
//    warp a head (max and sum by warp shuffles). PV: a thread owns 4 (or
//    8) head dims of the four heads over a share of the tokens; the shares
//    are summed in a fixed order at the end.
//  - All arithmetic is fp32 on the CUDA cores, as in the reference: pages
//    are widened exactly (E4M3/E5M2 by the paired conversion intrinsic,
//    bf16/fp16) to fp32. At four query rows a KV head the kernel is bound
//    by bytes and latency, not operations, and rounding p for the tensor
//    cores would change the reference's numbers.
//  - The combine stays in the same launch: each split writes an
//    unnormalised partial (m, l, acc) in fp32 to a scratch, and the last
//    split of a (slot, KV head, head group) to finish (a ticket from a
//    per-unit counter, after __threadfence) combines all partials in split
//    order (m = max m_i, l = sum l_i e^(m_i - m), acc likewise, out = acc /
//    max(l, 1e-30)) and resets the counter. So runs repeat bit for bit and
//    the decode step gains no launch. With one split the block writes the
//    output directly. A split with no live page contributes m = NEG_INF,
//    l = 0; an inactive slot writes exact zeros and reads nothing.
//  - What bounds it: the bytes of the live KV pages.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int GB = 4;  // query heads a block: one head group
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM: at most 128 registers a thread
constexpr int NB = 2;          // K/V buffers: step i + 1 loads while step i computes
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // as the reference

struct DecodeArgs {
  const void* q;
  void* out;
  const uint8_t* kp;
  const uint8_t* vp;
  const int* page_table;
  const int* seq_lens;
  const int* active;
  float* part_acc;  // (units, splits, GB, hd); null with one split
  float* part_ml;   // (units, splits, GB, 2)
  int* counters;    // (units,), zero between launches
  int q_dt, kv_dt;
  int hkv, g, groups, pages, page_size, window;  // window <= 0: none
  int splits, pages_per_split, pages_per_step;
  float softcap, scale;  // softcap <= 0: none
  // Byte offsets into dynamic shared memory (paged_decode_launch sets them).
  int off_ss, off_stat, off_live, off_kv, kv_buf_bytes;
};

// Head dims a thread takes in the score product, and its lanes per token.
template <int HD> __host__ __device__ constexpr int score_dims() { return HD < 16 ? HD : 16; }
// Head dims a thread owns in the PV product.
template <int HD> __host__ __device__ constexpr int pv_dims() { return HD / 32 > 4 ? HD / 32 : 4; }

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(dst), "l"(src), "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most NB - 1 groups are in flight: the oldest step has landed.
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(NB - 1) : "memory");
}

// N elements of storage size ES from shared memory, widened exactly to fp32.
template <int ES, int N>
__device__ __forceinline__ void load_widen(const uint8_t* p, float (&out)[N], int dt) {
  constexpr int W = N * ES / 4;  // 32-bit words
  uint32_t w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (ES == 1) {
      const __nv_fp8_interpretation_t kind = dt == DT_E4M3 ? __NV_E4M3 : __NV_E5M2;
      const __half2 lo(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] & 0xFFFF), kind));
      const __half2 hi(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w[i] >> 16), kind));
      const float2 a = __half22float2(lo), b = __half22float2(hi);
      out[4 * i] = a.x, out[4 * i + 1] = a.y, out[4 * i + 2] = b.x, out[4 * i + 3] = b.y;
    } else if constexpr (ES == 2) {
      if (dt == DT_BF16) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      } else {
        const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        out[2 * i] = a.x, out[2 * i + 1] = a.y;
      }
    } else {
      out[i] = __uint_as_float(w[i]);
    }
  }
}

template <int ES, int HD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) paged_decode_kernel(const DecodeArgs a) {
  constexpr int RB = HD * ES;                 // bytes of one token's row of one KV head
  constexpr int CH = RB < 16 ? RB : 16;       // bytes a cp.async
  constexpr int CPR = RB / CH;                // copies a row
  constexpr int DS = score_dims<HD>(), NS = HD / DS, TP = THREADS / NS;
  constexpr int VD = pv_dims<HD>(), DT = HD / VD, NTG = THREADS / DT;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);                 // (GB, hd), later the block's acc
  float* ss = reinterpret_cast<float*>(smem + a.off_ss);      // (tokens a step, GB)
  float* stat = reinterpret_cast<float*>(smem + a.off_stat);  // m (GB), l (GB), alpha (GB)
  int* ticket = reinterpret_cast<int*>(stat + 3 * GB);
  int* live_page = reinterpret_cast<int*>(smem + a.off_live);
  int* live_lp = live_page + a.pages_per_split;
  __shared__ int n_live_s;

  const int slot = blockIdx.x, gy = blockIdx.y, split = blockIdx.z;
  const int h = gy / a.groups, hg = gy % a.groups;
  const int unit = slot * a.hkv * a.groups + gy;
  const int g0 = hg * GB, gb = min(GB, a.g - g0);  // this block's heads: g0 .. g0 + gb - 1
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long qbase = ((long long)slot * a.hkv + h) * a.g * HD + (long long)g0 * HD;

  if (a.active[slot] == 0) {
    if (split == 0) {
      for (int e = tid; e < gb * HD; e += THREADS) store_from_float(a.out, qbase + e, a.q_dt, 0.0f);
    }
    return;
  }
  const int q_len = a.seq_lens[slot];
  for (int e = tid; e < GB * HD; e += THREADS) {
    qs[e] = e < gb * HD ? load_as_float(a.q, qbase + e, a.q_dt) : 0.0f;
  }
  if (tid < GB) stat[2 * GB + tid] = 1.0f;

  // The live pages of this split's range, in position order.
  const int p0 = split * a.pages_per_split, p1 = min(a.pages, p0 + a.pages_per_split);
  if (warp == 0) {
    const int* row = a.page_table + (long long)slot * a.pages;
    int n = 0;
    for (int first = p0; first < p1; first += 32) {
      const int lp = first + lane;
      int page = 0;
      bool live = false;
      if (lp < p1) {
        page = row[lp];
        const int base = lp * a.page_size;
        live = page != 0 && base <= q_len;
        if (a.window > 0) live = live && base + a.page_size - 1 > q_len - a.window;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = n + __popc(mask & ((1u << lane) - 1));
        live_page[at] = page;
        live_lp[at] = lp;
      }
      n += __popc(mask);
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_steps = (n_live + a.pages_per_step - 1) / a.pages_per_step;

  // Scores: token tid / NS of a pass, head dims (tid % NS) * DS on.
  const int sl = tid % NS;
  float qreg[GB][DS];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int k = 0; k < DS; ++k) qreg[gi][k] = qs[gi * HD + sl * DS + k];
  }
  // PV: head dims (tid % DT) * VD on, tokens tid / DT + NTG i.
  const int dc = tid % DT, tg = tid / DT;
  float acc[GB][VD];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int j = 0; j < VD; ++j) acc[gi][j] = 0.0f;
  }
  float m_run = NEG_INF, l_run = 0.0f;  // warp gi's head gi

  const uint32_t kv_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem + a.off_kv));
  auto k_buf = [&](int b) { return smem + a.off_kv + b * a.kv_buf_bytes; };
  auto v_buf = [&](int b) { return smem + a.off_kv + (NB + b) * a.kv_buf_bytes; };
  auto prefetch = [&](int step) {
    if (step >= n_steps) {
      cp_async_commit();  // an empty group keeps the waits uniform
      return;
    }
    const int b = step % NB, first = step * a.pages_per_step;
    const int n_here = min(a.pages_per_step, n_live - first);
    for (int c = tid; c < n_here * a.page_size * CPR; c += THREADS) {
      const int t = c / CPR, j = c % CPR;
      const int page = live_page[first + t / a.page_size], tok = t % a.page_size;
      const long long src = (((long long)page * a.page_size + tok) * a.hkv + h) * RB + j * CH;
      const uint32_t dst = t * RB + j * CH;
      cp_async<CH>(kv_s + b * a.kv_buf_bytes + dst, a.kp + src);
      cp_async<CH>(kv_s + (NB + b) * a.kv_buf_bytes + dst, a.vp + src);
    }
    cp_async_commit();
  };

  for (int step = 0; step < NB - 1; ++step) prefetch(step);
  for (int step = 0; step < n_steps; ++step) {
    __syncthreads();  // every thread is done with the buffer the next prefetch fills
    prefetch(step + NB - 1);
    cp_async_wait_step();
    __syncthreads();  // this step's rows have landed for every thread
    const int first = step * a.pages_per_step;
    const int n_tok = min(a.pages_per_step, n_live - first) * a.page_size;
    const uint8_t* kb = k_buf(step % NB);
    const uint8_t* vb = v_buf(step % NB);

    for (int pass = 0; pass * TP < n_tok; ++pass) {
      const int t = pass * TP + tid / NS;
      float part[GB] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t < n_tok) {
        float kf[DS];
        load_widen<ES, DS>(kb + t * RB + sl * DS * ES, kf, a.kv_dt);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
          for (int k = 0; k < DS; ++k) part[gi] = fmaf(qreg[gi][k], kf[k], part[gi]);
        }
      }
      // Sum the NS lanes of a token, transposing: after the first two
      // levels each lane holds one head's sum over four lanes.
      float hv[GB];
      int heads = GB, head0 = 0;  // lane holds heads head0 .. head0 + heads - 1 in hv
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) hv[gi] = part[gi];
      if constexpr (NS >= 2) {
        const bool b0 = sl & 1;
        const float r0 = __shfl_xor_sync(0xffffffffu, b0 ? part[0] : part[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, b0 ? part[1] : part[3], 1);
        hv[0] = (b0 ? part[2] : part[0]) + r0;
        hv[1] = (b0 ? part[3] : part[1]) + r1;
        heads = 2, head0 = b0 ? 2 : 0;
        if constexpr (NS >= 4) {
          const bool b1 = sl & 2;
          hv[0] = (b1 ? hv[1] : hv[0]) + __shfl_xor_sync(0xffffffffu, b1 ? hv[0] : hv[1], 2);
          heads = 1, head0 += b1 ? 1 : 0;
#pragma unroll
          for (int off = 4; off < NS; off *= 2) hv[0] += __shfl_xor_sync(0xffffffffu, hv[0], off);
        }
      }
      if (t < n_tok && sl < GB / heads) {
        const int lp = live_lp[first + t / a.page_size];
        const int pos = lp * a.page_size + t % a.page_size;
        bool ok = pos <= q_len;
        if (a.window > 0) ok = ok && pos > q_len - a.window;
#pragma unroll
        for (int i = 0; i < GB; ++i) {
          if (i < heads) {
            float x = hv[i] * a.scale;
            if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
            ss[t * GB + head0 + i] = ok ? x : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: warp gi for head gi.
    if (warp < gb) {
      float mx = NEG_INF;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, ss[t * GB + warp]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.0f;
      for (int t = lane; t < n_tok; t += 32) {
        const float p = expf(ss[t * GB + warp] - m_new);
        ss[t * GB + warp] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (lane == 0) stat[2 * GB + warp] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V over this thread's share of the tokens.
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      const float al = stat[2 * GB + gi];
#pragma unroll
      for (int j = 0; j < VD; ++j) acc[gi][j] *= al;
    }
    for (int t = tg; t < n_tok; t += NTG) {
      const float4 p4 = *reinterpret_cast<const float4*>(ss + t * GB);
      const float p[GB] = {p4.x, p4.y, p4.z, p4.w};
      float vf[VD];
      load_widen<ES, VD>(vb + t * RB + dc * VD * ES, vf, a.kv_dt);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
        for (int j = 0; j < VD; ++j) acc[gi][j] = fmaf(p[gi], vf[j], acc[gi][j]);
      }
    }
  }

  // The token shares summed in a fixed order into qs; m and l beside.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + a.off_kv);  // (NTG, GB, hd)
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int j = 0; j < VD; ++j) red[(tg * GB + gi) * HD + dc * VD + j] = acc[gi][j];
  }
  if (warp < gb && lane == 0) {
    stat[warp] = m_run;
    stat[GB + warp] = l_run;
  }
  __syncthreads();
  for (int e = tid; e < gb * HD; e += THREADS) {
    const int gi = e / HD, d = e % HD;
    float v = 0.0f;
    for (int i = 0; i < NTG; ++i) v += red[(i * GB + gi) * HD + d];
    qs[e] = v;
  }
  __syncthreads();

  if (a.splits == 1) {
    for (int e = tid; e < gb * HD; e += THREADS) {
      store_from_float(a.out, qbase + e, a.q_dt, qs[e] / fmaxf(stat[GB + e / HD], 1e-30f));
    }
    return;
  }
  const long long part = (long long)unit * a.splits + split;
  for (int e = tid; e < gb * HD; e += THREADS) a.part_acc[part * GB * HD + e] = qs[e];
  if (tid < gb) {
    a.part_ml[(part * GB + tid) * 2] = stat[tid];
    a.part_ml[(part * GB + tid) * 2 + 1] = stat[GB + tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(a.counters + unit, 1);
  __syncthreads();
  if (*ticket != a.splits - 1) return;

  // The last split of this unit: combine every split's partial in split order.
  __threadfence();
  const long long first_part = (long long)unit * a.splits;
  for (int e = tid; e < gb * HD; e += THREADS) {
    const int gi = e / HD;
    float m = NEG_INF;
    for (int i = 0; i < a.splits; ++i) m = fmaxf(m, __ldcg(a.part_ml + ((first_part + i) * GB + gi) * 2));
    float l = 0.0f, v = 0.0f;
    for (int i = 0; i < a.splits; ++i) {
      const float* ml = a.part_ml + ((first_part + i) * GB + gi) * 2;
      const float w = expf(__ldcg(ml) - m);
      l += __ldcg(ml + 1) * w;
      v += __ldcg(a.part_acc + (first_part + i) * GB * HD + e) * w;
    }
    store_from_float(a.out, qbase + e, a.q_dt, v / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.counters[unit] = 0;
}

template <int ES, int HD>
cudaError_t launch(DecodeArgs a, int s, cudaStream_t stream) {
  constexpr int RB = HD * ES;
  constexpr int NTG = THREADS / (HD / pv_dims<HD>());
  const int tokens = a.pages_per_step * a.page_size;
  auto up16 = [](int x) { return (x + 15) / 16 * 16; };
  a.off_ss = up16(GB * HD * 4);
  a.off_stat = a.off_ss + up16(tokens * GB * 4);
  a.off_live = a.off_stat + up16((3 * GB + 1) * 4);
  a.off_kv = a.off_live + up16(2 * a.pages_per_split * 4);
  a.kv_buf_bytes = up16(tokens * RB);
  const int kv_bytes = 2 * NB * a.kv_buf_bytes, red_bytes = NTG * GB * HD * 4;
  const size_t smem = a.off_kv + (kv_bytes > red_bytes ? kv_bytes : red_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<ES, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(s, a.hkv * a.groups, a.splits);
  paged_decode_kernel<ES, HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int ES>
cudaError_t launch_hd(const DecodeArgs& a, int hd, int s, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<ES, 8>(a, s, st);
    case 16: return launch<ES, 16>(a, s, st);
    case 32: return launch<ES, 32>(a, s, st);
    case 64: return launch<ES, 64>(a, s, st);
    case 128: return launch<ES, 128>(a, s, st);
    case 256: return launch<ES, 256>(a, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q and out: contiguous (s, hkv, g, hd); pools: contiguous
// (n_pages * page_size, hkv, hd); page_table: contiguous (s, pages) int32;
// seq_lens, active: (s,) int32. hd a power of two from 8 to 256. splits:
// blocks a (slot, KV head, head group), each walking pages_per_split
// logical pages, pages_per_step at a time; with more than one split,
// part_acc (units * splits * 4 * hd fp32), part_ml (units * splits * 8
// fp32) and counters (units int32, all zero) with units = s * hkv *
// ceil(g / 4). Returns the cudaError_t of the launch.
extern "C" int paged_decode_launch(
    const void* q, int q_dt, const void* kp, const void* vp, int kv_dt,
    const int* page_table, const int* seq_lens, const int* active, void* out,
    float* part_acc, float* part_ml, int* counters,
    int s, int hkv, int g, int hd, int pages, int page_size, int window,
    int splits, int pages_per_split, int pages_per_step,
    float softcap, float scale, void* stream) {
  if (s == 0 || g < 1 || splits < 1 || pages_per_split < 1 || pages_per_step < 1 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)) ||
      (long long)(splits - 1) * pages_per_split >= (pages > 0 ? pages : 1)) {
    return cudaErrorInvalidValue;
  }
  DecodeArgs a{q, out, static_cast<const uint8_t*>(kp), static_cast<const uint8_t*>(vp),
               page_table, seq_lens, active, part_acc, part_ml, counters, q_dt, kv_dt,
               hkv, g, (g + GB - 1) / GB, pages, page_size, window,
               splits, pages_per_split, pages_per_step, softcap, scale, 0, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dt) {
    case DT_E4M3:
    case DT_E5M2: return launch_hd<1>(a, hd, s, st);
    case DT_F16:
    case DT_BF16: return launch_hd<2>(a, hd, s, st);
    case DT_F32: return launch_hd<4>(a, hd, s, st);
    default: return cudaErrorInvalidValue;
  }
}
