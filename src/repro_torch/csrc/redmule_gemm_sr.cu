// The GEMM-Op kernel's small-row schedule for (mul, add) on fp8 operands,
// the SIMT schedule's split-K combine, and the K-major copy that the
// tensor-core and small-row schedules use for operands whose strides are
// not K-major. The schedules, their bounds and their numerics are
// described in the source note of redmule_gemm.cu; this file holds the
// kernels and their launchers.
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
// that every shape fills the card, and the split blocks of one 64-row
// output tile form one thread-block cluster (cluster dims (1, split, 1),
// at most SR_MAX_CLUSTER blocks): each block leaves its fp32 partial tile
// in its own shared memory, and after a cluster barrier each block takes a
// share of the tile's outputs, reads every split's partial of them through
// distributed shared memory and folds them in split order, adds Y, applies
// the output cast and stores Z. A second barrier keeps every block's shared
// memory alive until the others have read it. The fold adds in split
// order, as splitk_combine_kernel (the SIMT schedule's second launch) folds
// a workspace of partials, so a split gives the same bits either way; the
// small-row schedule needs no workspace and no second launch, and the
// decode step's GEMMs are one launch each, eager or in a captured graph.
//
// The K-major copy (kmajor_tile_kernel) turns a source whose unit-stride
// axis is the rows (the forward weight's N, the dW operands' columns) into
// rows of K. It is bound by its bytes: one read of the source, one write of
// the copy (twice the source's bytes when it widens fp8 to fp16). A block
// walks up to COPY_TILES_A_BLOCK consecutive COPY_TILE_K x COPY_TILE_BYTES
// tiles along K with COPY_STAGES in flight: 16-byte cp.async loads along
// the rows fill the next buffers while the current tile is transposed and
// stored. Shared memory holds
// the tile as 16-byte chunks under an XOR swizzle keyed by the K row's
// group of 8, so that the transposing reads (a warp: 8 groups of K rows x
// one chunk of rows) hit 32 different banks. A thread reads one 32-bit
// word of each of 8 (16 for bytes copied as they are) K rows, transposes
// 4 x 4 byte blocks with __byte_perm (2 x 2 blocks of 16-bit values),
// widens two fp8 values at a time with __nv_cvt_fp8x2_to_halfraw2, and
// stores 16 bytes along K. Sources whose rows are not 16-byte aligned
// (a row stride or base address off 16 bytes) and sources with no
// unit-stride axis take the element-wise kernel (kmajor_element_kernel);
// K-major sources with rows of whole 16-byte groups that only widen take
// kmajor_widen_rows_kernel.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SR_THREADS = 128;  // four warps, 16 weight rows each
constexpr int SR_BLOCK_N = 64;
constexpr int SR_MAX_M = 16;      // rows: one or two eight-row halves
constexpr int SR_STEP = 64;       // K bytes a warp covers per step
constexpr int SR_UNROLL = 4;      // steps whose loads are in flight together
constexpr int SR_CHUNK = 2048;    // K bytes of X staged in shared memory at once
constexpr int SR_XS = SR_CHUNK + 16;  // padded row of the staged X
constexpr int SR_MAX_CLUSTER = 16;    // K splits of one output tile: a cluster's blocks
constexpr int COPY_THREADS = 256;
constexpr int COPY_TILE_K = 128;      // K rows of a copy tile
constexpr int COPY_TILE_BYTES = 128;  // bytes of the rows' axis of a copy tile
constexpr int COPY_STAGES = 3;        // copy tiles in flight a block
constexpr int COPY_TILES_A_BLOCK = 2;  // consecutive K tiles a copy block walks, at most
constexpr int ELEM_TILE = 64;         // the element-wise copy's 64 x 64 tile

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
  void* z;            // contiguous (b1, b2, m, n)
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

// The K splits' fold of redmule_gemm_sr_kernel<..., FOLD>: the block's
// split is its rank in the cluster of the output tile's splits.
template <int NT>
__device__ __forceinline__ void fold_partials(const SrArgs& a, const float (&acc)[NT][4],
                                              uint8_t* xs, int split, int b1, int b2, int bz,
                                              int warp, int g, int t) {
  // The block's partial tile into its shared memory (over the staged X):
  // part[m][nl].
  float* part = reinterpret_cast<float*>(xs);
  __syncthreads();  // every warp is done with the staged X
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 8 * j + 2 * t + (i % 2), nl = warp * 16 + g + 8 * (i / 2);
      part[m * SR_BLOCK_N + nl] = acc[j][i];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial tile is in its block's shared memory
  // Each rank folds its share of the tile's outputs: all splits' partials
  // of an output loaded together out of the cluster's shared memory, then
  // added in split order (as splitk_combine_kernel did), then Y, then the
  // output cast; the stores run along N.
  const int outs = a.m * SR_BLOCK_N, per = (outs + a.split - 1) / a.split;
  const int nb = blockIdx.x * SR_BLOCK_N;
  for (int e = split * per + threadIdx.x; e < min(outs, (split + 1) * per); e += SR_THREADS) {
    const int m = e / SR_BLOCK_N, n = nb + e % SR_BLOCK_N;
    if (n >= a.n) continue;
    float p[SR_MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < SR_MAX_CLUSTER; ++s) {
      if (s < a.split) p[s] = cluster.map_shared_rank(part, s)[e];
    }
    float v = p[0];
#pragma unroll
    for (int s = 1; s < SR_MAX_CLUSTER; ++s) {
      if (s < a.split) v = __fadd_rn(v, p[s]);
    }
    if (a.y != nullptr) {
      v = __fadd_rn(load_as_float(a.y, b1 * a.sy1 + b2 * a.sy2 + m * a.sym + n * a.syn, a.y_dt),
                    v);
    }
    store_from_float(a.z, ((long long)bz * a.m + m) * a.n + n, a.z_dt, v);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// With FOLD, launched as clusters of (1, split, 1) blocks: blockIdx.y is
// the split and the block's rank in its cluster. Without (split 1), each
// block stores its own outputs.
template <int WK, int XK, int NT, bool FOLD>
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
  if constexpr (!FOLD) {  // K whole in this block: Y and the output cast straight away
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 8 * j + 2 * t + (i % 2), n = n0 + g + 8 * (i / 2);
        if (m >= a.m || n >= a.n) continue;
        float v = acc[j][i];
        if (a.y != nullptr) {
          v = __fadd_rn(load_as_float(a.y, b1 * a.sy1 + b2 * a.sy2 + m * a.sym + n * a.syn,
                                      a.y_dt), v);
        }
        store_from_float(a.z, ((long long)bz * a.m + m) * a.n + n, a.z_dt, v);
      }
    }
  } else {
    fold_partials(a, acc, xs, split, b1, b2, bz, warp, g, t);
  }
}

// Z = star(Y, star of the split partials), folded in split order: the SIMT
// (mul, add) splits' sum, min or max of the SIMT semiring splits (NaN
// propagating, -0 below +0; any order gives their bits).
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem),
                  "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// w[i] holds K row i's four bytes of four rows; afterwards w[j] holds row
// j's four bytes of the four K rows, the first K row lowest.
__device__ __forceinline__ void transpose4x4(uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                             uint32_t& w3) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140), b = __byte_perm(w0, w1, 0x7362);
  const uint32_t c = __byte_perm(w2, w3, 0x5140), d = __byte_perm(w2, w3, 0x7362);
  w0 = __byte_perm(a, c, 0x5410);
  w1 = __byte_perm(a, c, 0x7632);
  w2 = __byte_perm(b, d, 0x5410);
  w3 = __byte_perm(b, d, 0x7632);
}

template <int KIND>
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(two & 0xFFFF), KIND == K_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// dst (b1, b2, rows, kp) contiguous = src (b1, b2, rows, k) with the rows'
// axis of unit stride, K rows sk elements apart, every K row 16-byte
// aligned; zeros in [k, kp). ES is the element's bytes; with WIDEN (an fp8
// kind) each fp8 byte becomes its fp16 value, exactly. Tiles are numbered
// K tile fastest, then strip of COPY_TILE_BYTES of rows, then batch; a
// block takes ``per_block`` consecutive ones.
template <int ES, int WIDEN>
__global__ void __launch_bounds__(COPY_THREADS)
kmajor_tile_kernel(const uint8_t* src, uint8_t* dst, int b2, int rows, int k, int kp,
                   long long s1, long long s2, long long sk, int k_tiles, int strips,
                   long long tiles, int per_block) {
  constexpr int KU = (ES == 1 && WIDEN < 0) ? 16 : 8;  // K rows a thread transposes
  constexpr int KG = COPY_TILE_K / KU;                  // groups of them a tile
  constexpr int WC = COPY_TILE_BYTES / 4;               // 4-byte columns a tile
  constexpr int LANE_KG = KU == 8 ? 8 : 4;  // K groups a warp covers (x 32 / LANE_KG columns)
  constexpr int OUT_ES = WIDEN >= 0 ? 2 : ES;
  constexpr int CHUNKS = COPY_TILE_BYTES / 16;
  constexpr int ROWS = 4 / ES;  // rows a 4-byte column holds
  __shared__ __align__(16) uint8_t tile[COPY_STAGES][COPY_TILE_K * COPY_TILE_BYTES];
  const long long row_bytes = (long long)rows * ES;
  const long long sk_bytes = sk * ES;
  const long long t_begin = (long long)blockIdx.x * per_block;
  const long long t_end = min(tiles, t_begin + per_block);

  struct Where { int bz, rb0, k0; };
  auto where = [&](long long t) {
    const long long r = t / k_tiles;
    return Where{(int)(r / strips), (int)(r % strips) * COPY_TILE_BYTES,
                 (int)(t % k_tiles) * COPY_TILE_K};
  };
  auto load = [&](long long t, uint8_t* buf) {
    const Where w = where(t);
    const uint8_t* s = src + ((w.bz / b2) * s1 + (w.bz % b2) * s2) * ES + w.rb0;
    for (int e = threadIdx.x; e < COPY_TILE_K * CHUNKS; e += COPY_THREADS) {
      const int kk = e / CHUNKS, c = e % CHUNKS;
      const long long left = row_bytes - w.rb0 - 16 * c;
      const int bytes = w.k0 + kk < k ? (int)max(0LL, min(16LL, left)) : 0;
      const uint8_t* from = bytes ? s + (long long)(w.k0 + kk) * sk_bytes + 16 * c : src;
      cp_async16(buf + kk * COPY_TILE_BYTES + 16 * (c ^ ((kk >> 3) & 7)), from, bytes);
    }
  };

  for (int st = 0; st < COPY_STAGES - 1; ++st) {
    if (t_begin + st < t_end) load(t_begin + st, tile[st]);
    cp_async_commit();
  }
  int i = 0;
  for (long long t = t_begin; t < t_end; ++t, ++i) {
    // The stage it refills was read before the barrier that ended the last step.
    const long long next = t + COPY_STAGES - 1;
    if (next < t_end) load(next, tile[(i + COPY_STAGES - 1) % COPY_STAGES]);
    cp_async_commit();
    cp_async_wait<COPY_STAGES - 1>();
    __syncthreads();
    const uint8_t* buf = tile[i % COPY_STAGES];
    const Where w = where(t);
    for (int u = threadIdx.x; u < KG * WC; u += COPY_THREADS) {
      // A warp: LANE_KG K groups x one 16-byte chunk of columns (or two).
      const int kg = u % LANE_KG + LANE_KG * (u / (LANE_KG * WC));
      const int wc = (u / LANE_KG) % WC;
      const int kx = w.k0 + KU * kg;
      const int r0 = w.rb0 / ES + ROWS * wc;
      if (kx >= kp || r0 >= rows) continue;
      uint32_t v[KU];
#pragma unroll
      for (int j = 0; j < KU; ++j) {
        const int kk = KU * kg + j;
        v[j] = *reinterpret_cast<const uint32_t*>(
            buf + kk * COPY_TILE_BYTES + 16 * ((wc >> 2) ^ ((kk >> 3) & 7)) + 4 * (wc & 3));
      }
      uint4 out[ROWS];
      if constexpr (ES == 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t sel = r ? 0x7632 : 0x5410;
          out[r] = make_uint4(__byte_perm(v[0], v[1], sel), __byte_perm(v[2], v[3], sel),
                              __byte_perm(v[4], v[5], sel), __byte_perm(v[6], v[7], sel));
        }
      } else {
#pragma unroll
        for (int q = 0; q < KU / 4; ++q) {
          transpose4x4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (WIDEN >= 0) {
            out[r] = make_uint4(widen2<WIDEN>(v[r]), widen2<WIDEN>(v[r] >> 16),
                                widen2<WIDEN>(v[4 + r]), widen2<WIDEN>(v[4 + r] >> 16));
          } else {
            out[r] = make_uint4(v[r], v[4 + r], v[8 + r], v[12 + r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r0 + r < rows) {
          *reinterpret_cast<uint4*>(dst + (((long long)w.bz * rows + r0 + r) * kp + kx) * OUT_ES) =
              out[r];
        }
      }
    }
    __syncthreads();
  }
}

// Blocks of kmajor_tile_kernel<ES, WIDEN> the card holds at once.
template <int ES, int WIDEN>
int copy_resident() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmajor_tile_kernel<ES, WIDEN>,
                                                  COPY_THREADS, 0);
    resident = std::max(1, sms * per_sm);
  }
  return resident;
}

// The element-wise K-major copy, for sources the tile kernel does not
// take: a 64 x 64 tile through shared memory, read along the source's
// unit-stride axis where it has one and written along K.
template <typename T, typename TO, int WIDEN>
__global__ void __launch_bounds__(COPY_THREADS)
kmajor_element_kernel(const T* src, TO* dst, int b2, int rows, int k, int kp, long long s1,
                      long long s2, long long sr, long long sk) {
  __shared__ T tile[ELEM_TILE][ELEM_TILE + 1];
  const int bz = blockIdx.z, b1 = bz / b2, bb2 = bz % b2;
  const int r0 = blockIdx.y * ELEM_TILE, k0 = blockIdx.x * ELEM_TILE;
  const T* s = src + b1 * s1 + bb2 * s2;
  const bool rows_fast = sr == 1 && sk != 1;
#pragma unroll
  for (int e = threadIdx.x; e < ELEM_TILE * ELEM_TILE; e += COPY_THREADS) {
    const int rr = rows_fast ? e % ELEM_TILE : e / ELEM_TILE;
    const int kk = rows_fast ? e / ELEM_TILE : e % ELEM_TILE;
    const int r = r0 + rr, kx = k0 + kk;
    tile[rr][kk] = (r < rows && kx < k) ? s[r * sr + kx * sk] : T(0);
  }
  __syncthreads();
  TO* d = dst + (long long)bz * rows * kp;
#pragma unroll
  for (int e = threadIdx.x; e < ELEM_TILE * ELEM_TILE; e += COPY_THREADS) {
    const int rr = e / ELEM_TILE, kk = e % ELEM_TILE;
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
  const int chunks = k / 16;
  const long long e = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (e >= (long long)rows * chunks) return;
  const int bz = blockIdx.z, b1 = bz / b2, bb2 = bz % b2;
  const int r = (int)(e / chunks), c = (int)(e % chunks);
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + b1 * s1 + bb2 * s2 + r * sr + 16 * c));
  uint4* d = reinterpret_cast<uint4*>(dst + ((long long)bz * rows + r) * kp + 16 * c);
  d[0] = make_uint4(widen2<WIDEN>(v.x), widen2<WIDEN>(v.x >> 16), widen2<WIDEN>(v.y),
                    widen2<WIDEN>(v.y >> 16));
  d[1] = make_uint4(widen2<WIDEN>(v.z), widen2<WIDEN>(v.z >> 16), widen2<WIDEN>(v.w),
                    widen2<WIDEN>(v.w >> 16));
}

template <int WK, int XK, int NT>
cudaError_t launch_sr(const SrArgs& a, dim3 grid, cudaStream_t st) {
  if (a.split == 1) {  // no fold: a plain launch
    redmule_gemm_sr_kernel<WK, XK, NT, false><<<grid, SR_THREADS, 0, st>>>(a);
    return cudaGetLastError();
  }
  auto* kernel = redmule_gemm_sr_kernel<WK, XK, NT, true>;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.split;
  attr[0].val.clusterDim.z = 1;
  // A cluster's blocks on as many SMs as they can take, so that every SM
  // streams weight bytes.
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(SR_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int WK, int XK>
cudaError_t launch_sr(const SrArgs& a, dim3 grid, cudaStream_t st) {
  return a.m <= 8 ? launch_sr<WK, XK, 1>(a, grid, st) : launch_sr<WK, XK, 2>(a, grid, st);
}

}  // namespace

// Small-row schedule. x: (b1, b2, m, k) fp8, any strides; w: the K x N
// operand K-major, row n at n * swn; m <= 16; split <= SR_MAX_CLUSTER, the
// split blocks of an output tile one cluster. A cluster launch the card
// refuses returns its error.
extern "C" int redmule_gemm_sr_launch(
    int x_kind, int w_kind, const void* x, const void* w, const void* y, int y_dt,
    void* z, int z_dt, int b1, int b2, int m, int n, int k, int split,
    int k_per_split, int x_vec,
    long long sx1, long long sx2, long long sxm, long long sxk,
    long long sw1, long long sw2, long long swn,
    long long sy1, long long sy2, long long sym, long long syn, void* stream) {
  if (m < 1 || m > SR_MAX_M || split < 1 || split > SR_MAX_CLUSTER ||
      k_per_split % SR_STEP != 0 || swn % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  SrArgs a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), y, z,
           y_dt, z_dt, b2, m, n, k, split, k_per_split, x_vec,
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

// How many clusters of ``cluster`` small-row blocks (m rows) the card can
// hold at once (cudaOccupancyMaxActiveClusters); 0 where none fits.
extern "C" int redmule_gemm_sr_max_clusters(int m, int cluster, int* out) {
  auto* kernel = m <= 8 ? redmule_gemm_sr_kernel<K_E4M3, K_E4M3, 1, true>
                        : redmule_gemm_sr_kernel<K_E4M3, K_E4M3, 2, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster, 1);
  cfg.blockDim = dim3(SR_THREADS);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
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

// route: COPY_TILE, COPY_ROWS or COPY_ELEMENTS (redmule_gemm.py's copy_route
// names it from the same strides); a route whose conditions the call does
// not meet returns cudaErrorInvalidValue. widen: -1 copies the elements as
// they are; an fp8 kind (0 E4M3, 1 E5M2) writes each byte's fp16 value.
// kp counts output elements.
enum CopyRoute { COPY_TILE = 0, COPY_ROWS = 1, COPY_ELEMENTS = 2 };

extern "C" int kmajor_copy_launch(const void* src, void* dst, int elem_bytes, int widen, int route,
                                  int b1, int b2, int rows, int k, int kp, long long s1,
                                  long long s2, long long sr, long long sk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s8 = static_cast<const uint8_t*>(src);
  auto* d8 = static_cast<uint8_t*>(dst);
  const int es = elem_bytes;
  const bool src_aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                           (b1 == 1 || s1 * es % 16 == 0) && (b2 == 1 || s2 * es % 16 == 0);
  const bool fp8_widen = widen == K_E4M3 || widen == K_E5M2;
  if ((es != 1 && es != 2) || (widen >= 0 && (es != 1 || !fp8_widen))) return cudaErrorInvalidValue;
  if (route == COPY_TILE) {
    if (sr != 1 || (k > 1 && sk * es % 16 != 0) || !src_aligned) return cudaErrorInvalidValue;
    const int k_tiles = (kp + COPY_TILE_K - 1) / COPY_TILE_K;
    const int strips = (int)(((long long)rows * es + COPY_TILE_BYTES - 1) / COPY_TILE_BYTES);
    const long long tiles = (long long)k_tiles * strips * b1 * b2;
#define TILE_LAUNCH(ES, WIDEN)                                                                 \
  do {                                                                                         \
    /* Tiles a block: as many as keep one wave of resident blocks, up to */                  \
    /* COPY_TILES_A_BLOCK, so that small copies still spread over the card. */               \
    const int per_block = (int)std::max(1LL, std::min<long long>(                              \
        COPY_TILES_A_BLOCK, tiles / copy_resident<ES, WIDEN>()));                              \
    kmajor_tile_kernel<ES, WIDEN><<<(unsigned)((tiles + per_block - 1) / per_block),           \
                                    COPY_THREADS, 0, st>>>(s8, d8, b2, rows, k, kp, s1, s2,    \
                                                           sk, k_tiles, strips, tiles,         \
                                                           per_block);                         \
  } while (0)
    if (widen == K_E4M3) TILE_LAUNCH(1, K_E4M3);
    else if (widen == K_E5M2) TILE_LAUNCH(1, K_E5M2);
    else if (es == 1) TILE_LAUNCH(1, -1);
    else TILE_LAUNCH(2, -1);
#undef TILE_LAUNCH
  } else if (route == COPY_ROWS) {
    if (!fp8_widen || (k > 1 && sk != 1) || k % 16 != 0 || kp != k ||
        (rows > 1 && sr % 16 != 0) || !src_aligned) {
      return cudaErrorInvalidValue;
    }
    const dim3 g((unsigned)(((long long)rows * (k / 16) + COPY_THREADS - 1) / COPY_THREADS), 1,
                 b1 * b2);
    auto* d16 = static_cast<uint16_t*>(dst);
    if (widen == K_E4M3) {
      kmajor_widen_rows_kernel<K_E4M3><<<g, COPY_THREADS, 0, st>>>(s8, d16, b2, rows, k, kp,
                                                                     s1, s2, sr);
    } else {
      kmajor_widen_rows_kernel<K_E5M2><<<g, COPY_THREADS, 0, st>>>(s8, d16, b2, rows, k, kp,
                                                                     s1, s2, sr);
    }
  } else if (route == COPY_ELEMENTS) {
    const dim3 grid((kp + ELEM_TILE - 1) / ELEM_TILE, (rows + ELEM_TILE - 1) / ELEM_TILE, b1 * b2);
#define ELEM_ARGS b2, rows, k, kp, s1, s2, sr, sk
    if (widen == K_E4M3) {
      kmajor_element_kernel<uint8_t, uint16_t, K_E4M3><<<grid, COPY_THREADS, 0, st>>>(
          s8, static_cast<uint16_t*>(dst), ELEM_ARGS);
    } else if (widen == K_E5M2) {
      kmajor_element_kernel<uint8_t, uint16_t, K_E5M2><<<grid, COPY_THREADS, 0, st>>>(
          s8, static_cast<uint16_t*>(dst), ELEM_ARGS);
    } else if (es == 1) {
      kmajor_element_kernel<uint8_t, uint8_t, -1><<<grid, COPY_THREADS, 0, st>>>(
          s8, d8, ELEM_ARGS);
    } else {
      kmajor_element_kernel<uint16_t, uint16_t, -1><<<grid, COPY_THREADS, 0, st>>>(
          static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst), ELEM_ARGS);
    }
#undef ELEM_ARGS
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
