// Row layout shared by the ELL-GAT kernels (ell_gat_bwd.cu, kernel C' and
// its source pass in segment_reduce.cuh; ell_gat_v2_bwd.cu, kernel D';
// the forwards ell_gat_fwd.cu, kernel C, ell_gat_band.cu, kernel E, and
// ell_gat_v2_fwd.cu, kernel D, through FwdRow below): one warp owns one [HC] row at a time, each lane NV
// chunks of V consecutive columns, chunk j of lane l at column (j * 32 + l)
// * V. With V * sizeof(T) = 16 (4 floats, 8 bf16) a warp-wide load of a
// whole row, all heads at once, is one coalesced 16-byte access a lane per
// chunk row. V divides C, so a chunk never straddles two heads; the
// per-head dot products of a row are reduced among the lanes of each head
// only (head_sum).
#pragma once

#include <mutex>
#include <type_traits>
#include <vector>

#include "ell_gat_common.cuh"

namespace rows {

using ellgat::bf16;
using ellgat::FULL;
using ellgat::WARP;

// Slots whose rows a warp requests before its first reduction: their
// loads are in flight together. The destination passes keep a group's
// rows in registers; 4 lets them run at 128 registers a thread (16 warps
// an SM), which measured faster on the H100 than keeping all 8 rows of a
// k-NN node and reading none twice (see the kernels' headers).
constexpr int GROUP = 4;

// Blocks an SM should hold of the destination passes (128 threads) and
// the source passes (256 threads): the register budget each is built for.
constexpr int DST_MIN_BLOCKS = 4;
constexpr int SRC_MIN_BLOCKS = 4;

// V elements of an I/O stream of type T as loaded (raw), read as f32 by
// at(q) (q a compile-time index after unrolling).
template <typename T, int V>
struct Raw;

template <int V>
struct Raw<float, V> {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    ellgat::Vec<V>::load(p, v);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = 0.f;
  }
  __device__ __forceinline__ float at(int q) const { return v[q]; }
};

template <>
struct Raw<bf16, 8> {
  uint4 w;
  __device__ __forceinline__ void load(const bf16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  // a bf16 is the upper half of the f32 with the same value
  __device__ __forceinline__ float at(int q) const {
    const unsigned x = q < 2 ? w.x : q < 4 ? w.y : q < 6 ? w.z : w.w;
    return __uint_as_float((q & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};

template <>
struct Raw<bf16, 1> {
  unsigned short b;
  __device__ __forceinline__ void load(const bf16* p) {
    b = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void zero() { b = 0; }
  __device__ __forceinline__ float at(int) const {
    return __uint_as_float((unsigned)b << 16);
  }
};

// V f32 values stored as T (round to nearest for bf16).
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v);

template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store<float, 1>(float* p, const float* v) {
  p[0] = v[0];
}
template <>
__device__ __forceinline__ void store<float, 8>(float* p, const float* v) {
  store<float, 4>(p, v);
  store<float, 4>(p + 4, v + 4);
}
template <>
__device__ __forceinline__ void store<bf16, 8>(bf16* p, const float* v) {
  uint4 t;
  unsigned* u = reinterpret_cast<unsigned*>(&t);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    u[q] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = t;
}
template <>
__device__ __forceinline__ void store<bf16, 1>(bf16* p, const float* v) {
  p[0] = __float2bfloat16_rn(v[0]);
}

// The lane's chunks of an HC row, or of the column tile that starts at
// column col0: first column and head of each, and which lie inside the
// row (the others are skipped: their values are 0).
template <int V, int NV>
struct Lanes {
  int col[NV];
  int head[NV];
  unsigned live;

  static_assert(NV <= 32, "live holds one bit a chunk");

  __device__ __forceinline__ void init(int lane, int hc, int c,
                                       int col0 = 0) {
    live = 0u;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      col[j] = col0 + (j * WARP + lane) * V;
      const bool in = col[j] < hc;
      head[j] = in ? col[j] / c : 0;
      live |= (in ? 1u : 0u) << j;
    }
  }
  __device__ __forceinline__ bool in(int j) const {
    return (live >> j) & 1u;
  }
  // Chunk j is the first of its head in the tile that starts at col0:
  // one chunk a head present in the tile, the one lane that adds the
  // tile's per-head sum (head_sum's, the same in all the head's lanes) to
  // the head's total over the tiles.
  __device__ __forceinline__ bool first(int j, int c, int col0) const {
    return in(j) && (col[j] % c == 0 || col[j] == col0);
  }
};

// V f32 values at p (shared memory, 16-byte aligned when V > 1) added to
// v: 16-byte accesses, so a warp's consecutive chunks take no bank
// conflicts.
template <int V>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = p[q];
  }
}

template <int V>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = v[q];
  }
}

// The vector width of the row chunks of a call: 16-byte chunks (4
// floats, 8 bf16) when the caller's vec allows them (4: c % 4 == 0 and
// 16-byte aligned rows) and C is a multiple, else single columns.
inline int row_width(bool lowp, int vec, int c) {
  const int v = lowp ? 8 : 4;
  return (vec == 4 && c % v == 0) ? v : 1;
}

// Lanes per head within one chunk row when each head's chunks are the
// aligned groups of that many lanes (C / V a power of two <= 32), else 0:
// head_sum then takes one full-warp sum per head.
inline int head_lanes(int c, int v) {
  const int l = c / v;
  return (l >= 1 && l <= WARP && (l & (l - 1)) == 0) ? l : 0;
}

// Per-head sums over the warp of M sets of per-chunk partials: afterwards
// p[m][j] holds the sum of set m over all chunks of chunk j's head, the
// same bits in every lane (each butterfly step adds the same two values).
// seg = head_lanes(C, V): a xor tree inside each group of seg lanes;
// seg 0: per head, one warp sum of the lane's chunks of that head.
template <int M, int NV, int V>
__device__ __forceinline__ void head_sum(float (&p)[M][NV],
                                         const Lanes<V, NV>& ln, int seg,
                                         int heads) {
  if (seg > 0) {
    for (int o = seg >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          p[m][j] += __shfl_xor_sync(FULL, p[m][j], o);
    }
    return;
  }
  for (int h = 0; h < heads; ++h) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (ln.in(j) && ln.head[j] == h) t += p[m][j];
      t = ellgat::warp_sum(t);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (ln.in(j) && ln.head[j] == h) p[m][j] = t;
    }
  }
}

// The lane's chunks of the rows of slots s0 .. s0 + GROUP - 1 of one
// destination (src[s] its source, < 0 for a dead slot: 0; slots past K:
// 0), all requested before any is used.
template <typename T, int V, int NV, typename I>
__device__ __forceinline__ void load_group(Raw<T, V> (&r)[GROUP][NV],
                                           const T* __restrict__ x,
                                           const I* src, int s0, int k,
                                           int hc, const Lanes<V, NV>& ln) {
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    const int s = s0 + u;
    // the same in every lane
    const long long j = s < k ? (long long)src[s] : -1;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (j >= 0 && ln.in(q))
        r[u][q].load(x + j * hc + ln.col[q]);
      else
        r[u][q].zero();
    }
  }
}

// Max / sum over the lanes that share lane % heads (heads divides 32)
// within each aligned group of `width` lanes (a power of two >= heads; the
// whole warp by default): the per-head reductions when the lanes own
// (slot, head) pairs s * heads + h, every head at once. The same bits in
// every lane of a head.
__device__ __forceinline__ float pair_max(float v, int heads,
                                          int width = WARP) {
  for (int o = width / 2; o >= heads; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float pair_sum(float v, int heads,
                                          int width = WARP) {
  for (int o = width / 2; o >= heads; o >>= 1)
    v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The chunks a lane holds for an HC row at vector width V: the least of
// 1, 2, 4, 8, 16 that covers the row for the 16-byte widths (HC <= 2048 in
// f32, 4096 in bf16), of 8, 16, 32 for scalar columns (V = 1, the shapes
// the vector widths do not take: HC <= 1024); 0 when the row is wider
// (those rows run in column tiles, TILE_NV below). Past 8 chunks the rows no longer fit in registers and spill to local
// memory: those instances serve wide rows correctly, not fast.
inline int chunks_for(int hc, int v) {
  const int need = (hc + WARP * v - 1) / (WARP * v);
  for (int nv = v == 1 ? 8 : 1; nv <= (v == 1 ? 32 : 16); nv *= 2)
    if (need <= nv) return nv;
  return 0;
}

// Rows wider than chunks_for takes run in column tiles in the backward
// passes (C', D', F (b)): TILE_NV chunks a lane, a tile of 32 * TILE_NV *
// V columns, the tiles one after the other, so any HC runs. The rows that
// chunks_for takes keep their untiled instances and their sums' order.
constexpr int TILE_NV = 8;

inline bool row_tiled(int hc, int v) { return chunks_for(hc, v) == 0; }

// Calls f(std::integral_constant<int, NV>) with chunks_for(hc, V);
// returns f's result, or cudaErrorInvalidValue for a row wider than that.
template <int V, class F>
inline cudaError_t with_chunks(int hc, F&& f) {
  if constexpr (V == 1) {
    switch (chunks_for(hc, 1)) {
      case 8: return f(std::integral_constant<int, 8>{});
      case 16: return f(std::integral_constant<int, 16>{});
      case 32: return f(std::integral_constant<int, 32>{});
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (chunks_for(hc, V)) {
      case 1: return f(std::integral_constant<int, 1>{});
      case 2: return f(std::integral_constant<int, 2>{});
      case 4: return f(std::integral_constant<int, 4>{});
      case 8: return f(std::integral_constant<int, 8>{});
      case 16: return f(std::integral_constant<int, 16>{});
      default: return cudaErrorInvalidValue;
    }
  }
}

// Calls f(std::integral_constant<int, NV>, std::bool_constant<TILED>):
// the untiled instance of chunks_for(hc, V) chunks when it takes the row,
// else the tiled one of TILE_NV chunks a tile.
template <int V, class F>
inline cudaError_t with_row_form(int hc, F&& f) {
  if (row_tiled(hc, V))
    return f(std::integral_constant<int, TILE_NV>{}, std::true_type{});
  return with_chunks<V>(hc, [&](auto nv) { return f(nv, std::false_type{}); });
}

// Sets the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB; false when the card cannot give it.
template <typename K>
inline bool allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  if (bytes > 227 * 1024) return false;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

// Blocks of `threads` threads and `smem` bytes that run at once on the
// current card (one per resident slot: the grid-stride loops then split
// the rows evenly), at most `cap`, at least 1. The occupancy query costs
// tens of microseconds of host time, more than a small launch takes on
// the card, so its answer is kept per kernel, block shape and card.
template <typename K>
inline int resident_blocks(K kernel, int threads, size_t smem,
                           long long cap) {
  struct Seen {
    const void* kernel;
    int threads;
    size_t smem;
    int dev, blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  long long b = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Seen& e : seen)
      if (e.kernel == key && e.threads == threads && e.smem == smem &&
          e.dev == dev)
        b = e.blocks;
  }
  if (b == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    b = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    std::lock_guard<std::mutex> lock(mu);
    seen.push_back({key, threads, smem, dev, (int)b});
  }
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

// The attention dots of kernels D, D' and E: ac[i, m] = <xh[i, :],
// acat[:, m]> for the m < M = 2 * heads columns of a full acat [HC, M] of
// type T. The sums are taken in the order these kernels have always taken
// them: each lane an FMA chain over the columns lane, lane + 32, ... in
// ascending order, then a xor tree over the warp (offsets 16, 8, 4, 2, 1);
// so every form below gives the same bits, D and D' see the same logits,
// and decide LeakyReLU's kink alike (a logit there flips its branch with
// the summation order).
//
// mat_dots_kernel is the generic form (every HC and M <= 16): one warp per
// node. STAGED: a grid-stride loop, as many blocks as stay resident, acat
// staged once per block in shared memory, transposed, as f32; else one
// node a warp, acat read from global memory column by column (faster for
// narrow rows, see launch_mat_dots). Each product reads acat from shared
// or global memory, and the M sums take M separate xor trees.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(ellgat::THREADS)
mat_dots_kernel(const T* __restrict__ xh, const T* __restrict__ acat,
                float* __restrict__ ac, long long n, int hc, int m_cols) {
  constexpr int MAX_M = 16;
  extern __shared__ float acat_t[];   // [M, HC] when STAGED
  if constexpr (STAGED) {
    for (int j = threadIdx.x; j < hc * m_cols; j += blockDim.x) {
      const int col = j / m_cols, m = j - col * m_cols;
      acat_t[m * hc + col] = ellgat::ld(acat + j);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & (WARP - 1);
  const int wpb = blockDim.x / WARP;
  const long long total = (long long)gridDim.x * wpb;
  for (long long i = (long long)blockIdx.x * wpb + threadIdx.x / WARP; i < n;
       i += total) {
    const T* row = xh + i * hc;
    float p[MAX_M];
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) p[m] = 0.f;
    for (int col = lane; col < hc; col += WARP) {
      const float x = ellgat::ld(row + col);
      const T* a = acat + (long long)col * m_cols;
#pragma unroll
      for (int m = 0; m < MAX_M; ++m)
        if (m < m_cols)
          p[m] = fmaf(x, STAGED ? acat_t[m * hc + col] : ellgat::ld(a + m),
                      p[m]);
    }
    for (int o = WARP / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int m = 0; m < MAX_M; ++m)
        if (m < m_cols) p[m] += __shfl_xor_sync(FULL, p[m], o);
    }
    float mine = 0.f;   // lane m < M writes ac[i, m]
#pragma unroll
    for (int m = 0; m < MAX_M; ++m)
      if (m == lane) mine = p[m];
    if (lane < m_cols) ac[i * m_cols + lane] = mine;
  }
}

// The register form, for rows of HC <= 32 * CPL and M <= MM (CPL * MM <=
// 64 f32 registers a lane): each lane holds its columns lane + 32 t of
// acat, all M of them, as f32 in registers, loaded once per warp, so the
// inner loop is FMAs only. A grid-stride loop over nodes (as many blocks
// as stay resident), the rows of the next two nodes requested before the
// current node's FMAs and kept as loaded (a bf16 is widened where it is
// used: widened at the load, it stalled the warp there, and the bf16 form
// ran 2.6x slower than the f32 one on the H100). The M sums are reduced
// together by a reduce-scatter butterfly: at each of the first log2(MM)
// xor offsets (16, 8, ...) a lane keeps the half of its remaining sums
// that its lane bit selects and sends the other half to its partner,
// which adds it to the same sum; the rest of the offsets run a plain
// butterfly on the one sum left. Every level
// adds the same two partials as the generic form's xor trees (lane's own
// plus partner's), so the bits are the same; M = 8 takes 9 shuffles where
// M xor trees take 40. Afterwards lane l holds sum l >> (5 - log2(MM)).
template <typename T, int CPL, int MM>
__global__ void __launch_bounds__(ellgat::THREADS)
mat_dots_reg_kernel(const T* __restrict__ xh, const T* __restrict__ acat,
                    float* __restrict__ ac, long long n, int hc,
                    int m_cols) {
  static_assert(MM >= 2 && MM <= 16 && (MM & (MM - 1)) == 0, "MM");
  constexpr int LG = MM == 2 ? 1 : MM == 4 ? 2 : MM == 8 ? 3 : 4;
  const int lane = threadIdx.x & (WARP - 1);
  float a[CPL][MM];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int col = lane + WARP * t;
#pragma unroll
    for (int m = 0; m < MM; ++m)
      a[t][m] = col < hc && m < m_cols
                    ? ellgat::ld(acat + (long long)col * m_cols + m)
                    : 0.f;
  }
  const int wpb = blockDim.x / WARP;
  const long long total = (long long)gridDim.x * wpb;
  long long i = (long long)blockIdx.x * wpb + threadIdx.x / WARP;
  Raw<T, 1> x[CPL], x1[CPL];
  const auto load = [&](long long node, Raw<T, 1> (&v)[CPL]) {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int col = lane + WARP * t;
      if (node < n && col < hc)
        v[t].load(xh + node * hc + col);
      else
        v[t].zero();
    }
  };
  load(i, x);
  load(i + total, x1);
  for (; i < n; i += total) {
    Raw<T, 1> x2[CPL];
    load(i + 2 * total, x2);
    float p[MM];
#pragma unroll
    for (int m = 0; m < MM; ++m) p[m] = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (lane + WARP * t < hc) {
        const float xv = x[t].at(0);
#pragma unroll
        for (int m = 0; m < MM; ++m) p[m] = fmaf(xv, a[t][m], p[m]);
      }
    // reduce-scatter over the offsets 16, ..., 32 >> LG
#pragma unroll
    for (int lv = 0; lv < LG; ++lv) {
      const int o = (WARP / 2) >> lv;
      const int half = MM >> (lv + 1);
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = up ? p[j] : p[j + half];
        const float keep = up ? p[j + half] : p[j];
        p[j] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
#pragma unroll
    for (int o = (WARP / 2) >> LG; o > 0; o >>= 1)
      p[0] += __shfl_xor_sync(FULL, p[0], o);
    const int m = lane >> (5 - LG);
    if ((lane & ((WARP >> LG) - 1)) == 0 && m < m_cols)
      ac[i * m_cols + m] = p[0];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      x[t] = x1[t];
      x1[t] = x2[t];
    }
  }
}

// Rows at least this wide take the staged generic form. On the H100 the
// staging made D's and E's dots faster at HC 256 and slower at HC 64
// (PERF.md); the widths between were not measured.
constexpr int STAGE_MIN_HC = 128;

// The register form's columns a lane holds for a row of hc: 2, 4 or 8
// (HC <= 64, 128, 256), and the sums it holds for M: 2, 4, 8 or 16; 0 when
// the row or M is too wide for 64 registers of acat a lane.
inline int dots_cpl(int hc) {
  for (int cpl = 2; cpl <= 8; cpl *= 2)
    if (hc <= WARP * cpl) return cpl;
  return 0;
}
inline int dots_mm(int m_cols) {
  for (int mm = 2; mm <= 16; mm *= 2)
    if (m_cols <= mm) return mm;
  return 0;
}

// Launches the attention dots of kernels D, D' and E on stream s: the
// register form where it takes the row (generic false), else the generic
// form (staged at HC >= STAGE_MIN_HC), which gives the same bits.
template <typename T>
inline cudaError_t launch_mat_dots(const T* xh, const T* acat, float* ac,
                                   long long n, int hc, int m_cols,
                                   cudaStream_t s, bool generic = false) {
  if (m_cols < 1 || m_cols > 16) return cudaErrorInvalidValue;
  const long long node_blocks =
      (n + ellgat::THREADS / WARP - 1) / (ellgat::THREADS / WARP);
  const int cpl = dots_cpl(hc), mm = dots_mm(m_cols);
  if (!generic && cpl > 0 && cpl * mm <= 64) {
    const auto go = [&](auto kernel) {
      const int blocks =
          resident_blocks(kernel, ellgat::THREADS, 0, node_blocks);
      kernel<<<(unsigned)blocks, ellgat::THREADS, 0, s>>>(xh, acat, ac, n,
                                                         hc, m_cols);
      return cudaGetLastError();
    };
    const auto with_mm = [&](auto cpl_c) {
      constexpr int CPL = decltype(cpl_c)::value;
      switch (mm) {
        case 2: return go(mat_dots_reg_kernel<T, CPL, 2>);
        case 4: return go(mat_dots_reg_kernel<T, CPL, 4>);
        case 8: return go(mat_dots_reg_kernel<T, CPL, 8>);
        default:
          if constexpr (CPL * 16 <= 64)
            return go(mat_dots_reg_kernel<T, CPL, 16>);
          return cudaErrorInvalidValue;
      }
    };
    if (cpl == 2) return with_mm(std::integral_constant<int, 2>{});
    if (cpl == 4) return with_mm(std::integral_constant<int, 4>{});
    return with_mm(std::integral_constant<int, 8>{});
  }
  if (hc < STAGE_MIN_HC) {
    mat_dots_kernel<T, false><<<(unsigned)node_blocks, ellgat::THREADS, 0,
                                s>>>(xh, acat, ac, n, hc, m_cols);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)hc * m_cols * sizeof(float);
  auto* kernel = mat_dots_kernel<T, true>;
  if (!allow_smem(kernel, smem)) return cudaErrorInvalidValue;
  const int blocks =
      resident_blocks(kernel, ellgat::THREADS, smem, node_blocks);
  kernel<<<(unsigned)blocks, ellgat::THREADS, smem, s>>>(xh, acat, ac, n, hc,
                                                        m_cols);
  return cudaGetLastError();
}

// ---- the forward passes of kernels C, D and E -----------------------------
//
// One lane group of lpr lanes (a power of two) owns one destination at a
// time, each lane FWD_NV chunks of its row; a warp holds G = 32 / lpr of
// them. The nodes a warp has in flight hide each other's round trips to
// memory, which bound these passes (on the H100, one node a warp was
// slower at HC 64, most lanes idle). A group
// lists its destination's live slots densely (append_live: a dead slot
// costs no iteration and its row, NaN or not, is never read), takes the
// softmax over (entry, head) pairs inside the group (pair_softmax), then
// sums the weighted rows,
//   acc[col] = w_self[h] x[self, col] + sum_u w[u * hp + h] x[src[u], col]
// (h the head of col): the group's lanes own a column tile of lpr * FWD_NV
// chunks of V columns, chunk q of lane r at chunk (t * FWD_NV + q) * lpr +
// r of tile t; a row wider than a tile takes its tiles one after the other
// (no width limit). The self row and the first FWD_GROUP entries' rows are
// requested together, before the first FMA.

// Entries whose rows one lane group requests at once, and the chunks a
// lane holds of each.
constexpr int FWD_GROUP = 8;
constexpr int FWD_NV = 2;
// Warps a forward block holds at most, and the blocks an SM should hold:
// the register budget the forward kernels are built for (128 a thread).
constexpr int FWD_WARPS = 4;
constexpr int FWD_MIN_BLOCKS = 4;
// Shared memory a warp's node lists may take before its nodes fall back to
// one a warp (rows of a few channels with thousands of slots).
constexpr size_t FWD_WARP_LISTS = 8 * 1024;

// The lane geometry of a forward pass.
struct FwdGeom {
  int lg_lpr;   // log2 of the lanes per destination
  int tiles;    // column tiles of lpr * FWD_NV chunks
};

// The geometry of rows of hc columns in chunks of v, for nodes of hp pair
// lanes per slot whose lists take list_bytes each: the fewest lanes (a
// power of two, at least hp, at most 32) that hold a whole row at FWD_NV
// chunks a lane, or 32 when the lists of the 32 / lpr nodes a warp would
// hold exceed FWD_WARP_LISTS; and the tiles a row takes.
inline FwdGeom fwd_geom(int hc, int v, int hp, size_t list_bytes) {
  const int chunks = (hc + v - 1) / v;
  const int need = (chunks + FWD_NV - 1) / FWD_NV;
  FwdGeom g;
  g.lg_lpr = 0;
  while (g.lg_lpr < 5 && ((1 << g.lg_lpr) < need || (1 << g.lg_lpr) < hp))
    ++g.lg_lpr;
  if ((size_t)(WARP >> g.lg_lpr) * list_bytes > FWD_WARP_LISTS) g.lg_lpr = 5;
  const int tile = (1 << g.lg_lpr) * FWD_NV;
  g.tiles = (chunks + tile - 1) / tile;
  return g;
}

// The smallest power of two >= heads (1, 2, 4, 8): the (slot, head) pair
// stride of the forward softmaxes, so that a lane's head is lane % hp.
inline int pair_stride(int heads) {
  int hp = 1;
  while (hp < heads) hp *= 2;
  return hp;
}

// Appends the live slots of one chunk of lpr (lane r of the group holds
// slot s and its source j, j < 0 for a dead slot) to the group's dense
// lists src / slot after the nl entries already there: a ballot and a
// prefix count among the group's lanes. Returns the new count (the same in
// every lane of the group).
template <typename I>
__device__ __forceinline__ int append_live(I j, int s, int lane, int lg_lpr,
                                           int nl, I* src, int* slot) {
  const unsigned b = __ballot_sync(FULL, j >= 0);
  const int lpr = 1 << lg_lpr;
  const int lr = lane & (lpr - 1);
  const unsigned gb =
      lpr == WARP ? b : (b >> (lane - lr)) & ((1u << lpr) - 1u);
  if (j >= 0) {
    const int pos = nl + __popc(gb & ((1u << lr) - 1u));
    src[pos] = j;
    slot[pos] = s;
  }
  return nl + __popc(gb);
}

// The softmax statistics of one destination over its (entry, head) pairs,
// every head at once, in the destination's group of lpr = 1 << lg_lpr
// lanes: pair p < np = entries * hp belongs to the group's lane p % lpr
// (tile p / lpr) and head p % hp (hp a power of two >= heads, <= lpr;
// lanes of heads >= the real count pass hv false). l0 is the logit of the
// lane's pair of tile 0 (the caller loads its terms before the rows, so
// that both round trips overlap), logit(p) gives a later tile's; m enters
// as the lane's head's starting max (the self logit or a floor) and leaves
// as the head's max over all its pairs. Afterwards e0 = exp(l - m) of the
// lane's pair of tile 0 (0 when it has none), we[p] = exp(l - m) for the
// later tiles, and the head's sum of the exponentials over every pair is
// returned (each lane carries its tiles' max and sum; one xor tree among
// the group's lanes of a head reduces them).
template <class L>
__device__ __forceinline__ float pair_softmax(int np, int lg_hp, bool hv,
                                              int lr, int lg_lpr, float l0,
                                              L logit, float* we, float& m,
                                              float& e0) {
  const int lpr = 1 << lg_lpr;
  if (hv && lr < np) m = fmaxf(m, l0);
  for (int p = lr + lpr; p < np; p += lpr) {
    const float l = logit(p);
    we[p] = l;
    if (hv) m = fmaxf(m, l);
  }
  m = pair_max(m, 1 << lg_hp, lpr);
  float sum = 0.f;
  e0 = 0.f;
  if (hv && lr < np) {
    e0 = expf(l0 - m);
    sum = e0;
  }
  for (int p = lr + lpr; p < np; p += lpr)
    if (hv) {
      const float e = expf(we[p] - m);
      we[p] = e;
      sum += e;
    }
  return pair_sum(sum, 1 << lg_hp, lpr);
}

// A lane's part of one destination's gather.
template <typename T, int V>
struct FwdRow {
  static constexpr int NV = FWD_NV;
  Raw<T, V> xs[NV];               // the self row's chunks
  Raw<T, V> r[FWD_GROUP][NV];     // a group of entries' chunks
  int col[NV];
  int head[NV];
  unsigned live;                  // bit q: chunk q lies inside the row

  __device__ __forceinline__ bool in(int q) const {
    return (live >> q) & 1u;
  }
  // The lane's chunks of column tile t (lr its lane in the group).
  __device__ __forceinline__ void tile(int t, int lr, int lg_lpr, int hc,
                                       int c) {
    live = 0u;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      col[q] = (((t * NV + q) << lg_lpr) + lr) * V;
      const bool inside = col[q] < hc;
      head[q] = inside ? col[q] / c : 0;
      live |= (inside ? 1u : 0u) << q;
    }
  }
  // Requests the self row (when u0 is 0 and self >= 0) and the rows of the
  // entries u0 .. u0 + FWD_GROUP - 1 below nl.
  template <typename I>
  __device__ __forceinline__ void request(const T* __restrict__ xh,
                                          long long self, const I* src,
                                          int u0, int nl, int hc) {
    if (u0 == 0) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (self >= 0 && in(q))
          xs[q].load(xh + self * hc + col[q]);
        else
          xs[q].zero();
      }
    }
#pragma unroll
    for (int f = 0; f < FWD_GROUP; ++f) {
      const int u = u0 + f;
      const long long j = u < nl ? (long long)src[u] : -1;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (j >= 0 && in(q))
          r[f][q].load(xh + j * hc + col[q]);
        else
          r[f][q].zero();
      }
    }
  }
  // acc = ws[h] x_self + sum_u w[u * hp + h] x[src[u]] over the tile's
  // chunks (ws null: no self term), the entries in order. The first group
  // of rows (request with u0 = 0) must have been requested.
  template <typename I>
  __device__ __forceinline__ void sum(float (&acc)[NV][V],
                                      const T* __restrict__ xh, const I* src,
                                      const float* w, const float* ws, int nl,
                                      int hp, int hc) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float a = ws != nullptr ? ws[head[q]] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = a * xs[q].at(v);
    }
    for (int u0 = 0; u0 < nl; u0 += FWD_GROUP) {
      if (u0 > 0) request(xh, -1, src, u0, nl, hc);
#pragma unroll
      for (int f = 0; f < FWD_GROUP; ++f) {
        const int u = u0 + f;
        if (u < nl) {
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const float wv = w[u * hp + head[q]];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[q][v] = fmaf(wv, r[f][q].at(v), acc[q][v]);
          }
        }
      }
    }
  }
};

// Runs f(V) (as std::integral_constant) for the forward instance of a row:
// V = row_width(lowp, vec, c).
template <typename T, class F>
inline cudaError_t with_fwd_form(int vec, int c, F&& f) {
  constexpr int VW = sizeof(T) == 2 ? 8 : 4;
  if (row_width(sizeof(T) == 2, vec, c) == VW)
    return f(std::integral_constant<int, VW>{});
  return f(std::integral_constant<int, 1>{});
}

// ---- the attention dots of kernels C and C' -------------------------------

// dots[i, h] = <xh[i, h, :], att[0, h, :]>, dots[i, heads + h] = <xh[i, h,
// :], att[1, h, :]> (att [2, HC], xh and att of type T, dots f32) for at
// most MH heads of at most 32 * CPL channels: one node a warp, every
// head's loads of the node (its row, att's columns) requested before the
// first FMA, where ellgat::dots_kernel waits for one head's loads after
// another. Each lane's FMA chains run over the columns lane, lane + 32,
// ... of each head in order, and the 2 * heads sums take the same xor
// tree, as dots_kernel's: the same bits (a logit at LeakyReLU's kink flips
// its branch with the summation order). A grid-stride form with att in
// registers measured slower: fewer nodes in flight.
template <typename T, int CPL, int MH>
__global__ void __launch_bounds__(ellgat::THREADS)
node_dots_kernel(const T* __restrict__ xh, const T* __restrict__ att,
                 float* __restrict__ dots, long long n, int heads, int c) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long i =
      (long long)blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
  if (i >= n) return;   // the whole warp leaves together
  const int hc = heads * c;
  const T* row = xh + i * hc;
  float x[MH][CPL], as[MH][CPL], ad[MH][CPL];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int j = lane + WARP * t;
      const bool in = h < heads && j < c;
      x[h][t] = in ? ellgat::ld(row + h * c + j) : 0.f;
      as[h][t] = in ? ellgat::ld(att + h * c + j) : 0.f;
      ad[h][t] = in ? ellgat::ld(att + hc + h * c + j) : 0.f;
    }
  float s[MH], d[MH];
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    s[h] = 0.f;
    d[h] = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (lane + WARP * t < c) {
        s[h] = fmaf(x[h][t], as[h][t], s[h]);
        d[h] = fmaf(x[h][t], ad[h][t], d[h]);
      }
  }
  for (int o = WARP / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int h = 0; h < MH; ++h)
      if (h < heads) {
        s[h] += __shfl_xor_sync(FULL, s[h], o);
        d[h] += __shfl_xor_sync(FULL, d[h], o);
      }
  }
  float mine = 0.f;   // lane h < heads writes a_src, heads + h a_dst
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    if (h >= heads) continue;
    if (lane == h) mine = s[h];
    if (lane == heads + h) mine = d[h];
  }
  if (lane < 2 * heads) dots[i * 2 * heads + lane] = mine;
}

// Launches the attention dots of kernels C and C' on stream s:
// node_dots_kernel where a head has at most 64 channels (generic false),
// else ellgat::dots_kernel (the same bits).
template <typename T>
inline cudaError_t launch_node_dots(const T* xh, const T* att, float* dots,
                                    long long n, int heads, int c,
                                    cudaStream_t s, bool generic = false) {
  const unsigned blocks = (unsigned)(
      (n + ellgat::THREADS / WARP - 1) / (ellgat::THREADS / WARP));
  const auto go = [&](auto kernel) {
    kernel<<<blocks, ellgat::THREADS, 0, s>>>(xh, att, dots, n, heads, c);
    return cudaGetLastError();
  };
  if (generic || heads > 8 || c > 2 * WARP) return go(ellgat::dots_kernel<T>);
  const int mh = pair_stride(heads);
  if (c > WARP) {
    if (mh == 1) return go(node_dots_kernel<T, 2, 1>);
    if (mh <= 4) return go(node_dots_kernel<T, 2, 4>);
    return go(node_dots_kernel<T, 2, 8>);
  }
  if (mh == 1) return go(node_dots_kernel<T, 1, 1>);
  if (mh <= 4) return go(node_dots_kernel<T, 1, 4>);
  return go(node_dots_kernel<T, 1, 8>);
}

}  // namespace rows
