// Row layout shared by the ELL-GAT backward kernels (ell_gat_bwd.cu, kernel
// C' and its source pass in segment_reduce.cuh; ell_gat_v2_bwd.cu, kernel
// D'): one warp owns one [HC] row at a time, each lane NV chunks of V
// consecutive columns, chunk j of lane l at column (j * 32 + l) * V. With
// V * sizeof(T) = 16 (4 floats, 8 bf16) a warp-wide load of a whole row,
// all heads at once, is one coalesced 16-byte access a lane per chunk row.
// V divides C, so a chunk never straddles two heads; the per-head dot
// products of a row are reduced among the lanes of each head only
// (head_sum).
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

// The lane's chunks of an HC row: first column and head of each, and
// which lie inside the row (the others are skipped: their values are 0).
template <int V, int NV>
struct Lanes {
  int col[NV];
  int head[NV];
  unsigned live;

  static_assert(NV <= 32, "live holds one bit a chunk");

  __device__ __forceinline__ void init(int lane, int hc, int c) {
    live = 0u;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      col[j] = (j * WARP + lane) * V;
      const bool in = col[j] < hc;
      head[j] = in ? col[j] / c : 0;
      live |= (in ? 1u : 0u) << j;
    }
  }
  __device__ __forceinline__ bool in(int j) const {
    return (live >> j) & 1u;
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

// Max / sum over the lanes that share lane % heads (heads divides 32):
// the per-head reductions when the lanes own (slot, head) pairs s * heads
// + h, every head at once. The same bits in every lane of a head.
__device__ __forceinline__ float pair_max(float v, int heads) {
  for (int o = WARP / 2; o >= heads; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float pair_sum(float v, int heads) {
  for (int o = WARP / 2; o >= heads; o >>= 1)
    v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The chunks a lane holds for an HC row at vector width V: the least of
// 1, 2, 4, 8, 16 that covers the row for the 16-byte widths (HC <= 2048 in
// f32, 4096 in bf16), of 8, 16, 32 for scalar columns (V = 1, the shapes
// the vector widths do not take: HC <= 1024); 0 when the row is wider.
// Past 8 chunks the rows no longer fit in registers and spill to local
// memory: those instances serve wide rows correctly, not fast.
inline int chunks_for(int hc, int v) {
  const int need = (hc + WARP * v - 1) / (WARP * v);
  for (int nv = v == 1 ? 8 : 1; nv <= (v == 1 ? 32 : 16); nv *= 2)
    if (need <= nv) return nv;
  return 0;
}

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
// type T. One warp per node. STAGED: a grid-stride loop, as many blocks as
// stay resident, acat staged once per block in shared memory, transposed,
// as f32; else one node a warp, acat read from global memory column by
// column (the form these kernels had before the staging, faster for narrow
// rows, see launch_mat_dots). The sums are taken in the order these
// kernels have always taken them: each lane an FMA chain over the columns
// lane, lane + 32, ..., then a xor tree over the warp; so both forms give
// the same bits, D and D' see the same logits, and decide LeakyReLU's kink
// alike. The M sums are reduced together.
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

// Rows at least this wide take the staged form of mat_dots_kernel. On the
// H100 the staging made D's and E's dots faster at HC 256 and slower at HC
// 64 (PERF.md); the widths between were not measured.
constexpr int STAGE_MIN_HC = 128;

// Launches mat_dots_kernel on stream s.
template <typename T>
inline cudaError_t launch_mat_dots(const T* xh, const T* acat, float* ac,
                                   long long n, int hc, int m_cols,
                                   cudaStream_t s) {
  if (m_cols > 16) return cudaErrorInvalidValue;
  const long long node_blocks =
      (n + ellgat::THREADS / WARP - 1) / (ellgat::THREADS / WARP);
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

}  // namespace rows
