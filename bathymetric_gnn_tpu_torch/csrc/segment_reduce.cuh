// Sorted-segment row reduction (kernel F), shared by segment_reduce.cu
// (its entries) and ell_gat_bwd.cu (kernel C', whose source side is mode
// (b) with C''s destination side added first).
//
//   out[j, :] = sum of rows(perm[s], :) for row_ptr[j] <= s < row_ptr[j+1]
//
// ``perm`` lists the slots in source-sorted order (a stable sort, so each
// segment keeps its slots in ascending order) and ``row_ptr`` [n + 1]
// bounds each output row's segment; dead slots sort past row_ptr[n] and
// are never read. Each output row's segment is walked in order by one
// lane group (mode a) or one warp (mode b), so the sum is taken in a fixed
// order with no atomics and is the same from run to run. Rows are read as
// float or bf16 and summed in f32; the output is written as float (mode
// a) or float or bf16 (mode b).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ell_gat_common.cuh"
#include "ell_gat_rows.cuh"

namespace segred {

using ellgat::WARP;
using ellgat::round_bf;

// Mode (a): the rows are those of ct [S, f] (float or bf16).
//
// A lane group of L lanes (a power of two) owns one output row, so a
// warp carries 32 / L rows: L is the fewest lanes that hold the row in
// V-wide chunks (V * sizeof(T) = 16 bytes: 4 floats, 8 bf16; V = 1 for
// scalar columns), NV chunks a lane (chunk u of sub-lane q at column
// (u * L + q) * V). The COO path's narrow rows ([E, 1], [E, 3], [E, 4])
// take one lane a row, 32 rows a warp; [E, 64] f32 16 lanes, two rows a
// warp; [E, 256] the whole warp, two chunks a lane. Rows wider than a
// lane group holds run in column tiles of L * NV * V columns, each a walk
// of the segment.
//
// What sets the time of a short segment is its chain of dependent loads,
// row_ptr -> perm -> ct, not its bytes. So the blocks of the narrower forms
// stay resident and walk the rows in a grid-stride loop (launch_sum_rows),
// the next row's bounds are fetched while the current row is summed, and
// G slots are taken at a time: the G perm entries are loaded together,
// then the G rows' chunks are all requested before the first is added.
// Each lane of a group loads the same perm entries itself (one
// transaction a warp), so lanes whose rows end early need no shuffle
// partner.
//
// The sum of each column starts from 0.f and takes one f32 add a slot in
// ascending slot order (no FMA, no atomics): the bits of the in-order sum
// (ops/cuda/segment_reduce.segment_reduce_in_order), the same in every
// form and from run to run.
template <typename T, int V, int L, int NV>
__global__ void __launch_bounds__(ellgat::THREADS)
sum_rows_kernel(const T* __restrict__ ct, const int* __restrict__ perm,
                const int* __restrict__ row_ptr, float* __restrict__ out,
                long long n, int f) {
  static_assert(L >= 1 && L <= WARP && (L & (L - 1)) == 0, "L: 1..32, 2^k");
  constexpr int R = WARP / L;   // rows a warp carries
  // slots in flight: their rows' chunks take <= 32 registers a lane (a
  // 16-byte bf16 chunk stays packed in 4), and a whole-warp row (the wide
  // forms, which run a row a warp) takes <= 4 (the bf16 rows measured 7 %
  // slower at 8, 70 registers a thread)
  constexpr int CHUNK_REGS = (sizeof(T) == 2 && V == 8) ? 4 : V;
  constexpr int G0 = 32 / (NV * CHUNK_REGS);
  constexpr int GM = L == WARP ? 4 : 8;
  constexpr int G = G0 < 1 ? 1 : (G0 > GM ? GM : G0);
  constexpr int TILE = L * NV * V;   // columns of a tile
  const int lane = threadIdx.x & (WARP - 1);
  const int sub = lane & (L - 1);
  const long long wpb = blockDim.x / WARP;
  const long long stride = (long long)gridDim.x * wpb * R;
  long long j = ((long long)blockIdx.x * wpb + threadIdx.x / WARP) * R +
                lane / L;
  int lo = 0, hi = 0;
  if (j < n) {
    lo = row_ptr[j];
    hi = row_ptr[j + 1];
  }
  for (; j < n; j += stride) {
    // the next row's bounds, requested before this row's loads
    const long long jn = j + stride;
    int nlo = 0, nhi = 0;
    if (jn < n) {
      nlo = row_ptr[jn];
      nhi = row_ptr[jn + 1];
    }
    float* orow = out + j * f;
    for (int col0 = 0; col0 < f; col0 += TILE) {
      int col[NV];
      bool in[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        col[u] = col0 + (u * L + sub) * V;
        in[u] = col[u] < f;
      }
      float acc[NV][V];
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[u][q] = 0.f;
      for (int base = lo; base < hi; base += G) {
        const int cnt = hi - base < G ? hi - base : G;
        long long src[G];
#pragma unroll
        for (int t = 0; t < G; ++t)
          src[t] = t < cnt ? (long long)perm[base + t] * f : 0;
        rows::Raw<T, V> r[G][NV];
#pragma unroll
        for (int t = 0; t < G; ++t)
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            if (t < cnt && in[u])
              r[t][u].load(ct + src[t] + col[u]);
            else
              r[t][u].zero();
          }
#pragma unroll
        for (int t = 0; t < G; ++t) {
          if (t < cnt) {
#pragma unroll
            for (int u = 0; u < NV; ++u)
#pragma unroll
              for (int q = 0; q < V; ++q) acc[u][q] += r[t][u].at(q);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if (in[u]) rows::store<float, V>(orow + col[u], acc[u]);
    }
    lo = nlo;
    hi = nhi;
  }
}

// Launches one form on stream s. The narrower forms take as many blocks
// as stay resident (at most one row a lane group), and their lane groups
// walk the rows in the grid-stride loop; the whole-warp forms (wide rows)
// take a block for every 8 rows, one row a warp, and leave the order of
// the blocks to the hardware's scheduler: with the grid-stride loop their
// rows took 1-2 % longer (route D's bf16 rows 7 %), the rows' uneven
// segments no longer balanced across the warps.
template <typename T, int V, int L, int NV>
inline cudaError_t launch_sum_rows(const T* ct, const int* perm,
                                   const int* row_ptr, float* out,
                                   long long n, int f, cudaStream_t s) {
  auto* kernel = sum_rows_kernel<T, V, L, NV>;
  const long long rows_per_block = (ellgat::THREADS / WARP) * (WARP / L);
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  if (need > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = L == WARP ? (int)need
                               : rows::resident_blocks(kernel,
                                                       ellgat::THREADS, 0,
                                                       need);
  kernel<<<(unsigned)blocks, ellgat::THREADS, 0, s>>>(ct, perm, row_ptr, out,
                                                       n, f);
  return cudaGetLastError();
}

// The form of a call at chunk width V: L the fewest lanes (a power of
// two) that hold the row's chunks at NV 1, up to 32 lanes; wider rows the
// whole warp at NV 2, in column tiles past 64 chunks. Scalar rows (V 1)
// of up to 8 columns take one lane, NV the next power of two of f.
template <typename T, int V>
inline cudaError_t launch_sum_rows_v(const T* ct, const int* perm,
                                     const int* row_ptr, float* out,
                                     long long n, int f, cudaStream_t s) {
  const auto go = [&](auto l, auto nv) {
    return launch_sum_rows<T, V, decltype(l)::value, decltype(nv)::value>(
        ct, perm, row_ptr, out, n, f, s);
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  const int chunks = (f + V - 1) / V;
  if constexpr (V == 1) {
    if (chunks <= 1) return go(I1{}, I1{});
    if (chunks <= 2) return go(I1{}, I2{});
    if (chunks <= 4) return go(I1{}, I4{});
    if (chunks <= 8) return go(I1{}, I8{});
  } else {
    if (chunks <= 1) return go(I1{}, I1{});
    if (chunks <= 2) return go(I2{}, I1{});
    if (chunks <= 4) return go(I4{}, I1{});
    if (chunks <= 8) return go(I8{}, I1{});
    if (chunks <= 16) return go(I16{}, I1{});
  }
  if (chunks <= 32) return go(I32{}, I1{});
  return go(I32{}, I2{});
}

// vec 4: 16-byte chunks (the caller checked f % 4 == 0 and ct's
// alignment; bf16 rows need f % 8 == 0 too), else scalar columns.
template <typename T>
inline cudaError_t launch_reduce(const T* ct, const int* perm,
                                 const int* row_ptr, float* out, long long n,
                                 int f, int vec, cudaStream_t s) {
  constexpr int V16 = sizeof(T) == 2 ? 8 : 4;
  if (vec == 4 && f % V16 == 0)
    return launch_sum_rows_v<T, V16>(ct, perm, row_ptr, out, n, f, s);
  return launch_sum_rows_v<T, 1>(ct, perm, row_ptr, out, n, f, s);
}

// Mode (b), kernel C''s source side: the row of slot s = i * k + kk (the
// kk-th slot of destination i) is
//   alpha[s, h] * dy[i, h, :] + dl[s, h] * att_src[h, :]
// with h the head of the column: the message-path and attention-path
// cotangents of the gathered neighbour row, never written to memory. In
// the bf16 form (T = bf16) alpha holds the unnormalized dropped weights
// e * d and the row is
//   alpha[s, h] * bf16(dy[i, h, :] * inv[i, h]) + bf16(dl[s, h] * att_src)
// with the two roundings where the JAX kernel's interpret mode rounds
// (its cast() of dy / D and of the attention-path cotangent).
//
// With DSIDE, row j starts from C''s destination side, formed here from
// the three scalars C' wrote per (node, head), dsc [n, 3, heads] =
// (a_self, dst_r, dls_r):
//   a_self * dy[j, h, :] + dst_r * att_dst[h, :] + dls_r * att_src[h, :]
// (the expression C' used to write as an f32 row). Otherwise from 0.
//
// One warp per output row j, as many blocks as stay resident, in a
// grid-stride loop; the lanes own the row in V-wide chunks (rows::Lanes)
// and hold their columns of att [2, HC] (att_src, att_dst; att_src only
// without DSIDE) in registers as f32. The segment's slot numbers are
// loaded 32 at a time, one per lane, and broadcast, so the dy rows of
// consecutive slots are requested together.
//
// TILED (rows wider than rows::chunks_for takes): the warp takes the row's
// column tiles of NV chunks a lane one after the other, each a walk of the
// segment, and reloads its columns of att per tile; each column's sum runs
// in the same order as untiled.
template <typename T, int V, int NV, bool DSIDE, typename TO, bool TILED>
__global__ void __launch_bounds__(ellgat::THREADS, rows::SRC_MIN_BLOCKS)
gat_src_kernel(const float* __restrict__ alpha, const float* __restrict__ dl,
               const T* __restrict__ dy, const T* __restrict__ att,
               const float* __restrict__ inv, const float* __restrict__ dsc,
               const int* __restrict__ perm, const int* __restrict__ row_ptr,
               TO* __restrict__ out, long long n, int k, int heads, int c) {
  constexpr bool LOWP = sizeof(T) == 2;
  const int hc = heads * c;
  const int lane = threadIdx.x & (WARP - 1);
  const int wpb = blockDim.x / WARP;
  constexpr int TILE = WARP * NV * V;   // columns of a tile
  const int tiles = TILED ? (hc + TILE - 1) / TILE : 1;
  rows::Lanes<V, NV> ln;
  // the lane's columns of att_src and att_dst, as f32, for every row (of
  // the tile, when tiled)
  float ts[NV][V], td[NV][V];
  const auto load_att = [&](int col0) {
    ln.init(lane, hc, c, col0);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      rows::Raw<T, V> a, b;
      if (ln.in(u)) {
        a.load(att + ln.col[u]);
        if (DSIDE)
          b.load(att + hc + ln.col[u]);
        else
          b.zero();
      } else {
        a.zero();
        b.zero();
      }
#pragma unroll
      for (int q = 0; q < V; ++q) {
        ts[u][q] = a.at(q);
        td[u][q] = b.at(q);
      }
    }
  };
  load_att(0);
  const long long total = (long long)gridDim.x * wpb;
  for (long long j = (long long)blockIdx.x * wpb + threadIdx.x / WARP; j < n;
       j += total) {
    for (int tile = 0; tile < tiles; ++tile) {
      if (TILED) load_att(tile * TILE);
      const int lo = row_ptr[j], hi = row_ptr[j + 1];
      float acc[NV][V];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
#pragma unroll
        for (int q = 0; q < V; ++q) acc[u][q] = 0.f;
        if (DSIDE && ln.in(u)) {
          const int h = ln.head[u], col = ln.col[u];
          const float* d = dsc + j * 3 * heads + h;
          const float a_self = d[0], dst_r = d[heads], dls_r = d[2 * heads];
          rows::Raw<T, V> g;
          g.load(dy + j * hc + col);
#pragma unroll
          for (int q = 0; q < V; ++q)
            acc[u][q] = fmaf(a_self, g.at(q),
                             fmaf(dst_r, td[u][q], dls_r * ts[u][q]));
        }
      }
      for (int base = lo; base < hi; base += WARP) {
        const int mine = base + lane < hi ? perm[base + lane] : 0;
        const int cnt = hi - base < WARP ? hi - base : WARP;
#pragma unroll 4
        for (int t = 0; t < cnt; ++t) {
          const long long slot = __shfl_sync(ellgat::FULL, mine, t);
          const long long i = slot / k;
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            if (!ln.in(u)) continue;
            const int h = ln.head[u], col = ln.col[u];
            const float a = alpha[slot * heads + h];
            const float d = dl[slot * heads + h];
            rows::Raw<T, V> g;
            g.load(dy + i * hc + col);
            if (LOWP) {
              const float iv = inv[i * heads + h];
#pragma unroll
              for (int q = 0; q < V; ++q)
                acc[u][q] += fmaf(a, round_bf(g.at(q) * iv),
                                  round_bf(d * ts[u][q]));
            } else {
#pragma unroll
              for (int q = 0; q < V; ++q)
                acc[u][q] += fmaf(a, g.at(q), d * ts[u][q]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if (ln.in(u)) rows::store<TO, V>(out + j * hc + ln.col[u], acc[u]);
    }
  }
}

// Launches gat_src_kernel for n rows at vector width V (4 or 8 for 16-byte
// chunks, 1 for scalar columns) on stream s, in column tiles when a row
// needs more chunks than the untiled instances hold.
template <typename T, int V, bool DSIDE, typename TO>
inline cudaError_t launch_gat_src(const float* alpha, const float* dl,
                                  const T* dy, const T* att, const float* inv,
                                  const float* dsc, const int* perm,
                                  const int* row_ptr, TO* out, long long n,
                                  int k, int heads, int c, cudaStream_t s) {
  const int rows_per_block = ellgat::THREADS / WARP;
  return rows::with_row_form<V>(heads * c, [&](auto nv, auto tiled) {
    constexpr int NV = decltype(nv)::value;
    auto* kernel =
        gat_src_kernel<T, V, NV, DSIDE, TO, decltype(tiled)::value>;
    const int blocks = rows::resident_blocks(
        kernel, ellgat::THREADS, 0, (n + rows_per_block - 1) / rows_per_block);
    kernel<<<(unsigned)blocks, ellgat::THREADS, 0, s>>>(
        alpha, dl, dy, att, inv, dsc, perm, row_ptr, out, n, k, heads, c);
    return cudaGetLastError();
  });
}

}  // namespace segred
