// Sorted-segment row reduction (kernel F), shared by segment_reduce.cu
// (its entries) and ell_gat_bwd.cu (kernel C', whose source side is mode
// (b) with C''s destination side added first).
//
//   out[j, :] = sum of rows(perm[s], :) for row_ptr[j] <= s < row_ptr[j+1]
//
// ``perm`` lists the slots in source-sorted order (a stable sort, so each
// segment keeps its slots in ascending order) and ``row_ptr`` [n + 1]
// bounds each output row's segment; dead slots sort past row_ptr[n] and
// are never read. One warp per output row walks its segment in order, so
// the sum is taken in a fixed order with no atomics and is the same from
// run to run. Rows are read as float or bf16 and summed in f32; the output
// is written as float or bf16.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gat_common.cuh"
#include "ell_gat_rows.cuh"

namespace segred {

using ellgat::VecT;
using ellgat::WARP;
using ellgat::round_bf;

// Mode (a): the rows are those of ct [S, f] (float or bf16). One warp per
// output row; the lanes own columns (16-byte loads when VEC = 4, 8-byte
// for bf16 rows).
template <int VEC, typename T>
__global__ void __launch_bounds__(ellgat::THREADS)
reduce_kernel(const T* __restrict__ ct, const int* __restrict__ perm,
              const int* __restrict__ row_ptr, float* __restrict__ out,
              long long n, int f) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long j =
      (long long)blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
  if (j >= n) return;
  const int lo = row_ptr[j], hi = row_ptr[j + 1];
  float* orow = out + j * f;
  for (int col = lane * VEC; col < f; col += WARP * VEC) {
    float acc[VEC], v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    for (int s = lo; s < hi; ++s) {
      VecT<T, VEC>::load(ct + (long long)perm[s] * f + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] += v[q];
    }
    VecT<float, VEC>::store(orow + col, acc);
  }
}

template <typename T>
inline cudaError_t launch_reduce(const T* ct, const int* perm,
                                 const int* row_ptr, float* out, long long n,
                                 int f, int vec, cudaStream_t s) {
  const int rows_per_block = ellgat::THREADS / WARP;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) /
                                     rows_per_block);
  if (vec == 4)
    reduce_kernel<4, T><<<blocks, ellgat::THREADS, 0, s>>>(ct, perm, row_ptr,
                                                           out, n, f);
  else
    reduce_kernel<1, T><<<blocks, ellgat::THREADS, 0, s>>>(ct, perm, row_ptr,
                                                           out, n, f);
  return cudaGetLastError();
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
