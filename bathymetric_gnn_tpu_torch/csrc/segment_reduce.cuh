// Sorted-segment row reduction (kernel F), shared by segment_reduce.cu
// (its generic entry) and ell_gat_bwd.cu (kernel C', whose source-side
// rows it forms and reduces in registers).
//
//   out[j, :] (+)= sum of rows(perm[s], :) for row_ptr[j] <= s < row_ptr[j+1]
//
// ``perm`` lists the slots in source-sorted order (a stable sort, so each
// segment keeps its slots in ascending order) and ``row_ptr`` [n + 1]
// bounds each output row's segment; dead slots sort past row_ptr[n] and
// are never read. One warp per output row: the lanes own columns (16-byte
// loads when VEC = 4) and walk the segment in order, so the sum is taken
// in a fixed order with no atomics and is the same from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gat_common.cuh"

namespace segred {

using ellgat::Vec;
using ellgat::WARP;

// Mode (a): the rows are those of ct [S, f].
struct RowsCT {
  const float* ct;
  long long f;

  template <int VEC>
  __device__ __forceinline__ void load(long long slot, int col,
                                       float* v) const {
    Vec<VEC>::load(ct + slot * f + col, v);
  }
};

// Mode (b), kernel C''s source side: the row of slot s = i * k + kk (the
// kk-th slot of destination i) is
//   alpha[s, h] * dy[i, h, :] + dl[s, h] * att_src[h, :]
// with h the head of the column: the message-path and attention-path
// cotangents of the gathered neighbour row, never written to memory.
struct RowsGAT {
  const float* alpha;    // [N * K, heads] dropped, normalized weights
  const float* dl;       // [N * K, heads] logit cotangents
  const float* dy;       // [N, HC] the layer's output cotangent
  const float* att_src;  // [HC]
  int k, heads, c;

  template <int VEC>
  __device__ __forceinline__ void load(long long slot, int col,
                                       float* v) const {
    const int h = col / c;
    const long long i = slot / k;
    const float a = alpha[slot * heads + h];
    const float d = dl[slot * heads + h];
    float g[VEC], t[VEC];
    Vec<VEC>::load(dy + i * (long long)heads * c + col, g);
    Vec<VEC>::load(att_src + col, t);
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = fmaf(a, g[q], d * t[q]);
  }
};

// One warp per output row j; ACCUM adds into out (mode (b) adds into C''s
// per-destination dxh), otherwise out is overwritten.
template <int VEC, bool ACCUM, class Rows>
__global__ void __launch_bounds__(ellgat::THREADS)
reduce_kernel(Rows rows, const int* __restrict__ perm,
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
    if (ACCUM) {
      Vec<VEC>::load(orow + col, acc);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    }
    for (int s = lo; s < hi; ++s) {
      rows.template load<VEC>(perm[s], col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] += v[q];
    }
    Vec<VEC>::store(orow + col, acc);
  }
}

template <bool ACCUM, class Rows>
inline cudaError_t launch_reduce(const Rows& rows, const int* perm,
                                 const int* row_ptr, float* out, long long n,
                                 int f, int vec, cudaStream_t s) {
  const int rows_per_block = ellgat::THREADS / WARP;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) /
                                     rows_per_block);
  if (vec == 4)
    reduce_kernel<4, ACCUM, Rows><<<blocks, ellgat::THREADS, 0, s>>>(
        rows, perm, row_ptr, out, n, f);
  else
    reduce_kernel<1, ACCUM, Rows><<<blocks, ellgat::THREADS, 0, s>>>(
        rows, perm, row_ptr, out, n, f);
  return cudaGetLastError();
}

}  // namespace segred
