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
// loads when VEC = 4, 8-byte for bf16 rows) and walk the segment in order,
// so the sum is taken in a fixed order with no atomics and is the same
// from run to run. Rows are read as float or bf16 and summed in f32; the
// output is written as float or bf16.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gat_common.cuh"

namespace segred {

using ellgat::VecT;
using ellgat::WARP;
using ellgat::round_bf;

// Mode (a): the rows are those of ct [S, f] (float or bf16).
template <typename T>
struct RowsCT {
  const T* ct;
  long long f;

  template <int VEC>
  __device__ __forceinline__ void load(long long slot, int col,
                                       float* v) const {
    VecT<T, VEC>::load(ct + slot * f + col, v);
  }
};

// Mode (b), kernel C''s source side: the row of slot s = i * k + kk (the
// kk-th slot of destination i) is
//   alpha[s, h] * dy[i, h, :] + dl[s, h] * att_src[h, :]
// with h the head of the column: the message-path and attention-path
// cotangents of the gathered neighbour row, never written to memory. In
// the bf16 form (inv given) alpha holds the unnormalized dropped weights
// e * d and the row is
//   alpha[s, h] * bf16(dy[i, h, :] * inv[i, h]) + bf16(dl[s, h] * att_src)
// with the two roundings where the JAX kernel's interpret mode rounds
// (its cast() of dy / D and of the attention-path cotangent).
template <typename T>
struct RowsGAT {
  const float* alpha;    // [N * K, heads] dropped weights (see above)
  const float* dl;       // [N * K, heads] logit cotangents
  const T* dy;           // [N, HC] the layer's output cotangent
  const T* att_src;      // [HC]
  const float* inv;      // [N, heads] 1 / D (bf16 form) or null
  int k, heads, c;

  template <int VEC>
  __device__ __forceinline__ void load(long long slot, int col,
                                       float* v) const {
    const int h = col / c;
    const long long i = slot / k;
    const float a = alpha[slot * heads + h];
    const float d = dl[slot * heads + h];
    float g[VEC], t[VEC];
    VecT<T, VEC>::load(dy + i * (long long)heads * c + col, g);
    VecT<T, VEC>::load(att_src + col, t);
    if (inv != nullptr) {
      const float iv = inv[i * heads + h];
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        v[q] = fmaf(a, round_bf(g[q] * iv), round_bf(d * t[q]));
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = fmaf(a, g[q], d * t[q]);
    }
  }
};

// One warp per output row j. ACCUM starts each row from acc_in [n, f] f32
// (mode (b) adds to C''s per-destination dxh; acc_in may be out itself),
// otherwise from 0. out [n, f] of type TO.
template <int VEC, bool ACCUM, class Rows, typename TO>
__global__ void __launch_bounds__(ellgat::THREADS)
reduce_kernel(Rows rows, const int* __restrict__ perm,
              const int* __restrict__ row_ptr, const float* acc_in, TO* out,
              long long n, int f) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long j =
      (long long)blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
  if (j >= n) return;
  const int lo = row_ptr[j], hi = row_ptr[j + 1];
  TO* orow = out + j * f;
  for (int col = lane * VEC; col < f; col += WARP * VEC) {
    float acc[VEC], v[VEC];
    if (ACCUM) {
      VecT<float, VEC>::load(acc_in + j * f + col, acc);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    }
    for (int s = lo; s < hi; ++s) {
      rows.template load<VEC>(perm[s], col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] += v[q];
    }
    VecT<TO, VEC>::store(orow + col, acc);
  }
}

template <bool ACCUM, class Rows, typename TO>
inline cudaError_t launch_reduce(const Rows& rows, const int* perm,
                                 const int* row_ptr, const float* acc_in,
                                 TO* out, long long n, int f, int vec,
                                 cudaStream_t s) {
  const int rows_per_block = ellgat::THREADS / WARP;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) /
                                     rows_per_block);
  if (vec == 4)
    reduce_kernel<4, ACCUM, Rows, TO><<<blocks, ellgat::THREADS, 0, s>>>(
        rows, perm, row_ptr, acc_in, out, n, f);
  else
    reduce_kernel<1, ACCUM, Rows, TO><<<blocks, ellgat::THREADS, 0, s>>>(
        rows, perm, row_ptr, acc_in, out, n, f);
  return cudaGetLastError();
}

}  // namespace segred
