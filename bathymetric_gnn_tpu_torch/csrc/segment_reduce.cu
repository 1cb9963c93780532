// Sorted-segment row reduction (kernel F) for Hopper (sm_90a), CUDA C++:
// the backward of a row gather.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/segment_reduce.py::_reduce_kernel
// (segment_reduce_sorted), the Pallas TPU reducer that the JAX k-NN train
// step runs for the cotangent of its spill-row gather (ops/ell_banded.py
// gather_rows_reduce_bwd): out[j] = sum of ct[perm[s]] over the slots s of
// node j's segment, in sorted order, with no scatter-add.
//
// The TPU kernel turns each 1024-node block's contiguous cotangent range
// into one-hot matmuls on the MXU, with per-block first/jcount tables
// prefetched into the grid. Hopper reads rows directly, so a lane group
// sized to the row (one lane for the COO path's 1-4-wide rows, the whole
// warp for 256-wide ones) walks each output row's segment (row_ptr from a
// stable sort of the slots by source or destination: ops/ell.py
// src_sorted_slots, ops/graph.sorted_segments) and sums in registers
// (segment_reduce.cuh). Mode (b), its rows formed in registers from
// kernel C''s per-slot coefficients instead of read from ct, is the
// source-side half of kernel C' (ell_gat_bwd.cu), which starts each row
// from C''s destination side; segment_reduce_gat_rows runs it alone.
//
// The cotangent is read as float or bf16 (the bf16 model's spill-row
// gathers, whose cotangent JAX casts to the gathered table's dtype) and
// summed in f32; out is f32 (the caller casts it to the table's dtype, as
// JAX's gather backward does).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// it reads each live row of ct once, perm and row_ptr once, and writes out
// once, one add per element read: bound by bytes for wide rows. Segments
// are short (a k-NN source appears in ~K slots, a grid node in <= 8), so
// for narrow rows (1-64 columns) the chain of dependent loads row_ptr ->
// perm -> ct sets the time, not the bytes: mode (a) keeps up to 8 slots'
// row loads in flight a lane, 16 bytes each (scalar columns where a row
// is not 16-byte aligned), and fetches the next row's bounds ahead.

#include "segment_reduce.cuh"

// Mode (a). dtype: 0 = float32, 1 = bfloat16 (ct). ct [S, f]; perm
// [>= row_ptr[n]] int32; row_ptr [n + 1] int32; out [n, f] f32,
// overwritten. vec 4 needs f % 4 == 0 and 16-byte aligned ct and out
// (checked by the caller); bf16 rows take 16-byte chunks only when f % 8
// == 0 as well, else scalar columns. Launches on `stream`; returns the
// CUDA error code of the launch.
extern "C" int segment_reduce_sorted(int dtype, const void* ct,
                                     const void* perm, const void* row_ptr,
                                     void* out, long long n, int f, int vec,
                                     void* stream) {
  if (n < 1 || f < 1 || (vec != 1 && vec != 4) || (vec == 4 && f % 4 != 0) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)segred::launch_reduce(static_cast<const ellgat::bf16*>(ct),
                                      p, rp, o, n, f, vec, s);
  return (int)segred::launch_reduce(static_cast<const float*>(ct), p, rp, o,
                                    n, f, vec, s);
}

// Mode (b) on its own, the kernel of kernel C''s source side without the
// destination side C' adds first: out [n, heads * c] = for each source j
// the sum over its slots s of alpha[s, h] * dy[s / k, h, :] + dl[s, h] *
// att_src[h, :]. alpha, dl [n * k, heads] f32; dy [n, heads * c] f32;
// att_src [heads * c] f32; perm / row_ptr as mode (a); out overwritten.
// vec 4 (16-byte row chunks) needs c % 4 == 0 and 16-byte aligned dy,
// att_src and out; rows wider than heads * c 2048 (vec 4) or 1024 (vec 1)
// run in column tiles.
extern "C" int segment_reduce_gat_rows(const void* alpha, const void* dl,
                                       const void* dy, const void* att_src,
                                       const void* perm, const void* row_ptr,
                                       void* out, long long n, int k,
                                       int heads, int c, int vec,
                                       void* stream) {
  if (n < 1 || k < 1 || heads < 1 || c < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(alpha);
  const float* d = static_cast<const float*>(dl);
  const float* g = static_cast<const float*>(dy);
  const float* t = static_cast<const float*>(att_src);
  const int* p = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return (int)segred::launch_gat_src<float, 4, false, float>(
        a, d, g, t, nullptr, nullptr, p, rp, o, n, k, heads, c, s);
  return (int)segred::launch_gat_src<float, 1, false, float>(
      a, d, g, t, nullptr, nullptr, p, rp, o, n, k, heads, c, s);
}

extern "C" const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
