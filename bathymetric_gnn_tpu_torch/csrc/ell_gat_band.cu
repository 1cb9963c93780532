// Band part of the banded-ELL GAT layer (kernel E), for Hopper (sm_90a),
// CUDA C++, f32, forward only.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py::_kernel (the
// Pallas band kernel behind ell_gat_band_part_pallas, launched by
// _band_part_call). For destination i (band t = i / R) and head h:
//   ac     = xh @ acat                   ([a_src | a_dst] dots, acat
//                                          [HC, 2 * heads])
//   l_k    = LeakyReLU(a_src[src_k] + a_dst[i] + el[k, h, i]) for each
//            in-band slot k (src_k = (t + loc / R - 1) * R + loc % R);
//            slots with loc = -1 (dead or spilled) are left out
//   l_self = LeakyReLU(a_src[i] + a_dst[i] + el_self[h, i])   (if given)
//   m      = max(l_self or -1e4, max_k l_k)
//   denom  = max(sum_k exp(l_k - m) + exp(l_self - m), 1e-16)
//   y[i, h, :] = exp(l_self - m) xh[i, h, :] + sum_k exp(l_k - m) xh[src_k]
// y is left UNNORMALIZED: the spill fold (ops/ell_banded.py
// banded_gat_spill_pass_flat) adds the out-of-window edges and divides
// once by the joint denominator. Outputs y [N, HC], m and denom [N, heads].
//
// The TPU kernel keeps a 3R-row window of xh in VMEM per band and gathers
// by one-hot matmuls on the MXU, since the TPU has no fast gather. Hopper
// gathers rows directly, so this kernel reads each in-band source's row
// (from L2: Hilbert order keeps the window's rows close) and needs no
// window. Two kernels behind one C entry:
//   (1) the attention dots ac [N, 2 * heads] (ell_gat_banded.cuh);
//   (2) one warp per destination row: lanes own slots for the softmax
//       (the K x heads exponentials in the warp's slice of shared
//       memory), then output columns for the weighted gather-sum with
//       16-byte loads.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 65,536, K = 8, HC 256, 4 heads it must read xh (67.1 MB), el
// (8.4 MB), loc (2.1 MB), el_self and acat, and write y (67.1 MB) and the
// two statistics: ~146 MB, ~0.044 ms; its ~0.5 GFLOP take ~0.008 ms at the
// FP32 rate, so it is bound by bytes. This version reads xh twice (dots,
// then the gather) and each in-band neighbour row once more per slot.

#include "ell_gat_banded.cuh"

using namespace band;
using ellgat::Vec;

namespace {

// Floats of one warp's slice of shared memory: the exponentials [K,
// heads] and the self terms [heads]; the K sources (long long) of all
// warps follow all warps' floats.
__host__ __device__ inline int band_warp_floats(int k, int heads) {
  return (k + 1) * heads;
}

size_t band_smem(int wpb, int k, int heads) {
  size_t f = (size_t)wpb * band_warp_floats(k, heads) * sizeof(float);
  f = (f + 7) / 8 * 8;
  return f + (size_t)wpb * k * sizeof(long long);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
band_kernel(const float* __restrict__ xh, const float* __restrict__ ac,
            const int* __restrict__ loc, const float* __restrict__ el,
            const float* __restrict__ el_self, float* __restrict__ y,
            float* __restrict__ m_out, float* __restrict__ den_out,
            long long n, int k, int heads, int c, int r, float slope) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int per_warp = band_warp_floats(k, heads);
  float* e_s = smem + warp * per_warp;       // [K, heads]
  float* eself_s = e_s + k * heads;          // [heads]
  const size_t floats = ((size_t)wpb * per_warp * sizeof(float) + 7) / 8 * 8;
  long long* src_s =
      reinterpret_cast<long long*>(reinterpret_cast<char*>(smem) + floats) +
      warp * k;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // the whole warp leaves together
  const int hc = heads * c;
  load_sources(loc, i, n, k, r, lane, src_s);
  for (int h = 0; h < heads; ++h) {
    float den, es, ps;
    const float m = row_softmax<true>(ac, el, el_self, src_s, i, n, k, heads,
                                      h, slope, lane, e_s, nullptr, &den, &es,
                                      &ps);
    if (lane == 0) {
      eself_s[h] = es;
      m_out[i * heads + h] = m;
      den_out[i * heads + h] = den;
    }
  }
  __syncwarp();

  float* yrow = y + i * hc;
  for (int col = lane * VEC; col < hc; col += WARP * VEC) {
    const int h = col / c;
    float acc[VEC], v[VEC];
    const float ws = eself_s[h];
    Vec<VEC>::load(xh + i * hc + col, v);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = ws * v[q];
    for (int s = 0; s < k; ++s) {
      const long long j = src_s[s];
      if (j < 0) continue;
      const float w = e_s[s * heads + h];
      Vec<VEC>::load(xh + j * hc + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(w, v[q], acc[q]);
    }
    Vec<VEC>::store(yrow + col, acc);
  }
}

}  // namespace

// Kernel E. xh [n, heads * c] f32; acat [heads * c, 2 * heads] f32; loc
// [k, n] int32; el [k * heads, n] f32; el_self [heads, n] f32 or null (no
// self loop); ac [n, 2 * heads] f32 scratch; outputs y [n, heads * c], m
// and den [n, heads] f32. n must be a multiple of the band rows r. vec 4
// needs c % 4 == 0 and 16-byte aligned xh and y. Launches on `stream`;
// returns the CUDA error code of the launches (0 when both were accepted).
extern "C" int ell_gat_band(const void* xh, const void* acat, const void* loc,
                            const void* el, const void* el_self, void* ac,
                            void* y, void* m, void* den, long long n, int k,
                            int heads, int c, int r, float slope, int vec,
                            void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || (vec != 1 && vec != 4) || (vec == 4 && c % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int wpb = THREADS / WARP;
  const size_t smem = band_smem(wpb, k, heads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fxh = static_cast<const float*>(xh);
  cudaError_t err = launch_acat_dots(fxh, static_cast<const float*>(acat),
                                     static_cast<float*>(ac), n, heads * c,
                                     2 * heads, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + wpb - 1) / wpb);
  if (vec == 4)
    band_kernel<4><<<blocks, THREADS, smem, s>>>(
        fxh, static_cast<const float*>(ac), static_cast<const int*>(loc),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<float*>(y), static_cast<float*>(m),
        static_cast<float*>(den), n, k, heads, c, r, slope);
  else
    band_kernel<1><<<blocks, THREADS, smem, s>>>(
        fxh, static_cast<const float*>(ac), static_cast<const int*>(loc),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<float*>(y), static_cast<float*>(m),
        static_cast<float*>(den), n, k, heads, c, r, slope);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gat_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
