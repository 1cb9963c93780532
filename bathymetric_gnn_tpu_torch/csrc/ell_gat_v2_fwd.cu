// Fused banded-ELL GAT layer with the spill edges folded in (kernel D),
// forward, for Hopper (sm_90a), CUDA C++, f32.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py::_kernel_v2
// (launched by _run_fused_v2_forward behind ell_gat_fused_pallas, the
// layer of GATConvEllBanded(wide_kernel=False)). For destination i (band
// t = i / R, row r = i % R) and head h:
//   ac     = xh @ acat                      ([a_src | a_dst] dots)
//   l_k    = LeakyReLU(g_k + a_dst[i] + el[k, h, i]), g_k = a_src of the
//            slot's window source (0 for a slot with none: its el carries
//            NEG_BIG from band_ell's negmask_t, so exp flushes it to 0)
//   l_self = LeakyReLU(a_src[i] + a_dst[i] + el_self[h, i])   (if given)
//   m      = max(l_self or -1e4, max_k l_k)           (in-band max only)
//   D      = max(sum_k exp(l_k - m) + exp(l_self - m), 1e-16)
//   e_s    = exp(min(l_spill[t, h, s] - m, 60)) for band t's spill
//            entries s with dst_loc[t, s] = r (the 60-clamp against the
//            in-band max, as the TPU kernel)
//   out[i, h, :] = (d_self e_self xh[i] + sum_k d_k e_k xh[src_k]
//                   + sum_s d_s e_s xh_spill[t, s]) / (D + sum_s e_s)
// with the streamed dropout multipliers d (dmask [(K+1) * heads, N], the
// self loop at row K * heads + h; dmask_sp [T, heads, S]) applied to the
// weights and not to the denominator; d = 1 without dropout. The spill
// logits l_spill (LeakyReLU'd, -1e30 in dead entries) and the gathered
// spill rows xh_spill [T, S, HC] come from the caller (torch), as in the
// JAX entry.
//
// Design: as kernel E (ell_gat_band.cu), no window: (1) the attention dots;
// (2) one warp per destination row. The lanes own slots for the in-band
// softmax, then stride over the band's spill table (dst_loc, S entries,
// read from L1) for the spill denominator; then they own output columns,
// gather the in-band rows and, by a warp ballot over the spill table, the
// row's spill entries, and divide once by the joint denominator.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 262,144, K = 8, HC 256 it must read xh (268 MB), el (33.6 MB),
// loc (8.4 MB), the spill tables and write out (268 MB): ~0.58 GB, ~0.17
// ms; its ~2 GFLOP take ~0.03 ms at the FP32 rate: bound by bytes.

#include "ell_gat_banded.cuh"

using namespace band;
using ellgat::Vec;

namespace {

// Floats of one warp's slice of shared memory: the dropped weights [K,
// heads], then per head the dropped self weight, m and 1 / (D + sum e_s);
// the K sources (long long) of all warps follow all warps' floats.
__host__ __device__ inline int v2_warp_floats(int k, int heads) {
  return (k + 3) * heads;
}

size_t v2_smem(int wpb, int k, int heads) {
  size_t f = (size_t)wpb * v2_warp_floats(k, heads) * sizeof(float);
  f = (f + 7) / 8 * 8;
  return f + (size_t)wpb * k * sizeof(long long);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
v2_fwd_kernel(const float* __restrict__ xh, const float* __restrict__ ac,
              const int* __restrict__ loc, const float* __restrict__ el,
              const float* __restrict__ el_self,
              const float* __restrict__ l_spill,
              const float* __restrict__ xh_spill,
              const int* __restrict__ dst_loc, const float* __restrict__ dm,
              const float* __restrict__ dm_sp, float* __restrict__ out,
              long long n, int k, int heads, int c, int r, int s_max,
              float slope) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int per_warp = v2_warp_floats(k, heads);
  float* w_s = smem + warp * per_warp;       // [K, heads]
  float* wself_s = w_s + k * heads;          // [heads]
  float* m_s = wself_s + heads;              // [heads]
  float* inv_s = m_s + heads;                // [heads]
  const size_t floats = ((size_t)wpb * per_warp * sizeof(float) + 7) / 8 * 8;
  long long* src_s =
      reinterpret_cast<long long*>(reinterpret_cast<char*>(smem) + floats) +
      warp * k;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // the whole warp leaves together
  const int hc = heads * c;
  const long long t = i / r;
  const int row = (int)(i % r);
  load_sources(loc, i, n, k, r, lane, src_s);
  for (int h = 0; h < heads; ++h) {
    float den, es, ps;
    const float m = row_softmax<false>(ac, el, el_self, src_s, i, n, k,
                                       heads, h, slope, lane, w_s, nullptr,
                                       &den, &es, &ps);
    den += spill_denominator(l_spill, dst_loc, t, row, heads, h, s_max, m,
                             lane);
    if (dm != nullptr)
      for (int s = lane; s < k; s += WARP)
        w_s[s * heads + h] *= dm[((long long)s * heads + h) * n + i];
    if (lane == 0) {
      wself_s[h] =
          es * (dm != nullptr ? dm[((long long)k * heads + h) * n + i] : 1.f);
      m_s[h] = m;
      inv_s[h] = 1.f / den;
    }
  }
  __syncwarp();

  // every lane runs every column step (the spill ballots need the whole
  // warp); lanes past HC only vote
  float* orow = out + i * hc;
  for (int col0 = 0; col0 < hc; col0 += WARP * VEC) {
    const int col = col0 + lane * VEC;
    const bool active = col < hc;
    const int h = active ? col / c : 0;
    float acc[VEC], v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    if (active) {
      const float ws = wself_s[h];
      Vec<VEC>::load(xh + i * hc + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = ws * v[q];
      for (int s = 0; s < k; ++s) {
        const long long j = src_s[s];
        if (j < 0) continue;
        const float w = w_s[s * heads + h];
        Vec<VEC>::load(xh + j * hc + col, v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = fmaf(w, v[q], acc[q]);
      }
    }
    const float m = m_s[h];
    for (int base = 0; base < s_max; base += WARP) {
      unsigned bits = spill_ballot(dst_loc, t, row, s_max, base, lane);
      while (bits) {
        const int sp = base + __ffs(bits) - 1;
        bits &= bits - 1;
        if (!active) continue;
        const long long o = (t * heads + h) * s_max + sp;
        const float e = expf(fminf(l_spill[o] - m, 60.f)) *
                        (dm_sp != nullptr ? dm_sp[o] : 1.f);
        Vec<VEC>::load(xh_spill + (t * s_max + sp) * hc + col, v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = fmaf(e, v[q], acc[q]);
      }
    }
    if (active) {
      const float inv = inv_s[h];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] *= inv;
      Vec<VEC>::store(orow + col, acc);
    }
  }
}

}  // namespace

// Kernel D. xh [n, heads * c] f32; acat [heads * c, 2 * heads] f32; loc
// [k, n] int32; el [k * heads, n] f32 (NEG_BIG in dead and spilled slots);
// el_self [heads, n] f32 or null (no self loop); l_spill [T, heads, S]
// f32; xh_spill [T, S, heads * c] f32; dst_loc [T, S] int32 (-1 dead);
// dmask [(k + 1) * heads, n] and dmask_sp [T, heads, S] f32, both or
// neither (null: no dropout); ac [n, 2 * heads] f32 scratch; out [n,
// heads * c] f32. T = n / r. vec 4 needs c % 4 == 0 and 16-byte aligned
// xh, xh_spill and out. Launches on `stream`; returns the CUDA error code
// of the launches.
extern "C" int ell_gat_v2_fwd(const void* xh, const void* acat,
                              const void* loc, const void* el,
                              const void* el_self, const void* l_spill,
                              const void* xh_spill, const void* dst_loc,
                              const void* dmask, const void* dmask_sp,
                              void* ac, void* out, long long n, int k,
                              int heads, int c, int r, int s_max, float slope,
                              int vec, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || s_max < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) || ((dmask == nullptr) != (dmask_sp == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int wpb = THREADS / WARP;
  const size_t smem = v2_smem(wpb, k, heads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fxh = static_cast<const float*>(xh);
  cudaError_t err = launch_acat_dots(fxh, static_cast<const float*>(acat),
                                     static_cast<float*>(ac), n, heads * c,
                                     2 * heads, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + wpb - 1) / wpb);
#define V2_FWD_ARGS                                                         \
  fxh, static_cast<const float*>(ac), static_cast<const int*>(loc),         \
      static_cast<const float*>(el), static_cast<const float*>(el_self),    \
      static_cast<const float*>(l_spill),                                   \
      static_cast<const float*>(xh_spill), static_cast<const int*>(dst_loc), \
      static_cast<const float*>(dmask), static_cast<const float*>(dmask_sp), \
      static_cast<float*>(out), n, k, heads, c, r, s_max, slope
  if (vec == 4)
    v2_fwd_kernel<4><<<blocks, THREADS, smem, s>>>(V2_FWD_ARGS);
  else
    v2_fwd_kernel<1><<<blocks, THREADS, smem, s>>>(V2_FWD_ARGS);
#undef V2_FWD_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gat_v2_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
