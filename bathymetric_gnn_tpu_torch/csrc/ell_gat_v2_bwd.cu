// Fused banded-ELL GAT layer, backward (kernel D'), for Hopper (sm_90a),
// CUDA C++, f32, with or without streamed attention dropout.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py::_bwd_kernel_v2
// (the custom VJP _fused_v2 of kernel D, launched by _run_fused_v2_bwd).
// Flash-style: nothing of the forward is kept but its inputs. For
// destination i (band t, row r), head h, with the forward's softmax
// recomputed (ell_gat_v2_fwd.cu; m held constant, which drops the
// gradient of the min(l_s - m, 60) clamp as the TPU kernel does) and
// u = d out[i], dy = u / Dt (Dt = D + sum e_s), d the dropout multipliers:
//   A_k = <dy, xh[src_k]>_h (0 for a slot with no window source),
//   b   = <dy, xh[i]>_h,  c_s = <dy, xh_spill[t, s]>_h
//   ddenom = -(sum_k d_k e_k A_k + d_self e_self b + sum_s d_s e_s c_s) / Dt
//   dl_k = e_k (d_k A_k + ddenom) leaky'(pre_k)         (= d el[k, h, i])
//   dl_self = e_self (d_self b + ddenom) leaky'(pre_self)  (= d el_self)
//   d l_spill[t, h, s] = e_s (d_s c_s + ddenom)
//   d xh_spill[t, s, :] = d_s e_s dy
//   dac[src_k, h] += dl_k,  dac[i, h] += dl_self,  dac[i, heads + h] =
//     sum_k dl_k + dl_self        (the [a_src | a_dst] dot cotangents)
//   d xh[j] = sum over slots with source j of d_k e_k dy[dst]
//             + d_self e_self dy[j] + acat @ dac[j]
//   d acat = xh^T @ dac
//
// The TPU kernel scatters the window's cotangent with the transposed
// one-hot dot into three partials (chunks t-1, t, t+1) that XLA shift-adds,
// and accumulates d acat across its sequential grid. Blocks on Hopper run
// in no order, so the source side is a reduction in source-sorted order
// instead, as kernel C' (ell_gat_bwd.cu) does it: four launches behind one
// C entry,
//   (1) the attention dots ac (ell_gat_banded.cuh);
//   (2) one warp per destination row: the softmax recompute, the dot
//       products, the per-slot coefficients alpha = d_k e_k / Dt and dl
//       [N * K, heads], d el, d el_self, the row's spill cotangents (each
//       spill entry belongs to one row, so no two warps write it), and the
//       destination side of dac and the self message's coefficient;
//   (3) one warp per source node: walks its in-band slots in
//       source-sorted order (BandedEll.band_perm / band_row_ptr) for its
//       dac and its message rows alpha * u[dst], and writes d xh;
//   (4) per-block partials of xh^T @ dac [blocks, HC, 2 * heads], which
//       the caller sums in a fixed order.
// No atomics: every sum is taken in a fixed order and the gradients repeat
// bit for bit. The spill rows' own gathers (xh_spill, and a_src / a_dst of
// the spill logits) are torch gathers whose backward is kernel F mode (a)
// (ops/ell_banded.gather_rows_reduce_bwd).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 262,144, K = 8, HC 256 it must read xh and dout (268 MB each), el,
// loc and the spill tables, and write d xh (268 MB), d el (33.6 MB) and the
// spill cotangents: ~0.85 GB, ~0.25 ms; its operations (a dot product and
// an axpy of C per slot and head, the dxh epilogue) take ~0.05 ms at the
// FP32 rate: bound by bytes. This version reads each neighbour row of xh
// and of dout once more per slot, and xh again for d acat.

#include "ell_gat_banded.cuh"

using namespace band;
using ellgat::Vec;

namespace {

// Floats of one warp's slice of shared memory in (2): the exponentials,
// LeakyReLU slopes and dot products A [K, heads] each, then per head m,
// 1 / Dt, e_self and the self slope; the K sources (long long) of all
// warps follow all warps' floats.
__host__ __device__ inline int dst_warp_floats(int k, int heads) {
  return 3 * k * heads + 4 * heads;
}

size_t dst_smem(int wpb, int k, int heads) {
  size_t f = (size_t)wpb * dst_warp_floats(k, heads) * sizeof(float);
  f = (f + 7) / 8 * 8;
  return f + (size_t)wpb * k * sizeof(long long);
}

// <u[base:base + c], x[base:base + c]> over the warp.
__device__ __forceinline__ float warp_dot(const float* __restrict__ u,
                                          const float* __restrict__ x, int c,
                                          int lane) {
  float p = 0.f;
  for (int q = lane; q < c; q += WARP) p = fmaf(__ldg(u + q), __ldg(x + q), p);
  return warp_sum(p);
}

__global__ void __launch_bounds__(THREADS)
v2_bwd_dst_kernel(const float* __restrict__ xh, const float* __restrict__ ac,
                  const int* __restrict__ loc, const float* __restrict__ el,
                  const float* __restrict__ el_self,
                  const float* __restrict__ l_spill,
                  const float* __restrict__ xh_spill,
                  const int* __restrict__ dst_loc,
                  const float* __restrict__ dm,
                  const float* __restrict__ dm_sp,
                  const float* __restrict__ dout, float* __restrict__ alpha,
                  float* __restrict__ dl, float* __restrict__ cself,
                  float* __restrict__ dac, float* __restrict__ del,
                  float* __restrict__ del_self, float* __restrict__ dl_spill,
                  float* __restrict__ dxh_spill, long long n, int k,
                  int heads, int c, int r, int s_max, float slope) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int kh = k * heads;
  const int per_warp = dst_warp_floats(k, heads);
  float* e_s = smem + warp * per_warp;   // [K, heads]
  float* lf_s = e_s + kh;                // LeakyReLU slopes
  float* a_s = lf_s + kh;                // A
  float* m_s = a_s + kh;                 // [heads]
  float* inv_s = m_s + heads;
  float* es_s = inv_s + heads;
  float* fs_s = es_s + heads;
  const size_t floats = ((size_t)wpb * per_warp * sizeof(float) + 7) / 8 * 8;
  long long* src_s =
      reinterpret_cast<long long*>(reinterpret_cast<char*>(smem) + floats) +
      warp * k;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // the whole warp leaves together
  const int hc = heads * c;
  const long long t = i / r;
  const int row = (int)(i % r);
  const bool has_self = el_self != nullptr;
  load_sources(loc, i, n, k, r, lane, src_s);

  // ---- the forward's softmax, recomputed (lanes own slots) ------------
  for (int h = 0; h < heads; ++h) {
    float den, es, ps;
    const float m = row_softmax<false>(ac, el, el_self, src_s, i, n, k,
                                       heads, h, slope, lane, e_s, lf_s,
                                       &den, &es, &ps);
    den += spill_denominator(l_spill, dst_loc, t, row, heads, h, s_max, m,
                             lane);
    if (lane == 0) {
      m_s[h] = m;
      inv_s[h] = 1.f / den;
      es_s[h] = es;
      fs_s[h] = has_self ? (ps >= 0.f ? 1.f : slope) : 0.f;
    }
  }
  __syncwarp();

  // ---- cotangents, one head at a time (lanes own its C channels) ------
  const float* u = dout + i * hc;
  const float* xi = xh + i * hc;
  for (int h = 0; h < heads; ++h) {
    const int base = h * c;
    const float inv = inv_s[h], m = m_s[h], es = es_s[h];
    const float dms = dm != nullptr ? dm[((long long)kh + h) * n + i] : 1.f;
    const float b = warp_dot(u + base, xi + base, c, lane) * inv;
    float sea = has_self ? es * dms * b : 0.f;
    for (int s = 0; s < k; ++s) {
      const long long j = src_s[s];   // the same for every lane
      float p = 0.f;
      if (j >= 0) p = warp_dot(u + base, xh + j * hc + base, c, lane) * inv;
      const int o = s * heads + h;
      const float dmk =
          dm != nullptr ? dm[((long long)s * heads + h) * n + i] : 1.f;
      sea = fmaf(e_s[o] * dmk, p, sea);
      if (lane == 0) a_s[o] = p;
    }
    // the row's spill entries: c_s, d xh_spill, and d l_spill's first term
    for (int b0 = 0; b0 < s_max; b0 += WARP) {
      unsigned bits = spill_ballot(dst_loc, t, row, s_max, b0, lane);
      while (bits) {
        const int sp = b0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const long long o = (t * heads + h) * s_max + sp;
        const float* xs = xh_spill + (t * s_max + sp) * hc + base;
        const float cs = warp_dot(u + base, xs, c, lane) * inv;
        const float w = expf(fminf(l_spill[o] - m, 60.f)) *
                        (dm_sp != nullptr ? dm_sp[o] : 1.f);
        sea = fmaf(w, cs, sea);
        float* dxs = dxh_spill + (t * s_max + sp) * hc + base;
        for (int q = lane; q < c; q += WARP) dxs[q] = w * u[base + q] * inv;
        if (lane == 0) dl_spill[o] = w * cs;
      }
    }
    const float ddn = -sea * inv;
    // d l_spill's second term, e_s * ddenom (lane 0 wrote the first)
    for (int b0 = 0; b0 < s_max; b0 += WARP) {
      unsigned bits = spill_ballot(dst_loc, t, row, s_max, b0, lane);
      while (bits) {
        const int sp = b0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const long long o = (t * heads + h) * s_max + sp;
        if (lane == 0)
          dl_spill[o] += expf(fminf(l_spill[o] - m, 60.f)) * ddn;
      }
    }
    __syncwarp();
    float dsum = 0.f;
    for (int s = lane; s < k; s += WARP) {
      const int o = s * heads + h;
      const float dmk =
          dm != nullptr ? dm[((long long)s * heads + h) * n + i] : 1.f;
      const float d = e_s[o] * fmaf(dmk, a_s[o], ddn) * lf_s[o];
      del[((long long)s * heads + h) * n + i] = d;
      dsum += d;
      const bool live = src_s[s] >= 0;
      const long long slot = (i * k + s) * heads + h;
      alpha[slot] = live ? e_s[o] * dmk * inv : 0.f;
      dl[slot] = live ? d : 0.f;
    }
    dsum = warp_sum(dsum);
    const float dls = has_self ? es * fmaf(dms, b, ddn) * fs_s[h] : 0.f;
    if (lane == 0) {
      if (del_self != nullptr) del_self[(long long)h * n + i] = dls;
      dac[i * 2 * heads + h] = dls;
      dac[i * 2 * heads + heads + h] = dsum + dls;
      cself[i * heads + h] = has_self ? es * dms * inv : 0.f;
    }
    __syncwarp();
  }
}

// (3) One warp per source node j: dac[j, :heads] += the dl of its in-band
// slots (source-sorted: perm[row_ptr[j]:row_ptr[j + 1]]), then
// d xh[j, :] = cself[j] u[j] + sum_slots alpha u[dst] + acat @ dac[j].
template <int VEC>
__global__ void __launch_bounds__(THREADS)
v2_bwd_src_kernel(const float* __restrict__ dout,
                  const float* __restrict__ acat,
                  const float* __restrict__ alpha,
                  const float* __restrict__ dl,
                  const float* __restrict__ cself,
                  const int* __restrict__ perm,
                  const int* __restrict__ row_ptr, float* __restrict__ dac,
                  float* __restrict__ dxh, long long n, int k, int heads,
                  int c) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long j =
      (long long)blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
  if (j >= n) return;
  const int hc = heads * c, h2 = 2 * heads;
  const int lo = row_ptr[j], hi = row_ptr[j + 1];
  float ds[MAX_HEADS];
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h) ds[h] = 0.f;
  for (int p = lo + lane; p < hi; p += WARP) {
    const long long slot = perm[p];
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h)
      if (h < heads) ds[h] += dl[slot * heads + h];
  }
  float d[2 * MAX_HEADS];
#pragma unroll
  for (int jj = 0; jj < 2 * MAX_HEADS; ++jj) {
    d[jj] = 0.f;
    if (jj < h2) d[jj] = dac[j * h2 + jj];
  }
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < heads) d[h] += warp_sum(ds[h]);
  __syncwarp();
  if (lane == 0)
    for (int h = 0; h < heads; ++h) dac[j * h2 + h] = d[h];

  for (int col = lane * VEC; col < hc; col += WARP * VEC) {
    const int h = col / c;
    float acc[VEC], v[VEC];
    const float cs = cself[j * heads + h];
    Vec<VEC>::load(dout + j * hc + col, v);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = cs * v[q];
    for (int p = lo; p < hi; ++p) {
      const long long slot = perm[p];
      const float a = alpha[slot * heads + h];
      Vec<VEC>::load(dout + (slot / k) * hc + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(a, v[q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float* arow = acat + (long long)(col + q) * h2;
#pragma unroll
      for (int jj = 0; jj < 2 * MAX_HEADS; ++jj)
        if (jj < h2) acc[q] = fmaf(d[jj], __ldg(arow + jj), acc[q]);
    }
    Vec<VEC>::store(dxh + j * hc + col, acc);
  }
}

// (4) Block b sums xh[j, col] * dac[j, :] over its run of `per` nodes
// into part[b, col, :], threads owning columns.
__global__ void __launch_bounds__(THREADS)
v2_bwd_dacat_kernel(const float* __restrict__ xh,
                    const float* __restrict__ dac, float* __restrict__ part,
                    long long n, int hc, int h2, long long per) {
  const long long j0 = (long long)blockIdx.x * per;
  const long long j1 = j0 + per < n ? j0 + per : n;
  for (int col = threadIdx.x; col < hc; col += blockDim.x) {
    float acc[2 * MAX_HEADS];
#pragma unroll
    for (int jj = 0; jj < 2 * MAX_HEADS; ++jj) acc[jj] = 0.f;
    for (long long j = j0; j < j1; ++j) {
      const float x = __ldg(xh + j * hc + col);
      const float* dj = dac + j * h2;
#pragma unroll
      for (int jj = 0; jj < 2 * MAX_HEADS; ++jj)
        if (jj < h2) acc[jj] = fmaf(x, __ldg(dj + jj), acc[jj]);
    }
    float* out = part + ((long long)blockIdx.x * hc + col) * h2;
#pragma unroll
    for (int jj = 0; jj < 2 * MAX_HEADS; ++jj)
      if (jj < h2) out[jj] = acc[jj];
  }
}

}  // namespace

// Kernel D'. Inputs as ell_gat_v2_fwd (xh, acat, loc, el, el_self,
// l_spill, xh_spill, dst_loc, dmask, dmask_sp), the output cotangent dout
// [n, HC] f32 and the in-band slots' source-sorted tables band_perm
// [n * k] / band_row_ptr [n + 1] int32. Scratch: ac [n, 2 * heads], alpha
// and dl [n * k, heads], cself [n, heads]. Outputs: dac [n, 2 * heads]
// (the attention-dot cotangents), dxh [n, HC], del [k * heads, n],
// del_self [heads, n] (null without a self loop), dl_spill [T, heads, S]
// and dxh_spill [T, S, HC] (zero-filled by the caller: only live entries
// are written), part [da_blocks, HC, 2 * heads] (partials of d acat).
// vec 4 needs c % 4 == 0 and 16-byte aligned dout and dxh. Launches on
// `stream`; returns the CUDA error code of the launches.
extern "C" int ell_gat_v2_bwd(
    const void* xh, const void* acat, const void* loc, const void* el,
    const void* el_self, const void* l_spill, const void* xh_spill,
    const void* dst_loc, const void* dmask, const void* dmask_sp,
    const void* dout, const void* band_perm, const void* band_row_ptr,
    void* ac, void* alpha, void* dl, void* cself, void* dac, void* dxh,
    void* del, void* del_self, void* dl_spill, void* dxh_spill, void* part,
    long long n, int k, int heads, int c, int r, int s_max, float slope,
    int vec, int da_blocks, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || s_max < 1 || da_blocks < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) || ((dmask == nullptr) != (dmask_sp == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int wpb = THREADS / WARP;
  const size_t smem = dst_smem(wpb, k, heads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int hc = heads * c, h2 = 2 * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fxh = static_cast<const float*>(xh);
  const float* facat = static_cast<const float*>(acat);
  cudaError_t err = launch_acat_dots(fxh, facat, static_cast<float*>(ac), n,
                                     hc, h2, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + wpb - 1) / wpb);
  v2_bwd_dst_kernel<<<blocks, THREADS, smem, s>>>(
      fxh, static_cast<const float*>(ac), static_cast<const int*>(loc),
      static_cast<const float*>(el), static_cast<const float*>(el_self),
      static_cast<const float*>(l_spill), static_cast<const float*>(xh_spill),
      static_cast<const int*>(dst_loc), static_cast<const float*>(dmask),
      static_cast<const float*>(dmask_sp), static_cast<const float*>(dout),
      static_cast<float*>(alpha), static_cast<float*>(dl),
      static_cast<float*>(cself), static_cast<float*>(dac),
      static_cast<float*>(del), static_cast<float*>(del_self),
      static_cast<float*>(dl_spill), static_cast<float*>(dxh_spill), n, k,
      heads, c, r, s_max, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define V2_SRC_ARGS                                                          \
  static_cast<const float*>(dout), facat, static_cast<const float*>(alpha), \
      static_cast<const float*>(dl), static_cast<const float*>(cself),      \
      static_cast<const int*>(band_perm),                                   \
      static_cast<const int*>(band_row_ptr), static_cast<float*>(dac),      \
      static_cast<float*>(dxh), n, k, heads, c
  if (vec == 4)
    v2_bwd_src_kernel<4><<<blocks, THREADS, 0, s>>>(V2_SRC_ARGS);
  else
    v2_bwd_src_kernel<1><<<blocks, THREADS, 0, s>>>(V2_SRC_ARGS);
#undef V2_SRC_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per = (n + da_blocks - 1) / da_blocks;
  v2_bwd_dacat_kernel<<<(unsigned)da_blocks, THREADS, 0, s>>>(
      fxh, static_cast<const float*>(dac), static_cast<float*>(part), n, hc,
      h2, per);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gat_v2_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
