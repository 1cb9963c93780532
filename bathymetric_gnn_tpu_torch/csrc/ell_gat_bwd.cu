// GAT layer on a destination-major ELL graph, backward (kernel C'), for
// Hopper (sm_90a), CUDA C++.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py::_bwd_kernel_v3
// (the custom VJP of the wide banded-ELL kernel _kernel_v3, launched by
// _run_fused_v3_bwd), f32 and bf16, with or without attention dropout.
// Flash-style:
// nothing of the forward is kept but its inputs; the softmax is recomputed
// here (logits, the true max over the live slots and the self loop held
// constant, exponentials, the undropped denominator D, the dropout draw).
// For destination i, head h, live slot k with source j = nbr[i, k], and the
// output cotangent dy = d out[i, h, :] (0 at padded nodes):
//   alpha_k = e_k / D,  at_k = alpha_k * d_k  (d: the dropout multiplier)
//   P_k = <dy, xh[j, h, :]>,  P_s = <dy, xh[i, h, :]>
//   S   = sum_k at_k P_k + at_s P_s                   (= <dy, out - bias>)
//   dl_k = (at_k P_k - alpha_k S) * leaky'(pre_k),  likewise dl_s
// (equivalently e_k (d_k A_k + ddenom) leaky' with A = P / D and
// ddenom = -S / D). Then
//   d xh[j]   += at_k dy + dl_k att_src                (source side)
//   d xh[i]    = at_s dy + (sum_k dl_k + dl_s) att_dst + dl_s att_src
//   d el[i, k] = dl_k,  d el_self[i] = dl_s
//   d att_src  = sum dl_k xh[j] + dl_s xh[i],  d att_dst = sum (sum_k dl_k
//   + dl_s) xh[i],  d bias = sum over live nodes of dy.
//
// The TPU kernel works on bands of R destination rows with a one-hot
// gather over a 3R-row window and scatters the window's cotangent back
// with the transposed one-hot dot, plus a spill path and a lagged
// accumulator across its sequential grid. Blocks on Hopper run in no
// order, so the source side is a gather-free reduction instead: three
// launches behind one C entry,
//   (1) the attention dots of xh (as kernel C);
//   (2) C' proper: a grid-stride loop, one warp per destination node. The
//       lanes own slots for the softmax recompute (the K x heads
//       coefficients in the warp's slice of shared memory, as kernel C)
//       and the channels of one head at a time for the dot products and
//       the per-destination outputs. It writes at and dl [N * K, heads],
//       dxh's destination side [N, HC], d el_self [N, heads], and per-block
//       partial sums of d att_src, d att_dst and d bias [blocks, 3, HC]
//       (each warp keeps its own in shared memory, the block sums its warps
//       in a fixed order; the caller sums the blocks in a fixed order);
//   (3) kernel F in its mode (b) (segment_reduce.cuh): one warp per source
//       node walks its source-sorted slots and adds at dy[dst] + dl att_src
//       into dxh, formed in registers, so the [N * K, HC] cotangent of the
//       neighbour gather is never written (2.15 GB per layer at the k-NN
//       train step's N = 262,144, HC 256).
// No atomics: the sums are taken in a fixed order and repeat bit for bit.
//
// bf16 form: xh, the attention vectors and the cotangent dy are read as
// bf16; the softmax recompute and every sum run in f32, and dxh is formed
// in f32 (the destination side in a scratch, kernel F adding the source
// side) and written as bf16 once. Where the JAX kernel's interpret mode
// rounds (its cast() at _bwd_kernel_v3:1427-1434, 1461, 1480) this kernel
// rounds too: the normalized cotangent dy / D to bf16 in the neighbour
// dot products P_k and in the message rows, the attention-path rows
// dl * att_src, and the destination's own attention-dot cotangents before
// their products with att. The self loop's dot product and message use
// the unrounded dy, and d att, d el, d el_self and d bias stay f32, as
// there. (The TPU rounds more: its bf16 x bf16 products at :1429 and
// :1460.)
// Dead slots are skipped and padded nodes zeroed by selects, never by a
// multiply by 0.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// it must read xh and dy (N x HC each), el, el_self, the indices and
// masks, and write at, dl, dxh and d el_self: ~0.9 GB at N = 262,144,
// HC 256, ~0.28 ms; its operations (~K dot products and axpys of HC per
// node) take ~0.05 ms at the FP32 rate, so it is bound by bytes. This
// version moves more: xh is read by the dots kernel, each neighbour row
// is read twice by (2) (dot product, then the d att_src sum; the second
// from L1/L2) and once more by (3), and dxh is written by (2) and read
// and written again by (3). Fusing (2) and (3), tensor cores and TMA
// staging are later work.

#include "ell_gat_common.cuh"
#include "segment_reduce.cuh"

using namespace ellgat;

namespace {

// Floats of one warp's slice of shared memory: the d att_src / d att_dst
// / d bias accumulators [3, HC], then five [K + 1, heads] slot tables
// (alpha, at, leaky' factor, P, dl; the self loop at slot K) and 1 / D
// per head; the K sources (ints) of all warps follow all warps' floats.
__host__ __device__ inline long long bwd_warp_floats(int k, int heads,
                                                     int hc) {
  return 3LL * hc + 5LL * (k + 1) * heads + heads;
}

// xh, att and dy of type T; dxh the destination side, f32. In the bf16
// form (inv_out given) the per-slot weights written to alpha_out are the
// unnormalized e * d, and inv_out [N, heads] gets 1 / D (kernel F's rows
// need both: RowsGAT).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const T* __restrict__ xh, const float* __restrict__ dots,
           const T* __restrict__ att, const int* __restrict__ nbr,
           const uint8_t* __restrict__ nmask, const float* __restrict__ el,
           const float* __restrict__ el_self,
           const uint8_t* __restrict__ node_mask,
           const T* __restrict__ dy, Drop drop,
           float* __restrict__ alpha_out, float* __restrict__ dl_out,
           float* __restrict__ inv_out, float* __restrict__ dxh,
           float* __restrict__ del_self, float* __restrict__ part,
           long long n, int k, int heads, int c, float slope, int has_self) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int hc = heads * c;
  const int kh = (k + 1) * heads;
  const long long per_warp = bwd_warp_floats(k, heads, hc);
  float* acc = smem + warp * per_warp;   // [3, HC]
  float* al = acc + 3 * hc;              // alpha      [K + 1, heads]
  float* ad = al + kh;                   // at (dropped)
  float* lf = ad + kh;                   // leaky'(pre), 0 for dead slots
  float* pp = lf + kh;                   // P
  float* dd = pp + kh;                   // dl
  float* iv = dd + kh;                   // 1 / D       [heads]
  int* src = reinterpret_cast<int*>(smem + wpb * per_warp) + warp * k;
  for (int j = lane; j < 3 * hc; j += WARP) acc[j] = 0.f;
  __syncwarp();

  const long long total = (long long)gridDim.x * wpb;
  for (long long i = (long long)blockIdx.x * wpb + warp; i < n; i += total) {
    const long long slot0 = i * k;
    float* drow = dxh + i * hc;
    if (node_mask != nullptr && !node_mask[i]) {  // padded: no gradient
      for (int j = lane; j < hc; j += WARP) drow[j] = 0.f;
      for (int j = lane; j < k * heads; j += WARP) {
        alpha_out[slot0 * heads + j] = 0.f;
        dl_out[slot0 * heads + j] = 0.f;
      }
      for (int h = lane; h < heads; h += WARP) {
        del_self[i * heads + h] = 0.f;
        if (LOWP) inv_out[i * heads + h] = 0.f;
      }
      continue;
    }
    for (int s = lane; s < k; s += WARP)
      src[s] = nmask[slot0 + s] ? nbr[slot0 + s] : -1;
    __syncwarp();

    // ---- the forward's softmax, recomputed (lanes own slots) ----------
    const float* di = dots + i * 2 * heads;
    for (int h = 0; h < heads; ++h) {
      const float a_dst = di[heads + h];
      const float pre_self =
          di[h] + a_dst + (el_self != nullptr ? el_self[i * heads + h] : 0.f);
      const float self_l = has_self ? leaky(pre_self, slope) : -INFINITY;
      float m = self_l;
      for (int s = lane; s < k; s += WARP) {
        const int j = src[s];
        float l = -INFINITY, f = 0.f;
        if (j >= 0) {
          const float pre =
              dots[(long long)j * 2 * heads + h] + a_dst +
              (el != nullptr ? el[(slot0 + s) * heads + h] : 0.f);
          l = leaky(pre, slope);
          f = pre >= 0.f ? 1.f : slope;
          m = fmaxf(m, l);
        }
        al[s * heads + h] = l;
        lf[s * heads + h] = f;
      }
      m = warp_max(m);
      float den = 0.f;
      for (int s = lane; s < k; s += WARP) {
        const float e = src[s] >= 0 ? expf(al[s * heads + h] - m) : 0.f;
        al[s * heads + h] = e;
        den += e;
      }
      den = warp_sum(den);
      const float e_self = has_self ? expf(self_l - m) : 0.f;
      den = fmaxf(den + e_self, 1e-16f);
      for (int s = lane; s < k; s += WARP) {
        const bool live = src[s] >= 0;
        const float a = live ? al[s * heads + h] / den : 0.f;
        al[s * heads + h] = a;
        ad[s * heads + h] = live ? a * drop.mult(i, s, h, k, heads) : 0.f;
      }
      if (lane == 0) {
        const float a = e_self / den;
        iv[h] = 1.f / den;
        al[k * heads + h] = has_self ? a : 0.f;
        ad[k * heads + h] =
            has_self ? a * drop.mult(i, k, h, k, heads) : 0.f;
        lf[k * heads + h] =
            has_self ? (pre_self >= 0.f ? 1.f : slope) : 0.f;
      }
    }
    __syncwarp();

    // ---- cotangents, one head at a time (lanes own its C channels) ----
    const T* dyi = dy + i * hc;
    const T* xi = xh + i * hc;
    for (int h = 0; h < heads; ++h) {
      const int base = h * c;
      const float inv = iv[h];
      float ps = 0.f;
      for (int q = lane; q < c; q += WARP)
        ps = fmaf(ld(dyi + base + q), ld(xi + base + q), ps);
      ps = warp_sum(ps);
      float S = ad[k * heads + h] * ps;
      for (int s = 0; s < k; ++s) {
        const int j = src[s];   // the same for every lane: no divergence
        if (j < 0) continue;
        const T* xj = xh + (long long)j * hc + base;
        float p = 0.f;
        for (int q = lane; q < c; q += WARP) {
          const float g = ld(dyi + base + q);
          p = fmaf(LOWP ? round_bf(g * inv) : g, ld(xj + q), p);
        }
        p = warp_sum(p);
        if (LOWP) p /= inv;   // P on the scale of the unrounded path
        S = fmaf(ad[s * heads + h], p, S);
        if (lane == 0) pp[s * heads + h] = p;
      }
      __syncwarp();
      float dsum = 0.f;
      for (int s = lane; s < k; s += WARP) {
        const int o = s * heads + h;
        const float d =
            src[s] >= 0 ? (ad[o] * pp[o] - al[o] * S) * lf[o] : 0.f;
        dd[o] = d;
        dsum += d;
        alpha_out[(slot0 + s) * heads + h] = LOWP ? ad[o] / inv : ad[o];
        dl_out[(slot0 + s) * heads + h] = d;
      }
      dsum = warp_sum(dsum);
      const int os = k * heads + h;
      const float dls = (ad[os] * ps - al[os] * S) * lf[os];
      if (lane == 0) {
        del_self[i * heads + h] = dls;
        if (LOWP) inv_out[i * heads + h] = inv;
      }
      __syncwarp();
      const float a_self = ad[os];
      const float dst_l = dsum + dls;
      const float dls_r = LOWP ? round_bf(dls) : dls;
      const float dst_r = LOWP ? round_bf(dst_l) : dst_l;
      for (int q = lane; q < c; q += WARP) {
        const int col = base + q;
        const float g = ld(dyi + col), xv = ld(xi + col);
        drow[col] = fmaf(a_self, g, fmaf(dst_r, ld(att + hc + col),
                                         dls_r * ld(att + col)));
        float sa = dls * xv;
        for (int s = 0; s < k; ++s) {
          const int j = src[s];
          if (j < 0) continue;
          sa = fmaf(dd[s * heads + h], ld(xh + (long long)j * hc + col), sa);
        }
        acc[col] += sa;
        acc[hc + col] = fmaf(dst_l, xv, acc[hc + col]);
        acc[2 * hc + col] += g;
      }
      __syncwarp();
    }
  }

  // the block's partial sums: its warps' accumulators in warp order
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * hc; j += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < wpb; ++w) t += smem[w * per_warp + j];
    part[(long long)blockIdx.x * 3 * hc + j] = t;
  }
}

size_t bwd_smem(int wpb, int k, int heads, int hc) {
  return (size_t)wpb * ((size_t)bwd_warp_floats(k, heads, hc) *
                            sizeof(float) +
                        (size_t)k * sizeof(int));
}

}  // namespace

// The largest number of warps (<= 8) per C' block whose shared memory
// fits in 48 KB, or 0 when not even one warp fits.
extern "C" int ell_gat_bwd_warps_per_block(int k, int heads, int hc) {
  for (int wpb = THREADS / WARP; wpb >= 1; --wpb)
    if (bwd_smem(wpb, k, heads, hc) <= 48 * 1024) return wpb;
  return 0;
}

template <typename T>
int launch_bwd(const void* xh, const void* att, const void* nbr,
               const void* nmask, const void* el, const void* el_self,
               const void* node_mask, const void* dy, const Drop& drop,
               const void* perm, const void* row_ptr, void* dots,
               void* alpha, void* dl, void* inv, void* dxh32, void* dxh,
               void* del_self, void* part, long long n, int k, int heads,
               int c, float slope, int has_self, int vec, int blocks,
               int wpb, cudaStream_t s) {
  const int hc = heads * c;
  const T* txh = static_cast<const T*>(xh);
  const T* tatt = static_cast<const T*>(att);
  cudaError_t err = launch_dots<T>(txh, tatt, static_cast<float*>(dots), n,
                                   heads, c, s);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T><<<(unsigned)blocks, wpb * WARP, bwd_smem(wpb, k, heads, hc),
                  s>>>(
      txh, static_cast<const float*>(dots), tatt,
      static_cast<const int*>(nbr), static_cast<const uint8_t*>(nmask),
      static_cast<const float*>(el), static_cast<const float*>(el_self),
      static_cast<const uint8_t*>(node_mask), static_cast<const T*>(dy),
      drop, static_cast<float*>(alpha), static_cast<float*>(dl),
      static_cast<float*>(inv), static_cast<float*>(dxh32),
      static_cast<float*>(del_self), static_cast<float*>(part), n, k, heads,
      c, slope, has_self);
  err = cudaGetLastError();
  if (err != cudaSuccess || perm == nullptr || row_ptr == nullptr)
    return (int)err;
  const segred::RowsGAT<T> rows{static_cast<const float*>(alpha),
                                static_cast<const float*>(dl),
                                static_cast<const T*>(dy), tatt,
                                static_cast<const float*>(inv), k, heads, c};
  return (int)segred::launch_reduce<true>(
      rows, static_cast<const int*>(perm), static_cast<const int*>(row_ptr),
      static_cast<const float*>(dxh32), static_cast<T*>(dxh), n, hc, vec, s);
}

// Kernel C'. dtype: 0 = float32, 1 = bfloat16 (xh, att, dy, dxh). Inputs
// as ell_gat_fwd (xh, att, nbr, nmask, el, el_self, node_mask, the dropout
// arguments), the output cotangent dy [n, HC], and the source-sorted slot
// tables perm [n * k] / row_ptr [n + 1] (ops/ell.py src_sorted_slots).
// Scratch: dots [n, 2 * heads], alpha and dl [n * k, heads] (f32), inv
// [n, heads] f32 (bf16 only; null for float32), dxh32 [n, HC] f32 (the
// destination side; for float32 it may be dxh itself). Outputs: dxh
// [n, HC] (the whole input cotangent of xh), del_self [n, heads], part
// [blocks, 3, HC] (per-block d att_src, d att_dst, d bias), f32 but dxh.
// `blocks` C' blocks of ell_gat_bwd_warps_per_block warps run the
// grid-stride loop. vec 4 (kernel F's loads) needs c % 4 == 0 and 16-byte
// aligned dy, att, dxh32 and dxh. With perm or row_ptr null, kernel F is
// not launched and dxh32 holds the destination side only (for timing C' on
// its own). Launches on `stream`; returns the CUDA error code of the
// launches.
extern "C" int ell_gat_bwd(int dtype, const void* xh, const void* att,
                           const void* nbr, const void* nmask, const void* el,
                           const void* el_self, const void* node_mask,
                           const void* dy, int drop_mode, const void* dmask,
                           const void* seed, unsigned thresh, float keep_inv,
                           const void* perm, const void* row_ptr, void* dots,
                           void* alpha, void* dl, void* inv, void* dxh32,
                           void* dxh, void* del_self, void* part, long long n,
                           int k, int heads, int c, float slope, int has_self,
                           int vec, int blocks, void* stream) {
  const int hc = heads * c;
  if (n < 1 || k < 1 || heads < 1 || c < 1 || blocks < 1 ||
      (vec != 1 && vec != 4) || (vec == 4 && c % 4 != 0) || drop_mode < 0 ||
      drop_mode > 2 || (drop_mode == 1 && dmask == nullptr) ||
      (drop_mode == 2 && seed == nullptr) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && inv == nullptr) || (dtype == 0 && inv != nullptr))
    return (int)cudaErrorInvalidValue;
  const int wpb = ell_gat_bwd_warps_per_block(k, heads, hc);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(drop_mode, dmask, seed, thresh, keep_inv);
  if (dtype == 1)
    return launch_bwd<bf16>(xh, att, nbr, nmask, el, el_self, node_mask, dy,
                            drop, perm, row_ptr, dots, alpha, dl, inv, dxh32,
                            dxh, del_self, part, n, k, heads, c, slope,
                            has_self, vec, blocks, wpb, s);
  return launch_bwd<float>(xh, att, nbr, nmask, el, el_self, node_mask, dy,
                           drop, perm, row_ptr, dots, alpha, dl, inv, dxh32,
                           dxh, del_self, part, n, k, heads, c, slope,
                           has_self, vec, blocks, wpb, s);
}

extern "C" const char* ell_gat_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
