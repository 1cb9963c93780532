// GAT layer on a destination-major ELL graph, forward (kernel C), for
// Hopper (sm_90a), CUDA C++.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py::_kernel_v3 (the
// wide banded-ELL Pallas TPU kernel behind ell_gat_fused_wide_pallas) in
// f32 and bf16, in its inference form and its training (dropout) form. For
// node i of an ELL graph
// (nbr_src [N, K], nbr_mask [N, K]) and head h it computes
//   a_src[j, h] = sum_c xh[j, h, c] * att_src[h, c]       (dots kernel)
//   a_dst[j, h] = sum_c xh[j, h, c] * att_dst[h, c]
//   l_k    = LeakyReLU(a_src[nbr[i, k], h] + a_dst[i, h] + el[i, k, h])
//            for each live slot k
//   l_self = LeakyReLU(a_src[i, h] + a_dst[i, h] + el_self[i, h])
//   w      = softmax over {l_k} U {l_self}, max over all live slots,
//            times the dropout multipliers d (training form; 1 otherwise)
//   out[i, h, :] = (w_self * xh[i, h, :] + sum_k w_k * xh[nbr[i, k], h, :])
//                  [+ bias], 0 where node_mask[i] is false
// The dropout form multiplies the post-softmax weights of the live slots
// and of the self loop by 0 or 1 / keep; the denominator stays the
// undropped one, as in _kernel_v3. The multipliers are streamed ([N, K+1,
// heads] f32) or drawn here with Philox from a per-layer seed
// (ell_gat_common.cuh), so kernel C' (ell_gat_bwd.cu) regenerates them.
// The attention dots, the masked softmax and the weighted gather-sum are
// all computed here; x @ W and the edge-logit terms el = edge_attr @
// M_edge, el_self = mean live incoming attr @ M_edge come from the caller.
// bf16 form (compute_dtype="bfloat16"): xh, the attention vectors and the
// bias are read as bf16, out is written as bf16; logits, the softmax, the
// Philox draw and the accumulation run in f32 as in f32 form. As the JAX
// layer does (the kernel's bf16 output, then bias.astype(out.dtype) added
// in bf16), the sum is rounded to bf16 before the bias is added and the
// result rounded again. The TPU kernel also rounds its spill messages
// (e_s * xh_spill) to bf16 before their dot; this kernel does not single
// out spilled slots, so it sums them unrounded like the in-band ones.
// Dead slots are skipped (never multiplied by 0), so a non-finite value in
// a row that no live slot names cannot leak in. A node with no live slot
// gets its self term only; with no self loop either, its output is 0.
//
// The TPU kernel splits each node's slots into an in-band part (a dense
// one-hot gather over a window of 3 x R rows, since the TPU has no fast
// gather) and a spill part, and takes its softmax max over the in-band
// slots and the self loop only. Hopper gathers rows directly, so this
// kernel reads nbr_src as it is and takes the true max over every live
// slot; the two agree unless a spilled logit exceeds the in-band max by
// more than 60 (where the TPU kernel clamps the exponent).
//
// Design (simple and correct first). Two kernels behind one C entry:
//   (1) dots: one warp per node; the lanes stride over each head's C
//       channels and reduce with shuffles -> dots [N, 2 * heads] (a_src
//       then a_dst).
//   (2) aggregate: one warp per destination node. Lanes own slots for the
//       softmax (logits, warp max, exponentials, warp sum), the K x heads
//       weights and K sources are staged in the warp's slice of shared
//       memory, then the lanes own output columns and gather each live
//       neighbour's row with 16-byte loads (HC 256: two float4 a lane),
//       accumulating in f32. Hilbert node order keeps most neighbour rows
//       in L2.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor).
// At N = 65,536, K = 8, HC 256, 4 heads the layer must read xh (67.1 MB),
// el (8.4 MB), nbr_src and the mask (2.6 MB), el_self, and write out
// (67.1 MB): ~150 MB, ~0.045 ms; its operations (~0.44 GFLOP, dots and
// the 9-way weighted sum) take ~0.007 ms at the FP32 rate, so it is bound
// by bytes (bf16 halves the xh and out streams: ~82 MB, ~0.025 ms). This
// version moves more: xh is read by both kernels, and each
// node's K neighbour rows are gathered (from L2 when they are close).
// Fusing the dots into the producer of xh, wider rows per warp and
// tensor-core/TMA staging are later work.

#include "ell_gat_common.cuh"

using namespace ellgat;

namespace {

// One warp per destination node. Shared memory per warp: weights [K,
// heads], self weights [heads] (floats), then (after all warps' floats)
// the K sources (ints, -1 for a dead slot). VEC = 4 needs C % 4 == 0 and
// 16-byte aligned xh / out / bias (checked by the caller). The weights
// are multiplied by ``drop``'s multipliers after the normalization. xh,
// bias and out are of type T (float or bf16).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
aggregate_kernel(const T* __restrict__ xh, const float* __restrict__ dots,
                 const int* __restrict__ nbr,
                 const uint8_t* __restrict__ nmask,
                 const float* __restrict__ el,
                 const float* __restrict__ el_self,
                 const T* __restrict__ bias,
                 const uint8_t* __restrict__ node_mask,
                 T* __restrict__ out, long long n, int k, int heads,
                 int c, float slope, int has_self, Drop drop) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int per_warp = (k + 1) * heads;
  float* w_s = smem + warp * per_warp;       // [K, heads]
  float* wself_s = w_s + k * heads;          // [heads]
  int* src_s = reinterpret_cast<int*>(smem + wpb * per_warp) + warp * k;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // the whole warp leaves together
  const int hc = heads * c;
  T* orow = out + i * hc;
  if (node_mask != nullptr && !node_mask[i]) {
    for (int j = lane; j < hc; j += WARP) orow[j] = from_f<T>(0.f);
    return;
  }
  const long long slot0 = i * k;
  for (int s = lane; s < k; s += WARP)
    src_s[s] = nmask[slot0 + s] ? nbr[slot0 + s] : -1;

  const float* di = dots + i * 2 * heads;
  for (int h = 0; h < heads; ++h) {
    const float a_dst = di[heads + h];
    float self_l = -INFINITY;
    if (has_self)
      self_l = leaky(di[h] + a_dst +
                         (el_self != nullptr ? el_self[i * heads + h] : 0.f),
                     slope);
    // lane-private slots: each lane reads back only what it wrote
    float m = self_l;
    for (int s = lane; s < k; s += WARP) {
      const int j = src_s[s];
      float l = -INFINITY;
      if (j >= 0) {
        l = leaky(dots[(long long)j * 2 * heads + h] + a_dst +
                      (el != nullptr ? el[(slot0 + s) * heads + h] : 0.f),
                  slope);
        m = fmaxf(m, l);
      }
      w_s[s * heads + h] = l;
    }
    m = warp_max(m);
    float den = 0.f;
    for (int s = lane; s < k; s += WARP) {
      const float e = src_s[s] >= 0 ? expf(w_s[s * heads + h] - m) : 0.f;
      w_s[s * heads + h] = e;
      den += e;
    }
    den = warp_sum(den);
    const float e_self = has_self ? expf(self_l - m) : 0.f;
    den = fmaxf(den + e_self, 1e-16f);
    for (int s = lane; s < k; s += WARP)
      w_s[s * heads + h] = src_s[s] >= 0 ? w_s[s * heads + h] / den *
                                               drop.mult(i, s, h, k, heads)
                                         : 0.f;
    if (lane == 0)
      wself_s[h] = has_self ? e_self / den * drop.mult(i, k, h, k, heads)
                            : 0.f;
  }
  __syncwarp();

  for (int col = lane * VEC; col < hc; col += WARP * VEC) {
    const int h = col / c;
    float acc[VEC], v[VEC];
    if (has_self) {
      const float ws = wself_s[h];
      VecT<T, VEC>::load(xh + i * hc + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = ws * v[q];
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    }
    for (int s = 0; s < k; ++s) {
      const int j = src_s[s];
      if (j < 0) continue;
      const float w = w_s[s * heads + h];
      VecT<T, VEC>::load(xh + (long long)j * hc + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(w, v[q], acc[q]);
    }
    if (bias != nullptr) {
      VecT<T, VEC>::load(bias + col, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        acc[q] = (LOWP ? round_bf(acc[q]) : acc[q]) + v[q];
    }
    VecT<T, VEC>::store(orow + col, acc);
  }
}

// The multipliers of ``drop`` (mode 2) written out as the mask [n, k + 1,
// heads] that mode 1 streams.
__global__ void __launch_bounds__(THREADS)
drop_mask_kernel(float* __restrict__ out, Drop drop, long long n, int k,
                 int heads) {
  const long long total = n * (k + 1) * heads;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int h = (int)(idx % heads);
    const int s = (int)((idx / heads) % (k + 1));
    out[idx] = drop.mult(idx / ((long long)(k + 1) * heads), s, h, k, heads);
  }
}

}  // namespace

// Shared memory of one aggregate block with `wpb` warps.
static size_t agg_smem(int wpb, int k, int heads) {
  return (size_t)wpb * ((size_t)(k + 1) * heads * sizeof(float) +
                        (size_t)k * sizeof(int));
}

// The largest number of warps (<= 8) per aggregate block whose shared
// memory fits in 48 KB, or 0 when not even one warp fits.
extern "C" int ell_gat_fwd_warps_per_block(int k, int heads) {
  for (int wpb = THREADS / WARP; wpb >= 1; --wpb)
    if (agg_smem(wpb, k, heads) <= 48 * 1024) return wpb;
  return 0;
}

template <typename T>
int launch_fwd(const void* xh, const void* att, const void* nbr,
               const void* nmask, const void* el, const void* el_self,
               const void* bias, const void* node_mask, void* dots, void* out,
               long long n, int k, int heads, int c, float slope,
               int has_self, int vec, const Drop& drop, int wpb,
               cudaStream_t s) {
  const T* txh = static_cast<const T*>(xh);
  cudaError_t err = launch_dots<T>(txh, static_cast<const T*>(att),
                                   static_cast<float*>(dots), n, heads, c, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + wpb - 1) / wpb);
  const size_t smem = agg_smem(wpb, k, heads);
#define AGG_ARGS                                                            \
  txh, static_cast<const float*>(dots), static_cast<const int*>(nbr),       \
      static_cast<const uint8_t*>(nmask), static_cast<const float*>(el),    \
      static_cast<const float*>(el_self), static_cast<const T*>(bias),      \
      static_cast<const uint8_t*>(node_mask), static_cast<T*>(out), n, k,   \
      heads, c, slope, has_self, drop
  if (vec == 4)
    aggregate_kernel<T, 4><<<blocks, wpb * WARP, smem, s>>>(AGG_ARGS);
  else
    aggregate_kernel<T, 1><<<blocks, wpb * WARP, smem, s>>>(AGG_ARGS);
#undef AGG_ARGS
  return (int)cudaGetLastError();
}

// Kernel C. dtype: 0 = float32, 1 = bfloat16 (xh, att, bias, out). xh
// [n, heads * c]; att [2, heads * c]; nbr [n, k] int32; nmask [n, k]
// uint8; el [n, k, heads] f32 or null; el_self [n, heads] f32 or null
// (zeros); bias [heads * c] or null; node_mask [n] uint8 or null; dots
// [n, 2 * heads] f32 scratch; out [n, heads * c]. Dropout (training form):
// drop_mode 0 none, 1 dmask [n, k + 1, heads] f32, 2 Philox from the int64
// at seed with threshold thresh and scale keep_inv. vec 4 needs c % 4 == 0
// and 16-byte aligned xh, out and bias. Launches on `stream`; returns the
// CUDA error code of the launches (0 when both were accepted).
extern "C" int ell_gat_fwd(int dtype, const void* xh, const void* att,
                           const void* nbr, const void* nmask, const void* el,
                           const void* el_self, const void* bias,
                           const void* node_mask, void* dots, void* out,
                           long long n, int k, int heads, int c, float slope,
                           int has_self, int vec, int drop_mode,
                           const void* dmask, const void* seed,
                           unsigned thresh, float keep_inv, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || c < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) || drop_mode < 0 || drop_mode > 2 ||
      (drop_mode == 1 && dmask == nullptr) ||
      (drop_mode == 2 && seed == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int wpb = ell_gat_fwd_warps_per_block(k, heads);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(drop_mode, dmask, seed, thresh, keep_inv);
  if (dtype == 1)
    return launch_fwd<bf16>(xh, att, nbr, nmask, el, el_self, bias,
                            node_mask, dots, out, n, k, heads, c, slope,
                            has_self, vec, drop, wpb, s);
  return launch_fwd<float>(xh, att, nbr, nmask, el, el_self, bias, node_mask,
                           dots, out, n, k, heads, c, slope, has_self, vec,
                           drop, wpb, s);
}

// The Philox draw of ``seed`` (mode 2 of ell_gat_fwd) as the f32 mask
// [n, k + 1, heads] that mode 1 takes.
extern "C" int ell_gat_drop_mask(void* out, const void* seed, unsigned thresh,
                                 float keep_inv, long long n, int k,
                                 int heads, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  const Drop drop = make_drop(2, nullptr, seed, thresh, keep_inv);
  drop_mask_kernel<<<1024, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), drop, n, k, heads);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gat_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
