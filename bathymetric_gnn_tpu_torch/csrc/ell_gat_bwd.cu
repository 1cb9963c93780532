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
//   (1) the attention dots of xh (kernel C's, ell_gat_common.cuh: the
//       same logits, bit for bit);
//   (2) the destination pass: a grid-stride loop, one warp per destination
//       node, as many 4-warp blocks as stay resident (16 warps an SM at
//       128 registers a thread). Once the node's sources are known the
//       warp requests its dy and xh rows and its first group of 4 neighbour
//       rows
//       (ell_gat_rows.cuh: the lanes own the whole HC row in 16-byte
//       chunks, HC 256 is two float4 a lane in f32, one 8 x bf16 load in
//       bf16), then recomputes the softmax with the lanes owning (slot,
//       head) pairs, every head at once (heads dividing 32; else one head
//       at a time), then reduces all P_k of each group, all heads
//       together, among each head's lanes. d att_src, d att_dst and d bias
//       accumulate in registers, the lane's own columns, over the warp's
//       whole loop (the d att_src sum reads each group's rows again, from
//       L1/L2: keeping all 8 rows in registers measured slower); at the
//       end the block sums its warps in a fixed order into partials
//       [blocks, 3, HC] that the caller sums in a fixed order. It writes at
//       and dl [N * K, heads], d el_self [N, heads], and the destination
//       side of d xh as three scalars per (node, head), dsc [N, 3, heads] =
//       (at_s, the sum dl rounded as below, dl_s rounded): 12 bytes where
//       an f32 row of C floats was written and read back;
//   (3) kernel F in its mode (b) (segment_reduce.cuh): one warp per source
//       node, grid-stride, forms the node's destination side from dsc, dy
//       and att (the lane's columns of att in registers), walks its
//       source-sorted slots (the next node's segment fetched ahead) and
//       adds at dy[dst] + dl att_src, formed in registers, and writes d xh
//       once, so the [N * K, HC] cotangent of the neighbour gather is
//       never written (2.15 GB per layer at the k-NN train step's N =
//       262,144, HC 256).
// No atomics: the sums are taken in a fixed order and repeat bit for bit.
//
// bf16 form: xh, the attention vectors and the cotangent dy are read as
// bf16; the softmax recompute and every sum run in f32, and dxh is formed
// in f32 (the destination side from dsc, then the source side) and written
// as bf16 once. Where the JAX kernel's interpret mode rounds (its cast() at
// _bwd_kernel_v3:1427-1434, 1461, 1480) this kernel rounds too: the
// normalized cotangent dy / D to bf16 in the neighbour dot products P_k
// and in the message rows, the attention-path rows dl * att_src, and the
// destination's own attention-dot cotangents before their products with
// att. The self loop's dot product and message use the unrounded dy, and
// d att, d el, d el_self and d bias stay f32, as there. (The TPU rounds
// more: its bf16 x bf16 products at :1429 and :1460.)
// Dead slots are skipped and padded nodes zeroed by selects, never by a
// multiply by 0.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// the whole call must read xh and dy (N x HC each), el, el_self, the
// indices, masks and slot tables, and write dl, d el_self and dxh: ~0.85
// GB at N = 262,144, HC 256, ~0.25 ms; its operations (~K dot products and
// axpys of HC per node, the source side's rows) take ~0.07 ms at the FP32
// rate, so it is bound by bytes. Besides that minimum it reads xh once
// more (the dots), the neighbour rows of xh and dy from L2 (Hilbert order
// keeps most of them there), and writes and reads back the per-slot
// coefficients and dsc (~40 MB). Measured, it stays far above that bound
// (PERF.md): the destination pass's chain of dependent steps per node
// (sources, softmax reductions, the grouped dot products and their
// reductions, the per-pair and per-head stages) is long against the
// warps an SM holds.

#include "ell_gat_common.cuh"
#include "ell_gat_rows.cuh"
#include "segment_reduce.cuh"

using namespace ellgat;
using rows::GROUP;

namespace {

// Warps per destination-pass block at most.
constexpr int DST_WARPS = 4;

// Floats of one warp's slice of shared memory: five [K + 1, heads] slot
// tables (alpha, at, leaky' factor, P, dl; the self loop at slot K), then
// per head 1 / D, S, P_self, dl_self and the summed dl + dl_self.
__host__ __device__ inline int bwd_warp_floats(int k, int heads) {
  return 5 * (k + 1) * heads + 5 * heads;
}

// The tables and sources of wpb warps, then wpb [HC] rows for the block's
// final sum of its warps' accumulators.
size_t bwd_smem(int wpb, int k, int heads, int hc) {
  size_t b = (size_t)wpb * bwd_warp_floats(k, heads) * sizeof(float) +
             (size_t)wpb * k * sizeof(int);
  b = (b + 15) / 16 * 16;
  return b + (size_t)wpb * hc * sizeof(float);
}

// The largest number of warps (<= DST_WARPS) per destination-pass block
// whose shared memory fits in 48 KB, else 1 (then up to 227 KB).
int bwd_warps(int k, int heads, int hc) {
  for (int wpb = DST_WARPS; wpb > 1; --wpb)
    if (bwd_smem(wpb, k, heads, hc) <= 48 * 1024) return wpb;
  return 1;
}

// xh, att and dy of type T. In the bf16 form the per-slot weights written
// to alpha_out are the unnormalized e * d, and inv_out [N, heads] gets
// 1 / D (kernel F's rows need both). dsc [N, 3, heads] f32: the
// destination side's at_s, dst_r and dls_r (see the header).
template <typename T, int V, int NV>
__global__ void
__launch_bounds__(DST_WARPS * WARP, rows::DST_MIN_BLOCKS)
bwd_kernel(const T* __restrict__ xh, const float* __restrict__ dots,
           const T* __restrict__ att, const int* __restrict__ nbr,
           const uint8_t* __restrict__ nmask, const float* __restrict__ el,
           const float* __restrict__ el_self,
           const uint8_t* __restrict__ node_mask,
           const T* __restrict__ dy, Drop drop,
           float* __restrict__ alpha_out, float* __restrict__ dl_out,
           float* __restrict__ inv_out, float* __restrict__ dsc,
           float* __restrict__ del_self, float* __restrict__ part,
           long long n, int k, int heads, int c, float slope, int has_self,
           int seg) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int hc = heads * c;
  const int kh = (k + 1) * heads;
  const int per_warp = bwd_warp_floats(k, heads);
  float* al = smem + warp * per_warp;    // alpha      [K + 1, heads]
  float* ad = al + kh;                   // at (dropped)
  float* lf = ad + kh;                   // leaky'(pre), 0 for dead slots
  float* pp = lf + kh;                   // P
  float* dd = pp + kh;                   // dl
  float* iv = dd + kh;                   // 1 / D      [heads]
  float* sv = iv + heads;                // S
  float* psv = sv + heads;               // P_self
  float* dlsv = psv + heads;             // dl_self
  float* dstv = dlsv + heads;            // sum_k dl_k + dl_self
  int* src = reinterpret_cast<int*>(smem + wpb * per_warp) + warp * k;
  float* red = smem + ((size_t)wpb * per_warp * sizeof(float) +
                       (size_t)wpb * k * sizeof(int) + 15) / 16 * 4;

  rows::Lanes<V, NV> ln;
  ln.init(lane, hc, c);
  // the warp's d att_src, d att_dst and d bias over its whole loop
  float acc_s[NV][V], acc_d[NV][V], acc_b[NV][V];
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) acc_s[q][v] = acc_d[q][v] = acc_b[q][v] = 0.f;

  const long long total = (long long)gridDim.x * wpb;
  for (long long i = (long long)blockIdx.x * wpb + warp; i < n; i += total) {
    const long long slot0 = i * k;
    if (node_mask != nullptr && !node_mask[i]) {  // padded: no gradient
      for (int j = lane; j < k * heads; j += WARP) {
        alpha_out[slot0 * heads + j] = 0.f;
        dl_out[slot0 * heads + j] = 0.f;
      }
      for (int j = lane; j < 3 * heads; j += WARP) dsc[i * 3 * heads + j] = 0.f;
      for (int h = lane; h < heads; h += WARP) {
        del_self[i * heads + h] = 0.f;
        if (LOWP) inv_out[i * heads + h] = 0.f;
      }
      continue;
    }
    for (int s = lane; s < k; s += WARP)
      src[s] = nmask[slot0 + s] ? nbr[slot0 + s] : -1;
    __syncwarp();

    // the loads that need only the sources, in flight during the softmax:
    // dy and xh of the node, the first group of neighbour rows
    rows::Raw<T, V> rg[NV], rx[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (ln.in(q)) {
        rg[q].load(dy + i * hc + ln.col[q]);
        rx[q].load(xh + i * hc + ln.col[q]);
      } else {
        rg[q].zero();
        rx[q].zero();
      }
    }
    rows::Raw<T, V> r[GROUP][NV];
    rows::load_group(r, xh, src, 0, k, hc, ln);

    // ---- the forward's softmax, recomputed ------------------------------
    const float* di = dots + i * 2 * heads;
    if (WARP % heads == 0) {
      // lanes own (slot, head) pairs o = s * heads + h, every head at once:
      // a lane's pairs all have head lane % heads
      const int h = lane % heads;
      const float a_dst = di[heads + h];
      const float pre_self =
          di[h] + a_dst + (el_self != nullptr ? el_self[i * heads + h] : 0.f);
      const float self_l = has_self ? leaky(pre_self, slope) : -INFINITY;
      float m = self_l;
      for (int o = lane; o < k * heads; o += WARP) {
        const int j = src[o / heads];
        float l = -INFINITY, f = 0.f;
        if (j >= 0) {
          const float pre =
              dots[(long long)j * 2 * heads + h] + a_dst +
              (el != nullptr ? el[slot0 * heads + o] : 0.f);
          l = leaky(pre, slope);
          f = pre >= 0.f ? 1.f : slope;
          m = fmaxf(m, l);
        }
        al[o] = l;
        lf[o] = f;
      }
      m = rows::pair_max(m, heads);
      float den = 0.f;
      for (int o = lane; o < k * heads; o += WARP) {
        const float e = src[o / heads] >= 0 ? expf(al[o] - m) : 0.f;
        al[o] = e;
        den += e;
      }
      den = rows::pair_sum(den, heads);
      const float e_self = has_self ? expf(self_l - m) : 0.f;
      den = fmaxf(den + e_self, 1e-16f);
      for (int o = lane; o < k * heads; o += WARP) {
        const int s = o / heads;
        const bool live = src[s] >= 0;
        const float a = live ? al[o] / den : 0.f;
        al[o] = a;
        ad[o] = live ? a * drop.mult(i, s, h, k, heads) : 0.f;
      }
      if (lane < heads) {   // h == lane
        const float a = e_self / den;
        iv[h] = 1.f / den;
        al[k * heads + h] = has_self ? a : 0.f;
        ad[k * heads + h] =
            has_self ? a * drop.mult(i, k, h, k, heads) : 0.f;
        lf[k * heads + h] =
            has_self ? (pre_self >= 0.f ? 1.f : slope) : 0.f;
      }
    } else {
      // other head counts: one head at a time, lanes own slots
      for (int h = 0; h < heads; ++h) {
        const float a_dst = di[heads + h];
        const float pre_self = di[h] + a_dst +
            (el_self != nullptr ? el_self[i * heads + h] : 0.f);
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
    }
    __syncwarp();

    // ---- the dot products (lanes own the row, all heads at once) -------
    float g[NV][V], x[NV][V], gr[NV][V];
    float ps[1][NV], S[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float inv = iv[ln.head[q]];
      ps[0][q] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        g[q][v] = rg[q].at(v);
        x[q][v] = rx[q].at(v);
        gr[q][v] = LOWP ? round_bf(g[q][v] * inv) : g[q][v];
        ps[0][q] = fmaf(g[q][v], x[q][v], ps[0][q]);
      }
    }
    rows::head_sum(ps, ln, seg, heads);
#pragma unroll
    for (int q = 0; q < NV; ++q) S[q] = ad[k * heads + ln.head[q]] * ps[0][q];

    for (int s0 = 0; s0 < k; s0 += GROUP) {
      if (s0 > 0) rows::load_group(r, xh, src, s0, k, hc, ln);
      float p[GROUP][NV];
#pragma unroll
      for (int u = 0; u < GROUP; ++u)
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          p[u][q] = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v)
            p[u][q] = fmaf(gr[q][v], r[u][q].at(v), p[u][q]);
        }
      rows::head_sum(p, ln, seg, heads);
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int s = s0 + u;
        if (s >= k || src[s] < 0) continue;   // the same for every lane
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int h = ln.head[q];
          // P on the scale of the unrounded path
          const float pv = LOWP ? p[u][q] / iv[h] : p[u][q];
          S[q] = fmaf(ad[s * heads + h], pv, S[q]);
          if (ln.in(q)) pp[s * heads + h] = pv;  // a head's lanes agree
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (ln.in(q)) {
        sv[ln.head[q]] = S[q];
        psv[ln.head[q]] = ps[0][q];
      }
    __syncwarp();

    // ---- per (slot, head): dl, the weights, d el (lanes own pairs) ------
    for (int o = lane; o < k * heads; o += WARP) {
      const int s = o / heads, h = o - s * heads;
      const float d =
          src[s] >= 0 ? (ad[o] * pp[o] - al[o] * sv[h]) * lf[o] : 0.f;
      dd[o] = d;
      alpha_out[slot0 * heads + o] = LOWP ? ad[o] / iv[h] : ad[o];
      dl_out[slot0 * heads + o] = d;
    }
    __syncwarp();
    // ---- per head: d el_self and the destination side's scalars --------
    for (int h = lane; h < heads; h += WARP) {
      float dsum = 0.f;
      for (int s = 0; s < k; ++s) dsum += dd[s * heads + h];
      const int os = k * heads + h;
      const float dls = (ad[os] * psv[h] - al[os] * sv[h]) * lf[os];
      const float dst_l = dsum + dls;
      del_self[i * heads + h] = dls;
      if (LOWP) inv_out[i * heads + h] = iv[h];
      float* d = dsc + i * 3 * heads + h;
      d[0] = ad[os];
      d[heads] = LOWP ? round_bf(dst_l) : dst_l;
      d[2 * heads] = LOWP ? round_bf(dls) : dls;
      dlsv[h] = dls;
      dstv[h] = dst_l;
    }
    __syncwarp();

    // ---- the accumulators: d att_src from the rows held, d att_dst, d bias
    float sa[NV][V];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float dls = dlsv[ln.head[q]];
#pragma unroll
      for (int v = 0; v < V; ++v) sa[q][v] = dls * x[q][v];
    }
    for (int s0 = 0; s0 < k; s0 += GROUP) {
      if (k > GROUP) rows::load_group(r, xh, src, s0, k, hc, ln);
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int s = s0 + u;
        if (s >= k || src[s] < 0) continue;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float d = dd[s * heads + ln.head[q]];
#pragma unroll
          for (int v = 0; v < V; ++v)
            sa[q][v] = fmaf(d, r[u][q].at(v), sa[q][v]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float dst_l = dstv[ln.head[q]];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc_s[q][v] += sa[q][v];
        acc_d[q][v] = fmaf(dst_l, x[q][v], acc_d[q][v]);
        acc_b[q][v] += g[q][v];
      }
    }
    __syncwarp();
  }

  // the block's partial sums: its warps' accumulators in warp order
  for (int a = 0; a < 3; ++a) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (ln.in(q))
#pragma unroll
        for (int v = 0; v < V; ++v)
          red[warp * hc + ln.col[q] + v] =
              a == 0 ? acc_s[q][v] : a == 1 ? acc_d[q][v] : acc_b[q][v];
    __syncthreads();
    for (int j = threadIdx.x; j < hc; j += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < wpb; ++w) t += red[w * hc + j];
      part[((long long)blockIdx.x * 3 + a) * hc + j] = t;
    }
  }
}

// Runs f(bwd_kernel instance, NV) for the form of a call; returns f's
// result, or cudaErrorInvalidValue for a row wider than the templates.
template <typename T, int V, class F>
cudaError_t with_bwd_kernel(int hc, F&& f) {
  return rows::with_chunks<V>(hc, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    return f(bwd_kernel<T, V, NV>);
  });
}

template <typename T, class F>
cudaError_t with_bwd_kernel_v(int width, int hc, F&& f) {
  constexpr int VW = sizeof(T) == 2 ? 8 : 4;
  if (width == VW) return with_bwd_kernel<T, VW>(hc, f);
  return with_bwd_kernel<T, 1>(hc, f);
}

template <class F>
cudaError_t with_bwd_form(int dtype, int width, int hc, F&& f) {
  if (dtype == 1) return with_bwd_kernel_v<bf16>(width, hc, f);
  return with_bwd_kernel_v<float>(width, hc, f);
}

}  // namespace

// The number of destination-pass blocks kernel C' launches for a call of
// this form (as many as stay resident on the current card, at most one
// per warp's node), i.e. the rows of its partial sums; 0 when it cannot
// take the call (a row wider than rows::chunks_for takes).
extern "C" int ell_gat_bwd_blocks(int dtype, long long n, int k, int heads,
                                  int c, int vec) {
  if (n < 1 || k < 1 || heads < 1 || c < 1 || (dtype != 0 && dtype != 1))
    return 0;
  const int hc = heads * c;
  const int wpb = bwd_warps(k, heads, hc);
  const size_t smem = bwd_smem(wpb, k, heads, hc);
  int blocks = 0;
  const cudaError_t err = with_bwd_form(
      dtype, rows::row_width(dtype == 1, vec, c), hc, [&](auto kernel) {
        if (!rows::allow_smem(kernel, smem)) return cudaErrorInvalidValue;
        blocks = rows::resident_blocks(kernel, wpb * WARP, smem,
                                       (n + wpb - 1) / wpb);
        return cudaSuccess;
      });
  return err == cudaSuccess ? blocks : 0;
}

template <typename T>
int launch_bwd(const void* xh, const void* att, const void* nbr,
               const void* nmask, const void* el, const void* el_self,
               const void* node_mask, const void* dy, const Drop& drop,
               const void* perm, const void* row_ptr, void* dots,
               void* alpha, void* dl, void* inv, void* dsc, void* dxh,
               void* del_self, void* part, long long n, int k, int heads,
               int c, float slope, int has_self, int width, int blocks,
               cudaStream_t s) {
  const int hc = heads * c;
  const T* txh = static_cast<const T*>(xh);
  const T* tatt = static_cast<const T*>(att);
  cudaError_t err = launch_dots<T>(txh, tatt, static_cast<float*>(dots), n,
                                   heads, c, s);
  if (err != cudaSuccess) return (int)err;
  const int wpb = bwd_warps(k, heads, hc);
  const size_t smem = bwd_smem(wpb, k, heads, hc);
  const int seg = rows::head_lanes(c, width);
  err = with_bwd_kernel_v<T>(width, hc, [&](auto kernel) {
    if (!rows::allow_smem(kernel, smem)) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, wpb * WARP, smem, s>>>(
        txh, static_cast<const float*>(dots), tatt,
        static_cast<const int*>(nbr), static_cast<const uint8_t*>(nmask),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<const uint8_t*>(node_mask), static_cast<const T*>(dy),
        drop, static_cast<float*>(alpha), static_cast<float*>(dl),
        static_cast<float*>(inv), static_cast<float*>(dsc),
        static_cast<float*>(del_self), static_cast<float*>(part), n, k, heads,
        c, slope, has_self, seg);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || perm == nullptr || row_ptr == nullptr)
    return (int)err;
  const auto src = [&](auto width_c) {
    constexpr int V = decltype(width_c)::value;
    return segred::launch_gat_src<T, V, true, T>(
        static_cast<const float*>(alpha), static_cast<const float*>(dl),
        static_cast<const T*>(dy), tatt, static_cast<const float*>(inv),
        static_cast<const float*>(dsc), static_cast<const int*>(perm),
        static_cast<const int*>(row_ptr), static_cast<T*>(dxh), n, k, heads,
        c, s);
  };
  constexpr int VW = sizeof(T) == 2 ? 8 : 4;
  if (width == VW) return (int)src(std::integral_constant<int, VW>{});
  return (int)src(std::integral_constant<int, 1>{});
}

// Kernel C'. dtype: 0 = float32, 1 = bfloat16 (xh, att, dy, dxh). Inputs
// as ell_gat_fwd (xh, att, nbr, nmask, el, el_self, node_mask, the dropout
// arguments), the output cotangent dy [n, HC], and the source-sorted slot
// tables perm [n * k] / row_ptr [n + 1] (ops/ell.py src_sorted_slots).
// Scratch: dots [n, 2 * heads], alpha and dl [n * k, heads] (f32), inv
// [n, heads] f32 (bf16 only; null for float32), dsc [n, 3, heads] f32 (the
// destination side's scalars). Outputs: dxh [n, HC] (the whole input
// cotangent of xh), del_self [n, heads], part [blocks, 3, HC] (per-block
// d att_src, d att_dst, d bias), f32 but dxh. `blocks` must be
// ell_gat_bwd_blocks of the same form. vec 4 (16-byte row chunks) needs
// 16-byte aligned xh, dy, att and dxh; the chunks are 4 floats (c % 4 ==
// 0) or 8 bf16 (c % 8 == 0), HC <= 2048 (f32) or 4096 (bf16), else single
// columns (HC <= 1024). With perm or
// row_ptr null, kernel F is not launched and dxh is not written (for
// timing the destination pass on its own). Launches on `stream`; returns
// the CUDA error code of the launches.
extern "C" int ell_gat_bwd(int dtype, const void* xh, const void* att,
                           const void* nbr, const void* nmask, const void* el,
                           const void* el_self, const void* node_mask,
                           const void* dy, int drop_mode, const void* dmask,
                           const void* seed, unsigned thresh, float keep_inv,
                           const void* perm, const void* row_ptr, void* dots,
                           void* alpha, void* dl, void* inv, void* dsc,
                           void* dxh, void* del_self, void* part, long long n,
                           int k, int heads, int c, float slope, int has_self,
                           int vec, int blocks, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || c < 1 || blocks < 1 ||
      (vec != 1 && vec != 4) || (vec == 4 && c % 4 != 0) || drop_mode < 0 ||
      drop_mode > 2 || (drop_mode == 1 && dmask == nullptr) ||
      (drop_mode == 2 && seed == nullptr) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && inv == nullptr) || (dtype == 0 && inv != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(drop_mode, dmask, seed, thresh, keep_inv);
  const int width = rows::row_width(dtype == 1, vec, c);
  if (dtype == 1)
    return launch_bwd<bf16>(xh, att, nbr, nmask, el, el_self, node_mask, dy,
                            drop, perm, row_ptr, dots, alpha, dl, inv, dsc,
                            dxh, del_self, part, n, k, heads, c, slope,
                            has_self, width, blocks, s);
  return launch_bwd<float>(xh, att, nbr, nmask, el, el_self, node_mask, dy,
                           drop, perm, row_ptr, dots, alpha, dl, inv, dsc,
                           dxh, del_self, part, n, k, heads, c, slope,
                           has_self, width, blocks, s);
}

extern "C" const char* ell_gat_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
