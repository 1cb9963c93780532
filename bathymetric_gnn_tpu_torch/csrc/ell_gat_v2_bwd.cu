// Fused banded-ELL GAT layer, backward (kernel D'), for Hopper (sm_90a),
// CUDA C++, f32 and bf16, with or without streamed attention dropout.
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
//          = sum_i xh[i] (x) [dl_self_i | sum_k dl_k + dl_self_i]
//            + sum_i sum_k xh[src_k] (x) [dl_k | 0]   (by destination)
//
// The TPU kernel scatters the window's cotangent with the transposed
// one-hot dot into three partials (chunks t-1, t, t+1) that XLA shift-adds,
// and accumulates d acat across its sequential grid. Blocks on Hopper run
// in no order, so the source side is a reduction in source-sorted order
// instead, as kernel C' (ell_gat_bwd.cu) does it: three launches behind one
// C entry,
//   (1) the attention dots ac (rows::launch_mat_dots, as kernel D takes
//       them: the same logits, bit for bit), skipped when the caller hands
//       in the dots kernel D wrote (the training layer does);
//   (2) the destination pass: a grid-stride loop, one warp per destination
//       row, as many 4-warp blocks as stay resident (16 warps an SM at 128
//       registers a thread). Once the row's sources are known the warp
//       requests its dout and xh, its first group of 4 in-band rows
//       (ell_gat_rows.cuh: the lanes own the whole HC row in 16-byte
//       chunks) and its first spill row, then recomputes the softmax with
//       the lanes owning (slot, head) pairs, every head at once (heads
//       dividing 32; else one head at a time), then reduces all A_k of
//       each group, all heads together, among each head's lanes. The row's
//       spill entries are visited through the destination-sorted tables
//       (BandedEll.spill_perm_d / spill_row_ptr_d), all heads per visit:
//       the softmax denominator, c_s, d l_spill (w c_s and e_s kept in the
//       warp's tables until ddenom is known, then written once) and
//       d xh_spill. d acat is accumulated per warp in shared memory
//       ([2 * heads, HC] f32, 16-byte accesses) over its whole loop, from
//       the row's own xh and its in-band rows (each group read again, from
//       L1/L2: keeping all 8 rows in registers measured slower); the block
//       sums its warps in a fixed order into partials [blocks, HC,
//       2 * heads] that the caller sums in a fixed order. It writes the
//       per-slot coefficients alpha = d_k e_k / Dt and dl [N * K, heads],
//       d el, d el_self, the destination side of dac and the self
//       message's coefficient, and every entry of the spill cotangents:
//       each live entry belongs to one row (no two warps write it), each
//       dead one is zeroed by the row whose number it has modulo R;
//   (3) one warp per source node, grid-stride, acat staged once per block
//       in shared memory ([2 * heads, HC] f32): walks its in-band slots in
//       source-sorted order (BandedEll.band_perm / band_row_ptr) for its
//       dac and its message rows alpha * u[dst], and writes d xh.
// Rows wider than the untiled instances hold run (2) and (3) in column
// tiles (rows::TILE_NV chunks a lane; (2) one warp a block, d acat in its
// block's partials). No atomics: every sum is taken in a fixed order and
// the gradients repeat bit for bit. The spill rows' own gathers (xh_spill, and a_src / a_dst of
// the spill logits) are torch gathers whose backward is kernel F mode (a)
// (ops/ell_banded.gather_rows_reduce_bwd).
//
// bf16 form: xh, acat, the spill rows and dout are read as bf16, every
// sum runs in f32 and d xh is written as bf16 once. Where the JAX kernel's
// interpret mode rounds (cast() at _bwd_kernel_v2:797, 822, 849) this
// kernel rounds too: dy = u / Dt to bf16 in the spill dot products c_s and
// the spill rows' cotangent, each in-band message d_k e_k dy, and the
// node's dac before its product with acat. JAX emits d xh as three bf16
// partials (one per window chunk) summed in bf16; the source walk here
// sums the whole of d xh in f32 and rounds it once. d xh_spill stays f32
// here; the caller casts it to bf16 for the spill gather's backward
// (kernel F mode (a)), as JAX does. d el, d el_self, d l_spill and d acat
// are f32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 262,144, K = 8, HC 256 it must read xh and dout (268 MB each), el,
// loc and the spill tables, and write d xh (268 MB), d el (33.6 MB) and the
// full spill cotangents: ~1.3 GB, ~0.39 ms; its operations (a dot product
// of HC per slot, the d acat and d xh epilogues) take ~0.1 ms at the FP32
// rate: bound by bytes. Besides that minimum it reads xh once more (the
// dots) and the in-band rows of xh and dout from L2, and writes and reads
// back the per-slot coefficients (~40 MB). Measured, it stays far above
// that bound (PERF.md): per row the destination pass runs a long chain of
// dependent steps (softmax and spill reductions, grouped dot products, the
// spill visits, the d acat update in shared memory).

#include "ell_gat_banded.cuh"
#include "ell_gat_rows.cuh"

using namespace band;
using rows::GROUP;

namespace {

// Warps per destination-pass block at most.
constexpr int DST_WARPS = 4;

// Floats of one warp's slice of shared memory in (2): the exponentials,
// LeakyReLU slopes, dot products A, dropout multipliers and dl [K, heads]
// each; per spill entry of the row (a row has at most K) and head, w c_s
// and exp(min(l_s - m, 60)), and per entry its index in the band's table
// (-1: not the row's); then per head m, 1 / Dt, e_self, the self slope,
// the self's multiplier, b, ddenom, dl_self and sum dl + dl_self.
__host__ __device__ inline int dst_warp_floats(int k, int heads) {
  return 7 * k * heads + k + 9 * heads;
}

// The tables of wpb warps, their K sources (long long), then each warp's
// d acat accumulator [2 * heads, HC].
__host__ __device__ inline size_t dst_tables_bytes(int wpb, int k,
                                                   int heads) {
  size_t b = (size_t)wpb * dst_warp_floats(k, heads) * sizeof(float);
  b = (b + 7) / 8 * 8 + (size_t)wpb * k * sizeof(long long);
  return (b + 15) / 16 * 16;
}

// Tiled rows keep d acat in the block's partials, not in shared memory.
size_t dst_smem(int wpb, int k, int heads, int hc, bool tiled) {
  return dst_tables_bytes(wpb, k, heads) +
         (tiled ? 0 : (size_t)wpb * 2 * heads * hc * sizeof(float));
}

// The largest number of warps (<= DST_WARPS) per destination-pass block
// whose shared memory fits in 48 KB, else 1 (then up to 227 KB). Tiled
// rows take one warp a block: it accumulates in its block's partials.
int dst_warps(int k, int heads, int hc, bool tiled) {
  if (tiled) return 1;
  for (int wpb = DST_WARPS; wpb > 1; --wpb)
    if (dst_smem(wpb, k, heads, hc, false) <= 48 * 1024) return wpb;
  return 1;
}

// The index in band t's spill table of flat entry f (t * S + s) when it
// is a live entry of row `row` of that band, else -1 (the tables list only
// such entries for the row's node; the check keeps a stray one out).
__device__ __forceinline__ long long own_entry(int f,
                                               const int* __restrict__ dst_loc,
                                               long long t, int row,
                                               int s_max) {
  const long long sp = f - t * s_max;
  return (sp >= 0 && sp < s_max && dst_loc[f] == row) ? sp : -1;
}

// TILED (rows wider than rows::chunks_for takes): the lanes hold NV chunks
// of one column tile at a time and take a row's tiles one after the other
// in each phase that reads rows: b, A and the spill entries' c_s add each
// tile's per-head sums into the warp's tables (one lane a head and tile,
// rows::Lanes::first), ddenom and the entries' terms are formed per head
// and pair from them, and d acat accumulates in the block's partials in
// global memory (one warp a block), not in shared memory.
template <typename T, int V, int NV, bool TILED>
__global__ void
__launch_bounds__(DST_WARPS * WARP, rows::DST_MIN_BLOCKS)
v2_bwd_dst_kernel(const T* __restrict__ xh, const float* __restrict__ ac,
                  const int* __restrict__ loc, const float* __restrict__ el,
                  const float* __restrict__ el_self,
                  const float* __restrict__ l_spill,
                  const T* __restrict__ xh_spill,
                  const int* __restrict__ dst_loc,
                  const int* __restrict__ sp_perm,
                  const int* __restrict__ sp_row_ptr,
                  const float* __restrict__ dm,
                  const float* __restrict__ dm_sp,
                  const T* __restrict__ dout, float* __restrict__ alpha,
                  float* __restrict__ dl, float* __restrict__ cself,
                  float* __restrict__ dac, float* __restrict__ del,
                  float* __restrict__ del_self, float* __restrict__ dl_spill,
                  float* __restrict__ dxh_spill, float* __restrict__ part,
                  long long n, int k, int heads, int c, int r, int s_max,
                  float slope, int seg) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int hc = heads * c, h2 = 2 * heads;
  const int kh = k * heads;
  const int per_warp = dst_warp_floats(k, heads);
  float* e_s = smem + warp * per_warp;   // [K, heads]
  float* lf_s = e_s + kh;                // LeakyReLU slopes
  float* a_s = lf_s + kh;                // A
  float* dm_s = a_s + kh;                // dropout multipliers
  float* dd = dm_s + kh;                 // dl
  float* wcs_s = dd + kh;                // spill entries: w c_s [K, heads]
  float* ew_s = wcs_s + kh;              // exp(min(l_s - m, 60))
  float* spf_s = ew_s + kh;              // table index [K]
  float* m_s = spf_s + k;                // [heads]
  float* inv_s = m_s + heads;
  float* es_s = inv_s + heads;
  float* fs_s = es_s + heads;
  float* dms_s = fs_s + heads;
  float* b_s = dms_s + heads;
  float* ddn_s = b_s + heads;
  float* dls_s = ddn_s + heads;
  float* dst_s = dls_s + heads;
  const size_t floats = ((size_t)wpb * per_warp * sizeof(float) + 7) / 8 * 8;
  long long* src_s =
      reinterpret_cast<long long*>(reinterpret_cast<char*>(smem) + floats) +
      warp * k;
  float* aw = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                       dst_tables_bytes(wpb, k, heads)) +
              (size_t)warp * h2 * hc;    // d acat [2 * heads, HC]
  constexpr int TILE = WARP * NV * V;   // columns of a tile
  const int tiles = TILED ? (hc + TILE - 1) / TILE : 1;
  // tiled: the warp's d acat [HC, 2 * heads], its block's partials
  float* pw = part + (long long)blockIdx.x * hc * h2;
  const bool has_self = el_self != nullptr;
  rows::Lanes<V, NV> ln;
  if constexpr (TILED) {
    for (int tt = 0; tt < tiles; ++tt) {
      ln.init(lane, hc, c, tt * TILE);
#pragma unroll
      for (int q = 0; q < NV; ++q)
        if (ln.in(q))
          for (int j = 0; j < V * h2; ++j) pw[(long long)ln.col[q] * h2 + j] = 0.f;
    }
  } else {
    for (int j = lane; j < h2 * hc; j += WARP) aw[j] = 0.f;
  }
  ln.init(lane, hc, c);
  __syncwarp();

  const long long total = (long long)gridDim.x * wpb;
  for (long long i = (long long)blockIdx.x * wpb + warp; i < n; i += total) {
    const long long t = i / r;
    const int row = (int)(i % r);
    // the dead entries of band t's spill tables numbered row modulo R
    for (int sp = row; sp < s_max; sp += r) {
      const int dr = dst_loc[t * s_max + sp];   // the same for every lane
      if (dr >= 0 && dr < r) continue;
      for (int h = lane; h < heads; h += WARP)
        dl_spill[(t * heads + h) * s_max + sp] = 0.f;
      const float zero[V] = {};
      for (int tt = 0; tt < tiles; ++tt) {
        if (TILED) ln.init(lane, hc, c, tt * TILE);
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (ln.in(q))
            rows::store<float, V>(
                dxh_spill + (t * s_max + sp) * hc + ln.col[q], zero);
      }
    }
    if constexpr (TILED) ln.init(lane, hc, c);
    const int lo = sp_row_ptr[i], hi = sp_row_ptr[i + 1];
    load_sources(loc, i, n, k, r, lane, src_s);
    const bool pairs = WARP % heads == 0;

    // the loads that need only the sources, in flight during the softmax:
    // dout and xh of the row, the first group of in-band rows, the row's
    // first spill row and the spill logit of the lane's first (entry,
    // head) pair (their first tile when tiled)
    rows::Raw<T, V> ru[NV], rx[NV], xs0[NV];
    const int f0 = hi > lo ? sp_perm[lo] : -1;   // the same in every lane
    const bool f0_in = f0 >= 0 && f0 < (n / r) * s_max;
    const auto load_own = [&]() {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (ln.in(q)) {
          ru[q].load(dout + i * hc + ln.col[q]);
          rx[q].load(xh + i * hc + ln.col[q]);
        } else {
          ru[q].zero();
          rx[q].zero();
        }
      }
    };
    load_own();
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (f0_in && ln.in(q))
        xs0[q].load(xh_spill + (long long)f0 * hc + ln.col[q]);
      else
        xs0[q].zero();
    }
    rows::Raw<T, V> rw[GROUP][NV];
    rows::load_group(rw, xh, src_s, 0, k, hc, ln);
    float l_first = 0.f;
    bool has_first = false;
    if (pairs && lane < (hi - lo) * heads) {
      const long long sp =
          own_entry(sp_perm[lo + lane / heads], dst_loc, t, row, s_max);
      if (sp >= 0) {
        l_first = l_spill[(t * heads + lane % heads) * s_max + sp];
        has_first = true;
      }
    }

    // ---- the forward's softmax, recomputed ------------------------------
    if (pairs) {
      // lanes own (slot, head) pairs o = s * heads + h, every head at once
      // (row_softmax's arithmetic): a lane's pairs have head
      // lane % heads
      const int h = lane % heads;
      const float a_dst = ac[i * h2 + heads + h];
      const float ps = ac[i * h2 + h] + a_dst +
                       (has_self ? el_self[(long long)h * n + i] : 0.f);
      const float self_l = leaky(ps, slope);
      float m = has_self ? self_l : -1e4f;
      for (int o = lane; o < kh; o += WARP) {
        const long long j = src_s[o / heads];
        const float pre = (j >= 0 ? ac[j * h2 + h] : 0.f) + a_dst +
                          el[(long long)o * n + i];
        const float l = leaky(pre, slope);
        lf_s[o] = pre >= 0.f ? 1.f : slope;
        e_s[o] = l;
        m = fmaxf(m, l);
        dm_s[o] = dm != nullptr ? dm[(long long)o * n + i] : 1.f;
      }
      m = rows::pair_max(m, heads);
      float d = 0.f;
      for (int o = lane; o < kh; o += WARP) {
        const float e = expf(e_s[o] - m);
        e_s[o] = e;
        d += e;
      }
      d = rows::pair_sum(d, heads);
      const float es = has_self ? expf(self_l - m) : 0.f;
      float den = fmaxf(d + es, 1e-16f);
      if (hi > lo) {   // the row's own spill entries, (entry, head) pairs
        float dsp = has_first ? expf(fminf(l_first - m, 60.f)) : 0.f;
        for (int o = lane + WARP; o < (hi - lo) * heads; o += WARP) {
          const long long sp =
              own_entry(sp_perm[lo + o / heads], dst_loc, t, row, s_max);
          if (sp >= 0)
            dsp += expf(fminf(l_spill[(t * heads + h) * s_max + sp] - m,
                              60.f));
        }
        den += rows::pair_sum(dsp, heads);
      }
      if (lane < heads) {   // h == lane
        m_s[h] = m;
        inv_s[h] = 1.f / den;
        es_s[h] = es;
        fs_s[h] = has_self ? (ps >= 0.f ? 1.f : slope) : 0.f;
        dms_s[h] = dm != nullptr ? dm[((long long)kh + h) * n + i] : 1.f;
      }
    } else {
      // other head counts: one head at a time, lanes own slots
      for (int h = 0; h < heads; ++h) {
        float den, es, ps;
        const float m = row_softmax(ac, el, el_self, src_s, i, n, k, heads,
                                    h, slope, lane, e_s, lf_s, &den, &es,
                                    &ps);
        if (hi > lo) {   // the row's own spill entries
          float d = 0.f;
          for (int e = lo + lane; e < hi; e += WARP) {
            const long long sp =
                own_entry(sp_perm[e], dst_loc, t, row, s_max);
            if (sp >= 0)
              d += expf(fminf(l_spill[(t * heads + h) * s_max + sp] - m,
                              60.f));
          }
          den += warp_sum(d);
        }
        for (int s = lane; s < k; s += WARP)
          dm_s[s * heads + h] =
              dm != nullptr ? dm[((long long)s * heads + h) * n + i] : 1.f;
        if (lane == 0) {
          m_s[h] = m;
          inv_s[h] = 1.f / den;
          es_s[h] = es;
          fs_s[h] = has_self ? (ps >= 0.f ? 1.f : slope) : 0.f;
          dms_s[h] = dm != nullptr ? dm[((long long)kh + h) * n + i] : 1.f;
        }
      }
    }
    __syncwarp();

    // ---- the dot products (lanes own the row, all heads at once) -------
    float u[NV][V], x[NV][V];
    if constexpr (TILED) {
      // each tile's per-head sums added into b, A and the spill entries'
      // c_s (past K: in dl_spill), then ddenom and the entries' terms
      for (int o = lane; o < kh; o += WARP) {
        a_s[o] = 0.f;
        wcs_s[o] = 0.f;
      }
      for (int h = lane; h < heads; h += WARP) b_s[h] = 0.f;
      for (int e = lo; e < hi; ++e) {
        const int f = e == lo ? f0 : sp_perm[e];   // the same for every lane
        const long long sp = own_entry(f, dst_loc, t, row, s_max);
        const int el_ = e - lo;
        if (el_ < k) {
          if (lane == 0) spf_s[el_] = (float)sp;
        } else if (sp >= 0) {
          for (int h = lane; h < heads; h += WARP)
            dl_spill[(t * heads + h) * s_max + sp] = 0.f;
        }
      }
      __syncwarp();
      for (int tt = 0; tt < tiles; ++tt) {
        const int col0 = tt * TILE;
        if (tt > 0) {
          ln.init(lane, hc, c, col0);
          load_own();
          rows::load_group(rw, xh, src_s, 0, k, hc, ln);
        }
        float bq[1][NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          bq[0][q] = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            u[q][v] = ru[q].at(v);
            bq[0][q] = fmaf(u[q][v], rx[q].at(v), bq[0][q]);
          }
        }
        rows::head_sum(bq, ln, seg, heads);
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (ln.first(q, c, col0)) b_s[ln.head[q]] += bq[0][q];
        for (int s0 = 0; s0 < k; s0 += GROUP) {
          if (s0 > 0) rows::load_group(rw, xh, src_s, s0, k, hc, ln);
          float p[GROUP][NV];
#pragma unroll
          for (int w = 0; w < GROUP; ++w)
#pragma unroll
            for (int q = 0; q < NV; ++q) {
              p[w][q] = 0.f;
#pragma unroll
              for (int v = 0; v < V; ++v)
                p[w][q] = fmaf(u[q][v], rw[w][q].at(v), p[w][q]);
            }
          rows::head_sum(p, ln, seg, heads);
#pragma unroll
          for (int w = 0; w < GROUP; ++w) {
            const int s = s0 + w;
            if (s >= k) continue;   // the same for every lane
#pragma unroll
            for (int q = 0; q < NV; ++q)
              if (ln.first(q, c, col0)) a_s[s * heads + ln.head[q]] += p[w][q];
          }
        }
        for (int e = lo; e < hi; ++e) {
          const int f = e == lo ? f0 : sp_perm[e];   // the same for every lane
          const long long sp = own_entry(f, dst_loc, t, row, s_max);
          const int el_ = e - lo;
          if (sp < 0) continue;
          float cq[1][NV];
          rows::Raw<T, V> xs[NV];
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            if (e == lo && tt == 0)
              xs[q] = xs0[q];
            else if (ln.in(q))
              xs[q].load(xh_spill + (long long)f * hc + ln.col[q]);
            else
              xs[q].zero();
            const float inv = inv_s[ln.head[q]];
            cq[0][q] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v)
              cq[0][q] = fmaf(LOWP ? round_bf(u[q][v] * inv) : u[q][v],
                              xs[q].at(v), cq[0][q]);
          }
          rows::head_sum(cq, ln, seg, heads);
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            if (!ln.in(q)) continue;
            const int h = ln.head[q];
            const float inv = inv_s[h];
            const long long o = (t * heads + h) * s_max + sp;
            if (ln.first(q, c, col0)) {
              if (el_ < k)
                wcs_s[el_ * heads + h] += cq[0][q];
              else
                dl_spill[o] += cq[0][q];
            }
            const float w = expf(fminf(l_spill[o] - m_s[h], 60.f)) *
                            (dm_sp != nullptr ? dm_sp[o] : 1.f);
            float dxs[V];
#pragma unroll
            for (int v = 0; v < V; ++v)
              dxs[v] = LOWP ? w * round_bf(u[q][v] * inv) : w * u[q][v] * inv;
            rows::store<float, V>(dxh_spill + (long long)f * hc + ln.col[q],
                                  dxs);
          }
        }
        __syncwarp();
      }
      // per pair and per head, from the sums over the tiles
      for (int o = lane; o < kh; o += WARP) a_s[o] *= inv_s[o % heads];
      for (int h = lane; h < heads; h += WARP) b_s[h] *= inv_s[h];
      for (int o = lane; o < (hi - lo) * heads; o += WARP) {
        const int el_ = o / heads, h = o % heads;
        const long long sp =
            el_ < k ? (long long)spf_s[el_]
                    : own_entry(sp_perm[lo + el_], dst_loc, t, row, s_max);
        if (sp < 0) continue;
        const long long idx = (t * heads + h) * s_max + sp;
        const float raw = el_ < k ? wcs_s[o] : dl_spill[idx];
        const float cs = LOWP ? raw : raw * inv_s[h];
        const float er = expf(fminf(l_spill[idx] - m_s[h], 60.f));
        const float w = er * (dm_sp != nullptr ? dm_sp[idx] : 1.f);
        if (el_ < k) {
          wcs_s[o] = w * cs;
          ew_s[o] = er;
        } else {
          dl_spill[idx] = w * cs;
        }
      }
      __syncwarp();
      for (int h = lane; h < heads; h += WARP) {
        float sea = has_self ? es_s[h] * dms_s[h] * b_s[h] : 0.f;
        for (int s = 0; s < k; ++s) {
          const int o = s * heads + h;
          sea = fmaf(e_s[o] * dm_s[o], a_s[o], sea);
        }
        for (int el_ = 0; el_ < hi - lo; ++el_) {
          const long long sp =
              el_ < k ? (long long)spf_s[el_]
                      : own_entry(sp_perm[lo + el_], dst_loc, t, row, s_max);
          if (sp < 0) continue;
          sea += el_ < k ? wcs_s[el_ * heads + h]
                         : dl_spill[(t * heads + h) * s_max + sp];
        }
        ddn_s[h] = -sea * inv_s[h];
      }
      __syncwarp();
    } else {
      float bq[1][NV], sea[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        bq[0][q] = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          u[q][v] = ru[q].at(v);
          x[q][v] = rx[q].at(v);
          bq[0][q] = fmaf(u[q][v], x[q][v], bq[0][q]);
        }
      }
      rows::head_sum(bq, ln, seg, heads);
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int h = ln.head[q];
        const float b = bq[0][q] * inv_s[h];
        sea[q] = has_self ? es_s[h] * dms_s[h] * b : 0.f;
        if (ln.in(q)) b_s[h] = b;   // a head's lanes agree
      }

      for (int s0 = 0; s0 < k; s0 += GROUP) {
        if (s0 > 0) rows::load_group(rw, xh, src_s, s0, k, hc, ln);
        float p[GROUP][NV];
#pragma unroll
        for (int w = 0; w < GROUP; ++w)
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            p[w][q] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v)
              p[w][q] = fmaf(u[q][v], rw[w][q].at(v), p[w][q]);
          }
        rows::head_sum(p, ln, seg, heads);
#pragma unroll
        for (int w = 0; w < GROUP; ++w) {
          const int s = s0 + w;
          if (s >= k) continue;   // the same for every lane
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int h = ln.head[q], o = s * heads + h;
            const float pv = p[w][q] * inv_s[h];   // 0 with no source
            sea[q] = fmaf(e_s[o] * dm_s[o], pv, sea[q]);
            if (ln.in(q)) a_s[o] = pv;
          }
        }
      }

      // the row's spill entries: c_s, d xh_spill, and d l_spill's first term
      // (kept with the exponential for the second, in the entry tables)
      for (int e = lo; e < hi; ++e) {
        const int f = e == lo ? f0 : sp_perm[e];   // the same for every lane
        const long long sp = own_entry(f, dst_loc, t, row, s_max);
        const int el_ = e - lo;
        if (el_ < k && lane == 0) spf_s[el_] = (float)sp;
        if (sp < 0) continue;
        float cq[1][NV];
        rows::Raw<T, V> xs[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (e == lo)
            xs[q] = xs0[q];
          else if (ln.in(q))
            xs[q].load(xh_spill + (long long)f * hc + ln.col[q]);
          else
            xs[q].zero();
          const float inv = inv_s[ln.head[q]];
          cq[0][q] = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v)
            cq[0][q] = fmaf(LOWP ? round_bf(u[q][v] * inv) : u[q][v],
                            xs[q].at(v), cq[0][q]);
        }
        rows::head_sum(cq, ln, seg, heads);
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int h = ln.head[q];
          const float inv = inv_s[h];
          const long long o = (t * heads + h) * s_max + sp;
          const float cs = LOWP ? cq[0][q] : cq[0][q] * inv;
          const float er = expf(fminf(l_spill[o] - m_s[h], 60.f));
          const float w = er * (dm_sp != nullptr ? dm_sp[o] : 1.f);
          sea[q] = fmaf(w, cs, sea[q]);
          if (!ln.in(q)) continue;
          float dxs[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            dxs[v] = LOWP ? w * round_bf(u[q][v] * inv) : w * u[q][v] * inv;
          rows::store<float, V>(dxh_spill + (long long)f * hc + ln.col[q], dxs);
          if (el_ < k) {   // a head's lanes agree
            wcs_s[el_ * heads + h] = w * cs;
            ew_s[el_ * heads + h] = er;
          } else {
            dl_spill[o] = w * cs;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NV; ++q)
        if (ln.in(q)) ddn_s[ln.head[q]] = -sea[q] * inv_s[ln.head[q]];
      __syncwarp();
    }
    // d l_spill = w c_s + e_s ddenom (lanes own (entry, head) pairs)
    for (int o = lane; o < (hi - lo) * heads; o += WARP) {
      const int el_ = o / heads, h = o % heads;
      if (el_ < k) {
        const float spv = spf_s[el_];
        if (spv < 0.f) continue;
        dl_spill[(t * heads + h) * s_max + (long long)spv] =
            fmaf(ew_s[o], ddn_s[h], wcs_s[o]);
        continue;
      }
      const long long sp = own_entry(sp_perm[lo + el_], dst_loc, t, row, s_max);
      if (sp < 0) continue;
      const long long idx = (t * heads + h) * s_max + sp;
      dl_spill[idx] += expf(fminf(l_spill[idx] - m_s[h], 60.f)) * ddn_s[h];
    }

    // ---- per (slot, head): dl, d el, the weights (lanes own pairs) ------
    for (int o = lane; o < kh; o += WARP) {
      const int s = o / heads, h = o - s * heads;
      const float dmk = dm_s[o];
      const float d = e_s[o] * fmaf(dmk, a_s[o], ddn_s[h]) * lf_s[o];
      del[(long long)o * n + i] = d;
      dd[o] = d;
      const bool live = src_s[s] >= 0;
      const long long slot = i * kh + o;
      alpha[slot] = live ? e_s[o] * dmk * inv_s[h] : 0.f;
      dl[slot] = live ? d : 0.f;
    }
    __syncwarp();
    // ---- per head: d el_self, dac, the self message's coefficient -------
    for (int h = lane; h < heads; h += WARP) {
      float dsum = 0.f;
      for (int s = 0; s < k; ++s) dsum += dd[s * heads + h];
      const float es = es_s[h], dms = dms_s[h];
      const float dls =
          has_self ? es * fmaf(dms, b_s[h], ddn_s[h]) * fs_s[h] : 0.f;
      if (del_self != nullptr) del_self[(long long)h * n + i] = dls;
      dac[i * h2 + h] = dls;
      dac[i * h2 + heads + h] = dsum + dls;
      cself[i * heads + h] = has_self ? es * dms * inv_s[h] : 0.f;
      dls_s[h] = dls;
      dst_s[h] = dsum + dls;
    }
    __syncwarp();

    // ---- d acat: the row's own terms with its first group of in-band
    // rows, then any further groups
    if constexpr (TILED) {
      for (int tt = 0; tt < tiles; ++tt) {
        ln.init(lane, hc, c, tt * TILE);
        load_own();
        for (int s0 = 0; s0 < k; s0 += GROUP) {
          rows::load_group(rw, xh, src_s, s0, k, hc, ln);
          for (int hh = 0; hh < heads; ++hh) {
            const float dls = dls_s[hh], dst = dst_s[hh];
#pragma unroll
            for (int q = 0; q < NV; ++q) {
              if (!ln.in(q)) continue;
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float xv = rx[q].at(v);
                float tq = s0 == 0 ? xv * dls : 0.f;
#pragma unroll
                for (int w = 0; w < GROUP; ++w) {
                  const int s = s0 + w;
                  if (s >= k || src_s[s] < 0) continue;
                  tq = fmaf(dd[s * heads + hh], rw[w][q].at(v), tq);
                }
                float* a = pw + (long long)(ln.col[q] + v) * h2;
                a[hh] += tq;
                if (s0 == 0) a[heads + hh] = fmaf(xv, dst, a[heads + hh]);
              }
            }
          }
        }
      }
      __syncwarp();
      continue;
    }
    for (int s0 = 0; s0 < k; s0 += GROUP) {
      if (k > GROUP) rows::load_group(rw, xh, src_s, s0, k, hc, ln);
      for (int hh = 0; hh < heads; ++hh) {
        const float dls = dls_s[hh], dst = dst_s[hh];
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (!ln.in(q)) continue;
          float tq[V];
#pragma unroll
          for (int v = 0; v < V; ++v) tq[v] = s0 == 0 ? x[q][v] * dls : 0.f;
#pragma unroll
          for (int w = 0; w < GROUP; ++w) {
            const int s = s0 + w;
            if (s >= k || src_s[s] < 0) continue;
            const float d = dd[s * heads + hh];
#pragma unroll
            for (int v = 0; v < V; ++v) tq[v] = fmaf(d, rw[w][q].at(v), tq[v]);
          }
          float* p0 = aw + hh * hc + ln.col[q];
          float a0[V];
          rows::lds<V>(p0, a0);
#pragma unroll
          for (int v = 0; v < V; ++v) a0[v] += tq[v];
          rows::sts<V>(p0, a0);
          if (s0 == 0) {
            float* p1 = aw + (heads + hh) * hc + ln.col[q];
            float a1[V];
            rows::lds<V>(p1, a1);
#pragma unroll
            for (int v = 0; v < V; ++v) a1[v] = fmaf(x[q][v], dst, a1[v]);
            rows::sts<V>(p1, a1);
          }
        }
      }
    }
    __syncwarp();
  }

  // the block's partials of d acat [HC, 2 * heads]: its warps' in order
  if constexpr (TILED) return;
  __syncthreads();
  const float* aw0 = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem) + dst_tables_bytes(wpb, k, heads));
  for (int j = threadIdx.x; j < hc * h2; j += blockDim.x) {
    const int col = j / h2, hh = j - col * h2;
    float s = 0.f;
    for (int w = 0; w < wpb; ++w) s += aw0[((size_t)w * h2 + hh) * hc + col];
    part[(long long)blockIdx.x * hc * h2 + j] = s;
  }
}

// (3) One warp per source node j (grid-stride): dac[j, :heads] + the dl of
// its in-band slots (source-sorted: perm[row_ptr[j]:row_ptr[j + 1]]), then
// d xh[j, :] = cself[j] u[j] + sum_slots alpha u[dst] + acat @ dac[j]
// (bf16 form: each message alpha u[dst] and dac[j] rounded to bf16 first).
// acat [HC, 2 * heads] is staged once per block, transposed, as f32; TILED
// (rows wider than rows::chunks_for takes): the row's column tiles one
// after the other, acat read from global memory.
template <typename T, int V, int NV, bool TILED>
__global__ void __launch_bounds__(THREADS, rows::SRC_MIN_BLOCKS)
v2_bwd_src_kernel(const T* __restrict__ dout, const T* __restrict__ acat,
                  const float* __restrict__ alpha,
                  const float* __restrict__ dl,
                  const float* __restrict__ cself,
                  const float* __restrict__ dac,
                  const int* __restrict__ perm,
                  const int* __restrict__ row_ptr, T* __restrict__ dxh,
                  long long n, int k, int heads, int c) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float acat_t[];   // [2 * heads, HC]
  const int hc = heads * c, h2 = 2 * heads;
  if constexpr (!TILED) {
    for (int j = threadIdx.x; j < hc * h2; j += blockDim.x) {
      const int col = j / h2, jj = j - col * h2;
      acat_t[jj * hc + col] = ld(acat + j);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & (WARP - 1);
  const int wpb = blockDim.x / WARP;
  constexpr int TILE = WARP * NV * V;   // columns of a tile
  const int tiles = TILED ? (hc + TILE - 1) / TILE : 1;
  rows::Lanes<V, NV> ln;
  ln.init(lane, hc, c);
  const long long total = (long long)gridDim.x * wpb;
  for (long long j = (long long)blockIdx.x * wpb + threadIdx.x / WARP; j < n;
       j += total) {
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

    for (int tile = 0; tile < tiles; ++tile) {
      if (TILED) ln.init(lane, hc, c, tile * TILE);
      float acc[NV][V];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        rows::Raw<T, V> g;
        if (ln.in(q))
          g.load(dout + j * hc + ln.col[q]);
        else
          g.zero();
        const float cs = cself[j * heads + ln.head[q]];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[q][v] = cs * g.at(v);
      }
      for (int base = lo; base < hi; base += WARP) {
        const int mine = base + lane < hi ? perm[base + lane] : 0;
        const int cnt = hi - base < WARP ? hi - base : WARP;
#pragma unroll 4
        for (int tt = 0; tt < cnt; ++tt) {
          const long long slot = __shfl_sync(FULL, mine, tt);
          const long long i = slot / k;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            if (!ln.in(q)) continue;
            const float a = alpha[slot * heads + ln.head[q]];
            rows::Raw<T, V> g;
            g.load(dout + i * hc + ln.col[q]);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[q][v] = LOWP ? acc[q][v] + round_bf(a * g.at(v))
                               : fmaf(a, g.at(v), acc[q][v]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (!ln.in(q)) continue;
#pragma unroll
        for (int jj = 0; jj < 2 * MAX_HEADS; ++jj) {
          if (jj >= h2) break;
          float a[V];
          if constexpr (TILED) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              a[v] = ld(acat + (long long)(ln.col[q] + v) * h2 + jj);
          } else {
            rows::lds<V>(acat_t + jj * hc + ln.col[q], a);
          }
          const float dj = LOWP ? round_bf(d[jj]) : d[jj];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[q][v] = fmaf(dj, a[v], acc[q][v]);
        }
        rows::store<T, V>(dxh + j * hc + ln.col[q], acc[q]);
      }
    }
  }
}

// Runs f(destination kernel, source kernel) for the form of a call (the
// untiled instances that hold the row, else the tiled ones); returns f's
// result.
template <typename T, class F>
cudaError_t with_v2_kernels(int width, int hc, F&& f) {
  constexpr int VW = sizeof(T) == 2 ? 8 : 4;
  const auto pick = [&](auto vw) {
    constexpr int V = decltype(vw)::value;
    return rows::with_row_form<V>(hc, [&](auto nv, auto tiled) {
      constexpr int NV = decltype(nv)::value;
      constexpr bool TILED = decltype(tiled)::value;
      return f(v2_bwd_dst_kernel<T, V, NV, TILED>,
               v2_bwd_src_kernel<T, V, NV, TILED>);
    });
  };
  if (width == VW) return pick(std::integral_constant<int, VW>{});
  return pick(std::integral_constant<int, 1>{});
}

template <class F>
cudaError_t with_v2_form(int dtype, int width, int hc, F&& f) {
  if (dtype == 1) return with_v2_kernels<bf16>(width, hc, f);
  return with_v2_kernels<float>(width, hc, f);
}

}  // namespace

// The number of destination-pass blocks kernel D' launches for a call of
// this form (as many as stay resident on the current card, at most one
// per warp's row), i.e. the rows of its d acat partials; 0 when it cannot
// take the call (one warp's tables and, untiled, its d acat accumulator
// [2 * heads, HC] over the card's shared memory: the limit D's and the
// dots' staged a_cat_mat have too).
extern "C" int ell_gat_v2_bwd_blocks(int dtype, long long n, int k,
                                     int heads, int c, int vec) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 ||
      (dtype != 0 && dtype != 1))
    return 0;
  const int hc = heads * c;
  const int width = rows::row_width(dtype == 1, vec, c);
  const bool tiled = rows::row_tiled(hc, width);
  const int wpb = dst_warps(k, heads, hc, tiled);
  const size_t smem = dst_smem(wpb, k, heads, hc, tiled);
  int blocks = 0;
  const cudaError_t err = with_v2_form(
      dtype, width, hc, [&](auto dst, auto) {
        if (!rows::allow_smem(dst, smem)) return cudaErrorInvalidValue;
        blocks = rows::resident_blocks(dst, wpb * WARP, smem,
                                       (n + wpb - 1) / wpb);
        return cudaSuccess;
      });
  return err == cudaSuccess ? blocks : 0;
}

template <typename T>
int launch_v2_bwd(const void* xh, const void* acat, const void* loc,
                  const void* el, const void* el_self, const void* l_spill,
                  const void* xh_spill, const void* dst_loc,
                  const void* sp_perm, const void* sp_row_ptr,
                  const void* dmask, const void* dmask_sp, const void* dout,
                  const void* band_perm, const void* band_row_ptr, void* ac,
                  void* alpha, void* dl, void* cself, void* dac, void* dxh,
                  void* del, void* del_self, void* dl_spill, void* dxh_spill,
                  void* part, long long n, int k, int heads, int c, int r,
                  int s_max, float slope, int width, int blocks,
                  bool ac_given, cudaStream_t s) {
  const int hc = heads * c, h2 = 2 * heads;
  const T* txh = static_cast<const T*>(xh);
  const T* tacat = static_cast<const T*>(acat);
  cudaError_t err = cudaSuccess;
  if (!ac_given) {
    err = rows::launch_mat_dots<T>(txh, tacat, static_cast<float*>(ac), n,
                                   hc, h2, s);
    if (err != cudaSuccess) return (int)err;
  }
  const bool tiled = rows::row_tiled(hc, width);
  const int wpb = dst_warps(k, heads, hc, tiled);
  const size_t dsmem = dst_smem(wpb, k, heads, hc, tiled);
  const size_t ssmem = tiled ? 0 : (size_t)hc * h2 * sizeof(float);
  const int seg = rows::head_lanes(c, width);
  err = with_v2_kernels<T>(width, hc, [&](auto dst, auto src) {
    if (!rows::allow_smem(dst, dsmem) || !rows::allow_smem(src, ssmem))
      return cudaErrorInvalidValue;
    dst<<<(unsigned)blocks, wpb * WARP, dsmem, s>>>(
        txh, static_cast<const float*>(ac), static_cast<const int*>(loc),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<const float*>(l_spill), static_cast<const T*>(xh_spill),
        static_cast<const int*>(dst_loc), static_cast<const int*>(sp_perm),
        static_cast<const int*>(sp_row_ptr), static_cast<const float*>(dmask),
        static_cast<const float*>(dmask_sp), static_cast<const T*>(dout),
        static_cast<float*>(alpha), static_cast<float*>(dl),
        static_cast<float*>(cself), static_cast<float*>(dac),
        static_cast<float*>(del), static_cast<float*>(del_self),
        static_cast<float*>(dl_spill), static_cast<float*>(dxh_spill),
        static_cast<float*>(part), n, k, heads, c, r, s_max, slope, seg);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int sblocks = rows::resident_blocks(
        src, THREADS, ssmem, (n + THREADS / WARP - 1) / (THREADS / WARP));
    src<<<(unsigned)sblocks, THREADS, ssmem, s>>>(
        static_cast<const T*>(dout), tacat, static_cast<const float*>(alpha),
        static_cast<const float*>(dl), static_cast<const float*>(cself),
        static_cast<const float*>(dac), static_cast<const int*>(band_perm),
        static_cast<const int*>(band_row_ptr), static_cast<T*>(dxh), n, k,
        heads, c);
    return cudaGetLastError();
  });
  return (int)err;
}

// Kernel D'. dtype: 0 = float32, 1 = bfloat16 (xh, acat, xh_spill, dout,
// dxh). Inputs as ell_gat_v2_fwd (xh, acat, loc, el, el_self, l_spill,
// xh_spill, dst_loc, dmask, dmask_sp), the spill entries grouped by
// destination, sp_perm [T * S] / sp_row_ptr [n + 1] int32 (over the flat
// t * S + s entries whose dst_loc is live: BandedEll.spill_perm_d /
// spill_row_ptr_d), the output cotangent dout [n, HC] and the in-band
// slots' source-sorted tables band_perm [n * k] / band_row_ptr [n + 1]
// int32. Scratch: ac [n, 2 * heads], alpha and dl [n * k, heads], cself
// [n, heads], dac [n, 2 * heads], f32; ac [n, 2 * heads] f32 holds, when
// ac_given is 1, the attention dots kernel D wrote for the same xh and acat
// (ell_gat_v2_fwd's ac: the dots launch is then skipped; the same bits
// either way), else it is scratch for them. Outputs: dxh [n, HC], del [k *
// heads, n], del_self [heads, n] (null without a self loop), dl_spill [T,
// heads, S] and dxh_spill [T, S, HC] (f32, every entry written: 0 at dead
// entries), part [blocks, HC, 2 * heads] f32 (partials of d acat;
// `blocks` must be ell_gat_v2_bwd_blocks of the same form). vec 4
// (16-byte row chunks) needs 16-byte aligned xh, xh_spill, dout, dxh and
// dxh_spill; the chunks are 4 floats (c % 4 == 0) or 8 bf16 (c % 8 == 0),
// else single columns; rows wider than HC 2048 (f32) or 4096 (bf16), 1024
// in single columns, run in column tiles (rows::TILE_NV).
// Launches on `stream`; returns the CUDA
// error code of the launches.
extern "C" int ell_gat_v2_bwd(
    int dtype, const void* xh, const void* acat, const void* loc,
    const void* el, const void* el_self, const void* l_spill,
    const void* xh_spill, const void* dst_loc, const void* sp_perm,
    const void* sp_row_ptr, const void* dmask, const void* dmask_sp,
    const void* dout, const void* band_perm, const void* band_row_ptr,
    void* ac, void* alpha, void* dl, void* cself, void* dac, void* dxh,
    void* del, void* del_self, void* dl_spill, void* dxh_spill, void* part,
    long long n, int k, int heads, int c, int r, int s_max, float slope,
    int vec, int blocks, int ac_given, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || s_max < 1 || blocks < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) ||
      ((dmask == nullptr) != (dmask_sp == nullptr)) ||
      (dtype != 0 && dtype != 1) || sp_perm == nullptr ||
      sp_row_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = rows::row_width(dtype == 1, vec, c);
  if (dtype == 1)
    return launch_v2_bwd<bf16>(
        xh, acat, loc, el, el_self, l_spill, xh_spill, dst_loc, sp_perm,
        sp_row_ptr, dmask, dmask_sp, dout, band_perm, band_row_ptr, ac,
        alpha, dl, cself, dac, dxh, del, del_self, dl_spill, dxh_spill, part,
        n, k, heads, c, r, s_max, slope, width, blocks, ac_given != 0, s);
  return launch_v2_bwd<float>(
      xh, acat, loc, el, el_self, l_spill, xh_spill, dst_loc, sp_perm,
      sp_row_ptr, dmask, dmask_sp, dout, band_perm, band_row_ptr, ac, alpha,
      dl, cself, dac, dxh, del, del_self, dl_spill, dxh_spill, part, n, k,
      heads, c, r, s_max, slope, width, blocks, ac_given != 0, s);
}

extern "C" const char* ell_gat_v2_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
