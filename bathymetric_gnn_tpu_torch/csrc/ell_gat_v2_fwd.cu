// Fused banded-ELL GAT layer with the spill edges folded in (kernel D),
// forward, for Hopper (sm_90a), CUDA C++, f32 and bf16.
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
// bf16 form (compute_dtype="bfloat16"): xh, acat and the gathered spill
// rows are read as bf16 and out is written as bf16; logits, the softmax
// and the sums run in f32. Each spill message d_s e_s xh_spill[t, s] is
// rounded to bf16 before it is added, as the TPU kernel rounds the
// operands of its spill dot (_kernel_v2:400-411).
//
// The TPU kernel keeps a 3R-row window of xh in VMEM per band, gathers by
// one-hot matmuls on the MXU and scans the band's whole spill table for
// each row block. Hopper gathers rows directly, so this kernel reads each
// in-band source's row (from L2: Hilbert order keeps the window's rows
// close) and visits only the row's own spill entries. Two kernels behind
// one C entry:
//   (1) the attention dots ac [N, 2 * heads] (ell_gat_rows.cuh
//       launch_mat_dots; D' takes them from D's call, the same bits);
//   (2) the row pass, on kernel E's forward layout (ell_gat_rows.cuh, "the
//       forward passes"): a grid-stride loop over destinations, a lane group
//       per destination (the fewest lanes that hold the HC row at two
//       16-byte chunks a lane, so that a warp holds 32 / lanes destinations
//       at once), the first slots of loc of a group's next destination
//       fetched one destination ahead, and of the row's spill entries by
//       destination (BandedEll.spill_perm_d / spill_row_ptr_d) the range
//       two destinations ahead and the first entries one ahead. The group
//       lists the slots with a window source densely, then the row's own
//       spill entries after them (a ballot each: a dead or spilled slot and
//       a band without spills cost nothing, and no row but the listed ones
//       is read); requests the softmax's terms (ac, el, the dropout
//       multipliers, the spill logits and each spill entry's dst_loc), then
//       the self row and the first 8 listed rows, in-band and spill
//       together, all in flight at once; takes the in-band softmax over
//       (slot, head) pairs, every head at once (rows::pair_softmax), then
//       the spill exponents against its max in the same pair lanes; and
//       sums the weighted rows, self, in-band, spill, once, dividing by the
//       joint denominator at the end. Column tiles take any HC. A row with
//       more spill entries than K (band_ell never gives one: each is one of
//       the row's K slots) visits the rest one by one after the listed
//       ones.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 262,144, K = 8, HC 256 it must read xh (268 MB), el (33.6 MB),
// loc (8.4 MB), the live spill rows (138,213 x 1 KB, 142 MB) and tables,
// and write out (268 MB): ~0.71 GB, ~0.21 ms; its ~2 GFLOP take ~0.03 ms
// at the FP32 rate: bound by bytes (bf16 halves the xh, spill-row and out
// streams). Besides that it reads xh once more (the dots) and each in-band
// neighbour row once more per slot from L2. The design's answer is the
// one of kernels C and E: bytes are few, so the time is set by the nodes
// in flight and by each node's chain of dependent round trips, which the
// prefetches and the single group of requests keep to one.

#include "ell_gat_banded.cuh"
#include "ell_gat_rows.cuh"

using namespace band;
using rows::FwdGeom;
using rows::FwdRow;

namespace {

// The first version's shared memory for 8 warps (its per-warp softmax
// tables [(K + 3) * heads] floats and K sources): the C entry still
// refuses the shapes it refused, and no other.
size_t first_version_smem(int k, int heads) {
  const int wpb = THREADS / WARP;
  size_t f = (size_t)wpb * (k + 3) * heads * sizeof(float);
  f = (f + 7) / 8 * 8;
  return f + (size_t)wpb * k * sizeof(long long);
}

// One destination's lists in shared memory: per head the dropped self
// weight, the denominator and the in-band max [3, hp]; the pairs' logits,
// then weights [2K, hp] (the in-band entries, then the spill entries);
// per entry its slot (in-band) or its position in the band's spill table
// [2K] and, for a spill entry, whether dst_loc names the row [K] (ints);
// then, 8-byte aligned, each entry's source row (in-band) or flat spill
// entry t * S + s [2K] (long long).
__host__ __device__ inline size_t v2_src_offset(int k, int hp) {
  return ((size_t)(3 + 2 * k) * hp * sizeof(float) +
          (size_t)3 * k * sizeof(int) + 7) / 8 * 8;
}
__host__ __device__ inline size_t v2_node_bytes(int k, int hp) {
  return v2_src_offset(k, hp) + (size_t)2 * k * sizeof(long long);
}

// The warps of a row-pass block at one destination a warp: the most (<= 4)
// whose lists fit in 48 KB, else 1.
int v2_warps(int k, int hp) {
  for (int wpb = rows::FWD_WARPS; wpb > 1; --wpb)
    if (wpb * v2_node_bytes(k, hp) <= 48 * 1024) return wpb;
  return 1;
}

// A lane's part of one destination's gather: FwdRow's tiles and rows, with
// the listed entries u < nl read from xh (in-band sources) and nl <= u <
// ne from xh_spill (flat spill entries).
template <typename T, int V>
struct V2Row : FwdRow<T, V> {
  using B = FwdRow<T, V>;
  static constexpr int NV = B::NV;

  // Requests the self row (when u0 is 0 and self >= 0) and the rows of the
  // entries u0 .. u0 + FWD_GROUP - 1 below ne.
  __device__ __forceinline__ void request(const T* __restrict__ xh,
                                          const T* __restrict__ xh_spill,
                                          long long self,
                                          const long long* src, int u0,
                                          int nl, int ne, int hc) {
    if (u0 == 0) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (self >= 0 && B::in(q))
          B::xs[q].load(xh + self * hc + B::col[q]);
        else
          B::xs[q].zero();
      }
    }
#pragma unroll
    for (int f = 0; f < rows::FWD_GROUP; ++f) {
      const int u = u0 + f;
      const long long j = u < ne ? src[u] : -1;
      const T* base = u < nl ? xh : xh_spill;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if (j >= 0 && B::in(q))
          B::r[f][q].load(base + j * hc + B::col[q]);
        else
          B::r[f][q].zero();
      }
    }
  }

  // acc = ws[h] x_self + sum_u w[u * hp + h] row_u over the tile's chunks
  // (ws null: no self term), the entries in order; the spill entries
  // (u >= nl) whose dst_loc does not name the row (own[u - nl] 0) are
  // skipped, and in the bf16 form each spill message is rounded to bf16
  // before it is added. The first group of rows (request with u0 = 0)
  // must have been requested.
  __device__ __forceinline__ void sum(float (&acc)[NV][V],
                                      const T* __restrict__ xh,
                                      const T* __restrict__ xh_spill,
                                      const long long* src, const float* w,
                                      const float* ws, const int* own,
                                      int nl, int ne, int hp, int hc) {
    constexpr bool LOWP = sizeof(T) == 2;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float a = ws != nullptr ? ws[B::head[q]] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = a * B::xs[q].at(v);
    }
    for (int u0 = 0; u0 < ne; u0 += rows::FWD_GROUP) {
      if (u0 > 0) request(xh, xh_spill, -1, src, u0, nl, ne, hc);
#pragma unroll
      for (int f = 0; f < rows::FWD_GROUP; ++f) {
        const int u = u0 + f;
        if (u >= ne || (u >= nl && own[u - nl] == 0)) continue;
        const bool round = LOWP && u >= nl;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float wv = w[u * hp + B::head[q]];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float x = B::r[f][q].at(v);
            acc[q][v] = round ? acc[q][v] + round_bf(wv * x)
                              : fmaf(wv, x, acc[q][v]);
          }
        }
      }
    }
  }
};

template <typename T, int V>
__global__ void
__launch_bounds__(rows::FWD_WARPS * WARP, rows::FWD_MIN_BLOCKS)
v2_fwd_kernel(const T* __restrict__ xh, const float* __restrict__ ac,
              const int* __restrict__ loc, const float* __restrict__ el,
              const float* __restrict__ el_self,
              const float* __restrict__ l_spill,
              const T* __restrict__ xh_spill,
              const int* __restrict__ dst_loc,
              const int* __restrict__ sp_perm,
              const int* __restrict__ sp_row_ptr,
              const float* __restrict__ dm, const float* __restrict__ dm_sp,
              T* __restrict__ out, long long n, int k, int heads, int c,
              int r, int s_max, float slope, FwdGeom gm, int hp, int lg_hp) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ long long smem_ll[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int lg_lpr = gm.lg_lpr;
  const int lpr = 1 << lg_lpr;
  const int groups = WARP >> lg_lpr;
  const int g = lane >> lg_lpr;
  const int lr = lane & (lpr - 1);
  char* base_p = reinterpret_cast<char*>(smem_ll) +
                 (size_t)(warp * groups + g) * v2_node_bytes(k, hp);
  float* ws = reinterpret_cast<float*>(base_p);      // dropped self [hp]
  float* den_s = ws + hp;                            // [hp]
  float* m_s = den_s + hp;                           // [hp]
  float* we = m_s + hp;                              // [2K, hp]
  int* slot = reinterpret_cast<int*>(we + 2 * k * hp);   // [2K]
  int* own = slot + 2 * k;                           // [K]
  long long* src = reinterpret_cast<long long*>(
      base_p + v2_src_offset(k, hp));                // [2K]
  const int hc = heads * c;
  const int h2 = 2 * heads;
  const long long bands = n / r;
  const bool has_self = el_self != nullptr;
  const int h = lr & (hp - 1);
  const bool hv = h < heads;
  const int hh = hv ? h : 0;
  constexpr int NV = rows::FWD_NV;
  V2Row<T, V> row;

  // Ahead of the group's destination i: loc of the first lpr slots of the
  // next one, the spill range of the next (nx_*) and the one after, and
  // the next one's first lpr spill entries.
  const long long total = (long long)gridDim.x * wpb * groups;
  long long i = ((long long)blockIdx.x * wpb + warp) * groups + g;
  int pre_loc = -1, pre_f = -1, nx_lo = 0, nx_hi = 0;
  const auto range = [&](long long node, int& lo, int& hi) {
    lo = hi = 0;
    if (node < n) {
      lo = sp_row_ptr[node];
      hi = sp_row_ptr[node + 1];
    }
  };
  const auto prefetch = [&](long long node, int lo, int hi) {
    pre_loc = pre_f = -1;
    if (node < n && lr < k) pre_loc = loc[(long long)lr * n + node];
    if (lr < hi - lo && lr < k) pre_f = sp_perm[lo + lr];
  };
  int cur_lo, cur_hi;
  range(i, cur_lo, cur_hi);
  prefetch(i, cur_lo, cur_hi);
  range(i + total, nx_lo, nx_hi);
  for (long long base = i - g; base < n; base += total, i += total) {
    const bool act = i < n;
    const long long t = i / r;
    const int rrow = (int)(i - t * r);
    const int lo = cur_lo, hi = cur_hi;
    const long long j0 = act ? window_source(pre_loc, i, r, bands) : -1;
    const int f0 = pre_f;
    cur_lo = nx_lo;
    cur_hi = nx_hi;
    prefetch(i + total, cur_lo, cur_hi);
    range(i + 2 * total, nx_lo, nx_hi);

    // ---- the slots with a window source, then the row's spill entries --
    int nl = rows::append_live(j0, lr, lane, lg_lpr, 0, src, slot);
    for (int s0 = lpr; s0 < k; s0 += lpr) {
      const int s = s0 + lr;
      const long long j =
          act && s < k ? window_source(loc[(long long)s * n + i], i, r, bands)
                       : -1;
      nl = rows::append_live(j, s, lane, lg_lpr, nl, src, slot);
    }
    // entries lo .. lo + K - 1 of the row's range (the rest: the tail)
    const int ncap = act ? min(hi - lo, k) : 0;
    int ne = nl;
    for (int e0 = 0; e0 < k; e0 += lpr) {
      if (!__any_sync(FULL, e0 < ncap)) break;   // the same in every lane
      const int e = e0 + lr;
      const int f = e < ncap ? (e0 == 0 ? f0 : sp_perm[lo + e]) : -1;
      const long long sp = (long long)f - t * s_max;
      const bool listed = f >= 0 && sp >= 0 && sp < s_max;
      ne = rows::append_live(listed ? (long long)f : -1LL, (int)sp, lane,
                             lg_lpr, ne, src, slot);
    }
    __syncwarp();
    const int ns = ne - nl;

    // ---- the loads: the softmax's first, then the first tile's rows -----
    const int np = nl << lg_hp;
    const int nsp = ns << lg_hp;
    const auto pair_terms = [&](int p, float& a_j, float& e_j) {
      const int u = p >> lg_hp;
      a_j = ac[src[u] * h2 + hh];
      e_j = el[((long long)slot[u] * heads + hh) * n + i];
    };
    const auto pair_drop = [&](int p) {
      return dm != nullptr
                 ? dm[((long long)slot[p >> lg_hp] * heads + hh) * n + i]
                 : 1.f;
    };
    const auto spill_terms = [&](int q, float& l, float& d, int& dl) {
      const int u = nl + (q >> lg_hp);
      const long long o = (t * heads + hh) * s_max + slot[u];
      l = l_spill[o];
      d = dm_sp != nullptr ? dm_sp[o] : 1.f;
      dl = dst_loc[src[u]];
    };
    float a_j = 0.f, e_j = 0.f, d_j = 1.f, a_dst = 0.f, a_self = 0.f;
    float e_self_in = 0.f, d_self = 1.f, l_q = 0.f, d_q = 1.f;
    int dl_q = -1;
    if (lr < np) {
      pair_terms(lr, a_j, e_j);
      d_j = pair_drop(lr);
    }
    if (lr < nsp) spill_terms(lr, l_q, d_q, dl_q);
    if (act) {
      a_dst = ac[i * h2 + heads + hh];
      a_self = ac[i * h2 + hh];
      if (has_self) e_self_in = el_self[(long long)hh * n + i];
      if (dm != nullptr) d_self = dm[((long long)k * heads + hh) * n + i];
    }
    const long long self = act && has_self ? i : -1;
    row.tile(0, lr, lg_lpr, hc, c);
    row.request(xh, xh_spill, self, src, 0, nl, ne, hc);

    // ---- the in-band softmax over (slot, head) pairs ----------------------
    const float self_l =
        has_self ? leaky(a_self + a_dst + e_self_in, slope) : -1e4f;
    float m = self_l, e0;
    const float sum = rows::pair_softmax(
        np, lg_hp, hv, lr, lg_lpr, leaky(a_j + a_dst + e_j, slope),
        [&](int p) {
          float a, e;
          pair_terms(p, a, e);
          return leaky(a + a_dst + e, slope);
        },
        we, m, e0);
    const float es = has_self ? expf(self_l - m) : 0.f;
    // the weights: dropped, the denominator's terms not
    if (hv && lr < np) we[lr] = e0 * d_j;
    for (int p = lr + lpr; p < np; p += lpr)
      if (hv) we[p] *= pair_drop(p);
    // ---- the spill exponents against the in-band max ---------------------
    float ssum = 0.f;
    const auto spill_pair = [&](int q, float l, float d, int dl) {
      const bool mine = dl == rrow;
      const float e = mine ? expf(fminf(l - m, 60.f)) : 0.f;
      we[np + q] = e * d;
      ssum += e;
      if ((q & (hp - 1)) == 0) own[q >> lg_hp] = mine ? 1 : 0;
    };
    if (lr < nsp) spill_pair(lr, l_q, d_q, dl_q);
    for (int q = lr + lpr; q < nsp; q += lpr) {
      float l, d;
      int dl;
      spill_terms(q, l, d, dl);
      spill_pair(q, l, d, dl);
    }
    ssum = rows::pair_sum(ssum, hp, lpr);
    if (lr < hp && hv) {
      ws[h] = es * d_self;
      den_s[h] = fmaxf(sum + es, 1e-16f) + ssum;
      m_s[h] = m;
    }
    __syncwarp();

    // ---- the weighted gather-sum, normalized once ------------------------
    T* orow = out + i * hc;
    for (int tl = 0; tl < gm.tiles; ++tl) {
      if (tl > 0) {
        row.tile(tl, lr, lg_lpr, hc, c);
        row.request(xh, xh_spill, self, src, 0, nl, ne, hc);
      }
      float acc[NV][V];
      row.sum(acc, xh, xh_spill, src, we, has_self ? ws : nullptr, own, nl,
              ne, hp, hc);
      // the row's spill entries past the first K, one by one
      float dt[NV] = {};
      for (int e = lo + k; act && e < hi; ++e) {
        const int f = sp_perm[e];
        const long long sp = (long long)f - t * s_max;
        if (f < 0 || sp < 0 || sp >= s_max || dst_loc[f] != rrow) continue;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (!row.in(q)) continue;
          const int hq = row.head[q];
          const long long o = (t * heads + hq) * s_max + sp;
          const float ex = expf(fminf(l_spill[o] - m_s[hq], 60.f));
          const float wv = ex * (dm_sp != nullptr ? dm_sp[o] : 1.f);
          rows::Raw<T, V> x;
          x.load(xh_spill + (long long)f * hc + row.col[q]);
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[q][v] = LOWP ? acc[q][v] + round_bf(wv * x.at(v))
                             : fmaf(wv, x.at(v), acc[q][v]);
          dt[q] += ex;
        }
      }
      if (act) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (!row.in(q)) continue;
          const float inv = 1.f / (den_s[row.head[q]] + dt[q]);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[q][v] *= inv;
          rows::store<T, V>(orow + row.col[q], acc[q]);
        }
      }
    }
    __syncwarp();   // the next destinations' lists overwrite these
  }
}

}  // namespace

template <typename T>
int launch_v2_fwd(const void* xh, const void* acat, const void* loc,
                  const void* el, const void* el_self, const void* l_spill,
                  const void* xh_spill, const void* dst_loc,
                  const void* sp_perm, const void* sp_row_ptr,
                  const void* dmask, const void* dmask_sp, void* ac,
                  void* out, long long n, int k, int heads, int c, int r,
                  int s_max, float slope, int vec, cudaStream_t s) {
  const T* txh = static_cast<const T*>(xh);
  const int hc = heads * c;
  cudaError_t err = rows::launch_mat_dots<T>(
      txh, static_cast<const T*>(acat), static_cast<float*>(ac), n, hc,
      2 * heads, s);
  if (err != cudaSuccess) return (int)err;
  const int hp = rows::pair_stride(heads);
  int lg_hp = 0;
  while ((1 << lg_hp) < hp) ++lg_hp;
  const int wpb = v2_warps(k, hp);
  const size_t node_bytes = v2_node_bytes(k, hp);
  err = rows::with_fwd_form<T>(vec, c, [&](auto v_c) {
    constexpr int V = decltype(v_c)::value;
    auto* kernel = v2_fwd_kernel<T, V>;
    const FwdGeom gm = rows::fwd_geom(hc, V, hp, node_bytes);
    const int groups = WARP >> gm.lg_lpr;
    const size_t smem = (size_t)wpb * groups * node_bytes;
    if (!rows::allow_smem(kernel, smem)) return cudaErrorInvalidValue;
    const long long cap = (n + (long long)wpb * groups - 1) / (wpb * groups);
    const int blocks = rows::resident_blocks(kernel, wpb * WARP, smem, cap);
    kernel<<<(unsigned)blocks, wpb * WARP, smem, s>>>(
        txh, static_cast<const float*>(ac), static_cast<const int*>(loc),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<const float*>(l_spill), static_cast<const T*>(xh_spill),
        static_cast<const int*>(dst_loc), static_cast<const int*>(sp_perm),
        static_cast<const int*>(sp_row_ptr), static_cast<const float*>(dmask),
        static_cast<const float*>(dmask_sp), static_cast<T*>(out), n, k,
        heads, c, r, s_max, slope, gm, hp, lg_hp);
    return cudaGetLastError();
  });
  return (int)err;
}

// Kernel D. dtype: 0 = float32, 1 = bfloat16 (xh, acat, xh_spill, out). xh
// [n, heads * c]; acat [heads * c, 2 * heads]; loc [k, n] int32; el
// [k * heads, n] f32 (NEG_BIG in dead and spilled slots); el_self [heads,
// n] f32 or null (no self loop); l_spill [T, heads, S] f32; xh_spill [T,
// S, heads * c]; dst_loc [T, S] int32 (-1 dead); the spill entries grouped
// by destination, sp_perm [T * S] / sp_row_ptr [n + 1] int32 (over the
// flat t * S + s entries whose dst_loc is live: BandedEll.spill_perm_d /
// spill_row_ptr_d; an entry outside its row's band or whose dst_loc does
// not name the row is skipped); dmask [(k + 1) * heads, n] and dmask_sp
// [T, heads, S] f32, both or neither (null: no dropout); ac [n, 2 * heads]
// f32 (written: the attention dots, which D' can take); out [n, heads *
// c]. T = n / r. vec 4 needs c % 4 == 0 and 16-byte aligned xh, xh_spill
// and out (the rows then go in 16-byte chunks when c is a multiple of 4
// floats or 8 bf16, else in single columns); any HC. Launches on
// `stream`; returns the CUDA error code of the launches.
extern "C" int ell_gat_v2_fwd(int dtype, const void* xh, const void* acat,
                              const void* loc, const void* el,
                              const void* el_self, const void* l_spill,
                              const void* xh_spill, const void* dst_loc,
                              const void* sp_perm, const void* sp_row_ptr,
                              const void* dmask, const void* dmask_sp,
                              void* ac, void* out, long long n, int k,
                              int heads, int c, int r, int s_max, float slope,
                              int vec, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || s_max < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) ||
      ((dmask == nullptr) != (dmask_sp == nullptr)) ||
      (dtype != 0 && dtype != 1) || sp_perm == nullptr ||
      sp_row_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  if (first_version_smem(k, heads) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_v2_fwd<bf16>(xh, acat, loc, el, el_self, l_spill, xh_spill,
                               dst_loc, sp_perm, sp_row_ptr, dmask, dmask_sp,
                               ac, out, n, k, heads, c, r, s_max, slope, vec,
                               s);
  return launch_v2_fwd<float>(xh, acat, loc, el, el_self, l_spill, xh_spill,
                              dst_loc, sp_perm, sp_row_ptr, dmask, dmask_sp,
                              ac, out, n, k, heads, c, r, s_max, slope, vec,
                              s);
}

// The attention dots of kernels D, D' and E alone: ac [n, m_cols] f32 of
// xh [n, hc] and acat [hc, m_cols] (dtype as ell_gat_v2_fwd). generic 1
// runs the generic form (rows::mat_dots_kernel, the form every shape had
// before the register form), for holding the two against each other bit
// for bit and for timing.
extern "C" int ell_gat_mat_dots(int dtype, const void* xh, const void* acat,
                                void* ac, long long n, int hc, int m_cols,
                                int generic, void* stream) {
  if (n < 1 || hc < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)rows::launch_mat_dots<bf16>(
        static_cast<const bf16*>(xh), static_cast<const bf16*>(acat),
        static_cast<float*>(ac), n, hc, m_cols, s, generic != 0);
  return (int)rows::launch_mat_dots<float>(
      static_cast<const float*>(xh), static_cast<const float*>(acat),
      static_cast<float*>(ac), n, hc, m_cols, s, generic != 0);
}

extern "C" const char* ell_gat_v2_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
