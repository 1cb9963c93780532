// Band part of the banded-ELL GAT layer (kernel E), for Hopper (sm_90a),
// CUDA C++, f32 and bf16, forward only.
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
// bf16 form (compute_dtype="bfloat16"): xh and acat are read as bf16, and
// y, m and denom are f32 as in the TPU kernel (it has no lowp output); the
// dots, the softmax and the sum run in f32.
//
// The TPU kernel keeps a 3R-row window of xh in VMEM per band and gathers
// by one-hot matmuls on the MXU, since the TPU has no fast gather. Hopper
// gathers rows directly, so this kernel reads each in-band source's row
// (from L2: Hilbert order keeps the window's rows close) and needs no
// window. Two kernels behind one C entry:
//   (1) the attention dots ac [N, 2 * heads] (ell_gat_rows.cuh
//       launch_mat_dots, shared with D and D', whose bits they keep);
//   (2) the band pass, kernel C's aggregate on the band layout
//       (ell_gat_rows.cuh, "the forward passes"): a grid-stride loop over
//       destinations, a lane group per destination (the fewest lanes that
//       hold the HC row at two 16-byte chunks a lane, so that a warp holds
//       32 / lanes destinations at once), the first slots of loc of a
//       group's next destination fetched one destination ahead. The group
//       lists the slots with a window source densely (a ballot), so that
//       dead and spilled slots cost nothing and their rows are never read;
//       requests the softmax's terms, then the self row and the first 8
//       listed rows, all in flight together; and takes the softmax over
//       (slot, head) pairs, every head at once (rows::pair_softmax),
//       leaving the weights unnormalized. el [K * heads, N] is read one
//       float of each pair's row a lane: the warps walk the destinations
//       interleaved, so the destinations in flight at once are neighbours
//       and read the rest of each 32-byte sector (and their rows share L2
//       lines). Coalesced el reads, one lane a destination over 32
//       consecutive destinations a warp, measured slower on the H100: the
//       warps then walk 32 destinations each, every destination of the
//       graph is in flight at once, and the neighbour rows thrash L2.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor):
// at N = 65,536, K = 8, HC 256, 4 heads it must read xh (67.1 MB), el
// (8.4 MB), loc (2.1 MB), el_self and acat, and write y (67.1 MB) and the
// two statistics: ~146 MB, ~0.044 ms; its ~0.5 GFLOP take ~0.008 ms at the
// FP32 rate, so it is bound by bytes (bf16 halves the xh read). It reads
// xh twice (dots, then the gather), each in-band neighbour row once more
// per slot from L2, and the a_src of each slot's source.

#include "ell_gat_banded.cuh"
#include "ell_gat_rows.cuh"

using namespace band;
using rows::FwdGeom;
using rows::FwdRow;

namespace {

// One destination's lists in shared memory: the self terms [hp] and the
// pairs' logits, then exponentials [K, hp] (floats), the listed slots'
// numbers [K] (ints), then, 8-byte aligned, their window sources [K]
// (long long).
__host__ __device__ inline size_t band_src_offset(int k, int hp) {
  return ((size_t)(k + 1) * hp * sizeof(float) + k * sizeof(int) + 7) / 8 *
         8;
}
__host__ __device__ inline size_t band_node_bytes(int k, int hp) {
  return band_src_offset(k, hp) + (size_t)k * sizeof(long long);
}

// The warps of a band-pass block at one destination a warp: the most
// (<= 4) whose lists fit in 48 KB, else 1.
int band_warps(int k, int hp) {
  for (int wpb = rows::FWD_WARPS; wpb > 1; --wpb)
    if (wpb * band_node_bytes(k, hp) <= 48 * 1024) return wpb;
  return 1;
}

template <typename T, int V>
__global__ void
__launch_bounds__(rows::FWD_WARPS * WARP, rows::FWD_MIN_BLOCKS)
band_kernel(const T* __restrict__ xh, const float* __restrict__ ac,
            const int* __restrict__ loc, const float* __restrict__ el,
            const float* __restrict__ el_self, float* __restrict__ y,
            float* __restrict__ m_out, float* __restrict__ den_out,
            long long n, int k, int heads, int c, int r, float slope,
            FwdGeom gm, int hp, int lg_hp) {
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
                 (size_t)(warp * groups + g) * band_node_bytes(k, hp);
  float* ws = reinterpret_cast<float*>(base_p);       // self terms [hp]
  float* we = ws + hp;                                // [K, hp]
  int* slot = reinterpret_cast<int*>(we + k * hp);    // [K]
  long long* src = reinterpret_cast<long long*>(
      base_p + band_src_offset(k, hp));               // [K]
  const int hc = heads * c;
  const int h2 = 2 * heads;
  const long long bands = n / r;
  const bool has_self = el_self != nullptr;
  const int h = lr & (hp - 1);
  const bool hv = h < heads;
  const int hh = hv ? h : 0;
  constexpr int NV = rows::FWD_NV;
  FwdRow<T, V> row;

  // loc of the first lpr slots of the group's next destination
  int pre_loc = -1;
  const auto prefetch = [&](long long node) {
    pre_loc = -1;
    if (node < n && lr < k) pre_loc = loc[(long long)lr * n + node];
  };
  const long long total = (long long)gridDim.x * wpb * groups;
  long long i = ((long long)blockIdx.x * wpb + warp) * groups + g;
  prefetch(i);
  for (long long base = i - g; base < n; base += total, i += total) {
    const bool act = i < n;
    const long long j0 = act ? window_source(pre_loc, i, r, bands) : -1;
    prefetch(i + total);
    // ---- the slots with a window source, listed --------------------------
    int nl = rows::append_live(j0, lr, lane, lg_lpr, 0, src, slot);
    for (int s0 = lpr; s0 < k; s0 += lpr) {
      const int s = s0 + lr;
      const long long j =
          act && s < k ? window_source(loc[(long long)s * n + i], i, r, bands)
                       : -1;
      nl = rows::append_live(j, s, lane, lg_lpr, nl, src, slot);
    }
    __syncwarp();
    // ---- the loads: the softmax's first, then the first tile's rows -----
    const int np = nl << lg_hp;
    const auto pair_terms = [&](int p, float& a_j, float& e_j) {
      const int u = p >> lg_hp;
      a_j = ac[src[u] * h2 + hh];
      e_j = el[((long long)slot[u] * heads + hh) * n + i];
    };
    float a_j = 0.f, e_j = 0.f, a_dst = 0.f, a_self = 0.f, e_self_in = 0.f;
    if (lr < np) pair_terms(lr, a_j, e_j);
    if (act) {
      a_dst = ac[i * h2 + heads + hh];
      a_self = ac[i * h2 + hh];
      if (has_self) e_self_in = el_self[(long long)hh * n + i];
    }
    const long long self = act && has_self ? i : -1;
    row.tile(0, lr, lg_lpr, hc, c);
    row.request(xh, self, src, 0, nl, hc);

    // ---- the softmax over (slot, head) pairs, unnormalized ---------------
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
    if (hv && lr < np) we[lr] = e0;
    if (lr < hp && hv) {
      ws[h] = es;
      if (act) {
        m_out[i * heads + h] = m;
        den_out[i * heads + h] = fmaxf(sum + es, 1e-16f);
      }
    }
    __syncwarp();

    // ---- the weighted gather-sum, left unnormalized ------------------------
    float* yrow = y + i * hc;
    for (int t = 0; t < gm.tiles; ++t) {
      if (t > 0) {
        row.tile(t, lr, lg_lpr, hc, c);
        row.request(xh, self, src, 0, nl, hc);
      }
      float acc[NV][V];
      row.sum(acc, xh, src, we, has_self ? ws : nullptr, nl, hp, hc);
      if (act) {
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (row.in(q)) rows::store<float, V>(yrow + row.col[q], acc[q]);
      }
    }
    __syncwarp();   // the next destinations' lists overwrite these
  }
}

}  // namespace

template <typename T>
int launch_band(const void* xh, const void* acat, const void* loc,
                const void* el, const void* el_self, void* ac, void* y,
                void* m, void* den, long long n, int k, int heads, int c,
                int r, float slope, int vec, cudaStream_t s) {
  const T* txh = static_cast<const T*>(xh);
  const int hc = heads * c;
  cudaError_t err = rows::launch_mat_dots<T>(
      txh, static_cast<const T*>(acat), static_cast<float*>(ac), n, hc,
      2 * heads, s);
  if (err != cudaSuccess) return (int)err;
  const int hp = rows::pair_stride(heads);
  int lg_hp = 0;
  while ((1 << lg_hp) < hp) ++lg_hp;
  const int wpb = band_warps(k, hp);
  const size_t node_bytes = band_node_bytes(k, hp);
  err = rows::with_fwd_form<T>(vec, c, [&](auto v_c) {
    constexpr int V = decltype(v_c)::value;
    auto* kernel = band_kernel<T, V>;
    const rows::FwdGeom gm = rows::fwd_geom(hc, V, hp, node_bytes);
    const int groups = WARP >> gm.lg_lpr;
    const size_t smem = (size_t)wpb * groups * node_bytes;
    if (!rows::allow_smem(kernel, smem)) return cudaErrorInvalidValue;
    const long long cap = (n + (long long)wpb * groups - 1) / (wpb * groups);
    const int blocks = rows::resident_blocks(kernel, wpb * WARP, smem, cap);
    kernel<<<(unsigned)blocks, wpb * WARP, smem, s>>>(
        txh, static_cast<const float*>(ac), static_cast<const int*>(loc),
        static_cast<const float*>(el), static_cast<const float*>(el_self),
        static_cast<float*>(y), static_cast<float*>(m),
        static_cast<float*>(den), n, k, heads, c, r, slope, gm, hp, lg_hp);
    return cudaGetLastError();
  });
  return (int)err;
}

// Kernel E. dtype: 0 = float32, 1 = bfloat16 (xh, acat). xh [n, heads *
// c]; acat [heads * c, 2 * heads]; loc [k, n] int32; el [k * heads, n]
// f32; el_self [heads, n] f32 or null (no self loop); ac [n, 2 * heads]
// f32 scratch; outputs y [n, heads * c], m and den [n, heads] f32. n must
// be a multiple of the band rows r. vec 4 needs c % 4 == 0 and 16-byte
// aligned xh and y (the rows then go in 16-byte chunks when c is a
// multiple of 4 floats or 8 bf16, else in single columns); any HC.
// Launches on `stream`; returns the CUDA error code of the launches (0
// when both were accepted).
extern "C" int ell_gat_band(int dtype, const void* xh, const void* acat,
                            const void* loc, const void* el,
                            const void* el_self, void* ac, void* y, void* m,
                            void* den, long long n, int k, int heads, int c,
                            int r, float slope, int vec, void* stream) {
  if (n < 1 || k < 1 || heads < 1 || heads > MAX_HEADS || c < 1 || r < 1 ||
      n % r != 0 || (vec != 1 && vec != 4) || (vec == 4 && c % 4 != 0) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // one warp's lists in the 227 KB a block can have (K <= 64, the
  // wrapper's limit, takes ~2.8 KB at 8 heads)
  if (band_node_bytes(k, rows::pair_stride(heads)) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_band<bf16>(xh, acat, loc, el, el_self, ac, y, m, den, n, k,
                             heads, c, r, slope, vec, s);
  return launch_band<float>(xh, acat, loc, el, el_self, ac, y, m, den, n, k,
                            heads, c, r, slope, vec, s);
}

extern "C" const char* ell_gat_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
