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
// Design. Two kernels behind one C entry:
//   (1) the attention dots (ell_gat_rows.cuh node_dots_kernel): one node
//       a warp, every head's loads of the node requested before the first
//       FMA; the same bits as ellgat::dots_kernel, which took the heads one
//       after another. In the training form the caller keeps them for C'
//       (ell_gat_bwd takes them), so a train step computes them once a
//       layer.
//   (2) the aggregate: a grid-stride loop over nodes, as many 4-warp
//       blocks as stay resident, a lane group per node (ell_gat_rows.cuh,
//       "the forward passes"): the fewest lanes that hold the HC row at
//       two 16-byte chunks a lane (4 floats or 8 bf16 a load), so that a
//       warp holds 32 / lanes nodes at once (HC 256: one node in f32, two
//       in bf16; HC 64: four and eight), and wider rows take column tiles.
//       The node mask and the first slots of a group's next node are
//       fetched one node ahead. The group compacts its live slots with a
//       ballot over nbr_mask into a dense list (sources and slot numbers
//       in shared memory): dead slots cost no iteration and their rows,
//       NaN or not, are never read. It requests the softmax's terms (the
//       a_src of each pair's source, the edge logits, the self terms),
//       then the self row and the first 8 live rows, all in flight
//       together, and takes the softmax over (slot, head) pairs, every
//       head at once: lane p of the group owns pair (live slot p / hp, head
//       p % hp) (hp = heads rounded up to a power of two), forms its logit
//       and reduces the max and the sum among the group's lanes of its
//       head (xor offsets >= hp); more pairs than lanes take several pair
//       tiles, carrying max and sum. Every lane of a head forms the self
//       logit from the same (broadcast) loads rather than a lane of its
//       own: at K 8 x 4 heads the pairs fill the warp, and a self lane would
//       cost a second pair tile. In the dropout form each pair lane draws
//       its own multiplier with the counter ((i (K+1) + s) heads + h), and
//       each lane its head's self multiplier: the bits kernel C'
//       regenerates. The weights go to shared memory, and the gather sums
//       the rows already in flight.
// Why several nodes a warp and the softmax's loads first: each node waits
// for its round trips to memory, and what hides them is the number of
// nodes in flight an SM (on the H100, one node a warp with the softmax's
// loads behind the rows' was slower at HC 64 than the one-head-at-a-time
// kernel before it, PERF.md).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 non-tensor).
// At N = 65,536, K = 8, HC 256, 4 heads the layer must read xh (67.1 MB),
// el (8.4 MB), nbr_src and the mask (2.6 MB), el_self, and write out
// (67.1 MB): ~150 MB, ~0.045 ms; its operations (~0.44 GFLOP, dots and
// the 9-way weighted sum) take ~0.007 ms at the FP32 rate, so it is bound
// by bytes (bf16 halves the xh and out streams: ~82 MB, ~0.025 ms). It
// moves more: xh is read by both kernels, and each node's 9 rows are
// gathered through L2 (604 MB at HC 256 f32, which L2 serves in ~0.1 ms:
// the f32 aggregate's floor in this design; the warps walk the nodes
// interleaved, so the nodes in flight at once are neighbours in the
// Hilbert order and their rows stay in L2). Fusing the dots into the
// producer of xh, or sharing neighbour rows between the nodes of a block,
// is later work.

#include "ell_gat_common.cuh"
#include "ell_gat_rows.cuh"

using namespace ellgat;
using rows::FwdGeom;
using rows::FwdRow;

namespace {

// 32-bit words of one warp's slice of shared memory: the self weights
// [hp], the entries' logits then weights [K, hp], the live sources [K]
// and their slot numbers [K].
__host__ __device__ inline int fwd_warp_words(int k, int hp) {
  return (k + 1) * hp + 2 * k;
}

// A lane group of 1 << gm.lg_lpr lanes per destination node, 32 >> lg_lpr
// nodes a warp (grid-stride). xh, bias and out of type T, V columns a
// chunk, rows::FWD_NV chunks a lane of a column tile.
template <typename T, int V>
__global__ void
__launch_bounds__(rows::FWD_WARPS * WARP, rows::FWD_MIN_BLOCKS)
aggregate_kernel(const T* __restrict__ xh, const float* __restrict__ dots,
                 const int* __restrict__ nbr,
                 const uint8_t* __restrict__ nmask,
                 const float* __restrict__ el,
                 const float* __restrict__ el_self,
                 const T* __restrict__ bias,
                 const uint8_t* __restrict__ node_mask,
                 T* __restrict__ out, long long n, int k, int heads, int c,
                 float slope, int has_self, Drop drop, FwdGeom gm, int hp,
                 int lg_hp) {
  constexpr bool LOWP = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int wpb = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int lg_lpr = gm.lg_lpr;
  const int lpr = 1 << lg_lpr;
  const int groups = WARP >> lg_lpr;
  const int g = lane >> lg_lpr;          // the lane's node of the warp's
  const int lr = lane & (lpr - 1);       // and its lane in that group
  float* ws = smem + (warp * groups + g) * fwd_warp_words(k, hp);  // [hp]
  float* we = ws + hp;                               // [K, hp]
  int* src = reinterpret_cast<int*>(we + k * hp);    // [K]
  int* slot = src + k;                               // [K]
  const int hc = heads * c;
  const int h = lr & (hp - 1);
  const bool hv = h < heads;
  const int hh = hv ? h : 0;     // an address inside the row for h >= heads
  constexpr int NV = rows::FWD_NV;
  FwdRow<T, V> row;

  // The node mask and the first lpr slots of the group's next node,
  // fetched one node ahead: a node's only wait is then for its rows, dots
  // and edge logits, requested together.
  uint8_t pre_node = 0, pre_live = 0;
  int pre_src = 0;
  const auto prefetch = [&](long long node) {
    pre_node = 0;
    if (node >= n) return;
    pre_node = node_mask != nullptr ? node_mask[node] : 1;
    if (lr < k) {
      pre_live = nmask[node * k + lr];
      pre_src = nbr[node * k + lr];
    }
  };
  const long long total = (long long)gridDim.x * wpb * groups;
  long long i = ((long long)blockIdx.x * wpb + warp) * groups + g;
  prefetch(i);
  // every lane runs the loop as long as any node of its warp does: the
  // ballots and shuffles take the whole warp
  for (long long base = i - g; base < n; base += total, i += total) {
    const bool act = i < n;
    const bool keep = pre_node != 0;   // live and inside the graph
    const int j0 = keep && lr < k && pre_live ? pre_src : -1;
    prefetch(i + total);
    T* orow = out + i * hc;
    if (act && !keep)   // padded: zeros
      for (int j = lr; j < hc; j += lpr) orow[j] = from_f<T>(0.f);
    // ---- the live slots, compacted ---------------------------------------
    const long long slot0 = i * k;
    int nl = rows::append_live(j0, lr, lane, lg_lpr, 0, src, slot);
    for (int s0 = lpr; s0 < k; s0 += lpr) {
      const int s = s0 + lr;
      const int j = keep && s < k && nmask[slot0 + s] ? nbr[slot0 + s] : -1;
      nl = rows::append_live(j, s, lane, lg_lpr, nl, src, slot);
    }
    __syncwarp();
    // ---- the loads: the softmax's first (its pair tile 0 and the self
    // terms), then the first tile's rows, all in flight together ----------
    const int np = nl << lg_hp;
    const auto pair_terms = [&](int p, float& a_j, float& e_j) {
      const int u = p >> lg_hp;
      a_j = dots[(long long)src[u] * 2 * heads + hh];
      e_j = el != nullptr ? el[(slot0 + slot[u]) * heads + hh] : 0.f;
    };
    float a_j = 0.f, e_j = 0.f, a_dst = 0.f, a_self = 0.f, e_self_in = 0.f;
    if (lr < np) pair_terms(lr, a_j, e_j);
    if (keep) {
      const float* di = dots + i * 2 * heads;
      a_dst = di[heads + hh];
      a_self = di[hh];
      if (el_self != nullptr) e_self_in = el_self[i * heads + hh];
    }
    const long long self = keep && has_self ? i : -1;
    row.tile(0, lr, lg_lpr, hc, c);
    row.request(xh, self, src, 0, nl, hc);

    // ---- the softmax over (live slot, head) pairs, every head at once ----
    float self_l = -INFINITY, dself = 1.f;
    if (keep && has_self && hv) {
      self_l = leaky(a_self + a_dst + e_self_in, slope);
      dself = drop.mult(i, k, h, k, heads);
    }
    float m = self_l, e0;
    float den = rows::pair_softmax(
        np, lg_hp, hv, lr, lg_lpr, leaky(a_j + a_dst + e_j, slope),
        [&](int p) {
          float a, e;
          pair_terms(p, a, e);
          return leaky(a + a_dst + e, slope);
        },
        we, m, e0);
    const float e_self = self >= 0 && hv ? expf(self_l - m) : 0.f;
    den = fmaxf(den + e_self, 1e-16f);
    if (hv && lr < np)
      we[lr] = e0 / den * drop.mult(i, slot[lr >> lg_hp], h, k, heads);
    for (int p = lr + lpr; p < np; p += lpr)
      if (hv)
        we[p] = we[p] / den * drop.mult(i, slot[p >> lg_hp], h, k, heads);
    if (lr < hp) ws[h] = self >= 0 && hv ? e_self / den * dself : 0.f;
    __syncwarp();

    // ---- the weighted gather-sum, bias, store -----------------------------
    for (int t = 0; t < gm.tiles; ++t) {
      if (t > 0) {
        row.tile(t, lr, lg_lpr, hc, c);
        row.request(xh, self, src, 0, nl, hc);
      }
      float acc[NV][V];
      row.sum(acc, xh, src, we, self >= 0 ? ws : nullptr, nl, hp, hc);
      if (keep) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (!row.in(q)) continue;
          if (bias != nullptr) {
            rows::Raw<T, V> b;
            b.load(bias + row.col[q]);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[q][v] = (LOWP ? round_bf(acc[q][v]) : acc[q][v]) + b.at(v);
          }
          rows::store<T, V>(orow + row.col[q], acc[q]);
        }
      }
    }
    __syncwarp();   // the next nodes' lists overwrite these
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

// Bytes of one node's lists.
static size_t agg_node_bytes(int k, int heads) {
  return (size_t)fwd_warp_words(k, rows::pair_stride(heads)) * sizeof(float);
}

// The number of warps per aggregate block at one node a warp: the largest
// (<= 4) whose lists fit in 48 KB, else 1 when one node's fit in the 227
// KB a block can have; 0 when not even those fit (no K the kernel's first
// version took).
extern "C" int ell_gat_fwd_warps_per_block(int k, int heads) {
  if (k < 1 || heads < 1) return 0;
  for (int wpb = rows::FWD_WARPS; wpb >= 1; --wpb)
    if (wpb * agg_node_bytes(k, heads) <= 48 * 1024) return wpb;
  return agg_node_bytes(k, heads) <= 227 * 1024 ? 1 : 0;
}

template <typename T>
int launch_fwd(const void* xh, const void* att, const void* nbr,
               const void* nmask, const void* el, const void* el_self,
               const void* bias, const void* node_mask, void* dots, void* out,
               long long n, int k, int heads, int c, float slope,
               int has_self, int vec, const Drop& drop, int wpb,
               cudaStream_t s) {
  const T* txh = static_cast<const T*>(xh);
  cudaError_t err = rows::launch_node_dots<T>(
      txh, static_cast<const T*>(att), static_cast<float*>(dots), n, heads,
      c, s);
  if (err != cudaSuccess) return (int)err;
  const int hc = heads * c;
  const int hp = rows::pair_stride(heads);
  int lg_hp = 0;
  while ((1 << lg_hp) < hp) ++lg_hp;
  const size_t node_bytes = agg_node_bytes(k, heads);
  err = rows::with_fwd_form<T>(vec, c, [&](auto v_c) {
    constexpr int V = decltype(v_c)::value;
    auto* kernel = aggregate_kernel<T, V>;
    const rows::FwdGeom gm = rows::fwd_geom(hc, V, hp, node_bytes);
    const int groups = WARP >> gm.lg_lpr;
    const size_t smem = (size_t)wpb * groups * node_bytes;
    if (!rows::allow_smem(kernel, smem)) return cudaErrorInvalidValue;
    const long long cap = (n + (long long)wpb * groups - 1) / (wpb * groups);
    const int blocks = rows::resident_blocks(kernel, wpb * WARP, smem, cap);
    kernel<<<(unsigned)blocks, wpb * WARP, smem, s>>>(
        txh, static_cast<const float*>(dots), static_cast<const int*>(nbr),
        static_cast<const uint8_t*>(nmask), static_cast<const float*>(el),
        static_cast<const float*>(el_self), static_cast<const T*>(bias),
        static_cast<const uint8_t*>(node_mask), static_cast<T*>(out), n, k,
        heads, c, slope, has_self, drop, gm, hp, lg_hp);
    return cudaGetLastError();
  });
  return (int)err;
}

// Kernel C. dtype: 0 = float32, 1 = bfloat16 (xh, att, bias, out). xh
// [n, heads * c]; att [2, heads * c]; nbr [n, k] int32; nmask [n, k]
// uint8; el [n, k, heads] f32 or null; el_self [n, heads] f32 or null
// (zeros); bias [heads * c] or null; node_mask [n] uint8 or null; dots
// [n, 2 * heads] f32 (written: the attention dots, a_src then a_dst, that
// ell_gat_bwd takes); out [n, heads * c]. Dropout (training form):
// drop_mode 0 none, 1 dmask [n, k + 1, heads] f32, 2 Philox from the int64
// at seed with threshold thresh and scale keep_inv. vec 4 needs c % 4 == 0
// and 16-byte aligned xh, out and bias (the rows then go in 16-byte chunks
// when c is a multiple of 4 floats or 8 bf16, else in single columns). Any
// HC; K and heads as ell_gat_fwd_warps_per_block takes them. Launches on
// `stream`; returns the CUDA error code of the launches (0 when both were
// accepted).
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

// The attention dots alone (the first kernel of ell_gat_fwd, and of
// ell_gat_bwd when it is not given them): dots [n, 2 * heads] f32 of xh
// [n, heads * c] and att [2, heads * c] of type dtype. generic 1 runs
// ellgat::dots_kernel, the form every shape had before node_dots_kernel,
// for holding the two against each other bit for bit.
extern "C" int ell_gat_dots(int dtype, const void* xh, const void* att,
                            void* dots, long long n, int heads, int c,
                            int generic, void* stream) {
  if (n < 1 || heads < 1 || c < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)rows::launch_node_dots<bf16>(
        static_cast<const bf16*>(xh), static_cast<const bf16*>(att),
        static_cast<float*>(dots), n, heads, c, s, generic != 0);
  return (int)rows::launch_node_dots<float>(
      static_cast<const float*>(xh), static_cast<const float*>(att),
      static_cast<float*>(dots), n, heads, c, s, generic != 0);
}

extern "C" const char* ell_gat_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
