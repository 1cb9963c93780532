// Fused grid-GAT layer, backward (kernel B), for Hopper (sm_90a), CUDA C++.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py::_bwd_kernel
// (launched by _fused_backward, reached through the custom VJP's _bwd).
// The forward (grid_gat_fwd.cu) keeps nothing but its inputs; this
// backward recomputes xh = x @ W, the attention dots x @ (W @ [a_src|a_dst])
// and the softmax, applies the same attention dropout (the streamed mask,
// or the Philox draw regenerated from the layer's seed at the same global
// indices), and, for the cotangent g of out = (sum_k w'_k xh[nbr_k] +
// w'_s xh + bias) * valid, emits
//   dxh  = sum over the cells that read xh[q] of w' * g          [B,H,W,HC]
//   d_ad = [d a_src | d a_dst] through softmax and LeakyReLU      [B,H,W,2h]
//   dx   = dxh @ W^T + d_ad @ (W@a)^T                            [B,H,W,F]
//   per-block f32 partials of dW = x^T dxh, d(W@a) = x^T d_ad,
//   dM_edge = sum eattr (x) d_logit and dbias = sum g * valid.
// The caller sums the partials and forms dW_lin = dW + d(W@a) a_cat^T and
// d a_cat = W^T d(W@a), as the JAX code does outside its kernel.
//
// Two kernels, launched back to back by one C entry. The Pallas kernel
// does all of it per row block in one pass because a TPU grid step can
// hold a whole 16 x 256 row block and its [F, HC] weight-grad partial in
// VMEM. Here a block owns 8 x 16 cells; a per-block [F, HC] partial for
// every such block would be 512 MB at 4 x 256^2 cells, and the two kinds
// of product want different tilings. So:
//  * grid_gat_bwd_attn_kernel (one block per 8 x 16 cells): recomputes xh
//    for the cells two steps around the block (12 x 20; the softmax of the
//    ring one step out needs a_src of its own neighbours, and those
//    softmaxes feed dxh of the block's cells), the softmax of the 10 x 18
//    ring, d(dropped weights) = xh[nbr] . g per slot and head, the softmax
//    + LeakyReLU backward, and writes dxh, d_ad, dM_edge and dbias
//    partials. xh lives only in shared memory, as in the Pallas kernel.
//  * grid_gat_bwd_products_kernel: one register-tiled SIMT product routine
//    with two roles chosen by block index: dx tiles (cells x F, depth
//    HC + 2h) and weight-grad tiles ([F, HC + 2h], depth = one split of
//    the cells; one f32 partial per split).
// All products run in these kernels' bodies with f32 accumulation. With
// bf16 streams (the JAX kernel's `lowp`): x, W, W@a, el, g, the edge
// attributes, dxh and d_ad are bf16 (the Pallas kernel rounds dxh and d_ad
// to bf16 at its dot inputs too); the softmax, its backward and every
// partial are f32.
//
// What bounds it on an H100 SXM (67 TFLOP/s FP32 outside the tensor cores,
// 3.35 TB/s). For the 256 -> 256, 4-head layer on 4 x 256^2 cells in f32
// the function must do three [262144 x 256] x [256 x 256] products (xh
// recompute, dx, dW): ~103 GFLOP, ~1.5 ms at the FP32 rate, against
// ~0.9 GB of traffic (~0.27 ms), so it is bound by operations. This
// version does more: the attention kernel recomputes xh for 240 cells per
// 128 (1.9x), dxh and d_ad make a round trip through device memory, and
// the products are plain SIMT tiles (4 x 4 outputs a thread). Tensor cores
// and fusing the two kernels are later work.

#include <math.h>
#include <stddef.h>

#include "grid_gat_common.cuh"

namespace {

using gridgat::c_off;
using gridgat::Drop;
using gridgat::from_f;
using gridgat::leaky;
using gridgat::MAXK;
using gridgat::to_f;

// ---- attention backward -------------------------------------------------

constexpr int TH = 8;                    // block cells: rows
constexpr int TW = 16;                   //              cols
constexpr int NCELL = TH * TW;           // 128
constexpr int H1W = TW + 2;              // ring 1: 10 x 18 cells
constexpr int NH1 = (TH + 2) * H1W;      // 180
constexpr int H2W = TW + 4;              // ring 2: 12 x 20 cells
constexpr int NH2 = (TH + 4) * H2W;      // 240
constexpr int RM = 8;                    // product rows per thread
constexpr int RN = 8;                    // product cols per thread
constexpr int MROWS = 32 * RM;           // 256 >= NH2, padded with zeros
constexpr int NC = RN * 8;               // 64 channels per chunk
constexpr int KC = 32;                   // input features per staging step
constexpr int NTHREADS = 256;
constexpr int XS_STRIDE = MROWS + 4;     // staged x, transposed [KC][..]
constexpr int XH_STRIDE = NC + 4;        // xh chunk [MROWS][..]
constexpr int GS_STRIDE = NC + 1;        // cotangent chunk [NH1][..]
constexpr int NSLOT = MAXK + 1;          // slot MAXK holds the self loop
constexpr int MAXED = 4;                 // edge attributes handled
constexpr int U_FLOATS =
    (KC * XS_STRIDE > MROWS * XH_STRIDE) ? KC * XS_STRIDE : MROWS * XH_STRIDE;

static_assert(NH2 <= MROWS, "ring-2 rows must fit the padded product");
static_assert(NTHREADS % NC == 0, "dxh maps threads to channels");
static_assert(NCELL <= NTHREADS, "dM_edge maps threads to cells");
static_assert(U_FLOATS % 4 == 0 && XS_STRIDE % 4 == 0, "16B alignment");

template <int HEADS>
constexpr int attn_smem_floats() {
  return U_FLOATS + KC * NC + KC * 2 * HEADS + NH2 * HEADS + NH1 * HEADS +
         NH1 * GS_STRIDE + 3 * NSLOT * HEADS * NH1;
}

__device__ __forceinline__ int ring1(int ly, int lx) {
  return (ly + 1) * H1W + lx + 1;
}
__device__ __forceinline__ int ring2(int ly, int lx) {
  return (ly + 2) * H2W + lx + 2;
}

// Logits of ring-1 cell r1, head h, in slots 0..MAXK (self at MAXK; -inf
// for slots >= K and neighbours outside the tile), exactly as kernel A
// forms them. Returns false when the cell itself lies outside the tile.
template <typename T, int HEADS>
__device__ __forceinline__ bool cell_logits(
    int r1, int h, float* lg, const float* as_s, const float* ad_s,
    const T* __restrict__ el, const T* __restrict__ el_self, int b, int y0,
    int x0, int H, int W, int K, int conn_idx, float slope, int& gy,
    int& gx) {
  const int ly = r1 / H1W - 1, lx = r1 % H1W - 1;
  gy = y0 + ly;
  gx = x0 + lx;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return false;
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)gy * W + gx;
  const int r2 = ring2(ly, lx);
  const float ad = ad_s[r1 * HEADS + h];
  lg[MAXK] = leaky(as_s[r2 * HEADS + h] + ad +
                       to_f(el_self[((size_t)b * HEADS + h) * plane + pix]),
                   slope);
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    lg[k] = -INFINITY;
    if (k < K) {
      const int dr = c_off[conn_idx][k][0], dc = c_off[conn_idx][k][1];
      const int ny = gy + dr, nx = gx + dc;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W)
        lg[k] = leaky(
            as_s[(r2 + dr * H2W + dc) * HEADS + h] + ad +
                to_f(el[(((size_t)b * K + k) * HEADS + h) * plane + pix]),
            slope);
    }
  }
  return true;
}

template <typename T, int HEADS>
__global__ void __launch_bounds__(NTHREADS)
grid_gat_bwd_attn_kernel(
    const T* __restrict__ x, const T* __restrict__ wmat,
    const T* __restrict__ wa, const T* __restrict__ el,
    const T* __restrict__ el_self, const float* __restrict__ valid,
    const T* __restrict__ g, const T* __restrict__ eattr,
    const T* __restrict__ mattr, T* __restrict__ dxh, T* __restrict__ dad,
    float* __restrict__ dme_part, float* __restrict__ db_part, int H, int W,
    int F, int HC, int K, int conn_idx, int ED, float slope, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;                          // [KC][XS_STRIDE]
  float* xh_s = smem;                         // [MROWS][XH_STRIDE] (alias)
  float* ws = smem + U_FLOATS;                // [KC][NC]
  float* was = ws + KC * NC;                  // [KC][2 * HEADS]
  float* as_s = was + KC * 2 * HEADS;         // [NH2][HEADS]
  float* ad_s = as_s + NH2 * HEADS;           // [NH1][HEADS]
  float* gs = ad_s + NH1 * HEADS;             // [NH1][GS_STRIDE]
  float* wt_s = gs + NH1 * GS_STRIDE;         // [NSLOT][HEADS][NH1]
  float* dm_s = wt_s + NSLOT * HEADS * NH1;   // dropout multipliers
  float* dw_s = dm_s + NSLOT * HEADS * NH1;   // d(w'), then d(logit)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int C = HC / HEADS;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * plane * F;
  const int ty = tid / 8;
  const int tx = tid % 8;
  constexpr int SLOT_STRIDE = HEADS * NH1;

  for (int i = tid; i < NSLOT * HEADS * NH1; i += NTHREADS) dw_s[i] = 0.f;

  float dacc[2 * HEADS];
  for (int n0 = 0; n0 < HC; n0 += NC) {
    const bool first = n0 == 0;
    const int n1 = min(HC, n0 + NC);
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * HEADS; ++j) dacc[j] = 0.f;

    // xh (and, in the first chunk, the attention dots) of the ring-2 cells
    for (int k0 = 0; k0 < F; k0 += KC) {
      for (int i = tid; i < MROWS * KC; i += NTHREADS) {
        const int r = i / KC, kk = i % KC;
        float v = 0.f;
        if (r < NH2) {
          const int gy = y0 - 2 + r / H2W, gx = x0 - 2 + r % H2W;
          const int f = k0 + kk;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W && f < F)
            v = to_f(xb[((size_t)gy * W + gx) * F + f]);
        }
        xsT[kk * XS_STRIDE + r] = v;
      }
      for (int i = tid; i < KC * NC; i += NTHREADS) {
        const int f = k0 + i / NC, col = n0 + i % NC;
        ws[i] = (f < F && col < HC) ? to_f(wmat[(size_t)f * HC + col]) : 0.f;
      }
      if (first) {
        for (int i = tid; i < KC * 2 * HEADS; i += NTHREADS) {
          const int f = k0 + i / (2 * HEADS);
          was[i] = f < F ? to_f(wa[(size_t)f * 2 * HEADS + i % (2 * HEADS)])
                         : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float* ar = xsT + kk * XS_STRIDE + ty * RM;
        const float4 a03 = *reinterpret_cast<const float4*>(ar);
        const float4 a47 = *reinterpret_cast<const float4*>(ar + 4);
        const float a[RM] = {a03.x, a03.y, a03.z, a03.w,
                             a47.x, a47.y, a47.z, a47.w};
        const float* br = ws + kk * NC + tx * RN;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 4);
        const float bv[RN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      if (first && tid < NH2) {
        for (int kk = 0; kk < KC; ++kk) {
          const float xv = xsT[kk * XS_STRIDE + tid];
#pragma unroll
          for (int j = 0; j < 2 * HEADS; ++j)
            dacc[j] = fmaf(xv, was[kk * 2 * HEADS + j], dacc[j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* dst = xh_s + (ty * RM + i) * XH_STRIDE + tx * RN;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (first && tid < NH2) {
#pragma unroll
      for (int h = 0; h < HEADS; ++h) as_s[tid * HEADS + h] = dacc[h];
      const int ly = tid / H2W - 2, lx = tid % H2W - 2;
      if (ly >= -1 && ly <= TH && lx >= -1 && lx <= TW) {
#pragma unroll
        for (int h = 0; h < HEADS; ++h)
          ad_s[ring1(ly, lx) * HEADS + h] = dacc[HEADS + h];
      }
    }
    // cotangent chunk of the ring-1 cells: g * valid, 0 outside the tile
    for (int i = tid; i < NH1 * NC; i += NTHREADS) {
      const int r = i / NC, c = i % NC;
      const int gy = y0 - 1 + r / H1W, gx = x0 - 1 + r % H1W;
      const int col = n0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && col < HC) {
        const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
        if (valid[pix] > 0.f) v = to_f(g[pix * HC + col]);
      }
      gs[r * GS_STRIDE + c] = v;
    }
    __syncthreads();

    if (first) {
      // softmax weights and dropout multipliers of the ring-1 cells
      for (int i = tid; i < NH1 * HEADS; i += NTHREADS) {
        const int r1 = i % NH1, h = i / NH1;
        float lg[NSLOT];
        int gy, gx;
        float* wt = wt_s + h * NH1 + r1;
        float* dm = dm_s + h * NH1 + r1;
        if (!cell_logits<T, HEADS>(r1, h, lg, as_s, ad_s, el, el_self, b, y0,
                                   x0, H, W, K, conn_idx, slope, gy, gx)) {
#pragma unroll
          for (int s = 0; s < NSLOT; ++s) {
            wt[s * SLOT_STRIDE] = 0.f;
            dm[s * SLOT_STRIDE] = 0.f;
          }
          continue;
        }
        float m = lg[MAXK];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) m = fmaxf(m, lg[k]);
        float den = 0.f;
#pragma unroll
        for (int s = 0; s < NSLOT; ++s) {
          lg[s] = expf(lg[s] - m);   // exp(-inf) = 0 for skipped slots
          den += lg[s];
        }
        den = fmaxf(den, 1e-16f);
#pragma unroll
        for (int s = 0; s < NSLOT; ++s) {
          const bool live = s == MAXK || s < K;
          wt[s * SLOT_STRIDE] = lg[s] / den;
          dm[s * SLOT_STRIDE] =
              live ? drop.mult(b, s == MAXK ? K : s, h, gy, gx, K, HEADS, H,
                               W)
                   : 0.f;
        }
      }
      __syncthreads();
    }

    // dbias partial of this chunk
    if (tid < NC && n0 + tid < HC) {
      float s = 0.f;
      for (int q = 0; q < NCELL; ++q)
        s += gs[ring1(q / TW, q % TW) * GS_STRIDE + tid];
      db_part[(size_t)blk * HC + n0 + tid] = s;
    }

    // dxh of the block's cells: xh[q] is read by q itself (self loop) and
    // by each p = q - off_k through its slot k
    {
      const int c = tid % NC;
      const int col = n0 + c;
      if (col < HC) {
        const int h = col / C;
        const float* wt = wt_s + h * NH1;
        const float* dm = dm_s + h * NH1;
        for (int q = tid / NC; q < NCELL; q += NTHREADS / NC) {
          const int ly = q / TW, lx = q % TW;
          const int gy = y0 + ly, gx = x0 + lx;
          if (gy >= H || gx >= W) continue;
          const int r1 = ring1(ly, lx);
          float v = wt[MAXK * SLOT_STRIDE + r1] * dm[MAXK * SLOT_STRIDE + r1] *
                    gs[r1 * GS_STRIDE + c];
#pragma unroll
          for (int k = 0; k < MAXK; ++k) {
            if (k < K) {
              const int p = r1 - (c_off[conn_idx][k][0] * H1W +
                                  c_off[conn_idx][k][1]);
              v += wt[k * SLOT_STRIDE + p] * dm[k * SLOT_STRIDE + p] *
                   gs[p * GS_STRIDE + c];
            }
          }
          const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
          dxh[pix * HC + col] = from_f<T>(v);
        }
      }
    }

    // d(dropped weight) of each ring-1 cell, slot and head in this chunk:
    // sum over the head's channels of xh[neighbour] * g[cell]
    {
      const int h_lo = n0 / C;
      const int nh = (n1 - 1) / C - h_lo + 1;
      const int nslot = K + 1;
      for (int i = tid; i < nslot * nh * NH1; i += NTHREADS) {
        const int r1 = i % NH1;
        const int t = i / NH1;
        const int h = h_lo + t % nh;
        const int sl = t / nh;
        const int ly = r1 / H1W - 1, lx = r1 % H1W - 1;
        int r2 = ring2(ly, lx);
        if (sl < K) r2 += c_off[conn_idx][sl][0] * H2W + c_off[conn_idx][sl][1];
        const int c_lo = max(h * C, n0) - n0;
        const int c_hi = min((h + 1) * C, n1) - n0;
        const float* xr = xh_s + r2 * XH_STRIDE;
        const float* gr = gs + r1 * GS_STRIDE;
        float s = 0.f;
        for (int c = c_lo; c < c_hi; ++c) s = fmaf(xr[c], gr[c], s);
        dw_s[((sl < K ? sl : MAXK) * HEADS + h) * NH1 + r1] += s;
      }
    }
    __syncthreads();   // xh_s and gs are overwritten by the next chunk
  }

  // softmax + LeakyReLU backward of each ring-1 cell and head
  for (int i = tid; i < NH1 * HEADS; i += NTHREADS) {
    const int r1 = i % NH1, h = i / NH1;
    float lg[NSLOT];
    int gy, gx;
    const bool inside = cell_logits<T, HEADS>(r1, h, lg, as_s, ad_s, el,
                                              el_self, b, y0, x0, H, W, K,
                                              conn_idx, slope, gy, gx);
    float dw[NSLOT];
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < NSLOT; ++sl) {
      const int idx = (sl * HEADS + h) * NH1 + r1;
      dw[sl] = dw_s[idx] * dm_s[idx];
      s = fmaf(wt_s[idx], dw[sl], s);
    }
#pragma unroll
    for (int sl = 0; sl < NSLOT; ++sl) {
      const int idx = (sl * HEADS + h) * NH1 + r1;
      dw_s[idx] = inside ? wt_s[idx] * (dw[sl] - s) *
                               (lg[sl] >= 0.f ? 1.f : slope)
                         : 0.f;
    }
  }
  __syncthreads();

  // d a_src (through every slot that read it) and d a_dst of the block's
  // cells
  for (int i = tid; i < NCELL * HEADS; i += NTHREADS) {
    const int q = i % NCELL, h = i / NCELL;
    const int ly = q / TW, lx = q % TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const int r1 = ring1(ly, lx);
    const float* d = dw_s + h * NH1;
    float ds = d[MAXK * SLOT_STRIDE + r1];
    float dd = ds;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k < K) {
        const int p =
            r1 - (c_off[conn_idx][k][0] * H1W + c_off[conn_idx][k][1]);
        ds += d[k * SLOT_STRIDE + p];
        dd += d[k * SLOT_STRIDE + r1];
      }
    }
    const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
    dad[pix * 2 * HEADS + h] = from_f<T>(ds);
    dad[pix * 2 * HEADS + HEADS + h] = from_f<T>(dd);
  }

  // dM_edge partial: sum over the block's cells of attr (x) d(logit)
  {
    float acc[MAXED * HEADS];
#pragma unroll
    for (int o = 0; o < MAXED * HEADS; ++o) acc[o] = 0.f;
    if (tid < NCELL) {
      const int ly = tid / TW, lx = tid % TW;
      const int gy = y0 + ly, gx = x0 + lx;
      if (gy < H && gx < W) {
        const int r1 = ring1(ly, lx);
        const size_t pix = (size_t)gy * W + gx;
#pragma unroll
        for (int e = 0; e < MAXED; ++e) {
          if (e >= ED) break;
          const float ma = to_f(mattr[((size_t)b * plane + pix) * ED + e]);
#pragma unroll
          for (int h = 0; h < HEADS; ++h)
            acc[e * HEADS + h] =
                fmaf(ma, dw_s[(MAXK * HEADS + h) * NH1 + r1], acc[e * HEADS + h]);
          for (int k = 0; k < K; ++k) {
            const float ea =
                to_f(eattr[(((size_t)b * K + k) * plane + pix) * ED + e]);
#pragma unroll
            for (int h = 0; h < HEADS; ++h)
              acc[e * HEADS + h] = fmaf(ea, dw_s[(k * HEADS + h) * NH1 + r1],
                                        acc[e * HEADS + h]);
          }
        }
      }
    }
    float* red = gs;   // free after the chunk loop: [warps][MAXED * HEADS]
    const int lane = tid % 32, warp = tid / 32;
#pragma unroll
    for (int o = 0; o < MAXED * HEADS; ++o) {
      float v = acc[o];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * MAXED * HEADS + o] = v;
    }
    __syncthreads();
    if (tid < ED * HEADS) {
      const int e = tid / HEADS, h = tid % HEADS;
      float s = 0.f;
      for (int w = 0; w < NTHREADS / 32; ++w)
        s += red[w * MAXED * HEADS + e * HEADS + h];
      dme_part[((size_t)blk * ED + e) * HEADS + h] = s;
    }
  }
}

// ---- products -----------------------------------------------------------

constexpr int PBM = 64;    // tile rows
constexpr int PBN = 64;    // tile cols
constexpr int PBK = 16;    // depth per staging step
constexpr int PT = 256;    // 16 x 16 threads, 4 x 4 outputs each

// Role "dx" (blocks [0, n_dx)): dx[cell, f] = sum_j D[cell, j] Wc[f, j]
// with D = [dxh | d_ad] (width NB = HC + 2h) and Wc = [W | W@a].
// Role "dw" (the rest): part[split, f, j] = sum over the split's cells of
// x[cell, f] D[cell, j]: the dW (j < HC) and d(W@a) (j >= HC) partials.
template <typename T>
__global__ void __launch_bounds__(PT)
grid_gat_bwd_products_kernel(const T* __restrict__ x,
                             const T* __restrict__ wmat,
                             const T* __restrict__ wa,
                             const T* __restrict__ dxh,
                             const T* __restrict__ dad, T* __restrict__ dx,
                             float* __restrict__ dw_part, int ncell, int F,
                             int HC, int A2, int n_dx, int dx_tiles_n,
                             int dw_tiles_n, int cells_per_split) {
  __shared__ __align__(16) float As[PBK][PBM + 4];
  __shared__ __align__(16) float Bs[PBK][PBN + 4];
  const int tid = threadIdx.x;
  const int NB = HC + A2;
  const bool role_dx = (int)blockIdx.x < n_dx;
  int m0, n0, M, N, k_begin, k_end, split = 0;
  if (role_dx) {
    m0 = (blockIdx.x / dx_tiles_n) * PBM;
    n0 = (blockIdx.x % dx_tiles_n) * PBN;
    M = ncell;
    N = F;
    k_begin = 0;
    k_end = NB;
  } else {
    const int blk = blockIdx.x - n_dx;
    const int dw_tiles_m = (F + PBM - 1) / PBM;
    split = blk / (dw_tiles_m * dw_tiles_n);
    const int t = blk % (dw_tiles_m * dw_tiles_n);
    m0 = (t / dw_tiles_n) * PBM;
    n0 = (t % dw_tiles_n) * PBN;
    M = F;
    N = NB;
    k_begin = split * cells_per_split;
    k_end = min(ncell, k_begin + cells_per_split);
  }
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += PBK) {
    // A tile [PBK][PBM]; neighbouring threads read neighbouring addresses
    for (int i = tid; i < PBM * PBK; i += PT) {
      const int mm = role_dx ? i / PBK : i % PBM;
      const int kk = role_dx ? i % PBK : i / PBM;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < k_end) {
        if (role_dx)
          v = k < HC ? to_f(dxh[(size_t)m * HC + k])
                     : to_f(dad[(size_t)m * A2 + (k - HC)]);
        else
          v = to_f(x[(size_t)k * F + m]);
      }
      As[kk][mm] = v;
    }
    // B tile [PBK][PBN]
    for (int i = tid; i < PBK * PBN; i += PT) {
      const int nn = role_dx ? i / PBK : i % PBN;
      const int kk = role_dx ? i % PBK : i / PBN;
      const int n = n0 + nn, k = k0 + kk;
      float v = 0.f;
      if (n < N && k < k_end) {
        if (role_dx)
          v = k < HC ? to_f(wmat[(size_t)n * HC + k])
                     : to_f(wa[(size_t)n * A2 + (k - HC)]);
        else
          v = n < HC ? to_f(dxh[(size_t)k * HC + n])
                     : to_f(dad[(size_t)k * A2 + (n - HC)]);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      if (role_dx)
        dx[(size_t)m * F + n] = from_f<T>(acc[i][j]);
      else
        dw_part[((size_t)split * F + m) * NB + n] = acc[i][j];
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct BwdArgs {
  const void *x, *w, *wa, *el, *el_self, *valid, *g, *eattr, *mattr;
  void *dxh, *dad, *dme_part, *db_part, *dx, *dw_part;
  int B, H, W, F, HC, K, ED, nsplit, cells_per_split;
  float slope;
};

template <typename T, int HEADS>
int launch(const BwdArgs& a, Drop drop, cudaStream_t stream) {
  const int smem = attn_smem_floats<HEADS>() * (int)sizeof(float);
  auto attn = grid_gat_bwd_attn_kernel<T, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B);
  attn<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.wa), static_cast<const T*>(a.el),
      static_cast<const T*>(a.el_self), static_cast<const float*>(a.valid),
      static_cast<const T*>(a.g), static_cast<const T*>(a.eattr),
      static_cast<const T*>(a.mattr), static_cast<T*>(a.dxh),
      static_cast<T*>(a.dad), static_cast<float*>(a.dme_part),
      static_cast<float*>(a.db_part), a.H, a.W, a.F, a.HC, a.K,
      a.K == 8 ? 0 : 1, a.ED, a.slope, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int ncell = a.B * a.H * a.W;
  const int A2 = 2 * HEADS;
  const int dx_tiles_n = (a.F + PBN - 1) / PBN;
  const int n_dx = ((ncell + PBM - 1) / PBM) * dx_tiles_n;
  const int dw_tiles_n = (a.HC + A2 + PBN - 1) / PBN;
  const int n_dw = a.nsplit * ((a.F + PBM - 1) / PBM) * dw_tiles_n;
  grid_gat_bwd_products_kernel<T><<<n_dx + n_dw, PT, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.wa), static_cast<const T*>(a.dxh),
      static_cast<const T*>(a.dad), static_cast<T*>(a.dx),
      static_cast<float*>(a.dw_part), ncell, a.F, a.HC, A2, n_dx,
      dx_tiles_n, dw_tiles_n, a.cells_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_heads(int heads, const BwdArgs& a, Drop drop, cudaStream_t s) {
  switch (heads) {
    case 1:
      return launch<T, 1>(a, drop, s);
    case 2:
      return launch<T, 2>(a, drop, s);
    case 4:
      return launch<T, 4>(a, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes: launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success). dtype 0 = float32, 1 = bfloat16 for x,
// w, wa, el, el_self, g, eattr, mattr, dxh, dad and dx; valid, dmask and
// the partials are float32. Layouts (contiguous): x [B,H,W,F], w [F,HC],
// wa [F,2h], el [B,K,h,H,W], el_self [B,h,H,W], valid [B,H,W],
// g [B,H,W,HC], eattr [B,K,H,W,ed], mattr [B,H,W,ed] (mean incoming
// attribute), dxh [B,H,W,HC], dad [B,H,W,2h], dme_part [nblk,ed,h],
// db_part [nblk,HC] with nblk = B * ceil(H/8) * ceil(W/16), dx [B,H,W,F],
// dw_part [nsplit,F,HC+2h]; split s covers cells [s*cps, (s+1)*cps) of the
// B*H*W cells, and nsplit * cps >= B*H*W. Dropout as in grid_gat_fwd.
extern "C" int grid_gat_bwd(
    int dtype, const void* x, const void* w, const void* wa, const void* el,
    const void* el_self, const void* valid, const void* g, const void* eattr,
    const void* mattr, void* dxh, void* dad, void* dme_part, void* db_part,
    void* dx, void* dw_part, int B, int H, int W, int F, int HC, int heads,
    int conn, int ed, float slope, int drop_mode, const void* dmask,
    const void* seed, unsigned int thresh, float keep_inv, int nsplit,
    int cells_per_split, void* stream) {
  if (conn != 4 && conn != 8) return (int)cudaErrorInvalidValue;
  if (B < 1 || H < 1 || W < 1 || F < 1 || HC < 1 || heads < 1 ||
      HC % heads != 0 || ed < 0 || ed > MAXED || nsplit < 1 ||
      cells_per_split < 1 || (long long)nsplit * cells_per_split <
                                 (long long)B * H * W)
    return (int)cudaErrorInvalidValue;
  if (drop_mode < 0 || drop_mode > 2 || (drop_mode == 1 && !dmask) ||
      (drop_mode == 2 && !seed))
    return (int)cudaErrorInvalidValue;
  Drop drop;
  drop.mode = drop_mode;
  drop.mask = static_cast<const float*>(dmask);
  drop.seed = static_cast<const unsigned long long*>(seed);
  drop.thresh = thresh;
  drop.keep_inv = keep_inv;
  BwdArgs a{x,  w,   wa,       el,      el_self, valid, g,     eattr,
            mattr, dxh, dad,   dme_part, db_part, dx,    dw_part,
            B,  H,   W,  F,    HC,      conn,    ed,    nsplit,
            cells_per_split,   slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_heads<float>(heads, a, drop, s);
  if (dtype == 1) return dispatch_heads<__nv_bfloat16>(heads, a, drop, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* grid_gat_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
