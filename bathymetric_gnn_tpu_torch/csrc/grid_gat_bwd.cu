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
// What bounds it on an H100 SXM (3.35 TB/s; tensor cores 989 TFLOP/s
// bf16, 495 TF32; 67 TFLOP/s FP32 outside them). For the 256 -> 256,
// 4-head layer on 4 x 256^2 cells in f32 the function must do three
// [262144 x 256] x [256 x 264] products (xh and dots recompute, dx, dW and
// d(W@a)): ~106 GFLOP, which run as 3xTF32 (grid_gat_mma.cuh; the dots'
// 3 % on the CUDA cores) at 495/3 = 165 TFLOP/s, ~0.64 ms, plus ~1.2
// GFLOP of 9-way sums on the CUDA cores, against ~0.9 GB of traffic
// (~0.27 ms): bound by operations. bf16 (MMA at 989 TFLOP/s, half the
// bytes) is bound by bytes.
//
// Design: two kernels, launched back to back by one C entry, every product
// but the attention dots on the tensor cores through gridmma (mma.sync,
// not wgmma; 3xTF32 for f32, bf16 MMA with f32 accumulation for bf16):
//  * grid_gat_bwd_attn_kernel, one block of 8 warps per 8 x 28 cells
//    (12 x 12 at 8 heads). It recomputes xh, in 32-channel chunks, for the
//    cells two steps around the block (12 x 32 = 384 = 24 m16 tiles, 3 a
//    warp; 16 x 16 at 8 heads): the softmax of the ring one step out needs
//    a_src of its own neighbours, and those softmaxes feed dxh of the
//    block's cells. That is 1.71x the block's cells (2.0x in the 8 x 16
//    SIMT version, 240 cells padded to 256 rows); x and W stream through a
//    double-buffered cp.async ring, and each W chunk is split (transposed
//    in bf16) once for all warps (gridmma::prep_b). The attention dots are
//    f32 FMAs from
//    the same staged x in ascending k, bit for bit kernel A's (its note
//    says why they stay off the tensor cores). Then, in f32: the softmax of
//    the ring-1 cells (kept as the dropped weights w' = w * mask), dxh of
//    the block's cells, d(w') = xh[nbr] . g per slot and head; after the
//    last chunk, the softmax weights and dropout multipliers are
//    recomputed (cheaper in shared memory than keeping them: the 8-head
//    form fits only so) for the softmax + LeakyReLU backward, d_ad and the
//    dM_edge / dbias partials. dxh and the cotangent loads take 4
//    channels a thread. Shared memory at 4 heads, f32: staging ring
//    68,608 B (the xh chunk, 61,440 B, aliases it), dots 10,944 B, the
//    cotangent chunk 43,200 B, w' and d(w') 86,400 B, the split W chunk
//    5,120 B: 214,272 B, one block an SM. x is staged once per 32-channel
//    chunk (8 times at HC 256, from L2): a wider chunk does not fit beside
//    w', d(w') and g.
//  * grid_gat_bwd_products_kernel: a 256 x 128 block tile of 8 warps (64 x
//    64 each: a 32 x 32 warp tile reads 128 bytes of shared memory per
//    MMA, as much as the SM's shared memory delivers a cycle), a
//    3-deep cp.async ring, with two roles chosen by block index: weight-grad
//    tiles first ([F, HC + 2h], depth = one split of the cells, both
//    operands M/N-major; one f32 partial per split, no atomics, so the
//    gradients repeat bit for bit), then dx tiles (cells x F, depth
//    HC + 2h, both operands K-major).
// The split keeps dxh and d_ad's round trip through device memory: at the
// 4 x 256^2 layer that is 262144 x 264 values written once and read twice
// (~0.83 GB in f32, ~0.25 ms at 3.35 TB/s). Fusing dx into the attention
// kernel would save the dx role's read but needs [W | W@a] (270 KB in f32)
// or a second K loop per block, and the dW role still needs dxh of every
// cell; so the two kernels stay.
// With bf16 streams (the JAX kernel's `lowp`): x, W, W@a, el, g, the edge
// attributes, dxh and d_ad are bf16 (the Pallas kernel rounds dxh and d_ad
// to bf16 at its dot inputs too); the softmax, its backward and every
// partial are f32.

#include <math.h>
#include <stddef.h>

#include "grid_gat_common.cuh"
#include "grid_gat_mma.cuh"

namespace {

using gridgat::c_off;
using gridgat::Drop;
using gridgat::from_f;
using gridgat::leaky;
using gridgat::MAXK;
using gridgat::to_f;

// ---- attention backward -------------------------------------------------

constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int NC = 32;                   // channels per chunk
constexpr int WSB = NC + 24;             // staged W row: NC + dots + pad
constexpr int XH = NC + 8;               // xh chunk row (f32)
constexpr int GS = NC + 4;               // cotangent chunk row (f32)
constexpr int NSLOT = MAXK + 1;          // slot MAXK holds the self loop
constexpr int MAXED = 4;                 // edge attributes handled

template <typename T, int HEADS>
struct Cfg {
  static constexpr int TH = HEADS == 8 ? 12 : 8;    // block cells: rows
  static constexpr int TW = HEADS == 8 ? 12 : 28;   //              cols
  static constexpr int NCELL = TH * TW;
  static constexpr int H1W = TW + 2;                // ring 1
  static constexpr int NH1 = (TH + 2) * H1W;
  static constexpr int H2W = TW + 4;                // ring 2
  static constexpr int NH2 = (TH + 4) * H2W;        // 384 (256)
  static constexpr int MT = NH2 / 16 / NWARPS;
  static constexpr int ND = 2 * HEADS <= 8 ? 8 : 16;
  static constexpr int NT = NC / 8;
  static constexpr int RPT = (NH2 + NTHREADS - 1) / NTHREADS;
  static constexpr int KC = 64 / (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int XS = KC + VEC;
  static constexpr int STAGE = NH2 * XS * (int)sizeof(T) +
                               KC * WSB * (int)sizeof(T);
  static constexpr int NSTAGE = 2;                  // ring depth
  static constexpr int XH_BYTES = NH2 * XH * 4;
  static constexpr int UNION =
      XH_BYTES > NSTAGE * STAGE ? XH_BYTES : NSTAGE * STAGE;
  // W's chunk split (f32) or transposed (bf16) once for all warps
  static constexpr int PREP_OFF =
      UNION + 4 * (NH2 * HEADS + NH1 * HEADS + NH1 * GS +
                   2 * NSLOT * HEADS * NH1);
  static constexpr int PREP_BYTES =
      gridmma::Prep<T>::WORDS * NC * XS *
      (int)sizeof(typename gridmma::Prep<T>::type);
  static constexpr int SMEM = PREP_OFF + PREP_BYTES;
  static_assert(NH2 % (16 * NWARPS) == 0, "ring-2 rows: whole m16 tiles");
  static_assert(NCELL <= NTHREADS, "dM_edge maps threads to cells");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(STAGE % 16 == 0 && UNION % 16 == 0, "16B alignment");
};

// Logits of ring-1 cell r1, head h, in slots 0..MAXK (self at MAXK; -inf
// for slots >= K and neighbours outside the tile), exactly as kernel A
// forms them. Returns false when the cell itself lies outside the tile.
template <typename T, int HEADS, typename G>
__device__ __forceinline__ bool cell_logits(
    int r1, int h, float* lg, const float* as_s, const float* ad_s,
    const T* __restrict__ el, const T* __restrict__ el_self, int b, int y0,
    int x0, int H, int W, int K, int conn_idx, float slope, int& gy,
    int& gx) {
  const int ly = r1 / G::H1W - 1, lx = r1 % G::H1W - 1;
  gy = y0 + ly;
  gx = x0 + lx;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return false;
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)gy * W + gx;
  const int r2 = (ly + 2) * G::H2W + lx + 2;
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
            as_s[(r2 + dr * G::H2W + dc) * HEADS + h] + ad +
                to_f(el[(((size_t)b * K + k) * HEADS + h) * plane + pix]),
            slope);
    }
  }
  return true;
}

// softmax weights of the logits lg (in place), as kernel A takes them
__device__ __forceinline__ void softmax_slots(float* lg) {
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
  for (int s = 0; s < NSLOT; ++s) lg[s] = lg[s] / den;
}

template <typename T, int HEADS>
__global__ void __launch_bounds__(NTHREADS, 1)
grid_gat_bwd_attn_kernel(
    const T* __restrict__ x, const T* __restrict__ wmat,
    const T* __restrict__ wa, const T* __restrict__ el,
    const T* __restrict__ el_self, const float* __restrict__ valid,
    const T* __restrict__ g, const T* __restrict__ eattr,
    const T* __restrict__ mattr, T* __restrict__ dxh, T* __restrict__ dad,
    float* __restrict__ dme_part, float* __restrict__ db_part, int H, int W,
    int F, int HC, int K, int conn_idx, int ED, float slope, Drop drop) {
  using G = Cfg<T, HEADS>;
  constexpr int TH = G::TH, TW = G::TW, H1W = G::H1W, NH1 = G::NH1;
  constexpr int H2W = G::H2W, NH2 = G::NH2, NCELL = G::NCELL;
  constexpr int MT = G::MT, NT = G::NT, KC = G::KC, VEC = G::VEC;
  constexpr int XS = G::XS;
  constexpr int SLOT_STRIDE = HEADS * NH1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using PT = typename gridmma::Prep<T>::type;
  PT* bp = reinterpret_cast<PT*>(smem_raw + G::PREP_OFF);
  PT* bp_lo = bp + NC * XS;
  T* xs[G::NSTAGE];    // the staging ring: x and W (+ W@a) K chunks
  T* wsb[G::NSTAGE];
#pragma unroll
  for (int s = 0; s < G::NSTAGE; ++s) {
    xs[s] = reinterpret_cast<T*>(smem_raw + s * G::STAGE);
    wsb[s] = xs[s] + NH2 * XS;
  }
  float* xh_s = reinterpret_cast<float*>(smem_raw);   // aliases the ring
  float* as_s = reinterpret_cast<float*>(smem_raw + G::UNION);  // [NH2][h]
  float* ad_s = as_s + NH2 * HEADS;                   // [NH1][HEADS]
  float* gs = ad_s + NH1 * HEADS;                     // [NH1][GS]
  float* wp_s = gs + NH1 * GS;                        // w': [NSLOT][h][NH1]
  float* dw_s = wp_s + NSLOT * HEADS * NH1;           // d(w'), d(logit)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int C = HC / HEADS;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * plane * F;
  const int row0 = warp * MT * 16;
  const int nk = (F + KC - 1) / KC;
  auto ring1 = [](int ly, int lx) { return (ly + 1) * H1W + lx + 1; };

  for (int i = tid; i < NSLOT * HEADS * NH1; i += NTHREADS) dw_s[i] = 0.f;

  for (int n0 = 0; n0 < HC; n0 += NC) {
    const bool first = n0 == 0;
    const int n1 = min(HC, n0 + NC);

    auto stage = [&](int kt, int buf) {
      const int k0 = kt * KC;
      for (int i = tid; i < NH2 * (KC / VEC); i += NTHREADS) {
        const int r = i / (KC / VEC), v = i % (KC / VEC);
        const int gy = y0 - 2 + r / H2W, gx = x0 - 2 + r % H2W;
        const int f = k0 + v * VEC;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && f < F;
        gridmma::stage_vec<T>(
            xs[buf] + r * XS + v * VEC,
            in ? xb + ((size_t)gy * W + gx) * F + f : x, in ? F - f : 0, x);
      }
      constexpr int WG = NC / VEC, DG = G::ND / VEC;
      for (int i = tid; i < KC * (WG + DG); i += NTHREADS) {
        const int kk = i / (WG + DG), v = i % (WG + DG);
        const int f = k0 + kk;
        T* dst = wsb[buf] + kk * WSB + v * VEC;
        if (v < WG) {
          const int col = n0 + v * VEC;
          const bool in = f < F && col < HC;
          gridmma::stage_vec<T>(dst, in ? wmat + (size_t)f * HC + col : wmat,
                                in ? HC - col : 0, wmat);
        } else if (first) {
          const int col = (v - WG) * VEC;
          const bool in = f < F && col < 2 * HEADS;
          gridmma::stage_vec<T>(dst, in ? wa + (size_t)f * 2 * HEADS + col
                                        : wa,
                                in ? 2 * HEADS - col : 0, wa);
        }
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float dacc[G::RPT][2 * HEADS];
#pragma unroll
    for (int rr = 0; rr < G::RPT; ++rr)
#pragma unroll
      for (int j = 0; j < 2 * HEADS; ++j) dacc[rr][j] = 0.f;

    // xh (and, in the first chunk, the attention dots) of the ring-2 cells
#pragma unroll
    for (int s = 0; s < G::NSTAGE - 1; ++s) {
      if (s < nk) stage(s, s);
      gridmma::cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt % G::NSTAGE;
      gridmma::cp_wait<G::NSTAGE - 2>();
      __syncthreads();   // chunk kt landed; chunk kt - 1's buffer is free
      if (kt + G::NSTAGE - 1 < nk)
        stage(kt + G::NSTAGE - 1, (kt + G::NSTAGE - 1) % G::NSTAGE);
      gridmma::cp_commit();
      gridmma::prep_b<KC, NC, NTHREADS>(wsb[buf], WSB, bp, bp_lo, XS);
      __syncthreads();
      gridmma::mma_chunk_pre<MT, NT, KC>(acc, xs[buf] + row0 * XS, XS, bp,
                                         bp_lo, XS);
      if (first) {
        // the attention dots, f32 FMAs in ascending k (see the note)
        const T* xr = xs[buf];
        const T* wr = wsb[buf] + NC;
#pragma unroll
        for (int rr = 0; rr < G::RPT; ++rr) {
          const int r = tid + rr * NTHREADS;
          if (r >= NH2) break;
#pragma unroll
          for (int kk = 0; kk < KC; kk += 4) {
            float xv[4];
            gridgat::load4(xr + r * XS + kk, xv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float wv[(2 * HEADS + 3) / 4 * 4];
#pragma unroll
              for (int j = 0; j < 2 * HEADS; j += 4)
                gridgat::load4(wr + (kk + q) * WSB + j, wv + j);
#pragma unroll
              for (int j = 0; j < 2 * HEADS; ++j)
                dacc[rr][j] = fmaf(xv[q], wv[j], dacc[rr][j]);
            }
          }
        }
      }
    }
    __syncthreads();   // the ring is free: xh_s aliases it
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xh_s[(row0 + 16 * i + gridmma::acc_row(e)) * XH + 8 * j +
               gridmma::acc_col(e)] = acc[i][j][e];
    if (first) {
#pragma unroll
      for (int rr = 0; rr < G::RPT; ++rr) {
        const int r = tid + rr * NTHREADS;
        if (r >= NH2) break;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) as_s[r * HEADS + h] = dacc[rr][h];
        const int ly = r / H2W - 2, lx = r % H2W - 2;
        if (ly >= -1 && ly <= TH && lx >= -1 && lx <= TW) {
#pragma unroll
          for (int h = 0; h < HEADS; ++h)
            ad_s[ring1(ly, lx) * HEADS + h] = dacc[rr][HEADS + h];
        }
      }
    }
    // cotangent chunk of the ring-1 cells: g * valid, 0 outside the tile
    if (HC % 4 == 0) {
#pragma unroll 4
      for (int i = tid; i < NH1 * (NC / 4); i += NTHREADS) {
        const int r = i / (NC / 4), c = 4 * (i % (NC / 4));
        const int gy = y0 - 1 + r / H1W, gx = x0 - 1 + r % H1W;
        const int col = n0 + c;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && col < HC) {
          const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
          if (valid[pix] > 0.f) gridgat::load4(g + pix * HC + col, v);
        }
        *reinterpret_cast<float4*>(gs + r * GS + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int i = tid; i < NH1 * NC; i += NTHREADS) {
        const int r = i / NC, c = i % NC;
        const int gy = y0 - 1 + r / H1W, gx = x0 - 1 + r % H1W;
        const int col = n0 + c;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && col < HC) {
          const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
          if (valid[pix] > 0.f) v = to_f(g[pix * HC + col]);
        }
        gs[r * GS + c] = v;
      }
    }
    __syncthreads();

    if (first) {
      // dropped softmax weights w' of the ring-1 cells
      for (int i = tid; i < NH1 * HEADS; i += NTHREADS) {
        const int r1 = i % NH1, h = i / NH1;
        float lg[NSLOT];
        int gy, gx;
        float* wp = wp_s + h * NH1 + r1;
        if (!cell_logits<T, HEADS, G>(r1, h, lg, as_s, ad_s, el, el_self, b,
                                      y0, x0, H, W, K, conn_idx, slope, gy,
                                      gx)) {
#pragma unroll
          for (int s = 0; s < NSLOT; ++s) wp[s * SLOT_STRIDE] = 0.f;
          continue;
        }
        softmax_slots(lg);
#pragma unroll
        for (int s = 0; s < NSLOT; ++s) {
          const bool live = s == MAXK || s < K;
          wp[s * SLOT_STRIDE] =
              live ? lg[s] * drop.mult(b, s == MAXK ? K : s, h, gy, gx, K,
                                       HEADS, H, W)
                   : 0.f;
        }
      }
      __syncthreads();
    }

    // dbias partial of this chunk
    if (tid < NC && n0 + tid < HC) {
      float s = 0.f;
      for (int q = 0; q < NCELL; ++q)
        s += gs[ring1(q / TW, q % TW) * GS + tid];
      db_part[(size_t)blk * HC + n0 + tid] = s;
    }

    // dxh of the block's cells: xh[q] is read by q itself (self loop) and
    // by each p = q - off_k through its slot k
    if (C % 4 == 0) {
      // 4 channels of one head a thread
#pragma unroll 2
      for (int i = tid; i < NCELL * (NC / 4); i += NTHREADS) {
        const int q = i / (NC / 4), c = 4 * (i % (NC / 4));
        const int col = n0 + c;
        if (col >= HC) continue;
        const int ly = q / TW, lx = q % TW;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= H || gx >= W) continue;
        const float* wp = wp_s + (col / C) * NH1;
        const int r1 = ring1(ly, lx);
        const float ws = wp[MAXK * SLOT_STRIDE + r1];
        const float4 g0 = *reinterpret_cast<const float4*>(gs + r1 * GS + c);
        float v[4] = {ws * g0.x, ws * g0.y, ws * g0.z, ws * g0.w};
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if (k < K) {
            const int p =
                r1 - (c_off[conn_idx][k][0] * H1W + c_off[conn_idx][k][1]);
            const float wk = wp[k * SLOT_STRIDE + p];
            const float4 gk =
                *reinterpret_cast<const float4*>(gs + p * GS + c);
            v[0] += wk * gk.x, v[1] += wk * gk.y, v[2] += wk * gk.z,
                v[3] += wk * gk.w;
          }
        }
        const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
        gridgat::store4(dxh + pix * HC + col, v);
      }
    } else {
      for (int i = tid; i < NCELL * NC; i += NTHREADS) {
        const int q = i / NC, c = i % NC;
        const int col = n0 + c;
        if (col >= HC) continue;
        const int ly = q / TW, lx = q % TW;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= H || gx >= W) continue;
        const float* wp = wp_s + (col / C) * NH1;
        const int r1 = ring1(ly, lx);
        float v = wp[MAXK * SLOT_STRIDE + r1] * gs[r1 * GS + c];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if (k < K) {
            const int p =
                r1 - (c_off[conn_idx][k][0] * H1W + c_off[conn_idx][k][1]);
            v += wp[k * SLOT_STRIDE + p] * gs[p * GS + c];
          }
        }
        const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
        dxh[pix * HC + col] = from_f<T>(v);
      }
    }

    // d(w') of each ring-1 cell, slot and head in this chunk: sum over the
    // head's channels of xh[neighbour] * g[cell]
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
        int r2 = (ly + 2) * H2W + lx + 2;
        if (sl < K)
          r2 += c_off[conn_idx][sl][0] * H2W + c_off[conn_idx][sl][1];
        const int c_lo = max(h * C, n0) - n0;
        const int c_hi = min((h + 1) * C, n1) - n0;
        const float* xr = xh_s + r2 * XH;
        const float* gr = gs + r1 * GS;
        float s = 0.f;
        int c = c_lo;
        if ((c_lo & 3) == 0)
          for (; c + 4 <= c_hi; c += 4) {
            const float4 a = *reinterpret_cast<const float4*>(xr + c);
            const float4 q = *reinterpret_cast<const float4*>(gr + c);
            s = fmaf(a.x, q.x, s);
            s = fmaf(a.y, q.y, s);
            s = fmaf(a.z, q.z, s);
            s = fmaf(a.w, q.w, s);
          }
        for (; c < c_hi; ++c) s = fmaf(xr[c], gr[c], s);
        dw_s[((sl < K ? sl : MAXK) * HEADS + h) * NH1 + r1] += s;
      }
    }
    __syncthreads();   // xh_s and gs are overwritten by the next chunk
  }

  // softmax + LeakyReLU backward of each ring-1 cell and head, with the
  // weights and dropout multipliers recomputed
  for (int i = tid; i < NH1 * HEADS; i += NTHREADS) {
    const int r1 = i % NH1, h = i / NH1;
    float lg[NSLOT];
    int gy, gx;
    const bool inside = cell_logits<T, HEADS, G>(r1, h, lg, as_s, ad_s, el,
                                                 el_self, b, y0, x0, H, W, K,
                                                 conn_idx, slope, gy, gx);
    if (!inside) {
#pragma unroll
      for (int sl = 0; sl < NSLOT; ++sl)
        dw_s[(sl * HEADS + h) * NH1 + r1] = 0.f;
      continue;
    }
    float wt[NSLOT];
#pragma unroll
    for (int sl = 0; sl < NSLOT; ++sl) wt[sl] = lg[sl];
    softmax_slots(wt);
    float dw[NSLOT];
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < NSLOT; ++sl) {
      const bool live = sl == MAXK || sl < K;
      const float dm =
          live ? drop.mult(b, sl == MAXK ? K : sl, h, gy, gx, K, HEADS, H, W)
               : 0.f;
      dw[sl] = dw_s[(sl * HEADS + h) * NH1 + r1] * dm;
      s = fmaf(wt[sl], dw[sl], s);
    }
#pragma unroll
    for (int sl = 0; sl < NSLOT; ++sl)
      dw_s[(sl * HEADS + h) * NH1 + r1] =
          wt[sl] * (dw[sl] - s) * (lg[sl] >= 0.f ? 1.f : slope);
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
                fmaf(ma, dw_s[(MAXK * HEADS + h) * NH1 + r1],
                     acc[e * HEADS + h]);
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
    const int lane = tid % 32;
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
      for (int w = 0; w < NWARPS; ++w)
        s += red[w * MAXED * HEADS + e * HEADS + h];
      dme_part[((size_t)blk * ED + e) * HEADS + h] = s;
    }
  }
}

// ---- products -----------------------------------------------------------

constexpr int PBM = 256;   // tile rows: 4 warps x 64
constexpr int PBN = 128;   // tile cols: 2 warps x 64
constexpr int PT = 256;
constexpr int PMT = 4;     // m16 tiles a warp
constexpr int PNT = 8;     // n8 tiles a warp
constexpr int PSTAGE = 3;  // cp.async ring depth: 3 x 30,720 B

template <typename T>
struct PCfg {
  static constexpr int KC = 64 / (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int KS = KC + VEC;      // K-major rows (dx role)
  static constexpr int MS = PBM + 8;       // M-major rows (dw role, A)
  static constexpr int NS = PBN + 8;       // N-major rows (dw role, B)
  static constexpr int DX_ELEMS = (PBM + PBN) * KS;
  static constexpr int DW_ELEMS = KC * (MS + NS);
  static constexpr int STAGE = DX_ELEMS > DW_ELEMS ? DX_ELEMS : DW_ELEMS;
};

// VEC consecutive columns j.. of one row of the concatenation [a | b]
// (widths wa_, wb_; zeros past both) at dst
template <typename T>
__device__ __forceinline__ void stage_cat(T* dst, const T* a, int wa_,
                                          const T* b, int wb_, int j,
                                          const T* any) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (j + VEC <= wa_) {
    gridmma::stage_vec<T>(dst, a + j, VEC, any);
  } else if (j >= wa_) {
    gridmma::stage_vec<T>(dst, b + (j - wa_), wb_ - (j - wa_), any);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int jj = j + v;
      dst[v] = jj < wa_ ? a[jj]
                        : (jj - wa_ < wb_ ? b[jj - wa_] : gridmma::zero<T>());
    }
  }
}

// Role "dw" (blocks [0, n_dw): the long ones first): part[split, f, j] =
// sum over the split's cells of x[cell, f] D[cell, j]: the dW (j < HC)
// and d(W@a) (j >= HC) partials, D = [dxh | d_ad] (width NB = HC + 2h).
// Role "dx" (the rest): dx[cell, f] = sum_j D[cell, j] Wc[f, j] with
// Wc = [W | W@a]. A warp owns a 64 x 64 tile: each staged byte feeds more
// MMAs than with 32 x 32 tiles, which shared memory's bandwidth needed.
template <typename T>
__global__ void __launch_bounds__(PT, 1)
grid_gat_bwd_products_kernel(const T* __restrict__ x,
                             const T* __restrict__ wmat,
                             const T* __restrict__ wa,
                             const T* __restrict__ dxh,
                             const T* __restrict__ dad, T* __restrict__ dx,
                             float* __restrict__ dw_part, int ncell, int F,
                             int HC, int A2, int n_dw, int dx_tiles_n,
                             int dw_tiles_n, int cells_per_split) {
  using P = PCfg<T>;
  constexpr int KC = P::KC, VEC = P::VEC, KS = P::KS, MS = P::MS;
  constexpr int NS = P::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbuf[PSTAGE];
#pragma unroll
  for (int s = 0; s < PSTAGE; ++s)
    sbuf[s] = reinterpret_cast<T*>(smem_raw) + s * P::STAGE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // 4 x 2 warps
  const int NB = HC + A2;
  const bool role_dx = (int)blockIdx.x >= n_dw;
  int m0, n0, M, N, k_begin, k_end, split = 0;
  if (role_dx) {
    const int blk = blockIdx.x - n_dw;
    m0 = (blk / dx_tiles_n) * PBM;
    n0 = (blk % dx_tiles_n) * PBN;
    M = ncell;
    N = F;
    k_begin = 0;
    k_end = NB;
  } else {
    const int blk = blockIdx.x;
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
  const int nt_live = max(0, min(PNT, (N - n0 - 64 * wn + 7) / 8));

  auto stage = [&](int k0, int buf) {
    T* s = sbuf[buf];
    if (role_dx) {
      // A: D rows m0.. (K-major), B: Wc rows n0.. (K-major)
      for (int i = tid; i < (PBM + PBN) * (KC / VEC); i += PT) {
        const int r = i / (KC / VEC), v = i % (KC / VEC);
        const int k = k0 + v * VEC;
        T* dst = s + r * KS + v * VEC;
        if (r < PBM) {
          const int m = m0 + r;
          if (m < M && k < k_end)
            stage_cat<T>(dst, dxh + (size_t)m * HC, HC, dad + (size_t)m * A2,
                         A2, k, dxh);
          else
            gridmma::stage_vec<T>(dst, dxh, 0, dxh);
        } else {
          const int n = n0 + r - PBM;
          if (n < N && k < k_end)
            stage_cat<T>(dst, wmat + (size_t)n * HC, HC, wa + (size_t)n * A2,
                         A2, k, wmat);
          else
            gridmma::stage_vec<T>(dst, wmat, 0, wmat);
        }
      }
    } else {
      // A: x^T (rows = cells k, M-major), B: D (rows = cells k, N-major)
      T* sa = s;
      T* sb = s + KC * MS;
      for (int i = tid; i < KC * (PBM / VEC + PBN / VEC); i += PT) {
        const int kk = i / (PBM / VEC + PBN / VEC);
        const int v = i % (PBM / VEC + PBN / VEC);
        const int k = k0 + kk;
        if (v < PBM / VEC) {
          const int m = m0 + v * VEC;
          T* dst = sa + kk * MS + v * VEC;
          const bool in = k < k_end && m < M;
          gridmma::stage_vec<T>(dst, in ? x + (size_t)k * F + m : x,
                                in ? M - m : 0, x);
        } else {
          const int n = n0 + (v - PBM / VEC) * VEC;
          T* dst = sb + kk * NS + (v - PBM / VEC) * VEC;
          if (k < k_end && n < N)
            stage_cat<T>(dst, dxh + (size_t)k * HC, HC, dad + (size_t)k * A2,
                         A2, n, dxh);
          else
            gridmma::stage_vec<T>(dst, dxh, 0, dxh);
        }
      }
    }
  };

  float acc[PMT][PNT][4];
#pragma unroll
  for (int i = 0; i < PMT; ++i)
#pragma unroll
    for (int j = 0; j < PNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (k_end - k_begin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < PSTAGE - 1; ++s) {
    if (s < nk) stage(k_begin + s * KC, s);
    gridmma::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    gridmma::cp_wait<PSTAGE - 2>();
    __syncthreads();   // chunk kt landed; chunk kt - 1's buffer is free
    if (kt + PSTAGE - 1 < nk)
      stage(k_begin + (kt + PSTAGE - 1) * KC, (kt + PSTAGE - 1) % PSTAGE);
    gridmma::cp_commit();
    const T* s = sbuf[kt % PSTAGE];
    if (role_dx)
      gridmma::mma_chunk<PMT, PNT, KC, true, true>(
          acc, s + (64 * wm) * KS, KS, s + (PBM + 64 * wn) * KS, KS,
          nt_live);
    else
      gridmma::mma_chunk<PMT, PNT, KC, false, false>(
          acc, s + 64 * wm, MS, s + KC * MS + 64 * wn, NS, nt_live);
  }

#pragma unroll
  for (int i = 0; i < PMT; ++i) {
#pragma unroll
    for (int j = 0; j < PNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 64 * wm + 16 * i + gridmma::acc_row(e);
        const int n = n0 + 64 * wn + 8 * j + gridmma::acc_col(e);
        if (m >= M || n >= N) continue;
        if (role_dx)
          dx[(size_t)m * F + n] = from_f<T>(acc[i][j][e]);
        else
          dw_part[((size_t)split * F + m) * NB + n] = acc[i][j][e];
      }
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
dim3 attn_grid(int B, int H, int W) {
  using G = Cfg<T, HEADS>;
  return dim3((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
}

template <typename T, int HEADS>
int launch(const BwdArgs& a, Drop drop, cudaStream_t stream) {
  const int smem = Cfg<T, HEADS>::SMEM;
  auto attn = grid_gat_bwd_attn_kernel<T, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn<<<attn_grid<T, HEADS>(a.B, a.H, a.W), NTHREADS, smem, stream>>>(
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
  const int psmem = PSTAGE * PCfg<T>::STAGE * (int)sizeof(T);
  auto prod = grid_gat_bwd_products_kernel<T>;
  err = cudaFuncSetAttribute(
      prod, cudaFuncAttributeMaxDynamicSharedMemorySize, psmem);
  if (err != cudaSuccess) return (int)err;
  prod<<<n_dx + n_dw, PT, psmem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.wa), static_cast<const T*>(a.dxh),
      static_cast<const T*>(a.dad), static_cast<T*>(a.dx),
      static_cast<float*>(a.dw_part), ncell, a.F, a.HC, A2, n_dw,
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
    case 8:
      return launch<T, 8>(a, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of attention blocks, the leading size of dme_part and db_part
// below, for `heads` heads on a [B, H, W] batch (-1 for heads it does not
// take). The block tile does not depend on the I/O type.
extern "C" int grid_gat_bwd_blocks(int heads, int B, int H, int W) {
  dim3 g;
  switch (heads) {
    case 1: g = attn_grid<float, 1>(B, H, W); break;
    case 2: g = attn_grid<float, 2>(B, H, W); break;
    case 4: g = attn_grid<float, 4>(B, H, W); break;
    case 8: g = attn_grid<float, 8>(B, H, W); break;
    default: return -1;
  }
  return (int)(g.x * g.y * g.z);
}

// C entry, bound with ctypes: launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success). dtype 0 = float32, 1 = bfloat16 for x,
// w, wa, el, el_self, g, eattr, mattr, dxh, dad and dx; valid, dmask and
// the partials are float32. Layouts (contiguous): x [B,H,W,F], w [F,HC],
// wa [F,2h], el [B,K,h,H,W], el_self [B,h,H,W], valid [B,H,W],
// g [B,H,W,HC], eattr [B,K,H,W,ed], mattr [B,H,W,ed] (mean incoming
// attribute), dxh [B,H,W,HC], dad [B,H,W,2h], dme_part [nblk,ed,h],
// db_part [nblk,HC] with nblk = grid_gat_bwd_blocks(heads, B, H, W),
// dx [B,H,W,F], dw_part [nsplit,F,HC+2h]; split s covers cells
// [s*cps, (s+1)*cps) of the B*H*W cells, and nsplit * cps >= B*H*W.
// Dropout as in grid_gat_fwd.
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
