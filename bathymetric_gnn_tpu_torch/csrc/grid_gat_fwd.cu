// Fused grid-GAT layer, forward (kernel A), for Hopper (sm_90a), CUDA C++.
//
// Replaces bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py::_kernel (the
// Pallas TPU kernel behind fused_grid_gat_infer and the forward of
// fused_grid_gat) in both forms: inference, with an optional
// BatchNorm-affine + ReLU epilogue, and training, with post-softmax
// attention dropout from a streamed mask or drawn in the kernel (Philox,
// grid_gat_common.cuh; the backward, grid_gat_bwd.cu, regenerates the same
// draw). For each cell of a
// [B, H, W, F] batch of tiles and each of `heads` heads it computes
//   xh = x @ W                       (W [F, HC], HC = heads * C)
//   a  = x @ (W @ [a_src | a_dst])   (the attention dots, [2 * heads])
//   logit_k = LeakyReLU(a_src[nbr_k] + a_dst[cell] + el[k])   k < K
//   logit_s = LeakyReLU(a_src[cell]  + a_dst[cell] + el_self)
//   w = softmax over {logit_k} U {logit_s}    [* dropout multipliers]
//   out = (w_s * xh[cell] + sum_k w_k * xh[nbr_k] + bias) [* bn_scale
//         + bn_shift] [ReLU] * (valid > 0)
// with both products done in this kernel's own body. Neighbours outside
// the tile are skipped (their weight is exactly 0 in the reference, whose
// edge logit is premasked to -1e30); missing neighbours inside the tile
// arrive premasked the same way through `el`.
//
// Design. What bounds it on an H100 SXM (3.35 TB/s; tensor cores: 989
// TFLOP/s bf16, 495 TF32): at a 1024^2 tile a 256 -> 256 layer must move
// ~2.30 GB in f32 (x 1.07 GB in, out 1.07 GB, el + el_self 0.15 GB: ~0.69
// ms) and do ~146.5 GFLOP, 141.7 of them the x@W and dot products. In f32
// those run as 3xTF32 (three TF32 MMAs a product, grid_gat_mma.cuh): at
// 495/3 = 165 TFLOP/s plus the 9-way weighted sum at the 67 TFLOP/s FP32
// rate, ~0.93 ms, so f32 is bound by operations; in bf16 (half the bytes,
// products at 989 TFLOP/s) it is bound by bytes. The design:
//  * x @ W on the tensor cores (mma.sync, not wgmma, through
//    gridmma::mma_chunk_pre: 3xTF32 for f32, bf16 MMA with f32
//    accumulation for bf16), each warp 2 m16 row tiles x all 8 n8 column
//    tiles of a 64-channel chunk (128 registers a thread). Each staged W
//    chunk is split into its TF32 hi / lo words (transposed, in bf16) once
//    for all warps (gridmma::prep_b) instead of once per warp;
//  * the 2 * heads attention dots x @ (W @ [a_src|a_dst]) (3 % of the
//    operations at 4 heads) as f32 FMAs on the CUDA cores from the same
//    staged x, one halo cell a thread, in ascending k, the order of the
//    earlier SIMT kernels. The dots decide LeakyReLU's branch, whose
//    derivative jumps from 1 to the slope at 0: a logit within rounding of
//    0 takes the other branch when its dot is rounded otherwise. With the
//    dots on the tensor cores (other summation order, truncating
//    accumulation), kernel B's gradients missed the plain version's at
//    the 4 x 256^2 check batch (x 1.35e-2 of its scale, against 2e-4)
//    through such logits; kernel B recomputes the dots the same way;
//  * a block of 8 warps owns 14 x 14 output cells; its 16 x 16
//    halo-extended cells are exactly 16 m16 tiles, so xh is recomputed for
//    1.31x the cells it outputs (1.5x in the 8 x 16 SIMT version with its
//    192-row padding). Two such blocks share an SM, so one block's loads,
//    products and epilogue overlap the other's: on the H100 that ran
//    faster than one block of 16 warps on 14 x 30 cells (1.22x recompute,
//    one block an SM) and than one block of 8 warps with 4 m16 tiles each.
//    At 8 heads the softmax weights leave room for one block an SM, of 16
//    warps;
//  * x and W stream through a double-buffered cp.async ring (K chunks of
//    64 bytes a row: 16 f32 or 32 bf16 features; zero-filled outside the
//    tile, past F and past HC), so the next chunk loads while this one
//    multiplies; one barrier a step (a third buffer ran no faster);
//  * x is staged once per 64-channel chunk: 4 times at HC 256 (from L2 in
//    practice). Staging it once per block would need the whole
//    [256, F] halo block in shared memory (256 KB at F 256 in f32), and a
//    wider chunk does not fit two blocks an SM;
//  * softmax (f32, with the dropout multipliers folded in) once per block
//    in the first chunk, kept in shared memory for all heads; each chunk
//    ends with the 9-way weighted sum (4 channels a thread, float4 reads of
//    the xh chunk), the epilogue and a coalesced store.
// Shared memory, f32, at 4 heads: xh chunk 256 x 72 f32 (73,728 B; the two
// staging buffers, 2 x 26,112 B, and the split W chunk, 10,240 B, alias
// it), a_src / a_dst 7,232 B, softmax weights 28,224 B, the chunk's bias /
// BatchNorm constants 768 B: 109,952 B a block. bf16 stages x and W in
// bf16 and keeps xh, the softmax and the sums in f32 (the Pallas kernel
// rounds only x, W, W@a, el, el_self and the output to bf16, as here).
// Where the time goes (builds with one phase removed at a time, on an
// H100, before the two-block layout): the 3xTF32 MMAs, staging x from L2
// and the weighted-sum epilogue each take a large share, the attention
// dots a small one. mma.sync runs far below the tensor cores' wgmma rate;
// wgmma with a producer warp, and the epilogue overlapped with the next
// chunk's loads inside a block, are the next step.

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

constexpr int NC = 64;                  // output channels per chunk
constexpr int WS = NC + 24;             // staged W row: NC + dots + pad
constexpr int XH = NC + 8;              // xh chunk row (f32)

template <typename T, int HEADS>
struct Cfg {
  static constexpr int TH = 14;
  static constexpr int TW = 14;
  // two blocks of 8 warps an SM (each block's loads, products and epilogue
  // overlap the other's); at 8 heads the softmax weights allow one block,
  // of 16 warps
  static constexpr int MIN_BLOCKS = HEADS == 8 ? 1 : 2;
  static constexpr int NWARPS = HEADS == 8 ? 16 : 8;
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int HW = TW + 2;                 // halo width
  static constexpr int NHALO = (TH + 2) * HW;       // 256
  static constexpr int NCELL = TH * TW;             // 196
  static constexpr int MT = NHALO / 16 / NWARPS;    // m16 tiles a warp
  static constexpr int ND = 2 * HEADS <= 8 ? 8 : 16;  // dot columns
  static constexpr int NT = NC / 8;
  static constexpr int RPT = (NHALO + NTHREADS - 1) / NTHREADS;
  static constexpr int KC = 64 / (int)sizeof(T);    // features a stage
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int XS = KC + VEC;               // staged x row
  // bytes
  static constexpr int STAGE = NHALO * XS * (int)sizeof(T) +
                               KC * WS * (int)sizeof(T);
  static constexpr int NSTAGE = 2;                  // ring depth
  static constexpr int XH_BYTES = NHALO * XH * 4;
  // W's chunk split (f32) or transposed (bf16) once for all warps
  static constexpr int PREP_OFF = NSTAGE * STAGE;
  static constexpr int PREP_BYTES =
      gridmma::Prep<T>::WORDS * NC * XS *
      (int)sizeof(typename gridmma::Prep<T>::type);
  static constexpr int UNION = XH_BYTES > PREP_OFF + PREP_BYTES
                                   ? XH_BYTES : PREP_OFF + PREP_BYTES;
  static constexpr int SMEM = UNION + 4 * (NHALO * HEADS + NCELL * HEADS +
                                           (MAXK + 1) * HEADS * NCELL +
                                           3 * NC);
  static_assert(NHALO % (16 * NWARPS) == 0, "halo rows: whole m16 tiles");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(STAGE % 16 == 0 && UNION % 16 == 0, "16B alignment");
};

template <typename T, int HEADS>
__global__ void __launch_bounds__(Cfg<T, HEADS>::NTHREADS,
                                  Cfg<T, HEADS>::MIN_BLOCKS)
grid_gat_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                    const T* __restrict__ wa, const T* __restrict__ el,
                    const T* __restrict__ el_self,
                    const float* __restrict__ valid,
                    const float* __restrict__ bias,
                    const float* __restrict__ bn_scale,
                    const float* __restrict__ bn_shift, T* __restrict__ out,
                    int H, int W, int F, int HC, int K, int conn_idx,
                    float slope, int fuse_bn, int fuse_relu, Drop drop) {
  using G = Cfg<T, HEADS>;
  constexpr int TH = G::TH, TW = G::TW, HW = G::HW, NHALO = G::NHALO;
  constexpr int NTHREADS = G::NTHREADS;
  constexpr int NCELL = G::NCELL, MT = G::MT, NT = G::NT, KC = G::KC;
  constexpr int VEC = G::VEC, XS = G::XS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using PT = typename gridmma::Prep<T>::type;
  PT* bp = reinterpret_cast<PT*>(smem_raw + G::PREP_OFF);  // in the union
  PT* bp_lo = bp + NC * XS;
  T* xs[G::NSTAGE];    // the staging ring: x and W (+ W@a) K chunks
  T* wsb[G::NSTAGE];
#pragma unroll
  for (int s = 0; s < G::NSTAGE; ++s) {
    xs[s] = reinterpret_cast<T*>(smem_raw + s * G::STAGE);
    wsb[s] = xs[s] + NHALO * XS;
  }
  float* xh_s = reinterpret_cast<float*>(smem_raw);   // aliases the ring
  float* asrc_s = reinterpret_cast<float*>(smem_raw + G::UNION);
  float* adst_s = asrc_s + NHALO * HEADS;             // [NCELL][HEADS]
  float* wts_s = adst_s + NCELL * HEADS;              // [HEADS][K+1][NCELL]
  float* epi_s = wts_s + (MAXK + 1) * HEADS * NCELL;  // bias, scale, shift

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int C = HC / HEADS;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * plane * F;
  const int row0 = warp * MT * 16;    // this warp's first halo row
  const int nk = (F + KC - 1) / KC;

  for (int n0 = 0; n0 < HC; n0 += NC) {
    const bool first = n0 == 0;

    // one K chunk of x (halo cells) and W (+ W@a in the first chunk)
    auto stage = [&](int kt, int buf) {
      const int k0 = kt * KC;
      for (int i = tid; i < NHALO * (KC / VEC); i += NTHREADS) {
        const int r = i / (KC / VEC), v = i % (KC / VEC);
        const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
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
        T* dst = wsb[buf] + kk * WS + v * VEC;
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

    // the chunk's epilogue constants (read after the k loop's barriers)
    for (int c = tid; c < NC; c += NTHREADS) {
      const int col = min(n0 + c, HC - 1);
      epi_s[c] = bias[col];
      epi_s[NC + c] = fuse_bn ? bn_scale[col] : 1.f;
      epi_s[2 * NC + c] = fuse_bn ? bn_shift[col] : 0.f;
    }

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
      gridmma::prep_b<KC, NC, NTHREADS>(wsb[buf], WS, bp, bp_lo, XS);
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
          if (r >= NHALO) break;
#pragma unroll
          for (int kk = 0; kk < KC; kk += 4) {
            float xv[4];
            gridgat::load4(xr + r * XS + kk, xv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float wv[(2 * HEADS + 3) / 4 * 4];
#pragma unroll
              for (int j = 0; j < 2 * HEADS; j += 4)
                gridgat::load4(wr + (kk + q) * WS + j, wv + j);
#pragma unroll
              for (int j = 0; j < 2 * HEADS; ++j)
                dacc[rr][j] = fmaf(xv[q], wv[j], dacc[rr][j]);
            }
          }
        }
      }
    }
    __syncthreads();   // the ring is free: xh_s aliases it

    // xh of this chunk (all halo cells) -> shared; first chunk: the dots
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
        if (r >= NHALO) break;
        const int hy = r / HW, hx = r % HW;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) asrc_s[r * HEADS + h] = dacc[rr][h];
        if (hy >= 1 && hy <= TH && hx >= 1 && hx <= TW) {
#pragma unroll
          for (int h = 0; h < HEADS; ++h)
            adst_s[((hy - 1) * TW + hx - 1) * HEADS + h] = dacc[rr][HEADS + h];
        }
      }
    }
    __syncthreads();

    if (first) {
      // softmax over the K neighbours + self loop, per (cell, head)
      for (int i = tid; i < NCELL * HEADS; i += NTHREADS) {
        const int cell = i % NCELL, h = i / NCELL;
        const int ly = cell / TW, lx = cell % TW;
        const int gy = y0 + ly, gx = x0 + lx;
        float* wrow = wts_s + h * (MAXK + 1) * NCELL + cell;
        if (gy >= H || gx >= W) {
#pragma unroll
          for (int k = 0; k <= MAXK; ++k) wrow[k * NCELL] = 0.f;
          continue;
        }
        const size_t pix = (size_t)gy * W + gx;
        const int hc = (ly + 1) * HW + (lx + 1);
        const float ad = adst_s[cell * HEADS + h];
        const float self_lg = leaky(
            asrc_s[hc * HEADS + h] + ad +
                to_f(el_self[((size_t)b * HEADS + h) * plane + pix]),
            slope);
        float lg[MAXK];
        float m = self_lg;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          lg[k] = -INFINITY;
          if (k < K) {
            const int dr = c_off[conn_idx][k][0], dc = c_off[conn_idx][k][1];
            const int ny = gy + dr, nx = gx + dc;
            if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
              const int hn = hc + dr * HW + dc;
              lg[k] = leaky(
                  asrc_s[hn * HEADS + h] + ad +
                      to_f(el[(((size_t)b * K + k) * HEADS + h) * plane + pix]),
                  slope);
              m = fmaxf(m, lg[k]);
            }
          }
        }
        const float e_self = expf(self_lg - m);
        float den = e_self;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          lg[k] = expf(lg[k] - m);  // exp(-inf) = 0 for skipped slots
          den += lg[k];
        }
        den = fmaxf(den, 1e-16f);
        // post-softmax attention dropout (training form only)
#pragma unroll
        for (int k = 0; k < MAXK; ++k)
          wrow[k * NCELL] =
              k < K ? lg[k] / den * drop.mult(b, k, h, gy, gx, K, HEADS, H, W)
                    : 0.f;
        wrow[MAXK * NCELL] =
            e_self / den * drop.mult(b, K, h, gy, gx, K, HEADS, H, W);
      }
      __syncthreads();
    }

    // weighted sum over the 3x3 window + bias + epilogue + mask, 4
    // channels of one cell a thread
    const bool one_head = C % 4 == 0;
    const bool vec_out = HC % 4 == 0;
    for (int i = tid; i < NCELL * (NC / 4); i += NTHREADS) {
      const int c = 4 * (i % (NC / 4)), cell = i / (NC / 4);
      const int col0 = n0 + c;
      if (col0 >= HC) continue;
      const int ly = cell / TW, lx = cell % TW;
      const int gy = y0 + ly, gx = x0 + lx;
      if (gy >= H || gx >= W) continue;
      const int hc = (ly + 1) * HW + (lx + 1);
      float v[4];
      if (one_head) {
        const float* wb = wts_s + (col0 / C) * (MAXK + 1) * NCELL + cell;
        const float4 s = *reinterpret_cast<const float4*>(xh_s + hc * XH + c);
        const float ws0 = wb[MAXK * NCELL];
        v[0] = s.x * ws0, v[1] = s.y * ws0, v[2] = s.z * ws0, v[3] = s.w * ws0;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if (k < K) {
            const int hn =
                hc + c_off[conn_idx][k][0] * HW + c_off[conn_idx][k][1];
            const float4 q =
                *reinterpret_cast<const float4*>(xh_s + hn * XH + c);
            const float wk = wb[k * NCELL];
            v[0] += q.x * wk, v[1] += q.y * wk, v[2] += q.z * wk,
                v[3] += q.w * wk;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = min(col0 + j, HC - 1) / C;
          const float* wb = wts_s + h * (MAXK + 1) * NCELL + cell;
          float a = xh_s[hc * XH + c + j] * wb[MAXK * NCELL];
#pragma unroll
          for (int k = 0; k < MAXK; ++k) {
            if (k < K) {
              const int hn =
                  hc + c_off[conn_idx][k][0] * HW + c_off[conn_idx][k][1];
              a += xh_s[hn * XH + c + j] * wb[k * NCELL];
            }
          }
          v[j] = a;
        }
      }
      const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
      const float keep = valid[pix] > 0.f ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = v[j] + epi_s[c + j];
        if (fuse_bn) a = a * epi_s[NC + c + j] + epi_s[2 * NC + c + j];
        if (fuse_relu) a = fmaxf(a, 0.f);
        v[j] = a * keep;
      }
      T* dst = out + pix * HC + col0;
      if (vec_out) {
        gridgat::store4(dst, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + j < HC) dst[j] = from_f<T>(v[j]);
      }
    }
    __syncthreads();  // xh_s is overwritten by the next chunk's staging
  }
}

template <typename T, int HEADS>
int launch(const void* x, const void* w, const void* wa, const void* el,
           const void* el_self, const void* valid, const void* bias,
           const void* bn_scale, const void* bn_shift, void* out, int B,
           int H, int W, int F, int HC, int K, float slope, int fuse_bn,
           int fuse_relu, Drop drop, cudaStream_t stream) {
  const int smem = Cfg<T, HEADS>::SMEM;
  auto kern = grid_gat_fwd_kernel<T, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int TH = Cfg<T, HEADS>::TH, TW = Cfg<T, HEADS>::TW;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, Cfg<T, HEADS>::NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(wa), static_cast<const T*>(el),
      static_cast<const T*>(el_self), static_cast<const float*>(valid),
      static_cast<const float*>(bias), static_cast<const float*>(bn_scale),
      static_cast<const float*>(bn_shift), static_cast<T*>(out), H, W, F,
      HC, K, K == 8 ? 0 : 1, slope, fuse_bn, fuse_relu, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_heads(int heads, const void* x, const void* w, const void* wa,
                   const void* el, const void* el_self, const void* valid,
                   const void* bias, const void* bn_scale,
                   const void* bn_shift, void* out, int B, int H, int W,
                   int F, int HC, int K, float slope, int fuse_bn,
                   int fuse_relu, Drop drop, cudaStream_t s) {
  switch (heads) {
    case 1:
      return launch<T, 1>(x, w, wa, el, el_self, valid, bias, bn_scale,
                          bn_shift, out, B, H, W, F, HC, K, slope, fuse_bn,
                          fuse_relu, drop, s);
    case 2:
      return launch<T, 2>(x, w, wa, el, el_self, valid, bias, bn_scale,
                          bn_shift, out, B, H, W, F, HC, K, slope, fuse_bn,
                          fuse_relu, drop, s);
    case 4:
      return launch<T, 4>(x, w, wa, el, el_self, valid, bias, bn_scale,
                          bn_shift, out, B, H, W, F, HC, K, slope, fuse_bn,
                          fuse_relu, drop, s);
    case 8:
      return launch<T, 8>(x, w, wa, el, el_self, valid, bias, bn_scale,
                          bn_shift, out, B, H, W, F, HC, K, slope, fuse_bn,
                          fuse_relu, drop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Writes the draw of Drop mode 2 as a mask [B, K+1, heads, H, W]: the
// multipliers kernel A (and kernel B) apply. A debug entry for checking
// the in-kernel draw against the streamed-mask path; the model never calls
// it.
__global__ void drop_mask_kernel(float* __restrict__ out, Drop drop, int B,
                                 int K, int heads, int H, int W) {
  const size_t n = (size_t)B * (K + 1) * heads * H * W;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    size_t r = i;
    const int gx = (int)(r % W);
    r /= W;
    const int gy = (int)(r % H);
    r /= H;
    const int h = (int)(r % heads);
    r /= heads;
    const int slot = (int)(r % (K + 1));
    const int b = (int)(r / (K + 1));
    out[i] = drop.mult(b, slot, h, gy, gx, K, heads, H, W);
  }
}

Drop make_drop(int drop_mode, const void* dmask, const void* seed,
               unsigned int thresh, float keep_inv) {
  Drop d;
  d.mode = drop_mode;
  d.mask = static_cast<const float*>(dmask);
  d.seed = static_cast<const unsigned long long*>(seed);
  d.thresh = thresh;
  d.keep_inv = keep_inv;
  return d;
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (x, w, wa,
// el, el_self, out); valid, bias, bn_scale and bn_shift are float32.
// Layouts: x [B, H, W, F], w [F, HC], wa [F, 2*heads],
// el [B, K, heads, H, W], el_self [B, heads, H, W], valid [B, H, W],
// out [B, H, W, HC]; all contiguous. Attention dropout (training form):
// drop_mode 0 none; 1 streamed f32 dmask [B, K+1, heads, H, W]; 2 drawn
// in the kernel from the uint64 seed at device pointer `seed`, dropping
// where the Philox word < thresh and scaling kept weights by keep_inv.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int grid_gat_fwd(int dtype, const void* x, const void* w,
                            const void* wa, const void* el,
                            const void* el_self, const void* valid,
                            const void* bias, const void* bn_scale,
                            const void* bn_shift, void* out, int B, int H,
                            int W, int F, int HC, int heads, int conn,
                            float slope, int fuse_bn, int fuse_relu,
                            int drop_mode, const void* dmask,
                            const void* seed, unsigned int thresh,
                            float keep_inv, void* stream) {
  if (conn != 4 && conn != 8) return (int)cudaErrorInvalidValue;
  if (B < 1 || H < 1 || W < 1 || F < 1 || HC < 1 || HC % heads != 0)
    return (int)cudaErrorInvalidValue;
  if (drop_mode < 0 || drop_mode > 2 || (drop_mode == 1 && !dmask) ||
      (drop_mode == 2 && !seed))
    return (int)cudaErrorInvalidValue;
  const Drop drop = make_drop(drop_mode, dmask, seed, thresh, keep_inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_heads<float>(heads, x, w, wa, el, el_self, valid, bias,
                                 bn_scale, bn_shift, out, B, H, W, F, HC,
                                 conn, slope, fuse_bn, fuse_relu, drop, s);
  if (dtype == 1)
    return dispatch_heads<__nv_bfloat16>(heads, x, w, wa, el, el_self, valid,
                                         bias, bn_scale, bn_shift, out, B, H,
                                         W, F, HC, conn, slope, fuse_bn,
                                         fuse_relu, drop, s);
  return (int)cudaErrorInvalidValue;
}

// The in-kernel draw (drop_mode 2 above) written out as an f32 mask
// [B, K+1, heads, H, W], K = conn.
extern "C" int grid_gat_drop_mask(void* out, const void* seed,
                                  unsigned int thresh, float keep_inv, int B,
                                  int conn, int heads, int H, int W,
                                  void* stream) {
  if ((conn != 4 && conn != 8) || !seed || B < 1 || heads < 1 || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  const Drop drop = make_drop(2, nullptr, seed, thresh, keep_inv);
  drop_mask_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), drop, B, conn, heads, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* grid_gat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
