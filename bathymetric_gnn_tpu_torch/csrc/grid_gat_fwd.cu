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
// Design (simple and correct first). One block of 256 threads per
// (8 x 16 cells, tile). The block stages x for the 10 x 18 halo-extended
// cells in shared memory, 32 features at a time, and computes xh for the
// halo cells with a register-tiled SIMT product (6 x 8 outputs a thread,
// f32 accumulation), 64 output channels at a time. The first channel
// chunk also computes the 2 * heads attention dots from the same staged x
// and then the softmax weights of all 128 cells, kept in shared memory.
// Each chunk ends with the weighted sum over the 3 x 3 window, the
// epilogue and a coalesced store. Softmax and accumulation are f32 for
// both I/O types; with bf16 I/O, x, W, W@a, el, el_self and the output
// are bf16 (the Pallas kernel rounds at the same places).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s FP32
// non-tensor, 3.35 TB/s). At a 1024^2 tile in f32 a 256 -> 256 layer must
// move ~2.30 GB (x 1.07 GB in, out 1.07 GB, el + el_self 0.15 GB: ~0.69 ms)
// and do ~146.5 GFLOP (x@W 137.4, dots 4.3, weighted sum 4.8: ~2.19 ms at
// the FP32 rate), so in f32 it is bound by operations. This version does
// more than that: the halo cells' xh is recomputed (192 padded rows per
// 128 output cells, 1.5x the x@W work) and x is re-read from L2 once per
// 64-channel chunk. Tensor cores (wgmma, in bf16 at least), TMA loads and
// shared-memory pipelining are later work.

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

constexpr int TH = 8;                   // output rows per block
constexpr int TW = 16;                  // output cols per block
constexpr int HALO_W = TW + 2;
constexpr int NHALO = (TH + 2) * HALO_W;  // 180 halo-extended cells
constexpr int NCELL = TH * TW;          // 128 output cells
constexpr int RM = 6;                   // product rows per thread
constexpr int RN = 8;                   // product cols per thread
constexpr int MROWS = 32 * RM;          // 192 >= NHALO, padded with zeros
constexpr int NC = RN * 8;              // 64 output channels per chunk
constexpr int KC = 32;                  // input features per staging step
constexpr int NTHREADS = 256;           // 32 row groups x 8 col groups
constexpr int XS_STRIDE = MROWS + 2;    // x tile, transposed [KC][XS_STRIDE]
constexpr int XH_STRIDE = NC + 4;       // xh tile [MROWS][XH_STRIDE]
constexpr int U_FLOATS =
    (KC * XS_STRIDE > MROWS * XH_STRIDE) ? KC * XS_STRIDE : MROWS * XH_STRIDE;

static_assert(NHALO <= MROWS, "halo rows must fit the padded product");
static_assert(NTHREADS % NC == 0, "aggregation maps threads to channels");
static_assert(U_FLOATS % 4 == 0, "keep later shared arrays 16B aligned");

template <int HEADS>
constexpr int smem_floats() {
  return U_FLOATS + KC * NC + KC * 2 * HEADS + NHALO * HEADS +
         NCELL * HEADS + (MAXK + 1) * HEADS * NCELL;
}

template <typename T, int HEADS>
__global__ void __launch_bounds__(NTHREADS)
grid_gat_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                    const T* __restrict__ wa, const T* __restrict__ el,
                    const T* __restrict__ el_self,
                    const float* __restrict__ valid,
                    const float* __restrict__ bias,
                    const float* __restrict__ bn_scale,
                    const float* __restrict__ bn_shift, T* __restrict__ out,
                    int H, int W, int F, int HC, int K, int conn_idx,
                    float slope, int fuse_bn, int fuse_relu, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;     // staged x, transposed: [KC][XS_STRIDE]
  float* xh_s = smem;    // xh of the halo cells: [MROWS][XH_STRIDE]
                         // (aliases xsT: written only after the k loop)
  float* ws = smem + U_FLOATS;            // [KC][NC]
  float* was = ws + KC * NC;              // [KC][2 * HEADS]
  float* asrc_s = was + KC * 2 * HEADS;   // [NHALO][HEADS]
  float* adst_s = asrc_s + NHALO * HEADS; // [NCELL][HEADS]
  float* wts_s = adst_s + NCELL * HEADS;  // [HEADS][MAXK + 1][NCELL]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int C = HC / HEADS;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * plane * F;
  const int ty = tid / 8;  // product row group: rows ty*RM .. ty*RM+RM-1
  const int tx = tid % 8;  // product col group: cols tx*RN .. tx*RN+RN-1

  float dacc[2 * HEADS];

  for (int n0 = 0; n0 < HC; n0 += NC) {
    const bool first = n0 == 0;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * HEADS; ++j) dacc[j] = 0.f;

    for (int k0 = 0; k0 < F; k0 += KC) {
      // stage x (halo cells x KC features), zeros outside the tile
      for (int i = tid; i < MROWS * KC; i += NTHREADS) {
        const int r = i / KC, kk = i % KC;
        float v = 0.f;
        if (r < NHALO) {
          const int gy = y0 - 1 + r / HALO_W, gx = x0 - 1 + r % HALO_W;
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
        const float2 a01 = *reinterpret_cast<const float2*>(ar);
        const float2 a23 = *reinterpret_cast<const float2*>(ar + 2);
        const float2 a45 = *reinterpret_cast<const float2*>(ar + 4);
        const float a[RM] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
        const float* br = ws + kk * NC + tx * RN;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 4);
        const float bv[RN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      if (first && tid < MROWS) {
        for (int kk = 0; kk < KC; ++kk) {
          const float xv = xsT[kk * XS_STRIDE + tid];
#pragma unroll
          for (int j = 0; j < 2 * HEADS; ++j)
            dacc[j] = fmaf(xv, was[kk * 2 * HEADS + j], dacc[j]);
        }
      }
      __syncthreads();
    }

    // xh of this channel chunk for all halo cells -> shared
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* dst = xh_s + (ty * RM + i) * XH_STRIDE + tx * RN;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (first && tid < NHALO) {
#pragma unroll
      for (int h = 0; h < HEADS; ++h) asrc_s[tid * HEADS + h] = dacc[h];
      const int hy = tid / HALO_W, hx = tid % HALO_W;
      if (hy >= 1 && hy <= TH && hx >= 1 && hx <= TW) {
        const int cell = (hy - 1) * TW + (hx - 1);
#pragma unroll
        for (int h = 0; h < HEADS; ++h)
          adst_s[cell * HEADS + h] = dacc[HEADS + h];
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
        const int hc = (ly + 1) * HALO_W + (lx + 1);
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
              const int hn = hc + dr * HALO_W + dc;
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

    // weighted sum over the 3x3 window + bias + epilogue + mask
    {
      const int c = tid % NC;
      const int col = n0 + c;
      if (col < HC) {
        const int h = col / C;
        const float bcol = bias[col];
        const float sc = fuse_bn ? bn_scale[col] : 1.f;
        const float sh = fuse_bn ? bn_shift[col] : 0.f;
        const float* wbase = wts_s + h * (MAXK + 1) * NCELL;
        for (int cell = tid / NC; cell < NCELL; cell += NTHREADS / NC) {
          const int ly = cell / TW, lx = cell % TW;
          const int gy = y0 + ly, gx = x0 + lx;
          if (gy >= H || gx >= W) continue;
          const int hc = (ly + 1) * HALO_W + (lx + 1);
          float v = xh_s[hc * XH_STRIDE + c] * wbase[MAXK * NCELL + cell];
#pragma unroll
          for (int k = 0; k < MAXK; ++k) {
            if (k < K) {
              const int hn =
                  hc + c_off[conn_idx][k][0] * HALO_W + c_off[conn_idx][k][1];
              v += xh_s[hn * XH_STRIDE + c] * wbase[k * NCELL + cell];
            }
          }
          v += bcol;
          if (fuse_bn) v = v * sc + sh;
          if (fuse_relu) v = fmaxf(v, 0.f);
          const size_t pix = (size_t)b * plane + (size_t)gy * W + gx;
          v *= valid[pix] > 0.f ? 1.f : 0.f;
          out[pix * HC + col] = from_f<T>(v);
        }
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
  const int smem = smem_floats<HEADS>() * (int)sizeof(float);
  auto kern = grid_gat_fwd_kernel<T, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
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
