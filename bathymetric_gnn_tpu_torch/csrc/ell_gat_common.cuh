// Device helpers shared by the ELL-GAT kernels (ell_gat_fwd.cu, kernel C;
// ell_gat_bwd.cu, kernel C'; the banded kernels D, D' and E): warp
// reductions, LeakyReLU, the I/O types (float or bf16, converted to f32 on
// load: every product, softmax and sum is taken in f32), vector loads, the
// attention-dots kernel and the attention-dropout draw.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace ellgat {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to the nearest bf16 (where the JAX kernels' interpret mode
// rounds an f32 intermediate before a bf16 product), kept in f32.
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// One element of an I/O stream, as f32.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// VEC consecutive elements of an I/O stream of type T, as f32: 16-byte
// loads for float4, 8-byte loads for four bf16 (the caller checks the
// alignment).
template <typename T, int VEC>
struct VecT;
template <int VEC>
struct VecT<float, VEC> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    Vec<VEC>::load(p, v);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    Vec<VEC>::store(p, v);
  }
};
template <>
struct VecT<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct VecT<bf16, 4> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  }
};

// dots[i, h] = <xh[i, h, :], att[0, h, :]>, dots[i, heads + h] = <xh[i, h,
// :], att[1, h, :]>; att is [2, HC] (att_src then att_dst, flattened),
// xh and att of type T, dots f32. One warp per node; the lanes stride
// over each head's C channels. The generic form of kernels C's and C''s
// dots (ell_gat_rows.cuh launch_node_dots runs node_dots_kernel, with the
// same bits, where a head has at most 64 channels).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dots_kernel(const T* __restrict__ xh, const T* __restrict__ att,
            float* __restrict__ dots, long long n, int heads, int c) {
  const int lane = threadIdx.x & (WARP - 1);
  const long long i =
      (long long)blockIdx.x * (blockDim.x / WARP) + threadIdx.x / WARP;
  if (i >= n) return;
  const int hc = heads * c;
  const T* row = xh + i * hc;
  for (int h = 0; h < heads; ++h) {
    float s = 0.f, d = 0.f;
    for (int j = lane; j < c; j += WARP) {
      const float v = ld(row + h * c + j);
      s = fmaf(v, ld(att + h * c + j), s);
      d = fmaf(v, ld(att + hc + h * c + j), d);
    }
    s = warp_sum(s);
    d = warp_sum(d);
    if (lane == 0) {
      dots[i * 2 * heads + h] = s;
      dots[i * 2 * heads + heads + h] = d;
    }
  }
}

// Attention-dropout multipliers of the post-softmax weights. Mode 0: none
// (1). Mode 1: a streamed f32 mask [N, K+1, heads] (the self loop at slot
// K). Mode 2: drawn here: Philox4x32-10 keyed by the layer's 64-bit seed,
// counter = (global index of (node, slot, head) in that same layout, ELL
// stream tag), kept when the first 32-bit word is >= thresh (= round(rate
// * 2^32)) and scaled by keep_inv. A weight's draw depends only on its
// indices, so kernel C' regenerates the forward's draw exactly.
constexpr uint32_t ELL_STREAM = 0x454C4C00u;  // "ELL": apart from the grid's

struct Drop {
  int mode;
  const float* mask;
  const unsigned long long* seed;
  uint32_t thresh;
  float keep_inv;

  __device__ __forceinline__ float mult(long long i, int slot, int h, int k,
                                        int heads) const {
    if (mode == 0) return 1.f;
    const unsigned long long idx =
        ((unsigned long long)i * (k + 1) + slot) * heads + h;
    if (mode == 1) return mask[idx];
    const unsigned long long s = *seed;
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)idx, (uint32_t)(idx >> 32), ELL_STREAM, 0u),
        make_uint2((uint32_t)s, (uint32_t)(s >> 32)));
    return r.x >= thresh ? keep_inv : 0.f;
  }
};

inline Drop make_drop(int mode, const void* mask, const void* seed,
                      unsigned thresh, float keep_inv) {
  Drop d;
  d.mode = mode;
  d.mask = static_cast<const float*>(mask);
  d.seed = static_cast<const unsigned long long*>(seed);
  d.thresh = thresh;
  d.keep_inv = keep_inv;
  return d;
}

}  // namespace ellgat
