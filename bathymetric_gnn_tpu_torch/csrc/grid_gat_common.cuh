// Device helpers shared by the grid-GAT kernels (grid_gat_fwd.cu,
// grid_gat_bwd.cu): type conversion, LeakyReLU, the neighbour offsets and
// the attention-dropout draw.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace gridgat {

constexpr int MAXK = 8;  // neighbour slots; the self loop is slot K

// offsets (dr, dc) in the order of ops/edges.py: OFFSETS_8, OFFSETS_4
__constant__ int c_off[2][MAXK][2] = {
    {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}},
    {{-1, 0}, {1, 0}, {0, -1}, {0, 1}, {0, 0}, {0, 0}, {0, 0}, {0, 0}},
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive outputs (dst 16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// four consecutive inputs as f32 (src 16-byte aligned for float, 8 for
// bf16)
__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// Attention-dropout multipliers of one softmax. Mode 0: none (1). Mode 1:
// a streamed f32 mask [B, K+1, heads, H, W] (self loop at slot K). Mode 2:
// drawn here: Philox keyed by the layer's 64-bit seed, counter = the
// global index of (b, slot, head, row, col) in that same layout, kept when
// the first 32-bit word is >= thresh (= round(rate * 2^32)), scaled by
// keep_inv. A cell's draw depends only on its indices, so the backward
// regenerates it for any cell, halo cells included.
struct Drop {
  int mode;
  const float* mask;
  const unsigned long long* seed;
  uint32_t thresh;
  float keep_inv;

  __device__ __forceinline__ float mult(int b, int slot, int h, int gy,
                                        int gx, int K, int heads, int H,
                                        int W) const {
    if (mode == 0) return 1.f;
    const size_t idx =
        ((((size_t)b * (K + 1) + slot) * heads + h) * H + gy) * (size_t)W + gx;
    if (mode == 1) return mask[idx];
    const unsigned long long s = *seed;
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)idx, (uint32_t)((unsigned long long)idx >> 32),
                   0u, 0u),
        make_uint2((uint32_t)s, (uint32_t)(s >> 32)));
    return r.x >= thresh ? keep_inv : 0.f;
  }
};

}  // namespace gridgat
