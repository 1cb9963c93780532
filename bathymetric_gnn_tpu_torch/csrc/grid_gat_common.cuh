// Device helpers shared by the grid-GAT kernels (grid_gat_fwd.cu,
// grid_gat_bwd.cu): type conversion, LeakyReLU, the neighbour offsets and
// the attention-dropout draw.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// Counter-based Philox4x32-10 (Salmon et al., SC'11; the generator of
// Random123 and curand), written out so that no header beyond the CUDA
// runtime is needed.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
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
