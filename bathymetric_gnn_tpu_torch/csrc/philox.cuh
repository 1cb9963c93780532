// Counter-based Philox4x32-10 (Salmon et al., SC'11; the generator of
// Random123 and curand), written out so that no header beyond the CUDA
// runtime is needed. Shared by the attention-dropout draws of the grid-GAT
// kernels (grid_gat_common.cuh) and the ELL-GAT kernels
// (ell_gat_common.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
