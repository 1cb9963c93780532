// Warp-level tensor-core products shared by the grid-GAT kernels
// (grid_gat_fwd.cu, grid_gat_bwd.cu), and the cp.async staging helpers
// that feed them.
//
// One routine, `mma_chunk`, adds to a warp's f32 accumulators the product
// of an MT x 16-row block of A and an NT x 8-column block of B over one
// staged K chunk in shared memory, with mma.sync (sm_80+ warp MMAs; wgmma
// and warp specialisation are later work):
//  * bf16 operands: mma.m16n8k16 with f32 accumulation, the product the
//    Pallas kernel's bf16 dots take on the MXU (preferred f32);
//  * f32 operands: 3xTF32 on mma.m16n8k8. Each operand v is split into
//    hi = rna_tf32(v) and lo = rna_tf32(v - hi); the routine accumulates
//    lo*hi + hi*lo + hi*hi in f32. One TF32 pass keeps ~11 bits and misses
//    the f32 tolerance the kernels are held to (1e-4 of 1 + |ref| over a
//    256-deep sum, tests/test_torch_grid_mma_precision.py); the split keeps
//    ~21 bits a term, as close to the float64 product as f32 FMAs.
// Element (m, k) of A lies at sa[m * a_ms + k * a_ks] and element (k, n) of
// B at sb[k * b_ks + n * b_ns]; a stride of 1 along K (A_KC / B_KC) lets a
// bf16 pair load as one 32-bit word. Fragment layouts are PTX's for
// mma.m16n8k8.tf32 and mma.m16n8k16.bf16 (row.col): lane = 4 g + t.
// `prep_b` + `mma_chunk_pre` are the form for a B chunk that every warp of
// a block multiplies (x @ W): B is split (or transposed) once per block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gridmma {

// the element type prep_b writes: TF32 words for f32, bf16 for bf16
template <typename T>
struct Prep {
  using type = T;
  static constexpr int WORDS = 1;   // arrays: the values
};
template <>
struct Prep<float> {
  using type = uint32_t;
  static constexpr int WORDS = 2;   // arrays: hi and lo
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// (not volatile: the compiler may interleave independent MMAs)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 at p and p + stride as one register (the lower k in the low half)
template <bool CONTIG>
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p, int stride) {
  if (CONTIG) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return lo | (hi << 16);
}

// acc[i][j] += A[m0 + 16 i .., k0 .. k0 + KC) x B[k0 .., n0 + 8 j ..) for
// i < MT, j < NT (tiles j >= nt_live are skipped); KC a multiple of the
// MMA depth. sa / sb point at element (m0, k0) / (k0, n0).
template <int MT, int NT, int KC, bool A_KC, bool B_KC>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const float* sa, int a_ld,
                                          const float* sb, int b_ld,
                                          int nt_live) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a_ms = A_KC ? a_ld : 1, a_ks = A_KC ? 1 : a_ld;
  const int b_ks = B_KC ? 1 : b_ld, b_ns = B_KC ? b_ld : 1;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = sa + (16 * i) * a_ms + kk * a_ks;
      split(p[g * a_ms + t * a_ks], ah[i][0], al[i][0]);
      split(p[(g + 8) * a_ms + t * a_ks], ah[i][1], al[i][1]);
      split(p[g * a_ms + (t + 4) * a_ks], ah[i][2], al[i][2]);
      split(p[(g + 8) * a_ms + (t + 4) * a_ks], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) break;
      const float* q = sb + kk * b_ks + (8 * j + g) * b_ns;
      uint32_t bh[2], bl[2];
      split(q[t * b_ks], bh[0], bl[0]);
      split(q[(t + 4) * b_ks], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_tf32(acc[i][j], al[i], bh);
        mma_tf32(acc[i][j], ah[i], bl);
        mma_tf32(acc[i][j], ah[i], bh);
      }
    }
  }
}

template <int MT, int NT, int KC, bool A_KC, bool B_KC>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const __nv_bfloat16* sa, int a_ld,
                                          const __nv_bfloat16* sb, int b_ld,
                                          int nt_live) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a_ms = A_KC ? a_ld : 1, a_ks = A_KC ? 1 : a_ld;
  const int b_ks = B_KC ? 1 : b_ld, b_ns = B_KC ? b_ld : 1;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const __nv_bfloat16* p = sa + (16 * i) * a_ms + kk * a_ks;
      a[i][0] = pair<A_KC>(p + g * a_ms + (2 * t) * a_ks, a_ks);
      a[i][1] = pair<A_KC>(p + (g + 8) * a_ms + (2 * t) * a_ks, a_ks);
      a[i][2] = pair<A_KC>(p + g * a_ms + (2 * t + 8) * a_ks, a_ks);
      a[i][3] = pair<A_KC>(p + (g + 8) * a_ms + (2 * t + 8) * a_ks, a_ks);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) break;
      const __nv_bfloat16* q = sb + kk * b_ks + (8 * j + g) * b_ns;
      uint32_t b[2];
      b[0] = pair<B_KC>(q + (2 * t) * b_ks, b_ks);
      b[1] = pair<B_KC>(q + (2 * t + 8) * b_ks, b_ks);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b);
    }
  }
}

// ---- B staged once per block, then shared by every warp ------------------
//
// When all warps multiply their rows by the same [K, N] chunk of B (x @ W
// in kernels A and B), splitting B's f32 values (or gathering its bf16
// pairs) in each warp repeats that work once per warp. prep_b does it once
// per staged chunk: element (k, n) of B at sb[k * b_ld + n] goes to
// bp[n * PS + k] (f32: the TF32 hi word, and the lo word at bp_lo; bf16:
// the value), K-major, so a fragment pair is one 32-bit load.
template <int KC, int NCOLS, int NTHR>
__device__ __forceinline__ void prep_b(const float* sb, int b_ld,
                                       uint32_t* bp, uint32_t* bp_lo,
                                       int ps) {
  for (int i = threadIdx.x; i < KC * NCOLS; i += NTHR) {
    const int n = i / KC, k = i % KC;
    uint32_t hi, lo;
    split(sb[k * b_ld + n], hi, lo);
    bp[n * ps + k] = hi;
    bp_lo[n * ps + k] = lo;
  }
}
template <int KC, int NCOLS, int NTHR>
__device__ __forceinline__ void prep_b(const __nv_bfloat16* sb, int b_ld,
                                       __nv_bfloat16* bp, __nv_bfloat16*,
                                       int ps) {
  for (int i = threadIdx.x; i < KC * NCOLS; i += NTHR) {
    const int n = i / KC, k = i % KC;
    bp[n * ps + k] = sb[k * b_ld + n];
  }
}

// mma_chunk with B from prep_b (f32: hi and lo words; A split here)
template <int MT, int NT, int KC>
__device__ __forceinline__ void mma_chunk_pre(float (&acc)[MT][NT][4],
                                              const float* sa, int a_ld,
                                              const uint32_t* bh,
                                              const uint32_t* bl, int ps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = sa + (16 * i) * a_ld + kk;
      split(p[g * a_ld + t], ah[i][0], al[i][0]);
      split(p[(g + 8) * a_ld + t], ah[i][1], al[i][1]);
      split(p[g * a_ld + t + 4], ah[i][2], al[i][2]);
      split(p[(g + 8) * a_ld + t + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int q = (8 * j + g) * ps + kk + t;
      const uint32_t bhj[2] = {bh[q], bh[q + 4]};
      const uint32_t blj[2] = {bl[q], bl[q + 4]};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_tf32(acc[i][j], al[i], bhj);
        mma_tf32(acc[i][j], ah[i], blj);
        mma_tf32(acc[i][j], ah[i], bhj);
      }
    }
  }
}
template <int MT, int NT, int KC>
__device__ __forceinline__ void mma_chunk_pre(float (&acc)[MT][NT][4],
                                              const __nv_bfloat16* sa,
                                              int a_ld,
                                              const __nv_bfloat16* bp,
                                              const __nv_bfloat16*, int ps) {
  mma_chunk<MT, NT, KC, true, true>(acc, sa, a_ld, bp, ps, NT);
}

// Accumulator element e (0..3) of an m16n8 tile: row g + 8 (e / 2), column
// 2 t + e % 2, lane = 4 g + t.
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

// ---- staging ---------------------------------------------------------------

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read, but must be a mapped address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Stage VEC = 16 / sizeof(T) consecutive elements src[0 .. VEC) (of which
// the first `live` exist) at dst: one cp.async when all are live and the
// source is 16-byte aligned, else element by element (zeros past `live`).
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int live,
                                          const void* any) {
  constexpr int VEC = 16 / sizeof(T);
  if (live >= VEC && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp16(dst, src, true);
  } else if (live <= 0) {
    cp16(dst, any, false);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v] = v < live ? src[v] : zero<T>();
  }
}

}  // namespace gridmma
