// Device helpers shared by the banded-ELL GAT kernels (ell_gat_band.cu,
// kernel E; ell_gat_v2_fwd.cu, kernel D; ell_gat_v2_bwd.cu, kernel D'):
// the window source of an in-band slot, and D''s in-band softmax of one
// destination row one head at a time (E and D take the forward layout of
// ell_gat_rows.cuh, which also holds the attention dots).
//
// Layouts (ops/ell_banded.py band_ell): loc [K, N] int32 local window
// index (slot-major), el [K * heads, N] f32 raw edge logits (row k * heads
// + h), el_self [heads, N] f32; nodes in bands of R rows, band t = i / R.
// xh, acat and the spill rows are float or bf16 (the I/O type T of each
// kernel); everything computed from them is f32.
#pragma once

#include "ell_gat_common.cuh"

namespace band {

using ellgat::bf16;
using ellgat::FULL;
using ellgat::ld;
using ellgat::round_bf;
using ellgat::THREADS;
using ellgat::WARP;
using ellgat::leaky;
using ellgat::warp_max;
using ellgat::warp_sum;

constexpr int MAX_HEADS = 8;
constexpr float NEG_BIG = -1e30f;

// The global source of an in-band slot of destination i: chunk (i / R +
// loc / R - 1), row loc % R; -1 for a dead or spilled slot (loc outside
// [0, 3R)) and for a window chunk outside the graph (the TPU kernel
// clamps its window there; band_ell never emits such a slot).
__device__ __forceinline__ long long window_source(int loc, long long i,
                                                   int r, long long bands) {
  if (loc < 0 || loc >= 3 * r) return -1;
  const long long chunk = i / r + loc / r - 1;
  if (chunk < 0 || chunk >= bands) return -1;
  return chunk * r + loc % r;
}

// The K window sources of destination i into src_s (lanes own slots).
__device__ __forceinline__ void load_sources(const int* __restrict__ loc,
                                             long long i, long long n, int k,
                                             int r, int lane,
                                             long long* src_s) {
  const long long bands = n / r;
  for (int s = lane; s < k; s += WARP)
    src_s[s] = window_source(loc[(long long)s * n + i], i, r, bands);
  __syncwarp();
}

// The in-band softmax of destination i, head h, as kernel D' recomputes
// it for head counts that do not divide 32 (all lanes of the warp; lanes
// own slots). Logits l_s = LeakyReLU(g_s + a_dst + el) with g_s = a_src
// of the slot's source; a slot with no window source counts with g_s = 0,
// as the TPU kernel's one-hot gather gives, and its el must already carry
// NEG_BIG (band_ell's negmask_t). The self logit from a_src[i] + a_dst +
// el_self when has_self. Writes each slot's exp(l - m) to e_s
// [s * heads + h] and, when lf_s is given, its LeakyReLU slope (1 or
// `slope`). Returns the max m (floored at -1e4 without a self loop) and
// sets *den (sum of the exponentials and the self term, >= 1e-16),
// *e_self and *pre_self.
__device__ __forceinline__ float row_softmax(
    const float* __restrict__ ac, const float* __restrict__ el,
    const float* __restrict__ el_self, const long long* src_s, long long i,
    long long n, int k, int heads, int h, float slope, int lane,
    float* e_s, float* lf_s, float* den, float* e_self, float* pre_self) {
  const int h2 = 2 * heads;
  const float a_dst = ac[i * h2 + heads + h];
  const bool has_self = el_self != nullptr;
  const float ps = ac[i * h2 + h] + a_dst +
                   (has_self ? el_self[(long long)h * n + i] : 0.f);
  const float self_l = leaky(ps, slope);
  float m = has_self ? self_l : -1e4f;
  for (int s = lane; s < k; s += WARP) {
    const long long j = src_s[s];
    const float pre = (j >= 0 ? ac[j * h2 + h] : 0.f) + a_dst +
                      el[((long long)s * heads + h) * n + i];
    const float l = leaky(pre, slope);
    if (lf_s != nullptr) lf_s[s * heads + h] = pre >= 0.f ? 1.f : slope;
    m = fmaxf(m, l);
    e_s[s * heads + h] = l;
  }
  m = warp_max(m);
  float d = 0.f;
  for (int s = lane; s < k; s += WARP) {
    const float e = expf(e_s[s * heads + h] - m);
    e_s[s * heads + h] = e;
    d += e;
  }
  d = warp_sum(d);
  const float es = has_self ? expf(self_l - m) : 0.f;
  *den = fmaxf(d + es, 1e-16f);
  *e_self = es;
  *pre_self = ps;
  return m;
}

}  // namespace band
