"""Published peaks of one NVIDIA H100 SXM and the least time of a kernel
call, computed from its shapes.

A frozen copy of the yardstick ``chip_smoke.py`` kept beside the port
(``PEAK_BYTES``, ``PEAK_FLOPS``, ``MMA_FLOPS``, ``split_bound``, ``bound``,
``train_bounds``, ``coo_f_bound``): each input is read once and each
output written once over HBM bandwidth, against the operations at the
rate of the unit that runs them. Later changes to the program cannot move
it.
"""

from __future__ import annotations

# NVIDIA's data sheet, SXM part, dense rates, at the 700 W limit.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# The fastest f32-accurate product the card has: 3xTF32 (three TF32
# tensor-core MMAs a product, 495 / 3 TFLOP/s); bf16 on bf16 MMAs.
MMA_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}


def split_bound(nbytes, mma_flops, other_flops, dtype):
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM
    bandwidth and the operations' time, products at ``MMA_FLOPS[dtype]``
    and the other operations at the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (mma_flops / MMA_FLOPS[dtype]
             + other_flops / PEAK_FLOPS["float32"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _itemsize(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def gat_infer_bound(d):
    """Kernel A, inference form, one call over ``d`` = {b, h, w, f, hc,
    heads, k, dtype}: x, W, W@a, the edge logit terms and the output moved
    once, the valid mask and the epilogue's vectors; x@W and the attention
    dots at the MMA rate, the (k + 1)-way weighted sum at the FP32 rate.
    Returns (ms, bound by, bytes, flops)."""
    n = d["b"] * d["h"] * d["w"]
    f, hc, heads, k = d["f"], d["hc"], d["heads"], d["k"]
    s = _itemsize(d["dtype"])
    nbytes = (s * (n * f + f * hc + f * 2 * heads + (k + 1) * heads * n
                   + n * hc) + 4 * n + 12 * hc)
    mma = 2 * n * f * hc + 2 * n * f * 2 * heads
    other = 2 * (k + 1) * n * hc
    ms, by = split_bound(nbytes, mma, other, d["dtype"])
    return ms, by, nbytes, mma + other


def gat_train_bounds(d):
    """Kernel A's training form (``"A"``) and kernel B (``"B"``) for one
    call over ``d`` = {b, h, w, f, hc, heads, k, ed, dtype}. A: as
    ``gat_infer_bound`` without the epilogue (dropout drawn in the kernel:
    no mask bytes). B: x, W, W@a, the edge logit terms, g and the edge
    attributes read once, dx and the summed dW, d(W@a), dM_edge and dbias
    written once; products: the xh and attention-dot recompute, dx, dW and
    d(W@a); other operations: the (k + 1)-way dxh and d(weights) sums.
    Each entry is (ms, bound by, bytes, flops)."""
    n = d["b"] * d["h"] * d["w"]
    f, hc, heads, k, ed = d["f"], d["hc"], d["heads"], d["k"], d["ed"]
    s = _itemsize(d["dtype"])
    a2 = 2 * heads
    a_bytes = (s * (n * f + f * hc + f * a2 + (k + 1) * heads * n + n * hc)
               + 4 * n + 4 * hc)
    a_mma, a_other = 2 * n * f * hc + 2 * n * f * a2, 2 * (k + 1) * n * hc
    b_bytes = (s * (2 * n * f + f * hc + f * a2 + (k + 1) * heads * n
                    + n * hc + (k + 1) * n * ed)
               + 4 * n + 4 * (f * hc + f * a2 + ed * heads + hc))
    b_mma, b_other = 3 * 2 * n * f * (hc + a2), 4 * (k + 1) * n * hc
    out = {}
    for name, nbytes, mma, other in (("A", a_bytes, a_mma, a_other),
                                     ("B", b_bytes, b_mma, b_other)):
        ms, by = split_bound(nbytes, mma, other, d["dtype"])
        out[name] = (ms, by, nbytes, mma + other)
    return out


def coo_f_bound(live, n, f):
    """Kernel F mode (a), one call: each live row of the [S, f] f32 input,
    its perm entry, row_ptr and the [n, f] output moved once over HBM
    bandwidth, against one add per element read at the FP32 peak.
    Returns (ms, bound by, bytes)."""
    nbytes = 4 * (live * f + live + n + 1 + n * f)
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = live * f / PEAK_FLOPS["float32"] * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes
