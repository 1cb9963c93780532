"""Kernel A (``csrc/grid_gat_fwd.cu``, inference form) at the survey's
calls: the least time of its calls (``h100.gat_infer_bound``) over its
device time, in %. One launch a call."""

from portbench.roofline import h100, readers

PATTERNS = ("grid_gat_fwd_kernel",)


def read(ctx):
    return readers.kernel_roofline(
        ctx, "grid_gat_fwd.infer", PATTERNS, 1,
        lambda d: h100.gat_infer_bound(d)[0])
