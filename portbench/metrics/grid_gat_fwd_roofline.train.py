"""Kernel A (``csrc/grid_gat_fwd.cu``, training form, dropout drawn in the
kernel) in grid training: the least time of its calls
(``h100.gat_train_bounds``' A) over its device time, in %. One launch a
call."""

from portbench.roofline import h100, readers

PATTERNS = ("grid_gat_fwd_kernel",)


def read(ctx):
    return readers.kernel_roofline(
        ctx, "grid_gat.train", PATTERNS, 1,
        lambda d: h100.gat_train_bounds(d)["A"][0])
