"""Kernel B (``csrc/grid_gat_bwd.cu``: its attention pass and its products
pass) in grid training: the least time of its calls
(``h100.gat_train_bounds``' B) over the device time of both passes, in %.
Two launches a call."""

from portbench.roofline import h100, readers

PATTERNS = ("grid_gat_bwd_attn_kernel", "grid_gat_bwd_products_kernel")


def read(ctx):
    return readers.kernel_roofline(
        ctx, "grid_gat.train", PATTERNS, 2,
        lambda d: h100.gat_train_bounds(d)["B"][0])
