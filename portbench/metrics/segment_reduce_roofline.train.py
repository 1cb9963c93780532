"""Kernel F mode (a) (``csrc/segment_reduce.cu``: the COO path's segment
sums and gather backwards) in COO training: the least time of its calls
(``h100.coo_f_bound`` of each call's live rows, segments and width) over
its device time, in %. One launch a call."""

from portbench.roofline import h100, readers

PATTERNS = ("sum_rows_kernel",)


def read(ctx):
    return readers.kernel_roofline(
        ctx, "segment_reduce.sorted", PATTERNS, 1,
        lambda d: h100.coo_f_bound(d["live"], d["n"], d["f"])[0])
