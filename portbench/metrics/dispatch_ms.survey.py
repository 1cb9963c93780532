"""Host ms a batch spends being stacked and handed to
``BathymetricPipeline.forward_tiles`` (upload and enqueue), by the host
clock around those calls."""

from portbench.roofline import readers


def read(ctx):
    return readers.span_mean_ms(ctx, ("stack", "forward_tiles"), "batches")
