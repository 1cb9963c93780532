"""Stream ms a batch of the MLP extractor and the four GAT layers (kernel A
and its edge terms; ``GridBathymetricGNN.trunk``): the program's span
``model.layers`` records a CUDA event on the current stream before its
first launch and after its last, and this is the mean over the window's
batches of the time between the two. It is stream time, not kernel time:
any idle of the card between the stage's launches counts in it."""

from portbench import program_spans as ps


def read(ctx):
    al = ps.aligned(ctx, *ps.SURVEY)
    return None if al is None else al.mean_device_ms("model.layers")
