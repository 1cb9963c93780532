"""Host ms a batch spends in the program's ``pipeline.upload`` span (the
three host->device copies of ``BathymetricPipeline.forward_tiles``), the
mean over the window's ``pipeline.forward_tiles`` spans."""

from portbench import program_spans as ps


def read(ctx):
    al = ps.aligned(ctx, *ps.SURVEY)
    return None if al is None else al.mean_ms("pipeline.upload")
