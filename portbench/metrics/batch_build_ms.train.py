"""Host ms a training batch takes to build in the trainer's prefetch
thread, by the program's spans: ``train.collate`` (the grid trainer's
tiles read and stacked) or ``train.merge`` + ``train.from_padded`` (the
graph trainer's ``merge_stacked`` and ``CooGraph.from_padded``); the mean
over the builds that start and end in the window."""

from portbench import program_spans as ps


def read(ctx):
    return ps.batch_build_ms(ctx)
