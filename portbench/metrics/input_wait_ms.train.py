"""Host ms a step in which the trainer's loop waited on its prefetch
iterator for the next batch."""

from portbench.roofline import readers


def read(ctx):
    return readers.span_mean_ms(ctx, ("next_batch",), "steps")
