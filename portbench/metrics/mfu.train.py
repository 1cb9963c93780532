"""Training's model operations, forward and backward
(``roofline/model_flops``), over the traced window at the card's fastest
f32-accurate rate, in %."""

from portbench.roofline import readers


def read(ctx):
    return readers.model_flops_share(ctx)
