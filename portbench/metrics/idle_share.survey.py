"""Share of the traced survey window with nothing running on the card."""

from portbench.roofline import readers


def read(ctx):
    return readers.idle_share(ctx)
