"""Share of the traced training window, in %, with nothing running on the
card while the host was in the program's span ``train.forward``: the
loss function (the inputs to the card, featurization on the grid path,
the model's forward, the losses). Each idle gap goes to the deepest
program span on the step's thread covering most of it
(``program_spans.gap_paths``); this sums the gaps that went to
``train.forward`` or to a span inside it."""

from portbench import program_spans as ps


def read(ctx):
    return ps.idle_share(ctx, "train.forward")
