"""Share of the traced training window, in %, with nothing running on the
card while the host was in the program's span ``train.optimizer``:
gradient clipping and AdamW. Each idle gap goes to the deepest program
span on the step's thread covering most of it
(``program_spans.gap_paths``); this sums the gaps that went to
``train.optimizer`` or to a span inside it."""

from portbench import program_spans as ps


def read(ctx):
    return ps.idle_share(ctx, "train.optimizer")
