"""The control on the card: the reference in TF32 put in the program's
place fails a limit the program meets. At a size a test run holds; the
cell's own size is read with ``control.py``. Run on the card with
``python -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import compare, control, harness
from portbench.tests.test_pb_contract import BENCH

SMALL = {"survey-f32": {"survey": [2048, 2048]},
         "grid-train-f32": {"tiles_per_side": 2, "warm_steps": 1},
         "coo-train-f32": {"tiles_per_side": [2, 4], "warm_steps": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: TF32 exists only there")
    c = harness.Cell(cell, BENCH)
    r = control.readings(c, 20261018, 2.0, overrides=SMALL[cell])
    limits = c.traffic["limits"]
    prog = [(k, v, limits[k]) for k, v in r["program"].items()]
    ctrl = [(k, v, limits[k]) for k, v in r["control"].items()]
    assert compare.passed(prog)
    assert not compare.passed(ctrl)
