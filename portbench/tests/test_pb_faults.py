"""Runs with the timed path broken underneath: ``correct`` comes out
false (the chip's look skipped, tiny sizes on the CPU)."""

import io
import json

import pytest

from portbench import faults, run
from portbench.tests.cpu_cells import TINY

CASES = [("survey-f32", "altered"), ("grid-train-f32", "unchanged"),
         ("grid-train-f32", "half_batch"), ("coo-train-f32", "unchanged"),
         ("coo-train-f32", "half_batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    out = io.StringIO()
    args = run.parse_args(["--workload", cell, "--seed", "977",
                           "--seconds", "1", "--trace", "0"])
    with faults.planted(fault):
        run.run(args, device="cpu", overrides=TINY[cell], out=out)
    # the run's own limits are the tiny sizes' (``cpu_cells``)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
