"""BENCHMARK.json against the contract's rules, and the last line a run
prints."""

import io
import json
import os
import re

import pytest

from portbench import harness, run
from portbench.tests.cpu_cells import TINY

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]
                                                 + BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_every_name_finds_its_files():
    used = set()
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"], BENCH)
        used.add(w["config"])
        assert cell.driver().setup
        ends = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in ends and len(ends) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert cell.metric_reader(m["name"]).read
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))


def test_per_layer_layers_and_moves():
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_last_line(cell):
    """A run on the CPU at a tiny size (the chip's look skipped) prints
    the result line the contract asks for, the checks last."""
    out = io.StringIO()
    args = run.parse_args(["--workload", cell, "--seed", str(2 ** 33 + 5),
                           "--seconds", "1", "--trace", "0"])
    run.run(args, device="cpu", overrides=TINY[cell], out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = harness.Cell(cell, BENCH)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the run exits non-zero and prints no result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "survey-f32", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
