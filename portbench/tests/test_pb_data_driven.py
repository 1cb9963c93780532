"""A configuration, a traffic mix, a driver and a per-layer metric added
as new files with new entries are found by name; nothing that is there
is edited."""

import json
import shutil

from portbench import harness


def test_dummy_entries_are_found(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "model": {}}))
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"driver": "dummy_driver", "n": 3}))
    (base / "drivers" / "dummy_driver.py").write_text(
        "def setup(cell, seed, device, spans, overrides=None):\n"
        "    return cell.traffic['n']\n")
    (base / "metrics" / "dummy_share.dummy.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    bench["per_layer"].append({"name": "dummy_share.dummy", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "dummy_per_s",
                               "workloads": ["dummy-cell"]})
    cell = harness.Cell("dummy-cell", bench, base=base)
    assert cell.config["name"] == "dummy"
    assert cell.driver().setup(cell, 1, "cpu", None) == 3
    assert {m["name"] for m in cell.end_to_end} == {"dummy_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["dummy_share.dummy"]
    assert cell.metric_reader("dummy_share.dummy").read({}) == 42.0
    # the cells that were there are untouched and do not see the new metric
    old = harness.Cell("survey-f32", bench, base=base)
    assert "dummy_share.dummy" not in {m["name"] for m in old.per_layer}
    after = {p: p.read_bytes() for p in before}
    assert after == before
