"""The harness is driven by data: a configuration, a cell and a per-layer
metric added as files alone are found and run; BENCHMARK.json names only
files that exist and keeps to the contract's forms."""

from __future__ import annotations

import json
import re

from conftest import BENCH, REPO, drive

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_files_that_exist():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["kpbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and (BENCH / "drivers" / f"{wl['kind']}.py").is_file()
        assert w["chips"] == 1
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:  # setup_s, one other end-to-end metric and one per-layer metric
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_cells_kept_for_later_are_listed_in_their_files():
    """A workload file that BENCHMARK.json does not list carries the listing
    a later PR moves there: its chips and its metrics in BENCHMARK.json's
    form, each per-layer one with a reader and moving one of its own."""
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in b["workloads"]}
    later = [p for p in (BENCH / "workloads").glob("*.json") if p.stem not in listed]
    assert later, "PERF.md keeps cells for later"
    for path in later:
        wl = json.loads(path.read_text())
        assert (BENCH / "configs" / f"{wl['config']}.json").is_file()
        own = wl["benchmark"]
        assert set(own) == {"chips", "end_to_end", "per_layer"} and own["chips"] in (1, 4)
        e2e = {m["name"] for m in own["end_to_end"]}
        for m in own["end_to_end"] + own["per_layer"]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher") and "workloads" not in m
        for m in own["per_layer"]:
            assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_config_cell_and_metric_added_as_files(smoke):
    """A dummy configuration (another width of the offline path), a dummy
    cell on it and a dummy per-layer metric, each a new file and a new
    entry, and no edit of any file the benchmark had."""
    cfg = json.loads((smoke / "configs" / "penn-final.json").read_text())
    cfg["model"]["translator_filters"] = 8
    (smoke / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    wl = json.loads((smoke / "workloads" / "penn-final.offline-b32.json").read_text())
    wl.update(config="dummy-cfg", batch=2)
    (smoke / "workloads" / "dummy-cfg.offline-b2.json").write_text(json.dumps(wl))
    (smoke / "metrics" / "dummy_calls.offline.py").write_text(
        "def read(rec):\n    return rec.get('calls')\n")
    b = json.loads((smoke.parent / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="dummy-cfg",
                             file="kpbench/configs/dummy-cfg.json"))
    b["workloads"].append({"name": "dummy-cfg.offline-b2", "config": "dummy-cfg",
                           "traffic": "offline-b2", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dummy-cfg.offline-b2")
    b["per_layer"].append({"name": "dummy_calls.offline", "unit": "calls", "better": "higher",
                           "source": "device_trace", "layer": "generate", "moves": "frames_per_s",
                           "workloads": ["dummy-cfg.offline-b2"]})
    (smoke.parent / "BENCHMARK.json").write_text(json.dumps(b))
    result, cell = drive(smoke, "dummy-cfg.offline-b2", seconds=0.5)
    assert cell.model["translator_filters"] == 8 and result["correct"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    result, _ = drive(smoke, "dummy-cfg.offline-b2", seconds=0.5, trace=True)
    assert result["metrics"]["dummy_calls.offline"]["value"] == wl["trace_calls"]
