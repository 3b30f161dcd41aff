"""BENCHMARK.json against the contract's rules of form, and every file a cell
names found by its name."""

import json
import os
import re

import pytest
from conftest import REPO, with_later

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def later():
    with open(os.path.join(REPO, "perfbench", "later.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(s["paths"]) <= 16 and all(PATH.match(p) for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32 and all(line(w) for w in s["command"])
    assert all(not w.startswith("/") and ".." not in w for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51


def test_full_check_fits_its_time_at_24_cells():
    s = spec()
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("with_kept_cells", [False, True])
def test_names_units_and_entry_keys(with_kept_cells):
    s = with_later(spec(), later()) if with_kept_cells else spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in s[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("with_kept_cells", [False, True])
def test_cells_metrics_and_chips(with_kept_cells):
    s = with_later(spec(), later()) if with_kept_cells else spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        reported = [m["name"] for m in s["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in s["per_layer"] if w in m.get("workloads", ())]
        assert layer
        assert all(m["moves"] in reported for m in layer)
    four = sum(w["chips"] == 4 for w in s["workloads"])
    assert four <= max(1, len(s["workloads"]) // 4)
    used = {w["config"] for w in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}
    for m in s["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"] + later()["workloads"]])
def test_every_file_a_cell_names_is_found(workload, tmp_path):
    from perfbench.spec import Cell

    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(with_later(spec(), later()), f)
    os.symlink(os.path.join(REPO, "perfbench"), tmp_path / "perfbench")
    cell = Cell(str(tmp_path), workload)
    config_file = [c["file"] for c in cell.spec["configs"] if c["name"] == cell.workload["config"]]
    assert config_file[0].startswith("perfbench/configs/")
    assert cell.config["name"] == cell.workload["config"]
    for kind, name in (("entries", cell.traffic["entry"]), ("programs", cell.config["program"]),
                       ("reference", cell.config["program"])):
        assert cell.module(kind, name) is not None
    assert cell.module("entries", cell.traffic["entry"]).Entry
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)
    assert float(cell.config["check"]["max_rel_err"]) > 0
