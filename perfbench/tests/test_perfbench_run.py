"""A run's last line, its no-card and no-program exits, the modules it loads,
and a cell added by files and entries alone: rehearsed on the CPU (the
harness's run with CPU devices, the port's plain version in its kernels'
place), the card's own exits on the card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import REPO, copy_benchmark, shrink

from perfbench.harness import run_cell
from perfbench.spec import Cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def cpu_run(root, workload, traced=False, seconds=0.5, seed=2**31 + 5):
    cell = Cell(root, workload)
    return cell, run_cell(cell, seed, seconds, traced, ["cpu"] * cell.chips, time.perf_counter())


@pytest.mark.parametrize("workload", ["hdiff-chain", "vadv-chain", "hdiff-calls",
                                      "hdiff-2x2-apply"])
def test_last_line_keys(small_root, workload):
    cell, result = cpu_run(small_root, workload)
    assert list(result) == KEYS
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["device"]["count"] == cell.chips
    # the comparison holds on the plain version; the kernel guard does not on the CPU
    assert result["checks"]["max_rel_err"]["value"] <= result["checks"]["max_rel_err"]["limit"]
    assert result["checks"]["kernel_launches_per_step"]["value"] == 0
    assert result["correct"] is False
    json.dumps(result)


def test_traced_line_has_breakdown_and_the_cells_per_layer_metrics(small_root):
    cell, result = cpu_run(small_root, "hdiff-calls", traced=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    wanted = {m["name"] for m in cell.per_layer}
    # on the CPU no device operation is traced: the rooflines read nothing
    assert set(result["metrics"]) == wanted - {"hdiff_roofline", "vadv_roofline"}


def test_run_loads_no_jax_module(small_root):
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "from perfbench.spec import Cell; from perfbench.harness import run_cell\n"
        "from perfbench.run import forbidden_modules\n"
        "for w in ('hdiff-chain', 'vadv-chain', 'hdiff-calls', 'hdiff-2x2-apply'):\n"
        "    c = Cell(%r, w); run_cell(c, 9, 0.2, w == 'hdiff-calls', ['cpu'] * c.chips, 0.0)\n"
        "print(forbidden_modules())\n" % (small_root, REPO, small_root)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=small_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    sys.modules["gt4py_tpu_torch_probe_name"] = sys  # a name the JAX package's begins
    try:
        assert "gt4py_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["gt4py_tpu_torch_probe_name"]


def test_without_a_card_it_exits_nonzero_and_prints_nothing(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hdiff-chain", "--seed",
         str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_config_traffic_and_metric_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as files
    and entries of a copy, run without an edit to any harness file."""
    root = copy_benchmark(str(tmp_path))
    shrink(root)
    before = {p: open(os.path.join(root, "perfbench", p)).read()
              for p in ("harness.py", "spec.py", "check.py", "trace.py", "run.py")}
    configs = os.path.join(root, "perfbench", "configs")
    config = json.load(open(os.path.join(configs, "cosmo_hdiff_256x256x80_f32.json")))
    config["name"] = "cosmo_hdiff_small_f64"
    config["dtype"], config["literal_precision"] = "float64", 64
    json.dump(config, open(os.path.join(configs, "cosmo_hdiff_small_f64.json"), "w"))
    json.dump({"entry": "chain", "steps_per_call": 3, "warmup_calls": 2, "checked_calls": 3,
               "traced_calls": 4, "calls_per_s_max": 100},
              open(os.path.join(root, "perfbench", "traffic", "chain3.json"), "w"))
    with open(os.path.join(root, "perfbench", "metrics", "steps_per_call.py"), "w") as f:
        f.write("def read(run):\n    return run.steps / run.calls if run.calls else None\n")
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["configs"].append({"name": "cosmo_hdiff_small_f64", "source": "https://example.org/x",
                            "file": "perfbench/configs/cosmo_hdiff_small_f64.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "hdiff-f64-chain3", "config": "cosmo_hdiff_small_f64",
                              "traffic": "chain3", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("hdiff-f64-chain3")
    spec["end_to_end"][1]["workloads"].append("hdiff-f64-chain3")
    spec["per_layer"].append({"name": "steps_per_call", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "runtime and backend wrapper",
                              "moves": "step_us", "workloads": ["hdiff-f64-chain3"]})
    json.dump(spec, open(path, "w"))
    _, plain = cpu_run(root, "hdiff-f64-chain3")
    assert set(plain["metrics"]) == {"step_us", "call_p95_us", "setup_s"}
    assert plain["checks"]["max_rel_err"]["value"] <= plain["checks"]["max_rel_err"]["limit"]
    _, traced = cpu_run(root, "hdiff-f64-chain3", traced=True)
    assert traced["metrics"]["steps_per_call"]["value"] == 3
    after = {p: open(os.path.join(root, "perfbench", p)).read() for p in before}
    assert after == before


def test_in_a_directory_of_the_benchmark_alone_it_exits_nonzero(tmp_path, card):
    """On a card: with no program beside it, a run exits non-zero and prints
    no result."""
    root = copy_benchmark(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hdiff-chain", "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    shutil.rmtree(os.path.join(root, ".gt_cache"), ignore_errors=True)


test_in_a_directory_of_the_benchmark_alone_it_exits_nonzero = pytest.mark.cuda(
    test_in_a_directory_of_the_benchmark_alone_it_exits_nonzero)
