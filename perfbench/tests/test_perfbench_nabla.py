"""The nabla-1m-calls cell (the FVM nabla through the field view): its
last line and per-layer metrics in a CPU rehearsal at a small twin of its
configuration (a 16 x 16 mesh of 5 levels), its plain reference against the
field view's ``numpy`` oracle, the reference's imports, the roofline's byte
count against bench_torch.py's, the span readers on synthetic records, and
on the card the traced counts."""

import ast
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import REPO, copy_benchmark

from perfbench import program_spans, spec
from perfbench.harness import run_cell
from perfbench.spec import Cell, load_module

CELL = "nabla-1m-calls"
CONFIG = "fvm_pnabla_1m_l137_f32"
NEW = ["nabla_roofline", "next_launches_per_call", "next_call_runtime_us", "next_host_us",
       "idle_frac.next"]


def small(config: dict, n: int = 16, nk: int = 5) -> dict:
    """``config`` on an n x n mesh of nk levels."""
    config = json.loads(json.dumps(config))
    for field in config["fields"].values():
        field["shape"] = [n * n, nk]
    config.update(mesh_n=n, columns=n * n, edges=2 * n * n, levels=nk)
    return config


@pytest.fixture
def nabla_root(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ with the cell's configuration
    cut to a 16 x 16 mesh of 5 levels and a few traced calls."""
    root = copy_benchmark(str(tmp_path), later=False)
    path = os.path.join(root, "perfbench", "configs", f"{CONFIG}.json")
    config = small(spec.load_json(path))
    with open(path, "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "perfbench", "traffic", "next_calls.json")
    traffic = spec.load_json(path)
    traffic["traced_calls"] = 6
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


def cpu_run(root, traced=False, seconds=0.5, seed=2**31 + 9):
    cell = Cell(root, CELL)
    return cell, run_cell(cell, seed, seconds, traced, ["cpu"], time.perf_counter())


def test_last_line_keys(nabla_root):
    cell, result = cpu_run(nabla_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} == \
        {"step_us", "call_p95_us", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the plain version equals the reference; the kernel guard does not hold on the CPU
    assert result["checks"]["max_rel_err"]["value"] <= result["checks"]["max_rel_err"]["limit"]
    assert result["checks"]["kernel_launches_per_step"]["value"] == 0
    assert result["checks"]["plain_steps_checked"]["value"] == 5
    assert result["correct"] is False
    json.dumps(result)


def test_traced_rehearsal_reports_the_cells_per_layer_metrics(nabla_root, capfd):
    cell, result = cpu_run(nabla_root, traced=True)
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    # on the CPU no device operation is traced: the roofline reads nothing
    assert set(result["metrics"]) == set(NEW) - {"nabla_roofline"}
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["next_launches_per_call"] == 0.0  # the plain version: no kernel
    assert 0 < m["next_call_runtime_us"] and 0 < m["next_host_us"]
    assert "metric next_host_us " in capfd.readouterr().err


def test_run_loads_no_jax_module(nabla_root):
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "from perfbench.spec import Cell; from perfbench.harness import run_cell\n"
        "from perfbench.run import forbidden_modules\n"
        "c = Cell(%r, %r); run_cell(c, 9, 0.2, True, ['cpu'], 0.0)\n"
        "print(forbidden_modules())\n" % (nabla_root, REPO, nabla_root, CELL)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=nabla_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_equals_the_numpy_backend(dtype):
    """The reference against the field view's ``numpy`` oracle running the
    program's operator on a 16 x 16 mesh of 5 levels, from the same pp,
    mesh and geometry."""
    config = small(spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json")))
    config["dtype"] = dtype
    program = load_module(REPO, "programs", "fvm_pnabla")
    reference = load_module(REPO, "reference", "fvm_pnabla")
    pp = torch.from_numpy(np.random.default_rng(7).random((256, 5)).astype(dtype))
    state = {"pp": pp, "pnabla_M": torch.zeros_like(pp), "pnabla_P": torch.zeros_like(pp)}
    args, out, provider = program.operands(config, state)
    program.pnabla.with_backend("numpy")(*args, out=out, offset_provider=provider)
    want = reference.step({"pp": pp}, config)
    rtol = 2e-6 if dtype == "float32" else 1e-13
    for role, w in want.items():
        np.testing.assert_allclose(state[role].numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * float(w.abs().max()))


def test_reference_imports_nothing_of_the_port_or_jax():
    path = os.path.join(REPO, "perfbench", "reference", "fvm_pnabla.py")
    tree = ast.parse(open(path).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"torch"}, imported
    code = ("import sys; sys.path.insert(0, %r); from perfbench import spec; "
            "spec.load_module(%r, 'reference', 'fvm_pnabla'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gt4py_tpu', 'gt4py_tpu_torch'}))" % (REPO, REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pnabla_bytes_hold_bench_torchs_nabla_bytes():
    """At one level, the x component alone without the index tables is
    bench_torch.nabla_bytes; the cell's size moves 1,828,716,544 bytes."""
    sys.path.insert(0, REPO)
    import bench_torch

    nabla = load_module(REPO, "metrics", "nabla_roofline")
    for n in (256, 1024):
        nv = n * n
        assert nabla.pnabla_bytes(nv, 1, 2 * nv, 4, 0, components=1) == \
            bench_torch.nabla_bytes(nv)
    config = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    assert nabla.pnabla_bytes(config["columns"], config["levels"], config["edges"]) == \
        1_828_716_544


def _rec(name, id, parent, root, start, end, overhead=0, **attrs):
    return SimpleNamespace(name=name, id=id, parent=parent, root=root, start_ns=start,
                           end_ns=end, overhead_ns=overhead, attrs=attrs)


def _next_call(base, first_id, name):
    """One traced field-operator call at ``base`` ns: the root 0-80 µs holding
    a ``name`` span 50-70 µs, one launch; each span's own recording 2 µs."""
    c, r = first_id, first_id + 1
    return [_rec(name, r, c, c, base + 50_000, base + 70_000, 2_000, launches=1),
            _rec("gt4py.next.call", c, None, c, base, base + 80_000, 2_000)]


def test_span_readers_on_two_traced_calls(monkeypatch):
    recs = (_next_call(0, 10, "gt4py.next.launch") + _next_call(10**6, 20, "gt4py.next.replay")
            + _next_call(2 * 10**6, 30, "gt4py.next.replay"))
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    run = SimpleNamespace(traffic={"traced_calls": 2}, trace={"kernels_launched": 2, "steps": 2})
    reader = lambda name: load_module(REPO, "metrics", name)  # noqa: E731
    assert reader("next_launches_per_call").read(run) == 1.0
    # 80 µs less its own recording's 2 and the replay's 20
    assert reader("next_call_runtime_us").read(run) == pytest.approx(58.0)
    run.trace["kernels_launched"] = 3  # the counters disagree: nothing read
    assert reader("next_launches_per_call").read(run) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert reader("next_call_runtime_us").read(run) is None


@pytest.mark.cuda
def test_traced_cell_reads_one_launch_a_call_on_card(card):
    """A traced run of the cell in a process of its own, as the benchmark
    runs it (a profile earlier in the same process can leave CUPTI's kernel
    records incomplete)."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", str(2**31 + 29),
         "--seconds", "1", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["next_launches_per_call"] == 1.0
    assert 0 < m["nabla_roofline"] <= 100 and m["idle_frac.next"] < 0.05
    assert result["breakdown"]["device_ops"][0][0].startswith("gt_neighbor_pnabla_")
    assert result["correct"] is True
