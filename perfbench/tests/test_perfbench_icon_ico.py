"""The icon-diffusion-vn-ico cell (ICON's diffusion of vn on the global
icosahedral grid R03B06, through the field-view program): its last line and
per-layer metrics in a CPU rehearsal at a small twin of its configuration
(R02B01 at 3 levels), a skip slot planted wrong reading above the limit,
the configuration and its byte counts, the reference's imports, and the new
metrics' readers on synthetic traces and spans."""

import ast
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
from conftest import REPO, copy_benchmark

from perfbench import program_spans, spec
from perfbench.harness import run_cell
from perfbench.spec import Cell, load_module

CELL = "icon-diffusion-vn-ico"
CONFIG = "icon_diffusion_vn_r3b6_l80_f64"
NEW = ["icon_ico_roofline", "icon_ico_rbf_roofline", "icon_ico_nabla2_roofline",
       "icon_ico_nabla4_roofline", "icon_ico_apply_roofline", "masked_calls_per_step", "mesh_s"]
#: the accepted metrics whose workloads list the cell too
SHARED = ["build_s", "idle_frac.next", "next_program_launches_per_step",
          "next_program_runtime_us"]
PROGRAM = load_module(REPO, "programs", "icon_diffusion_vn_ico")
TORUS = "icon_diffusion_vn_1m_l80_f64"


def full_config() -> dict:
    return spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))


@pytest.fixture
def ico_root(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ with the cell's configuration
    cut to R02B01 at 3 levels and a few traced calls."""
    root = copy_benchmark(str(tmp_path), later=False)
    path = os.path.join(root, "perfbench", "configs", f"{CONFIG}.json")
    with open(path, "w") as f:
        json.dump(PROGRAM.small_config(full_config(), 2, 1, 3), f)
    path = os.path.join(root, "perfbench", "traffic", "next_program_calls.json")
    traffic = spec.load_json(path)
    traffic["traced_calls"] = 6
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


def cpu_run(root, traced=False, seconds=0.5, seed=2**31 + 17):
    cell = Cell(root, CELL)
    return cell, run_cell(cell, seed, seconds, traced, ["cpu"], time.perf_counter())


def test_last_line_keys(ico_root):
    cell, result = cpu_run(ico_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} == \
        {"step_us", "call_p95_us", "setup_s"}
    # the plain path equals the reference to the bit; no kernel runs on the CPU
    assert result["checks"]["max_rel_err"]["value"] == 0.0 and result["failed"] == 0
    assert result["checks"]["kernel_launches_per_step"]["value"] == 0
    assert result["checks"]["plain_steps_checked"]["value"] == 5
    assert result["correct"] is False
    json.dumps(result)


def test_traced_rehearsal_reports_the_cells_per_layer_metrics(ico_root):
    cell, result = cpu_run(ico_root, traced=True)
    assert {m["name"] for m in cell.per_layer} == set(NEW + SHARED)
    # on the CPU no device operation is traced and no program span is a
    # card call's: the build's host clock, the idle share of a trace with
    # no device operation (1.0) and the grid's build span are read
    assert set(result["metrics"]) == {"build_s", "idle_frac.next", "mesh_s"}
    assert 0 < result["metrics"]["mesh_s"]["value"] < 10


def test_a_skip_slot_summed_reads_above_the_limit(ico_root, monkeypatch):
    """The fault planted: the grid's V2E handed to the program with the
    pentagons' sixth slot filled by their first edge and no skip value, so
    that it is summed: the comparison reads above the limit, every checked
    call fails."""
    from gt4py_tpu_torch.next import mesh_utils

    build = mesh_utils.icosahedral_mesh

    def summed(root, bisections):
        tables = build(root, bisections)
        v2e = tables["V2E"].copy()
        rows = v2e[:, 5] == -1
        v2e[rows, 5] = v2e[rows, 0]
        return {**tables, "V2E": v2e, "skip_values": {"V2E": None}}

    monkeypatch.setattr(mesh_utils, "icosahedral_mesh", summed)
    _, result = cpu_run(ico_root)
    check = result["checks"]["max_rel_err"]
    assert check["value"] > 100 * check["limit"] and result["failed"] == 5


def test_configuration_fills_the_grid():
    cfg = full_config()
    r, b = cfg["mesh_root"], cfg["mesh_bisections"]
    n = r * r * 4 ** b
    assert (r, b) == (3, 6) and cfg["levels"] == 80 and cfg["dtype"] == "float64"
    assert (cfg["cells"], cfg["edges"], cfg["vertices"]) == (20 * n, 30 * n, 10 * n + 2) == (
        737_280, 1_105_920, 368_642)
    for role, field in cfg["fields"].items():
        rows = cfg["vertices"] if role in ("u_vert", "v_vert") else cfg["edges"]
        assert field["shape"] == [rows, cfg["levels"]]
    assert cfg["reduced"] == [] and cfg["program"] == "icon_diffusion_vn_ico"
    assert cfg["check"]["max_rel_err"] == 1e-9
    torus = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{TORUS}.json"))
    for key in ("geometry", "profiles", "scalars", "geometry_seed", "written", "read",
                "operator_calls", "swap", "backend"):
        assert cfg[key] == torus[key], key
    entry = [c for c in spec.load_json(os.path.join(REPO, "BENCHMARK.json"))["configs"]
             if c["name"] == CONFIG][0]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert "R03B06" in entry["source"] and "icon4py" in entry["source"]


def test_byte_counts_at_the_configurations_size():
    """The step moves 11,610,698,176 bytes (a floor of 3.47 ms at 3.35 TB/s)."""
    m = load_module(REPO, "metrics", "icon_vn_roofline")
    nv, ne, nk = m.sizes(full_config())
    assert m.step_bytes(nv, ne, nk) == 11_610_698_176
    assert 3.4e-3 < m.step_bytes(nv, ne, nk) / 3.35e12 < 3.5e-3


def test_reference_imports_nothing_of_the_port():
    path = os.path.join(REPO, "perfbench", "reference", "icon_diffusion_vn_ico.py")
    tree = ast.parse(open(path).read())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert imported == {"os", "torch", "perfbench.spec"}
    code = ("import sys; sys.path.insert(0, %r); from perfbench import spec; "
            "r = spec.load_module(%r, 'reference', 'icon_diffusion_vn_ico'); "
            "r.tables({'mesh_root': 2, 'mesh_bisections': 1}, 'cpu'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gt4py_tpu', 'gt4py_tpu_torch'}))" % (REPO, REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --- the readers on synthetic traces and spans --------------------------------------------


def _trace_run(program="icon_diffusion_vn_ico", complete=True):
    ops = [["gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_0123456789(GtNbrParams)", 2e-3],
           ["gt_neighbor_calculate_nabla2_and_smag_coefficients_for_vn_0123456789(Gt)", 2e-3],
           ["gt_neighbor_calculate_nabla4_0123456789(GtNbrParams)", 1e-3],
           ["gt_neighbor_apply_nabla2_and_nabla4_to_vn_0123456789(GtNbrParams)", 3e-3]]
    return SimpleNamespace(config={**full_config(), "program": program}, peak_Bps=3.35e12,
                           itemsize=8, trace={"complete": complete, "busy_s": 8e-3, "steps": 2,
                                              "breakdown": {"device_ops": ops}})


def test_roofline_readers_on_a_synthetic_trace():
    """Each share from a complete trace whose device_ops name the kernels: a
    step of 4 ms busy, the RBF (both calls) and nabla2 1 ms, nabla4 0.5."""
    m = load_module(REPO, "metrics", "icon_vn_roofline")
    run = _trace_run()
    sizes = m.sizes(run.config)
    read = {name: load_module(REPO, "metrics", name).read(run) for name in NEW[:5]}
    assert read["icon_ico_roofline"] == pytest.approx(
        100 * m.step_bytes(*sizes) / 3.35e12 / 4e-3)
    assert read["icon_ico_rbf_roofline"] == pytest.approx(
        100 * 2 * m.rbf_bytes(*sizes) / 3.35e12 / 1e-3)
    assert read["icon_ico_nabla2_roofline"] == pytest.approx(
        100 * m.nabla2_bytes(*sizes) / 3.35e12 / 1e-3)
    assert read["icon_ico_nabla4_roofline"] == pytest.approx(
        100 * m.nabla4_bytes(*sizes) / 3.35e12 / 0.5e-3)
    # the update: the busy 4 ms a step less the gathers' 2.5 ms
    assert read["icon_ico_apply_roofline"] == pytest.approx(
        100 * m.apply_bytes(*sizes) / 3.35e12 / 1.5e-3)


@pytest.mark.parametrize("off", ["program", "incomplete", "untraced", "no_peak"])
def test_roofline_readers_read_nothing_off_their_program_or_trace(off):
    """None off the icosahedral program (the torus's run), from an
    incomplete trace, from an untraced run or without the card's peak; the
    torus's own readers read nothing on the icosahedral run."""
    run = _trace_run(program="icon_diffusion_vn" if off == "program" else
                     "icon_diffusion_vn_ico", complete=off != "incomplete")
    if off == "untraced":
        run.trace = None
    if off == "no_peak":
        run.peak_Bps = None
    assert all(load_module(REPO, "metrics", name).read(run) is None for name in NEW[:5])
    torus_readers = ["icon_vn_roofline", "icon_rbf_roofline", "icon_nabla2_roofline",
                     "icon_nabla4_roofline", "icon_apply_roofline"]
    assert all(load_module(REPO, "metrics", name).read(_trace_run()) is None
               for name in torus_readers)


def test_a_missing_kernel_reads_nothing():
    run = _trace_run()
    run.trace["breakdown"]["device_ops"] = run.trace["breakdown"]["device_ops"][1:]
    assert load_module(REPO, "metrics", "icon_ico_rbf_roofline").read(run) is None
    assert load_module(REPO, "metrics", "icon_ico_apply_roofline").read(run) is None
    assert load_module(REPO, "metrics", "icon_ico_nabla2_roofline").read(run) is not None


def _rec(name, id, parent, root, start, end, overhead=0, **attrs):
    return SimpleNamespace(name=name, id=id, parent=parent, root=root, start_ns=start,
                           end_ns=end, overhead_ns=overhead, attrs=attrs)


def _mesh(id, end, overhead, grid):
    return SimpleNamespace(name="gt4py.build.mesh", id=id, parent=None, root=id, start_ns=0,
                           end_ns=end, overhead_ns=overhead,
                           attrs={"kind": "icosahedral", "root": grid[0], "bisections": grid[1]})


def test_masked_calls_per_step_on_synthetic_roots(monkeypatch):
    roots = [_rec("gt4py.next.program", 10 * i, None, 10 * i, 0, 1, operators=5, launches=5,
                  masked=m) for i, m in enumerate((2, 2, 2, 1), start=1)]
    monkeypatch.setattr(program_spans, "records", lambda: list(roots))
    reader = load_module(REPO, "metrics", "masked_calls_per_step")
    run = SimpleNamespace(traffic={"traced_calls": 3}, trace={"kernels_launched": 15})
    assert reader.read(run) == pytest.approx(5 / 3)  # the last three roots
    run.traffic["traced_calls"] = 2
    assert reader.read(run) == 1.5
    # a program that sets no such attribute (one older than it): nothing read
    for r in roots:
        del r.attrs["masked"]
    assert reader.read(run) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert reader.read(run) is None


def test_mesh_s_reads_the_setup_build_of_the_configurations_grid(monkeypatch):
    """The first build of the configuration's grid (the operands', in
    set-up), not the small grid's nor a later one."""
    recs = [_mesh(1, 5_000_000, 1_000_000, (1, 1)), _mesh(2, 900_000_000, 2_000_000, (3, 6)),
            _rec("gt4py.build.codegen", 3, None, 3, 0, 7, stencil="x"),
            _mesh(4, 950_000_000, 3_000_000, (3, 6)), _mesh(5, 4_000_000, 0, (1, 1))]
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    reader = load_module(REPO, "metrics", "mesh_s")
    run = SimpleNamespace(config=full_config())
    assert reader.read(run) == pytest.approx(0.898)
    monkeypatch.setattr(program_spans, "records", lambda: recs[2:3])
    assert reader.read(run) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert reader.read(run) is None


@pytest.mark.cuda
def test_traced_cell_reads_masked_calls_on_card(card):
    """A traced run of the cell in a process of its own, as the benchmark
    runs it."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", str(2**31 + 37),
         "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["next_program_launches_per_step"] == 5.0 and m["masked_calls_per_step"] == 2.0
    assert set(m) == set(NEW + SHARED) and all(0 < m[k] <= 100 for k in NEW[:5])
    assert result["correct"] is True and result["checks"]["max_rel_err"]["value"] <= 1e-9
