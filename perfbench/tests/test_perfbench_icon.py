"""The icon-diffusion-vn-calls cell (ICON's diffusion of vn through a
field-view program): its last line and per-layer metrics in a CPU rehearsal
at a small twin of its configuration (a 12 x 8 torus of 5 levels), the
byte counts at the configuration's sizes, the reference against the port's
plain path and its float32 control, the reference's imports, the entry's
guard against a step that leaves the kernels, ``build``'s refusal of a
declined operator, and the span readers on synthetic records."""

import ast
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from conftest import REPO, copy_benchmark

from perfbench import control, program_spans, spec
from perfbench.harness import run_cell
from perfbench.spec import Cell, load_module

CELL = "icon-diffusion-vn-calls"
CONFIG = "icon_diffusion_vn_1m_l80_f64"
NEW = ["icon_vn_roofline", "icon_rbf_roofline", "icon_nabla2_roofline", "icon_nabla4_roofline",
       "icon_apply_roofline", "next_program_launches_per_step", "next_program_runtime_us"]
#: the accepted metrics whose workloads list the cell too
SHARED = ["build_s", "idle_frac.next"]
PROGRAM = load_module(REPO, "programs", "icon_diffusion_vn")
REFERENCE = load_module(REPO, "reference", "icon_diffusion_vn")


def config(nx=12, ny=8, nk=5) -> dict:
    full = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    return PROGRAM.small_config(full, nx, ny, nk)


@pytest.fixture
def icon_root(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ with the cell's configuration
    cut to a 12 x 8 torus of 5 levels and a few traced calls."""
    root = copy_benchmark(str(tmp_path), later=False)
    path = os.path.join(root, "perfbench", "configs", f"{CONFIG}.json")
    with open(path, "w") as f:
        json.dump(config(), f)
    path = os.path.join(root, "perfbench", "traffic", "next_program_calls.json")
    traffic = spec.load_json(path)
    traffic["traced_calls"] = 6
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


def cpu_run(root, traced=False, seconds=0.5, seed=2**31 + 11, entry_class=None):
    cell = Cell(root, CELL)
    return cell, run_cell(cell, seed, seconds, traced, ["cpu"], time.perf_counter(),
                          entry_class=entry_class)


def state(cfg, seed=4):
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {r: torch.zeros(f["shape"], dtype=torch.float64) for r, f in cfg["fields"].items()}
    out["vn"] = torch.rand(out["vn"].shape, generator=gen, dtype=torch.float64)
    return out


def test_last_line_keys(icon_root):
    cell, result = cpu_run(icon_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} == \
        {"step_us", "call_p95_us", "setup_s"}
    # the plain path equals the reference to the bit; no kernel runs on the CPU
    assert result["checks"]["max_rel_err"]["value"] == 0.0
    assert result["checks"]["kernel_launches_per_step"]["value"] == 0
    assert result["checks"]["plain_steps_checked"]["value"] == 5
    assert result["correct"] is False
    json.dumps(result)


def test_traced_rehearsal_reports_the_cells_per_layer_metrics(icon_root):
    cell, result = cpu_run(icon_root, traced=True)
    assert {m["name"] for m in cell.per_layer} == set(NEW + SHARED)
    # on the CPU no device operation is traced and no program span is a
    # card call's: only the build's host clock and the idle share of a
    # trace with no device operation (1.0) are read
    assert set(result["metrics"]) == set(SHARED) and result["metrics"]["idle_frac.next"] == {
        "value": 1.0, "unit": "frac"}


def test_run_loads_no_jax_module(icon_root):
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "from perfbench.spec import Cell; from perfbench.harness import run_cell\n"
        "from perfbench.run import forbidden_modules\n"
        "c = Cell(%r, %r); run_cell(c, 9, 0.2, True, ['cpu'], 0.0)\n"
        "print(forbidden_modules())\n" % (icon_root, REPO, icon_root, CELL)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=icon_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_byte_counts_at_the_configurations_size():
    """The step moves 18,061,068,160 bytes (a floor of 5.39 ms at 3.35 TB/s)."""
    m = load_module(REPO, "metrics", "icon_vn_roofline")
    cfg = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    nv, ne, nk = m.sizes(cfg)
    assert (nv, ne, nk) == (573_440, 1_720_320, 80) and cfg["cells"] == 1_146_880
    assert m.rbf_bytes(nv, ne, nk) == 1_917_583_360
    assert m.nabla2_bytes(nv, ne, nk) == 5_509_612_800
    assert m.nabla4_bytes(nv, ne, nk) == 3_183_738_880
    assert m.apply_bytes(nv, ne, nk) == 5_532_549_760
    assert m.step_bytes(nv, ne, nk) == 18_061_068_160
    assert 5.3e-3 < m.step_bytes(nv, ne, nk) / 3.35e12 < 5.5e-3


def test_fields_fill_the_configuration():
    cfg = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    for role, field in cfg["fields"].items():
        rows = cfg["vertices"] if role in ("u_vert", "v_vert") else cfg["edges"]
        assert field["shape"] == [rows, cfg["levels"]]
    assert cfg["reduced"] == [] and cfg["dtype"] == "float64"
    assert set(cfg["written"]) == set(cfg["fields"]) == set(PROGRAM.WRITTEN)
    assert cfg["vertices"] == cfg["mesh_nx"] * cfg["mesh_ny"]
    assert cfg["edges"] == 3 * cfg["vertices"] and cfg["cells"] == 2 * cfg["vertices"]


def test_reference_equals_the_ports_plain_path():
    """The port's ``cuda:hopper`` program on CPU tensors (the lowering's
    plain path, every operation in the kernel's order) against the
    reference: to the bit."""
    cfg = config()
    fields = state(cfg)
    want = REFERENCE.step({"vn": fields["vn"].clone()}, cfg)
    kwargs, provider = PROGRAM.operands(cfg, fields)
    PROGRAM.make_program("cuda:hopper")(**kwargs, offset_provider=provider)
    for role in PROGRAM.WRITTEN:
        assert torch.equal(fields[role], want[role]), role


def test_reference_in_blocks_equals_one_block(monkeypatch):
    cfg = config()
    vn = state(cfg)["vn"]
    whole = REFERENCE.step({"vn": vn}, cfg)
    monkeypatch.setattr(REFERENCE, "EDGE_BLOCK", 7)
    for role, t in REFERENCE.step({"vn": vn}, cfg).items():
        assert torch.equal(t, whole[role]), role


def test_ranges_take_every_branch_and_move_vn():
    """At a 48 x 32 torus of 8 levels: the step's increment to vn is over a
    tenth of vn's largest magnitude, and each branch of maximum(0, ...),
    minimum(..., smag_limit) and the update's maximum holds at 10 % or more
    of the points."""
    cfg = config(48, 32, 8)
    vn = state(cfg)["vn"]
    out = REFERENCE.step({"vn": vn}, cfg)
    assert (out["vn"] - vn).abs().max() > 0.1 * vn.abs().max()
    g = REFERENCE.geometry(cfg, "cpu", torch.float64)
    x = out["kh_smag_ec"] - cfg["scalars"]["smag_offset"]
    limit = g["smag_limit"][None, :]
    nudge = cfg["scalars"]["nudgezone_diff"] * g["nudgecoeff_e"][:, None]
    shares = [(x < 0).double().mean(), (x > 0).double().mean(), (x > limit).double().mean(),
              (x < limit).double().mean(), (nudge > out["kh_smag_e"]).double().mean(),
              (nudge < out["kh_smag_e"]).double().mean()]
    assert all(s >= 0.1 for s in shares), shares


def test_float32_control_reads_far_above_the_limit():
    """The same step computed in float32 (the precision below the
    configuration's) against the float64 reference: at least 100 times
    ``max_rel_err``, in the harness's comparison."""
    from perfbench import check

    cfg = config(24, 16, 8)
    vn = state(cfg)["vn"]
    want = check.follow(REFERENCE, cfg, {"vn": vn}, {}, 1, torch.float64)
    got = check.follow(REFERENCE, cfg, {"vn": vn}, {}, 1, torch.float32)
    del want["vn"], got["vn"]
    want.update(REFERENCE.step({"vn": vn}, cfg))
    got.update(REFERENCE.step({"vn": vn.float()}, cfg))
    err = check.rel_err(got, want)
    assert err >= 100 * cfg["check"]["max_rel_err"], err


def test_control_entry_in_float32_is_not_correct(icon_root, monkeypatch):
    """The harness's control (perfbench/control.py) run in float32 in the
    program's place: its reading exceeds the limit, so the run is not
    correct."""
    monkeypatch.setattr(control, "LOWER", "float32")
    _, result = cpu_run(icon_root, entry_class=control.ControlEntry)
    check = result["checks"]["max_rel_err"]
    assert check["value"] >= 100 * check["limit"] and result["correct"] is False


def test_reference_imports_nothing_of_the_port_or_jax():
    path = os.path.join(REPO, "perfbench", "reference", "icon_diffusion_vn.py")
    tree = ast.parse(open(path).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"torch"}, imported
    code = ("import sys; sys.path.insert(0, %r); from perfbench import spec; "
            "spec.load_module(%r, 'reference', 'icon_diffusion_vn'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gt4py_tpu', 'gt4py_tpu_torch'}))" % (REPO, REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_builds_the_ports_mesh():
    from gt4py_tpu_torch.next.mesh_utils import periodic_triangle_mesh

    want = periodic_triangle_mesh(7, 5)
    for name, table in REFERENCE.mesh(7, 5, "cpu").items():
        assert torch.equal(table, torch.from_numpy(want[name])), name


# --- the entry's guard and build's refusal --------------------------------------------


class _Counting:
    """A stand-in for the program: each call adds ``launches`` kernel
    launches, ``served`` calls of the generated kernel and ``declines``
    declines."""

    def __init__(self, launches=5, served=5, declines=0):
        self.launches, self.served, self.declines = launches, served, declines

    def __call__(self, **kwargs):
        from gt4py_tpu_torch.cartesian.backend import cuda_backend
        from gt4py_tpu_torch.next import unstructured_codegen as uc

        cuda_backend.NEIGHBOR.launches += self.launches
        uc.calls_served["neighbor"] += self.served
        uc.declined[uc.DECLINED_BUILTIN] += self.declines


@pytest.mark.parametrize("planted, strategy", [
    ({}, "neighbor"),
    ({"declines": 1}, None),
    ({"launches": 4, "served": 4}, None),
    ({"served": 4}, None),
])
def test_entry_reports_neighbor_only_for_a_step_on_the_kernels(planted, strategy):
    Entry = load_module(REPO, "entries", "next_program").Entry
    cfg = config()
    entry = Entry(_Counting(**planted), cfg, {}, state(cfg), [torch.device("cpu")])
    entry.on_card = True  # as on a card: the counters decide
    info: dict = {}
    entry.call(info)
    assert entry.strategies(info) == {"kernel": [strategy]}


def test_build_raises_at_once_where_an_operator_is_declined(monkeypatch):
    from gt4py_tpu_torch.next import unstructured_codegen as uc

    cfg = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    assert PROGRAM.build(cfg) is not None

    def declines(op, *args, **kwargs):
        raise uc.Declined(uc.DECLINED_BUILTIN, "'sqrt'")

    monkeypatch.setattr(uc, "lower", declines)
    t0 = time.perf_counter()
    with pytest.raises(uc.Declined):
        PROGRAM.build(cfg)
    assert time.perf_counter() - t0 < 60


# --- the span readers ----------------------------------------------------------------------


def _rec(name, id, parent, root, start, end, overhead=0, **attrs):
    return SimpleNamespace(name=name, id=id, parent=parent, root=root, start_ns=start,
                           end_ns=end, overhead_ns=overhead, attrs=attrs)


def _program_call(base, first):
    """One traced program call at ``base`` ns: the root 0-500 µs holding five
    operator calls of 80 µs, each with a replay of one launch (50-70 µs
    into it); each span's own recording 2 µs."""
    recs = []
    for i in range(5):
        c, r = first + 1 + 2 * i, first + 2 + 2 * i
        at = base + 10_000 + 95_000 * i
        recs += [_rec("gt4py.next.replay", r, c, first, at + 50_000, at + 70_000, 2_000,
                      launches=1),
                 _rec("gt4py.next.call", c, first, first, at, at + 80_000, 2_000)]
    return recs + [_rec("gt4py.next.program", first, None, first, base, base + 500_000, 2_000,
                        operators=5, launches=5)]


def test_span_readers_on_two_traced_program_calls(monkeypatch):
    recs = _program_call(0, 10) + _program_call(10**6, 30) + _program_call(2 * 10**6, 50)
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    run = SimpleNamespace(traffic={"traced_calls": 2},
                          trace={"kernels_launched": 10, "steps": 2})
    reader = lambda name: load_module(REPO, "metrics", name)  # noqa: E731
    assert reader("next_program_launches_per_step").read(run) == 5.0
    # 500 µs less its own recording's 2 and the five replays' 20 each
    assert reader("next_program_runtime_us").read(run) == pytest.approx(398.0)
    run.trace["kernels_launched"] = 11  # the counters disagree: nothing read
    assert reader("next_program_launches_per_step").read(run) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert reader("next_program_runtime_us").read(run) is None


def test_roofline_readers_on_a_synthetic_trace():
    """Each share from a complete trace whose device_ops name the kernels:
    a step of 4 ms busy, the gathers 1, 1 and 0.5 ms, the rest the update."""
    full = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))
    ops = [["gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_0123456789(GtNbrParams)", 2e-3],
           ["gt_neighbor_calculate_nabla2_and_smag_coefficients_for_vn_0123456789(Gt)", 2e-3],
           ["gt_neighbor_calculate_nabla4_0123456789(GtNbrParams)", 1e-3],
           ["gt_neighbor_apply_nabla2_and_nabla4_to_vn_0123456789(GtNbrParams)", 3e-3]]
    run = SimpleNamespace(config=full, peak_Bps=3.35e12, itemsize=8, trace={
        "complete": True, "busy_s": 8e-3, "steps": 2, "breakdown": {"device_ops": ops}})
    m = load_module(REPO, "metrics", "icon_vn_roofline")
    sizes = m.sizes(full)
    read = {name: load_module(REPO, "metrics", name).read(run) for name in NEW[:5]}
    assert read["icon_vn_roofline"] == pytest.approx(100 * m.step_bytes(*sizes) / 3.35e12 / 4e-3)
    assert read["icon_rbf_roofline"] == pytest.approx(
        100 * 2 * m.rbf_bytes(*sizes) / 3.35e12 / 1e-3)
    assert read["icon_nabla2_roofline"] == pytest.approx(
        100 * m.nabla2_bytes(*sizes) / 3.35e12 / 1e-3)
    assert read["icon_nabla4_roofline"] == pytest.approx(
        100 * m.nabla4_bytes(*sizes) / 3.35e12 / 0.5e-3)
    assert read["icon_apply_roofline"] == pytest.approx(
        100 * m.apply_bytes(*sizes) / 3.35e12 / 1.5e-3)
    run.trace["complete"] = False
    assert all(load_module(REPO, "metrics", name).read(run) is None for name in NEW[:5])


@pytest.mark.cuda
def test_traced_cell_reads_five_launches_a_step_on_card(card):
    """A traced run of the cell in a process of its own, as the benchmark
    runs it."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", str(2**31 + 31),
         "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["next_program_launches_per_step"] == 5.0
    assert set(m) == set(NEW + SHARED) and all(0 < m[k] <= 100 for k in NEW[:5])
    assert 0 < m["build_s"] and 0 <= m["idle_frac.next"] < 0.05
    assert result["correct"] is True and result["checks"]["max_rel_err"]["value"] <= 1e-9
