"""The per-layer metrics read from the port's own spans: each reader on
synthetic records (and on a program that records none), a traced CPU
rehearsal of the chain cells, and on the card the counts and the spans'
place in the Chrome trace beside the CUDA runtime calls."""

import json
import os
import tempfile
import time
from types import SimpleNamespace

import pytest
from conftest import REPO, copy_benchmark

from perfbench import harness, program_spans
from perfbench.harness import run_cell
from perfbench.spec import Cell, load_module

NEW = ["chain_runtime_us", "chain_backend_us", "graph_replays_per_step", "launches_per_step",
       "front_end_s"]


def reader(name):
    return load_module(REPO, "metrics", name)


class Rec(SimpleNamespace):
    """A record with the fields of ``instrumentation.SpanRecord``."""


def rec(name, id, parent, root, start, end, overhead=0, **attrs):
    return Rec(name=name, id=id, parent=parent, root=root, start_ns=start, end_ns=end,
               overhead_ns=overhead, attrs=attrs)


def chain_call(base, first_id, replays, launches, steps=20):
    """One traced ``chain`` call at ``base`` ns: the root 0-100 µs, its
    run_steps 30-90 µs holding a replay 40-80 µs, its write-back after;
    each span's own recording 2 µs of it."""
    c, b, r = first_id, first_id + 1, first_id + 2
    return [
        rec("gt4py.backend.replay", r, b, c, base + 40_000, base + 80_000, 2_000,
            replays=replays, launches=launches),
        rec("gt4py.backend.run_steps", b, c, c, base + 30_000, base + 90_000, 2_000, captured=0),
        rec("gt4py.chain", c, None, c, base, base + 100_000, 2_000, steps=steps),
    ]


BUILD = [
    rec("gt4py.build.front_end", 1, None, 1, 0, 50_000_000, stencil="other"),
    rec("gt4py.build.front_end", 2, None, 2, 0, 30_000_000, stencil="horizontal_diffusion"),
    rec("gt4py.build.codegen", 3, None, 3, 0, 11_000_000, 1_000_000,
        stencil="horizontal_diffusion"),
]


@pytest.fixture
def records(monkeypatch):
    """Sets the records the readers find."""
    def use(recs):
        monkeypatch.setattr(program_spans, "records",
                            lambda: None if recs is None else list(recs))
    return use


def traced_run(kernels_launched=20, traced_calls=2):
    return SimpleNamespace(traffic={"traced_calls": traced_calls},
                           trace={"kernels_launched": kernels_launched, "steps": 40})


def test_readers_on_two_traced_calls(records):
    # an untraced call first (no profile: not kept), so the last two roots are read
    records(BUILD + chain_call(0, 10, 10, 10) + chain_call(10**6, 20, 10, 10)
            + chain_call(2 * 10**6, 30, 10, 10))
    run = traced_run()
    # 100 µs less its own recording's 2 and the run_steps child's 60
    assert reader("chain_runtime_us").read(run) == pytest.approx(38.0)
    # 60 µs less its own 2 and the replay's 40
    assert reader("chain_backend_us").read(run) == pytest.approx(18.0)
    assert reader("graph_replays_per_step").read(run) == pytest.approx(0.5)
    assert reader("launches_per_step").read(run) == pytest.approx(0.5)
    assert reader("front_end_s").read(run) == pytest.approx(0.04)


def test_launches_read_only_where_the_kernel_counters_agree(records):
    records(chain_call(0, 10, 20, 40) + chain_call(10**6, 20, 20, 40))
    assert reader("launches_per_step").read(traced_run(kernels_launched=80)) == 2.0
    assert reader("launches_per_step").read(traced_run(kernels_launched=79)) is None


def test_launch_spans_count_and_self_time_leaves_out_each_child(records):
    # two launches outside a graph under run_steps; a write-back span-less gap
    calls = []
    for k, base in enumerate((0, 10**6)):
        c = 100 + 10 * k
        calls += [
            rec("gt4py.backend.launch", c + 2, c + 1, c, base + 10_000, base + 20_000, launches=1),
            rec("gt4py.backend.launch", c + 3, c + 1, c, base + 15_000, base + 30_000, launches=1),
            rec("gt4py.backend.run_steps", c + 1, c, c, base + 5_000, base + 35_000),
            rec("gt4py.chain", c, None, c, base, base + 50_000, steps=2),
        ]
    records(calls)
    run = traced_run(kernels_launched=4)
    assert reader("launches_per_step").read(run) == 1.0
    assert reader("graph_replays_per_step").read(run) == 0.0
    assert reader("chain_backend_us").read(run) == pytest.approx(10.0)  # 30 less 10-30
    assert reader("chain_runtime_us").read(run) == pytest.approx(20.0)


@pytest.mark.parametrize("case", ["no spans", "none kept", "untraced", "too few roots"])
def test_readers_return_none_with_nothing_to_read(records, case):
    run = traced_run()
    if case == "no spans":  # a program older than its spans
        records(None)
    elif case == "none kept":
        records([])
    elif case == "untraced":
        records(chain_call(0, 10, 10, 10) + chain_call(10**6, 20, 10, 10))
        run.trace = None
    else:
        records(BUILD + chain_call(0, 10, 10, 10))
    for name in NEW:
        if name == "front_end_s" and case in ("untraced", "too few roots"):
            continue  # build spans are read from any run
        assert reader(name).read(run) is None, name


def test_a_program_without_spans_reads_none(monkeypatch):
    from gt4py_tpu_torch import instrumentation

    monkeypatch.delattr(instrumentation, "spans")
    assert program_spans.records() is None
    for name in NEW:
        assert reader(name).read(traced_run()) is None, name


@pytest.mark.parametrize("workload", ["hdiff-chain", "vadv-chain"])
def test_traced_rehearsal_reports_the_span_metrics(small_root, workload, capfd, monkeypatch):
    from gt4py_tpu_torch.cartesian import stencil_builder

    monkeypatch.setattr(stencil_builder, "_MEMO", {})  # built anew, as in a run's own process
    cell = Cell(small_root, workload)
    result = run_cell(cell, 2**31 + 11, 0.3, True, ["cpu"], time.perf_counter())
    err = capfd.readouterr().err
    for name in NEW:
        assert name in result["metrics"], name
        assert f"metric {name} " in err
    m = {k: v["value"] for k, v in result["metrics"].items()}
    # on CPU tensors the plain version runs: no graph, no kernel
    assert m["graph_replays_per_step"] == m["launches_per_step"] == 0.0
    assert 0 < m["chain_runtime_us"] < m["chain_host_us"]
    assert 0 < m["front_end_s"] < m["build_s"]


# --- on the card ----------------------------------------------------------------------

#: (graph replays, kernel launches) a step: hdiff's swap is a 2-step cycle of
#: one plane kernel, vadv's a 1-step cycle of two column kernels
COUNTS = {"hdiff-chain": (0.5, 1.0), "vadv-chain": (1.0, 2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(COUNTS))
def test_traced_cell_reads_the_counts_on_card(workload, card, tmp_path):
    root = copy_benchmark(str(tmp_path), later=False)
    cell = Cell(root, workload)
    result = run_cell(cell, 2**31 + 23, 1.0, True, ["cuda:0"], time.perf_counter())
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert (m["graph_replays_per_step"], m["launches_per_step"]) == COUNTS[workload]
    assert m["chain_runtime_us"] > 0 and m["chain_backend_us"] > 0
    assert 0 < m["front_end_s"] <= m["build_s"]
    assert result["correct"] is True


@pytest.mark.cuda
def test_replay_spans_enclose_the_graph_launches_on_card(card):
    """A traced ``chain(20)`` of hdiff: in the Chrome trace every
    ``cudaGraphLaunch`` lies inside a ``gt4py.backend.replay`` span, inside
    ``gt4py.backend.run_steps`` and ``gt4py.chain``; no capture after the
    warm-up; the profiler's switch is on under ``emit_nvtx`` too."""
    import torch
    from torch.autograd import _profiler_enabled
    from torch.profiler import ProfilerActivity, profile

    cell = Cell(REPO, "hdiff-chain")
    device = torch.device("cuda:0")
    inputs = harness.make_inputs(cell.config, 5, device)
    stencil = cell.module("programs", cell.config["program"]).build(cell.config)
    entry = cell.module("entries", "chain").Entry(stencil, cell.config, cell.traffic, inputs,
                                                   [device])
    for _ in range(2):
        entry.call()
    torch.cuda.synchronize()
    with torch.autograd.profiler.emit_nvtx():
        assert _profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            entry.call()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)

    def spans(name, cat="user_annotation"):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == name and e.get("cat") == cat]

    launches = spans("cudaGraphLaunch", "cuda_runtime")
    replays, runs, chains = (spans(f"gt4py.{n}") for n in ("backend.replay", "backend.run_steps",
                                                         "chain"))
    assert len(launches) == 30 and len(replays) == len(runs) == len(chains) == 3
    assert not spans("gt4py.backend.capture")

    def inside(inner, outer):
        return all(any(lo <= a and b <= hi for lo, hi in outer) for a, b in inner)

    assert inside(launches, replays) and inside(replays, runs) and inside(runs, chains)
