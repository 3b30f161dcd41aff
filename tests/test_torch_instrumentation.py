"""tests/test_instrumentation.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Metrics/hooks subsystem tests (reference design:
next/instrumentation/metrics.py + hook_machinery.py)."""

import json

import numpy as np
from torch.profiler import ProfilerActivity, profile, record_function

from gt4py_tpu_torch.instrumentation import (
    NO_SPAN,
    MetricCollectionLevel,
    MetricsCollector,
    clear_spans,
    collect_metrics,
    dump_metrics_json,
    dump_metrics_table,
    span,
    spans,
)
from gt4py_tpu_torch.instrumentation import metrics as metrics_mod
from gt4py_tpu_torch.instrumentation.hooks import context_hook, event_hook, stencil_call


def test_collector_respects_level():
    metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)
    with MetricsCollector("test_prog", "disabled_metric"):
        pass
    assert metrics_mod.get_metric("test_prog", "disabled_metric").count == 0

    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    with collect_metrics("test_prog", "enabled_metric"):
        pass
    assert metrics_mod.get_metric("test_prog", "enabled_metric").count == 1
    metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)


def test_stencil_call_records_metric():
    import json

    from gt4py_tpu_torch.cartesian import gtscript
    from tests import torch_stencil_defs as defs

    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    try:
        st = gtscript.stencil(backend="numpy", definition=defs.copy_stencil)
        a = np.random.rand(4, 4, 2)
        st(a, np.zeros_like(a))
        metric = metrics_mod.get_metric("copy_stencil", "compute")
        assert metric.count >= 1
        assert metric.total > 0
        table = dump_metrics_table()
        assert "copy_stencil" in table
        data = json.loads(dump_metrics_json())
        assert any(d["source"] == "copy_stencil" for d in data)
    finally:
        metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)


def test_hooks():
    events = []
    hook = event_hook("test_event")
    hook.register(lambda x: events.append(x))
    hook.fire(42)
    assert events == [42]

    order = []

    class _Ctx:
        def __enter__(self):
            order.append("enter")

        def __exit__(self, *a):
            order.append("exit")
            return False

    chook = context_hook("test_ctx")
    chook.register(lambda *a, **k: _Ctx())
    with chook.wrap():
        order.append("body")
    assert order == ["enter", "body", "exit"]


# --- the port's spans (instrumentation/spans.py; no counterpart in the JAX package) ----
SWAP = {"in_field": "out_field", "out_field": "in_field"}


def _hdiff(**options):
    """hdiff on ``cuda:hopper`` (its plain version on CPU tensors) and its
    fields on the CPU."""
    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript
    from tests import torch_stencil_defs as defs

    st = gtscript.stencil(backend="cuda:hopper", definition=defs.horizontal_diffusion, **options)
    rng = np.random.default_rng(0)
    fields = {n: storage.from_array(rng.random((10, 10, 3)), backend="cuda:hopper",
                                    aligned_index=(2, 2, 0), device="cpu")
              for n in ("in_field", "out_field", "coeff")}
    return st, fields


def test_span_off_path_records_nothing():
    """With no profile, metrics DISABLED and no stencil_call hook, a span is
    the shared no-op, and a chain and a call keep no record."""
    metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)
    assert not stencil_call.factories
    st, f = _hdiff()
    assert span("gt4py.anything") is NO_SPAN
    clear_spans()
    st.chain(4, **f, swap=SWAP, domain=(6, 6, 3))
    st(**f, domain=(6, 6, 3))
    assert spans() == []


def test_chain_spans_nest_in_the_profile(tmp_path):
    """Under a CPU profile, a chain records ``gt4py.chain`` (its steps) as a
    root and ``gt4py.backend.run_steps`` under it, and both lie in the Chrome
    trace inside the enclosing ``record_function``."""
    st, f = _hdiff()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.outer"):
            st.chain(4, **f, swap=SWAP, domain=(6, 6, 3))
    recs = {r.name: r for r in spans()}
    chain, steps = recs["gt4py.chain"], recs["gt4py.backend.run_steps"]
    assert (chain.parent, chain.root, chain.attrs) == (None, chain.id, {"steps": 4})
    assert (steps.parent, steps.root, steps.attrs) == (chain.id, chain.id, {"captured": 0})
    assert chain.start_ns <= steps.start_ns <= steps.end_ns <= chain.end_ns
    # the plain version's four applications, each a run span under run_steps
    runs = [r for r in spans() if r.name == "gt4py.backend.run"]
    assert [(r.parent, r.root) for r in runs] == [(steps.id, chain.id)] * 4
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = {e["name"]: e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    outer = events["perfbench.outer"]
    for name in ("gt4py.chain", "gt4py.backend.run_steps"):
        e = events[name]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_metrics_fed_by_spans_without_records():
    """At level PERFORMANCE with no profile, the root spans feed the
    stencil's ``compute`` and ``chain`` metrics and keep no record."""
    st, f = _hdiff()
    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    try:
        before = {m: metrics_mod.get_metric(st.name, m).count for m in ("compute", "chain")}
        clear_spans()
        st(**f, domain=(6, 6, 3))
        st.chain(2, **f, swap=SWAP, domain=(6, 6, 3))
        assert spans() == []
        for m in ("compute", "chain"):
            assert metrics_mod.get_metric(st.name, m).count == before[m] + 1
        assert metrics_mod.get_metric("gt4py", "gt4py.backend.run_steps").count >= 1
    finally:
        metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)


def test_stencil_call_hook_wraps_the_call_span():
    """A stencil_call hook is entered around the call with the stencil,
    outside the ``gt4py.call`` span; registering one turns the root span on."""
    st, f = _hdiff()
    seen = []

    class _Ctx:
        def __init__(self, obj):
            self.obj = obj

        def __enter__(self):
            seen.append(("enter", self.obj))

        def __exit__(self, *exc):
            seen.append(("exit", self.obj))
            return False

    stencil_call.register(_Ctx)
    try:
        assert span("gt4py.x", hook=st) is not NO_SPAN
        assert span("gt4py.x") is NO_SPAN
        st(**f, domain=(6, 6, 3))
    finally:
        stencil_call.factories.remove(_Ctx)
    assert seen == [("enter", st), ("exit", st)]


def test_build_spans_and_build_info():
    """A build keeps its front end and code generator spans with the
    stencil's name, profiled or not, and ``build_info`` takes its times from
    them; the ``nvcc`` phase is a build span too."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    clear_spans()
    info = {}
    _hdiff(build_info=info, rebuild=True)
    recs = {r.name: r for r in spans()}
    for phase, key in (("front_end", "parse_time"), ("codegen", "codegen_time")):
        r = recs[f"gt4py.build.{phase}"]
        assert r.attrs == {"stencil": "horizontal_diffusion"}
        assert info[key] == (r.end_ns - r.start_ns - r.overhead_ns) / 1e9 > 0
    assert info["module_time"] >= info["codegen_time"]
    cuda_backend.build_libraries([])
    assert spans()[-1].name == "gt4py.build.nvcc" and spans()[-1].attrs == {"nvcc_runs": 0}


def test_metrics_collector_is_a_span():
    """``MetricsCollector`` is the span primitive named after its metric: in
    a profile it is recorded, at its level it feeds the metric."""
    clear_spans()
    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with MetricsCollector("test_prog", "as_span"):
                pass
    finally:
        metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)
    assert [r.name for r in spans()] == ["test_prog.as_span"]
    assert metrics_mod.get_metric("test_prog", "as_span").count == 1


# --- the port's program span (not in the reference) ----------------------------------


def _icon_step(monkeypatch):
    """ICON's diffusion step (perfbench/programs/icon_diffusion_vn.py) on a
    12 x 8 torus of 5 levels, on a stand-in for the card (its kernels'
    plain versions, counted as launches)."""
    from .test_torch_icon_diffusion import PROGRAM, config, fields_of, install_fake_card

    install_fake_card(monkeypatch)
    cfg = config()
    kwargs, provider = PROGRAM.operands(cfg, fields_of(cfg))
    return PROGRAM, kwargs, provider


def test_program_call_on_card_tensors_is_the_root_span(monkeypatch):
    """A program's call on card tensors is one root span
    ``gt4py.next.program`` with the operator calls it made, the kernels
    they launched or replayed and the calls served masking skip values
    (none on the torus); each operator's ``gt4py.next.call`` span, with its
    launch or replay, nests under it."""
    program, kwargs, provider = _icon_step(monkeypatch)
    step = program.make_program("cuda:hopper")
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            step(**kwargs, offset_provider=provider)
    records = spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["gt4py.next.program"] * 3
    assert all(r.attrs == {"operators": 5, "launches": 5, "masked": 0} for r in roots)
    for root in roots:
        mine = [r for r in records if r.root == root.id and r.id != root.id]
        calls = [r for r in mine if r.name == "gt4py.next.call"]
        assert len(calls) == 5 and all(c.parent == root.id for c in calls)
        work = [r for r in mine if r.name in ("gt4py.next.launch", "gt4py.next.replay")]
        assert sum(r.attrs["launches"] for r in work) == 5
        assert {r.parent for r in work} == {c.id for c in calls}
    assert [r.name for r in records if r.root == roots[-1].id].count("gt4py.next.replay") == 5


def test_program_span_only_on_card_tensors_while_recording(monkeypatch):
    """No program span on CPU tensors or while no profile records; a field
    operator called alone keeps ``gt4py.next.call`` as its root."""
    from .test_torch_icon_diffusion import PROGRAM, config, fields_of

    cfg = config()
    kwargs, provider = PROGRAM.operands(cfg, fields_of(cfg))
    step = PROGRAM.make_program("cuda:hopper")
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(**kwargs, offset_provider=provider)
    names = [r.name for r in spans()]
    assert "gt4py.next.program" not in names and names.count("gt4py.next.call") == 5
    program, kwargs, provider = _icon_step(monkeypatch)
    clear_spans()
    program.make_program("cuda:hopper")(**kwargs, offset_provider=provider)
    assert [r.name for r in spans() if not r.name.startswith("gt4py.build.")] == []
    rbf = program.OPERATORS[0].with_backend("cuda:hopper")
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        rbf(kwargs["vn"], kwargs["ptr_coeff_1"], kwargs["ptr_coeff_2"],
            out=(kwargs["u_vert"], kwargs["v_vert"]), offset_provider=provider)
    roots = [r for r in spans() if r.parent is None and not r.name.startswith("gt4py.build.")]
    assert [r.name for r in roots] == ["gt4py.next.call"]
