"""The port's compile stages and ``cuda:hopper:aot`` (gt4py_tpu_torch.next.
stages, backend, program_processors) — the counterpart of the JAX package's
``jax:aot`` (tests/next_tests/test_backend_assembly.py).

For a bridged operator every stage is filled: the typed definition, the
traced program (the bridge's GTIR, its text ``gtir_pretty``), the lowered
program (the generated CUDA C++) and the compiled program; the texts are
non-empty and the same for the same signature, the fingerprints stable and
distinct, dynamic keyword arguments are not baked in, and a call after
``compile()`` builds no variant and runs no ``nvcc``. An operator the
bridge refuses stops after the typed stage, with the reason, and runs
embedded. On CPU tensors nothing is built (``cost_analysis()`` is None)
and the result is the kernels' plain version's, equal to ``cuda:hopper``'s
to the bit. Tests marked ``cuda`` check the same on a card, with the launch
counts and ``format_compiled``'s report.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.next import (
    Backend,
    NamedStepSequence,
    program_processors,
    resolve_backend,
    stages,
)
from gt4py_tpu_torch.next import cartesian_bridge as bridge

from . import torch_next_defs as defs

I = gtx.Dimension("I")


@gtx.field_operator
def _dbl(a):
    return a * 2.0


@gtx.field_operator
def _scaled(a, s):
    return a * s


_HELPER_GAIN = 3.0


def _gained(a):
    return a * _HELPER_GAIN


@gtx.field_operator
def _through_helper(a):
    return _gained(a)


def _field(n=8):
    return gtx.as_field([I], np.arange(float(n)), device="cpu")


def _hdiff(device="cpu", dtype=np.float64):
    return defs.inputs("hdiff_op", 9, 8, 5, dtype, seed=2, device=device)


def test_registry_resolution():
    assert resolve_backend("cuda:hopper:aot").kind == "aot"
    assert resolve_backend("numpy").kind == "numpy"
    be = resolve_backend("torch")
    assert isinstance(be, Backend) and resolve_backend(be) is be
    with pytest.raises(ValueError, match="Unknown backend"):
        resolve_backend("no-such-backend")


def test_named_step_sequence_replace_swaps_a_step():
    @dataclasses.dataclass(frozen=True)
    class Seq(NamedStepSequence):
        one: object = staticmethod(lambda x: x + ["one"])
        two: object = staticmethod(lambda x: x + ["two"])

    assert Seq()([]) == ["one", "two"]
    assert Seq().replace(two=None)([]) == ["one"]


def test_aot_stages_of_a_bridged_operator():
    args, kwargs, out = _hdiff()
    op = defs.hdiff_op.with_backend("cuda:hopper:aot")
    job = op.compiled_job(*args, out=out, offset_provider=defs.PROV_K)
    assert job.unsupported is None
    assert isinstance(job.typed_stage, stages.TypedDefinition)
    assert isinstance(job.traced_stage, stages.TracedProgram)
    assert isinstance(job.lowered_stage, stages.LoweredProgram)
    assert isinstance(job.compiled_stage, stages.CompiledProgram)
    assert job.traced_stage.text.startswith("stencil hdiff_op {")
    assert "__global__" in job.lowered_stage.text and "gt_plane_0" in job.lowered_stage.text
    assert job.lowered_stage.strategy == defs.KERNEL["hdiff_op"][0]
    assert job.compiled_stage.library is None  # CPU tensors: nothing built
    assert job.compiled_stage.cost_analysis() is None
    fps = {job.typed_stage.fingerprint, job.traced_stage.fingerprint,
           job.lowered_stage.fingerprint}
    assert len(fps) == 3


def test_aot_texts_and_fingerprints_are_stable():
    args, kwargs, out = _hdiff()
    jobs = [
        defs.hdiff_op.with_backend("cuda:hopper:aot").compiled_job(
            *args, out=out, offset_provider=defs.PROV_K)
        for _ in range(2)
    ]
    for stage in ("traced_stage", "lowered_stage"):
        a, b = (getattr(j, stage) for j in jobs)
        assert a.text == b.text and a.fingerprint == b.fingerprint
    args32, _, out32 = _hdiff(dtype=np.float32)
    other = defs.hdiff_op.with_backend("cuda:hopper:aot").compiled_job(
        *args32, out=out32, offset_provider=defs.PROV_K)
    assert other.traced_stage.fingerprint != jobs[0].traced_stage.fingerprint
    assert other.lowered_stage.fingerprint != jobs[0].lowered_stage.fingerprint


def test_stage_fingerprints_stable_and_distinct():
    d1 = stages.OperatorDefinition(_dbl.definition)
    d2 = stages.OperatorDefinition(_dbl.definition)
    assert d1.fingerprint == d2.fingerprint
    assert stages.OperatorDefinition(_dbl.definition, static_args=(("s", 2),)).fingerprint \
        != d1.fingerprint
    assert stages.OperatorDefinition(_scaled.definition).fingerprint != d1.fingerprint


@pytest.mark.parametrize("name", ["hdiff_op", "solve_tridiag"])
def test_aot_equals_cuda_hopper_and_builds_nothing_at_the_call(name):
    """compile() runs the stages; the first call then builds no variant and
    runs no nvcc, and its result equals cuda:hopper's to the bit."""
    args, kwargs, out = defs.inputs(name, 9, 8, 5, np.float64, seed=3, device="cpu")
    _, _, want = defs.inputs(name, 9, 8, 5, np.float64, seed=3, device="cpu")
    op = getattr(defs, name).with_backend("cuda:hopper:aot")
    op.compile(*args, out=out, offset_provider=defs.PROV_K, **kwargs)
    built, runs = bridge.variants_built, cuda_backend.nvcc_runs
    op(*args, out=out, offset_provider=defs.PROV_K, **kwargs)
    assert (bridge.variants_built, cuda_backend.nvcc_runs) == (built, runs)
    assert len(op._aot_jobs) == 1
    getattr(defs, name).with_backend("cuda:hopper")(
        *args, out=want, offset_provider=defs.PROV_K, **kwargs)
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


def test_aot_dynamic_kwargs_not_baked():
    op = _scaled.with_backend("cuda:hopper:aot")
    f = gtx.as_field([I, gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)],
                     np.arange(12.0).reshape(6, 2), device="cpu")
    out = gtx.zeros(f.domain, device="cpu")
    op(f, s=3.0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 3 * np.arange(12.0).reshape(6, 2))
    op(f, s=5.0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 5 * np.arange(12.0).reshape(6, 2))
    assert len(op._aot_jobs) == 1
    job = op.compiled_job(f, s=5.0, out=out)
    assert job.traced_stage is not None and "s" in job.traced_stage.text


def test_aot_stops_after_typed_stage_for_unbridgeable_operator():
    e2v, v2e = defs.toy_mesh_tables()
    conn = gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge, v2e, device="cpu")
    e = gtx.as_field([defs.Edge], np.arange(18.0), device="cpu")
    out = gtx.zeros({defs.Vertex: 9}, device="cpu")
    op = defs.edge_sum.with_backend("cuda:hopper:aot")
    op(e, out=out, offset_provider={"V2E": conn})
    np.testing.assert_array_equal(out.asnumpy(), np.arange(18.0)[v2e].sum(axis=1))
    job = op.compiled_job(e, out=out, offset_provider={"V2E": conn})
    assert job.typed_stage is not None
    assert job.traced_stage is job.lowered_stage is job.compiled_stage is None
    assert "not cartesian" in job.unsupported


def test_compile_job_of_a_raw_function():
    f = _field()
    out = gtx.zeros({I: 8}, device="cpu")
    job = resolve_backend("cuda:hopper:aot").compile_job(lambda a: a + 1.0, f, out=out)
    assert isinstance(job.typed_stage, stages.TypedDefinition)
    assert isinstance(job.traced_stage, stages.TracedProgram)
    job.executable(f, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.arange(8.0) + 1.0)


def test_custom_rewrite_and_compile_steps_apply():
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(1)
            return fn(*a, **k)

        return wrapped

    base = resolve_backend("torch")
    custom = base.replace(name="torch:spy", transforms=base.transforms.with_rewrites(spy))
    out = gtx.zeros({I: 8}, device="cpu")
    _dbl.with_backend(custom)(_field(), out=out)
    np.testing.assert_array_equal(out.asnumpy(), 2 * np.arange(8.0))
    assert calls


def test_helper_of_the_same_module_reads_the_pinned_constants():
    """A plain function of the operator's module, called from the
    definition, reads the module constants as they were when the variant
    was built, as the JAX package's ``jax.jit`` fixes what its trace read."""
    import tests.test_torch_stages as mod

    out = gtx.zeros({I: 8}, device="cpu")
    op = _through_helper.with_backend("torch")
    op(_field(), out=out)
    np.testing.assert_array_equal(out.asnumpy(), 3 * np.arange(8.0))
    old = mod._HELPER_GAIN
    try:
        mod._HELPER_GAIN = 7.0
        op(_field(), out=out)
        np.testing.assert_array_equal(out.asnumpy(), 3 * np.arange(8.0))
    finally:
        mod._HELPER_GAIN = old


_HELPER_MODULE = """\
GAIN = 3.0


def scale(a):
    return a * GAIN


def scale_twice(a):
    return scale(a) + scale(a)
"""

_OPERATOR_MODULE = """\
import gt4py_tpu_torch.next as gtx
from {helpers} import scale_twice


@gtx.field_operator
def through_other_module(a):
    return scale_twice(a)
"""


def test_helper_of_another_module_reads_the_pinned_constants(tmp_path, monkeypatch):
    """A plain function of another user module, imported by name into the
    operator's module, reads that module's constants as they were when the
    variant was built, and so does the helper of the same module it calls
    (one snapshot a module); the module itself is left as it is."""
    import importlib

    helpers, operators = "pinned_helpers_mod", "pinned_operator_mod"
    (tmp_path / f"{helpers}.py").write_text(_HELPER_MODULE)
    (tmp_path / f"{operators}.py").write_text(_OPERATOR_MODULE.format(helpers=helpers))
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in (helpers, operators):
        monkeypatch.delitem(sys.modules, name, raising=False)
    helper_mod = importlib.import_module(helpers)
    op = importlib.import_module(operators).through_other_module.with_backend("torch")
    out = gtx.zeros({I: 8}, device="cpu")
    op(_field(), out=out)
    np.testing.assert_array_equal(out.asnumpy(), 6 * np.arange(8.0))
    monkeypatch.setattr(helper_mod, "GAIN", 7.0)
    op(_field(), out=out)
    np.testing.assert_array_equal(out.asnumpy(), 6 * np.arange(8.0))
    assert helper_mod.scale(1.0) == 7.0  # the live module reads its own rebinding


_GLOBAL_WRITER_MODULE = """\
import numpy as np
import {package}.next as gtx

I = gtx.Dimension("I")
n_built = 0


def count_build(a):
    global n_built
    n_built += 1
    return a * n_built


@gtx.field_operator
def counted(a: gtx.Field[gtx.Dims[I], np.float64]) -> gtx.Field[gtx.Dims[I], np.float64]:
    return count_build(a) * 2.0
"""


def _global_writers(tmp_path, monkeypatch) -> tuple:
    """The JAX package's and the port's copies of _GLOBAL_WRITER_MODULE,
    imported fresh, each with ``counted`` on its backend (``jax``,
    ``torch``) as ``op``: one operator, whose variants every call reuses."""
    import importlib

    monkeypatch.syspath_prepend(str(tmp_path))
    mods = []
    for package in ("gt4py_tpu", "gt4py_tpu_torch"):
        name = f"global_writer_{package}"
        (tmp_path / f"{name}.py").write_text(_GLOBAL_WRITER_MODULE.format(package=package))
        monkeypatch.delitem(sys.modules, name, raising=False)
        mods.append(importlib.import_module(name))
    ref, port = mods
    ref.op, port.op = ref.counted.with_backend("jax"), port.counted.with_backend("torch")
    return ref, port


def _call_both(ref, port, size: int) -> np.ndarray:
    """One call of each ``op`` at ``size``; their outputs must be equal."""
    values = np.arange(float(size))
    ref_out = ref.gtx.zeros({ref.I: size})
    ref.op(ref.gtx.as_field([ref.I], values), out=ref_out)
    port_out = port.gtx.zeros({port.I: size}, device="cpu")
    port.op(port.gtx.as_field([port.I], values, device="cpu"), out=port_out)
    np.testing.assert_array_equal(port_out.asnumpy(), np.asarray(ref_out.ndarray))
    return port_out.asnumpy()


def test_global_write_of_a_helper_reaches_the_module_once(tmp_path, monkeypatch):
    """A plain helper of the operator's module that writes a module global
    by ``global`` and returns a value that reads it: the JAX package's
    ``jax`` backend runs it in its trace, at the first call of a shape, so
    it writes the module once and every call computes what the trace did;
    the port's ``torch`` backend writes the helper's write back to the
    module after the variant's first run, and runs each later call from the
    snapshot as it was pinned. Two calls at one shape: the outputs and the
    module's value match after each."""
    ref, port = _global_writers(tmp_path, monkeypatch)
    for call in range(2):
        out = _call_both(ref, port, 6)
        np.testing.assert_array_equal(out, 2.0 * np.arange(6.0))
        assert port.n_built == ref.n_built == 1, call


def test_global_write_of_a_helper_at_a_new_shape(tmp_path, monkeypatch):
    """A second shape is a second variant in both packages: it reads the
    module as the first variant left it (1), writes 2 back, and keeps
    computing with 2; the first shape keeps computing with 1."""
    ref, port = _global_writers(tmp_path, monkeypatch)
    _call_both(ref, port, 6)
    for call in range(2):
        np.testing.assert_array_equal(_call_both(ref, port, 5), 4.0 * np.arange(5.0))
        assert port.n_built == ref.n_built == 2, call
    np.testing.assert_array_equal(_call_both(ref, port, 6), 2.0 * np.arange(6.0))
    assert port.n_built == ref.n_built == 2


def test_only_user_modules_are_pinned():
    """The port's, torch's, numpy's, the standard library's and installed
    packages' functions keep their live globals (the port's builtins keep
    their identity for the bridge's tracer)."""
    import os.path

    from gt4py_tpu_torch.next import backend

    assert backend._user_module(globals())
    for fn in (gtx.field_operator, torch.where, np.where, os.path.join, pytest.raises):
        assert not backend._user_module(getattr(fn, "__globals__", {"__name__": fn.__module__}))


def test_ptxas_report_parses_the_build_log():
    log = (
        "ptxas info    : Compiling entry function '_Z10gt_plane_07GtParams' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z10gt_plane_07GtParams\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 384 bytes cmem[0], 16 bytes smem\n"
    )
    assert stages.ptxas_report(log) == {"gt_plane_0": {
        "registers": 40, "spill_store_bytes": 8, "spill_load_bytes": 4,
        "static_shared_bytes": 16}}


def test_program_processors_render_the_stages():
    args, _, out = _hdiff()
    gtir = program_processors.format_gtir(defs.hdiff_op, *args, out=out,
                                          offset_provider=defs.PROV_K)
    assert gtir.startswith("stencil hdiff_op {") and "computation(PARALLEL)" in gtir
    cuda = program_processors.format_cuda(defs.hdiff_op, *args, out=out,
                                          offset_provider=defs.PROV_K)
    assert "extern \"C\" int gt_launch_0" in cuda
    e = gtx.as_field([defs.Edge], np.arange(18.0), device="cpu")
    conn = gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge,
                               defs.toy_mesh_tables()[1], device="cpu")
    with pytest.raises(bridge.BridgeUnsupported, match="not cartesian"):
        program_processors.format_gtir(defs.edge_sum, e, out=gtx.zeros({defs.Vertex: 9},
                                                                       device="cpu"),
                                       offset_provider={"V2E": conn})


def test_format_compiled_names_the_missing_tool():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args, _, out = _hdiff()
    with pytest.raises(RuntimeError, match="nvcc"):
        program_processors.format_compiled(defs.hdiff_op, *args, out=out,
                                           offset_provider=defs.PROV_K)


# --- on the card ---------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hdiff_op", "solve_tridiag"])
def test_aot_first_call_on_card_builds_nothing_and_launches_its_kernel(name):
    _need_card()
    args, kwargs, out = defs.inputs(name, 64, 64, 16, np.float32, seed=3)
    _, _, want = defs.inputs(name, 64, 64, 16, np.float32, seed=3)
    op = getattr(defs, name).with_backend("cuda:hopper:aot")
    op.compile(*args, out=out, offset_provider=defs.PROV_K, **kwargs)
    job = op.compiled_job(*args, out=out, offset_provider=defs.PROV_K, **kwargs)
    assert job.compiled_stage.library is not None
    assert job.compiled_stage.cost_analysis()
    for w in cuda_backend.WRAPPERS.values():
        w.launches = 0
    built, runs = bridge.variants_built, cuda_backend.nvcc_runs
    op(*args, out=out, offset_provider=defs.PROV_K, **kwargs)
    torch.cuda.synchronize()
    assert (bridge.variants_built, cuda_backend.nvcc_runs) == (built, runs)
    kernel = job.lowered_stage.strategy
    module = job.lowered_stage.module
    launches = {k: w.launches for k, w in cuda_backend.WRAPPERS.items() if w.launches}
    # solve_tridiag's scans run as one on-chip pair (counted as one launch)
    assert launches == {kernel: module.kernels_per_call(16, True)}
    getattr(defs, name).with_backend("cuda:hopper")(
        *args, out=want, offset_provider=defs.PROV_K, **kwargs)
    assert torch.equal(out.ndarray, want.ndarray)


@pytest.mark.cuda
def test_format_compiled_reports_the_kernel():
    _need_card()
    args, _, out = defs.inputs("hdiff_op", 32, 32, 8, np.float32, seed=3)
    text = program_processors.format_compiled(defs.hdiff_op, *args, out=out,
                                              offset_provider=defs.PROV_K)
    assert "gt_plane_0" in text and "registers" in text
