"""Unstructured field operators on ``cuda:hopper``: the generated
gather-reduce kernel (next/unstructured_codegen.py).

On the CPU: the FVM nabla's plain reference (perfbench/reference/
fvm_pnabla.py) against the field view's ``numpy`` oracle and the ``torch``
backend; the lowering's plain version against the reference and the
oracle, skip values included; the generated source (one ``gt_neighbor_*``
kernel for every output, no edge-sized temporary, valid C++ to a host
compiler); each decline with its reason and count; the new spans on a
stand-in for the card. On the card (``-m cuda``): the kernel against the
reference at 16 x 16 x 5 and at 1,048,576 x 137, and a warm call as one
graph replay of one launch.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.instrumentation.spans import clear_spans, spans
from gt4py_tpu_torch.next import neighbor_sum, otf, where
from gt4py_tpu_torch.next import unstructured_codegen as uc

from . import neighbor_host_emulation as host
from . import torch_next_defs as defs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import spec  # noqa: E402

PROGRAM = spec.load_module(REPO, "programs", "fvm_pnabla")
REFERENCE = spec.load_module(REPO, "reference", "fvm_pnabla")
Vertex, Edge, K, V2EDim = PROGRAM.Vertex, PROGRAM.Edge, PROGRAM.K, PROGRAM.V2EDim


def config(n=16, nk=5, dtype="float32"):
    base = spec.load_json(os.path.join(REPO, "perfbench", "configs", "fvm_pnabla_1m_l137_f32.json"))
    base.update(mesh_n=n, columns=n * n, edges=2 * n * n, levels=nk, dtype=dtype)
    return base


def inputs(cfg, device="cpu", seed=5):
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (cfg["columns"], cfg["levels"])
    return {"pp": torch.rand(shape, generator=gen, device=device, dtype=dtype),
            "pnabla_M": torch.zeros(shape, device=device, dtype=dtype),
            "pnabla_P": torch.zeros(shape, device=device, dtype=dtype)}


def nabla_on(backend, cfg, device="cpu", calls=1):
    """Both components from ``backend``'s run of the program's operator."""
    state = inputs(cfg, device)
    args, out, provider = PROGRAM.operands(cfg, state)
    op = PROGRAM.pnabla.with_backend(backend)
    for _ in range(calls):
        op(*args, out=out, offset_provider=provider)
    return state, op


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


# --- the reference ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_reference_equals_the_field_view(backend, dtype):
    """The plain reference, and the operator on the ``numpy`` oracle and the
    ``torch`` backend, from the same pp, mesh and geometry at 16 x 16 x 5:
    float32 within the rounding of a sum of four terms, float64 to a few
    ulps."""
    cfg = config(dtype=dtype)
    state, _ = nabla_on(backend, cfg)
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    tol = 1e-6 if dtype == "float32" else 1e-14
    for role in ("pnabla_M", "pnabla_P"):
        assert rel_err(state[role], want[role]) <= tol


def test_reference_builds_the_programs_mesh():
    from gt4py_tpu_torch.next.mesh_utils import periodic_quad_mesh

    e2v, v2e, sign = REFERENCE.mesh(6, "cpu")
    want = periodic_quad_mesh(6)
    assert np.array_equal(e2v.numpy(), want[0]) and np.array_equal(v2e.numpy(), want[1])
    assert np.array_equal(sign.numpy(), want[2])


# --- the plain version ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generated_plain_version_equals_the_reference(dtype):
    cfg = config(dtype=dtype)
    before = dict(uc.declined)
    state, op = nabla_on("cuda:hopper", cfg, calls=2)
    programs = [p for p in op._neighbor_cache.values()]
    assert len(programs) == 1 and isinstance(programs[0], uc.NeighborProgram)
    assert dict(uc.declined) == before
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    for role in ("pnabla_M", "pnabla_P"):
        assert torch.equal(state[role], want[role])


def test_aot_lowers_the_nabla():
    cfg = config()
    state = inputs(cfg)
    args, out, provider = PROGRAM.operands(cfg, state)
    op = PROGRAM.pnabla.with_backend("cuda:hopper:aot")
    op(*args, out=out, offset_provider=provider)
    job = op.compiled_job(*args, out=out, offset_provider=provider)
    assert job.traced_stage is None and "one out field" in job.unsupported
    assert isinstance(job.unstructured, uc.NeighborProgram)
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    assert torch.equal(state["pnabla_M"], want["pnabla_M"])
    job.executable(*args, out=out)
    assert torch.equal(state["pnabla_P"], want["pnabla_P"])


def _oracle(cfg, args, table):
    """Both components from the ``numpy`` oracle on CPU copies of ``args``
    (the geometry drawn on a card differs from the CPU's draw), with
    ``table`` as ``V2E``."""
    cpu = inputs(cfg)
    cargs, cout, cprovider = PROGRAM.operands(cfg, cpu)
    for c, a in zip(cargs, args):
        c.ndarray.copy_(a.ndarray)
    cprovider["V2E"].table = table.cpu()
    PROGRAM.pnabla.with_backend("numpy")(*cargs, out=cout, offset_provider=cprovider)
    return cpu


def _check_rebound_tables(backend, device):
    """``V2E`` rebound to its columns reversed, back to the first table, and
    then the first rewritten in place to the reversed one, each served
    twice: the program's merged gathers (the vertex's own value at one end
    of each of its edges) hold only for the table they were lowered
    against, so every call equals the ``numpy`` oracle, on CPU copies, and
    each table content is lowered once."""
    cfg = config()
    state = inputs(cfg, device)
    args, out, provider = PROGRAM.operands(cfg, state)
    conn = provider["V2E"]
    first = conn.table
    flipped = first.flip(1).contiguous()
    op = PROGRAM.pnabla.with_backend(backend)
    for step in ("first", "flipped", "first", "rewritten"):
        if step == "rewritten":
            first.copy_(flipped)
        else:
            conn.table = first if step == "first" else flipped
        for _ in range(2):
            op(*args, out=out, offset_provider=provider)
        cpu = _oracle(cfg, args, conn.table)
        for role in ("pnabla_M", "pnabla_P"):
            assert rel_err(state[role].cpu(), cpu[role]) <= 1e-6, (step, role)
    assert len(op._neighbor_cache) == 2


@pytest.mark.parametrize("backend", ["cuda:hopper", "cuda:hopper:aot"])
def test_rebound_and_rewritten_tables_equal_the_oracle(backend):
    _check_rebound_tables(backend, "cpu")


def test_aot_executable_serves_its_variant_and_lowers_other_tables():
    """The ahead-of-time executable runs its own program for its variant
    key (no lowering) and lowers anew for a table of other contents."""
    cfg = config()
    state = inputs(cfg)
    args, out, provider = PROGRAM.operands(cfg, state)
    job = PROGRAM.pnabla.with_backend("cuda:hopper:aot").compiled_job(
        *args, out=out, offset_provider=provider)
    lower = uc.lower
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uc, "lower", lambda *a, **k: calls.append(a) or lower(*a, **k))
        job.executable(*args, out=out)
        assert not calls
        want = REFERENCE.step({"pp": state["pp"]}, cfg)
        assert torch.equal(state["pnabla_M"], want["pnabla_M"])
        provider["V2E"].table = provider["V2E"].table.flip(1).contiguous()
        job.executable(*args, out=out)
        assert len(calls) == 1
    cpu = _oracle(cfg, args, provider["V2E"].table)
    assert rel_err(state["pnabla_P"], cpu["pnabla_P"]) <= 1e-6


def _toy(dtype, skip: bool, levels=None):
    e2v, v2e = defs.toy_mesh_tables()
    if skip:
        v2e = defs.with_skips(v2e)
    rng = np.random.default_rng(3)
    dims = [defs.Edge] if levels is None else [defs.Edge, defs.KDim]
    shape = (18,) if levels is None else (18, levels)
    e = gtx.as_field(dims, rng.random(shape).astype(dtype), device="cpu")
    conn = gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge, v2e, device="cpu",
                               skip_value=-1 if skip else None)
    out_dims = {defs.Vertex: 9} if levels is None else {defs.Vertex: 9, defs.KDim: levels}
    return e, {"V2E": conn}, lambda: gtx.zeros(out_dims, dtype, device="cpu")


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_skip_values_count_as_absent(dtype, levels):
    """``neighbor_sum`` over a V2E with every third entry missing: the plain
    version equals the oracle; the source compares each entry with the
    skip value once, before the K loop."""
    e, provider, make_out = _toy(dtype, skip=True, levels=levels)
    got, want = make_out(), make_out()
    op = defs.edge_sum.with_backend("cuda:hopper")
    op(e, out=got, offset_provider=provider)
    defs.edge_sum.with_backend("numpy")(e, out=want, offset_provider=provider)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6, atol=0)
    (program,) = op._neighbor_cache.values()
    assert program.source.count("!= -1LL") == 2 * 4  # a mask and a safe index a neighbor


def test_generated_source_is_one_kernel_for_both_outputs():
    cfg = config()
    state = inputs(cfg)
    args, out, provider = PROGRAM.operands(cfg, state)
    program = uc.lower(PROGRAM.pnabla, args, {}, out, provider)
    src = program.source
    assert re.findall(r"__global__ void __launch_bounds__\(\d+\) (\w+)\(", src) == [program.kernel]
    assert program.kernel.startswith("gt_neighbor_pnabla_")
    # every buffer is an argument, an output or a table: no edge-sized temporary
    assert re.findall(r"^\s+(?:const )?\w+(?: \w+)?\* __restrict__ (\w+);", src, re.M) == \
        ["f0", "f1", "f2", "f3", "f4", "o0", "o1", "c0", "c1"]
    assert src.count(" = p.o0 + ") == 1 and src.count(" = p.o1 + ") == 1
    # 5 levels: one trip of 16 lanes (32 would idle 27 of them)
    assert program.lanes == 16 and src.count("s0[") == 1 and src.count("s1[") == 1
    # pp read at its own row and the far end of each of its 4 edges, inside
    # the K loop: the near end of every edge is the vertex itself on this
    # mesh, so those four reads are one, and their E2V reads are gone
    assert src.count(" = p.f0 + ") == 5 and src.count(" = p.f0 + gt_h * ") == 1
    assert src.count("__ldg(p.c0 +") == 4 and src.count("__ldg(p.c1 +") == 4
    # the loads before the arithmetic (the divisions' branches would fence them)
    assert src.rindex("__ldg(b") < re.search(r"= t\w+ / t\w+;", src).start()
    assert "16 lanes an element along K" in src and "gt_h = gt_t / 16;" in src


@pytest.mark.parametrize("nk, lanes", [(2, 16), (5, 16), (16, 16), (31, 32), (32, 32), (33, 16),
                                       (48, 16), (64, 32), (80, 16), (96, 32), (100, 16),
                                       (128, 32), (137, 32), (256, 32), (300, 32)])
def test_lanes_pad_k_the_least(nk, lanes):
    """An element takes 32 lanes along K, or 16 where that pads K to fewer
    levels in whole trips and leaves the trips unrolled (at most
    MAX_TRIPS); 32 on a tie."""
    assert uc._lanes(nk) == lanes


def test_benchmark_nabla_keeps_32_lanes():
    """At the benchmark's 137 levels 32 lanes pad K the least (five trips;
    16 lanes would need nine, rolled): one warp an element, as before."""
    cfg = config(nk=137)
    args, out, provider = PROGRAM.operands(cfg, inputs(cfg))
    program = uc.lower(PROGRAM.pnabla, args, {}, out, provider)
    assert program.lanes == uc.K_LANES == 32
    assert "one warp an element, its lanes along K" in program.source


def test_generated_source_threads_along_the_horizontal_where_k_is_outer():
    e, provider, make_out = _toy(np.float32, skip=False, levels=4)
    out = make_out()  # the port's allocator: K outermost
    program = uc.lower(defs.edge_sum, (e,), {}, out, provider)
    assert program.lanes == 1


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_generated_source_compiles_as_cxx(tmp_path):
    """The kernel's C++ under a host compiler, CUDA's names stubbed (nvcc
    runs only on the card's machine)."""
    cfg = config()
    args, out, provider = PROGRAM.operands(cfg, inputs(cfg))
    src = uc.lower(PROGRAM.pnabla, args, {}, out, provider).source
    stub = ("struct gt_dim3 { unsigned x; }; static gt_dim3 blockIdx, threadIdx;\n"
            "#define __global__\n#define __launch_bounds__(n)\n"
            "template <class T> T __ldg(const T* p) { return *p; }\n"
            "typedef void* cudaStream_t; enum { cudaErrorInvalidConfiguration = 9 };\n"
            "static int cudaGetLastError() { return 0; }\n")
    src = re.sub(r"<<<[^>]*>>>", "", src.replace("#include <cuda_runtime.h>", stub))
    path = tmp_path / "kernel.cpp"
    path.write_text(src)
    out = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-Wall", "-Werror",
                          "-Wno-unknown-pragmas", str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _k_inner_toy(dtype, skip: bool, levels: int):
    """``_toy`` with ``K`` innermost in the edge field and the out (the
    layout whose lanes run along ``K``), and E2V beside V2E."""
    from gt4py_tpu_torch.next.embedded import Field

    e2v, v2e = defs.toy_mesh_tables()
    if skip:
        v2e = defs.with_skips(v2e)
    rng = np.random.default_rng(3)

    def field(dims, values):
        t = torch.from_numpy(values)
        return Field(gtx.domain({d: (0, n) for d, n in zip(dims, t.shape)}), t)

    provider = {
        "V2E": gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge, v2e, device="cpu",
                                   skip_value=-1 if skip else None),
        "E2V": gtx.as_connectivity([defs.Edge, defs.E2VDim], defs.Vertex, e2v, device="cpu"),
    }
    e = field([defs.Edge, defs.KDim], rng.random((18, levels)).astype(dtype))
    return e, provider, field([defs.Vertex, defs.KDim], np.zeros((9, levels), dtype))


E2V, V2E, V2EDim = defs.E2V, defs.V2E, defs.V2EDim


@gtx.field_operator
def _vertex_means_summed(v):
    """At each vertex, the sum over its V2E edges of the mean of the edge's
    two vertices' values."""
    mean = 0.5 * (v(E2V[0]) + v(E2V[1]))
    return neighbor_sum(mean(V2E), axis=V2EDim)


def _against_32_lanes_on_the_host(program, values, outs, scalars, provider) -> list:
    """``program``'s kernel and the 32-lane kernel of the same DAG run on the
    host (``neighbor_host_emulation``) from NaN outs, equal to the bit;
    returns the outputs."""
    import dataclasses

    twin = dataclasses.replace(program, lanes=32)
    twin.source, twin.kernel = uc.generate(twin)
    got = []
    for p in (program, twin):
        for o in outs:
            o.ndarray.fill_(float("nan"))
        assert host.launch(p, values, outs, scalars, provider) == 0
        got.append([o.ndarray.clone() for o in outs])
    assert all(torch.equal(a, b) for a, b in zip(*got))
    return got[0]


@pytest.mark.skipif(not host.available(), reason="needs a host C++ compiler")
@pytest.mark.parametrize("nk, dtype", [(2, "float32"), (33, "float64"), (80, "float32"),
                                       (80, "float64"), (100, "float32")])
def test_16_lane_kernel_on_the_host_equals_the_32_lane_kernel(nk, dtype):
    """The nabla with 16 lanes an element, run on the host, on a 7 x 7 mesh
    (49 vertices: no multiple of a block's elements) against the 32-lane
    kernel and the plain ``torch`` version, to the bit."""
    cfg = config(7, nk, dtype)
    args, out, provider = PROGRAM.operands(cfg, inputs(cfg))
    program = uc.lower(PROGRAM.pnabla, args, {}, out, provider)
    assert program.lanes == 16
    values, scalars = uc._call_values(program, uc.bind(PROGRAM.pnabla.definition, args, {}))
    got = _against_32_lanes_on_the_host(program, values, list(out), scalars, provider)
    program.run_plain(values, list(out), scalars, provider)
    assert all(torch.equal(g, o.ndarray) for g, o in zip(got, out))


@pytest.mark.skipif(not host.available(), reason="needs a host C++ compiler")
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("nk", [2, 33])
def test_16_lanes_with_skip_values_on_the_host(nk, skip):
    """E2V read through a V2E with every third entry missing, K innermost:
    an absent edge's terms are 0 with 16 lanes as with 32 and in the plain
    version, to the bit."""
    e, provider, out = _k_inner_toy(np.float64, skip, nk)
    v = gtx.as_field([defs.Vertex], np.random.default_rng(4).random(9), device="cpu")
    program = uc.lower(_vertex_means_summed, (v,), {}, out, provider)
    assert program.lanes == 16 and ("!= -1LL" in program.source) == skip
    values, scalars = uc._call_values(program, uc.bind(_vertex_means_summed.definition, (v,), {}))
    (got,) = _against_32_lanes_on_the_host(program, values, [out], scalars, provider)
    program.run_plain(values, [out], scalars, provider)
    assert torch.equal(got, out.ndarray)


# --- declines ---------------------------------------------------------------------------


@gtx.field_operator
def _mixed_dims(v, e):
    return v + e


@gtx.field_operator
def _masked(e, flag):
    return neighbor_sum(where(flag, e(defs.V2E), 0.0), axis=defs.V2EDim)


def _case(name):
    """(operator, args, out, provider, domain, the reason it is declined)."""
    e, provider, make_out = _toy(np.float64, skip=False)
    if name == "max_over":
        return defs.edge_spread, (e,), make_out(), provider, None, uc.DECLINED_BUILTIN
    if name == "where":
        flag = gtx.as_field([defs.Vertex, defs.V2EDim], np.ones((9, 4), bool), device="cpu")
        return _masked, (e, flag), make_out(), provider, None, uc.DECLINED_BUILTIN
    if name == "domain":
        return (defs.edge_sum, (e,), make_out(), provider, {defs.Vertex: (0, 4)},
                uc.DECLINED_DOMAIN)
    if name == "two_horizontal":
        v = gtx.as_field([defs.Vertex], np.ones(9), device="cpu")
        return _mixed_dims, (v, e), make_out(), provider, None, uc.DECLINED_DIMS
    if name == "skip_in_indexed_shift":
        e2v, _ = defs.toy_mesh_tables()
        conn = gtx.as_connectivity([defs.Edge, defs.E2VDim], defs.Vertex, e2v, device="cpu",
                                   skip_value=-1)
        v = gtx.as_field([defs.Vertex], np.arange(9.0), device="cpu")
        out = gtx.zeros({defs.Edge: 18}, device="cpu")
        return defs.vertex_jump, (v,), out, {"E2V": conn}, None, uc.DECLINED_SKIP
    if name == "int_fields":
        ei = gtx.as_field([defs.Edge], np.arange(18, dtype=np.int32), device="cpu")
        out = gtx.zeros({defs.Vertex: 9}, np.int32, device="cpu")
        return defs.edge_sum, (ei,), out, provider, None, uc.DECLINED_DTYPE
    raise KeyError(name)


DECLINE_CASES = ["max_over", "where", "domain", "skip_in_indexed_shift", "int_fields"]


@pytest.mark.parametrize("name", DECLINE_CASES)
def test_decline_runs_embedded_with_its_reason_counted_once(name):
    op, args, out, provider, domain, reason = _case(name)
    want = _case(name)[2]
    op.with_backend("numpy")(*args, out=want, offset_provider=provider, domain=domain)
    fresh = op.with_backend("cuda:hopper")
    before = uc.declined[reason]
    for _ in range(2):
        fresh(*args, out=out, offset_provider=provider, domain=domain)
    assert uc.declined[reason] == before + 1
    assert list(fresh._neighbor_cache.values()) == [None]
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("name", ["max_over", "where", "skip_in_indexed_shift", "int_fields"])
def test_aot_decline_reason_in_the_job(name):
    op, args, out, provider, _, reason = _case(name)
    aot = op.with_backend("cuda:hopper:aot")
    job = aot.compiled_job(*args, out=out, offset_provider=provider)
    assert job.unstructured is None and reason in job.unsupported
    assert job.traced_stage is None


def test_two_horizontal_dimensions_are_declined():
    op, args, out, provider, _, reason = _case("two_horizontal")
    before = uc.declined[reason]
    with pytest.raises(uc.Declined) as info:
        uc.lower(op, args, {}, out, provider)
    assert info.value.reason == reason and uc.declined[reason] == before + 1


def test_declines_are_known_reasons():
    assert len(set(uc.DECLINES)) == len(uc.DECLINES)
    with pytest.raises(uc.Declined) as info:
        e, provider, make_out = _toy(np.float64, skip=False)
        uc.lower(defs.edge_spread, (e,), {}, make_out(), provider)
    assert info.value.reason == uc.DECLINED_BUILTIN and "max_over" in str(info.value)


# --- spans, on a stand-in for the card ----------------------------------------------------


class _FakeGraph:
    """A stand-in for ``otf.Graph``: a replay runs the body, whose launch is
    counted as it runs, and returns the kernels it launched."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        return self.body()

    def retire(self):
        pass


def test_spans_of_a_first_and_a_warm_call(monkeypatch):
    """A key's first call launches (span ``gt4py.next.launch``, launches 1);
    its second captures and replays (``gt4py.next.launch``, launches 1); the
    next is a replay (``gt4py.next.replay``, launches 1); each a child of
    ``gt4py.next.call``; the lowering is a build span
    ``gt4py.build.codegen`` of kind ``unstructured``. The kernel's launch
    is stood in for by its plain version, counted by ``NEIGHBOR``."""

    class _Stream:
        cuda_stream = 1

    def fake_prepare(self, values, outs, scalars, providers, device):
        def launch():
            self.run_plain(values, outs, scalars, providers)
            return cuda_backend.NEIGHBOR.launch(lambda: 0, ())
        return launch

    monkeypatch.setattr(uc, "launches_on", lambda device: True)
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    monkeypatch.setattr(otf, "_stream", lambda device: _Stream())
    monkeypatch.setattr(otf, "capture", lambda device, stream, body, keeps: _FakeGraph(body))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(uc.NeighborProgram, "prepare", fake_prepare)
    cfg = config()
    state = inputs(cfg)
    args, out, provider = PROGRAM.operands(cfg, state)
    op = PROGRAM.pnabla.with_backend("cuda:hopper")
    clear_spans()
    launches = cuda_backend.NEIGHBOR.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            op(*args, out=out, offset_provider=provider)
    assert cuda_backend.NEIGHBOR.launches == launches + 3
    records = spans()
    calls = [r for r in records if r.name == "gt4py.next.call"]
    assert len(calls) == 3 and all(r.parent is None for r in calls)
    work = [r for r in records if r.name in ("gt4py.next.launch", "gt4py.next.replay")]
    assert [r.name for r in work] == ["gt4py.next.launch", "gt4py.next.launch",
                                      "gt4py.next.replay"]
    assert [r.parent for r in work] == [c.id for c in calls]
    assert all(r.attrs["launches"] == 1 for r in work)
    build = [r for r in records if r.name == "gt4py.build.codegen"]
    assert build and build[-1].attrs == {"stencil": "pnabla", "kind": "unstructured"}
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    assert torch.equal(state["pnabla_M"], want["pnabla_M"])


def test_neighbor_wrapper_is_counted_with_the_kernels():
    assert cuda_backend.WRAPPERS["neighbor"] is cuda_backend.NEIGHBOR


# --- on the card ----------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(16, 5, "float32"), (16, 5, "float64"),
                                  (1024, 137, "float32")])
def test_kernel_equals_the_reference_on_card(size):
    """The kernel against the reference on the card: each component within
    the rounding of a different order of the four-term sum."""
    _need_card()
    n, nk, dtype = size
    cfg = config(n, nk, dtype)
    before = cuda_backend.NEIGHBOR.launches
    state, _ = nabla_on("cuda:hopper", cfg, device="cuda", calls=3)
    torch.cuda.synchronize()
    assert cuda_backend.NEIGHBOR.launches == before + 3
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    tol = 1e-6 if dtype == "float32" else 1e-14
    for role in ("pnabla_M", "pnabla_P"):
        assert rel_err(state[role], want[role]) <= tol


@pytest.mark.cuda
def test_warm_call_is_one_replay_of_one_launch_on_card():
    _need_card()
    cfg = config(64, 9)
    state = inputs(cfg, "cuda")
    args, out, provider = PROGRAM.operands(cfg, state)
    op = PROGRAM.pnabla.with_backend("cuda:hopper")
    op(*args, out=out, offset_provider=provider)  # builds, launches
    op(*args, out=out, offset_provider=provider)  # captures, replays
    assert len(op._neighbor_graphs) == 1
    clear_spans()
    launches = cuda_backend.NEIGHBOR.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        op(*args, out=out, offset_provider=provider)
        torch.cuda.synchronize()
    assert cuda_backend.NEIGHBOR.launches == launches + 1
    records = spans()
    assert [(r.name, r.attrs) for r in records if r.parent is not None] == [
        ("gt4py.next.replay", {"launches": 1})]
    kernels = [e.name for e in prof.events() if e.name.startswith("gt_neighbor_")]
    assert kernels and all(k.startswith("gt_neighbor_pnabla_") for k in kernels)
    want = REFERENCE.step({"pp": state["pp"]}, cfg)
    assert rel_err(state["pnabla_P"], want["pnabla_P"]) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_skip_values_on_card(dtype, levels):
    _need_card()
    e, provider, make_out = _toy(dtype, skip=True, levels=levels)
    want = make_out()
    defs.edge_sum.with_backend("numpy")(e, out=want, offset_provider=provider)
    card = gtx.as_field(list(e.domain.dims), e.asnumpy(), device="cuda")
    conn = provider["V2E"]
    conn = gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge, conn.table.numpy(),
                               device="cuda", skip_value=-1)
    got = gtx.zeros({d: len(r.unit_range) for d, r in zip(want.domain.dims, want.domain.ranges)},
                    dtype, device="cuda")
    before = cuda_backend.NEIGHBOR.launches
    for _ in range(2):
        defs.edge_sum.with_backend("cuda:hopper")(card, out=got, offset_provider={"V2E": conn})
    torch.cuda.synchronize()
    assert cuda_backend.NEIGHBOR.launches == before + 2
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda:hopper", "cuda:hopper:aot"])
def test_rebound_and_rewritten_tables_equal_the_oracle_on_card(backend):
    """The card counterpart: a rebound table misses the graph key (a new
    index address) and an int64 table rewritten in place, whose address
    stays, misses it by its contents; both are lowered anew."""
    _need_card()
    _check_rebound_tables(backend, "cuda")


@pytest.mark.cuda
def test_table_rewritten_inside_a_capture_runs_embedded_on_card():
    """A table rewritten in place, then a call inside the caller's CUDA graph
    capture: its contents cannot be read there, so the call is declined
    (``DECLINED_CAPTURE``) and runs embedded into the capture; the replay
    equals the oracle."""
    _need_card()
    cfg = config()
    state = inputs(cfg, "cuda")
    args, out, provider = PROGRAM.operands(cfg, state)
    op = PROGRAM.pnabla.with_backend("cuda:hopper")
    for _ in range(2):
        op(*args, out=out, offset_provider=provider)
    table = provider["V2E"].table
    table.copy_(table.flip(1).contiguous())
    before = uc.declined[uc.DECLINED_CAPTURE]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        op(*args, out=out, offset_provider=provider)
    state["pnabla_M"].zero_()
    state["pnabla_P"].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert uc.declined[uc.DECLINED_CAPTURE] == before + 1
    cpu = _oracle(cfg, args, table)
    for role in ("pnabla_M", "pnabla_P"):
        assert rel_err(state[role].cpu(), cpu[role]) <= 1e-6, role


def _against_plain_on_card(op, args, out, provider) -> int:
    """One call of ``op`` on ``cuda:hopper`` against its lowered program's
    plain version on the same card fields, computed first (an in-place
    out reads its argument before the kernel writes it), to the bit, one
    call served; returns the lanes an element."""
    from gt4py_tpu_torch.next.embedded import Field

    program = uc.lower(op, args, {}, out, provider)
    values, scalars = uc._call_values(program, uc.bind(op.definition, args, {}))
    outs = list(out) if isinstance(out, tuple) else [out]
    want = [Field(o.domain, torch.full_like(o.ndarray, float("nan"))) for o in outs]
    program.run_plain(values, want, scalars, provider)
    served = uc.calls_served["neighbor"]
    op.with_backend("cuda:hopper")(*args, out=out, offset_provider=provider)
    torch.cuda.synchronize()
    for o, w in zip(outs, want):
        assert torch.equal(o.ndarray, w.ndarray), program.name
    assert uc.calls_served["neighbor"] == served + 1
    return program.lanes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nk", [1, 2, 31, 33, 80, 137])
def test_kernel_equals_the_plain_path_on_card(nk, dtype):
    """The nabla on a 7 x 7 mesh (49 vertices: no multiple of a block's
    elements) on the card, 32, 16 or 1 lanes an element as ``_lanes``
    picks, against the plain version, to the bit."""
    _need_card()
    cfg = config(7, nk, dtype)
    args, out, provider = PROGRAM.operands(cfg, inputs(cfg, "cuda"))
    lanes = _against_plain_on_card(PROGRAM.pnabla, args, out, provider)
    assert lanes == (uc._lanes(nk) if nk > 1 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
def test_16_lanes_with_skip_values_on_card(skip):
    _need_card()
    from gt4py_tpu_torch.next.embedded import Field

    _, provider, out = _k_inner_toy(np.float64, skip, 33)
    provider = {
        "V2E": gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge,
                                   provider["V2E"].table.numpy(), device="cuda",
                                   skip_value=-1 if skip else None),
        "E2V": gtx.as_connectivity([defs.Edge, defs.E2VDim], defs.Vertex,
                                   provider["E2V"].table.numpy(), device="cuda"),
    }
    out = Field(out.domain, out.ndarray.to("cuda"))
    v = gtx.as_field([defs.Vertex], np.random.default_rng(4).random(9), device="cuda")
    assert _against_plain_on_card(_vertex_means_summed, (v,), out, provider) == 16
