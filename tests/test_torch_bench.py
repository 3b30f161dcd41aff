"""bench_torch.py, the port's counterpart of bench.py, against bench.py.

On the CPU: each row's stencil or operator, built by bench_torch's row code
at 16×16×8 on CPU tensors (the kernels' plain version), equals the JAX
package's twin built from bench.py's own definitions (``_define_hdiff32``,
the ``stencil_defs`` vadv, and the definitions nested in ``bench.main``,
read out of bench.py's source) on its ``numpy`` backend, rtol 1e-5 in
float32 and 2e-2 in bfloat16; the byte and point counts equal bench.py's
formulae, read out of its source; ``StepTimer``'s fit gives a known slope
and intercept from a synthetic clock; the keys of ``details`` are
bench.py's ``results`` keys less the rows left out and the ``*_error``
keys, plus the port's two; the whole program runs on CPU tensors at a small
size with the card's clock and properties stood in for; and without a card
``python3 bench_torch.py`` exits 1 and prints no line. Tests marked ``cuda``
run one row each on the card against the port's ``numpy`` backend and skip
without one.
"""

import ast
import functools
import importlib.util
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO_ROOT, "bench.py")
SIZE = (16, 16, 8)
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BT = _load("bench_torch", os.path.join(REPO_ROOT, "bench_torch.py"))


@functools.lru_cache(maxsize=None)
def _bench_tree():
    with open(BENCH_PY) as f:
        src = f.read()
    tree = ast.parse(src)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return src, main


#: definitions nested in bench.main that the rows port
NESTED = ("tri32", "copy48", "lap48", "next_hdiff", "nabla_x", "_b_tri_fwd", "_b_tri_bwd",
          "next_tridiag", "_b_vadv_fwd", "_b_vadv_bwd", "next_vadv_op")

#: what bench.main binds before those definitions (bench.py:162-166, :481,
#: :552-562, :679-684, :1025-1033, :1115-1125, :1578), against the JAX package
PREAMBLE = '''
from __future__ import annotations

import numpy as np

import gt4py_tpu.next as gtx
import gt4py_tpu.next as gtx2
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import computation, interval
from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where
from gt4py_tpu.next.experimental import concat_where

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))
Ioff2 = FieldOffset("Ioff", source=IDim, target=(IDim,))
Koff2 = FieldOffset("Koff", source=KDim, target=(KDim,))
V = Dimension("Vertex")
E = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))
BET_M, BET_P = 0.5, 0.5
NKC = {nk}
F32 = gtscript.Field[np.float32]
Field3F = gtscript.Field[np.float32]
'''


@functools.lru_cache(maxsize=None)
def _bench_defs(nk: int):
    """bench.main's nested definitions, read out of bench.py's source into a
    module of their own (the frontends read a definition's source) after
    ``PREAMBLE``, with ``NKC`` = ``nk``; ``tri32``'s annotations as
    bench.py:481-482 sets them."""
    src, main = _bench_tree()
    lines = src.splitlines()
    found = {}
    for node in ast.walk(main):
        if isinstance(node, ast.FunctionDef) and node.name in NESTED and node.name not in found:
            start = min([d.lineno for d in node.decorator_list] + [node.lineno])
            found[node.name] = textwrap.dedent("\n".join(lines[start - 1:node.end_lineno]))
    assert set(found) == set(NESTED)
    text = PREAMBLE.format(nk=nk) + "\n\n".join(found[n] for n in NESTED) + (
        '\n\ntri32.__annotations__ = {k: F32 for k in ("inf", "diag", "sup", "rhs", "out")}\n')
    path = os.path.join(tempfile.mkdtemp(prefix="bench_defs_"), f"bench_defs_{nk}.py")
    with open(path, "w") as f:
        f.write(text)
    name = f"bench_defs_{nk}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _bench():
    return _load("bench_reference", BENCH_PY)


# -- the rows against bench.py's definitions ---------------------------------------


def _jax_stencil(row):
    """The JAX twin of a StencilRow on the JAX ``numpy`` backend, from
    bench.py's definitions."""
    from gt4py_tpu.cartesian import gtscript as rgtscript
    from gt4py_tpu.core.definitions import bfloat16 as rbf16

    s32 = dict(literal_float_precision=32, literal_int_precision=32)
    if row.label in ("hdiff", "hdiff_bf16"):
        dtype = np.float32 if row.dtype == "float32" else rbf16
        definition = _bench()._define_hdiff32(dtype, name=row.label)
        return rgtscript.stencil(backend="numpy", definition=definition, name=row.label, **s32)
    if row.label == "vadv":
        from tests.cartesian_tests import stencil_defs as rdefs

        return rgtscript.stencil(backend="numpy", definition=rdefs.vertical_advection_dycore_generic,
                                 externals=rdefs.VADV_EXTERNALS, dtypes={"vadv_dt": np.float32},
                                 **s32)
    definition = getattr(_bench_defs(SIZE[2]), {"tridiag": "tri32"}.get(row.label, row.label))
    return rgtscript.stencil(backend="numpy", definition=definition,
                             literal_float_precision=32)


def _jax_storages(row):
    from gt4py_tpu import storage as rstorage
    from gt4py_tpu.core.definitions import bfloat16 as rbf16

    dtype = np.float32 if row.dtype == "float32" else rbf16
    return {n: rstorage.from_array(v.float().numpy().astype(dtype), backend="numpy",
                                   aligned_index=row.origin) for n, v in row.host.items()}


def _stencil_rows():
    ni, nj, nk = SIZE
    return [BT.hdiff_row("float32", ni, nj, nk), BT.hdiff_row("bfloat16", ni, nj, nk),
            BT.vadv_row(ni, nj, nk), BT.tridiag_row(ni, nj, nk), BT.small_row("copy48", nk),
            BT.small_row("lap48", nk)]


@pytest.mark.parametrize("index", range(6), ids=["hdiff", "hdiff_bf16", "vadv", "tridiag",
                                                  "copy48", "lap48"])
def test_stencil_row_equals_bench_definition(index):
    """A cartesian row's first application on ``cuda:hopper`` with CPU
    tensors (the plain version) equals bench.py's definition on the JAX
    ``numpy`` backend from the same bits, every point of the written
    fields; on a card the row is served by the kernel it names."""
    row = _stencil_rows()[index]
    assert row.build("cuda:hopper")._backend.strategy == row.kernel
    got = row.first("cuda:hopper", "cpu")
    theirs = _jax_storages(row)
    _jax_stencil(row)(**theirs, **row.scalars, origin=row.origin, domain=row.domain)
    rtol, atol = TOL[row.dtype]
    for n in row.written:
        want = np.asarray(theirs[n]).astype(np.float32)
        assert np.isfinite(got[n]).all()
        np.testing.assert_allclose(got[n], want, rtol=rtol, atol=atol)


def _to_jax(field, rgtx, dims):
    dom = rgtx.domain({dims[nr.dim.value]: (nr.unit_range.start, nr.unit_range.stop)
                       for nr in field.domain.ranges})
    return rgtx.as_field(dom, field.asnumpy())


@pytest.mark.parametrize("name", ["next_hdiff", "next_tridiag", "next_vadv"])
def test_view_row_equals_bench_definition(name):
    """A field-view row's call on ``cuda:hopper`` with CPU fields (the
    bridge's variant on its plain version) equals bench.py's operator on
    the JAX ``numpy`` backend; the variant's kernel on a card is the row's;
    its chain buffers are K-leading as a field's."""
    jd = _bench_defs(SIZE[2])
    row = getattr(BT, f"{name}_row")(*SIZE, device="cpu")
    op = row.call("cuda:hopper")
    variant = row.variant(op)
    assert variant.backend.strategy == row.kernel
    assert variant.backend.last_strategy == "plain"
    dims = {d.value: d for d in (jd.IDim, jd.JDim, jd.KDim)}
    ref_args = tuple(_to_jax(a, jd.gtx, dims) if hasattr(a, "domain") else a for a in row.args)
    ref_out = _to_jax(row.out, jd.gtx, dims)
    ref_op = jd.next_vadv_op if name == "next_vadv" else getattr(jd, name)
    ref_op.with_backend("numpy")(*ref_args, out=ref_out,
                                 offset_provider={"Ioff": jd.IDim, "Joff": jd.JDim,
                                                  "Koff": jd.KDim})
    np.testing.assert_allclose(row.out.asnumpy(), ref_out.asnumpy(), rtol=1e-5, atol=0)
    for t in row.chain_buffers(variant, "cpu").values():
        assert t.stride()[1] == 1 and t.stride()[2] == t.shape[0] * t.shape[1]


def _renumbered(e2v, v2e, signs):
    """bench.py:754-761's renumbering of a mesh's tables."""
    nv = v2e.shape[0]
    perm_v = np.random.default_rng(3).permutation(nv)
    perm_e = np.random.default_rng(4).permutation(2 * nv)
    inv_v, inv_e = np.argsort(perm_v), np.argsort(perm_e)
    return perm_v[e2v][inv_e], perm_e[v2e][inv_v], signs[inv_v]


@pytest.mark.parametrize("renumber", [False, True], ids=["structured", "irregular"])
def test_nabla_row_equals_bench_definition(renumber):
    """The FVM nabla row on the ``torch`` backend with CPU fields, on its
    mesh (or the renumbered twin), equals bench.py's ``nabla_x`` on the JAX
    ``numpy`` backend over bench.py's mesh tables (``make_periodic_mesh``,
    renumbered as bench.py renumbers them)."""
    from tests.next_tests.test_field_ops import make_periodic_mesh

    n = 8
    jd = _bench_defs(SIZE[2])
    args, provider, out = BT.nabla_row(n, "cpu", renumber)
    got = BT.nabla_first(n, "torch", "cpu", renumber)
    e2v, v2e, signs = make_periodic_mesh(n)
    if renumber:
        e2v, v2e, signs = _renumbered(e2v, v2e, signs)
    np.testing.assert_array_equal(provider["E2V"].table.numpy(), e2v)
    np.testing.assert_array_equal(provider["V2E"].table.numpy(), v2e)
    np.testing.assert_array_equal(args[2].asnumpy(), signs.astype(np.float32))
    rprov = {"E2V": jd.gtx.as_connectivity([jd.E, jd.E2VDim], jd.V, e2v),
             "V2E": jd.gtx.as_connectivity([jd.V, jd.V2EDim], jd.E, v2e)}
    pp, s_x, sign, vol = (a.asnumpy() for a in args)
    ref_out = jd.gtx.zeros({jd.V: n * n}, dtype=np.float32)
    jd.nabla_x.with_backend("numpy")(
        jd.gtx.as_field([jd.V], pp), jd.gtx.as_field([jd.E], s_x),
        jd.gtx.as_field([jd.V, jd.V2EDim], sign), jd.gtx.as_field([jd.V], vol),
        out=ref_out, offset_provider=rprov)
    np.testing.assert_allclose(got, ref_out.asnumpy(), rtol=BT.NABLA_TOL[0], atol=BT.NABLA_TOL[1])


# -- bench.py's counts ---------------------------------------------------------------


def _bench_assignments() -> dict:
    """bench.main's assignments to a name (of a tuple of names, each), their
    expressions by name (the first of each)."""
    _, main = _bench_tree()
    out = {}
    for node in ast.walk(main):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            out.setdefault(target.id, node.value)
        elif isinstance(target, ast.Tuple) and isinstance(node.value, ast.Tuple):
            for t, v in zip(target.elts, node.value.elts):
                out.setdefault(t.id, v)
    return out


def _bench_value(name: str, **names):
    expr = ast.Expression(_bench_assignments()[name])
    return eval(compile(expr, BENCH_PY, "eval"), {}, dict(names))


@pytest.mark.parametrize("ni,nj,nk,halo", [(256, 256, 80, 2), (37, 45, 9, 1)])
def test_counts_equal_bench_formulae(ni, nj, nk, halo):
    """Every byte and point count of the rows equals bench.py's expression,
    read out of its source and evaluated at the same sizes."""
    sizes = dict(ni=ni, nj=nj, nk=nk, halo=halo)
    assert BT.hdiff_bytes(ni, nj, nk, halo) == _bench_value("hdiff_bytes", **sizes)
    assert BT.hdiff_bytes(ni, nj, nk, halo, 2) == _bench_value("bf_bytes", **sizes)
    vpoints = _bench_value("vpoints", **sizes)
    assert BT.vadv_points(ni, nj, nk) == vpoints
    assert BT.vadv_bytes(ni, nj, nk) == _bench_value("vadv_bytes", vpoints=vpoints)
    tpoints = _bench_value("tpoints", **sizes)
    assert BT.tridiag_bytes(ni, nj, nk) == _bench_value("tri_bytes", tpoints=tpoints)
    for nv in (ni * nj, 256 * 256):
        assert BT.nabla_bytes(nv) == _bench_value("nb_bytes", nv=nv)
        assert BT.nabla_bytes(nv) == _bench_value("nbb_bytes", nvb=nv)
        assert BT.gathered_rows(nv) == _bench_value("gathered_rows", nv=nv)
    shape = (ni + 2 * halo, nj + 2 * halo, nk)
    assert BT.triad_bytes(shape) == _bench_value("triad_bytes", shape=shape)
    assert (BT.NI, BT.NJ, BT.NK, BT.HALO) == tuple(
        _bench_value(n) for n in ("ni", "nj", "nk", "halo"))
    assert (BT.N48, BT.LHALO) == (_bench_value("n48"), _bench_value("lhalo"))
    assert (BT.NABLA_SMALL, BT.NABLA_BIG) == (_bench_value("nmesh"), _bench_value("nbig"))
    assert (BT.CAP_J, BT.CAP_K) == _bench_value("cap_dom")[1:]


def test_capacity_domain_fits_bf16_and_not_f32():
    """On 79 GB free: three bfloat16 buffers under 60 GB, three float32 ones
    above the free memory; J and K bench.py's, I a multiple of 256."""
    free = 79_000_000_000
    ni, nj, nk = BT.capacity_domain(free)
    points = ni * nj * nk
    assert (nj, nk) == (BT.CAP_J, BT.CAP_K) and ni % 256 == 0
    assert 7e9 <= points <= 10e9
    assert 3 * 2 * points < 60e9 and 3 * 4 * points > free


# -- the timer -------------------------------------------------------------------------


def _synthetic(monkeypatch, noise=()):
    """StepTimer's clock stood in for: a run of n steps reads
    0.3 + 0.05 n ms, plus the next of ``noise`` (0 once it runs out)."""
    from gt4py_tpu_torch.instrumentation import timing

    noise, ran = list(noise), []

    def clock(run):
        run()
        return 0.3 + 0.05 * ran[-1] + (noise.pop(0) if noise else 0.0)

    monkeypatch.setattr(timing, "_events_once", clock)
    return timing, ran


def test_fit_gives_slope_and_intercept_of_a_synthetic_clock(monkeypatch):
    timing, ran = _synthetic(monkeypatch)
    resets = []
    lines = []
    timer = timing.StepTimer(log=lines.append)
    ms = timer.measure(lambda n: (lambda: ran.append(n), lambda: resets.append(n)), "walk",
                       20, 220, trials=3)
    assert ms == pytest.approx(0.05)
    assert timer.intercept_ms["walk"] == pytest.approx(0.3)
    assert timer.spread_pct["walk"] == pytest.approx(0.0, abs=1e-9)
    assert timer.compile_times["walk"] >= 0.0
    assert ran == [20, 220] + [20, 220] * 3 and resets == ran
    assert len(lines) == 1 and lines[0].startswith("[bench] walk:")


def test_fit_is_best_of_trials_and_records_the_median_spread(monkeypatch):
    """Runs in order lo, hi (warm), then lo, hi a trial: the min-fit takes
    the smallest of each length, the spread the medians' fit."""
    noise = [0, 0, 0.4, 1.0, 0.0, 0.0, 0.2, 2.0]  # lo 0.4, 0, 0.2; hi 1.0, 0, 2.0
    timing, ran = _synthetic(monkeypatch, noise)
    timer = timing.StepTimer()
    ms = timer.measure(lambda n: (lambda: ran.append(n), None), "w", 20, 220, trials=3)
    assert ms == pytest.approx(0.05)
    med = (0.3 + 0.05 * 220 + 1.0 - (0.3 + 0.05 * 20 + 0.2)) / 200
    assert timer.spread_pct["w"] == pytest.approx((med - 0.05) / 0.05 * 100)


def test_fit_that_is_not_positive_raises():
    from gt4py_tpu_torch.instrumentation.timing import two_point_fit

    with pytest.raises(RuntimeError, match="not positive"):
        two_point_fit([5.0, 5.1], [4.0, 6.0], 20, 220)
    fit = two_point_fit([1.3], [11.3], 20, 220)
    assert fit["step_ms"] == pytest.approx(0.05) and fit["intercept_ms"] == pytest.approx(0.3)


def test_fit_takes_the_callers_clock(monkeypatch):
    """``measure(..., clock=...)``: each run read by the given clock, none
    by the CUDA events."""
    timing, ran = _synthetic(monkeypatch)
    monkeypatch.setattr(timing, "_events_once", lambda run: pytest.fail("events used"))
    clocked = []

    def clock(run):
        run()
        clocked.append(ran[-1])
        return 2.0 + 0.01 * ran[-1]

    timer = timing.StepTimer()
    ms = timer.measure(lambda n: (lambda: ran.append(n), None), "c", 64, 1088, trials=2,
                       clock=clock)
    assert ms == pytest.approx(0.01) and timer.intercept_ms["c"] == pytest.approx(2.0)
    assert clocked == [64, 1088] * 3


def test_repeat_takes_the_median_and_its_spread():
    """``repeat``: one reading to warm, then ``trials``; the median is the
    reading, its distance from the smallest in % the spread."""
    from gt4py_tpu_torch.instrumentation.timing import StepTimer, median_spread

    values = iter([9.0, 1.1, 1.0, 1.3, 1.05, 1.2])
    lines = []
    timer = StepTimer(log=lines.append)
    assert timer.repeat(lambda: next(values), "call", trials=5) == pytest.approx(1.1)
    assert timer.spread_pct["call"] == pytest.approx(10.0)
    assert timer.compile_times["call"] >= 0.0 and "call" not in timer.intercept_ms
    assert next(values, None) is None
    assert len(lines) == 1 and lines[0].startswith("[bench] call:")
    assert median_spread([2.0, 2.0, 2.0]) == (2.0, 0.0)


def test_once_times_a_warm_run(monkeypatch):
    """``once``: a warm run, then one timed run, each after its reset; ms
    a step of the timed one."""
    timing, ran = _synthetic(monkeypatch, noise=[5.0])
    resets = []
    ms = timing.StepTimer.once(lambda n: (lambda: ran.append(n), lambda: resets.append(n)), 20)
    assert ms == pytest.approx((0.3 + 0.05 * 20) / 20)
    assert ran == [20, 20] and resets == [20, 20]


@pytest.mark.parametrize("spreads,wide", [({"a": 0.4, "b": -4.99}, set()),
                                          ({"a": 5.0, "b": 1.0}, {"a"}),
                                          ({"a": -7.0, "b": 12.0}, {"a", "b"}),
                                          ({"a": float("nan")}, {"a"})])
def test_wide_spreads_fail_the_run(spreads, wide):
    assert set(BT.wide_spreads(spreads)) == wide


# -- the keys ------------------------------------------------------------------------


def _bench_keys() -> set:
    """Every key bench.main writes into ``results``, f-string keys expanded
    over the first item of each tuple their ``for`` loop walks."""
    _, main = _bench_tree()
    keys = set()

    def visit(node, loops):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and isinstance(node.iter, ast.Tuple)
                and all(isinstance(e, ast.Tuple) and isinstance(e.elts[0], ast.Constant)
                        for e in node.iter.elts)):
            values = [e.elts[0].value for e in node.iter.elts]
            loops = {**loops, node.target.elts[0].id: values}
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "results"):
            key = node.slice
            if isinstance(key, ast.Constant):
                keys.add(key.value)
            else:
                (var,) = [v.value.id for v in key.values if isinstance(v, ast.FormattedValue)]
                tail = "".join(v.value for v in key.values if isinstance(v, ast.Constant))
                keys.update(f"{value}{tail}" for value in loops[var])
        for child in ast.iter_child_nodes(node):
            visit(child, loops)

    visit(main, {})
    return keys


def test_detail_keys_are_bench_keys():
    """bench_torch's keys: bench.py's ``results`` keys, less the left-out
    rows (each with its reason) and the ``*_error`` keys, plus the port's
    two."""
    keys = _bench_keys()
    assert "tridiag_vs_chain_ceiling" in keys and "lap48_Ggps" in keys
    assert set(BT.LEFT_OUT) <= keys and all(BT.LEFT_OUT.values())
    errors = {k for k in keys if k.endswith("_error")}
    want = keys - set(BT.LEFT_OUT) - errors | set(BT.ADDED)
    assert len(BT.DETAIL_KEYS) == len(set(BT.DETAIL_KEYS))
    assert set(BT.DETAIL_KEYS) == want


def test_finite_values():
    assert BT.finite_values({"a": 1.0, "b": {"c": True, "d": "x"}})
    assert not BT.finite_values({"a": float("nan")})
    assert not BT.finite_values({}) and not BT.finite_values("") and not BT.finite_values(None)


# -- the whole program ---------------------------------------------------------------


class _Event:
    """A CUDA event stood in for: the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3 + 1e-3


def test_program_rehearsed_on_cpu(monkeypatch):
    """``Bench.run`` on CPU tensors at a small size, every kernel's plain
    version in place of the kernel (the checks expect "plain"), the card's
    clock, copy, probes' fit and properties stood in for: every row runs
    and is checked, and the line has bench.py's top-level keys and every
    key of ``details``, each finite."""
    from gt4py_tpu_torch.cartesian.backend import calibration
    from gt4py_tpu_torch.instrumentation import profiler, timing

    def fake_measure(self, make_chained, label, n_lo=20, n_hi=220, trials=5, spin=None,
                     clock=None):
        for n in (n_lo, n_hi):
            run, reset = make_chained(n)
            if reset is not None:
                reset()
            run() if clock is None else clock(run)
        self.compile_times[label], self.spread_pct[label] = 0.1, 0.5
        self.intercept_ms[label] = 0.2
        return 0.01 + 0.001 * len(self.spread_pct)

    def fake_repeat(self, reading, label, trials=5):
        self.compile_times[label], self.spread_pct[label] = 0.1, 0.5
        return reading()

    monkeypatch.setattr(timing.StepTimer, "measure", fake_measure)
    monkeypatch.setattr(timing.StepTimer, "repeat", fake_repeat)
    monkeypatch.setattr(timing, "events_ms", lambda work, n: (work(), 0.25)[1])
    monkeypatch.setattr(profiler, "spin_ms", lambda work, n=1, name="": (work(), 0.25)[1])
    monkeypatch.setattr(timing, "copy_bandwidth", lambda device="cuda": 2.9e12)
    monkeypatch.setattr(calibration, "peak_memory_Bps", lambda device="cuda": 3.352e12)
    monkeypatch.setattr(calibration, "l2_bytes", lambda device: 50 * 2 ** 20)
    monkeypatch.setattr(calibration, "fit_us",
                        lambda kind, inputs, params=(), trials=5, timer=None:
                        {"us": 10.0 + sum(params), "spread_pct": 0.5})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a CPU")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (256 * 64 * 8 * 9, 10 ** 9))
    bench = BT.Bench("cpu", size=(12, 12, 8), halo=2, n48=8, nablas=(8, 16), cap=(64, 8))
    out = bench.run()
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device", "peak_hbm_GBps",
                        "details"}
    assert out["metric"] == "hdiff_256x256x80_f32_throughput" and out["device"] == "a CPU"
    assert out["peak_hbm_GBps"] == pytest.approx(3352.0)
    details = out["details"]
    assert tuple(details) == BT.DETAIL_KEYS
    assert [k for k, v in details.items() if not BT.finite_values(v)] == []
    assert set(details["program_call_overhead"]) == {
        "stencil_call_us", "stencil_call_novalidate_us", "frozen_call_us", "chained_per_step_us",
        "chain_dispatch_us", "field_operator_call_us", "scan_call_us", "program_call_2ops_us"}
    assert details["bf16_capacity_domain"] == "256x64x8"
    assert details["next_hdiff_bridged"] is False  # CPU tensors: the plain version
    nablas = ("fvm_nabla", "fvm_nabla_irregular", "fvm_nabla_1M")
    assert set(details["fvm_nabla_host_call_us"]) == set(nablas)
    assert set(details["measurement_spread_pct"]) == {
        "hdiff", "hdiff_bf16", "vadv", "tridiag", "next_hdiff", "next_tridiag", "next_vadv",
        *nablas, "stream_triad", "stream_triad_bf16", "copy48", "lap48"}
    assert set(details["host_spread_pct"]) == {
        *(f"{n}_host_call" for n in nablas), *details["program_call_overhead"]}
    assert set(details["compile_warm_s"]) == (set(details["measurement_spread_pct"])
                                              | set(details["host_spread_pct"]))


def test_without_a_card_exits_1_and_prints_no_line():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr


# -- on the card -----------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _numpy_first(row) -> dict:
    return row.first("numpy", "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(6), ids=["hdiff", "hdiff_bf16", "vadv", "tridiag",
                                                  "copy48", "lap48"])
def test_stencil_row_on_card_equals_numpy(index):
    """A cartesian row at bench.py's size: its first application on the
    card, served by its kernel, against the port's ``numpy`` backend."""
    _need_card()
    row = [BT.hdiff_row("float32"), BT.hdiff_row("bfloat16"), BT.vadv_row(), BT.tridiag_row(),
           BT.small_row("copy48"), BT.small_row("lap48")][index]
    fields = row.storages("cuda:hopper", "cuda")
    assert row.apply(row.build("cuda:hopper"), fields) == row.kernel
    want = _numpy_first(row)
    rtol, atol = BT.ORACLE_TOL[row.dtype]
    for n in row.written:
        got = fields[n].array.float().cpu().numpy()
        np.testing.assert_allclose(got, want[n], rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["next_hdiff", "next_tridiag", "next_vadv"])
def test_view_row_on_card_equals_numpy(name):
    """A field-view row at bench.py's size: bridged onto its kernel on the
    card, against the field-view ``numpy`` backend on the host."""
    _need_card()
    row = getattr(BT, f"{name}_row")(device="cuda")
    variant = row.variant(row.call("cuda:hopper"))
    assert variant.backend.last_strategy == row.kernel
    host = getattr(BT, f"{name}_row")(device="cpu")
    host.call("numpy")
    rtol, atol = BT.ORACLE_TOL["float32"]
    np.testing.assert_allclose(row.out.asnumpy(), host.out.asnumpy(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_nabla_row_on_card_equals_numpy():
    _need_card()
    got = BT.nabla_first(BT.NABLA_SMALL, "torch", "cuda")
    want = BT.nabla_first(BT.NABLA_SMALL, "numpy", "cpu")
    np.testing.assert_allclose(got, want, rtol=BT.NABLA_TOL[0], atol=BT.NABLA_TOL[1])


@pytest.mark.cuda
def test_peak_memory_is_read_from_the_card():
    """The card's memory clock times its bus width times 2; on an H100 SXM5
    within 10 % of 3352 GB/s."""
    _need_card()
    from gt4py_tpu_torch.cartesian.backend import calibration

    peak = calibration.peak_memory_Bps("cuda")
    assert peak > 0
    if torch.cuda.get_device_name(0) == "NVIDIA H100 80GB HBM3":
        assert abs(peak / 1e9 - 3352) < 335.2


@pytest.mark.parametrize("spread", [0.4, 12.0])
def test_row_measured_once(monkeypatch, spread):
    """``Bench.measure`` reads the timer's fit once, whatever its spread:
    a wide spread fails the run at its end (``wide_spreads``), it is not
    measured again."""
    from gt4py_tpu_torch.instrumentation import timing

    attempts = []

    def fake_measure(self, make_chained, label, n_lo=20, n_hi=220, trials=5, spin=None,
                     clock=None):
        attempts.append((label, n_lo, n_hi, trials))
        self.spread_pct[label] = spread
        return 0.05

    monkeypatch.setattr(timing.StepTimer, "measure", fake_measure)
    bench = BT.Bench("cpu")
    assert bench.measure(lambda n: (None, None), "row") == pytest.approx(0.05e-3)
    assert attempts == [("row", *BT.CHAINS, BT.TRIALS)]
    assert bench.timer.spread_pct["row"] == spread
