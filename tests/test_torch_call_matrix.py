"""Call-interface and upcasting matrices on every backend of the port.

tests/cartesian_tests/test_call_matrix.py (frozen stencils, multi-value
``gtscript.function``) and test_upcasting_matrix.py but for its seven
bfloat16 cases (those run in tests/test_torch_bfloat16.py and
tests/test_torch_cpu_backends.py), case by case, on ``torch``,
``cuda:hopper`` (CPU tensors: the plain version), ``numpy``, ``debug`` and
``cpu:c``. Each case keeps its own oracle and tolerance, and runs a second
time in the JAX package, from the same inputs, with the same definition
(its twin: the same source resolved against the JAX package's
``gtscript``): ``numpy``, ``debug`` and ``cpu:c`` on their namesakes, where
the results must be equal to the bit; ``torch`` and ``cuda:hopper`` on its
``numpy`` backend, the exact oracle, within rtol 1e-12 (torch's math may
round differently from NumPy's, never by more). As in the JAX package, the
frozen cases leave ``debug`` out.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from gt4py_tpu import storage as ref_storage
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    exp,
    interval,
    sqrt,
)
from gt4py_tpu_torch.storage import layout

from . import torch_definitions as tdefs

ALL_BACKENDS = tdefs.ALL_BACKENDS
FAST_BACKENDS = [b for b in ALL_BACKENDS if b != "debug"]
#: the JAX package's backend each port backend is held against, and how
REF_TWIN = {"numpy": "numpy", "debug": "debug", "cpu:c": "cpu:c", "torch": "numpy",
            "cuda:hopper": "numpy"}
TWIN_RTOL = 1e-12

F64 = gtscript.Field[np.float64]
F32 = gtscript.Field[np.float32]
F16 = gtscript.Field[np.float16]
I32 = gtscript.Field[np.int32]
I64 = gtscript.Field[np.int64]
Field3D = F64

#: what a definition's names mean in the JAX package
_REF_NAMES = {
    "gtscript": ref_gtscript, "computation": ref_gtscript.computation,
    "interval": ref_gtscript.interval, "PARALLEL": ref_gtscript.PARALLEL,
    "FORWARD": ref_gtscript.FORWARD, "BACKWARD": ref_gtscript.BACKWARD,
    "exp": ref_gtscript.exp, "sqrt": ref_gtscript.sqrt,
    "F64": ref_gtscript.Field[np.float64], "F32": ref_gtscript.Field[np.float32],
    "F16": ref_gtscript.Field[np.float16], "I32": ref_gtscript.Field[np.int32],
    "I64": ref_gtscript.Field[np.int64], "Field3D": ref_gtscript.Field[np.float64],
}


def twin(fn, **names):
    """``fn`` with its names resolved in the JAX package (``names``: closure
    variables and globals of its own that differ there)."""
    env = {**fn.__globals__, **_REF_NAMES, **names}
    closure = None
    if fn.__closure__:
        closure = tuple(
            types.CellType(names.get(var, cell.cell_contents))
            for var, cell in zip(fn.__code__.co_freevars, fn.__closure__)
        )
    out = types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__, closure)
    out.__annotations__ = dict(fn.__annotations__)
    return out


class Side:
    """One package's run of a case: its stencil builder and storages."""

    def __init__(self, port: bool, backend: str):
        self.port = port
        self.backend = backend if port else REF_TWIN[backend]
        self.gtscript = gtscript if port else ref_gtscript
        self._storage = storage if port else ref_storage

    def build(self, definition, **kwargs):
        if not self.port:
            definition = twin(definition, **kwargs.pop("ref_names", {}))
        kwargs.pop("ref_names", None)
        return self.gtscript.stencil(backend=self.backend, definition=definition,
                                     rebuild=True, **kwargs)

    def from_array(self, value):
        extra = {}
        if self.port and layout.from_name(self.backend).device == "cuda":
            extra["device"] = "cpu"
        return self._storage.from_array(value, backend=self.backend, **extra)


def both(backend, case):
    """Run ``case(side)`` in each package; returns (port's, JAX package's)
    results (dicts of NumPy arrays) after holding them against each other."""
    mine = case(Side(True, backend))
    theirs = case(Side(False, backend))
    for n, want in theirs.items():
        got = np.asarray(mine[n])
        if REF_TWIN[backend] == backend or got.dtype.kind not in "fc":
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=n)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=TWIN_RTOL, atol=0, err_msg=n)
    return mine


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def copy_shift(src: F64, dst: F64):
    with computation(PARALLEL), interval(...):
        dst = src[1, 0, 0]


def scalar_inputs(field_a: F64, scalar_in: float):
    with computation(PARALLEL), interval(...):
        field_a = field_a * scalar_in


def copy_stencil(field_a: F64, field_b: F64):
    with computation(PARALLEL), interval(...):
        field_b = field_a[0, 0, 0]


def tridiagonal_solver(inf: F64, diag: F64, sup: F64, rhs: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def horizontal_diffusion(in_field: F64, out_field: F64, coeff: F64):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


# --- frozen-stencil behavior matrix (test_call_matrix.py) ---------------------------


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_sequential_stencil_matches_normal_call(backend, rng):
    """freeze() on a FORWARD scan (carry dependence) must match the
    validated call exactly — geometry pre-resolution cannot change the
    K-walk (reference stencil_object.py:95)."""
    shape = (4, 5, 8)
    rhs = rng.random(shape)

    def case(side):
        st = side.build(tridiagonal_solver)
        inf, diag, sup = np.full(shape, -1.0), np.full(shape, 4.0), np.full(shape, -1.0)
        out_normal = np.zeros(shape)
        st(inf.copy(), diag.copy(), sup.copy(), rhs.copy(), out_normal,
           origin=(0, 0, 0), domain=shape)
        frozen = st.freeze(origin=(0, 0, 0), domain=shape)
        out_frozen = np.zeros(shape)
        frozen(inf=inf.copy(), diag=diag.copy(), sup=sup.copy(),
               rhs=rhs.copy(), out=out_frozen)
        return {"normal": out_normal, "frozen": out_frozen}

    got = both(backend, case)
    np.testing.assert_allclose(got["frozen"], got["normal"], rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_repeated_calls_see_mutations(backend, rng):
    """A frozen stencil is a hot-loop entry point: calling it N times must
    iterate the operator (each call reads the previous call's writes), not
    replay a captured first input."""
    shape = (9, 8, 3)
    src = rng.random(shape)

    def case(side):
        frozen = side.build(copy_shift).freeze(origin=(1, 0, 0), domain=(7, 8, 3))
        a, b = src.copy(), np.zeros(shape)
        for _ in range(3):
            frozen(src=a, dst=b)
            a, b = b, a
        return {"a": a}

    got = both(backend, case)
    ea, eb = src.copy(), np.zeros(shape)
    for _ in range(3):
        eb[1:8] = ea[2:9]  # oracle: dst[i] = src[i+1] over the domain
        ea, eb = eb, ea
    np.testing.assert_allclose(got["a"], ea, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_accepts_storages_and_ndarrays(backend, rng):
    """The frozen path takes the same duck-typed field arguments as the
    normal path: Storage and plain ndarray must agree."""
    a = rng.random((5, 4, 3))

    def case(side):
        frozen = side.build(scalar_inputs).freeze(origin=(0, 0, 0), domain=(5, 4, 3))
        buf_np = a.copy()
        frozen(field_a=buf_np, scalar_in=2.0)
        buf_st = side.from_array(a)
        frozen(field_a=buf_st, scalar_in=2.0)
        return {"ndarray": buf_np, "storage": np.asarray(buf_st)}

    got = both(backend, case)
    np.testing.assert_allclose(got["storage"], got["ndarray"], rtol=1e-12)
    np.testing.assert_allclose(got["ndarray"], a * 2.0, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_missing_field_raises_keyerror(backend):
    for side in (Side(True, backend), Side(False, backend)):
        frozen = side.build(scalar_inputs).freeze(origin=(0, 0, 0), domain=(4, 4, 2))
        with pytest.raises(KeyError):
            frozen(scalar_in=1.0)  # field_a missing


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_scalar_coercion_matches_normal(backend, rng):
    """Python ints passed for float scalar parameters coerce through the
    declared parameter dtype on the frozen path (the validated path
    rejects the mismatch by design — reference stencil_object type check)."""
    a = rng.random((4, 4, 2))

    def case(side):
        st = side.build(scalar_inputs)
        normal = a.copy()
        st(normal, 3.0, origin=(0, 0, 0), domain=(4, 4, 2))
        with pytest.raises(TypeError):
            st(a.copy(), 3, origin=(0, 0, 0), domain=(4, 4, 2))
        frozen = st.freeze(origin=(0, 0, 0), domain=(4, 4, 2))
        buf = a.copy()
        frozen(field_a=buf, scalar_in=3)  # int for a float parameter
        return {"normal": normal, "frozen": buf}

    got = both(backend, case)
    np.testing.assert_allclose(got["frozen"], got["normal"], rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_freeze_interleaves_with_normal_calls(backend, rng):
    """freeze() must not perturb the stencil object: normal-path calls
    before and after frozen calls all produce identical results (the two
    paths share backend caches keyed by geometry)."""
    shape = (12, 12, 3)
    in_field, coeff = rng.random(shape), rng.random(shape)

    def case(side):
        st = side.build(horizontal_diffusion)
        out1 = np.zeros(shape)
        st(in_field.copy(), out1, coeff.copy(), origin=(2, 2, 0), domain=(8, 8, 3))
        frozen = st.freeze(origin=(2, 2, 0), domain=(8, 8, 3))
        out2 = np.zeros(shape)
        frozen(in_field=in_field.copy(), out_field=out2, coeff=coeff.copy())
        out3 = np.zeros(shape)
        st(in_field.copy(), out3, coeff.copy(), origin=(2, 2, 0), domain=(8, 8, 3))
        return {"out1": out1, "out2": out2, "out3": out3}

    got = both(backend, case)
    np.testing.assert_allclose(got["out2"], got["out1"], rtol=1e-12)
    np.testing.assert_allclose(got["out3"], got["out1"], rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_per_field_origin_mapping(backend, rng):
    """Per-field origins freeze into full (i,j,k) tuples once; a shifted
    input origin reads a different window than the output's."""
    src = rng.random((8, 8, 2))

    def case(side):
        frozen = side.build(copy_stencil).freeze(
            origin={"field_a": (2, 1, 0), "field_b": (0, 0, 0)}, domain=(5, 5, 2)
        )
        dst = np.zeros((8, 8, 2))
        frozen(field_a=src.copy(), field_b=dst)
        return {"dst": dst}

    got = both(backend, case)
    np.testing.assert_allclose(got["dst"][0:5, 0:5], src[2:7, 1:6], rtol=1e-12)


# --- multi-value gtscript.function matrix (test_call_matrix.py) --------------------


def _split_pm(x):
    return x + 1.0, x - 1.0


def _minmax(x, y):
    lo = x if x < y else y
    hi = x if x > y else y
    return lo, hi


def _spread(lo, hi):
    return hi - lo


def _pair(x):
    return 2.0 * x, x * x


def functions(package):
    """The case's ``gtscript.function`` helpers in one package."""
    return {name: package.function(fn) for name, fn in (
        ("split_pm", _split_pm), ("minmax", _minmax), ("spread", _spread), ("pair", _pair))}


def _tuple_case(definition, inputs, out_names, **call):
    def case(side):
        st = side.build(definition, ref_names=functions(ref_gtscript))
        arrays = {n: v.copy() for n, v in inputs.items()}
        arrays.update({n: np.zeros_like(next(iter(inputs.values()))) for n in out_names})
        st(**arrays, **call)
        return {n: arrays[n] for n in out_names}

    return case


_PORT_FUNCTIONS = functions(gtscript)
split_pm, minmax, spread, pair = (_PORT_FUNCTIONS[n] for n in ("split_pm", "minmax", "spread", "pair"))


def _split(a: Field3D, p: Field3D, m: Field3D):
    with computation(PARALLEL), interval(...):
        p, m = split_pm(a)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_return_matrix(backend, rng):
    """Tuple-returning gtscript.function under every backend (reference
    gtscript_frontend multi-value returns)."""
    a = rng.random((4, 3, 2))
    got = both(backend, _tuple_case(_split, {"a": a}, ("p", "m"), origin=(0, 0, 0),
                                    domain=(4, 3, 2)))
    np.testing.assert_allclose(got["p"], a + 1.0, rtol=1e-12)
    np.testing.assert_allclose(got["m"], a - 1.0, rtol=1e-12)


def _chained(a: Field3D, b: Field3D, out: Field3D):
    with computation(FORWARD), interval(0, 1):
        lo, hi = minmax(a, b)
        out = spread(lo, hi)
    with computation(FORWARD), interval(1, None):
        lo, hi = minmax(a, b)
        out = out[0, 0, -1] + spread(lo, hi)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_chained_through_functions(backend, rng):
    """A tuple produced by one function, consumed element-wise by another,
    inside a sequential computation — inliner × scan interaction."""
    a, b = rng.random((3, 4, 5)), rng.random((3, 4, 5))
    got = both(backend, _tuple_case(_chained, {"a": a, "b": b}, ("out",), origin=(0, 0, 0),
                                    domain=(3, 4, 5)))
    np.testing.assert_allclose(got["out"], np.cumsum(np.abs(a - b), axis=2), rtol=1e-12)


def _offsets(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        d, q = pair(a)
        out = d[1, 0, 0] + q[-1, 0, 0]


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_with_offsets_at_call_site(backend, rng):
    """Tuple results assigned to temporaries are fields: reading them at an
    offset after the unpacking must see neighboring columns' values."""
    a = rng.random((6, 3, 2))
    got = both(backend, _tuple_case(_offsets, {"a": a}, ("out",), origin=(1, 0, 0),
                                    domain=(4, 3, 2)))
    np.testing.assert_allclose(got["out"][1:5], 2.0 * a[2:6] + a[0:4] ** 2, rtol=1e-12)


# --- dtype upcasting (test_upcasting_matrix.py) --------------------------------------


def _run(definition, backend, arrays, **options):
    def case(side):
        st = side.build(definition, **options)
        stores = {k: side.from_array(v) for k, v in arrays.items()}
        st(**stores)
        return {k: np.asarray(v) for k, v in stores.items()}

    return both(backend, case)


def _ipf(i32: I32, f32: F32, out: F64):
    with computation(PARALLEL), interval(...):
        out = i32 + f32  # int32 + float32 -> promoted, then cast to f64


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_plus_float_promotes(backend):
    rng = np.random.default_rng(0)
    arrays = {
        "i32": rng.integers(-5, 5, (4, 4, 2)).astype(np.int32),
        "f32": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(_ipf, backend, arrays)["out"]
    expected = (arrays["i32"] + arrays["f32"]).astype(np.float64)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def _idiv(a: I64, b: I64, out: F64):
    with computation(PARALLEL), interval(...):
        out = a / b


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_division_promotes_to_float(backend):
    rng = np.random.default_rng(1)
    arrays = {
        "a": rng.integers(1, 20, (4, 4, 2)).astype(np.int64),
        "b": rng.integers(1, 9, (4, 4, 2)).astype(np.int64),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(_idiv, backend, arrays)["out"]
    np.testing.assert_allclose(got, arrays["a"] / arrays["b"], rtol=1e-12)


def _lit32(f32: F32, out: F32):
    with computation(PARALLEL), interval(...):
        out = f32 * 2.0 + 1.0


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_literal_precision_does_not_widen_f32(backend):
    rng = np.random.default_rng(2)
    arrays = {
        "f32": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2), np.float32),
    }
    got = _run(_lit32, backend, arrays, literal_float_precision=32)["out"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, arrays["f32"] * np.float32(2.0) + np.float32(1.0), rtol=1e-6
    )


def _cmpsel(a: F64, b: F32, out: F64):
    with computation(PARALLEL), interval(...):
        out = a if a > b else b  # mixed compare + ternary promote


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_comparison_yields_bool_then_selects(backend):
    rng = np.random.default_rng(3)
    arrays = {
        "a": rng.random((4, 4, 2)),
        "b": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(_cmpsel, backend, arrays)["out"]
    expected = np.where(
        arrays["a"] > arrays["b"], arrays["a"], arrays["b"].astype(np.float64)
    )
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def _itmp(a: I32, out: I64):
    with computation(PARALLEL), interval(...):
        t = a * 2
        out = t + 1


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_temporary_keeps_int_arithmetic(backend):
    arrays = {
        "a": np.arange(32, dtype=np.int32).reshape(4, 4, 2),
        "out": np.zeros((4, 4, 2), np.int64),
    }
    got = _run(_itmp, backend, arrays)["out"]
    np.testing.assert_array_equal(got, arrays["a"].astype(np.int64) * 2 + 1)


def _sp(a: F32, out: F64, w: float):
    with computation(PARALLEL), interval(...):
        out = a * w


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_scalar_param_promotes_with_field(backend):
    rng = np.random.default_rng(4)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }

    def case(side):
        st = side.build(_sp)
        stores = {k: side.from_array(v) for k, v in arrays.items()}
        st(w=1.5, **stores)
        return {k: np.asarray(v) for k, v in stores.items()}

    got = both(backend, case)["out"]
    np.testing.assert_allclose(got, arrays["a"] * 1.5, rtol=1e-6)


def _f16(x: F16, y: F16):
    with computation(PARALLEL), interval(...):
        y = 2.0 * x + y


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_f16_roundtrip(backend):
    rng = np.random.default_rng(5)
    x = rng.random((4, 4, 2)).astype(np.float16)
    y = rng.random((4, 4, 2)).astype(np.float16)
    got = _run(_f16, backend, {"x": x, "y": y.copy()})["y"]
    assert got.dtype == np.float16
    np.testing.assert_allclose(
        got.astype(np.float32), 2.0 * x.astype(np.float32) + y.astype(np.float32),
        rtol=0.01, atol=0.01,
    )


def _transcendental(a: F64, out: F64):
    with computation(PARALLEL), interval(...):
        out = sqrt(a) + exp(a)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_transcendentals_match_jax_package(backend):
    """The math functions the bfloat16 case exercises, in float64 on every
    backend (``cpu:c``: the C library's ``sqrt`` and ``exp``)."""
    a = np.random.default_rng(7).random((4, 4, 2))
    got = _run(_transcendental, backend, {"a": a, "out": np.zeros_like(a)})["out"]
    np.testing.assert_allclose(got, np.sqrt(a) + np.exp(a), rtol=1e-12)
