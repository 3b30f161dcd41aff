"""The port's cartesian path against the JAX package, on the CPU.

Every stencil runs through the port's ``torch`` backend and its
``cuda:hopper`` backend (CPU tensors: the plain version) on inputs made
with ``np.random.default_rng(seed)``, and every field — written ones
included, halo points included — is compared with:

1. the JAX package's ``numpy`` backend in float64, exactly (rtol 1e-12);
2. its ``tpu:pallas`` backend in interpret mode in float32 (as
   tests/cartesian_tests/test_pallas_backend.py runs it), at rtol 1e-5 and
   atol 1e-6: both sides compute in float32, but XLA may fuse a product and
   a sum into one rounding and orders nothing else differently, so the
   results differ by a few ulp, growing along the 8-level recurrences;
3. both in float16, at rtol = atol = 1e-2 (the JAX package's float16
   tolerance, tests/cartesian_tests/test_upcasting_matrix.py): the plain
   version and the ``numpy`` backend round every operation to half, K1
   computes half fields in float32 and rounds once, at the store.

Data crosses between the packages only as NumPy arrays.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu import storage as ref_storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript as port_gtscript

from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs

PORT_BACKENDS = ["torch", "cuda:hopper"]
HALO = 2
F32_RTOL, F32_ATOL = 1e-5, 1e-6


def _shape(entry):
    return (12 + 2 * HALO, 11 + 2 * HALO, max(6, entry["min_k"]))


def _inputs(names, shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {n: rng.random(shape).astype(dtype) for n in names}


def _field_names(stencil):
    return [n for n, info in stencil.field_info.items() if info is not None]


# --- JAX twins of the port-only definitions ------------------------------------


def _ref_hdiff_sponge(
    in_field: "gtscript.Field['dt']",
    out_field: "gtscript.Field['dt']",
    coeff: "gtscript.Field[gtscript.IJ, 'dt']",
    damp: "gtscript.Field[gtscript.K, 'dt']",
):
    """hdiff as three PARALLEL computations handing temporaries on (the
    Laplacian, the limited fluxes, the update), with a diffusion coefficient
    that varies only in the horizontal and a vertical sponge profile."""
    with computation(PARALLEL), interval(...):
        lap = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
    with computation(PARALLEL), interval(...):
        res = lap[1, 0, 0] - lap[0, 0, 0]
        flx = 0.0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap[0, 1, 0] - lap[0, 0, 0]
        fly = 0.0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
    with computation(PARALLEL), interval(...):
        out_field = in_field[0, 0, 0] - coeff[0, 0] * damp[0] * (
            flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
        )


def _ref_smoothed_column_sum(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    """A FORWARD sweep that couples neighbouring columns at every level: a
    damped running sum ``acc`` and, in ``out``, the running sum of its
    4-neighbour mean."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = 0.25 * (acc[1, 0, 0] + acc[-1, 0, 0] + acc[0, 1, 0] + acc[0, -1, 0])
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -1]
            out = out[0, 0, -1] + 0.25 * (
                acc[1, 0, 0] + acc[-1, 0, 0] + acc[0, 1, 0] + acc[0, -1, 0]
            )


Field3D = gtscript.Field[np.float64]


def _ref_read_ahead_sweep(inp: Field3D, out: Field3D, out2: Field3D):
    """A FORWARD loop that reads the field it writes at its own level and
    one level ahead of the walk (both its values from before the loop), and
    a BACKWARD loop carrying the result down."""
    with computation(FORWARD):
        with interval(0, -1):
            out = inp + 0.5 * (out + out[0, 0, 1])
        with interval(-1, None):
            out = inp + 0.5 * out
    with computation(BACKWARD):
        with interval(-1, None):
            out2 = out
        with interval(0, -1):
            out2 = out + 0.25 * out2[0, 0, 1]


def _ref_restarted_temporary(inp: Field3D, out: Field3D):
    """A temporary carried up a FORWARD walk that sections 1 and 2 do not
    write (it reads 0 at their levels, and its carry restarts from 0), then
    written only where ``inp > 0.5``."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = acc
        with interval(1, 3):
            out = acc[0, 0, -1] + inp
        with interval(3, None):
            if inp > 0.5:
                acc = acc[0, 0, -1] + inp
            out = acc + out[0, 0, -1]


def _ref_narrow_offset_read(inp: Field3D, wind: Field3D, out: Field3D):
    """A FORWARD loop whose columns are widened by ``flux``, which the later
    loop reads at a horizontal offset, while the narrower ``adv`` reads
    ``wind`` at ``i + 1``: at the widened columns that read would leave
    wind's allocation, so only ``adv``'s columns may copy it."""
    with computation(FORWARD):
        with interval(0, 1):
            flux = inp
            adv = wind[1, 0, 0] - wind[0, 0, 0]
        with interval(1, None):
            flux = inp + 0.5 * flux[0, 0, -1]
            adv = wind[1, 0, 0] - wind[0, 0, 0] + 0.5 * adv[0, 0, -1]
    with computation(PARALLEL), interval(...):
        out = flux[1, 0, 0] + flux[-1, 0, 0] + adv


JAX_TWINS = {
    "hdiff_sponge": _ref_hdiff_sponge,
    "smoothed_column_sum": _ref_smoothed_column_sum,
    "read_ahead_sweep": _ref_read_ahead_sweep,
    "restarted_temporary": _ref_restarted_temporary,
    "narrow_offset_read": _ref_narrow_offset_read,
}


def _ref_lagged_neighbour_sweep(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = acc
        with interval(1, None):
            lag = acc[1, 0, -1]
            acc = inp + 0.5 * lag
            out = acc


def _ref_lag_read_before_write(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            out = acc[1, 0, -1] + acc[0, -1, -1]
            acc = inp * 2.0


#: sweeps reading an earlier level beyond the points its writers compute,
#: which the port's tiled kernel serves with one launch per level: the
#: port's definition and its JAX twin
LAGGED_SWEEPS = {
    "lagged_neighbour_sweep": (defs.lagged_neighbour_sweep, _ref_lagged_neighbour_sweep),
    "lag_read_before_write": (defs.lag_read_before_write, _ref_lag_read_before_write),
}


def _reference_definition(name):
    return JAX_TWINS[name] if name in defs.PORT_ONLY else getattr(ref_defs, name)


def _run_reference(name, entry, host, shape):
    st = gtscript.stencil(
        backend="numpy", definition=_reference_definition(name),
        externals=entry["externals"], dtypes=entry.get("dtypes", {}),
    )
    arrays = {n: v.copy() for n, v in host.items()}
    st(**arrays, **entry["scalars"], origin=(HALO, HALO, 0),
       domain=(shape[0] - 2 * HALO, shape[1] - 2 * HALO, shape[2]))
    return arrays


def test_registry_covers_the_jax_registry():
    """Every stencil of the JAX package's registry has its port, pinned to
    a Hopper kernel."""
    assert set(ref_defs.REGISTRY) <= set(defs.REGISTRY)
    assert set(defs.REGISTRY) - set(ref_defs.REGISTRY) == set(defs.PORT_ONLY)


def _as_kind(value, kind, backend):
    if kind == "numpy":
        return value.copy()
    if kind == "tensor":
        return torch.from_numpy(value.copy())
    return storage.from_array(value, backend=backend, device="cpu")


def _to_numpy(value):
    return np.asarray(value) if not isinstance(value, torch.Tensor) else value.numpy()


@pytest.mark.parametrize("kind", ["storage", "numpy", "tensor"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_matches_numpy_backend_exactly(name, backend, kind):
    entry = defs.REGISTRY[name]
    shape = _shape(entry)
    st = port_gtscript.stencil(
        backend=backend, definition=entry["definition"], externals=entry["externals"],
        dtypes=entry["dtypes"],
    )
    host = defs.make_inputs(st.field_info, shape, np.random.default_rng(3))
    expected = _run_reference(name, entry, host, shape)
    args = {n: _as_kind(v, kind, backend) for n, v in host.items()}
    info = {}
    st(**args, **entry["scalars"], origin=(HALO, HALO, 0),
       domain=(shape[0] - 2 * HALO, shape[1] - 2 * HALO, shape[2]), exec_info=info)
    assert info["kernel_strategy"] == "plain"
    for n in host:
        got = _to_numpy(args[n])
        if np.issubdtype(host[n].dtype, np.floating):
            np.testing.assert_allclose(got, expected[n], rtol=1e-12, atol=0, err_msg=n)
        else:
            np.testing.assert_array_equal(got, expected[n], err_msg=n)


# --- float32 against the Pallas kernels in interpret mode ----------------------
#
# JAX-side float32 definitions of hdiff and tridiag (stencil_defs.py has
# float64 ones, plus the generic vadv used here as is).


def _ref_hdiff_generic(
    in_field: "gtscript.Field['dt']",
    out_field: "gtscript.Field['dt']",
    coeff: "gtscript.Field['dt']",
):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0.0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0.0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


def _ref_tridiag_generic(
    inf: "gtscript.Field['dt']",
    diag: "gtscript.Field['dt']",
    sup: "gtscript.Field['dt']",
    rhs: "gtscript.Field['dt']",
    out: "gtscript.Field['dt']",
):
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


F32_CASES = {
    "hdiff": {
        "port": defs.horizontal_diffusion_generic,
        "ref": _ref_hdiff_generic,
        "externals": {},
        "scalars": {},
        "shape": (20, 19, 4),
        "origin": (2, 2, 0),
        "domain": (16, 15, 4),
    },
    "vadv": {
        "port": defs.vertical_advection_dycore_generic,
        "ref": ref_defs.vertical_advection_dycore_generic,
        "externals": defs.VADV_EXTERNALS,
        "scalars": {"dtr_stage": np.float32(0.15)},
        "shape": (7, 6, 8),
        "origin": (0, 0, 0),
        "domain": (6, 6, 8),
    },
    "tridiag": {
        "port": defs.tridiagonal_solver_generic,
        "ref": _ref_tridiag_generic,
        "externals": {},
        "scalars": {},
        "shape": (8, 9, 8),
        "origin": (0, 0, 0),
        "domain": (8, 9, 8),
    },
    # K2 (the JAX package's "plane" strategy) and K3 ("staged") as reference
    "hdiff_sponge": {
        "port": defs.hdiff_sponge,
        "ref": _ref_hdiff_sponge,
        "externals": {},
        "scalars": {},
        "shape": (20, 19, 8),
        "origin": (2, 2, 0),
        "domain": (16, 15, 8),
        "pallas_strategy": "plane",
    },
    "smoothed_column_sum": {
        "port": defs.smoothed_column_sum,
        "ref": _ref_smoothed_column_sum,
        "externals": {},
        "scalars": {},
        "shape": (20, 19, 8),
        "origin": (2, 2, 0),
        "domain": (16, 15, 8),
        "pallas_strategy": "staged",
    },
    **{
        name: {
            "port": port,
            "ref": ref,
            "externals": {},
            "scalars": {},
            "shape": (20, 19, 8),
            "origin": (2, 2, 0),
            "domain": (16, 15, 8),
            "pallas_strategy": "staged",
        }
        for name, (port, ref) in LAGGED_SWEEPS.items()
    },
}

_F32_OPTS = dict(
    dtypes={"dt": np.float32, "vadv_dt": np.float32},
    literal_float_precision=32,
    literal_int_precision=32,
)


def _f32_host(case, stencil):
    if "pallas_strategy" in case:  # lower-dimensional fields
        host = defs.make_inputs(stencil.field_info, case["shape"], np.random.default_rng(5))
        return {n: v.astype(np.float32) for n, v in host.items()}
    host = _inputs(_field_names(stencil), case["shape"], seed=5, dtype=np.float32)
    if "diag" in host:  # diagonally dominant system
        host["diag"] = host["diag"] + np.float32(4.0)
        host["inf"], host["sup"] = -host["inf"], -host["sup"]
    if "wcon" in host:  # pivots away from zero
        host["wcon"] = host["wcon"] * np.float32(0.1)
    return host


@pytest.fixture(scope="module")
def pallas_results():
    """The JAX package's tpu:pallas backend, interpret mode, float32."""
    out = {}
    for key, case in F32_CASES.items():
        st = gtscript.stencil(
            backend="tpu:pallas", definition=case["ref"], externals=case["externals"],
            rebuild=True, **_F32_OPTS,
        )
        host = _f32_host(case, st)
        arrays = {n: v.copy() for n, v in host.items()}
        info = {}
        st(**arrays, **case["scalars"], origin=case["origin"], domain=case["domain"],
           exec_info=info)
        out[key] = (host, arrays, info.get("pallas_strategy"))
    return out


@pytest.mark.parametrize(
    "key", ["hdiff_sponge", "smoothed_column_sum", *sorted(LAGGED_SWEEPS)]
)
def test_jax_serves_full_width_definitions_with_pallas(key, pallas_results):
    """The JAX package runs the port-only definitions through a Pallas
    kernel: hdiff_sponge through K2 (``plane``), smoothed_column_sum and the
    lagged sweeps through K3 (``staged``)."""
    assert pallas_results[key][2] == F32_CASES[key]["pallas_strategy"]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("key", sorted(F32_CASES))
def test_matches_pallas_interpret_float32(key, backend, pallas_results):
    case = F32_CASES[key]
    host, expected, _ = pallas_results[key]
    st = port_gtscript.stencil(
        backend=backend, definition=case["port"], externals=case["externals"], **_F32_OPTS
    )
    fields = {n: storage.from_array(v, backend=backend, device="cpu") for n, v in host.items()}
    st(**fields, **case["scalars"], origin=case["origin"], domain=case["domain"])
    for n in host:
        got = np.asarray(fields[n])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, expected[n], rtol=F32_RTOL, atol=F32_ATOL, err_msg=n)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", sorted(LAGGED_SWEEPS))
def test_lagged_sweeps_match_numpy_backend_exactly(name, backend):
    """Served on the card by tiled, one launch per level; here the plain
    version, against the JAX numpy backend in float64."""
    port, ref = LAGGED_SWEEPS[name]
    opts = dict(dtypes={"dt": np.float64})
    st = port_gtscript.stencil(backend=backend, definition=port, **opts)
    if backend == "cuda:hopper":
        assert st._backend.strategy == "tiled"
    host = _inputs(["inp", "out"], (20, 19, 9), seed=8)
    expected = {n: v.copy() for n, v in host.items()}
    gtscript.stencil(backend="numpy", definition=ref, **opts)(
        **expected, origin=(2, 2, 0), domain=(16, 15, 9)
    )
    fields = {n: storage.from_array(v, backend=backend, device="cpu") for n, v in host.items()}
    st(**fields, origin=(2, 2, 0), domain=(16, 15, 9))
    for n in host:
        np.testing.assert_allclose(np.asarray(fields[n]), expected[n], rtol=1e-12, atol=0, err_msg=n)


# --- K4: the stage-fusion switch ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(defs.FUSED_STAGES))
def test_fused_stages_match_numpy_backend_exactly(name, monkeypatch):
    """With the switch on, K4's class is pinned to fused_column. The CPU
    tensors here run the plain version, which this holds against the JAX
    numpy backend in float64; fused_column itself is held against the plain
    version by the ``cuda``-marked tests and chip_smoke.py on the card."""
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1")
    entry = defs.REGISTRY[name]
    shape = _shape(entry)
    st = port_gtscript.stencil(
        backend="cuda:hopper", definition=entry["definition"], externals=entry["externals"],
        dtypes=entry["dtypes"],
    )
    assert st._backend.strategy == defs.FUSED_STAGES[name]
    host = defs.make_inputs(st.field_info, shape, np.random.default_rng(12))
    expected = _run_reference(name, entry, host, shape)
    fields = {n: storage.from_array(v, backend="cuda:hopper", device="cpu") for n, v in host.items()}
    st(**fields, **entry["scalars"], origin=(HALO, HALO, 0),
       domain=(shape[0] - 2 * HALO, shape[1] - 2 * HALO, shape[2]))
    for n in host:
        np.testing.assert_allclose(np.asarray(fields[n]), expected[n], rtol=1e-12, atol=0, err_msg=n)


@pytest.mark.parametrize("key", ["vadv", "tridiag"])
def test_matches_k4_interpret_float32(key, monkeypatch):
    """The JAX package's K4 (``pallas_seq._build_fused_call``, interpret
    mode, GT4PY_PALLAS_FUSE_STAGES=1), which no test of that package
    reaches, against the port's plain version, every field in float32. The
    port is built with its switch on and pinned to fused_column, but CPU
    tensors run the plain version; fused_column is held against that on
    the card (the ``cuda``-marked tests and chip_smoke.py)."""
    from gt4py_tpu.cartesian.backend import pallas_seq

    built = []
    build_fused_call = pallas_seq._build_fused_call

    def counting(*args, **kwargs):
        built.append(build_fused_call(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(pallas_seq, "_build_fused_call", counting)
    monkeypatch.setenv("GT4PY_PALLAS_FUSE_STAGES", "1")
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1")
    case = F32_CASES[key]
    k4 = gtscript.stencil(
        backend="tpu:pallas", definition=case["ref"], externals=case["externals"],
        rebuild=True, **_F32_OPTS,
    )
    host = _f32_host(case, k4)
    expected = {n: v.copy() for n, v in host.items()}
    info = {}
    k4(**expected, **case["scalars"], origin=case["origin"], domain=case["domain"],
       exec_info=info)
    assert built and info["pallas_strategy"] == "staged"
    st = port_gtscript.stencil(
        backend="cuda:hopper", definition=case["port"], externals=case["externals"], **_F32_OPTS
    )
    assert st._backend.strategy == "fused_column"
    fields = {n: storage.from_array(v, backend="cuda:hopper", device="cpu") for n, v in host.items()}
    st(**fields, **case["scalars"], origin=case["origin"], domain=case["domain"])
    for n in host:
        got = np.asarray(fields[n])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, expected[n], rtol=F32_RTOL, atol=F32_ATOL, err_msg=n)


# --- chain ------------------------------------------------------------------------

CHAIN_CASES = {
    "horizontal_diffusion": {"in_field": "out_field", "out_field": "in_field"},
    "tridiagonal_solver": {"rhs": "out", "out": "rhs"},
    "vertical_advection_dycore": {},
}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_matches_three_reference_calls(name, backend):
    entry = defs.REGISTRY[name]
    swap = CHAIN_CASES[name]
    shape = _shape(entry)
    domain = (shape[0] - 2 * HALO, shape[1] - 2 * HALO, shape[2])
    st = port_gtscript.stencil(
        backend=backend, definition=entry["definition"], externals=entry["externals"]
    )
    host = _inputs(_field_names(st), shape, seed=9)
    if "diag" in host:
        host["diag"] = host["diag"] + 4.0

    ref = gtscript.stencil(
        backend="numpy", definition=getattr(ref_defs, name), externals=entry["externals"]
    )
    roles = {n: v.copy() for n, v in host.items()}
    for _ in range(3):
        ref(**roles, **entry["scalars"], origin=(HALO, HALO, 0), domain=domain)
        roles = {r: roles[swap.get(r, r)] for r in roles}

    fields = {
        n: storage.from_array(v, backend=backend, device="cpu", aligned_index=(HALO, HALO, 0))
        for n, v in host.items()
    }
    info = {}
    st.chain(3, **fields, **entry["scalars"], swap=swap, domain=domain, exec_info=info)
    assert info["kernel_strategy"] == "plain"
    for n in host:
        np.testing.assert_allclose(np.asarray(fields[n]), roles[n], rtol=1e-12, atol=0, err_msg=n)


def test_chain_zero_steps_changes_nothing():
    entry = defs.REGISTRY["horizontal_diffusion"]
    st = port_gtscript.stencil(backend="torch", definition=entry["definition"])
    host = _inputs(["in_field", "out_field", "coeff"], (12, 12, 3), seed=1)
    fields = {n: storage.from_array(v, aligned_index=(2, 2, 0), device="cpu") for n, v in host.items()}
    st.chain(0, **fields, swap={"in_field": "out_field", "out_field": "in_field"})
    for n in host:
        np.testing.assert_array_equal(np.asarray(fields[n]), host[n])


def test_chain_rejects_non_permutation():
    st = port_gtscript.stencil(backend="torch", definition=defs.copy_stencil)
    a = storage.zeros((4, 4, 2), device="cpu")
    b = storage.zeros((4, 4, 2), device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        st.chain(2, a, b, swap={"field_a": "field_b"})


# --- storage ------------------------------------------------------------------------


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_storage_layout_is_k_leading(backend):
    s = storage.zeros((5, 6, 7), np.float32, backend=backend, device="cpu")
    assert s.shape == (5, 6, 7)
    # (K, I, J) buffer with J contiguous, seen as (I, J, K)
    assert s.array.stride() == (6, 1, 30)
    assert s.dtype == np.float32


@pytest.mark.parametrize("fn", ["empty", "zeros", "ones"])
def test_storage_constructors(fn):
    s = getattr(storage, fn)((3, 4, 2), np.float64, aligned_index=(1, 1, 0), device="cpu")
    assert s.shape == (3, 4, 2)
    assert s.__gt_origin__ == (1, 1, 0)
    assert s.device.type == "cpu"
    if fn == "ones":
        assert np.all(np.asarray(s) == 1.0)
    elif fn == "zeros":
        assert np.all(np.asarray(s) == 0.0)


def test_storage_full_and_data_dims():
    s = storage.full((3, 4, 2, 3), 2.5, dimensions=("I", "J", "K", "0"), device="cpu")
    assert s.shape == (3, 4, 2, 3)
    assert s.__gt_dims__ == ("I", "J", "K", "0")
    assert s.array.stride()[3] == 1  # data dimension innermost
    assert np.all(np.asarray(s) == 2.5)


def test_storage_validates_arguments():
    with pytest.raises(ValueError, match="Unknown backend"):
        storage.zeros((2, 2, 2), backend="tpu:pallas")
    with pytest.raises(ValueError, match="aligned_index"):
        storage.zeros((2, 2, 2), aligned_index=(1, 1))


def test_from_array_of_reference_storage_keeps_origin_and_dims():
    """from_array turns the JAX package's state into the port's."""
    rng = np.random.default_rng(4)
    ref = ref_storage.from_array(
        rng.random((6, 5, 4)), backend="numpy", aligned_index=(1, 2, 0),
        dimensions=("I", "J", "K"),
    )
    s = storage.from_array(ref, backend="cuda:hopper", device="cpu")
    assert s.__gt_origin__ == (1, 2, 0)
    assert s.__gt_dims__ == ("I", "J", "K")
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ref))


def test_cuda_storage_needs_a_card():
    """cuda:hopper storages default to the card; with none there is no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        storage.zeros((4, 4, 4), backend="cuda:hopper")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_storage_defaults_to_the_card(backend):
    """Both backends' storages default to the card, as the JAX package's
    ``jax`` backend allocates on its accelerator; the CPU is only ever
    asked for (``device="cpu"``)."""
    from gt4py_tpu_torch.storage import layout

    assert layout.from_name(backend).device == "cuda"
    assert storage.zeros((2, 2, 2), backend=backend, device="cpu").device.type == "cpu"


def test_storage_copy_and_setitem():
    s = storage.from_array(np.arange(24.0).reshape(2, 3, 4), device="cpu")
    c = s.copy()
    s[0, 0, 0] = -1.0
    assert float(np.asarray(c)[0, 0, 0]) == 0.0
    assert float(np.asarray(s)[0, 0, 0]) == -1.0
    assert c.array.stride() == s.array.stride()


def test_written_numpy_argument_updated_in_place():
    st = port_gtscript.stencil(backend="cuda:hopper", definition=defs.copy_stencil)
    a = np.random.default_rng(2).random((4, 5, 3))
    b = np.zeros_like(a)
    st(a, b)
    np.testing.assert_array_equal(a, b)


def test_read_only_numpy_argument_rejected_for_dtype():
    st = port_gtscript.stencil(backend="torch", definition=defs.copy_stencil)
    a = np.zeros((4, 4, 2), np.float32)
    with pytest.raises(TypeError, match="dtype"):
        st(a, a.copy())


# --- float16: stored half; K1 computes it in float32 -------------------------------


def _ref_half_precision(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    with computation(PARALLEL), interval(...):
        out = inp


#: the port's float16 stencils (defs.HALF_STENCILS, one on each kernel, and
#: the copy the card once refused) and their JAX twins
HALF_TWINS = {
    "hdiff": _ref_hdiff_generic,
    "hdiff_sponge": _ref_hdiff_sponge,
    "tridiag": _ref_tridiag_generic,
    "tridiag_fused": _ref_tridiag_generic,
    "smoothed_column_sum": _ref_smoothed_column_sum,
    "half_precision": _ref_half_precision,
}


def _half_port(name):
    if name == "half_precision":
        return defs.half_precision
    return defs.HALF_STENCILS[name][0]


@pytest.fixture(scope="module")
def half_results():
    """Each float16 stencil's inputs and the JAX package's results on them,
    from its ``numpy`` backend and its ``tpu:pallas`` one in interpret mode."""
    out = {}
    for name, ref in HALF_TWINS.items():
        port = port_gtscript.stencil(
            backend="torch", definition=_half_port(name), dtypes={"dt": np.float16}
        )
        host = defs.half_inputs(port.field_info, (20, 19, 8), np.random.default_rng(5))
        results = {}
        for backend in ("numpy", "tpu:pallas"):
            st = gtscript.stencil(
                backend=backend, definition=ref, dtypes={"dt": np.float16}, rebuild=True
            )
            arrays = {n: v.copy() for n, v in host.items()}
            st(**arrays, origin=(2, 2, 0), domain=(16, 15, 8))
            results[backend] = {n: np.asarray(v) for n, v in arrays.items()}
        out[name] = (host, results)
    return out


@pytest.mark.parametrize("reference", ["numpy", "tpu:pallas"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", sorted(HALF_TWINS))
def test_half_matches_the_reference(name, backend, reference, half_results, monkeypatch):
    """float16 fields through the port's plain version against the JAX
    package, every field in float16 and within the half tolerance."""
    if name in defs.HALF_STENCILS and defs.HALF_STENCILS[name][2]:
        monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1")
    host, results = half_results[name]
    st = port_gtscript.stencil(
        backend=backend, definition=_half_port(name), dtypes={"dt": np.float16}
    )
    if backend == "cuda:hopper" and name in defs.HALF_STENCILS:
        assert st._backend.strategy == defs.HALF_STENCILS[name][1]
    fields = {n: storage.from_array(v, backend=backend, device="cpu") for n, v in host.items()}
    st(**fields, origin=(2, 2, 0), domain=(16, 15, 8))
    for n in host:
        got = np.asarray(fields[n])
        assert got.dtype == np.float16
        np.testing.assert_allclose(
            got.astype(np.float64), results[reference][n].astype(np.float64),
            rtol=defs.HALF_TOL, atol=defs.HALF_TOL, err_msg=n,
        )


# --- sweeps whose shared planes a neighbouring block could overwrite first ---------

def _ref_two_writer_sweep(inp: Field3D, mid: Field3D, out: Field3D):
    with computation(FORWARD), interval(...):
        if inp > 0.6:
            mid = 2.0 * inp
        if inp < 0.3:
            mid = inp - 1.0
        out = mid[1, 0, 0] + mid[-1, 0, 0] + mid[0, 1, 0]


def _ref_read_between_writes_sweep(inp: Field3D, mid: Field3D, out: Field3D):
    with computation(FORWARD), interval(...):
        if inp > 0.6:
            mid = 2.0 * inp
        out = mid[1, 0, 0] + mid[-1, 0, 0]
        if inp < 0.3:
            mid = inp - 1.0


def _ref_read_before_write_sweep(inp: Field3D, out: Field3D, out2: Field3D):
    with computation(FORWARD), interval(...):
        out2 = out[1, 0, 0] - out[0, -1, 0]
        out = inp + 0.5 * out2


#: the two shapes tiled once refused, as sweeps, with their JAX twins and
#: the Pallas kernel the JAX package serves each with: K3 (``staged``)
#: agrees with its numpy backend; K5 (``tiled``) serves the read before the
#: write but disagrees with its numpy backend there, so the port is held
#: against numpy alone for it
LOAD_HAZARDS = {
    "two_writer_sweep": (defs.two_writer_sweep, _ref_two_writer_sweep, "staged"),
    "read_between_writes_sweep": (
        defs.read_between_writes_sweep, _ref_read_between_writes_sweep, "staged"
    ),
    "read_before_write_sweep": (
        defs.read_before_write_sweep, _ref_read_before_write_sweep, "tiled"
    ),
}


@pytest.mark.parametrize("reference", ["numpy", "tpu:pallas"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", sorted(LOAD_HAZARDS))
def test_load_hazard_sweeps_match_the_reference(name, backend, reference):
    """Served on the card by tiled (the plane of a field read at other
    points before the level's last write is loaded from a snapshot taken
    before the launch); here the plain version, against the JAX package in
    float64."""
    port, ref, pallas = LOAD_HAZARDS[name]
    if reference == "tpu:pallas" and pallas != "staged":
        reference = "numpy"  # K5 disagrees with the numpy backend here
    st = port_gtscript.stencil(backend=backend, definition=port, dtypes={"dt": np.float64})
    if backend == "cuda:hopper":
        assert st._backend.strategy == "tiled"
    host = _inputs(_field_names(st), (14, 13, 6), seed=0)
    expected = {n: v.copy() for n, v in host.items()}
    info = {}
    gtscript.stencil(backend=reference, definition=ref, rebuild=True)(
        **expected, origin=(2, 2, 0), domain=(10, 9, 6), exec_info=info
    )
    if reference == "tpu:pallas":
        assert info["pallas_strategy"] == pallas
    fields = {n: storage.from_array(v, backend=backend, device="cpu") for n, v in host.items()}
    st(**fields, origin=(2, 2, 0), domain=(10, 9, 6))
    for n in host:
        np.testing.assert_allclose(
            np.asarray(fields[n]), np.asarray(expected[n]), rtol=1e-12, atol=0, err_msg=n
        )
