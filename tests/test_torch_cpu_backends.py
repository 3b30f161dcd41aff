"""The port's CPU backends — ``numpy``, ``debug`` and ``cpu:c`` — against the
JAX package's same-named backends, on the CPU.

1. Every stencil of tests/torch_stencil_defs.py runs on each of the three
   and on the JAX package's backend of the same name, from the same inputs
   (``np.random.default_rng(3)``), and every field, halo points included,
   must be equal to the bit: in float64 through the public API on the
   port's K-leading storages, and in float32 on the stencil narrowed to
   32 bits (``testing.narrowing``), each backend called directly.
2. bfloat16 on the seven cases of test_upcasting_matrix.py, to the bit
   against the JAX package's ``numpy`` backend, which holds bfloat16 in
   ``ml_dtypes`` arrays; the port has no ``ml_dtypes`` (numpy_evaluator.py).
3. The cases of tests/cartesian_tests/test_c_backend.py on the port's
   ``cpu:c``, against the port's ``numpy`` (to the bit, or rtol 1e-14 where
   the JAX package's test says so), and the C source it renders, equal to
   the JAX package's for every registry stencil.
4. A tensor that is not on the CPU, handed to a CPU backend, raises; the
   exclusion matrix (tests/torch_definitions.py) against the code generator;
   the cache manager; the profiler's host-only trace and its refusal
   without a card.
"""

import json
import os
import re
import warnings

import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import frontend as ref_frontend
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu.cartesian.backend import REGISTRY as REF_BACKENDS
from gt4py_tpu.cartesian.passes.pipeline import analyze_gtir as ref_analyze_gtir
from gt4py_tpu.testing.narrowing import narrow_stencil as ref_narrow_stencil
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import frontend, gtscript
from gt4py_tpu_torch.cartesian.backend import REGISTRY, c_backend, c_codegen
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    Field,
    computation,
    interval,
)
from gt4py_tpu_torch.cartesian.passes.pipeline import analyze, analyze_gtir
from gt4py_tpu_torch.testing.narrowing import narrow_stencil

from . import torch_definitions as tdefs
from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs
from .test_torch_bfloat16 import CASES as BF16_CASES
from .test_torch_bfloat16 import _run_ref as run_ref_bf16
from .test_torch_cartesian import JAX_TWINS
from .test_torch_cuda_codegen import _too_wide_temporary

CPU_BACKENDS = ["numpy", "debug", "cpu:c"]
HALO = 2
#: the port's C against NumPy in float32 (two ulp): libm's sinf, expf, ...
#: and NumPy's float32 loops may round a result differently
F32_MATH_RTOL = 2.5e-7


def _reference_definition(name):
    return JAX_TWINS[name] if name in defs.PORT_ONLY else getattr(ref_defs, name)


def _domain(backend, entry):
    """The per-point ``debug`` interpreter takes a smaller domain."""
    if backend == "debug":
        return (5, 4, max(4, entry["min_k"]))
    return (12, 11, max(6, entry["min_k"]))


def _equal(got, want, name):
    np.testing.assert_array_equal(got, want, err_msg=name)


# --- 1. every registry stencil, float64 and float32, to the bit -------------------


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_float64_matches_jax_package_to_the_bit(name, backend):
    entry = defs.REGISTRY[name]
    ni, nj, nk = _domain(backend, entry)
    shape = (ni + 2 * HALO, nj + 2 * HALO, nk)
    st = gtscript.stencil(backend=backend, definition=entry["definition"],
                          externals=entry["externals"], dtypes=entry["dtypes"])
    ref = ref_gtscript.stencil(backend=backend, definition=_reference_definition(name),
                               externals=entry["externals"], dtypes=entry["dtypes"])
    host = defs.make_inputs(st.field_info, shape, np.random.default_rng(3))
    kw = dict(origin=(HALO, HALO, 0), domain=(ni, nj, nk))
    theirs = {n: v.copy() for n, v in host.items()}
    ref(**theirs, **entry["scalars"], **kw)
    mine = {n: storage.from_array(v, backend=backend) for n, v in host.items()}
    info = {}
    st(**mine, **entry["scalars"], **kw, exec_info=info)
    assert info["kernel_strategy"] == ("c" if backend == "cpu:c" else backend)
    for n in host:
        assert mine[n].device.type == "cpu"
        _equal(np.asarray(mine[n]), theirs[n], n)


def _narrowed(package, name, entry):
    """(analyzed float32 stencil, its inputs' dtypes) in one package: the
    registry stencil parsed, narrowed to 32 bits and analyzed."""
    if package == "port":
        parse, narrow, run_passes, definition = (
            frontend.parse_stencil, narrow_stencil, analyze_gtir, entry["definition"])
    else:
        parse, narrow, run_passes, definition = (
            ref_frontend.parse_stencil, ref_narrow_stencil, ref_analyze_gtir,
            _reference_definition(name))
    options = {
        "externals": dict(entry["externals"]), "dtypes": dict(entry["dtypes"]),
        "literal_float_precision": 32, "literal_int_precision": 32, "name": f"{name}_32",
    }
    return run_passes(narrow(parse(definition, options)), options)


def _origins3(analyzed):
    return {
        n: tuple(HALO if on and ax < 2 else 0 for ax, on in enumerate(info.domain_mask))
        for n, info in analyzed.field_infos.items()
        if info.access
    }


#: registry stencils with no float32 narrowing: dtype_zoo holds an int64
#: literal (123456789012345) beyond int32, and already mixes 8- to 64-bit
#: types; newton_sqrt_while iterates until its residual is within 1e-10,
#: below float32's resolution, so in float32 its loop never ends (in either
#: package)
NOT_NARROWED = ("dtype_zoo", "newton_sqrt_while")


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("name", sorted(set(defs.REGISTRY) - set(NOT_NARROWED)))
def test_float32_matches_jax_package_to_the_bit(name, backend):
    entry = defs.REGISTRY[name]
    ni, nj, nk = _domain(backend, entry)
    shape = (ni + 2 * HALO, nj + 2 * HALO, nk)
    mine_an, theirs_an = _narrowed("port", name, entry), _narrowed("ref", name, entry)
    used = {n: i for n, i in mine_an.field_infos.items() if i.access}
    host = defs.make_inputs(used, shape, np.random.default_rng(3))
    assert all(v.dtype.itemsize <= 4 for v in host.values())
    scalars = {
        n: np.asarray(v, dtype=mine_an.parameter_infos[n].dtype)[()]
        for n, v in entry["scalars"].items()
    }
    origins = _origins3(mine_an)
    theirs = {n: v.copy() for n, v in host.items()}
    ref = REF_BACKENDS[backend](theirs_an, {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX package's cpu:c warns where it falls back
        ref.run(theirs, dict(scalars), (ni, nj, nk), origins)
    mine = {n: torch.from_numpy(v.copy()) for n, v in host.items()}
    port = REGISTRY[backend](mine_an, {})
    port.run(mine, dict(scalars), (ni, nj, nk), origins)
    if getattr(ref, "last_path", None) == "numpy_fallback":
        # The JAX package renders a float32 literal as NumPy 2's repr, which
        # is no C, and runs NumPy instead (test_c_source_float32_literals_
        # compile); the port runs C, whose libm math functions may differ
        # from NumPy's float32 ones in the last bit.
        assert port.last_path == "c"
        for n in host:
            np.testing.assert_allclose(mine[n].numpy(), theirs[n], rtol=F32_MATH_RTOL,
                                       atol=0, err_msg=n)
        return
    for n in host:
        _equal(mine[n].numpy(), theirs[n], n)


# --- 2. bfloat16, to the bit ------------------------------------------------------


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_case_matches_jax_numpy_to_the_bit(case, backend):
    """The seven bfloat16 cases, equal to the bit to the JAX package's
    ``numpy`` backend (``cpu:c`` has no C type for bfloat16 and runs the
    ``numpy`` backend's path)."""
    definition, ref_definition, host, _, _ = BF16_CASES[case]
    st = gtscript.stencil(backend=backend, definition=definition)
    fields = {n: storage.from_array(v, dtype=st.field_info[n].dtype, backend=backend)
              for n, v in host.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st(**fields)
    theirs = run_ref_bf16(ref_definition, "numpy", host)
    for n, want in theirs.items():
        _equal(np.asarray(fields[n]).astype(np.float64), want, n)


# --- 3. the cases of test_c_backend.py ----------------------------------------------


def _run_pair(definition, domain=(6, 7, 8), **kwargs):
    """Run on cpu:c and numpy; return (c_outputs, numpy_outputs, c_backend)."""
    results = {}
    backend_obj = None
    for be in ("cpu:c", "numpy"):
        st = gtscript.stencil(
            backend=be,
            definition=definition,
            name=f"{definition.__name__}_{be.replace(':', '_')}",
        )
        rng = np.random.default_rng(7)
        arrays = {}
        for name, fi in st.field_info.items():
            lo, up = fi.boundary.lower, fi.boundary.upper
            shape = tuple(
                l + d + u
                for l, d, u, m in zip(lo, domain, up, fi.domain_mask)
                if m
            ) + tuple(fi.data_dims)
            arrays[name] = rng.random(shape).astype(fi.dtype)
        origin = {
            name: tuple(b for b, m in zip(fi.boundary.lower, fi.domain_mask) if m)
            + (0,) * len(fi.data_dims)
            for name, fi in st.field_info.items()
        }
        st(**arrays, **kwargs, origin=origin, domain=domain)
        results[be] = arrays
        if be == "cpu:c":
            backend_obj = st._backend
    return results["cpu:c"], results["numpy"], backend_obj


def _diffuse(inp: Field[np.float64], out: Field[np.float64], alpha: np.float64):
    with computation(PARALLEL), interval(...):
        out = inp + alpha * (
            inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0] - 4.0 * inp
        )


def test_supported_stencil_serves_from_c():
    got, want, backend = _run_pair(_diffuse, alpha=0.3)
    assert backend.last_path == "c"
    np.testing.assert_array_equal(got["out"], want["out"])


def _cumsum(inp: Field[np.float64], out: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp
    with computation(BACKWARD), interval(...):
        out = out + 0.0


def test_sequential_scan_serves_from_c():
    got, want, backend = _run_pair(_cumsum)
    assert backend.last_path == "c"
    np.testing.assert_array_equal(got["out"], want["out"])


def _scale(inp: Field[torch.bfloat16], out: Field[torch.bfloat16]):
    with computation(PARALLEL), interval(...):
        out = inp + inp


def test_half_float_falls_back_to_numpy_with_warning():
    st = gtscript.stencil(backend="cpu:c", definition=_scale, name="scale_bf16_c")
    a = storage.ones((4, 4, 4), "bfloat16", backend="cpu:c")
    b = storage.zeros((4, 4, 4), "bfloat16", backend="cpu:c")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st(inp=a, out=b, domain=(4, 4, 4))
    assert st._backend.last_path == "numpy_fallback"
    assert any("falling back" in str(w.message) for w in caught)
    np.testing.assert_array_equal(np.asarray(b), 2.0)


def _vark(inp: Field[np.float64], idx: Field[np.int64], out: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        out = inp[0, 0, idx]


def test_generated_source_structure():
    module = c_codegen.generate(analyze(_vark, {"name": "varkc", "backend_opts": {}}))
    src = module.source
    assert "void gt_run(" in src
    assert "#pragma omp parallel for" in src
    # Variable-K reads clamp, like the numpy/debug oracles.
    assert "gt_clampk" in src
    # The fixed ABI exposes strides in bytes — no layout assumptions.
    assert "strides[" in src


def _plus1(inp: Field[np.float64], out: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        out = inp + 1.0


def test_object_cache_reused_across_builds():
    st1 = gtscript.stencil(backend="cpu:c", definition=_plus1, name="plus1_a")
    a = np.zeros((3, 3, 3))
    b = np.zeros((3, 3, 3))
    st1(inp=a, out=b, domain=(3, 3, 3))
    n_libs = len(c_backend._LIB_CACHE)
    # Same definition under a new name: identical source → same lib.
    st2 = gtscript.stencil(backend="cpu:c", definition=_plus1, name="plus1_b")
    st2(inp=a, out=b, domain=(3, 3, 3))
    assert len(c_backend._LIB_CACHE) == n_libs
    np.testing.assert_array_equal(b, 1.0)


def _axpy(x: Field[np.float64], y: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        y = 2.0 * x + y


@pytest.mark.parametrize("kind", ["ndarray", "storage"])
def test_aliased_in_place_call_matches_numpy(kind):
    """Reading and writing the same buffer through two parameters must not
    be miscompiled (the generated pointers are deliberately NOT restrict)."""
    for be in ("cpu:c", "numpy", "debug"):
        st = gtscript.stencil(backend=be, definition=_axpy, name=f"axpy_{be[-1]}")
        arr = np.full((4, 4, 4), 3.0)
        if kind == "storage":
            arr = storage.from_array(arr, backend=be)
        st(x=arr, y=arr, domain=(4, 4, 4))
        np.testing.assert_array_equal(np.asarray(arr), 9.0, err_msg=be)


def _two_step(inp: Field[np.float64], out: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        tmp = inp * 2.0
        out = tmp[1, 0, 0] + tmp[-1, 0, 0]


def test_parallel_statement_ordering():
    """Within a PARALLEL computation each statement sweeps the whole domain
    before the next starts — a later statement sees the earlier one's
    writes at every K level (GTScript parallel-assignment semantics)."""
    got, want, backend = _run_pair(_two_step)
    assert backend.last_path == "c"
    np.testing.assert_array_equal(got["out"], want["out"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_numpy_semantics_mod_pow_div(dtype):
    """Floor-mod, integer power, and int-division-promotes-to-float follow
    NumPy, not C (% is floor-mod; / on ints is true division)."""
    is_int = np.issubdtype(dtype, np.integer)

    def arith(a: Field[dtype], b: Field[dtype], out: Field[np.float64]):  # type: ignore[valid-type]
        with computation(PARALLEL), interval(...):
            out = (a % b) + a**2 + a / b

    results = {}
    for be in ("cpu:c", "numpy"):
        st = gtscript.stencil(backend=be, definition=arith,
                              name=f"arith_{be[-1]}_{np.dtype(dtype).name}")
        rng = np.random.default_rng(3)
        if is_int:
            a = rng.integers(-9, 9, (4, 4, 4)).astype(dtype)
            b = (rng.integers(1, 5, (4, 4, 4)) * rng.choice([-1, 1], (4, 4, 4))).astype(dtype)
        else:
            a = (rng.random((4, 4, 4)) * 4 - 2).astype(dtype)
            b = ((rng.random((4, 4, 4)) + 0.5) * rng.choice([-1, 1], (4, 4, 4))).astype(dtype)
        out = np.zeros((4, 4, 4))
        st(a=a, b=b, out=out, domain=(4, 4, 4))
        results[be] = out
    np.testing.assert_allclose(results["cpu:c"], results["numpy"], rtol=1e-14)


def _c_sources(name, entry, **options):
    """The C source each package renders for a registry stencil."""
    port = gtscript.stencil(backend="cpu:c", definition=entry["definition"],
                            externals=entry["externals"], dtypes=entry["dtypes"], **options)
    opts = dict(options, dtypes=entry["dtypes"])
    if name in JAX_TWINS:  # named as the port names its own definition
        opts["name"] = name
    ref = ref_gtscript.stencil(backend="cpu:c", definition=_reference_definition(name),
                               externals=entry["externals"], **opts)
    return port._backend._module.source, ref._backend._module.source


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_c_source_matches_jax_package(name):
    """The copied generator renders the JAX package's C, but for the
    package's name in its first line."""
    mine, theirs = _c_sources(name, defs.REGISTRY[name])
    assert mine.replace("by gt4py_tpu_torch cpu:c", "by gt4py_tpu cpu:c") == theirs


def test_c_source_float32_literals_compile():
    """float32 literals: the JAX package renders NumPy 2's repr,
    ``np.float32(0.5)f``, which is no C, so its cpu:c falls back for every
    stencil with one; the port renders ``0.5f``, and is otherwise equal."""
    entry = {**defs.REGISTRY["hdiff_sponge"], "dtypes": {"dt": np.float32}}
    mine, theirs = _c_sources("hdiff_sponge", entry, literal_float_precision=32)
    assert "np.float32(" in theirs and "np.float32(" not in mine
    fixed = re.sub(r"np\.float32\(([^()]*)\)f", r"\1f", theirs)
    assert mine.replace("by gt4py_tpu_torch cpu:c", "by gt4py_tpu cpu:c") == fixed
    st = gtscript.stencil(backend="cpu:c", definition=entry["definition"],
                          dtypes=entry["dtypes"], literal_float_precision=32)
    host = defs.make_inputs(st.field_info, (9, 8, 3), np.random.default_rng(1))
    fields = {n: storage.from_array(v, backend="cpu:c") for n, v in host.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback
        st(**fields, origin=(2, 2, 0), domain=(5, 4, 3))
    assert st._backend.last_path == "c"


# --- 4. devices, the exclusion matrix, caches, the profiler ------------------------


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_tensor_off_the_cpu_raises_naming_its_device(backend):
    """Nothing is moved between devices: a field on another device (here
    torch's ``meta``, as no card is needed; tests/test_torch_cuda_codegen.py
    hands a CUDA tensor on the card) raises a TypeError naming it."""
    st = gtscript.stencil(backend=backend, definition=_plus1)
    inp = torch.zeros((3, 3, 3), dtype=torch.float64, device="meta")
    out = torch.zeros((3, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="meta"):
        st._backend.run({"inp": inp, "out": out}, {}, (3, 3, 3),
                        {"inp": (0, 0, 0), "out": (0, 0, 0)})


def test_storages_pass_between_all_five_backends():
    """Every backend's storage is a K-leading (K, I, J) buffer; one set of
    CPU storages runs on each backend in turn, as they are."""
    a = storage.from_array(np.arange(60.0).reshape(3, 4, 5), backend="numpy")
    b = storage.zeros((3, 4, 5), backend="cpu:c")
    assert a.array.stride() == b.array.stride() == (4, 1, 12)
    for be in tdefs.ALL_BACKENDS:
        st = gtscript.stencil(backend=be, definition=_axpy)
        b.array.zero_()
        st(x=a, y=b)
        np.testing.assert_array_equal(np.asarray(b), 2.0 * np.asarray(a), err_msg=be)


def test_registry_and_tiers():
    assert tdefs.ALL_BACKENDS == ["cpu:c", "cuda:hopper", "debug", "numpy", "torch"]
    assert tdefs.CPU_BACKENDS == ["cpu:c", "debug", "numpy"]
    assert tdefs.CARD_BACKENDS == ["cuda:hopper", "torch"]
    for be in tdefs.CPU_BACKENDS:
        assert storage.zeros((2, 2, 2), backend=be).device.type == "cpu"


def _exclusion_features(backend_obj, analyzed, fused: bool) -> tuple:
    """The matrix's features a stencil has, as the generator sees them."""
    features = []
    if backend_obj.module is None and "shared memory" in backend_obj.unsupported:
        features.append(tdefs.USES_WIDE_TEMPORARY)
    if fused and any(len(i.axes) < 3 for i in analyzed.field_infos.values() if i.axes):
        features.append(tdefs.USES_FUSED_LOWER_DIM)
    return tuple(features)


def _lower_dim_sweep(inp: Field[np.float64], prof: Field[gtscript.K, np.float64],
                     out: Field[np.float64], out2: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp * prof
        with interval(1, None):
            out = out[0, 0, -1] + inp * prof
    with computation(BACKWARD):
        with interval(-1, None):
            out2 = out
        with interval(0, -1):
            out2 = out + 0.5 * out2[0, 0, 1]


@pytest.mark.parametrize(
    "definition, fused, refused, kernel",
    [
        (_too_wide_temporary, False, True, None),
        (_lower_dim_sweep, True, False, "column"),
        (_lower_dim_sweep, False, False, "column"),
        (defs.tridiagonal_solver, True, False, "fused_column"),
        (defs.horizontal_diffusion, False, False, "plane"),
    ],
)
def test_exclusion_matrix_records_what_cuda_hopper_refuses(
    definition, fused, refused, kernel, monkeypatch
):
    """Where the matrix says ``cuda:hopper`` refuses a construct, the code
    generator has no kernel for it; where it says another kernel serves it,
    that kernel does; and a stencil without those features gets its
    class's kernel."""
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fused else "0")
    st = gtscript.stencil(backend="cuda:hopper", definition=definition,
                          dtypes={"dt": np.float64})
    features = _exclusion_features(st._backend, st._analyzed, fused)
    table = tdefs.BACKEND_SKIP_TEST_MATRIX["cuda:hopper"]
    assert (st._backend.module is None) == refused
    assert any(table.get(f) == tdefs.REFUSED_ON_CARD for f in features) == refused
    if not refused:
        assert st._backend.strategy == kernel
        if fused:
            assert tdefs.expects_kernel_of_class("cuda:hopper", *features) == (
                kernel == "fused_column")
    for be in tdefs.ALL_BACKENDS:  # CPU tensors: every construct runs everywhere
        tdefs.apply_exclusion(be, *features)
    for be in tdefs.CPU_BACKENDS:
        assert tdefs.expects_kernel_of_class(be, *features)
    if refused:  # on CUDA tensors the refused construct is skipped
        with pytest.raises(pytest.skip.Exception, match="uses_wide_temporary"):
            tdefs.apply_exclusion("cuda:hopper", *features, on_card=True)


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_registry_needs_no_exclusion(name):
    """No registry stencil has a feature of the matrix: each one is served on
    the card by the kernel tests/torch_stencil_defs.py pins for it."""
    entry = defs.REGISTRY[name]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"],
                          externals=entry["externals"], dtypes=entry["dtypes"])
    assert _exclusion_features(st._backend, st._analyzed, fused=False) == ()
    assert st._backend.unsupported is None


def test_cache_manager_lists_and_cleans_the_c_cache(tmp_path, monkeypatch):
    from gt4py_tpu_torch.cartesian import cache_manager, caching

    root = str(tmp_path / "torch")
    monkeypatch.setattr(caching, "GT_CACHE_ROOT", root)
    monkeypatch.setattr(c_backend, "_LIB_CACHE", {})
    st = gtscript.stencil(backend="cpu:c", definition=_plus1, name="plus1_cache")
    st(inp=np.zeros((2, 2, 2)), out=np.zeros((2, 2, 2)))
    info = cache_manager.cache_info(root)
    assert set(info["subsystems"]) == {"cbackend"}
    assert info["subsystems"]["cbackend"]["entries"] == 2  # the .c and the .so
    assert info["total_bytes"] == info["subsystems"]["cbackend"]["bytes"] > 0
    os.makedirs(os.path.join(root, "cuda"))
    open(os.path.join(root, "cuda", "gt_0123abcd.so"), "w").close()
    assert list(cache_manager.iter_cached_stencils(root)) == ["0123abcd"]
    cache_manager.clean_cache(root, subsystem="cbackend")
    assert set(cache_manager.cache_info(root)["subsystems"]) == {"cuda"}
    cache_manager.clean_cache(root)
    assert cache_manager.cache_info(root)["subsystems"] == {}


def test_profiler_host_trace(tmp_path):
    """``gpu_trace(activities="cpu")`` traces the host only and writes a
    Chrome trace; ``named_scope`` and the runtime's own span show in it.
    Outside a profile nothing is recorded: ``named_scope`` is the shared
    no-op and the call keeps no span."""
    from gt4py_tpu_torch.instrumentation import (
        NO_SPAN,
        clear_spans,
        gpu_trace,
        named_scope,
        spans,
    )

    st = gtscript.stencil(backend="numpy", definition=_plus1)
    a, b = np.zeros((2, 2, 2)), np.zeros((2, 2, 2))
    with gpu_trace(str(tmp_path), activities="cpu") as prof:
        with named_scope("gt4py_numpy_call"):
            st(inp=a, out=b)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gt4py_numpy_call", "gt4py.call"} <= names
    np.testing.assert_array_equal(b, 1.0)
    clear_spans()
    with named_scope("unmarked") as scope:
        st(inp=a, out=b)
    assert scope is NO_SPAN
    assert spans() == []
    with gpu_trace(str(tmp_path / "off"), activities="cpu") as prof:
        pass
    with open(prof.trace_path) as f:
        assert "unmarked" not in {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_refuses_a_device_trace_without_a_card(tmp_path, monkeypatch):
    from gt4py_tpu_torch.instrumentation import gpu_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="activities='cpu'"):
        with gpu_trace(str(tmp_path)):
            pass
    with pytest.raises(ValueError, match="activities"):
        with gpu_trace(str(tmp_path), activities="tpu"):
            pass


def test_reference_keeps_its_own_registry():
    assert sorted(REF_BACKENDS) == ["cpu:c", "debug", "jax", "numpy", "tpu:pallas"]
    for name in CPU_BACKENDS:
        assert REF_BACKENDS[name] is not REGISTRY[name]
