"""The ``cuda:hopper`` code generator and its build and launch wrappers.

On the CPU: generation succeeds and picks the ``plane`` or ``column``
skeleton, unsupported constructs raise ``CudaUnsupported`` with their
reason, and the build command and the launch ABI hold what the card needs.
Tests marked ``cuda`` build and launch the kernels; they decide inside the
test whether there is a card and skip without one.
"""

import ctypes

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend, cuda_codegen
from gt4py_tpu_torch.cartesian.backend.cuda_codegen import CudaUnsupported
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

from . import torch_stencil_defs as defs

F64 = gtscript.Field[np.float64]
F16 = gtscript.Field[np.float16]


def _backend(definition, **options):
    return gtscript.stencil(backend="cuda:hopper", definition=definition, **options)._backend


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_strategy_for_registry_stencil(name):
    entry = defs.REGISTRY[name]
    backend = _backend(entry["definition"], externals=entry["externals"])
    assert backend.unsupported is None
    assert backend.strategy == entry["strategy"]
    source = backend.module.source
    skeleton = f"gt_{entry['strategy']}_0"
    assert f"__global__ void __launch_bounds__" in source
    assert skeleton in source
    assert len(backend.module.launchers) == len(
        backend.analyzed.stencil.vertical_loops
    )


@pytest.mark.parametrize(
    "definition, dtypes, strategy",
    [
        (defs.horizontal_diffusion_generic, {"dt": np.float32}, "plane"),
        (defs.tridiagonal_solver_generic, {"dt": np.float32}, "column"),
        (defs.vertical_advection_dycore_generic, {"vadv_dt": np.float32}, "column"),
    ],
)
def test_float32_main_path_strategies(definition, dtypes, strategy):
    backend = _backend(
        definition, dtypes=dtypes, externals=defs.VADV_EXTERNALS,
        literal_float_precision=32, literal_int_precision=32,
    )
    assert backend.strategy == strategy
    # float32 fields: no double loads or stores in the kernels (a comparison
    # with an integer literal still promotes to double, as NumPy does)
    kernels = [k.split('extern "C"')[0] for k in backend.module.source.split("__global__")[1:]]
    assert kernels and not any("double*" in k for k in kernels)
    assert all("float*" in k for k in kernels)


def _shifted_read_after_write(inp: F64, out: F64, out2: F64):
    with computation(PARALLEL), interval(...):
        out = inp * 2.0
        out2 = out[1, 0, 0]


def _sequential_horizontal_race(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        tmp = inp * 2.0
        out = tmp[1, 0, 0]


def _half_precision(inp: F16, out: F16):
    with computation(PARALLEL), interval(...):
        out = inp


def _temporary_across_loops(inp: F64, out: F64):
    with computation(PARALLEL), interval(...):
        tmp = inp * 2.0
    with computation(PARALLEL), interval(...):
        out = tmp[1, 0, 0] + tmp[-1, 0, 0]


@pytest.mark.parametrize(
    "definition, reason",
    [
        (_shifted_read_after_write, "read at a horizontal offset after it is written"),
        (_sequential_horizontal_race, "columns would race"),
        (_half_precision, "float16 has no kernel type"),
        (_temporary_across_loops, "crosses vertical loops"),
    ],
)
def test_unsupported_constructs_name_their_reason(definition, reason):
    backend = _backend(definition)
    assert backend.module is None
    assert reason in backend.unsupported
    with pytest.raises(CudaUnsupported, match=reason):
        cuda_codegen.generate(backend.analyzed)


def test_unsupported_stencil_still_runs_plain_on_cpu():
    st = gtscript.stencil(backend="cuda:hopper", definition=_temporary_across_loops)
    rng = np.random.default_rng(0)
    inp = rng.random((8, 8, 3))
    out = np.zeros_like(inp)
    info = {}
    st(inp, out, origin=(2, 2, 0), domain=(4, 4, 3), exec_info=info)
    assert info["kernel_strategy"] == "plain"
    want = 2.0 * (inp[3:7, 2:6] + inp[1:5, 2:6])
    np.testing.assert_allclose(out[2:6, 2:6], want, rtol=1e-12)


def test_build_command_targets_hopper():
    cmd = cuda_backend.build_command("k.cu", "k.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    assert cmd[-3:] == ["-o", "k.so", "k.cu"]


def test_source_has_plain_c_interface():
    backend = _backend(defs.horizontal_diffusion)
    source = backend.module.source
    assert 'extern "C" int gt_launch_0(' in source
    assert "cudaGetLastError()" in source
    assert "torch/extension.h" not in source
    assert "restrict" not in source  # API fields may alias


def test_column_restrict_variant_only_when_noalias():
    """The column kernel's __restrict__ variant is launched only under the
    wrapper's noalias flag; the default variant takes plain pointers."""
    backend = _backend(defs.tridiagonal_solver)
    source = backend.module.source
    for n in range(2):
        plain = source.split(f"gt_column_{n}(const GtParams p)")[1].split("__global__")[0]
        assert "restrict" not in plain
        assert f"if (noalias) gt_column_{n}_r<<<" in source
        assert f"else gt_column_{n}<<<" in source
    # read-only fields of a loop are const in its restrict variant
    assert "const char* __restrict__ f0" in source  # inf


def test_overlapping_roles():
    base = torch.zeros(100)
    assert cuda_backend.overlapping({"a": base[:50], "b": base[50:]}) == []
    assert cuda_backend.overlapping({"a": base[:51], "b": base[50:]}) == [("a", "b")]
    assert cuda_backend.overlapping({"a": base, "b": base}) != []
    grid = torch.zeros(4, 5, 6).permute(1, 2, 0)
    assert cuda_backend.overlapping({"a": grid, "b": grid[1:3]}) != []
    assert cuda_backend.overlapping({"a": torch.zeros(3, 4), "b": torch.zeros(3, 4)}) == []


@pytest.mark.parametrize(
    "name, hazard",
    [
        ("copy_stencil", False),  # in place, point by point
        ("forward_cumsum", False),  # K-offset reads in a sequential loop: one thread
        ("staggeredish_interval_chain", False),
        ("lap_of_lap", True),  # offset reads of what other threads write
        ("horizontal_diffusion", True),
        ("shift_all_directions", True),  # PARALLEL K-offset reads in the column kernel
    ],
)
def test_alias_hazard(name, hazard):
    """Every field role given the same buffer."""
    entry = defs.REGISTRY[name]
    module = _backend(entry["definition"], externals=entry["externals"]).module
    buf = torch.zeros(6, 6, 6)
    pairs = cuda_backend.overlapping({m.name: buf for m in module.slots if not m.is_temp})
    assert pairs
    found = cuda_backend.alias_hazard(module, pairs)
    assert (found is not None) == hazard, found


def test_source_is_name_free():
    """The library cache is keyed by the source hash: one build serves
    identical definitions registered under different names."""
    a = _backend(defs.copy_stencil, name="first").module.source
    b = _backend(defs.copy_stencil, name="second", rebuild=True).module.source
    assert a == b


def test_launcher_abi_uses_pointers():
    """Every pointer and the stream go through c_void_p or a pointer type,
    never a 32-bit int."""

    class FakeLib:
        gt_launch_0 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    fn = cuda_backend._bind(FakeLib(), "gt_launch_0")
    assert fn.argtypes[-2] is ctypes.c_void_p  # the stream
    assert fn.argtypes[-1] is ctypes.c_int  # the noalias flag
    assert all(t is not ctypes.c_int for t in fn.argtypes[:-1])


def test_wrapper_counts_only_successful_launches():
    wrapper = cuda_backend.KernelWrapper("probe")
    wrapper.launch(lambda *a: 0, ())
    assert wrapper.launches == 1
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        wrapper.launch(lambda *a: 2, ())
    assert wrapper.launches == 1
    # an empty grid: the launcher returns without launching anything
    wrapper.launch(lambda *a: cuda_codegen.NOTHING_LAUNCHED, ())
    assert wrapper.launches == 1


@pytest.mark.parametrize("name", ["horizontal_diffusion", "tridiagonal_solver"])
def test_launcher_reports_an_empty_grid(name):
    entry = defs.REGISTRY[name]
    source = _backend(entry["definition"], externals=entry["externals"]).module.source
    assert (
        f"if (grid.x == 0 || grid.y == 0 || grid.z == 0) return "
        f"{cuda_codegen.NOTHING_LAUNCHED};" in source
    )


def test_cpu_tensors_never_launch():
    entry = defs.REGISTRY["tridiagonal_solver"]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"])
    before = (cuda_backend.PLANE.launches, cuda_backend.COLUMN.launches)
    fields = [storage.ones((4, 4, 5), backend="cuda:hopper", device="cpu") for _ in range(5)]
    st(*fields)
    assert (cuda_backend.PLANE.launches, cuda_backend.COLUMN.launches) == before


def test_build_error_names_the_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_backend, "_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(cuda_backend, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(cuda_backend.CudaBuildError, match="nvcc"):
        cuda_backend.load_library("/* empty */\n")


# --- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_kernel_matches_plain_on_card(name):
    _need_card()
    entry = defs.REGISTRY[name]
    kern = gtscript.stencil(
        backend="cuda:hopper", definition=entry["definition"], externals=entry["externals"]
    )
    plain = gtscript.stencil(
        backend="torch", definition=entry["definition"], externals=entry["externals"]
    )
    names = [n for n, i in kern.field_info.items() if i is not None]
    shape = (22, 21, max(9, entry["min_k"]))
    rng = np.random.default_rng(1)
    host = {n: rng.random(shape) for n in names}
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper", aligned_index=(3, 3, 0))
                  for n, v in host.items()}
        info = {}
        st(**fields, **entry["scalars"], domain=(16, 15, shape[2]), exec_info=info)
        torch.cuda.synchronize()
        expected = entry["strategy"] if tag == "kernel" else "plain"
        assert info["kernel_strategy"] == expected
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in names:
        np.testing.assert_allclose(out["kernel"][n], out["plain"][n], rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_unsupported_raises_on_card():
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=_temporary_across_loops)
    a = storage.zeros((8, 8, 3), backend="cuda:hopper")
    b = storage.zeros((8, 8, 3), backend="cuda:hopper")
    with pytest.raises(CudaUnsupported, match="crosses vertical loops"):
        st(a, b, origin=(2, 2, 0), domain=(4, 4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["forward_cumsum", "staggeredish_interval_chain", "copy_stencil"])
def test_aliased_arguments_on_card(name):
    """One storage passed for every field role: the wrapper sees the
    overlap and launches the plain-pointer variant; results match the
    plain version given the same aliasing."""
    _need_card()
    entry = defs.REGISTRY[name]
    host = np.random.default_rng(2).random((14, 13, 8))
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(backend=backend, definition=entry["definition"])
        field = storage.from_array(host, backend="cuda:hopper", aligned_index=(2, 2, 0))
        roles = [n for n, i in st.field_info.items() if i is not None]
        st(**{n: field for n in roles}, domain=(10, 9, 8))
        torch.cuda.synchronize()
        out[backend] = np.asarray(field)
    np.testing.assert_allclose(out["cuda:hopper"], out["torch"], rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_racy_aliasing_raises_on_card():
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=defs.lap_of_lap)
    field = storage.zeros((14, 13, 4), backend="cuda:hopper", aligned_index=(2, 2, 0))
    with pytest.raises(CudaUnsupported, match="share memory"):
        st(inp=field, out=field, domain=(10, 9, 4))
