"""The ``cuda:hopper`` code generator and its build and launch wrappers.

On the CPU: generation succeeds and picks the ``plane``, ``fused_plane``,
``column``, ``fused_column`` (with the stage-fusion switch on) or ``tiled``
skeleton, a construct no skeleton serves raises
``CudaUnsupported`` with its reason, and the build command, the kernels'
launch structure and the launch ABI hold what the card needs. Tests marked
``cuda`` build and launch the kernels; they decide inside the test whether
there is a card and skip without one.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend, cuda_codegen
from gt4py_tpu_torch.cartesian.backend.cuda_codegen import CudaUnsupported
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    I,
    computation,
    horizontal,
    interval,
    region,
)

from . import torch_stencil_defs as defs

F64 = gtscript.Field[np.float64]
F16 = gtscript.Field[np.float16]
FK = gtscript.Field[gtscript.K, np.float64]
FI64 = gtscript.Field[np.int64]
T4 = gtscript.GlobalTable[(np.float64, (4,))]


def _backend(definition, **options):
    options.setdefault("dtypes", {"dt": np.float64})
    return gtscript.stencil(backend="cuda:hopper", definition=definition, **options)._backend


def _registry_backend(name, **options):
    entry = defs.REGISTRY[name]
    return _backend(
        entry["definition"], externals=entry["externals"], dtypes=entry["dtypes"], **options
    )


def _kernel(source, name):
    """The body of one generated kernel."""
    return source.split(f"{name}(const GtParams p")[1].split('extern "C"')[0]


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_strategy_for_registry_stencil(name):
    """The pinned skeleton of every registry stencil (the role of
    EXPECTED_STRATEGY in tests/tpu_tests/test_registry_hardware.py)."""
    entry = defs.REGISTRY[name]
    backend = _registry_backend(name)
    assert backend.unsupported is None
    assert backend.strategy == entry["strategy"]
    source = backend.module.source
    skeleton = f"gt_{entry['strategy']}_0"
    assert f"__global__ void __launch_bounds__" in source
    assert skeleton in source
    loops = len(backend.analyzed.stencil.vertical_loops)
    fused = entry["strategy"] == "fused_plane"
    assert len(backend.module.launchers) == (1 if fused else loops)


def test_registry_pins_every_skeleton():
    """REGISTRY's pins, with those taken with the stage-fusion switch on,
    name every skeleton."""
    pinned = {e["strategy"] for e in defs.REGISTRY.values()} | set(defs.FUSED_STAGES.values())
    assert pinned == set(cuda_backend.WRAPPERS)


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


def _race_then_backward(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        tmp = inp * 2.0
        out = tmp[1, 0, 0] + tmp[0, -1, 0]
    with computation(BACKWARD), interval(0, -1):
        out = out + 0.5 * out[0, 0, 1]


def _wide_temporary(inp: F64, out: F64):
    with computation(PARALLEL), interval(...):
        tmp = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        out = tmp[40, 0, 0] + tmp[-40, 0, 0] + tmp[0, 40, 0] + tmp[0, -40, 0]


def _too_wide_temporary(inp: F64, out: F64):
    with computation(PARALLEL), interval(...):
        tmp = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        out = tmp[100, 0, 0] + tmp[-100, 0, 0] + tmp[0, 100, 0] + tmp[0, -100, 0]


def _tiled_in_place(inp: F64, out: F64):
    """A tiled sweep whose API fields are read only at their own point:
    ``stencil(a, a)`` is safe."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = 1.0
            out = inp + acc[1, 0, 0]
        with interval(1, None):
            acc = 0.5 * acc[0, 0, -1] + 1.0
            out = inp + acc[1, 0, 0] - acc[-1, 0, 0]


def _k_field_write(inp: F64, prof: FK):
    with computation(PARALLEL), interval(...):
        tmp = inp * 2.0
        prof = tmp[1, 0, 0]


def _masked_shared_write(inp: F64, out: F64, out2: F64):
    with computation(PARALLEL), interval(...):
        if inp > 0.5:
            out = inp * 2.0
        out2 = out[1, 0, 0] + out[0, -1, 0]


def _temporary_across_intervals(inp: F64, out: F64):
    with computation(PARALLEL), interval(0, 2):
        tmp = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
    with computation(PARALLEL), interval(...):
        out = tmp[1, 0, 0] + tmp[-1, 0, 0] + tmp[0, 1, 0] + tmp[0, -1, 0]


def _table_while(idx: FI64, out: F64, table: T4):
    with computation(PARALLEL), interval(...):
        v = table[idx]
        while v < 4.0:
            v = v * 2.0 + 0.5
        out = v + v


def _backward_ring(inp: F64, out: F64):
    with computation(BACKWARD):
        with interval(-1, None):
            acc = inp
            out = acc[1, 0, 0] - acc[-1, 0, 0]
        with interval(0, -1):
            acc = inp + 0.5 * acc[0, 0, 1]
            out = out[0, 0, 1] + acc[0, 1, 0] - acc[0, -1, 0]


def _masked_sweep(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            if inp > 0.3:
                acc = inp + 0.5 * acc[0, 0, -1]
            out = acc[1, 0, 0] + acc[0, -1, 0]


def _parallel_then_race(inp: F64, out: F64):
    with computation(PARALLEL), interval(...):
        tmp = inp * 2.0
    with computation(FORWARD), interval(...):
        acc = tmp[1, 0, 0] + tmp[-1, 0, 0]
        out = acc[0, 1, 0] + acc[0, -1, 0]


def _region_sweep(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        acc = inp
        with horizontal(region[I[0], :]):
            acc = 0.0
        out = acc[1, 0, 0] + acc[-1, 0, 0]


#: constructs beyond the registry that take the fused_plane and tiled
#: kernels' less travelled paths: planes filled from device memory or zeros
#: at every level, a BACKWARD ring, PARALLEL loops in the tiled kernel,
#: regions, tables and while, and sweeps reading an earlier level beyond the
#: points its writers compute (a tiled launch per level)
CONSTRUCTS = {
    "_shifted_read_after_write": (_shifted_read_after_write, "fused_plane"),
    "_temporary_across_loops": (_temporary_across_loops, "fused_plane"),
    "_masked_shared_write": (_masked_shared_write, "fused_plane"),
    "_temporary_across_intervals": (_temporary_across_intervals, "fused_plane"),
    "_table_while": (_table_while, "fused_plane"),
    "_sequential_horizontal_race": (_sequential_horizontal_race, "tiled"),
    "_race_then_backward": (_race_then_backward, "tiled"),
    "_backward_ring": (_backward_ring, "tiled"),
    "_masked_sweep": (_masked_sweep, "tiled"),
    "_parallel_then_race": (_parallel_then_race, "tiled"),
    "_region_sweep": (_region_sweep, "tiled"),
    "_tiled_in_place": (_tiled_in_place, "tiled"),
    "_lagged_neighbour_sweep": (defs.lagged_neighbour_sweep, "tiled"),
    "_lag_read_before_write": (defs.lag_read_before_write, "tiled"),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct_strategy(name):
    definition, strategy = CONSTRUCTS[name]
    backend = _backend(definition)
    assert backend.unsupported is None
    assert backend.strategy == strategy


def test_planes_filled_at_every_level_where_needed():
    fused = _kernel(_backend(_masked_shared_write).module.source, "gt_fused_plane_0")
    walk = fused.split("for (long long k = kb0; k < kb1; ++k)")[1]
    assert walk.index("f1_s[q] = gt_x;") < walk.index("gt_v")  # out: from memory
    zeros = _kernel(_backend(_temporary_across_intervals).module.source, "gt_fused_plane_0")
    assert "t0_s[q] = (double)0;" in zeros  # tmp: zeros where interval(0, 2) ends
    covered = _kernel(_registry_backend("hdiff_sponge").module.source, "gt_fused_plane_0")
    assert "_s[q] = (double)0;" not in covered  # every plane first written whole
    sweep = _kernel(_backend(_masked_sweep).module.source, "gt_tiled_0")
    # acc: filled from memory in the masked section only
    assert len(re.findall(r"t0_s\[t0_cur \* \d+ \+ q\] = gt_x;", sweep)) == 1


@pytest.mark.parametrize(
    "definition, strategy",
    [
        (_shifted_read_after_write, "fused_plane"),
        (_sequential_horizontal_race, "tiled"),
        (_temporary_across_loops, "fused_plane"),
    ],
)
def test_formerly_refused_constructs_get_a_kernel(definition, strategy):
    """An API field read at an offset after it is written, a value that
    columns of a sequential loop share, and a temporary handed from one
    loop to the next: each now has its kernel."""
    backend = _backend(definition)
    assert backend.unsupported is None
    assert backend.strategy == strategy
    assert backend.module.strategy == strategy
    assert f"gt_{strategy}_0" in backend.module.source


@pytest.mark.parametrize(
    "definition, reason",
    [(_half_precision, "float16 has no kernel type")],
)
def test_unsupported_constructs_name_their_reason(definition, reason):
    backend = _backend(definition)
    assert backend.module is None
    assert reason in backend.unsupported
    with pytest.raises(CudaUnsupported, match=reason):
        cuda_codegen.generate(backend.analyzed)


def test_unsupported_stencil_still_runs_plain_on_cpu():
    st = gtscript.stencil(backend="cuda:hopper", definition=_half_precision)
    assert st._backend.module is None
    inp = np.random.default_rng(0).random((8, 8, 3)).astype(np.float16)
    out = np.zeros_like(inp)
    info = {}
    st(inp, out, origin=(2, 2, 0), domain=(4, 4, 3), exec_info=info)
    assert info["kernel_strategy"] == "plain"
    np.testing.assert_array_equal(out[2:6, 2:6], inp[2:6, 2:6])


def test_fused_plane_is_one_launch_per_stencil():
    backend = _registry_backend("hdiff_sponge")
    source = backend.module.source
    assert len(backend.analyzed.stencil.vertical_loops) == 3
    assert backend.module.launchers == ["gt_launch_0"]
    assert source.count("<<<") == 1 and source.count("__global__") == 1
    stage, walk = _kernel(source, "gt_fused_plane_0").split(
        "for (long long k = kb0; k < kb1; ++k)"
    )
    # coeff (IJ) is staged in shared memory once, before the K walk; damp
    # (K) and the fields are read in the walk; temporaries never leave the SM
    assert "f2_s[q] = gt_x;" in stage and "f2_s[" in walk
    assert "f3_b = f3 + (f3_ok + k) * f3_sk" in walk
    assert "(*(double*)(f1_b)) = gt_v;" in walk  # out_field, at owned points
    # barriers: one after staging, one after each of the four statements
    assert stage.count("__syncthreads();") == 1
    assert walk.count("__syncthreads();") == 4
    assert "cudaFuncSetAttribute" not in source  # under 48 KB


def test_fused_plane_stores_widened_writes_only_where_it_owns():
    source = _backend(_shifted_read_after_write).module.source
    walk = _kernel(source, "gt_fused_plane_0")
    # out is written over i in [0, ni + 1) and read at i + 1: held in shared
    # memory, stored at the block's own points
    assert "const bool gt_own" in walk
    assert "if (gt_own) (*(double*)(f1_b)) = gt_v;" in walk
    assert "f1_s[f1_x + (64)]" in walk


def test_dynamic_shared_memory_above_48_kb():
    backend = _backend(_wide_temporary)
    assert backend.strategy == "fused_plane"  # the plane kernel's static 48 KB is too small
    source = backend.module.source
    smem = int(source.split("gt_fused_plane_0<<<grid, block, ")[1].split(",")[0])
    assert smem > cuda_codegen.SHARED_BYTES_MAX
    assert (
        f"cudaFuncSetAttribute(gt_fused_plane_0, cudaFuncAttributeMaxDynamicSharedMemorySize, "
        f"{smem});" in source
    )


def test_shared_memory_beyond_the_card_names_the_bytes():
    backend = _backend(_too_wide_temporary)
    assert backend.module is None
    assert "bytes of shared memory per block" in backend.unsupported
    assert str(cuda_codegen.SHARED_BYTES_LIMIT) in backend.unsupported


def test_tiled_is_one_launch_per_loop():
    backend = _backend(_race_then_backward)
    assert backend.strategy == "tiled"
    source = backend.module.source
    assert backend.module.launchers == ["gt_launch_0", "gt_launch_1"]
    assert source.count("<<<") == 2
    assert "for (long long k = (nk + (-1)) - 1; k >= (0); --k)" in _kernel(source, "gt_tiled_1")


def test_tiled_ring_and_barriers():
    source = _registry_backend("smoothed_column_sum").module.source
    kernel = _kernel(source, "gt_tiled_0")
    # acc is read one level back at other points: a ring of two planes
    assert "const int t0_cur = gt_slot(k, 2);" in kernel
    assert "t0_s[gt_slot((k + (-1)), 2) * 340 + t0_x + (0)]" in kernel
    # out is read one level back at its own point: device memory, clamped
    assert "gt_clampk(f1_ok + k + (-1), f1_nk)" in kernel
    # one barrier after each statement of each of the two sections
    assert kernel.count("__syncthreads();") == 4


@pytest.mark.parametrize("name", ["_lagged_neighbour_sweep", "_lag_read_before_write"])
def test_lagged_sweep_launches_once_per_level(name):
    """A read of the level below beyond the points its writers compute: the
    launcher launches the kernel once per level, in the walk's order, and
    the kernel reads earlier levels from device memory (a ring of one)."""
    module = _backend(CONSTRUCTS[name][0]).module
    source = module.source
    assert module.strategy == "tiled" and module.launchers == ["gt_launch_0"]
    assert module.per_level == {"gt_launch_0"}
    kernel = _kernel(source, "gt_tiled_0")
    launcher = source.split('extern "C" int gt_launch_0(')[1]
    assert "gt_tiled_0(const GtParams p, const long long k)" in source
    assert "for (long long k" not in kernel and "if (k >= (1) && k < (nk + (0)))" in kernel
    assert "gt_slot" not in kernel
    assert "gt_clampk(t0_ok + k + (-1), t0_nk)" in kernel  # acc one level down, from memory
    # level 0, then levels 1 .. nk - 1, each a launch
    walks = re.findall(r"(for \(long long k = .*\) \{)\s*gt_tiled_0<<<grid", launcher)
    assert walks == [
        "for (long long k = (0); k < (1); ++k) {",
        "for (long long k = (1); k < (nk + (0)); ++k) {",
    ]
    assert launcher.count("<<<") == 2
    # it writes how many kernels it launched, for the wrapper to count
    assert "int noalias, long long* launched) {" in launcher
    assert launcher.count("++*launched;") == 2
    assert f"if (*launched == 0) return {cuda_codegen.NOTHING_LAUNCHED};" in launcher


def test_sweep_without_the_hazard_launches_once():
    module = _registry_backend("smoothed_column_sum").module
    source = module.source
    launcher = source.split('extern "C" int gt_launch_0(')[1]
    assert "gt_tiled_0(const GtParams p)" in source
    assert launcher.count("<<<") == 1 and "for (" not in launcher
    assert module.per_level == frozenset() and "launched" not in launcher


# --- the stage-fusion switch and the fused_column kernel ---------------------------


@pytest.fixture
def fuse_stages(monkeypatch):
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1")


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_strategy_with_the_fusion_switch(name, fuse_stages, monkeypatch):
    """Switch on: K4's class takes fused_column, one launch per stencil and
    one kernel body per variant; every other stencil keeps its kernel and
    its source, byte for byte."""
    entry = defs.REGISTRY[name]
    fused = _registry_backend(name)
    assert fused.unsupported is None
    assert fused.strategy == defs.FUSED_STAGES.get(name, entry["strategy"])
    monkeypatch.delenv("GT4PY_CUDA_FUSE_STAGES")
    plain_switch = _registry_backend(name)
    assert plain_switch.strategy == entry["strategy"]
    if name in defs.FUSED_STAGES:
        source = fused.module.source
        assert fused.module.launchers == ["gt_launch_0"]
        assert source.count("__global__") == 2 and source.count("<<<") == 2
        assert "gt_fused_column_0(const GtParams p)" in source
        assert "gt_fused_column_0_r(const GtParams p" in source
        assert "fused_column" not in plain_switch.module.source
    else:
        assert fused.module.source == plain_switch.module.source


def test_fusion_switch_is_part_of_the_fingerprint(monkeypatch):
    """The same definition built with the switch off, on and off again: two
    stencil objects, the first served from the build memo the third time."""
    monkeypatch.delenv("GT4PY_CUDA_FUSE_STAGES", raising=False)
    definition = defs.REGISTRY["tridiagonal_solver"]["definition"]
    off = gtscript.stencil(backend="cuda:hopper", definition=definition)
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1")
    on = gtscript.stencil(backend="cuda:hopper", definition=definition)
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "0")
    again = gtscript.stencil(backend="cuda:hopper", definition=definition)
    assert on is not off and again is off
    assert (off._backend.strategy, on._backend.strategy) == ("column", "fused_column")


def _fused_generator(name):
    """The generator of a registry stencil with the switch on, and its
    module."""
    backend = _registry_backend(name)
    gen = cuda_codegen._Generator(backend.analyzed, fuse_stages=True)
    return gen, gen.generate()


def test_fused_column_keeps_vadv_temporaries_on_chip(fuse_stages):
    gen, module = _fused_generator("vertical_advection_dycore")
    assert module.strategy == "fused_column"
    assert len(gen.stencil.temporaries) == 11
    # the 9 loop-local temporaries are registers: no global buffer; the two
    # cross names of K4 (read by the BACKWARD loop) have one each, written
    # before they are read, so not zero-filled
    temps = [m for m in module.slots if m.is_temp]
    assert [m.name for m in module.slots if not m.is_temp] == [
        "utens_stage", "u_stage", "wcon", "u_pos", "utens"
    ]
    assert sorted(m.name for m in temps) == ["ccol", "dcol"]
    assert not any(m.fill for m in temps)
    kernel = _kernel(module.source, "gt_fused_column_0")
    for name in ("ccol", "dcol"):
        assert gen.held[name].cross and not gen.held[name].zero
    for name in set(t.name for t in gen.stencil.temporaries) - {"ccol", "dcol"}:
        assert not gen.held[name].cross and f"{gen.fields[name].var}_r = gt_v;" in kernel
    # datacol[0, 0, 1] is one carry register
    datacol = gen.fields["datacol"].var
    assert f"{datacol}_r1 = {datacol}_r;" in kernel
    assert module.min_nk == 2
    assert "gt_smem" not in module.source
    # up, then down, in one kernel
    up = kernel.index("for (long long k = (0); k < (1); ++k)")
    down = kernel.index("for (long long k = (nk + (0)) - 1; k >= (nk + (-1)); --k)")
    assert up < down


def test_fused_column_launch_shape(fuse_stages):
    """Blocks of FC_THREADS columns, 32 along J, over the union of the
    statement extents (vadv reads wcon at i + 1), no dynamic shared memory,
    and the __restrict__ variant only under the wrapper's noalias flag."""
    _, module = _fused_generator("vertical_advection_dycore")
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    rows = cuda_codegen.FC_THREADS // 32
    assert f"__launch_bounds__({cuda_codegen.FC_THREADS}) gt_fused_column_0(" in module.source
    assert f"const dim3 block(32, {rows});" in launcher
    assert f"/ {rows}), 1u);" in launcher
    assert "if (noalias) gt_fused_column_0_r<<<grid, block, 0," in launcher
    assert "else gt_fused_column_0<<<grid, block, 0," in launcher
    assert "cudaFuncSetAttribute" not in module.source


def test_fused_column_reads_tridiag_fields_from_device_memory(fuse_stages):
    gen, module = _fused_generator("tridiagonal_solver")
    kernel = _kernel(module.source, "gt_fused_column_0")
    assert gen.held == {} and [m.name for m in module.slots] == ["inf", "diag", "sup", "rhs", "out"]
    rhs = gen.fields["rhs"].var
    # the BACKWARD loop reads back what the same thread stored in the FORWARD one
    assert f"= (*(double*)({rhs} + ({rhs}_oi + i + (0)) * {rhs}_si" in kernel
    assert not module.nonlocal_reads  # every read at the thread's own column: aliasing is safe


def _carry_across_a_gap(inp: F64, out: F64, out2: F64):
    """acc is not written at level 1, so the carry read at level 2 sees 0,
    and so does the later loop there."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, 2):
            out = inp
        with interval(2, None):
            acc = inp + 0.5 * acc[0, 0, -1]
            out = acc
    with computation(BACKWARD), interval(...):
        out2 = acc + 1.0


def _masked_carry(inp: F64, out: F64):
    """acc is written only where inp > 0.5: elsewhere the carry and the
    later loop read 0."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            if inp > 0.5:
                acc = inp + 0.5 * acc[0, 0, -1]
    with computation(BACKWARD), interval(...):
        out = acc


def _sweep_then_parallel(inp: F64, out: F64):
    """A PARALLEL loop reads the sweep's value one level up, so the two
    loops stay apart."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -1]
    with computation(PARALLEL):
        with interval(0, -1):
            out = acc[0, 0, 1] - acc
        with interval(-1, None):
            out = acc


#: stencils of K4's class beyond the registry that take fused_column's less
#: travelled paths: a level that does not write a carried temporary, a
#: masked carry, a PARALLEL loop reading a sweep's value at a K offset
FUSED_CONSTRUCTS = {
    "_carry_across_a_gap": _carry_across_a_gap,
    "_masked_carry": _masked_carry,
    "_sweep_then_parallel": _sweep_then_parallel,
}


@pytest.mark.parametrize("name", sorted(FUSED_CONSTRUCTS))
def test_fused_construct_strategy(name, fuse_stages):
    backend = _backend(FUSED_CONSTRUCTS[name])
    assert backend.strategy == "fused_column"
    gen = cuda_codegen._Generator(backend.analyzed, fuse_stages=True)
    gen.generate()
    acc = gen.held["acc"]
    assert acc.ring == 1 and acc.cross
    # where a level does not write acc whole, its register restarts at 0
    # and its buffer is zero-filled; the whole sweep needs neither
    restarts = name != "_sweep_then_parallel"
    assert bool(acc.reset) == acc.zero == restarts
    assert (f"{acc.meta.var}_r = (double)0;" in backend.module.source) == restarts


def _cross_read_at_offset(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        tmp = inp * 2.0
    with computation(BACKWARD), interval(...):
        out = tmp[1, 0, 0]


def _carry_before_the_walk(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -2]
    with computation(BACKWARD), interval(...):
        out = acc


def _partial_k_range(inp: F64, out: F64):
    with computation(FORWARD), interval(0, -1):
        acc = inp * 2.0
    with computation(BACKWARD), interval(...):
        out = acc


@pytest.mark.parametrize(
    "definition, reason",
    [
        (defs.REGISTRY["heat_step"]["definition"], "written in two vertical loops"),
        (defs.REGISTRY["staggeredish_interval_chain"]["definition"], "written in two"),
        (defs.REGISTRY["dycore_smagorinsky_like"]["definition"], "one vertical loop"),
        (_cross_read_at_offset, "horizontal offset"),
        (_carry_before_the_walk, "needs seeding"),
        (_partial_k_range, "do not cover the K range"),
    ],
)
def test_fused_column_declines_what_k4_declines(definition, reason, fuse_stages):
    """These stay on column with the switch on, and why."""
    backend = _backend(definition)
    assert backend.strategy == "column"
    with pytest.raises(CudaUnsupported, match=reason):
        cuda_codegen._Generator(backend.analyzed, fuse_stages=True)._plan_fused_column()


def test_fused_column_refuses_too_few_levels(fuse_stages):
    """vadv's carries reach one level beyond the first section: below two
    levels the wrapper refuses, naming the bound."""
    memo = _registry_backend("vertical_advection_dycore")
    backend = cuda_backend.CudaHopperBackend(memo.analyzed, {})  # not the build memo's
    assert backend.module.min_nk == 2
    arrays = {n: torch.zeros(4, 4, 1, dtype=torch.float64) for n in backend.analyzed.field_infos}
    with pytest.raises(CudaUnsupported, match="at least 2 levels"):
        backend.prepare(arrays, {"dtr_stage": 0.1}, (4, 4, 1), {})


def test_lower_dimensional_writes_need_a_unit_axis():
    module = _backend(_k_field_write).module
    assert module.strategy == "fused_plane"
    assert module.unit_axes == {"prof": "IJ"}
    assert _registry_backend("temporary_stencil").module.unit_axes == {}


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
        ("vector_axpy", False),  # fused_plane, point by point
        ("hdiff_sponge", True),  # fused_plane: offset reads of in_field
        ("table_lookup", True),  # fused_plane: the table is staged in shared memory
        ("k_profile_scale", True),  # one level of prof is read at every (i, j)
        ("smoothed_column_sum", True),  # tiled: inp read over the widened tile
    ],
)
def test_alias_hazard(name, hazard):
    """Every field role given the same buffer."""
    module = _registry_backend(name).module
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


def test_wrapper_counts_every_level_of_a_per_level_launcher():
    """A per-level launcher writes how many kernels it launched; the
    wrapper adds that, and nothing on a failed or empty launch."""

    def launcher(levels, rc):
        def fn(*args):
            args[-1]._obj.value = levels
            return rc

        return fn

    wrapper = cuda_backend.KernelWrapper("probe")
    wrapper.launch(launcher(80, 0), (), per_level=True)
    assert wrapper.launches == 80
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        wrapper.launch(launcher(3, 9), (), per_level=True)
    wrapper.launch(launcher(0, cuda_codegen.NOTHING_LAUNCHED), (), per_level=True)
    wrapper.launch(lambda *a: 0, ())
    assert wrapper.launches == 81


def test_per_level_launcher_abi_takes_the_count_pointer():
    class FakeLib:
        gt_launch_0 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    fn = cuda_backend._bind(FakeLib(), "gt_launch_0", per_level=True)
    assert fn.argtypes[-3] is ctypes.c_void_p  # the stream
    assert fn.argtypes[-2] is ctypes.c_int  # the noalias flag
    assert fn.argtypes[-1] is ctypes.POINTER(ctypes.c_longlong)  # kernels launched


@pytest.mark.parametrize("name", ["horizontal_diffusion", "tridiagonal_solver"])
def test_launcher_reports_an_empty_grid(name):
    entry = defs.REGISTRY[name]
    source = _backend(entry["definition"], externals=entry["externals"]).module.source
    assert (
        f"if (grid.x == 0 || grid.y == 0 || grid.z == 0) return "
        f"{cuda_codegen.NOTHING_LAUNCHED};" in source
    )


def test_cpu_tensors_never_launch():
    st = gtscript.stencil(backend="cuda:hopper", definition=defs.REGISTRY["tridiagonal_solver"]["definition"])
    before = {k: w.launches for k, w in cuda_backend.WRAPPERS.items()}
    fields = [storage.ones((4, 4, 5), backend="cuda:hopper", device="cpu") for _ in range(5)]
    st(*fields)
    sponge = gtscript.stencil(backend="cuda:hopper", definition=_temporary_across_loops)
    sponge(*fields[:2], origin=(1, 1, 0), domain=(2, 2, 5))
    assert {k: w.launches for k, w in cuda_backend.WRAPPERS.items()} == before


def test_build_libraries_starts_every_build_at_once(tmp_path, monkeypatch):
    """Four one-second builds finish in about one second, not four; a
    library on disk is not built again."""
    import time

    monkeypatch.setattr(cuda_backend, "_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(
        cuda_backend, "build_command", lambda cu, lib: ["sh", "-c", f"sleep 1; cp {cu} {lib}"]
    )
    sources = [f"/* {n} */\n" for n in range(4)]
    t0 = time.perf_counter()
    cuda_backend.build_libraries(sources + sources[:1])
    assert time.perf_counter() - t0 < 3.0
    assert len(list(tmp_path.glob("gt_*.so"))) == 4
    t0 = time.perf_counter()
    cuda_backend.build_libraries(sources)
    assert time.perf_counter() - t0 < 0.5


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_backend, "_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(
        cuda_backend, "build_command", lambda cu, lib: ["sh", "-c", "echo bad kernel >&2; exit 2"]
    )
    with pytest.raises(cuda_backend.CudaBuildError, match="bad kernel"):
        cuda_backend.build_libraries(["/* broken */\n"])
    assert not list(tmp_path.glob("gt_*.so"))


def test_build_error_names_the_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_backend, "_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(cuda_backend, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(cuda_backend.CudaBuildError, match="nvcc"):
        cuda_backend.load_library("/* empty */\n")


# --- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _assert_same(got, want, name):
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_kernel_matches_plain_on_card(name):
    """Every registry stencil through its pinned kernel, against the plain
    version on the same card, every field and every point compared."""
    _need_card()
    entry = defs.REGISTRY[name]
    opts = dict(externals=entry["externals"], dtypes=entry["dtypes"])
    kern = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"], **opts)
    plain = gtscript.stencil(backend="torch", definition=entry["definition"], **opts)
    shape = (22, 21, max(9, entry["min_k"]))
    host = defs.make_inputs(kern.field_info, shape, np.random.default_rng(1))
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        info = {}
        st(**fields, **entry["scalars"], origin=(3, 3, 0), domain=(16, 15, shape[2]),
           exec_info=info)
        torch.cuda.synchronize()
        expected = entry["strategy"] if tag == "kernel" else "plain"
        assert info["kernel_strategy"] == expected
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct_matches_plain_on_card(name):
    _need_card()
    definition, strategy = CONSTRUCTS[name]
    opts = dict(definition=definition, dtypes={"dt": np.float64})
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    plain = gtscript.stencil(backend="torch", **opts)
    host = defs.make_inputs(kern.field_info, (41, 70, 7), np.random.default_rng(4))
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        info = {}
        st(**fields, origin=(2, 2, 0), domain=(37, 66, 7), exec_info=info)
        torch.cuda.synchronize()
        assert info["kernel_strategy"] == (strategy if tag == "kernel" else "plain")
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_lagged_neighbour_sweep", "_lag_read_before_write"])
def test_lagged_sweep_counts_a_launch_per_level_on_card(name):
    """The grid-wide step per level: the tiled wrapper counts one kernel
    launch for each of the domain's levels."""
    _need_card()
    st = gtscript.stencil(
        backend="cuda:hopper", definition=CONSTRUCTS[name][0], dtypes={"dt": np.float64}
    )
    host = defs.make_inputs(st.field_info, (41, 70, 7), np.random.default_rng(5))
    fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    cuda_backend.TILED.launches = 0
    st(**fields, origin=(2, 2, 0), domain=(37, 66, 7))
    torch.cuda.synchronize()
    assert cuda_backend.TILED.launches == 7


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(defs.FUSED_STAGES))
def test_fused_column_matches_plain_on_card(name, fuse_stages):
    """K4's class through fused_column (one launch per application) against
    the plain version on the same card, every field and point compared."""
    _need_card()
    entry = defs.REGISTRY[name]
    opts = dict(externals=entry["externals"], dtypes=entry["dtypes"])
    kern = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"], **opts)
    plain = gtscript.stencil(backend="torch", definition=entry["definition"], **opts)
    host = defs.make_inputs(kern.field_info, (41, 70, 19), np.random.default_rng(6))
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        cuda_backend.FUSED_COLUMN.launches = 0
        info = {}
        st(**fields, **entry["scalars"], origin=(2, 2, 0), domain=(37, 66, 19), exec_info=info)
        torch.cuda.synchronize()
        assert info["kernel_strategy"] == ("fused_column" if tag == "kernel" else "plain")
        assert cuda_backend.FUSED_COLUMN.launches == (1 if tag == "kernel" else 0)
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_CONSTRUCTS))
def test_fused_construct_matches_plain_on_card(name, fuse_stages):
    _need_card()
    definition = FUSED_CONSTRUCTS[name]
    kern = gtscript.stencil(backend="cuda:hopper", definition=definition)
    plain = gtscript.stencil(backend="torch", definition=definition)
    host = defs.make_inputs(kern.field_info, (41, 70, 9), np.random.default_rng(7))
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        info = {}
        st(**fields, origin=(2, 2, 0), domain=(37, 66, 9), exec_info=info)
        torch.cuda.synchronize()
        assert info["kernel_strategy"] == ("fused_column" if tag == "kernel" else "plain")
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
def test_unsupported_raises_on_card():
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=_half_precision)
    a = storage.zeros((8, 8, 3), np.float16, backend="cuda:hopper")
    b = storage.zeros((8, 8, 3), np.float16, backend="cuda:hopper")
    with pytest.raises(CudaUnsupported, match="float16 has no kernel type"):
        st(a, b, origin=(2, 2, 0), domain=(4, 4, 3))


@pytest.mark.cuda
def test_lower_dimensional_write_needs_a_unit_axis_on_card():
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=_k_field_write)
    inp = storage.zeros((8, 8, 3), backend="cuda:hopper")
    prof = storage.zeros((3,), backend="cuda:hopper", dimensions=("K",))
    with pytest.raises(CudaUnsupported, match="no I/J axis"):
        st(inp, prof, origin=(2, 2, 0), domain=(4, 4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    ["forward_cumsum", "staggeredish_interval_chain", "copy_stencil", "vector_axpy",
     "_tiled_in_place"],
)
def test_aliased_arguments_on_card(name):
    """One storage passed for every field role: the wrapper sees the
    overlap and launches the plain-pointer variant; results match the
    plain version given the same aliasing."""
    _need_card()
    entry = defs.REGISTRY.get(name, {"definition": globals().get(name), "scalars": {}})
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(backend=backend, definition=entry["definition"])
        roles = [n for n, i in st.field_info.items() if i is not None]
        host = defs.make_inputs(st.field_info, (14, 13, 8), np.random.default_rng(2))[roles[0]]
        field = storage.from_array(host, backend="cuda:hopper")
        info = {}
        st(**{n: field for n in roles}, **entry["scalars"], origin=(2, 2, 0),
           domain=(10, 9, 8), exec_info=info)
        torch.cuda.synchronize()
        if backend == "cuda:hopper":
            assert info["kernel_strategy"] == _backend(entry["definition"]).strategy
        out[backend] = np.asarray(field)
    np.testing.assert_allclose(out["cuda:hopper"], out["torch"], rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, roles",
    [
        ("lap_of_lap", ("inp", "out")),
        ("hdiff_sponge", ("in_field", "out_field")),
        ("smoothed_column_sum", ("inp", "out")),
    ],
)
def test_racy_aliasing_raises_on_card(name, roles):
    _need_card()
    entry = defs.REGISTRY[name]
    st = gtscript.stencil(
        backend="cuda:hopper", definition=entry["definition"], dtypes=entry["dtypes"]
    )
    host = defs.make_inputs(st.field_info, (14, 13, 4), np.random.default_rng(3))
    fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    fields[roles[1]] = fields[roles[0]]
    with pytest.raises(CudaUnsupported, match="share memory"):
        st(**fields, origin=(2, 2, 0), domain=(10, 9, 4))
