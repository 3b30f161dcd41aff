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
from gt4py_tpu_torch.cartesian.definitions import Extent
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    I,
    computation,
    exp,
    horizontal,
    interval,
    region,
    sqrt,
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
    name every skeleton (every wrapper but the field view's unstructured
    ``neighbor`` kernels, which no stencil takes)."""
    pinned = {e["strategy"] for e in defs.REGISTRY.values()} | set(defs.FUSED_STAGES.values())
    assert pinned == set(cuda_backend.WRAPPERS) - {cuda_backend.NEIGHBOR.name}


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


def _section_written_lag(inp: F64, low: F64, out: F64):
    """low is written by the first level's section only and read one level
    down by the other section: level 0 holds what the first section stored,
    the levels above their values from before the call."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            low = 2.0 * inp
            out = acc[1, 0, 0] + acc[-1, 0, 0]
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -1]
            out = low[0, 0, -1] + acc[1, 0, 0] - acc[0, -1, 0]


def _scaled_update(inp: F64, out: F64, prof: FK):
    """out is read at its own point before the level writes it: its value
    from before the call, which the tile ring may prefetch."""
    with computation(PARALLEL), interval(...):
        out = out * prof + inp[1, 0, 0] - inp[0, -1, 0]


#: constructs beyond the registry that take the fused_plane and tiled
#: kernels' less travelled paths: planes filled from device memory or zeros
#: at every level, a BACKWARD ring, PARALLEL loops in the tiled kernel,
#: regions, tables and while, and sweeps reading an earlier level beyond the
#: points its writers compute (a tiled launch per level)
def _masked_temporary(inp: F64, out: F64):
    """tmp is written by two masked statements and read at other points:
    its shared plane is zero-filled, since neither write alone covers it."""
    with computation(PARALLEL), interval(...):
        if inp > 0.5:
            tmp = inp
        else:
            tmp = -inp
        out = tmp[1, 0, 0] + tmp[0, -1, 0]


def _sectioned_plane(inp: F64, out: F64):
    """Sections with their own K intervals, a temporary written whole in
    one and under a mask in the other."""
    with computation(PARALLEL):
        with interval(0, 3):
            tmp = 2.0 * inp
            out = tmp[1, 0, 0] - tmp[-1, 0, 0]
        with interval(3, None):
            if inp > 0.4:
                tmp = inp
            else:
                tmp = 0.5 * inp
            out = tmp[0, 1, 0] + inp[-1, 0, 0]


CONSTRUCTS = {
    "_masked_temporary": (_masked_temporary, "plane"),
    "_sectioned_plane": (_sectioned_plane, "plane"),
    "_shifted_read_after_write": (_shifted_read_after_write, "fused_plane"),
    "_temporary_across_loops": (_temporary_across_loops, "fused_plane"),
    "_masked_shared_write": (_masked_shared_write, "fused_plane"),
    "_temporary_across_intervals": (_temporary_across_intervals, "fused_plane"),
    "_table_while": (_table_while, "fused_plane"),
    "_scaled_update": (_scaled_update, "fused_plane"),
    "_sequential_horizontal_race": (_sequential_horizontal_race, "tiled"),
    "_race_then_backward": (_race_then_backward, "tiled"),
    "_backward_ring": (_backward_ring, "tiled"),
    "_masked_sweep": (_masked_sweep, "tiled"),
    "_parallel_then_race": (_parallel_then_race, "tiled"),
    "_region_sweep": (_region_sweep, "tiled"),
    "_tiled_in_place": (_tiled_in_place, "tiled"),
    "_section_written_lag": (_section_written_lag, "tiled"),
    "_lagged_neighbour_sweep": (defs.lagged_neighbour_sweep, "tiled"),
    "_lag_read_before_write": (defs.lag_read_before_write, "tiled"),
    "_two_writer_sweep": (defs.two_writer_sweep, "tiled"),
    "_read_between_writes_sweep": (defs.read_between_writes_sweep, "tiled"),
    "_read_before_write_sweep": (defs.read_before_write_sweep, "tiled"),
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
    sweep = _bodies(_backend(_masked_sweep).module.source)["gt_tiled_0"]
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
    [(_too_wide_temporary, "bytes of shared memory per block")],
)
def test_unsupported_constructs_name_their_reason(definition, reason):
    backend = _backend(definition)
    assert backend.module is None
    assert reason in backend.unsupported
    with pytest.raises(CudaUnsupported, match=reason):
        cuda_codegen.generate(backend.analyzed)


def test_unsupported_stencil_still_runs_plain_on_cpu():
    """A stencil whose temporary's shared planes exceed the card's shared
    memory has no kernel, and CPU tensors still run the plain version."""
    st = gtscript.stencil(backend="cuda:hopper", definition=_too_wide_temporary)
    assert st._backend.module is None
    inp = np.random.default_rng(0).random((207, 206, 3))
    out = np.zeros_like(inp)
    info = {}
    st(inp, out, origin=(101, 101, 0), domain=(4, 3, 3), exec_info=info)
    assert info["kernel_strategy"] == "plain"
    tmp = inp[2:, 1:-1] + inp[:-2, 1:-1] + inp[1:-1, 2:] + inp[1:-1, :-2]  # at (i + 1, j + 1)
    want = (
        tmp[200:204, 100:103] + tmp[0:4, 100:103] + tmp[100:104, 200:203] + tmp[100:104, 0:3]
    )
    np.testing.assert_allclose(out[101:105, 101:104], want, rtol=1e-12)


def test_fused_plane_is_one_launch_per_stencil():
    backend = _registry_backend("hdiff_sponge")
    source = backend.module.source
    assert len(backend.analyzed.stencil.vertical_loops) == 3
    assert backend.module.launchers == ["gt_launch_0"]
    # one launcher; two variants of one kernel (the __restrict__ one rings
    # its inputs), of which each call launches one
    assert source.count('extern "C"') == 1
    assert set(_bodies(source)) == {"gt_fused_plane_0", "gt_fused_plane_0_r"}
    for body in _bodies(source).values():
        stage, walk = body.split("for (long long k = kb0; k < kb1; ++k)")
        # coeff (IJ) is staged in shared memory once, before the K walk;
        # damp (K) and the fields are read in the walk; temporaries never
        # leave the SM
        assert "f2_s[q] = gt_x;" in stage and "f2_s[" in walk
        assert "f3_b = f3 + (f3_ok + k) * f3_sk" in walk
        assert "(*(double*)(f1_b)) = gt_v;" in walk  # out_field, at owned points
        # barriers: the level's first, lap | flx, fly | out_field
        assert "__syncthreads();" not in stage
        assert walk.count("__syncthreads();") == 3
    assert "cudaFuncSetAttribute(gt_fused_plane_0," not in source  # under 48 KB


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
    for n in range(2):
        launcher = source.split(f'extern "C" int gt_launch_{n}(')[1].split("cudaGetLastError")[0]
        # one launch a call: the __restrict__ variant or the other
        assert launcher.count("<<<") == 2 and "if (noalias)" in launcher and "for (" not in launcher
    assert "for (long long k = (nk + (-1)) - 1; k >= (0); --k)" in _bodies(source)["gt_tiled_1"]


def test_tiled_ring_and_barriers():
    module = _registry_backend("smoothed_column_sum").module
    bodies = _bodies(module.source)
    for name, kernel in bodies.items():
        # acc[0, 0, -1] is read at the thread's own point: a register carry,
        # so acc's shared plane holds the current level only
        assert "const int t0_cur = 0;" in kernel and "gt_slot((k + (-1))" not in kernel
        assert "t0_r1 = t0_r;" in kernel and "* ((double)(t0_r1))" in kernel
        # out[0, 0, -1] too, in the __restrict__ variant; the other reads
        # device memory (another name may share out's memory)
        restrict = name.endswith("_r")
        assert ("((double)(f1_r1))" in kernel) == restrict
        assert ("gt_clampk(f1_ok + k + (-1), f1_nk)" in kernel) != restrict
        # per level: the level's barrier, and one between acc and out
        for walk in kernel.split("for (long long k = ")[1:]:
            assert walk.count("__syncthreads();") == 2


@pytest.mark.parametrize("name", ["_lagged_neighbour_sweep", "_lag_read_before_write"])
def test_lagged_sweep_launches_once_per_level(name):
    """A read of the level below beyond the points its writers compute:
    one cooperative launch walks every level, each block over its tiles,
    each tile first waiting for the tiles its reads reach to publish the
    level before; earlier levels are read from L2 (``__ldcg``). (The name
    is the one the test had when each level was a launch of its own.)"""
    module = _backend(CONSTRUCTS[name][0]).module
    source = module.source
    assert module.strategy == "tiled" and module.launchers == ["gt_launch_0"]
    assert module.cooperative == {"gt_launch_0"}
    kernel = _bodies(source)["gt_tiled_0"]
    assert set(_bodies(source)) == {"gt_tiled_0"}
    assert "gt_tiled_0(const GtParams p, int* __restrict__ gt_flags)" in source
    assert "for (long long gt_t = blockIdx.x; gt_t < gt_tiles; gt_t += gridDim.x)" in kernel
    assert "gt_slot" not in kernel
    assert "__ldcg((const double*)(t0 + " in kernel and "gt_clampk(t0_ok + k + (-1), t0_nk)" in kernel
    assert "while (gt_flag_load(gt_f) < gt_step)" in kernel and "__trap();" in kernel
    assert "gt_flag_store(gt_flags + gt_t, gt_step + 1);" in kernel
    launcher = source.split('extern "C" int gt_launch_0(')[1]
    assert "int noalias, int* flags) {" in launcher
    assert "for (" not in launcher and "<<<" not in launcher
    assert launcher.count("cudaLaunchCooperativeKernel(") == 1
    assert "cudaMemsetAsync(flags, 0, gt_tiles * sizeof(int)" in launcher
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&gt_per_sm, gt_tiled_0," in launcher


def test_sweep_without_the_hazard_launches_once():
    module = _registry_backend("smoothed_column_sum").module
    source = module.source
    launcher = source.split('extern "C" int gt_launch_0(')[1]
    assert "gt_tiled_0(const GtParams p)" in source and "gt_tiled_0_r(const GtParams p)" in source
    assert launcher.count("<<<") == 2 and "for (" not in launcher
    assert module.cooperative == frozenset() and "Cooperative" not in launcher
    assert "gt_flag" not in source


# --- the tile walks: input ring, barriers, carries, buffers ---------------------


def _tile_generator(definition, **options):
    backend = _backend(definition, **options)
    gen = cuda_codegen._Generator(backend.analyzed)
    return gen, gen.generate()


@pytest.mark.parametrize(
    "name, kernel, rings, levels",
    [
        ("smoothed_column_sum", "gt_tiled_0", {"inp"}, 4),
        # float64: 4 levels would leave two blocks an SM (test below)
        ("hdiff_sponge", "gt_fused_plane_0", {"in_field"}, 2),
        ("k_profile_scale", "gt_fused_plane_0", {"inp"}, 4),
    ],
)
def test_tile_walks_ring_their_inputs(name, kernel, rings, levels):
    """The __restrict__ variant copies its input planes with cp.async,
    depth - 1 levels ahead, waits once a level for the level it reads, and
    reads them from the ring; the other variant loads directly."""
    module = _registry_backend(name).module
    bodies = _bodies(module.source)
    ringed = bodies[kernel + "_r"]
    assert set(module.ring_bytes) == {kernel + "_r"}
    fields = {m.name: m.var for m in module.slots}
    for field in rings:
        v = fields[field]
        assert f"gt_clampk({v}_ok + gt_k, {v}_nk) * {v}_sk" in ringed
        assert f"{v}_s[gt_slot(k + (0), {levels}) * " in ringed
        assert f"{v}_s[" not in bodies[kernel]
    assert ringed.count("gt_cp_async") == len(rings) and "gt_cp_async" not in bodies[kernel]
    assert f"for (int gt_f = 0; gt_f < {levels - 1}; ++gt_f) gt_tfetch(gt_f);" in ringed
    walks = ringed.split("for (long long k = ")[1:]
    for walk in walks:
        assert walk.count(f"gt_cp_wait<{levels - 2}>();") == 1
        assert walk.count(f"gt_tfetch(gt_p + {levels - 1});") == 1
    assert ringed.count("gt_cp_wait_all();") == 1
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    assert f"{kernel}_r<<<grid, block, " in launcher.split("else")[0]


@pytest.mark.parametrize("name, barriers", [("hdiff_sponge", 2), ("smoothed_column_sum", 1)])
def test_tile_walk_barriers_by_the_sharing_rule(name, barriers):
    """A barrier between two statements only where the later one reads at
    another thread's point what the earlier one wrote (or overwrites what it
    read), besides the one that turns each level over: hdiff_sponge
    lap | flx, fly | out_field; smoothed_column_sum acc | out."""
    module = _registry_backend(name).module
    for body in _bodies(module.source).values():
        for walk in body.split("for (long long k = ")[1:]:
            assert walk.count("__syncthreads();") == 1 + barriers


@pytest.mark.parametrize("dtype, levels, blocks", [(np.float32, 4, 4), (np.float64, 2, 4)])
def test_tile_ring_depth_keeps_the_block_resident(dtype, levels, blocks):
    """hdiff_sponge's ring takes the most levels, up to TILE_RING_LEVELS, at
    which its block, shared planes and ring, still leaves
    TILE_RESIDENT_THREADS threads resident on an SM: float32 keeps 4 levels;
    float64 would keep 2 blocks of 256 threads at 4 levels and 3 at 3, so it
    takes 2."""
    gen, module = _tile_generator(
        defs.REGISTRY["hdiff_sponge"]["definition"], dtypes={"dt": dtype}
    )
    (ring,) = gen.tile_rings[0]
    assert ring.ring == levels
    assert f"gt_tfetch(gt_p + {levels - 1});" in module.source

    def resident(depth):
        used = gen.fused_bytes + ring.bytes // levels * depth + cuda_codegen.BLOCK_RESERVED_BYTES
        return cuda_codegen.SM_SHARED_BYTES // used

    assert resident(levels) == blocks
    assert resident(levels) * cuda_codegen.PLANE_THREADS >= cuda_codegen.TILE_RESIDENT_THREADS
    for deeper in range(levels + 1, cuda_codegen.TILE_RING_LEVELS + 1):
        assert resident(deeper) * cuda_codegen.PLANE_THREADS < cuda_codegen.TILE_RESIDENT_THREADS


def test_tile_ring_skips_earlier_levels_of_a_field_another_section_writes():
    """low is written at level 0 by the first section and read at k - 1 by
    the second: the ring would copy level 0 before the first section stores
    it, so the read stays a load from device memory. inp, read at its own
    level and written nowhere, is ringed."""
    gen, module = _tile_generator(_section_written_lag)
    assert gen.tile_rings[0] and {b.meta.name for b in gen.tile_rings[0]} == {"inp"}
    low = gen.fields["low"].var
    ringed = _bodies(module.source)["gt_tiled_0_r"]
    assert f"{low}_s[" not in ringed
    assert f"gt_clampk({low}_ok + k + (-1), {low}_nk)" in ringed


def test_hazard_rule_reads_the_gtir():
    gen, _ = _tile_generator(
        defs.REGISTRY["hdiff_sponge"]["definition"], dtypes={"dt": np.float64}
    )
    lap, flx, fly, out = gen._items(range(3))
    assert gen._hazard([lap], flx, alias=False)  # lap read at i + 1
    assert not gen._hazard([flx], fly, alias=False)  # nothing shared
    assert gen._hazard([flx, fly], out, alias=False)  # flx at i - 1
    # API fields that may share memory count as one: out_field's write
    # meets lap's reads of in_field at other points
    assert not gen._hazard([lap], out, alias=False)
    assert gen._hazard([lap], out, alias=True)


def test_smoothed_column_sum_keeps_acc_on_chip(monkeypatch):
    """acc is read only from its ring and its register: it has no slot, the
    wrapper allocates nothing for it and the kernels store none of it."""
    gen, module = _tile_generator(
        defs.REGISTRY["smoothed_column_sum"]["definition"], dtypes={"dt": np.float64}
    )
    assert [m.name for m in module.slots] == ["inp", "out"]
    assert gen.no_buffer == {"acc"}
    assert {n: d for n, (d, _) in gen.tiled_carries[0].items()} == {"acc": 1, "out": 1}
    acc = gen.fields["acc"].var
    assert f"(*(double*)({acc} +" not in module.source
    backend = cuda_backend.CudaHopperBackend(gen.analyzed, {})
    backend._fns = []
    arrays = {n: torch.zeros(6, 5, 4, dtype=torch.float64) for n in backend.analyzed.field_infos}
    calls = []
    for fn in ("zeros", "empty"):
        real = getattr(torch, fn)
        monkeypatch.setattr(
            torch, fn, lambda *a, _fn=fn, _real=real, **k: calls.append(_fn) or _real(*a, **k)
        )
    backend.prepared(arrays, (4, 3, 4), {})
    assert calls == []


@pytest.mark.parametrize(
    "definition, carries, buffers",
    [
        # a masked write: the level's value may be device memory's
        (_masked_sweep, {}, {"acc"}),
        # out is written whole at every level and read back one level up:
        # carried; acc's plane is filled from device memory where its
        # second section's write does not cover it, so it keeps a buffer
        (_backward_ring, {"out": 1}, {"acc"}),
        # tmp never leaves its loop; out[0, 0, 1] at the top level is the
        # value from before the loop, so no carry
        (_race_then_backward, {}, set()),
        (defs.lagged_neighbour_sweep, {}, {"acc", "lag"}),
    ],
)
def test_tiled_carries_and_buffers(definition, carries, buffers):
    gen, module = _tile_generator(definition)
    found = {}
    for loop in gen.tiled_carries.values():
        found.update({n: d for n, (d, _) in loop.items()})
    assert found == carries
    assert {m.name for m in module.slots if m.is_temp} == buffers


def test_tile_ring_serves_a_field_read_before_its_write():
    """out is read at its own point before the level writes it: the ring
    prefetches its value from before the call; inp at two offsets shares one
    plane over their footprint."""
    gen, module = _tile_generator(_scaled_update)
    (ring,) = gen.tile_rings.values()
    assert {b.meta.name for b in ring} == {"inp", "out"}
    inp, ringed_out = (next(b for b in ring if b.meta.name == n) for n in ("inp", "out"))
    assert (inp.fp.i, inp.fp.j) == ((0, 1), (-1, 0))
    assert (inp.rows, inp.cols) == (cuda_codegen.TI + 1, cuda_codegen.TJ + 1)
    # the store still goes to the level's address in device memory
    out = gen.fields["out"].var
    body = _bodies(module.source)["gt_fused_plane_0_r"]
    assert f"{out}_s[gt_slot(k + (0), {ringed_out.ring}) * " in body
    assert f"({out}_ok + k) * {out}_sk;" in body and f"(*(double*)({out}_b)) = gt_v;" in body


def _ring_beyond_budget(inp: F64, prof: FK, out: F64):
    with computation(PARALLEL), interval(...):
        out = inp[-30, 0, 0] * prof + inp[30, 0, 0] + inp[0, 0, 0]


def test_tile_ring_keeps_within_its_budget():
    """A plane over inp's footprint (76 × 64 float64, 38,912 B) times
    TILE_RING_LEVELS exceeds RING_BYTES_MAX: inp stays a direct load."""
    gen, module = _tile_generator(_ring_beyond_budget)
    ring = gen.tile_rings[0]
    assert "inp" not in {b.meta.name for b in ring}
    assert all(
        b.elements * b.meta.dtype.itemsize <= cuda_codegen.RING_BYTES_MAX for b in ring
    )


# --- the plane kernel (K1): a walk of PL_TK levels a block, 32-bit offsets --------


def _plane_generator(definition, **options):
    gen, module = _tile_generator(definition, **options)
    assert module.strategy == "plane"
    return gen, module


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plane_restrict_variant_rings_its_inputs(dtype):
    """hdiff: gt_plane_0_r prefetches in_field (read at four neighbours)
    and coeff (read at its own point: ringed, it measured faster than a
    direct load) with cp.async into a ring of planes over their
    footprints, whole 16-byte vectors where the field lies on the tiles'
    vectors and element by element where it does not, waits once a level
    for the level it reads, and reads them from the level's slot of the
    ring; gt_plane_0 loads them directly. The launcher takes the ringed
    variant only where the wrapper found no overlap, on a grid shifted by
    the word's shift."""
    gen, module = _plane_generator(defs.horizontal_diffusion_generic, dtypes={"dt": dtype})
    bodies = _bodies(module.source)
    ringed, plain = bodies["gt_plane_0_r"], bodies["gt_plane_0"]
    ring = gen.tile_rings[0]
    assert ring is gen.patch_plans[0].ring
    assert {b.meta.name for b in ring} == {"in_field", "coeff"}
    depth = ring[0].ring
    # float64's planes at 3 levels would leave fewer than
    # TILE_RESIDENT_THREADS threads resident on an SM: 2
    assert depth == (cuda_codegen.PL_RING_LEVELS if dtype == np.float32 else 2)
    assert set(module.ring_bytes) == {"gt_plane_0_r"}
    assert module.ring_bytes["gt_plane_0_r"] == sum(b.bytes for b in ring)
    assert "gt_tfetch(" in ringed and "gt_tfetch(" not in plain
    assert f"gt_cp_wait<{depth - 2}>();" in ringed and "gt_cp_wait<" not in plain
    size = np.dtype(dtype).itemsize
    vector = gen.patch_plans[0].width * size  # a vector of the field: 8 or 16 bytes
    assert f"gt_cp_async{vector}(gt_d + " in ringed
    assert f"gt_cp_async{size}(gt_d + " in ringed  # off the vectors, or cut
    v = gen.fields["in_field"].var
    assert f"const {'float' if dtype == np.float32 else 'double'}* const {v}_l = {v}_s + " \
        f"gt_slot(k, {depth}) * " in ringed
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    assert "if (noalias)" in launcher
    assert "gt_plane_0_r<<<dim3((unsigned)((nj + ((noalias >> 1) & 7) + 63) / 64), " \
        "grid.y, grid.z), dim3(256), " in launcher
    assert "(noalias >> 1) & 7, (unsigned)noalias >> 4);" in launcher
    assert "else gt_plane_0<<<grid, block, " in launcher


def test_plane_walks_levels_of_one_tile_a_block():
    """A block walks PL_TK levels of one PL_TI × PL_TJ tile, the last walk
    cut at nk. In gt_plane_0 threads run along J and walk rows of I; in
    gt_plane_0_r a thread takes the statement's patches, the tile's columns
    shifted by the word's shift so that they start on the storage's
    vectors."""
    _, module = _plane_generator(defs.horizontal_diffusion_generic)
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    tk = cuda_codegen.PL_TK
    assert f"(unsigned)((nk + {tk - 1}) / {tk})" in launcher
    assert f"(unsigned)((nj + {cuda_codegen.PL_TJ - 1}) / {cuda_codegen.PL_TJ})" in launcher
    bodies = _bodies(module.source)
    for body in bodies.values():
        assert f"const long long kb1 = kb0 + {tk} < nk ? kb0 + {tk} : nk;" in body
        assert body.count("for (long long k = kb0; k < kb1; ++k)") == 1
    assert "for (int gt_r = ty; gt_r < " in bodies["gt_plane_0"]
    patched = bodies["gt_plane_0_r"]
    assert f"j0 = blockIdx.x * {cuda_codegen.PL_TJ} - gt_s;" in patched
    assert "for (int gt_r = ty;" not in patched
    assert patched.count(f"for (int gt_q = tid; gt_q < ") == 2  # lap, out_field


def test_plane_point_offsets_are_32_bit():
    """Each field's address at the tile's corner is computed once a block
    and at each level once a level; a point's offset from it, and every
    access's constant offset, is an int. No per-point division."""
    gen, module = _plane_generator(defs.horizontal_diffusion_generic)
    v = gen.fields["in_field"].var
    for body in _bodies(module.source).values():
        assert f"const int {v}_si4 = (int){v}_si, {v}_sj4 = (int){v}_sj;" in body
        assert "long long i =" not in body and "long long j =" not in body
    plain, patched = _bodies(module.source)["gt_plane_0"], _bodies(module.source)["gt_plane_0_r"]
    assert "const int gt_di = gt_r + (" in plain and "const int gt_dj = tx + (" in plain
    assert " / " not in plain.split("for (long long k = kb0")[1]
    # a patch's corner, once a patch: its index over a constant count of
    # patches a row, and nothing else divided
    level = patched.split("for (long long k = kb0")[1]
    assert level.count(" / ") == level.count("const int gt_r = gt_q / ") == 2
    out = gen.fields["out_field"].var
    assert f"char* const {out}_b = {out}_k + (gt_r * {out}_si4 + gt_c * {out}_sj4);" in level
    assert f"{v}_k + (gt_di * {v}_si4 + gt_dj * {v}_sj4)" in plain
    assert f"{v}_b + (1) * {v}_si4" in plain and f" * {v}_si)" not in plain.split("kb1")[1]


def test_plane_refuses_offsets_beyond_32_bits():
    """The wrapper refuses, naming the strides, a field whose strides carry
    the tile's reach beyond 32 bits; one just inside passes."""
    backend = _backend(defs.horizontal_diffusion_generic, dtypes={"dt": np.float32})
    rows, cols = backend.module.offset_span
    meta = backend.module.slots[0]
    wide = torch.empty_strided((4, 4, 4), (2**31 // (4 * rows) + 1, 1, 4), device="meta")
    with pytest.raises(CudaUnsupported, match="beyond 32 bits"):
        backend._check_offsets(meta, wide)
    fits = torch.empty_strided((4, 4, 4), ((2**31 - 1 - 4 * cols) // (4 * rows), 1, 4), device="meta")
    backend._check_offsets(meta, fits)


def test_plane_fills_no_plane_its_first_write_covers():
    """hdiff writes lap whole before reading it: no plane is zero-filled
    and no barrier waits for one. A temporary written under a
    mask is filled at every level, in the section that needs it only."""
    _, module = _plane_generator(defs.horizontal_diffusion_generic)
    assert not re.search(r"_s\[q\] = \(\w+\)0;", module.source)
    for body in _bodies(module.source).values():
        # the level's turn, and lap | out_field
        assert body.split("for (long long k = kb0")[1].count("__syncthreads();") == 2
    _, masked = _plane_generator(_masked_temporary)
    for body in _bodies(masked.source).values():
        assert len(re.findall(r"_s\[q\] = \(double\)0;", body)) == 1
    _, sectioned = _plane_generator(_sectioned_plane)
    for body in _bodies(sectioned.source).values():
        first, second = body.split("if (k >= (3)")
        assert "if (k >= (0) && k < (3))" in first and "(double)0;" not in first
        assert len(re.findall(r"_s\[q\] = \(double\)0;", second)) == 1


# --- the plane kernel's register patches (gt_plane_<n>_r) ------------------------


@pytest.mark.parametrize(
    "name, dtype, width, rows, fields",
    [
        ("hdiff", np.float32, 2, 2, ("in_field", "out_field", "coeff")),
        ("hdiff", np.float64, 2, 1, ("in_field", "out_field", "coeff")),
        ("hdiff", np.float16, 2, 2, ("in_field", "out_field", "coeff")),
        ("hdiff", "bfloat16", 2, 2, ("in_field", "out_field", "coeff")),
        # int8 and bool move point by point; float64 sets the size
        ("dtype_zoo", None, 2, 1, ("idx32", "big", "f32", "f64")),
        ("land_mask", None, 2, 1, ("height",)),
    ],
)
def test_patch_width_follows_the_widest_field(name, dtype, width, rows, fields):
    """A patch is PL_PATCH_WIDTH J points by PL_PATCH_ROWS rows, at most 16
    bytes of the loop's widest field with a vector path (float16 and
    bfloat16, 4- and 8-byte types): 2 × 2 in float32 and the halves, 2 × 1
    in float64; the mask's fields are those, in slot order."""
    if name == "hdiff":
        gen, module = _plane_generator(defs.horizontal_diffusion_generic, dtypes={"dt": dtype})
    else:
        entry = defs.REGISTRY[name]
        gen, module = _plane_generator(
            entry["definition"], dtypes=entry["dtypes"], externals=entry["externals"]
        )
    plan = gen.patch_plans[0]
    assert (plan.width, plan.rows) == (width, rows)
    assert tuple(m.name for m in plan.fields) == fields
    layout = module.patches["gt_launch_0"]
    assert layout.width == width and tuple(n for n, _ in layout.fields) == fields


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_patch_ring_windows_round_out_to_vectors(dtype):
    """hdiff: lap runs over its extent rounded out to whole patches; the
    ring copies in_field over its footprint (20 rows of columns -2 to 65)
    rounded out to whole vectors, and its plane also spans the columns the
    patches read beyond it; coeff, read at the tile's own points, is 16
    rows of whole vectors."""
    gen, module = _plane_generator(defs.horizontal_diffusion_generic, dtypes={"dt": dtype})
    plan = gen.patch_plans[0]
    w, size = plan.width, np.dtype(dtype).itemsize
    lap_cols, in_cols, in_vectors = (-2, 66), (-4, 68), 34  # vectors of 2
    lap = next(it for it in gen._items([0]) if it.writes_name("lap_field"))
    assert plan.regions[id(lap.stmt)] == (-1, 17) + lap_cols
    ring = {b.meta.name: b for b in plan.ring}
    inp, coeff = ring["in_field"], ring["coeff"]
    assert inp.fill == Extent(i=(-2, 2), j=(-2, 2)) and coeff.fill == Extent()
    assert (inp.fp.j[0], cuda_codegen.PL_TJ + inp.fp.j[1]) == in_cols and inp.cols % w == 0
    assert inp.rows == 20 and (coeff.rows, coeff.cols) == (16, 64)
    patched = _bodies(module.source)["gt_plane_0_r"]
    assert f"gt_q < {20 * in_vectors} && " in patched
    assert f"gt_q < {16 * 64 // w} && " in patched
    assert f"gt_cp_async{w * size}(gt_d + {inp.meta.var}_d0, gt_g + {inp.meta.var}_o0);" in patched
    for b in plan.planes + plan.ring:  # every plane's rows start on a vector
        assert b.fp.j[0] % w == 0 and b.cols % w == 0 and b.offset % 16 == 0
    # which elements a copy moves is worked out once a block, not at each level
    setup, fetch = patched.split("auto gt_tfetch", 1)
    fetch = fetch.split("gt_cp_commit();", 1)[0]
    assert "gt_lo" in setup and "gt_lo" not in fetch and "gt_q" not in fetch
    assert f"if ({inp.meta.var}_f0 & 1u) " in fetch


@pytest.mark.parametrize(
    "width, itemsize, address, strides, shift",
    [
        (4, 4, 1040 * 3 + 8, (1040, 4, 1040 * 260), 2),  # the benchmark's storages
        (4, 4, 4096 + 12, (1040, 4, 1040 * 260), 3),
        (2, 8, 4096 + 8, (2080, 8, 2080 * 260), 1),
        (8, 2, 4096 + 6, (528, 2, 528 * 260), 3),
        (4, 4, 4096, (1044, 4, 1044 * 260), None),  # a row pitch of no whole vectors
        (4, 4, 4096, (1040, 4, 1040 * 260 + 4), None),  # nor a level pitch
        (4, 4, 4096, (1040, 320, 4), None),  # J is not the contiguous axis
        (4, 4, 4098, (1040, 4, 1040 * 260), None),  # an element cut by its alignment
        (1, 1, 4096, (64, 1, 64 * 64), None),  # no vector: a bool kernel
    ],
)
def test_patch_shift_decides_vector_or_fallback(width, itemsize, address, strides, shift):
    assert cuda_codegen.patch_shift(width, itemsize, address, strides) == shift


def test_patch_word_marks_the_fields_on_the_tiles_vectors():
    """The word: bit 0 no overlap, the shift of the first field with a
    vector path, a bit for each field whose vectors start there too;
    ``patched`` only where every field has its bit."""
    layout = cuda_codegen.PatchLayout(4, (("a", 4), ("b", 4), ("c", 4)))
    row, level = (1040, 4, 1040 * 260), 8192
    at = {"a": (level + 8, row), "b": (2 * level + 8, row), "c": (3 * level + 8, row)}
    word = layout.word(1, at)
    assert word == 1 | 2 << 1 | 0b111 << cuda_codegen.PATCH_MASK_AT and layout.patched(word)
    odd = dict(at, b=(2 * level + 8, (1044, 4, 1044 * 260)))
    word = layout.word(1, odd)
    assert word == 1 | 2 << 1 | 0b101 << cuda_codegen.PATCH_MASK_AT and not layout.patched(word)
    other = dict(at, a=(level, (1044, 4, 1044 * 260)), c=(3 * level + 4, row))
    word = layout.word(1, other)  # a falls back; b sets the shift; c starts elsewhere
    assert word == 1 | 2 << 1 | 0b010 << cuda_codegen.PATCH_MASK_AT and not layout.patched(word)
    assert layout.word(0, at) == 0 and not layout.patched(0)
    assert not cuda_codegen.PatchLayout(1, ()).patched(1)


def test_patch_word_sends_a_half_field_off_the_vectors_to_the_plain_kernel():
    """A half field off the tiles' vectors makes the word 0, the launch the
    plain-pointer kernel's (which reads it faster than the patches' element
    path); a 4- or 8-byte field off them keeps the patches."""
    layout = cuda_codegen.PatchLayout(2, (("a", 2), ("b", 2), ("c", 4)))
    at = {"a": (4096 + 2, (520, 2, 520 * 260)), "b": (8192 + 2, (520, 2, 520 * 260)),
          "c": (16384, (1040, 4, 1040 * 260))}  # c off the vectors: 4 bytes, kept
    word = layout.word(1, at)
    assert word == 1 | 1 << 1 | 0b011 << cuda_codegen.PATCH_MASK_AT and not layout.patched(word)
    assert layout.word(1, dict(at, b=(8192 + 2, (522, 2, 522 * 260)))) == 0  # a row pitch of 261
    assert layout.word(1, dict(at, b=(8192, (520, 2, 520 * 260)))) == 0  # vectors elsewhere
    assert layout.word(1, {"a": at["a"], "c": at["c"]}) & 1  # b absent: nothing to read


def test_prepared_launch_words_from_the_buffers():
    """The prepared launch makes each launcher's word from its buffers'
    addresses, strides and origins: hdiff on storages whose rows are whole
    vectors takes every field's vector path; a coeff that is a view of a
    wider buffer (a row pitch of no whole vectors) falls back alone."""
    backend = _cpu_backend()  # float64: vectors of 2
    names = [n for n, i in backend.analyzed.field_infos.items() if i is not None]
    arrays = {n: storage.zeros((12, 12, 4), np.float64, backend="cuda:hopper", device="cpu").array
              for n in names}
    dom, orig = (8, 8, 4), {n: (2, 3, 0) for n in names}
    launch = backend.prepared(arrays, dom, orig)
    layout = backend.module.patches["gt_launch_0"]
    word = launch.words["gt_launch_0"]
    assert word >> 1 & 7 == (arrays[layout.fields[0][0]].data_ptr() // 8 + 3) % 2
    assert layout.patched(word)
    wide = storage.zeros((12, 13, 4), np.float64, backend="cuda:hopper", device="cpu").array
    launch = backend.prepared(dict(arrays, coeff=wide[:, :12]), dom, orig)
    bit = [n for n, _ in layout.fields].index("coeff")
    assert not launch.words["gt_launch_0"] >> cuda_codegen.PATCH_MASK_AT & 1 << bit
    assert not layout.patched(launch.words["gt_launch_0"])


def test_patch_stores_whole_vectors_only_where_no_read_can_tell():
    """hdiff: lap, which one unmasked statement writes whole, is stored as
    whole vectors; out_field as one vector a patch row in an inner tile of
    a field on the tiles' vectors, else point by point within its extent. A
    temporary written under a mask, an API field written in a region, and a
    ``while`` go point by point."""
    gen, module = _plane_generator(
        defs.horizontal_diffusion_generic, dtypes={"dt": np.float32}, literal_float_precision=32
    )
    patched = _bodies(module.source)["gt_plane_0_r"]
    lap, out = gen.fields["lap_field"].var, gen.fields["out_field"].var
    assert f"*(float2*)({lap}_s + {lap}_x + (0)) = make_float2(gt_v0_0, gt_v0_1);" in patched
    assert f"if ({out}_v && gt_inner) {{" in patched
    assert f"*(float2*)({out}_b + (1 * {out}_si4 + 0)) = make_float2(gt_v1_0, gt_v1_1);" in patched
    assert "if (i >= (0) && i < ni + (0) && j >= (0) && j < nj + (0)) " in patched
    _, masked = _plane_generator(_masked_temporary)
    body = _bodies(masked.source)["gt_plane_0_r"]
    assert "*(double2*)(t" not in body and "&& gt_m0_1) t" in body
    _, region = _plane_generator(defs.region_interaction)
    assert "*(double2*)(" in _bodies(region.source)["gt_plane_0_r"]  # out = inp, unmasked
    assert " && (i >= 0) && (i < 2)) (*(double*)(" in _bodies(region.source)["gt_plane_0_r"]
    _, newton = _plane_generator(defs.newton_sqrt_while)
    body = _bodies(newton.source)["gt_plane_0_r"]
    assert "while (" in body and "const int gt_di = gt_r + (1), gt_dj = gt_c + (1)" not in body
    assert "const int gt_di = gt_r + (0), gt_dj = gt_c + (1)" in body


# --- float16: stored half, computed in float32 -------------------------------------


def _half_module(name, monkeypatch):
    definition, kernel, fuse = defs.HALF_STENCILS[name]
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    module = _backend(definition, dtypes={"dt": np.float16}).module
    assert module.strategy == kernel
    return module


#: every way a generated source may touch a half value: loads, stores and
#: the conversion intrinsics
_HALF_FORMS = re.compile(
    r"__half2float\(\*\(const __half\*\)|__half2float\(__ushort_as_half\(|"
    r"\*\(__half\*\)\(|__half_as_ushort\(__float2half_rn\(|__float2half_rn\(|<cuda_fp16.h>"
)


@pytest.mark.parametrize("name", sorted(defs.HALF_STENCILS))
def test_half_sources_convert_with_intrinsics(name, monkeypatch):
    """Every float16 field is loaded with __half2float and stored with
    __float2half_rn; no __half value takes part in arithmetic, every value
    is computed as float, and no 2-byte stream is copied with cp.async:
    only plane's register patches ring half fields, in vectors of 2
    elements, and copy a field's cut vectors through the thread's
    registers."""
    module = _half_module(name, monkeypatch)
    source = module.source
    assert "__half2float(" in source and "__float2half_rn(" in source
    assert "__half" not in _HALF_FORMS.sub("", source)
    for kernel, body in _bodies(source).items():
        assert "double" not in body, kernel
        copies = set(re.findall(r"gt_cp_async(\d+)\(", body))
        assert copies == ({"4"} if kernel == "gt_plane_0_r" else set()), kernel
    assert set(module.ring_bytes) == ({"gt_plane_0_r"} if module.strategy == "plane" else set())


def test_half_temporaries_live_in_float():
    """hdiff in float16: lap (flx and fly are inlined into out's
    statement) is a float plane in shared memory, its bytes those of float
    elements, in both variants; the register patches ring the half fields
    as their 16 bits, in planes of 2-byte elements."""
    gen, module = _plane_generator(defs.horizontal_diffusion_generic, dtypes={"dt": np.float16})
    for plan in (gen.plane_plans[0], gen.patch_plans[0].planes):
        assert {b.meta.name for b in plan} == {"lap_field"}
        assert all(b.meta.dtype == np.float32 for b in plan)
        for b in plan:
            assert f"float* const {b.meta.var}_s = (float*)(gt_smem + {b.offset});" in module.source
    ring = gen.tile_rings[0]
    assert {b.meta.name for b in ring} == {"in_field", "coeff"}
    for b in ring:
        assert b.size == 2 and b.bytes == -(-b.plane * b.ring * 2 // 16) * 16
        assert f"unsigned short* const {b.meta.var}_s = (unsigned short*)(gt_smem + {b.offset});" \
            in module.source
    assert set(module.ring_bytes) == {"gt_plane_0_r"}


def test_half_precision_gets_a_kernel():
    """The float16 copy the card refused is served by plane: in the plain
    variant a half load and a half store; in the register patches the
    input ringed in vectors of 2 halves, read as its 16 bits, and stored as
    vectors of packed halves (or point by point off the vectors)."""
    module = _backend(_half_precision).module
    assert module.strategy == "plane" and set(module.ring_bytes) == {"gt_plane_0_r"}
    plain, patched = _bodies(module.source)["gt_plane_0"], _bodies(module.source)["gt_plane_0_r"]
    assert "__float2half_rn(gt_v)" in plain and "__half2float(*(const __half*)(" in plain
    assert "gt_cp_async4(" in patched and "__half2float(__ushort_as_half(" in patched
    assert "= gt_pack_h(gt_v1_0, gt_v1_1);" in patched
    assert "= __float2half_rn(gt_v1_1);" in patched


def _half_math(a: F16, out: F16):
    with computation(PARALLEL), interval(...):
        out = sqrt(abs(a) + 1.0) + exp(-a) + a % 0.25 + abs(a) ** 1.5


def test_half_literals_and_math_take_float_names():
    """A float16 stencil's literals are float literals and its math calls
    the float ones."""
    body = _bodies(_backend(_half_math).module.source)["gt_plane_0"]
    for call in ("sqrtf(", "fabsf(", "expf(", "gt_fmodf_np(", "powf("):
        assert call in body, call
    assert "double" not in body and "1.0f" in body


# --- loads from device memory that a neighbouring block may have overwritten -------


@pytest.mark.parametrize(
    "definition, snapshot",
    [
        # read at other points only after its last write: no snapshot
        (defs.two_writer_sweep, set()),
        # read at other points between two writes, or before the only one
        (defs.read_between_writes_sweep, {"mid"}),
        (defs.read_before_write_sweep, {"out"}),
    ],
)
def test_load_hazard_takes_a_snapshot(definition, snapshot):
    """A plane first loaded from device memory where a read at other points
    comes before or in the level's last write loads from a copy the wrapper
    takes before the launch: a slot of the same layout, one per symbol."""
    module = _backend(definition).module
    assert module.strategy == "tiled"
    assert set(module.snapshots.get("gt_launch_0", ())) == snapshot
    snaps = {m.snapshot_of: m for m in module.slots if m.snapshot_of}
    assert set(snaps) == snapshot
    for name, m in snaps.items():
        assert f"{m.var} + " in _bodies(module.source)["gt_tiled_0"]


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
        assert gen.held[name].cross and not gen.fill[name]
    for name in set(t.name for t in gen.stencil.temporaries) - {"ccol", "dcol"}:
        assert not gen.held[name].cross and f"{gen.fields[name].var}_r = gt_v;" in kernel
    # datacol[0, 0, 1] is one carry register
    datacol = gen.fields["datacol"].var
    assert f"{datacol}_r1 = {datacol}_r;" in kernel
    assert module.min_nk == 2
    # no shared memory in the plain-pointer variant; the __restrict__ one
    # prefetches through its ring
    plain = module.source.split("gt_fused_column_0(const GtParams p)")[1].split("__global__")[0]
    assert "gt_smem" not in plain
    assert set(module.ring_bytes) == {"gt_fused_column_0_r"}
    # up, then down, in one kernel
    up = kernel.index("for (long long k = (0); k < (1); ++k)")
    down = kernel.index("for (long long k = (nk + (0)) - 1; k >= (nk + (-1)); --k)")
    assert up < down


def test_fused_column_launch_shape(fuse_stages):
    """Blocks of FC_THREADS columns, 32 along J, over the union of the
    statement extents (vadv reads wcon at i + 1); the plain-pointer variant
    without dynamic shared memory, the __restrict__ variant only under the
    wrapper's noalias flag, with its ring's bytes (vadv float64: above 48 KB,
    so first allowed them)."""
    _, module = _fused_generator("vertical_advection_dycore")
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    rows = cuda_codegen.FC_THREADS // 32
    smem = module.ring_bytes["gt_fused_column_0_r"]
    assert smem > cuda_codegen.SHARED_BYTES_MAX
    assert f"__launch_bounds__({cuda_codegen.FC_THREADS}) gt_fused_column_0(" in module.source
    assert f"const dim3 block(32, {rows});" in launcher
    assert f"/ {rows}), 1u);" in launcher
    noalias = launcher.split("if (noalias) {")[1].split("}")[0]
    assert (
        f"cudaFuncSetAttribute(gt_fused_column_0_r, cudaFuncAttributeMaxDynamicSharedMemorySize, "
        f"{smem});" in noalias
    )
    assert f"gt_fused_column_0_r<<<grid, block, {smem}," in noalias
    assert "else gt_fused_column_0<<<grid, block, 0," in launcher
    assert launcher.count("cudaFuncSetAttribute") == 1


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
    assert bool(acc.reset) == gen.fill["acc"] == restarts
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
        backend.prepared(arrays, (4, 4, 1), {})


# --- column: registers for loop-local temporaries, and the prefetch ring -------------


def _column_generator(name, **options):
    backend = _registry_backend(name, **options)
    gen = cuda_codegen._Generator(backend.analyzed)
    return gen, gen.generate()


def test_column_keeps_vadv_temporaries_in_registers(monkeypatch):
    """vadv on column: the 9 loop-local temporaries and datacol are
    registers, ccol and dcol also keep a buffer for the BACKWARD loop,
    written before it is read: the wrapper allocates no zero-filled
    temporary, and column serves every K the stencil takes. The buffers are
    allocated on a shape that the on-chip pair does not serve (taller than
    its bound)."""
    gen, module = _column_generator("vertical_advection_dycore")
    assert module.strategy == "column" and module.min_nk == 0
    assert set(gen.held) == {t.name for t in gen.stencil.temporaries}
    temps = [m for m in module.slots if m.is_temp]
    assert sorted(m.name for m in temps) == ["ccol", "dcol"]
    assert not any(m.fill for m in temps)
    assert {n for n, h in gen.held.items() if h.cross} == {"ccol", "dcol"}
    datacol = gen.held["datacol"]
    assert (datacol.writer, datacol.ring) == (1, 1)
    v = datacol.meta.var
    assert f"{v}_r1 = {v}_r;" in _kernel(module.source, "gt_column_1")
    # the wrapper: buffers for ccol and dcol, none of them zero-filled
    backend = cuda_backend.CudaHopperBackend(gen.analyzed, {})
    backend._fns = []  # nothing to build or launch here
    nk = module.on_chip["gt_launch_0"].max_nk + 1
    arrays = {n: torch.zeros(5, 4, nk, dtype=torch.float64) for n in backend.analyzed.field_infos}
    calls = []
    for fn in ("zeros", "empty"):
        real = getattr(torch, fn)
        monkeypatch.setattr(
            torch, fn, lambda *a, _fn=fn, _real=real, **k: calls.append(_fn) or _real(*a, **k)
        )
    backend.prepared(arrays, (4, 4, nk), {})
    assert calls == ["empty", "empty"]


def _temporary_in_a_while(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        tmp = inp
        while tmp < 0.5:
            tmp = tmp * 2.0 + 0.125
        out = tmp


def _temporary_read_ahead(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, -1):
            tmp = inp * 2.0
            out = tmp + tmp[0, 0, 1]
        with interval(-1, None):
            tmp = inp
            out = tmp


def _temporary_at_an_offset_later(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            tmp = inp
        with interval(1, None):
            tmp = inp + 0.5 * tmp[0, 0, -1]
    with computation(BACKWARD), interval(...):
        out = tmp[1, 0, 0] + tmp[0, 0, 1]


@pytest.mark.parametrize(
    "definition, registers, buffers",
    [
        # PARALLEL loops run statement by statement: their temporaries keep
        # zero-filled buffers as before, and so does one written in two loops
        (defs.REGISTRY["bool_elif_koffset"]["definition"], {}, {"gap": True}),
        (defs.REGISTRY["nested_conditional_locals"]["definition"], {"_mask_4": 0},
         {"fallback": True, "bump": True}),
        # the analysis merges these PARALLEL loops into the FORWARD one
        # after them: one walk, every temporary a register
        (defs.REGISTRY["dycore_smagorinsky_like"]["definition"],
         {"shear": 0, "tension": 0, "smag": 0}, {}),
        (defs.REGISTRY["temporary_stencil"]["definition"], {"tmp": 0}, {}),
        # inside a while, or read ahead of the walk: a buffer as before
        (_temporary_in_a_while, {}, {"tmp": True}),
        (_temporary_read_ahead, {}, {"tmp": True}),
        # a register in its loop, and a buffer for the later loop, which
        # reads it at a horizontal and a K offset, zero-filled where that
        # reaches beyond the levels written
        (_temporary_at_an_offset_later, {"tmp": 1}, {"tmp": True}),
        (defs.narrow_offset_read, {"flux": 1, "adv": 1}, {"flux": False, "adv": False}),
        (defs.restarted_temporary, {"acc": 1, "_mask_1": 0}, {}),
    ],
)
def test_column_registers_and_buffers(definition, registers, buffers):
    """Which temporaries column keeps in registers (with their carry
    depth), and which keep a (K, I, J) buffer, zero-filled or not."""
    backend = _backend(definition)
    assert backend.strategy == "column"
    gen = cuda_codegen._Generator(backend.analyzed)
    module = gen.generate()
    assert {n: h.ring for n, h in gen.held.items()} == registers
    assert {m.name: m.fill for m in module.slots if m.is_temp} == buffers
    assert module.min_nk == 0


def test_column_register_restarts_where_its_section_does_not_write_it():
    gen, module = _column_generator("restarted_temporary")
    acc = gen.held["acc"]
    # section 0 writes acc whole; section 1 not at all, section 2 under a mask
    assert acc.reset == {1, 2} and not acc.cross
    for body in _bodies(module.source).values():
        assert body.count(f"{acc.meta.var}_r = (double)0;") == 2


def _bodies(source):
    """kernel name -> its body."""
    out = {}
    for chunk in source.split("__global__ void __launch_bounds__(")[1:]:
        name = chunk.split(") ", 1)[1].split("(", 1)[0]
        out[name] = chunk.split('extern "C"')[0]
    return out


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["vertical_advection_dycore", "tridiagonal_solver"])
def test_ring_only_in_restrict_variants(name, fuse, monkeypatch):
    """The prefetch ring is in the __restrict__ variants and nowhere else;
    the plain-pointer variants load what they read directly, as before.
    vadv's on-chip pair (a third ``_r`` kernel, off with the switch on)
    rings both its walks."""
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    module = _registry_backend(name).module
    bodies = _bodies(module.source)
    ringed = {k for k in bodies if k.endswith("_r")}
    pairs = {oc.kernel for oc in module.on_chip.values()}
    assert len(pairs) == (name == "vertical_advection_dycore" and not fuse)
    assert set(module.ring_bytes) == ringed and len(ringed) == (1 if fuse else 2 + len(pairs))
    for kernel, body in bodies.items():
        ring = kernel in ringed
        for mark in ("gt_smem", "gt_fetch(", "gt_cp_async", "gt_cp_wait<", "gt_lds_"):
            assert (mark in body) == ring, (kernel, mark)
        # two blocks per SM: ptxas gives a ringed kernel the registers it needs
        assert (f"__launch_bounds__(256, 2) {kernel}(" in module.source) == (
            ring and kernel not in pairs)
    assert "cp.async" in module.source and "asm volatile" in module.source


def _vadv_generic(dtype, **options):
    prec = 8 * np.dtype(dtype).itemsize
    return _backend(
        defs.vertical_advection_dycore_generic, dtypes={"vadv_dt": dtype},
        externals=defs.VADV_EXTERNALS, literal_float_precision=prec,
        literal_int_precision=prec, **options,
    )


def test_on_chip_pair_of_vadv_only_in_the_restrict_path():
    """vadv's FORWARD and BACKWARD walks in one kernel, ``gt_column_0_1_r``
    (named ``gt_column*``, so a trace counts it with the column kernels):
    loop 0's launcher launches it under the no-overlap check and the rule's
    bound on nk, and loop 1's launcher then launches nothing. It keeps ccol
    and dcol in the slab (no pointer to their buffers, no store to device
    memory); the plain-pointer kernels keep their buffers as before."""
    module = _registry_backend("vertical_advection_dycore").module
    oc = module.on_chip["gt_launch_0"]
    assert list(module.on_chip) == ["gt_launch_0"]
    assert (oc.kernel, oc.cross) == ("gt_column_0_1_r", ("ccol", "dcol"))
    assert oc.kernel.startswith("gt_column")
    bodies = _bodies(module.source)
    assert set(bodies) == {"gt_column_0", "gt_column_0_r", "gt_column_0_1_r", "gt_column_1",
                           "gt_column_1_r"}
    first = module.source.split('extern "C" int gt_launch_0(')[1].split('extern "C"')[0]
    second = module.source.split('extern "C" int gt_launch_1(')[1].split('extern "C"')[0]
    rule = f"if (noalias && nk <= {oc.max_nk})"
    assert rule in first and first.index(rule) < first.index(f"{oc.kernel}<<<")
    assert f"{rule} return {cuda_codegen.NOTHING_LAUNCHED};" in second
    assert oc.kernel not in second
    slots = {m.name: m.var for m in module.slots}
    head = module.source.split(f"{oc.kernel}(const GtParams p")[1].split(") {")[0]
    for name in oc.cross:
        assert f" {slots[name]}" not in head and f"{slots[name]}_s" not in bodies[oc.kernel]
        assert f" {slots[name]}" in module.source.split("gt_column_0_r(const GtParams p")[1].split(") {")[0]
    assert bodies[oc.kernel].count("(*(double*)(gt_slab + (unsigned)(k) * ") >= 4
    for kernel in ("gt_column_0", "gt_column_0_r", "gt_column_1", "gt_column_1_r"):
        assert "gt_slab" not in bodies[kernel]
    assert f"__launch_bounds__({32 * cuda_codegen.ON_CHIP_ROWS}, 1) {oc.kernel}(" in module.source


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_on_chip_slab_bytes(dtype):
    """The slab holds nk levels of ccol and dcol for every column of the
    block, [k][value][thread], after the ring: nk × columns × 2 × item size;
    the launcher asks for the ring's bytes and that, and allows them above
    48 KB."""
    module = _vadv_generic(dtype).module
    oc = module.on_chip["gt_launch_0"]
    columns = 32 * cuda_codegen.ON_CHIP_ROWS
    item = np.dtype(dtype).itemsize
    for nk in (1, 80, oc.max_nk):
        assert nk * oc.level_bytes == nk * columns * 2 * item
        assert oc.shared_bytes(nk) == oc.ring_bytes + nk * columns * 2 * item
    assert oc.ring_bytes == module.ring_bytes[oc.kernel]
    launcher = module.source.split('extern "C" int gt_launch_0(')[1]
    assert f"const int gt_smem = {oc.ring_bytes} + (int)nk * {oc.level_bytes};" in launcher
    assert f"cudaFuncSetAttribute({oc.kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, gt_smem)" in launcher
    body = _bodies(module.source)[oc.kernel]
    assert f"unsigned char* const gt_slab = gt_smem + {oc.ring_bytes};" in body
    ct = "float" if dtype == np.float32 else "double"
    for offset in (0, columns * item):  # ccol, then dcol
        assert f"(*({ct}*)(gt_slab + (unsigned)(k) * {oc.level_bytes}u + {offset}u + gt_tid * {item}u))" in body


def _resident_bytes(oc, nk, item):
    """What the rule counts at ``nk`` levels: the columns the block's shared
    memory leaves resident on an SM, times the streams' item size."""
    blocks = cuda_codegen.SM_SHARED_BYTES // (oc.shared_bytes(nk) + cuda_codegen.BLOCK_RESERVED_BYTES)
    return blocks * 32 * cuda_codegen.ON_CHIP_ROWS * item


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_on_chip_bound_follows_the_rule(dtype):
    """The launcher takes the pair up to the largest nk at which slab and
    ring fit a block and leave ``ON_CHIP_RESIDENT_BYTES`` resident, and the
    two launches above it (a tall nk) or for overlapping arguments; vadv at
    the benchmark's 80 levels takes it in float32 and float64."""
    module = _vadv_generic(dtype).module
    oc = module.on_chip["gt_launch_0"]
    item = np.dtype(dtype).itemsize
    assert oc.shared_bytes(oc.max_nk) <= cuda_codegen.SHARED_BYTES_LIMIT
    assert _resident_bytes(oc, oc.max_nk, item) >= cuda_codegen.ON_CHIP_RESIDENT_BYTES
    assert _resident_bytes(oc, oc.max_nk + 1, item) < cuda_codegen.ON_CHIP_RESIDENT_BYTES
    assert oc.serves(80, True) and oc.serves(oc.max_nk, True)
    assert not oc.serves(oc.max_nk + 1, True) and not oc.serves(160, True)
    assert not oc.serves(80, False)
    assert module.kernels_per_call(80, True) == 1
    assert module.kernels_per_call(oc.max_nk + 1, True) == module.kernels_per_call(80, False) == 2


def test_on_chip_bound_takes_the_two_launches_for_float64_where_the_rule_says_so():
    """float64 doubles the slab: at 100 levels the block leaves 64 columns
    resident, 512 bytes a level, and the launcher keeps the two kernels,
    where float32 still takes the pair."""
    f64 = _vadv_generic(np.float64).module.on_chip["gt_launch_0"]
    f32 = _vadv_generic(np.float32).module.on_chip["gt_launch_0"]
    assert _resident_bytes(f64, 100, 8) == 512 < cuda_codegen.ON_CHIP_RESIDENT_BYTES
    assert not f64.serves(100, True) and f32.serves(100, True)


def _pair_with_temporary(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -1]
    with computation(BACKWARD):
        with interval(-1, None):
            out = acc
        with interval(0, -1):
            out = acc + 0.25 * out[0, 0, 1]


def _pair_reads_a_neighbour_the_backward_loop_writes(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        acc = inp + out[1, 0, 0]
    with computation(BACKWARD), interval(...):
        out = acc


def _pair_value_read_by_a_later_loop(inp: F64, out: F64, out2: F64):
    with computation(FORWARD), interval(...):
        acc = inp * 2.0
    with computation(BACKWARD), interval(...):
        out = acc
    with computation(PARALLEL), interval(...):
        out2 = acc + 1.0


def _pair_with_a_k_field(inp: F64, w: FK, out: F64):
    with computation(FORWARD), interval(...):
        acc = inp * w
    with computation(BACKWARD), interval(...):
        out = acc


def _pair_with_a_while(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        acc = inp
        while acc < 0.5:
            acc = acc * 2.0 + 0.125
    with computation(BACKWARD), interval(...):
        out = acc


def test_on_chip_pair_serves_a_forward_backward_temporary():
    """A FORWARD loop whose register a BACKWARD loop reads at its own
    column takes the pair, as vadv does."""
    module = _backend(_pair_with_temporary).module
    assert module.strategy == "column"
    assert {k: oc.cross for k, oc in module.on_chip.items()} == {"gt_launch_0": ("acc",)}


@pytest.mark.parametrize(
    "definition",
    [
        defs.REGISTRY["tridiagonal_solver"]["definition"],  # API fields cross
        _temporary_at_an_offset_later,  # read at a horizontal offset, zero-filled
        _pair_reads_a_neighbour_the_backward_loop_writes,
        _pair_value_read_by_a_later_loop,
        _pair_with_a_k_field,
        _pair_with_a_while,
    ],
)
def test_on_chip_pair_declined(definition):
    """Two launches where a BACKWARD loop reads an API field the FORWARD
    one wrote, a value at another column or one a later loop reads too, or
    K4's other conditions fail (a lower-dimensional field, a while)."""
    module = _backend(definition).module
    assert module.strategy == "column" and module.on_chip == {}
    assert "gt_slab" not in module.source


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_on_chip_pair_only_for_vadv_in_the_registry(name):
    """Of the registry, only vadv takes the pair: single-loop stencils,
    PARALLEL loops, tridiag and read_ahead_sweep keep their launches."""
    module = _registry_backend(name).module
    assert (module.on_chip != {}) == (name == "vertical_advection_dycore")


def test_on_chip_pair_not_with_the_fusion_switch(fuse_stages):
    """fused_column (the switch on) is one launch already and unchanged."""
    module = _registry_backend("vertical_advection_dycore").module
    assert module.strategy == "fused_column" and module.on_chip == {}
    assert "gt_slab" not in module.source


def test_prepared_launch_allocates_no_buffer_the_pair_keeps_on_chip(monkeypatch):
    """On a shape the pair serves, ``prepared`` allocates no ccol or dcol
    buffer (their pointers stay null: the pair never reads them) and counts
    one kernel a call; with overlapping arguments (the plain-pointer
    kernels) it allocates both and counts two."""
    backend = _cpu_backend("vertical_advection_dycore")
    names = [n for n, i in backend.analyzed.field_infos.items() if i is not None]
    arrays = {n: torch.zeros(5, 4, 6, dtype=torch.float64) for n in names}
    temps = [m for m in backend.module.slots if m.is_temp]
    calls = []
    real = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: calls.append(a) or real(*a, **k))
    launch = backend.prepared(arrays, (4, 4, 6), {})
    assert calls == [] and backend._scratch == {}
    assert launch.on_chip == {"gt_launch_0"} and launch.kernels == 1
    assert [launch.ptrs[m.index] for m in temps] == [None, None]
    monkeypatch.setattr(cuda_backend, "overlapping", lambda arrays: [("", "")])
    other = {n: torch.zeros(5, 4, 6, dtype=torch.float64) for n in names}
    launch = backend.prepared(other, (4, 4, 6), {})
    assert len(calls) == 2 and len(backend._scratch) == 2
    assert launch.on_chip == frozenset() and launch.kernels == 2


def test_ring_nowhere_but_the_column_walks():
    """The column ring (``gt_fetch``) is in column and fused_column sources
    alone, and not in column loops that walk no level (PARALLEL); plane,
    fused_plane and tiled sources carry the tile ring (``gt_tfetch``) in
    their __restrict__ variants only, and a plane source without one (no
    3-D field of 4 or 8 bytes read) no ``cp.async`` at all."""
    for name, entry in defs.REGISTRY.items():
        module = _registry_backend(name).module
        if entry["strategy"] not in ("column", "fused_column"):
            assert "gt_fetch(" not in module.source, name
        if entry["strategy"] == "plane" and not module.ring_bytes:
            assert "cp.async" not in module.source, name
        for kernel, body in _bodies(module.source).items():
            assert ("gt_tfetch(" in body) == (kernel in module.ring_bytes and entry["strategy"] in (
                "plane", "fused_plane", "tiled")), (name, kernel)
    heat = _registry_backend("heat_step").module
    assert set(heat.ring_bytes) == {"gt_column_1_r", "gt_column_2_r"}


def _ring(name, n, **options):
    gen, _ = _column_generator(name, **options)
    return gen._plan_ring(n, Extent.zeros(), cuda_codegen.COL_BJ * cuda_codegen.COL_BI)


def test_ring_streams_of_vadv():
    """vadv's FORWARD walk: six streams, wcon at i and i + 1 each its own,
    u_stage read a level behind and ahead; the BACKWARD walk reads ccol and
    dcol back (a later loop's buffers) and u_pos; datacol is a register."""
    up = _ring("vertical_advection_dycore", 0)
    assert {(s.meta.name, s.di, s.dj) for s in up.streams} == {
        ("utens_stage", 0, 0), ("u_stage", 0, 0), ("wcon", 0, 0), ("wcon", 1, 0),
        ("u_pos", 0, 0), ("utens", 0, 0),
    }
    assert (up.back, up.ahead, up.slots) == (1, 1, cuda_codegen.RING_LEVELS + 1)
    down = _ring("vertical_advection_dycore", 1)
    assert {s.meta.name for s in down.streams} == {"ccol", "dcol", "u_pos"}
    assert (down.back, down.ahead, down.backward) == (0, 0, True)


def test_ring_streams_what_a_walk_writes_only_before_its_first_write():
    """tridiag's FORWARD walk streams sup and rhs at its own level, read
    before the level writes them (their values from before the loop); the
    level below, which the thread wrote, stays a direct load."""
    up = _ring("tridiagonal_solver", 0)
    assert {s.meta.name for s in up.streams} == {"inf", "diag", "sup", "rhs"}
    assert (up.back, up.ahead) == (0, 0)
    module = _registry_backend("tridiagonal_solver").module
    body = _bodies(module.source)["gt_column_0_r"]
    sup = next(m.var for m in module.slots if m.name == "sup")
    assert f"gt_clampk({sup}_ok + k + (-1), {sup}_nk) * {sup}_sk" in body  # direct
    assert f"*(double*)({sup} + ({sup}_oi + i + (0)) * {sup}_si + ({sup}_oj + j + (0)) * " \
        f"{sup}_sj + ({sup}_ok + k) * {sup}_sk)) = " in body  # the store
    assert body.count(f"({sup}_ok + k) * {sup}_sk") == 2  # two stores, no load
    down = _ring("tridiagonal_solver", 1)
    assert {s.meta.name for s in down.streams} == {"rhs", "sup"}  # out[0, 0, 1]: direct


def test_ring_reads_ahead_of_the_walk_of_a_written_field_stay_direct():
    gen, module = _column_generator("read_ahead_sweep")
    up = gen._plan_ring(0, Extent.zeros(), 256)
    assert {s.meta.name for s in up.streams} == {"inp", "out"} and up.ahead == 0
    out = next(m.var for m in module.slots if m.name == "out")
    assert f"gt_clampk({out}_ok + k + (1), {out}_nk)" in _bodies(module.source)["gt_column_0_r"]


def test_ring_copies_are_guarded_by_extent():
    """narrow_offset_read: the loop's columns reach one beyond the domain on
    both sides (flux), wind is read at i + 1 only where adv is computed, so
    its copies are guarded by adv's extent; inp's are not guarded."""
    module = _registry_backend("narrow_offset_read").module
    body = _bodies(module.source)["gt_column_0_r"]
    copies = [line.strip() for line in body.splitlines() if "gt_cp_async8(" in line]
    wind = next(m.var for m in module.slots if m.name == "wind")
    inp = next(m.var for m in module.slots if m.name == "inp")
    fields = dict(re.findall(r"const char\* const gt_g(\d+) = (\w+) \+", body))
    field = lambda copy: fields[re.search(r"gt_cp_async8\(gt_q(\d+) ", copy).group(1)]  # noqa: E731
    guarded = [c for c in copies if c.startswith("if (i >= (0) && i < ni + (0)) gt_cp_async8(")]
    assert len(copies) == 3 and len(guarded) == 2
    assert all(field(c) == wind for c in guarded)
    assert any(c.startswith("gt_cp_async8(") and field(c) == inp for c in copies)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["vertical_advection_dycore", "tridiagonal_solver",
                                  "narrow_offset_read"])
def test_ring_copies_step_a_level_a_fetch(name, fuse, monkeypatch):
    """Every ringed walk (``column``'s, ``fused_column``'s and the on-chip
    pair's) copies each stream from an address that starts at the level of
    its first fetch (``back`` levels behind the walk's first) and steps one
    level a fetch, in the walk's direction, as ``gt_k`` does; the slot
    starts at 0 and steps one a fetch, wrapping at the slots the reads
    index. Only a level outside some stream's field (``gt_klo``, ``gt_khi``:
    the tightest bounds of every field the walk streams) computes clamped
    addresses, on a branch marked unlikely."""
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    module = _registry_backend(name).module
    walked = set()
    for kernel, body in _bodies(module.source).items():
        for chunk in body.split("const long long gt_w0")[1:]:
            chunk = chunk.split("const long long gt_w0")[0]
            fetch = chunk.split("auto gt_fetch")[1].split("};")[0]
            (start,) = re.findall(r"for \(int gt_f = (-?\d+); gt_f < \d+; \+\+gt_f\) gt_fetch", chunk)
            back = -int(start)
            (sign,) = re.findall(r"const long long gt_k = gt_w0 ([+-]) gt_f;", fetch)
            behind = "-" if sign == "+" else "+"
            streams = dict(re.findall(r"const char\* const gt_g(\d+) = (\w+) \+", chunk))
            assert streams, kernel
            for q, v in streams.items():
                assert f"const char* gt_a{q} = gt_g{q} + ({v}_ok + gt_w0 {behind} {back}) * {v}_sk;" in chunk
                assert fetch.count(f"gt_a{q} {sign}= {v}_sk;") == 1
                assert re.search(rf"gt_cp_async\d\(gt_q{q} \+ gt_s \* \d+u, gt_c{q}\);", fetch)
            fields = set(streams.values())
            first = re.search(r"long long gt_klo = -(\w+)_ok, gt_khi = (\w+)_nk - \w+_ok;", chunk).groups()
            assert first[0] == first[1] and first[0] in fields
            for v in fields - {first[0]}:
                assert f"if (-{v}_ok > gt_klo) gt_klo = -{v}_ok;" in chunk
                assert f"if ({v}_nk - {v}_ok < gt_khi) gt_khi = {v}_nk - {v}_ok;" in chunk
            edge = fetch.split("if (__builtin_expect(gt_k < gt_klo || gt_k >= gt_khi, 0)) {")[1]
            edge = edge.split("}")[0]
            assert fetch.count("gt_clampk(") == edge.count("gt_clampk(") == len(streams)
            assert "unsigned gt_s = 0u;" in chunk
            (last,) = re.findall(r"gt_s = gt_s == (\d+)u \? 0u : gt_s \+ 1u;", fetch)
            assert set(re.findall(r"\(unsigned\)\(gt_p \+ \d+\) % (\d+)u", chunk)) == {str(int(last) + 1)}
            walked.add(kernel)
    assert walked == set(module.ring_bytes)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_shared_memory_per_block(dtype):
    """[slot][stream][thread]: RING_LEVELS slots, plus one per level behind
    the walk its reads reach, of every stream for the block's 256 columns;
    above 48 KB the launcher first allows them."""
    backend = _backend(
        defs.vertical_advection_dycore_generic, dtypes={"vadv_dt": dtype},
        externals=defs.VADV_EXTERNALS,
    )
    module = backend.module
    size = np.dtype(dtype).itemsize
    threads = cuda_codegen.COL_BJ * cuda_codegen.COL_BI
    levels = cuda_codegen.RING_LEVELS
    # the BACKWARD walk streams u_pos and the buffers of ccol and dcol,
    # which type inference makes float64 in either case; the on-chip pair's
    # walks share one region, and its BACKWARD walk streams u_pos alone
    up, down = cuda_codegen.ON_CHIP_RING_LEVELS
    pair = cuda_codegen.ON_CHIP_ROWS * 32
    assert module.ring_bytes == {
        "gt_column_0_r": (levels + 1) * 6 * size * threads,
        "gt_column_1_r": levels * (size + 2 * 8) * threads,
        "gt_column_0_1_r": max((up + 1) * 6 * size * pair, down * size * pair),
    }
    for n in range(2):
        kernel = f"gt_column_{n}_r"
        smem = module.ring_bytes[kernel]
        launcher = module.source.split(f'extern "C" int gt_launch_{n}(')[1]
        assert f"{kernel}<<<grid, block, {smem}," in launcher
        allowed = f"cudaFuncSetAttribute({kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});"
        assert (allowed in launcher) == (smem > cuda_codegen.SHARED_BYTES_MAX)


def _many_streams(inp: F64, out: F64):
    with computation(FORWARD), interval(...):
        out = (
            inp[-7, 0, 0] + inp[-6, 0, 0] + inp[-5, 0, 0] + inp[-4, 0, 0] + inp[-3, 0, 0]
            + inp[-2, 0, 0] + inp[-1, 0, 0] + inp[0, 0, 0] + inp[1, 0, 0] + inp[2, 0, 0]
            + inp[3, 0, 0] + inp[4, 0, 0] + inp[5, 0, 0] + inp[6, 0, 0] + inp[7, 0, 0]
            + inp[0, -7, 0] + inp[0, -6, 0] + inp[0, -5, 0] + inp[0, -4, 0] + inp[0, -3, 0]
            + inp[0, -2, 0] + inp[0, -1, 0] + inp[0, 1, 0] + inp[0, 2, 0] + inp[0, 3, 0]
            + inp[0, 4, 0] + inp[0, 5, 0] + inp[0, 6, 0] + inp[0, 7, 0]
        )


def test_ring_keeps_within_its_budget():
    """29 streams of float64 would take RING_LEVELS × 29 × 8 B × 256 =
    232 KB: the walk rings the first 14 it reads (112 KB, within
    RING_BYTES_MAX, so two blocks fit an SM) and loads the other 15
    directly; column serves it as it did before the ring."""
    backend = _backend(_many_streams)
    assert backend.strategy == "column" and backend.unsupported is None
    threads = cuda_codegen.COL_BJ * cuda_codegen.COL_BI
    stream = cuda_codegen.RING_LEVELS * 8 * threads
    kept = cuda_codegen.RING_BYTES_MAX // stream
    assert kept == 14
    assert backend.module.ring_bytes == {"gt_column_0_r": kept * stream}
    ring = cuda_codegen._Generator(backend.analyzed)._plan_ring(0, Extent.zeros(), threads)
    assert [(s.di, s.dj) for s in ring.streams] == [(d, 0) for d in range(-7, 7)]
    body = _bodies(backend.module.source)["gt_column_0_r"]
    assert body.count("gt_cp_async8(") == kept and body.count("gt_lds_double(") == kept
    inp = next(m.var for m in backend.module.slots if m.name == "inp")
    assert body.count(f"({inp}_ok + k) * {inp}_sk") == 29 - kept  # direct


def _far_behind(inp: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 6):
            out = inp
        with interval(6, None):
            out = inp + inp[0, 0, -1] + inp[0, 0, -6]


def test_ring_leaves_reads_far_behind_the_walk_direct():
    """A read RING_LEVELS or more levels behind the walk would add a slot to
    every stream for each level: it stays a direct load, as a read that far
    ahead does."""
    backend = _backend(_far_behind)
    threads = cuda_codegen.COL_BJ * cuda_codegen.COL_BI
    ring = cuda_codegen._Generator(backend.analyzed)._plan_ring(0, Extent.zeros(), threads)
    assert (ring.back, ring.slots) == (1, cuda_codegen.RING_LEVELS + 1)
    inp = next(m.var for m in backend.module.slots if m.name == "inp")
    body = _bodies(backend.module.source)["gt_column_0_r"]
    assert f"gt_clampk({inp}_ok + k + (-6), {inp}_nk)" in body
    assert f"gt_clampk({inp}_ok + k + (-1), {inp}_nk)" not in body


def test_ring_beyond_the_card_names_the_bytes(monkeypatch):
    """Where not even one stream fits a block's budget, the stencil is
    refused, naming the bytes."""
    backend = _backend(_many_streams)
    monkeypatch.setattr(cuda_codegen, "RING_BYTES_MAX", 4096)
    need = cuda_codegen.RING_LEVELS * 8 * cuda_codegen.COL_BJ * cuda_codegen.COL_BI
    with pytest.raises(CudaUnsupported, match=f"needs {need} bytes of shared memory per block"):
        cuda_codegen._Generator(backend.analyzed).generate()


def _walk_rings(body):
    """Each walk's ring as the kernel body lays it out: (slots, slot bytes,
    [(offset, pitch, item size) per stream])."""
    walks = []
    for chunk in body.split("const long long gt_w0")[1:]:
        streams = {
            q: (int(off), int(pitch))
            for q, off, pitch in re.findall(
                r"const unsigned gt_q(\d+) = gt_sm \+ (\d+)u \+ gt_tid \* (\d+)u;", chunk
            )
        }
        sizes = dict((q, int(n)) for n, q in re.findall(r"gt_cp_async(\d)\(gt_q(\d+) ", chunk))
        (slot_bytes,) = set(re.findall(r"\+ gt_s \* (\d+)u", chunk))
        (last,) = re.findall(r"gt_s = gt_s == (\d+)u \? 0u : gt_s \+ 1u;", chunk)
        walks.append((int(last) + 1, int(slot_bytes), [(*streams[q], sizes[q]) for q in streams]))
    return walks


def _thread_bytes(walks, threads):
    """byte of the shared region -> the threads whose ring elements cover
    it, over every walk of one kernel."""
    owners = {}
    for slots, slot_bytes, streams in walks:
        for slot in range(slots):
            for offset, pitch, size in streams:
                for t in range(threads):
                    at = slot * slot_bytes + offset + t * pitch
                    for b in range(at, at + size):
                        owners.setdefault(b, set()).add(t)
    return owners


@pytest.mark.parametrize(
    "name, dtypes",
    [(name, None) for name in sorted(defs.FUSED_STAGES)]
    + [("vertical_advection_dycore_generic", np.float32),
       ("vertical_advection_dycore_generic", np.float64)],
)
def test_fused_column_walks_keep_each_thread_on_its_own_bytes(name, dtypes, fuse_stages):
    """fused_column's walks reuse one region of shared memory with no
    barrier between them: in the kernel's source, no byte of it is any two
    threads' in any two walks. vadv with float32 fields streams float32 in
    the FORWARD walk and float64 (ccol, dcol) in the BACKWARD one, so every
    stream takes 8 B a thread there."""
    if dtypes is None:
        backend = _registry_backend(name)
    else:
        backend = _backend(
            defs.vertical_advection_dycore_generic, dtypes={"vadv_dt": dtypes},
            externals=defs.VADV_EXTERNALS,
        )
    assert backend.strategy == "fused_column"
    body = _bodies(backend.module.source)["gt_fused_column_0_r"]
    walks = _walk_rings(body)
    assert bool(walks) == bool(backend.module.ring_bytes)
    owners = _thread_bytes(walks, cuda_codegen.FC_THREADS)
    assert all(len(t) == 1 for t in owners.values())
    assert max(owners, default=-1) < backend.module.ring_bytes.get("gt_fused_column_0_r", 0)
    sizes = {size for _, _, streams in walks for *_, size in streams}
    pitches = {pitch for _, _, streams in walks for _, pitch, _ in streams}
    assert (sizes == {4, 8}) == (dtypes is np.float32)
    assert pitches == ({8} if dtypes is np.float32 else sizes)


def test_fused_column_fences_before_streaming_its_own_stores(fuse_stages):
    """tridiag on fused_column: the BACKWARD walk streams sup and rhs, which
    the same thread stored in the FORWARD walk: a fence comes first."""
    _, module = _fused_generator("tridiagonal_solver")
    body = _bodies(module.source)["gt_fused_column_0_r"]
    down = body.split("__threadfence();")[1]
    assert body.count("__threadfence();") == 1 and down.count("gt_cp_async8(") == 2
    assert "__threadfence" not in _bodies(module.source)["gt_fused_column_0"]


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
    # API fields may alias: only the variant launched where they do not
    # takes them as __restrict__
    assert "restrict" not in _bodies(source)["gt_plane_0"]
    assert "gt_plane_0_r(const GtParams p, const char* __restrict__ f0" in source


def test_column_restrict_variant_only_when_noalias():
    """The column kernel's __restrict__ variant is launched only under the
    wrapper's noalias flag; the default variant takes plain pointers."""
    backend = _backend(defs.tridiagonal_solver)
    source = backend.module.source
    for n in range(2):
        plain = source.split(f"gt_column_{n}(const GtParams p)")[1].split("__global__")[0]
        assert "restrict" not in plain
        launcher = source.split(f'extern "C" int gt_launch_{n}(')[1].split("cudaGetLastError")[0]
        noalias, other = launcher.split("if (noalias)")[1].split("else ")
        assert f"gt_column_{n}_r<<<" in noalias
        assert f"gt_column_{n}<<<grid, block, 0," in other
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
    """A cooperative launcher walks every level in one launch: the wrapper
    counts one launch a call, raises on a refused launch (a grid larger than
    what is resident at once: cudaErrorCooperativeLaunchTooLarge, 82), and
    counts nothing on an empty grid. (The name is the one the test had when
    a launcher launched once per level.)"""
    wrapper = cuda_backend.KernelWrapper("probe")
    wrapper.launch(lambda *a: 0, (1, 2))
    assert wrapper.launches == 1
    with pytest.raises(RuntimeError, match="CUDA error 82"):
        wrapper.launch(lambda *a: 82, (1, 2))
    wrapper.launch(lambda *a: cuda_codegen.NOTHING_LAUNCHED, (1, 2))
    wrapper.launch(lambda *a: 0, ())
    assert wrapper.launches == 2


def test_per_level_launcher_abi_takes_the_count_pointer():
    """A cooperative launcher takes the tiles' level counters as a trailing
    pointer (the name is the one the test had when that pointer was the
    count of launches); the wrapper gives it an int32 buffer, one element
    per tile."""

    class FakeLib:
        gt_launch_0 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    fn = cuda_backend._bind(FakeLib(), "gt_launch_0", cooperative=True)
    assert fn.argtypes[-3] is ctypes.c_void_p  # the stream
    assert fn.argtypes[-2] is ctypes.c_int  # the noalias flag
    assert fn.argtypes[-1] is ctypes.c_void_p  # the level counters
    module = _backend(CONSTRUCTS["_lagged_neighbour_sweep"][0]).module
    assert module.tile == (cuda_codegen.TL_TI, cuda_codegen.TL_TJ) == (8, 32)
    assert module.tiles(256, 256) == 32 * 8
    assert module.tiles(37, 45) == 5 * 2


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


def test_wrapper_counts_a_captured_launch_at_its_replays(monkeypatch):
    """A launch recorded into a CUDA graph is not counted when captured:
    the launcher reports it, an empty grid reports none, and each replay
    adds what was recorded (torch's graph and streams stood in for)."""
    import contextlib

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode=None):
            pass

        capture_end = replay = lambda self: None

    class Stream:
        cuda_stream = 1

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    wrapper = cuda_backend.KernelWrapper("probe")
    got = []
    graph = cuda_backend.capture_graph("cuda", [
        lambda: got.append(wrapper.launch(lambda *a: 0, ())),
        lambda: got.append(wrapper.launch(lambda *a: cuda_codegen.NOTHING_LAUNCHED, ())),
    ])
    assert got == [1, 0] and wrapper.launches == 0 and graph.per_replay == 1
    assert graph.replay(3) == 3 and wrapper.launches == 3
    assert wrapper.launch(lambda *a: 0, ()) == 1 and wrapper.launches == 4


def _cpu_backend(name="horizontal_diffusion"):
    memo = _registry_backend(name)
    backend = cuda_backend.CudaHopperBackend(memo.analyzed, {})
    backend._fns = []  # nothing to build or launch here
    return backend


def test_prepared_launch_is_cached_by_buffers_and_layout():
    """The cache keys a prepared launch on each role's pointer, shape,
    strides and dtype, the domain and the origins: the same buffers find it
    (by the runtime's call key too), another buffer or layout does not; it
    holds no caller tensor."""
    import weakref

    backend = _cpu_backend()
    names = [n for n, i in backend.analyzed.field_infos.items() if i is not None]
    arrays = {n: torch.zeros(12, 11, 4, dtype=torch.float64) for n in names}
    dom, orig = (8, 7, 4), {n: (2, 2, 0) for n in names}
    first = backend.prepared(arrays, dom, orig)
    assert backend.prepared(dict(arrays), dom, orig) is first
    assert backend.prepared(arrays, dom, orig, cache_key="k") is first
    assert backend.prepared(arrays, dom, orig, cache_key="k") is first  # the warm lookup
    assert backend.prepared(arrays, (8, 7, 3), orig) is not first
    moved = dict(arrays, coeff=torch.zeros(12, 11, 4, dtype=torch.float64))
    assert backend.prepared(moved, dom, orig) is not first
    strided = dict(arrays, coeff=torch.zeros(4, 11, 12, dtype=torch.float64).permute(2, 1, 0))
    assert backend.prepared(strided, dom, orig) is not first
    assert len({id(p) for p in backend._launches.values()}) == 4
    gone = weakref.ref(moved["coeff"])
    del moved
    assert gone() is None


def test_prepared_launch_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(cuda_backend, "CACHE_ENTRIES", 2)
    backend = _cpu_backend()
    names = [n for n, i in backend.analyzed.field_infos.items() if i is not None]
    arrays = {n: torch.zeros(12, 11, 4, dtype=torch.float64) for n in names}
    for nk in (2, 3, 4):
        backend.prepared(arrays, (8, 7, nk), {})
    assert len(backend._launches) == 1


def test_prepared_launches_share_their_scratch():
    """Two prepared launches of one domain use the same temporaries (one
    set a domain, not one a cache entry); a filled one is zeroed at each
    launch, not allocated zero-filled."""
    backend = _cpu_backend("vertical_advection_dycore")
    names = [n for n, i in backend.analyzed.field_infos.items() if i is not None]
    nk = backend.module.on_chip["gt_launch_0"].max_nk + 1  # the pair keeps no buffer
    a = {n: torch.zeros(5, 4, nk, dtype=torch.float64) for n in names}
    b = {n: torch.zeros(5, 4, nk, dtype=torch.float64) for n in names}
    pa, pb = backend.prepared(a, (4, 4, nk), {}), backend.prepared(b, (4, 4, nk), {})
    assert pa is not pb
    temps = [m for m in backend.module.slots if m.is_temp]
    assert [pa.ptrs[m.index] for m in temps] == [pb.ptrs[m.index] for m in temps]
    assert len(backend._scratch) == len(temps) == 2


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
def test_lagged_sweep_counts_one_launch_per_call_on_card(name):
    """One cooperative launch walks every level: the tiled wrapper counts
    one launch a call."""
    _need_card()
    st = gtscript.stencil(
        backend="cuda:hopper", definition=CONSTRUCTS[name][0], dtypes={"dt": np.float64}
    )
    host = defs.make_inputs(st.field_info, (41, 70, 7), np.random.default_rng(5))
    fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    cuda_backend.TILED.launches = 0
    st(**fields, origin=(2, 2, 0), domain=(37, 66, 7))
    torch.cuda.synchronize()
    assert cuda_backend.TILED.launches == 1


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


#: the column walks of the registry: every stencil column serves, and K4's
#: class again with the switch on (fused_column)
COLUMN_WALKS = [
    (name, False) for name, e in sorted(defs.REGISTRY.items()) if e["strategy"] == "column"
] + [(name, True) for name in sorted(defs.FUSED_STAGES)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["restrict", "plain"])
@pytest.mark.parametrize("depth", ["short", "long"])
@pytest.mark.parametrize("name, fuse", COLUMN_WALKS)
def test_column_walk_matches_plain_on_card(name, fuse, depth, variant, monkeypatch):
    """Every column walk against the plain version on the same card, over
    as few levels as the stencil takes (fewer than the prefetch ring's depth
    for all but multi_section_forward and restarted_temporary) and over
    many times more, in
    the __restrict__ variant (with its ring) and in the plain-pointer one,
    which the wrapper takes when it sees overlapping arguments (here it is
    told so, and the stencil is built anew, so that no launch prepared
    before is found); each launch is counted (vadv's on-chip pair, where
    the shape takes it, as one)."""
    _need_card()
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    if variant == "plain":
        monkeypatch.setattr(cuda_backend, "overlapping", lambda arrays: [("", "")])
    entry = defs.REGISTRY[name]
    opts = dict(externals=entry["externals"], dtypes=entry["dtypes"])
    kern = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"], rebuild=True,
                            **opts)
    plain = gtscript.stencil(backend="torch", definition=entry["definition"], **opts)
    nk = max(entry["min_k"], 2) if depth == "short" else 4 * cuda_codegen.RING_LEVELS + 5
    host = defs.make_inputs(kern.field_info, (25, 23, nk), np.random.default_rng(8))
    wrapper = cuda_backend.WRAPPERS["fused_column" if fuse else "column"]
    launches = 1 if fuse else kern._backend.module.kernels_per_call(nk, variant == "restrict")
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        wrapper.launches = 0
        st(**fields, **entry["scalars"], origin=(3, 3, 0), domain=(19, 17, nk))
        torch.cuda.synchronize()
        assert wrapper.launches == (launches if tag == "kernel" else 0)
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_vadv_float32_fields_float64_temporaries_on_card(fuse, monkeypatch):
    """vadv with float32 fields keeps ccol and dcol in float64, so the
    BACKWARD walk streams 8-byte values and the FORWARD one 4-byte ones
    (fused_column: through one region of shared memory, at one pitch).
    Against the plain version at 256×256×80, where every block is resident
    and warps run their walks out of step; the launch counted."""
    _need_card()
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    opts = dict(
        definition=defs.vertical_advection_dycore_generic, externals=defs.VADV_EXTERNALS,
        dtypes={"vadv_dt": np.float32},
    )
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    plain = gtscript.stencil(backend="torch", **opts)
    assert kern._backend.strategy == ("fused_column" if fuse else "column")
    nk = 80
    host = defs.make_inputs(kern.field_info, (260, 260, nk), np.random.default_rng(4))
    host["wcon"] = (0.1 * host["wcon"]).astype(host["wcon"].dtype)
    wrapper = cuda_backend.WRAPPERS[kern._backend.strategy]
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        wrapper.launches = 0
        st(**fields, dtr_stage=np.float32(0.15), origin=(2, 2, 0), domain=(256, 256, nk))
        torch.cuda.synchronize()
        launches = 1 if fuse else kern._backend.module.kernels_per_call(nk, True)
        assert wrapper.launches == (launches if tag == "kernel" else 0)
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


def _vadv_pair_and_two(dtype, monkeypatch):
    """vadv in ``dtype`` on the card with the on-chip pair, the same stencil
    with the pair's bound at 0 levels (the two column kernels, built anew),
    and the plain version."""
    pair = gtscript.stencil(backend="cuda:hopper", rebuild=True, **_vadv_options(dtype))
    with monkeypatch.context() as m:
        m.setattr(cuda_codegen, "ON_CHIP_RESIDENT_BYTES", 1 << 40)
        two = gtscript.stencil(backend="cuda:hopper", rebuild=True, **_vadv_options(dtype))
    assert pair._backend.module.on_chip and not two._backend.module.on_chip
    plain = gtscript.stencil(backend="torch", **_vadv_options(dtype))
    return pair, two, plain


def _vadv_options(dtype):
    prec = 8 * np.dtype(dtype).itemsize
    return dict(definition=defs.vertical_advection_dycore_generic, externals=defs.VADV_EXTERNALS,
                dtypes={"vadv_dt": dtype}, literal_float_precision=prec,
                literal_int_precision=prec)


def _vadv_host(st, shape, seed):
    host = defs.make_inputs(st.field_info, shape, np.random.default_rng(seed))
    host["wcon"] = (0.1 * host["wcon"]).astype(host["wcon"].dtype)
    return host


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", ["full", "ragged", "at_bound", "above_bound"])
def test_on_chip_pair_equals_the_two_launches_on_card(dtype, shape, monkeypatch):
    """vadv on the pair (one launch, counted as one) equals the two column
    kernels and the plain version to the bit: at 256×256×80, on a domain
    that fills no block (36×44×23), and at the rule's bound and one level
    above it, where the launcher takes the two kernels (two launches)."""
    _need_card()
    pair, two, plain = _vadv_pair_and_two(dtype, monkeypatch)
    oc = pair._backend.module.on_chip["gt_launch_0"]
    nk = {"full": 80, "ragged": 23, "at_bound": oc.max_nk, "above_bound": oc.max_nk + 1}[shape]
    ni, nj = (256, 256) if shape == "full" else (37, 45)
    host = _vadv_host(pair, (ni, nj, nk), 9)
    scalar = np.dtype(dtype).type(0.15)
    served = shape != "above_bound"
    out = {}
    for tag, st in (("pair", pair), ("two", two), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        cuda_backend.COLUMN.launches = 0
        st(**fields, dtr_stage=scalar, domain=(ni - 1, nj, nk))
        torch.cuda.synchronize()
        assert cuda_backend.COLUMN.launches == {"pair": 1 if served else 2, "two": 2,
                                                "plain": 0}[tag]
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        for other in ("two", "plain"):
            got, want = (np.ascontiguousarray(out[t][n]).view(np.uint8) for t in ("pair", other))
            assert np.array_equal(got, want), (n, other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_on_chip_pair_chain_as_a_graph_on_card(dtype, monkeypatch):
    """``chain(20)`` of vadv at 256×256×80 captured into a CUDA graph: 20
    launches of the pair, one a step, counted by the replays and their
    spans; the result equals 20 calls of the two column kernels to the
    bit."""
    from gt4py_tpu_torch.instrumentation import clear_spans, spans

    _need_card()
    pair, two, _ = _vadv_pair_and_two(dtype, monkeypatch)
    host = _vadv_host(pair, (256, 256, 80), 11)
    scalar = np.dtype(dtype).type(0.15)
    chained = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    cur = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    cuda_backend.COLUMN.launches = 0
    info = {}
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pair.chain(20, **chained, dtr_stage=scalar, domain=(255, 256, 80), exec_info=info)
        torch.cuda.synchronize()
    assert info["chain_mode"] == "graph"
    assert cuda_backend.COLUMN.launches == 20
    records = [r for r in spans() if r.name in ("gt4py.backend.replay", "gt4py.backend.launch",
                                                 "gt4py.backend.capture")]
    ran = [r for r in records if r.name != "gt4py.backend.capture"]
    assert sum(r.attrs["launches"] for r in ran) == 20
    assert all(r.attrs["launches"] == 1 for r in records if r.name == "gt4py.backend.capture")
    for _ in range(20):
        two(**cur, dtr_stage=scalar, domain=(255, 256, 80))
    torch.cuda.synchronize()
    for n in host:
        assert _same_bits(chained[n].array, cur[n].array), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_on_chip_pair_spills_nothing_and_keeps_its_blocks_on_card(dtype):
    """ptxas fits vadv's ringed kernels, the on-chip pair and the two
    ``column`` kernels it replaces, without a byte of spill stores or
    loads, and the pair's registers leave it the blocks an SM that its
    shared memory gives at the benchmark's 80 levels (the rule's count: 4
    of 64 columns in float32, 2 in float64)."""
    import importlib.util
    import os

    _need_card()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    st = gtscript.stencil(backend="cuda:hopper", rebuild=True, **_vadv_options(dtype))
    module = st._backend.module
    oc = module.on_chip["gt_launch_0"]
    cuda_backend.load_library(module.source)
    report = smoke.ptxas_report(module.source, cuda_backend)
    for kernel in (oc.kernel, "gt_column_0_r", "gt_column_1_r"):
        registers, stores, loads = report[kernel]
        assert (stores, loads) == (0, 0), (kernel, registers)
    by_shared = cuda_codegen.SM_SHARED_BYTES // (oc.shared_bytes(80) + cuda_codegen.BLOCK_RESERVED_BYTES)
    assert by_shared == {np.float32: 4, np.float64: 2}[dtype]
    assert smoke.residency(module.source, cuda_backend, module.on_chip, 80)[oc.kernel] == by_shared


@pytest.mark.cuda
def test_unsupported_raises_on_card():
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=_too_wide_temporary)
    a = storage.zeros((207, 206, 3), backend="cuda:hopper")
    b = storage.zeros((207, 206, 3), backend="cuda:hopper")
    with pytest.raises(CudaUnsupported, match="bytes of shared memory per block"):
        st(a, b, origin=(101, 101, 0), domain=(4, 3, 3))


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
     "_tiled_in_place", "read_ahead_sweep", "restarted_temporary"],
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


#: the tile walks: every registry stencil fused_plane or tiled serves, and
#: the tiled constructs (the lagged sweeps among them)
TILE_WALKS = [
    (name, e["definition"], e["dtypes"] or {"dt": np.float64}, e["scalars"], e["min_k"])
    for name, e in sorted(defs.REGISTRY.items()) if e["strategy"] in ("fused_plane", "tiled")
] + [
    (name, definition, {"dt": np.float64}, {}, 2)
    for name, (definition, strategy) in sorted(CONSTRUCTS.items()) if strategy == "tiled"
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["restrict", "plain"])
@pytest.mark.parametrize("depth", ["short", "long"])
@pytest.mark.parametrize("name, definition, dtypes, scalars, min_k", TILE_WALKS)
def test_tile_walk_matches_plain_on_card(name, definition, dtypes, scalars, min_k, depth, variant,
                                         monkeypatch):
    """Every tile walk against the plain version on the same card, at a
    ragged 37 × 45 domain (a multiple of neither tile), over fewer levels
    than the tile ring holds and over 80, in the __restrict__ variant (with
    its ring and carries) and in the plain-pointer one (the wrapper is told
    that the arguments overlap, of a stencil built anew); one counted launch
    a call."""
    _need_card()
    if variant == "plain":
        monkeypatch.setattr(cuda_backend, "overlapping", lambda arrays: [("", "")])
    kern = gtscript.stencil(backend="cuda:hopper", definition=definition, dtypes=dtypes,
                            rebuild=True)
    plain = gtscript.stencil(backend="torch", definition=definition, dtypes=dtypes)
    nk = max(min_k, 2) if depth == "short" else 80
    assert depth == "long" or nk <= cuda_codegen.TILE_RING_LEVELS
    host = defs.make_inputs(kern.field_info, (41, 49, nk), np.random.default_rng(9))
    wrapper = cuda_backend.WRAPPERS[kern._backend.strategy]
    launches = len(kern._backend.module.launchers)
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        wrapper.launches = 0
        st(**fields, **scalars, origin=(2, 2, 0), domain=(37, 45, nk))
        torch.cuda.synchronize()
        assert wrapper.launches == (launches if tag == "kernel" else 0)
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _assert_same(out["kernel"][n], out["plain"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_lagged_neighbour_sweep", "_lag_read_before_write"])
def test_lagged_sweep_walks_many_tiles_a_block_on_card(name):
    """1024 × 1024 has 4096 tiles, more than the blocks resident at once, so
    each block walks several tiles a level: three runs, each one counted
    launch, each equal to the others and to the plain version."""
    _need_card()
    definition = CONSTRUCTS[name][0]
    kern = gtscript.stencil(backend="cuda:hopper", definition=definition, dtypes={"dt": np.float64})
    plain = gtscript.stencil(backend="torch", definition=definition, dtypes={"dt": np.float64})
    host = defs.make_inputs(kern.field_info, (1026, 1026, 16), np.random.default_rng(10))
    kw = dict(origin=(1, 1, 0), domain=(1024, 1024, 16))
    want = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    plain(**want, **kw)
    first = None
    for _ in range(3):
        got = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        cuda_backend.TILED.launches = 0
        kern(**got, **kw)
        torch.cuda.synchronize()
        assert cuda_backend.TILED.launches == 1
        for n in host:
            _assert_same(np.asarray(got[n]), np.asarray(want[n]), n)
            if first is not None:
                np.testing.assert_array_equal(np.asarray(got[n]), np.asarray(first[n]), err_msg=n)
        first = first or got


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", ["hdiff_sponge", "smoothed_column_sum", "_lagged_neighbour_sweep", "_lag_read_before_write"]
)
def test_tile_walk_twice_and_chained_on_card(name):
    """Two calls in a row on the same fields, then ``chain(5)``, against the
    plain version doing the same: a level counter or ring slot left over
    from the call before would show."""
    _need_card()
    entry = defs.REGISTRY.get(name) or {
        "definition": CONSTRUCTS[name][0], "dtypes": {"dt": np.float64}
    }
    opts = dict(definition=entry["definition"], dtypes=entry["dtypes"] or {"dt": np.float64})
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(backend=backend, **opts)
        host = defs.make_inputs(st.field_info, (41, 49, 23), np.random.default_rng(11))
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        kw = dict(origin=(2, 2, 0), domain=(37, 45, 23))
        st(**fields, **kw)
        st(**fields, **kw)
        st.chain(5, **fields, **kw)
        torch.cuda.synchronize()
        out[backend] = {n: np.asarray(v) for n, v in fields.items()}
    for n in out["torch"]:
        _assert_same(out["cuda:hopper"][n], out["torch"][n], n)


#: the plane walks: every registry stencil plane serves, and the plane
#: constructs
PLANE_WALKS = [
    (name, e["definition"], e["dtypes"], e["externals"], e["scalars"], e["min_k"])
    for name, e in sorted(defs.REGISTRY.items()) if e["strategy"] == "plane"
] + [
    (name, definition, {"dt": np.float64}, {}, {}, {"_sectioned_plane": 4}.get(name, 2))
    for name, (definition, strategy) in sorted(CONSTRUCTS.items()) if strategy == "plane"
]


def _plane_walk(definition, dtypes, externals, shape, calls):
    """The kernel and the plain version on the same inputs, each through
    ``calls(stencil, fields)``: every field of both. Built anew, so that a
    launch prepared before (by another test, maybe in the other variant) is
    not found."""
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(
            backend=backend, definition=definition, dtypes=dtypes, externals=externals,
            rebuild=True,
        )
        host = defs.make_inputs(st.field_info, shape, np.random.default_rng(12))
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        cuda_backend.PLANE.launches = 0
        calls(st, fields)
        torch.cuda.synchronize()
        out[backend] = ({n: np.asarray(v) for n, v in fields.items()}, cuda_backend.PLANE.launches)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["restrict", "plain"])
@pytest.mark.parametrize("depth", ["short", "long"])
@pytest.mark.parametrize("name, definition, dtypes, externals, scalars, min_k", PLANE_WALKS)
def test_plane_walk_matches_plain_on_card(name, definition, dtypes, externals, scalars, min_k,
                                          depth, variant, monkeypatch):
    """Every plane stencil against the plain version on the same card, at a
    ragged 37 × 45 domain (a multiple of neither tile side), over fewer
    levels than a block walks and over 80, in the __restrict__ variant
    (with its ring) and in the plain-pointer one (the wrapper is told that
    the arguments overlap); one counted launch a loop."""
    _need_card()
    if variant == "plain":
        monkeypatch.setattr(cuda_backend, "overlapping", lambda arrays: [("", "")])
    nk = max(min_k, 2) if depth == "short" else 80
    out = _plane_walk(
        definition, dtypes, externals, (41, 49, nk),
        lambda st, fields: st(**fields, **scalars, origin=(2, 2, 0), domain=(37, 45, nk)),
    )
    (got, launches), (want, none) = out["cuda:hopper"], out["torch"]
    assert launches == len(_backend(definition, dtypes=dtypes, externals=externals).module.launchers)
    assert none == 0
    for n in want:
        _assert_same(got[n], want[n], n)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", ["horizontal_diffusion", "lap_of_lap", "region_interaction", "large_k_interval",
             "_sectioned_plane"]
)
def test_plane_walk_twice_and_chained_on_card(name):
    """Two calls in a row on the same fields, then ``chain(5)``, at 23
    levels (a ragged last walk), against the plain version doing the same:
    a ring slot or plane left over from a call or level before would
    show."""
    _need_card()
    entry = defs.REGISTRY.get(name) or {
        "definition": CONSTRUCTS[name][0], "dtypes": {"dt": np.float64}, "externals": {},
        "scalars": {},
    }
    kw = dict(origin=(2, 2, 0), domain=(37, 45, 23))

    def calls(st, fields):
        st(**fields, **entry["scalars"], **kw)
        st(**fields, **entry["scalars"], **kw)
        st.chain(5, **fields, **entry["scalars"], **kw)

    out = _plane_walk(entry["definition"], entry["dtypes"], entry["externals"], (41, 49, 23), calls)
    assert out["cuda:hopper"][1] > 0
    for n, want in out["torch"][0].items():
        _assert_same(out["cuda:hopper"][0][n], want, n)


def _patch_storages(host, dtypes, origin, pad=None):
    """Card storages of ``host`` whose rows are whole 16-byte vectors (the J
    size rounded up to 8 elements, the points beyond it never read), so that
    the register patches take their vector path; ``pad``: fields made views
    of a buffer of an odd number of elements along J instead (a row pitch of
    no whole vectors: their per-point path)."""
    out = {}
    for n, v in host.items():
        ni, nj = v.shape[:2]
        wide = nj + 1 + nj % 2 if n in (pad or ()) else -(-nj // 8) * 8
        full = np.zeros((ni, wide) + v.shape[2:], dtype=v.dtype)
        full[:, :nj] = v
        st = storage.from_array(full, backend="cuda:hopper", aligned_index=origin,
                                dtype=dtypes.get(n))
        out[n] = st.array[:, :nj]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name, definition, dtypes, externals, scalars, min_k", PLANE_WALKS)
def test_plane_patches_match_plain_on_card(name, definition, dtypes, externals, scalars, min_k):
    """Every plane stencil's register patches on storages whose rows are
    whole vectors, over 255 × 257 (a multiple of neither the tile nor a
    patch) and 7 levels, against the plain version on the same card: every
    launch's word takes every field's vector path, every field and point
    equal."""
    _need_card()
    nk = max(min_k, 7)
    shape, origin, domain = (261, 263, nk), (3, 3, 0), (255, 257, nk)
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(backend=backend, definition=definition, dtypes=dtypes,
                              externals=externals, rebuild=True)
        host = defs.make_inputs(st.field_info, shape, np.random.default_rng(14))
        kinds = {n: st.field_info[n].dtype for n in host}
        fields = _patch_storages(host, kinds, origin)
        cuda_backend.PLANE.launches = 0
        st(**fields, **scalars, origin=origin, domain=domain)
        torch.cuda.synchronize()
        out[backend] = {n: np.asarray(v.cpu()) for n, v in fields.items()}
        if backend == "cuda:hopper":
            module = st._backend.module
            (launch,) = set(st._backend._launches.values())
            patched = sum(layout.patched(launch.words[n]) for n, layout in module.patches.items())
            assert cuda_backend.PLANE.launches == len(module.launchers) == patched, patched
    for n, want in out["torch"].items():
        _assert_same(out["cuda:hopper"][n], want, n)


#: hdiff in the four types the card stores: their tolerance against the
#: plain version (half: the kernel rounds once, the plain version at every
#: operation)
PATCH_TYPES = {"float32": 0.0, "float64": 0.0, "float16": defs.HALF_TOL,
               "bfloat16": defs.BF16_TOL["hdiff"]}


@pytest.mark.cuda
@pytest.mark.parametrize("oj", range(2, 6))
@pytest.mark.parametrize("dtype", sorted(PATCH_TYPES))
def test_hdiff_patches_at_every_shift_on_card(dtype, oj):
    """hdiff in float32, float64, float16 and bfloat16 with its domain
    starting at J origins 2-5, so that the tiles' shift takes every value a
    vector of 2 allows, twice, over 255 × 257 × 7: each launch patched, the
    result the plain version's (the halves within their tolerance), a
    chain of 5 too."""
    _need_card()
    dtypes = {"dt": torch.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)}
    origin, domain = (2, oj, 0), (255, 257, 7)
    shape = (259, 257 + oj + 2, 7)
    out = {}
    for backend in ("cuda:hopper", "torch"):
        st = gtscript.stencil(backend=backend, definition=defs.horizontal_diffusion_generic,
                              dtypes=dtypes, rebuild=True)
        host = defs.half_inputs(st.field_info, shape, np.random.default_rng(15))
        fields = _patch_storages(host, {n: st.field_info[n].dtype for n in host}, origin)
        cuda_backend.PLANE.launches = 0
        st(**fields, origin=origin, domain=domain)
        st.chain(5, **fields, origin=origin, domain=domain)
        torch.cuda.synchronize()
        if backend == "cuda:hopper":
            assert cuda_backend.PLANE.launches == 6
            (launch,) = set(st._backend._launches.values())
            layout = st._backend.module.patches["gt_launch_0"]
            assert layout.patched(launch.words["gt_launch_0"])
            assert launch.words["gt_launch_0"] >> 1 & 7 == oj % layout.width  # rows start on vectors
        out[backend] = {n: v.cpu().double().numpy() for n, v in fields.items()}
    tol = PATCH_TYPES[dtype]
    for n, want in out["torch"].items():
        np.testing.assert_allclose(out["cuda:hopper"][n], want, rtol=tol or 1e-12, atol=tol, err_msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_plane_patches_fall_back_for_a_field_off_the_vectors_on_card(dtype):
    """hdiff with coeff a view of a buffer of an odd number of elements
    along J (a row pitch of no whole vectors): the launch's word leaves the
    vector path to the others, coeff moves element by element, the other fields by vectors
    (float16: the launch runs the plain-pointer kernel), and the result is
    the plain version's; with every field so, too."""
    _need_card()
    dtypes = {"dt": np.dtype(dtype)}
    origin, domain = (2, 2, 0), (255, 257, 7)
    for pad in ({"coeff"}, {"in_field", "out_field", "coeff"}):
        out = {}
        for backend in ("cuda:hopper", "torch"):
            st = gtscript.stencil(backend=backend, definition=defs.horizontal_diffusion_generic,
                                  dtypes=dtypes, rebuild=True)
            host = defs.half_inputs(st.field_info, (259, 261, 7), np.random.default_rng(16))
            fields = _patch_storages(host, {}, origin, pad=pad)
            cuda_backend.PLANE.launches = 0
            st(**fields, origin=origin, domain=domain)
            torch.cuda.synchronize()
            if backend == "cuda:hopper":
                (launch,) = set(st._backend._launches.values())
                layout = st._backend.module.patches["gt_launch_0"]
                assert cuda_backend.PLANE.launches == 1
                assert not layout.patched(launch.words["gt_launch_0"])
            out[backend] = {n: v.cpu().double().numpy() for n, v in fields.items()}
        tol = PATCH_TYPES[dtype]
        for n, want in out["torch"].items():
            np.testing.assert_allclose(out["cuda:hopper"][n], want, rtol=tol or 1e-12, atol=tol,
                                       err_msg=f"{n} {sorted(pad)}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(defs.HALF_STENCILS))
def test_half_stencil_matches_plain_on_card(name, monkeypatch):
    """One float16 stencil on each of the five kernels against the plain
    version on the same card, within the half tolerance (the kernel computes
    in float32 and rounds at the store, the plain version rounds every
    operation); the largest error is printed."""
    _need_card()
    definition, kernel, fuse = defs.HALF_STENCILS[name]
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    opts = dict(definition=definition, dtypes={"dt": np.float16})
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    plain = gtscript.stencil(backend="torch", **opts)
    assert kern._backend.strategy == kernel
    host = defs.half_inputs(kern.field_info, (41, 49, 19), np.random.default_rng(13))
    wrapper = cuda_backend.WRAPPERS[kernel]
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        wrapper.launches = 0
        st(**fields, origin=(2, 2, 0), domain=(37, 45, 19))
        torch.cuda.synchronize()
        assert (wrapper.launches > 0) == (tag == "kernel")
        out[tag] = {n: np.asarray(v).astype(np.float64) for n, v in fields.items()}
    err = max(np.max(np.abs(out["kernel"][n] - out["plain"][n])) for n in host)
    print(f"float16 {name} on {kernel}: max abs err {err}")
    for n in host:
        assert np.all(np.isfinite(out["kernel"][n])), n
        np.testing.assert_allclose(
            out["kernel"][n], out["plain"][n], rtol=defs.HALF_TOL, atol=defs.HALF_TOL, err_msg=n
        )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(defs.HALF_STENCILS))
def test_bf16_stencil_matches_plain_on_card(name, monkeypatch):
    """One bfloat16 stencil on each of the five kernels against the plain
    version on the same card, at ``defs.BF16_TOL`` (the JAX package's
    bfloat16 tolerances: the kernel computes in float32 and rounds at the
    store, the plain version rounds every operation)."""
    _need_card()
    definition, kernel, fuse = defs.HALF_STENCILS[name]
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    opts = dict(definition=definition, dtypes={"dt": torch.bfloat16})
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    plain = gtscript.stencil(backend="torch", **opts)
    assert kern._backend.strategy == kernel
    host = defs.half_inputs(kern.field_info, (41, 49, 19), np.random.default_rng(13))
    wrapper = cuda_backend.WRAPPERS[kernel]
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, dtype="bfloat16", backend="cuda:hopper")
                  for n, v in host.items()}
        wrapper.launches = 0
        st(**fields, origin=(2, 2, 0), domain=(37, 45, 19))
        torch.cuda.synchronize()
        assert (wrapper.launches > 0) == (tag == "kernel")
        out[tag] = {n: np.asarray(v).astype(np.float64) for n, v in fields.items()}
    tol = defs.BF16_TOL[name]
    err = max(np.max(np.abs(out["kernel"][n] - out["plain"][n])) for n in host)
    print(f"bfloat16 {name} on {kernel}: max abs err {err}")
    for n in host:
        assert np.all(np.isfinite(out["kernel"][n])), n
        np.testing.assert_allclose(out["kernel"][n], out["plain"][n], rtol=tol, atol=tol, err_msg=n)


# --- chain as a CUDA graph, and the warm call ------------------------------------------


def _swap_pair(st) -> dict:
    """A field the stencil writes and one it only reads, of the same dtype,
    axes and data dimensions, to swap between steps ({} where none)."""
    info = {n: i for n, i in st.field_info.items() if i is not None}
    written = [n for n in info if n in st._backend.written]
    for w in written:
        for r in info:
            if r not in written and (info[w].dtype, info[w].axes, info[w].data_dims) == (
                info[r].dtype, info[r].axes, info[r].data_dims
            ):
                return {w: r, r: w}
    return {}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (NaNs included)."""
    bits = lambda t: t.detach().cpu().contiguous().view(torch.uint8)  # noqa: E731
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def _chain_against_calls(st, host, n_steps, swap, scalars, **kw):
    """``chain(n)`` on one copy of ``host`` and n single calls rotating the
    same roles on another; returns (chain's fields, the calls' final roles,
    the chain's exec_info, its launches, the calls' launches)."""
    def fields():
        return {n: storage.from_array(v, dtype=st.field_info[n].dtype, backend="cuda:hopper")
                for n, v in host.items()}

    def counted(work):
        for w in cuda_backend.WRAPPERS.values():
            w.launches = 0
        work()
        torch.cuda.synchronize()
        return sum(w.launches for w in cuda_backend.WRAPPERS.values())

    chained, cur, info = fields(), fields(), {}
    chain_launches = counted(
        lambda: st.chain(n_steps, **chained, **scalars, swap=swap, exec_info=info, **kw)
    )

    def calls():
        nonlocal cur
        for _ in range(n_steps):
            st(**cur, **scalars, **kw)
            cur = {r: cur[swap.get(r, r)] for r in cur}

    call_launches = counted(calls)
    return chained, cur, info, chain_launches, call_launches


def _expected_mode(st, swap, n_steps) -> str:
    """A fresh chain (a stencil built anew, ``rebuild=True``) launches its
    first cycle, then replays the graph of it if as many steps are left."""
    from gt4py_tpu_torch.cartesian.backend.base import chain_cycle_len

    cycle = chain_cycle_len([n for n, i in st.field_info.items() if i is not None], swap)
    return "graph" if n_steps - cycle >= cycle else "launches"


def _assert_chain_is_the_calls(st, host, n_steps, swap, scalars, **kw):
    chained, cur, info, chain_launches, call_launches = _chain_against_calls(
        st, host, n_steps, swap, scalars, **kw
    )
    for r in chained:
        assert _same_bits(chained[r].array, cur[r].array), r
    assert chain_launches == call_launches > 0
    assert info["chain_mode"] == _expected_mode(st, swap, n_steps)
    assert info["kernel_strategy"] == st._backend.strategy


_SMOKE_SPEC = None


def _smoke():
    """chip_smoke.py as a module (its main paths and inputs)."""
    import importlib.util
    import os

    global _SMOKE_SPEC
    if _SMOKE_SPEC is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
        _SMOKE_SPEC = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_SMOKE_SPEC)
    return _SMOKE_SPEC


MAIN_PATHS = ["hdiff", "vadv", "tridiag", "hdiff_sponge", "smoothed_column_sum", "vadv_fused",
              "tridiag_fused"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 2, 5, 11])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("path", MAIN_PATHS)
def test_graph_chain_of_a_main_path_is_its_calls_on_card(path, dtype, n_steps):
    """Every main path of chip_smoke.py at 36 × 36 × 16 (halo 2): ``chain(n)``
    through the CUDA graph equals n single calls to the bit, launches the
    same kernels as many times, and runs as a graph once a replay follows
    the first cycle."""
    _need_card()
    smoke = _smoke()
    case = next(c for c in smoke.path_cases(defs) if c["name"] == path)
    opts = {"dtypes": {"dt": dtype, "vadv_dt": dtype}}
    if dtype == "float32":
        opts.update(literal_float_precision=32, literal_int_precision=32)
    st = smoke.build_switched(gtscript, case.get("fuse", False), backend="cuda:hopper",
                              definition=case["definition"], externals=case["externals"],
                              rebuild=True, **opts)
    host = {n: v.astype(dtype) for n, v in smoke.make_host(case, (36, 36, 16), 5, np).items()}
    scalars = {n: np.dtype(dtype).type(v) for n, v in case["scalars"].items()}
    # lower-dimensional fields keep their own axes (card_fields), one copy a side
    chained = smoke.card_fields(host, (2, 2, 0), case, storage)
    cur = smoke.card_fields(host, (2, 2, 0), case, storage)
    info = {}
    for w in cuda_backend.WRAPPERS.values():
        w.launches = 0
    st.chain(n_steps, **chained, **scalars, swap=case["swap"], domain=(32, 32, 16), exec_info=info)
    torch.cuda.synchronize()
    chain_launches = cuda_backend.WRAPPERS[case["kernel"]].launches
    cuda_backend.WRAPPERS[case["kernel"]].launches = 0
    for _ in range(n_steps):
        st(**cur, **scalars, domain=(32, 32, 16))
        cur = {r: cur[case["swap"].get(r, r)] for r in cur}
    torch.cuda.synchronize()
    assert chain_launches == cuda_backend.WRAPPERS[case["kernel"]].launches == (
        n_steps * st._backend.module.kernels_per_call(16, True)
    )
    for r in chained:
        assert _same_bits(chained[r].array, cur[r].array), r
    assert info["chain_mode"] == _expected_mode(st, case["swap"], n_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 2, 5, 11])
@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_graph_chain_of_a_registry_stencil_is_its_calls_on_card(name, n_steps):
    """Every registry stencil, ping-ponging a written field with a field
    it only reads where it has such a pair (else chained in place):
    ``chain(n)`` equals n single calls to the bit, with the same launches."""
    _need_card()
    entry = defs.REGISTRY[name]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"],
                          externals=entry["externals"], dtypes=entry["dtypes"], rebuild=True)
    nk = max(9, entry["min_k"])
    host = defs.make_inputs(st.field_info, (22, 21, nk), np.random.default_rng(2))
    _assert_chain_is_the_calls(st, host, n_steps, _swap_pair(st), entry["scalars"],
                               origin=(3, 3, 0), domain=(16, 15, nk))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_lagged_neighbour_sweep", "_lag_read_before_write"])
def test_lagged_sweeps_chain_on_card(name):
    """The cooperative sweeps chain as CUDA graphs too: CUDA captures the
    cooperative launch and its memset of the level counters; equal to
    single calls, one cooperative launch a step."""
    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=CONSTRUCTS[name][0],
                          dtypes={"dt": np.float64}, rebuild=True)
    assert st._backend.module.cooperative
    host = defs.make_inputs(st.field_info, (41, 49, 23), np.random.default_rng(11))
    for n_steps in (5, 11):
        _assert_chain_is_the_calls(st, host, n_steps, {"inp": "out", "out": "inp"}, {},
                                   origin=(2, 2, 0), domain=(37, 45, 23))


@pytest.mark.cuda
def test_new_scalar_value_recaptures_on_card():
    """Scalars are baked into a captured graph: a chain with a new value
    captures a graph of its own and computes with it (a stencil built anew,
    so no other test's chains are in its caches)."""
    _need_card()
    entry = defs.REGISTRY["vertical_advection_dycore"]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"],
                          externals=entry["externals"], dtypes=entry["dtypes"], rebuild=True)
    host = defs.make_inputs(st.field_info, (12, 12, 16), np.random.default_rng(3))
    chained = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    for value in (0.1, 0.2, 0.1):
        for n, v in host.items():  # the same buffers, refilled
            chained[n].array.copy_(torch.from_numpy(v))
        info = {}
        st.chain(5, **chained, dtr_stage=value, exec_info=info)
        cur = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        for _ in range(5):
            st(**cur, dtr_stage=value)
        torch.cuda.synchronize()
        assert info["chain_mode"] == "graph"
        for n in host:
            assert _same_bits(chained[n].array, cur[n].array), (value, n)
    chains = {id(c): c for c in st._backend._chains.values()}.values()
    assert [sorted(c.graphs) for c in chains] == [[(("dtr_stage", 0.1),), (("dtr_stage", 0.2),)]]


@pytest.mark.cuda
def test_filled_temporary_is_zeroed_every_step_on_card():
    """``tmp[0, 0, 1]`` reads the level above before the FORWARD walk writes
    it: the plain version's zero-filled temporary. The kernel's buffer is
    zeroed before every step, in a graph replay too, so a chain equals the
    plain version's chain (a buffer left from the step before would hold
    2 * inp there)."""
    _need_card()
    opts = dict(definition=_temporary_read_ahead, dtypes={"dt": np.float64})
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    assert any(m.is_temp and m.fill for m in kern._backend.module.slots)
    plain = gtscript.stencil(backend="torch", **opts)
    host = defs.make_inputs(kern.field_info, (9, 10, 12), np.random.default_rng(4))
    out = {}
    for tag, st in (("kernel", kern), ("plain", plain)):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        info = {}
        st.chain(7, **fields, swap={"inp": "out", "out": "inp"}, exec_info=info)
        st(**fields)
        torch.cuda.synchronize()
        out[tag] = ({n: np.asarray(v) for n, v in fields.items()}, info["chain_mode"])
    assert out["kernel"][1] == "graph"
    for n in host:
        _assert_same(out["kernel"][0][n], out["plain"][0][n], n)


@pytest.mark.cuda
def test_warm_call_reuses_its_prepared_launch_on_card():
    """A second call on the same storages finds its prepared launch; other
    storages get one of their own; the cache holds no caller tensor (a
    stencil built anew, so no other test's launches are in its cache)."""
    import weakref

    _need_card()
    entry = defs.REGISTRY["horizontal_diffusion"]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"], rebuild=True)

    def launches():  # each kept by its launch key and by the runtime's call key
        return len({id(p) for p in st._backend._launches.values()})

    host = defs.make_inputs(st.field_info, (20, 20, 8), np.random.default_rng(6))
    fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    kw = dict(origin=(2, 2, 0), domain=(16, 16, 8))
    st(**fields, **kw)
    st(**fields, **kw)
    assert launches() == 1
    other = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    st(**other, **kw)
    torch.cuda.synchronize()
    assert launches() == 2
    for n in host:
        _assert_same(np.asarray(other[n]), np.asarray(fields[n]), n)
    gone = weakref.ref(other["out_field"].array)
    del other
    assert gone() is None


# --- the CPU oracles against the kernels, on the card ----------------------------------

#: kernel against the numpy backend on the host: rtol by the field's dtype
ORACLE_RTOL = {"float64": 1e-12, "float32": 1e-5}


def _against_oracle(got, want, name):
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL[want.dtype.name], atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, fuse",
    [(n, False) for n in sorted(defs.REGISTRY)] + [(n, True) for n in sorted(defs.FUSED_STAGES)],
)
def test_registry_oracle_on_card(name, fuse, monkeypatch):
    """Every registry stencil through its pinned kernel (K4's class again
    with the stage-fusion switch on) against the port's ``numpy`` backend
    run on the host from the same inputs: the exact oracle, which needs
    neither JAX nor ml_dtypes."""
    _need_card()
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    entry = defs.REGISTRY[name]
    opts = dict(definition=entry["definition"], externals=entry["externals"],
                dtypes=entry["dtypes"])
    kern = gtscript.stencil(backend="cuda:hopper", **opts)
    oracle = gtscript.stencil(backend="numpy", **opts)
    assert kern._backend.strategy == (defs.FUSED_STAGES[name] if fuse else entry["strategy"])
    shape = (22, 21, max(9, entry["min_k"]))
    host = defs.make_inputs(kern.field_info, shape, np.random.default_rng(1))
    out = {}
    for tag, st, backend in (("kernel", kern, "cuda:hopper"), ("oracle", oracle, "numpy")):
        fields = {n: storage.from_array(v, backend=backend) for n, v in host.items()}
        assert {f.device.type for f in fields.values()} == {
            "cuda" if backend == "cuda:hopper" else "cpu"}
        st(**fields, **entry["scalars"], origin=(3, 3, 0), domain=(16, 15, shape[2]))
        torch.cuda.synchronize()
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n in host:
        _against_oracle(out["kernel"][n], out["oracle"][n], n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hdiff", "vadv", "tridiag"])
def test_cpu_c_full_width_on_card(name):
    """hdiff, vadv and tridiag at 256×256×80 (halo 2, float64) on ``cpu:c``,
    built with the machine's ``cc``, equal to ``cuda:hopper`` within rtol
    1e-12."""
    from .test_torch_chip_smoke import SMOKE

    _need_card()
    case = {c["name"]: c for c in SMOKE.path_cases(defs)}[name]
    shape = (SMOKE.NI + 2 * SMOKE.HALO, SMOKE.NJ + 2 * SMOKE.HALO, SMOKE.NK)
    host = SMOKE.make_host(case, shape, 7, np)
    scalars = case["scalars"]
    out = {}
    for backend in ("cuda:hopper", "cpu:c"):
        st = SMOKE.build_stencil(gtscript, case["definition"], backend, "float64",
                                 case["externals"])
        fields = {n: storage.from_array(v, backend=backend, aligned_index=(2, 2, 0))
                  for n, v in host.items()}
        st(**fields, **scalars, domain=(SMOKE.NI, SMOKE.NJ, SMOKE.NK))
        torch.cuda.synchronize()
        out[backend] = {n: np.asarray(v) for n, v in fields.items()}
        if backend == "cpu:c":
            assert st._backend.last_path == "c"
    for n in host:
        np.testing.assert_allclose(out["cpu:c"][n], out["cuda:hopper"][n], rtol=1e-12, atol=0,
                                   err_msg=n)


@pytest.mark.cuda
def test_warm_call_trace_holds_only_the_generated_kernel():
    """A warm ``__call__`` of hdiff (``plane``) under ``gpu_trace``: the
    device work in the trace is its generated kernel and nothing else; no
    kernel of the plain version runs."""
    from .test_torch_chip_smoke import SMOKE

    _need_card()
    st = gtscript.stencil(backend="cuda:hopper", definition=defs.horizontal_diffusion_generic,
                          dtypes={"dt": np.float32}, literal_float_precision=32)
    host = defs.make_inputs(st.field_info, (68, 68, 16), np.random.default_rng(2))
    fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
    traced = SMOKE.trace_warm_call(
        lambda: st(**fields, origin=(2, 2, 0), domain=(64, 64, 16)),
        st._backend.module, "gt4py_warm_call", cuda_backend, torch,
    )
    assert traced["work"] == {"generated": 1, "fills": 0, "copies": 0, "other": []}
    assert len(traced["splits"]) == 5 and traced["call_us"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["numpy", "debug", "cpu:c"])
def test_cuda_tensor_handed_to_a_cpu_backend_raises(backend):
    _need_card()
    st = gtscript.stencil(backend=backend, definition=defs.copy_stencil)
    a = storage.ones((4, 4, 4), backend="cuda:hopper")
    b = storage.zeros((4, 4, 4), backend="cuda:hopper")
    with pytest.raises(TypeError, match="cuda"):
        st(a, b)
    assert float(b.array.sum()) == 0.0


@pytest.mark.cuda
def test_refused_construct_raises_on_card():
    """What the exclusion matrix (tests/torch_definitions.py) records as
    refused on the card raises there, and still runs on CPU tensors."""
    from . import torch_definitions as tdefs

    _need_card()
    assert tdefs.BACKEND_SKIP_TEST_MATRIX["cuda:hopper"][tdefs.USES_WIDE_TEMPORARY] == (
        tdefs.REFUSED_ON_CARD)
    st = gtscript.stencil(backend="cuda:hopper", definition=_too_wide_temporary)
    host = np.random.default_rng(0).random((207, 206, 3))
    card = [storage.from_array(host, backend="cuda:hopper") for _ in range(2)]
    with pytest.raises(CudaUnsupported, match="shared memory"):
        st(*card, origin=(101, 101, 0), domain=(4, 3, 3))


@pytest.mark.cuda
def test_array_setter_on_card():
    """``Storage.array = ndarray`` on a card storage: the same shape and
    dtype are copied into the held tensor (its pointer, which a prepared
    launch holds, stays), a new shape gets a new K-leading tensor on the
    card; the copy stencil's kernel then writes what the ``numpy`` backend
    writes on the host from the same assignments."""
    _need_card()
    results = {}
    for backend, device in (("cuda:hopper", "cuda"), ("numpy", "cpu")):
        st = gtscript.stencil(backend=backend, definition=defs.copy_stencil)
        a = storage.zeros((4, 4, 2), backend=backend, device=device)
        b = storage.zeros((4, 4, 2), backend=backend, device=device)
        held = a.array.data_ptr()
        a.array = np.full((4, 4, 2), 2.0)
        assert a.array.data_ptr() == held
        st(a, b)
        first = b.asnumpy()
        a.array = np.arange(30.0).reshape(5, 3, 2)
        b.array = np.zeros((5, 3, 2))
        st(a, b)
        assert a.device.type == b.device.type == device
        assert a.array.stride() == (3, 1, 15) and b.shape == (5, 3, 2)
        results[backend] = (first, b.asnumpy())
    for got, want in zip(results["cuda:hopper"], results["numpy"]):
        np.testing.assert_array_equal(got, want)
