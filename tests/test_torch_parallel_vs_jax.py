"""The port's parallel package against the JAX package's, on the CPU.

The same NumPy inputs, made from a seed, go through
``gt4py_tpu.parallel.DistributedStencil`` on the JAX package's eight
virtual CPU devices (its ``jax`` backend, and ``tpu:pallas`` in interpret
mode as tests/parallel_tests/test_distributed.py runs it) and through the
port's on ``[torch.device("cpu")] * 8`` (``torch``, and ``cuda:hopper``,
whose shards run its kernels' plain version on CPU tensors): hdiff under
periodic, clamp and zero boundaries, uneven sizes (pad and trim), vadv and
tridiag, in float64 (rtol 1e-12) and float32 (rtol 1e-5, with the atol 1e-6
of tests/test_torch_cartesian.py: XLA may fuse a product and a sum into one
rounding, and a tridiag solution near 0 carries that difference of a few
ulp of its larger terms). vadv in float64 is held at rtol 1e-10, the
tolerance of its reference test (tests/parallel_tests/test_distributed.py,
test_distributed_vadv_interval_sections): XLA's float64 vadv differs from
the port's eager one by up to 1.2e-12 relative on a few points of the
9-level recurrence (the single-device JAX ``numpy`` backend and the port
agree within 1e-12, tests/test_torch_cartesian.py). Then the same for
``DistributedUnstructured`` (FVM nabla), ``halo_gather`` and
``partition_gather`` (tables equal exactly), ``shard_field``'s placement,
and ``core/native.py``. Data crosses between the packages only as NumPy
arrays.
"""

import numpy as np
import pytest
import torch

import jax

from gt4py_tpu import parallel as ref_parallel
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu_torch import parallel
from gt4py_tpu_torch.cartesian import gtscript

from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs
from .test_torch_cartesian import _ref_hdiff_generic, _ref_hdiff_sponge, _ref_tridiag_generic

CPU8 = [torch.device("cpu")] * 8
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
ATOL = {np.float64: 0.0, np.float32: 1e-6}
#: (JAX package backend, port backend)
PAIRS = [("jax", "torch"), ("tpu:pallas", "cuda:hopper")]

STENCILS = {
    "hdiff": (defs.horizontal_diffusion_generic, _ref_hdiff_generic, {}),
    "vadv": (defs.vertical_advection_dycore_generic,
             ref_defs.vertical_advection_dycore_generic, defs.VADV_EXTERNALS),
    "tridiag": (defs.tridiagonal_solver_generic, _ref_tridiag_generic, {}),
}

#: name -> (stencil, boundary, global shape, scalars)
CASES = {
    "hdiff_periodic": ("hdiff", "periodic", (32, 16, 4), {}),
    "hdiff_clamp": ("hdiff", "clamp", (32, 16, 3), {}),
    "hdiff_zero": ("hdiff", "zero", (16, 24, 2), {}),
    "hdiff_uneven_periodic": ("hdiff", "periodic", (30, 17, 3), {}),
    "hdiff_uneven_clamp": ("hdiff", "clamp", (19, 13, 2), {}),
    "hdiff_uneven_zero": ("hdiff", ("zero", "periodic"), (9, 22, 2), {}),
    "vadv": ("vadv", "periodic", (16, 8, 9), {"dtr_stage": 0.15}),
    "tridiag": ("tridiag", "periodic", (16, 16, 8), {}),
}


def _inputs(names, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    out = {n: rng.random(shape).astype(dtype) for n in names}
    if "diag" in out:  # a diagonally dominant system
        out["diag"] += 3.0
    return out


def _build(gts, definition, backend, dtype, externals):
    return gts.stencil(
        backend=backend, definition=definition, externals=externals,
        dtypes={"dt": dtype, "vadv_dt": dtype},
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_stencil_matches_jax(case, pair, dtype):
    name, boundary, shape, scalars = CASES[case]
    port_def, ref_def, externals = STENCILS[name]
    ref_backend, port_backend = pair
    ref_st = _build(ref_gtscript, ref_def, ref_backend, dtype, externals)
    port_st = _build(gtscript, port_def, port_backend, dtype, externals)
    fields = [n for n, i in port_st.field_info.items() if i is not None]
    data = _inputs(fields, shape, dtype, seed=sorted(CASES).index(case))
    scal = {k: dtype(v) for k, v in scalars.items()}
    rtol = 1e-10 if (name, dtype) == ("vadv", np.float64) else RTOL[dtype]

    ref = ref_parallel.DistributedStencil(ref_st, ref_parallel.CartesianMesh(), boundary=boundary)
    want = ref.apply(**{k: v.copy() for k, v in data.items()}, **scal)
    dist = parallel.DistributedStencil(port_st, parallel.CartesianMesh(CPU8), boundary=boundary)
    got = dist.apply(**{k: v.copy() for k, v in data.items()}, **scal)
    assert sorted(got) == sorted(want)
    assert dist.last_strategy == ["plain"] * 8
    for n in want:
        assert got[n].shape == shape and got[n].dtype == np.dtype(dtype)
        np.testing.assert_allclose(
            np.asarray(got[n]), np.asarray(want[n]), rtol=rtol, atol=ATOL[dtype])


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("shape", [(16, 24, 6), (15, 22, 6)], ids=["even", "uneven"])
def test_lower_dimensional_fields_match_jax(shape, pair):
    """hdiff_sponge: an IJ coefficient split over the mesh and a K damping
    profile whole in every shard (``spec_for``), float64."""
    ref_backend, port_backend = pair
    ref_st = _build(ref_gtscript, _ref_hdiff_sponge, ref_backend, np.float64, {})
    port_st = _build(gtscript, defs.hdiff_sponge, port_backend, np.float64, {})
    rng = np.random.default_rng(21)
    data = {"in_field": rng.random(shape), "out_field": np.zeros(shape),
            "coeff": rng.random(shape[:2]), "damp": rng.random(shape[2])}
    want = ref_parallel.DistributedStencil(ref_st).apply(**{k: v.copy() for k, v in data.items()})
    dist = parallel.DistributedStencil(port_st, parallel.CartesianMesh(CPU8))
    got = dist.apply(**data)
    assert got["out_field"].shape == shape
    np.testing.assert_allclose(np.asarray(got["out_field"]), np.asarray(want["out_field"]),
                               rtol=1e-12)
    assert dist.exchange_plan(**data)[0]["field"] == "in_field"


def test_exchange_plan_matches_shard_count_of_hlo():
    """One collective-permute pair per axis in the JAX program; in the
    port, one slab per shard, side and axis, each from a mesh neighbour."""
    port_st = _build(gtscript, defs.horizontal_diffusion_generic, "torch", np.float64, {})
    dist = parallel.DistributedStencil(port_st, parallel.CartesianMesh(CPU8))
    shape = (16, 32, 3)
    plan = dist.exchange_plan(in_field=np.zeros(shape), coeff=np.zeros(shape),
                              out_field=np.zeros(shape))
    ref_st = _build(ref_gtscript, _ref_hdiff_generic, "jax", np.float64, {})
    hlo = ref_parallel.DistributedStencil(ref_st).lowered_hlo(
        in_field=np.zeros(shape), coeff=np.zeros(shape), out_field=np.zeros(shape))
    assert "collective-permute" in hlo and "all-gather" not in hlo
    assert len(plan) == 4 * len(CPU8)
    assert {(t["axis"], t["slab"][:2]) for t in plan} == {("i", (2, 8)), ("j", (12, 2))}


# --- unstructured ---------------------------------------------------------------


def _ring_blocks(array, n=8):
    return [b.to(d) for b, d in zip(torch.chunk(torch.as_tensor(array), n), CPU8)]


@pytest.mark.parametrize("offsets", [[-2, 0, 1, 3], [-1, 0, 2], [0, 1]])
def test_partition_and_halo_gather_match_jax(offsets):
    """partition_gather's tables and halo widths equal the JAX package's
    exactly; halo_gather over the port's ring equals the JAX package's
    halo_gather under shard_map."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from gt4py_tpu.parallel import unstructured as ref_un
    from gt4py_tpu_torch.parallel import unstructured as un

    n = 64
    table = (np.arange(n)[:, None] + np.asarray(offsets)[None, :]) % n
    vals = np.random.default_rng(len(offsets)).random(n).astype(np.float32)
    plan = un.partition_gather(table, n, 8)
    ref_plan = ref_un.partition_gather(table, n, 8)
    np.testing.assert_array_equal(plan.local_tables, ref_plan.local_tables)
    assert (plan.halo_lo, plan.halo_hi, plan.n_local) == (
        ref_plan.halo_lo, ref_plan.halo_hi, ref_plan.n_local)

    mesh1d = Mesh(np.asarray(jax.devices()[:8]), axis_names=("x",))
    want = jax.jit(shard_map(
        lambda vv, tt: ref_un.halo_gather(vv, tt, ref_plan, "x"), mesh=mesh1d,
        in_specs=(P("x"), P("x", None)), out_specs=P("x", None),
    ))(vals, ref_plan.local_tables)
    got = un.halo_gather(_ring_blocks(vals), _ring_blocks(plan.local_tables), plan)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))


def test_distributed_nabla_matches_jax():
    """FVM nabla through DistributedUnstructured on both packages, the same
    mesh, renumbering and float32 inputs: equal within rtol 1e-5."""
    import gt4py_tpu.next as ref_gtx
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu.next.mesh_utils import Renumbering as RefRenumbering
    from gt4py_tpu.next.mesh_utils import periodic_quad_mesh as ref_mesh
    from gt4py_tpu.parallel.unstructured import DistributedUnstructured as RefDU
    from gt4py_tpu_torch.next.mesh_utils import Renumbering, periodic_quad_mesh
    from gt4py_tpu_torch.parallel.unstructured import DistributedUnstructured

    from . import test_torch_parallel_distributed_unstructured as port_t
    from .parallel_tests import test_distributed_unstructured as ref_t

    nmesh = 16
    e2v_np, v2e_np, signs = periodic_quad_mesh(nmesh)
    assert all(np.array_equal(a, b) for a, b in zip(ref_mesh(nmesh), (e2v_np, v2e_np, signs)))
    nv = nmesh * nmesh
    rng = np.random.default_rng(0)
    pp, vol = rng.random(nv).astype(np.float32), (rng.random(nv) + 0.5).astype(np.float32)
    sx = rng.random(2 * nv).astype(np.float32)
    perm = port_t.edge_row_interleave(nmesh).perm

    ref = RefDU(
        ref_t.nabla,
        offset_provider={"E2V": ref_gtx.as_connectivity([ref_t.E, ref_t.E2VDim], ref_t.V, e2v_np),
                         "V2E": ref_gtx.as_connectivity([ref_t.V, ref_t.V2EDim], ref_t.E, v2e_np)},
        sizes={ref_t.V: nv, ref_t.E: 2 * nv}, renumberings=[RefRenumbering(ref_t.E, perm)],
    )
    want = ref(ref_gtx.as_field([ref_t.V], pp), ref_gtx.as_field([ref_t.E], sx),
               ref_gtx.as_field([ref_t.V, ref_t.V2EDim], signs.astype(np.float32)),
               ref_gtx.as_field([ref_t.V], vol))
    port = DistributedUnstructured(
        port_t.nabla,
        offset_provider={
            "E2V": gtx.as_connectivity([port_t.E, port_t.E2VDim], port_t.V, e2v_np, device="cpu"),
            "V2E": gtx.as_connectivity([port_t.V, port_t.V2EDim], port_t.E, v2e_np, device="cpu"),
        },
        sizes={port_t.V: nv, port_t.E: 2 * nv}, renumberings=[Renumbering(port_t.E, perm)],
        mesh=CPU8,
    )
    got = port(gtx.as_field([port_t.V], pp, device="cpu"),
               gtx.as_field([port_t.E], sx, device="cpu"),
               gtx.as_field([port_t.V, port_t.V2EDim], signs.astype(np.float32), device="cpu"),
               gtx.as_field([port_t.V], vol, device="cpu"))
    np.testing.assert_allclose(got.ndarray.numpy(), np.asarray(want.ndarray), rtol=1e-5)


def test_shard_field_placement_matches_jax():
    """shard_field's placement gives the JAX NamedSharding's shard shape,
    and the placed field's values are the field's."""
    import gt4py_tpu.next as ref_gtx
    import gt4py_tpu_torch.next as gtx

    data = np.random.default_rng(3).random((64, 32, 4))
    ref_dims = [ref_gtx.Dimension("I"), ref_gtx.Dimension("J"),
                ref_gtx.Dimension("K", kind=ref_gtx.DimensionKind.VERTICAL)]
    dims = [gtx.Dimension("I"), gtx.Dimension("J"),
            gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)]
    want = ref_parallel.shard_field(ref_gtx.as_field(ref_dims, data), ref_parallel.CartesianMesh())
    got = parallel.shard_field(gtx.as_field(dims, data, device="cpu"),
                               parallel.CartesianMesh(CPU8))
    assert got.ndarray.sharding.shard_shape(data.shape) == want.ndarray.sharding.shard_shape(
        data.shape)
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(want.ndarray))


# --- core/native.py --------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 7, 64, 4097])
def test_content_hash_matches_jax(size):
    from gt4py_tpu.core import native as ref_native
    from gt4py_tpu_torch.core import native

    data = np.random.default_rng(size).bytes(size)
    assert native.content_hash(data) == ref_native.content_hash(data)
    assert native.content_hash(data) == native._fnv1a64(data)  # native == pure Python


@pytest.mark.parametrize("alignment", [64, 128, 4096])
def test_aligned_empty_aligned(alignment):
    from gt4py_tpu_torch.core import native

    arr = native.aligned_empty((3, 5, 7), np.float32, alignment=alignment)
    assert arr.shape == (3, 5, 7) and arr.dtype == np.float32
    assert arr.ctypes.data % alignment == 0
    arr[...] = 1.0
    assert arr.sum() == 105.0


def test_native_library_built_into_the_port_cache():
    import os

    from gt4py_tpu_torch.cartesian.caching import GT_CACHE_ROOT
    from gt4py_tpu_torch.core import native

    if native.get_lib() is None:
        pytest.skip("no C compiler here: the pure-Python path serves")
    assert os.path.isfile(os.path.join(GT_CACHE_ROOT, "native", "libgt4py_tpu_torch_fastpath.so"))


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool"])
def test_cpu_allocator_aligned_as_jax(dtype):
    """The port's host allocator hands out zeroed buffers from the native
    aligned allocator, at the JAX package's alignment, in the asked layout."""
    from gt4py_tpu.next.allocators import CPUFieldBufferAllocator as RefAllocator
    from gt4py_tpu_torch.next.allocators import CPUFieldBufferAllocator

    ref = RefAllocator().allocate((3, 5, 7), dtype)
    alloc = CPUFieldBufferAllocator()
    assert alloc.alignment == RefAllocator().alignment
    for layout in (None, (2, 0, 1)):
        got = alloc.allocate((3, 5, 7), dtype, layout)
        assert got.data_ptr() % alloc.alignment == 0
        assert tuple(got.shape) == ref.shape and str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(got.numpy(), ref)
    assert alloc.allocate((3, 5, 7), dtype, (2, 0, 1)).stride() == (5, 1, 15)
