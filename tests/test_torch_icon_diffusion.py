"""ICON's Smagorinsky diffusion of the normal wind through the field view
(perfbench/programs/icon_diffusion_vn.py) on ``cuda:hopper``: the generated
gather-reduce kernel's ``sqrt``, ``maximum`` and ``minimum``, fields over
``K`` alone, the pointwise update with ``vn`` read and written, and the
torus mesh (``mesh_utils.periodic_triangle_mesh``).

On the CPU, on a 12 x 8 torus of 5 levels in float64: the lowering's plain
path against the plain reference (perfbench/reference/icon_diffusion_vn.py)
to the bit, the ``torch`` backend and the JAX package's ``numpy`` field view
running the same operators within 1e-12, the declines counted (none in the
step, an alias read under a shift still), the generated sources, the mesh's
invariants, the in-place update on a stand-in for the card, the step on
``cuda:hopper:aot`` (the gathers lowered with the program's offset
provider), and a cartesian update in place left to the bridge.
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
from gt4py_tpu_torch.next import maximum, minimum, neighbor_sum, otf, sqrt
from gt4py_tpu_torch.next import unstructured_codegen as uc
from gt4py_tpu_torch.next.mesh_utils import periodic_triangle_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import spec  # noqa: E402

from . import neighbor_host_emulation as host  # noqa: E402

PROGRAM = spec.load_module(REPO, "programs", "icon_diffusion_vn")
REFERENCE = spec.load_module(REPO, "reference", "icon_diffusion_vn")
Edge, Vertex, K = PROGRAM.Edge, PROGRAM.Vertex, PROGRAM.K
E2C2VDim, V2EDim = PROGRAM.E2C2VDim, PROGRAM.V2EDim
V2E, E2C2V = PROGRAM.V2E, PROGRAM.E2C2V
OPERATORS = [op.definition.__name__ for op in PROGRAM.OPERATORS]


def config(nx=12, ny=8, nk=5) -> dict:
    full = spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                       "icon_diffusion_vn_1m_l80_f64.json"))
    return PROGRAM.small_config(full, nx, ny, nk)


def fields_of(cfg, seed=11) -> dict:
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {r: torch.zeros(f["shape"], dtype=torch.float64) for r, f in cfg["fields"].items()}
    out["vn"] = torch.rand(out["vn"].shape, generator=gen, dtype=torch.float64)
    return out


def step_on(backend, cfg, seed=11) -> tuple:
    """(the written fields, their starting vn) after one ``diffusion_vn``
    call on ``backend``."""
    fields = fields_of(cfg, seed)
    vn0 = fields["vn"].clone()
    kwargs, provider = PROGRAM.operands(cfg, fields)
    PROGRAM.make_program(backend)(**kwargs, offset_provider=provider)
    return fields, vn0


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# --- the mesh -------------------------------------------------------------------------


@pytest.mark.parametrize("nx, ny", [(12, 8), (3, 3), (5, 7)])
def test_torus_invariants(nx, ny):
    """Counts; each vertex's six V2E edges contain it; E2C2V[0..1] are E2V;
    E2C2V[2..3] the vertices opposite the edge in its E2C cells (C2E, read
    back, holds the edge); E2ECV is 4e + i; every edge joins two distinct
    vertices, and no two edges join the same pair."""
    t = periodic_triangle_mesh(nx, ny)
    nv, ne, nc = nx * ny, 3 * nx * ny, 2 * nx * ny
    assert {k: v.shape for k, v in t.items()} == {
        "E2V": (ne, 2), "E2C": (ne, 2), "C2E": (nc, 3), "V2E": (nv, 6), "E2C2V": (ne, 4),
        "E2ECV": (ne, 4)}
    assert all(v.dtype == np.int64 for v in t.values())
    e2v, e2c, c2e, v2e, e2c2v = (t[k] for k in ("E2V", "E2C", "C2E", "V2E", "E2C2V"))
    assert (e2v[v2e] == np.arange(nv)[:, None, None]).any(axis=2).all()
    assert len(np.unique(v2e, axis=None)) == ne  # every edge in two vertices' rows
    assert np.array_equal(e2c2v[:, :2], e2v)
    c2v = [set(e2v[c2e[c]].ravel()) for c in range(nc)]
    assert all(len(v) == 3 for v in c2v)
    for e in range(ne):
        for j in range(2):
            cell = e2c[e, j]
            assert e in c2e[cell]
            (opposite,) = c2v[cell] - set(e2v[e])
            assert e2c2v[e, 2 + j] == opposite
    assert np.array_equal(t["E2ECV"], 4 * np.arange(ne)[:, None] + np.arange(4))
    assert (e2v[:, 0] != e2v[:, 1]).all()
    assert len({tuple(sorted(p)) for p in e2v.tolist()}) == ne


def test_torus_needs_three_rows_and_columns():
    with pytest.raises(ValueError):
        periodic_triangle_mesh(2, 5)


# --- the step against the reference --------------------------------------------------------


def test_plain_path_equals_the_reference_to_the_bit():
    cfg = config()
    before = dict(uc.declined)
    uc.calls_served.clear()
    got, vn0 = step_on("cuda:hopper", cfg)
    want = REFERENCE.step({"vn": vn0}, cfg)
    for role in PROGRAM.WRITTEN:
        assert torch.equal(got[role], want[role]), role
    # every call lowered, none declined
    assert uc.calls_served["neighbor"] == 5 and dict(uc.declined) == before


def test_aot_lowers_the_gathers_with_the_programs_provider():
    """On ``cuda:hopper:aot`` the stages lower each gather operator with the
    offset provider of the program it is called in (the operators get none
    of their own): four calls served by the lowering, none declined; the
    update, which the stages trace for the bridge, runs there."""
    cfg = config()
    before = dict(uc.declined)
    uc.calls_served.clear()
    got, vn0 = step_on("cuda:hopper:aot", cfg)
    want = REFERENCE.step({"vn": vn0}, cfg)
    for role in PROGRAM.WRITTEN:
        assert torch.equal(got[role], want[role]), role
    assert uc.calls_served["neighbor"] == 4 and dict(uc.declined) == before


def test_torch_backend_within_1e12_of_the_reference():
    cfg = config()
    got, vn0 = step_on("torch", cfg)
    want = REFERENCE.step({"vn": vn0}, cfg)
    for role in PROGRAM.WRITTEN:
        assert rel_err(got[role], want[role]) <= 1e-12, role


def _jax_twin(tmp_path):
    """The program module's operators defined against the JAX package."""
    import importlib.util

    src = open(os.path.join(REPO, "perfbench", "programs", "icon_diffusion_vn.py")).read()
    path = tmp_path / "icon_diffusion_vn_jax.py"
    path.write_text(re.sub(r"\bgt4py_tpu_torch\b", "gt4py_tpu", src))
    module_spec = importlib.util.spec_from_file_location("icon_diffusion_vn_jax", path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[module_spec.name] = module  # the frontend reads the definitions' source
    module_spec.loader.exec_module(module)
    return module


def test_jax_numpy_backend_within_1e12_of_the_port(tmp_path):
    """The same five calls on the JAX package's ``numpy`` field view, from the
    same vn, geometry and tables, against the port's ``cuda:hopper``."""
    import gt4py_tpu.next as jgtx

    twin = _jax_twin(tmp_path)
    cfg = config()
    fields = fields_of(cfg)
    vn0 = fields["vn"].clone()
    kwargs, provider = PROGRAM.operands(cfg, fields)
    dims = {d.value: getattr(twin, n) for n, d in (
        ("Edge", Edge), ("Vertex", Vertex), ("ECV", PROGRAM.ECV), ("K", K), ("V2EDim", V2EDim),
        ("E2C2VDim", E2C2VDim))}

    def twin_field(value):
        if isinstance(value, float):
            return value
        return jgtx.as_field([dims[d.value] for d in value.dims], value.ndarray.numpy().copy())

    j = {name: twin_field(value) for name, value in kwargs.items()}
    j["vn"] = jgtx.as_field([twin.Edge, twin.K], vn0.numpy().copy())
    jprov = {name: jgtx.as_connectivity([dims[d.value] for d in c.domain_dims],
                                        dims[c.codomain.value], c.table.numpy())
             for name, c in provider.items()}
    rbf, nabla2, nabla4, apply = (op.with_backend("numpy") for op in twin.OPERATORS)
    rbf(j["vn"], j["ptr_coeff_1"], j["ptr_coeff_2"], out=(j["u_vert"], j["v_vert"]),
        offset_provider=jprov)
    nabla2(*(j[n] for n in (
        "diff_multfac_smag", "tangent_orientation", "inv_primal_edge_length",
        "inv_vert_vert_length", "u_vert", "v_vert", "primal_normal_vert_x",
        "primal_normal_vert_y", "dual_normal_vert_x", "dual_normal_vert_y", "vn", "smag_limit",
        "smag_offset")), out=(j["kh_smag_e"], j["kh_smag_ec"], j["z_nabla2_e"]),
        offset_provider=jprov)
    rbf(j["z_nabla2_e"], j["ptr_coeff_1"], j["ptr_coeff_2"], out=(j["u_vert"], j["v_vert"]),
        offset_provider=jprov)
    nabla4(*(j[n] for n in ("u_vert", "v_vert", "primal_normal_vert_x", "primal_normal_vert_y",
                            "z_nabla2_e", "inv_vert_vert_length", "inv_primal_edge_length")),
           out=j["z_nabla4_e2"], offset_provider=jprov)
    apply(*(j[n] for n in ("area_edge", "kh_smag_e", "z_nabla2_e", "z_nabla4_e2",
                           "diff_multfac_vn", "nudgecoeff_e", "vn", "nudgezone_diff")),
          out=j["vn"], offset_provider=jprov)
    PROGRAM.make_program("cuda:hopper")(**kwargs, offset_provider=provider)
    for role in PROGRAM.WRITTEN:
        theirs = torch.from_numpy(np.array(j[role].asnumpy()))
        assert rel_err(fields[role], theirs) <= 1e-12, role


# --- the generated sources ----------------------------------------------------------------


@pytest.fixture(scope="module")
def lowered():
    return dict(zip(OPERATORS, PROGRAM.lowered(config())))


def test_every_operator_of_the_step_is_lowered(lowered):
    assert [p.name for p in lowered.values()] == OPERATORS
    assert all(p.kernel.startswith(f"gt_neighbor_{p.name}_") for p in lowered.values())
    # the update reads every field at its own element: vn may be its out
    apply = lowered["apply_nabla2_and_nabla4_to_vn"]
    assert not apply.conns and apply.own_only == frozenset(range(len(apply.fields)))


def test_sources_hold_max_min_sqrt_and_k_only_loads(lowered):
    src = lowered["calculate_nabla2_and_smag_coefficients_for_vn"].source
    # NaN-propagating max and min, as torch.maximum/torch.minimum, not bare fmax
    assert "double gt_max(double a, double b) { return a != a ? a : (b != b ? b : fmax(a, b)); }" \
        in src
    assert "double gt_min(double a, double b) { return a != a ? a : (b != b ? b : fmin(a, b)); }" \
        in src
    assert "double gt_sqrt(double a) { return __dsqrt_rn(a); }" in src
    assert src.count("gt_max(") == 2 and src.count("gt_min(") == 2 and src.count("gt_sqrt(") == 2
    # diff_multfac_smag (f0) and smag_limit (f11) over K alone: a row pointer
    # at the lane's level, no horizontal term
    program = lowered["calculate_nabla2_and_smag_coefficients_for_vn"]
    k_only = [i for i, f in enumerate(program.fields) if f.dims == (K,)]
    assert [program.fields[i].param for i in k_only] == ["diff_multfac_smag", "smag_limit"]
    for i in k_only:
        assert re.search(rf"const double\* __restrict__ b\d+ = p\.f{i} \+ gt_lane;", src)
        assert program.field_strides[i] == (0, 0, 1)
    # the helpers only where called
    assert "gt_sqrt" not in lowered["calculate_nabla4"].source
    assert "gt_max" in lowered["apply_nabla2_and_nabla4_to_vn"].source


def test_update_in_place_reads_vn_through_a_plain_pointer(lowered):
    program = lowered["apply_nabla2_and_nabla4_to_vn"]
    vn = [i for i, f in enumerate(program.fields) if f.param == "vn"][0]
    aliased = program.aliased(((vn, 0),))
    assert aliased is program.aliased(((vn, 0),)) and program.aliased(()) is program
    assert aliased.kernel != program.kernel
    assert f"const double* f{vn};" in aliased.source and "double* o0;" in aliased.source
    assert f"gt_ld(p.f{vn} +" in aliased.source or re.search(r"gt_ld\(b\d+ \+", aliased.source)
    assert "__ldg(" in aliased.source  # the other fields keep the read-only path
    assert f"const double* __restrict__ f{vn};" in program.source


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
@pytest.mark.parametrize("name", OPERATORS)
def test_sources_compile_as_cxx(lowered, name, tmp_path):
    """Each kernel's C++ (the update's aliased variant too) under a host
    compiler, CUDA's names stubbed (nvcc runs only on the card's machine)."""
    program = lowered[name]
    sources = [program.source]
    if name == "apply_nabla2_and_nabla4_to_vn":
        sources.append(program.aliased(((6, 0),)).source)
    stub = ("#include <cmath>\n"
            "struct gt_dim3 { unsigned x; }; static gt_dim3 blockIdx, threadIdx;\n"
            "#define __global__\n#define __device__\n#define __forceinline__ inline\n"
            "#define __launch_bounds__(n)\n"
            "template <class T> T __ldg(const T* p) { return *p; }\n"
            "static double __dsqrt_rn(double a) { return std::sqrt(a); }\n"
            "using std::fmax; using std::fmin;\n"
            "typedef void* cudaStream_t; enum { cudaErrorInvalidConfiguration = 9 };\n"
            "static int cudaGetLastError() { return 0; }\n")
    for i, src in enumerate(sources):
        src = re.sub(r"<<<[^>]*>>>", "", src.replace("#include <cuda_runtime.h>", stub))
        path = tmp_path / f"kernel{i}.cpp"
        path.write_text(src)
        out = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-Wall", "-Werror",
                              "-Wno-unknown-pragmas", "-Wno-unused-function", str(path)],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr


# --- lanes an element --------------------------------------------------------------------------
#
# Sources lowered on the 12 x 8 torus (288 edges, 96 vertices) at the levels
# given; the update's in-place variant too. Where 32 lanes an element still
# pad K the least (137 levels), every source is the one of the kernel
# before 16 lanes, byte for byte (its SHA-1).

UNCHANGED_SOURCES = {
    "mo_intp_rbf_rbf_vec_interpol_vertex": "51acca0a7b04add4fb6b87d1f0750edaf7fd5d82",
    "calculate_nabla2_and_smag_coefficients_for_vn": "9d18ffef1192b0c036e5d7c73fcc1e1d86dfecad",
    "calculate_nabla4": "dafed81fe9ec51ec415d1561ddbc159ee96a09f9",
    "apply_nabla2_and_nabla4_to_vn": "3db1c7038154011dafb9e6e87fd222e3806ac633",
    "apply_nabla2_and_nabla4_to_vn/aliased": "713b54b78a47849d3e32f9ce7b45e9d83049fce9",
}

#: each operator's call in the step: (operator, its arguments' names, its
#: outs' names)
CALLS = [
    (PROGRAM.OPERATORS[0], ("vn", "ptr_coeff_1", "ptr_coeff_2"), ("u_vert", "v_vert")),
    (PROGRAM.OPERATORS[1], ("diff_multfac_smag", "tangent_orientation", "inv_primal_edge_length",
                            "inv_vert_vert_length", "u_vert", "v_vert", "primal_normal_vert_x",
                            "primal_normal_vert_y", "dual_normal_vert_x", "dual_normal_vert_y",
                            "vn", "smag_limit", "smag_offset"),
     ("kh_smag_e", "kh_smag_ec", "z_nabla2_e")),
    (PROGRAM.OPERATORS[2], ("u_vert", "v_vert", "primal_normal_vert_x", "primal_normal_vert_y",
                            "z_nabla2_e", "inv_vert_vert_length", "inv_primal_edge_length"),
     ("z_nabla4_e2",)),
    (PROGRAM.OPERATORS[3], ("area_edge", "kh_smag_e", "z_nabla2_e", "z_nabla4_e2",
                            "diff_multfac_vn", "nudgecoeff_e", "vn", "nudgezone_diff"), ("vn",)),
]


def call_of(kwargs: dict, names: tuple, outs: tuple) -> tuple:
    """(arguments, out) of a call of :data:`CALLS` on ``kwargs``."""
    out = tuple(kwargs[n] for n in outs)
    return tuple(kwargs[n] for n in names), out if len(out) > 1 else out[0]


def lowered_at(nk: int, dtype: str = "float64") -> dict:
    """name -> program of each operator of the step on the 12 x 8 torus at
    ``nk`` levels in ``dtype``; the update's in-place variant under
    ``<name>/aliased``."""
    cfg = config(nk=nk)
    fields = {r: t.to(getattr(torch, dtype)) for r, t in fields_of(cfg).items()}
    kwargs, provider = PROGRAM.operands(cfg, fields)
    programs = {}
    for op, names, outs in CALLS:
        args, out = call_of(kwargs, names, outs)
        programs[op.definition.__name__] = uc.lower(op, args, {}, out, provider)
    apply = programs["apply_nabla2_and_nabla4_to_vn"]
    vn = [i for i, f in enumerate(apply.fields) if f.param == "vn"][0]
    programs["apply_nabla2_and_nabla4_to_vn/aliased"] = apply.aliased(((vn, 0),))
    return programs


def test_80_levels_take_five_trips_of_16_lanes():
    """At the benchmark's 80 levels every kernel of the step gives an
    element 16 lanes, five whole trips (32 lanes: three, the last half
    idle), no lane masked; the kernels keep their names."""
    for name, program in lowered_at(80).items():
        src = program.source
        assert program.lanes == 16, name
        assert program.kernel.startswith(f"gt_neighbor_{name.split('/')[0]}_")
        assert "16 lanes an element along K" in src and "gt_in_" not in src
        assert src.count("s0[") == 5 and "const int gt_h = gt_t / 16;" in src


@pytest.mark.parametrize("name", sorted(UNCHANGED_SOURCES))
def test_source_unchanged_where_32_lanes_pad_k_the_least(name):
    """At 137 levels (five trips of 32; 16 lanes would need nine, rolled)
    each kernel of the step, the update's in-place variant too, is the
    plain one of 32 lanes, its source unchanged byte for byte."""
    import hashlib

    program = lowered_at(137)[name]
    assert program.lanes == 32
    assert hashlib.sha1(program.source.encode()).hexdigest() == UNCHANGED_SOURCES[name]


def test_one_thread_an_element_where_k_is_outer():
    """``vn`` over ``K`` then ``Edge`` (K outermost): one thread an
    element, whatever the levels."""
    cfg = config(nk=9)
    fields = {r: t.t().contiguous().t() for r, t in fields_of(cfg).items()}
    kwargs, provider = PROGRAM.operands(cfg, fields)
    program = uc.lower(PROGRAM.OPERATORS[0], (kwargs["vn"], kwargs["ptr_coeff_1"],
                                              kwargs["ptr_coeff_2"]), {},
                       (kwargs["u_vert"], kwargs["v_vert"]), provider)
    assert program.lanes == 1 and "one thread an element" in program.source


@pytest.mark.skipif(not host.available(), reason="needs a host C++ compiler")
@pytest.mark.parametrize("nk, dtype", [(2, "float64"), (33, "float64"), (80, "float64"),
                                       (31, "float32"), (80, "float32")])
def test_kernels_on_the_host_equal_the_32_lane_kernels(nk, dtype):
    """Each operator's kernel run on the host (``neighbor_host_emulation``)
    on a 7 x 5 torus (105 edges, 35 vertices: no multiple of a block's
    elements) against the 32-lane kernel of the same DAG on the same
    inputs, to the bit (the update in place: both from the same ``vn``)."""
    import dataclasses

    cfg = PROGRAM.small_config(config(), 7, 5, nk)
    fields = {r: t.to(getattr(torch, dtype)) for r, t in fields_of(cfg).items()}
    kwargs, provider = PROGRAM.operands(cfg, fields)
    for op, names, out_names in CALLS:
        args, out = call_of(kwargs, names, out_names)
        program = uc.lower(op, args, {}, out, provider)
        values, scalars = uc._call_values(program, uc.bind(op.definition, args, {}))
        outs = [kwargs[n] for n in out_names]
        twin = dataclasses.replace(program, lanes=32 if program.lanes > 1 else 1)
        twin.source, twin.kernel = uc.generate(twin)
        start = [o.ndarray.clone() for o in outs]
        got = []
        for p in (twin, program):
            for o, s in zip(outs, start):
                o.ndarray.copy_(s)
            assert host.launch(p, values, outs, scalars, provider) == 0
            got.append([o.ndarray.clone() for o in outs])
        assert all(torch.equal(a, b) for a, b in zip(*got)), program.name
        assert program.lanes == uc._lanes(nk)


# --- the builtins, K-only fields and declines on a small mesh ------------------------------


@gtx.field_operator
def _limited(a, lo, hi):
    return minimum(maximum(lo, sqrt(a)), hi)


@gtx.field_operator
def _limited_at_first_end(v, lo, hi):
    return minimum(maximum(lo, sqrt(v(E2C2V[0]))), hi)


#: sqrt's, maximum's and minimum's operands: a NaN, a negative, zero and
#: ordinary values at three vertices, and bounds over K, one a NaN
_VALUES = [float("nan"), -1.0, 0.25, 4.0, 9.0, 0.0, 16.0, float("nan"), 1.0]
_LO, _HI = [0.4, 0.1, float("nan")], [2.5, 3.5, 3.0]


def _nan_case(device):
    """(the operator's arguments, out, provider, torch's result): vertex
    values read at each edge's first end (E2C2V[0]), so that the bridge
    refuses the call and the generated kernel serves it."""
    v = gtx.as_field([Vertex, K], np.asarray(_VALUES).reshape(3, 3), device=device)
    lo = gtx.as_field([K], np.asarray(_LO), device=device)
    hi = gtx.as_field([K], np.asarray(_HI), device=device)
    table = np.asarray([[e % 3, 0, 0, 0] for e in range(6)], dtype=np.int64)
    provider = {"E2C2V": gtx.as_connectivity([Edge, E2C2VDim], Vertex, table, device=device)}
    out = gtx.zeros({Edge: 6, K: 3}, dtype=np.float64, device=device)
    gathered = v.ndarray[torch.as_tensor(table[:, 0], device=v.ndarray.device)]
    want = torch.minimum(torch.maximum(lo.ndarray[None, :], torch.sqrt(gathered)),
                         hi.ndarray[None, :])
    return (v, lo, hi), out, provider, want


@pytest.mark.parametrize("backend", ["cuda:hopper", "numpy"])
def test_builtins_propagate_nan_as_torch(backend):
    """sqrt, maximum and minimum of a NaN, a negative and ordinary values,
    with K-only bounds: the lowering's plain path equals torch's functions,
    NaN included, as the ``numpy`` oracle does."""
    args, out, provider, want = _nan_case("cpu")
    before, served = dict(uc.declined), uc.calls_served["neighbor"]
    with np.errstate(invalid="ignore"):  # the oracle's sqrt of -1
        _limited_at_first_end.with_backend(backend)(*args, out=out, offset_provider=provider)
    assert torch.equal(out.ndarray.isnan(), want.isnan())
    assert torch.equal(out.ndarray.nan_to_num(-7.0), want.nan_to_num(-7.0))
    assert dict(uc.declined) == before
    assert uc.calls_served["neighbor"] == served + (backend == "cuda:hopper")


@gtx.field_operator
def _vertex_sum_over_edges(c):
    return neighbor_sum(c, axis=V2EDim)


def test_no_connectivity_and_another_horizontal_dimension_is_declined():
    c = gtx.as_field([Vertex, V2EDim], np.ones((4, 6)), device="cpu")
    out = gtx.zeros({Edge: 12}, dtype=np.float64, device="cpu")
    before = uc.declined[uc.DECLINED_NO_CONNECTIVITY]
    with pytest.raises(uc.Declined) as info:
        uc.lower(_vertex_sum_over_edges, (c,), {}, out, {})
    assert info.value.reason == uc.DECLINED_NO_CONNECTIVITY
    assert uc.declined[uc.DECLINED_NO_CONNECTIVITY] == before + 1


def test_a_field_over_no_dimension_is_still_declined():
    a = gtx.as_field([Edge, K], np.arange(9.0).reshape(3, 3), device="cpu")
    scalar_field = gtx.as_field([], np.asarray(2.0), device="cpu")
    out = gtx.zeros({Edge: 3, K: 3}, dtype=np.float64, device="cpu")
    with pytest.raises(uc.Declined) as info:
        uc.lower(_limited, (a, scalar_field, scalar_field), {}, out, {})
    assert info.value.reason == uc.DECLINED_DIMS


# --- on a stand-in for the card -------------------------------------------------------------


class _FakeGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        return self.body()

    def retire(self):
        pass


class _Stream:
    cuda_stream = 1


def install_fake_card(monkeypatch) -> list:
    """Every device a card: the lowered kernel's launch stood in for by its
    plain version (counted by ``NEIGHBOR``), a capture by its body. Returns
    the programs launched, in order."""
    launched = []

    def fake_prepare(self, values, outs, scalars, providers, device):
        def launch():
            launched.append(self)
            self.run_plain(values, outs, scalars, providers)
            return cuda_backend.NEIGHBOR.launch(lambda: 0, ())
        return launch

    monkeypatch.setattr(uc, "launches_on", lambda device: True)
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    monkeypatch.setattr(otf, "_stream", lambda device: _Stream())
    monkeypatch.setattr(otf, "capture", lambda device, stream, body, keeps: _FakeGraph(body))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(uc.NeighborProgram, "prepare", fake_prepare)
    return launched


def test_step_on_a_card_stand_in_is_five_kernels_vn_in_place(monkeypatch):
    """Three steps: each call a launch of its lowered kernel (the first
    launches, the second captures, the third replays), the update's the
    aliased variant; nothing declined, every result the reference's."""
    launched = install_fake_card(monkeypatch)
    cfg = config()
    fields = fields_of(cfg)
    kwargs, provider = PROGRAM.operands(cfg, fields)
    program = PROGRAM.make_program("cuda:hopper")
    before, launches = dict(uc.declined), cuda_backend.NEIGHBOR.launches
    vn = fields["vn"].clone()
    for _ in range(3):
        want = REFERENCE.step({"vn": vn}, cfg)
        program(**kwargs, offset_provider=provider)
        for role in PROGRAM.WRITTEN:
            assert torch.equal(fields[role], want[role]), role
        vn = want["vn"]
    assert dict(uc.declined) == before
    assert cuda_backend.NEIGHBOR.launches == launches + 15
    assert [p.name for p in launched[:5]] == [OPERATORS[i] for i in (0, 1, 0, 2, 3)]
    assert [bool(p.aliases) for p in launched[:5]] == [False] * 4 + [True]


@gtx.field_operator
def _with_vertex_sums(e):
    at_vertex = neighbor_sum(e(V2E), axis=V2EDim)
    return e + at_vertex(E2C2V[0])


def test_an_alias_read_under_a_shift_is_still_declined(monkeypatch):
    """``out`` is the argument, read at the six edges of each edge's first
    vertex: declined (counted by call), run embedded, and right."""
    install_fake_card(monkeypatch)
    t = periodic_triangle_mesh(4, 3)
    provider = {
        "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, t["V2E"], device="cpu"),
        "E2C2V": gtx.as_connectivity([Edge, E2C2VDim], Vertex, t["E2C2V"], device="cpu"),
    }
    ne = 36
    values = np.arange(ne * 3, dtype=np.float64).reshape(ne, 3)
    e = gtx.as_field([Edge, K], values.copy(), device="cpu")
    before = uc.declined[uc.DECLINED_ALIAS]
    op = _with_vertex_sums.with_backend("cuda:hopper")
    for calls in (1, 2):
        op(e, out=e, offset_provider=provider)
        assert uc.declined[uc.DECLINED_ALIAS] == before + calls
        want = values + values[t["V2E"]].sum(axis=1)[t["E2C2V"][:, 0]]
        np.testing.assert_allclose(e.asnumpy(), want, rtol=1e-15)
        values = want


@gtx.field_operator
def _doubled(a):
    return 2.0 * a


def test_a_cartesian_update_in_place_goes_to_the_bridge_first():
    """An operator over I, J and K writing its argument is not offered to
    the lowering before the bridge (which serves it): nothing declined."""
    from gt4py_tpu_torch.next import Dimension, DimensionKind
    from gt4py_tpu_torch.next.decorators import _updates_in_place

    dims = [Dimension("I"), Dimension("J"), Dimension("K", kind=DimensionKind.VERTICAL)]
    a = gtx.as_field(dims, np.ones((4, 5, 3)), device="cpu")
    e = gtx.as_field([Edge, K], np.ones((6, 3)), device="cpu")
    assert not _updates_in_place((a,), {}, a) and _updates_in_place((e,), {}, e)
    before = dict(uc.declined)
    op = _doubled.with_backend("cuda:hopper")
    for _ in range(3):
        op(a, out=a, offset_provider={})
    assert np.array_equal(a.asnumpy(), np.full((4, 5, 3), 8.0))
    assert dict(uc.declined) == before


# --- on the card (-m cuda) ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _card_fields(cfg, seed=11) -> dict:
    return {r: t.to("cuda") for r, t in fields_of(cfg, seed).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(12, 8, 5), (64, 40, 80), (7, 5, 33)])
def test_step_equals_the_reference_to_the_bit_on_card(size):
    """Three steps on the card: five launches each (the first step's
    launches, the second's captures, the third's replays), every written
    field equal to the reference's, computed on the card, to the bit."""
    _need_card()
    cfg = config(*size)
    fields = _card_fields(cfg)
    kwargs, provider = PROGRAM.operands(cfg, fields)
    program = PROGRAM.make_program("cuda:hopper")
    before, launches = dict(uc.declined), cuda_backend.NEIGHBOR.launches
    vn = fields["vn"].clone()
    for _ in range(3):
        want = REFERENCE.step({"vn": vn}, cfg)
        program(**kwargs, offset_provider=provider)
        torch.cuda.synchronize()
        for role in PROGRAM.WRITTEN:
            assert torch.equal(fields[role], want[role]), role
        vn = want["vn"]
    assert cuda_backend.NEIGHBOR.launches == launches + 15
    assert dict(uc.declined) == before


@pytest.mark.cuda
def test_builtins_propagate_nan_as_torch_on_card():
    """The generated kernel's gt_sqrt, gt_max and gt_min against torch's
    functions on the card, NaN included."""
    _need_card()
    args, out, provider, want = _nan_case("cuda")
    launches = cuda_backend.NEIGHBOR.launches
    _limited_at_first_end.with_backend("cuda:hopper")(*args, out=out, offset_provider=provider)
    torch.cuda.synchronize()
    assert cuda_backend.NEIGHBOR.launches == launches + 1
    assert torch.equal(out.ndarray.isnan(), want.isnan())
    assert torch.equal(out.ndarray.nan_to_num(-7.0), want.nan_to_num(-7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nk", [1, 2, 31, 33, 80, 137])
def test_operators_equal_the_plain_path_on_card(nk, dtype):
    """Each operator of the step on a 7 x 5 torus (105 edges, 35 vertices)
    on the card, in the step's order, against its plain version on the
    same fields, to the bit (the update in place: its plain version from
    ``vn`` before the kernel writes it); 32, 16 or 1 lanes an element as
    ``_lanes`` picks, each call served by the lowering."""
    from .test_torch_unstructured_codegen import _against_plain_on_card

    _need_card()
    cfg = PROGRAM.small_config(config(), 7, 5, nk)
    fields = {r: t.to("cuda", getattr(torch, dtype)) for r, t in fields_of(cfg).items()}
    kwargs, provider = PROGRAM.operands(cfg, fields)
    for op, names, outs in CALLS:
        lanes = _against_plain_on_card(op, *call_of(kwargs, names, outs), provider)
        assert lanes == (uc._lanes(nk) if nk > 1 else 1)


# --- the global icosahedral grid (icon-diffusion-vn-ico) -------------------------------------
#
# ``mesh_utils.icosahedral_mesh`` and the step on it (perfbench/programs/
# icon_diffusion_vn_ico.py): twelve pentagons with the skip value -1 in
# V2E's sixth slot, the grid's own numbering, and the plain reference
# (perfbench/reference/icon_diffusion_vn_ico.py) that derives its tables
# from the triangulation alone.

from gt4py_tpu_torch.next.mesh_utils import icosahedral_mesh  # noqa: E402

ICO = spec.load_module(REPO, "programs", "icon_diffusion_vn_ico")
ICO_REFERENCE = spec.load_module(REPO, "reference", "icon_diffusion_vn_ico")
GRIDS = [(1, 0), (1, 1), (2, 1), (3, 1)]


def ico_config(root=2, bisections=1, nk=3) -> dict:
    full = spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                       "icon_diffusion_vn_r3b6_l80_f64.json"))
    return ICO.small_config(full, root, bisections, nk)


def ico_step_on(backend, cfg, seed=11) -> tuple:
    fields = fields_of(cfg, seed)
    vn0 = fields["vn"].clone()
    kwargs, provider = ICO.operands(cfg, fields)
    ICO.make_program(backend)(**kwargs, offset_provider=provider)
    return fields, vn0


@pytest.mark.parametrize("root, bisections", GRIDS)
def test_icosahedral_counts_and_euler(root, bisections):
    """20 r² 4^b cells, 30 r² 4^b edges, 10 r² 4^b + 2 vertices (V - E + F
    = 2), every table int64 of ICON's widths, the vertices on the unit
    sphere."""
    t = icosahedral_mesh(root, bisections)
    n = root * root * 4 ** bisections
    nc, ne, nv = 20 * n, 30 * n, 10 * n + 2
    assert nv - ne + nc == 2
    assert {k: v.shape for k, v in t.items() if isinstance(v, np.ndarray)} == {
        "C2V": (nc, 3), "E2V": (ne, 2), "E2C": (ne, 2), "C2E": (nc, 3), "V2E": (nv, 6),
        "E2C2V": (ne, 4), "E2ECV": (ne, 4), "xyz": (nv, 3)}
    assert all(t[k].dtype == np.int64 for k in ("C2V", "E2V", "E2C", "C2E", "V2E", "E2C2V"))
    np.testing.assert_allclose(np.linalg.norm(t["xyz"], axis=1), 1.0, rtol=1e-14)
    assert t["skip_values"] == {"V2E": -1}


@pytest.mark.parametrize("root, bisections", GRIDS)
def test_icosahedral_twelve_pentagons_skip_in_v2e(root, bisections):
    """Exactly twelve vertices of degree 5, each with one -1, in V2E's sixth
    slot; every other slot an edge of the vertex, no edge twice in a row,
    and every edge in the rows of its two ends."""
    t = icosahedral_mesh(root, bisections)
    v2e, e2v = t["V2E"], t["E2V"]
    degree = np.bincount(t["C2V"].ravel(), minlength=len(v2e))
    assert sorted(set(degree.tolist())) == ([5] if bisections == 0 and root == 1 else [5, 6])
    pentagons = np.nonzero(degree == 5)[0]
    assert len(pentagons) == 12
    assert np.array_equal(np.nonzero((v2e == -1).any(axis=1))[0], pentagons)
    assert (v2e[:, :5] >= 0).all() and (v2e[pentagons, 5] == -1).all()
    present = v2e >= 0
    own = (e2v[np.where(present, v2e, 0)] == np.arange(len(v2e))[:, None, None]).any(axis=2)
    assert own[present].all()
    assert all(len(set(row[row >= 0])) == (row >= 0).sum() for row in v2e)
    assert np.array_equal(np.bincount(v2e[present], minlength=len(e2v)), np.full(len(e2v), 2))


@pytest.mark.parametrize("root, bisections", GRIDS)
def test_icosahedral_edges_in_two_cells(root, bisections):
    """Every edge in exactly two cells, C2E's sides read back; E2V its ends
    as its first cell walks them; E2C2V its ends, then the corner opposite
    it in E2C[0] and in E2C[1]; E2ECV 4e + i; no two edges join one pair."""
    t = icosahedral_mesh(root, bisections)
    c2v, c2e, e2v, e2c, e2c2v = (t[k] for k in ("C2V", "C2E", "E2V", "E2C", "E2C2V"))
    ne = len(e2v)
    assert np.array_equal(np.bincount(c2e.ravel(), minlength=ne), np.full(ne, 2))
    assert (e2c[:, 0] != e2c[:, 1]).all()
    assert np.array_equal(e2c2v[:, :2], e2v)
    for j in range(2):
        cells = e2c[:, j]
        side = np.argmax(c2e[cells] == np.arange(ne)[:, None], axis=1)
        assert (c2e[cells, side] == np.arange(ne)).all()
        walked = np.stack([c2v[cells, side], c2v[cells, (side + 1) % 3]], axis=1)
        assert np.array_equal(walked, e2v if j == 0 else e2v[:, ::-1])
        assert np.array_equal(e2c2v[:, 2 + j], c2v[cells, (side + 2) % 3])
    assert np.array_equal(t["E2ECV"], 4 * np.arange(ne)[:, None] + np.arange(4))
    assert len({tuple(sorted(p)) for p in e2v.tolist()}) == ne


@pytest.mark.parametrize("root, bisections", GRIDS)
def test_icosahedral_v2e_counter_clockwise(root, bisections):
    """Around each vertex, seen from outside the sphere, each edge of V2E
    turns counter-clockwise to the next (the last back to the first), and
    they go once round; each cell's corners counter-clockwise too."""
    t = icosahedral_mesh(root, bisections)
    xyz, v2e, e2v, c2v = t["xyz"], t["V2E"], t["E2V"], t["C2V"]
    a, b, c = (xyz[c2v[:, k]] for k in range(3))
    assert (np.einsum("ij,ij->i", np.cross(b - a, c - a), a + b + c) > 0).all()
    nv = len(v2e)
    degree = np.where(v2e[:, 5] == -1, 5, 6)
    slots = np.arange(6)
    to = np.where(v2e >= 0, v2e, v2e[:, :1])
    other = np.where(e2v[to, 0] == np.arange(nv)[:, None], e2v[to, 1], e2v[to, 0])
    d = xyz[other] - xyz[:, None, :]
    d -= np.einsum("ijk,ik->ij", d, xyz)[:, :, None] * xyz[:, None, :]  # on the tangent plane
    nxt = (slots[None, :] + 1) % degree[:, None]
    turn = np.einsum("ijk,ik->ij", np.cross(d, d[np.arange(nv)[:, None], nxt]), xyz)
    assert (turn[slots[None, :] < degree[:, None]] > 0).all()
    # once round: the turns' angles on the tangent plane add up to 2 pi
    cos = np.einsum("ijk,ijk->ij", d, d[np.arange(nv)[:, None], nxt]) / (
        np.linalg.norm(d, axis=2) * np.linalg.norm(d[np.arange(nv)[:, None], nxt], axis=2))
    angle = np.where(slots[None, :] < degree[:, None], np.arccos(np.clip(cos, -1, 1)), 0.0)
    np.testing.assert_allclose(angle.sum(axis=1), 2 * np.pi, rtol=1e-9)


@pytest.mark.parametrize("root, bisections", [(1, 1), (2, 1), (3, 1), (1, 2)])
def test_icosahedral_children_numbered_consecutively(root, bisections):
    """Cells 4p to 4p + 3 are the four children of the grid's cell p one
    bisection coarser: their tips are its corners, and their centre its
    sides' midpoints on the sphere."""
    fine, coarse = icosahedral_mesh(root, bisections), icosahedral_mesh(root, bisections - 1)
    parent = coarse["xyz"][coarse["C2V"]]  # (cells, corner, xyz)
    child = fine["xyz"][fine["C2V"]].reshape(len(parent), 4, 3, 3)
    for k in range(3):
        np.testing.assert_allclose(child[:, k, k], parent[:, k], atol=1e-14)
    mid = parent + np.roll(parent, -1, axis=1)
    mid /= np.linalg.norm(mid, axis=2, keepdims=True)  # a b, b c, c a
    np.testing.assert_allclose(child[:, 3], mid[:, [1, 2, 0]], atol=1e-14)


@pytest.mark.parametrize("root, bisections", GRIDS)
def test_icosahedral_numbering_by_first_appearance(root, bisections):
    """Vertices and edges numbered in the order the cells, walked in order,
    first name them; the order is not row-major: consecutive cells' lowest
    vertices jump back."""
    t = icosahedral_mesh(root, bisections)
    for table in ("C2V", "C2E"):
        _, first = np.unique(t[table].ravel(), return_index=True)
        assert (np.diff(first) > 0).all(), table
    lowest = t["C2V"].min(axis=1)
    if len(lowest) > 20:
        assert (np.diff(lowest) < 0).any()


def test_icosahedral_r03b06_counts():
    """The benchmark's grid: 737,280 cells, 1,105,920 edges, 368,642
    vertices, twelve of them with a -1 in V2E."""
    t = icosahedral_mesh(3, 6)
    assert (len(t["C2V"]), len(t["E2V"]), len(t["V2E"])) == (737_280, 1_105_920, 368_642)
    assert ((t["V2E"] == -1).sum(axis=1) == 1).sum() == 12 and (t["V2E"] == -1).sum() == 12


def test_icosahedral_rejects_no_root():
    with pytest.raises(ValueError):
        icosahedral_mesh(0, 2)


def test_mesh_span_and_its_attributes():
    """A build span ``gt4py.build.mesh`` around ``icosahedral_mesh``, kept with no
    profile, with the grid's kind, root, bisections and counts."""
    from gt4py_tpu_torch.instrumentation import clear_spans, spans

    clear_spans()
    icosahedral_mesh(2, 1)
    (rec,) = [r for r in spans() if r.name == "gt4py.build.mesh"]
    assert rec.attrs == {"kind": "icosahedral", "root": 2, "bisections": 1, "cells": 320,
                         "edges": 480, "vertices": 162, "pentagons": 12, "skip_slots": 12}
    assert rec.parent is None and rec.end_ns > rec.start_ns


@pytest.mark.parametrize("root, bisections", GRIDS + [(2, 3)])
def test_reference_derives_the_grids_tables(root, bisections):
    """The reference's V2E (with its skip slots), E2C2V and E2ECV, derived
    from its own triangulation alone, equal ``icosahedral_mesh``'s."""
    t = icosahedral_mesh(root, bisections)
    derived = ICO_REFERENCE.derive(ICO_REFERENCE.triangulation(root, bisections))
    for name in ("V2E", "E2C2V", "E2ECV"):
        assert np.array_equal(derived[name].numpy(), t[name]), name


@pytest.mark.parametrize("root, bisections", GRIDS + [(2, 3), (3, 2), (4, 1)])
def test_reference_triangulation_equals_icosahedral_mesh(root, bisections):
    """The reference's own triangulation (exact lattice points of the
    icosahedron's surface, numbered by first appearance) is
    ``icosahedral_mesh``'s ``C2V``, cell for cell and corner for corner."""
    c2v = ICO_REFERENCE.triangulation(root, bisections)
    assert np.array_equal(c2v.numpy(), icosahedral_mesh(root, bisections)["C2V"])


def test_ico_plain_path_equals_the_reference_to_the_bit():
    """R02B01 at 3 levels: the lowering's plain path (``cuda:hopper`` on CPU
    tensors) equals the reference to the bit; five calls served, the two
    of the interpolation masking V2E's skip values, none declined."""
    cfg = ico_config()
    before = dict(uc.declined)
    uc.calls_served.clear()
    got, vn0 = ico_step_on("cuda:hopper", cfg)
    want = ICO_REFERENCE.step({"vn": vn0}, cfg)
    for role in ICO.WRITTEN:
        assert torch.equal(got[role], want[role]), role
    assert dict(uc.calls_served) == {"neighbor": 5, "masked": 2}
    assert dict(uc.declined) == before


def test_ico_torch_backend_within_1e12_of_the_reference():
    cfg = ico_config()
    got, vn0 = ico_step_on("torch", cfg)
    want = ICO_REFERENCE.step({"vn": vn0}, cfg)
    for role in ICO.WRITTEN:
        assert rel_err(got[role], want[role]) <= 1e-12, role


def test_ico_a_skip_slot_summed_reads_far_from_the_reference():
    """The planted fault: the pentagons' sixth slot summed (the skip value
    replaced by an edge of the vertex's row) moves u_vert and v_vert at the
    pentagons by far more than the benchmark's limit."""
    cfg = ico_config()
    fields = fields_of(cfg)
    vn0 = fields["vn"].clone()
    kwargs, provider = ICO.operands(cfg, fields)
    table = provider["V2E"].table.clone()
    rows = torch.nonzero(table[:, 5] == -1).squeeze(1)
    table[rows, 5] = table[rows, 0]
    provider["V2E"] = gtx.as_connectivity([ICO.Vertex, ICO.V2EDim], ICO.Edge, table,
                                          device="cpu")
    ICO.make_program("cuda:hopper")(**kwargs, offset_provider=provider)
    want = ICO_REFERENCE.step({"vn": vn0}, cfg)
    assert rel_err(fields["u_vert"], want["u_vert"]) > 1e-3


def test_ico_jax_numpy_backend_within_1e12_of_the_port(tmp_path):
    """The same five calls on the JAX package's ``numpy`` field view, on the
    same skip-valued tables (V2E with skip_value -1), against the port's
    ``cuda:hopper``."""
    import gt4py_tpu.next as jgtx

    twin = _jax_twin(tmp_path)
    cfg = ico_config()
    fields = fields_of(cfg)
    vn0 = fields["vn"].clone()
    kwargs, provider = ICO.operands(cfg, fields)
    dims = {d.value: getattr(twin, n) for n, d in (
        ("Edge", Edge), ("Vertex", Vertex), ("ECV", PROGRAM.ECV), ("K", K), ("V2EDim", V2EDim),
        ("E2C2VDim", E2C2VDim))}

    def twin_field(value):
        if isinstance(value, float):
            return value
        return jgtx.as_field([dims[d.value] for d in value.dims], value.ndarray.numpy().copy())

    j = {name: twin_field(value) for name, value in kwargs.items()}
    j["vn"] = jgtx.as_field([twin.Edge, twin.K], vn0.numpy().copy())
    jprov = {name: jgtx.as_connectivity([dims[d.value] for d in c.domain_dims],
                                        dims[c.codomain.value], c.table.numpy(),
                                        skip_value=c.skip_value)
             for name, c in provider.items()}
    assert jprov["V2E"].skip_value == -1 and jprov["E2C2V"].skip_value is None
    ops = [o.with_backend("numpy") for o in twin.OPERATORS]
    second_rbf = (("z_nabla2_e",) + ICO.CALLS[0][0][1:], ICO.CALLS[0][1])
    for op, (names, outs) in zip([ops[0], ops[1], ops[0], ops[2], ops[3]],
                                 [ICO.CALLS[0], ICO.CALLS[1], second_rbf, *ICO.CALLS[2:]]):
        out = tuple(j[n] for n in outs)
        op(*(j[n] for n in names), out=out if len(out) > 1 else out[0], offset_provider=jprov)
    ICO.make_program("cuda:hopper")(**kwargs, offset_provider=provider)
    for role in ICO.WRITTEN:
        theirs = torch.from_numpy(np.array(j[role].asnumpy()))
        assert rel_err(fields[role], theirs) <= 1e-12, role


def test_ico_rbf_source_masks_the_skip_slots():
    """The interpolation's kernel on the skip-valued V2E: each of the six
    slots' validity tested once an element, before the level trips, the
    index of an absent slot read as 0, its term a select of 0; the edge
    operators' kernels, on E2C2V and E2ECV, mask nothing."""
    programs = ICO.lowered(ico_config())
    rbf = programs[0]
    assert rbf.masks and not any(p.masks for p in programs[1:])
    assert rbf.source.count("!= -1LL;") == 6
    assert rbf.source.count("!= -1LL ? (int)") == 6
    trips = -(-rbf.nk // rbf.lanes)
    assert len(re.findall(r"= t\d+ \? t\d+_\d : \(double\)0;", rbf.source)) == 2 * 6 * trips
    assert all("-1LL" not in p.source for p in programs[1:])


@pytest.mark.skipif(not host.available(), reason="needs a host C++ compiler")
@pytest.mark.parametrize("nk", [3, 80])
def test_ico_kernels_on_the_host_equal_the_plain_path(nk):
    """The interpolation's masked kernel run on the host
    (``neighbor_host_emulation``) on R02B01 equals its plain version, and
    its 32-lane twin, to the bit; the update too."""
    import dataclasses

    cfg = ico_config(2, 1, nk)
    fields = fields_of(cfg)
    kwargs, provider = ICO.operands(cfg, fields)
    for index in (0, 3):
        op, (names, out_names) = ICO.OPERATORS[index], ICO.CALLS[index]
        args = tuple(kwargs[n] for n in names)
        outs = [kwargs[n] for n in out_names]
        program = uc.lower(op, args, {}, tuple(outs) if len(outs) > 1 else outs[0], provider)
        values, scalars = uc._call_values(program, uc.bind(op.definition, args, {}))
        twin = dataclasses.replace(program, lanes=32)
        twin.source, twin.kernel = uc.generate(twin)
        start = [o.ndarray.clone() for o in outs]
        program.run_plain(values, outs, scalars, provider)
        got = [[o.ndarray.clone() for o in outs]]
        for p in (program, twin):
            for o, s in zip(outs, start):
                o.ndarray.copy_(s)
            assert host.launch(p, values, outs, scalars, provider) == 0
            got.append([o.ndarray.clone() for o in outs])
        for other in got[1:]:
            assert all(torch.equal(a, b) for a, b in zip(got[0], other)), program.name


def test_ico_build_lowers_on_r01b01_and_raises_without_the_grid(monkeypatch):
    """``build`` lowers the four operators on R01B01 (12 pentagons among 42
    vertices); a port without ``icosahedral_mesh`` fails it at once."""
    from gt4py_tpu_torch.next import mesh_utils

    full = spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                       "icon_diffusion_vn_r3b6_l80_f64.json"))
    assert ICO.build(full) is not None
    assert [p.nh for p in ICO.lowered(full)] == [42, 120, 120, 120]
    monkeypatch.delattr(mesh_utils, "icosahedral_mesh")
    with pytest.raises(RuntimeError, match="icosahedral"):
        ICO.build(full)


def test_ico_masked_calls_counted_on_a_card_stand_in(monkeypatch):
    """Three steps on the stand-in for the card (a key's first call
    launches, the second captures, the third replays): every step two
    calls served masked; the program's root span holds ``masked`` 2 and
    ``launches`` 5 for each call under a profile."""
    from torch.profiler import ProfilerActivity, profile

    from gt4py_tpu_torch.instrumentation import clear_spans, spans

    install_fake_card(monkeypatch)
    cfg = ico_config()
    fields = fields_of(cfg)
    kwargs, provider = ICO.operands(cfg, fields)
    program = ICO.make_program("cuda:hopper")
    vn = fields["vn"].clone()
    uc.calls_served.clear()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            want = ICO_REFERENCE.step({"vn": vn}, cfg)
            program(**kwargs, offset_provider=provider)
            for role in ICO.WRITTEN:
                assert torch.equal(fields[role], want[role]), role
            vn = want["vn"]
    assert dict(uc.calls_served) == {"neighbor": 15, "masked": 6}
    roots = [r for r in spans() if r.name == "gt4py.next.program"]
    assert [(r.attrs["masked"], r.attrs["launches"]) for r in roots] == [(2, 5)] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("grid, cells", [((2, 4, 80), 20_480), ((3, 6, 80), 737_280)])
def test_ico_step_equals_the_reference_to_the_bit_on_card(grid, cells):
    """R02B04 (20,480 cells) and the benchmark's R03B06 (chip_smoke.py's
    step 7f) at 80 levels on the card through ``make_program("cuda:hopper")``:
    exactly five ``neighbor`` launches, two calls served masked, nothing
    declined, every written field equal to the reference to the bit."""
    _need_card()
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.run_icon_ico(*grid, torch)
    assert out["launches"] == {cuda_backend.NEIGHBOR.name: 5} and out["masked"] == 2
    assert out["declines"] == out["refused"] == 0 and out["cells"] == cells
    assert all(e == 0.0 for e in out["rel_err"].values())
