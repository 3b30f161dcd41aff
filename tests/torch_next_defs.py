"""Field-view operator definitions for the PyTorch/CUDA port.

The port's counterparts of the JAX package's field-view workloads, written
against ``gt4py_tpu_torch.next`` (the JAX package's definitions bind its
own Dimension and operator classes, so they cannot be reused):

- ``lap`` and ``hdiff_op`` (tests/next_tests/test_cartesian_bridge.py:24-46),
  ``next_hdiff`` (bench.py:564-576, the same as ``hdiff_op``);
- ``solve_tridiag`` (test_cartesian_bridge.py:292-311): two scans, a tuple
  carry;
- ``next_vadv`` (test_cartesian_bridge.py:342-378): two scans with I- and
  K-shifted arguments and boundary selection through a K index field;
- ``next_tridiag`` and ``next_vadv_op(nk)``, bench.py's field-view scans
  (bench.py:1035-1048, :1127-1153): the same solves written as bench.py
  writes them, with no annotations and with ``concat_where`` boundaries;
- ``copy_op``, ``cumsum``, ``dbl``, ``inc`` and ``pipeline``, the operators
  whose call overhead benchmarks/benchmark_program_call.py times;
- smaller operators for the parity tests: a scan on its own
  (``weighted_cumsum``), a program calling two operators (``lap_twice``),
  a tuple return, the builtins, and unstructured ones over the toy mesh of
  tests/next_tests/cases.py (``neighbor_sum`` and ``max_over``/``min_over``
  through connectivities with ``skip_value``).

``KERNEL`` names the kernel of the port that serves each on a card (with
``GT4PY_CUDA_FUSE_STAGES=1``, ``fused_column`` for solve_tridiag), and
``REPLACES`` the TPU kernel it stands for. Operators are declared on the
``torch`` backend; ``op.with_backend("cuda:hopper")`` bridges them.
"""

import functools

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    astype,
    broadcast,
    concat_where,
    max_over,
    min_over,
    neighbor_sum,
    where,
)

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))
Koff = FieldOffset("Koff", source=KDim, target=(KDim,))
PROV = {"Ioff": IDim, "Joff": JDim}
PROV_K = {"Ioff": IDim, "Joff": JDim, "Koff": KDim}


@gtx.field_operator
def lap(phi):
    return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])


@gtx.field_operator
def hdiff_op(inp, coeff):
    lap_f = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
    res1 = lap_f(Ioff[1]) - lap_f
    flx = where(res1 * (inp(Ioff[1]) - inp) > 0.0, 0.0, res1)
    res2 = lap_f(Joff[1]) - lap_f
    fly = where(res2 * (inp(Joff[1]) - inp) > 0.0, 0.0, res2)
    return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))


#: the bench's field-view hdiff is the same operator
next_hdiff = hdiff_op


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def _tri_fwd(carry, a: float, b: float, c: float, d: float):
    cp_prev, dp_prev = carry
    denom = b - a * cp_prev
    return (c / denom, (d - a * dp_prev) / denom)


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def _tri_bwd(x_kp1, cp: float, dp: float):
    return dp - cp * x_kp1


@gtx.field_operator
def solve_tridiag(a, b, c, d):
    cp, dp = _tri_fwd(a, b, c, d)
    return _tri_bwd(cp, dp)


BET_M, BET_P = 0.5, 0.5


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def _vadv_fwd(
    carry, w_i1, w_c, w_i1_k1, w_k1, us_m1, us, us_p1, upos, uten, utens_st,
    kidx, klast, dtr,
):
    ccol_m1, dcol_m1 = carry
    first = kidx == 0
    last = kidx == klast
    gav = -0.25 * (w_i1 + w_c)
    gcv = 0.25 * (w_i1_k1 + w_k1)
    as_ = where(first, 0.0, gav * BET_M)
    acol = where(first, 0.0, gav * BET_P)
    cs = where(last, 0.0, gcv * BET_M)
    ccol = where(last, 0.0, gcv * BET_P)
    bcol = dtr - acol - ccol
    corr = -as_ * (us_m1 - us) - cs * (us_p1 - us)
    dcol = dtr * upos + uten + utens_st + corr
    divided = 1.0 / (bcol - ccol_m1 * acol)
    return (ccol * divided, (dcol - dcol_m1 * acol) * divided)


@gtx.scan_operator(axis=KDim, forward=False, init=(0.0, 0.0))
def _vadv_bwd(carry, ccol, dcol, upos, kidx, klast, dtr):
    data_p1, _ = carry
    data = where(kidx == klast, dcol, dcol - ccol * data_p1)
    return (data, dtr * (data - upos))


@gtx.field_operator
def next_vadv(utens_stage, u_stage, wcon, u_pos, utens, kidx, klast: int, dtr: float):
    ccol, dcol = _vadv_fwd(
        wcon(Ioff[1]), wcon, wcon(Ioff[1])(Koff[1]), wcon(Koff[1]),
        u_stage(Koff[-1]), u_stage, u_stage(Koff[1]),
        u_pos, utens, utens_stage, kidx, klast, dtr,
    )
    return _vadv_bwd(ccol, dcol, u_pos, kidx, klast, dtr)[1]


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def _bench_tri_fwd(carry, a, b, c, d):
    cp_prev, dp_prev = carry
    denom = b - a * cp_prev
    return (c / denom, (d - a * dp_prev) / denom)


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def _bench_tri_bwd(x_kp1, cp, dp):
    return dp - cp * x_kp1


@gtx.field_operator
def next_tridiag(a, b, c, d):
    """bench.py's field-view tridiagonal solve (bench.py:1035-1048): two
    scans with no annotations, the carry's type taken from the fields."""
    cp, dp = _bench_tri_fwd(a, b, c, d)
    return _bench_tri_bwd(cp, dp)


@functools.cache
def next_vadv_op(nk: int):
    """bench.py's field-view vadv over ``nk`` levels (bench.py:1127-1153):
    the vertical boundary coefficients by ``concat_where`` over K sections,
    no K index field; ``nk`` is closed over as bench.py closes over its
    ``NKC``."""
    nkc = nk

    @gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
    def _b_vadv_fwd(carry, acol, bcol, ccol, dcol):
        ccol_m1, dcol_m1 = carry
        divided = 1.0 / (bcol - ccol_m1 * acol)
        return (ccol * divided, (dcol - dcol_m1 * acol) * divided)

    @gtx.scan_operator(axis=KDim, forward=False, init=(0.0, 0.0))
    def _b_vadv_bwd(carry, ccol, dcol, upos, dtr):
        data_p1, _ = carry
        data = dcol - ccol * data_p1
        return (data, dtr * (data - upos))

    @gtx.field_operator
    def next_vadv_op(utens_stage, u_stage, wcon, u_pos, utens, dtr):
        gav = -0.25 * (wcon(Ioff[1]) + wcon)
        gcv = 0.25 * (wcon(Ioff[1])(Koff[1]) + wcon(Koff[1]))
        as_ = concat_where(KDim == 0, 0.0, gav * BET_M)
        acol = concat_where(KDim == 0, 0.0, gav * BET_P)
        cs = concat_where(KDim == nkc - 1, 0.0, gcv * BET_M)
        ccol = concat_where(KDim == nkc - 1, 0.0, gcv * BET_P)
        bcol = dtr - acol - ccol
        dm1 = concat_where(KDim == 0, 0.0, u_stage(Koff[-1]) - u_stage)
        dp1 = concat_where(KDim == nkc - 1, 0.0, u_stage(Koff[1]) - u_stage)
        corr = (0.0 - as_) * dm1 - cs * dp1
        dcol = dtr * u_pos + utens + utens_stage + corr
        cc, dd = _b_vadv_fwd(acol, bcol, ccol, dcol)
        return _b_vadv_bwd(cc, dd, u_pos, dtr)[1]

    return next_vadv_op


@gtx.scan_operator(axis=KDim, forward=True, init=0.0)
def weighted_cumsum(carry: float, a: float, w: float) -> float:
    return carry * w + a


@gtx.program
def lap_twice(phi, tmp, out):
    lap(phi, out=tmp)
    lap(tmp, out=out)


lap_hopper = lap.with_backend("cuda:hopper")


@gtx.program
def lap_twice_hopper(phi, tmp, out):
    lap_hopper(phi, out=tmp)
    lap_hopper(tmp, out=out)


@gtx.program
def lap_twice_mixed(phi, tmp, out):
    lap_hopper(phi, out=tmp)
    lap(tmp, out=out)


# --- the call-overhead operators (benchmarks/benchmark_program_call.py:73-120) ---

CallI = Dimension("I")
CallIb = Dimension("Ib")
CallKb = Dimension("Kb", kind=DimensionKind.VERTICAL)


@gtx.field_operator
def copy_op(a):
    return a


@gtx.scan_operator(axis=CallKb, forward=True, init=0.0)
def cumsum(c, x):
    return c + x


@gtx.field_operator
def dbl(a):
    return a * 2.0


@gtx.field_operator
def inc(a):
    return a + 1.0


@gtx.program
def pipeline(a, tmp, out):
    dbl(a, out=tmp)
    inc(tmp, out=out)


@gtx.field_operator
def sum_and_diff(a, b):
    return a + b, a - b


@gtx.field_operator
def select_and_cast(a, m):
    """``a`` float, ``m`` int32: a weak literal keeps ``a``'s type; the
    int32 field promotes with it as JAX promotes."""
    c = where(a > 0.5, a, 0.0)
    return c + astype(m, gtx.float32) * a + broadcast(2.0, (IDim, JDim, KDim)) * a + m * 0.5


@gtx.field_operator
def k_boundary(a):
    return concat_where(KDim == 0, a, a(Koff[-1]) * 0.5)


Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))


def toy_mesh_tables() -> tuple:
    """The 9-vertex / 18-edge periodic 3x3 quad mesh of
    tests/next_tests/cases.py (``_toy_mesh_tables``): (E2V, V2E)."""
    n = 3
    nv = n * n
    ii, jj = np.divmod(np.arange(nv), n)
    right = ii * n + (jj + 1) % n
    down = ((ii + 1) % n) * n + jj
    e2v = np.concatenate(
        [
            np.stack([np.arange(nv), right], axis=1),  # horizontal edges
            np.stack([np.arange(nv), down], axis=1),  # vertical edges
        ]
    )
    v2e = np.empty((nv, 4), dtype=np.int64)
    v2e[:, 0] = np.arange(nv)  # h edge leaving v
    v2e[:, 1] = ii * n + (jj - 1) % n  # h edge entering v
    v2e[:, 2] = nv + np.arange(nv)  # v edge leaving v
    v2e[:, 3] = nv + ((ii - 1) % n) * n + jj  # v edge entering v
    return e2v.astype(np.int64), v2e


def with_skips(table: np.ndarray, every: int = 3, skip: int = -1) -> np.ndarray:
    """``table`` with every ``every``-th entry (row-major) missing."""
    out = table.copy()
    out.reshape(-1)[::every] = skip
    return out


@gtx.field_operator
def edge_sum(e):
    return neighbor_sum(e(V2E), axis=V2EDim)


@gtx.field_operator
def edge_spread(e):
    return max_over(e(V2E), axis=V2EDim) - min_over(e(V2E), axis=V2EDim)


@gtx.field_operator
def vertex_jump(v):
    return v(E2V[1]) - v(E2V[0])


#: operator -> the kernel that serves it on a card (switch off, switch on).
#: next_vadv's K index field is lower-dimensional, which fused_column
#: refuses as the JAX package's K4 does (pallas_seq.py:314-320): it stays on
#: column with the switch on
KERNEL = {
    "lap": ("plane", "plane"),
    "hdiff_op": ("plane", "plane"),
    "solve_tridiag": ("column", "fused_column"),
    "next_vadv": ("column", "column"),
}
#: kernel of the port -> the TPU kernel (``pl.pallas_call``) it replaces
REPLACES = {
    "plane": "gt4py_tpu/cartesian/backend/pallas_split.py:424",
    "column": "gt4py_tpu/cartesian/backend/pallas_seq.py:1130",
    "fused_column": "gt4py_tpu/cartesian/backend/pallas_seq.py:1704",
}


def hdiff_inputs(ni: int, nj: int, nk: int, halo: int, dtype, seed: int, device=None):
    """``next_hdiff``'s arguments and out field: inputs over the out domain
    widened by ``halo`` in I and J (its shifts reach two points), the out
    field over I, J in [halo, halo + n), K in [0, nk). A stable diffusion
    coefficient (0.1 × uniform)."""
    rng = np.random.default_rng(seed)
    shape = (ni + 2 * halo, nj + 2 * halo, nk)
    inp = gtx.as_field([IDim, JDim, KDim], rng.random(shape).astype(dtype), device=device)
    coeff = gtx.as_field(
        [IDim, JDim, KDim], (0.1 * rng.random(shape)).astype(dtype), device=device
    )
    out = gtx.zeros(
        {IDim: (halo, halo + ni), JDim: (halo, halo + nj), KDim: nk}, dtype, device=device
    )
    return (inp, coeff), {}, out


def tridiag_inputs(ni: int, nj: int, nk: int, dtype, seed: int, device=None):
    """``solve_tridiag``'s arguments (a diagonally dominant system: -1 ≤ a,
    c ≤ 0, 4 ≤ b ≤ 5) and out field, all over the same domain."""
    rng = np.random.default_rng(seed)
    shape = (ni, nj, nk)
    a, b, c, d = (rng.random(shape) for _ in range(4))
    f = lambda x: gtx.as_field([IDim, JDim, KDim], x.astype(dtype), device=device)  # noqa: E731
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk}, dtype, device=device)
    return (f(-a), f(b + 4.0), f(-c), f(d)), {}, out


def vadv_inputs(ni: int, nj: int, nk: int, dtype, seed: int, device=None):
    """``next_vadv``'s arguments and out field. Its shifts reach I + 1 and
    K ± 1, so the inputs are widened there: I in [0, ni + 1), K in [-1, nk +
    1); the out field covers I in [0, ni), K in [0, nk). The K index field
    covers [0, nk), ``klast`` = nk - 1, ``dtr`` = 0.15 in ``dtype`` (a scalar
    of the fields' type, as the cartesian vadv's ``dtr_stage``). The vertical
    wind is small beside 1/dt (0.1 × uniform), so pivots stay away from 0."""
    rng = np.random.default_rng(seed)
    shape = (ni + 1, nj, nk + 2)
    names = ("utens_stage", "u_stage", "wcon", "u_pos", "utens")
    host = {n: rng.random(shape) for n in names}
    host["wcon"] = 0.1 * host["wcon"]
    dom = {IDim: (0, ni + 1), JDim: (0, nj), KDim: (-1, nk + 1)}
    fields = tuple(gtx.as_field(dom, host[n].astype(dtype), device=device) for n in names)
    kidx = gtx.as_field([KDim], np.arange(nk, dtype=np.int32), device=device)
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk}, dtype, device=device)
    return fields + (kidx, nk - 1, np.dtype(dtype).type(0.15)), {}, out


def inputs(name: str, ni: int, nj: int, nk: int, dtype, seed: int, device=None):
    """``(args, kwargs, out)`` of the structured operator ``name`` over an out
    domain of ni × nj × nk, made from ``seed``."""
    if name == "lap":
        (inp, _), kwargs, out = hdiff_inputs(ni, nj, nk, 2, dtype, seed, device)
        return (inp,), kwargs, out
    if name == "hdiff_op":
        return hdiff_inputs(ni, nj, nk, 2, dtype, seed, device)
    if name == "solve_tridiag":
        return tridiag_inputs(ni, nj, nk, dtype, seed, device)
    return vadv_inputs(ni, nj, nk, dtype, seed, device)


@gtx.field_operator
def nabla_x(pp, s_x, sign, vol):
    """The FVM nabla's x component (bench.py:687-689): the vertex values
    averaged onto each edge (``E2V``), scaled by the edge's ``s_x``, summed
    with orientation signs over each vertex's edges (``V2E``) and divided
    by the dual volume."""
    zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
    return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol


def nabla_inputs(n: int, dtype, seed: int, device=None, renumber: bool = False):
    """``nabla_x``'s arguments, offset provider and out field on the periodic
    ``n`` × ``n`` quad mesh of ``mesh_utils.periodic_quad_mesh`` (the
    bench's 65k row at n = 256, its 1M row at n = 1024): uniform vertex
    values and edge lengths, volumes in [0.5, 1.5). ``renumber``: the
    irregular twin of bench.py:754-765, vertices and edges renumbered by
    random permutations (seeds 3 and 4), so that no shift structure is
    left."""
    from gt4py_tpu_torch.next.mesh_utils import periodic_quad_mesh

    e2v, v2e, signs = periodic_quad_mesh(n)
    nv = n * n
    if renumber:
        perm_v = np.random.default_rng(3).permutation(nv)
        perm_e = np.random.default_rng(4).permutation(2 * nv)
        inv_v, inv_e = np.argsort(perm_v), np.argsort(perm_e)
        e2v, v2e, signs = perm_v[e2v][inv_e], perm_e[v2e][inv_v], signs[inv_v]
    rng = np.random.default_rng(seed)
    provider = {
        "E2V": gtx.as_connectivity([Edge, E2VDim], Vertex, e2v, device=device),
        "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, v2e, device=device),
    }
    pp = gtx.as_field([Vertex], rng.random(nv).astype(dtype), device=device)
    s_x = gtx.as_field([Edge], rng.random(2 * nv).astype(dtype), device=device)
    sign = gtx.as_field([Vertex, V2EDim], signs.astype(dtype), device=device)
    vol = gtx.as_field([Vertex], (rng.random(nv) + 0.5).astype(dtype), device=device)
    out = gtx.zeros({Vertex: nv}, dtype, device=device)
    return (pp, s_x, sign, vol), provider, out
