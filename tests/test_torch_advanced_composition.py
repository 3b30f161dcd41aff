"""tests/next_tests/test_advanced_composition.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Deep field-view composition cases (round-3, verdict item 9): tuples of
tuples through operators and write-back, nested concat_where, and
scan × connectivity interactions — the corners the reference exercises in
ffront_tests (test_execution.py tuple cases, test_concat_where.py,
test_with_toy_connectivity.py + scan interactions)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where
from gt4py_tpu_torch.next.fbuiltins import concat_where

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Cell = Dimension("Cell")
Edge = Dimension("Edge")
E2CDim = Dimension("E2C", kind=DimensionKind.LOCAL)
E2C = FieldOffset("E2C", source=Cell, target=(Edge, E2CDim))


@pytest.fixture
def rng():
    return np.random.default_rng(21)


# --- tuples of tuples --------------------------------------------------------


def test_nested_tuple_return_and_out(rng):
    """((a+b, a-b), a*b) — nested tuple result written to nested-tuple out
    (reference test_execution.py tuple-output cases)."""

    @gtx.field_operator
    def nested(a, b):
        return ((a + b, a - b), a * b)

    data_a = rng.random((5, 4))
    data_b = rng.random((5, 4))
    a = gtx.as_field([IDim, JDim], data_a, device="cpu")
    b = gtx.as_field([IDim, JDim], data_b, device="cpu")
    o1 = gtx.zeros({IDim: 5, JDim: 4}, device="cpu")
    o2 = gtx.zeros({IDim: 5, JDim: 4}, device="cpu")
    o3 = gtx.zeros({IDim: 5, JDim: 4}, device="cpu")
    nested(a, b, out=((o1, o2), o3))
    np.testing.assert_allclose(np.asarray(o1.ndarray), data_a + data_b)
    np.testing.assert_allclose(np.asarray(o2.ndarray), data_a - data_b)
    np.testing.assert_allclose(np.asarray(o3.ndarray), data_a * data_b)


def test_nested_tuple_where(rng):
    """where() maps over nested tuple branches leaf-wise."""

    @gtx.field_operator
    def sel(c, a, b):
        return where(c > 0.5, ((a, b), a + b), ((b, a), a - b))

    dc = rng.random((6,))
    da = rng.random((6,))
    db = rng.random((6,))
    c = gtx.as_field([IDim], dc, device="cpu")
    a = gtx.as_field([IDim], da, device="cpu")
    b = gtx.as_field([IDim], db, device="cpu")
    o1 = gtx.zeros({IDim: 6}, device="cpu")
    o2 = gtx.zeros({IDim: 6}, device="cpu")
    o3 = gtx.zeros({IDim: 6}, device="cpu")
    sel(c, a, b, out=((o1, o2), o3))
    m = dc > 0.5
    np.testing.assert_allclose(np.asarray(o1.ndarray), np.where(m, da, db))
    np.testing.assert_allclose(np.asarray(o2.ndarray), np.where(m, db, da))
    np.testing.assert_allclose(np.asarray(o3.ndarray), np.where(m, da + db, da - db))


def test_tuple_unpack_inside_operator(rng):
    """Operators calling operators that return tuples, unpacked inline."""

    @gtx.field_operator
    def pair(a, b):
        return (a + b, a * b)

    @gtx.field_operator
    def consume(a, b):
        s, p = pair(a, b)
        return s - p

    da = rng.random((7,))
    db = rng.random((7,))
    out = gtx.zeros({IDim: 7}, device="cpu")
    consume(gtx.as_field([IDim], da, device="cpu"), gtx.as_field([IDim], db, device="cpu"), out=out)
    np.testing.assert_allclose(np.asarray(out.ndarray), (da + db) - da * db)


# --- nested concat_where ------------------------------------------------------


def test_nested_concat_where(rng):
    """Boundary-condition chains: concat_where nested in both branches
    (reference concat_where tests, iterator/transforms/concat_where)."""

    @gtx.field_operator
    def bc(interior, surface, top):
        return concat_where(
            KDim < 1, surface, concat_where(KDim >= 5, top, interior)
        )

    nk = 6
    di = rng.random((4, nk))
    ds = rng.random((4, nk))
    dt = rng.random((4, nk))
    interior = gtx.as_field([IDim, KDim], di, device="cpu")
    surface = gtx.as_field([IDim, KDim], ds, device="cpu")
    top = gtx.as_field([IDim, KDim], dt, device="cpu")
    out = gtx.zeros({IDim: 4, KDim: nk}, device="cpu")
    bc(interior, surface, top, out=out)
    expected = di.copy()
    expected[:, 0] = ds[:, 0]
    expected[:, 5:] = dt[:, 5:]
    np.testing.assert_allclose(np.asarray(out.ndarray), expected)


def test_concat_where_tuple_branches(rng):
    @gtx.field_operator
    def bc2(a, b):
        return concat_where(KDim < 2, (a, b), (b, a))

    nk = 5
    da = rng.random((3, nk))
    db = rng.random((3, nk))
    a = gtx.as_field([IDim, KDim], da, device="cpu")
    b = gtx.as_field([IDim, KDim], db, device="cpu")
    o1 = gtx.zeros({IDim: 3, KDim: nk}, device="cpu")
    o2 = gtx.zeros({IDim: 3, KDim: nk}, device="cpu")
    bc2(a, b, out=(o1, o2))
    e1 = np.where(np.arange(nk) < 2, da, db)
    e2 = np.where(np.arange(nk) < 2, db, da)
    np.testing.assert_allclose(np.asarray(o1.ndarray), e1)
    np.testing.assert_allclose(np.asarray(o2.ndarray), e2)


def test_concat_where_inside_arithmetic(rng):
    @gtx.field_operator
    def mixed(a, b):
        return 2.0 * concat_where(KDim < 1, a, b) + concat_where(KDim >= 3, a, b)

    nk = 4
    da = rng.random((2, nk))
    db = rng.random((2, nk))
    out = gtx.zeros({IDim: 2, KDim: nk}, device="cpu")
    mixed(gtx.as_field([IDim, KDim], da, device="cpu"), gtx.as_field([IDim, KDim], db, device="cpu"), out=out)
    k = np.arange(nk)
    expected = 2.0 * np.where(k < 1, da, db) + np.where(k >= 3, da, db)
    np.testing.assert_allclose(np.asarray(out.ndarray), expected)


# --- scan x connectivity interactions ----------------------------------------


def _edge_mesh(n_cells, rng):
    """Tiny irregular mesh: each edge touches 2 distinct random cells."""
    n_edges = 2 * n_cells
    tbl = np.stack(
        [
            rng.integers(0, n_cells, n_edges),
            rng.integers(0, n_cells, n_edges),
        ],
        axis=1,
    )
    return gtx.as_connectivity([Edge, E2CDim], Cell, tbl, device="cpu"), tbl


def test_scan_over_remapped_columns(rng):
    """neighbor reduction feeding a column scan: (Edge, K) field built from
    (Cell, K) data via E2C, then cumulative-summed along K (reference
    scan+connectivity interaction class)."""
    n_cells, nk = 10, 6
    conn, tbl = _edge_mesh(n_cells, rng)

    @gtx.field_operator
    def edge_avg(c):
        return 0.5 * (c(E2C[0]) + c(E2C[1]))

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def kcum(carry: float, x: float) -> float:
        return carry + x

    @gtx.field_operator
    def column_integral(c):
        return kcum(edge_avg(c))

    data = rng.random((n_cells, nk))
    c = gtx.as_field([Cell, KDim], data, device="cpu")
    out = gtx.zeros({Edge: 2 * n_cells, KDim: nk}, device="cpu")
    column_integral(c, out=out, offset_provider={"E2C": conn})
    expected = np.cumsum(0.5 * (data[tbl[:, 0]] + data[tbl[:, 1]]), axis=1)
    np.testing.assert_allclose(np.asarray(out.ndarray), expected, rtol=1e-12)


def test_scan_then_reduce(rng):
    """Scan along K first, then neighbor_sum of the scanned columns."""
    n_cells, nk = 8, 5
    conn, tbl = _edge_mesh(n_cells, rng)

    @gtx.scan_operator(axis=KDim, forward=False, init=0.0)
    def suffix_sum(carry: float, x: float) -> float:
        return carry + x

    @gtx.field_operator
    def reduce_scanned(c):
        s = suffix_sum(c)
        return neighbor_sum(s(E2C), axis=E2CDim)

    data = rng.random((n_cells, nk))
    c = gtx.as_field([Cell, KDim], data, device="cpu")
    out = gtx.zeros({Edge: 2 * n_cells, KDim: nk}, device="cpu")
    reduce_scanned(c, out=out, offset_provider={"E2C": conn})
    suffix = np.cumsum(data[:, ::-1], axis=1)[:, ::-1]
    expected = suffix[tbl[:, 0]] + suffix[tbl[:, 1]]
    np.testing.assert_allclose(np.asarray(out.ndarray), expected, rtol=1e-12)


def test_scan_tuple_carry_with_connectivity(rng):
    """Tuple-carry scan consuming a remapped field (running max + sum)."""
    n_cells, nk = 6, 7
    conn, tbl = _edge_mesh(n_cells, rng)

    @gtx.field_operator
    def first_cell(c):
        return c(E2C[0])

    @gtx.scan_operator(axis=KDim, forward=True, init=(0.0, -1e30))
    def sum_and_max(carry, x):
        s, m = carry
        return (s + x, where(x > m, x, m))

    @gtx.field_operator
    def stats(c):
        return sum_and_max(first_cell(c))

    data = rng.random((n_cells, nk))
    c = gtx.as_field([Cell, KDim], data, device="cpu")
    o1 = gtx.zeros({Edge: 2 * n_cells, KDim: nk}, device="cpu")
    o2 = gtx.zeros({Edge: 2 * n_cells, KDim: nk}, device="cpu")
    stats(c, out=(o1, o2), offset_provider={"E2C": conn})
    g = data[tbl[:, 0]]
    np.testing.assert_allclose(np.asarray(o1.ndarray), np.cumsum(g, axis=1), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(o2.ndarray), np.maximum.accumulate(g, axis=1), rtol=1e-12
    )


# --- oracle cross-checks (numpy-backend vs jax-backend) ----------------------


@pytest.mark.parametrize("case", ["nested_tuple", "nested_concat"])
def test_backend_parity(case, rng):
    """The same composition through the numpy oracle backend and the jax
    backend must agree exactly."""

    if case == "nested_tuple":

        def defn(a, b):
            return ((a + b, a - b), a * b)

        outs = lambda: (  # noqa: E731
            (gtx.zeros({IDim: 5, JDim: 4}, device="cpu"), gtx.zeros({IDim: 5, JDim: 4}, device="cpu")),
            gtx.zeros({IDim: 5, JDim: 4}, device="cpu"),
        )
        flat = lambda o: [o[0][0], o[0][1], o[1]]  # noqa: E731
    else:

        def defn(a, b):
            return concat_where(JDim < 1, a, concat_where(JDim >= 3, b, a + b))

        outs = lambda: gtx.zeros({IDim: 5, JDim: 4}, device="cpu")  # noqa: E731
        flat = lambda o: [o]  # noqa: E731

    da = rng.random((5, 4))
    db = rng.random((5, 4))
    results = {}
    for backend in ("numpy", "torch"):
        op = gtx.field_operator(defn, backend=backend)
        a = gtx.as_field([IDim, JDim], da, device="cpu")
        b = gtx.as_field([IDim, JDim], db, device="cpu")
        out = outs()
        op(a, b, out=out)
        results[backend] = [np.asarray(f.ndarray) for f in flat(out)]
    for r_np, r_jax in zip(results["numpy"], results["torch"]):
        np.testing.assert_allclose(r_np, r_jax, rtol=1e-14)
