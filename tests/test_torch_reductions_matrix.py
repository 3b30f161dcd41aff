"""tests/next_tests/test_reductions_matrix.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Neighbor-reduction matrix: {neighbor_sum, max_over, min_over} x
{dense table, skip-value table} x {eager, field_operator}, against NumPy
oracles.

Reference pattern: tests/next_tests/integration_tests/feature_tests/
ffront_tests/test_execution.py reduction cases (incl. skip_value
connectivities).
"""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset
from gt4py_tpu_torch.next import max_over, min_over, neighbor_sum

Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))

N_V, N_E, N_NB = 7, 12, 4
SKIP = -1


def _table(skip: bool, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, N_E, (N_V, N_NB))
    if skip:
        holes = rng.random((N_V, N_NB)) < 0.3
        holes[:, 0] = False  # every vertex keeps one neighbor
        t = np.where(holes, SKIP, t)
    return t


def _oracle(op_name: str, table: np.ndarray, edge_vals: np.ndarray) -> np.ndarray:
    neutral = {"sum": 0.0, "max": -np.inf, "min": np.inf}[op_name]
    gathered = np.where(table == SKIP, neutral, edge_vals[table])
    if op_name == "sum":
        return gathered.sum(axis=1)
    return gathered.max(axis=1) if op_name == "max" else gathered.min(axis=1)


OPS = {"sum": neighbor_sum, "max": max_over, "min": min_over}


@pytest.mark.parametrize("skip", [False, True], ids=["dense", "skip_values"])
@pytest.mark.parametrize("op_name", sorted(OPS))
def test_reduction_eager(op_name, skip):
    table = _table(skip)
    rng = np.random.default_rng(1)
    edge_vals = rng.random(N_E)
    conn = gtx.as_connectivity(
        [Vertex, V2EDim], Edge, table, skip_value=SKIP if skip else None, device="cpu"
    )
    f_e = gtx.as_field([Edge], edge_vals, device="cpu")
    from gt4py_tpu_torch.next.embedded import offset_provider_context

    with offset_provider_context({"V2E": conn}):
        res = OPS[op_name](f_e(V2E), axis=V2EDim)
    np.testing.assert_allclose(
        np.asarray(res.ndarray), _oracle(op_name, table, edge_vals), rtol=1e-12
    )


@pytest.mark.parametrize("skip", [False, True], ids=["dense", "skip_values"])
@pytest.mark.parametrize("op_name", sorted(OPS))
def test_reduction_operator(op_name, skip):
    impl = OPS[op_name]

    @gtx.field_operator
    def op(e):
        return impl(e(V2E), axis=V2EDim)

    table = _table(skip, seed=2)
    rng = np.random.default_rng(3)
    edge_vals = rng.random(N_E)
    conn = gtx.as_connectivity(
        [Vertex, V2EDim], Edge, table, skip_value=SKIP if skip else None, device="cpu"
    )
    f_e = gtx.as_field([Edge], edge_vals, device="cpu")
    out = gtx.zeros({Vertex: N_V}, dtype=np.float64, device="cpu")
    op(f_e, out=out, offset_provider={"V2E": conn})
    np.testing.assert_allclose(
        np.asarray(out.ndarray), _oracle(op_name, table, edge_vals), rtol=1e-12
    )


def test_weighted_reduction_operator():
    """Reduction over an expression of gathered and local fields (the FVM
    nabla pattern)."""

    @gtx.field_operator
    def op(e, w):
        return neighbor_sum(e(V2E) * w, axis=V2EDim)

    table = _table(True, seed=4)
    rng = np.random.default_rng(5)
    edge_vals = rng.random(N_E)
    weights = rng.random((N_V, N_NB))
    conn = gtx.as_connectivity([Vertex, V2EDim], Edge, table, skip_value=SKIP, device="cpu")
    f_e = gtx.as_field([Edge], edge_vals, device="cpu")
    f_w = gtx.as_field([Vertex, V2EDim], weights, device="cpu")
    out = gtx.zeros({Vertex: N_V}, dtype=np.float64, device="cpu")
    op(f_e, f_w, out=out, offset_provider={"V2E": conn})
    gathered = np.where(table == SKIP, 0.0, edge_vals[table] * weights)
    np.testing.assert_allclose(np.asarray(out.ndarray), gathered.sum(axis=1), rtol=1e-12)
