"""tests/next_tests/test_icon_like_scan.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

ICON-like scan: bool-in-carry first-level handling, NamedTuple state,
ternary on a traced carry leaf, and sliced ``out=`` write-back.

Reference: tests/next_tests/integration_tests/multi_feature_tests/
ffront_tests/test_icon_like_scan.py (solve_nonhydro_stencil_52_like).
"""

from typing import NamedTuple

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx

Cell = gtx.Dimension("Cell")
KDim = gtx.Dimension("KDim", kind=gtx.DimensionKind.VERTICAL)
Koff = gtx.FieldOffset("Koff", source=KDim, target=(KDim,))


class State(NamedTuple):
    z_q_new: float
    w_new: float
    first_level: bool


@gtx.scan_operator(
    axis=KDim, forward=True, init=State(z_q_new=0.0, w_new=0.0, first_level=True)
)
def _scan(state: State, w: float, z_q: float, z_a: float, z_b: float, z_c: float) -> State:
    z_g = z_b + z_a * state.z_q_new
    z_q_new = (0.0 - z_c) * z_g
    w_new = z_a * state.w_new * z_g
    return (
        State(z_q_new=z_q, w_new=w, first_level=False)
        if state.first_level
        else State(z_q_new=z_q_new, w_new=w_new, first_level=False)
    )


@gtx.field_operator
def _solve_nonhydro_stencil_52_like(w, z_q, z_a, z_b, z_c):
    z_q_res, w_res, dummy = _scan(w, z_q, z_a, z_b, z_c)
    return z_q_res, w_res, dummy


@gtx.field_operator
def _solve_52_like_shifted(z_alpha, z_beta, z_q, w):
    """Shifted coefficient construction feeding the scan (the reference
    operator body, test_icon_like_scan.py:57)."""
    z_a = z_beta(Koff[-1]) * z_alpha(Koff[-1])
    z_c = z_beta * z_alpha(Koff[1])
    z_b = z_alpha * (z_beta(Koff[-1]) + z_beta)
    z_q_res, w_res, _ = _scan(w, z_q, z_a, z_b, z_c)
    return z_q_res, w_res


def _reference(w, z_q, z_a, z_b, z_c):
    n, k = w.shape
    zq = np.zeros((n, k))
    wn = np.zeros((n, k))
    qprev = np.zeros(n)
    wprev = np.zeros(n)
    for kk in range(k):
        z_g = z_b[:, kk] + z_a[:, kk] * qprev
        q_new = (0.0 - z_c[:, kk]) * z_g
        w_new = z_a[:, kk] * wprev * z_g
        if kk == 0:
            zq[:, kk] = z_q[:, kk]
            wn[:, kk] = w[:, kk]
        else:
            zq[:, kk] = q_new
            wn[:, kk] = w_new
        qprev = zq[:, kk]
        wprev = wn[:, kk]
    return zq, wn


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    n, k = 6, 9
    return {
        m: rng.random((n, k)) for m in ("w", "z_q", "z_a", "z_b", "z_c")
    }


def _fields(data):
    return {m: gtx.as_field([Cell, KDim], v, device="cpu") for m, v in data.items()}


def test_bool_carry_scan_direct(data):
    f = _fields(data)
    zq, wn, dummy = _scan(f["w"], f["z_q"], f["z_a"], f["z_b"], f["z_c"])
    zq_ref, wn_ref = _reference(*(data[m] for m in ("w", "z_q", "z_a", "z_b", "z_c")))
    np.testing.assert_allclose(zq.asnumpy(), zq_ref, rtol=1e-12)
    np.testing.assert_allclose(wn.asnumpy(), wn_ref, rtol=1e-12)
    assert dummy.dtype == np.bool_
    assert not dummy.asnumpy()[:, 1:].any()  # False after the first level
    assert dummy.asnumpy().shape == zq_ref.shape


def test_bool_carry_scan_foast_compiled(data):
    """The ternary-on-carry body must run through FOAST (no raw-definition
    fallback): the generated source carries the where-lowering."""
    from gt4py_tpu_torch.next.foast import foast_source

    src = foast_source(_scan)
    assert "__gtx_ternary__" in src


def test_icon_like_scan_in_field_operator_sliced_out(data):
    """The reference program writes all scan outputs into K-sliced views:
    out=(z_q[:, 1:], w[:, 1:], dummy[:, 1:])."""
    f = _fields(data)
    n, k = data["w"].shape
    zq_ref, wn_ref = _reference(*(data[m] for m in ("w", "z_q", "z_a", "z_b", "z_c")))

    outq = gtx.zeros({Cell: n, KDim: k}, device="cpu")
    outw = gtx.zeros({Cell: n, KDim: k}, device="cpu")
    outd = gtx.zeros({Cell: n, KDim: k}, dtype=bool, device="cpu")
    _solve_nonhydro_stencil_52_like(
        f["w"], f["z_q"], f["z_a"], f["z_b"], f["z_c"],
        out=(outq[:, 1:], outw[:, 1:], outd[:, 1:]),
    )
    np.testing.assert_allclose(outq.asnumpy()[:, 1:], zq_ref[:, 1:], rtol=1e-12)
    np.testing.assert_allclose(outw.asnumpy()[:, 1:], wn_ref[:, 1:], rtol=1e-12)
    # Row 0 untouched by the sliced write.
    assert np.all(outq.asnumpy()[:, 0] == 0.0)
    assert np.all(outw.asnumpy()[:, 0] == 0.0)


def test_icon_like_scan_shifted_coefficients(data):
    """Full reference operator: K-shifted coefficient fields feed the scan;
    the result domain shrinks by the shift halo."""
    rng = np.random.default_rng(3)
    n, k = 6, 9
    z_alpha = rng.random((n, k + 1))
    z_beta = rng.random((n, k))
    z_q = rng.random((n, k))
    w = rng.random((n, k))
    fa = gtx.as_field([Cell, KDim], z_alpha, device="cpu")
    fb = gtx.as_field([Cell, KDim], z_beta, device="cpu")
    fq = gtx.as_field([Cell, KDim], z_q, device="cpu")
    fw = gtx.as_field([Cell, KDim], w, device="cpu")

    zq_res, w_res = _solve_52_like_shifted(
        fa, fb, fq, fw, offset_provider={"Koff": KDim}
    )
    # Valid K range: [1, k-1) (Koff[-1] needs k>=1, Koff[1] on beta needs
    # k+1<=k-1... compute the oracle on the intersected domain).
    z_a = np.zeros((n, k))
    z_c = np.zeros((n, k))
    z_b_c = np.zeros((n, k))
    for kk in range(1, k):
        z_a[:, kk] = z_beta[:, kk - 1] * z_alpha[:, kk - 1]
    for kk in range(k):
        z_c[:, kk] = z_beta[:, kk] * z_alpha[:, kk + 1] if kk + 1 <= k else 0.0
    for kk in range(1, k):
        z_b_c[:, kk] = z_alpha[:, kk] * (z_beta[:, kk - 1] + z_beta[:, kk])
    lo = zq_res.domain[KDim].unit_range.start
    hi = zq_res.domain[KDim].unit_range.stop
    assert lo == 1
    # Oracle over the restricted K window, with the scan running on it.
    zq_ref, wn_ref = _reference(
        w[:, lo:hi], z_q[:, lo:hi], z_a[:, lo:hi], z_b_c[:, lo:hi], z_c[:, lo:hi]
    )
    np.testing.assert_allclose(zq_res.asnumpy(), zq_ref, rtol=1e-12)
    np.testing.assert_allclose(w_res.asnumpy(), wn_ref, rtol=1e-12)


def test_relative_slicing_semantics():
    I = gtx.Dimension("Irel")
    J = gtx.Dimension("Jrel")
    f = gtx.as_field([I, J], np.arange(20.0).reshape(4, 5), device="cpu")

    v = f[1:3, 2:]
    assert v.domain[I].unit_range == gtx.UnitRange(1, 3)
    assert v.domain[J].unit_range == gtx.UnitRange(2, 5)
    np.testing.assert_array_equal(v.asnumpy(), f.asnumpy()[1:3, 2:])

    # Ellipsis and negative bounds.
    v2 = f[..., -2:]
    assert v2.domain[J].unit_range == gtx.UnitRange(3, 5)
    np.testing.assert_array_equal(v2.asnumpy(), f.asnumpy()[:, -2:])

    # Int collapse.
    v3 = f[2]
    assert v3.dims == (J,)
    np.testing.assert_array_equal(v3.asnumpy(), f.asnumpy()[2])
    assert f[-1, -1] == f.asnumpy()[-1, -1]

    # Offset domains: slicing is relative to the domain start.
    g = gtx.as_field({I: (10, 14)}, np.arange(4.0), device="cpu")
    v4 = g[1:3]
    assert v4.domain[I].unit_range == gtx.UnitRange(11, 13)

    with pytest.raises(IndexError):
        f[0, 0, 0]
    with pytest.raises(IndexError):
        f[::2]
    with pytest.raises(IndexError):
        f[7, :]


def test_sliced_out_write_back_chain():
    """Nested views write through every level to the root field."""
    I = gtx.Dimension("Iwb")

    @gtx.field_operator
    def fill(a):
        return a + 1.0

    f = gtx.as_field([I], np.zeros(8), device="cpu")
    view = f[2:7]
    inner = view[1:3]  # rows 3:5 of f
    fill(gtx.as_field({I: (3, 5)}, np.zeros(2), device="cpu"), out=inner)
    expect = np.zeros(8)
    expect[3:5] = 1.0
    np.testing.assert_array_equal(f.asnumpy(), expect)
    np.testing.assert_array_equal(view.asnumpy(), expect[2:7])
