"""tests/next_tests/test_staggered.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Staggered-grid support (reference common.py:1445-1490, ADR 0024):
half-integer cartesian shifts map fields between a dimension and its
staggered counterpart; ``I + 1`` integer shifts work without declaring a
FieldOffset."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    CartesianConnectivity,
    Dimension,
    as_non_staggered,
    connectivity_for_cartesian_shift,
    flip_staggered,
    is_staggered,
)

I = Dimension("I")
IHalf = flip_staggered(I)


# --- dimension algebra -------------------------------------------------------


def test_staggered_flip_roundtrip():
    assert is_staggered(IHalf)
    assert not is_staggered(I)
    assert flip_staggered(IHalf) == I
    assert as_non_staggered(IHalf) == I
    assert as_non_staggered(I) == I
    assert IHalf.kind == I.kind


def test_connectivity_for_integer_shift():
    c = connectivity_for_cartesian_shift(I, 2)
    assert isinstance(c, CartesianConnectivity)
    assert c.dim == I and c.codomain == I and c.offset == 2


def test_connectivity_for_half_shift_conventions():
    # I + 0.5 maps I(i) -> IHalf(i+1)  (ADR 0024: staggered index sits
    # half a cell below its base index).
    c = connectivity_for_cartesian_shift(I, 0.5)
    assert c.dim == I and c.codomain == IHalf and c.offset == 1
    # IHalf + 0.5 maps IHalf(i) -> I(i).
    c2 = connectivity_for_cartesian_shift(IHalf, 0.5)
    assert c2.dim == IHalf and c2.codomain == I and c2.offset == 0
    # I - 0.5 maps I(i) -> IHalf(i).
    c3 = connectivity_for_cartesian_shift(I, -0.5)
    assert c3.dim == I and c3.codomain == IHalf and c3.offset == 0


def test_dimension_arithmetic_builds_connectivity():
    c = I + 1
    assert isinstance(c, CartesianConnectivity) and c.offset == 1
    c2 = I - 1
    assert c2.offset == -1 and c2.codomain == I
    c3 = I + 0.5
    assert c3.codomain == IHalf


def test_quarter_shift_rejected():
    with pytest.raises(ValueError, match="half-integer"):
        connectivity_for_cartesian_shift(I, 0.25)


# --- execution ---------------------------------------------------------------


def test_integer_dim_shift_without_field_offset():
    @gtx.field_operator
    def diff(c):
        return c(I + 1) - c

    data = np.arange(8.0)
    out = gtx.zeros({I: (0, 7)}, device="cpu")
    diff(gtx.as_field([I], data, device="cpu"), out=out, offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), np.diff(data))


def test_faces_to_centers_average():
    """C-grid staple: cell-centered average of a face (staggered) field."""

    @gtx.field_operator
    def to_centers(u):
        return 0.5 * (u(I + 0.5) + u(I - 0.5))

    u_np = np.arange(6.0) ** 2
    u = gtx.as_field([IHalf], u_np, device="cpu")
    out = gtx.zeros({I: (0, 5)}, device="cpu")
    to_centers(u, out=out, offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), 0.5 * (u_np[1:] + u_np[:-1]))


def test_centers_to_faces_difference():
    """Face-located gradient of a centered field (pressure-gradient
    pattern): dp(i+½) = p(i+1) - p(i) lives on IHalf."""

    @gtx.field_operator
    def face_grad(p):
        return p(IHalf + 0.5) - p(IHalf - 0.5)

    p_np = np.array([1.0, 4.0, 9.0, 16.0, 25.0])
    p = gtx.as_field([I], p_np, device="cpu")
    out = gtx.zeros({IHalf: (1, 5)}, device="cpu")
    face_grad(p, out=out, offset_provider={})
    # IHalf+0.5: r(i)=p(I(i)); IHalf-0.5: r(i)=p(I(i-1)).
    np.testing.assert_allclose(out.asnumpy(), p_np[1:] - p_np[:-1])


def test_staggered_roundtrip_identity():
    @gtx.field_operator
    def there_and_back(u):
        centered = 0.5 * (u(I + 0.5) + u(I - 0.5))
        return 0.5 * (centered(IHalf + 0.5) + centered(IHalf - 0.5))

    u_np = np.linspace(0.0, 1.0, 9)
    u = gtx.as_field([IHalf], u_np, device="cpu")
    out = gtx.zeros({IHalf: (1, 8)}, device="cpu")
    there_and_back(u, out=out, offset_provider={})
    expected = 0.25 * (u_np[:-2] + 2 * u_np[1:-1] + u_np[2:])
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_premap_missing_codomain_rejected():
    @gtx.field_operator
    def bad(u):
        return u(I + 0.5)  # u is over I, not IHalf

    u = gtx.as_field([I], np.arange(4.0), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    with pytest.raises(ValueError, match="no _StaggeredI dimension"):
        bad(u, out=out, offset_provider={})


def test_package_level_math_and_dtype_aliases():
    # gtx.float64 is a constructor-cast alias (reference type builtins:
    # float64(field) casts); it stays dtype-compatible with np.float64.
    assert np.dtype(gtx.float64) == np.dtype(np.float64)
    assert gtx.float64(1) == np.float64(1.0)
    assert np.dtype(gtx.int32) == np.dtype(np.int32)
    data = np.linspace(0.1, 1.0, 5)

    @gtx.field_operator
    def f(a):
        return gtx.sqrt(a) + gtx.maximum(a, 0.5)

    out = gtx.zeros({I: 5}, device="cpu")
    f(gtx.as_field([I], data, device="cpu"), out=out)
    np.testing.assert_allclose(
        out.asnumpy(), np.sqrt(data) + np.maximum(data, 0.5), rtol=1e-12
    )


def test_type_deduction_tracks_staggered_shift():
    from gt4py_tpu_torch.next import Dims, Field
    from gt4py_tpu_torch.next.errors import DSLTypeError
    from gt4py_tpu_torch.next.type_deduction import deduce

    def to_centers(u: Field[Dims[IHalf], np.float64]):
        return 0.5 * (u(I + 0.5) + u(I - 0.5))

    info = deduce(to_centers)
    assert info.returns.dims == (I,)

    with pytest.raises(DSLTypeError, match="no _StaggeredI dimension"):

        @gtx.field_operator
        def bad(p: Field[Dims[I], np.float64]):
            return p(I + 0.5)  # needs a field over IHalf


def test_mixed_staggered_domain_rejected():
    from gt4py_tpu_torch.next import check_dims, domain

    with pytest.raises(ValueError, match="staggered counterpart"):
        check_dims((I, IHalf))
    with pytest.raises(ValueError, match="staggered counterpart"):
        domain({I: 4, IHalf: 4})
    # distinct base dims are fine
    check_dims((I, Dimension("J")))


def test_as_field_rejects_mixed_staggered_dims():
    with pytest.raises(ValueError, match="staggered counterpart"):
        gtx.as_field([I, IHalf], np.zeros((3, 4)), device="cpu")
