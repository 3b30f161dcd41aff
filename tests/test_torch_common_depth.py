"""tests/next_tests/test_common_depth.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Deep range/domain algebra suite — reference-parity semantics.

Ports the behavioral checklist of the reference's
``tests/next_tests/unit_tests/test_common.py`` (795 LoC: unbounded-range
arithmetic, UnitRange indexing/iteration/set-ordering, flexible Domain
construction, slice_at/pop/replace/dim_index) against this framework's
``gt4py_tpu_torch.next.common`` implementation.
"""

import operator

import numpy as np
import pytest

from gt4py_tpu_torch.next.common import (
    Dimension,
    DimensionKind,
    Domain,
    Infinity,
    NamedRange,
    UnitRange,
    domain,
    named_range,
    unit_range,
)

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
ECDim = Dimension("ECDim")


@pytest.fixture
def rng():
    return UnitRange(-5, 5)


@pytest.fixture
def a_domain():
    return Domain(
        NamedRange(IDim, UnitRange(0, 10)),
        NamedRange(JDim, UnitRange(5, 15)),
        NamedRange(KDim, UnitRange(20, 30)),
    )


# --- UnitRange: normalization, length, membership ---------------------------


@pytest.mark.parametrize("empty_range", [UnitRange(1, 0), UnitRange(1, -1)])
def test_empty_range_normalizes(empty_range):
    assert empty_range == UnitRange(0, 0)
    assert empty_range.is_empty()


def test_nonempty_range_is_not_normalized():
    r = UnitRange(3, 4)
    assert (r.start, r.stop) == (3, 4)
    assert not r.is_empty()


def test_unit_range_length(rng):
    assert rng.start == -5
    assert rng.stop == 5
    assert len(rng) == 10


@pytest.mark.parametrize(
    "rng_like, expected",
    [
        ((2, 4), UnitRange(2, 4)),
        (range(2, 4), UnitRange(2, 4)),
        (UnitRange(2, 4), UnitRange(2, 4)),
        ((None, None), UnitRange(Infinity.NEGATIVE, Infinity.POSITIVE)),
        ((2, None), UnitRange(2, Infinity.POSITIVE)),
        ((None, 4), UnitRange(Infinity.NEGATIVE, 4)),
        (None, UnitRange(Infinity.NEGATIVE, Infinity.POSITIVE)),
    ],
)
def test_unit_range_like(rng_like, expected):
    assert unit_range(rng_like) == expected


def test_unit_range_repr(rng):
    assert repr(rng) == "UnitRange(-5, 5)"
    assert "Infinity.POSITIVE" in repr(UnitRange(0, Infinity.POSITIVE))
    assert "Infinity.NEGATIVE" in repr(UnitRange.infinite())


def test_unit_range_iter(rng):
    assert list(rng) == list(range(-5, 5))


def test_unit_range_iter_open_raises():
    with pytest.raises(ValueError):
        list(UnitRange(0, Infinity.POSITIVE))


def test_unit_range_get_item(rng):
    assert rng[-1] == 4
    assert rng[0] == -5
    assert rng[0:4] == UnitRange(-5, -1)
    assert rng[-4:] == UnitRange(1, 5)


def test_unit_range_index_error(rng):
    with pytest.raises(IndexError):
        rng[10]
    with pytest.raises(IndexError):
        rng[-11]


def test_unit_range_slice_step_error(rng):
    with pytest.raises(ValueError):
        rng[1:2:5]


@pytest.mark.parametrize(
    "rng1, rng2, expected",
    [
        (UnitRange(0, 5), UnitRange(10, 15), UnitRange(0, 0)),
        (UnitRange(0, 5), UnitRange(5, 10), UnitRange(0, 0)),
        (UnitRange(0, 5), UnitRange(3, 7), UnitRange(3, 5)),
        (UnitRange(0, 5), UnitRange(1, 6), UnitRange(1, 5)),
        (UnitRange(0, 5), UnitRange(-5, 5), UnitRange(0, 5)),
        (UnitRange(0, 0), UnitRange(0, 5), UnitRange(0, 0)),
        (UnitRange(0, 0), UnitRange(0, 0), UnitRange(0, 0)),
    ],
)
def test_unit_range_intersection(rng1, rng2, expected):
    assert (rng1 & rng2) == expected
    assert rng1.intersection(rng2) == expected


@pytest.mark.parametrize(
    "rng1, rng2, expected",
    [
        (UnitRange(20, Infinity.POSITIVE), UnitRange(10, 15), UnitRange(0, 0)),
        (UnitRange(Infinity.NEGATIVE, 0), UnitRange(5, 10), UnitRange(0, 0)),
        (UnitRange(Infinity.NEGATIVE, 0), UnitRange(-10, 0), UnitRange(-10, 0)),
        (
            UnitRange(0, Infinity.POSITIVE),
            UnitRange(Infinity.NEGATIVE, 5),
            UnitRange(0, 5),
        ),
        (
            UnitRange(Infinity.NEGATIVE, 0),
            UnitRange(Infinity.NEGATIVE, 5),
            UnitRange(Infinity.NEGATIVE, 0),
        ),
        (
            UnitRange.infinite(),
            UnitRange.infinite(),
            UnitRange.infinite(),
        ),
    ],
)
def test_unit_range_unbounded_intersection(rng1, rng2, expected):
    assert (rng1 & rng2) == expected


@pytest.mark.parametrize(
    "open_rng",
    [
        UnitRange(Infinity.NEGATIVE, 0),
        UnitRange(0, Infinity.POSITIVE),
        UnitRange.infinite(),
    ],
)
def test_open_range_len_raises(open_rng):
    with pytest.raises(ValueError, match=r".*[Oo]pen.*"):
        len(open_rng)


def test_range_contains():
    assert 1 in UnitRange(0, 2)
    assert 1 not in UnitRange(0, 1)
    assert 1 in UnitRange(0, Infinity.POSITIVE)
    assert 1 in UnitRange(Infinity.NEGATIVE, 2)
    assert 1 in UnitRange.infinite()
    assert "s" not in UnitRange.infinite()
    assert 1.5 not in UnitRange(0, 5)
    # numpy integers count as integers
    assert np.int32(1) in UnitRange(0, 2)
    assert np.int64(7) not in UnitRange(0, 2)


@pytest.mark.parametrize(
    "op, rng1, rng2, expected",
    [
        (operator.le, UnitRange(-1, 2), UnitRange(-2, 3), True),
        (operator.le, UnitRange(-2, 3), UnitRange(-1, 2), False),
        (
            operator.le,
            UnitRange(Infinity.NEGATIVE, 2),
            UnitRange(Infinity.NEGATIVE, 3),
            True,
        ),
        (operator.ge, UnitRange(-2, 3), UnitRange(-1, 2), True),
        (
            operator.ge,
            UnitRange(Infinity.NEGATIVE, 3),
            UnitRange(Infinity.NEGATIVE, 2),
            True,
        ),
        (operator.lt, UnitRange(-1, 2), UnitRange(-2, 2), True),
        (operator.lt, UnitRange(-2, 1), UnitRange(-2, 2), True),
        (operator.lt, UnitRange(-2, 2), UnitRange(-2, 2), False),
        (
            operator.lt,
            UnitRange(Infinity.NEGATIVE, 2),
            UnitRange(Infinity.NEGATIVE, 3),
            True,
        ),
        (operator.gt, UnitRange(-2, 2), UnitRange(-1, 2), True),
        (operator.gt, UnitRange(-2, 2), UnitRange(-2, 1), True),
        (
            operator.gt,
            UnitRange(Infinity.NEGATIVE, 3),
            UnitRange(Infinity.NEGATIVE, 2),
            True,
        ),
        (
            operator.eq,
            UnitRange(Infinity.NEGATIVE, 2),
            UnitRange(Infinity.NEGATIVE, 2),
            True,
        ),
        (
            operator.ne,
            UnitRange(Infinity.NEGATIVE, 2),
            UnitRange(Infinity.NEGATIVE, 3),
            True,
        ),
    ],
)
def test_range_subset_comparison(op, rng1, rng2, expected):
    assert op(rng1, rng2) == expected


def test_shifted_pins_unbounded_ends():
    assert UnitRange(0, Infinity.POSITIVE).shifted(3) == UnitRange(
        3, Infinity.POSITIVE
    )
    assert UnitRange(Infinity.NEGATIVE, 4).shifted(-2) == UnitRange(
        Infinity.NEGATIVE, 2
    )
    assert UnitRange.infinite().shifted(100) == UnitRange.infinite()
    assert UnitRange(1, 5).shifted(2) == UnitRange(3, 7)


def test_unit_range_hashable_and_frozen(rng):
    assert hash(rng) == hash(UnitRange(-5, 5))
    with pytest.raises(Exception):
        rng.start = 0


# --- NamedRange --------------------------------------------------------------


@pytest.mark.parametrize(
    "named_rng_like",
    [(IDim, (2, 4)), (IDim, range(2, 4)), (IDim, UnitRange(2, 4))],
)
def test_named_range_like(named_rng_like):
    assert named_range(named_rng_like) == (IDim, UnitRange(2, 4))


def test_named_range_is_tuple_compatible():
    nr = NamedRange(IDim, UnitRange(0, 5))
    assert nr == (IDim, UnitRange(0, 5))
    d, r = nr
    assert d is IDim and r == UnitRange(0, 5)
    assert nr.dim is IDim and nr.unit_range == UnitRange(0, 5)


def test_named_range_bad_spec():
    with pytest.raises(TypeError):
        named_range((1, 2, 3))
    with pytest.raises(TypeError):
        named_range(("not_a_dim", (0, 1)))


# --- Domain: construction forms ----------------------------------------------


def test_domain_length(a_domain):
    assert len(a_domain) == 3
    assert a_domain.ndim == 3


@pytest.mark.parametrize(
    "empty_domain, expected",
    [
        (Domain(), False),
        (Domain(NamedRange(IDim, UnitRange(0, 10))), False),
        (Domain(NamedRange(IDim, UnitRange(0, 0))), True),
        (
            Domain(
                NamedRange(IDim, UnitRange(0, 0)),
                NamedRange(JDim, UnitRange(0, 1)),
            ),
            True,
        ),
        (
            Domain(
                NamedRange(IDim, UnitRange(0, 1)),
                NamedRange(JDim, UnitRange(0, 0)),
            ),
            True,
        ),
    ],
)
def test_empty_domain(empty_domain, expected):
    assert empty_domain.is_empty() == expected


@pytest.mark.parametrize(
    "domain_like",
    [
        Domain(dims=(IDim, JDim), ranges=(UnitRange(2, 4), UnitRange(3, 5))),
        ((IDim, (2, 4)), (JDim, (3, 5))),
        {IDim: (2, 4), JDim: (3, 5)},
    ],
)
def test_domain_like(domain_like):
    assert domain(domain_like) == Domain(
        dims=(IDim, JDim), ranges=(UnitRange(2, 4), UnitRange(3, 5))
    )


def test_domain_constructor_forms_agree(a_domain):
    by_kwargs = Domain(
        dims=(IDim, JDim, KDim),
        ranges=(UnitRange(0, 10), UnitRange(5, 15), UnitRange(20, 30)),
    )
    by_iterable = Domain(
        (
            NamedRange(IDim, UnitRange(0, 10)),
            NamedRange(JDim, UnitRange(5, 15)),
            NamedRange(KDim, UnitRange(20, 30)),
        )
    )
    assert by_kwargs == a_domain == by_iterable


def test_domain_kwargs_range_coercion():
    d = Domain(dims=(IDim,), ranges=((2, 4),))
    assert d[IDim] == (IDim, UnitRange(2, 4))


def test_domain_mixed_args_kwargs_rejected():
    with pytest.raises(ValueError):
        Domain(NamedRange(IDim, UnitRange(0, 1)), dims=(JDim,), ranges=((0, 1),))
    with pytest.raises(ValueError):
        Domain(dims=(IDim,))


def test_domain_iteration(a_domain):
    iterated = [val for val in a_domain]
    assert iterated == list(zip(a_domain.dims, (r.unit_range for r in a_domain)))


def test_domain_contains_named_range(a_domain):
    assert (IDim, UnitRange(0, 10)) in a_domain
    assert (IDim, UnitRange(-5, 5)) not in a_domain
    assert NamedRange(JDim, UnitRange(5, 15)) in a_domain
    assert IDim in a_domain
    assert ECDim not in a_domain
    assert "IDim" not in a_domain


@pytest.mark.parametrize(
    "second_domain, expected",
    [
        (
            Domain(dims=(IDim, JDim), ranges=(UnitRange(2, 12), UnitRange(7, 17))),
            Domain(
                dims=(IDim, JDim, KDim),
                ranges=(UnitRange(2, 10), UnitRange(7, 15), UnitRange(20, 30)),
            ),
        ),
        (
            Domain(dims=(IDim, KDim), ranges=(UnitRange(2, 12), UnitRange(7, 27))),
            Domain(
                dims=(IDim, JDim, KDim),
                ranges=(UnitRange(2, 10), UnitRange(5, 15), UnitRange(20, 27)),
            ),
        ),
        (
            Domain(dims=(JDim, KDim), ranges=(UnitRange(2, 12), UnitRange(4, 27))),
            Domain(
                dims=(IDim, JDim, KDim),
                ranges=(UnitRange(0, 10), UnitRange(5, 12), UnitRange(20, 27)),
            ),
        ),
    ],
)
def test_domain_intersection_different_dimensions(a_domain, second_domain, expected):
    assert (a_domain & second_domain) == expected


# --- Domain: indexing ---------------------------------------------------------


@pytest.mark.parametrize(
    "index, expected",
    [
        (0, (IDim, UnitRange(0, 10))),
        (1, (JDim, UnitRange(5, 15))),
        (2, (KDim, UnitRange(20, 30))),
        (-1, (KDim, UnitRange(20, 30))),
        (-2, (JDim, UnitRange(5, 15))),
    ],
)
def test_domain_integer_indexing(a_domain, index, expected):
    assert a_domain[index] == expected


@pytest.mark.parametrize(
    "slice_obj, expected",
    [
        (slice(0, 2), ((IDim, UnitRange(0, 10)), (JDim, UnitRange(5, 15)))),
        (slice(1, None), ((JDim, UnitRange(5, 15)), (KDim, UnitRange(20, 30)))),
    ],
)
def test_domain_slice_indexing(a_domain, slice_obj, expected):
    result = a_domain[slice_obj]
    assert isinstance(result, Domain)
    assert len(result) == len(expected)
    assert all(res == exp for res, exp in zip(result, expected))


@pytest.mark.parametrize(
    "index, expected_result",
    [(JDim, (JDim, UnitRange(5, 15))), (KDim, (KDim, UnitRange(20, 30)))],
)
def test_domain_dimension_indexing(a_domain, index, expected_result):
    assert a_domain[index] == expected_result


def test_domain_indexing_dimension_missing(a_domain):
    with pytest.raises(KeyError, match=r"No Dimension .* present in the Domain"):
        a_domain[ECDim]


def test_domain_indexing_invalid_type(a_domain):
    with pytest.raises(
        KeyError, match="Invalid index type, must be either int, slice, or Dimension."
    ):
        a_domain["foo"]


def test_domain_repeat_dims():
    with pytest.raises(NotImplementedError, match=r"must be unique"):
        Domain(
            dims=(IDim, JDim, IDim),
            ranges=(UnitRange(0, 5), UnitRange(0, 8), UnitRange(0, 3)),
        )


def test_domain_dims_ranges_length_mismatch():
    with pytest.raises(
        ValueError,
        match=r"Number of provided dimensions \(\d+\) does not match number of provided ranges \(\d+\)",
    ):
        Domain(
            dims=[Dimension("X"), Dimension("Y"), Dimension("Z")],
            ranges=[UnitRange(0, 1), UnitRange(0, 1)],
        )


# --- Domain: slice_at / pop / replace / dim_index -----------------------------


def test_domain_slice_at(a_domain):
    result = a_domain.slice_at[slice(2, 5), slice(5, 7), slice(7, 10)]
    assert result == Domain(
        NamedRange(IDim, UnitRange(2, 5)),
        NamedRange(JDim, UnitRange(10, 12)),
        NamedRange(KDim, UnitRange(27, 30)),
    )

    # out-of-range slices clamp to the available extent
    result = a_domain.slice_at[slice(2, 15), slice(5, 7), slice(7, 10)]
    assert result[0] == (IDim, UnitRange(2, 10))

    with pytest.raises(TypeError):
        a_domain.slice_at["a", 7, 25]

    with pytest.raises(ValueError, match="not match the number of dimensions"):
        a_domain.slice_at[slice(2, 5), slice(7, 10)]


def test_domain_dim_index(a_domain):
    assert a_domain.dim_index(JDim) == 1
    assert a_domain.dim_index(Dimension("Foo")) is None
    assert a_domain.index(KDim) == 2
    with pytest.raises(KeyError):
        a_domain.index(Dimension("Foo"))


def test_domain_pop(a_domain):
    rest = Domain(a_domain.ranges[1:])
    assert a_domain.pop(IDim) == rest
    assert a_domain.pop(0) == rest
    assert a_domain.pop(-1) == Domain(a_domain.ranges[:-1])
    with pytest.raises(IndexError):
        a_domain.pop(5)
    with pytest.raises(KeyError):
        a_domain.pop(ECDim)


@pytest.mark.parametrize(
    "index, repl, expected_at",
    [
        (
            0,
            NamedRange(ECDim, UnitRange(0, 2)),
            0,
        ),
        (
            JDim,
            NamedRange(ECDim, UnitRange(0, 2)),
            1,
        ),
        (
            -1,
            NamedRange(ECDim, UnitRange(0, 2)),
            2,
        ),
    ],
)
def test_domain_replace_single(a_domain, index, repl, expected_at):
    result = a_domain.replace(index, repl)
    assert result[expected_at] == repl
    assert len(result) == len(a_domain)


def test_domain_replace_with_two(a_domain):
    result = a_domain.replace(
        JDim,
        NamedRange(ECDim, UnitRange(0, 2)),
        NamedRange(Dimension("X"), UnitRange(0, 3)),
    )
    assert len(result) == 4
    assert result[1] == (ECDim, UnitRange(0, 2))
    assert result[2] == (Dimension("X"), UnitRange(0, 3))
    assert result[3] == a_domain[2]


def test_domain_replace_out_of_bounds(a_domain):
    with pytest.raises(IndexError):
        a_domain.replace(3, NamedRange(ECDim, UnitRange(0, 2)))


def test_domain_shape_and_dims(a_domain):
    assert a_domain.shape == (10, 10, 10)
    assert a_domain.dims == (IDim, JDim, KDim)


def test_domain_hashable(a_domain):
    assert hash(a_domain) == hash(
        Domain(
            dims=(IDim, JDim, KDim),
            ranges=(UnitRange(0, 10), UnitRange(5, 15), UnitRange(20, 30)),
        )
    )
