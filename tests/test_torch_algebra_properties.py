"""tests/next_tests/test_algebra_properties.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Property-based invariants of the core algebra (reference
unit_tests/test_common.py hypothesis cases): promote_dims laws,
UnitRange/Domain intersection lattice properties."""

import hypothesis.strategies as st
import numpy as np
from hypothesis import given, settings

from gt4py_tpu_torch.next.common import (
    Dimension,
    Domain,
    NamedRange,
    UnitRange,
    promote_dims,
)

DIMS = [Dimension(n) for n in "ABCDE"]


def dim_lists():
    return st.lists(st.sampled_from(DIMS), max_size=5, unique=True).map(tuple)


def unit_ranges():
    return st.tuples(
        st.integers(-20, 20), st.integers(0, 30)
    ).map(lambda t: UnitRange(t[0], t[0] + t[1]))


@settings(max_examples=60, deadline=None)
@given(a=dim_lists(), b=dim_lists())
def test_promote_dims_contains_both(a, b):
    r = promote_dims(a, b)
    assert set(r) == set(a) | set(b)
    # The FIRST list's relative order is always preserved (the union is
    # first-argument biased); the second's only when the two orders do
    # not contradict each other.
    pos = [r.index(d) for d in a]
    assert pos == sorted(pos)
    shared = [d for d in a if d in b]
    if [d for d in b if d in shared] == shared:  # consistent orders
        pos_b = [r.index(d) for d in b]
        assert pos_b == sorted(pos_b)


@settings(max_examples=60, deadline=None)
@given(a=dim_lists(), b=dim_lists(), c=dim_lists())
def test_promote_dims_associative_in_membership(a, b, c):
    left = promote_dims(promote_dims(a, b), c)
    right = promote_dims(a, promote_dims(b, c))
    assert set(left) == set(right)


@settings(max_examples=60, deadline=None)
@given(a=dim_lists())
def test_promote_dims_idempotent(a):
    assert promote_dims(a, a) == a


@settings(max_examples=80, deadline=None)
@given(r1=unit_ranges(), r2=unit_ranges())
def test_unit_range_intersection_commutative_and_bounded(r1, r2):
    i12 = r1.intersection(r2)
    i21 = r2.intersection(r1)
    assert len(i12) == len(i21)
    assert len(i12) <= min(len(r1), len(r2))
    for v in range(i12.start, i12.stop):
        assert v in r1 and v in r2


@settings(max_examples=80, deadline=None)
@given(r=unit_ranges(), offset=st.integers(-15, 15))
def test_unit_range_shift_roundtrip(r, offset):
    assert r.shifted(offset).shifted(-offset) == r
    assert len(r.shifted(offset)) == len(r)


@settings(max_examples=60, deadline=None)
@given(r1=unit_ranges(), r2=unit_ranges(), r3=unit_ranges())
def test_unit_range_intersection_associative(r1, r2, r3):
    a = r1.intersection(r2).intersection(r3)
    b = r1.intersection(r2.intersection(r3))
    assert len(a) == len(b)
    if len(a):
        assert a == b


@settings(max_examples=60, deadline=None)
@given(r1=unit_ranges(), r2=unit_ranges())
def test_domain_intersection_matches_range_intersection(r1, r2):
    d1 = Domain((NamedRange(DIMS[0], r1),))
    d2 = Domain((NamedRange(DIMS[0], r2),))
    di = d1.intersection(d2)
    assert di[DIMS[0]].unit_range.intersection(r1.intersection(r2)) == di[DIMS[0]].unit_range


@settings(max_examples=40, deadline=None)
@given(r1=unit_ranges(), r2=unit_ranges())
def test_domain_intersection_promotes_disjoint_dims(r1, r2):
    d1 = Domain((NamedRange(DIMS[0], r1),))
    d2 = Domain((NamedRange(DIMS[1], r2),))
    di = d1.intersection(d2)
    assert set(di.dims) == {DIMS[0], DIMS[1]}
