"""tests/next_tests/test_inverse_image_properties.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Property-based invariants of Connectivity.inverse_image.

Reference behavior: NdArrayConnectivityField.inverse_image
(upstream gt4py src/gt4py/next/embedded/nd_array_field.py:571-597 via
_hyperslice) — the preimage of a codomain UnitRange is the set of source
rows whose every non-skip neighbor lands inside the range; a
non-contiguous preimage raises. The reference covers this with directed
cases (tests/next_tests/unit_tests/embedded_tests/test_nd_array_field.py);
here a brute-force numpy oracle checks arbitrary generated tables.
"""

import hypothesis.strategies as st
import numpy as np
import pytest
from hypothesis import given, settings

from gt4py_tpu_torch.next.common import Connectivity, Dimension, UnitRange

Edge = Dimension("Edge")
E2VDim = Dimension("E2V")
Vertex = Dimension("Vertex")

SKIP = -1


def make_conn(table, skip=None):
    return Connectivity(
        np.asarray(table, dtype=np.int64),
        domain_dims=(Edge, E2VDim),
        codomain=Vertex,
        skip_value=skip, device="cpu"
    )


def brute_preimage(table, image_range, skip=None):
    """Oracle: boolean row mask of the preimage."""
    table = np.asarray(table)
    valid = np.ones_like(table, dtype=bool) if skip is None else table != skip
    inside = ((table >= image_range.start) & (table < image_range.stop)) | ~valid
    return inside.all(axis=1) & valid.any(axis=1)


def tables(max_rows=12, max_cols=3, m=8, with_skips=False):
    entry = st.integers(SKIP if with_skips else 0, m - 1)
    return st.integers(1, max_rows).flatmap(
        lambda r: st.integers(1, max_cols).flatmap(
            lambda c: st.lists(
                st.lists(entry, min_size=c, max_size=c),
                min_size=r,
                max_size=r,
            )
        )
    )


def ranges(m=8):
    return st.tuples(st.integers(0, m), st.integers(0, m)).map(
        lambda t: UnitRange(min(t), max(t))
    )


@settings(max_examples=200, deadline=None)
@given(table=tables(with_skips=True), rng=ranges())
def test_inverse_image_matches_bruteforce(table, rng):
    """inverse_image == the brute-force row mask when that mask is a
    contiguous run (or empty); otherwise it raises."""
    conn = make_conn(table, skip=SKIP)
    mask = brute_preimage(table, rng, skip=SKIP)
    idx = np.flatnonzero(mask)
    contiguous = idx.size == 0 or np.array_equal(
        idx, np.arange(idx[0], idx[-1] + 1)
    )
    if contiguous:
        got = conn.inverse_image(rng)
        if idx.size == 0:
            assert len(got) == 0
        else:
            assert got == UnitRange(int(idx[0]), int(idx[-1]) + 1)
    else:
        with pytest.raises(ValueError):
            conn.inverse_image(rng)


def banded_tables(max_rows=12, m=16, width=3):
    """Rows sorted by neighbor band: row i draws from [i, i+width) clipped
    to [0, m) — preimages are contiguous for most ranges (not all: a row
    can out-jump its successor within the band)."""

    def build(pair):
        r, offsets = pair
        tab = [
            [min(m - 1, i + o) for o in row_off]
            for i, row_off in zip(range(r), offsets)
        ]
        return tab

    return st.integers(1, max_rows).flatmap(
        lambda r: st.tuples(
            st.just(r),
            st.lists(
                st.lists(st.integers(0, width - 1), min_size=2, max_size=2),
                min_size=r,
                max_size=r,
            ),
        ).map(build)
    )


def _contiguous(mask):
    idx = np.flatnonzero(mask)
    return idx.size == 0 or np.array_equal(idx, np.arange(idx[0], idx[-1] + 1))


@settings(max_examples=150, deadline=None)
@given(table=banded_tables(), a=ranges(m=16), b=ranges(m=16))
def test_inverse_image_monotone(table, a, b):
    """A larger image range yields a superset preimage (cases where either
    preimage is non-contiguous are vacuous — the method raises there,
    covered by test_inverse_image_matches_bruteforce)."""
    conn = make_conn(table)
    lo = UnitRange(min(a.start, b.start), max(a.stop, b.stop))
    if not (_contiguous(brute_preimage(table, a)) and
            _contiguous(brute_preimage(table, lo))):
        return
    small = conn.inverse_image(a)
    big = conn.inverse_image(lo)
    assert (len(small) == 0) or (
        big.start <= small.start and small.stop <= big.stop
    )


@settings(max_examples=100, deadline=None)
@given(table=tables(with_skips=True))
def test_inverse_image_full_range_is_all_nonskip_rows(table):
    """The preimage of the full codomain is exactly the rows having at
    least one non-skip neighbor — when those form a contiguous run."""
    conn = make_conn(table, skip=SKIP)
    full = UnitRange(0, 8)
    mask = brute_preimage(table, full, skip=SKIP)
    idx = np.flatnonzero(mask)
    contiguous = idx.size == 0 or np.array_equal(
        idx, np.arange(idx[0], idx[-1] + 1)
    )
    if not contiguous:
        return
    got = conn.inverse_image(full)
    assert len(got) == idx.size


def test_inverse_image_all_skip_rows_never_included():
    table = [[SKIP, SKIP], [0, 1], [1, SKIP], [SKIP, SKIP]]
    conn = make_conn(table, skip=SKIP)
    got = conn.inverse_image(UnitRange(0, 8))
    assert got == UnitRange(1, 3)  # rows 0 and 3 are all-skip


def test_inverse_image_empty_range_is_empty():
    conn = make_conn([[0, 1], [1, 2]])
    assert len(conn.inverse_image(UnitRange(3, 3))) == 0
