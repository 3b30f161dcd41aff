"""tests/cartesian_tests/test_seq_fusion.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

fuse_parallel_temporaries: PARALLEL coefficient temps move into their
consuming sequential loop (reference vertical-loop-merging role,
gtc/passes/oir_optimizations/vertical_loop_merging.py)."""

import numpy as np
import pytest

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

F = gtscript.Field[np.float64]


def _loops(st):
    return st._analyzed.stencil.vertical_loops


def _run_both(defn, fields, domain=None, **kw):
    outs = {}
    st = None
    for backend in ("numpy", "torch"):
        st = gtscript.stencil(backend=backend, definition=defn, **kw)
        arrs = {k: storage.from_array(v, backend=backend, device="cpu") for k, v in fields.items()}
        st(**arrs, domain=domain)
        outs[backend] = {k: np.asarray(v) for k, v in arrs.items()}
    np.testing.assert_allclose(
        outs["numpy"]["out"], outs["torch"]["out"], rtol=1e-13
    )
    return st, outs["torch"]


def test_parallel_coeff_fuses_into_forward():
    def cum_coeff(a: F, out: F):
        with computation(PARALLEL), interval(...):
            c = a * 2.0 + 1.0
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c

    st, res = _run_both(
        cum_coeff,
        {
            "a": np.random.default_rng(0).random((4, 5, 6)),
            "out": np.zeros((4, 5, 6)),
        },
    )
    # One fused FORWARD loop remains; the PARALLEL producer is gone.
    assert len(_loops(st)) == 1
    assert _loops(st)[0].loop_order.name == "FORWARD"
    a = res["a"]
    expect = np.cumsum(a * 2.0 + 1.0, axis=2)
    np.testing.assert_allclose(res["out"], expect, rtol=1e-13)


def test_sectioned_producer_splits_consumer():
    """A temp defined piecewise over K (concat_where shape) splits the
    consumer's sections at its boundaries."""

    def piecewise(a: F, out: F):
        with computation(PARALLEL):
            with interval(0, 1):
                c = 0.0
            with interval(1, None):
                c = a
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c

    st, res = _run_both(
        piecewise,
        {
            "a": np.random.default_rng(1).random((3, 4, 7)),
            "out": np.zeros((3, 4, 7)),
        },
    )
    assert len(_loops(st)) == 1
    a = res["a"]
    c = a.copy()
    c[:, :, 0] = 0.0
    np.testing.assert_allclose(res["out"], np.cumsum(c, axis=2), rtol=1e-13)


def test_multi_consumer_temp_stays_materialized():
    def two_readers(a: F, out: F, out2: F):
        with computation(PARALLEL), interval(...):
            c = a + 1.0
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c
        with computation(BACKWARD):
            with interval(-1, None):
                out2 = c
            with interval(0, -1):
                out2 = out2[0, 0, 1] * 0.5 + c

    st = gtscript.stencil(backend="torch", definition=two_readers)
    # c read by two sequential loops: must NOT move (it would be computed
    # twice or once in the wrong loop) -> 3 loops survive.
    assert len(_loops(st)) == 3
    rng = np.random.default_rng(2)
    a = storage.from_array(rng.random((3, 4, 5)), backend="torch", device="cpu")
    out = storage.zeros((3, 4, 5), backend="torch", device="cpu")
    out2 = storage.zeros((3, 4, 5), backend="torch", device="cpu")
    st(a=a, out=out, out2=out2)
    c = np.asarray(a) + 1.0
    np.testing.assert_allclose(np.asarray(out), np.cumsum(c, axis=2), rtol=1e-13)


def test_koffset_read_blocks_fusion():
    """Reading the temp at a K offset inside the sequential loop keeps it
    materialized (moving it would read an unmaterialized plane)."""

    def koff(a: F, out: F):
        with computation(PARALLEL), interval(...):
            c = a * 3.0
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c[0, 0, -1]

    st, res = _run_both(
        koff,
        {
            "a": np.random.default_rng(3).random((3, 4, 6)),
            "out": np.zeros((3, 4, 6)),
        },
    )
    assert len(_loops(st)) == 2  # producer loop survives
    a = res["a"]
    c = a * 3.0
    expect = np.empty_like(c)
    expect[:, :, 0] = c[:, :, 0]
    for k in range(1, c.shape[2]):
        expect[:, :, k] = expect[:, :, k - 1] + c[:, :, k - 1]
    np.testing.assert_allclose(res["out"], expect, rtol=1e-13)


def test_rewritten_input_blocks_fusion():
    """The temp's definition reads a field that a LATER loop rewrites:
    moving the definition would observe updated values — keep it."""

    def rewrite(a: F, out: F):
        with computation(PARALLEL), interval(...):
            c = a + 5.0
        with computation(PARALLEL), interval(...):
            a = 0.0
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c

    st, res = _run_both(
        rewrite,
        {
            "a": np.random.default_rng(4).random((3, 4, 5)),
            "out": np.zeros((3, 4, 5)),
        },
    )
    assert len(_loops(st)) == 3
    # a was zeroed AFTER c = a + 5 was materialized.
    assert np.all(res["a"] == 0.0)
    assert res["out"][0, 0, -1] != 0.0


def test_chain_of_temps_moves_together():
    """Coefficient chains (temp reading temp) migrate as a unit."""

    def chain(a: F, out: F):
        with computation(PARALLEL), interval(...):
            c = a * 2.0
            d = c + 1.0
        with computation(FORWARD):
            with interval(0, 1):
                out = d
            with interval(1, None):
                out = out[0, 0, -1] + d

    st, res = _run_both(
        chain,
        {
            "a": np.random.default_rng(5).random((3, 4, 5)),
            "out": np.zeros((3, 4, 5)),
        },
    )
    assert len(_loops(st)) == 1
    d = res["a"] * 2.0 + 1.0
    np.testing.assert_allclose(res["out"], np.cumsum(d, axis=2), rtol=1e-13)


def test_fusion_on_cuda_hopper():
    """The fused stencil serves from the column kernel (on CPU tensors: its
    plain version; the reference's twin, test_fusion_on_pallas_interpret,
    runs the staged Pallas kernel in interpret mode)."""

    def cum_coeff(a: F, out: F):
        with computation(PARALLEL), interval(...):
            c = a * 2.0 + 1.0
        with computation(FORWARD):
            with interval(0, 1):
                out = c
            with interval(1, None):
                out = out[0, 0, -1] + c

    st = gtscript.stencil(backend="cuda:hopper", definition=cum_coeff)
    assert st._backend.strategy == "column"
    rng = np.random.default_rng(6)
    a = storage.from_array(rng.random((8, 16, 6)), backend="cuda:hopper", device="cpu")
    out = storage.zeros((8, 16, 6), backend="cuda:hopper", device="cpu")
    st(a=a, out=out)
    expect = np.cumsum(np.asarray(a) * 2.0 + 1.0, axis=2)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-6)


def test_write_only_out_halo_preserved_staged():
    """Seed-skip regression: a write-only out field with full-K coverage
    skips the seed stream; the decode paste must still preserve halo
    points outside the compute domain."""

    def diff(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = out[0, 0, -1] * 0.5 + a[1, 0, 0]

    st = gtscript.stencil(backend="cuda:hopper", definition=diff)
    rng = np.random.default_rng(7)
    shape = (10, 18, 5)
    a = storage.from_array(rng.random(shape), backend="cuda:hopper", device="cpu")
    out = storage.from_array(np.full(shape, 7.0), backend="cuda:hopper", device="cpu")
    st(a=a, out=out, origin=(1, 1, 0), domain=(8, 16, 5))
    o = np.asarray(out)
    # Halo frame untouched.
    assert np.all(o[0, :, :] == 7.0) and np.all(o[9, :, :] == 7.0)
    assert np.all(o[:, 0, :] == 7.0) and np.all(o[:, 17, :] == 7.0)
    # Domain computed.
    an = np.asarray(a)
    expect = np.empty((8, 16, 5))
    expect[..., 0] = an[1:9, 1:17, 0]
    for k in range(1, 5):
        expect[..., k] = expect[..., k - 1] * 0.5 + an[2:10, 1:17, k]
    np.testing.assert_allclose(o[1:9, 1:17], expect, rtol=1e-13)


def test_write_only_out_high_halo_preserved_staged():
    """Seed-skip with a zero origin but a public array LARGER than the
    domain: the high-side halo must survive the native write-back (the
    backend pastes the domain region onto the previous native)."""

    def diff2(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = out[0, 0, -1] * 0.5 + a

    st = gtscript.stencil(backend="cuda:hopper", definition=diff2)
    rng = np.random.default_rng(8)
    shape = (10, 18, 6)
    a = storage.from_array(rng.random(shape), backend="cuda:hopper", device="cpu")
    out = storage.from_array(np.full(shape, 7.0), backend="cuda:hopper", device="cpu")
    st(a=a, out=out, origin=(0, 0, 0), domain=(8, 16, 6))
    o = np.asarray(out)
    assert np.all(o[8:, :, :] == 7.0)
    assert np.all(o[:, 16:, :] == 7.0)
    an = np.asarray(a)
    expect = np.empty((8, 16, 6))
    expect[..., 0] = an[:8, :16, 0]
    for k in range(1, 6):
        expect[..., k] = expect[..., k - 1] * 0.5 + an[:8, :16, k]
    np.testing.assert_allclose(o[:8, :16], expect, rtol=1e-13)
