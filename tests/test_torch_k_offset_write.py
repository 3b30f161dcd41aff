"""tests/cartesian_tests/test_k_offset_write.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

K-offset writes in sequential computations.

Reference semantics: ``tests/cartesian_tests/integration_tests/
multi_feature_tests/test_code_generation.py::test_K_offset_write_simple/
_forward/_backward/_conditional`` and ``unit_tests/frontend_tests/
test_gtscript_frontend.py::TestAssignmentSyntax::test_K_offset_write``
(PARALLEL rejection): a statement may assign to ``field[0, 0, n]`` (or a
runtime-variable ``field[0, 0, lev]``) inside FORWARD/BACKWARD loops;
levels execute in order and later iterations observe earlier offset
writes. Out-of-range variable-offset target levels are dropped.
"""

import numpy as np
import pytest

from gt4py_tpu_torch import storage as gt_storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.frontend import GTScriptSyntaxError
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    Field,
    computation,
    interval,
)

from tests.torch_definitions import ALL_BACKENDS

# the reference's CPU tier holds every backend but tpu:pallas, ``jax``
# included: here every backend but cuda:hopper, ``torch`` included (on CPU
# tensors; its storages default to the card)
BACKENDS = [b for b in ALL_BACKENDS if b not in ("debug", "cuda:hopper")] + ["debug"]


def _zeros(shape, backend):
    return gt_storage.zeros(shape, dtype=np.float64, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_offset_write_simple(backend):
    @gtscript.stencil(backend=backend)
    def simple(A: Field[np.float64], B: Field[np.float64]):
        with computation(FORWARD), interval(...):
            B[0, 0, 1] = A

    shape = (1, 1, 4)
    K_values = np.arange(start=40.0, stop=44.0)
    A = _zeros(shape, backend)
    A[:, :, :] = K_values
    B = _zeros(shape, backend)
    simple(A, B)
    # B's K boundary (0, 1) shrinks the default K domain to 3:
    # k in [0, 3) writes B[k+1] = A[k]
    assert (np.asarray(B)[:, :, 0] == 0).all()
    np.testing.assert_allclose(np.asarray(B)[0, 0, 1:4], K_values[0:3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_offset_write_forward(backend):
    @gtscript.stencil(backend=backend)
    def forward(A: Field[np.float64], B: Field[np.float64], scalar: np.float64):
        with computation(FORWARD), interval(1, None):
            A[0, 0, -1] = scalar
            B[0, 0, 0] = A

    shape = (1, 1, 4)
    K_values = np.arange(start=40.0, stop=44.0)
    A = _zeros(shape, backend)
    A[:, :, :] = K_values
    B = _zeros(shape, backend)
    forward(A, B, 2.0)
    # FORWARD: A[k-1] is overwritten AFTER B already read A at k
    assert (np.asarray(A)[:, :, :3] == 2.0).all()
    assert (np.asarray(A)[:, :, 3] == K_values[3]).all()
    assert (np.asarray(B)[:, :, 0] == 0).all()
    np.testing.assert_allclose(np.asarray(B)[0, 0, 1:], K_values[1:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_offset_write_backward(backend):
    @gtscript.stencil(backend=backend)
    def backward(A: Field[np.float64], B: Field[np.float64], scalar: np.float64):
        with computation(BACKWARD), interval(-1, None):
            A = scalar

        with computation(BACKWARD), interval(1, None):
            A[0, 0, -1] = scalar
            B[0, 0, 0] = A

    shape = (1, 1, 4)
    K_values = np.arange(start=40.0, stop=44.0)
    A = _zeros(shape, backend)
    A[:, :, :] = K_values
    B = _zeros(shape, backend)
    backward(A, B, 2.0)
    # BACKWARD: A[k-1] written at iteration k is then read at iteration k-1
    assert (np.asarray(A) == 2.0).all()
    assert (np.asarray(B)[:, :, 0] == 0.0).all()
    assert (np.asarray(B)[:, :, 1:] == 2.0).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_offset_write_conditional(backend):
    @gtscript.stencil(backend=backend)
    def column_physics_conditional(
        A: Field[np.float64], B: Field[np.float64], scalar: np.float64
    ):
        with computation(BACKWARD), interval(1, -1):
            if A > 0 and B > 0:
                A[0, 0, -1] = scalar
                B[0, 0, 1] = A
            lev = 1
            while A >= 0 and B >= 0:
                A[0, 0, lev] = -1
                B = -1
                lev = lev + 1

    shape = (1, 1, 4)
    K_values = np.arange(start=40.0, stop=44.0)
    A = _zeros(shape, backend)
    A[:, :, :] = K_values
    B = gt_storage.ones(shape, dtype=np.float64, backend=backend, device="cpu")
    column_physics_conditional(A, B, 2.0)
    # manual unroll documented in the reference test
    assert (np.asarray(A)[0, 0, :] == np.array([2.0, 2.0, -1.0, -1.0])).all()
    assert (np.asarray(B)[0, 0, :] == np.array([1.0, -1.0, 2.0, 42.0])).all()


def test_k_offset_write_parallel_rejected():
    with pytest.raises(
        GTScriptSyntaxError,
        match=r"non-zero offsets in K is not available in PARALLEL",
    ):

        @gtscript.stencil(backend="numpy")
        def bad(out: Field[np.float64], inp: Field[np.float64]):
            with computation(PARALLEL), interval(...):
                out[0, 0, 1] = inp


def test_ij_offset_write_still_rejected():
    with pytest.raises(GTScriptSyntaxError, match=r"zero offset in I and J"):

        @gtscript.stencil(backend="numpy")
        def bad(out: Field[np.float64], inp: Field[np.float64]):
            with computation(FORWARD), interval(...):
                out[1, 0, 0] = inp


def test_k_offset_write_larger_domain_vs_oracle():
    """Cross-backend agreement on a (5, 4, 6) domain with both signs."""

    def defn(A: Field[np.float64], B: Field[np.float64]):
        with computation(FORWARD), interval(1, None):
            B[0, 0, -1] = A + 1.0
            A[0, 0, 0] = B

    results = {}
    rng = np.random.default_rng(7)
    a0 = rng.normal(size=(5, 4, 6))
    b0 = rng.normal(size=(5, 4, 6))
    for backend in BACKENDS:
        st = gtscript.stencil(backend=backend, definition=defn)
        A = _zeros((5, 4, 6), backend)
        B = _zeros((5, 4, 6), backend)
        A[...] = a0
        B[...] = b0
        st(A, B)
        results[backend] = (np.asarray(A).copy(), np.asarray(B).copy())
    ref = results["debug"]
    for backend, (ra, rb) in results.items():
        np.testing.assert_allclose(ra, ref[0], err_msg=f"A mismatch on {backend}")
        np.testing.assert_allclose(rb, ref[1], err_msg=f"B mismatch on {backend}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_variable_k_offset_write(backend):
    """Runtime-variable write level, reference conditional-test pattern."""

    @gtscript.stencil(backend=backend)
    def varwrite(A: Field[np.float64], L: Field[np.int64]):
        with computation(FORWARD), interval(...):
            A[0, 0, L] = 99.0

    shape = (2, 2, 5)
    A = _zeros(shape, backend)
    L = gt_storage.zeros(shape, dtype=np.int64, backend=backend, device="cpu")
    # at k, write to k + L[k]; choose L so k=0 writes k=2, k=1 writes k=1,
    # others write out of range (dropped)
    L[:, :, 0] = 2
    L[:, :, 1] = 0
    L[:, :, 2] = 99  # out of range -> dropped
    L[:, :, 3] = -99  # out of range -> dropped
    L[:, :, 4] = 0
    varwrite(A, L)
    expected = np.zeros(shape)
    expected[:, :, 2] = 99.0
    expected[:, :, 1] = 99.0
    expected[:, :, 4] = 99.0
    np.testing.assert_allclose(np.asarray(A), expected)
