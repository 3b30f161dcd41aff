"""tests/cartesian_tests/test_burgers.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Burgers model family (reference demo_burgers.ipynb): RK3 + 6th-order
upwind advection + 4th-order diffusion, validated against the Zhao
analytic solution and across backends."""


import numpy as np
import pytest

from gt4py_tpu_torch.examples.burgers import run, zhao_solution


def test_burgers_converges_to_zhao():
    """After 100 RK3 steps at n=11 the numerical solution tracks the
    analytic one (reference demo prints ~1e-3-class errors here)."""
    err_u, err_v, _, _ = run(backend="torch", factor=0, niter=100, verbose=False, device="cpu")
    assert err_u < 5e-3, err_u
    assert err_v < 5e-3, err_v


def test_burgers_backends_agree():
    outs = {}
    for backend in ("numpy", "torch"):
        _, _, u, v = run(backend=backend, factor=0, niter=20, verbose=False, device="cpu")
        outs[backend] = (u, v)
    np.testing.assert_allclose(outs["numpy"][0], outs["torch"][0], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(outs["numpy"][1], outs["torch"][1], rtol=1e-10, atol=1e-14)


def test_burgers_grid_refinement_reduces_error():
    """Halving dx (factor 0 -> 1) with the dt scaling keeps the scheme
    stable and reduces the error (the demo's convergence premise)."""
    eu0, _, _, _ = run(backend="torch", factor=0, niter=100, verbose=False, device="cpu")
    eu1, _, _, _ = run(backend="torch", factor=1, niter=400, verbose=False, device="cpu")
    assert eu1 < eu0


def test_zhao_solution_satisfies_boundary_conditions():
    x = np.linspace(0.0, 1.0, 21)
    y = np.linspace(0.0, 1.0, 21)
    u, v = zhao_solution(0.3, x, y)
    # v vanishes on the y=0/1 walls (cos(pi*y) factor is +-1, sin drives u)
    np.testing.assert_allclose(u[:, 0], 0.0, atol=1e-12)
    np.testing.assert_allclose(u[:, -1], 0.0, atol=1e-12)


def test_aliased_in_out_storage_torch_snapshot_semantics():
    """Passing the SAME storage as a read and a written argument (the
    reference demo's in-place RK idiom) must not crash the torch backend
    (donation is disabled for aliased calls) and reads observe the
    PRE-CALL values (functional snapshot semantics)."""
    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript

    F = gtscript.Field[np.float64]

    def shiftadd(src: F, dst: F):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            dst = src[1, 0, 0] + 1.0

    st = gtscript.stencil(backend="torch", definition=shiftadd)
    buf = storage.from_array(np.arange(40.0).reshape(5, 4, 2), backend="torch", device="cpu")
    st(buf, buf, origin=(0, 0, 0), domain=(4, 4, 2))
    got = np.asarray(buf)
    orig = np.arange(40.0).reshape(5, 4, 2)
    np.testing.assert_array_equal(got[:4], orig[1:] + 1.0)
    np.testing.assert_array_equal(got[4], orig[4])  # outside domain
