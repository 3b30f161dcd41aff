"""tests/cartesian_tests/test_power_unroll.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

GTIR power unrolling (reference power_unrolling.py analog for the
cartesian pipeline): small integral exponents become multiplications —
the Pallas kernels then avoid the transcendental pow path."""

import numpy as np

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtir_pretty import pretty
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

F = gtscript.Field[np.float64]


def test_small_int_powers_unroll():
    def powers(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a**4 + a**2 + a**1 + a**0

    st = gtscript.stencil(backend="torch", definition=powers)
    text = pretty(st._analyzed.stencil)
    assert "**" not in text

    a = storage.from_array(np.linspace(0.5, 2.0, 24).reshape(4, 3, 2), backend="torch", device="cpu")
    out = storage.zeros((4, 3, 2), backend="torch", device="cpu")
    st(a=a, out=out)
    x = np.asarray(a)
    np.testing.assert_allclose(np.asarray(out), x**4 + x**2 + x + 1.0, rtol=1e-14)


def test_fractional_power_stays():
    def frac(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a**1.5

    st = gtscript.stencil(backend="torch", definition=frac)
    text = pretty(st._analyzed.stencil)
    assert "**" in text or "pow" in text

    a = storage.from_array(np.linspace(0.5, 2.0, 24).reshape(4, 3, 2), backend="torch", device="cpu")
    out = storage.zeros((4, 3, 2), backend="torch", device="cpu")
    st(a=a, out=out)
    np.testing.assert_allclose(np.asarray(out), np.asarray(a) ** 1.5, rtol=1e-14)


def test_unrolled_power_on_cuda_hopper():
    """The reference's test_unrolled_power_on_pallas_interpret, on the
    plane kernel's plain version (CPU tensors)."""

    def cube(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = (a + 1.0) ** 3

    st = gtscript.stencil(backend="cuda:hopper", definition=cube)
    a = storage.from_array(np.linspace(0.0, 1.0, 8 * 16 * 4).reshape(8, 16, 4),
                           backend="cuda:hopper", device="cpu")
    out = storage.zeros((8, 16, 4), backend="cuda:hopper", device="cpu")
    st(a=a, out=out)
    np.testing.assert_allclose(np.asarray(out), (np.asarray(a) + 1.0) ** 3, rtol=1e-6)
