"""tests/cartesian_tests/test_isentropic.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Isentropic diagnostics model family (reference
demo_isentropic_diagnostics): FORWARD pressure + PARALLEL Exner +
BACKWARD Montgomery/height in one stencil, vs a NumPy oracle."""


import numpy as np
import pytest

from gt4py_tpu_torch.examples.isentropic_diagnostics import run


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda:hopper"])
def test_isentropic_diagnostics_match_oracle(backend):
    errs, _ = run(backend=backend, nx=10, ny=18, nz=16, verbose=False, device="cpu")
    for name, err in errs.items():
        assert err < 1e-10, (name, err)


def test_isentropic_mountain_shapes_height_field():
    _, stor = run(backend="torch", nx=16, ny=16, nz=12, verbose=False, device="cpu")
    h = np.asarray(stor["h"])
    # the bell-shaped mountain lifts the bottom isentrope at the center
    assert h[8, 8, -1] > h[0, 0, -1]
    # heights decrease monotonically downward through the column
    assert np.all(np.diff(h[8, 8, :]) <= 0.0)
