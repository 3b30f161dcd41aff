"""Tridiagonal solve with FORWARD/BACKWARD computations (Thomas algorithm).

Counterpart of examples/tridiagonal_solver.py: the canonical sequential-K
workload, which ``cuda:hopper`` serves with its ``column`` kernel (one
thread a column walking K, the recurrence in registers).

Run: python -m gt4py_tpu_torch.examples.tridiagonal_solver [backend]
"""

import sys

import numpy as np

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import BACKWARD, FORWARD, computation, interval

Field3D = gtscript.Field[np.float32]


def tridiagonal_solver(
    inf: Field3D, diag: Field3D, sup: Field3D, rhs: Field3D, out: Field3D
):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def make_stencils(backend: str = "cuda:hopper"):
    """The solver built for ``backend`` (float32 literals, as the JAX
    example's ``literal_float_precision=32``)."""
    return gtscript.stencil(
        backend=backend, definition=tridiagonal_solver, literal_float_precision=32
    )


def main(backend: str = "cuda:hopper", device=None, shape=(64, 64, 48), stencils=None):
    """Solve the system whose solution is x == 1; returns the solution as a
    NumPy array. ``stencils``: the solver of :func:`make_stencils` to reuse."""
    solver = stencils or make_stencils(backend)
    extra = {} if device is None else {"device": device}
    # System with known solution x == 1: rhs = row sums of [-1, 3, 1].
    inf = storage.full(shape, -1.0, np.float32, backend=backend, **extra)
    diag = storage.full(shape, 3.0, np.float32, backend=backend, **extra)
    sup = storage.full(shape, 1.0, np.float32, backend=backend, **extra)
    rhs_np = np.full(shape, 3.0, dtype=np.float32)
    rhs_np[:, :, 0] = 4.0   # first row: 3 + 1
    rhs_np[:, :, -1] = 2.0  # last row: -1 + 3
    rhs = storage.from_array(rhs_np, np.float32, backend=backend, **extra)
    out = storage.zeros(shape, np.float32, backend=backend, **extra)

    solver(inf, diag, sup, rhs, out)
    result = np.asarray(out)
    print("max |x - 1| =", np.abs(result - 1.0).max())
    assert np.allclose(result, 1.0, atol=1e-5)
    print("OK")
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
