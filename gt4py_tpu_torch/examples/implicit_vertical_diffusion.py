"""Implicit vertical diffusion — a column-physics example of the fused
scan-composition path.

Counterpart of examples/implicit_vertical_diffusion.py. The backward-Euler
step ``(I - dt L) q_new = q_old`` with a tridiagonal vertical Laplacian is
the canonical implicit column solve of atmospheric physics
parameterizations. Written in the field view as two scan operators
composed inside one field operator, it compiles to a SINGLE cartesian
stencil through the cartesian bridge, whose forward and backward sweeps
``cuda:hopper`` runs on its ``column`` kernel with the modified
coefficients in registers (next/cartesian_bridge.py).

Run: python -m gt4py_tpu_torch.examples.implicit_vertical_diffusion [backend]
"""

import sys

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.examples import field_device
from gt4py_tpu_torch.next import Dimension, DimensionKind, where

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)

DT, DZ2 = 0.1, 1.0  # the JAX example's time step and squared level spacing


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def thomas_forward(carry, a: float, b: float, c: float, d: float):
    """Modified-coefficient sweep: cp/dp stay in the carry (registers)."""
    cp_prev, dp_prev = carry
    denom = b - a * cp_prev
    return (c / denom, (d - a * dp_prev) / denom)


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def thomas_backward(x_kp1, cp: float, dp: float):
    return dp - cp * x_kp1


@gtx.field_operator(backend="cuda:hopper")
def diffuse_implicit(q, kappa, kidx, klast: int, dt: float, dz2: float):
    """One backward-Euler step of d q/dt = d/dz (kappa dq/dz).

    Interior rows: -r*kappa q_{k-1} + (1 + 2 r kappa) q_k - r*kappa q_{k+1}
    with r = dt/dz^2; zero-flux boundaries drop the out-of-domain stroke.
    """
    r = dt / dz2
    lower = where(kidx == 0, 0.0, -r * kappa)
    upper = where(kidx == klast, 0.0, -r * kappa)
    diag = 1.0 - lower - upper
    cp, dp = thomas_forward(lower, diag, upper, q)
    return thomas_backward(cp, dp)


def reference_solve(q, kappa, dt, dz2):
    """Dense NumPy oracle: assemble and solve each column's tridiagonal."""
    ni, nj, nk = q.shape
    r = dt / dz2
    out = np.empty_like(q)
    for i in range(ni):
        for j in range(nj):
            m = np.zeros((nk, nk))
            for k in range(nk):
                lo = 0.0 if k == 0 else -r * kappa[i, j, k]
                up = 0.0 if k == nk - 1 else -r * kappa[i, j, k]
                m[k, k] = 1.0 - lo - up
                if k > 0:
                    m[k, k - 1] = lo
                if k < nk - 1:
                    m[k, k + 1] = up
            out[i, j] = np.linalg.solve(m, q[i, j])
    return out


def make_inputs(shape, seed: int = 0):
    """(q0, kappa) as the JAX example makes them, from ``seed``."""
    rng = np.random.default_rng(seed)
    q0 = rng.random(shape)
    kappa = 0.5 + 0.5 * rng.random(shape)
    return q0, kappa


def solve(backend="cuda:hopper", device=None, shape=(16, 16, 24), stencils=None):
    """One implicit step from :func:`make_inputs`; returns (the result as a
    NumPy array, the operator that ran, the strategy the bridge's last call
    ran or "embedded"). ``stencils``: an operator of ``diffuse_implicit``
    to reuse."""
    ni, nj, nk = shape
    q0, kappa = make_inputs(shape)
    op = stencils or diffuse_implicit.with_backend(backend)
    dev = field_device(backend, device)

    q = gtx.as_field([IDim, JDim, KDim], q0, device=dev)
    kf = gtx.as_field([IDim, JDim, KDim], kappa, device=dev)
    kidx = gtx.as_field([KDim], np.arange(nk, dtype=np.int32), device=dev)
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk}, device=dev)

    op(q, kf, kidx, nk - 1, DT, DZ2, out=out)

    result = out.asnumpy()
    var = next(
        (v for v in getattr(op, "_bridge_cache", {}).values() if v is not None), None
    )
    strategy = getattr(var.backend, "last_strategy", None) if var else "embedded"
    return result, op, strategy


def main(backend="cuda:hopper", device=None, shape=(16, 16, 24), stencils=None):
    """:func:`solve`, held against :func:`reference_solve` (a dense solve
    per column: meant for small sizes); returns what :func:`solve` does."""
    result, op, strategy = solve(backend, device, shape, stencils)
    expected = reference_solve(*make_inputs(shape), DT, DZ2)
    err = float(np.abs(result - expected).max())
    print(f"implicit vertical diffusion: max |err| = {err:.2e} (bridge strategy: {strategy})")
    assert err < 1e-10
    return result, op, strategy


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
