"""1-D shallow-water equations on a staggered C-grid.

Counterpart of examples/shallow_water.py, showing field-view features
working together:
- staggered grids: height h on cell centers (I), velocity u on faces
  (IHalf), half-integer shifts moving between them,
- typed operators (Field[Dims[...], dtype] annotations -> definition-time
  type deduction),
validated against a hand-written NumPy reference. The operators run
embedded on every backend (the cartesian bridge takes no staggered
dimension and no ``domain=``), on card tensors where the fields live on
the card.

Run: python -m gt4py_tpu_torch.examples.shallow_water [backend]
"""

import sys

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.examples import field_device
from gt4py_tpu_torch.next import Dimension, Dims, Field, flip_staggered

I = Dimension("I")
IHalf = flip_staggered(I)

G = 9.81
DX = 1.0
DT = 0.02

FH = Field[Dims[I], np.float64]
FU = Field[Dims[IHalf], np.float64]


@gtx.field_operator
def update_u(u: FU, h: FH) -> FU:
    """Momentum: du/dt = -g dh/dx, the gradient landing on faces."""
    dhdx = (h(IHalf + 0.5) - h(IHalf - 0.5)) / DX
    return u - DT * G * dhdx


@gtx.field_operator
def update_h(h: FH, u: FU) -> FH:
    """Continuity: dh/dt = -H du/dx with H = 1 (linearized)."""
    dudx = (u(I + 0.5) - u(I - 0.5)) / DX
    return h - DT * dudx


def numpy_reference(h0: np.ndarray, u0: np.ndarray, steps: int):
    h, u = h0.copy(), u0.copy()
    for _ in range(steps):
        # u lives at i+1/2 between h[i] and h[i+1]; interior faces only.
        u_new = u.copy()
        u_new[1:-1] = u[1:-1] - DT * G * (h[1:] - h[:-1]) / DX
        h_new = h - DT * (u_new[1:] - u_new[:-1]) / DX
        u, h = u_new, h_new
    return h, u


def main(backend="cuda:hopper", device=None, n: int = 64, steps: int = 50):
    """``steps`` steps from a gaussian bump; returns (h, u) as NumPy arrays."""
    x = np.linspace(0, 2 * np.pi, n)
    h0 = 1.0 + 0.1 * np.exp(-((x - np.pi) ** 2))  # gaussian bump
    u0 = np.zeros(n + 1)
    dev = field_device(backend, device)
    step_u, step_h = update_u.with_backend(backend), update_h.with_backend(backend)

    # DSL state: h over I=(0..n), u over IHalf=(0..n+1). The momentum
    # update needs h on both sides of each interior face, so u's update
    # domain is the interior faces; boundaries stay fixed (walls).
    h = gtx.as_field([I], h0, device=dev)
    u = gtx.as_field([IHalf], u0, device=dev)
    h_new = gtx.zeros({I: n}, device=dev)
    u_new = gtx.zeros({IHalf: n + 1}, device=dev)

    for _ in range(steps):
        # interior faces (1..n-1); walls u=0 at the ends
        step_u(u, h, out=u_new, domain={IHalf: (1, n)})
        step_h(h, u_new, out=h_new)
        u, u_new = u_new, u
        h, h_new = h_new, h

    h_ref, u_ref = numpy_reference(h0, u0, steps)
    err_h = np.abs(h.asnumpy() - h_ref).max()
    err_u = np.abs(u.asnumpy() - u_ref).max()
    print(f"after {steps} steps: max|h - ref| = {err_h:.3e}, max|u - ref| = {err_u:.3e}")
    assert err_h < 1e-12 and err_u < 1e-12
    print("shallow-water C-grid demo OK (mass:", float(h.asnumpy().sum()), ")")
    return h.asnumpy(), u.asnumpy()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
