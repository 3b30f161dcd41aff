"""2-D viscous Burgers equations with an RK3 time stepper.

Counterpart of examples/burgers.py: 6th-order upwind-biased advection +
4th-order centered diffusion, validated against the Zhao analytic
solution. Exercises ``@gtscript.function`` composition (multi-value
returns, externals), wide (±3) horizontal offsets, per-call origin/domain,
and ``Storage.array`` reassignment (the boundary frame is written on the
host and assigned back every sub-step; a card storage takes it in place).
On ``cuda:hopper`` both stencils run on the ``plane`` kernel.

Run: python -m gt4py_tpu_torch.examples.burgers [backend]
"""

import sys
import time

import numpy as np

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript

MU = 0.1  # diffusion coefficient

Field = gtscript.Field[np.float64]


@gtscript.function
def upwind_adv_x(dx, vel, phi):
    """6th-order upwind-biased advective derivative along I."""
    a = vel[0, 0, 0] >= 0.0
    mag = vel[0, 0, 0] * (2.0 * a - 1.0)  # |vel| without abs()
    centered = (
        45.0 * (phi[1, 0, 0] - phi[-1, 0, 0])
        - 9.0 * (phi[2, 0, 0] - phi[-2, 0, 0])
        + (phi[3, 0, 0] - phi[-3, 0, 0])
    )
    biased = (
        (phi[3, 0, 0] + phi[-3, 0, 0])
        - 6.0 * (phi[2, 0, 0] + phi[-2, 0, 0])
        + 15.0 * (phi[1, 0, 0] + phi[-1, 0, 0])
        - 20.0 * phi[0, 0, 0]
    )
    return (vel[0, 0, 0] * centered - mag * biased) / (60.0 * dx)


@gtscript.function
def upwind_adv_y(dy, vel, phi):
    a = vel[0, 0, 0] >= 0.0
    mag = vel[0, 0, 0] * (2.0 * a - 1.0)
    centered = (
        45.0 * (phi[0, 1, 0] - phi[0, -1, 0])
        - 9.0 * (phi[0, 2, 0] - phi[0, -2, 0])
        + (phi[0, 3, 0] - phi[0, -3, 0])
    )
    biased = (
        (phi[0, 3, 0] + phi[0, -3, 0])
        - 6.0 * (phi[0, 2, 0] + phi[0, -2, 0])
        + 15.0 * (phi[0, 1, 0] + phi[0, -1, 0])
        - 20.0 * phi[0, 0, 0]
    )
    return (vel[0, 0, 0] * centered - mag * biased) / (60.0 * dy)


@gtscript.function
def lap4_x(dx, phi):
    """4th-order centered second derivative along I."""
    return (
        -phi[-2, 0, 0]
        + 16.0 * phi[-1, 0, 0]
        - 30.0 * phi[0, 0, 0]
        + 16.0 * phi[1, 0, 0]
        - phi[2, 0, 0]
    ) / (12.0 * dx * dx)


@gtscript.function
def lap4_y(dy, phi):
    return (
        -phi[0, -2, 0]
        + 16.0 * phi[0, -1, 0]
        - 30.0 * phi[0, 0, 0]
        + 16.0 * phi[0, 1, 0]
        - phi[0, 2, 0]
    ) / (12.0 * dy * dy)


@gtscript.function
def burgers_rhs(dx, dy, mu, u, v, phi):
    """Right-hand side for one transported quantity."""
    adv = upwind_adv_x(dx=dx, vel=u, phi=phi) + upwind_adv_y(dy=dy, vel=v, phi=phi)
    diff = lap4_x(dx=dx, phi=phi) + lap4_y(dy=dy, phi=phi)
    return -adv + mu * diff


def make_stencils(backend: str = "cuda:hopper"):
    externals = {
        "upwind_adv_x": upwind_adv_x,
        "upwind_adv_y": upwind_adv_y,
        "lap4_x": lap4_x,
        "lap4_y": lap4_y,
        "burgers_rhs": burgers_rhs,
    }

    @gtscript.stencil(backend=backend, externals=externals)
    def rk_stage(
        u_now: Field,
        v_now: Field,
        u_tmp: Field,
        v_tmp: Field,
        u_out: Field,
        v_out: Field,
        *,
        dt: float,
        dx: float,
        dy: float,
        mu: float,
    ):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            u_out = u_now[0, 0, 0] + dt * burgers_rhs(
                dx=dx, dy=dy, mu=mu, u=u_tmp, v=v_tmp, phi=u_tmp
            )
            v_out = v_now[0, 0, 0] + dt * burgers_rhs(
                dx=dx, dy=dy, mu=mu, u=u_tmp, v=v_tmp, phi=v_tmp
            )

    @gtscript.stencil(backend=backend)
    def copy2(src_u: Field, src_v: Field, dst_u: Field, dst_v: Field):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            dst_u = src_u[0, 0, 0]
            dst_v = src_v[0, 0, 0]

    return rk_stage, copy2


def zhao_solution(t, x, y):
    """Analytic (Zhao) solution of the 2-D viscous Burgers system."""
    x2 = x[:, None, None]
    y2 = y[None, :, None]
    damp = np.exp(-5.0 * np.pi**2 * MU * t)
    den = 2.0 + damp * np.sin(2.0 * np.pi * x2) * np.sin(np.pi * y2)
    u = -4.0 * MU * np.pi * damp * np.cos(2.0 * np.pi * x2) * np.sin(np.pi * y2) / den
    v = -2.0 * MU * np.pi * damp * np.sin(2.0 * np.pi * x2) * np.cos(np.pi * y2) / den
    return u, v


def run(
    backend: str = "cuda:hopper",
    factor: int = 0,
    niter: int = 100,
    verbose: bool = True,
    device=None,
    stencils=None,
):
    """``niter`` RK3 steps on an (n, n, 1) grid, n = 10 * 2**factor + 1;
    returns (||u - u_zhao||, ||v - v_zhao||, u, v). ``stencils``: the pair
    of :func:`make_stencils` to reuse."""
    nx = ny = 10 * 2**factor + 1
    halo = 3
    dx = dy = 1.0 / (nx - 1)
    dt = 1.0 / (nx - 1) ** 2
    x = np.linspace(0.0, 1.0, nx)
    y = np.linspace(0.0, 1.0, ny)

    rk_stage, copy2 = stencils or make_stencils(backend)
    extra = {} if device is None else {"device": device}

    u0, v0 = zhao_solution(0.0, x, y)
    u_new = storage.from_array(u0, backend=backend, **extra)
    v_new = storage.from_array(v0, backend=backend, **extra)
    u_now = storage.zeros((nx, ny, 1), backend=backend, **extra)
    v_now = storage.zeros((nx, ny, 1), backend=backend, **extra)
    u_stage = storage.from_array(u0, backend=backend, **extra)
    v_stage = storage.from_array(v0, backend=backend, **extra)

    def apply_bc(t, u, v):
        """Dirichlet frame from the analytic solution (3-wide)."""
        ue, ve = zhao_solution(t, x, y)
        ub = np.array(np.asarray(u), copy=True)
        vb = np.array(np.asarray(v), copy=True)
        for sl in (slice(0, halo), slice(nx - halo, nx)):
            ub[sl, :] = ue[sl, :]
            vb[sl, :] = ve[sl, :]
            ub[:, sl] = ue[:, sl]
            vb[:, sl] = ve[:, sl]
        u.array = ub
        v.array = vb

    rk_fraction = (1.0 / 3.0, 0.5, 1.0)
    t = 0.0
    t0 = time.time()
    for i in range(niter):
        copy2(u_new, v_new, u_now, v_now, origin=(0, 0, 0), domain=(nx, ny, 1))
        for frac in rk_fraction:
            ddt = frac * dt
            # Stage buffers swap with the state each sub-step (clean RK:
            # every read sees the previous stage, no in-call aliasing).
            rk_stage(
                u_now, v_now, u_new, v_new, u_stage, v_stage,
                dt=ddt, dx=dx, dy=dy, mu=MU,
                origin=(halo, halo, 0), domain=(nx - 2 * halo, ny - 2 * halo, 1),
            )
            apply_bc(t + ddt, u_stage, v_stage)
            u_new, u_stage = u_stage, u_new
            v_new, v_stage = v_stage, v_new
        t += dt
    elapsed = time.time() - t0

    ue, ve = zhao_solution(t, x, y)
    sl = slice(halo, -halo)
    err_u = np.linalg.norm(np.asarray(u_new)[sl, sl] - ue[sl, sl]) * np.sqrt(dx * dy)
    err_v = np.linalg.norm(np.asarray(v_new)[sl, sl] - ve[sl, sl]) * np.sqrt(dx * dy)
    if verbose:
        print(
            f"backend={backend} n={nx} iters={niter}: "
            f"||u-uex||={err_u:.3e} ||v-vex||={err_v:.3e} ({elapsed:.2f}s)"
        )
    return err_u, err_v, np.asarray(u_new), np.asarray(v_new)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
