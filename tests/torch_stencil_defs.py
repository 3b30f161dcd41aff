"""Stencil definitions and NumPy oracles for the port's tests and chip_smoke.py.

Copied from tests/cartesian_tests/stencil_defs.py — hdiff, vadv and tridiag
at :111-310 and every stencil of its registry (:408-805) — with the
annotations resolved against ``gt4py_tpu_torch``'s gtscript. This module
imports no JAX, so it also serves on a machine without it. The
``*_generic`` variants take their dtype from the ``dtypes={"dt": ...}``
build option, for float32 runs; the generic hdiff is bench.py's ``hdiff32``
(float literals, so that with ``literal_float_precision=32`` it computes in
float32 throughout); ``tridiagonal_solver_temporaries``, ``copy_generic`` and
``laplacian_generic`` are bench.py's ``tri32``, ``copy48`` and ``lap48``, the
stencils of bench_torch.py's rows. Two full-width dycore-style stencils of the port's own,
``hdiff_sponge`` and ``smoothed_column_sum``, and three column walks at the
edges of the column kernels' prefetch ring and registers
(``read_ahead_sweep``, ``restarted_temporary``, ``narrow_offset_read``)
complete the registry; their JAX twins live in tests/test_torch_cartesian.py.
"""

import numpy as np

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.core.definitions import bfloat16
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    I,
    J,
    K,
    __INLINED,
    ceil,
    computation,
    cos,
    exp,
    floor,
    horizontal,
    interval,
    log,
    region,
    sin,
    sqrt,
)

Field3D = gtscript.Field[np.float64]
Field2D = gtscript.Field[gtscript.IJ, np.float64]
FieldI64 = gtscript.Field[np.int64]
FieldVec3 = gtscript.Field[(np.float64, (3,))]
FieldMat33 = gtscript.Field[(np.float64, (3, 3))]
FieldK = gtscript.Field[gtscript.K, np.float64]
Table4 = gtscript.GlobalTable[(np.float64, (4,))]
Table22 = gtscript.GlobalTable[(np.float64, (2, 2))]
FieldBool = gtscript.Field[np.bool_]
FieldF32 = gtscript.Field[np.float32]
FieldI32 = gtscript.Field[np.int32]
FieldI8 = gtscript.Field[np.int8]


def copy_stencil(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_b = field_a[0, 0, 0]


def horizontal_diffusion(in_field: Field3D, out_field: Field3D, coeff: Field3D):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


def validate_horizontal_diffusion(in_field, coeff):
    """NumPy oracle for hdiff over the interior [2:-2, 2:-2]."""
    lap = 4.0 * in_field[1:-1, 1:-1] - (
        in_field[2:, 1:-1] + in_field[:-2, 1:-1] + in_field[1:-1, 2:] + in_field[1:-1, :-2]
    )
    res1 = lap[1:, 1:-1] - lap[:-1, 1:-1]
    flx = np.where(res1 * (in_field[2:-1, 2:-2] - in_field[1:-2, 2:-2]) > 0, 0.0, res1)
    res2 = lap[1:-1, 1:] - lap[1:-1, :-1]
    fly = np.where(res2 * (in_field[2:-2, 2:-1] - in_field[2:-2, 1:-2]) > 0, 0.0, res2)
    return in_field[2:-2, 2:-2] - coeff[2:-2, 2:-2] * (
        flx[1:, :] - flx[:-1, :] + fly[:, 1:] - fly[:, :-1]
    )


def tridiagonal_solver(inf: Field3D, diag: Field3D, sup: Field3D, rhs: Field3D, out: Field3D):
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


def validate_tridiagonal_solver(inf, diag, sup, rhs):
    """Thomas algorithm column-by-column (oracle)."""
    ni, nj, nk = inf.shape
    out = np.zeros_like(rhs)
    for i in range(ni):
        for j in range(nj):
            a, b, c, d = inf[i, j], diag[i, j].copy(), sup[i, j].copy(), rhs[i, j].copy()
            c[0] = c[0] / b[0]
            d[0] = d[0] / b[0]
            for k in range(1, nk):
                m = b[k] - c[k - 1] * a[k]
                c[k] = c[k] / m
                d[k] = (d[k] - a[k] * d[k - 1]) / m
            out[i, j, nk - 1] = d[nk - 1]
            for k in range(nk - 2, -1, -1):
                out[i, j, k] = d[k] - c[k] * out[i, j, k + 1]
    return out


def vertical_advection_dycore(
    utens_stage: Field3D,
    u_stage: Field3D,
    wcon: Field3D,
    u_pos: Field3D,
    utens: Field3D,
    *,
    dtr_stage: float,
):
    from __externals__ import BET_M, BET_P

    with computation(FORWARD):
        with interval(0, 1):
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
            cs = gcv * BET_M

            ccol = gcv * BET_P
            bcol = dtr_stage - ccol[0, 0, 0]

            correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / bcol[0, 0, 0]
            ccol = ccol[0, 0, 0] * divided
            dcol = dcol[0, 0, 0] * divided

        with interval(1, -1):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])

            as_ = gav * BET_M
            cs = gcv * BET_M

            acol = gav * BET_P
            ccol = gcv * BET_P
            bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                u_stage[0, 0, 1] - u_stage[0, 0, 0]
            )
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            ccol = ccol[0, 0, 0] * divided
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with interval(-1, None):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

    with computation(BACKWARD):
        with interval(-1, None):
            datacol = dcol[0, 0, 0]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

        with interval(0, -1):
            datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])


VADV_EXTERNALS = {"BET_M": 0.5, "BET_P": 0.5}


def validate_vertical_advection_dycore(utens_stage, u_stage, wcon, u_pos, utens, dtr_stage):
    """NumPy column-wise oracle for the vadv Thomas solve (domain excludes
    the last I row: wcon is read at [1, 0, *])."""
    BET_M, BET_P = 0.5, 0.5
    ni, nj, nk = u_stage.shape
    ni_d = ni - 1
    out = utens_stage.copy()
    for i in range(ni_d):
        for j in range(nj):
            ccol = np.zeros(nk)
            dcol = np.zeros(nk)
            # k = 0
            gcv = 0.25 * (wcon[i + 1, j, 1] + wcon[i, j, 1])
            cs = gcv * BET_M
            ccol[0] = gcv * BET_P
            bcol = dtr_stage - ccol[0]
            corr = -cs * (u_stage[i, j, 1] - u_stage[i, j, 0])
            dcol[0] = (
                dtr_stage * u_pos[i, j, 0] + utens[i, j, 0] + utens_stage[i, j, 0] + corr
            )
            divided = 1.0 / bcol
            ccol[0] *= divided
            dcol[0] *= divided
            # interior
            for k in range(1, nk - 1):
                gav = -0.25 * (wcon[i + 1, j, k] + wcon[i, j, k])
                gcv = 0.25 * (wcon[i + 1, j, k + 1] + wcon[i, j, k + 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol[k] = gcv * BET_P
                bcol = dtr_stage - acol - ccol[k]
                corr = -as_ * (u_stage[i, j, k - 1] - u_stage[i, j, k]) - cs * (
                    u_stage[i, j, k + 1] - u_stage[i, j, k]
                )
                dcol[k] = (
                    dtr_stage * u_pos[i, j, k] + utens[i, j, k] + utens_stage[i, j, k] + corr
                )
                divided = 1.0 / (bcol - ccol[k - 1] * acol)
                ccol[k] *= divided
                dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided
            # k = nk-1
            k = nk - 1
            gav = -0.25 * (wcon[i + 1, j, k] + wcon[i, j, k])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol
            corr = -as_ * (u_stage[i, j, k - 1] - u_stage[i, j, k])
            dcol[k] = (
                dtr_stage * u_pos[i, j, k] + utens[i, j, k] + utens_stage[i, j, k] + corr
            )
            divided = 1.0 / (bcol - ccol[k - 1] * acol)
            dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided
            # backward
            datacol = dcol[nk - 1]
            out[i, j, nk - 1] = dtr_stage * (datacol - u_pos[i, j, nk - 1])
            for k in range(nk - 2, -1, -1):
                datacol = dcol[k] - ccol[k] * datacol
                out[i, j, k] = dtr_stage * (datacol - u_pos[i, j, k])
    return out[:ni_d]


def vertical_advection_dycore_generic(
    utens_stage: "gtscript.Field['vadv_dt']",
    u_stage: "gtscript.Field['vadv_dt']",
    wcon: "gtscript.Field['vadv_dt']",
    u_pos: "gtscript.Field['vadv_dt']",
    utens: "gtscript.Field['vadv_dt']",
    *,
    dtr_stage: "vadv_dt",
):
    from __externals__ import BET_M, BET_P

    with computation(FORWARD):
        with interval(0, 1):
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
            cs = gcv * BET_M

            ccol = gcv * BET_P
            bcol = dtr_stage - ccol[0, 0, 0]

            correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / bcol[0, 0, 0]
            ccol = ccol[0, 0, 0] * divided
            dcol = dcol[0, 0, 0] * divided

        with interval(1, -1):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])

            as_ = gav * BET_M
            cs = gcv * BET_M

            acol = gav * BET_P
            ccol = gcv * BET_P
            bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                u_stage[0, 0, 1] - u_stage[0, 0, 0]
            )
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            ccol = ccol[0, 0, 0] * divided
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with interval(-1, None):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

    with computation(BACKWARD):
        with interval(-1, None):
            datacol = dcol[0, 0, 0]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

        with interval(0, -1):
            datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])


def lap_of_lap(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0] - 4.0 * inp
        out = lap[1, 0, 0] + lap[-1, 0, 0] + lap[0, 1, 0] + lap[0, -1, 0] - 4.0 * lap


def native_function_zoo(a: Field3D, b: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = (
            sin(a) + cos(b) + exp(-abs(a)) + log(1.0 + abs(b))
            + min(a, b) + max(a, b) + floor(a) + ceil(b) + sqrt(abs(a) + 1.0)
        )


def ternary_and_masks(a: Field3D, b: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        tmp = a if a > b else b
        if tmp > 0.5:
            out = tmp * 2.0
        else:
            out = tmp - b


def region_interaction(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = inp
        with horizontal(region[I[0]:I[2], :]):
            out = inp * 10.0
        with horizontal(region[:, J[-1]]):
            out = 0.0
        with horizontal(region[I[-1], J[0]]):
            out = -1.0


def param_multibranch(src: Field3D, dst: Field3D, c: float):
    """Scalar-parameter if/elif/else (reference multibranch_param_conditional)."""
    with computation(PARALLEL), interval(...):
        if c > 0.0:
            dst = src + src[1, 0, 0]
        elif c < -1.0:
            dst = src - src[1, 0, 0]
        else:
            dst = src


def iteration_index_parallel(inp: Field3D, out: Field3D):
    """Current-K iterator access in PARALLEL context, in values and in
    branch conditions (reference gtc/gtir.py:68 IteratorAccess)."""
    with computation(PARALLEL), interval(...):
        if K >= 1:
            out = inp + K
        else:
            out = inp - K


def forward_cumsum(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp


def backward_cumsum(inp: Field3D, out: Field3D):
    with computation(BACKWARD):
        with interval(-1, None):
            out = inp
        with interval(0, -1):
            out = out[0, 0, 1] + inp


def multi_section_forward(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 2):
            out = inp * 2.0
        with interval(2, -2):
            out = out[0, 0, -1] + inp
        with interval(-2, None):
            out = out[0, 0, -1] * 0.5


def heat_step(t: Field3D, out: Field3D, dt: float):
    """Explicit heat equation step with a vertical implicit-ish smoothing
    pass (PARALLEL laplacian + FORWARD/BACKWARD relaxations)."""
    with computation(PARALLEL), interval(...):
        lap = (
            t[1, 0, 0] + t[-1, 0, 0] + t[0, 1, 0] + t[0, -1, 0] - 4.0 * t
        )
        out = t + dt * lap
    with computation(FORWARD), interval(1, None):
        out = 0.75 * out + 0.25 * out[0, 0, -1]
    with computation(BACKWARD), interval(0, -1):
        out = 0.75 * out + 0.25 * out[0, 0, 1]


def staggeredish_interval_chain(inp: Field3D, out: Field3D):
    """Multi-computation chain alternating PARALLEL and BACKWARD with
    K-boundary intervals (dycore wind-solver shape)."""
    with computation(PARALLEL), interval(...):
        out = 0.5 * inp
    with computation(BACKWARD):
        with interval(-1, None):
            out = out + inp
        with interval(0, -1):
            out = out + 0.25 * out[0, 0, 1]


def iteration_index_sequential(inp: Field3D, out: Field3D):
    """K-dependent coefficient inside a FORWARD carry chain (the
    level-weighted cumulative-sum pattern of K-dependent physics)."""
    with computation(FORWARD):
        with interval(0, 1):
            out = inp * (K + 1)
        with interval(1, None):
            out = out[0, 0, -1] + inp * (K + 1)


def dycore_smagorinsky_like(u: Field3D, v: Field3D, out_u: Field3D, cs: float):
    """PARALLEL shear computation + FORWARD column damping (multi-loop
    dycore shape: horizontal stage feeding a sequential stage)."""
    with computation(PARALLEL), interval(...):
        shear = (u[0, 1, 0] - u[0, -1, 0]) * 0.5 + (v[1, 0, 0] - v[-1, 0, 0]) * 0.5
        tension = (u[1, 0, 0] - u[-1, 0, 0]) * 0.5 - (v[0, 1, 0] - v[0, -1, 0]) * 0.5
        smag = cs * sqrt(shear * shear + tension * tension)
    with computation(FORWARD):
        with interval(0, 1):
            out_u = u + smag
        with interval(1, None):
            out_u = u + smag + 0.1 * out_u[0, 0, -1]


def shift_all_directions(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(1, -1):
        out = (
            inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
            + inp[0, 0, 1] + inp[0, 0, -1]
        )


def horizontal_diffusion_generic(
    in_field: "gtscript.Field['dt']",
    out_field: "gtscript.Field['dt']",
    coeff: "gtscript.Field['dt']",
):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0.0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0.0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


def tridiagonal_solver_generic(
    inf: "gtscript.Field['dt']",
    diag: "gtscript.Field['dt']",
    sup: "gtscript.Field['dt']",
    rhs: "gtscript.Field['dt']",
    out: "gtscript.Field['dt']",
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


def tridiagonal_solver_temporaries(
    inf: "gtscript.Field['dt']",
    diag: "gtscript.Field['dt']",
    sup: "gtscript.Field['dt']",
    rhs: "gtscript.Field['dt']",
    out: "gtscript.Field['dt']",
):
    """bench.py's ``tri32`` (bench.py:462-479): the Thomas algorithm with the
    modified coefficients in temporaries, so that it reads four fields and
    writes one."""
    with computation(FORWARD):
        with interval(0, 1):
            cp = sup / diag
            dp = rhs / diag
        with interval(1, None):
            cp = sup / (diag - cp[0, 0, -1] * inf)
            dp = (rhs - inf * dp[0, 0, -1]) / (diag - cp[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = dp
        with interval(0, -1):
            out = dp - cp * out[0, 0, 1]


def copy_generic(src: "gtscript.Field['dt']", dst: "gtscript.Field['dt']"):
    """bench.py's ``copy48`` (bench.py:1580-1582)."""
    with computation(PARALLEL), interval(...):
        dst = src[0, 0, 0]


def laplacian_generic(src: "gtscript.Field['dt']", dst: "gtscript.Field['dt']"):
    """bench.py's ``lap48`` (bench.py:1584-1588)."""
    with computation(PARALLEL), interval(...):
        dst = -4.0 * src[0, 0, 0] + (src[1, 0, 0] + src[-1, 0, 0] + src[0, 1, 0] + src[0, -1, 0])


# --- the rest of the registry of tests/cartesian_tests/stencil_defs.py ----------


def arithmetic_ops(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_a = (((((field_b + 42.0) - 42.0) * +42.0) / -42.0) % 42.0) ** 2


@gtscript.function
def _fn_sqrt_abs(b):
    return sqrt(abs(b[0, 0, 0]))


def function_call(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_b = _fn_sqrt_abs(field_a) + 1.0


def temporary_stencil(field_a: Field3D, field_b: Field2D, scalar_in: float):
    with computation(PARALLEL), interval(...):
        tmp = field_a * scalar_in

    with computation(FORWARD), interval(0, 1):
        field_b += tmp


def runtime_if(field_a: Field3D, field_b: Field3D):
    with computation(BACKWARD), interval(...):
        if field_a > 0.0:
            field_b = -1
            field_a = -field_a
        else:
            field_b = 1
            field_a = field_a


def while_stencil(field_a: Field3D, field_b: Field3D):
    with computation(BACKWARD), interval(...):
        while field_a > 2.0:
            field_b = -1
            field_a = -field_b


def large_k_interval(in_field: Field3D, out_field: Field3D):
    with computation(PARALLEL):
        with interval(0, 6):
            out_field = in_field
        with interval(6, -10):
            out_field = in_field + 1
        with interval(-10, None):
            out_field = in_field


def compile_time_if(inp: Field3D, out: Field3D):
    from __externals__ import USE_FAST, WEIGHT

    with computation(PARALLEL), interval(...):
        if __INLINED(USE_FAST):
            out = inp * WEIGHT
        else:
            out = inp * 0.125


def variable_k_shift(a: Field3D, idx: FieldI64, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a[0, 0, idx]


def absolute_k_reference(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a - a.at(K=0)


def table_lookup(idx: FieldI64, out: Field3D, table: Table4):
    with computation(PARALLEL), interval(...):
        out = table[idx]


def table_lookup_2d(i0: FieldI64, i1: FieldI64, out: Field3D, table: Table22):
    with computation(PARALLEL), interval(...):
        out = table[i0, i1]


def vector_axpy(x: FieldVec3, y: FieldVec3, out: FieldVec3, alpha: float):
    with computation(PARALLEL), interval(...):
        out = x * alpha + y


def matvec_product(mat: FieldMat33, vec: FieldVec3, out: FieldVec3):
    with computation(PARALLEL), interval(...):
        out = mat @ vec


def component_extract(vec: FieldVec3, sel: FieldI64, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][sel]


def k_profile_scale(inp: Field3D, prof: FieldK, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = inp * prof


def newton_sqrt_while(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        guess = a * 0.5 + 0.5
        err = guess * guess - a
        while (err > 1e-10) or (err < -1e-10):
            guess = 0.5 * (guess + a / guess)
            err = guess * guess - a
        out = guess


def dtype_zoo(
    flag: FieldBool,
    tiny: FieldI8,
    idx32: FieldI32,
    big: FieldI64,
    f32: FieldF32,
    f64: Field3D,
):
    """Literal assignment across the dtype spectrum (reference data_types
    class: per-dtype fields written with in-range literals)."""
    with computation(PARALLEL), interval(...):
        flag = True
        tiny = 101
        idx32 = 1000000007
        big = 123456789012345
        f32 = 0.8125
        f64 = 0.333251953125


def land_mask(height: Field3D, mask: FieldBool):
    """Boolean field computed from a comparison (reference form_land_mask)."""
    with computation(PARALLEL), interval(...):
        mask = height >= 0.5


def bool_elif_koffset(base: Field3D, marker: FieldBool, hi: Field3D, lo: Field3D):
    """Bool-field elif chain with K-offset reads of the condition field
    (reference set_inner_as_kord class)."""
    with computation(PARALLEL), interval(1, -1):
        gap = 0.0
        if marker and marker[0, 0, -1]:
            hi = base
        elif marker and marker[0, 0, 1]:
            lo = base
        else:
            gap = hi - lo
            hi = hi + 0.125 * gap


def nested_conditional_locals(src: Field3D, dst: Field3D):
    """Local scalars declared inside nested conditionals, different
    computations re-declaring the same local (reference
    local_var_inside_nested_conditional class)."""
    with computation(PARALLEL), interval(0, 2):
        fallback = 2.0
        if src[0, 0, 0] > 0.3:
            bump = 4.0
            if bump + src < dst:
                fallback = 3.0
            else:
                fallback = 4.0
            dst = bump + fallback
    with computation(FORWARD), interval(2, None):
        if src[0, 0, 0] < 0.3:
            bump = 6.0
            dst = bump


def empty_computation_inlined(src: Field3D, dst: Field3D):
    """A computation emptied by __INLINED(False) must still compile
    (reference allow_empty_computation)."""
    from __externals__ import EXTRA_SMOOTH

    with computation(FORWARD), interval(...):
        dst = src
    with computation(PARALLEL), interval(...):
        if __INLINED(EXTRA_SMOOTH):
            dst = abs(src)


def single_level_offset(src: Field3D, dst: Field3D):
    """Single-level interval with a horizontal offset read (reference
    single_level_with_offset)."""
    with computation(PARALLEL), interval(1, 2):
        dst = 0.5 * (src[1, 0, 0] + src[-1, 0, 0])


def region_conditional(src: Field3D, dst: Field3D):
    """Runtime conditional inside horizontal regions (reference
    horizontal_region_with_conditional)."""
    with computation(PARALLEL), interval(...):
        dst = src
        with horizontal(region[I[0]:I[2], :], region[I[-2]:I[-1] + 1, :]):
            if src > 0.4:
                dst = src + 1.0
            else:
                dst = 0.0


def region_in_sequential(inp: Field3D, out: Field3D):
    """Horizontal region restriction inside a FORWARD loop (feature
    interaction: per-column carry + edge specialization)."""
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp
            with horizontal(region[I[0], :]):
                out = 0.0


def optional_tendency(
    in_field: Field3D,
    out_field: Field3D,
    dyn_tend: Field3D,
    phys_tend: Field3D = None,
    *,
    dt: float,
):
    """Optional-field pattern (reference optional_field): the phys_tend
    parameter may be omitted entirely when __INLINED(PHYS_TEND) prunes its
    use (covered in test_features); registered here with the field live so
    every backend executes the two-tendency update."""
    from __externals__ import PHYS_TEND

    with computation(PARALLEL), interval(...):
        out_field = in_field + dt * dyn_tend
        if __INLINED(PHYS_TEND):
            out_field = out_field + dt * phys_tend


# --- two full-width dycore-style stencils for the card ----------------------------


def hdiff_sponge(
    in_field: "gtscript.Field['dt']",
    out_field: "gtscript.Field['dt']",
    coeff: "gtscript.Field[gtscript.IJ, 'dt']",
    damp: "gtscript.Field[gtscript.K, 'dt']",
):
    """hdiff as three PARALLEL computations handing temporaries on (the
    Laplacian, the limited fluxes, the update), with a diffusion coefficient
    that varies only in the horizontal and a vertical sponge profile."""
    with computation(PARALLEL), interval(...):
        lap = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
    with computation(PARALLEL), interval(...):
        res = lap[1, 0, 0] - lap[0, 0, 0]
        flx = 0.0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap[0, 1, 0] - lap[0, 0, 0]
        fly = 0.0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
    with computation(PARALLEL), interval(...):
        out_field = in_field[0, 0, 0] - coeff[0, 0] * damp[0] * (
            flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
        )


def validate_hdiff_sponge(in_field, coeff, damp):
    """NumPy oracle over the interior [2:-2, 2:-2]: hdiff with the
    coefficient ``coeff[i, j] * damp[k]``."""
    return validate_horizontal_diffusion(in_field, coeff[:, :, None] * damp[None, None, :])


def smoothed_column_sum(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    """A FORWARD sweep that couples neighbouring columns at every level: a
    damped running sum ``acc`` and, in ``out``, the running sum of its
    4-neighbour mean."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = 0.25 * (acc[1, 0, 0] + acc[-1, 0, 0] + acc[0, 1, 0] + acc[0, -1, 0])
        with interval(1, None):
            acc = inp + 0.5 * acc[0, 0, -1]
            out = out[0, 0, -1] + 0.25 * (
                acc[1, 0, 0] + acc[-1, 0, 0] + acc[0, 1, 0] + acc[0, -1, 0]
            )


def validate_smoothed_column_sum(inp):
    """NumPy oracle over the interior [1:-1, 1:-1]."""
    acc = inp.copy()
    for k in range(1, inp.shape[2]):
        acc[:, :, k] = inp[:, :, k] + 0.5 * acc[:, :, k - 1]
    mean = 0.25 * (acc[2:, 1:-1] + acc[:-2, 1:-1] + acc[1:-1, 2:] + acc[1:-1, :-2])
    return np.cumsum(mean, axis=2)


def lagged_neighbour_sweep(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    """Each level reads the level below one column further on: a tile
    needs its neighbour's value of the level before, at every level."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = acc
        with interval(1, None):
            lag = acc[1, 0, -1]
            acc = inp + 0.5 * lag
            out = acc


def lag_read_before_write(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    """The level below is read at an offset before this level's write, so
    the write's extent does not reach the read."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
        with interval(1, None):
            out = acc[1, 0, -1] + acc[0, -1, -1]
            acc = inp * 2.0


# --- sweeps whose shared planes start from device memory at every level ---------


def two_writer_sweep(inp: Field3D, mid: Field3D, out: Field3D):
    """mid is written by two statements under conditions and read at other
    points after both: where neither writes, its value from before the call."""
    with computation(FORWARD), interval(...):
        if inp > 0.6:
            mid = 2.0 * inp
        if inp < 0.3:
            mid = inp - 1.0
        out = mid[1, 0, 0] + mid[-1, 0, 0] + mid[0, 1, 0]


def read_between_writes_sweep(inp: Field3D, mid: Field3D, out: Field3D):
    """mid is read at other points between its two conditional writes: where
    the first did not write, the value from before the call, which the
    second may overwrite."""
    with computation(FORWARD), interval(...):
        if inp > 0.6:
            mid = 2.0 * inp
        out = mid[1, 0, 0] + mid[-1, 0, 0]
        if inp < 0.3:
            mid = inp - 1.0


def read_before_write_sweep(inp: Field3D, out: Field3D, out2: Field3D):
    """out is read at other points before the level writes it: its values
    from before the call."""
    with computation(FORWARD), interval(...):
        out2 = out[1, 0, 0] - out[0, -1, 0]
        out = inp + 0.5 * out2


# --- three column walks at the edges of the prefetch ring and the registers -----


def read_ahead_sweep(inp: Field3D, out: Field3D, out2: Field3D):
    """A FORWARD loop that reads the field it writes at its own level and
    one level ahead of the walk (both its values from before the loop), and
    a BACKWARD loop carrying the result down."""
    with computation(FORWARD):
        with interval(0, -1):
            out = inp + 0.5 * (out + out[0, 0, 1])
        with interval(-1, None):
            out = inp + 0.5 * out
    with computation(BACKWARD):
        with interval(-1, None):
            out2 = out
        with interval(0, -1):
            out2 = out + 0.25 * out2[0, 0, 1]


def restarted_temporary(inp: Field3D, out: Field3D):
    """A temporary carried up a FORWARD walk that sections 1 and 2 do not
    write (it reads 0 at their levels, and its carry restarts from 0), then
    written only where ``inp > 0.5``."""
    with computation(FORWARD):
        with interval(0, 1):
            acc = inp
            out = acc
        with interval(1, 3):
            out = acc[0, 0, -1] + inp
        with interval(3, None):
            if inp > 0.5:
                acc = acc[0, 0, -1] + inp
            out = acc + out[0, 0, -1]


def narrow_offset_read(inp: Field3D, wind: Field3D, out: Field3D):
    """A FORWARD loop whose columns are widened by ``flux``, which the later
    loop reads at a horizontal offset, while the narrower ``adv`` reads
    ``wind`` at ``i + 1``: at the widened columns that read would leave
    wind's allocation, so only ``adv``'s columns may copy it."""
    with computation(FORWARD):
        with interval(0, 1):
            flux = inp
            adv = wind[1, 0, 0] - wind[0, 0, 0]
        with interval(1, None):
            flux = inp + 0.5 * flux[0, 0, -1]
            adv = wind[1, 0, 0] - wind[0, 0, 0] + 0.5 * adv[0, 0, -1]
    with computation(PARALLEL), interval(...):
        out = flux[1, 0, 0] + flux[-1, 0, 0] + adv


def _entry(definition, strategy, *, externals=None, scalars=None, min_k=1, dtypes=None):
    return {
        "definition": definition,
        "strategy": strategy,
        "externals": externals or {},
        "scalars": scalars or {},
        "min_k": min_k,
        "dtypes": dtypes or {},
    }


#: name -> definition, the kernel skeleton pinned to serve it on the card
#: (the role of EXPECTED_STRATEGY in tests/tpu_tests/test_registry_hardware.py),
#: build externals, scalar arguments, the smallest K it takes and build
#: dtypes. The names are those of tests/cartesian_tests/stencil_defs.py.
REGISTRY = {
    "copy_stencil": _entry(copy_stencil, "plane"),
    "horizontal_diffusion": _entry(horizontal_diffusion, "plane"),
    "lap_of_lap": _entry(lap_of_lap, "plane"),
    "native_function_zoo": _entry(native_function_zoo, "plane"),
    "ternary_and_masks": _entry(ternary_and_masks, "plane"),
    "region_interaction": _entry(region_interaction, "plane"),
    "param_multibranch": _entry(param_multibranch, "plane", scalars={"c": 0.5}),
    "iteration_index_parallel": _entry(iteration_index_parallel, "plane", min_k=2),
    "tridiagonal_solver": _entry(tridiagonal_solver, "column", min_k=2),
    "vertical_advection_dycore": _entry(
        vertical_advection_dycore, "column", externals=VADV_EXTERNALS,
        scalars={"dtr_stage": 0.15}, min_k=3,
    ),
    "forward_cumsum": _entry(forward_cumsum, "column"),
    "backward_cumsum": _entry(backward_cumsum, "column"),
    "multi_section_forward": _entry(multi_section_forward, "column", min_k=6),
    "heat_step": _entry(heat_step, "column", scalars={"dt": 0.1}, min_k=2),
    "staggeredish_interval_chain": _entry(staggeredish_interval_chain, "column", min_k=2),
    "iteration_index_sequential": _entry(iteration_index_sequential, "column", min_k=2),
    "dycore_smagorinsky_like": _entry(
        dycore_smagorinsky_like, "column", scalars={"cs": 0.18}, min_k=2
    ),
    "shift_all_directions": _entry(shift_all_directions, "column", min_k=3),
    "arithmetic_ops": _entry(arithmetic_ops, "plane"),
    "function_call": _entry(function_call, "plane"),
    "temporary_stencil": _entry(temporary_stencil, "column", scalars={"scalar_in": 1.5}),
    "runtime_if": _entry(runtime_if, "column"),
    "while_stencil": _entry(while_stencil, "column"),
    "large_k_interval": _entry(large_k_interval, "plane", min_k=16),
    "compile_time_if": _entry(
        compile_time_if, "plane", externals={"USE_FAST": True, "WEIGHT": 0.25}
    ),
    "variable_k_shift": _entry(variable_k_shift, "column"),
    "absolute_k_reference": _entry(absolute_k_reference, "column"),
    "table_lookup": _entry(table_lookup, "fused_plane"),
    "table_lookup_2d": _entry(table_lookup_2d, "fused_plane"),
    "vector_axpy": _entry(vector_axpy, "fused_plane", scalars={"alpha": 1.75}),
    "matvec_product": _entry(matvec_product, "fused_plane"),
    "component_extract": _entry(component_extract, "fused_plane"),
    "k_profile_scale": _entry(k_profile_scale, "fused_plane"),
    "newton_sqrt_while": _entry(newton_sqrt_while, "plane"),
    "dtype_zoo": _entry(dtype_zoo, "plane"),
    "land_mask": _entry(land_mask, "plane"),
    "bool_elif_koffset": _entry(bool_elif_koffset, "column", min_k=3),
    "nested_conditional_locals": _entry(nested_conditional_locals, "column", min_k=3),
    "empty_computation_inlined": _entry(
        empty_computation_inlined, "column", externals={"EXTRA_SMOOTH": False}
    ),
    "single_level_offset": _entry(single_level_offset, "plane", min_k=3),
    "region_conditional": _entry(region_conditional, "plane"),
    "region_in_sequential": _entry(region_in_sequential, "column", min_k=2),
    "optional_tendency": _entry(
        optional_tendency, "plane", externals={"PHYS_TEND": True}, scalars={"dt": 0.5}
    ),
    "hdiff_sponge": _entry(hdiff_sponge, "fused_plane", dtypes={"dt": np.float64}),
    "smoothed_column_sum": _entry(
        smoothed_column_sum, "tiled", dtypes={"dt": np.float64}, min_k=2
    ),
    "read_ahead_sweep": _entry(read_ahead_sweep, "column", min_k=2),
    "restarted_temporary": _entry(restarted_temporary, "column", min_k=4),
    "narrow_offset_read": _entry(narrow_offset_read, "column", min_k=2),
}

#: registry stencils with no twin in tests/cartesian_tests/stencil_defs.py
#: (their JAX twins live in tests/test_torch_cartesian.py)
PORT_ONLY = (
    "hdiff_sponge", "smoothed_column_sum", "read_ahead_sweep", "restarted_temporary",
    "narrow_offset_read",
)

#: the kernel that serves a registry stencil with the stage-fusion switch
#: on (GT4PY_CUDA_FUSE_STAGES=1) where it is not REGISTRY's: K4's class,
#: the three stencils the JAX package's _build_fused_call builds a kernel
#: for with GT4PY_PALLAS_FUSE_STAGES=1, and the port's read_ahead_sweep
FUSED_STAGES = {
    "vertical_advection_dycore": "fused_column",
    "tridiagonal_solver": "fused_column",
    "empty_computation_inlined": "fused_column",
    "read_ahead_sweep": "fused_column",
}


#: float16 stencils, one on each kernel: name -> (definition, the kernel
#: that serves it, whether it is built with the stage-fusion switch on).
#: Stored half and computed in float32 on the card, as K1 computes them
#: (pallas_split.py:129-156); the plain version computes in half operation
#: by operation, so the two agree to HALF_TOL, the JAX package's own
#: tolerance for float16 (tests/cartesian_tests/test_upcasting_matrix.py)
HALF_STENCILS = {
    "hdiff": (horizontal_diffusion_generic, "plane", False),
    "hdiff_sponge": (hdiff_sponge, "fused_plane", False),
    "tridiag": (tridiagonal_solver_generic, "column", False),
    "tridiag_fused": (tridiagonal_solver_generic, "fused_column", True),
    "smoothed_column_sum": (smoothed_column_sum, "tiled", False),
}
HALF_TOL = 1e-2
#: the same stencils in bfloat16 (stored in 16 bits with an 8-bit mantissa,
#: computed in float32 on the card), at the JAX package's bfloat16
#: tolerances (test_upcasting_matrix.py): 0.02 for one PARALLEL
#: application, 0.05 for a carry along K. The largest error this test
#: suite's inputs give against the plain version computed in float32 and
#: rounded once is 0.004 (PARALLEL) and 0.015 (smoothed_column_sum)
BF16_TOL = {
    "hdiff": 0.02, "hdiff_sponge": 0.02,
    "tridiag": 0.05, "tridiag_fused": 0.05, "smoothed_column_sum": 0.05,
}


def half_precision(inp: "gtscript.Field['dt']", out: "gtscript.Field['dt']"):
    """A copy, built with float16 fields: the construct the card refused
    before float16 had a kernel type."""
    with computation(PARALLEL), interval(...):
        out = inp


def half_inputs(field_info, shape, rng):
    """Half inputs of a HALF_STENCILS stencil (:func:`make_inputs`),
    conditioned as a model's would be: a diagonally dominant tridiagonal
    system, a stable diffusion coefficient."""
    host = make_inputs(field_info, shape, rng)
    if "diag" in host:
        host["diag"] = host["diag"] + host["diag"].dtype.type(4.0)
        host["inf"], host["sup"] = -host["inf"], -host["sup"]
    if "coeff" in host:
        host["coeff"] = (0.1 * host["coeff"]).astype(host["coeff"].dtype)
    return host


def make_inputs(field_info, shape, rng):
    """NumPy inputs for every field a stencil touches, made with ``rng``.

    ``shape`` is the (I, J, K) allocation of a 3-D field; lower-dimensional
    fields keep the axes they have, data dimensions trail, tables take their
    own shape. Floats are uniform in [0, 1), integers 0 or 1 (a valid index
    of every table and data dimension of the registry), booleans random.
    NumPy has no bfloat16: a bfloat16 field's inputs are float32, which
    ``storage.from_array(..., dtype=...)`` rounds to it.
    """
    out = {}
    for name, info in field_info.items():
        if info is None:
            continue
        spatial = tuple(n for n, on in zip(shape, info.domain_mask) if on)
        full = spatial + tuple(info.data_dims)
        dtype = np.dtype(np.float32) if info.dtype == bfloat16 else np.dtype(info.dtype)
        if dtype.kind == "b":
            out[name] = rng.random(full) > 0.5
        elif dtype.kind in "iu":
            out[name] = rng.integers(0, 2, full).astype(dtype)
        else:
            out[name] = rng.random(full).astype(dtype)
    return out


# --- the rest of stencil_defs.py that tests/test_torch_stencils.py reads --------


def validate_arithmetic_ops(field_b):
    return (((((field_b + 42.0) - 42.0) * +42.0) / -42.0) % 42.0) ** 2


def scalar_inputs(field_a: Field3D, scalar_in: float):
    with computation(PARALLEL), interval(...):
        field_a = field_a * scalar_in


def validate_function_call(field_a):
    return np.sqrt(np.abs(field_a)) + 1.0


def validate_runtime_if(field_a):
    field_b = np.where(field_a > 0.0, -1.0, 1.0)
    new_a = np.where(field_a > 0.0, -field_a, field_a)
    return new_a, field_b


def validate_while(field_a, field_b):
    a = field_a.copy()
    b = field_b.copy()
    mask = a > 2.0
    while mask.any():
        b[mask] = -1
        a[mask] = 1.0
        mask = a > 2.0
    return a, b
