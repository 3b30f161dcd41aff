"""COSMO's vertical advection (the dycore's implicit vertical solve), as the
port's users write it in GTScript.

Copied from tests/torch_stencil_defs.py:264 (``vertical_advection_dycore_generic``)
with ``VADV_EXTERNALS`` (:199), which are gt4py's own definition
(tests/cartesian_tests/integration_tests/multi_feature_tests/
stencil_definitions.py) with its dtype taken from the ``dtypes={"vadv_dt":
...}`` build option. The externals ``BET_M`` and ``BET_P`` come from the
configuration file.
"""

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import BACKWARD, FORWARD, computation, interval


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


def build(config: dict):
    """The stencil of ``config`` (its backend, dtype, externals and literal
    precision)."""
    return gtscript.stencil(
        backend=config["backend"], definition=vertical_advection_dycore_generic,
        dtypes={"vadv_dt": config["dtype"]}, externals=config.get("externals", {}),
        literal_float_precision=config["literal_precision"],
        literal_int_precision=config["literal_precision"],
    )
