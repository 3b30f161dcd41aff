"""COSMO's horizontal diffusion, as the port's users write it in GTScript.

Copied from tests/torch_stencil_defs.py:477 (``horizontal_diffusion_generic``,
bench.py's ``hdiff32``): the definition of tests/torch_stencil_defs.py:63
(gt4py's own, tests/cartesian_tests/integration_tests/multi_feature_tests/
stencil_definitions.py) with float literals and its dtype taken from the
``dtypes={"dt": ...}`` build option, so that a float32 build computes in
float32 throughout. The harness builds it on the configuration's backend.
"""

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

def horizontal_diffusion(
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


def build(config: dict):
    """The stencil of ``config`` (its backend, dtype and literal precision)."""
    return gtscript.stencil(
        backend=config["backend"], definition=horizontal_diffusion,
        dtypes={"dt": config["dtype"]}, externals=config.get("externals", {}),
        literal_float_precision=config["literal_precision"],
        literal_int_precision=config["literal_precision"],
    )
