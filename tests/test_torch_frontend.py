"""The port's copy of the front half (frontend, GTIR, passes) is faithful:
for the same definition, ``gtir_pretty.pretty`` of the port's analyzed
stencil equals the JAX package's, text for text."""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu.cartesian.gtir_pretty import pretty as ref_pretty
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtir_pretty import parse, pretty

from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs
from .test_torch_cartesian import JAX_TWINS


def _pretty_pair(name, *, backend="torch", **options):
    entry = defs.REGISTRY.get(name)
    definition = entry["definition"] if entry else getattr(defs, name)
    externals = dict(entry["externals"]) if entry else {}
    externals.update(options.pop("externals", {}))
    if name in JAX_TWINS:  # the port's own definitions, named as the port names them
        options.update(dtypes=entry["dtypes"], name=name)
    port = gtscript.stencil(
        backend=backend, definition=definition, externals=externals, **options
    )
    ref = ref_gtscript.stencil(
        backend="numpy", definition=JAX_TWINS.get(name) or getattr(ref_defs, name),
        externals=externals, **options,
    )
    return pretty(port._analyzed.stencil), ref_pretty(ref._analyzed.stencil)


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_pretty_ir_matches_reference(name):
    mine, ref = _pretty_pair(name)
    assert mine == ref


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generic_vadv_pretty_ir_matches_reference(backend, dtype):
    precision = 32 if dtype == np.float32 else 64
    mine, ref = _pretty_pair(
        "vertical_advection_dycore_generic",
        backend=backend,
        externals=defs.VADV_EXTERNALS,
        dtypes={"vadv_dt": dtype},
        literal_float_precision=precision,
        literal_int_precision=precision,
    )
    assert mine == ref


@pytest.mark.parametrize("name", ["horizontal_diffusion", "tridiagonal_solver"])
def test_pretty_ir_round_trips(name):
    port = gtscript.stencil(backend="torch", definition=defs.REGISTRY[name]["definition"])
    text = port.pretty_ir()
    assert pretty(parse(text)) == text


def test_bfloat16_literals_build():
    """``literal_float_precision="bf16"`` builds, as in the JAX package, and
    its GTIR prints as the JAX package's does, bf16 literals included."""
    mine, ref = _pretty_pair("lap_of_lap", literal_float_precision="bf16")
    assert ":bf16" in mine
    assert mine == ref
    assert pretty(parse(mine)) == mine
