"""tests/cartesian_tests/test_stencils.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Integration tests: canonical stencils × all backends vs NumPy oracles.

Mirrors the reference's backend-parametrized suite approach
(upstream gt4py tests/cartesian_tests/definitions.py:34-54 and
integration_tests/multi_feature_tests/test_code_generation.py): no mocks —
every registered backend runs the same stencils, results compared against
hand-written NumPy validation functions.
"""

import numpy as np
import pytest

from gt4py_tpu_torch.cartesian import gtscript

from tests import torch_stencil_defs as defs

from tests.torch_definitions import (
    BACKEND_SKIP_TEST_MATRIX,
    USES_WHILE,
    apply_exclusion,
)
from tests.torch_definitions import ALL_BACKENDS as _REGISTERED

# Backends exercised here come from the live registry (reference
# definitions.py:34-54); tpu:pallas has its own module (interpret mode).
# The reference's CPU tier holds every backend but tpu:pallas, ``jax``
# included: the port's holds every backend but cuda:hopper, ``torch``
# included (on CPU tensors; its storages default to the card).
ALL_BACKENDS = [b for b in _REGISTERED if b != "cuda:hopper"]
FAST_BACKENDS = [b for b in ALL_BACKENDS if b != "debug"]  # debug is O(points) Python


def build(definition, backend, **kwargs):
    return gtscript.stencil(backend=backend, definition=definition, rebuild=True, **kwargs)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_copy_stencil(backend, rng):
    st = build(defs.copy_stencil, backend)
    a = rng.random((6, 5, 4))
    b = np.zeros((6, 5, 4))
    st(a, b)
    np.testing.assert_allclose(a, b)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_arithmetic_ops(backend, rng):
    st = build(defs.arithmetic_ops, backend)
    a = np.zeros((4, 4, 4))
    b = rng.random((4, 4, 4))
    st(a, b)
    np.testing.assert_allclose(a, defs.validate_arithmetic_ops(b))


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_scalar_inputs(backend, rng):
    st = build(defs.scalar_inputs, backend)
    a = rng.random((4, 4, 4))
    expected = a * 3.5
    st(a, 3.5)
    np.testing.assert_allclose(a, expected)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_call(backend, rng):
    st = build(defs.function_call, backend)
    a = rng.random((5, 5, 3)) - 0.5
    b = np.zeros_like(a)
    st(a, b)
    np.testing.assert_allclose(b, defs.validate_function_call(a))


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_temporary_and_2d_field(backend, rng):
    st = build(defs.temporary_stencil, backend)
    a = rng.random((5, 6, 4))
    b = rng.random((5, 6))
    expected = b + a[:, :, 0] * 2.0
    st(a, b, 2.0)
    np.testing.assert_allclose(b, expected)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_runtime_if(backend, rng):
    st = build(defs.runtime_if, backend)
    a = rng.random((4, 4, 5)) - 0.5
    b = np.zeros_like(a)
    exp_a, exp_b = defs.validate_runtime_if(a)
    st(a, b)
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_while_stencil(backend, rng):
    # Exclusion-matrix pattern (reference ADR 0015): whether a backend
    # runs/xfails this feature comes from the central table.
    apply_exclusion(backend, USES_WHILE)
    st = build(defs.while_stencil, backend)
    a = rng.random((4, 4, 3)) * 4.0
    b = np.zeros_like(a)
    exp_a, exp_b = defs.validate_while(a, b)
    st(a, b)
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_horizontal_diffusion(backend, rng):
    st = build(defs.horizontal_diffusion, backend)
    shape = (12, 11, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out_field = np.zeros(shape)
    st(
        in_field,
        out_field,
        coeff,
        origin=(2, 2, 0),
        domain=(shape[0] - 4, shape[1] - 4, shape[2]),
    )
    np.testing.assert_allclose(
        out_field[2:-2, 2:-2], defs.validate_horizontal_diffusion(in_field, coeff)
    )


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_tridiagonal_solver(backend, rng):
    st = build(defs.tridiagonal_solver, backend)
    shape = (4, 5, 8)
    inf = -np.ones(shape)
    diag = np.full(shape, 4.0)
    sup = -np.ones(shape)
    rhs = rng.random(shape)
    expected = defs.validate_tridiagonal_solver(inf, diag, sup, rhs)
    out = np.zeros(shape)
    st(inf.copy(), diag.copy(), sup.copy(), rhs.copy(), out)
    np.testing.assert_allclose(out, expected, rtol=1e-12)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_vertical_advection_dycore(backend, rng):
    st = build(
        defs.vertical_advection_dycore, backend, externals=defs.VADV_EXTERNALS
    )
    shape = (6, 5, 9)
    utens_stage = rng.random(shape)
    u_stage = rng.random(shape)
    wcon = rng.random(shape)
    u_pos = rng.random(shape)
    utens = rng.random(shape)
    dtr_stage = 3.0 / 20.0
    expected = defs.validate_vertical_advection_dycore(
        utens_stage, u_stage, wcon, u_pos, utens, dtr_stage
    )
    result = utens_stage.copy()
    st(
        result,
        u_stage,
        wcon,
        u_pos,
        utens,
        dtr_stage=dtr_stage,
        domain=(shape[0] - 1, shape[1], shape[2]),
    )
    np.testing.assert_allclose(result[: shape[0] - 1], expected, rtol=1e-8)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_large_k_interval(backend, rng):
    st = build(defs.large_k_interval, backend)
    shape = (4, 4, 20)
    in_field = rng.random(shape)
    out_field = np.zeros(shape)
    st(in_field, out_field)
    expected = in_field.copy()
    expected[:, :, 6:10] += 1
    np.testing.assert_allclose(out_field, expected)

    with pytest.raises(ValueError):
        st(rng.random((4, 4, 10)), np.zeros((4, 4, 10)))


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_storage_roundtrip(backend, rng):
    from gt4py_tpu_torch import storage

    st = build(defs.copy_stencil, backend)
    data = rng.random((5, 5, 5))
    a = storage.from_array(data, backend=backend if backend != "torch" else "torch", device="cpu")
    b = storage.zeros((5, 5, 5), backend="torch", device="cpu")
    st(a, b)
    np.testing.assert_allclose(b.asnumpy(), data)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_stencil_matches_normal_call(backend, rng):
    """freeze() pre-resolves geometry and skips validation; results must
    match the normal call path exactly (reference stencil_object.py:95)."""
    from gt4py_tpu_torch import storage

    st = build(defs.horizontal_diffusion, backend)
    shape = (20, 19, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out_a = np.zeros(shape)
    st(
        in_field.copy(), out_a, coeff.copy(),
        origin=(2, 2, 0), domain=(16, 15, 4),
    )

    frozen = st.freeze(origin=(2, 2, 0), domain=(16, 15, 4))
    out_b = storage.zeros(shape, backend=backend, device="cpu")
    frozen(
        in_field=storage.from_array(in_field, backend=backend, device="cpu"),
        out_field=out_b,
        coeff=storage.from_array(coeff, backend=backend, device="cpu"),
    )
    np.testing.assert_allclose(np.asarray(out_b), out_a, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_stencil_with_scalars_and_per_field_origins(backend, rng):
    st = build(defs.scalar_inputs, backend)
    a = rng.random((6, 6, 3))
    expected = a * 3.5
    frozen = st.freeze(origin={"field_a": (0, 0, 0)}, domain=(6, 6, 3))
    buf = a.copy()
    frozen(field_a=buf, scalar_in=3.5)
    np.testing.assert_allclose(buf, expected)
