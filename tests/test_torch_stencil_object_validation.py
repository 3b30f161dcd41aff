"""tests/cartesian_tests/test_stencil_object_validation.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

StencilObject call-path validation tests (reference
tests/cartesian_tests/unit_tests/test_stencil_object.py: every class of
invalid call — bad domain, wrong dtype/ndim/shape, missing args,
too-small origins — raises the documented error)."""

import numpy as np
import pytest

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

Field3D = gtscript.Field[np.float64]


@pytest.fixture(scope="module")
def lap():
    def lap_defn(src: Field3D, dst: Field3D):
        with computation(PARALLEL), interval(...):
            dst = src[1, 0, 0] + src[-1, 0, 0] - 2.0 * src

    return gtscript.stencil(backend="numpy", definition=lap_defn)


@pytest.fixture(scope="module")
def scaled():
    def scaled_defn(src: Field3D, dst: Field3D, w: float):
        with computation(PARALLEL), interval(...):
            dst = w * src

    return gtscript.stencil(backend="numpy", definition=scaled_defn)


def _args(n=6, nk=3):
    src = storage.ones((n, n, nk), backend="numpy", aligned_index=(1, 0, 0), device="cpu")
    dst = storage.zeros((n, n, nk), backend="numpy", aligned_index=(1, 0, 0), device="cpu")
    return src, dst


def test_invalid_domain_length(lap):
    src, dst = _args()
    with pytest.raises(ValueError, match="Invalid 'domain'"):
        lap(src, dst, domain=(4, 4))


def test_zero_domain_rejected(lap):
    src, dst = _args()
    with pytest.raises(ValueError, match="zero sizes"):
        lap(src, dst, domain=(0, 4, 3))


def test_domain_too_large(lap):
    src, dst = _args()
    with pytest.raises(ValueError, match="too large"):
        lap(src, dst, domain=(6, 6, 3))  # needs I halo 1 on both sides


def test_missing_field(lap):
    src, _ = _args()
    with pytest.raises((ValueError, TypeError)):
        lap(src, domain=(4, 6, 3))


def test_wrong_dtype_rejected(lap):
    src = storage.ones((6, 6, 3), np.float32, backend="numpy", aligned_index=(1, 0, 0), device="cpu")
    dst = storage.zeros((6, 6, 3), backend="numpy", aligned_index=(1, 0, 0), device="cpu")
    with pytest.raises(TypeError, match="dtype of field 'src'"):
        lap(src, dst, domain=(4, 6, 3))


def test_wrong_ndim_rejected(lap):
    src = storage.ones((6, 6), backend="numpy", device="cpu")
    dst = storage.zeros((6, 6), backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        lap(src, dst, domain=(4, 4, 1))


def test_origin_too_small(lap):
    src, dst = _args()
    with pytest.raises(ValueError, match="Origin for field src too small"):
        lap(src, dst, origin={"src": (0, 0, 0), "dst": (0, 0, 0)}, domain=(4, 6, 3))


def test_shape_too_small(lap):
    # The max-domain check subsumes the per-field minimum-shape check when
    # every field is undersized; either diagnostic is acceptable.
    src, dst = _args(n=4)
    with pytest.raises(ValueError, match="too large|must be at least"):
        lap(src, dst, origin=(1, 0, 0), domain=(4, 4, 3))


def test_missing_scalar_parameter(scaled):
    src, dst = _args()
    with pytest.raises((ValueError, TypeError), match="w"):
        scaled(src, dst, domain=(4, 6, 3))


def test_wrong_scalar_type(scaled):
    src, dst = _args()
    with pytest.raises(TypeError, match="type of parameter 'w'"):
        scaled(src, dst, w="not-a-number", domain=(4, 6, 3))


def test_min_sequential_axis_enforced():
    def two_levels(src: Field3D, dst: Field3D):
        with computation(FORWARD):
            with interval(0, 1):
                dst = src
            with interval(1, 2):
                dst = src + dst[0, 0, -1]

    st = gtscript.stencil(backend="numpy", definition=two_levels)
    src = storage.ones((4, 4, 1), backend="numpy", device="cpu")
    dst = storage.zeros((4, 4, 1), backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="Sequential axis"):
        st(src, dst, domain=(4, 4, 1))


def test_valid_call_passes(lap):
    src, dst = _args()
    lap(src, dst, domain=(4, 6, 3))
    np.testing.assert_allclose(np.asarray(dst)[1:5], 0.0)


def test_exec_info_populated(lap):
    src, dst = _args()
    exec_info: dict = {}
    lap(src, dst, domain=(4, 6, 3), exec_info=exec_info)
    assert "call_run_start_time" in exec_info or exec_info  # populated dict


# --- precompile / wait_for_compilation (round-3, verdict item 6) -------------


def test_precompile_warms_then_runs():
    import numpy as np

    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def s(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a[1, 0, 0] + a[-1, 0, 0]

    st = gtscript.stencil(backend="cuda:hopper", definition=s, name="precomp_t", rebuild=True)
    st.precompile(domain=(6, 6, 3), device="cpu")
    st.wait_for_compilation()

    rng = np.random.default_rng(0)
    a = rng.random((8, 6, 3))
    out = np.zeros((8, 6, 3))
    info = {}
    st(a, out, origin=(1, 0, 0), domain=(6, 6, 3), exec_info=info)
    np.testing.assert_allclose(out[1:7], a[2:8] + a[0:6])
    # the port names the key kernel_strategy (the JAX package: pallas_strategy)
    assert info.get("kernel_strategy") is not None


def test_precompile_defers_errors():
    import numpy as np
    import pytest

    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.gtscript import FORWARD, computation, interval

    F = gtscript.Field[np.float64]

    def s(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 2):
                out = a
            with interval(2, None):
                out = out[0, 0, -1] + a

    st = gtscript.stencil(backend="torch", definition=s, name="precomp_err", rebuild=True)
    # K too small for the interval structure -> backend raises in the worker
    st.precompile(domain=(4, 4, 1), device="cpu")
    with pytest.raises(Exception):
        st.wait_for_compilation()
    # the stencil itself is not poisoned
    a = np.random.default_rng(1).random((4, 4, 5))
    out = np.zeros((4, 4, 5))
    st(a, out)
    expected = np.concatenate(
        [a[:, :, :2], np.cumsum(a[:, :, 1:], axis=2)[:, :, 1:] + a[:, :, 1:2]], axis=2
    )
    assert out.shape == (4, 4, 5)


def test_keyword_only_param_rejected_positionally():
    """Python call semantics: a keyword-only scalar passed positionally
    must raise TypeError (the fast binder may not silently accept it)."""

    def kw_defn(src: Field3D, dst: Field3D, *, w: float):
        with computation(PARALLEL), interval(...):
            dst = w * src

    st = gtscript.stencil(backend="numpy", definition=kw_defn)
    src, dst = _args()
    with pytest.raises(TypeError, match="positional"):
        st(src, dst, 2.0, domain=(4, 6, 3))
    # ... while the keyword spelling works.
    st(src, dst, w=2.0, domain=(4, 6, 3))
    np.testing.assert_allclose(np.asarray(dst)[1:5, :, :], 2.0)
