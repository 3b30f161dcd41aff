"""The port's examples (gt4py_tpu_torch/examples/) against their JAX twins
(examples/*.py), on the CPU.

Each example runs from the same inputs (the JAX example's own, made from
its seed with NumPy) on the JAX package's ``numpy`` and ``jax`` backends
and on the port's ``numpy``, ``torch`` and ``cuda:hopper`` (the last on
CPU tensors: its kernels' plain version), at small sizes: burgers at
factor 0 for 20 iterations, isentropic at 10×18×16, the rest at their own
sizes or smaller. Tolerances: float64 results equal the JAX ``numpy``
backend's within rtol 1e-12 (atol 1e-15 where a value crosses zero) and
the JAX ``jax`` backend's within the same; the float32 tridiagonal solver
within the registry tolerances of tests/test_torch_cartesian.py (rtol
1e-5, atol 1e-6).
"""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples import burgers as ref_burgers  # noqa: E402
from examples import custom_backend as ref_custom  # noqa: E402
from examples import distributed_hdiff as ref_distributed  # noqa: E402
from examples import implicit_vertical_diffusion as ref_implicit  # noqa: E402
from examples import isentropic_diagnostics as ref_isentropic  # noqa: E402
from examples import lap_cartesian_vs_next as ref_lap  # noqa: E402
from examples import shallow_water as ref_shallow  # noqa: E402
from examples import tridiagonal_solver as ref_tridiag  # noqa: E402
from examples import typed_operators as ref_typed  # noqa: E402

import gt4py_tpu.next as ref_gtx  # noqa: E402
from gt4py_tpu import storage as ref_storage  # noqa: E402
from gt4py_tpu.cartesian import gtscript as ref_gtscript  # noqa: E402
from gt4py_tpu_torch.examples import (  # noqa: E402
    burgers,
    custom_backend,
    distributed_hdiff,
    implicit_vertical_diffusion,
    isentropic_diagnostics,
    lap_cartesian_vs_next,
    shallow_water,
    tridiagonal_solver,
    typed_operators,
)

#: the port's backends, each on CPU tensors
PORT = ["numpy", "torch", "cuda:hopper"]
#: the JAX package's backends each port result is held against
REF = ["numpy", "jax"]
RTOL, ATOL = 1e-12, 1e-15
F32_RTOL, F32_ATOL = 1e-5, 1e-6

_ref_cache: dict = {}


def ref_result(name, backend, make):
    """The JAX example's result on ``backend``, computed once."""
    key = (name, backend)
    if key not in _ref_cache:
        _ref_cache[key] = make(backend)
    return _ref_cache[key]


def close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


# --- 1. tridiagonal_solver ------------------------------------------------------------


def _ref_tridiag(backend, shape=(16, 16, 24)):
    st = ref_gtscript.stencil(
        backend=backend, definition=ref_tridiag.tridiagonal_solver.definition_func,
        literal_float_precision=32,
    )
    inf = ref_storage.full(shape, -1.0, np.float32, backend=backend)
    diag = ref_storage.full(shape, 3.0, np.float32, backend=backend)
    sup = ref_storage.full(shape, 1.0, np.float32, backend=backend)
    rhs_np = np.full(shape, 3.0, dtype=np.float32)
    rhs_np[:, :, 0] = 4.0
    rhs_np[:, :, -1] = 2.0
    rhs = ref_storage.from_array(rhs_np, np.float32, backend=backend)
    out = ref_storage.zeros(shape, np.float32, backend=backend)
    st(inf, diag, sup, rhs, out)
    return np.asarray(out)


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_tridiagonal_solver(backend, ref):
    got = tridiagonal_solver.main(backend, device="cpu", shape=(16, 16, 24))
    want = ref_result("tridiag", ref, _ref_tridiag)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(got, 1.0, atol=1e-5)


def test_tridiagonal_solver_runs_on_column():
    assert tridiagonal_solver.make_stencils("cuda:hopper")._backend.strategy == "column"


# --- 2. lap_cartesian_vs_next -----------------------------------------------------------


def _ref_lap(backend, n=12):
    data = np.random.default_rng(0).random((n, n, n))
    st = ref_gtscript.stencil(backend=backend, definition=ref_lap.lap_cartesian.definition_func)
    inp = ref_storage.from_array(data, backend=backend, aligned_index=(1, 1, 0))
    out = ref_storage.zeros((n, n, n), backend=backend, aligned_index=(1, 1, 0))
    st(inp, out, origin=(1, 1, 0), domain=(n - 2, n - 2, n))
    I, J, K = ref_lap.IDim, ref_lap.JDim, ref_lap.KDim
    finp = ref_gtx.as_field([I, J, K], data)
    fout = ref_gtx.zeros({I: (1, n - 1), J: (1, n - 1), K: n})
    ref_lap.lap_next.with_backend(backend)(finp, out=fout, offset_provider={"Ioff": I, "Joff": J})
    return out.asnumpy()[1:-1, 1:-1], fout.asnumpy()


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_lap_cartesian_vs_next(backend, ref):
    cart, fv, expected = lap_cartesian_vs_next.main(backend, device="cpu", shape=(12, 12, 12))
    close((cart, fv), ref_result("lap", ref, _ref_lap))
    np.testing.assert_allclose(cart, fv, rtol=RTOL, atol=ATOL)


def test_lap_runs_on_plane_both_ways():
    st, op = lap_cartesian_vs_next.make_stencils("cuda:hopper")
    assert st._backend.strategy == "plane"
    lap_cartesian_vs_next.main("cuda:hopper", device="cpu", shape=(10, 10, 4), stencils=(st, op))
    variants = [v for v in op._bridge_cache.values() if v is not None]
    assert [v.backend.strategy for v in variants] == ["plane"]


# --- 3. burgers -----------------------------------------------------------------------------


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_burgers(backend, ref):
    got = burgers.run(backend, factor=0, niter=20, verbose=False, device="cpu")
    want = ref_result("burgers", ref, lambda b: ref_burgers.run(b, 0, 20, verbose=False))
    close(got, want)


def test_burgers_runs_on_plane():
    assert [s._backend.strategy for s in burgers.make_stencils("cuda:hopper")] == ["plane"] * 2


# --- 4. isentropic_diagnostics --------------------------------------------------------------


def _isentropic(run, backend, **extra):
    errs, stor = run(backend=backend, nx=10, ny=18, nz=16, verbose=False, **extra)
    return errs, [np.asarray(stor[n]) for n in ("p", "exn", "mtg", "h")]


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_isentropic_diagnostics(backend, ref):
    errs, got = _isentropic(isentropic_diagnostics.run, backend, device="cpu")
    _, want = ref_result("isentropic", ref, lambda b: _isentropic(ref_isentropic.run, b))
    close(got, want)
    assert max(errs.values()) < 1e-10


def test_isentropic_runs_on_column():
    assert isentropic_diagnostics.make_diagnostics("cuda:hopper")._backend.strategy == "column"


# --- 5. implicit_vertical_diffusion ---------------------------------------------------------


def _ref_implicit(backend, shape=(8, 8, 12)):
    ni, nj, nk = shape
    q0, kappa = implicit_vertical_diffusion.make_inputs(shape)
    I, J, K = ref_implicit.IDim, ref_implicit.JDim, ref_implicit.KDim
    out = ref_gtx.zeros({I: ni, J: nj, K: nk})
    ref_implicit.diffuse_implicit.with_backend(backend)(
        ref_gtx.as_field([I, J, K], q0), ref_gtx.as_field([I, J, K], kappa),
        ref_gtx.as_field([K], np.arange(nk, dtype=np.int32)), nk - 1, 0.1, 1.0, out=out,
    )
    return out.asnumpy()


def test_implicit_inputs_are_the_jax_examples():
    """make_inputs draws what the JAX example's main draws from seed 0."""
    rng = np.random.default_rng(0)
    q0 = rng.random((16, 16, 24))
    kappa = 0.5 + 0.5 * rng.random((16, 16, 24))
    got = implicit_vertical_diffusion.make_inputs((16, 16, 24))
    np.testing.assert_array_equal(got[0], q0)
    np.testing.assert_array_equal(got[1], kappa)


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_implicit_vertical_diffusion(backend, ref):
    got, op, strategy = implicit_vertical_diffusion.main(backend, device="cpu", shape=(8, 8, 12))
    close([got], [ref_result("implicit", ref, _ref_implicit)])
    if backend == "cuda:hopper":  # bridged onto the column kernel: the plain version ran
        (variant,) = [v for v in op._bridge_cache.values() if v is not None]
        assert variant.backend.strategy == "column" and strategy == "plain"
    else:
        assert strategy == "embedded"


# --- 6. shallow_water --------------------------------------------------------------------------


def _ref_shallow(backend, n=24, steps=10):
    x = np.linspace(0, 2 * np.pi, n)
    h0 = 1.0 + 0.1 * np.exp(-((x - np.pi) ** 2))
    I, IHalf = ref_shallow.I, ref_shallow.IHalf
    h, u = ref_gtx.as_field([I], h0), ref_gtx.as_field([IHalf], np.zeros(n + 1))
    h_new, u_new = ref_gtx.zeros({I: n}), ref_gtx.zeros({IHalf: n + 1})
    step_u = ref_shallow.update_u.with_backend(backend)
    step_h = ref_shallow.update_h.with_backend(backend)
    for _ in range(steps):
        step_u(u, h, out=u_new, domain={IHalf: (1, n)})
        step_h(h, u_new, out=h_new)
        u, u_new = u_new, u
        h, h_new = h_new, h
    return h.asnumpy(), u.asnumpy()


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_shallow_water(backend, ref):
    got = shallow_water.main(backend, device="cpu", n=24, steps=10)
    close(got, ref_result("shallow", ref, _ref_shallow))


def test_shallow_water_full_run():
    """The example's own size: 64 cells, 50 steps, on cuda:hopper (the
    staggered operators run embedded: the bridge refuses a half shift)."""
    h, u = shallow_water.main("cuda:hopper", device="cpu")
    assert h.shape == (64,) and u.shape == (65,)


# --- 7. typed_operators ---------------------------------------------------------------------------


def _printed(fn, *args, **kwargs) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("backend", PORT)
def test_typed_operators_print_what_the_jax_example_prints(backend):
    """Signature, values and both error texts, line for line."""
    got = _printed(typed_operators.main, backend, device="cpu")
    want = ref_result("typed", "jax", lambda b: _printed(ref_typed.main))
    assert len(got) == 4
    assert got == want


# --- 8. custom_backend --------------------------------------------------------------------------


def _ref_smooth(backend, n=32):
    phi = ref_gtx.as_field([ref_custom.I], np.random.default_rng(1).random(n))
    out = ref_gtx.zeros({ref_custom.I: n})
    ref_custom.smooth.with_backend(backend)(phi, alpha=0.3, out=out)
    return out.asnumpy()


@pytest.mark.parametrize("ref", REF)
@pytest.mark.parametrize("backend", PORT)
def test_custom_backend(backend, ref):
    shown = custom_backend.main(backend, device="cpu")
    want = ref_result("smooth", ref, _ref_smooth)
    close([shown[k] for k in ("rewritten", "aot", "eager", "backend")], [want] * 4)
    assert len(shown["calls"]) == 1
    job = shown["job"]
    assert job.traced_stage.text.startswith("stencil smooth")
    assert "__global__" in job.lowered_stage.text
    assert job.compiled_stage.cost_analysis() is None  # CPU tensors: nothing built


def test_custom_backend_jax_example_runs_alike():
    """The JAX example's three backends print the values the port's do."""
    lines = _printed(ref_custom.main)
    mine = custom_backend.main("torch", device="cpu")
    for tag, key in (("remat backend", "rewritten"), ("eager backend", "eager")):
        (line,) = [ln for ln in lines if ln.startswith(tag)]
        assert line.split("=", 1)[1].strip() == str(mine[key][:3])


def test_custom_backend_smooth_on_fused_plane():
    shown = custom_backend.main("cuda:hopper", device="cpu")
    (variant,) = [v for v in shown["op"]._bridge_cache.values() if v is not None]
    assert variant.backend.strategy == "fused_plane"
    assert shown["job"].traced_stage.variant.backend.strategy == "fused_plane"


# --- 9. distributed_hdiff -------------------------------------------------------------------------


def _ref_distributed(backend):
    """The JAX example's arrays (its mesh: the eight virtual CPU devices,
    2 × 4, so a 64 × 128 × 8 domain), recorded from its own ``main``."""
    import gt4py_tpu.next as ref_next
    import gt4py_tpu.parallel as ref_parallel

    seen = {}

    class Recording(ref_parallel.DistributedStencil):
        def apply(self, **kwargs):
            seen["hdiff"] = out = super().apply(**kwargs)
            return out

    def zeros(*args, **kwargs):
        seen["lap"] = field = real_zeros(*args, **kwargs)
        return field

    real_zeros = ref_next.zeros
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_parallel, "DistributedStencil", Recording)
        mp.setattr(ref_next, "zeros", zeros)
        _printed(ref_distributed.main)
    return np.asarray(seen["hdiff"]["out_field"]), seen["lap"].asnumpy()


@pytest.mark.parametrize("ref", ["jax"])
@pytest.mark.parametrize("backend", PORT)
def test_distributed_hdiff(backend, ref):
    """Four CPU shards (2 × 2, blocks 32 × 64 × 8: the JAX example's global
    64 × 128 × 8) equal the JAX example on its eight devices."""
    cpu4 = [torch.device("cpu")] * 4
    out, lap = distributed_hdiff.main(backend, cpu4, (32, 64, 8))
    want_hdiff, want_lap = ref_result("distributed", ref, _ref_distributed)
    assert out.shape == want_hdiff.shape == (64, 128, 8)
    assert out.sharding.shard_shape(out.shape) == (32, 64, 8)
    close([np.asarray(out), lap.asnumpy()], [want_hdiff, want_lap])
