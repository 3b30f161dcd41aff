"""``StencilObject.chain`` in the port against the JAX package, on the CPU.

The six cases of tests/cartesian_tests/test_chain.py run through the port's
``torch`` and ``cuda:hopper`` backends (CPU tensors: the plain version, step
by step) and through the JAX package's ``numpy`` backend in float64 (rtol
1e-12) and its ``tpu:pallas`` backend in interpret mode in float32 (rtol
1e-5: both compute in float32, XLA may fuse a product and a sum). Every
role's final content is compared. The cycle planner that the CUDA-graph
chain captures one swap cycle with (``base.chain_plan``) is held against the
Python time loop it replaces.

Data crosses between the packages only as NumPy arrays.
"""

import numpy as np
import pytest

from gt4py_tpu import storage as ref_storage
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend.base import chain_cycle_len, chain_plan

PORT_BACKENDS = ["torch", "cuda:hopper"]
#: (JAX backend, dtype, rtol, atol) each port backend is held against
REFERENCES = [("numpy", np.float64, 1e-12, 0.0), ("tpu:pallas", np.float32, 1e-5, 1e-6)]

PF = gtscript.Field["dt"]
RF = ref_gtscript.Field["dt"]
#: each package's frontend takes its own ``computation``: the port's
#: definitions name them through ``gs``, the JAX twins through ``rs``
gs, rs = gtscript, ref_gtscript


def _smooth(in_field: PF, out_field: PF, w: "dt"):  # noqa: F821
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out_field = (1.0 - w) * in_field + w * 0.25 * (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )


def _ref_smooth(in_field: RF, out_field: RF, w: "dt"):  # noqa: F821
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out_field = (1.0 - w) * in_field + w * 0.25 * (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )


def _accum(acc: PF, inc: PF):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        acc = acc + inc


def _ref_accum(acc: RF, inc: RF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        acc = acc + inc


def _cum(inp: PF, out: PF):
    with gs.computation(gs.FORWARD):
        with gs.interval(0, 1):
            out = inp
        with gs.interval(1, None):
            out = out[0, 0, -1] + 0.5 * inp


def _ref_cum(inp: RF, out: RF):
    with rs.computation(rs.FORWARD):
        with rs.interval(0, 1):
            out = inp
        with rs.interval(1, None):
            out = out[0, 0, -1] + 0.5 * inp


def _step3(u_prev: PF, u: PF, u_next: PF):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        u_next = 0.5 * u + 0.5 * u_prev


def _ref_step3(u_prev: RF, u: RF, u_next: RF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        u_next = 0.5 * u + 0.5 * u_prev


PINGPONG = {"in_field": "out_field", "out_field": "in_field"}


def _options(dtype):
    opts = {"dtypes": {"dt": dtype}}
    if dtype == np.float32:
        opts.update(literal_float_precision=32)
    return opts


def _chain_both(port_backend, ref, definition, ref_definition, host, n_steps, swap, **call):
    """Run ``chain`` on the port and on the JAX package from the same host
    arrays; return (port results, reference results, the port's exec_info)."""
    ref_backend, dtype, _, _ = ref
    scalars = {k: dtype(v) for k, v in call.pop("scalars", {}).items()}
    port = gtscript.stencil(backend=port_backend, definition=definition, **_options(dtype))
    jax_st = ref_gtscript.stencil(backend=ref_backend, definition=ref_definition, **_options(dtype))
    mine = {n: storage.from_array(v.astype(dtype), backend=port_backend, device="cpu")
            for n, v in host.items()}
    theirs = {n: ref_storage.from_array(v.astype(dtype), backend=ref_backend)
              for n, v in host.items()}
    info = {}
    port.chain(n_steps, **mine, **scalars, swap=swap, exec_info=info, **call)
    jax_st.chain(n_steps, **theirs, **scalars, swap=swap, **call)
    return ({n: np.asarray(v) for n, v in mine.items()},
            {n: np.asarray(v) for n, v in theirs.items()}, info)


def _assert_close(mine, theirs, ref):
    _, dtype, rtol, atol = ref
    for n in theirs:
        assert mine[n].dtype == dtype, n
        np.testing.assert_allclose(mine[n], theirs[n], rtol=rtol, atol=atol, err_msg=n)


@pytest.mark.parametrize("ref", REFERENCES, ids=lambda r: r[0])
@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
@pytest.mark.parametrize("n_steps", [1, 2, 11])
def test_chain_pingpong_matches_reference(port_backend, ref, n_steps):
    rng = np.random.default_rng(3)
    host = {"in_field": rng.random((14, 14, 4)), "out_field": np.zeros((14, 14, 4))}
    mine, theirs, info = _chain_both(
        port_backend, ref, _smooth, _ref_smooth, host, n_steps, PINGPONG,
        origin=(1, 1, 0), domain=(12, 12, 4), scalars={"w": 0.6},
    )
    _assert_close(mine, theirs, ref)
    # CPU tensors run the plain version one step after the other
    assert (info["kernel_strategy"], info["chain_mode"]) == ("plain", "launches")


@pytest.mark.parametrize("ref", REFERENCES, ids=lambda r: r[0])
@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_chain_inout_accumulates_without_swap(port_backend, ref):
    rng = np.random.default_rng(5)
    host = {"acc": np.zeros((8, 8, 3)), "inc": rng.random((8, 8, 3))}
    mine, theirs, _ = _chain_both(port_backend, ref, _accum, _ref_accum, host, 10, {})
    _assert_close(mine, theirs, ref)
    np.testing.assert_allclose(mine["acc"], 10.0 * host["inc"].astype(ref[1]), rtol=2e-5)


@pytest.mark.parametrize("ref", REFERENCES, ids=lambda r: r[0])
@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_chain_forward_scan_pingpong(port_backend, ref):
    rng = np.random.default_rng(7)
    host = {"inp": rng.random((6, 6, 5)), "out": np.zeros((6, 6, 5))}
    mine, theirs, _ = _chain_both(
        port_backend, ref, _cum, _ref_cum, host, 4, {"inp": "out", "out": "inp"}
    )
    _assert_close(mine, theirs, ref)


@pytest.mark.parametrize("ref", REFERENCES, ids=lambda r: r[0])
@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_chain_three_cycle_rotation(port_backend, ref):
    rng = np.random.default_rng(9)
    host = {"u_prev": rng.random((5, 5, 2)), "u": rng.random((5, 5, 2)),
            "u_next": np.zeros((5, 5, 2))}
    swap = {"u_prev": "u", "u": "u_next", "u_next": "u_prev"}
    mine, theirs, _ = _chain_both(port_backend, ref, _step3, _ref_step3, host, 7, swap)
    _assert_close(mine, theirs, ref)


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_chain_validation_errors(port_backend):
    st = gtscript.stencil(backend=port_backend, definition=_smooth, **_options(np.float32))
    a = storage.ones((8, 8, 3), np.float32, backend=port_backend, device="cpu")
    b = storage.zeros((8, 8, 3), np.float32, backend=port_backend, device="cpu")
    geom = dict(origin=(1, 1, 0), domain=(6, 6, 3), w=np.float32(0.5))
    with pytest.raises(ValueError, match="permutation"):
        st.chain(2, a, b, swap={"in_field": "out_field"}, **geom)
    with pytest.raises(ValueError, match="not fields"):
        st.chain(2, a, b, swap={"nope": "nope"}, **geom)
    c = storage.zeros((9, 8, 3), np.float32, backend=port_backend, device="cpu")
    with pytest.raises(ValueError, match="agree in shape"):
        st.chain(2, a, c, swap=PINGPONG, **geom)
    with pytest.raises(ValueError, match="n_steps"):
        st.chain(-1, a, b, **geom)


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_chain_zero_steps_is_noop(port_backend):
    st = gtscript.stencil(backend=port_backend, definition=_smooth, **_options(np.float32))
    a = storage.ones((8, 8, 3), np.float32, backend=port_backend, device="cpu")
    b = storage.zeros((8, 8, 3), np.float32, backend=port_backend, device="cpu")
    st.chain(0, a, b, origin=(1, 1, 0), domain=(6, 6, 3), w=np.float32(0.5))
    np.testing.assert_allclose(np.asarray(b), 0.0)
    np.testing.assert_allclose(np.asarray(a), 1.0)


# --- the cycle plan of the CUDA-graph chain --------------------------------------


SWAPS = {
    1: {},
    2: {"a": "b", "b": "a"},
    3: {"a": "b", "b": "c", "c": "a"},
}


@pytest.mark.parametrize("n_steps", range(8))
@pytest.mark.parametrize("cycle", sorted(SWAPS))
def test_chain_plan_matches_the_python_loop(cycle, n_steps):
    """Step s of the Python loop runs on plan[s % C], and after n steps
    every role's buffer is plan[n % C]'s; d never rotates."""
    roles = ["a", "b", "c", "d"]
    swap = SWAPS[cycle]
    plan = chain_plan(roles, swap)
    assert len(plan) == chain_cycle_len(roles, swap) == cycle
    fields = {r: r for r in roles}  # each role's buffer, named by its owner
    for s in range(n_steps):
        assert plan[s % cycle] == fields
        fields = {r: fields[swap.get(r, r)] for r in fields}
    assert plan[n_steps % cycle] == fields


def test_chain_plan_cycle_is_the_lcm_of_the_rotations():
    swap = {"a": "b", "b": "a", "c": "d", "d": "e", "e": "c"}
    assert chain_cycle_len("abcdef", swap) == 6
    with pytest.raises(ValueError, match="permutation"):
        chain_plan("ab", {"a": "b"})


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_frozen_stencil_matches_a_call(port_backend):
    """``freeze`` resolves origins once (the same expansion over I, J, K as
    a call and a chain); a frozen call equals a validated one."""
    st = gtscript.stencil(backend=port_backend, definition=_smooth, **_options(np.float64))
    src = np.random.default_rng(13).random((14, 14, 4))
    a = storage.from_array(src, backend=port_backend, device="cpu")
    b = storage.zeros((14, 14, 4), backend=port_backend, device="cpu")
    c = storage.zeros((14, 14, 4), backend=port_backend, device="cpu")
    st(a, b, w=0.6, origin=(1, 1, 0), domain=(12, 12, 4))
    st.freeze(origin=(1, 1, 0), domain=(12, 12, 4))(in_field=a, out_field=c, w=0.6)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(b))
    assert np.asarray(b)[1:13, 1:13].any() and not np.asarray(b)[0].any()
