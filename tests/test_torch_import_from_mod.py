"""tests/next_tests/test_import_from_mod.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Dotted module-attribute access + scalar-driven program domains
(reference tests/next_tests/integration_tests/feature_tests/ffront_tests/
test_import_from_mod.py): dims and field types referenced as module
attributes inside operator/program definitions, and ``domain=`` bounds
supplied by scalar program parameters — which the whole-program jit bakes
as static values per compiled variant (reference otf/arguments.py
static-arg descriptors; here `past.static_scalar_params`)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import broadcast
from gt4py_tpu_torch.next.past import func_to_past, static_scalar_params

from tests import torch_mod_helpers as mh


@gtx.field_operator
def _mod_op(f: mh.IField) -> mh.IKField:
    return broadcast(f, (mh.I, mh.K))


@gtx.program
def _mod_prog(f: mh.IField, isize: np.int32, ksize: np.int32, out: mh.IKField):
    _mod_op(f, out=out, domain={mh.I: (0, isize), mh.K: (0, ksize)})


def test_import_dims_module():
    """Reference test_import_dims_module: dotted dims in annotations and
    in the domain dict; the restricted region is written, the rest kept."""
    n, nk = 10, 5
    f = gtx.as_field([mh.I], np.arange(float(n)), device="cpu")
    out = gtx.zeros({mh.I: n, mh.K: nk}, device="cpu")
    _mod_prog(f, np.int32(n - 1), np.int32(nk - 2), out=out)
    got = out.asnumpy()
    want = np.zeros((n, nk))
    want[: n - 1, : nk - 2] = np.arange(float(n))[: n - 1, None]
    np.testing.assert_allclose(got, want)


def test_domain_scalars_compile_per_value():
    """Different scalar domain bounds are different compiled variants of
    the SAME program object, each producing the right restriction."""
    n, nk = 8, 4
    f = gtx.as_field([mh.I], np.ones(n), device="cpu")

    for isize in (3, 6):
        out = gtx.zeros({mh.I: n, mh.K: nk}, device="cpu")
        _mod_prog(f, np.int32(isize), np.int32(nk), out=out)
        got = out.asnumpy()
        assert (got[:isize] == 1.0).all()
        assert (got[isize:] == 0.0).all()


def test_static_scalar_params_analysis():
    """Unit: names reachable from domain= args and if conditions (incl.
    through intermediate assignments) are detected; others are not."""

    def prog(f, isize, coeff, flag, out):
        stop = isize - 1
        if flag:
            _mod_op(f, out=out, domain={mh.I: (0, stop)})
        else:
            _mod_op(f, out=out)

    names = static_scalar_params(func_to_past(prog))
    assert names == frozenset({"isize", "flag"})


def test_static_analysis_no_domain():
    def prog(f, coeff, out):
        _mod_op(f, out=out)

    assert static_scalar_params(func_to_past(prog)) == frozenset()


def test_program_if_condition_on_scalar():
    """A scalar parameter steering an ``if`` between operator calls is
    baked static, so both branches work under the whole-program jit."""

    @gtx.field_operator
    def _add1(a):
        return a + 1.0

    @gtx.field_operator
    def _add2(a):
        return a + 2.0

    @gtx.program
    def pick(a: mh.IField, which: bool, out: mh.IField):
        if which:
            _add1(a, out=out)
        else:
            _add2(a, out=out)

    a = gtx.as_field([mh.I], np.zeros(6), device="cpu")
    out = gtx.zeros({mh.I: 6}, device="cpu")
    pick(a, True, out=out)
    assert (out.asnumpy() == 1.0).all()
    pick(a, False, out=out)
    assert (out.asnumpy() == 2.0).all()


def test_domain_dict_in_past_source():
    """Dict literals are part of the PAST subset: the program does NOT
    fall back to the raw definition, and the generated source round-trips
    the domain dict."""
    src = _mod_prog.inspect(stage="past")
    assert "domain=" in src and "{" in src
    assert "past_fallback_reason" not in _mod_prog.__dict__
