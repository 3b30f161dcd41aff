"""The field-view feature breadth: every test of the JAX package's
tests/next_tests/test_feature_*.py (14 files, 126 tests) as a case of
tests/torch_feature_defs.py, run on each of the port's four field-view
backends and held against the JAX package's twin of the same case.

The same inputs (the kit's initializers, seeded generators) go through the
JAX package's operator on ``jax`` and on ``numpy`` — once per case and
backend in a module, cached — and through the port's on ``None``
(embedded), ``torch``, ``cuda:hopper`` (on CPU tensors its kernels' plain
version) and ``numpy``. Every case also checks itself against its test's
NumPy reference, through the kit's ``verify``.

Tolerances: the port's ``numpy`` equals the JAX package's ``numpy`` to the
bit, dtype included (both apply NumPy's operators to the same arrays); the
other backends equal the JAX package's ``jax`` within rtol 1e-12 in
float64 and 1e-5 in float32 (atol 0), integers and booleans exactly. Where
the JAX package's test asserts an error, both packages raise one of the
same class, its message matching the test's pattern.
"""

import functools
import re

import numpy as np
import pytest

from . import torch_cases as cases
from . import torch_feature_defs as defs

RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}

#: cases the JAX package's ``numpy`` backend cannot run: it rebuilds a
#: NamedTuple or named-collection argument as a plain tuple
#: (gt4py_tpu/next/decorators.py:274-283 ``_as_numpy``), so ``vel.u``
#: raises AttributeError there. The port's ``numpy`` keeps the argument's
#: type; it is held against the JAX package's ``jax`` instead (ROADMAP
#: Queue 3 lists the difference).
REFERENCE_NUMPY_FAULTS = {
    "named_tuple_constructed_outside",
    "nested_mixed_collections",
    "where_over_collection",
}


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX package's twins of the cases (this module's only JAX)."""
    return defs.load("gt4py_tpu")


def _leaves(value) -> list:
    if isinstance(value, tuple):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value.asnumpy()]


def _outcome(module, name: str, backend):
    """("ok", the written arrays) or ("error", the exception)."""
    try:
        return "ok", _leaves(module.run_case(name, backend))
    except Exception as exc:  # noqa: BLE001 — compared with the other package's
        return "error", exc


@functools.lru_cache(maxsize=None)
def _reference_outcome(name: str, backend: str):
    return _outcome(_reference(), name, backend)


def _class_names(exc) -> set:
    return {cls.__name__ for cls in type(exc).__mro__}


def _check_error(name: str, mine, ref) -> None:
    cls, pattern = defs.RAISES[name]
    for kind, exc in (mine, ref):
        assert kind == "error", f"{name}: no {cls} raised"
        assert cls in _class_names(exc), f"{name}: {type(exc).__name__}, not {cls}"
        assert re.search(pattern, str(exc)), f"{name}: {exc!r} does not match {pattern!r}"
    assert type(mine[1]).__name__ == type(ref[1]).__name__


def _assert_same(name: str, mine: list, ref: list, exact: bool) -> None:
    assert len(mine) == len(ref)
    for got, want in zip(mine, ref):
        assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype)
        if exact or got.dtype not in RTOL:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL[got.dtype], atol=0, err_msg=name)


@pytest.mark.parametrize("backend", cases.BACKENDS, ids=cases.BACKEND_IDS)
@pytest.mark.parametrize("name", sorted(defs.CASES))
def test_feature_matches_reference(name, backend):
    mine = _outcome(defs, name, backend)
    oracle = backend == "numpy" and name not in REFERENCE_NUMPY_FAULTS
    ref = _reference_outcome(name, "numpy" if oracle else "jax")
    if name in defs.RAISES:
        _check_error(name, mine, ref)
        return
    assert mine[0] == "ok", f"{name} on {backend}: {mine[1]!r}"
    assert ref[0] == "ok", f"{name}: the JAX package raised {ref[1]!r}"
    _assert_same(name, mine[1], ref[1], exact=oracle)


@pytest.mark.parametrize("name", sorted(set(defs.CASES) - set(defs.RAISES)))
def test_feature_bridged_onto_its_kernels(name):
    """On ``cuda:hopper`` each case runs on the kernels ``BRIDGED_ONTO``
    pins for it, and the others embedded: a case that leaves its kernel,
    or a refusal that is no longer one, fails here."""
    from gt4py_tpu_torch.next import cartesian_bridge as bridge
    from gt4py_tpu_torch.next import unstructured_codegen

    bridge.calls_served.clear()
    unstructured_codegen.calls_served.clear()
    defs.run_case(name, "cuda:hopper")
    served = set(bridge.calls_served) | set(unstructured_codegen.calls_served)
    assert served == defs.bridged_kernels(name)


@pytest.mark.parametrize("name", sorted(REFERENCE_NUMPY_FAULTS))
def test_reference_numpy_drops_named_tuples(name):
    """The recorded difference of the reference still stands: its
    ``numpy`` backend raises where the port's runs."""
    kind, exc = _reference_outcome(name, "numpy")
    assert kind == "error" and isinstance(exc, AttributeError)
    assert _outcome(defs, name, "numpy")[0] == "ok"


def test_every_feature_test_is_a_case():
    """Each of the 126 test functions of the 14 files is here, by name."""
    import ast
    import os

    here = os.path.join(os.path.dirname(__file__), "next_tests")
    tests = set()
    for fname in sorted(os.listdir(here)):
        if fname.startswith("test_feature_"):
            with open(os.path.join(here, fname)) as f:
                tree = ast.parse(f.read())
            tests |= {n.name[len("test_"):] for n in tree.body
                      if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    mine = {fn.__name__ for _, _, fn, _ in defs.CASES.values()}
    assert len(tests) == 126
    assert tests == mine
