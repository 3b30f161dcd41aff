"""The FOAST/PAST text form of the port (gt4py_tpu_torch.next.foast_pretty)
against the JAX package's (tests/next_tests/test_foast_pretty.py,
test_past_pretty.py and test_double_roundtrip.py).

For the same definition the port's canonical text equals the JAX
package's, character for character; it round-trips
(``parse(pretty(ir)) == normalize(ir)``, ``pretty`` a fixpoint), the
hand-authored textual pass tests give the same text, and an operator run
through pretty → parse → codegen equals its direct run, to the bit, on the
port's Fields.
"""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import foast, foast_passes, foast_pretty, past, where
from gt4py_tpu_torch.next.embedded import offset_provider_context

from . import torch_cases as cases
from .next_tests import test_foast_pretty as ref_foast_tests
from .next_tests import test_past_pretty as ref_past_tests


def _reference():
    from gt4py_tpu.next import foast as rfoast
    from gt4py_tpu.next import foast_pretty as rpretty
    from gt4py_tpu.next import past as rpast

    return rfoast, rpretty, rpast


# --- FOAST ----------------------------------------------------------------------------


@pytest.mark.parametrize("defn", ref_foast_tests.CORPUS, ids=lambda f: f.__name__)
def test_foast_text_matches_reference_and_round_trips(defn):
    rfoast, rpretty, _ = _reference()
    ir = foast.func_to_foast(defn)
    text = foast_pretty.pretty(ir)
    assert text == rpretty.pretty(rfoast.func_to_foast(defn))
    back = foast_pretty.parse(text)
    assert back == foast_pretty.normalize(ir)
    assert foast_pretty.pretty(back) == text


def test_foast_round_trip_after_passes_matches_reference():
    rfoast, rpretty, _ = _reference()
    from gt4py_tpu.next import foast_passes as rpasses

    def passes(module, ir):
        ir = module.fold_constants(ir)
        ir = module.eliminate_common_subexpressions(ir)
        return module.eliminate_dead_code(ir)

    ir = passes(foast_passes, foast.func_to_foast(ref_foast_tests.op_misc))
    text = foast_pretty.pretty(ir)
    assert text == rpretty.pretty(passes(rpasses, rfoast.func_to_foast(ref_foast_tests.op_misc)))
    assert foast_pretty.parse(text) == foast_pretty.normalize(ir)


def test_negative_literal_normalization():
    ir = foast_pretty.parse("def f(a):\n    return a + -2.5\n")
    (ret,) = ir.body
    assert isinstance(ret.value.right, foast.Literal)
    assert ret.value.right.value == -2.5


def test_parse_rejects_out_of_subset():
    for text in ("def f(a):\n    for i in a:\n        pass\n", "x = 1\n", "def f(:\n"):
        with pytest.raises(foast.FoastUnsupported):
            foast_pretty.parse(text)


@pytest.mark.parametrize("case", [
    ("fold_constants", "def f(a):\n    c = (2.0 * 3.0) + (1.0 - 1.0)\n    return a * c\n"),
    ("eliminate_dead_code",
     "def f(a):\n    dead = a * 41.0\n    live = a + 1.0\n    return live\n"),
    ("eliminate_common_subexpressions", "def f(a, b):\n    x = (a * b) + (a * b)\n    return x\n"),
], ids=lambda c: c[0])
def test_textual_pass_matches_reference(case):
    """A pass authored as text gives the JAX package's text."""
    _, rpretty, _ = _reference()
    from gt4py_tpu.next import foast_passes as rpasses

    name, source = case
    mine = foast_pretty.pretty(getattr(foast_passes, name)(foast_pretty.parse(source)))
    assert mine == rpretty.pretty(getattr(rpasses, name)(rpretty.parse(source)))
    if name == "fold_constants":
        assert "c = 6.0" in mine and "2.0 * 3.0" not in mine
    elif name == "eliminate_dead_code":
        assert "dead" not in mine and "live = (a + 1.0)" in mine
    else:
        assert mine.count("(a * b)") == 1


# --- PAST -------------------------------------------------------------------------------


@pytest.mark.parametrize("defn", ref_past_tests.CORPUS, ids=lambda f: f.__name__)
def test_past_text_matches_reference_and_round_trips(defn):
    _, rpretty, rpast = _reference()
    ir = past.func_to_past(defn)
    text = foast_pretty.pretty_program(ir)
    assert text == rpretty.pretty_program(rpast.func_to_past(defn))
    back = foast_pretty.parse_program(text)
    assert back == foast_pretty.normalize_program(ir)
    assert foast_pretty.pretty_program(back) == text


def test_past_round_trip_after_passes():
    ir = past.func_to_past(ref_past_tests.prog_temps)
    ir = past.eliminate_dead_temporaries(foast_passes.fold_constants(ir))
    text = foast_pretty.pretty_program(ir)
    assert foast_pretty.parse_program(text) == foast_pretty.normalize_program(ir)


def test_past_parse_rejects_out_of_subset():
    for text in ("def p(a, out):\n    return a\n", "def p(*args):\n    pass\n", "x = 1\n"):
        with pytest.raises(foast.FoastUnsupported):
            foast_pretty.parse_program(text)


def test_textual_program_passes_match_reference():
    _, rpretty, rpast = _reference()
    static = ("def p(a, out, lo, hi, unused):\n    n = (hi - lo)\n"
              "    op(a, out=out, domain={I: (lo, n)})\n")
    assert past.static_scalar_params(foast_pretty.parse_program(static)) == frozenset({"lo", "hi"})
    through_if = ("def p(a, out, flag, n):\n    if flag:\n"
                  "        op(a, out=out, domain={I: (0, n)})\n    else:\n        op(a, out=out)\n")
    assert past.static_scalar_params(foast_pretty.parse_program(through_if)) == frozenset(
        {"flag", "n"})
    dead = ("def p(a, out, s):\n    live = (s * 2.0)\n    dead = (s + 41.0)\n"
            "    deader = (dead + 1.0)\n    op(a, live, out=out)\n")
    mine = foast_pretty.pretty_program(
        past.eliminate_dead_temporaries(foast_pretty.parse_program(dead)))
    assert mine == rpretty.pretty_program(rpast.eliminate_dead_temporaries(
        rpretty.parse_program(dead)))
    assert "dead" not in mine and "op(a, live, out=out)" in mine
    folded = foast_pretty.pretty_program(foast_passes.fold_constants(foast_pretty.parse_program(
        "def p(a, out):\n    op(a, out=out, domain={I: (0, (2 * 32))})\n")))
    assert "64" in folded and "2 * 32" not in folded


def test_program_text_executes():
    I, J = gtx.Dimension("I"), gtx.Dimension("J")
    IJField = gtx.Field[gtx.Dims[I, J], gtx.float64]

    @gtx.field_operator
    def _dbl(a: IJField) -> IJField:
        return a * 2.0

    @gtx.program
    def prog(a, out):
        _dbl(a, out=out)

    text = foast_pretty.pretty_program(past.func_to_past(prog.definition))
    assert "_dbl(a, out=out)" in text
    back = foast_pretty.parse_program(text)
    assert [type(s).__name__ for s in back.body] == ["CallStmt"]
    a = gtx.as_field([I, J], np.ones((4, 3)), device="cpu")
    out = gtx.zeros({I: 4, J: 3}, device="cpu")
    prog(a, out)
    np.testing.assert_array_equal(out.asnumpy(), 2.0)


# --- double round trip: pretty -> parse -> codegen -> exec --------------------------------


@gtx.field_operator
def lap_op(f: cases.IField) -> cases.IField:
    return f(cases.Ioff[1]) + f(cases.Ioff[-1]) - 2.0 * f


@gtx.field_operator
def vsum_op(ef: cases.EField) -> cases.VField:
    return gtx.neighbor_sum(ef(cases.V2E), axis=cases.V2EDim)


@gtx.field_operator
def mixed_op(a: cases.IField, b: cases.IField) -> cases.IField:
    m = where(a > b, a, b)
    t = (m, a + b)
    return t[0] * 2.0 - t[1]


def _roundtrip_exec(op, *args, provider):
    """``op`` run directly and through its textual round trip."""
    definition = op.definition
    back = foast_pretty.parse(foast_pretty.pretty(foast.func_to_foast(definition)))
    fn = foast._function_from_source(foast.codegen(back), back.name, definition, None)
    with offset_provider_context(provider):
        return definition(*args).asnumpy(), fn(*args).asnumpy()


@pytest.mark.parametrize("name", ["cartesian", "unstructured", "mixed"])
def test_double_roundtrip(name):
    rng = np.random.default_rng(51)
    if name == "unstructured":
        case = cases.simple_unstructured_case(None)
        args = (cases.as_field([cases.Edge], rng.random(case.default_sizes[cases.Edge])),)
        op = vsum_op
    else:
        case = cases.simple_cartesian_case(None)
        n = case.default_sizes[cases.IDim]
        op = lap_op if name == "cartesian" else mixed_op
        args = tuple(cases.as_field([cases.IDim], rng.random(n + 2 if op is lap_op else n))
                     for _ in range(1 if op is lap_op else 2))
    direct, via_text = _roundtrip_exec(op, *args, provider=case.offset_provider)
    np.testing.assert_array_equal(direct, via_text)


@pytest.mark.parametrize("backend", cases.BACKENDS, ids=cases.BACKEND_IDS)
def test_double_roundtrip_matches_backend_execution(backend):
    case = cases.simple_cartesian_case(backend)
    n = case.default_sizes[cases.IDim]
    rng = np.random.default_rng(54)
    a, b = cases.as_field([cases.IDim], rng.random(n)), cases.as_field([cases.IDim], rng.random(n))
    out = cases.zeros({cases.IDim: n})
    cases.run(case, mixed_op, a, b, out=out)
    _, via_text = _roundtrip_exec(mixed_op, a, b, provider={})
    np.testing.assert_array_equal(out.asnumpy(), via_text)
