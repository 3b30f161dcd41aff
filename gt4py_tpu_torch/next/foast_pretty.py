"""FOAST pretty printer and parser (textual IR round-trip).

Role of the reference's bidirectional ITIR text form
(src/gt4py/next/iterator/pretty_printer.py and
pretty_parser.py, round-trip-tested in
tests/next_tests/unit_tests/iterator_tests/test_pretty_{printer,parser}.py):
a stable, human-readable text form of the field-view compiler IR that
parses back to a structurally-equal tree, so pass-level unit tests can be
hand-authored as text instead of via live Python definitions, and IR
snapshots can travel in bug reports.

Here the IR is FOAST (``next/foast.py``), whose nodes mirror a strict
Python subset — so the canonical text form IS Python source::

    def lap(f):
        a = ((f(Ioff[1]) + f(Ioff[-1])) - (2.0 * f))
        return a

- :func:`pretty` emits fully-parenthesized canonical source (one
  statement per line, normalized assignments, ``a if c else b``
  ternaries).
- :func:`parse` turns such source back into a
  :class:`~gt4py_tpu_torch.next.foast.FieldOperatorDefinition` through the same
  ``_Lowerer`` the frontend uses, then :func:`normalize`\\ s it.
- :func:`normalize` folds the one Python-syntax ambiguity — a negative
  numeric literal has no literal syntax, so ``UnaryOp('-', Literal(v))``
  and ``Literal(-v)`` print identically; normalization canonicalizes to
  the folded ``Literal``.

Round-trip contract: ``parse(pretty(ir)) == normalize(ir)`` for every IR
the frontend or the FOAST passes produce (property-tested over the test
operator corpus in ``tests/next_tests/test_foast_pretty.py``).

The same contract extends to PAST programs (reference
pretty_printer.py program/closure forms): :func:`pretty_program` /
:func:`parse_program` cover ``@program`` definitions — operator-call
statements, ``out=`` arguments, ``domain={I: (lo, hi)}`` dict literals,
kw-only scalar parameters — so program-level passes
(``past.static_scalar_params``, dead-temporary elimination) get
hand-authored textual tests like the operator-level ones.

Copied from gt4py_tpu/next/foast_pretty.py; imports renamed.
"""

from __future__ import annotations

import ast

from gt4py_tpu_torch.next import foast
from gt4py_tpu_torch.next.foast import (
    Assign,
    Attribute,
    BinOp,
    BoolOp,
    Call,
    Compare,
    Expr,
    FieldOperatorDefinition,
    FoastUnsupported,
    IfExpr,
    IfStmt,
    ListExpr,
    Literal,
    Name,
    Return,
    SliceExpr,
    Stmt,
    Subscript,
    TupleExpr,
    UnaryOp,
)

__all__ = [
    "pretty",
    "parse",
    "normalize",
    "pretty_program",
    "parse_program",
    "normalize_program",
]


# --- printer -------------------------------------------------------------------
# Mirrors foast._emit (every composite expression parenthesized, so
# operator precedence never needs reproducing) except IfExpr, which the
# executable codegen dispatches through __gtx_ternary__ but the pretty
# form keeps as Python ternary syntax so it parses back to IfExpr.


def _pp(e: Expr) -> str:
    if isinstance(e, Name):
        return e.id
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, TupleExpr):
        inner = ", ".join(_pp(x) for x in e.elts)
        return f"({inner},)" if len(e.elts) == 1 else f"({inner})"
    if isinstance(e, ListExpr):
        return "[" + ", ".join(_pp(x) for x in e.elts) + "]"
    if isinstance(e, foast.DictExpr):
        items = ", ".join(
            f"{_pp(k)}: {_pp(v)}" for k, v in zip(e.keys, e.values)
        )
        return "{" + items + "}"
    if isinstance(e, UnaryOp):
        sep = " " if e.op == "not" else ""
        return f"({e.op}{sep}{_pp(e.operand)})"
    if isinstance(e, BinOp):
        return f"({_pp(e.left)} {e.op} {_pp(e.right)})"
    if isinstance(e, BoolOp):
        return "(" + f" {e.op} ".join(_pp(v) for v in e.values) + ")"
    if isinstance(e, Compare):
        return f"({_pp(e.left)} {e.op} {_pp(e.right)})"
    if isinstance(e, IfExpr):
        return f"({_pp(e.true_expr)} if {_pp(e.cond)} else {_pp(e.false_expr)})"
    if isinstance(e, Call):
        parts = [_pp(a) for a in e.args]
        parts += [f"{k}={_pp(v)}" for k, v in e.kwargs.items()]
        return f"{_pp(e.func)}({', '.join(parts)})"
    if isinstance(e, Subscript):
        return f"{_pp(e.value)}[{_pp_index(e.index)}]"
    if isinstance(e, Attribute):
        return f"{_pp(e.value)}.{e.attr}"
    if isinstance(e, SliceExpr):
        return _pp_index(e)
    raise TypeError(f"cannot pretty-print {type(e).__name__}")


def _pp_index(e: Expr) -> str:
    if isinstance(e, SliceExpr):
        lo = _pp(e.lower) if e.lower is not None else ""
        hi = _pp(e.upper) if e.upper is not None else ""
        s = f"{lo}:{hi}"
        if e.step is not None:
            s += f":{_pp(e.step)}"
        return s
    if isinstance(e, TupleExpr):
        return ", ".join(_pp_index(x) for x in e.elts)
    return _pp(e)


def _pp_stmt(s: Stmt, lines: list, indent: int) -> None:
    pad = "    " * indent
    if isinstance(s, Assign):
        tgt = " = ".join(_pp(t) for t in s.targets)
        lines.append(f"{pad}{tgt} = {_pp(s.value)}")
    elif isinstance(s, Return):
        lines.append(f"{pad}return {_pp(s.value)}")
    elif isinstance(s, IfStmt):
        lines.append(f"{pad}if {_pp(s.cond)}:")
        if s.body:
            for b in s.body:
                _pp_stmt(b, lines, indent + 1)
        else:
            lines.append(f"{pad}    pass")
        if s.orelse:
            lines.append(f"{pad}else:")
            for b in s.orelse:
                _pp_stmt(b, lines, indent + 1)
    else:
        raise TypeError(f"cannot pretty-print {type(s).__name__}")


def pretty(ir: FieldOperatorDefinition) -> str:
    """Canonical text form of a FOAST definition (valid Python source)."""
    ir = normalize(ir)
    sig = list(ir.params)
    if ir.kwonly_params:
        sig += ["*", *ir.kwonly_params]
    lines = [f"def {ir.name}({', '.join(sig)}):"]
    if not ir.body:
        lines.append("    pass")
    for s in ir.body:
        _pp_stmt(s, lines, 1)
    return "\n".join(lines) + "\n"


# --- normalization ---------------------------------------------------------------


def _normalize_expr(e):
    if isinstance(e, UnaryOp):
        operand = _normalize_expr(e.operand)
        if (
            e.op in ("-", "+")
            and isinstance(operand, Literal)
            and isinstance(operand.value, (int, float, complex))
            and not isinstance(operand.value, bool)
        ):
            v = operand.value
            return Literal(value=-v if e.op == "-" else +v)
        return UnaryOp(op=e.op, operand=operand)
    if isinstance(e, BinOp):
        return BinOp(op=e.op, left=_normalize_expr(e.left), right=_normalize_expr(e.right))
    if isinstance(e, BoolOp):
        return BoolOp(op=e.op, values=[_normalize_expr(v) for v in e.values])
    if isinstance(e, Compare):
        return Compare(op=e.op, left=_normalize_expr(e.left), right=_normalize_expr(e.right))
    if isinstance(e, IfExpr):
        return IfExpr(
            cond=_normalize_expr(e.cond),
            true_expr=_normalize_expr(e.true_expr),
            false_expr=_normalize_expr(e.false_expr),
        )
    if isinstance(e, Call):
        return Call(
            func=_normalize_expr(e.func),
            args=[_normalize_expr(a) for a in e.args],
            kwargs={k: _normalize_expr(v) for k, v in e.kwargs.items()},
        )
    if isinstance(e, Subscript):
        return Subscript(value=_normalize_expr(e.value), index=_normalize_expr(e.index))
    if isinstance(e, Attribute):
        return Attribute(value=_normalize_expr(e.value), attr=e.attr)
    if isinstance(e, TupleExpr):
        return TupleExpr(elts=[_normalize_expr(x) for x in e.elts])
    if isinstance(e, ListExpr):
        return ListExpr(elts=[_normalize_expr(x) for x in e.elts])
    if isinstance(e, foast.DictExpr):
        return foast.DictExpr(
            keys=[_normalize_expr(k) for k in e.keys],
            values=[_normalize_expr(v) for v in e.values],
        )
    if isinstance(e, SliceExpr):
        return SliceExpr(
            lower=_normalize_expr(e.lower) if e.lower is not None else None,
            upper=_normalize_expr(e.upper) if e.upper is not None else None,
            step=_normalize_expr(e.step) if e.step is not None else None,
        )
    return e


def _normalize_stmt(s: Stmt) -> Stmt:
    if isinstance(s, Assign):
        return Assign(
            targets=[_normalize_expr(t) for t in s.targets],
            value=_normalize_expr(s.value),
        )
    if isinstance(s, Return):
        return Return(value=_normalize_expr(s.value))
    if isinstance(s, IfStmt):
        return IfStmt(
            cond=_normalize_expr(s.cond),
            body=[_normalize_stmt(b) for b in s.body],
            orelse=[_normalize_stmt(b) for b in s.orelse],
        )
    return s


def normalize(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    """Fold ``UnaryOp('-'|'+', Literal(number))`` into signed literals —
    the one construct whose pretty form is syntactically indistinguishable
    from the folded literal. Idempotent."""
    return FieldOperatorDefinition(
        name=ir.name,
        params=list(ir.params),
        body=[_normalize_stmt(s) for s in ir.body],
        kwonly_params=list(ir.kwonly_params),
    )


# --- parser --------------------------------------------------------------------


def parse(text: str) -> FieldOperatorDefinition:
    """Parse canonical (or any in-subset Python) source back to FOAST.

    The text must contain exactly one top-level function definition; it is
    lowered through the frontend's ``_Lowerer`` (identical subset rules,
    identical normalizations: docstrings dropped, ``x op= e`` expanded,
    annotations erased) and then :func:`normalize`\\ d.
    """
    try:
        mod = ast.parse(text)
    except SyntaxError as err:
        raise FoastUnsupported(f"not valid Python source: {err}") from err
    fdefs = [n for n in mod.body if isinstance(n, ast.FunctionDef)]
    if len(fdefs) != 1:
        raise FoastUnsupported(
            f"expected exactly one function definition, found {len(fdefs)}"
        )
    return normalize(foast._Lowerer().lower_function(fdefs[0]))


# --- PAST programs ---------------------------------------------------------------
# Reference analog: the ITIR text form covers programs (closures, domains)
# as well as expressions (pretty_printer.py Program/SetAt visitors); here
# the program IR is PAST (next/past.py) and its text form is the same
# strict-Python-subset source, extended with the program-only constructs:
# bare operator-call statements and dict literals (domain= arguments).


def _pp_program_stmt(s, lines: list, indent: int) -> None:
    from gt4py_tpu_torch.next.past import CallStmt

    pad = "    " * indent
    if isinstance(s, CallStmt):
        lines.append(f"{pad}{_pp(s.call)}")
    elif isinstance(s, IfStmt):
        lines.append(f"{pad}if {_pp(s.cond)}:")
        if s.body:
            for b in s.body:
                _pp_program_stmt(b, lines, indent + 1)
        else:
            lines.append(f"{pad}    pass")
        if s.orelse:
            lines.append(f"{pad}else:")
            for b in s.orelse:
                _pp_program_stmt(b, lines, indent + 1)
    else:
        _pp_stmt(s, lines, indent)


def pretty_program(ir) -> str:
    """Canonical text form of a PAST :class:`ProgramDefinition` (valid
    Python source; fixpoint of ``pretty_program ∘ parse_program``)."""
    ir = normalize_program(ir)
    sig = list(ir.params)
    if ir.kwonly_params:
        sig += ["*", *ir.kwonly_params]
    lines = [f"def {ir.name}({', '.join(sig)}):"]
    if not ir.body:
        lines.append("    pass")
    for s in ir.body:
        _pp_program_stmt(s, lines, 1)
    return "\n".join(lines) + "\n"


def _normalize_program_stmt(s):
    from gt4py_tpu_torch.next.past import CallStmt

    if isinstance(s, CallStmt):
        return CallStmt(call=_normalize_expr(s.call))
    if isinstance(s, IfStmt):
        return IfStmt(
            cond=_normalize_expr(s.cond),
            body=[_normalize_program_stmt(b) for b in s.body],
            orelse=[_normalize_program_stmt(b) for b in s.orelse],
        )
    return _normalize_stmt(s)


def normalize_program(ir):
    """Program-level :func:`normalize` (signed-literal folding through
    call statements and domain dicts). Idempotent."""
    from gt4py_tpu_torch.next.past import ProgramDefinition

    return ProgramDefinition(
        name=ir.name,
        params=list(ir.params),
        body=[_normalize_program_stmt(s) for s in ir.body],
        kwonly_params=list(ir.kwonly_params),
    )


def parse_program(text: str):
    """Parse canonical (or any in-subset Python) source back to PAST.

    Exactly one top-level function definition; lowered through the
    frontend's ``_ProgramLowerer`` (identical subset rules: bare
    operator-call statements become :class:`~gt4py_tpu_torch.next.past.CallStmt`,
    dict literals are accepted for ``domain=``, value returns rejected)
    and then :func:`normalize_program`\\ d.
    """
    from gt4py_tpu_torch.next.past import ProgramDefinition, _ProgramLowerer

    try:
        mod = ast.parse(text)
    except SyntaxError as err:
        raise FoastUnsupported(f"not valid Python source: {err}") from err
    fdefs = [n for n in mod.body if isinstance(n, ast.FunctionDef)]
    if len(fdefs) != 1:
        raise FoastUnsupported(
            f"expected exactly one function definition, found {len(fdefs)}"
        )
    fdef = fdefs[0]
    a = fdef.args
    if a.vararg or a.kwarg:
        raise FoastUnsupported("*args/**kwargs parameters")
    lowerer = _ProgramLowerer()
    ir = ProgramDefinition(
        name=fdef.name,
        params=[p.arg for p in (*a.posonlyargs, *a.args)],
        body=lowerer.lower_body(fdef.body),
        kwonly_params=[p.arg for p in a.kwonlyargs],
    )
    return normalize_program(ir)
