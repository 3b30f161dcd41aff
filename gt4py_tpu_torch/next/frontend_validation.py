"""Definition-time validation of field-view DSL functions.

Role of the reference's AST frontend checks
(src/gt4py/next/ffront/func_to_foast.py and
foast_passes/type_deduction.py): before the first trace, the operator's
source is parsed and checked so user mistakes surface as structured
:mod:`gt4py_tpu_torch.next.errors` exceptions with source locations and
did-you-mean suggestions — instead of a raw ``NameError`` deep inside a
JAX trace. The execution semantics stay trace-based (the definition runs
on Field objects); this layer is purely diagnostic.

Checks:
- undefined symbols (per-scope, comprehensions and lambdas included) ->
  ``UndefinedSymbolError`` with fuzzy suggestions,
- constructs a field operator cannot contain (imports, ``global``/
  ``nonlocal``, ``yield``/``await``, nested class definitions) ->
  ``DSLSyntaxError``,
- missing parameter annotations on field operators ->
  ``MissingParameterAnnotationError`` (warning-free for programs, whose
  parameters are plain Python).

Copied from gt4py_tpu/next/frontend_validation.py; imports renamed.
"""

from __future__ import annotations

import ast
import builtins
import inspect
import textwrap
from typing import Callable, Iterable, Optional

from gt4py_tpu_torch.eve import SourceLocation
from gt4py_tpu_torch.next import errors


def _definition_source(fn: Callable):
    try:
        source = inspect.getsource(fn)
        filename = inspect.getsourcefile(fn) or "<unknown>"
        _, firstline = inspect.getsourcelines(fn)
    except (OSError, TypeError):
        return None
    dedented = textwrap.dedent(source)
    try:
        tree = ast.parse(dedented)
    except SyntaxError:
        return None
    node = tree.body[0]
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    indent = len(source.splitlines()[0]) - len(source.splitlines()[0].lstrip())
    return node, filename, firstline - 1, indent


def _loc(node: ast.AST, filename: str, line_offset: int, col_offset: int):
    return SourceLocation(
        line=node.lineno + line_offset,
        column=node.col_offset + col_offset + 1,
        filename=filename,
        end_line=getattr(node, "end_lineno", node.lineno) + line_offset,
        end_column=(getattr(node, "end_col_offset", node.col_offset) or 0)
        + col_offset
        + 1,
    )


class _ScopeChecker(ast.NodeVisitor):
    """Name-resolution walk with lexical scopes (assignments anywhere in the
    scope count as defined — runtime use-before-assign is out of scope)."""

    def __init__(self, env: set[str], filename: str, line_offset: int, col_offset: int):
        self.scopes: list[set[str]] = [set(env)]
        self.filename = filename
        self.line_offset = line_offset
        self.col_offset = col_offset

    # -- helpers -------------------------------------------------------------

    def _defined(self, name: str) -> bool:
        return any(name in s for s in self.scopes)

    def _candidates(self) -> list[str]:
        out: set[str] = set()
        for s in self.scopes:
            out |= s
        return sorted(out)

    def _collect_stores(self, node: ast.AST) -> None:
        for child in ast.walk(node):
            if isinstance(child, ast.Name) and isinstance(child.ctx, ast.Store):
                self.scopes[-1].add(child.id)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scopes[-1].add(child.name)
            elif isinstance(child, ast.NamedExpr) and isinstance(
                child.target, ast.Name
            ):
                self.scopes[-1].add(child.target.id)

    def _fail_undefined(self, node: ast.Name) -> None:
        raise errors.UndefinedSymbolError(
            _loc(node, self.filename, self.line_offset, self.col_offset),
            node.id,
            self._candidates(),
        )

    def _fail_syntax(self, node: ast.AST, message: str) -> None:
        raise errors.DSLSyntaxError(
            _loc(node, self.filename, self.line_offset, self.col_offset), message
        )

    # -- scope bodies ----------------------------------------------------------

    def check_function(self, node) -> None:
        self.scopes.append(set())
        args = node.args
        for a in (
            list(args.posonlyargs)
            + list(args.args)
            + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        ):
            self.scopes[-1].add(a.arg)
        for stmt in node.body:
            self._collect_stores(stmt)
        for stmt in node.body:
            self.visit(stmt)
        self.scopes.pop()

    # -- node rules -------------------------------------------------------------

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and not self._defined(node.id):
            self._fail_undefined(node)

    def visit_Import(self, node: ast.Import) -> None:
        self._fail_syntax(node, "Imports are not allowed inside DSL definitions.")

    visit_ImportFrom = visit_Import

    def visit_Global(self, node: ast.Global) -> None:
        self._fail_syntax(node, "'global' is not allowed inside DSL definitions.")

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._fail_syntax(node, "'nonlocal' is not allowed inside DSL definitions.")

    def visit_Yield(self, node) -> None:
        self._fail_syntax(node, "Generators are not allowed inside DSL definitions.")

    visit_YieldFrom = visit_Yield
    visit_Await = visit_Yield

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._fail_syntax(node, "Class definitions are not allowed inside DSL definitions.")

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.scopes.append({a.arg for a in node.args.args})
        self.visit(node.body)
        self.scopes.pop()

    def visit_FunctionDef(self, node) -> None:
        self.check_function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _visit_comprehension(self, node) -> None:
        self.scopes.append(set())
        for gen in node.generators:
            self._collect_stores(gen.target)
            self.visit(gen.iter)
            for cond in gen.ifs:
                self.visit(cond)
        if isinstance(node, ast.DictComp):
            self.visit(node.key)
            self.visit(node.value)
        else:
            self.visit(node.elt)
        self.scopes.pop()

    visit_ListComp = _visit_comprehension
    visit_SetComp = _visit_comprehension
    visit_GeneratorExp = _visit_comprehension
    visit_DictComp = _visit_comprehension


def _environment(fn: Callable) -> set[str]:
    env: set[str] = set(dir(builtins))
    env |= set(getattr(fn, "__globals__", {}) or {})
    closure = getattr(fn, "__closure__", None)
    if closure:
        env |= set(fn.__code__.co_freevars)
    # DSL builtins are valid even when not imported into the module scope.
    from gt4py_tpu_torch.next import fbuiltins

    env |= {n for n in dir(fbuiltins) if not n.startswith("_")}
    return env


def validate_definition(
    fn: Callable,
    *,
    kind: str = "field_operator",
    extra_symbols: Iterable[str] = (),
) -> None:
    """Raise a structured DSL error for mistakes in ``fn``'s definition.

    Soft-fails (returns) when the source is unavailable (REPL lambdas,
    exec'd code) — execution-time errors still apply."""
    parsed = _definition_source(fn)
    if parsed is None:
        return
    node, filename, line_offset, col_offset = parsed

    if kind in ("field_operator", "scan_operator"):
        if node.args.vararg is not None or node.args.kwarg is not None:
            bad = node.args.vararg or node.args.kwarg
            raise errors.DSLSyntaxError(
                _loc(bad, filename, line_offset, col_offset),
                f"*{bad.arg} parameters are not allowed on a {kind}.",
            )
        # NOTE: loops and f-strings are NOT rejected here, unlike the
        # reference (errors.UnsupportedPythonFeatureError): statically
        # unrollable Python control flow executes correctly through the
        # raw-definition fallback, with the reason recorded on the
        # operator (foast_fallback_reason) — a deliberate superset, see
        # tests/next_tests/test_foast.py::test_fallback_reason_recorded.

    if kind == "program":
        # PAST-analog lints (reference past_passes linters + ProgramLowering
        # checks, next/ffront/past_to_itir.py): a program is a sequence of
        # operator calls writing through ``out=`` — bare expressions do
        # nothing and a missing out= silently discards the result.
        for i, stmt in enumerate(node.body):
            if (
                i == 0
                and isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            ):
                continue  # docstring
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                raise errors.DSLSyntaxError(
                    _loc(stmt, filename, line_offset, col_offset),
                    "Programs do not return values; write results through "
                    "the out= argument of operator calls.",
                )
            if isinstance(stmt, ast.Expr):
                if isinstance(stmt.value, ast.Call):
                    call = stmt.value
                    if not any(kw.arg == "out" for kw in call.keywords):
                        raise errors.DSLSyntaxError(
                            _loc(stmt, filename, line_offset, col_offset),
                            "Operator calls inside a program must pass "
                            "out=<field> — without it the result is "
                            "discarded.",
                        )
                elif not isinstance(stmt.value, ast.Constant):
                    raise errors.DSLSyntaxError(
                        _loc(stmt, filename, line_offset, col_offset),
                        "This statement has no effect inside a program.",
                    )

    checker = _ScopeChecker(
        _environment(fn) | set(extra_symbols), filename, line_offset, col_offset
    )
    checker.check_function(node)
