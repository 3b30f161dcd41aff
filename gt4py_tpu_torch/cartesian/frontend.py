"""GTScript frontend: Python AST → GTIR.

Copied from gt4py_tpu/cartesian/frontend.py; imports renamed.

Behavioral counterpart of the reference's
``gt4py.cartesian.frontend.gtscript_frontend`` (GTScriptParser/IRMaker,
src/gt4py/cartesian/frontend/gtscript_frontend.py:886,2068)
collapsed into a single direct AST→GTIR translation (the reference goes
through a legacy "DefIR"; there is no need for that intermediate here).

Supported language surface (spec: docs/user/cartesian/lang_design.rst):
``computation``/``interval`` blocks, parallel assignments, temporaries,
``@gtscript.function`` inlining, ``from __externals__ import``/``__INLINED``
compile-time folding, ``compile_assert``, field/scalar if-else, ``while``,
``horizontal(region[...])`` restrictions, relative offsets, variable and
absolute K offsets (``field.at(K=...)``), data-dimension subscripts,
native math functions, axis-subset fields.
"""

from __future__ import annotations

import ast
import inspect
import numbers
import textwrap
from typing import Any, Callable, Optional, Sequence

import numpy as np

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir, gtscript
from gt4py_tpu_torch.core.definitions import bfloat16
from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype


class GTScriptSyntaxError(Exception):
    """DSL syntax/semantic error with source location."""

    def __init__(self, message: str, loc: Optional[eve.SourceLocation] = None):
        if loc is not None:
            message = f"{message} (at {loc})"
        super().__init__(message)
        self.loc = loc


class GTScriptDefinitionError(GTScriptSyntaxError):
    pass


_AST_BIN_OPS = {
    ast.Add: gtir.ArithmeticOperator.ADD,
    ast.Sub: gtir.ArithmeticOperator.SUB,
    ast.Mult: gtir.ArithmeticOperator.MUL,
    ast.Div: gtir.ArithmeticOperator.DIV,
    ast.Mod: gtir.ArithmeticOperator.MOD,
    ast.Pow: gtir.ArithmeticOperator.POW,
    ast.MatMult: gtir.ArithmeticOperator.MATMUL,
}

_AST_CMP_OPS = {
    ast.Eq: gtir.ComparisonOperator.EQ,
    ast.NotEq: gtir.ComparisonOperator.NE,
    ast.Lt: gtir.ComparisonOperator.LT,
    ast.LtE: gtir.ComparisonOperator.LE,
    ast.Gt: gtir.ComparisonOperator.GT,
    ast.GtE: gtir.ComparisonOperator.GE,
}

_AST_UNARY_OPS = {
    ast.UAdd: gtir.UnaryOperator.POS,
    ast.USub: gtir.UnaryOperator.NEG,
    ast.Not: gtir.UnaryOperator.NOT,
}

_NATIVE_BY_NAME = {f.value: f for f in gtir.NativeFunction}


def _literal_dtype(value: Any, options: dict) -> np.dtype:
    if isinstance(value, (bool, np.bool_)):
        return np.dtype(np.bool_)
    if isinstance(value, (int, np.integer)):
        return np.dtype(f"int{options.get('literal_int_precision', 64)}")
    if isinstance(value, (float, np.floating)):
        prec = options.get("literal_float_precision", 64)
        if prec in ("bf16", "bfloat16"):
            return bfloat16
        return np.dtype(f"float{prec}")
    raise GTScriptSyntaxError(f"Unsupported literal value: {value!r}")


def _value_to_literal(value: Any, options: dict) -> gtir.Literal:
    if isinstance(value, np.generic):
        return gtir.Literal(value=value, dtype=value.dtype)
    if isinstance(value, (bool, int, float)):
        return gtir.Literal(value=value, dtype=_literal_dtype(value, options))
    raise GTScriptSyntaxError(f"Cannot use value of type {type(value).__name__} in a stencil")


def _axis_index_to_bound(ai: gtscript.AxisIndex) -> gtir.AxisBound:
    total = ai.index + ai.offset
    if ai.index >= 0:
        return gtir.AxisBound.start(total)
    return gtir.AxisBound.end(total)


def _region_spec_to_interval(spec: Any) -> gtir.HorizontalInterval:
    if isinstance(spec, slice):
        start = None if spec.start is None else _axis_index_to_bound(spec.start)
        end = None if spec.stop is None else _axis_index_to_bound(spec.stop)
        return gtir.HorizontalInterval(start=start, end=end)
    if isinstance(spec, gtscript.AxisIndex):
        start = _axis_index_to_bound(spec)
        return gtir.HorizontalInterval(
            start=start, end=gtir.AxisBound(level=start.level, offset=start.offset + 1)
        )
    raise GTScriptSyntaxError(f"Invalid region specification: {spec!r}")


def _region_mask_to_ir(mask: "gtscript._RegionMask") -> gtir.HorizontalMask:
    return gtir.HorizontalMask(
        i=_region_spec_to_interval(mask.i_spec), j=_region_spec_to_interval(mask.j_spec)
    )


def _resolve_dtype(spec: Any, dtypes: dict) -> np.dtype:
    if isinstance(spec, str):
        if spec not in dtypes:
            raise GTScriptDefinitionError(
                f"Missing value for dtype key '{spec}' (pass it via the 'dtypes' option)"
            )
        spec = dtypes[spec]
    return numpy_dtype(spec)  # torch dtypes and "bfloat16" too


class _FunctionScope:
    """Inlining scope for one ``@gtscript.function`` call: maps the callee's
    parameter names to caller-side GTIR expressions and renames callee locals
    (reference: CallInliner, gtscript_frontend.py:488)."""

    def __init__(self, subs: dict[str, gtir.Expr], prefix: str, env: dict):
        self.subs = subs
        self.prefix = prefix
        self.env = env
        self.local_names: dict[str, str] = {}


class IRMaker(ast.NodeVisitor):
    """Translate one stencil definition function body to GTIR."""

    def __init__(
        self,
        *,
        fields: dict[str, gtir.FieldDecl],
        scalars: dict[str, gtir.ScalarDecl],
        tables: dict[str, gtir.GlobalTableDecl],
        env: dict,
        options: dict,
        filename: str,
        line_offset: int = 0,
    ):
        self.fields = fields
        self.scalars = scalars
        self.tables = tables
        self.base_env = env
        self.options = options
        self.filename = filename
        self.line_offset = line_offset
        self.temps: dict[str, gtir.Temporary] = {}
        self.externals_used: dict[str, Any] = {}
        self._inline_counter = 0
        # Stack of function-inlining scopes; empty = stencil main scope.
        self._scopes: list[_FunctionScope] = []
        # Statements produced while translating a sub-expression (function
        # inlining hoists callee statements before the current statement).
        self._prelude: list[gtir.Stmt] = []

    # -- helpers -------------------------------------------------------------

    def _loc(self, node: ast.AST) -> eve.SourceLocation:
        return eve.SourceLocation(
            line=getattr(node, "lineno", 0) + self.line_offset,
            column=getattr(node, "col_offset", 0),
            filename=self.filename,
        )

    def _error(self, msg: str, node: ast.AST) -> GTScriptSyntaxError:
        return GTScriptSyntaxError(msg, self._loc(node))

    @property
    def _local_symbol_names(self) -> set[str]:
        names = set(self.fields) | set(self.scalars) | set(self.tables) | set(self.temps)
        if self._scopes:
            scope = self._scopes[-1]
            names |= set(scope.subs) | set(scope.local_names)
        return names

    def _eval_env(self) -> dict:
        env = dict(gtscript.MATH_BUILTINS)
        for name in ("computation", "interval", "horizontal", "region", "I", "J", "K"):
            env.setdefault(name, getattr(gtscript, name))
        env.update({"PARALLEL": "PARALLEL", "FORWARD": "FORWARD", "BACKWARD": "BACKWARD"})
        env["__INLINED"] = getattr(gtscript, "__INLINED")
        env["compile_assert"] = gtscript.compile_assert
        if self._scopes:
            env.update(self._scopes[-1].env)
        else:
            env.update(self.base_env)
        # Local symbols shadow module-level names.
        for name in self._local_symbol_names:
            env.pop(name, None)
        return env

    def _try_eval(self, node: ast.AST) -> tuple[bool, Any]:
        """Try to evaluate an AST expression at compile time against externals
        and module globals (the reference achieves this with ValueInliner +
        CompiledIfInliner, gtscript_frontend.py:411,747).

        The underlying exception is kept on ``self._last_eval_error`` so
        call sites that REQUIRE a compile-time value (e.g. ``with`` clause
        headers) can surface the real cause instead of a generic message
        (the reference reports these precisely, round-1 review weak #8)."""
        try:
            code = compile(ast.Expression(body=_strip_locations(node)), "<gtscript>", "eval")
            value = eval(code, {"__builtins__": __builtins__}, self._eval_env())
            self._last_eval_error = None
            return True, value
        except Exception as e:
            self._last_eval_error = e
            return False, None

    def _eval_cause(self) -> str:
        e = getattr(self, "_last_eval_error", None)
        return f": {type(e).__name__}: {e}" if e is not None else ""

    def _resolve_name(self, name: str, node: ast.AST) -> Any:
        """Resolve a bare name to a GTIR expression."""
        if self._scopes:
            scope = self._scopes[-1]
            if name in scope.subs:
                return scope.subs[name]
            if name in scope.local_names:
                name = scope.local_names[name]
        if name in self.fields:
            decl = self.fields[name]
            return gtir.FieldAccess(name=name, dtype=decl.dtype)
        if name in self.scalars:
            return gtir.ScalarAccess(name=name, dtype=self.scalars[name].dtype)
        if name in self.tables:
            raise self._error(f"GlobalTable '{name}' must be subscripted", node)
        if name in self.temps:
            return gtir.FieldAccess(name=name)
        ok, value = self._try_eval(node)
        if ok:
            if isinstance(value, (bool, int, float, np.generic)):
                self.externals_used[name] = value
                return _value_to_literal(value, self.options)
            if isinstance(value, gtscript.Axis):
                # Current-K iterator access: the axis name K used as a value
                # yields the K iteration index (reference IteratorAccess,
                # gtscript_frontend.py:860,1298 — only K can be queried).
                if value.name != "K":
                    raise self._error(
                        f"Parallel axis {value.name} can't be queried - only K", node
                    )
                prec = self.options.get("literal_int_precision", 64)
                return gtir.IteratorAccess(axis="K", dtype=np.dtype(f"int{prec}"))
            raise self._error(
                f"Name '{name}' resolves to a {type(value).__name__}; only numeric "
                "externals can be used as values",
                node,
            )
        raise self._error(f"Unknown symbol '{name}'", node)

    def _target_name(self, name: str) -> str:
        """Resolve an assignment-target name in the current scope, creating
        temporaries on first write."""
        if self._scopes:
            scope = self._scopes[-1]
            if name in scope.subs:
                sub = scope.subs[name]
                if isinstance(sub, gtir.FieldAccess) and sub.offset == (0, 0, 0):
                    return sub.name
                raise GTScriptSyntaxError(
                    f"Cannot assign to function parameter '{name}' bound to an expression"
                )
            if name not in scope.local_names:
                scope.local_names[name] = f"{scope.prefix}{name}"
            name = scope.local_names[name]
        if name in self.scalars:
            raise GTScriptSyntaxError(f"Cannot assign to scalar parameter '{name}'")
        if name in self.tables:
            raise GTScriptSyntaxError(f"Cannot assign to GlobalTable '{name}'")
        if name not in self.fields and name not in self.temps:
            self.temps[name] = gtir.Temporary(name=name)
        return name

    # -- top level -----------------------------------------------------------

    def parse_body(self, body: list[ast.stmt]) -> list[gtir.VerticalLoop]:
        loops: list[gtir.VerticalLoop] = []
        for node in body:
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
                continue  # docstring
            if isinstance(node, ast.ImportFrom):
                self._handle_externals_import(node)
                continue
            if isinstance(node, ast.With):
                loops.append(self._parse_computation(node))
                continue
            raise self._error(
                "Only 'with computation(...)' blocks and '__externals__' imports are "
                "allowed at stencil top level",
                node,
            )
        if not loops:
            raise GTScriptSyntaxError("A stencil must contain at least one computation")
        return loops

    def _handle_externals_import(self, node: ast.ImportFrom) -> None:
        if node.module != "__externals__":
            raise self._error(f"Cannot import from '{node.module}' inside a stencil", node)
        env = self._eval_env()
        for alias in node.names:
            if alias.name not in env:
                raise self._error(f"Missing external '{alias.name}'", node)
            # Names imported from __externals__ resolve through the eval env;
            # record usage for the fingerprint.
            self.externals_used[alias.asname or alias.name] = env[alias.name]

    def _parse_computation(self, node: ast.With) -> gtir.VerticalLoop:
        ctx_objs = []
        for item in node.items:
            ok, value = self._try_eval(item.context_expr)
            if not ok:
                raise self._error(
                    "Invalid 'with' clause in computation"
                    + self._eval_cause(),
                    item.context_expr,
                )
            ctx_objs.append(value)
        if not isinstance(ctx_objs[0], gtscript._ComputationContext):
            raise self._error("Expected 'with computation(...)'", node)
        order = gtir.LoopOrder[ctx_objs[0].order]
        sections: list[gtir.VerticalSection] = []
        if len(ctx_objs) > 1:
            if len(ctx_objs) != 2 or not isinstance(ctx_objs[1], gtscript._IntervalContext):
                raise self._error("Expected 'with computation(...), interval(...)'", node)
            sections.append(self._parse_section(ctx_objs[1], node.body, node))
        else:
            body_is_intervals = all(
                isinstance(sub, ast.With)
                and (iv := self._with_interval(sub)) is not None  # noqa: F841
                for sub in node.body
            )
            if body_is_intervals:
                for sub in node.body:
                    assert isinstance(sub, ast.With)
                    iv = self._with_interval(sub)
                    assert iv is not None
                    sections.append(self._parse_section(iv, sub.body, sub))
            else:
                sections.append(self._parse_section(gtscript.interval(...), node.body, node))
        _validate_sections(order, sections, node, self)
        return gtir.VerticalLoop(loop_order=order, sections=sections, loc=self._loc(node))

    def _with_interval(self, node: ast.With) -> Optional[gtscript._IntervalContext]:
        if len(node.items) != 1:
            return None
        ok, value = self._try_eval(node.items[0].context_expr)
        if ok and isinstance(value, gtscript._IntervalContext):
            return value
        return None

    def _parse_section(
        self, iv: "gtscript._IntervalContext", body: list[ast.stmt], node: ast.AST
    ) -> gtir.VerticalSection:
        def to_bound(v: Any, *, is_end: bool) -> gtir.AxisBound:
            """Bound forms (reference gtscript_frontend.py:130-153): int
            (negative = from the domain end), None (full extent), or a
            K ``AxisIndex`` expression like ``K[2] + 1`` / ``K[-1]``."""
            if v is None or isinstance(v, (int, np.integer)):
                return gtir.AxisBound.from_int(
                    None if v is None else int(v), is_end=is_end
                )
            if isinstance(v, gtscript.AxisIndex):
                if v.axis != "K":
                    raise self._error(
                        f"Interval bounds must be on the K axis, got {v.axis}", node
                    )
                return _axis_index_to_bound(v)
            raise self._error(
                "Interval bounds must be compile-time integers or K axis indices "
                f"(e.g. K[2] + 1), got {type(v).__name__}",
                node,
            )

        start = to_bound(iv.start, is_end=False)
        end = to_bound(iv.end, is_end=True)
        stmts: list[gtir.Stmt] = []
        for sub in body:
            stmts.extend(self.visit_stmt(sub))
        return gtir.VerticalSection(
            interval=gtir.Interval(start=start, end=end), body=stmts, loc=self._loc(node)
        )

    # -- statements ----------------------------------------------------------

    def visit_stmt(self, node: ast.stmt) -> list[gtir.Stmt]:
        self._prelude = []
        if isinstance(node, ast.Assign):
            result = self._visit_assign(node)
        elif isinstance(node, ast.AugAssign):
            result = self._visit_aug_assign(node)
        elif isinstance(node, ast.AnnAssign):
            result = self._visit_ann_assign(node)
        elif isinstance(node, ast.If):
            result = self._visit_if(node)
        elif isinstance(node, ast.While):
            result = self._visit_while(node)
        elif isinstance(node, ast.With):
            result = self._visit_horizontal(node)
        elif isinstance(node, ast.ImportFrom):
            self._handle_externals_import(node)
            result = []
        elif isinstance(node, ast.Expr):
            result = self._visit_expr_stmt(node)
        elif isinstance(node, ast.Pass):
            result = []
        elif isinstance(node, ast.Return):
            raise self._error("'return' is not allowed inside a stencil", node)
        else:
            raise self._error(f"Unsupported statement: {type(node).__name__}", node)
        prelude, self._prelude = self._prelude, []
        return prelude + result

    def _visit_expr_stmt(self, node: ast.Expr) -> list[gtir.Stmt]:
        if isinstance(node.value, ast.Constant):
            return []
        if isinstance(node.value, ast.Call):
            func = node.value.func
            if isinstance(func, ast.Name) and func.id == "compile_assert":
                if len(node.value.args) != 1:
                    raise self._error("compile_assert takes exactly one argument", node)
                ok, value = self._try_eval(node.value.args[0])
                if not ok:
                    raise self._error(
                        "compile_assert argument must be evaluable at compile time", node
                    )
                if not value:
                    raise GTScriptDefinitionError(
                        f"compile_assert failed: {ast.unparse(node.value.args[0])}",
                        self._loc(node),
                    )
                return []
        raise self._error("Expression statements have no effect in stencils", node)

    def _make_assign(
        self, target_node: ast.expr, value: gtir.Expr, node: ast.stmt
    ) -> gtir.Assign:
        target = self._parse_assign_target(target_node)
        return gtir.Assign(target=target, value=value, loc=self._loc(node))

    def _parse_assign_target(self, node: ast.expr) -> gtir.FieldAccess:
        if isinstance(node, ast.Name):
            name = self._target_name(node.id)
            return gtir.FieldAccess(name=name)
        if isinstance(node, ast.Subscript):
            access = self.visit_expr(node)
            if not isinstance(access, gtir.FieldAccess):
                raise self._error("Invalid assignment target", node)
            if access.offset[0] != 0 or access.offset[1] != 0:
                raise self._error(
                    "Assignments must be at zero offset in I and J", node
                )
            if access.abs_k is not None:
                raise self._error(
                    "Assignments to absolute K indices are not supported", node
                )
            # K offsets (static or variable) are allowed; sequential-order
            # validation happens per computation block (reference
            # gtscript_frontend K-offset-write support; PARALLEL rejected
            # in _validate_sections).
            return access
        raise self._error("Invalid assignment target", node)

    def _visit_assign(self, node: ast.Assign) -> list[gtir.Stmt]:
        if len(node.targets) != 1:
            raise self._error("Chained assignments are not supported", node)
        target = node.targets[0]
        if isinstance(target, ast.Tuple):
            value = self.visit_expr(node.value, allow_tuple=True)
            values = value if isinstance(value, tuple) else None
            if values is None or len(values) != len(target.elts):
                raise self._error("Mismatched tuple assignment", node)
            return [self._make_assign(t, v, node) for t, v in zip(target.elts, values)]
        value = self.visit_expr(node.value)
        return [self._make_assign(target, value, node)]

    def _visit_ann_assign(self, node: ast.AnnAssign) -> list[gtir.Stmt]:
        if node.value is None:
            raise self._error("Annotated declarations require a value", node)
        value = self.visit_expr(node.value)
        # The annotation forces the temporary dtype (cast applied by the
        # type-inference pass).
        stmt = self._make_assign(node.target, value, node)
        ok, ann = self._try_eval(node.annotation)
        if ok and isinstance(stmt.target, gtir.FieldAccess) and stmt.target.name in self.temps:
            try:
                self.temps[stmt.target.name].dtype = _resolve_dtype(
                    ann, self.options.get("dtypes", {})
                )
            except TypeError:
                pass
        return [stmt]

    def _visit_aug_assign(self, node: ast.AugAssign) -> list[gtir.Stmt]:
        op = _AST_BIN_OPS.get(type(node.op))
        if op is None:
            raise self._error(f"Unsupported augmented assignment: {type(node.op).__name__}", node)
        read = self.visit_expr(node.target)
        value = self.visit_expr(node.value)
        return [
            self._make_assign(
                node.target, gtir.BinaryOp(op=op, left=read, right=value), node
            )
        ]

    def _visit_if(self, node: ast.If) -> list[gtir.Stmt]:
        # Compile-time conditional (__INLINED or external-only condition).
        ok, value = self._try_eval(node.test)
        if ok and isinstance(value, (bool, np.bool_, int, np.integer)):
            chosen = node.body if value else node.orelse
            stmts: list[gtir.Stmt] = []
            for sub in chosen:
                stmts.extend(self.visit_stmt(sub))
            return stmts
        # Function calls in if conditions are rejected (reference
        # gtscript_frontend.py TestFunctionIfError: inlining a subroutine
        # inside a condition context is unsound).
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call):
                ok_f, fval = self._try_eval(sub.func)
                if ok_f and gtscript.is_gtscript_function(fval):
                    raise self._error(
                        "Using function calls in the condition of an if is "
                        "not allowed",
                        node,
                    )
        cond = self.visit_expr(node.test)
        body: list[gtir.Stmt] = []
        for sub in node.body:
            body.extend(self.visit_stmt(sub))
        orelse: list[gtir.Stmt] = []
        for sub in node.orelse:
            orelse.extend(self.visit_stmt(sub))
        is_scalar = not any(
            isinstance(n, (gtir.FieldAccess, gtir.IteratorAccess))
            for n in eve.walk_values(cond)
        )
        return [
            gtir.If(cond=cond, body=body, orelse=orelse, is_scalar=is_scalar, loc=self._loc(node))
        ]

    def _visit_while(self, node: ast.While) -> list[gtir.Stmt]:
        if node.orelse:
            raise self._error("'while ... else' is not supported", node)
        cond = self.visit_expr(node.test)
        body: list[gtir.Stmt] = []
        for sub in node.body:
            body.extend(self.visit_stmt(sub))
        return [gtir.While(cond=cond, body=body, loc=self._loc(node))]

    def _visit_horizontal(self, node: ast.With) -> list[gtir.Stmt]:
        if len(node.items) != 1:
            raise self._error("Invalid 'with' block inside computation", node)
        ok, ctx = self._try_eval(node.items[0].context_expr)
        if not ok or not isinstance(ctx, gtscript._HorizontalContext):
            raise self._error(
                "Only 'with horizontal(region[...])' blocks are allowed inside computations"
                + ("" if ok else self._eval_cause()),
                node,
            )
        if getattr(self, "_in_horizontal", False):
            raise self._error(
                "Nested 'with horizontal(...)' regions are not allowed",
                node,
            )
        self._in_horizontal = True
        try:
            body: list[gtir.Stmt] = []
            for sub in node.body:
                body.extend(self.visit_stmt(sub))
        finally:
            self._in_horizontal = False
        return [
            gtir.HorizontalRestriction(
                mask=_region_mask_to_ir(mask), body=list(body), loc=self._loc(node)
            )
            for mask in ctx.masks
        ]

    # -- expressions ---------------------------------------------------------

    def visit_expr(self, node: ast.expr, *, allow_tuple: bool = False) -> Any:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (bool, int, float)):
                return _value_to_literal(node.value, self.options)
            raise self._error(f"Unsupported literal: {node.value!r}", node)
        if isinstance(node, ast.Name):
            return self._resolve_name(node.id, node)
        if isinstance(node, ast.Subscript):
            return self._visit_subscript(node)
        if isinstance(node, ast.BinOp):
            op = _AST_BIN_OPS.get(type(node.op))
            if op is None:
                raise self._error(f"Unsupported operator: {type(node.op).__name__}", node)
            return gtir.BinaryOp(
                op=op, left=self.visit_expr(node.left), right=self.visit_expr(node.right)
            )
        if isinstance(node, ast.UnaryOp):
            op = _AST_UNARY_OPS.get(type(node.op))
            if op is None:
                raise self._error(f"Unsupported unary operator: {type(node.op).__name__}", node)
            expr = self.visit_expr(node.operand)
            if (
                op in (gtir.UnaryOperator.NEG, gtir.UnaryOperator.POS)
                and isinstance(expr, gtir.Literal)
                and isinstance(expr.value, numbers.Number)
                and not isinstance(expr.value, bool)
            ):
                value = expr.value if op == gtir.UnaryOperator.POS else -expr.value
                return gtir.Literal(value=value, dtype=expr.dtype)
            return gtir.UnaryOp(op=op, expr=expr)
        if isinstance(node, ast.Compare):
            return self._visit_compare(node)
        if isinstance(node, ast.BoolOp):
            op = (
                gtir.LogicalOperator.AND
                if isinstance(node.op, ast.And)
                else gtir.LogicalOperator.OR
            )
            result = self.visit_expr(node.values[0])
            for v in node.values[1:]:
                result = gtir.BinaryOp(op=op, left=result, right=self.visit_expr(v))
            return result
        if isinstance(node, ast.IfExp):
            return gtir.TernaryOp(
                cond=self.visit_expr(node.test),
                true_expr=self.visit_expr(node.body),
                false_expr=self.visit_expr(node.orelse),
            )
        if isinstance(node, ast.Call):
            return self._visit_call(node, allow_tuple=allow_tuple)
        if isinstance(node, ast.Tuple) and allow_tuple:
            return tuple(self.visit_expr(e) for e in node.elts)
        if isinstance(node, ast.Attribute):
            ok, value = self._try_eval(node)
            if ok and isinstance(value, (bool, int, float, np.generic)):
                return _value_to_literal(value, self.options)
        raise self._error(f"Unsupported expression: {type(node).__name__}", node)

    def _visit_compare(self, node: ast.Compare) -> gtir.Expr:
        left = self.visit_expr(node.left)
        result: Optional[gtir.Expr] = None
        for op_node, comp in zip(node.ops, node.comparators):
            op = _AST_CMP_OPS.get(type(op_node))
            if op is None:
                raise self._error(f"Unsupported comparison: {type(op_node).__name__}", node)
            right = self.visit_expr(comp)
            pair = gtir.BinaryOp(op=op, left=left, right=right)
            result = (
                pair
                if result is None
                else gtir.BinaryOp(op=gtir.LogicalOperator.AND, left=result, right=pair)
            )
            left = right
        assert result is not None
        return result

    def _offset_element(self, node: ast.expr, axis: int) -> tuple[int, Optional[gtir.Expr]]:
        """Parse one element of an offset tuple: compile-time int, axis-style
        offset (``I - 1``), or — for K only — a runtime integer expression
        (variable K offset, reference gtir.py:50)."""
        ok, value = self._try_eval(node)
        if ok:
            if isinstance(value, (int, np.integer)):
                return int(value), None
            if isinstance(value, gtscript.Axis):
                return 0, None
            if isinstance(value, gtscript.ShiftedAxis):
                return value.shift, None
        if axis == 2:
            expr = self.visit_expr(node)
            return 0, expr
        raise self._error("Horizontal offsets must be compile-time integers", node)

    def _visit_subscript(self, node: ast.Subscript) -> gtir.Expr:
        base = node.value
        # Chained subscript: field[offset][data_index...]
        if isinstance(base, ast.Subscript):
            access = self._visit_subscript(base)
            if not isinstance(access, gtir.FieldAccess):
                raise self._error("Invalid data-dimension subscript", node)
            index = self._parse_index_elements(node.slice)
            decl = self.fields.get(access.name) or self.temps.get(access.name)
            ddims = tuple(getattr(decl, "data_dims", ()) or ())
            if ddims:
                prior = len(access.data_index)
                if prior + len(index) > len(ddims):
                    raise self._error(
                        f"Field '{access.name}' has {len(ddims)} data "
                        f"dimensions, got {prior + len(index)} data indices",
                        node,
                    )
                for pos, e in enumerate(index):
                    if isinstance(e, gtir.Literal):
                        v = int(e.value)
                        bound = ddims[prior + pos]
                        if not (0 <= v < bound):
                            raise self._error(
                                f"Data index {v} out of bounds for data "
                                f"dimension of size {bound} of field "
                                f"'{access.name}'",
                                node,
                            )
            return access.copy(data_index=tuple(index))
        if isinstance(base, ast.Name):
            resolved = None
            name = base.id
            if self._scopes and name in self._scopes[-1].subs:
                resolved = self._scopes[-1].subs[name]
                if not isinstance(resolved, gtir.FieldAccess):
                    raise self._error(
                        f"Cannot subscript function argument '{name}' (not a field)", node
                    )
            elif self._scopes and name in self._scopes[-1].local_names:
                name = self._scopes[-1].local_names[name]

            if name in self.tables:
                index = self._parse_index_elements(node.slice)
                decl = self.tables[name]
                if len(index) != len(decl.shape):
                    raise self._error(
                        f"GlobalTable '{name}' expects {len(decl.shape)} indices", node
                    )
                return gtir.FieldAccess(
                    name=name, data_index=tuple(index), dtype=decl.dtype
                )
            if name in self.fields or name in self.temps or resolved is not None:
                decl = self.fields.get(name)
                mask = decl.dimensions if decl is not None else (True, True, True)
                n_spatial = sum(mask)
                elements = (
                    node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
                )
                if len(elements) != n_spatial:
                    raise self._error(
                        f"Field '{name}' expects {n_spatial} offsets, got {len(elements)}",
                        node,
                    )
                offset = [0, 0, 0]
                koffset: Optional[gtir.Expr] = None
                spatial_axes = [i for i, m in enumerate(mask) if m]
                for axis, elem in zip(spatial_axes, elements):
                    off, kexpr = self._offset_element(elem, axis)
                    offset[axis] = off
                    if kexpr is not None:
                        koffset = kexpr
                if resolved is not None:
                    # Compose with the substituted access (function inlining).
                    if resolved.koffset is not None or resolved.abs_k is not None:
                        if any(offset) or koffset is not None:
                            raise self._error(
                                "Cannot offset a variable-K function argument", node
                            )
                        return resolved
                    new_offset = tuple(a + b for a, b in zip(resolved.offset, offset))
                    return resolved.copy(offset=new_offset, koffset=koffset)
                return gtir.FieldAccess(
                    name=name,
                    offset=(offset[0], offset[1], offset[2]),
                    koffset=koffset,
                    dtype=decl.dtype if decl is not None else None,
                )
        raise self._error("Unsupported subscript expression", node)

    def _parse_index_elements(self, slice_node: ast.expr) -> list[gtir.Expr]:
        elements = slice_node.elts if isinstance(slice_node, ast.Tuple) else [slice_node]
        return [self.visit_expr(e) for e in elements]

    def _visit_call(self, node: ast.Call, *, allow_tuple: bool = False) -> Any:
        # field.at(K=expr) — absolute K indexing (reference gtscript.py:734)
        if isinstance(node.func, ast.Attribute) and node.func.attr == "at":
            access = self.visit_expr(node.func.value)
            if not isinstance(access, gtir.FieldAccess):
                raise self._error("'.at' requires a field", node)
            kwargs = {kw.arg: kw.value for kw in node.keywords}
            if set(kwargs) != {"K"} or node.args:
                raise self._error("'.at' accepts exactly one keyword argument K", node)
            abs_k = self.visit_expr(kwargs["K"])
            if isinstance(abs_k, gtir.IteratorAccess):
                # Reference parity (gtscript_frontend.py:1696): `.at(K=K)` is
                # an absolute index equal to the current position — it is
                # just `field` and almost certainly a user mistake.
                raise self._error(
                    "'.at(K=K)' denotes an absolute index and is equivalent to "
                    "'field[0, 0, 0]' — write the field name directly",
                    node,
                )
            return access.copy(abs_k=abs_k)

        ok, func_obj = self._try_eval(node.func)
        if not ok:
            raise self._error(f"Unknown function '{ast.unparse(node.func)}'", node)

        if func_obj is getattr(gtscript, "__INLINED"):
            if len(node.args) != 1:
                raise self._error("__INLINED takes exactly one argument", node)
            ok, value = self._try_eval(node.args[0])
            if not ok:
                raise self._error("__INLINED argument must be a compile-time expression", node)
            return _value_to_literal(value, self.options)

        if isinstance(func_obj, gtscript._MathBuiltin):
            name = func_obj.name
            native = _NATIVE_BY_NAME[name]
            args = [self.visit_expr(a) for a in node.args]
            if len(args) != native.arity:
                raise self._error(
                    f"'{name}' expects {native.arity} arguments, got {len(args)}", node
                )
            return gtir.NativeFuncCall(func=native, args=args)

        builtin_name = getattr(func_obj, "__name__", None)
        if func_obj in (abs, min, max) or builtin_name in ("abs", "min", "max"):
            args = [self.visit_expr(a) for a in node.args]
            name = builtin_name if builtin_name in ("abs", "min", "max") else func_obj.__name__
            if name == "abs":
                if len(args) != 1:
                    raise self._error("abs expects one argument", node)
                return gtir.NativeFuncCall(func=gtir.NativeFunction.ABS, args=args)
            if len(args) < 2:
                raise self._error(f"{name} expects at least two arguments", node)
            native = gtir.NativeFunction.MIN if name == "min" else gtir.NativeFunction.MAX
            result = args[0]
            for a in args[1:]:
                result = gtir.NativeFuncCall(func=native, args=[result, a])
            return result

        if gtscript.is_gtscript_function(func_obj):
            return self._inline_function(func_obj, node, allow_tuple=allow_tuple)

        raise self._error(
            f"Cannot call '{ast.unparse(node.func)}' inside a stencil "
            "(not a gtscript.function or math builtin)",
            node,
        )

    # -- function inlining ---------------------------------------------------

    def _inline_function(self, func_obj: Callable, node: ast.Call, *, allow_tuple: bool) -> Any:
        fn_ast, fn_env, filename, line_offset = _get_function_ast(func_obj)
        params = [a.arg for a in fn_ast.args.args]
        kwonly = [a.arg for a in fn_ast.args.kwonlyargs]
        subs: dict[str, gtir.Expr] = {}
        if len(node.args) > len(params):
            raise self._error(f"Too many arguments for '{func_obj.__name__}'", node)
        for pname, arg in zip(params, node.args):
            subs[pname] = self.visit_expr(arg)
        for kw in node.keywords:
            if kw.arg is None or kw.arg in subs or kw.arg not in (params + kwonly):
                raise self._error(
                    f"Invalid keyword argument '{kw.arg}' for '{func_obj.__name__}'", node
                )
            subs[kw.arg] = self.visit_expr(kw.value)
        # Defaults for unbound parameters.
        defaults = _get_default_map(fn_ast)
        for pname in params + kwonly:
            if pname not in subs:
                if pname in defaults:
                    ok, value = self._try_eval(defaults[pname])
                    if not ok:
                        raise self._error(
                            f"Cannot evaluate default for '{pname}' of '{func_obj.__name__}'",
                            node,
                        )
                    subs[pname] = _value_to_literal(value, self.options)
                else:
                    raise self._error(
                        f"Missing argument '{pname}' for '{func_obj.__name__}'", node
                    )

        n_returns = sum(
            isinstance(s, ast.Return) for s in ast.walk(fn_ast)
        )
        if n_returns > 1:
            raise self._error(
                f"Function '{func_obj.__name__}' should have a single "
                "return statement",
                node,
            )
        self._inline_counter += 1
        prefix = f"_{func_obj.__name__}_{self._inline_counter}_"
        scope = _FunctionScope(subs=subs, prefix=prefix, env=fn_env)
        self._scopes.append(scope)
        outer_prelude = self._prelude
        self._prelude = []
        try:
            return_value: Any = None
            for stmt in fn_ast.body:
                if isinstance(stmt, ast.Return):
                    if stmt.value is None:
                        raise self._error(
                            f"Function '{func_obj.__name__}' must return a value", node
                        )
                    return_value = self.visit_expr(stmt.value, allow_tuple=True)
                    break
                if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
                    continue
                inner_stmts = self._visit_function_stmt(stmt)
                self._prelude.extend(inner_stmts)
            if return_value is None:
                raise self._error(f"Function '{func_obj.__name__}' has no return", node)
        finally:
            self._scopes.pop()
            inlined_stmts = self._prelude
            self._prelude = outer_prelude
        self._prelude.extend(inlined_stmts)
        if isinstance(return_value, tuple) and not allow_tuple:
            raise self._error(
                f"Function '{func_obj.__name__}' returns multiple values here", node
            )
        return return_value

    def _visit_function_stmt(self, node: ast.stmt) -> list[gtir.Stmt]:
        """Visit a statement inside an inlined function body (no nested
        prelude reset — the caller manages the prelude buffer)."""
        if isinstance(node, ast.Assign):
            return self._visit_assign(node)
        if isinstance(node, ast.AugAssign):
            return self._visit_aug_assign(node)
        if isinstance(node, ast.AnnAssign):
            return self._visit_ann_assign(node)
        if isinstance(node, ast.If):
            return self._visit_if(node)
        if isinstance(node, ast.While):
            return self._visit_while(node)
        if isinstance(node, ast.With):
            return self._visit_horizontal(node)
        if isinstance(node, ast.Pass):
            return []
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            return []
        raise self._error(
            f"Unsupported statement in gtscript.function: {type(node).__name__}", node
        )


def _strip_locations(node: ast.AST) -> ast.AST:
    import copy

    node = copy.deepcopy(node)
    return ast.fix_missing_locations(node)


def _get_default_map(fn_ast: ast.FunctionDef) -> dict[str, ast.expr]:
    defaults: dict[str, ast.expr] = {}
    pos = fn_ast.args.args
    for name_node, default in zip(pos[len(pos) - len(fn_ast.args.defaults):], fn_ast.args.defaults):
        defaults[name_node.arg] = default
    for name_node, default in zip(fn_ast.args.kwonlyargs, fn_ast.args.kw_defaults):
        if default is not None:
            defaults[name_node.arg] = default
    return defaults


_function_ast_cache: dict[Any, tuple] = {}


def _get_function_ast(func: Callable) -> tuple[ast.FunctionDef, dict, str, int]:
    key = getattr(func, "__wrapped__", func)
    if key in _function_ast_cache:
        return _function_ast_cache[key]
    source = textwrap.dedent(inspect.getsource(key))
    module = ast.parse(source)
    fn_ast = module.body[0]
    if not isinstance(fn_ast, ast.FunctionDef):
        raise GTScriptDefinitionError(f"Cannot parse function {func!r}")
    fn_ast.decorator_list = []
    env = dict(getattr(key, "__globals__", {}))
    closure = inspect.getclosurevars(key)
    env.update(closure.nonlocals)
    filename = inspect.getsourcefile(key) or "<unknown>"
    try:
        line_offset = inspect.getsourcelines(key)[1] - 1
    except OSError:
        line_offset = 0
    result = (fn_ast, env, filename, line_offset)
    _function_ast_cache[key] = result
    return result


def _validate_sections(
    order: gtir.LoopOrder,
    sections: list[gtir.VerticalSection],
    node: ast.AST,
    maker: IRMaker,
) -> None:
    """Check interval sanity; normalize section order for sequential loops
    (reference orders FORWARD ascending, BACKWARD descending)."""

    def sort_key(s: gtir.VerticalSection):
        b = s.interval.start
        return (0 if b.level == gtir.LevelMarker.START else 1, b.offset)

    if order == gtir.LoopOrder.FORWARD:
        sections.sort(key=sort_key)
    elif order == gtir.LoopOrder.BACKWARD:
        sections.sort(key=sort_key, reverse=True)
    else:
        # K-offset writes are only meaningful under a defined iteration
        # order (reference gtscript_frontend.py K-offset-write check).
        # Pre-lowering statement stream: If nodes still exist here.
        def _walk_writes(stmt):
            if isinstance(stmt, gtir.Assign):
                yield stmt.target
            elif isinstance(stmt, (gtir.While, gtir.If)):
                for s in list(stmt.body) + list(getattr(stmt, "orelse", [])):
                    yield from _walk_writes(s)

        for section in sections:
            for stmt in section.body:
                for w in _walk_writes(stmt):
                    if w.offset[2] != 0 or w.koffset is not None:
                        raise maker._error(
                            "Assignment to non-zero offsets in K is not "
                            "available in PARALLEL. Choose FORWARD or "
                            "BACKWARD.",
                            node,
                        )
    # Empty / reversed intervals (same-level bounds are statically
    # comparable; reference TestIntervalSyntax test_reversed_interval):
    for s in sections:
        st, en = s.interval.start, s.interval.end
        if st.level == en.level and en.offset <= st.offset:
            raise maker._error(
                "Empty or reversed interval in computation", node
            )
    # Statically detectable overlaps (same-level bounds):
    ordered = sorted(sections, key=sort_key)
    for a, b in zip(ordered[:-1], ordered[1:]):
        ea, sb = a.interval.end, b.interval.start
        if ea.level == sb.level and ea.offset > sb.offset:
            raise maker._error("Overlapping intervals in computation", node)


# --- stencil definition parsing ----------------------------------------------


def parse_stencil(definition: Callable, options: dict) -> gtir.Stencil:
    """Parse a stencil definition function into a GTIR Stencil."""
    fn_ast, fn_env, filename, line_offset = _get_function_ast(definition)
    fn_env = dict(fn_env)
    fn_env.update(options.get("externals", {}))

    fields: dict[str, gtir.FieldDecl] = {}
    scalars: dict[str, gtir.ScalarDecl] = {}
    tables: dict[str, gtir.GlobalTableDecl] = {}
    dtypes = options.get("dtypes", {})

    annotations = _collect_annotations(definition, fn_ast, fn_env)
    sig_params = list(inspect.signature(definition).parameters.values())
    for p in sig_params:
        if p.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            raise GTScriptDefinitionError(f"Variadic parameter '{p.name}' is not allowed")
        ann = annotations.get(p.name)
        if ann is None:
            raise GTScriptDefinitionError(f"Missing type annotation for parameter '{p.name}'")
        if isinstance(ann, gtscript._FieldDescriptor):
            fields[p.name] = gtir.FieldDecl(
                name=p.name,
                dtype=_resolve_dtype(ann.dtype, dtypes),
                dimensions=ann.dimensions_mask,
                data_dims=ann.data_dims,
            )
        elif isinstance(ann, gtscript._GlobalTableDescriptor):
            tables[p.name] = gtir.GlobalTableDecl(
                name=p.name, dtype=_resolve_dtype(ann.dtype, dtypes), shape=ann.shape
            )
        else:
            scalars[p.name] = gtir.ScalarDecl(name=p.name, dtype=_resolve_dtype(ann, dtypes))

    maker = IRMaker(
        fields=fields,
        scalars=scalars,
        tables=tables,
        env=fn_env,
        options=options,
        filename=filename,
        line_offset=line_offset,
    )
    loops = maker.parse_body(fn_ast.body)

    docstring = ast.get_docstring(fn_ast) or ""
    params: list[gtir.Decl] = []
    for p in sig_params:
        params.append(
            fields.get(p.name) or scalars.get(p.name) or tables[p.name]  # type: ignore[arg-type]
        )

    stencil = gtir.Stencil(
        name=options.get("name") or definition.__name__,
        params=params,
        vertical_loops=loops,
        temporaries=list(maker.temps.values()),
        externals=dict(maker.externals_used),
        docstring=docstring,
        loc=eve.SourceLocation(line=line_offset + 1, column=0, filename=filename),
    )
    return stencil


def _collect_annotations(definition: Callable, fn_ast: ast.FunctionDef, env: dict) -> dict:
    raw = dict(getattr(definition, "__annotations__", {}))
    resolved = {}
    for name, ann in raw.items():
        if name == "return":
            continue
        # With `from __future__ import annotations` every annotation is a
        # string; a doubly-quoted one ('"name"') evaluates to a string that
        # must be resolved once more (unless it is a dtypes-dict key).
        for _ in range(2):
            if not isinstance(ann, str):
                break
            try:
                value = eval(ann, {"__builtins__": __builtins__}, dict(env))
            except Exception:
                # Not evaluable: treat as a dtypes-dict key (reference's
                # string-dtype annotations, gtscript.py dtypes option).
                break
            if isinstance(value, str) and value not in env:
                ann = value
                continue
            ann = value
        resolved[name] = ann
    return resolved
