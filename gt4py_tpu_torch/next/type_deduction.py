"""Definition-time type deduction over field-operator ASTs.

Role of the reference's FOAST type deduction
(src/gt4py/next/ffront/foast_passes/type_deduction.py,
1,108 LoC): when a field operator's parameters carry DSL annotations
(``Field[Dims[I, J], float]``, scalar kinds, ``tuple[...]``), its
definition AST is walked BEFORE the first trace, inferring a
:mod:`gt4py_tpu_torch.next.type_system` spec for every expression. Mistakes —
arithmetic on booleans, shifting a dimension the field does not have,
reducing over a missing axis, branch/return type mismatches, calling an
operator with the wrong argument types — surface as structured
:class:`gt4py_tpu_torch.next.errors.DSLTypeError` with source locations, not as
raw errors from inside the
execution.

Execution semantics stay trace-based (the definition runs on Field
pytrees); this layer is purely diagnostic, and unannotated operators are
left alone (legacy mode). The deduced signature is also used at call time
to validate concrete arguments (reference decorator.py argument checking
via type_info.accepts_args).

Promotion model: the JAX package's weak typing is mirrored for literals
— a Python scalar literal does not widen a concrete field dtype of the
same kind (``float32_field * 4.0`` stays float32); cross-kind promotion
uses NumPy rules. True division of integers yields float64, as in the JAX
package, which enables 64-bit types.

Copied from gt4py_tpu/next/type_deduction.py; imports renamed.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np

from gt4py_tpu_torch.next import errors, type_system as ts
from gt4py_tpu_torch.next.common import Dimension, DimensionKind, FieldOffset
from gt4py_tpu_torch.next.frontend_validation import _definition_source, _loc


__all__ = ["OperatorTypeInfo", "deduce", "check_call_args"]


class _Unknown:
    """Poison value: propagates silently through every rule."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<unknown>"


UNKNOWN = _Unknown()


@dataclasses.dataclass(frozen=True)
class _WeakScalar:
    """A Python literal: promotes without widening concrete dtypes of the
    same kind (JAX weak-type semantics)."""

    kind: str  # 'bool' | 'int' | 'float'

    @property
    def dtype(self) -> np.dtype:
        return np.dtype({"bool": np.bool_, "int": np.int64, "float": np.float64}[self.kind])


@dataclasses.dataclass(frozen=True)
class _OffsetTy:
    offset: FieldOffset
    index: Optional[bool] = False  # True once subscripted: Ioff[1]


@dataclasses.dataclass(frozen=True)
class _CartShiftTy:
    """Type of ``I + 1`` / ``I + 0.5`` (a CartesianConnectivity value):
    shifts within ``codomain``; when ``dim != codomain`` it premaps onto
    the staggered counterpart."""

    dim: Dimension
    codomain: Dimension


@dataclasses.dataclass(frozen=True)
class _DimCondTy:
    """Type of ``KDim < 1`` — only valid as a concat_where condition."""

    dim: Dimension


@dataclasses.dataclass(frozen=True)
class _OperatorRef:
    info: "OperatorTypeInfo"
    name: str
    # Scan-operator reference: params[0] is the implicit carry and the
    # remaining declared types are per-LEVEL element types (a Field arg of
    # any dims with a matching dtype is valid; the scan axis is implicit).
    is_scan: bool = False


@dataclasses.dataclass(frozen=True)
class _BuiltinRef:
    name: str


@dataclasses.dataclass
class OperatorTypeInfo:
    """Deduced operator signature (reference foast FieldOperatorType)."""

    params: dict[str, Any]  # name -> TypeSpec | UNKNOWN
    returns: Any = None  # TypeSpec | UNKNOWN | None (no return seen)

    def __str__(self) -> str:
        ps = ", ".join(f"{n}: {t}" for n, t in self.params.items())
        return f"({ps}) -> {self.returns}"


_MATH_UNARY_FLOAT = {
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "sqrt", "cbrt", "exp", "log",
}
_MATH_UNARY_KEEP = {"abs", "floor", "ceil", "trunc"}
_MATH_UNARY_BOOL = {"isfinite", "isinf", "isnan"}
_MATH_BINARY = {"minimum", "maximum", "fmod", "power"}
_REDUCERS = {"neighbor_sum", "max_over", "min_over"}


def _is_bool(t: Any) -> bool:
    if isinstance(t, ts.ScalarType):
        return t.dtype == np.dtype(bool)
    if isinstance(t, ts.FieldType):
        return t.dtype == np.dtype(bool)
    if isinstance(t, _WeakScalar):
        return t.kind == "bool"
    return False


def _dtype_of(t: Any) -> Optional[np.dtype]:
    if isinstance(t, (ts.ScalarType, ts.FieldType)):
        return t.dtype
    if isinstance(t, _WeakScalar):
        return t.dtype
    return None


def _dims_of(t: Any) -> tuple[Dimension, ...]:
    return t.dims if isinstance(t, ts.FieldType) else ()


def _promote_dtype(a: Any, b: Any) -> np.dtype:
    """NumPy promotion with JAX weak-literal semantics."""
    da, db = _dtype_of(a), _dtype_of(b)
    wa, wb = isinstance(a, _WeakScalar), isinstance(b, _WeakScalar)
    if wa and wb:
        return np.result_type(da, db)
    weak = a if wa else b
    if wa:
        da, db, wa, wb = db, da, wb, wa  # strong dtype first
    if wb:
        # Weak literal: keep the strong dtype unless the literal's kind is
        # wider (int field * 2.5 -> float).
        if np.dtype(da).kind in "fc" or weak.kind in ("bool", "int"):
            return np.dtype(da)
        return np.result_type(da, np.float32 if np.dtype(da).itemsize <= 4 else np.float64)
    return np.result_type(da, db)


def _combine(a: Any, b: Any, dtype: np.dtype) -> Any:
    """Result spec of a binary op over a/b with the given element dtype."""
    if isinstance(a, ts.FieldType) or isinstance(b, ts.FieldType):
        dims = ts.promote_dims(_dims_of(a), _dims_of(b))
        return ts.FieldType(dims=dims, dtype=dtype)
    return ts.ScalarType(dtype)


class _Typer(ast.NodeVisitor):
    def __init__(
        self,
        fn: Callable,
        env: dict[str, Any],
        filename: str,
        line_offset: int,
        col_offset: int,
    ):
        self.fn = fn
        self.env = env
        self.filename = filename
        self.line_offset = line_offset
        self.col_offset = col_offset
        self.return_type: Any = None
        self._saw_return = False

    # -- infrastructure ----------------------------------------------------

    def _loc(self, node: ast.AST):
        return _loc(node, self.filename, self.line_offset, self.col_offset)

    def _fail(self, node: ast.AST, msg: str):
        raise errors.DSLTypeError(self._loc(node), msg)

    def _global(self, name: str) -> Any:
        """Classify a module-level / closure value (reference closure-var
        handling in func_to_foast)."""
        g = getattr(self.fn, "__globals__", {}) or {}
        if name in g:
            return _classify_value(g[name])
        closure = getattr(self.fn, "__closure__", None)
        if closure:
            freevars = self.fn.__code__.co_freevars
            for var, cell in zip(freevars, closure):
                if var == name:
                    try:
                        return _classify_value(cell.cell_contents)
                    except ValueError:
                        return UNKNOWN
        import builtins as _b

        from gt4py_tpu_torch.next import fbuiltins

        if name in _REDUCERS or name in set(_MATH_UNARY_FLOAT) | _MATH_UNARY_KEEP | _MATH_UNARY_BOOL | _MATH_BINARY or name in (
            "broadcast", "where", "concat_where", "astype",
        ):
            return _BuiltinRef(name)
        if hasattr(fbuiltins, name) or hasattr(_b, name):
            return _BuiltinRef(name)
        return UNKNOWN

    # -- statements --------------------------------------------------------

    def type_statements(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.visit(stmt)

    def visit_Assign(self, node: ast.Assign) -> None:
        value = self.type_expr(node.value)
        for target in node.targets:
            self._bind(target, value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        value = self.type_expr(node.value) if node.value is not None else UNKNOWN
        declared = self._eval_annotation(node.annotation)
        if declared is not None and not _compatible(declared, value):
            self._fail(
                node,
                f"Annotated type {declared} does not match assigned value type "
                f"{_fmt(value)}.",
            )
        self._bind(node.target, declared if declared is not None else value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        target_t = self.type_expr(node.target)
        value_t = self.type_expr(node.value)
        result = self._binop_type(node, node.op, target_t, value_t)
        self._bind(node.target, result)

    def visit_Return(self, node: ast.Return) -> None:
        t = self.type_expr(node.value) if node.value is not None else UNKNOWN
        self._saw_return = True
        if self.return_type is None:
            self.return_type = t
        elif not _compatible(self.return_type, t):
            self._fail(
                node,
                f"Return type {_fmt(t)} conflicts with an earlier return of "
                f"type {_fmt(self.return_type)}.",
            )

    def visit_If(self, node: ast.If) -> None:
        cond = self.type_expr(node.test)
        if isinstance(cond, ts.FieldType):
            self._fail(
                node.test,
                "Condition of an if-statement must be a scalar bool; use "
                "where()/concat_where() for field-valued conditions.",
            )
        if cond is not UNKNOWN and not _is_bool(cond) and not isinstance(cond, _DimCondTy):
            self._fail(node.test, f"Condition must be bool, got {_fmt(cond)}.")
        before = dict(self.env)
        self.type_statements(node.body)
        then_env = self.env
        self.env = dict(before)
        self.type_statements(node.orelse)
        else_env = self.env
        merged = dict(before)
        for k in set(then_env) | set(else_env):
            a, b = then_env.get(k, UNKNOWN), else_env.get(k, UNKNOWN)
            merged[k] = a if _compatible(a, b) else UNKNOWN
        self.env = merged

    def visit_Expr(self, node: ast.Expr) -> None:
        self.type_expr(node.value)

    def generic_visit(self, node):
        # Statements with no dedicated rule contribute no bindings; their
        # expressions were already scope-checked by frontend_validation.
        pass

    # -- binding -----------------------------------------------------------

    def _bind(self, target: ast.expr, value: Any) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            star_idx = next(
                (i for i, e in enumerate(elts) if isinstance(e, ast.Starred)),
                None,
            )
            if isinstance(value, ts.TupleType):
                if star_idx is None:
                    if len(value.types) != len(elts):
                        self._fail(
                            target,
                            f"Cannot unpack a {len(value.types)}-tuple into "
                            f"{len(elts)} names.",
                        )
                    for e, v in zip(elts, value.types):
                        self._bind(e, v)
                else:
                    n_fixed = len(elts) - 1
                    if len(value.types) < n_fixed:
                        self._fail(
                            target,
                            f"Cannot unpack a {len(value.types)}-tuple into "
                            f"{n_fixed}+ names (starred target).",
                        )
                    n_star = len(value.types) - n_fixed
                    head, tail = elts[:star_idx], elts[star_idx + 1 :]
                    for e, v in zip(head, value.types[: len(head)]):
                        self._bind(e, v)
                    self._bind(
                        elts[star_idx].value,
                        ts.TupleType(
                            types=tuple(
                                value.types[star_idx : star_idx + n_star]
                            )
                        ),
                    )
                    for e, v in zip(tail, value.types[star_idx + n_star :]):
                        self._bind(e, v)
            else:
                for e in elts:
                    self._bind(
                        e.value if isinstance(e, ast.Starred) else e, UNKNOWN
                    )

    def _eval_annotation(self, node: ast.expr) -> Any:
        try:
            src = ast.unparse(node)
            value = eval(src, getattr(self.fn, "__globals__", {}))  # noqa: S307
        except Exception:
            return None
        return ts.from_annotation(value, getattr(self.fn, "__globals__", {}))

    # -- expressions -------------------------------------------------------

    def type_expr(self, node: Optional[ast.expr]) -> Any:
        if node is None:
            return UNKNOWN
        method = getattr(self, f"expr_{type(node).__name__}", None)
        if method is None:
            return UNKNOWN
        return method(node)

    def expr_Constant(self, node: ast.Constant) -> Any:
        v = node.value
        if isinstance(v, bool):
            return _WeakScalar("bool")
        if isinstance(v, int):
            return _WeakScalar("int")
        if isinstance(v, float):
            return _WeakScalar("float")
        return UNKNOWN

    def expr_Name(self, node: ast.Name) -> Any:
        if node.id in self.env:
            return self.env[node.id]
        return self._global(node.id)

    def expr_Tuple(self, node: ast.Tuple) -> Any:
        parts = tuple(self.type_expr(e) for e in node.elts)
        if any(p is UNKNOWN for p in parts):
            return UNKNOWN
        if not all(isinstance(p, ts.TypeSpec) for p in parts):
            return UNKNOWN
        return ts.TupleType(types=parts)

    expr_List = expr_Tuple

    def expr_Subscript(self, node: ast.Subscript) -> Any:
        base = self.type_expr(node.value)
        if isinstance(base, _OffsetTy) and not base.index:
            return _OffsetTy(base.offset, index=True)
        if isinstance(base, ts.TupleType):
            idx = node.slice
            if isinstance(idx, ast.Constant) and isinstance(idx.value, int):
                i = idx.value
                if not -len(base.types) <= i < len(base.types):
                    self._fail(node, f"Tuple index {i} out of range for {base}.")
                return base.types[i]
        return UNKNOWN

    def expr_UnaryOp(self, node: ast.UnaryOp) -> Any:
        t = self.type_expr(node.operand)
        if t is UNKNOWN:
            return UNKNOWN
        if isinstance(node.op, (ast.Not, ast.Invert)):
            if not _is_bool(t) and _dtype_of(t) is not None and np.dtype(_dtype_of(t)).kind != "i":
                self._fail(node, f"Operator '~/not' expects bool, got {_fmt(t)}.")
            return t
        if isinstance(node.op, (ast.USub, ast.UAdd)):
            if _is_bool(t) and not isinstance(t, _WeakScalar):
                self._fail(node, f"Unary '{_op_sym(node.op)}' is not defined for bool.")
            return t
        return UNKNOWN

    def _binop_type(self, node: ast.AST, op: ast.operator, a: Any, b: Any) -> Any:
        if a is UNKNOWN or b is UNKNOWN:
            return UNKNOWN
        if isinstance(a, ts.DimensionType) and isinstance(op, (ast.Add, ast.Sub)):
            # ``I + 1`` / ``I + 0.5``: cartesian/staggered shift value
            # (common.connectivity_for_cartesian_shift).
            from gt4py_tpu_torch.next.common import connectivity_for_cartesian_shift

            if isinstance(node, ast.BinOp) and isinstance(node.right, ast.Constant):
                off = node.right.value
                try:
                    conn = connectivity_for_cartesian_shift(
                        a.dim, -off if isinstance(op, ast.Sub) else off
                    )
                except (ValueError, TypeError):
                    return UNKNOWN
                return _CartShiftTy(conn.dim, conn.codomain)
            return UNKNOWN
        if isinstance(op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            for t in (a, b):
                if not _is_bool(t) and (
                    _dtype_of(t) is None or np.dtype(_dtype_of(t)).kind not in "bi"
                ):
                    self._fail(node, f"Bitwise op expects bool/int operands, got {_fmt(t)}.")
            return _combine(a, b, np.result_type(_dtype_of(a), _dtype_of(b)))
        if _dtype_of(a) is None or _dtype_of(b) is None:
            return UNKNOWN
        if isinstance(op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow)):
            for t in (a, b):
                if _is_bool(t) and not isinstance(t, _WeakScalar):
                    self._fail(
                        node,
                        f"Arithmetic operator '{_op_sym(op)}' is not defined for "
                        f"bool operand {_fmt(t)}.",
                    )
            dtype = _promote_dtype(a, b)
            if isinstance(op, ast.Div) and np.dtype(dtype).kind in "biu":
                dtype = np.dtype(np.float64)
            return _combine(a, b, dtype)
        return UNKNOWN

    def expr_BinOp(self, node: ast.BinOp) -> Any:
        return self._binop_type(
            node, node.op, self.type_expr(node.left), self.type_expr(node.right)
        )

    def expr_Compare(self, node: ast.Compare) -> Any:
        left = self.type_expr(node.left)
        result: Any = UNKNOWN
        for op, comparator in zip(node.ops, node.comparators):
            right = self.type_expr(comparator)
            if isinstance(left, ts.DimensionType) or isinstance(right, ts.DimensionType):
                dim = left.dim if isinstance(left, ts.DimensionType) else right.dim
                result = _DimCondTy(dim)
            elif left is UNKNOWN or right is UNKNOWN:
                result = UNKNOWN
            else:
                if _dtype_of(left) is None or _dtype_of(right) is None:
                    result = UNKNOWN
                else:
                    result = _combine(left, right, np.dtype(bool))
            left = right
        return result

    def expr_BoolOp(self, node: ast.BoolOp) -> Any:
        parts = [self.type_expr(v) for v in node.values]
        out: Any = None
        for p, v in zip(parts, node.values):
            if p is UNKNOWN:
                return UNKNOWN
            if not _is_bool(p):
                self._fail(
                    v,
                    f"Operands of 'and'/'or' must be bool, got {_fmt(p)}. "
                    "Use '&'/'|' only on bool fields; arithmetic masks need astype.",
                )
            out = p if out is None else _combine(out, p, np.dtype(bool))
        return out

    def expr_IfExp(self, node: ast.IfExp) -> Any:
        cond = self.type_expr(node.test)
        if isinstance(cond, ts.FieldType):
            self._fail(
                node.test,
                "Ternary conditions must be scalar; use where(cond, a, b) for "
                "field-valued conditions.",
            )
        a = self.type_expr(node.body)
        b = self.type_expr(node.orelse)
        if a is UNKNOWN or b is UNKNOWN:
            return UNKNOWN
        if not _compatible(a, b):
            self._fail(node, f"Ternary branches have incompatible types {_fmt(a)} and {_fmt(b)}.")
        da, db = _dtype_of(a), _dtype_of(b)
        if da is not None and db is not None:
            return _combine(a, b, _promote_dtype(a, b))
        return a

    # -- calls -------------------------------------------------------------

    def expr_Call(self, node: ast.Call) -> Any:
        callee = self.type_expr(node.func)
        args = [self.type_expr(a) for a in node.args]
        kwargs = {k.arg: self.type_expr(k.value) for k in node.keywords if k.arg}

        if isinstance(callee, ts.FieldType):
            return self._shift(node, callee, args)
        if isinstance(callee, _BuiltinRef):
            return self._builtin(node, callee.name, args, kwargs)
        if isinstance(callee, _OperatorRef):
            return self._operator_call(node, callee, args, kwargs)
        return UNKNOWN

    def _shift(self, node: ast.Call, field: ts.FieldType, args: list[Any]) -> Any:
        if not args:
            self._fail(node, "Field shifts take at least one offset argument.")
        if len(args) > 1:
            # Multi-offset premaps fold left-to-right (embedded __call__).
            result: Any = field
            for a in args:
                if not isinstance(result, ts.FieldType):
                    return UNKNOWN
                result = self._shift(node, result, [a])
            return result
        (off,) = args
        if off is UNKNOWN:
            return UNKNOWN
        if isinstance(off, _CartShiftTy):
            if off.codomain not in field.dims:
                self._fail(
                    node,
                    f"Cannot premap via {off.dim.value}-shift: field over "
                    f"({', '.join(d.value for d in field.dims)}) has no "
                    f"{off.codomain.value} dimension.",
                )
            if off.dim == off.codomain:
                return field
            new_dims = tuple(
                off.dim if d == off.codomain else d for d in field.dims
            )
            return ts.FieldType(dims=new_dims, dtype=field.dtype)
        if not isinstance(off, _OffsetTy):
            self._fail(
                node,
                f"Fields are called with offsets (e.g. f(Ioff[1])), got {_fmt(off)}.",
            )
        offset = off.offset
        if off.index:
            if offset.source not in field.dims:
                self._fail(
                    node,
                    f"Cannot shift along {offset.source.value}: field has "
                    f"dimensions ({', '.join(d.value for d in field.dims)}).",
                )
            if offset.target and offset.target[0] != offset.source:
                # Indexed unstructured offset (E2V[0]): a single-column
                # remap — source dim becomes the target's primary dim,
                # WITHOUT the local neighbor dim.
                new_dims = tuple(
                    offset.target[0] if d == offset.source else d
                    for d in field.dims
                )
                return ts.FieldType(dims=new_dims, dtype=field.dtype)
            # Cartesian shift: dims unchanged.
            return field
        # Unstructured remap: replace the source dim with the target dims.
        if offset.source not in field.dims:
            self._fail(
                node,
                f"Cannot remap via {offset.value}: field over "
                f"({', '.join(d.value for d in field.dims)}) has no "
                f"{offset.source.value} dimension.",
            )
        new_dims: list[Dimension] = []
        for d in field.dims:
            if d == offset.source:
                new_dims.extend(offset.target)
            else:
                new_dims.append(d)
        return ts.FieldType(dims=tuple(new_dims), dtype=field.dtype)

    def _builtin(self, node: ast.Call, name: str, args: list[Any], kwargs: dict) -> Any:
        if name in _REDUCERS:
            field = args[0] if args else UNKNOWN
            axis = kwargs.get("axis", args[1] if len(args) > 1 else UNKNOWN)
            if field is UNKNOWN:
                return UNKNOWN
            if not isinstance(field, ts.FieldType):
                self._fail(node, f"{name} expects a field, got {_fmt(field)}.")
            if isinstance(axis, ts.DimensionType):
                dim = axis.dim
                if dim not in field.dims:
                    self._fail(
                        node,
                        f"{name} over {dim.value}: field has no such dimension "
                        f"(dims: {', '.join(d.value for d in field.dims)}).",
                    )
                if dim.kind is not DimensionKind.LOCAL:
                    self._fail(
                        node,
                        f"{name} reduces over LOCAL (neighbor) dimensions; "
                        f"{dim.value} is {dim.kind.value}.",
                    )
                return ts.FieldType(
                    dims=tuple(d for d in field.dims if d != dim), dtype=field.dtype
                )
            return UNKNOWN
        if name == "broadcast":
            if len(args) != 2:
                return UNKNOWN
            target = node.args[1]
            dims: list[Dimension] = []
            try:
                value = eval(ast.unparse(target), getattr(self.fn, "__globals__", {}))  # noqa: S307
                for d in value:
                    if not isinstance(d, Dimension):
                        return UNKNOWN
                    dims.append(d)
            except Exception:
                return UNKNOWN
            src = args[0]
            src_dims = _dims_of(src)
            missing = [d for d in src_dims if d not in dims]
            if missing:
                self._fail(
                    node,
                    f"broadcast cannot drop dimensions ({', '.join(d.value for d in missing)}).",
                )
            dtype = _dtype_of(src)
            if dtype is None:
                return UNKNOWN
            return ts.FieldType(dims=tuple(dims), dtype=dtype)
        if name in ("where", "concat_where"):
            if len(args) != 3:
                return UNKNOWN
            cond, a, b = args
            if name == "where" and cond is not UNKNOWN and not _is_bool(cond) and not isinstance(cond, _DimCondTy):
                self._fail(node.args[0], f"where() condition must be bool, got {_fmt(cond)}.")
            if a is UNKNOWN or b is UNKNOWN:
                return UNKNOWN
            if _dtype_of(a) is None or _dtype_of(b) is None:
                return UNKNOWN
            out = _combine(a, b, _promote_dtype(a, b))
            if name == "where" and isinstance(cond, ts.FieldType):
                dims = ts.promote_dims(cond.dims, _dims_of(out))
                return ts.FieldType(dims=dims, dtype=_dtype_of(out))
            return out
        if name == "astype":
            if len(args) != 2:
                return UNKNOWN
            try:
                dtype = np.dtype(
                    eval(ast.unparse(node.args[1]), getattr(self.fn, "__globals__", {}))  # noqa: S307
                )
            except Exception:
                return UNKNOWN
            src = args[0]
            if isinstance(src, ts.FieldType):
                return ts.FieldType(dims=src.dims, dtype=dtype)
            if _dtype_of(src) is not None:
                return ts.ScalarType(dtype)
            return UNKNOWN
        if name in _MATH_UNARY_FLOAT | _MATH_UNARY_KEEP | _MATH_UNARY_BOOL:
            src = args[0] if args else UNKNOWN
            if src is UNKNOWN:
                return UNKNOWN
            dtype = _dtype_of(src)
            if dtype is None:
                return UNKNOWN
            if name in _MATH_UNARY_BOOL:
                out_dtype = np.dtype(bool)
            elif name in _MATH_UNARY_FLOAT and np.dtype(dtype).kind not in "fc":
                out_dtype = np.dtype(np.float64)
            else:
                out_dtype = np.dtype(dtype)
            if isinstance(src, ts.FieldType):
                return ts.FieldType(dims=src.dims, dtype=out_dtype)
            return ts.ScalarType(out_dtype)
        if name in _MATH_BINARY:
            if len(args) != 2 or UNKNOWN in args:
                return UNKNOWN
            a, b = args
            if _dtype_of(a) is None or _dtype_of(b) is None:
                return UNKNOWN
            return _combine(a, b, _promote_dtype(a, b))
        return UNKNOWN

    def _operator_call(self, node: ast.Call, ref: _OperatorRef, args: list[Any], kwargs: dict) -> Any:
        info = ref.info
        names = list(info.params)
        if len(args) > len(names):
            self._fail(
                node,
                f"{ref.name}() takes {len(names)} arguments but {len(args)} were given.",
            )
        bound = dict(zip(names, args))
        for k, v in kwargs.items():
            if k not in names:
                self._fail(node, f"{ref.name}() has no parameter '{k}'.")
            bound[k] = v
        for pname, declared in info.params.items():
            got = bound.get(pname, UNKNOWN)
            if got is UNKNOWN or declared is UNKNOWN:
                continue
            ok = (
                _scan_arg_compatible(declared, got)
                if ref.is_scan
                else _compatible(declared, got)
            )
            if not ok:
                self._fail(
                    node,
                    f"Argument '{pname}' of {ref.name}(): expected {declared}, "
                    f"got {_fmt(got)}.",
                )
        return info.returns if info.returns is not None else UNKNOWN


def _scan_arg_compatible(declared: Any, got: Any) -> bool:
    """Scan call-site rule (deduction-time analog of _element_accepts):
    declared per-level scalars accept a Field of any dims with the same
    dtype, a matching scalar, or a weak literal of a fitting kind."""
    if isinstance(declared, ts.ScalarType):
        if isinstance(got, (ts.FieldType, ts.ScalarType)):
            return np.dtype(got.dtype) == np.dtype(declared.dtype)
        if isinstance(got, _WeakScalar):
            kind = {"bool": "b", "int": "i", "float": "f"}[got.kind]
            return np.dtype(declared.dtype).kind in {"b": "b", "i": "iuf", "f": "f"}[kind]
        return True
    if isinstance(declared, ts.TupleType) and isinstance(got, ts.TupleType):
        return len(declared.types) == len(got.types) and all(
            _scan_arg_compatible(d, g) for d, g in zip(declared.types, got.types)
        )
    return True


def _classify_value(value: Any) -> Any:
    """Spec of a closure/global value referenced from a definition."""
    from gt4py_tpu_torch.next.common import OffsetIndex

    if isinstance(value, FieldOffset):
        return _OffsetTy(value)
    if isinstance(value, OffsetIndex):
        return _OffsetTy(value.offset, index=True)
    if isinstance(value, Dimension):
        return ts.DimensionType(value)
    if isinstance(value, bool):
        return _WeakScalar("bool")
    if isinstance(value, int):
        return _WeakScalar("int")
    if isinstance(value, float):
        return _WeakScalar("float")
    if isinstance(value, (np.generic,)):
        return ts.ScalarType(np.dtype(value.dtype))
    info = getattr(value, "type_info", None)
    if isinstance(info, OperatorTypeInfo):
        defn = getattr(value, "definition", None)
        name = getattr(defn, "__name__", "operator")
        is_scan = hasattr(value, "axis") and hasattr(value, "init")
        if is_scan:
            names = list(info.params)
            info = OperatorTypeInfo(
                params={n: info.params[n] for n in names[1:]},  # drop carry
                returns=UNKNOWN,  # field result dims depend on the call site
            )
        return _OperatorRef(info, name, is_scan)
    # DSL builtins imported into the user module (where, neighbor_sum, ...).
    if callable(value) and getattr(value, "__module__", "") == "gt4py_tpu_torch.next.fbuiltins":
        return _BuiltinRef(value.__name__)
    return UNKNOWN


def _compatible(a: Any, b: Any) -> bool:
    """Whether two specs can be unified (branch merge / return check)."""
    if a is UNKNOWN or b is UNKNOWN:
        return True
    if isinstance(a, _WeakScalar) or isinstance(b, _WeakScalar):
        # A weak literal unifies with any scalar, never with a field/tuple.
        other = b if isinstance(a, _WeakScalar) else a
        return isinstance(other, (_WeakScalar, ts.ScalarType))
    if isinstance(a, ts.FieldType) and isinstance(b, ts.FieldType):
        return set(a.dims) == set(b.dims) and a.dtype == b.dtype
    if isinstance(a, ts.ScalarType) and isinstance(b, ts.ScalarType):
        return a.dtype == b.dtype
    if isinstance(a, ts.TupleType) and isinstance(b, ts.TupleType):
        return len(a.types) == len(b.types) and all(
            _compatible(x, y) for x, y in zip(a.types, b.types)
        )
    return type(a) is type(b)


def _fmt(t: Any) -> str:
    if t is UNKNOWN:
        return "<unknown>"
    if isinstance(t, _WeakScalar):
        return f"{t.kind} literal"
    return str(t)


def _op_sym(op: ast.AST) -> str:
    return {
        ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
        ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**",
        ast.USub: "-", ast.UAdd: "+",
    }.get(type(op), type(op).__name__)


def deduce(fn: Callable, *, kind: str = "field_operator") -> Optional[OperatorTypeInfo]:
    """Deduce an operator's type info from its annotations + AST.

    Returns None (deduction off) when no parameter carries a usable DSL
    annotation — unannotated legacy operators keep trace-time semantics.
    Raises :class:`~gt4py_tpu_torch.next.errors.DSLTypeError` /
    :class:`~gt4py_tpu_torch.next.errors.MissingParameterAnnotationError` for
    definition mistakes (reference foast_passes/type_deduction.py)."""
    parsed = _definition_source(fn)
    if parsed is None:
        return None
    node, filename, line_offset, col_offset = parsed

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    globalns = getattr(fn, "__globals__", {}) or {}
    params: dict[str, Any] = {}
    n_annotated = 0
    bare_params: set[str] = set()
    for pname, p in sig.parameters.items():
        spec = ts.from_annotation(p.annotation, globalns)
        if spec is not None:
            n_annotated += 1
        elif p.annotation is not inspect.Parameter.empty:
            # annotated with a type the DSL cannot express (NamedTuple /
            # @named_collection classes): counts as annotated, deduction
            # just cannot see inside it
            n_annotated += 1
        else:
            bare_params.add(pname)
        params[pname] = spec if spec is not None else UNKNOWN
    if n_annotated == 0:
        return None
    # Scalar-only annotations (e.g. a static `f: float` parameter) do not
    # opt into strict mode: enforcing full annotation there would break
    # legacy operators. Field/tuple annotations do.
    n_field_annotated = sum(
        isinstance(s, (ts.FieldType, ts.TupleType)) for s in params.values()
    )
    if n_field_annotated and bare_params and kind == "field_operator":
        for pname in params:
            if pname in bare_params:
                arg_nodes = {a.arg: a for a in node.args.args}
                raise errors.MissingParameterAnnotationError(
                    _loc(arg_nodes.get(pname, node), filename, line_offset, col_offset),
                    pname,
                )

    typer = _Typer(fn, dict(params), filename, line_offset, col_offset)
    typer.type_statements(node.body)

    declared_return = ts.from_annotation(
        sig.return_annotation if sig.return_annotation is not inspect.Signature.empty else None,
        globalns,
    )
    deduced = typer.return_type if typer._saw_return else None
    if declared_return is not None and deduced is not None:
        if not _compatible(declared_return, deduced):
            raise errors.DSLTypeError(
                _loc(node, filename, line_offset, col_offset),
                f"Declared return type {declared_return} does not match the "
                f"deduced return type {_fmt(deduced)}.",
            )
        returns = declared_return
    else:
        returns = declared_return if declared_return is not None else (
            deduced if deduced is not None else UNKNOWN
        )
    return OperatorTypeInfo(params=params, returns=returns)


def check_call_args(
    info: OperatorTypeInfo,
    args: tuple,
    kwargs: dict,
    *,
    name: str,
    element_only: bool = False,
) -> None:
    """Validate concrete call arguments against a deduced signature
    (reference decorator.py argument validation). Raises DSLTypeError.

    ``element_only`` is the scan-operator mode: declared types are
    per-level element types (reference scan semantics), so a declared
    scalar accepts a field of any dims with a matching element dtype."""
    names = list(info.params)
    if len(args) > len(names):
        raise errors.DSLTypeError(
            None, f"{name}() takes {len(names)} arguments but {len(args)} were given."
        )
    bound = dict(zip(names, args))
    for k, v in kwargs.items():
        if k in info.params:
            bound[k] = v
    problems = []
    for pname, declared in info.params.items():
        if declared is UNKNOWN or pname not in bound:
            continue
        try:
            got = ts.from_value(bound[pname])
        except TypeError:
            continue
        ok = (
            _element_accepts(declared, bound[pname], got)
            if element_only
            else _runtime_accepts(declared, bound[pname], got)
        )
        if not ok:
            problems.append(f"  '{pname}': expected {declared}, got {got}")
    if problems:
        raise errors.DSLTypeError(
            None,
            f"Invalid argument types in call to {name}():\n" + "\n".join(problems),
        )


def check_out_arg(info: OperatorTypeInfo, out: Any, *, name: str) -> None:
    """Validate the ``out=`` field(s) against the deduced return type
    (reference decorator.py out-argument type checking). Dims must cover
    the return dims with a matching dtype; tuples check element-wise."""
    declared = info.returns
    if declared is None or declared is UNKNOWN or out is None:
        return
    _check_out(declared, out, name, "out")


def _check_out(declared: Any, out: Any, name: str, path: str) -> None:
    from gt4py_tpu_torch.next.embedded import Field

    if isinstance(declared, ts.TupleType):
        if not isinstance(out, tuple) or len(out) != len(declared.types):
            raise errors.DSLTypeError(
                None,
                f"{name}(): '{path}' must be a {len(declared.types)}-tuple "
                f"matching the return type {declared}.",
            )
        for i, (d, o) in enumerate(zip(declared.types, out)):
            _check_out(d, o, name, f"{path}[{i}]")
        return
    if isinstance(declared, ts.FieldType):
        if not isinstance(out, Field):
            raise errors.DSLTypeError(
                None, f"{name}(): '{path}' must be a Field (returns {declared})."
            )
        missing = [d for d in out.dims if d not in declared.dims]
        if missing:
            raise errors.DSLTypeError(
                None,
                f"{name}(): '{path}' has dimension(s) "
                f"{', '.join(d.value for d in missing)} not produced by the "
                f"operator (returns {declared}).",
            )


def _element_accepts(declared: Any, value: Any, got: ts.TypeSpec) -> bool:
    """Scan-operator argument rule: element dtype must match; dims are
    free (the scan axis and any vectorized dims are implicit)."""
    if isinstance(declared, ts.ScalarType):
        if isinstance(value, (bool, int, float)):
            kind = "b" if isinstance(value, bool) else ("i" if isinstance(value, int) else "f")
            return np.dtype(declared.dtype).kind in {"b": "b", "i": "iuf", "f": "f"}[kind]
        d = getattr(got, "dtype", None)
        return d is not None and np.dtype(d) == np.dtype(declared.dtype)
    if isinstance(declared, ts.TupleType) and isinstance(got, ts.TupleType):
        return len(declared.types) == len(got.types) and all(
            _element_accepts(d, v, g)
            for d, v, g in zip(declared.types, value, got.types)
        )
    return True


def _runtime_accepts(declared: Any, value: Any, got: ts.TypeSpec) -> bool:
    from gt4py_tpu_torch.next.embedded import Field

    if isinstance(declared, ts.FieldType):
        if not isinstance(value, Field):
            return False
        return set(got.dims) == set(declared.dims) and got.dtype == declared.dtype
    if isinstance(declared, ts.ScalarType):
        if isinstance(value, Field):
            return False
        if isinstance(value, (bool, int, float)):
            # Python literals are weak: accepted wherever the kind fits.
            kind = "b" if isinstance(value, bool) else ("i" if isinstance(value, int) else "f")
            return np.dtype(declared.dtype).kind in {"b": "b", "i": "iuf", "f": "f"}[kind]
        return got.dtype == declared.dtype
    if isinstance(declared, ts.TupleType):
        if not isinstance(got, ts.TupleType) or len(got.types) != len(declared.types):
            return False
        return all(
            _runtime_accepts(d, v, g)
            for d, v, g in zip(declared.types, value, got.types)
        )
    return True
