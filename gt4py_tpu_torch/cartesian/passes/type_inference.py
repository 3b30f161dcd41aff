"""Dtype resolution and implicit upcasting.

Copied from gt4py_tpu/cartesian/passes/type_inference.py; imports renamed.

Combines the roles of the reference's ``gtir_dtype_resolver`` and
``gtir_upcaster`` passes (src/gt4py/cartesian/gtc/passes/):
annotates every expression with its dtype, registers temporary dtypes from
their first assignment, and inserts ``Cast`` nodes where an assignment's
value dtype differs from the target dtype. Binary-op promotion follows NumPy
rules, matching the
reference's numpy-backend semantics, and for bfloat16, where NumPy has no
lattice, JAX's (core/definitions.py ``upcast``: the JAX package asks
``jnp.promote_types``, which the port cannot import).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.frontend import GTScriptSyntaxError
from gt4py_tpu_torch.core.definitions import HALF_FLOAT_DTYPES, is_float_dtype, upcast

_BOOL = np.dtype(np.bool_)

_BOOL_FUNCS = {
    gtir.NativeFunction.ISFINITE,
    gtir.NativeFunction.ISINF,
    gtir.NativeFunction.ISNAN,
}
# Functions that preserve the (promoted) argument dtype even for integers.
_DTYPE_PRESERVING_FUNCS = {
    gtir.NativeFunction.ABS,
    gtir.NativeFunction.MIN,
    gtir.NativeFunction.MAX,
    gtir.NativeFunction.MOD,
    gtir.NativeFunction.FLOOR,
    gtir.NativeFunction.CEIL,
    gtir.NativeFunction.TRUNC,
    gtir.NativeFunction.ROUND,
    gtir.NativeFunction.ROUND_AWAY_FROM_ZERO,
    gtir.NativeFunction.COPYSIGN,
    gtir.NativeFunction.FMA,
    gtir.NativeFunction.POW,
}


def infer_dtypes(stencil: gtir.Stencil) -> None:
    """Annotate dtypes in place, in program order."""
    inference = _TypeInference(stencil)
    for _, _, stmt in stencil.walk_stmts():
        inference.infer_stmt(stmt)
    # Backfill temporary decls.
    for temp in stencil.temporaries:
        if temp.dtype is None:
            temp.dtype = inference.symbols.get(temp.name)


class _TypeInference:
    def __init__(self, stencil: gtir.Stencil):
        self.symbols: dict[str, Optional[np.dtype]] = {}
        self.data_dims: dict[str, tuple[int, ...]] = {}
        for p in stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.symbols[p.name] = p.dtype
                self.data_dims[p.name] = p.data_dims
            elif isinstance(p, gtir.ScalarDecl):
                self.symbols[p.name] = p.dtype
            elif isinstance(p, gtir.GlobalTableDecl):
                self.symbols[p.name] = p.dtype
        for t in stencil.temporaries:
            if t.dtype is not None:
                self.symbols[t.name] = t.dtype

    def infer_stmt(self, stmt: gtir.Stmt) -> None:
        if isinstance(stmt, gtir.Assign):
            value_dtype = self.infer(stmt.value)
            if stmt.mask is not None:
                mask_dtype = self.infer(stmt.mask)
                if mask_dtype is not None and mask_dtype != _BOOL:
                    raise GTScriptSyntaxError(
                        f"Condition must be boolean, got {mask_dtype}", stmt.loc
                    )
            name = stmt.target.name
            target_dtype = self.symbols.get(name)
            if target_dtype is None:
                if value_dtype is None:
                    raise GTScriptSyntaxError(
                        f"Cannot infer dtype of temporary '{name}'", stmt.loc
                    )
                self.symbols[name] = value_dtype
                target_dtype = value_dtype
            for idx in stmt.target.data_index:
                self._check_integer(idx, stmt.loc)
            stmt.target.dtype = target_dtype
            if value_dtype is not None and value_dtype != target_dtype:
                stmt.value = gtir.Cast(dtype=target_dtype, expr=stmt.value)
        elif isinstance(stmt, gtir.While):
            cond_dtype = self.infer(stmt.cond)
            if cond_dtype is not None and cond_dtype != _BOOL:
                raise GTScriptSyntaxError(
                    f"While condition must be boolean, got {cond_dtype}", stmt.loc
                )
            if stmt.mask is not None:
                self.infer(stmt.mask)
            for s in stmt.body:
                self.infer_stmt(s)
        elif isinstance(stmt, (gtir.If, gtir.HorizontalRestriction)):
            # Pre-lowering structure (used when analyzing unlowered IR).
            if isinstance(stmt, gtir.If):
                self.infer(stmt.cond)
                for s in stmt.body + stmt.orelse:
                    self.infer_stmt(s)
            else:
                for s in stmt.body:
                    self.infer_stmt(s)
        else:
            raise TypeError(f"Unexpected statement: {type(stmt).__name__}")

    def _check_integer(self, expr: gtir.Expr, loc) -> None:
        dtype = self.infer(expr)
        if dtype is not None and dtype.kind not in ("i", "u"):
            raise GTScriptSyntaxError(f"Index expression must be integer, got {dtype}", loc)

    def infer(self, expr: gtir.Expr) -> Optional[np.dtype]:
        dtype = self._infer(expr)
        if hasattr(expr, "dtype"):
            expr.dtype = dtype
        return dtype

    def _infer(self, expr: gtir.Expr) -> Optional[np.dtype]:
        if isinstance(expr, gtir.Literal):
            return expr.dtype
        if isinstance(expr, gtir.ScalarAccess):
            return expr.dtype if expr.dtype is not None else self.symbols.get(expr.name)
        if isinstance(expr, gtir.FieldAccess):
            if expr.koffset is not None:
                self._check_integer(expr.koffset, None)
            if expr.abs_k is not None:
                self._check_integer(expr.abs_k, None)
            for idx in expr.data_index:
                self._check_integer(idx, None)
            return self.symbols.get(expr.name)
        if isinstance(expr, gtir.UnaryOp):
            operand = self.infer(expr.expr)
            if expr.op == gtir.UnaryOperator.NOT:
                if operand is not None and operand != _BOOL:
                    raise GTScriptSyntaxError(f"'not' requires a boolean, got {operand}")
                return _BOOL
            return operand
        if isinstance(expr, gtir.BinaryOp):
            left = self.infer(expr.left)
            right = self.infer(expr.right)
            dts = [left, right]
            _weaken_half_literals([expr.left, expr.right], dts)
            left, right = dts
            if isinstance(expr.op, gtir.ComparisonOperator):
                return _BOOL
            if isinstance(expr.op, gtir.LogicalOperator):
                for side in (left, right):
                    if side is not None and side != _BOOL:
                        raise GTScriptSyntaxError(
                            f"Logical operands must be boolean, got {side}"
                        )
                return _BOOL
            promoted = _promote(left, right)
            if expr.op == gtir.ArithmeticOperator.DIV:
                if promoted is not None and promoted.kind in ("i", "u", "b"):
                    promoted = np.dtype(np.float64)
            return promoted
        if isinstance(expr, gtir.TernaryOp):
            cond = self.infer(expr.cond)
            if cond is not None and cond != _BOOL:
                raise GTScriptSyntaxError(f"Ternary condition must be boolean, got {cond}")
            dts = [self.infer(expr.true_expr), self.infer(expr.false_expr)]
            _weaken_half_literals([expr.true_expr, expr.false_expr], dts)
            return _promote(dts[0], dts[1])
        if isinstance(expr, gtir.NativeFuncCall):
            arg_dtypes = [self.infer(a) for a in expr.args]
            _weaken_half_literals(list(expr.args), arg_dtypes)
            if expr.func in _BOOL_FUNCS:
                return _BOOL
            promoted = None
            for d in arg_dtypes:
                promoted = _promote(promoted, d)
            if expr.func in _DTYPE_PRESERVING_FUNCS:
                return promoted
            # Transcendentals return floating point.
            if promoted is not None and promoted.kind in ("i", "u", "b"):
                return np.dtype(np.float64)
            return promoted
        if isinstance(expr, gtir.Cast):
            self.infer(expr.expr)
            return expr.dtype
        if isinstance(expr, gtir.IteratorAccess):
            return expr.dtype
        raise TypeError(f"Unexpected expression: {type(expr).__name__}")


def _promote(a: Optional[np.dtype], b: Optional[np.dtype]) -> Optional[np.dtype]:
    if a is None:
        return b
    if b is None:
        return a
    return upcast(a, b)


_F32 = np.dtype(np.float32)


def comparison_dtype(a: Optional[np.dtype], b: Optional[np.dtype]) -> Optional[np.dtype]:
    """The dtype a comparison of ``a`` and ``b`` is evaluated in: a half
    side widens to float32 first, which holds it exactly, and the other
    side keeps its dtype (a float64 or int64 counterpart is never narrowed),
    as the JAX package's evaluator does (evaluator.py:188-197)."""
    a = _F32 if a in HALF_FLOAT_DTYPES else a
    b = _F32 if b in HALF_FLOAT_DTYPES else b
    return _promote(a, b)


def _weaken_half_literals(exprs: "list[gtir.Expr]", dtypes: "list[Optional[np.dtype]]") -> None:
    """JAX-style weak literal typing against half-precision operands: when a
    non-literal operand is bfloat16/float16, numeric Python literals in the
    same operation adapt to that dtype instead of promoting everything to
    their default 32/64-bit precision (which would silently undo the
    narrow-dtype pipeline the user asked for). Mutates literal dtypes and
    the dtypes list in place."""
    halfs = {
        d
        for e, d in zip(exprs, dtypes)
        if d in HALF_FLOAT_DTYPES and not isinstance(e, gtir.Literal)
    }
    if len(halfs) != 1:
        return
    target = next(iter(halfs))
    for i, (e, d) in enumerate(zip(exprs, dtypes)):
        if (
            isinstance(e, gtir.Literal)
            and d is not None
            and d not in HALF_FLOAT_DTYPES
            and d != _BOOL
            and (is_float_dtype(d) or d.kind in ("i", "u"))
        ):
            e.dtype = target
            dtypes[i] = target
