"""Vector/matrix assignment unrolling.

Copied from gt4py_tpu/cartesian/passes/vector_unroll.py; imports renamed.

Counterpart of the reference's DefIR→GTIR vector-assignment expansion
(src/gt4py/cartesian/frontend/defir_to_gtir.py:123,195):
an assignment whose target has UNINDEXED trailing data dimensions —
``out = mat @ vec``, ``y = alpha * x + y`` on ``Field[(f64, (3,))]`` —
unrolls into one scalar assignment per component with literal data
indices. ``@`` contracts explicitly (``Σ_k mat[c, k] * vec[k]``).

The vector backends can execute whole-vector assignments directly (the
evaluator broadcasts over trailing dims), but the Pallas kernels carry
data-dimension fields as one stream per flat index — unrolled scalar
assignments are exactly their native form, so this pass is what moves the
``vector_axpy``/``matvec_product`` class off the XLA fallback. Unrolling
is capped (``_MAX_COMPONENTS``) to avoid code explosion; capped
statements keep the whole-vector form (and its evaluator path).
"""

from __future__ import annotations

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.frontend import GTScriptSyntaxError

_MAX_COMPONENTS = 16

_IDX_DTYPE = np.dtype(np.int32)


def unroll_vector_assignments(stencil: gtir.Stencil) -> gtir.Stencil:
    shapes = _DataShapes(stencil)
    for vloop in stencil.vertical_loops:
        for section in vloop.sections:
            section.body = _unroll_body(section.body, shapes)
    return stencil


class _DataShapes:
    """Remaining-data-dimension shapes of expressions."""

    def __init__(self, stencil: gtir.Stencil):
        self.decl_dims: dict[str, tuple[int, ...]] = {}
        for p in stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.decl_dims[p.name] = tuple(p.data_dims)
            elif isinstance(p, gtir.GlobalTableDecl):
                self.decl_dims[p.name] = tuple(p.shape)
        for t in stencil.temporaries:
            self.decl_dims[t.name] = tuple(t.data_dims)

    def of(self, expr: gtir.Expr) -> tuple[int, ...]:
        if isinstance(expr, gtir.FieldAccess):
            dims = self.decl_dims.get(expr.name, ())
            return dims[len(expr.data_index):]
        if isinstance(expr, (gtir.Literal, gtir.ScalarAccess, gtir.IteratorAccess)):
            return ()
        if isinstance(expr, gtir.BinaryOp):
            left, right = self.of(expr.left), self.of(expr.right)
            if expr.op == gtir.ArithmeticOperator.MATMUL:
                return _matmul_shape(left, right)
            return _broadcast(left, right)
        if isinstance(expr, gtir.UnaryOp):
            return self.of(expr.expr)
        if isinstance(expr, gtir.TernaryOp):
            return _broadcast(self.of(expr.true_expr), self.of(expr.false_expr))
        if isinstance(expr, gtir.NativeFuncCall):
            shape: tuple[int, ...] = ()
            for a in expr.args:
                shape = _broadcast(shape, self.of(a))
            return shape
        if isinstance(expr, gtir.Cast):
            return self.of(expr.expr)
        return ()

    def select(self, expr: gtir.Expr, idx: tuple[int, ...]) -> gtir.Expr:
        """The component ``expr[idx]`` as a scalar-data expression."""
        if not idx:
            return expr
        if isinstance(expr, gtir.FieldAccess):
            return expr.copy(
                data_index=tuple(expr.data_index) + tuple(_lit(i) for i in idx)
            )
        if isinstance(expr, (gtir.Literal, gtir.ScalarAccess, gtir.IteratorAccess)):
            return expr  # scalar broadcast
        if isinstance(expr, gtir.BinaryOp):
            if expr.op == gtir.ArithmeticOperator.MATMUL:
                return self._select_matmul(expr, idx)
            return expr.copy(
                left=self._select_bcast(expr.left, idx),
                right=self._select_bcast(expr.right, idx),
            )
        if isinstance(expr, gtir.UnaryOp):
            return expr.copy(expr=self._select_bcast(expr.expr, idx))
        if isinstance(expr, gtir.TernaryOp):
            return expr.copy(
                cond=self._select_bcast(expr.cond, idx),
                true_expr=self._select_bcast(expr.true_expr, idx),
                false_expr=self._select_bcast(expr.false_expr, idx),
            )
        if isinstance(expr, gtir.NativeFuncCall):
            return expr.copy(args=[self._select_bcast(a, idx) for a in expr.args])
        if isinstance(expr, gtir.Cast):
            return expr.copy(expr=self._select_bcast(expr.expr, idx))
        raise GTScriptSyntaxError(
            f"Cannot unroll data-dimension expression {type(expr).__name__}"
        )

    def _select_bcast(self, expr: gtir.Expr, idx: tuple[int, ...]) -> gtir.Expr:
        return self.select(expr, idx) if self.of(expr) else expr

    def _select_matmul(self, expr: gtir.BinaryOp, idx: tuple[int, ...]) -> gtir.Expr:
        left_s, right_s = self.of(expr.left), self.of(expr.right)
        k = left_s[-1]
        if len(left_s) == 2 and len(right_s) == 1:  # (m, k) @ (k,) -> (m,)
            (c,) = idx
            terms = [
                gtir.BinaryOp(
                    op=gtir.ArithmeticOperator.MUL,
                    left=self.select(expr.left, (c, j)),
                    right=self.select(expr.right, (j,)),
                )
                for j in range(k)
            ]
        elif len(left_s) == 1 and len(right_s) == 2:  # (k,) @ (k, n) -> (n,)
            (c,) = idx
            k = left_s[0]
            terms = [
                gtir.BinaryOp(
                    op=gtir.ArithmeticOperator.MUL,
                    left=self.select(expr.left, (j,)),
                    right=self.select(expr.right, (j, c)),
                )
                for j in range(k)
            ]
        elif len(left_s) == 2 and len(right_s) == 2:  # (m, k) @ (k, n)
            c, d = idx
            terms = [
                gtir.BinaryOp(
                    op=gtir.ArithmeticOperator.MUL,
                    left=self.select(expr.left, (c, j)),
                    right=self.select(expr.right, (j, d)),
                )
                for j in range(k)
            ]
        else:
            raise GTScriptSyntaxError(
                f"Unsupported '@' operand data shapes {left_s} @ {right_s}"
            )
        acc = terms[0]
        for t in terms[1:]:
            acc = gtir.BinaryOp(op=gtir.ArithmeticOperator.ADD, left=acc, right=t)
        return acc


def _unroll_body(body: list[gtir.Stmt], shapes: _DataShapes) -> list[gtir.Stmt]:
    out: list[gtir.Stmt] = []
    for stmt in body:
        if isinstance(stmt, gtir.While):
            stmt.body = _unroll_body(stmt.body, shapes)
            out.append(stmt)
            continue
        if not isinstance(stmt, gtir.Assign):
            out.append(stmt)
            continue
        target_shape = shapes.of(stmt.target)
        if not target_shape:
            if shapes.of(stmt.value):
                # scalar target fed a whole-vector value: the data
                # dimensions were never indexed (reference
                # TestDataDimensions "forgot to index ddims" rejection)
                raise GTScriptSyntaxError(
                    f"Value assigned to '{stmt.target.name}' still has "
                    f"data dimensions {shapes.of(stmt.value)} — index "
                    "them (field[0,0,0][c]) or assign to a field with "
                    "matching data dimensions"
                )
            out.append(stmt)
            continue
        if int(np.prod(target_shape)) > _MAX_COMPONENTS:
            out.append(stmt)
            continue
        if any(
            not isinstance(e, gtir.Literal) for e in stmt.target.data_index
        ):
            out.append(stmt)  # dynamic partial index: keep whole-vector form
            continue
        if not _self_reads_are_componentwise(stmt, shapes):
            # `v = mat @ v` (or an explicit cross-component self-read):
            # component c would read already-overwritten earlier components
            # — whole-vector evaluation stays atomic.
            out.append(stmt)
            continue
        value_shape = shapes.of(stmt.value)
        if value_shape not in ((), target_shape):
            out.append(stmt)  # shape mismatch surfaces at execution
            continue
        for idx in np.ndindex(*target_shape):
            out.append(
                stmt.copy(
                    target=stmt.target.copy(
                        data_index=tuple(stmt.target.data_index)
                        + tuple(_lit(i) for i in idx)
                    ),
                    value=shapes.select(stmt.value, idx)
                    if value_shape
                    else stmt.value,
                )
            )
    return out


def _self_reads_are_componentwise(stmt: gtir.Assign, shapes: _DataShapes) -> bool:
    """True when unrolling cannot observe its own partial writes: every
    read of the target field inside the value must select exactly the
    component being written — i.e. carry NO explicit data index (select()
    appends the output component) and sit outside any ``@`` contraction
    (which reads across components)."""
    name = stmt.target.name

    def ok(expr: gtir.Expr, under_matmul: bool) -> bool:
        if isinstance(expr, gtir.FieldAccess):
            if expr.name != name:
                return True
            return not under_matmul and not expr.data_index
        if isinstance(expr, gtir.BinaryOp):
            inner = under_matmul or expr.op == gtir.ArithmeticOperator.MATMUL
            return ok(expr.left, inner) and ok(expr.right, inner)
        if isinstance(expr, gtir.UnaryOp):
            return ok(expr.expr, under_matmul)
        if isinstance(expr, gtir.TernaryOp):
            return (
                ok(expr.cond, under_matmul)
                and ok(expr.true_expr, under_matmul)
                and ok(expr.false_expr, under_matmul)
            )
        if isinstance(expr, gtir.NativeFuncCall):
            return all(ok(a, under_matmul) for a in expr.args)
        if isinstance(expr, gtir.Cast):
            return ok(expr.expr, under_matmul)
        return True

    result = ok(stmt.value, False)
    if stmt.mask is not None:
        result = result and ok(stmt.mask, False)
    return result


def _matmul_shape(left: tuple[int, ...], right: tuple[int, ...]) -> tuple[int, ...]:
    if len(left) == 2 and len(right) == 1:
        return (left[0],)
    if len(left) == 1 and len(right) == 2:
        return (right[1],)
    if len(left) == 2 and len(right) == 2:
        return (left[0], right[1])
    raise GTScriptSyntaxError(f"Unsupported '@' operand data shapes {left} @ {right}")


def _broadcast(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, ...]:
    if not a:
        return b
    if not b:
        return a
    if a != b:
        raise GTScriptSyntaxError(f"Mismatched data-dimension shapes {a} vs {b}")
    return a


def _lit(i: int) -> gtir.Literal:
    return gtir.Literal(value=int(i), dtype=_IDX_DTYPE)
