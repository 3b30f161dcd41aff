"""Unroll small integer powers into multiplications.

Copied from gt4py_tpu/cartesian/passes/power_unroll.py; imports renamed.

Counterpart of the reference's ``PowerUnrolling`` iterator transform
(src/gt4py/next/iterator/transforms/power_unrolling.py):
``x ** n`` with a literal integral exponent 0 <= n <= 5 becomes a
square-and-multiply chain. On the VPU this replaces the transcendental
pow path (exp/log) with 1-3 multiplies — faster AND exact for integral
powers. Repeated base subexpressions are shared by the evaluators' CSE.
"""

from __future__ import annotations

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir

_MAX_UNROLL = 5


def _int_exponent(node: gtir.Expr) -> int | None:
    if not isinstance(node, gtir.Literal):
        return None
    try:
        v = float(node.value)
    except (TypeError, ValueError):
        return None
    if v != int(v) or not (0 <= v <= _MAX_UNROLL):
        return None
    return int(v)


def _mul(a: gtir.Expr, b: gtir.Expr) -> gtir.Expr:
    return gtir.BinaryOp(op=gtir.ArithmeticOperator.MUL, left=a, right=b)


def _unrolled(base: gtir.Expr, n: int) -> gtir.Expr:
    if n == 0:
        return gtir.Literal(value=1.0, dtype=getattr(base, "dtype", None))
    # Square-and-multiply over shared subtrees: repeated references to the
    # same node are CSE'd by the expression evaluators.
    result: gtir.Expr | None = None
    square = base
    while n:
        if n & 1:
            result = square if result is None else _mul(result, square)
        n >>= 1
        if n:
            square = _mul(square, square)
    assert result is not None
    return result


class _PowerUnroll(eve.NodeTranslator):
    def visit_BinaryOp(self, node: gtir.BinaryOp, **kwargs):
        node = self.generic_visit(node, **kwargs)
        if node.op == gtir.ArithmeticOperator.POW:
            n = _int_exponent(node.right)
            if n is not None:
                return _unrolled(node.left, n)
        return node

    def visit_NativeFuncCall(self, node: gtir.NativeFuncCall, **kwargs):
        node = self.generic_visit(node, **kwargs)
        if node.func == gtir.NativeFunction.POW and len(node.args) == 2:
            n = _int_exponent(node.args[1])
            if n is not None:
                return _unrolled(node.args[0], n)
        return node


def unroll_powers(stencil: gtir.Stencil) -> gtir.Stencil:
    return _PowerUnroll().visit(stencil)
