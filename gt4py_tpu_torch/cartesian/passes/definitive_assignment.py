"""Definitive-assignment analysis for temporaries.

Copied from gt4py_tpu/cartesian/passes/definitive_assignment.py; imports renamed.

Counterpart of the reference's
``gtc/passes/gtir_definitive_assignment_analysis.py``: reading a temporary
that is not definitely assigned on every control path is a DSL error.
Runs on the *structured* (pre-lowering) IR so branch information is intact.
"""

from __future__ import annotations

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.frontend import GTScriptSyntaxError


def check_definitive_assignment(stencil: gtir.Stencil) -> None:
    temps = {t.name for t in stencil.temporaries}
    assigned: set[str] = set()
    for _, _, stmt in stencil.walk_stmts():
        _check_stmt(stmt, temps, assigned, definite=True)


def _check_reads(expr: gtir.Expr, temps: set[str], assigned: set[str], loc) -> None:
    for access in eve.walk_type(expr, gtir.FieldAccess):
        if access.name in temps and access.name not in assigned:
            raise GTScriptSyntaxError(
                f"Temporary '{access.name}' may be read before assignment", loc
            )


def _check_stmt(stmt: gtir.Stmt, temps: set[str], assigned: set[str], *, definite: bool) -> None:
    if isinstance(stmt, gtir.Assign):
        _check_reads(stmt.value, temps, assigned, stmt.loc)
        if stmt.mask is not None:
            _check_reads(stmt.mask, temps, assigned, stmt.loc)
        for idx in stmt.target.data_index:
            _check_reads(idx, temps, assigned, stmt.loc)
        if stmt.target.name in temps and definite:
            assigned.add(stmt.target.name)
    elif isinstance(stmt, gtir.If):
        _check_reads(stmt.cond, temps, assigned, stmt.loc)
        body_set = set(assigned)
        for s in stmt.body:
            _check_stmt(s, temps, body_set, definite=True)
        else_set = set(assigned)
        for s in stmt.orelse:
            _check_stmt(s, temps, else_set, definite=True)
        if definite:
            assigned |= body_set & else_set
    elif isinstance(stmt, gtir.While):
        _check_reads(stmt.cond, temps, assigned, stmt.loc)
        body_set = set(assigned)
        for s in stmt.body:
            # Assignments inside the loop body are not definite (the loop may
            # not execute), but sequential reads within one iteration are OK.
            _check_stmt(s, temps, body_set, definite=True)
    elif isinstance(stmt, gtir.HorizontalRestriction):
        # Region-restricted writes only cover part of the domain: reads are
        # allowed within the same region body, but the write is not definite
        # for the rest of the stencil.
        body_set = set(assigned)
        for s in stmt.body:
            _check_stmt(s, temps, body_set, definite=True)
    else:
        raise TypeError(f"Unexpected statement: {type(stmt).__name__}")
