"""Control-flow lowering: structured If / HorizontalRestriction → masked

Copied from gt4py_tpu/cartesian/passes/lowering.py; imports renamed.
parallel assignments.

Counterpart of the reference's GTIR→OIR mask lowering
(src/gt4py/cartesian/gtc/gtir_to_oir.py:146 visit_FieldIfStmt
and MaskStmt creation): after this pass every vertical-section body contains
only ``Assign`` (possibly with ``mask``/``horizontal_masks``) and ``While``
units, which the vector backends execute as masked full-domain updates — the
natural shape for XLA/Pallas (predication instead of divergent control flow).

Semantics (reference lang_design.rst:199-296): the condition is evaluated
*before* the branch bodies run; body statements execute in order as masked
parallel assignments, then else statements with the negated mask — so an
else branch observes writes made by the if branch at other grid points,
exactly like the reference's generated code.
"""

from __future__ import annotations

from typing import Optional

from gt4py_tpu_torch.cartesian import gtir


def lower_control_flow(stencil: gtir.Stencil) -> gtir.Stencil:
    lowerer = _Lowerer(stencil)
    for vloop in stencil.vertical_loops:
        for section in vloop.sections:
            section.body = lowerer.flatten(section.body, None, ())
    stencil.temporaries.extend(lowerer.new_temps)
    return stencil


class _Lowerer:
    def __init__(self, stencil: gtir.Stencil):
        self.stencil = stencil
        self.counter = 0
        self.new_temps: list[gtir.Temporary] = []
        self.existing = {t.name for t in stencil.temporaries} | set(stencil.param_names)

    def _fresh_mask(self) -> str:
        while True:
            self.counter += 1
            name = f"_mask_{self.counter}"
            if name not in self.existing:
                self.existing.add(name)
                self.new_temps.append(gtir.Temporary(name=name))
                return name

    def flatten(
        self,
        stmts: list[gtir.Stmt],
        mask: Optional[gtir.Expr],
        hmasks: tuple[gtir.HorizontalMask, ...],
    ) -> list[gtir.Stmt]:
        out: list[gtir.Stmt] = []
        for s in stmts:
            if isinstance(s, gtir.Assign):
                out.append(
                    s.copy(mask=_and(s.mask, mask), horizontal_masks=hmasks)
                )
            elif isinstance(s, gtir.While):
                cond = _and(mask, s.cond) if mask is not None else s.cond
                body = self.flatten(s.body, None, ())
                out.append(s.copy(cond=cond, body=body, horizontal_masks=hmasks))
            elif isinstance(s, gtir.If):
                out.extend(self._flatten_if(s, mask, hmasks))
            elif isinstance(s, gtir.HorizontalRestriction):
                out.extend(self.flatten(s.body, mask, hmasks + (s.mask,)))
            else:
                raise TypeError(f"Unexpected statement in lowering: {type(s).__name__}")
        return out

    def _flatten_if(
        self,
        s: gtir.If,
        mask: Optional[gtir.Expr],
        hmasks: tuple[gtir.HorizontalMask, ...],
    ) -> list[gtir.Stmt]:
        out: list[gtir.Stmt] = []
        if_mask_name = self._fresh_mask()
        cond = _and(mask, s.cond)
        out.append(
            gtir.Assign(
                target=gtir.FieldAccess(name=if_mask_name), value=cond, loc=s.loc
            )
        )
        if_mask = gtir.FieldAccess(name=if_mask_name)
        else_mask: Optional[gtir.FieldAccess] = None
        if s.orelse:
            else_mask_name = self._fresh_mask()
            not_cond = gtir.UnaryOp(op=gtir.UnaryOperator.NOT, expr=s.cond)
            out.append(
                gtir.Assign(
                    target=gtir.FieldAccess(name=else_mask_name),
                    value=_and(mask, not_cond),
                    loc=s.loc,
                )
            )
            else_mask = gtir.FieldAccess(name=else_mask_name)
        out.extend(self.flatten(s.body, if_mask, hmasks))
        if s.orelse:
            out.extend(self.flatten(s.orelse, else_mask, hmasks))
        return out


def _and(a: Optional[gtir.Expr], b: Optional[gtir.Expr]) -> Optional[gtir.Expr]:
    if a is None:
        return b
    if b is None:
        return a
    return gtir.BinaryOp(op=gtir.LogicalOperator.AND, left=a, right=b)
