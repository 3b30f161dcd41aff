"""Structural race detection.

Copied from gt4py_tpu/cartesian/passes/race_detection.py; imports renamed.

Counterpart of the reference's illegal-pattern rejection (reference
docs/user/cartesian/lang_design.rst:55-88 and the GTScript frontend
checks): parallel grid-point execution makes two patterns undefined, and
they are rejected at compile time — the framework's "race detector"
(SURVEY.md §5: correctness of parallel codegen is enforced structurally):

R1 — shifted self-read: an assignment whose right-hand side (or mask)
     reads its own target at a nonzero offset. Horizontal offsets are
     always illegal (IJ points run in parallel in every loop order); K
     offsets are additionally illegal in PARALLEL computations (K levels
     run in parallel there; in FORWARD/BACKWARD they are the defined
     scan-carry semantics).

R2 — write after offset-read (PARALLEL only): a field read with a nonzero
     offset by an earlier statement of the same parallel vertical loop
     must not be written by a later statement; under fused parallel
     execution the read's timing relative to neighboring points' writes
     is unspecified. (Write first, offset-read later is fine — reads
     observe the updated values via the extended-domain semantics.)
"""

from __future__ import annotations

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.passes.extents import iter_writes


class StencilRaceError(ValueError):
    """An undefined parallel access pattern (compile-time rejection)."""


def _stmt_reads(stmt: gtir.Stmt):
    if isinstance(stmt, gtir.Assign):
        yield from eve.walk_type(stmt.value, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for i in stmt.target.data_index:
            yield from eve.walk_type(i, gtir.FieldAccess)
        if stmt.target.koffset is not None:
            yield from eve.walk_type(stmt.target.koffset, gtir.FieldAccess)
    elif isinstance(stmt, gtir.While):
        yield from eve.walk_type(stmt.cond, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for s in stmt.body:
            yield from _stmt_reads(s)


def _flat_stmts(stmt: gtir.Stmt):
    yield stmt
    if isinstance(stmt, gtir.While):
        for s in stmt.body:
            yield from _flat_stmts(s)


def detect_races(stencil: gtir.Stencil) -> None:
    """Raise :class:`StencilRaceError` on undefined parallel patterns."""
    for vloop in stencil.vertical_loops:
        parallel = vloop.loop_order == gtir.LoopOrder.PARALLEL
        for section in vloop.sections:
            # (R2) fields read with an offset so far in this section.
            offset_read: dict[str, tuple[int, int, int]] = {}
            for top in section.body:
                for stmt in _flat_stmts(top):
                    writes = {w.name for w in iter_writes(stmt)}
                    # (R1) self-read at a racy offset within the statement.
                    for acc in _stmt_reads(stmt):
                        if acc.name in writes:
                            di, dj, dk = acc.offset
                            horizontal = di != 0 or dj != 0
                            racy_k = parallel and (
                                dk != 0 or acc.koffset is not None or acc.abs_k is not None
                            )
                            if horizontal or racy_k:
                                raise StencilRaceError(
                                    f"Stencil '{stencil.name}': '{acc.name}' is "
                                    f"assigned from itself at offset {acc.offset} in "
                                    "the same statement — the parallel execution "
                                    "order of grid points makes this undefined "
                                    "(reference lang_design.rst:55-88)."
                                )
                    if parallel:
                        # (R2) write after offset-read within the loop.
                        for name in writes:
                            if name in offset_read:
                                raise StencilRaceError(
                                    f"Stencil '{stencil.name}': '{name}' is written "
                                    f"after being read at offset "
                                    f"{offset_read[name]} in the same PARALLEL "
                                    "computation — under parallel execution the "
                                    "read may observe either value (reference "
                                    "lang_design.rst:55-88). Reorder the "
                                    "statements or use a temporary."
                                )
                        for acc in _stmt_reads(stmt):
                            off = acc.offset
                            if (
                                (off[0] != 0 or off[1] != 0 or off[2] != 0)
                                and acc.name not in offset_read
                            ):
                                offset_read[acc.name] = off
