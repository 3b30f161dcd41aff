"""Access-extent analysis.

Copied from gt4py_tpu/cartesian/passes/extents.py; imports renamed.

Counterpart of the reference's ``AccessCollector``/``StencilExtentComputer``
(src/gt4py/cartesian/gtc/passes/oir_optimizations/utils.py:89,250)
and ``gtir_k_boundary.py``: walks the lowered statement units in *reverse*
program order, accumulating

- per-statement horizontal extents (how far beyond the compute domain each
  parallel assignment must execute so later offset reads of its target are
  valid — this drives temporary-domain extension and Pallas halo tiles),
- per-field accumulated extents, whose boundary is the halo each API field
  must provide (used by runtime arg validation) and the padding temporaries
  are allocated with.

K boundaries are interval-aware: a read at K offset ``d`` inside a section
``[start, end)`` needs a lower halo only if its smallest absolute index is
below the domain (start measured from the domain start), and an upper halo
only if its largest index is above (end measured from the domain end).
"""

from __future__ import annotations

from typing import Iterator

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import Extent


def _k_halo(section: gtir.VerticalSection, dk: int) -> tuple[int, int]:
    start, end = section.interval.start, section.interval.end
    lower = 0
    upper = 0
    if start.level == gtir.LevelMarker.START:
        lower = max(0, -(start.offset + dk))
    if end.level == gtir.LevelMarker.END:
        upper = max(0, end.offset + dk)
    return lower, upper


def _iter_reads(stmt: gtir.Stmt) -> Iterator[gtir.FieldAccess]:
    """All field reads of a lowered unit (value, mask, while cond/body,
    data/k index expressions; excluding the write target itself)."""
    if isinstance(stmt, gtir.Assign):
        yield from eve.walk_type(stmt.value, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for idx in stmt.target.data_index:
            yield from eve.walk_type(idx, gtir.FieldAccess)
        if stmt.target.koffset is not None:
            # variable-K WRITE: the level expression is a read
            yield from eve.walk_type(stmt.target.koffset, gtir.FieldAccess)
    elif isinstance(stmt, gtir.While):
        yield from eve.walk_type(stmt.cond, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for s in stmt.body:
            yield from _iter_reads(s)
    else:
        raise TypeError(type(stmt).__name__)


def iter_writes(stmt: gtir.Stmt) -> Iterator[gtir.FieldAccess]:
    if isinstance(stmt, gtir.Assign):
        yield stmt.target
    elif isinstance(stmt, gtir.While):
        for s in stmt.body:
            yield from iter_writes(s)
    else:
        raise TypeError(type(stmt).__name__)


class ExtentAnalysis:
    """Results: ``stmt_extents`` keyed by statement identity, ``field_extents``
    by field name (clamped to include zero)."""

    def __init__(self, stencil: gtir.Stencil):
        self.stmt_extents: dict[gtir.Stmt, Extent] = {}
        self.field_extents: dict[str, Extent] = {}
        param_names = set(stencil.param_names)

        units = list(stencil.walk_stmts())
        for vloop, section, stmt in reversed(units):
            writes = list(iter_writes(stmt))
            ext = Extent.zeros()
            for w in writes:
                ext = ext.union(self.field_extents.get(w.name, Extent.zeros()))
            ext = ext.clamped()
            self.stmt_extents[stmt] = ext

            region_restricted = bool(getattr(stmt, "horizontal_masks", ()))
            for read in _iter_reads(stmt):
                di, dj, dk = read.offset
                k_lo, k_hi = _k_halo(section, dk)
                if read.koffset is not None or read.abs_k is not None:
                    # Variable/absolute K reads are clamped at runtime; no
                    # static K halo demand.
                    k_lo, k_hi = 0, 0
                contrib = Extent(
                    i=(ext.i[0] + di, ext.i[1] + di),
                    j=(ext.j[0] + dj, ext.j[1] + dj),
                    k=(-k_lo, k_hi),
                )
                if region_restricted and read.name in param_names:
                    # Reads inside horizontal regions do not impose halo
                    # requirements on API fields (the restriction typically
                    # exists precisely to stay in bounds near the border).
                    continue
                prev = self.field_extents.get(read.name, Extent.zeros())
                self.field_extents[read.name] = prev.union(contrib).clamped()

            # Writes at a K offset land outside the iteration level: the
            # field needs that K halo, which also shrinks the default
            # domain computed from its shape (reference K-offset-write
            # semantics, test_code_generation.py::test_K_offset_write_*).
            for w in writes:
                dkw = w.offset[2]
                if dkw == 0 or w.koffset is not None:
                    # Variable-K writes are bounds-guarded at runtime
                    # (out-of-range lanes are dropped) — no static demand.
                    continue
                k_lo, k_hi = _k_halo(section, dkw)
                contrib = Extent(i=ext.i, j=ext.j, k=(-k_lo, k_hi))
                prev = self.field_extents.get(w.name, Extent.zeros())
                self.field_extents[w.name] = prev.union(contrib).clamped()


def compute_min_k_size(stencil: gtir.Stencil) -> int:
    """Smallest K domain the interval structure allows (reference:
    DomainInfo.min_sequential_axis_size)."""
    required = 0
    for vloop in stencil.vertical_loops:
        for section in vloop.sections:
            s, e = section.interval.start, section.interval.end
            if s.level == gtir.LevelMarker.START and e.level == gtir.LevelMarker.END:
                required = max(required, s.offset - e.offset)
            elif s.level == gtir.LevelMarker.START and e.level == gtir.LevelMarker.START:
                required = max(required, e.offset)
            elif s.level == gtir.LevelMarker.END and e.level == gtir.LevelMarker.END:
                required = max(required, -s.offset)
    return required
