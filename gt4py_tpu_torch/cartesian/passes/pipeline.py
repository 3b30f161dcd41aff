"""Analysis pipeline: parsed GTIR → fully annotated, backend-ready stencil.

Copied from gt4py_tpu/cartesian/passes/pipeline.py; imports renamed.

Counterpart of the reference's ``GtirPipeline`` + ``OirPipeline``
(src/gt4py/cartesian/gtc/passes/gtir_pipeline.py:24,
oir_pipeline.py:40). The reference's OIR optimization passes (horizontal
execution merging, on-the-fly merging, temporaries-to-scalars, IJ/K cache
detection) exist to schedule generated C++/CUDA loop nests; on TPU those jobs
belong to XLA (fusion, scalar promotion) and the Pallas backend (VMEM
residency), so the pipeline here is: definitive assignment → control-flow
lowering → dtype inference → extent analysis → runtime metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import frontend, gtir
from gt4py_tpu_torch.cartesian.definitions import (
    AccessKind,
    Boundary,
    DomainInfo,
    Extent,
    FieldInfo,
    ParameterInfo,
)
from gt4py_tpu_torch.cartesian.passes.definitive_assignment import check_definitive_assignment
from gt4py_tpu_torch.cartesian.passes.extents import (
    ExtentAnalysis,
    compute_min_k_size,
    iter_writes,
)
from gt4py_tpu_torch.cartesian.passes.lowering import lower_control_flow
from gt4py_tpu_torch.cartesian.passes.type_inference import infer_dtypes


@dataclasses.dataclass
class AnalyzedStencil:
    stencil: gtir.Stencil
    stmt_extents: dict[gtir.Stmt, Extent]
    field_extents: dict[str, Extent]
    field_infos: dict[str, FieldInfo]
    parameter_infos: dict[str, ParameterInfo]
    domain_info: DomainInfo
    #: the lowered stencil BEFORE temporary inlining (for backends that
    #: prefer materialized temporaries over recompute, e.g. the value-based
    #: Pallas plane kernels); None when inlining was disabled anyway.
    pre_inline_stencil: "gtir.Stencil | None" = None
    _materialized: "AnalyzedStencil | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def name(self) -> str:
        return self.stencil.name

    def written_fields(self) -> list[str]:
        """API fields written by the stencil, in parameter order."""
        return [
            name
            for name, info in self.field_infos.items()
            if info.access & AccessKind.WRITE
        ]

    def materialized_variant(self) -> "AnalyzedStencil":
        """This analysis re-done with a small recompute cap: non-trivial
        multi-read temporaries stay materialized (computed once) instead of
        being recomputed per shifted read site. Field halo demands of this
        variant are a subset of the primary's, so arrays validated against
        the primary are always sufficient."""
        if self._materialized is not None:
            return self._materialized
        if self.pre_inline_stencil is None:
            self._materialized = self
            return self
        from gt4py_tpu_torch.cartesian.passes.inline_temporaries import inline_temporaries

        stencil = inline_temporaries(self.pre_inline_stencil, expansion_cap=6)
        extents = ExtentAnalysis(stencil)
        self._materialized = AnalyzedStencil(
            stencil=stencil,
            stmt_extents=extents.stmt_extents,
            field_extents=extents.field_extents,
            field_infos=self.field_infos,
            parameter_infos=self.parameter_infos,
            domain_info=self.domain_info,
        )
        return self._materialized


def _step_lower_control_flow(stencil: gtir.Stencil) -> gtir.Stencil:
    return lower_control_flow(stencil)


def _step_vector_unroll(stencil: gtir.Stencil) -> gtir.Stencil:
    # Whole-vector / matmul data-dimension assignments unroll into
    # per-component scalar assignments (reference defir_to_gtir.py:123,195)
    # — the native form for the Pallas per-stream kernels.
    from gt4py_tpu_torch.cartesian.passes.vector_unroll import unroll_vector_assignments

    return unroll_vector_assignments(stencil)


def _step_race_detection(stencil: gtir.Stencil) -> gtir.Stencil:
    # Structural race detection AFTER mask lowering (Ifs are gone, the
    # statement stream is flat) and BEFORE temporary inlining (which would
    # hide the racy reads it substitutes away).
    from gt4py_tpu_torch.cartesian.passes.race_detection import detect_races

    detect_races(stencil)
    return stencil


def _step_power_unroll(stencil: gtir.Stencil) -> gtir.Stencil:
    # Small integral powers become multiplications BEFORE dtype inference
    # (the unrolled tree infers like any product; reference
    # iterator/transforms/power_unrolling.py).
    from gt4py_tpu_torch.cartesian.passes.power_unroll import unroll_powers

    return unroll_powers(stencil)


def _step_infer_dtypes(stencil: gtir.Stencil) -> gtir.Stencil:
    infer_dtypes(stencil)
    return stencil


def _step_seq_fusion(stencil: gtir.Stencil) -> gtir.Stencil:
    # PARALLEL coefficient temporaries consumed by one sequential loop
    # compute per level inside it (reference vertical-loop-merging role):
    # one grid sweep instead of one per producing loop, and concat_where
    # piece boundaries become specialized consumer sections.
    from gt4py_tpu_torch.cartesian.passes.seq_fusion import fuse_parallel_temporaries

    return fuse_parallel_temporaries(stencil)


def _step_inline_temporaries(stencil: gtir.Stencil) -> gtir.Stencil:
    from gt4py_tpu_torch.cartesian.passes.inline_temporaries import inline_temporaries

    return inline_temporaries(stencil)


#: transform steps that only REARRANGE (semantics-preserving); checks
#: (definitive assignment, race detection) are separate — skipping a check
#: loosens the language contract, skipping an optimization only costs perf.
_OPTIMIZATION_STEPS = frozenset({"seq_fusion", "inline_temporaries"})


@dataclasses.dataclass(frozen=True)
class PassPipeline:
    """User-controllable GTIR pass pipeline (the reference's
    ``DefaultPipeline`` skip/add contract, gtc/passes/oir_pipeline.py:55-90:
    "runs passes in order and allows skipping; may only call existing
    passes"). ``skip`` names steps to omit; ``add_steps`` appends custom
    ``Stencil -> Stencil`` callables after the built-in steps (before
    extent analysis). Hashable/reprable so builds fingerprint by it.

    Step names, in order: ``definitive_assignment``, ``lower_control_flow``,
    ``vector_unroll``, ``race_detection``, ``power_unroll``,
    ``infer_dtypes``, ``seq_fusion``, ``inline_temporaries``.
    """

    skip: tuple = ()
    add_steps: tuple = ()

    @staticmethod
    def all_steps() -> "list[tuple[str, Callable]]":
        return [
            ("definitive_assignment", _step_check_definitive_assignment),
            ("lower_control_flow", _step_lower_control_flow),
            ("vector_unroll", _step_vector_unroll),
            ("race_detection", _step_race_detection),
            ("power_unroll", _step_power_unroll),
            ("infer_dtypes", _step_infer_dtypes),
            ("seq_fusion", _step_seq_fusion),
            ("inline_temporaries", _step_inline_temporaries),
        ]

    def __post_init__(self):
        known = {name for name, _ in self.all_steps()}
        unknown = set(self.skip) - known
        if unknown:
            raise ValueError(
                f"Unknown pipeline step(s) to skip: {sorted(unknown)}; "
                f"known steps: {sorted(known)}"
            )
        for step in self.add_steps:
            if not callable(step):
                raise ValueError(f"add_steps entries must be callable, got {step!r}")

    @property
    def steps(self) -> "list[tuple[str, Callable]]":
        kept = [(n, f) for n, f in self.all_steps() if n not in set(self.skip)]
        return kept + [
            (getattr(f, "__name__", repr(f)), f) for f in self.add_steps
        ]

    def __repr__(self) -> str:
        return f"PassPipeline({[n for n, _ in self.steps]})"

    def run(self, stencil: gtir.Stencil) -> "tuple[gtir.Stencil, gtir.Stencil | None]":
        """Apply the steps in order; returns ``(stencil, pre_inline)`` where
        ``pre_inline`` is the stencil just before temporary inlining (the
        materialized-temporaries variant used by value-based backends), or
        None when inlining is skipped."""
        pre_inline: "gtir.Stencil | None" = None
        for name, step in self.steps:
            if name == "inline_temporaries":
                pre_inline = stencil
            stencil = step(stencil)
        return stencil, pre_inline


def _step_check_definitive_assignment(stencil: gtir.Stencil) -> gtir.Stencil:
    check_definitive_assignment(stencil)
    return stencil


def analyze(definition: Callable, options: dict) -> AnalyzedStencil:
    stencil = frontend.parse_stencil(definition, options)
    return analyze_gtir(stencil, options)


def _pipeline_from_options(options: dict) -> PassPipeline:
    opts = options.get("backend_opts", {}) or {}
    pipeline = opts.get("pass_pipeline")
    if pipeline is not None:
        if not isinstance(pipeline, PassPipeline):
            raise TypeError(
                f"pass_pipeline must be a PassPipeline, got {type(pipeline).__name__}"
            )
        return pipeline
    skip = []
    if not opts.get("fuse_sequential", True):
        skip.append("seq_fusion")
    if not opts.get("inline_temporaries", True):
        skip.append("inline_temporaries")
    return PassPipeline(skip=tuple(skip))


def analyze_gtir(stencil: "gtir.Stencil", options: dict) -> AnalyzedStencil:
    """Run the analysis pipeline on an already-built GTIR stencil (used by
    the field-view cartesian bridge, next/cartesian_bridge.py)."""
    stencil, pre_inline = _pipeline_from_options(options).run(stencil)
    extents = ExtentAnalysis(stencil)

    access: dict[str, AccessKind] = {p.name: AccessKind.NONE for p in stencil.params}
    for _, _, stmt in stencil.walk_stmts():
        for w in iter_writes(stmt):
            if w.name in access:
                access[w.name] |= AccessKind.WRITE
        for node in _all_reads(stmt):
            if node.name in access:
                access[node.name] |= AccessKind.READ
        for node in _all_scalar_reads(stmt):
            if node.name in access:
                access[node.name] |= AccessKind.READ

    field_infos: dict[str, FieldInfo] = {}
    parameter_infos: dict[str, ParameterInfo] = {}
    for p in stencil.params:
        if isinstance(p, gtir.FieldDecl):
            ext = extents.field_extents.get(p.name, Extent.zeros())
            axes = tuple(ax for ax, m in zip("IJK", p.dimensions) if m)
            boundary = _mask_boundary(ext.boundary, p.dimensions)
            field_infos[p.name] = FieldInfo(
                access=access[p.name],
                boundary=boundary,
                axes=axes,
                data_dims=p.data_dims,
                dtype=p.dtype,
            )
        elif isinstance(p, gtir.GlobalTableDecl):
            field_infos[p.name] = FieldInfo(
                access=access[p.name],
                boundary=Boundary(),
                axes=(),
                data_dims=p.shape,
                dtype=p.dtype,
            )
        elif isinstance(p, gtir.ScalarDecl):
            parameter_infos[p.name] = ParameterInfo(access=access[p.name], dtype=p.dtype)

    domain_info = DomainInfo(min_sequential_axis_size=compute_min_k_size(stencil))
    return AnalyzedStencil(
        stencil=stencil,
        stmt_extents=extents.stmt_extents,
        field_extents=extents.field_extents,
        field_infos=field_infos,
        parameter_infos=parameter_infos,
        domain_info=domain_info,
        pre_inline_stencil=pre_inline,
    )


def _all_reads(stmt: gtir.Stmt):
    if isinstance(stmt, gtir.Assign):
        yield from eve.walk_type(stmt.value, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for idx in stmt.target.data_index:
            yield from eve.walk_type(idx, gtir.FieldAccess)
        if stmt.target.koffset is not None:
            # variable-K WRITE target: the level expression is a read
            yield from eve.walk_type(stmt.target.koffset, gtir.FieldAccess)
    elif isinstance(stmt, gtir.While):
        yield from eve.walk_type(stmt.cond, gtir.FieldAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.FieldAccess)
        for s in stmt.body:
            yield from _all_reads(s)


def _all_scalar_reads(stmt: gtir.Stmt):
    if isinstance(stmt, gtir.Assign):
        yield from eve.walk_type(stmt.value, gtir.ScalarAccess)
        if stmt.mask is not None:
            yield from eve.walk_type(stmt.mask, gtir.ScalarAccess)
        if stmt.target.koffset is not None:
            yield from eve.walk_type(stmt.target.koffset, gtir.ScalarAccess)
    elif isinstance(stmt, gtir.While):
        yield from eve.walk_type(stmt.cond, gtir.ScalarAccess)
        for s in stmt.body:
            yield from _all_scalar_reads(s)


def _mask_boundary(boundary: Boundary, mask: tuple[bool, bool, bool]) -> Boundary:
    lower = tuple(b if m else 0 for b, m in zip(boundary.lower, mask))
    upper = tuple(b if m else 0 for b, m in zip(boundary.upper, mask))
    return Boundary(lower=lower, upper=upper)  # type: ignore[arg-type]
