"""GTIR — declarative stencil IR for the TPU-native cartesian DSL.

Copied from gt4py_tpu/cartesian/gtir.py; imports renamed.

Single mid-level IR combining the roles of the reference's GTIR
(src/gt4py/cartesian/gtc/gtir.py) and OIR
(src/gt4py/cartesian/gtc/oir.py). The reference needs two
IRs because its backends emit imperative C++/CUDA loop nests (OIR models
loops, caches and masks explicitly); here every backend lowers to
JAX/XLA/Pallas where scheduling (fusion, loop structure, on-chip residency)
is carried by annotations on this IR plus the compiler:

- per-statement ``Extent`` annotations (computed by
  ``passes/extents.py``) replace OIR's HorizontalExecution extents,
- FieldIf/While stay structured (vector backends lower them to masked
  selects; reference lowers them to OIR MaskStmt),
- IJ/K cache detection (reference oir_optimizations/caches.py) maps to
  VMEM block residency in the Pallas backend.

Semantics follow the GTScript language spec
(docs/user/cartesian/lang_design.rst): statements inside a
``computation`` are *parallel assignments* over the horizontal domain,
executed in program order; vertical loops iterate K ``PARALLEL``,
``FORWARD`` or ``BACKWARD`` with non-overlapping interval sections.
"""

from __future__ import annotations

import enum
from typing import Any, Optional, Union

import numpy as np

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.eve import Node, datamodel, field


# --- common vocabulary (reference: gtc/common.py:65-131) ---------------------


class LoopOrder(enum.Enum):
    PARALLEL = "parallel"
    FORWARD = "forward"
    BACKWARD = "backward"


class UnaryOperator(enum.Enum):
    POS = "+"
    NEG = "-"
    NOT = "not"


class ArithmeticOperator(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    POW = "**"
    MOD = "%"
    MATMUL = "@"


class ComparisonOperator(enum.Enum):
    EQ = "=="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="


class LogicalOperator(enum.Enum):
    AND = "and"
    OR = "or"


BinaryOperator = Union[ArithmeticOperator, ComparisonOperator, LogicalOperator]


class NativeFunction(enum.Enum):
    """Math builtins with fixed arity (reference: gtc/common.py:150-243)."""

    ABS = "abs"
    MIN = "min"
    MAX = "max"
    MOD = "mod"
    SIN = "sin"
    COS = "cos"
    TAN = "tan"
    ASIN = "asin"
    ACOS = "acos"
    ATAN = "atan"
    SINH = "sinh"
    COSH = "cosh"
    TANH = "tanh"
    ASINH = "asinh"
    ACOSH = "acosh"
    ATANH = "atanh"
    SQRT = "sqrt"
    CBRT = "cbrt"
    EXP = "exp"
    LOG = "log"
    LOG10 = "log10"
    GAMMA = "gamma"
    ISFINITE = "isfinite"
    ISINF = "isinf"
    ISNAN = "isnan"
    FLOOR = "floor"
    CEIL = "ceil"
    TRUNC = "trunc"
    ROUND = "round"
    ROUND_AWAY_FROM_ZERO = "round_away_from_zero"
    ERF = "erf"
    ERFC = "erfc"
    POW = "pow"
    ATAN2 = "atan2"
    HYPOT = "hypot"
    COPYSIGN = "copysign"
    FMA = "fma"

    @property
    def arity(self) -> int:
        return _NATIVE_FUNCTION_ARITY[self]


_NATIVE_FUNCTION_ARITY = {
    NativeFunction.ABS: 1,
    NativeFunction.MIN: 2,
    NativeFunction.MAX: 2,
    NativeFunction.MOD: 2,
    NativeFunction.POW: 2,
    NativeFunction.ATAN2: 2,
    NativeFunction.HYPOT: 2,
    NativeFunction.COPYSIGN: 2,
    NativeFunction.FMA: 3,
    **{
        f: 1
        for f in NativeFunction
        if f.value
        not in ("abs", "min", "max", "mod", "pow", "atan2", "hypot", "copysign", "fma")
    },
}


class LevelMarker(enum.Enum):
    START = "start"
    END = "end"


@datamodel
class AxisBound(Node):
    """Position on the K axis relative to the compute domain start/end
    (reference: gtc/common.py:756)."""

    level: LevelMarker
    offset: int = 0

    @classmethod
    def start(cls, offset: int = 0) -> "AxisBound":
        return cls(level=LevelMarker.START, offset=offset)

    @classmethod
    def end(cls, offset: int = 0) -> "AxisBound":
        return cls(level=LevelMarker.END, offset=offset)

    @classmethod
    def from_int(cls, value: Optional[int], *, is_end: bool) -> "AxisBound":
        """GTScript ``interval(start, stop)`` convention: non-negative ints
        are offsets from the domain start, negative ints from the domain end,
        ``None`` means the full extent on that side."""
        if value is None:
            return cls.end() if is_end else cls.start()
        if value >= 0:
            return cls.start(value)
        return cls.end(value)

    def resolve(self, k_size: int) -> int:
        return self.offset if self.level == LevelMarker.START else k_size + self.offset


@datamodel
class Interval(Node):
    """Half-open K interval ``[start, end)`` (reference: gtc/gtir.py:207)."""

    start: AxisBound
    end: AxisBound

    @classmethod
    def full(cls) -> "Interval":
        return cls(start=AxisBound.start(), end=AxisBound.end())

    def resolve(self, k_size: int) -> tuple[int, int]:
        return self.start.resolve(k_size), self.end.resolve(k_size)


# --- horizontal regions (reference: gtc/common.py:872, gtscript.py:548-620) --


@datamodel
class HorizontalInterval(Node):
    """Restriction of one horizontal axis; ``None`` bound = unbounded."""

    start: Optional[AxisBound] = None
    end: Optional[AxisBound] = None


@datamodel
class HorizontalMask(Node):
    i: HorizontalInterval = field(default_factory=HorizontalInterval)
    j: HorizontalInterval = field(default_factory=HorizontalInterval)


# --- expressions -------------------------------------------------------------


@datamodel
class Expr(Node):
    pass


@datamodel
class Literal(Expr):
    value: Any
    dtype: np.dtype = None  # type: ignore[assignment]


@datamodel
class ScalarAccess(Expr):
    """Read of a scalar parameter or a compile-time external value."""

    name: str
    dtype: Optional[np.dtype] = None


@datamodel
class FieldAccess(Expr):
    """Field read/write at a relative offset.

    ``offset`` is the (i, j, k) relative offset; a *variable* K offset
    (reference: gtc/gtir.py:50 VariableKOffset) is expressed with
    ``koffset`` set to an Expr (then ``offset[2]`` must be 0); *absolute*
    K indexing ``field.at(K=expr)`` (reference: gtc/gtir.py:54) with
    ``abs_k`` set. ``data_index`` subscripts trailing data dimensions.
    """

    name: str
    offset: tuple[int, int, int] = (0, 0, 0)
    koffset: Optional[Expr] = None
    abs_k: Optional[Expr] = None
    data_index: tuple[Expr, ...] = ()
    dtype: Optional[np.dtype] = None


@datamodel
class UnaryOp(Expr):
    op: UnaryOperator
    expr: Expr
    dtype: Optional[np.dtype] = None


@datamodel
class BinaryOp(Expr):
    op: Any  # BinaryOperator
    left: Expr
    right: Expr
    dtype: Optional[np.dtype] = None


@datamodel
class TernaryOp(Expr):
    cond: Expr
    true_expr: Expr
    false_expr: Expr
    dtype: Optional[np.dtype] = None


@datamodel
class NativeFuncCall(Expr):
    func: NativeFunction
    args: list[Expr] = field(default_factory=list)
    dtype: Optional[np.dtype] = None


@datamodel
class Cast(Expr):
    dtype: np.dtype
    expr: Expr = None  # type: ignore[assignment]


@datamodel
class IteratorAccess(Expr):
    """Current K iteration index read as a value (``x = K`` inside a
    computation; reference gtc/gtir.py:68 IteratorAccess, frontend
    gtscript_frontend.py:1298). Only the K axis can be queried; the value
    is the absolute K index within the compute domain (0-based from the
    domain start, reference npir_codegen.py:346-347)."""

    axis: str = "K"
    dtype: Optional[np.dtype] = None


# --- statements --------------------------------------------------------------


@datamodel
class Stmt(Node):
    pass


@datamodel
class Assign(Stmt):
    """Parallel assignment over the horizontal domain
    (reference GTIR ParAssignStmt, gtc/gtir.py:78).

    After the control-flow lowering pass (passes/lowering.py), conditional
    writes carry a boolean ``mask`` expression and/or a ``horizontal_mask``
    region restriction — the role OIR MaskStmt plays in the reference
    (gtc/oir.py:84): ``target = where(mask ∧ region, value, target)``.
    """

    target: FieldAccess
    value: Expr
    mask: Optional[Expr] = None
    horizontal_masks: tuple[HorizontalMask, ...] = ()
    loc: Optional[eve.SourceLocation] = None


@datamodel
class If(Stmt):
    """Conditional; ``is_scalar`` marks compile-/runtime-scalar conditions
    (reference ScalarIfStmt gtc/gtir.py:139), otherwise a per-gridpoint
    masked conditional (FieldIfStmt gtc/gtir.py:114)."""

    cond: Expr
    body: list[Stmt] = field(default_factory=list)
    orelse: list[Stmt] = field(default_factory=list)
    is_scalar: bool = False
    loc: Optional[eve.SourceLocation] = None


@datamodel
class While(Stmt):
    """Per-gridpoint while loop (reference gtc/gtir.py:156). After lowering,
    ``mask``/``horizontal_mask`` restrict which grid points iterate."""

    cond: Expr
    body: list[Stmt] = field(default_factory=list)
    mask: Optional[Expr] = None
    horizontal_masks: tuple[HorizontalMask, ...] = ()
    loc: Optional[eve.SourceLocation] = None


@datamodel
class HorizontalRestriction(Stmt):
    """Execute body only inside a horizontal region
    (reference gtc/gtir.py:152)."""

    mask: HorizontalMask
    body: list[Stmt] = field(default_factory=list)
    loc: Optional[eve.SourceLocation] = None


# --- declarations ------------------------------------------------------------


@datamodel
class Decl(Node):
    pass


@datamodel
class FieldDecl(Decl):
    """API field parameter. ``dimensions`` masks which of (I, J, K) the
    field spans; ``data_dims`` are trailing non-spatial dimensions."""

    name: str
    dtype: np.dtype = None  # type: ignore[assignment]
    dimensions: tuple[bool, bool, bool] = (True, True, True)
    data_dims: tuple[int, ...] = ()


@datamodel
class ScalarDecl(Decl):
    name: str
    dtype: np.dtype = None  # type: ignore[assignment]


@datamodel
class Temporary(Decl):
    """Computation-scoped temporary field (auto-extended domain,
    reference lang_design.rst:153-197)."""

    name: str
    dtype: Optional[np.dtype] = None
    data_dims: tuple[int, ...] = ()


@datamodel
class GlobalTableDecl(Decl):
    """Read-only lookup table parameter (reference gtscript.py:773)."""

    name: str
    dtype: np.dtype = None  # type: ignore[assignment]
    shape: tuple[int, ...] = ()


# --- structure ---------------------------------------------------------------


@datamodel
class VerticalSection(Node):
    interval: Interval
    body: list[Stmt] = field(default_factory=list)
    loc: Optional[eve.SourceLocation] = None


@datamodel
class VerticalLoop(Node):
    loop_order: LoopOrder
    sections: list[VerticalSection] = field(default_factory=list)
    loc: Optional[eve.SourceLocation] = None


@datamodel
class Stencil(Node):
    """Top-level stencil program (reference gtc/gtir.py:301)."""

    name: str
    params: list[Decl] = field(default_factory=list)
    vertical_loops: list[VerticalLoop] = field(default_factory=list)
    temporaries: list[Temporary] = field(default_factory=list)
    externals: dict = field(default_factory=dict)
    docstring: str = ""
    loc: Optional[eve.SourceLocation] = None

    @property
    def param_names(self) -> list[str]:
        return [p.name for p in self.params]

    def symtable(self) -> dict[str, Decl]:
        table: dict[str, Decl] = {p.name: p for p in self.params}
        table.update({t.name: t for t in self.temporaries})
        return table

    def walk_stmts(self):
        """Yield (vertical_loop, section, stmt) for all top-level statements."""
        for vloop in self.vertical_loops:
            for section in vloop.sections:
                for stmt in section.body:
                    yield vloop, section, stmt
