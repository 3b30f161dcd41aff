"""GTIR → C source generation for the native ``cpu:c`` backend.

Copied from gt4py_tpu/cartesian/backend/c_codegen.py; imports renamed.

The counterpart of the reference's generated-C++ backends
(src/gt4py/cartesian/backend/gtcpp_backend.py:169,
gt4py/cartesian/gtc/gtcpp/gtcpp_codegen.py): the lowered GTIR is rendered
to a single self-contained C translation unit (triple loop nests over the
per-statement extents, OpenMP-parallel horizontal planes), compiled
on-the-fly with the system C compiler and bound through ``ctypes`` — the
role nanobind/CMake play in the reference OTF pipeline
(next/otf/binding/nanobind.py, compilation/build_systems/cmake.py).

The generated function has ONE fixed ABI for every stencil::

    void gt_run(void** fields, const long long* shapes,
                const long long* strides, const long long* origins,
                const double* fscalars, const long long* iscalars,
                long long ni, long long nj, long long nk)

``fields`` are the API field/table base pointers in parameter order;
``shapes``/``strides`` (bytes) are flattened per-field with offsets fixed
at generation time; ``origins`` are role-indexed (I, J, K) triples.
Temporaries are heap-allocated inside the function with their
compile-time extents (zero-initialized, matching the numpy/debug
backends). Numerics replicate NumPy semantics: floor-division ``%``,
true-divide on integers, NaN-propagating min/max, banker's ``round``,
K-index clamping for variable/absolute K offsets. The loop nest walks K,
then I, then J innermost, so on the port's K-leading storages
(storage/layout.py) the inner loop steps through contiguous memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import Extent
from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil
from gt4py_tpu_torch.cartesian.passes.type_inference import _promote
from gt4py_tpu_torch.core.definitions import HALF_FLOAT_DTYPES


class CUnsupported(Exception):
    """Raised when a construct has no C rendering; the backend falls back
    to the numpy evaluator (transparent, recorded in ``last_path``)."""


_CTYPES = {
    "bool": "unsigned char",
    "int8": "int8_t",
    "int16": "int16_t",
    "int32": "int32_t",
    "int64": "int64_t",
    "uint8": "uint8_t",
    "uint16": "uint16_t",
    "uint32": "uint32_t",
    "uint64": "uint64_t",
    "float32": "float",
    "float64": "double",
}

_F64 = np.dtype(np.float64)
_F32 = np.dtype(np.float32)
_BOOL = np.dtype(np.bool_)

#: NativeFunction -> C libm name (f64 variant; f32 appends 'f').
_LIBM = {
    gtir.NativeFunction.SIN: "sin",
    gtir.NativeFunction.COS: "cos",
    gtir.NativeFunction.TAN: "tan",
    gtir.NativeFunction.ASIN: "asin",
    gtir.NativeFunction.ACOS: "acos",
    gtir.NativeFunction.ATAN: "atan",
    gtir.NativeFunction.SINH: "sinh",
    gtir.NativeFunction.COSH: "cosh",
    gtir.NativeFunction.TANH: "tanh",
    gtir.NativeFunction.ASINH: "asinh",
    gtir.NativeFunction.ACOSH: "acosh",
    gtir.NativeFunction.ATANH: "atanh",
    gtir.NativeFunction.SQRT: "sqrt",
    gtir.NativeFunction.CBRT: "cbrt",
    gtir.NativeFunction.EXP: "exp",
    gtir.NativeFunction.LOG: "log",
    gtir.NativeFunction.LOG10: "log10",
    gtir.NativeFunction.GAMMA: "tgamma",
    gtir.NativeFunction.ERF: "erf",
    gtir.NativeFunction.ERFC: "erfc",
    gtir.NativeFunction.ATAN2: "atan2",
    gtir.NativeFunction.HYPOT: "hypot",
    gtir.NativeFunction.COPYSIGN: "copysign",
    gtir.NativeFunction.POW: "pow",
    gtir.NativeFunction.FMA: "fma",
    gtir.NativeFunction.FLOOR: "floor",
    gtir.NativeFunction.CEIL: "ceil",
    gtir.NativeFunction.TRUNC: "trunc",
    gtir.NativeFunction.ROUND: "rint",  # NumPy round = half-to-even
    gtir.NativeFunction.ROUND_AWAY_FROM_ZERO: "round",
}

_PRELUDE = r"""
#include <stdint.h>
#include <stdlib.h>
#include <math.h>

static inline long long gt_clampk(long long k, long long n) {
    return k < 0 ? 0 : (k >= n ? n - 1 : k);
}
/* NumPy floor-mod: result sign follows the divisor. */
static inline double gt_fmod_np(double a, double b) {
    double r = fmod(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
static inline float gt_fmodf_np(float a, float b) {
    float r = fmodf(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
static inline int64_t gt_imod_np(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
static inline int64_t gt_ipow(int64_t base, int64_t e) {
    if (e < 0) return (int64_t)pow((double)base, (double)e);
    int64_t r = 1;
    while (e) { if (e & 1) r *= base; base *= base; e >>= 1; }
    return r;
}
/* NumPy minimum/maximum propagate NaN from either operand. */
static inline double gt_fmin_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
static inline double gt_fmax_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
static inline float gt_fminf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
static inline float gt_fmaxf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
static inline int64_t gt_imin(int64_t a, int64_t b) { return a < b ? a : b; }
static inline int64_t gt_imax(int64_t a, int64_t b) { return a > b ? a : b; }
"""


def _np_dtype(dtype: Any) -> np.dtype:
    if dtype is None:
        raise CUnsupported("expression with unresolved dtype")
    return np.dtype(dtype)


def _ctype(dtype: Any) -> str:
    dt = _np_dtype(dtype)
    if dt in HALF_FLOAT_DTYPES:
        raise CUnsupported(f"half-precision dtype {dt} has no native C type")
    try:
        return _CTYPES[dt.name]
    except KeyError:
        raise CUnsupported(f"dtype {dt} not supported by the C backend") from None


@dataclasses.dataclass
class _FieldMeta:
    """Per-symbol layout info shared by codegen and the runtime caller."""

    name: str
    var: str
    dtype: np.dtype
    axes: tuple[bool, bool, bool]  # (I, J, K) presence; tables: all False
    data_dims: tuple[int, ...]
    index: int = -1  # slot in the fields/origins arrays (params only)
    shape_off: int = -1  # offset into the flat shapes/strides arrays
    is_temp: bool = False
    extent: Optional[Extent] = None  # temps only

    @property
    def ndim(self) -> int:
        return sum(self.axes) + len(self.data_dims)


@dataclasses.dataclass
class CModule:
    """Generated source + the call metadata the runtime needs."""

    source: str
    fields: list[_FieldMeta]  # parameter fields/tables, in order
    scalars: list[tuple[str, str, int, np.dtype]]  # (name, 'f'|'i', slot, dtype)
    n_shape_slots: int


def generate(analyzed: AnalyzedStencil) -> CModule:
    return _Generator(analyzed).generate()


class _Generator:
    def __init__(self, analyzed: AnalyzedStencil):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.fields: dict[str, _FieldMeta] = {}
        self.param_fields: list[_FieldMeta] = []
        self.scalars: list[tuple[str, str, int, np.dtype]] = []
        self.scalar_vars: dict[str, str] = {}
        self.lines: list[str] = []
        self.indent = 1

        shape_off = 0
        index = 0
        f_slot = i_slot = 0
        for p in self.stencil.params:
            if isinstance(p, gtir.FieldDecl):
                meta = _FieldMeta(
                    name=p.name,
                    var=f"f{index}",
                    dtype=_np_dtype(p.dtype),
                    axes=tuple(p.dimensions),
                    data_dims=tuple(p.data_dims),
                    index=index,
                    shape_off=shape_off,
                )
            elif isinstance(p, gtir.GlobalTableDecl):
                meta = _FieldMeta(
                    name=p.name,
                    var=f"f{index}",
                    dtype=_np_dtype(p.dtype),
                    axes=(False, False, False),
                    data_dims=tuple(p.shape),
                    index=index,
                    shape_off=shape_off,
                )
            elif isinstance(p, gtir.ScalarDecl):
                dt = _np_dtype(p.dtype)
                _ctype(dt)  # reject half floats early
                if dt.kind == "f":
                    self.scalars.append((p.name, "f", f_slot, dt))
                    f_slot += 1
                else:
                    self.scalars.append((p.name, "i", i_slot, dt))
                    i_slot += 1
                self.scalar_vars[p.name] = f"sc_{p.name}"
                continue
            else:
                raise CUnsupported(f"parameter kind {type(p).__name__}")
            _ctype(meta.dtype)
            self.fields[p.name] = meta
            self.param_fields.append(meta)
            shape_off += meta.ndim
            index += 1
        self.n_shape_slots = shape_off

        for ti, t in enumerate(self.stencil.temporaries):
            ext = analyzed.field_extents.get(t.name, Extent.zeros())
            meta = _FieldMeta(
                name=t.name,
                var=f"t{ti}",
                dtype=_np_dtype(t.dtype),
                axes=(True, True, True),
                data_dims=tuple(t.data_dims),
                is_temp=True,
                extent=ext,
            )
            _ctype(meta.dtype)
            self.fields[t.name] = meta

    # -- emission helpers ----------------------------------------------------

    def emit(self, line: str = "") -> None:
        self.lines.append("    " * self.indent + line if line else "")

    # -- top level -----------------------------------------------------------

    def generate(self) -> CModule:
        self._emit_header()
        self._emit_field_locals()
        self._emit_scalar_locals()
        self._emit_temp_allocs()
        for vloop in self.stencil.vertical_loops:
            self._emit_vloop(vloop)
        self._emit_temp_frees()
        self.lines.append("}")
        # NOTE: deliberately name-free — the .so cache is keyed by source
        # hash, and identical definitions registered under different stencil
        # names must share one compiled object (cf. the location-free tk
        # probe-cache keys in pallas_backend).
        source = (
            "/* generated by gt4py_tpu_torch cpu:c backend */\n"
            + _PRELUDE
            + "\n"
            + "\n".join(self.lines)
            + "\n"
        )
        return CModule(
            source=source,
            fields=self.param_fields,
            scalars=self.scalars,
            n_shape_slots=self.n_shape_slots,
        )

    def _emit_header(self) -> None:
        self.lines.append(
            "void gt_run(void** fields, const long long* shapes,\n"
            "            const long long* strides, const long long* origins,\n"
            "            const double* fscalars, const long long* iscalars,\n"
            "            long long ni, long long nj, long long nk)\n{"
        )
        self.emit("(void)fields; (void)shapes; (void)strides; (void)origins;")
        self.emit("(void)fscalars; (void)iscalars; (void)ni; (void)nj; (void)nk;")

    def _emit_field_locals(self) -> None:
        for m in self.param_fields:
            v = m.var
            # NOT restrict: API fields may alias (in-place/aliased calls).
            self.emit(f"char* {v} = (char*)fields[{m.index}];")
            axis_pos = 0
            for role, present in zip("ijk", m.axes):
                if not present:
                    continue
                self.emit(
                    f"const long long {v}_s{role} = strides[{m.shape_off + axis_pos}];"
                )
                if role == "k":
                    self.emit(
                        f"const long long {v}_nk = shapes[{m.shape_off + axis_pos}];"
                    )
                axis_pos += 1
            for d in range(len(m.data_dims)):
                self.emit(
                    f"const long long {v}_d{d} = strides[{m.shape_off + axis_pos + d}];"
                )
            for role, present in zip("ijk", m.axes):
                if present:
                    ri = "ijk".index(role)
                    self.emit(
                        f"const long long {v}_o{role} = origins[{m.index * 3 + ri}];"
                    )
            self.emit()

    def _emit_scalar_locals(self) -> None:
        for name, kind, slot, dt in self.scalars:
            ct = _ctype(dt)
            src = f"fscalars[{slot}]" if kind == "f" else f"iscalars[{slot}]"
            self.emit(f"const {ct} sc_{name} = ({ct}){src};")
        if self.scalars:
            self.emit()

    def _emit_temp_allocs(self) -> None:
        for m in self.fields.values():
            if not m.is_temp:
                continue
            v, ext = m.var, m.extent
            ct = _ctype(m.dtype)
            self.emit(f"const long long {v}_xi = ni + ({ext.i[1] - ext.i[0]});")
            self.emit(f"const long long {v}_xj = nj + ({ext.j[1] - ext.j[0]});")
            self.emit(f"const long long {v}_nk = nk + ({ext.k[1] - ext.k[0]});")
            # C-order strides in bytes: data dims innermost.
            inner = f"(long long)sizeof({ct})"
            for d in reversed(range(len(m.data_dims))):
                self.emit(f"const long long {v}_d{d} = {inner};")
                inner = f"{v}_d{d} * {m.data_dims[d]}"
            self.emit(f"const long long {v}_sk = {inner};")
            self.emit(f"const long long {v}_sj = {v}_sk * {v}_nk;")
            self.emit(f"const long long {v}_si = {v}_sj * {v}_xj;")
            self.emit(f"const long long {v}_oi = {-ext.i[0]};")
            self.emit(f"const long long {v}_oj = {-ext.j[0]};")
            self.emit(f"const long long {v}_ok = {-ext.k[0]};")
            self.emit(
                f"char* restrict {v} = (char*)calloc("
                f"(size_t)({v}_si * {v}_xi), 1);"
            )
            self.emit()

    def _emit_temp_frees(self) -> None:
        for m in self.fields.values():
            if m.is_temp:
                self.emit(f"free({m.var});")

    # -- loops ---------------------------------------------------------------

    def _emit_vloop(self, vloop: gtir.VerticalLoop) -> None:
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            for section in vloop.sections:
                ks, ke = self._k_bounds(section.interval)
                for stmt in section.body:
                    self.emit("#pragma omp parallel for collapse(2)")
                    self.emit(f"for (long long k = {ks}; k < {ke}; ++k)")
                    self._emit_plane(stmt, k_outer=True)
        else:
            backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
            for section in vloop.sections:
                ks, ke = self._k_bounds(section.interval)
                if backward:
                    self.emit(f"for (long long k = ({ke}) - 1; k >= {ks}; --k) {{")
                else:
                    self.emit(f"for (long long k = {ks}; k < {ke}; ++k) {{")
                self.indent += 1
                for stmt in section.body:
                    self.emit("#pragma omp parallel for")
                    self._emit_plane(stmt, k_outer=False)
                self.indent -= 1
                self.emit("}")

    def _k_bounds(self, interval: gtir.Interval) -> tuple[str, str]:
        def bound(b: gtir.AxisBound) -> str:
            if b.level == gtir.LevelMarker.START:
                return str(b.offset)
            return f"nk + ({b.offset})"

        return bound(interval.start), bound(interval.end)

    def _emit_plane(self, stmt: gtir.Stmt, *, k_outer: bool) -> None:
        ext = self.analyzed.stmt_extents[stmt]
        self.emit(
            f"for (long long i = {ext.i[0]}; i < ni + ({ext.i[1]}); ++i)"
        )
        self.indent += 1
        self.emit(
            f"for (long long j = {ext.j[0]}; j < nj + ({ext.j[1]}); ++j) {{"
        )
        self.indent += 1
        self._emit_stmt(stmt)
        self.indent -= 1
        self.emit("}")
        self.indent -= 1

    def _region_cond(self, hmasks) -> str:
        """Point-in-all-regions condition (debug backend `_in_region`)."""
        terms = []
        for hm in hmasks:
            for var, interval, size in (("i", hm.i, "ni"), ("j", hm.j, "nj")):
                for b, cmp_ in ((interval.start, ">="), (interval.end, "<")):
                    if b is None:
                        continue
                    if b.level == gtir.LevelMarker.START:
                        bound = str(b.offset)
                    else:
                        bound = f"{size} + ({b.offset})"
                    terms.append(f"({var} {cmp_} {bound})")
        return " && ".join(terms) if terms else "1"

    def _emit_stmt(self, stmt: gtir.Stmt) -> None:
        hmasks = getattr(stmt, "horizontal_masks", ())
        if hmasks:
            self.emit(f"if (!({self._region_cond(hmasks)})) continue;")
        if isinstance(stmt, gtir.Assign):
            self._emit_assign(stmt, guard="continue")
        elif isinstance(stmt, gtir.While):
            cond = self._expr(stmt.cond)
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            self.emit(f"while ({cond}) {{")
            self.indent += 1
            for s in stmt.body:
                if not isinstance(s, gtir.Assign):
                    raise CUnsupported(
                        f"{type(s).__name__} inside while body"
                    )
                self._emit_assign(s, guard="block")
            self.indent -= 1
            self.emit("}")
        else:
            raise CUnsupported(f"statement {type(stmt).__name__}")

    def _emit_assign(self, stmt: gtir.Assign, *, guard: str) -> None:
        t = stmt.target
        if t.koffset is not None:
            # Variable-K-offset write: out-of-range target levels are
            # DROPPED (a clamp would smear onto the boundary level).
            m = self.fields.get(t.name)
            if m is None:
                raise CUnsupported(f"access to unknown symbol '{t.name}'")
            v = m.var
            kt = (
                f"({v}_ok + k + ({t.offset[2]}) + "
                f"(long long)({self._expr(t.koffset)}))"
            )
            cond = f"{kt} >= 0 && {kt} < {v}_nk"
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            store = f"{self._access(t, k_override=kt)} = {self._expr(stmt.value)};"
            self.emit(f"if ({cond}) {{ {store} }}")
            return
        store = f"{self._access(stmt.target)} = {self._expr(stmt.value)};"
        if stmt.mask is None:
            self.emit(store)
        elif guard == "continue":
            self.emit(f"if (!({self._expr(stmt.mask)})) continue;")
            self.emit(store)
        else:
            self.emit(f"if ({self._expr(stmt.mask)}) {{ {store} }}")

    # -- expressions ---------------------------------------------------------

    def _access(self, node: gtir.FieldAccess, *, k_override: str = "") -> str:
        m = self.fields.get(node.name)
        if m is None:
            raise CUnsupported(f"access to unknown symbol '{node.name}'")
        v = m.var
        ct = _ctype(m.dtype)
        terms = []
        if m.axes[0]:
            terms.append(f"({v}_oi + i + ({node.offset[0]})) * {v}_si")
        if m.axes[1]:
            terms.append(f"({v}_oj + j + ({node.offset[1]})) * {v}_sj")
        if m.axes[2]:
            if k_override:
                # caller computed (and bounds-checked) the K index
                terms.append(f"{k_override} * {v}_sk")
            else:
                if node.abs_k is not None:
                    kexpr = f"{v}_ok + (long long)({self._expr(node.abs_k)})"
                elif node.koffset is not None:
                    kexpr = (
                        f"{v}_ok + k + ({node.offset[2]}) + "
                        f"(long long)({self._expr(node.koffset)})"
                    )
                else:
                    kexpr = f"{v}_ok + k + ({node.offset[2]})"
                terms.append(f"gt_clampk({kexpr}, {v}_nk) * {v}_sk")
        for d, e in enumerate(node.data_index):
            terms.append(f"((long long)({self._expr(e)})) * {v}_d{d}")
        offset = " + ".join(terms) if terms else "0"
        return f"(*({ct}*)({v} + {offset}))"

    def _expr(self, node: gtir.Expr) -> str:
        if isinstance(node, gtir.Literal):
            return self._literal(node.value, _np_dtype(node.dtype))
        if isinstance(node, gtir.ScalarAccess):
            var = self.scalar_vars.get(node.name)
            if var is None:
                raise CUnsupported(f"scalar '{node.name}' is not a parameter")
            return var
        if isinstance(node, gtir.FieldAccess):
            return self._access(node)
        if isinstance(node, gtir.UnaryOp):
            inner = self._expr(node.expr)
            if node.op == gtir.UnaryOperator.NOT:
                return f"(!({inner}))"
            if node.op == gtir.UnaryOperator.NEG:
                return f"(-({inner}))"
            return f"(+({inner}))"
        if isinstance(node, gtir.BinaryOp):
            return self._binop(node)
        if isinstance(node, gtir.TernaryOp):
            ct = _ctype(node.dtype)
            return (
                f"(({self._expr(node.cond)}) ? ({ct})({self._expr(node.true_expr)})"
                f" : ({ct})({self._expr(node.false_expr)}))"
            )
        if isinstance(node, gtir.NativeFuncCall):
            return self._call(node)
        if isinstance(node, gtir.Cast):
            ct = _ctype(node.dtype)
            inner = self._expr(node.expr)
            if _np_dtype(node.dtype) == _BOOL:
                return f"((unsigned char)(({inner}) != 0))"
            return f"(({ct})({inner}))"
        if isinstance(node, gtir.IteratorAccess):
            dt = node.dtype if node.dtype is not None else np.dtype(np.int64)
            return f"(({_ctype(dt)})k)"
        raise CUnsupported(f"expression {type(node).__name__}")

    def _literal(self, value: Any, dtype: np.dtype) -> str:
        ct = _ctype(dtype)
        if dtype.kind == "b":
            return "1" if value else "0"
        if dtype.kind in "iu":
            return f"(({ct})({int(value)}LL))"
        v = float(value)
        if math.isnan(v):
            return f"(({ct})NAN)"
        if math.isinf(v):
            sign = "-" if v < 0 else ""
            return f"(({ct})({sign}INFINITY))"
        if dtype == _F32:
            # str, not repr: NumPy 2's repr is "np.float32(0.1)", not C
            return f"{np.float32(value)}f"
        return f"(({ct})({v!r}))"

    def _binop(self, node: gtir.BinaryOp) -> str:
        op = node.op
        left, right = self._expr(node.left), self._expr(node.right)
        A, C, L = (
            gtir.ArithmeticOperator,
            gtir.ComparisonOperator,
            gtir.LogicalOperator,
        )
        if isinstance(op, L):
            c_op = "&&" if op == L.AND else "||"
            return f"(({left}) {c_op} ({right}))"
        if isinstance(op, C):
            prom = _promote(
                getattr(node.left, "dtype", None), getattr(node.right, "dtype", None)
            )
            pct = _ctype(prom) if prom is not None else "double"
            return f"((unsigned char)((({pct})({left})) {op.value} (({pct})({right}))))"
        dt = _np_dtype(node.dtype)
        ct = _ctype(dt)
        lc, rc = f"(({ct})({left}))", f"(({ct})({right}))"
        if dt == _BOOL:
            # NumPy bool arithmetic: + is logical-or, * is logical-and.
            if op == A.ADD:
                return f"((unsigned char)(({left}) || ({right})))"
            if op == A.MUL:
                return f"((unsigned char)(({left}) && ({right})))"
            raise CUnsupported(f"bool operands for '{op.value}'")
        if op in (A.ADD, A.SUB, A.MUL, A.DIV):
            return f"({lc} {op.value} {rc})"
        if op == A.MOD:
            if dt.kind in "iu":
                return f"(({ct})gt_imod_np((int64_t){lc}, (int64_t){rc}))"
            fn = "gt_fmodf_np" if dt == _F32 else "gt_fmod_np"
            return f"{fn}({lc}, {rc})"
        if op == A.POW:
            if dt.kind in "iu":
                return f"(({ct})gt_ipow((int64_t){lc}, (int64_t){rc}))"
            fn = "powf" if dt == _F32 else "pow"
            return f"{fn}({lc}, {rc})"
        raise CUnsupported(f"operator '{op.value}'")

    def _call(self, node: gtir.NativeFuncCall) -> str:
        F = gtir.NativeFunction
        dt = _np_dtype(node.dtype)
        args = [self._expr(a) for a in node.args]
        if node.func in (F.ISFINITE, F.ISINF, F.ISNAN):
            fn = {"isfinite": "isfinite", "isinf": "isinf", "isnan": "isnan"}[
                node.func.value
            ]
            return f"((unsigned char)({fn}((double)({args[0]})) != 0))"
        ct = _ctype(dt)
        cast_args = [f"(({ct})({a}))" for a in args]
        if dt.kind in "iub":
            if node.func == F.ABS:
                if dt.kind in "ub":
                    return cast_args[0]
                return f"(({ct})llabs((long long){cast_args[0]}))"
            if node.func in (F.MIN, F.MAX):
                fn = "gt_imin" if node.func == F.MIN else "gt_imax"
                return (
                    f"(({ct}){fn}((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
                )
            if node.func == F.MOD:
                return (
                    f"(({ct})gt_imod_np((int64_t){cast_args[0]},"
                    f" (int64_t){cast_args[1]}))"
                )
            if node.func == F.POW:
                return (
                    f"(({ct})gt_ipow((int64_t){cast_args[0]},"
                    f" (int64_t){cast_args[1]}))"
                )
            if node.func in (
                F.FLOOR,
                F.CEIL,
                F.TRUNC,
                F.ROUND,
                F.ROUND_AWAY_FROM_ZERO,
            ):
                return cast_args[0]  # integral already
            raise CUnsupported(f"integer-typed call to {node.func.value}")
        f32 = dt == _F32
        if node.func == F.ABS:
            return f"({'fabsf' if f32 else 'fabs'}({cast_args[0]}))"
        if node.func in (F.MIN, F.MAX):
            base = "gt_fmin" if node.func == F.MIN else "gt_fmax"
            fn = f"{base}f_np" if f32 else f"{base}_np"
            return f"{fn}({cast_args[0]}, {cast_args[1]})"
        if node.func == F.MOD:
            fn = "gt_fmodf_np" if f32 else "gt_fmod_np"
            return f"{fn}({cast_args[0]}, {cast_args[1]})"
        libm = _LIBM.get(node.func)
        if libm is None:
            raise CUnsupported(f"native function {node.func.value}")
        fn = libm + "f" if f32 else libm
        return f"{fn}({', '.join(cast_args)})"
