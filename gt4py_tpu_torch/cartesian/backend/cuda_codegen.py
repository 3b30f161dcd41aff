"""GTIR → CUDA C++ for the two hand-written Hopper kernel skeletons.

Counterpart of gt4py_tpu/cartesian/backend/pallas_codegen.py
(``_BlockEvaluator``, which renders GTIR into the Pallas kernels) plus the
expression renderer of gt4py_tpu/cartesian/backend/c_codegen.py, copied
here with a ``__device__`` prelude. As on the TPU, the kernels are generated
per stencil: the hand-written part is a kernel skeleton, and the stencil's
statements are rendered into its body as CUDA C++.

Two skeletons, chosen by :func:`choose_strategy`:

``plane`` — replaces K1, ``pallas_split.build_plane_split_fn``
(gt4py_tpu/cartesian/backend/pallas_split.py:195, ``pallas_call`` at
:424), and is the seed of K2 (``pallas_codegen.build_plane_fn``). It serves
stencils whose vertical loops are all PARALLEL with no K-offset reads.
    Mapping: one launch per vertical loop; grid (J tiles, I tiles, K), one
    block of 256 threads per (TI × TJ) tile of one K plane. K1 splits each
    field into a 128-lane main block and a J-halo strip only because of the
    TPU's 128-lane padding (pallas_split.py:1-29); here J is simply the
    contiguous axis (storage/layout.py) and neighbouring threads take
    neighbouring J. Statements run in program order; each is evaluated over
    its tile widened by the statement's extent (``analyzed.stmt_extents``),
    so the halo is recomputed at tile edges. Temporaries live in shared
    memory, one zero-initialised (TI + ext_i) × (TJ + ext_j) plane each,
    with ``__syncthreads()`` between statements; ragged edges are masked.
    API fields are written only at domain points of the block's own tile;
    each point computes its fields' addresses once and adds constant
    offsets. Bound on the H100: bytes, ideally. hdiff reads two fields and
    writes one, three 21.6 MB float32 streams at 256×256×80 — more than the
    50 MB L2 — so a step moves ≈ 65 MB through device memory. This first
    version reaches well under the bandwidth bound (PERF.md): the halo
    recompute, two barriers per tile and 64-bit index arithmetic stand in
    its way, and a larger tile (16 × 64 over 8 × 32) was the measured gain.

``column`` — replaces K3, ``pallas_seq._build_stage_call``
(gt4py_tpu/cartesian/backend/pallas_seq.py:732, ``pallas_call`` at :1130,
driven by ``build_staged_fn`` :243). It serves every other stencil the
checks below admit: FORWARD/BACKWARD loops (vadv, tridiag) and PARALLEL
loops beside them.
    Mapping: one launch per vertical loop, in order, on the current stream.
    One thread per (i, j) column of the loop's statement extents walks the
    loop's sections in order, K ascending (FORWARD) or descending
    (BACKWARD); a PARALLEL loop runs statement by statement over its K
    range. Each thread owns its column, so a read of an already-updated
    value (``sup[0, 0, -1]``) reads back what the same thread wrote: no
    carry planes or rings as in K3. Reads at K offsets are clamped to the
    allocation (``gt_clampk``), the semantics of K3's clamped shifted
    streams. Temporaries are (K, I, J) device buffers the wrapper allocates
    zero-filled. Bound on the H100: latency of the dependent K chain. The
    columns of one 256×256 plane give 65536 threads, about 500 per SM, to
    hide each level's loads, and each level waits for the level before;
    every temporary is a global buffer (register carries are later work).
    The ``__restrict__`` variant (below) lets the compiler forward stored
    values instead of reloading them, the measured gain for vadv.

Numerics follow c_codegen.py: NumPy floor-mod, true division, NaN-
propagating min/max, banker's round. The build uses ``--fmad=false``
(cuda_backend.py), so products and sums round as in the eager plain
version. Arguments may alias (``stencil(a, a)``), so the kernels take plain
pointers; the column kernel has a second, ``__restrict__`` variant that the
wrapper launches when it has checked that no two field buffers overlap.
Constructs either skeleton cannot serve raise :class:`CudaUnsupported`
with the reason; there is no silent fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import Extent
from gt4py_tpu_torch.cartesian.passes.extents import _iter_reads, iter_writes
from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil
from gt4py_tpu_torch.cartesian.passes.type_inference import _promote

#: plane-kernel tile: TI rows of I by TJ columns of J, and its thread count
TI, TJ = 16, 64
PLANE_THREADS = 256
#: column-kernel block: (32 along J) × (8 along I) columns
COL_BJ, COL_BI = 32, 8
#: static shared memory a plane block may use for temporaries
SHARED_BYTES_MAX = 48 * 1024
#: what a launcher returns when its grid is empty and no kernel ran
#: (``cudaError_t`` values are never negative)
NOTHING_LAUNCHED = -1


class CudaUnsupported(Exception):
    """A construct the generated kernels cannot serve (the message names
    it). The ``cuda:hopper`` backend raises it on CUDA tensors."""


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

_F32 = np.dtype(np.float32)
_BOOL = np.dtype(np.bool_)

#: NativeFunction -> CUDA math name (f64 variant; f32 appends 'f').
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
#include <cuda_runtime.h>

#define GT_D static __device__ __forceinline__
GT_D long long gt_clampk(long long k, long long n) {
    return k < 0 ? 0 : (k >= n ? n - 1 : k);
}
/* NumPy floor-mod: result sign follows the divisor. */
GT_D double gt_fmod_np(double a, double b) {
    double r = fmod(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D float gt_fmodf_np(float a, float b) {
    float r = fmodf(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D int64_t gt_imod_np(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D int64_t gt_ipow(int64_t base, int64_t e) {
    if (e < 0) return (int64_t)pow((double)base, (double)e);
    int64_t r = 1;
    while (e) { if (e & 1) r *= base; base *= base; e >>= 1; }
    return r;
}
/* NumPy minimum/maximum propagate NaN from either operand. */
GT_D double gt_fmin_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
GT_D double gt_fmax_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
GT_D float gt_fminf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
GT_D float gt_fmaxf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
GT_D int64_t gt_imin(int64_t a, int64_t b) { return a < b ? a : b; }
GT_D int64_t gt_imax(int64_t a, int64_t b) { return a > b ? a : b; }
"""


def _np_dtype(dtype: Any) -> np.dtype:
    if dtype is None:
        raise CudaUnsupported("expression with unresolved dtype")
    return np.dtype(dtype)


def _ctype(dtype: Any) -> str:
    dt = _np_dtype(dtype)
    try:
        return _CTYPES[dt.name]
    except KeyError:
        raise CudaUnsupported(f"dtype {dt} has no kernel type yet") from None


@dataclasses.dataclass
class FieldMeta:
    """Per-symbol layout info shared by codegen and the launching wrapper.

    API fields, tables and (column kernel) global temporaries each take one
    slot of the launch arguments: a base pointer, ``ndim`` shape/stride
    entries from ``shape_off`` on, and an (I, J, K) origin triple."""

    name: str
    var: str
    dtype: np.dtype
    axes: tuple[bool, bool, bool]  # (I, J, K) presence; tables: all False
    data_dims: tuple[int, ...]
    index: int = -1  # slot in the launch arguments (-1: shared-memory temp)
    shape_off: int = -1
    is_temp: bool = False
    extent: Optional[Extent] = None  # temps only

    @property
    def ndim(self) -> int:
        return sum(self.axes) + len(self.data_dims)


@dataclasses.dataclass
class KernelModule:
    """Generated source plus what the launching wrapper needs."""

    strategy: str  # "plane" | "column"
    source: str
    #: launch slots in order: API fields and tables, then global temporaries
    slots: list[FieldMeta]
    scalars: list[tuple[str, str, int, np.dtype]]  # (name, 'f'|'i', slot, dtype)
    n_shape_slots: int
    #: extern "C" launcher names, one per vertical loop, in launch order
    launchers: list[str]
    #: API fields the stencil writes
    written: frozenset[str] = frozenset()
    #: API fields some thread reads at a point another thread may write:
    #: at a horizontal offset, from a widened plane statement, or at a K
    #: offset in a PARALLEL loop of the column kernel. If one of these
    #: shares memory with a written field, the kernels would race.
    nonlocal_reads: frozenset[str] = frozenset()


def _nonlocal_reads(analyzed: AnalyzedStencil, strategy: str) -> frozenset[str]:
    params = set(analyzed.field_infos)
    out = set()
    for vloop in analyzed.stencil.vertical_loops:
        parallel = vloop.loop_order == gtir.LoopOrder.PARALLEL
        for section in vloop.sections:
            for stmt in section.body:
                ext = analyzed.stmt_extents[stmt]
                wide = strategy == "plane" and (ext.i != (0, 0) or ext.j != (0, 0))
                for r in _iter_reads(stmt):
                    k_shift = r.offset[2] != 0 or r.koffset is not None or r.abs_k is not None
                    if r.name in params and (
                        r.offset[0] != 0
                        or r.offset[1] != 0
                        or wide
                        or (parallel and strategy == "column" and k_shift)
                    ):
                        out.add(r.name)
    return frozenset(out)


def choose_strategy(analyzed: AnalyzedStencil) -> str:
    """``plane`` for all-PARALLEL stencils without K-offset reads (K1's
    class, ``pallas_split.split_eligible``), else ``column`` (K3's)."""
    stencil = analyzed.stencil
    if any(v.loop_order != gtir.LoopOrder.PARALLEL for v in stencil.vertical_loops):
        return "column"
    for _, _, stmt in stencil.walk_stmts():
        for acc in _iter_reads(stmt):
            if acc.offset[2] != 0 or acc.koffset is not None or acc.abs_k is not None:
                return "column"
    return "plane"


def generate(analyzed: AnalyzedStencil) -> KernelModule:
    strategy = choose_strategy(analyzed)
    return _Generator(analyzed, strategy).generate()


def _loop_symbols(vloop: gtir.VerticalLoop):
    """(writes, reads) of one vertical loop, as FieldAccess lists."""
    writes, reads = [], []
    for section in vloop.sections:
        for stmt in section.body:
            writes.extend(iter_writes(stmt))
            reads.extend(_iter_reads(stmt))
    return writes, reads


class _Generator:
    def __init__(self, analyzed: AnalyzedStencil, strategy: str):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.strategy = strategy
        self.fields: dict[str, FieldMeta] = {}
        self.slots: list[FieldMeta] = []
        self.scalars: list[tuple[str, str, int, np.dtype]] = []
        self.scalar_vars: dict[str, str] = {}
        self.lines: list[str] = []
        self.indent = 0
        #: plane kernel: name -> shared-memory tile row length (temps only)
        self.shared: dict[str, int] = {}
        #: name -> variable holding the symbol's address at the current
        #: point: a byte pointer at (i, j[, k]) for fields, an element index
        #: at (i, j) for shared-memory temporaries; offsets are added to it
        self.point_base: dict[str, str] = {}
        #: column kernel, alias-free variant: symbols read but not written
        #: by the loop, accessed through ``const`` pointers
        self.read_only: set[str] = set()

        shape_off = 0
        f_slot = i_slot = 0
        for p in self.stencil.params:
            if isinstance(p, (gtir.FieldDecl, gtir.GlobalTableDecl)):
                table = isinstance(p, gtir.GlobalTableDecl)
                meta = FieldMeta(
                    name=p.name,
                    var=f"f{len(self.slots)}",
                    dtype=_np_dtype(p.dtype),
                    axes=(False, False, False) if table else tuple(p.dimensions),
                    data_dims=tuple(p.shape) if table else tuple(p.data_dims),
                    index=len(self.slots),
                    shape_off=shape_off,
                )
            elif isinstance(p, gtir.ScalarDecl):
                dt = _np_dtype(p.dtype)
                _ctype(dt)
                if dt.kind == "f":
                    self.scalars.append((p.name, "f", f_slot, dt))
                    f_slot += 1
                else:
                    self.scalars.append((p.name, "i", i_slot, dt))
                    i_slot += 1
                self.scalar_vars[p.name] = f"sc_{p.name}"
                continue
            else:
                raise CudaUnsupported(f"parameter kind {type(p).__name__}")
            _ctype(meta.dtype)
            self.fields[p.name] = meta
            self.slots.append(meta)
            shape_off += meta.ndim

        for ti, t in enumerate(self.stencil.temporaries):
            if t.data_dims:
                raise CudaUnsupported(f"temporary '{t.name}' with data dimensions")
            meta = FieldMeta(
                name=t.name,
                var=f"t{ti}",
                dtype=_np_dtype(t.dtype),
                axes=(True, True, True),
                data_dims=(),
                is_temp=True,
                extent=analyzed.field_extents.get(t.name, Extent.zeros()),
            )
            _ctype(meta.dtype)
            self.fields[t.name] = meta
            if strategy == "column":  # global (K, I, J) buffers
                meta.index = len(self.slots)
                meta.shape_off = shape_off
                self.slots.append(meta)
                shape_off += 3
        self.n_shape_slots = shape_off

    # -- emission helpers ----------------------------------------------------

    def emit(self, line: str = "") -> None:
        self.lines.append("    " * self.indent + line if line else "")

    def _block(self, head: str):
        gen = self

        class _Scope:
            def __enter__(self):
                gen.emit(f"{head} {{" if head else "{")
                gen.indent += 1

            def __exit__(self, *exc):
                gen.indent -= 1
                gen.emit("}")

        return _Scope()

    # -- top level -----------------------------------------------------------

    def generate(self) -> KernelModule:
        nf = max(len(self.slots), 1)
        ns = max(self.n_shape_slots, 1)
        n_f = max(sum(1 for s in self.scalars if s[1] == "f"), 1)
        n_i = max(sum(1 for s in self.scalars if s[1] == "i"), 1)
        head = [
            f"/* generated by gt4py_tpu_torch cuda:hopper backend ({self.strategy} kernel) */",
            _PRELUDE,
            "struct GtParams {",
            f"    char* f[{nf}];",
            f"    long long sh[{ns}];",
            f"    long long st[{ns}];",
            f"    long long o[{3 * nf}];",
            f"    double fs[{n_f}];",
            f"    long long is[{n_i}];",
            "    long long ni, nj, nk;",
            "};",
            "",
            "static void gt_fill(GtParams& p, void* const* fields, const long long* shapes,",
            "                    const long long* strides, const long long* origins,",
            "                    const double* fscalars, const long long* iscalars,",
            "                    long long ni, long long nj, long long nk) {",
            f"    for (int n = 0; n < {nf}; ++n) p.f[n] = (char*)fields[n];",
            f"    for (int n = 0; n < {ns}; ++n) {{ p.sh[n] = shapes[n]; p.st[n] = strides[n]; }}",
            f"    for (int n = 0; n < {3 * nf}; ++n) p.o[n] = origins[n];",
            f"    for (int n = 0; n < {n_f}; ++n) p.fs[n] = fscalars[n];",
            f"    for (int n = 0; n < {n_i}; ++n) p.is[n] = iscalars[n];",
            "    p.ni = ni; p.nj = nj; p.nk = nk;",
            "}",
            "",
        ]
        self.lines = []
        launchers = []
        for n, vloop in enumerate(self.stencil.vertical_loops):
            if self.strategy == "plane":
                self._emit_plane_kernel(n, vloop)
            else:
                self._emit_column_kernel(n, vloop)
            launchers.append(f"gt_launch_{n}")
            self.emit()
        # NOTE: name-free source: the library cache is keyed by its hash, so
        # identical definitions under different names share one build.
        return KernelModule(
            strategy=self.strategy,
            source="\n".join(head + self.lines) + "\n",
            slots=self.slots,
            scalars=self.scalars,
            n_shape_slots=self.n_shape_slots,
            launchers=launchers,
            written=frozenset(self.analyzed.written_fields()),
            nonlocal_reads=_nonlocal_reads(self.analyzed, self.strategy),
        )

    def _emit_locals(self, names: set[str], *, pointers: bool = True) -> None:
        """Kernel-local pointers (unless they are kernel parameters), byte
        strides, K sizes and origins of the launch slots the loop touches,
        and the scalars."""
        self.emit("const long long ni = p.ni, nj = p.nj, nk = p.nk;")
        self.emit("(void)ni; (void)nj; (void)nk;")
        for m in self.slots:
            if m.name not in names:
                continue
            v = m.var
            if pointers:
                self.emit(f"char* {v} = p.f[{m.index}];")
            pos = 0
            for role, present in zip("ijk", m.axes):
                if not present:
                    continue
                self.emit(f"const long long {v}_s{role} = p.st[{m.shape_off + pos}];")
                if role == "k":
                    self.emit(f"const long long {v}_nk = p.sh[{m.shape_off + pos}];")
                self.emit(f"const long long {v}_o{role} = p.o[{m.index * 3 + 'ijk'.index(role)}];")
                pos += 1
            for d in range(len(m.data_dims)):
                self.emit(f"const long long {v}_d{d} = p.st[{m.shape_off + pos + d}];")
        for name, kind, slot, dt in self.scalars:
            ct = _ctype(dt)
            src = f"p.fs[{slot}]" if kind == "f" else f"p.is[{slot}]"
            self.emit(f"const {ct} sc_{name} = ({ct}){src}; (void)sc_{name};")

    def _emit_launcher(
        self, n: int, kernel: str, grid: str, block: str, noalias_call: str = ""
    ) -> None:
        """``noalias`` (set by the wrapper when no two field buffers
        overlap) selects ``noalias_call``, the ``__restrict__`` variant."""
        self.emit(
            f'extern "C" int gt_launch_{n}(void* const* fields, const long long* shapes,'
        )
        self.emit("    const long long* strides, const long long* origins,")
        self.emit("    const double* fscalars, const long long* iscalars,")
        self.emit("    long long ni, long long nj, long long nk, void* stream, int noalias) {")
        self.indent += 1
        self.emit("GtParams p;")
        self.emit("gt_fill(p, fields, shapes, strides, origins, fscalars, iscalars, ni, nj, nk);")
        self.emit(f"const dim3 grid({grid});")
        self.emit(f"const dim3 block({block});")
        self.emit(
            f"if (grid.x == 0 || grid.y == 0 || grid.z == 0) return {NOTHING_LAUNCHED};"
        )
        if noalias_call:
            self.emit(f"if (noalias) {noalias_call};")
            self.emit(f"else {kernel}<<<grid, block, 0, (cudaStream_t)stream>>>(p);")
        else:
            self.emit("(void)noalias;")
            self.emit(f"{kernel}<<<grid, block, 0, (cudaStream_t)stream>>>(p);")
        self.emit("return (int)cudaGetLastError();")
        self.indent -= 1
        self.emit("}")

    @staticmethod
    def _k_bound(b: gtir.AxisBound) -> str:
        if b.level == gtir.LevelMarker.START:
            return f"({b.offset})"
        return f"(nk + ({b.offset}))"

    def _extent_cond(self, ext: Extent, union: Optional[Extent] = None) -> str:
        """Point (i, j) inside the statement extent (terms the launch's
        thread range already guarantees are dropped)."""
        terms = []
        for var, (lo, hi), size, ulo_hi in (
            ("i", ext.i, "ni", union.i if union else None),
            ("j", ext.j, "nj", union.j if union else None),
        ):
            if ulo_hi is None or lo != ulo_hi[0]:
                terms.append(f"{var} >= ({lo})")
            if ulo_hi is None or hi != ulo_hi[1]:
                terms.append(f"{var} < {size} + ({hi})")
        return " && ".join(terms) if terms else "1"

    # -- the plane kernel ------------------------------------------------------

    def _check_plane(self, vloop: gtir.VerticalLoop) -> None:
        writes, _ = _loop_symbols(vloop)
        written = {w.name for w in writes}
        for w in writes:
            m = self.fields[w.name]
            if w.offset != (0, 0, 0) or w.koffset is not None:
                raise CudaUnsupported(f"offset write to '{w.name}' in a PARALLEL loop")
            if not m.is_temp and not m.axes[2]:
                raise CudaUnsupported(
                    f"PARALLEL write to '{w.name}', which has no K axis"
                )
        for section in vloop.sections:
            for stmt in section.body:
                ext = self.analyzed.stmt_extents[stmt]
                wide = ext.i != (0, 0) or ext.j != (0, 0)
                targets = {w.name for w in iter_writes(stmt)}
                for t in targets:
                    if not self.fields[t].is_temp and wide:
                        raise CudaUnsupported(
                            f"API field '{t}' is read at a horizontal offset after "
                            "it is written; a later kernel serves it"
                        )
                for r in _iter_reads(stmt):
                    shifted = r.offset[0] != 0 or r.offset[1] != 0
                    if r.name in written and not self.fields[r.name].is_temp and (
                        shifted or wide
                    ):
                        raise CudaUnsupported(
                            f"API field '{r.name}' is written and read at a horizontal "
                            "offset in one PARALLEL loop; a later kernel serves it"
                        )
                    if r.name in targets and shifted:
                        raise CudaUnsupported(
                            f"statement reads its own target '{r.name}' at an offset"
                        )

    def _emit_plane_kernel(self, n: int, vloop: gtir.VerticalLoop) -> None:
        self._check_plane(vloop)
        writes, reads = _loop_symbols(vloop)
        names = {a.name for a in writes + reads}
        temps = [m for m in self.fields.values() if m.is_temp and m.name in names]
        for m in temps:
            for other in self.stencil.vertical_loops:
                if other is vloop:
                    continue
                ow, orr = _loop_symbols(other)
                if any(a.name == m.name for a in ow + orr):
                    raise CudaUnsupported(
                        f"temporary '{m.name}' crosses vertical loops"
                    )
        self.shared = {}
        shared_bytes = 0
        kernel = f"gt_plane_{n}"
        self.emit(f"__global__ void __launch_bounds__({PLANE_THREADS}) {kernel}(const GtParams p) {{")
        self.indent += 1
        self._emit_locals(names)
        self.emit(f"const long long i0 = (long long)blockIdx.y * {TI};")
        self.emit(f"const long long j0 = (long long)blockIdx.x * {TJ};")
        self.emit("const long long k = blockIdx.z;")
        self.emit("const int tid = threadIdx.x;")
        for m in temps:
            e = m.extent
            si = TI + e.i[1] - e.i[0]
            sj = TJ + e.j[1] - e.j[0]
            ct = _ctype(m.dtype)
            shared_bytes += si * sj * m.dtype.itemsize
            self.shared[m.name] = sj
            self.emit(f"__shared__ {ct} {m.var}_s[{si * sj}];")
            with self._block(f"for (int q = tid; q < {si * sj}; q += {PLANE_THREADS})"):
                self.emit(f"{m.var}_s[q] = ({ct})0;")
        if shared_bytes > SHARED_BYTES_MAX:
            raise CudaUnsupported(
                f"temporaries need {shared_bytes} bytes of shared memory per block"
            )
        if temps:
            self.emit("__syncthreads();")
        for section in vloop.sections:
            lo, hi = self._k_bound(section.interval.start), self._k_bound(section.interval.end)
            with self._block(f"if (k >= {lo} && k < {hi})"):
                for s_idx, stmt in enumerate(section.body):
                    ext = self.analyzed.stmt_extents[stmt]
                    ni_s = TI + ext.i[1] - ext.i[0]
                    nj_s = TJ + ext.j[1] - ext.j[0]
                    with self._block(
                        f"for (int q = tid; q < {ni_s * nj_s}; q += {PLANE_THREADS})"
                    ):
                        self.emit(f"const long long i = i0 + ({ext.i[0]}) + q / {nj_s};")
                        self.emit(f"const long long j = j0 + ({ext.j[0]}) + q % {nj_s};")
                        with self._block(f"if ({self._extent_cond(ext)})"):
                            self._emit_point_bases(stmt, with_k=True)
                            self._emit_stmt(stmt)
                    if s_idx + 1 < len(section.body):
                        self.emit("__syncthreads();")
        self.indent -= 1
        self.emit("}")
        self.emit()
        self._emit_launcher(
            n,
            kernel,
            f"(unsigned)((nj + {TJ - 1}) / {TJ}), (unsigned)((ni + {TI - 1}) / {TI}), (unsigned)nk",
            f"{PLANE_THREADS}",
        )

    # -- the column kernel -----------------------------------------------------

    def _check_column(self, vloop: gtir.VerticalLoop) -> None:
        writes, reads = _loop_symbols(vloop)
        written = {w.name for w in writes}
        for w in writes:
            if w.offset[0] != 0 or w.offset[1] != 0:
                raise CudaUnsupported(f"horizontal offset write to '{w.name}'")
        for r in reads:
            if r.name in written and (r.offset[0] != 0 or r.offset[1] != 0):
                raise CudaUnsupported(
                    f"'{r.name}' is written and read at a horizontal offset in one "
                    "vertical loop (columns would race)"
                )
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            for section in vloop.sections:
                for stmt in section.body:
                    targets = {w.name for w in iter_writes(stmt)}
                    for r in _iter_reads(stmt):
                        if r.name in targets and (
                            r.offset[2] != 0 or r.koffset is not None or r.abs_k is not None
                        ):
                            raise CudaUnsupported(
                                f"PARALLEL statement reads its own target '{r.name}' "
                                "at a K offset"
                            )

    def _emit_column_kernel(self, n: int, vloop: gtir.VerticalLoop) -> None:
        """Two variants of one skeleton: ``gt_column_<n>`` with plain
        pointers, for any arguments, and ``gt_column_<n>_r`` taking the
        field pointers as ``__restrict__`` parameters (read-only ones
        ``const``), for arguments whose buffers do not overlap. With no
        aliasing to fear, the compiler forwards a value a thread stored to
        its later loads and issues independent loads early, which the
        dependent K chain otherwise serialises."""
        self._check_column(vloop)
        writes, reads = _loop_symbols(vloop)
        names = {a.name for a in writes + reads}
        written = {a.name for a in writes}
        stmts = [s for section in vloop.sections for s in section.body]
        union = Extent.zeros()
        for s in stmts:
            union = union.union(self.analyzed.stmt_extents[s])
        kernel = f"gt_column_{n}"
        used = [m for m in self.slots if m.name in names]
        params = ", ".join(
            f"{'const ' if m.name not in written else ''}char* __restrict__ {m.var}"
            for m in used
        )
        args = ", ".join(
            f"({'const ' if m.name not in written else ''}char*)fields[{m.index}]"
            for m in used
        )
        self._emit_column_variant(kernel, vloop, names, union, "")
        self.read_only = names - written
        self._emit_column_variant(kernel + "_r", vloop, names, union, params)
        self.read_only = set()
        ni_u = f"ni + ({union.i[1] - union.i[0]})"
        nj_u = f"nj + ({union.j[1] - union.j[0]})"
        self._emit_launcher(
            n,
            kernel,
            f"(unsigned)(({nj_u} + {COL_BJ - 1}) / {COL_BJ}), "
            f"(unsigned)(({ni_u} + {COL_BI - 1}) / {COL_BI}), 1u",
            f"{COL_BJ}, {COL_BI}",
            noalias_call=(
                f"{kernel}_r<<<grid, block, 0, (cudaStream_t)stream>>>(p, {args})"
            ),
        )

    def _emit_column_variant(self, kernel, vloop, names, union, params: str) -> None:
        extra = f", {params}" if params else ""
        self.emit(
            f"__global__ void __launch_bounds__({COL_BJ * COL_BI}) "
            f"{kernel}(const GtParams p{extra}) {{"
        )
        self.indent += 1
        self._emit_locals(names, pointers=not params)
        self.emit(
            f"const long long j = ({union.j[0]}) + (long long)blockIdx.x * {COL_BJ} + threadIdx.x;"
        )
        self.emit(
            f"const long long i = ({union.i[0]}) + (long long)blockIdx.y * {COL_BI} + threadIdx.y;"
        )
        self.emit(f"if (i >= ni + ({union.i[1]}) || j >= nj + ({union.j[1]})) return;")
        self.point_base = {}
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        for section in vloop.sections:
            lo, hi = self._k_bound(section.interval.start), self._k_bound(section.interval.end)
            if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                for stmt in section.body:
                    with self._block(f"for (long long k = {lo}; k < {hi}; ++k)"):
                        self._emit_guarded(stmt, union)
                continue
            head = (
                f"for (long long k = {hi} - 1; k >= {lo}; --k)"
                if backward
                else f"for (long long k = {lo}; k < {hi}; ++k)"
            )
            with self._block(head):
                for stmt in section.body:
                    self._emit_guarded(stmt, union)
        self.indent -= 1
        self.emit("}")
        self.emit()

    def _emit_guarded(self, stmt: gtir.Stmt, union: Extent) -> None:
        cond = self._extent_cond(self.analyzed.stmt_extents[stmt], union)
        if cond == "1":
            with self._block(""):
                self._emit_stmt(stmt)
        else:
            with self._block(f"if ({cond})"):
                self._emit_stmt(stmt)

    # -- per-point addresses ---------------------------------------------------

    def _emit_field_base(self, m: FieldMeta, *, with_k: bool) -> None:
        """``char* v_b``: the field's address at (i, j), and at k too when
        ``with_k``; an access then adds only its constant offsets."""
        v = m.var
        terms = [
            f"({v}_o{r} + {r}) * {v}_s{r}"
            for r, present in zip("ijk", m.axes)
            if present and (r != "k" or with_k)
        ]
        self.emit(f"char* const {v}_b = {' + '.join([v] + terms)};")
        self.point_base[m.name] = f"{v}_b"

    def _emit_point_bases(self, stmt: gtir.Stmt, *, with_k: bool) -> None:
        names = {a.name for a in iter_writes(stmt)} | {a.name for a in _iter_reads(stmt)}
        self.point_base = {}
        for name in sorted(names):
            m = self._meta(name)
            if m.name in self.shared:
                e = m.extent
                self.emit(
                    f"const int {m.var}_b = (int)((i - i0 - ({e.i[0]})) * {self.shared[name]}"
                    f" + (j - j0 - ({e.j[0]})));"
                )
                self.point_base[name] = f"{m.var}_b"
            else:
                self._emit_field_base(m, with_k=with_k)

    # -- statements ------------------------------------------------------------

    def _region_cond(self, hmasks) -> str:
        """Point-in-all-regions condition (c_codegen._region_cond)."""
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
            with self._block(f"if ({self._region_cond(hmasks)})"):
                self._emit_stmt_body(stmt)
        else:
            self._emit_stmt_body(stmt)

    def _emit_stmt_body(self, stmt: gtir.Stmt) -> None:
        if isinstance(stmt, gtir.Assign):
            self._emit_assign(stmt)
        elif isinstance(stmt, gtir.While):
            cond = self._expr(stmt.cond)
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            with self._block(f"while ({cond})"):
                for s in stmt.body:
                    if not isinstance(s, gtir.Assign):
                        raise CudaUnsupported(f"{type(s).__name__} inside while body")
                    self._emit_assign(s)
        else:
            raise CudaUnsupported(f"statement {type(stmt).__name__}")

    def _emit_assign(self, stmt: gtir.Assign) -> None:
        t = stmt.target
        if t.koffset is not None:
            # Variable-K-offset write: out-of-range target levels are
            # DROPPED (a clamp would smear onto the boundary level).
            m = self._meta(t.name)
            if m.name not in self.shared:
                kt = f"({m.var}_ok + k + ({t.offset[2]}) + (long long)({self._expr(t.koffset)}))"
                cond = f"{kt} >= 0 && {kt} < {m.var}_nk"
                if stmt.mask is not None:
                    cond = f"({self._expr(stmt.mask)}) && ({cond})"
                store = f"{self._access(t, k_override=kt)} = {self._expr(stmt.value)};"
                self.emit(f"if ({cond}) {{ {store} }}")
                return
            raise CudaUnsupported("variable-K write to a shared-memory temporary")
        store = f"{self._access(stmt.target)} = {self._expr(stmt.value)};"
        if stmt.mask is None:
            self.emit(store)
        else:
            self.emit(f"if ({self._expr(stmt.mask)}) {{ {store} }}")

    # -- expressions -------------------------------------------------------------

    def _meta(self, name: str) -> FieldMeta:
        m = self.fields.get(name)
        if m is None:
            raise CudaUnsupported(f"access to unknown symbol '{name}'")
        return m

    def _access(self, node: gtir.FieldAccess, *, k_override: str = "") -> str:
        m = self._meta(node.name)
        v = m.var
        ct = _ctype(m.dtype)
        di, dj, dk = node.offset
        base = self.point_base.get(m.name)
        if m.name in self.shared:  # plane kernel temporary: shared-memory tile
            return f"{v}_s[{base} + ({di * self.shared[m.name] + dj})]"
        terms = []
        if base is None:  # column kernel: the full (i, j) address per access
            base = v
            if m.axes[0]:
                terms.append(f"({v}_oi + i + ({di})) * {v}_si")
            if m.axes[1]:
                terms.append(f"({v}_oj + j + ({dj})) * {v}_sj")
        else:  # plane kernel: constant offsets from the point's address
            if m.axes[0] and di:
                terms.append(f"({di}) * {v}_si")
            if m.axes[1] and dj:
                terms.append(f"({dj}) * {v}_sj")
        if m.axes[2] and self.strategy == "column":
            if k_override:
                terms.append(f"{k_override} * {v}_sk")
            elif node.abs_k is not None:
                kexpr = f"{v}_ok + (long long)({self._expr(node.abs_k)})"
                terms.append(f"gt_clampk({kexpr}, {v}_nk) * {v}_sk")
            elif node.koffset is not None:
                kexpr = f"{v}_ok + k + ({dk}) + (long long)({self._expr(node.koffset)})"
                terms.append(f"gt_clampk({kexpr}, {v}_nk) * {v}_sk")
            elif dk:
                terms.append(f"gt_clampk({v}_ok + k + ({dk}), {v}_nk) * {v}_sk")
            else:
                terms.append(f"({v}_ok + k) * {v}_sk")
        elif m.axes[2] and (dk or node.koffset is not None or node.abs_k is not None):
            raise CudaUnsupported(f"K-offset read of '{m.name}' in the plane kernel")
        for d, e in enumerate(node.data_index):
            terms.append(f"((long long)({self._expr(e)})) * {v}_d{d}")
        const = "const " if m.name in self.read_only else ""
        return f"(*({const}{ct}*)({' + '.join([base] + terms)}))"

    def _expr(self, node: gtir.Expr) -> str:
        if isinstance(node, gtir.Literal):
            return self._literal(node.value, _np_dtype(node.dtype))
        if isinstance(node, gtir.ScalarAccess):
            var = self.scalar_vars.get(node.name)
            if var is None:
                raise CudaUnsupported(f"scalar '{node.name}' is not a parameter")
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
        raise CudaUnsupported(f"expression {type(node).__name__}")

    def _literal(self, value: Any, dtype: np.dtype) -> str:
        ct = _ctype(dtype)
        if dtype.kind == "b":
            return "1" if value else "0"
        if dtype.kind in "iu":
            return f"(({ct})({int(value)}LL))"
        v = float(value)
        f32 = dtype == _F32
        if math.isnan(v):
            return "__int_as_float(0x7fc00000)" if f32 else "__longlong_as_double(0x7ff8000000000000LL)"
        if math.isinf(v):
            sign = "-" if v < 0 else ""
            inf = "__int_as_float(0x7f800000)" if f32 else "__longlong_as_double(0x7ff0000000000000LL)"
            return f"({sign}{inf})"
        if f32:
            return f"({float(np.float32(v))!r}f)"
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
            raise CudaUnsupported(f"bool operands for '{op.value}'")
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
        raise CudaUnsupported(f"operator '{op.value}'")

    def _call(self, node: gtir.NativeFuncCall) -> str:
        F = gtir.NativeFunction
        dt = _np_dtype(node.dtype)
        args = [self._expr(a) for a in node.args]
        if node.func in (F.ISFINITE, F.ISINF, F.ISNAN):
            return f"((unsigned char)({node.func.value}((double)({args[0]})) != 0))"
        ct = _ctype(dt)
        cast_args = [f"(({ct})({a}))" for a in args]
        if dt.kind in "iub":
            if node.func == F.ABS:
                if dt.kind in "ub":
                    return cast_args[0]
                return f"(({ct})llabs((long long){cast_args[0]}))"
            if node.func in (F.MIN, F.MAX):
                fn = "gt_imin" if node.func == F.MIN else "gt_imax"
                return f"(({ct}){fn}((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
            if node.func == F.MOD:
                return (
                    f"(({ct})gt_imod_np((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
                )
            if node.func == F.POW:
                return f"(({ct})gt_ipow((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
            if node.func in (F.FLOOR, F.CEIL, F.TRUNC, F.ROUND, F.ROUND_AWAY_FROM_ZERO):
                return cast_args[0]  # integral already
            raise CudaUnsupported(f"integer-typed call to {node.func.value}")
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
            raise CudaUnsupported(f"native function {node.func.value}")
        fn = libm + "f" if f32 else libm
        return f"{fn}({', '.join(cast_args)})"


__all__ = [
    "COL_BI",
    "COL_BJ",
    "CudaUnsupported",
    "FieldMeta",
    "KernelModule",
    "TI",
    "TJ",
    "choose_strategy",
    "generate",
]
