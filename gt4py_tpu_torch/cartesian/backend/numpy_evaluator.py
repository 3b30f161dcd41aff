"""Eager GTIR execution on NumPy arrays — the ``numpy`` backend's engine.

Copied from gt4py_tpu/cartesian/backend/evaluator.py, its ``ns="numpy"``
path: every field gets a *window*, the view of the array the stencil
touches (domain extended by the field's access extent), and statements read
and write those views in place, with NumPy's promotion and mask semantics.
The ``ns="jax"`` branches (the ``jax.jit`` trace, the plane-carry
``lax.scan``, ``lax.while_loop``) are left out: the port has no JAX.

Semantics (those of the JAX package's numpy branch):
- every statement executes over the compute domain extended by its
  per-statement extent (passes/extents.py), in program order;
- conditional writes are masked selects (both branches evaluated);
- FORWARD/BACKWARD sections loop over K in Python, one plane per level, so
  K-offset reads of fields written in the section observe updated values;
- K windows that reach past a read-only field's allocation clamp to the
  edge level.

bfloat16: the JAX package holds it in ``ml_dtypes.bfloat16`` arrays, whose
ufuncs compute in float32 and round every result to bfloat16. NumPy has no
bfloat16 of its own, so here a bfloat16 value is *carried* in a float32
array (:func:`carrier_dtype`) and rounded to nearest even after every
operation whose result ml_dtypes would give in bfloat16
(:func:`round_bf16`); a math function is computed in float64 and rounded
to float32 first, as ``ml_dtypes`` calls the C library's float functions
(which that matches exhaustively over the 65536 bfloat16 inputs). A value
converted to bfloat16 from float64 rounds through float32, as ml_dtypes
converts it.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import AccessKind, Extent
from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil
from gt4py_tpu_torch.core.definitions import HALF_FLOAT_DTYPES, bfloat16

_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
#: dtypes whose operations with bfloat16 give bfloat16 in ml_dtypes
#: (wider integers and other floats promote past it)
_BF16_PARTNERS = frozenset({bfloat16, np.dtype(np.bool_), np.dtype(np.int8), np.dtype(np.uint8)})


def carrier_dtype(dtype: Any) -> np.dtype:
    """The NumPy dtype a value of GTIR ``dtype`` is held in: float32 for
    bfloat16, the dtype itself otherwise."""
    if dtype is None:
        return _F64
    dt = np.dtype(dtype)
    return _F32 if dt == bfloat16 else dt


def round_bf16(x: Any) -> np.ndarray:
    """``x`` rounded to bfloat16, to nearest even, held in float32 (NaN
    stays NaN)."""
    x32 = np.asarray(x, dtype=_F32)
    bits = x32.view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    out = bits.astype(np.uint32).view(_F32)
    out = np.where(np.isnan(x32), x32, out)
    return out if out.ndim else out[()]


def as_dtype_value(value: Any, dtype: Any) -> Any:
    """``value`` converted to GTIR ``dtype`` (bfloat16 through float32, as
    ml_dtypes converts)."""
    out = np.asarray(value).astype(carrier_dtype(dtype))
    if dtype is not None and np.dtype(dtype) == bfloat16:
        out = round_bf16(out)
    return out


def bf16_result(expr: gtir.Expr, operands) -> bool:
    """True where ml_dtypes computes ``expr`` in bfloat16: its GTIR dtype
    is bfloat16 and every operand's is bfloat16 or a type narrower than it."""
    return (
        expr.dtype is not None
        and np.dtype(expr.dtype) == bfloat16
        and all(o.dtype is None or np.dtype(o.dtype) in _BF16_PARTNERS for o in operands)
    )


def bf16_apply(fn, *args) -> np.ndarray:
    """``fn`` as an ml_dtypes ufunc applies it to bfloat16 operands:
    computed in float64, rounded to float32, then to bfloat16."""
    wide = [np.asarray(a, dtype=_F64) if np.asarray(a).dtype.kind == "f" else a for a in args]
    with np.errstate(all="ignore"):
        return round_bf16(np.asarray(fn(*wide)).astype(_F32))


def _np_unary_vec(fn):
    vec = np.vectorize(fn)

    def impl(x):
        out = vec(x)
        return out if isinstance(out, np.ndarray) else np.asarray(out)

    return impl


class _NamespaceOps:
    """Array-namespace helpers of the evaluator, on NumPy."""

    xp = np

    def slice_nd(self, arr, starts, sizes):
        assert all(isinstance(s, (int, np.integer)) for s in starts)
        idx = tuple(slice(int(s), int(s) + int(z)) for s, z in zip(starts, sizes))
        return arr[idx + (slice(None),) * (arr.ndim - len(starts))]

    def update_nd(self, arr, starts, value):
        idx = tuple(slice(int(s), int(s) + int(z)) for s, z in zip(starts, value.shape))
        arr[idx + (slice(None),) * (arr.ndim - len(starts))] = value
        return arr

    def take_along_k(self, arr, idx):
        idx = np.clip(idx, 0, arr.shape[2] - 1)
        return np.take_along_axis(arr, idx, axis=2)

    def put_along_k(self, arr, idx, value, valid):
        """Masked per-gridpoint scatter along K (variable-K-offset
        writes): lanes with out-of-range indices — or ``valid`` False —
        keep their old value (dropped, not clamped-overwritten)."""
        nk = arr.shape[2]
        safe = np.clip(idx, 0, nk - 1)
        inb = (idx >= 0) & (idx < nk)
        ok = inb if valid is None else np.logical_and(valid, inb)
        old = np.take_along_axis(arr, safe, axis=2)
        new = np.where(ok, value, old)
        np.put_along_axis(arr, safe, new, axis=2)
        return arr

    def iota(self, n: int, axis: int, shape3) -> Any:
        vec = np.arange(n, dtype=np.int64)
        reshape = [1, 1, 1]
        reshape[axis] = n
        return vec.reshape(reshape)


def _native_impls(ops: _NamespaceOps) -> dict:
    xp = ops.xp
    gamma_fn = _np_unary_vec(math.gamma)
    erf_fn = _np_unary_vec(math.erf)
    erfc_fn = _np_unary_vec(math.erfc)

    F = gtir.NativeFunction
    return {
        F.ABS: xp.abs,
        F.MIN: xp.minimum,
        F.MAX: xp.maximum,
        F.MOD: xp.mod,
        F.SIN: xp.sin,
        F.COS: xp.cos,
        F.TAN: xp.tan,
        F.ASIN: xp.arcsin,
        F.ACOS: xp.arccos,
        F.ATAN: xp.arctan,
        F.SINH: xp.sinh,
        F.COSH: xp.cosh,
        F.TANH: xp.tanh,
        F.ASINH: xp.arcsinh,
        F.ACOSH: xp.arccosh,
        F.ATANH: xp.arctanh,
        F.SQRT: xp.sqrt,
        F.CBRT: xp.cbrt,
        F.EXP: xp.exp,
        F.LOG: xp.log,
        F.LOG10: xp.log10,
        F.GAMMA: gamma_fn,
        F.ISFINITE: xp.isfinite,
        F.ISINF: xp.isinf,
        F.ISNAN: xp.isnan,
        F.FLOOR: xp.floor,
        F.CEIL: xp.ceil,
        F.TRUNC: xp.trunc,
        F.ROUND: xp.round,
        F.ROUND_AWAY_FROM_ZERO: lambda x: xp.trunc(
            x + xp.copysign(xp.asarray(0.5, dtype=_dt(x)), x)
        ),
        F.ERF: erf_fn,
        F.ERFC: erfc_fn,
        F.POW: xp.power,
        F.ATAN2: xp.arctan2,
        F.HYPOT: xp.hypot,
        F.COPYSIGN: xp.copysign,
        F.FMA: lambda a, b, c: a * b + c,
    }


#: natives that NumPy computes through Python's ``math`` one value at a
#: time: float64 whatever the argument's dtype, so never bfloat16
_VECTORIZED = frozenset({gtir.NativeFunction.GAMMA, gtir.NativeFunction.ERF, gtir.NativeFunction.ERFC})


def _bf16_native(func, impl, args):
    """A native call whose result ml_dtypes gives in bfloat16: each of its
    ufuncs rounds (FMA and round-away-from-zero are two)."""
    F = gtir.NativeFunction
    if func == F.FMA:
        a, b, c = args
        return bf16_apply(np.add, bf16_apply(np.multiply, a, b), c)
    if func == F.ROUND_AWAY_FROM_ZERO:
        (x,) = args
        return np.trunc(bf16_apply(np.add, x, np.copysign(np.float32(0.5), x)))
    return bf16_apply(impl, *args)


def _dt(x):
    return getattr(x, "dtype", np.float64)


def _apply_binop(xp, op, left, right):
    A = gtir.ArithmeticOperator
    C = gtir.ComparisonOperator
    L = gtir.LogicalOperator
    if isinstance(op, C):
        # widening ONLY the half operand to float32 is bit-identical (f32
        # embeds a half-float exactly); the other side keeps its dtype (an
        # f64/int64 counterpart must not be narrowed) and ordinary
        # promotion finishes the job, as in the JAX package
        if getattr(left, "dtype", None) in HALF_FLOAT_DTYPES:
            left = xp.asarray(left).astype(np.float32)
        if getattr(right, "dtype", None) in HALF_FLOAT_DTYPES:
            right = xp.asarray(right).astype(np.float32)
    if op == A.ADD:
        return xp.add(left, right)
    if op == A.SUB:
        return xp.subtract(left, right)
    if op == A.MUL:
        return xp.multiply(left, right)
    if op == A.DIV:
        return xp.true_divide(left, right)
    if op == A.MOD:
        return xp.mod(left, right)
    if op == A.POW:
        return xp.power(left, right)
    if op == A.MATMUL:
        # '@' on data-dimension fields (reference visit_MatMult,
        # gtscript_frontend.py:1506): grid axes (always rank 3 here) are
        # batch dims; the trailing data dims multiply. NumPy's 1-D vector
        # special case doesn't apply to batched operands, so vectors get an
        # explicit trailing/leading axis.
        ld, rd = left.ndim - 3, right.ndim - 3
        if ld == 2 and rd == 1:
            return xp.matmul(left, right[..., None])[..., 0]
        if ld == 1 and rd == 2:
            return xp.matmul(left[..., None, :], right)[..., 0, :]
        return xp.matmul(left, right)
    if op == C.EQ:
        return xp.equal(left, right)
    if op == C.NE:
        return xp.not_equal(left, right)
    if op == C.LT:
        return xp.less(left, right)
    if op == C.LE:
        return xp.less_equal(left, right)
    if op == C.GT:
        return xp.greater(left, right)
    if op == C.GE:
        return xp.greater_equal(left, right)
    if op == L.AND:
        return xp.logical_and(left, right)
    if op == L.OR:
        return xp.logical_or(left, right)
    raise TypeError(op)


def apply_binop(expr: gtir.BinaryOp, left, right):
    """One binary operation as the JAX package's numpy backend computes
    it, bfloat16 rounding included."""
    if isinstance(expr.op, gtir.ArithmeticOperator) and bf16_result(expr, (expr.left, expr.right)):
        return bf16_apply(lambda a, b: _apply_binop(np, expr.op, a, b), left, right)
    return _apply_binop(np, expr.op, left, right)


def apply_native(natives: dict, expr: gtir.NativeFuncCall, args: list):
    """One native call as the JAX package's numpy backend computes it."""
    if expr.func not in _VECTORIZED and bf16_result(expr, expr.args):
        return _bf16_native(expr.func, natives[expr.func], args)
    return natives[expr.func](*args)


class _Ctx:
    """Evaluation context for one unit: extent + K window; ``k_seq`` is the
    current sequential K (a Python int) or None for a PARALLEL unit."""

    __slots__ = ("ext", "ks", "ke", "k_seq", "nk_static")

    def __init__(self, ext: Extent, ks, ke, k_seq):
        self.ext = ext
        self.ks = ks
        self.ke = ke
        self.k_seq = k_seq
        self.nk_static = 1 if k_seq is not None else int(ke - ks)


class Evaluator:
    """Executes one analyzed stencil for a concrete (domain, origins) set,
    in place on ``arrays`` (NumPy arrays; bfloat16 fields in their float32
    carriers, see :func:`carrier_dtype`)."""

    def __init__(
        self,
        analyzed: AnalyzedStencil,
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        arrays: dict[str, Any],
        scalars: dict[str, Any],
    ):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.domain = domain
        self.origins = dict(origins)
        self.arrays = dict(arrays)
        self.scalars = scalars
        self.ops = _NamespaceOps()
        self.natives = _native_impls(self.ops)

        self.dims: dict[str, tuple[bool, bool, bool]] = {}
        self.data_ndims: dict[str, int] = {}
        self.f_ext: dict[str, Extent] = {}
        #: fields and temporaries of dtype bfloat16 (held in float32)
        self.bf16: set[str] = set()
        for p in self.stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.dims[p.name] = p.dimensions
                self.data_ndims[p.name] = len(p.data_dims)
            elif isinstance(p, gtir.GlobalTableDecl):
                self.dims[p.name] = (False, False, False)
                self.data_ndims[p.name] = len(p.shape)
            if getattr(p, "dtype", None) is not None and np.dtype(p.dtype) == bfloat16:
                self.bf16.add(p.name)
        for name in list(self.arrays):
            self.f_ext[name] = analyzed.field_extents.get(name, Extent.zeros())
        for t in self.stencil.temporaries:
            self.f_ext[t.name] = analyzed.field_extents.get(t.name, Extent.zeros())
            self.dims[t.name] = (True, True, True)
            self.data_ndims[t.name] = 0
            if t.dtype is not None and np.dtype(t.dtype) == bfloat16:
                self.bf16.add(t.name)
        self._setup_windows()

    # -- windows -----------------------------------------------------------

    def _win_shape(self, name: str) -> tuple[int, ...]:
        ni, nj, nk = self.domain
        ext = self.f_ext[name]
        dims = self.dims[name]
        shape = []
        if dims[0]:
            shape.append(ni + ext.i[1] - ext.i[0])
        if dims[1]:
            shape.append(nj + ext.j[1] - ext.j[0])
        if dims[2]:
            shape.append(nk + ext.k[1] - ext.k[0])
        return tuple(shape)

    def _setup_windows(self) -> None:
        """Create per-field windows: views of the sub-arrays the stencil
        touches. K windows that extend past a read-only field's allocation
        clamp to the boundary level (edge padding, a copy)."""
        self.win: dict[str, Any] = {}
        for name, arr in self.arrays.items():
            dims = self.dims.get(name, (True, True, True))
            if not any(dims):  # GlobalTable
                self.win[name] = arr
                continue
            ext = self.f_ext[name]
            origin = self.origins.get(name, (0, 0, 0))
            sl = []
            k_pad = (0, 0)
            for ax, (present, lo, size) in enumerate(
                zip(dims, (ext.i[0], ext.j[0], ext.k[0]), self._axis_sizes(name))
            ):
                if present:
                    start = origin[ax] + lo
                    if ax == 2:
                        n = arr.shape[len(sl)]
                        lo_pad = max(0, -start)
                        hi_pad = max(0, start + size - n)
                        if lo_pad or hi_pad:
                            info = self.analyzed.field_infos.get(name)
                            if info is not None and info.access & AccessKind.WRITE:
                                raise IndexError(
                                    f"K access extent of written field '{name}' "
                                    f"exceeds its allocation"
                                )
                            k_pad = (lo_pad, hi_pad)
                            start, size = max(start, 0), min(start + size, n) - max(start, 0)
                    sl.append(slice(start, start + size))
            sl = tuple(sl) + (slice(None),) * self.data_ndims.get(name, 0)
            window = arr[sl]
            if k_pad != (0, 0):
                kax = sum(dims[:2])
                pad = [(0, 0)] * window.ndim
                pad[kax] = k_pad
                window = np.pad(window, pad, mode="edge")
            self.win[name] = window
        # Temporaries: lazily-allocated windows.
        for t in self.stencil.temporaries:
            self.win[t.name] = None
        self._temp_dtypes = {
            t.name: (t.dtype if t.dtype is not None else np.float64)
            for t in self.stencil.temporaries
        }

    def _axis_sizes(self, name: str) -> tuple:
        """The window's size along each of I, J and K (0 where the field
        has no such axis): ``_win_shape`` lists the present axes only, so a
        lower-dimensional field's K origin would otherwise be dropped."""
        sizes = iter(self._win_shape(name))
        return tuple(next(sizes) if present else 0 for present in self.dims[name])

    def _get_window(self, name: str):
        w = self.win[name]
        if w is None:  # unwritten temporary: undefined values read as zeros
            w = np.zeros(self._win_shape(name), dtype=carrier_dtype(self._temp_dtypes[name]))
            self.win[name] = w
        return w

    def _stored(self, name: str, value, dtype) -> Any:
        """``value`` as field ``name`` stores it, in (carrier) ``dtype``."""
        value = np.asarray(value).astype(dtype)
        return round_bf16(value) if name in self.bf16 else value

    # -- main entry --------------------------------------------------------

    def run(self) -> dict[str, Any]:
        for vloop in self.stencil.vertical_loops:
            if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                self._run_parallel(vloop)
            else:
                self._run_sequential(vloop)
        return self.arrays  # windows are views: the writes went through

    # -- parallel loops ----------------------------------------------------

    def _run_parallel(self, vloop: gtir.VerticalLoop) -> None:
        nk = self.domain[2]
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            if ke <= ks:
                continue
            for stmt in section.body:
                self._exec_unit(stmt, ks, ke, None)

    # -- sequential loops --------------------------------------------------

    def _run_sequential(self, vloop: gtir.VerticalLoop) -> None:
        nk = self.domain[2]
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            if ke <= ks:
                continue
            k_range = range(ks, ke)
            if backward:
                k_range = reversed(k_range)
            for k in k_range:
                for stmt in section.body:
                    self._exec_unit(stmt, k, k + 1, k)

    # -- unit execution ----------------------------------------------------

    def _exec_unit(self, stmt: gtir.Stmt, ks, ke, k_seq) -> None:
        ext = self.analyzed.stmt_extents[stmt]
        ctx = _Ctx(ext, ks, ke, k_seq)
        if isinstance(stmt, gtir.Assign):
            value = self._broadcast_target(
                self.eval_expr(stmt.value, ctx), ctx, stmt.target
            )
            mask = self._full_mask(stmt, ctx)
            self._write(stmt.target, value, mask, ctx)
        elif isinstance(stmt, gtir.While):
            self._exec_while(stmt, ctx)
        else:
            raise TypeError(type(stmt).__name__)

    def _full_mask(self, stmt, ctx: _Ctx) -> Optional[Any]:
        mask = None
        if stmt.mask is not None:
            mask = self._broadcast(self.eval_expr(stmt.mask, ctx), ctx)
        if stmt.horizontal_masks:
            rmask = self._region_mask(stmt.horizontal_masks, ctx)
            mask = rmask if mask is None else np.logical_and(mask, rmask)
        return mask

    def _exec_while(self, stmt: gtir.While, ctx: _Ctx, outer_mask=None) -> None:
        def eval_mask() -> Any:
            cond = self._broadcast(self.eval_expr(stmt.cond, ctx), ctx)
            extra = self._full_mask(stmt, ctx)
            if extra is not None:
                cond = np.logical_and(cond, extra)
            if outer_mask is not None:
                cond = np.logical_and(cond, outer_mask)
            return cond

        def apply_body(mask) -> None:
            for s in stmt.body:
                if isinstance(s, gtir.Assign):
                    value = self._broadcast_target(
                        self.eval_expr(s.value, ctx), ctx, s.target
                    )
                    smask = self._full_mask(s, ctx)
                    total = mask if smask is None else np.logical_and(mask, smask)
                    self._write(s.target, value, total, ctx)
                elif isinstance(s, gtir.While):
                    # nested while: the outer iteration mask gates the inner
                    # loop (points done with the outer loop must not change)
                    self._exec_while(s, ctx, outer_mask=mask)
                else:
                    raise TypeError(type(s).__name__)

        mask = eval_mask()
        while bool(np.any(mask)):
            apply_body(mask)
            mask = eval_mask()

    # -- reads/writes ------------------------------------------------------

    def _window_shape(self, ctx: _Ctx) -> tuple[int, int, int]:
        ni, nj, _ = self.domain
        ext = ctx.ext
        return (
            ni + ext.i[1] - ext.i[0],
            nj + ext.j[1] - ext.j[0],
            ctx.nk_static,
        )

    def _read_field(self, access: gtir.FieldAccess, ctx: _Ctx) -> Any:
        name = access.name
        dims = self.dims[name]
        Ni, Nj, Nk = self._window_shape(ctx)

        if not any(dims):  # GlobalTable: pure data-index lookup
            idx = tuple(self.eval_expr(e, ctx) for e in access.data_index)
            return self.win[name][idx]

        w = self._get_window(name)
        ext = ctx.ext
        f_ext = self.f_ext[name]
        di, dj, dk = access.offset

        starts = []
        sizes = []
        gather = access.koffset is not None or access.abs_k is not None
        if dims[0]:
            starts.append(ext.i[0] + di - f_ext.i[0])
            sizes.append(Ni)
        if dims[1]:
            starts.append(ext.j[0] + dj - f_ext.j[0])
            sizes.append(Nj)
        if dims[2] and not gather:
            base = ctx.ks if ctx.k_seq is None else ctx.k_seq
            starts.append(base + dk - f_ext.k[0])
            sizes.append(Nk)

        if gather:
            window = self.ops.slice_nd(w, starts, sizes) if starts else w
            window = self._expand_missing(window, (dims[0], dims[1], True), Ni, Nj, Nk)
            if access.abs_k is not None:
                kidx = np.asarray(self.eval_expr(access.abs_k, ctx)) - f_ext.k[0]
            else:
                base = ctx.ks if ctx.k_seq is None else ctx.k_seq
                k_iota = self.ops.iota(Nk, 2, None) if ctx.k_seq is None else 0
                koff = self.eval_expr(access.koffset, ctx)
                kidx = np.asarray(base + dk + k_iota + koff - f_ext.k[0])
            kidx = np.broadcast_to(kidx.astype(np.int64), (Ni, Nj, Nk))
            data_shape = tuple(window.shape[3:])
            if data_shape:
                # data-dim fields: gather K per gridpoint, broadcast the
                # index over the trailing data dims
                kidx = np.broadcast_to(
                    kidx.reshape((Ni, Nj, Nk) + (1,) * len(data_shape)),
                    (Ni, Nj, Nk) + data_shape,
                )
            value = self.ops.take_along_k(
                np.broadcast_to(window, (Ni, Nj) + tuple(window.shape[2:])), kidx
            )
            if access.data_index:
                value = self._apply_data_index(value, access.data_index, ctx)
            return value

        value = self.ops.slice_nd(w, starts, sizes)
        value = self._expand_missing(value, dims, Ni, Nj, Nk)
        if access.data_index:
            value = self._apply_data_index(value, access.data_index, ctx)
        return value

    def _expand_missing(self, value, dims, Ni, Nj, Nk) -> Any:
        axis = 0
        for present in dims:
            if not present:
                value = np.expand_dims(value, axis)
            axis += 1
        return value

    def _eval_static_index(self, expr: gtir.Expr, ctx: _Ctx):
        value = self.eval_expr(expr, ctx)
        if isinstance(value, np.ndarray) and value.ndim == 0:
            return int(value)
        if isinstance(value, (int, np.integer)):
            return int(value)
        return None  # per-gridpoint index: caller gathers

    def _apply_data_index(self, value, index_exprs, ctx: _Ctx):
        """Index the trailing data dimensions; scalar indices slice,
        per-gridpoint (array-valued) indices gather along the data axis
        (reference gtscript_frontend.py:1290 data-dims subscripting)."""
        axis = 3  # first data axis after (I, J, K)
        for expr in index_exprs:
            idx = self._eval_static_index(expr, ctx)
            if idx is not None:
                value = value[(slice(None),) * axis + (idx,)]
                continue
            iv = self._broadcast(self.eval_expr(expr, ctx), ctx)
            iv = np.asarray(iv).astype(np.int64)
            iv = np.clip(iv, 0, value.shape[axis] - 1)
            # broadcast the (I, J, K)-shaped index over remaining data dims
            iv = np.broadcast_to(
                iv.reshape(iv.shape[:3] + (1,) * (value.ndim - 3)),
                value.shape[:axis] + (1,) + value.shape[axis + 1 :],
            )
            value = np.take_along_axis(value, iv, axis=axis)
            value = np.squeeze(value, axis=axis)
        return value

    def _write(self, target: gtir.FieldAccess, value, mask, ctx: _Ctx) -> None:
        name = target.name
        if target.koffset is not None:
            self._write_variable_k(target, value, mask, ctx)
            return
        dims = self.dims[name]
        ext = ctx.ext
        f_ext = self.f_ext[name]
        Ni, Nj, Nk = self._window_shape(ctx)
        w = self._get_window(name) if (self.win.get(name) is not None or mask is not None or target.data_index) else None

        value = self._broadcast_target(value, ctx, target)

        starts = []
        shape_out = []
        if dims[0]:
            starts.append(ext.i[0] - f_ext.i[0])
            shape_out.append(Ni)
        if dims[1]:
            starts.append(ext.j[0] - f_ext.j[0])
            shape_out.append(Nj)
        if dims[2]:
            base = ctx.ks if ctx.k_seq is None else ctx.k_seq
            # K-offset writes (sequential loops only) land at k + dk.
            starts.append(base + target.offset[2] - f_ext.k[0])
            shape_out.append(Nk)
        elif Nk != 1:
            raise NotImplementedError(
                f"Writing field '{name}' without K axis over a multi-level section"
            )

        squeeze_axes = tuple(i for i, present in enumerate(dims) if not present)
        if squeeze_axes:
            value = np.squeeze(value, axis=squeeze_axes)

        if w is None:
            # Unallocated temporary with a plain write.
            win_shape = self._win_shape(name)
            value = self._stored(name, value, carrier_dtype(self._temp_dtypes[name]))
            if tuple(shape_out) == win_shape and all(
                isinstance(s, (int, np.integer)) and s == 0 for s in starts
            ):
                self.win[name] = value
                return
            w = self._get_window(name)

        value = self._stored(name, value, w.dtype)
        # Full-window unmasked writes replace the window outright.
        if (
            mask is None
            and not target.data_index
            and tuple(shape_out) == tuple(w.shape[: len(shape_out)])
            and (not self.data_ndims.get(name, 0) or value.shape == w.shape)
            and all(isinstance(s, (int, np.integer)) and s == 0 for s in starts)
        ):
            w[...] = value
            return

        def _expand_mask(m, like):
            if m is not None and like.ndim > m.ndim:
                m = m.reshape(m.shape + (1,) * (like.ndim - m.ndim))
            return m

        if mask is not None:
            if squeeze_axes:
                mask = np.squeeze(mask, axis=squeeze_axes)
            old = self.ops.slice_nd(w, starts, shape_out)
            if target.data_index:
                idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
                if any(i is None for i in idx):
                    new = self._set_data_index(old, target.data_index, value, mask, ctx)
                else:
                    old_elem = old[(Ellipsis,) + idx]
                    sel = np.where(_expand_mask(mask, old_elem), value, old_elem)
                    old[(Ellipsis,) + idx] = sel
                    new = old
            else:
                new = np.where(_expand_mask(mask, value), value, old)
            self.win[name] = self.ops.update_nd(w, starts, new)
        else:
            if target.data_index:
                idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
                old = self.ops.slice_nd(w, starts, shape_out)
                if any(i is None for i in idx):
                    block = self._set_data_index(old, target.data_index, value, None, ctx)
                else:
                    old[(Ellipsis,) + idx] = value
                    block = old
                self.win[name] = self.ops.update_nd(w, starts, block)
            else:
                self.win[name] = self.ops.update_nd(w, starts, value)

    def _write_variable_k(
        self, target: gtir.FieldAccess, value, mask, ctx: _Ctx
    ) -> None:
        """Per-gridpoint variable-K-offset write (``A[0, 0, lev] = x``
        with runtime ``lev``; reference test_code_generation.py
        ::test_K_offset_write_conditional). Sequential loops only; out-of-
        range target levels are dropped, mirroring the clamped-read
        policy's bounds safety without corrupting boundary levels."""
        name = target.name
        dims = self.dims[name]
        if target.data_index:
            raise NotImplementedError(
                "variable-K-offset write combined with data-dimension indexing"
            )
        if not (dims[0] and dims[1] and dims[2]):
            raise NotImplementedError(
                "variable-K-offset writes require a full IJK field"
            )
        if ctx.k_seq is None:
            raise RuntimeError(
                "variable-K-offset write outside a sequential loop "
                "(should have been rejected at parse time)"
            )
        ext = ctx.ext
        f_ext = self.f_ext[name]
        Ni, Nj, Nk = self._window_shape(ctx)
        w = self._get_window(name)
        value = self._broadcast_target(value, ctx, target)

        starts = [ext.i[0] - f_ext.i[0], ext.j[0] - f_ext.j[0]]
        sizes = [Ni, Nj]
        block = self.ops.slice_nd(w, starts, sizes)  # (Ni, Nj, K_window)
        koff = self._broadcast(self.eval_expr(target.koffset, ctx), ctx)
        kidx = np.asarray(
            ctx.k_seq + target.offset[2] + koff - f_ext.k[0]
        ).astype(np.int64)
        kidx = np.broadcast_to(kidx, (Ni, Nj, Nk))
        value = np.broadcast_to(self._stored(name, value, w.dtype), (Ni, Nj, Nk))
        if mask is not None:
            mask = np.broadcast_to(mask, (Ni, Nj, Nk))
        # slice_nd returned a view; put_along_k writes through
        self.ops.put_along_k(block, kidx, value, mask)

    def _set_data_index(self, old, index_exprs, value, mask, ctx: _Ctx):
        """Per-gridpoint data-index WRITE: blend ``value`` into ``old`` at
        the (possibly array-valued) data indices via one-hot selection
        (data dims are small, so the select is cheap and scatter-free)."""
        dd = old.ndim - 3
        if len(index_exprs) != dd:
            raise NotImplementedError(
                "partial per-gridpoint data-dimension writes are not supported"
            )
        cond = None
        for d, expr in enumerate(index_exprs):
            iv = self._eval_static_index(expr, ctx)
            if iv is None:
                iv = self._broadcast(self.eval_expr(expr, ctx), ctx)
            iv = np.asarray(iv).astype(np.int64)
            iv = iv.reshape(iv.shape + (1,) * dd) if iv.ndim == 3 else iv
            shape_iota = (1, 1, 1) + tuple(
                old.shape[3 + t] if t == d else 1 for t in range(dd)
            )
            iota = np.arange(old.shape[3 + d], dtype=np.int64).reshape(shape_iota)
            c = iota == iv
            cond = c if cond is None else np.logical_and(cond, c)
        if mask is not None:
            cond = np.logical_and(cond, mask.reshape(mask.shape + (1,) * dd))
        valx = np.asarray(value)
        if valx.ndim == 3:
            valx = valx.reshape(valx.shape + (1,) * dd)
        return np.where(cond, valx, old)

    def _region_mask(self, hmasks, ctx: _Ctx) -> Any:
        ni, nj, _ = self.domain
        Ni, Nj, Nk = self._window_shape(ctx)
        i_rel = self.ops.iota(Ni, 0, None) + ctx.ext.i[0]
        j_rel = self.ops.iota(Nj, 1, None) + ctx.ext.j[0]
        total = None
        for hm in hmasks:
            cond = np.ones((1, 1, 1), dtype=bool)
            for rel, interval, size in ((i_rel, hm.i, ni), (j_rel, hm.j, nj)):
                if interval.start is not None:
                    cond = np.logical_and(cond, rel >= interval.start.resolve(size))
                if interval.end is not None:
                    cond = np.logical_and(cond, rel < interval.end.resolve(size))
            total = cond if total is None else np.logical_and(total, cond)
        return np.broadcast_to(total, (Ni, Nj, Nk))

    def _broadcast(self, value, ctx: _Ctx) -> Any:
        shape = self._window_shape(ctx)
        return np.broadcast_to(np.asarray(value), shape)

    def _broadcast_target(self, value, ctx: _Ctx, target: gtir.FieldAccess) -> Any:
        """Broadcast an assignment's RHS to the target's full value shape —
        (Ni, Nj, Nk) plus the remaining (unindexed) data dimensions for
        vector/matrix assignments like ``out = mat @ vec`` (reference
        unrolls these in defir_to_gtir.py:123,195; here they stay whole)."""
        shape = self._window_shape(ctx)
        dd = self._data_shape(target.name)
        rest = dd[len(target.data_index):] if dd else ()
        if rest:
            value = np.asarray(value)
            # a grid-shaped value (leading dims == window) gets new trailing
            # axes; pure data values ((M,) constants) trail-align naturally
            if value.ndim == 3 and tuple(value.shape) == shape:
                value = value.reshape(value.shape + (1,) * len(rest))
            return np.broadcast_to(value, shape + rest)
        return np.broadcast_to(np.asarray(value), shape)

    def _data_shape(self, name: str) -> tuple[int, ...]:
        info = self.analyzed.field_infos.get(name)
        if info is not None:
            return tuple(info.data_dims or ())
        w = self.win.get(name)
        if w is not None and w.ndim > 3:
            return tuple(w.shape[3:])
        return ()

    # -- expression evaluation --------------------------------------------

    def eval_expr(self, expr: gtir.Expr, ctx: _Ctx) -> Any:
        if isinstance(expr, gtir.Literal):
            return as_dtype_value(expr.value, expr.dtype)[()]
        if isinstance(expr, gtir.ScalarAccess):
            return self.scalars[expr.name]
        if isinstance(expr, gtir.FieldAccess):
            return self._read_field(expr, ctx)
        if isinstance(expr, gtir.UnaryOp):
            v = self.eval_expr(expr.expr, ctx)
            if expr.op == gtir.UnaryOperator.NOT:
                return np.logical_not(v)
            if expr.op == gtir.UnaryOperator.NEG:
                return np.negative(v)
            return v
        if isinstance(expr, gtir.BinaryOp):
            left = self.eval_expr(expr.left, ctx)
            right = self.eval_expr(expr.right, ctx)
            return apply_binop(expr, left, right)
        if isinstance(expr, gtir.TernaryOp):
            cond = self.eval_expr(expr.cond, ctx)
            t = self.eval_expr(expr.true_expr, ctx)
            f = self.eval_expr(expr.false_expr, ctx)
            return np.where(cond, t, f)
        if isinstance(expr, gtir.NativeFuncCall):
            args = [self.eval_expr(a, ctx) for a in expr.args]
            return apply_native(self.natives, expr, args)
        if isinstance(expr, gtir.Cast):
            return as_dtype_value(self.eval_expr(expr.expr, ctx), expr.dtype)
        if isinstance(expr, gtir.IteratorAccess):
            dtype = expr.dtype if expr.dtype is not None else np.dtype(np.int64)
            if ctx.k_seq is not None:
                return np.asarray(ctx.k_seq, dtype=dtype)[()]
            return (self.ops.iota(ctx.nk_static, 2, None) + ctx.ks).astype(dtype)
        raise TypeError(type(expr).__name__)
