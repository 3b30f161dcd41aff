"""Eager GTIR execution engine on torch tensors — the plain version.

Counterpart of gt4py_tpu/cartesian/backend/evaluator.py, following its
``ns="numpy"`` branch (eager, in place on views): every field gets a
*window*, the view of the tensor the stencil touches (domain extended by the
field's access extent), and statements read and write those views on the
tensors' own device. It is the ``"torch"`` backend and the plain version
that every generated CUDA kernel is held against.

Semantics (those of the JAX package's numpy branch):
- every statement executes over the compute domain extended by its
  per-statement extent (passes/extents.py), in program order;
- conditional writes are masked selects (both branches evaluated);
- FORWARD/BACKWARD sections loop over K in Python, one plane per level, so
  K-offset reads of fields written in the section observe updated values;
- K windows that reach past a read-only field's allocation clamp to the
  edge level.

Dtypes: torch promotes differently from NumPy (a float64 0-d operand does not
widen a float32 tensor; ``int * 0.5`` is float32). GTIR fixes every
expression's dtype (passes/type_inference.py), so each operation here first
casts its operands to that dtype and never relies on torch promotion. Half
types (float16, bfloat16) run in torch's own, rounded at every operation,
as the JAX package's ``numpy`` backend rounds them with ml_dtypes; a
comparison widens only its half side (``comparison_dtype``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import AccessKind, Extent
from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil
from gt4py_tpu_torch.cartesian.passes.type_inference import comparison_dtype
from gt4py_tpu_torch.core.ndarray_utils import (
    TorchNamespace,
    slice_nd,
    torch_math,
    update_nd,
)

_BOOL_FUNCS = frozenset(
    {gtir.NativeFunction.ISFINITE, gtir.NativeFunction.ISINF, gtir.NativeFunction.ISNAN}
)
_ROUNDING_FUNCS = frozenset(
    {
        gtir.NativeFunction.FLOOR,
        gtir.NativeFunction.CEIL,
        gtir.NativeFunction.TRUNC,
        gtir.NativeFunction.ROUND,
        gtir.NativeFunction.ROUND_AWAY_FROM_ZERO,
    }
)


def _native_impls() -> dict:
    F = gtir.NativeFunction
    m = torch_math
    return {
        F.ABS: m.abs,
        F.MIN: m.minimum,
        F.MAX: m.maximum,
        F.MOD: m.mod,
        F.SIN: m.sin,
        F.COS: m.cos,
        F.TAN: m.tan,
        F.ASIN: m.arcsin,
        F.ACOS: m.arccos,
        F.ATAN: m.arctan,
        F.SINH: m.sinh,
        F.COSH: m.cosh,
        F.TANH: m.tanh,
        F.ASINH: m.arcsinh,
        F.ACOSH: m.arccosh,
        F.ATANH: m.arctanh,
        F.SQRT: m.sqrt,
        F.CBRT: m.cbrt,
        F.EXP: m.exp,
        F.LOG: m.log,
        F.LOG10: m.log10,
        F.GAMMA: m.gamma,
        F.ISFINITE: m.isfinite,
        F.ISINF: m.isinf,
        F.ISNAN: m.isnan,
        F.FLOOR: m.floor,
        F.CEIL: m.ceil,
        F.TRUNC: m.trunc,
        F.ROUND: m.round,
        F.ROUND_AWAY_FROM_ZERO: m.round_away_from_zero,
        F.ERF: m.erf,
        F.ERFC: m.erfc,
        F.POW: m.power,
        F.ATAN2: m.arctan2,
        F.HYPOT: m.hypot,
        F.COPYSIGN: m.copysign,
        F.FMA: lambda a, b, c: a * b + c,
    }


_NATIVES = _native_impls()


def _apply_binop(op, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Operands arrive cast to a common dtype (see Evaluator.eval_expr)."""
    A = gtir.ArithmeticOperator
    C = gtir.ComparisonOperator
    L = gtir.LogicalOperator
    if op == A.ADD:
        return torch.add(left, right)
    if op == A.SUB:
        return torch.sub(left, right)
    if op == A.MUL:
        return torch.mul(left, right)
    if op == A.DIV:
        return torch.true_divide(left, right)
    if op == A.MOD:
        return torch.remainder(left, right)
    if op == A.POW:
        return torch.pow(left, right)
    if op == A.MATMUL:
        # '@' on data-dimension fields: grid axes (rank 3) are batch dims.
        ld, rd = left.ndim - 3, right.ndim - 3
        if ld == 2 and rd == 1:
            return torch.matmul(left, right[..., None])[..., 0]
        if ld == 1 and rd == 2:
            return torch.matmul(left[..., None, :], right)[..., 0, :]
        return torch.matmul(left, right)
    if op == C.EQ:
        return torch.eq(left, right)
    if op == C.NE:
        return torch.ne(left, right)
    if op == C.LT:
        return torch.lt(left, right)
    if op == C.LE:
        return torch.le(left, right)
    if op == C.GT:
        return torch.gt(left, right)
    if op == C.GE:
        return torch.ge(left, right)
    if op == L.AND:
        return torch.logical_and(left, right)
    if op == L.OR:
        return torch.logical_or(left, right)
    raise TypeError(op)


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
    in place on ``arrays`` (tensors of one device)."""

    def __init__(
        self,
        analyzed: AnalyzedStencil,
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        arrays: dict[str, torch.Tensor],
        scalars: dict[str, Any],
        device: torch.device,
    ):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.domain = domain
        self.origins = dict(origins)
        self.arrays = dict(arrays)
        self.xp = TorchNamespace(device)
        self.scalars = {
            name: self.xp.asarray(np.asarray(v)) for name, v in scalars.items()
        }
        self._literals: dict = {}

        self.dims: dict[str, tuple[bool, bool, bool]] = {}
        self.data_ndims: dict[str, int] = {}
        self.f_ext: dict[str, Extent] = {}
        for p in self.stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.dims[p.name] = p.dimensions
                self.data_ndims[p.name] = len(p.data_dims)
            elif isinstance(p, gtir.GlobalTableDecl):
                self.dims[p.name] = (False, False, False)
                self.data_ndims[p.name] = len(p.shape)
        for name in list(self.arrays):
            self.f_ext[name] = analyzed.field_extents.get(name, Extent.zeros())
        for t in self.stencil.temporaries:
            self.f_ext[t.name] = analyzed.field_extents.get(t.name, Extent.zeros())
            self.dims[t.name] = (True, True, True)
            self.data_ndims[t.name] = 0
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
        """Create per-field windows: views of the sub-tensors the stencil
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
                window = self.xp.pad_edge(window, sum(dims[:2]), *k_pad)
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
            w = self.xp.zeros(self._win_shape(name), self._temp_dtypes[name])
            self.win[name] = w
        return w

    # -- main entry --------------------------------------------------------

    def run(self) -> dict[str, torch.Tensor]:
        for vloop in self.stencil.vertical_loops:
            if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                self._run_parallel(vloop)
            else:
                self._run_sequential(vloop)
        return self.arrays  # windows are views: the writes went through

    def _run_parallel(self, vloop: gtir.VerticalLoop) -> None:
        nk = self.domain[2]
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            if ke <= ks:
                continue
            for stmt in section.body:
                self._exec_unit(stmt, ks, ke, None)

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
            mask = rmask if mask is None else self.xp.logical_and(mask, rmask)
        return mask

    def _exec_while(self, stmt: gtir.While, ctx: _Ctx, outer_mask=None) -> None:
        xp = self.xp

        def eval_mask() -> Any:
            cond = self._broadcast(self.eval_expr(stmt.cond, ctx), ctx)
            extra = self._full_mask(stmt, ctx)
            if extra is not None:
                cond = xp.logical_and(cond, extra)
            if outer_mask is not None:
                cond = xp.logical_and(cond, outer_mask)
            return cond

        def apply_body(mask) -> None:
            for s in stmt.body:
                if isinstance(s, gtir.Assign):
                    value = self._broadcast_target(
                        self.eval_expr(s.value, ctx), ctx, s.target
                    )
                    smask = self._full_mask(s, ctx)
                    total = mask if smask is None else xp.logical_and(mask, smask)
                    self._write(s.target, value, total, ctx)
                elif isinstance(s, gtir.While):
                    # nested while: the outer iteration mask gates the inner
                    # loop (points done with the outer loop must not change)
                    self._exec_while(s, ctx, outer_mask=mask)
                else:
                    raise TypeError(type(s).__name__)

        mask = eval_mask()
        while xp.any(mask):
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
        xp = self.xp
        name = access.name
        dims = self.dims[name]
        Ni, Nj, Nk = self._window_shape(ctx)

        if not any(dims):  # GlobalTable: pure data-index lookup
            idx = tuple(self._index_value(self.eval_expr(e, ctx)) for e in access.data_index)
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
            window = slice_nd(w, starts, sizes) if starts else w
            window = self._expand_missing(window, (dims[0], dims[1], True))
            if access.abs_k is not None:
                kidx = xp.astype(self.eval_expr(access.abs_k, ctx), np.int64) - f_ext.k[0]
            else:
                base = ctx.ks if ctx.k_seq is None else ctx.k_seq
                k_iota = self._iota(Nk, 2) if ctx.k_seq is None else 0
                koff = xp.astype(self.eval_expr(access.koffset, ctx), np.int64)
                kidx = koff + k_iota + (base + dk - f_ext.k[0])
            kidx = xp.broadcast_to(kidx, (Ni, Nj, Nk))
            data_shape = tuple(window.shape[3:])
            if data_shape:
                # data-dim fields: gather K per gridpoint, broadcast the
                # index over the trailing data dims
                kidx = xp.broadcast_to(
                    kidx.reshape((Ni, Nj, Nk) + (1,) * len(data_shape)),
                    (Ni, Nj, Nk) + data_shape,
                )
            kidx = xp.clip(kidx, 0, window.shape[2] - 1)
            window = xp.broadcast_to(window, (Ni, Nj) + tuple(window.shape[2:]))
            value = xp.take_along_axis(window, kidx, axis=2)
            if access.data_index:
                value = self._apply_data_index(value, access.data_index, ctx)
            return value

        value = slice_nd(w, starts, sizes)
        value = self._expand_missing(value, dims)
        if access.data_index:
            value = self._apply_data_index(value, access.data_index, ctx)
        return value

    def _expand_missing(self, value, dims) -> Any:
        axis = 0
        for present in dims:
            if not present:
                value = self.xp.expand_dims(value, axis)
            axis += 1
        return value

    def _iota(self, n: int, axis: int) -> torch.Tensor:
        shape = [1, 1, 1]
        shape[axis] = n
        return self.xp.arange(n, dtype=np.int64).reshape(shape)

    @staticmethod
    def _index_value(value):
        """A 0-d index as a Python int; per-gridpoint indices stay tensors."""
        if isinstance(value, torch.Tensor) and value.ndim == 0:
            return int(value)
        return value

    def _eval_static_index(self, expr: gtir.Expr, ctx: _Ctx):
        value = self.eval_expr(expr, ctx)
        if isinstance(value, torch.Tensor) and value.ndim == 0:
            return int(value)
        return None  # per-gridpoint index: caller gathers

    def _apply_data_index(self, value, index_exprs, ctx: _Ctx):
        """Index the trailing data dimensions; scalar indices slice,
        per-gridpoint indices gather along the data axis."""
        xp = self.xp
        axis = 3  # first data axis after (I, J, K)
        for expr in index_exprs:
            idx = self._eval_static_index(expr, ctx)
            if idx is not None:
                value = value[(slice(None),) * axis + (idx,)]
                continue
            iv = self._broadcast(self.eval_expr(expr, ctx), ctx)
            iv = xp.clip(xp.astype(iv, np.int64), 0, value.shape[axis] - 1)
            # broadcast the (I, J, K)-shaped index over remaining data dims
            iv = xp.broadcast_to(
                iv.reshape(tuple(iv.shape[:3]) + (1,) * (value.ndim - 3)),
                tuple(value.shape[:axis]) + (1,) + tuple(value.shape[axis + 1 :]),
            )
            value = xp.take_along_axis(value, iv, axis=axis).squeeze(axis)
        return value

    def _write(self, target: gtir.FieldAccess, value, mask, ctx: _Ctx) -> None:
        xp = self.xp
        name = target.name
        if target.koffset is not None:
            self._write_variable_k(target, value, mask, ctx)
            return
        dims = self.dims[name]
        ext = ctx.ext
        f_ext = self.f_ext[name]
        Ni, Nj, Nk = self._window_shape(ctx)
        w = (
            self._get_window(name)
            if (self.win.get(name) is not None or mask is not None or target.data_index)
            else None
        )

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
            value = xp.squeeze(value, axis=squeeze_axes)

        if w is None:
            # Unallocated temporary with a plain write: a private copy.
            win_shape = self._win_shape(name)
            value = xp.astype(value, self._temp_dtypes[name]).clone()
            if tuple(shape_out) == win_shape and all(s == 0 for s in starts):
                self.win[name] = value
                return
            w = self._get_window(name)

        value = xp.astype(value, w.dtype)
        if value.untyped_storage().data_ptr() == w.untyped_storage().data_ptr():
            value = value.clone()  # a shifted view of the target itself
        # Full-window unmasked writes replace the window's content.
        if (
            mask is None
            and not target.data_index
            and tuple(shape_out) == tuple(w.shape[: len(shape_out)])
            and (not self.data_ndims.get(name, 0) or tuple(value.shape) == tuple(w.shape))
            and all(s == 0 for s in starts)
        ):
            w[...] = value
            return

        def _expand_mask(m, like):
            if m is not None and like.ndim > m.ndim:
                m = m.reshape(tuple(m.shape) + (1,) * (like.ndim - m.ndim))
            return m

        old = slice_nd(w, starts, shape_out)
        if mask is not None:
            if squeeze_axes:
                mask = xp.squeeze(mask, axis=squeeze_axes)
            if target.data_index:
                idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
                if any(i is None for i in idx):
                    new = self._set_data_index(old, target.data_index, value, mask, ctx)
                else:
                    old_elem = old[(Ellipsis,) + idx]
                    old_elem[...] = xp.where(_expand_mask(mask, old_elem), value, old_elem)
                    return
            else:
                new = xp.where(_expand_mask(mask, value), value, old)
            update_nd(w, starts, new)
        elif target.data_index:
            idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
            if any(i is None for i in idx):
                update_nd(w, starts, self._set_data_index(old, target.data_index, value, None, ctx))
            else:
                old[(Ellipsis,) + idx] = value
        else:
            update_nd(w, starts, value)

    def _write_variable_k(
        self, target: gtir.FieldAccess, value, mask, ctx: _Ctx
    ) -> None:
        """Per-gridpoint variable-K-offset write (``A[0, 0, lev] = x`` with
        runtime ``lev``). Sequential loops only; out-of-range target levels
        are dropped."""
        xp = self.xp
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
        block = slice_nd(w, starts, [Ni, Nj])  # (Ni, Nj, K_window), a view
        koff = xp.astype(self._broadcast(self.eval_expr(target.koffset, ctx), ctx), np.int64)
        kidx = xp.broadcast_to(koff + (ctx.k_seq + target.offset[2] - f_ext.k[0]), (Ni, Nj, Nk))
        value = xp.broadcast_to(xp.astype(value, w.dtype), (Ni, Nj, Nk))
        nk = block.shape[2]
        safe = xp.clip(kidx, 0, nk - 1)
        ok = (kidx >= 0) & (kidx < nk)
        if mask is not None:
            ok = xp.logical_and(xp.broadcast_to(mask, (Ni, Nj, Nk)), ok)
        old = xp.take_along_axis(block, safe, axis=2)
        xp.put_along_axis(block, safe, xp.where(ok, value, old), axis=2)

    def _set_data_index(self, old, index_exprs, value, mask, ctx: _Ctx):
        """Per-gridpoint data-index WRITE: blend ``value`` into ``old`` at
        the (possibly array-valued) data indices via one-hot selection."""
        xp = self.xp
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
            iv = xp.astype(iv, np.int64)
            iv = iv.reshape(tuple(iv.shape) + (1,) * dd) if iv.ndim == 3 else iv
            shape_iota = (1, 1, 1) + tuple(
                old.shape[3 + t] if t == d else 1 for t in range(dd)
            )
            iota = xp.arange(old.shape[3 + d], dtype=np.int64).reshape(shape_iota)
            c = iota == iv
            cond = c if cond is None else xp.logical_and(cond, c)
        if mask is not None:
            cond = xp.logical_and(cond, mask.reshape(tuple(mask.shape) + (1,) * dd))
        valx = xp.asarray(value)
        if valx.ndim == 3:
            valx = valx.reshape(tuple(valx.shape) + (1,) * dd)
        return xp.where(cond, valx, old)

    def _region_mask(self, hmasks, ctx: _Ctx) -> Any:
        xp = self.xp
        ni, nj, _ = self.domain
        Ni, Nj, Nk = self._window_shape(ctx)
        i_rel = self._iota(Ni, 0) + ctx.ext.i[0]
        j_rel = self._iota(Nj, 1) + ctx.ext.j[0]
        total = None
        for hm in hmasks:
            cond = xp.ones((1, 1, 1), dtype=np.bool_)
            for rel, interval, size in ((i_rel, hm.i, ni), (j_rel, hm.j, nj)):
                if interval.start is not None:
                    cond = xp.logical_and(cond, rel >= interval.start.resolve(size))
                if interval.end is not None:
                    cond = xp.logical_and(cond, rel < interval.end.resolve(size))
            total = cond if total is None else xp.logical_and(total, cond)
        return xp.broadcast_to(total, (Ni, Nj, Nk))

    def _broadcast(self, value, ctx: _Ctx) -> Any:
        return self.xp.broadcast_to(value, self._window_shape(ctx))

    def _broadcast_target(self, value, ctx: _Ctx, target: gtir.FieldAccess) -> Any:
        """Broadcast an assignment's RHS to the target's full value shape —
        (Ni, Nj, Nk) plus the remaining (unindexed) data dimensions for
        vector/matrix assignments like ``out = mat @ vec``."""
        xp = self.xp
        shape = self._window_shape(ctx)
        dd = self._data_shape(target.name)
        rest = dd[len(target.data_index):] if dd else ()
        if rest:
            value = xp.asarray(value)
            # a grid-shaped value (leading dims == window) gets new trailing
            # axes; pure data values ((M,) constants) trail-align naturally
            if value.ndim == 3 and tuple(value.shape) == shape:
                value = value.reshape(tuple(value.shape) + (1,) * len(rest))
            return xp.broadcast_to(value, shape + rest)
        return xp.broadcast_to(value, shape)

    def _data_shape(self, name: str) -> tuple[int, ...]:
        info = self.analyzed.field_infos.get(name)
        if info is not None:
            return tuple(info.data_dims or ())
        w = self.win.get(name)
        if w is not None and w.ndim > 3:
            return tuple(w.shape[3:])
        return ()

    # -- expression evaluation --------------------------------------------

    def _literal(self, value, dtype) -> torch.Tensor:
        key = (repr(value), np.dtype(dtype))
        lit = self._literals.get(key)
        if lit is None:
            lit = self.xp.asarray(value, dtype)
            self._literals[key] = lit
        return lit

    def _cast(self, value, dtype) -> torch.Tensor:
        return value if dtype is None else self.xp.astype(value, dtype)

    def eval_expr(self, expr: gtir.Expr, ctx: _Ctx) -> Any:
        """The expression's value as a tensor of its GTIR dtype (0-d for
        scalars), broadcastable to the unit's window."""
        xp = self.xp
        if isinstance(expr, gtir.Literal):
            return self._literal(expr.value, expr.dtype)
        if isinstance(expr, gtir.ScalarAccess):
            return self.scalars[expr.name]
        if isinstance(expr, gtir.FieldAccess):
            return self._read_field(expr, ctx)
        if isinstance(expr, gtir.UnaryOp):
            v = self.eval_expr(expr.expr, ctx)
            if expr.op == gtir.UnaryOperator.NOT:
                return xp.logical_not(v)
            if expr.op == gtir.UnaryOperator.NEG:
                return torch.neg(v)
            return v
        if isinstance(expr, gtir.BinaryOp):
            left = self.eval_expr(expr.left, ctx)
            right = self.eval_expr(expr.right, ctx)
            if isinstance(expr.op, gtir.ComparisonOperator):
                common = comparison_dtype(
                    getattr(expr.left, "dtype", None), getattr(expr.right, "dtype", None)
                )
                left, right = self._cast(left, common), self._cast(right, common)
            elif isinstance(expr.op, gtir.ArithmeticOperator):
                left, right = self._cast(left, expr.dtype), self._cast(right, expr.dtype)
            return _apply_binop(expr.op, left, right)
        if isinstance(expr, gtir.TernaryOp):
            cond = self.eval_expr(expr.cond, ctx)
            t = self._cast(self.eval_expr(expr.true_expr, ctx), expr.dtype)
            f = self._cast(self.eval_expr(expr.false_expr, ctx), expr.dtype)
            return xp.where(cond, t, f)
        if isinstance(expr, gtir.NativeFuncCall):
            args = [self.eval_expr(a, ctx) for a in expr.args]
            if expr.func not in _BOOL_FUNCS:
                args = [self._cast(a, expr.dtype) for a in args]
                if (
                    expr.func in _ROUNDING_FUNCS
                    and not args[0].is_floating_point()
                ):
                    return args[0]  # integral already
            return _NATIVES[expr.func](*args)
        if isinstance(expr, gtir.Cast):
            return xp.astype(self.eval_expr(expr.expr, ctx), expr.dtype)
        if isinstance(expr, gtir.IteratorAccess):
            dtype = expr.dtype if expr.dtype is not None else np.dtype(np.int64)
            if ctx.k_seq is not None:
                return self._literal(ctx.k_seq, dtype)
            return xp.astype(self._iota(ctx.nk_static, 2) + ctx.ks, dtype)
        raise TypeError(type(expr).__name__)

