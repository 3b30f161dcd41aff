"""Debug backend ``"debug"``: per-gridpoint Python interpreter.

Copied from gt4py_tpu/cartesian/backend/debug_backend.py, the counterpart
of the reference's ``debug`` backend
(src/gt4py/cartesian/backend/debug_backend.py:29 —
straight-line triple loops). Independent of both vectorized evaluators
(the NumPy one and the port's torch one), so it serves as a second oracle:
plain Python loops over the extended domain, one point at a time, with
NumPy scalar arithmetic. Only suitable for small domains.

Like ``numpy`` it runs on NumPy views of CPU tensors, in place, and a CUDA
tensor raises (numpy_backend.HostViews). bfloat16 values are carried in
float32 and rounded after every operation as ml_dtypes rounds them
(numpy_evaluator.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.backend.base import Backend, register
from gt4py_tpu_torch.cartesian.backend.numpy_backend import HostViews
from gt4py_tpu_torch.cartesian.backend.numpy_evaluator import (
    _native_impls,
    _NamespaceOps,
    apply_binop,
    apply_native,
    as_dtype_value,
    carrier_dtype,
    round_bf16,
)
from gt4py_tpu_torch.cartesian.definitions import AccessKind, Extent
from gt4py_tpu_torch.core.definitions import bfloat16


@register
class DebugBackend(Backend):
    name = "debug"
    storage_info = {"alignment": 1, "device": "cpu"}

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        self.last_strategy = "debug"
        views = HostViews(arrays, self.name)
        _PointInterpreter(self.analyzed, domain, origins, views.arrays, scalars).run()
        views.store()
        return {
            name: arrays[name]
            for name, info in self.analyzed.field_infos.items()
            if info.access & AccessKind.WRITE and name in arrays
        }


class _PointInterpreter:
    def __init__(self, analyzed, domain, origins, arrays, scalars):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.domain = domain
        self.origins = dict(origins)
        self.arrays = arrays
        self.scalars = scalars
        self.natives = _native_impls(_NamespaceOps())
        self.dims = {}
        #: fields and temporaries of dtype bfloat16 (held in float32)
        self.bf16 = set()
        for p in self.stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.dims[p.name] = p.dimensions
            elif isinstance(p, gtir.GlobalTableDecl):
                self.dims[p.name] = (False, False, False)
            if getattr(p, "dtype", None) is not None and np.dtype(p.dtype) == bfloat16:
                self.bf16.add(p.name)
        ni, nj, nk = domain
        for t in self.stencil.temporaries:
            ext = analyzed.field_extents.get(t.name, Extent.zeros())
            shape = (
                ni + ext.i[1] - ext.i[0],
                nj + ext.j[1] - ext.j[0],
                nk + ext.k[1] - ext.k[0],
            )
            self.arrays[t.name] = np.zeros(shape, dtype=carrier_dtype(t.dtype))
            self.origins[t.name] = (-ext.i[0], -ext.j[0], -ext.k[0])
            self.dims[t.name] = (True, True, True)
            if t.dtype is not None and np.dtype(t.dtype) == bfloat16:
                self.bf16.add(t.name)

    def run(self) -> None:
        nk = self.domain[2]
        for vloop in self.stencil.vertical_loops:
            if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                for section in vloop.sections:
                    ks, ke = section.interval.resolve(nk)
                    for stmt in section.body:
                        for k in range(ks, ke):
                            self._exec_plane(stmt, k)
            else:
                backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
                for section in vloop.sections:
                    ks, ke = section.interval.resolve(nk)
                    k_range = range(ks, ke)
                    if backward:
                        k_range = reversed(k_range)
                    for k in k_range:
                        for stmt in section.body:
                            self._exec_plane(stmt, k)

    def _exec_plane(self, stmt: gtir.Stmt, k: int) -> None:
        ni, nj, _ = self.domain
        ext = self.analyzed.stmt_extents[stmt]
        for i in range(ext.i[0], ni + ext.i[1]):
            for j in range(ext.j[0], nj + ext.j[1]):
                self._exec_point(stmt, i, j, k)

    def _in_region(self, hmasks, i: int, j: int) -> bool:
        ni, nj, _ = self.domain
        for hm in hmasks:
            for rel, interval, size in ((i, hm.i, ni), (j, hm.j, nj)):
                if interval.start is not None and rel < interval.start.resolve(size):
                    return False
                if interval.end is not None and rel >= interval.end.resolve(size):
                    return False
        return True

    def _exec_point(self, stmt: gtir.Stmt, i: int, j: int, k: int) -> None:
        if stmt.horizontal_masks and not self._in_region(stmt.horizontal_masks, i, j):
            return
        pt = (i, j, k)
        if isinstance(stmt, gtir.Assign):
            if stmt.mask is not None and not bool(self.eval(stmt.mask, pt)):
                return
            self._write(stmt.target, self.eval(stmt.value, pt), pt)
        elif isinstance(stmt, gtir.While):
            def cond() -> bool:
                if stmt.mask is not None and not bool(self.eval(stmt.mask, pt)):
                    return False
                return bool(self.eval(stmt.cond, pt))

            while cond():
                for s in stmt.body:
                    assert isinstance(s, gtir.Assign)
                    if s.mask is not None and not bool(self.eval(s.mask, pt)):
                        continue
                    self._write(s.target, self.eval(s.value, pt), pt)
        else:
            raise TypeError(type(stmt).__name__)

    def _index(self, access: gtir.FieldAccess, pt, *, clamp_k: bool = True):
        """Storage index for an access; reads clamp K (variable-K read
        policy), writes pass ``clamp_k=False`` and get None for
        out-of-range target levels (the write is dropped, never smeared
        onto the boundary)."""
        name = access.name
        dims = self.dims[name]
        origin = self.origins.get(name, (0, 0, 0))
        i, j, k = pt
        arr = self.arrays[name]
        idx = []
        if dims[0]:
            idx.append(origin[0] + i + access.offset[0])
        if dims[1]:
            idx.append(origin[1] + j + access.offset[1])
        if dims[2]:
            if access.abs_k is not None:
                kk = origin[2] + int(self.eval(access.abs_k, pt))
            elif access.koffset is not None:
                kk = origin[2] + k + access.offset[2] + int(self.eval(access.koffset, pt))
            else:
                kk = origin[2] + k + access.offset[2]
            k_axis = len(idx)
            if clamp_k:
                kk = min(max(kk, 0), arr.shape[k_axis] - 1)
            elif not 0 <= kk < arr.shape[k_axis]:
                return None
            idx.append(kk)
        for e in access.data_index:
            idx.append(int(self.eval(e, pt)))
        return tuple(idx)

    def _write(self, target: gtir.FieldAccess, value, pt) -> None:
        arr = self.arrays[target.name]
        idx = self._index(target, pt, clamp_k=False)
        if idx is None:
            return
        if target.name in self.bf16:
            value = round_bf16(np.asarray(value).astype(arr.dtype))
        arr[idx] = value

    def eval(self, expr: gtir.Expr, pt) -> Any:
        if isinstance(expr, gtir.Literal):
            return as_dtype_value(expr.value, expr.dtype)[()]
        if isinstance(expr, gtir.ScalarAccess):
            return self.scalars[expr.name]
        if isinstance(expr, gtir.FieldAccess):
            return self.arrays[expr.name][self._index(expr, pt)]
        if isinstance(expr, gtir.UnaryOp):
            v = self.eval(expr.expr, pt)
            if expr.op == gtir.UnaryOperator.NOT:
                return np.logical_not(v)
            if expr.op == gtir.UnaryOperator.NEG:
                return -v
            return v
        if isinstance(expr, gtir.BinaryOp):
            return apply_binop(expr, self.eval(expr.left, pt), self.eval(expr.right, pt))
        if isinstance(expr, gtir.TernaryOp):
            return (
                self.eval(expr.true_expr, pt)
                if bool(self.eval(expr.cond, pt))
                else self.eval(expr.false_expr, pt)
            )
        if isinstance(expr, gtir.NativeFuncCall):
            return apply_native(self.natives, expr, [self.eval(a, pt) for a in expr.args])
        if isinstance(expr, gtir.Cast):
            return as_dtype_value(self.eval(expr.expr, pt), expr.dtype)[()]
        if isinstance(expr, gtir.IteratorAccess):
            dtype = expr.dtype if expr.dtype is not None else np.int64
            return np.asarray(pt[2], dtype=dtype)[()]
        raise TypeError(type(expr).__name__)
