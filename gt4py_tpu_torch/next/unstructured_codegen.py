"""Unstructured field operators lowered to one generated CUDA kernel.

The ``cuda:hopper`` field-view backend's path for the operators that the
cartesian bridge refuses because they shift through connectivities: the
gather-reduce operators of unstructured-mesh models (the FVM nabla of
gt4py's ``test_fvm_nabla.py``, ICON's diffusion of ``vn``). It replaces no
TPU kernel: the JAX package runs these operators as XLA gathers, and the
port ran them as embedded ``torch`` operations until this lowering.

The lowering works from the operator's FOAST (``foast.func_to_foast``)
typed by the call's arguments: each parameter's dimensions and dtype, each
offset's connectivity. It evaluates the FOAST symbolically into one
expression DAG per returned field, at one element of the output's
horizontal dimension and one level of ``K``. The subset it takes:

- arithmetic (``+ - * /``, unary ``-``) on fields over one horizontal
  dimension, with or without the vertical one, plus scalars and literals;
  a field over ``K`` alone (ICON's vertical profiles) is a value of each
  level, broadcast over the horizontal dimension;
- ``sqrt`` (rounded to nearest), ``maximum`` and ``minimum`` (a NaN operand
  gives NaN, as ``torch.maximum``/``torch.minimum``);
- shifts through fixed-width connectivities, indexed (``pp(E2V[0])``) or
  whole (``zavgS(V2E)``, which adds the local dimension); an intermediate
  on the source domain (the FVM nabla's edge value ``zavg * S``) is
  recomputed inline at each neighbor and never written to memory;
- ``neighbor_sum`` over the local dimension, a table entry equal to the
  connectivity's ``skip_value`` counting as absent;
- nested field operators (inlined), tuple returns and tuple locals;
- an operator with no shift whose fields all lie over the output's
  horizontal dimension (ICON's update of ``vn``);
- an ``out`` that is an argument the operator reads only at the output's
  own element, as the same view (``apply(..., vn, out=vn)``): each thread
  reads the element before it writes it, through a plain pointer
  (:meth:`NeighborProgram.aliased`). ``FieldOperator.__call__`` offers such
  an update in place here before the cartesian bridge, which would copy the
  argument first.

Anything else is declined (:class:`Declined`), its reason counted in
:data:`declined` by the constants ``DECLINED_*``; the call then runs
embedded, as before.

On card tensors the variant's source is one kernel, ``gt_neighbor_*``, that
writes every returned field in one launch. What bounds it is the card's
memory bandwidth: each input and output byte moved once is the floor; the
gathers' reuse (a vertex's neighbors' values, read once by each of them)
is left to the L1 and L2 caches. Its design:

- where the outputs' ``K`` axis is contiguous, 32 lanes (one warp) an
  element of the horizontal dimension along ``K`` (coalesced rows), or 16
  where that pads ``K`` to fewer levels in whole trips (:func:`_lanes`:
  ICON's 80 levels are five trips of 16, not three of 32 whose last idles
  half its lanes); else one thread an element, its loop along ``K``
  (coalesced across threads);
- the part of the DAG that does not vary along ``K`` (table reads, the
  geometry, the validity of each neighbor) is computed once an element,
  before the ``K`` loop;
- the ``K`` loop unrolled, every trip's loads issued before any trip's
  arithmetic (the IEEE divisions' slow-path branches would otherwise hold
  each trip's loads behind the trip before: one load in flight per
  gather instead of all of them);
- sizes and strides compile-time constants (the variant key holds them),
  32-bit offsets where every offset fits;
- a gathered index that equals, at every element, one met before it (the
  vertex itself at one end of each of its edges, on a mesh whose edges
  list their vertices in a fixed order) is that one: the tables are part
  of the variant, so the lowering compares them once (the nabla's 8 reads
  of ``pp`` a level become 5, and 4 of its 8 ``E2V`` reads go).

Built with ``nvcc`` through the cartesian backend's shared cache
(``cuda_backend.load_library``), launched through
``cuda_backend.NEIGHBOR``, whose ``launches`` counts it. A card call's
key (``otf.GraphCache.run``) builds and launches at its first call, and
captures the launch into a CUDA graph and replays it at its second (span
``gt4py.next.launch``); every later call of the key is one replay (span
``gt4py.next.replay``). Since the tables are part of the program, the
variant and graph keys hold each table's contents
(:func:`table_key`): a table rebound or rewritten in place is lowered
anew.
On CPU tensors the same DAG runs as plain ``torch`` operations
(:meth:`NeighborProgram.run_plain`).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import inspect
import itertools
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from gt4py_tpu_torch.next import foast as F
from gt4py_tpu_torch.next.common import Dimension, DimensionKind, FieldOffset, OffsetIndex

__all__ = ["Declined", "NeighborProgram", "declined", "lower", "try_call"]

#: why an operator is declined (each counted in :data:`declined`)
DECLINED_CONSTRUCT = "a construct outside the lowering's subset"
DECLINED_BUILTIN = "a builtin other than neighbor_sum, sqrt, maximum and minimum"
DECLINED_OFFSET = "an offset that is not a connectivity of fixed width"
DECLINED_SKIP = "a skip value outside a neighbor reduction"
DECLINED_DIMS = "more than one horizontal, vertical or local dimension"
DECLINED_DTYPE = "a dtype other than one of float32 and float64"
DECLINED_DOMAIN = "a domain= or a field not starting at index 0"
DECLINED_OUT = "an out that does not match the returned fields"
DECLINED_ALIAS = "an out field that shares memory with an argument read at other elements, " \
    "or with another out"
DECLINED_NO_CONNECTIVITY = "no shift through a connectivity, and a field over another " \
    "horizontal dimension than the output's"
DECLINED_CAPTURE = "a table rebound or rewritten while a CUDA graph captures"
DECLINES = (DECLINED_CONSTRUCT, DECLINED_BUILTIN, DECLINED_OFFSET, DECLINED_SKIP, DECLINED_DIMS,
            DECLINED_DTYPE, DECLINED_DOMAIN, DECLINED_OUT, DECLINED_ALIAS,
            DECLINED_NO_CONNECTIVITY, DECLINED_CAPTURE)

#: operators (variant keys) declined, by reason; a call whose table cannot
#: be read (``DECLINED_CAPTURE``), by call
declined: collections.Counter = collections.Counter()
#: ``"neighbor"`` -> the calls the lowered kernel served since the counter
#: was cleared (on CPU tensors they run its plain version; on a card each
#: is one launch of ``cuda_backend.NEIGHBOR``, eager or replayed);
#: ``"masked"`` -> those of them served by a variant whose neighbor sums
#: mask a table's skip values (:attr:`NeighborProgram.masks`)
calls_served: collections.Counter = collections.Counter()

#: lanes a horizontal element takes where the outputs' K axis is contiguous,
#: or half as many (:func:`_lanes`)
K_LANES = 32
#: threads a block (four warps: four elements, eight at 16 lanes an element):
#: the benchmark's nabla took 817 µs a call at 128 against 869 at 256 and 929
#: at 512 (H100 80GB HBM3)
BLOCK = 128
#: the widest connectivity a neighbor sum is unrolled over
MAX_WIDTH = 64
#: the most trips of the K loop unrolled with every trip's loads issued
#: first: the IEEE divisions' slow-path branches keep the compiler from
#: moving a later trip's loads above an earlier trip's arithmetic (the
#: benchmark's nabla: 817 against 981 µs a call, H100 80GB HBM3)
MAX_TRIPS = 8


class Declined(Exception):
    """The operator or call is outside the lowering's subset; ``reason`` says
    why (one of :data:`DECLINES` where the lowering declined)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


# --- the expression DAG -----------------------------------------------------------
#
# Nodes are tuples, so equal subexpressions are one node (the two components
# of the nabla share their edge averages):
#   ("const", value)                       a literal, in the program's dtype
#   ("scalar", slot)                       a scalar argument
#   ("h",)                                 the output's horizontal index
#   ("raw", conn, row, col)                a table entry (row: an index node)
#   ("valid", conn, row, col)              raw != the table's skip value
#   ("nbr", conn, row, col)                the entry, 0 where it is absent
#   ("load", field, row, col, has_k)       a field's value (col: local slot)
#   ("bin", op, a, b), ("neg", a)          op: + - * / max min
#   ("fn", name, a)                        a math function (sqrt)
#   ("sel", cond, a)                       a where cond, else 0
#   ("sum", terms), ("and", conds)


def _varies_k(node, memo: dict) -> bool:
    hit = memo.get(node)
    if hit is not None:
        return hit
    kind = node[0]
    if kind == "load":
        out = node[4]
    elif kind in ("bin",):
        out = _varies_k(node[2], memo) or _varies_k(node[3], memo)
    elif kind in ("neg",):
        out = _varies_k(node[1], memo)
    elif kind == "fn":
        out = _varies_k(node[2], memo)
    elif kind == "sel":
        out = _varies_k(node[2], memo)
    elif kind == "sum":
        out = any(_varies_k(t, memo) for t in node[1])
    else:
        out = False
    memo[node] = out
    return out


@dataclasses.dataclass(frozen=True)
class _FieldSpec:
    """A field argument's slot: its parameter, its place in a tuple
    parameter (None: the parameter itself), its dims in the tensor's
    order."""

    param: str
    index: Optional[int]
    dims: tuple

    @property
    def name(self) -> str:
        return self.param if self.index is None else f"{self.param}[{self.index}]"


@dataclasses.dataclass(frozen=True)
class _ConnSpec:
    """A connectivity's slot."""

    name: str
    width: int
    skip: Optional[int]


class _Val:
    """A field-valued FOAST expression: its horizontal, local and vertical
    dimensions, and ``at(row, local)`` building its node at the horizontal
    index node ``row`` with the local slots ``local`` ({local dim: slot});
    ``conds(row, local)`` the validity nodes of the neighbors it reads."""

    def __init__(self, hdim, local, has_k, at, conds=None, width=None):
        self.hdim = hdim
        self.local = local  # a local Dimension or None
        self.has_k = has_k
        self.at = at
        self.conds = conds or (lambda row, local: ())
        self.width = width  # the local dimension's width


class _Param:
    """A parameter of the lowered operator, given a slot where the body
    first reads it (parameters it never reads take none)."""

    def __init__(self, name: str, value):
        self.name = name
        self.value = value

    def resolve(self, lowering: "_Lowering"):
        from gt4py_tpu_torch.next.embedded import Field

        v = self.value
        if isinstance(v, Field):
            return lowering.field_arg(self.name, None, v)
        if isinstance(v, tuple) and v and all(isinstance(x, Field) for x in v):
            return tuple(lowering.field_arg(self.name, i, x) for i, x in enumerate(v))
        return lowering.scalar_arg(self.name, v)


class _Lowering:
    """The symbolic evaluation of one operator's FOAST for one call's
    argument types (:func:`lower`)."""

    def __init__(self, dtype, providers):
        self.dtype = dtype
        self.providers = providers
        self.fields: list[_FieldSpec] = []
        self.field_values: list = []
        self.conns: list[_ConnSpec] = []
        self.conn_objects: list = []
        self.conn_index: dict = {}
        self.scalars: list[str] = []
        self.depth = 0

    # -- names and values ----------------------------------------------------------

    def conn_slot(self, name: str, offset: FieldOffset) -> int:
        if name in self.conn_index:
            return self.conn_index[name]
        conn = self.providers.get(name)
        table = getattr(conn, "table", None)
        if not isinstance(table, torch.Tensor) or table.ndim != 2 \
                or not hasattr(conn, "neighbor_dim") or hasattr(conn, "sharded_gather"):
            raise Declined(DECLINED_OFFSET, f"'{name}' is {type(conn).__name__}")
        if table.dtype not in (torch.int32, torch.int64):
            raise Declined(DECLINED_OFFSET, f"'{name}' has a {table.dtype} table")
        if conn.codomain != offset.source or conn.source_dim != offset.target[0]:
            raise Declined(DECLINED_OFFSET, f"'{name}' does not map {offset.source.value}")
        width = int(table.shape[1])
        if width > MAX_WIDTH:
            raise Declined(DECLINED_OFFSET, f"'{name}' has {width} neighbors, over {MAX_WIDTH}")
        skip = conn.skip_value
        slot = len(self.conns)
        self.conns.append(_ConnSpec(name, width, None if skip is None else int(skip)))
        self.conn_objects.append(conn)
        self.conn_index[name] = slot
        return slot

    def field_arg(self, param: str, index: Optional[int], value) -> _Val:
        from gt4py_tpu_torch.next.embedded import Field

        name = param if index is None else f"{param}[{index}]"
        if not isinstance(value, Field) or not isinstance(value.ndarray, torch.Tensor):
            raise Declined(DECLINED_CONSTRUCT, f"argument '{name}' is no torch Field")
        if value.mask is not None:
            raise Declined(DECLINED_CONSTRUCT, f"argument '{name}' has a mask")
        if np.dtype(value.dtype) != self.dtype:
            raise Declined(DECLINED_DTYPE, f"'{name}' is {value.dtype}, the program {self.dtype}")
        hdims = [d for d in value.dims if d.kind == DimensionKind.HORIZONTAL]
        kdims = [d for d in value.dims if d.kind == DimensionKind.VERTICAL]
        ldims = [d for d in value.dims if d.kind == DimensionKind.LOCAL]
        # a field over K alone is a value of each level, broadcast over the
        # horizontal dimension (ICON's vertical profiles)
        k_only = not hdims and len(kdims) == 1 and not ldims
        if (len(hdims) != 1 and not k_only) or len(kdims) > 1 or len(ldims) > 1:
            raise Declined(DECLINED_DIMS, f"argument '{name}' over {value.dims}")
        if any(r.unit_range.start != 0 for r in value.domain.ranges):
            raise Declined(DECLINED_DOMAIN, f"argument '{name}' over {value.domain}")
        slot = len(self.fields)
        self.fields.append(_FieldSpec(param, index, tuple(value.dims)))
        self.field_values.append(value)
        local = ldims[0] if ldims else None
        has_k = bool(kdims)
        width = int(value.domain[local].unit_range.stop) if local is not None else None

        def at(row, loc):
            col = loc[local] if local is not None else None
            return ("load", slot, row, col, has_k)

        return _Val(hdims[0] if hdims else None, local, has_k, at, width=width)

    def scalar_arg(self, name: str, value):
        if isinstance(value, (bool, np.bool_)) or not isinstance(value, (int, float, np.floating)):
            raise Declined(DECLINED_CONSTRUCT,
                           f"scalar argument '{name}' of {type(value).__name__}")
        if isinstance(value, np.floating) and np.dtype(type(value)) != self.dtype:
            raise Declined(DECLINED_DTYPE, f"scalar '{name}' is {np.dtype(type(value))}")
        self.scalars.append(name)
        return ("scalar", len(self.scalars) - 1)

    # -- the FOAST walk ----------------------------------------------------------------

    def run(self, definition, env: dict):
        """The value ``definition``'s body returns, its parameters bound in
        ``env``."""
        self.depth += 1
        if self.depth > 16:
            raise Declined(DECLINED_CONSTRUCT, "operators nested over 16 deep")
        try:
            ir = F.func_to_foast(definition)
        except F.FoastUnsupported as exc:
            raise Declined(DECLINED_CONSTRUCT, str(exc)) from None
        names = {**getattr(definition, "__globals__", {}), **F._closure_map(definition)}
        scope = dict(env)
        for stmt in ir.body:
            if isinstance(stmt, F.Assign):
                value = self.expr(stmt.value, scope, names)
                for target in stmt.targets:
                    self.bind(target, value, scope)
            elif isinstance(stmt, F.Return):
                self.depth -= 1
                return self.expr(stmt.value, scope, names)
            else:
                raise Declined(DECLINED_CONSTRUCT, type(stmt).__name__)
        raise Declined(DECLINED_CONSTRUCT, "no return")

    def bind(self, target, value, scope: dict) -> None:
        if isinstance(target, F.Name):
            scope[target.id] = value
            return
        if isinstance(target, F.TupleExpr) and isinstance(value, tuple) \
                and len(target.elts) == len(value) \
                and all(isinstance(e, F.Name) for e in target.elts):
            for e, v in zip(target.elts, value):
                scope[e.id] = v
            return
        raise Declined(DECLINED_CONSTRUCT, "an assignment target")

    def expr(self, e, scope: dict, names: dict):
        if isinstance(e, F.Name):
            if e.id in scope:
                value = scope[e.id]
                if isinstance(value, _Param):
                    value = scope[e.id] = value.resolve(self)
                return value
            if e.id in names:
                value = names[e.id]
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    return ("const", float(value))
                return ("global", value)
            raise Declined(DECLINED_CONSTRUCT, f"name '{e.id}'")
        if isinstance(e, F.Literal):
            if isinstance(e.value, bool) or not isinstance(e.value, (int, float)):
                raise Declined(DECLINED_CONSTRUCT, f"literal {e.value!r}")
            return ("const", float(e.value))
        if isinstance(e, F.TupleExpr):
            return tuple(self.expr(x, scope, names) for x in e.elts)
        if isinstance(e, F.BinOp):
            if e.op not in "+-*/" or len(e.op) != 1:
                raise Declined(DECLINED_CONSTRUCT, f"operator {e.op}")
            return self.binary(e.op, self.expr(e.left, scope, names),
                               self.expr(e.right, scope, names))
        if isinstance(e, F.UnaryOp):
            value = self.expr(e.operand, scope, names)
            if e.op == "+":
                return self.numeric(value)
            if e.op == "-":
                return self.unary(value)
            raise Declined(DECLINED_CONSTRUCT, f"operator {e.op}")
        if isinstance(e, F.Subscript):
            base = self.expr(e.value, scope, names)
            if not isinstance(e.index, F.Literal) or not isinstance(e.index.value, int):
                raise Declined(DECLINED_CONSTRUCT, "a subscript that is not an integer literal")
            if isinstance(base, tuple) and base and base[0] == "global" \
                    and isinstance(base[1], FieldOffset):
                return ("global", base[1][e.index.value])
            if isinstance(base, tuple) and not _is_node(base):
                return base[e.index.value]
            raise Declined(DECLINED_CONSTRUCT, "a subscript")
        if isinstance(e, F.Call):
            return self.call(e, scope, names)
        raise Declined(DECLINED_CONSTRUCT, type(e).__name__)

    def numeric(self, value):
        if isinstance(value, _Val) or _is_node(value):
            return value
        raise Declined(DECLINED_CONSTRUCT, "arithmetic on a value that is no field or number")

    def binary(self, op: str, a, b):
        return self.combine(("bin", op), (a, b), op)

    def unary(self, value):
        return self.combine(("neg",), (value,), "-")

    def combine(self, head: tuple, operands: tuple, what: str):
        """The node ``head + operands`` of numbers and field values: a field
        value where any operand is one, over the operands' horizontal
        dimension (a field over ``K`` alone takes the others') and local
        dimension."""
        operands = tuple(self.numeric(v) for v in operands)
        vals = [v for v in operands if isinstance(v, _Val)]
        if not vals:
            return head + operands
        hdims = {v.hdim for v in vals if v.hdim is not None}
        locals_ = {v.local for v in vals if v.local is not None}
        if len(hdims) > 1 or len(locals_) > 1:
            raise Declined(DECLINED_DIMS,
                           f"{what} of fields over {sorted(d.value for d in hdims)}")
        widths = {v.width for v in vals if v.local is not None}
        if len(widths) > 1:
            raise Declined(DECLINED_DIMS, f"{what} over local dimensions of widths {widths}")

        def at(row, loc):
            return head + tuple(v.at(row, loc) if isinstance(v, _Val) else v for v in operands)

        def conds(row, loc):
            return tuple(c for v in vals for c in v.conds(row, loc))

        return _Val(hdims.pop() if hdims else None, locals_.pop() if locals_ else None,
                    any(v.has_k for v in vals), at, conds, widths.pop() if widths else None)

    def call(self, e, scope: dict, names: dict):
        from gt4py_tpu_torch.next import fbuiltins

        func = self.expr(e.func, scope, names)
        if isinstance(func, _Val):
            if e.kwargs or not e.args:
                raise Declined(DECLINED_CONSTRUCT, "a shift with keywords")
            value = func
            for a in e.args:
                value = self.shift(value, self.expr(a, scope, names))
            return value
        target = func[1] if isinstance(func, tuple) and func and func[0] == "global" else None
        if target is fbuiltins.neighbor_sum:
            args = [self.expr(a, scope, names) for a in e.args]
            kwargs = {k: self.expr(v, scope, names) for k, v in e.kwargs.items()}
            if len(args) == 2 and "axis" not in kwargs:
                kwargs["axis"] = args.pop()
            if len(args) != 1 or set(kwargs) != {"axis"}:
                raise Declined(DECLINED_CONSTRUCT, "neighbor_sum's arguments")
            axis = kwargs["axis"]
            axis = axis[1] if isinstance(axis, tuple) and axis and axis[0] == "global" else None
            return self.reduce(args[0], axis)
        head = next((h for f, h in ((fbuiltins.sqrt, ("fn", "sqrt")),
                                    (fbuiltins.maximum, ("bin", "max")),
                                    (fbuiltins.minimum, ("bin", "min"))) if target is f), None)
        if head is not None:
            args = tuple(self.expr(a, scope, names) for a in e.args)
            if e.kwargs or len(args) != (1 if head[0] == "fn" else 2):
                raise Declined(DECLINED_CONSTRUCT, f"'{target.__name__}''s arguments")
            return self.combine(head, args, target.__name__)
        definition = getattr(target, "definition", None)
        if definition is not None and hasattr(target, "transform_options") \
                and not hasattr(target, "axis"):
            args = [self.expr(a, scope, names) for a in e.args]
            kwargs = {k: self.expr(v, scope, names) for k, v in e.kwargs.items()}
            try:
                bound = inspect.signature(definition).bind(*args, **kwargs)
            except TypeError as exc:
                raise Declined(DECLINED_CONSTRUCT, f"a call of {target}: {exc}") from None
            bound.apply_defaults()
            return self.run(definition, dict(bound.arguments))
        name = getattr(target, "__name__", type(target).__name__)
        raise Declined(DECLINED_BUILTIN, f"'{name}'")

    def shift(self, value: _Val, offset):
        offset = offset[1] if isinstance(offset, tuple) and offset and offset[0] == "global" \
            else offset
        if isinstance(offset, OffsetIndex):
            fo, index = offset.offset, offset.index
        elif isinstance(offset, FieldOffset):
            fo, index = offset, None
        else:
            raise Declined(DECLINED_OFFSET, f"{offset!r}")
        if fo.source == fo.target[0] or len(fo.target) != 2:
            raise Declined(DECLINED_OFFSET, f"'{fo.value}' is cartesian")
        if value.hdim not in (fo.source, None):
            raise Declined(DECLINED_DIMS, f"'{fo.value}' shifts a field over {value.hdim.value}")
        slot = self.conn_slot(fo.value, fo)
        spec = self.conns[slot]
        local_dim = fo.target[1]
        if index is not None:
            if spec.skip is not None:
                raise Declined(DECLINED_SKIP, f"'{fo.value}[{index}]'")
            if not 0 <= index < spec.width:
                raise Declined(DECLINED_OFFSET, f"'{fo.value}[{index}]' of {spec.width}")
            return _Val(fo.target[0], value.local, value.has_k,
                        lambda row, loc: value.at(("nbr", slot, row, index), loc),
                        lambda row, loc: value.conds(("nbr", slot, row, index), loc),
                        value.width)
        if value.local is not None:
            raise Declined(DECLINED_DIMS, f"'{fo.value}' of a field over a local dimension")

        def at(row, loc):
            return value.at(("nbr", slot, row, loc[local_dim]), loc)

        def conds(row, loc):
            col = loc[local_dim]
            own = (("valid", slot, row, col),) if spec.skip is not None else ()
            return own + value.conds(("nbr", slot, row, col), loc)

        return _Val(fo.target[0], local_dim, value.has_k, at, conds, spec.width)

    def reduce(self, value, axis) -> _Val:
        if not isinstance(value, _Val) or not isinstance(axis, Dimension) \
                or value.local != axis or value.width is None:
            raise Declined(DECLINED_CONSTRUCT, "neighbor_sum of no field over its axis")

        def at(row, loc):
            terms = []
            for n in range(value.width):
                inner = {**loc, axis: n}
                term = value.at(row, inner)
                conds = tuple(dict.fromkeys(value.conds(row, inner)))
                if conds:
                    term = ("sel", conds[0] if len(conds) == 1 else ("and", conds), term)
                terms.append(term)
            return ("sum", tuple(terms))

        return _Val(value.hdim, None, value.has_k, at)


def _is_node(value) -> bool:
    return isinstance(value, tuple) and bool(value) and isinstance(value[0], str) \
        and value[0] in ("const", "scalar", "bin", "neg", "fn")


# --- the program ------------------------------------------------------------------


@dataclasses.dataclass
class NeighborProgram:
    """One operator lowered for one argument signature: its parameters'
    slots, connectivities and scalars, the output nodes (one a returned
    field, at the output's horizontal index ``("h",)`` and a level), the
    outputs' dimensions and sizes, the layout baked into the kernel, and
    the generated source."""

    name: str
    dtype: np.dtype
    fields: list
    conns: list
    scalars: list
    outputs: list
    hdim: Dimension
    kdim: Optional[Dimension]
    nh: int
    nk: int
    lanes: int
    #: element strides baked into the kernel: (horizontal, local, vertical)
    #: a field, (horizontal, vertical) an output, (row, column) a table
    field_strides: list = dataclasses.field(default_factory=list)
    out_strides: list = dataclasses.field(default_factory=list)
    table_strides: list = dataclasses.field(default_factory=list)
    #: the kernel's index type: ``int`` where every offset fits in 32 bits
    index: str = "long long"
    #: the field slots read only at the output's own element
    #: (:func:`_read_at_own_element`)
    own_only: frozenset = frozenset()
    #: (field slot, out index) pairs that share one buffer as the same view
    #: (:meth:`aliased`): their pointers are not ``__restrict__``
    aliases: tuple = ()
    #: the variant key it was lowered for (:func:`variant_key`)
    key: Any = None
    kernel: str = ""
    source: str = ""
    _fn: Any = dataclasses.field(default=None, repr=False)
    _aliased: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def masks(self) -> bool:
        """Whether its neighbor sums mask skip values: a table with a skip
        value is read only under a neighbor sum (``DECLINED_SKIP``)."""
        return any(c.skip is not None for c in self.conns)

    def aliased(self, pairs: tuple) -> "NeighborProgram":
        """This program where each (field slot, out index) of ``pairs`` is one
        buffer, the same view: each slot is one of :attr:`own_only`, so a
        thread writes the element only after reading it; the generated
        kernel reads such a field through a plain pointer (no ``__ldg``,
        no ``__restrict__``)."""
        if not pairs:
            return self
        hit = self._aliased.get(pairs)
        if hit is None:
            hit = dataclasses.replace(self, aliases=pairs, _fn=None, _aliased={})
            hit.source, hit.kernel = generate(hit)
            self._aliased[pairs] = hit
        return hit

    # -- binding a call -------------------------------------------------------------

    def tensors(self, values: list, outs: list, providers: dict, device) -> tuple:
        """(field tensors as (H, [L], [K]) views, out tensors as (H, K)
        views, the int64 tables on ``device``)."""
        from gt4py_tpu_torch.next.embedded import device_index

        ins = [_canonical(v, spec.dims) for v, spec in zip(values, self.fields)]
        outs = [_canonical(o, tuple(o.dims)) for o in outs]
        outs = [o if o.ndim == 2 else o.unsqueeze(1) for o in outs]
        tables = [device_index(providers[c.name], device) for c in self.conns]
        return ins, outs, tables

    def run_plain(self, values, outs, scalars, providers) -> None:
        """The plain ``torch`` version: the DAG's nodes as tensor operations
        in the kernel's order, the sums over neighbors added one by one."""
        device = outs[0].ndarray.device
        ins, out_t, tables = self.tensors(values, outs, providers, device)
        tdtype = _torch_dtype(self.dtype)
        h = torch.arange(self.nh, device=device)
        memo: dict = {}

        def ev(node):
            hit = memo.get(node)
            if hit is not None:
                return hit
            kind = node[0]
            if kind == "const":
                out = torch.tensor(node[1], dtype=tdtype, device=device)
            elif kind == "scalar":
                out = torch.tensor(float(scalars[node[1]]), dtype=tdtype, device=device)
            elif kind == "h":
                out = h
            elif kind in ("raw", "valid", "nbr"):
                table = tables[node[1]]
                raw = table[ev(node[2]), node[3]]
                skip = self.conns[node[1]].skip
                if kind == "raw" or skip is None:
                    out = raw
                elif kind == "valid":
                    out = raw != skip
                else:
                    out = torch.where(raw != skip, raw, torch.zeros_like(raw))
            elif kind == "load" and not any(d.kind == DimensionKind.HORIZONTAL
                                            for d in self.fields[node[1]].dims):
                out = ins[node[1]][:self.nk].unsqueeze(0)  # a field over K alone
            elif kind == "load":
                t = ins[node[1]][ev(node[2])]
                if node[3] is not None:
                    t = t[:, node[3]]
                out = t[:, :self.nk] if node[4] else t.unsqueeze(1)
            elif kind == "bin":
                a, b = ev(node[2]), ev(node[3])
                out = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
                       "max": torch.maximum, "min": torch.minimum}[node[1]](a, b)
            elif kind == "neg":
                out = torch.neg(ev(node[1]))
            elif kind == "fn":
                out = {"sqrt": torch.sqrt}[node[1]](ev(node[2]))
            elif kind == "sel":
                cond = ev(node[1])
                value = ev(node[2])
                cond = cond.reshape(cond.shape + (1,) * (value.dim() - cond.dim()))
                out = torch.where(cond, value, torch.zeros((), dtype=tdtype, device=device))
            elif kind == "and":
                out = ev(node[1][0])
                for c in node[1][1:]:
                    out = out & ev(c)
            elif kind == "sum":
                # the kernel's order: the neighbors added one by one
                out = _as_rows(ev(node[1][0]), self.nh)
                for t in node[1][1:]:
                    out = out + _as_rows(ev(t), self.nh)
            else:
                out = h
            memo[node] = out
            return out

        results = [_as_rows(ev(node), self.nh) for node in self.outputs]
        for t, r in zip(out_t, results):
            t.copy_(r.expand(t.shape))

    # -- the kernel ---------------------------------------------------------------

    def launcher(self):
        """The built launcher (``nvcc`` once per source, through the shared
        cache)."""
        if self._fn is None:
            from gt4py_tpu_torch.cartesian.backend import cuda_backend

            lib = cuda_backend.load_library(self.source)
            fn = getattr(lib, f"{self.kernel}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
                           ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def prepare(self, values, outs, scalars, providers, device) -> Callable[[], int]:
        """The launch on these buffers, packed once: calling it launches the
        kernel on the current stream and returns the kernels launched. The
        buffers' strides are the ones baked into the kernel (the variant
        key holds them)."""
        from gt4py_tpu_torch.cartesian.backend import cuda_backend

        ins, out_t, tables = self.tensors(values, outs, providers, device)
        if [_strides(t, s.dims) for t, s in zip(ins, self.fields)] != self.field_strides \
                or [tuple(t.stride()) for t in out_t] != self.out_strides \
                or [tuple(t.stride()) for t in tables] != self.table_strides:
            raise ValueError(f"{self.name}: buffers laid out unlike the kernel's variant")
        ptrs = (ctypes.c_void_p * (len(ins) + len(out_t) + len(tables)))(
            *[t.data_ptr() for t in ins + out_t + tables])
        c_scalars = (ctypes.c_double * max(len(scalars), 1))(*[float(s) for s in scalars])
        fn = self.launcher()
        keep = (ins, out_t, tables)

        def launch() -> int:
            stream = torch.cuda.current_stream(device).cuda_stream
            with torch.cuda.device(device):
                launched = cuda_backend.NEIGHBOR.launch(fn, (ptrs, c_scalars, stream))
            assert keep is not None
            return launched

        return launch


def _strides(t: torch.Tensor, dims: tuple) -> tuple:
    """(horizontal, local, vertical) element strides of a canonical field
    view, 0 for an absent dimension."""
    kinds = {d.kind for d in dims}
    it = iter(t.stride())
    return tuple(next(it) if kind in kinds else 0
                 for kind in (DimensionKind.HORIZONTAL, DimensionKind.LOCAL,
                              DimensionKind.VERTICAL))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[dtype]


def _as_rows(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``t`` as (nh, levels): a 0-d value broadcast over the elements."""
    if t.dim() == 0:
        return t.reshape(1, 1).expand(nh, 1)
    return t


def _canonical(field, dims: tuple) -> torch.Tensor:
    """The field's tensor as a view in (horizontal, local, vertical) order
    (the present ones)."""
    order = sorted(range(len(dims)), key=lambda i: {
        DimensionKind.HORIZONTAL: 0, DimensionKind.LOCAL: 1, DimensionKind.VERTICAL: 2}[
        dims[i].kind])
    t = field.ndarray
    return t.permute(order) if order != sorted(order) else t


# --- lowering ---------------------------------------------------------------------


def _out_fields(out) -> list:
    from gt4py_tpu_torch.next.embedded import Field

    fields = list(out) if isinstance(out, tuple) else [out]
    if not fields or not all(isinstance(f, Field) and isinstance(f.ndarray, torch.Tensor)
                             for f in fields):
        raise Declined(DECLINED_OUT, "out is not a Field or a flat tuple of Fields")
    return fields


def _program_dtype(values: list) -> np.dtype:
    from gt4py_tpu_torch.next.embedded import Field

    found = {np.dtype(v.dtype) for v in values
             if isinstance(v, Field) and np.dtype(v.dtype).kind == "f"}
    if len(found) != 1 or not found <= {np.dtype(np.float32), np.dtype(np.float64)}:
        raise Declined(DECLINED_DTYPE, f"fields of {sorted(str(d) for d in found)}")
    return found.pop()


def bind(definition, args, kwargs) -> inspect.BoundArguments:
    try:
        bound = inspect.signature(definition).bind(*args, **kwargs)
    except TypeError as exc:
        raise Declined(DECLINED_CONSTRUCT, str(exc)) from None
    bound.apply_defaults()
    return bound


def lower(op, args, kwargs, out, providers, name: Optional[str] = None) -> NeighborProgram:
    """``op`` (a field operator) lowered for this call's argument types, its
    source generated (a build span ``gt4py.build.codegen``, ``kind``
    "unstructured"); raises :class:`Declined`, the reason counted."""
    from gt4py_tpu_torch.instrumentation.spans import Span
    from gt4py_tpu_torch.next.embedded import Field

    definition = getattr(op, "definition", op)
    name = name or getattr(definition, "__name__", "operator")
    with Span("gt4py.build.codegen", always=True, stencil=name, kind="unstructured"):
        try:
            outs = _out_fields(out)
            bound = bind(definition, args, kwargs)
            values = list(bound.arguments.items())
            lowering = _Lowering(_program_dtype([v for _, v in values] + outs), providers or {})
            env = {pname: _Param(pname, v) for pname, v in values}
            result = lowering.run(definition, env)
            program = _assemble(name, lowering, result, outs)
        except Declined as exc:
            declined[exc.reason] += 1
            raise
    program.key = variant_key(args, kwargs, out, None, table_key(providers))
    return program


def _assemble(name: str, lowering: _Lowering, result, outs: list) -> NeighborProgram:
    results = list(result) if isinstance(result, tuple) and not _is_node(result) else [result]
    if len(results) != len(outs):
        raise Declined(DECLINED_OUT, f"{len(results)} returned fields, {len(outs)} out fields")
    dims = tuple(outs[0].dims)
    hdims = [d for d in dims if d.kind == DimensionKind.HORIZONTAL]
    kdims = [d for d in dims if d.kind == DimensionKind.VERTICAL]
    if len(hdims) != 1 or len(kdims) > 1 or len(dims) != len(hdims) + len(kdims):
        raise Declined(DECLINED_DIMS, f"out over {dims}")
    domain = outs[0].domain
    for o in outs:
        if tuple(o.dims) != dims or o.domain != domain:
            raise Declined(DECLINED_OUT, "out fields over different domains")
        if np.dtype(o.dtype) != lowering.dtype:
            raise Declined(DECLINED_DTYPE, f"an out field of {o.dtype}")
    if any(r.unit_range.start != 0 for r in domain.ranges):
        raise Declined(DECLINED_DOMAIN, f"out over {domain}")
    hdim, kdim = hdims[0], (kdims[0] if kdims else None)
    if not lowering.conns and any(
            d.kind == DimensionKind.HORIZONTAL and d != hdim
            for spec in lowering.fields for d in spec.dims):
        raise Declined(DECLINED_NO_CONNECTIVITY)
    nh = len(domain[hdim].unit_range)
    nk = len(domain[kdim].unit_range) if kdim is not None else 1
    nodes = []
    for r in results:
        if _is_node(r):
            raise Declined(DECLINED_OUT, "a returned scalar")
        if not isinstance(r, _Val) or r.local is not None or r.hdim not in (hdim, None) \
                or (r.has_k and kdim is None):
            raise Declined(DECLINED_OUT, "a returned value that is not a field over the out's "
                                         "dimensions")
        nodes.append(r.at(("h",), {}))
    nodes = _merge_equal_indices(nodes, lowering, hdim, nh)
    for v, spec in zip(lowering.field_values, lowering.fields):
        for d in spec.dims:
            if d.kind == DimensionKind.VERTICAL and (d != kdim or len(v.domain[d].unit_range) < nk):
                raise Declined(DECLINED_DOMAIN, f"'{spec.name}' over {v.domain}")
            if d == hdim and len(v.domain[d].unit_range) < nh:
                raise Declined(DECLINED_DOMAIN, f"'{spec.name}' over {v.domain}")
    ins = [_canonical(v, spec.dims) for v, spec in zip(lowering.field_values, lowering.fields)]
    out_t = [_canonical(o, dims) for o in outs]
    out_t = [t if t.ndim == 2 else t.unsqueeze(1) for t in out_t]
    tables = [tuple(c.table.shape) for c in lowering.conn_objects]
    reach = [sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride())) + 1
             for t in ins + out_t] + [rows * width for rows, width in tables]
    reach.append(nh * K_LANES + BLOCK)  # the thread index
    program = NeighborProgram(
        name=name, dtype=lowering.dtype, fields=lowering.fields, conns=lowering.conns,
        scalars=lowering.scalars, outputs=nodes, hdim=hdim, kdim=kdim, nh=nh, nk=nk,
        lanes=_lanes(nk) if out_t[0].stride(1) == 1 and nk > 1 else 1,
        field_strides=[_strides(t, spec.dims) for t, spec in zip(ins, lowering.fields)],
        out_strides=[tuple(t.stride()) for t in out_t],
        table_strides=[(width, 1) for _, width in tables],
        index="int" if max(reach) < 2**31 else "long long",
        own_only=_read_at_own_element(nodes, len(lowering.fields)))
    program.source, program.kernel = generate(program)
    return program


def _lanes(nk: int) -> int:
    """The lanes an element takes along a contiguous ``K`` of ``nk`` levels:
    ``K_LANES``, or half as many where that pads ``K`` to fewer levels in
    whole trips and keeps the trips unrolled. ICON's 80 levels take five
    trips of 16, not three of 32 whose last leaves half its lanes idle:
    each of its three gather kernels 9.6-10.1 % faster, its update as fast
    as before (H100 80GB HBM3); the nabla's 137 keep 32 (nine trips of 16
    are rolled: 1,207 against 824 µs a call)."""
    half = K_LANES // 2
    trips = -(-nk // half)
    if trips <= MAX_TRIPS and trips * half < -(-nk // K_LANES) * K_LANES:
        return half
    return K_LANES


def _read_at_own_element(nodes: list, n_fields: int) -> frozenset:
    """The field slots the program reads only at the output's own element
    (row ``("h",)``, no local slot): an out that is such a field, as the
    same view, is written only where its own thread has read it."""
    others: set = set()
    seen: set = set()

    def walk(node):
        if node in seen:
            return
        seen.add(node)
        if node[0] == "load" and (node[2] != ("h",) or node[3] is not None):
            others.add(node[1])
        for c in _children(node):
            walk(c)

    for n in nodes:
        walk(n)
    return frozenset(range(n_fields)) - others


def _children(node) -> list:
    kind = node[0]
    if kind in ("raw", "valid", "nbr", "load"):
        return [node[2]]
    if kind == "bin":
        return [node[2], node[3]]
    if kind in ("neg",):
        return [node[1]]
    if kind == "fn":
        return [node[2]]
    if kind == "sel":
        return [node[1], node[2]]
    if kind in ("sum", "and"):
        return list(node[1])
    return []


def _rebuild(node, new: list):
    kind = node[0]
    if kind in ("raw", "valid", "nbr", "load"):
        return node[:2] + (new[0],) + node[3:]
    if kind == "bin":
        return node[:2] + (new[0], new[1])
    if kind == "neg":
        return (kind, new[0])
    if kind == "fn":
        return node[:2] + (new[0],)
    if kind == "sel":
        return (kind, new[0], new[1])
    if kind in ("sum", "and"):
        return (kind, tuple(new))
    return node


def _merge_equal_indices(nodes: list, lowering: _Lowering, hdim: Dimension, nh: int) -> list:
    """``nodes`` with each neighbor index that equals, at every element, one
    met before it in the same index space (the output's own index, or an
    earlier gather into the same dimension) replaced by that one. The
    tables are part of the variant, so this holds for every call of it:
    on a mesh whose edges list their vertices in a fixed order, a vertex's
    own value at each of its edges is then one load, and the table reads
    that found it are gone."""
    tables = [c.table for c in lowering.conn_objects]
    if any(c.skip is not None for c in lowering.conns) or not tables:
        return nodes
    device = tables[0].device
    if any(t.device != device for t in tables) or (
            device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        return nodes  # compared where the tables live, outside any capture
    values: dict = {("h",): torch.arange(nh, device=device)}
    space = {("h",): hdim}
    found: dict = {}
    memo: dict = {}

    def index(node):
        if node in values:
            return values[node]
        c = node[1]
        values[node] = out = tables[c][index(node[2]), node[3]].to(torch.int64)
        return out

    def rw(node):
        hit = memo.get(node)
        if hit is not None:
            return hit
        new = _rebuild(node, [rw(c) for c in _children(node)])
        if new[0] in ("nbr", "raw"):
            dim = lowering.conn_objects[new[1]].codomain
            space[new] = dim
            got = index(new)
            for other in found.get(dim, []) + ([("h",)] if dim == hdim else []):
                if other is not new and torch.equal(values[other], got):
                    new = other
                    break
            else:
                found.setdefault(dim, []).append(new)
        memo[node] = new
        return new

    return [rw(n) for n in nodes]


# --- CUDA C++ -----------------------------------------------------------------------


_BINARY = {"+": "+", "-": "-", "*": "*", "/": "/"}
#: the kernel's functions of the DAG's ``max``, ``min`` and ``fn`` nodes:
#: ``torch.maximum``/``torch.minimum`` (a NaN operand gives NaN, which bare
#: ``fmax``/``fmin`` drop) and an IEEE sqrt rounded to nearest
_FUNCTIONS = {"max": "gt_max", "min": "gt_min", "sqrt": "gt_sqrt"}
#: each helper's definition, emitted where the kernel calls it
_HELPERS = {
    "gt_max": "__device__ __forceinline__ {t} gt_max({t} a, {t} b) {{ "
              "return a != a ? a : (b != b ? b : {fmax}(a, b)); }}",
    "gt_min": "__device__ __forceinline__ {t} gt_min({t} a, {t} b) {{ "
              "return a != a ? a : (b != b ? b : {fmin}(a, b)); }}",
    "gt_sqrt": "__device__ __forceinline__ {t} gt_sqrt({t} a) {{ return {sqrt_rn}(a); }}",
    # a field the kernel also writes: a plain read, in program order
    "gt_ld": "__device__ __forceinline__ {t} gt_ld(const {t}* p) {{ return *p; }}",
}
#: a load of a field in a generated line
_LOAD = re.compile(r"\b(?:__ldg|gt_ld)\(")


def _helpers(body: str, ctype: str) -> str:
    """The definitions of the helpers ``body`` calls, for ``ctype``."""
    names = {"fmax": "fmaxf", "fmin": "fminf", "sqrt_rn": "__fsqrt_rn"} if ctype == "float" \
        else {"fmax": "fmax", "fmin": "fmin", "sqrt_rn": "__dsqrt_rn"}
    used = [h for h in _HELPERS if re.search(rf"\b{h}\(", body)]
    return "".join(_HELPERS[h].format(t=ctype, **names) + "\n" for h in used)


def _term(index: str, stride: int) -> list:
    return [] if stride == 0 else [index if stride == 1 else f"{index} * {stride}"]


def generate(program: NeighborProgram) -> tuple[str, str]:
    """(source, kernel name) of ``program``: one kernel writing every
    output, its sizes and strides compile-time constants, and its C
    launcher ``<kernel>_launch``."""
    from gt4py_tpu_torch.cartesian.backend.cuda_codegen import NOTHING_LAUNCHED

    ctype = "float" if program.dtype == np.dtype(np.float32) else "double"
    itype = program.index
    # a field that is also an out (the same view) is read through a plain
    # pointer: it is written in this kernel, so neither __ldg's read-only
    # path nor __restrict__ holds for it
    aliased_in = {slot for slot, _ in program.aliases}
    aliased_out = {i for _, i in program.aliases}
    memo_k: dict = {}
    names: dict = {}
    counter = itertools.count()
    hoisted: list[str] = []
    looped: list[str] = []

    def emit(node) -> str:
        hit = names.get(node)
        if hit is not None:
            return hit
        kind = node[0]
        if kind == "h":
            return "gt_h"
        if kind == "const":
            return f"(({ctype}){float(node[1])!r})"
        if kind == "scalar":
            return f"(({ctype})p.sc[{node[1]}])"
        var = f"t{next(counter)}"
        lines = looped if _varies_k(node, memo_k) else hoisted
        if kind in ("raw", "nbr", "valid"):
            c = node[1]
            if kind == "raw":
                rs, cs = program.table_strides[c]
                offset = " + ".join(_term(emit(node[2]), rs) + _term(f"{node[3]}", cs)) or "0"
                lines.append(f"const long long {var} = __ldg(p.c{c} + {offset});")
            else:
                raw = emit(("raw",) + node[1:])
                skip = program.conns[c].skip
                if kind == "valid":
                    lines.append(f"const bool {var} = {raw} != {skip}LL;")
                elif skip is None:
                    lines.append(f"const {itype} {var} = ({itype}){raw};")
                else:
                    lines.append(f"const {itype} {var} = {raw} != {skip}LL ? ({itype}){raw} : 0;")
        elif kind == "load":
            f = node[1]
            sh, sl, sk = program.field_strides[f]
            terms = _term(emit(node[2]), sh)
            if node[3] is not None:
                terms += _term(f"{node[3]}", sl)
            load, restrict = ("gt_ld", "") if f in aliased_in else ("__ldg", " __restrict__")
            if node[4]:
                # the row's pointer at the lane's first level, once an
                # element; a trip adds its level's offset (``@K<stride>@``)
                row = f"b{var[1:]}"
                terms += _term("gt_lane", sk)
                hoisted.append(f"const {ctype}*{restrict} {row} = p.f{f} + "
                               f"{' + '.join(terms) or '0'};")
                lines.append(f"const {ctype} {var} = {load}({row} + @K{sk}@);")
            else:
                lines.append(f"const {ctype} {var} = {load}(p.f{f} + "
                             f"{' + '.join(terms) or '0'});")
        elif kind == "bin":
            a, b = emit(node[2]), emit(node[3])
            if node[1] in _FUNCTIONS:
                lines.append(f"const {ctype} {var} = {_FUNCTIONS[node[1]]}({a}, {b});")
            else:
                lines.append(f"const {ctype} {var} = {a} {_BINARY[node[1]]} {b};")
        elif kind == "neg":
            a = emit(node[1])
            lines.append(f"const {ctype} {var} = -{a};")
        elif kind == "fn":
            a = emit(node[2])
            lines.append(f"const {ctype} {var} = {_FUNCTIONS[node[1]]}({a});")
        elif kind == "sel":
            cond, a = emit(node[1]), emit(node[2])
            lines.append(f"const {ctype} {var} = {cond} ? {a} : ({ctype})0;")
        elif kind == "and":
            conds = [emit(c) for c in node[1]]
            lines.append(f"const bool {var} = {' && '.join(conds)};")
        elif kind == "sum":
            terms = [emit(t) for t in node[1]]
            lines.append(f"{ctype} {var} = {terms[0]};")
            for t in terms[1:]:
                lines.append(f"{var} = {var} + {t};")
        else:
            raise AssertionError(node)
        names[node] = var
        return var

    stores = []
    for i, node in enumerate(program.outputs):
        value = emit(node)
        oh, ok = program.out_strides[i]
        terms = _term("gt_h", oh) + _term("gt_lane", ok)
        restrict = "" if i in aliased_out else " __restrict__"
        hoisted.append(f"{ctype}*{restrict} s{i} = p.o{i} + {' + '.join(terms) or '0'};")
        stores.append(f"s{i}[@K{ok}@] = {value};")
    members = [f"const {ctype}*{'' if i in aliased_in else ' __restrict__'} f{i};"
               for i in range(len(program.fields))]
    members += [f"{ctype}*{'' if i in aliased_out else ' __restrict__'} o{i};"
                for i in range(len(program.outputs))]
    members += [f"const long long* __restrict__ c{i};" for i in range(len(program.conns))]
    lanes, nk, nh = program.lanes, program.nk, program.nh
    trips = -(-nk // lanes)
    ragged = trips * lanes != nk
    body = [f"    {line}" for line in hoisted]
    loads = [line for line in looped if _LOAD.search(line)]
    rest = [line for line in looped if not _LOAD.search(line)]

    local = {m.group(1) for line in looped for m in [re.match(r"(?:const )?\w+ (t\d+) =", line)]
             if m}

    def trip(text: str, j: int) -> str:
        return re.sub(r"\b(t\d+)\b",
                      lambda m: f"{m.group(1)}_{j}" if m.group(1) in local else m.group(1), text)

    def level(text: str, offset) -> str:
        """``text`` at the trip whose level offset from the lane's first is
        ``offset(stride)``."""
        return re.sub(r"@K(\d+)@", lambda m: offset(int(m.group(1))), text)

    if trips <= MAX_TRIPS:
        # every trip's loads first: none waits on the division of an earlier
        # trip; the last trip's lanes past the last level load and compute
        # nothing (masked lanes spare the card's power: the benchmark's nabla
        # took 822-825 µs against 830-833 with their work clamped to the last
        # level, H100 80GB HBM3 at its 700 W limit)
        for j in range(trips):
            lines = [level(trip(line, j), lambda st, j=j: f"{j * lanes * st}") for line in loads]
            if ragged and j == trips - 1:
                body.append(f"    const bool gt_in_{j} = gt_lane + {j * lanes} < {nk};")
                lines = [re.sub(r"= ((?:__ldg|gt_ld)\(.*\));$", rf"= gt_in_{j} ? \1 : ({ctype})0;",
                                line) for line in lines]
            body += [f"    {line}" for line in lines]
        for j in range(trips):
            body.append(f"    if (gt_in_{j}) {{" if ragged and j == trips - 1 else "    {")
            body += [f"        {trip(line, j)}" for line in rest]
            body += [f"        {level(trip(st, j), lambda st, j=j: str(j * lanes * st))}"
                     for st in stores]
            body.append("    }")
    else:
        inner = "\n".join(f"            {level(line, lambda st: f'gt_j * {lanes * st}')}"
                           for line in loads + rest + stores)
        guard = f"if (gt_lane + gt_j * {lanes} < {nk}) " if ragged else ""
        body.append(f"""    #pragma unroll 4
    for ({itype} gt_j = 0; gt_j < {trips}; ++gt_j) {{
        {guard}{{
{inner}
        }}
    }}""")
    body = "\n".join(body)
    text = f"{program.name}|{ctype}|{itype}|{lanes}|{nh}|{nk}|{BLOCK}|{body}"
    key = hashlib.sha1(text.encode()).hexdigest()[:10]
    kernel = f"gt_neighbor_{re.sub(r'[^0-9A-Za-z_]', '_', program.name)}_{key}"
    n_ptr = len(members)
    assign = [f"p.f{i} = (const {ctype}*)ptrs[{i}];" for i in range(len(program.fields))]
    base = len(program.fields)
    assign += [f"p.o{i} = ({ctype}*)ptrs[{base + i}];" for i in range(len(program.outputs))]
    base += len(program.outputs)
    assign += [f"p.c{i} = (const long long*)ptrs[{base + i}];"
               for i in range(len(program.conns))]
    n_sc = max(len(program.scalars), 1)
    assign += [f"p.sc[{i}] = scalars[{i}];" for i in range(len(program.scalars))]
    struct = "\n".join(f"    {m}" for m in members + [f"double sc[{n_sc}];"])
    setup = "\n".join(f"    {a}" for a in assign)
    blocks = -(-nh * lanes // BLOCK)
    layout = ("one warp an element, its lanes along K" if lanes == K_LANES
              else f"{lanes} lanes an element along K" if lanes > 1
              else "one thread an element, its loop along K")
    source = f"""// {kernel}: the field operator '{program.name}' lowered by
// gt4py_tpu_torch/next/unstructured_codegen.py: {ctype}, {nh} elements x {nk} levels,
// {n_ptr} buffers, {itype} offsets; {layout}, what does not vary along K
// computed once an element, before the level trips.
#include <cuda_runtime.h>
{_helpers(body, ctype)}
struct GtNbrParams {{
{struct}
}};

__global__ void __launch_bounds__({BLOCK}) {kernel}(const GtNbrParams p) {{
    const {itype} gt_t = ({itype})blockIdx.x * {BLOCK} + ({itype})threadIdx.x;
    const {itype} gt_h = gt_t / {lanes};
    if (gt_h >= {nh}) return;
    const {itype} gt_lane = gt_t % {lanes};
{body}
}}

extern "C" int {kernel}_launch(void* const* ptrs, const double* scalars, void* stream) {{
    GtNbrParams p;
{setup}
    if ({blocks}LL == 0) return {NOTHING_LAUNCHED};
    {kernel}<<<{blocks}, {BLOCK}, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}}
"""
    if blocks > 2**31 - 1:
        raise Declined(DECLINED_DIMS, f"{program.nh} elements need {blocks} blocks")
    return source, kernel


# --- the call -----------------------------------------------------------------------


def _signature(value) -> Any:
    """The part of a variant key for ``value``: a Field's dims, dtype,
    domain and strides (baked into the kernel); a scalar's type; a tuple's
    members'."""
    from gt4py_tpu_torch.next.embedded import Field

    if isinstance(value, Field):
        t = value.ndarray
        strides = tuple(t.stride()) if isinstance(t, torch.Tensor) else None
        return (Field, value.domain, str(value.dtype), value.mask is None, strides)
    if isinstance(value, tuple):
        return (tuple, tuple(_signature(v) for v in value))
    if isinstance(value, np.generic):
        return (type(value), value.dtype.str)
    return (type(value),)


def _table_fingerprint(conn) -> Optional[str]:
    """A hash of ``conn.table``'s contents, kept on the connectivity with the
    table it was taken of for as long as ``conn.table`` is that tensor,
    unmodified (its version counter), as ``embedded.device_index`` keeps
    its cast: a rebound or rewritten table is hashed anew. None where that
    would read a card table while a CUDA graph captures."""
    table = conn.table
    hit = conn.__dict__.get("_gt_table_fingerprint")
    if hit is not None and hit[0] is table and hit[1] == table._version:
        return hit[2]
    if table.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return None
    fp = hashlib.blake2b(table.cpu().numpy().tobytes(), digest_size=16).hexdigest()
    conn.__dict__["_gt_table_fingerprint"] = (table, table._version, fp)
    return fp


def table_key(providers) -> Optional[tuple]:
    """Each connectivity's part of a key: its structure
    (``otf._provider_fingerprint``) and its table's contents, shape and
    dtype, which the program's merged gathers are built on; None where a
    table cannot be read (:func:`_table_fingerprint`)."""
    from gt4py_tpu_torch.next.otf import _provider_fingerprint

    parts = []
    for name in sorted(providers or {}):
        conn = providers[name]
        if isinstance(getattr(conn, "table", None), torch.Tensor):
            fp = _table_fingerprint(conn)
            if fp is None:
                return None
            parts.append((name, _provider_fingerprint(conn), fp, tuple(conn.table.shape),
                          str(conn.table.dtype)))
    return tuple(parts)


def variant_key(args, kwargs, out, dom, tables: Optional[tuple]) -> tuple:
    """What a lowered program depends on besides the operator: the
    arguments' and out's signatures, ``domain=`` given or not, and the
    connectivities' :func:`table_key`."""
    return (tuple(_signature(a) for a in args),
            tuple(sorted((k, _signature(v)) for k, v in kwargs.items())),
            _signature(out), dom is not None, tables)


def _call_values(program: NeighborProgram, bound: inspect.BoundArguments) -> tuple[list, list]:
    """The call's field values in the program's slots, and its scalars."""
    args = bound.arguments
    values = [args[f.param] if f.index is None else args[f.param][f.index]
              for f in program.fields]
    return values, [args[name] for name in program.scalars]


def _aliases(program: NeighborProgram, values: list, outs: list) -> Optional[tuple]:
    """The (field slot, out index) pairs whose buffers overlap, where each
    is the same view and the field one the program reads only at the
    output's own element (:attr:`NeighborProgram.own_only`); None where
    any other overlap involves an out."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import overlapping

    tensors = {f"in{i}": v.ndarray for i, v in enumerate(values)}
    tensors.update({f"out{i}": o.ndarray for i, o in enumerate(outs)})
    pairs = []
    for a, b in overlapping(tensors):
        if not (a.startswith("out") or b.startswith("out")):
            continue
        (f, o) = (a, b) if a.startswith("in") else (b, a)
        if not f.startswith("in"):
            return None  # two outs share memory
        slot, i = int(f[2:]), int(o[3:])
        t_in, t_out = tensors[f], tensors[o]
        same = values[slot].dims == outs[i].dims and t_in.data_ptr() == t_out.data_ptr() \
            and t_in.shape == t_out.shape and t_in.stride() == t_out.stride()
        if not same or slot not in program.own_only:
            return None
        pairs.append((slot, i))
    return tuple(sorted(pairs))


def _graphs(op):
    from gt4py_tpu_torch.next import otf

    graphs = op.__dict__.get("_neighbor_graphs")
    if graphs is None:
        graphs = op.__dict__["_neighbor_graphs"] = otf.GraphCache("field_operator")
    return graphs


def launches_on(device: torch.device) -> bool:
    """Whether a call on ``device`` launches the kernel (a CUDA card)."""
    return device.type == "cuda"


def try_call(op, args, kwargs, out, dom, providers, make: Optional[Callable] = None) -> bool:
    """Run a field operator's call through its lowered program; False where
    the lowering declines it (the call then runs embedded). ``op`` holds
    the caches (a FieldOperator, or an ahead-of-time executable's) and its
    ``definition``. The program of each variant key (:func:`variant_key`)
    is made once, by ``make()`` (default: :func:`lower`), a decline cached
    as None. On card tensors a key of :func:`otf.graph_key` and
    :func:`table_key` is served by ``otf.GraphCache.run`` (span
    ``gt4py.next.launch``): its first call launches the kernel, its second
    captures the launch and replays it; every later call is one replay
    (span ``gt4py.next.replay``). Within an enclosing capture the kernel
    is launched into it. On CPU tensors the plain version runs."""
    from gt4py_tpu_torch.instrumentation.spans import span
    from gt4py_tpu_torch.next import otf

    tables = table_key(providers)
    if tables is None:
        declined[DECLINED_CAPTURE] += 1
        return False
    key, device, refusal, keeps = otf.graph_key((args, kwargs, out, dom), providers)
    on_card = device is not None and launches_on(device)
    graphs = None
    # not otf.serve: the lowering may decline between the replay and the run
    if on_card and refusal is None and not otf.inline(device):
        graphs = _graphs(op)
        # an int64 card table rewritten in place keeps its address: the
        # contents name it
        key = (key, tables)
        graph = graphs.find(key, device)
        if graph is not None:
            with span("gt4py.next.replay") as replay_span:
                replay_span.set("launches", graphs.replay(graph))
            _served(tables in op.__dict__.get("_neighbor_masked", ()))
            return True
    cache = op.__dict__.setdefault("_neighbor_cache", {})
    vkey = variant_key(args, kwargs, out, dom, tables)
    program = cache.get(vkey, _UNSEEN)
    if program is _UNSEEN:
        try:
            if dom is not None:
                declined[DECLINED_DOMAIN] += 1
                raise Declined(DECLINED_DOMAIN)
            program = (make or (lambda: lower(op, args, kwargs, out, providers)))()
        except Declined:
            program = None
        cache[vkey] = program
    if program is None:
        return False
    bound = bind(getattr(op, "definition", op), args, kwargs)
    values, scalars = _call_values(program, bound)
    outs = _out_fields(out)
    if not on_card:
        if device is not None:  # a card the lowering cannot launch on
            return False
        program.run_plain(values, outs, scalars, providers)
        _served(program.masks)
        return True
    aliases = _aliases(program, values, outs)
    if aliases is None:
        declined[DECLINED_ALIAS] += 1
        return False
    launch = program.aliased(aliases).prepare(values, outs, scalars, providers, device)
    if graphs is None:
        if refusal is not None:
            otf.refuse(refusal)
        launch()
        _served(program.masks)
        return True
    if program.masks:  # so are its graph's replays: whether it masks, its tables say
        op.__dict__.setdefault("_neighbor_masked", set()).add(tables)
    with span("gt4py.next.launch") as launch_span:
        launch_span.set("launches", graphs.run(key, device, keeps, launch))
    _served(program.masks)
    return True


def _served(masked: bool) -> None:
    """Count a call the lowered kernel served (:data:`calls_served`)."""
    calls_served["neighbor"] += 1
    if masked:
        calls_served["masked"] += 1


_UNSEEN = object()

