"""Field-view core model: dimensions, ranges, domains, connectivities.

Counterpart of the reference's ``gt4py.next.common``
(src/gt4py/next/common.py:79,197,433,749,991): the same
concepts — ``Dimension`` (HORIZONTAL/VERTICAL/LOCAL), ``UnitRange``,
``Domain``, ``Field``, ``Connectivity`` — with the single concrete field
implementation living on torch tensors (embedded.py).

Copied from gt4py_tpu/next/common.py; imports renamed. The connectivity
tables are torch tensors, on the card unless the caller says otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
import operator
import typing
from typing import Any, Iterator, Optional, Sequence, Union


class DimensionKind(enum.Enum):
    HORIZONTAL = "horizontal"
    VERTICAL = "vertical"
    LOCAL = "local"


def _is_plain_int(v: Any) -> bool:
    """A Python or NumPy integer (bools excluded) — valid as a domain
    coordinate in dimension comparisons (``KDim < nlev - 1`` where nlev
    arrives as np.int32, reference test_concat_where.py:85)."""
    import numpy as np

    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


@dataclasses.dataclass(frozen=True, eq=False)
class Dimension:
    value: str
    kind: DimensionKind = DimensionKind.HORIZONTAL

    def __str__(self) -> str:
        return f"{self.value}[{self.kind.value}]"

    # Reference parity (common.py:86): ``KDim(0)`` is a NamedIndex — an
    # absolute coordinate usable in field restriction (``f[V2EDim(0)]``
    # collapses the dimension, reference test_external_local_field.py:56).
    # Range-like arguments keep building NamedRanges for domain
    # construction: ``IDim((0, 10))``, ``IDim(range(10))``.
    def __call__(
        self, rng: Union[int, "UnitRange", range, tuple]
    ) -> Union["NamedIndex", "NamedRange"]:
        if _is_plain_int(rng):
            return NamedIndex(self, int(rng))
        return NamedRange(self, UnitRange.from_value(rng))

    def __hash__(self) -> int:
        return hash((self.value, self.kind))

    # ``I + 1`` / ``I + 0.5`` build cartesian/staggered shift
    # connectivities (reference common.py:89): ``field(I + 1)`` shifts,
    # ``field(I + 0.5)`` premaps onto the staggered counterpart.
    def __add__(self, offset) -> "CartesianConnectivity":
        return connectivity_for_cartesian_shift(self, offset)

    def __sub__(self, offset) -> "CartesianConnectivity":
        return connectivity_for_cartesian_shift(self, -offset)

    # Comparisons against integers build domain conditions for
    # ``concat_where`` (reference experimental.concat_where,
    # ffront/experimental.py:52); Dimension-to-Dimension compares stay
    # plain equality.
    def __eq__(self, other):
        if isinstance(other, Dimension):
            return self.value == other.value and self.kind == other.kind
        if _is_plain_int(other):
            return DimCondition(self, "==", other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, Dimension):
            return not self.__eq__(other)
        if _is_plain_int(other):
            return DimCondition(self, "!=", other)
        return NotImplemented

    def __lt__(self, other):
        if _is_plain_int(other):
            return DimCondition(self, "<", other)
        return NotImplemented

    def __le__(self, other):
        if _is_plain_int(other):
            return DimCondition(self, "<=", other)
        return NotImplemented

    def __gt__(self, other):
        if _is_plain_int(other):
            return DimCondition(self, ">", other)
        return NotImplemented

    def __ge__(self, other):
        if _is_plain_int(other):
            return DimCondition(self, ">=", other)
        return NotImplemented


def merge_regions(regions) -> tuple:
    """Sort, drop empties, and coalesce touching/overlapping UnitRanges."""
    rs = sorted((r for r in regions if not r.is_empty()), key=lambda r: r.start)
    out: list = []
    for r in rs:
        if out and r.start <= out[-1].stop:
            if r.stop > out[-1].stop:
                out[-1] = UnitRange(out[-1].start, r.stop)
        else:
            out.append(r)
    return tuple(out)


def complement_regions(regions) -> tuple:
    """The complement of a merged disjoint region list over (-inf, inf)."""
    rs = merge_regions(regions)
    out = []
    prev = _NEG_INF
    for r in rs:
        if r.start > prev:
            out.append(UnitRange(prev, r.start))
        prev = r.stop
    if prev < _POS_INF:
        out.append(UnitRange(prev, _POS_INF))
    return tuple(out)


def _regions_from_op(op: str, v: int) -> tuple:
    if op == "==":
        return (UnitRange(v, v + 1),)
    if op == "!=":
        return (UnitRange(_NEG_INF, v), UnitRange(v + 1, _POS_INF))
    if op == "<":
        return (UnitRange(_NEG_INF, v),)
    if op == "<=":
        return (UnitRange(_NEG_INF, v + 1),)
    if op == ">":
        return (UnitRange(v + 1, _POS_INF),)
    if op == ">=":
        return (UnitRange(v, _POS_INF),)
    raise ValueError(f"unknown comparison op {op!r}")  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class DimCondition:
    """Symbolic per-dimension index-region condition, e.g. ``KDim < 1``
    (the reference builds 1-D Domains from dimension comparisons,
    common.py Dimension.__lt__ et al.). Conditions combine with ``&`` /
    ``|`` / ``~`` into multi-region conditions
    (``(KDim < 2) | (KDim >= 5)``, reference test_concat_where.py:262).
    ``regions`` — disjoint sorted UnitRanges of domain coordinates where
    the condition holds — is the source of truth; ``op``/``value`` are
    kept for single comparisons."""

    dim: "Dimension"
    op: Optional[str] = None
    value: Optional[int] = None
    regions: tuple = ()

    def __post_init__(self):
        if self.op is not None and not self.regions:
            object.__setattr__(
                self, "regions", _regions_from_op(self.op, int(self.value))
            )
        else:
            object.__setattr__(self, "regions", merge_regions(self.regions))

    def _check(self, other: "DimCondition") -> None:
        if not isinstance(other, DimCondition):
            raise TypeError(f"cannot combine DimCondition with {other!r}")
        if other.dim != self.dim:
            raise ValueError(
                "conditions combine along one dimension only "
                f"({self.dim} vs {other.dim})"
            )

    def __and__(self, other: "DimCondition") -> "DimCondition":
        self._check(other)
        inter = tuple(
            a.intersection(b) for a in self.regions for b in other.regions
        )
        return DimCondition(self.dim, regions=inter)

    def __or__(self, other: "DimCondition") -> "DimCondition":
        self._check(other)
        return DimCondition(self.dim, regions=self.regions + other.regions)

    def __invert__(self) -> "DimCondition":
        return DimCondition(self.dim, regions=complement_regions(self.regions))


class Dims:
    """Annotation-only dimension list: ``Field[Dims[I, J], float]``
    (reference common.py ``Dims`` variadic generic). Subscripting yields
    the plain dimension tuple consumed by ``Field.__class_getitem__``."""

    def __class_getitem__(cls, dims) -> tuple["Dimension", ...]:
        if not isinstance(dims, tuple):
            dims = (dims,)
        for d in dims:
            if not isinstance(d, Dimension):
                raise TypeError(f"Dims[...] expects Dimension instances, got {d!r}")
        return dims


# Sentinel bounds for unbounded ranges (reference common.py:159 Infinity).
_NEG_INF = -(2**62)
_POS_INF = 2**62


class Infinity:
    """Named sentinel bounds for unbounded ranges (reference
    common.py:159): ``UnitRange(0, Infinity.POSITIVE)`` is the half-line
    [0, ∞). The sentinels are plain ints so range arithmetic stays in
    integer land; ``UnitRange`` pins them under shifts."""

    POSITIVE = _POS_INF
    NEGATIVE = _NEG_INF


def _fmt_bound(v: int) -> str:
    if v <= _NEG_INF:
        return "Infinity.NEGATIVE"
    if v >= _POS_INF:
        return "Infinity.POSITIVE"
    return str(v)


@dataclasses.dataclass(frozen=True)
class UnitRange:
    """Half-open integer range [start, stop) (reference common.py:197);
    may be unbounded on either side (broadcast placeholder ranges).
    Empty ranges are normalized to the canonical ``UnitRange(0, 0)`` so
    every empty range compares equal (reference semantics)."""

    start: int
    stop: int

    def __post_init__(self):
        if self.stop <= self.start:
            object.__setattr__(self, "start", 0)
            object.__setattr__(self, "stop", 0)

    @classmethod
    def infinite(cls) -> "UnitRange":
        return cls(_NEG_INF, _POS_INF)

    @property
    def is_finite(self) -> bool:
        return self.start > _NEG_INF and self.stop < _POS_INF

    def is_empty(self) -> bool:
        return self.start >= self.stop

    @classmethod
    def from_value(
        cls, value: Union[int, "UnitRange", range, tuple, None]
    ) -> "UnitRange":
        if isinstance(value, UnitRange):
            return value
        if value is None:
            return cls.infinite()
        if isinstance(value, int):
            return cls(0, value)
        if isinstance(value, range):
            if value.step != 1:
                raise ValueError("UnitRange requires step 1")
            return cls(value.start, value.stop)
        if isinstance(value, tuple) and len(value) == 2:
            lo = _NEG_INF if value[0] is None else int(value[0])
            hi = _POS_INF if value[1] is None else int(value[1])
            return cls(lo, hi)
        raise TypeError(f"Cannot build UnitRange from {value!r}")

    def __len__(self) -> int:
        if not self.is_finite:
            raise ValueError(f"Open UnitRange {self!r} has no length.")
        return max(0, self.stop - self.start)

    def __iter__(self) -> Iterator[int]:
        if not self.is_finite:
            raise ValueError(f"Cannot iterate open UnitRange {self!r}.")
        return iter(range(self.start, self.stop))

    def __getitem__(self, index: Union[int, slice]) -> Union[int, "UnitRange"]:
        if isinstance(index, slice):
            if index.step not in (None, 1):
                raise ValueError("UnitRange slices require step 1")
            start, stop, _ = index.indices(len(self))
            return UnitRange(self.start + start, self.start + stop)
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(f"UnitRange index {index} out of range")
        return self.start + index

    def __contains__(self, value: Any) -> bool:
        if isinstance(value, bool):
            return False
        try:
            v = int(operator.index(value))  # accepts numpy integers too
        except TypeError:
            return False
        return self.start <= v < self.stop

    def intersection(self, other: "UnitRange") -> "UnitRange":
        return UnitRange(max(self.start, other.start), min(self.stop, other.stop))

    __and__ = intersection

    # Subset ordering (reference common.py: ``r1 <= r2`` means r1 ⊆ r2).
    def __le__(self, other: "UnitRange") -> bool:
        return self.start >= other.start and self.stop <= other.stop

    def __lt__(self, other: "UnitRange") -> bool:
        return self <= other and self != other

    def __ge__(self, other: "UnitRange") -> bool:
        return other <= self

    def __gt__(self, other: "UnitRange") -> bool:
        return other < self

    def shifted(self, offset: int) -> "UnitRange":
        # Unbounded ends stay pinned at the sentinels under shifts.
        lo = self.start if self.start <= _NEG_INF else self.start + offset
        hi = self.stop if self.stop >= _POS_INF else self.stop + offset
        return UnitRange(lo, hi)

    def __repr__(self) -> str:
        return f"UnitRange({_fmt_bound(self.start)}, {_fmt_bound(self.stop)})"

    def __str__(self) -> str:
        return f"({self.start}:{self.stop})"


class NamedRange(typing.NamedTuple):
    """A (dimension, range) pair. A tuple subtype (reference common.py
    NamedRange is a NamedTuple) so ``(IDim, UnitRange(0, 4))`` compares
    equal to ``NamedRange(IDim, UnitRange(0, 4))``."""

    dim: Dimension
    unit_range: UnitRange

    def __str__(self) -> str:
        return f"{self.dim.value}={self.unit_range}"


class NamedIndex(typing.NamedTuple):
    """An absolute (dimension, coordinate) pair (reference common.py:370):
    restriction with a NamedIndex collapses the dimension at that
    coordinate — ``f[KDim(2)]`` reads plane 2."""

    dim: Dimension
    value: int

    def __str__(self) -> str:
        return f"{self.dim.value}={self.value}"


def named_range(value: Union["NamedRange", tuple]) -> NamedRange:
    """Coerce a ``(dim, range-like)`` pair into a NamedRange (reference
    common.named_range)."""
    if isinstance(value, NamedRange):
        return value
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[0], Dimension):
        return NamedRange(value[0], UnitRange.from_value(value[1]))
    raise TypeError(f"Cannot build NamedRange from {value!r}")


@dataclasses.dataclass(frozen=True, init=False)
class Domain:
    """Ordered set of named ranges (reference common.py:433).

    Accepted constructor forms (all reference-parity):

    - ``Domain(named_ranges_tuple)`` — a single iterable of NamedRanges
    - ``Domain(NamedRange(I, ...), NamedRange(J, ...))`` — varargs
    - ``Domain(dims=(I, J), ranges=(UnitRange(0, 2), UnitRange(0, 3)))``
    """

    ranges: tuple[NamedRange, ...] = ()

    def __init__(self, *args: Any, dims: Any = None, ranges: Any = None):
        if dims is not None or ranges is not None:
            if args:
                raise ValueError(
                    "Either provide named ranges positionally or dims=/ranges=, not both."
                )
            if dims is None or ranges is None:
                raise ValueError("dims= and ranges= must be provided together.")
            dims = tuple(dims)
            ranges = tuple(ranges)
            if len(dims) != len(ranges):
                raise ValueError(
                    f"Number of provided dimensions ({len(dims)}) does not match "
                    f"number of provided ranges ({len(ranges)})."
                )
            nrs = tuple(
                NamedRange(d, UnitRange.from_value(r)) for d, r in zip(dims, ranges)
            )
        elif len(args) == 1 and not isinstance(args[0], NamedRange):
            # legacy/primary form: one iterable of named ranges
            nrs = tuple(named_range(r) for r in args[0])
        else:
            nrs = tuple(named_range(r) for r in args)
        seen_dims = [nr.dim for nr in nrs]
        if len(set(seen_dims)) != len(seen_dims):
            raise NotImplementedError(
                f"Domain dimensions must be unique, not {seen_dims}."
            )
        object.__setattr__(self, "ranges", nrs)

    @classmethod
    def from_sizes(cls, **sizes: Any) -> "Domain":
        raise TypeError("Use domain(dim=size, ...) helper with Dimension objects")

    @property
    def dims(self) -> tuple[Dimension, ...]:
        return tuple(r.dim for r in self.ranges)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(r.unit_range) for r in self.ranges)

    @property
    def ndim(self) -> int:
        return len(self.ranges)

    def __len__(self) -> int:
        return len(self.ranges)

    def is_empty(self) -> bool:
        """True when any constituent range is empty (reference
        Domain.is_empty); the zero-dimensional domain is non-empty."""
        return any(r.unit_range.is_empty() for r in self.ranges)

    def __iter__(self) -> Iterator[NamedRange]:
        return iter(self.ranges)

    def __getitem__(self, dim: Union[int, slice, Dimension]) -> Any:
        if isinstance(dim, slice):
            return Domain(self.ranges[dim])
        if isinstance(dim, int):
            return self.ranges[dim]
        if isinstance(dim, Dimension):
            for r in self.ranges:
                if r.dim == dim:
                    return r
            raise KeyError(f"No Dimension of type {dim} is present in the Domain.")
        raise KeyError("Invalid index type, must be either int, slice, or Dimension.")

    def index(self, dim: Dimension) -> int:
        for i, r in enumerate(self.ranges):
            if r.dim == dim:
                return i
        raise KeyError(f"No Dimension of type {dim} is present in the Domain.")

    def dim_index(self, dim: Dimension) -> Optional[int]:
        """Position of ``dim``, or None when absent (reference
        Domain.dim_index non-strict mode)."""
        for i, r in enumerate(self.ranges):
            if r.dim == dim:
                return i
        return None

    def __contains__(self, item: Any) -> bool:
        if isinstance(item, Dimension):
            return any(r.dim == item for r in self.ranges)
        if isinstance(item, tuple) and len(item) == 2:
            try:
                nr = named_range(item)
            except TypeError:
                return False
            return nr in self.ranges
        return False

    def intersection(self, other: "Domain") -> "Domain":
        """Promote to the union of dims; intersect ranges of shared dims
        (reference broadcast/intersection semantics, common.py:1367)."""
        ranges = []
        for r in self.ranges:
            if r.dim in other:
                o = other[r.dim]
                ranges.append(NamedRange(r.dim, r.unit_range.intersection(o.unit_range)))
            else:
                ranges.append(r)
        for o in other.ranges:
            if o.dim not in self:
                ranges.append(o)
        return Domain(tuple(ranges))

    __and__ = intersection

    @property
    def slice_at(self) -> "_DomainSliceIndexer":
        """Relative-slice indexing: ``domain.slice_at[2:5, 0:3]`` slices
        every range by position (reference Domain.slice_at)."""
        return _DomainSliceIndexer(self)

    def pop(self, index: Union[int, Dimension] = -1) -> "Domain":
        """Domain without the given dimension/position (reference
        Domain.pop)."""
        if isinstance(index, Dimension):
            index = self.index(index)
        if index < 0:
            index += len(self.ranges)
        if not 0 <= index < len(self.ranges):
            raise IndexError(f"Domain index {index} out of range")
        return Domain(self.ranges[:index] + self.ranges[index + 1:])

    def replace(self, dim: Union[int, Dimension], *new: NamedRange) -> "Domain":
        idx = self.index(dim) if isinstance(dim, Dimension) else dim
        if idx < 0:
            idx += len(self.ranges)
        if not 0 <= idx < len(self.ranges):
            raise IndexError(f"Domain index {idx} out of range")
        new_nrs = tuple(named_range(n) for n in new)
        return Domain(self.ranges[:idx] + new_nrs + self.ranges[idx + 1:])

    def __str__(self) -> str:
        return "Domain(" + ", ".join(str(r) for r in self.ranges) + ")"


class _DomainSliceIndexer:
    """Helper backing :attr:`Domain.slice_at`."""

    def __init__(self, domain: Domain):
        self._domain = domain

    def __getitem__(self, item: Any) -> Domain:
        if not isinstance(item, tuple):
            item = (item,)
        if not all(isinstance(s, slice) for s in item):
            raise TypeError("slice_at indices must be slices")
        if len(item) != self._domain.ndim:
            raise ValueError(
                f"Number of slices ({len(item)}) does not match the number of "
                f"dimensions ({self._domain.ndim})."
            )
        new_ranges = []
        for s, nr in zip(item, self._domain.ranges):
            sub = nr.unit_range[s]
            new_ranges.append(NamedRange(nr.dim, sub))
        return Domain(tuple(new_ranges))


def check_dims(dims: Sequence["Dimension"]) -> None:
    """Reject a dimension appearing together with its staggered
    counterpart in one field/domain (reference common.py:1349 check_dims:
    they denote different grid locations; mixing is ambiguous)."""
    seen: dict[Dimension, Dimension] = {}
    for dim in dims:
        base = as_non_staggered(dim)
        if base in seen and seen[base] != dim:
            raise ValueError(
                f"Dimensions '{seen[base]}' and '{dim}' cannot be combined: a "
                "dimension and its staggered counterpart must not appear "
                "together in the same field or domain."
            )
        seen[base] = dim


def unit_range(value: Union[int, "UnitRange", range, tuple]) -> UnitRange:
    """Construct a UnitRange from any accepted spec (reference
    common.unit_range)."""
    return UnitRange.from_value(value)


def domain(spec: Union[dict, Sequence, Domain]) -> Domain:
    """Build a Domain from {dim: size-or-(start, stop)}, a sequence of
    NamedRanges / (dim, range-like) pairs, or a Domain (reference
    common.py domain constructor)."""
    if isinstance(spec, Domain):
        return spec
    if isinstance(spec, dict):
        result = Domain(
            tuple(NamedRange(d, UnitRange.from_value(v)) for d, v in spec.items())
        )
    else:
        result = Domain(tuple(named_range(r) for r in spec))
    check_dims(result.dims)
    return result


@dataclasses.dataclass(frozen=True)
class FieldOffset:
    """Named offset usable in field-operator shifts (reference
    fbuiltins.py:466): cartesian (``Ioff[1]``) when source dim == target
    dim, unstructured (``E2V``) when it maps via a connectivity."""

    value: str
    source: Dimension
    target: tuple[Dimension, ...]

    def __getitem__(self, index: int) -> "OffsetIndex":
        return OffsetIndex(self, index)

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class OffsetIndex:
    offset: FieldOffset
    index: int


class Connectivity:
    """Neighbor table: for each element of ``source_dim`` up to
    ``max_neighbors`` indices into ``codomain`` (reference common.py:991).
    ``skip_value`` marks missing neighbors."""

    def __init__(
        self,
        table: Any,
        *,
        domain_dims: tuple[Dimension, Dimension],
        codomain: Dimension,
        skip_value: Optional[int] = None,
        device: Any = None,
    ):
        import torch

        if isinstance(table, torch.Tensor):
            self.table = table if device is None else table.to(device)
        else:
            import numpy as np

            self.table = torch.as_tensor(np.asarray(table), device=device or "cuda")
        self.domain_dims = domain_dims  # (source dim, local neighbor dim)
        self.codomain = codomain
        self.skip_value = skip_value

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_gt_index", None)  # the embedded gathers' cast tables, by device
        return state

    @property
    def source_dim(self) -> Dimension:
        return self.domain_dims[0]

    @property
    def neighbor_dim(self) -> Dimension:
        return self.domain_dims[1]

    @property
    def max_neighbors(self) -> int:
        return self.table.shape[1]

    def __repr__(self) -> str:
        return (
            f"Connectivity({self.source_dim.value}->{self.codomain.value}, "
            f"shape={tuple(self.table.shape)}, skip_value={self.skip_value})"
        )

    def inverse_image(self, image_range: "UnitRange") -> "UnitRange":
        """Source rows whose (non-skip) neighbors all land inside
        ``image_range`` (reference NdArrayConnectivityField.inverse_image,
        embedded/nd_array_field.py:572). Raises if the preimage is not a
        contiguous range."""
        import numpy as np

        table = self.table.cpu().numpy()
        valid = np.ones_like(table, dtype=bool)
        if self.skip_value is not None:
            valid = table != self.skip_value
        inside = ((table >= image_range.start) & (table < image_range.stop)) | ~valid
        rows = inside.all(axis=1) & valid.any(axis=1)
        idx = np.flatnonzero(rows)
        if idx.size == 0:
            return UnitRange(0, 0)
        if not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            raise ValueError("inverse image is not a contiguous range")
        return UnitRange(int(idx[0]), int(idx[-1]) + 1)


#: Alias with the reference's name for a materialized neighbor table
#: (reference common.py:1150).
NeighborTable = Connectivity


class CartesianConnectivity:
    """A fixed cartesian shift presented through the connectivity protocol
    (reference common.py:1242): remapping by it equals offsetting indices
    along ``dim`` by ``offset``. With ``codomain != dim`` it is a domain
    premap onto another dimension (the staggered-shift case, reference
    connectivity_for_cartesian_shift): ``field(conn)`` for a field over
    ``codomain`` yields a field over ``dim`` with
    ``result(i) = field(codomain(i + offset))``."""

    def __init__(self, dim: Dimension, offset: int = 0, codomain: Optional[Dimension] = None):
        self.dim = dim
        self.offset = int(offset)
        self._codomain = codomain if codomain is not None else dim

    @property
    def codomain(self) -> Dimension:
        return self._codomain

    def __repr__(self) -> str:
        tail = "" if self._codomain == self.dim else f" -> {self._codomain.value}"
        return f"CartesianConnectivity({self.dim.value}, {self.offset:+d}{tail})"


# --- staggered grids (reference common.py:1445, ADR 0024) --------------------

_STAGGERED_PREFIX = "_Staggered"


def is_staggered(dim: Dimension) -> bool:
    """Whether ``dim`` is a staggered (half-level) dimension."""
    return dim.value.startswith(_STAGGERED_PREFIX)


def flip_staggered(dim: Dimension) -> Dimension:
    """The staggered counterpart of ``dim`` (reference common.py:1453)."""
    if is_staggered(dim):
        return Dimension(dim.value[len(_STAGGERED_PREFIX):], dim.kind)
    return Dimension(f"{_STAGGERED_PREFIX}{dim.value}", dim.kind)


def as_non_staggered(dim: Dimension) -> Dimension:
    """The non-staggered base dimension of ``dim``."""
    return flip_staggered(dim) if is_staggered(dim) else dim


def connectivity_for_cartesian_shift(
    dim: Dimension, offset: Union[int, float]
) -> CartesianConnectivity:
    """The connectivity shifting ``dim`` by ``offset`` (reference
    common.py:1470). Integer offsets stay within ``dim``; half-integer
    offsets (fractional part 0.5) land on the staggered counterpart — the
    convention (ADR 0024) places a staggered index half a cell BELOW its
    base index, so ``I + 0.5`` maps ``I(i)`` to ``IHalf(i+1)`` while
    ``IHalf + 0.5`` maps ``IHalf(i)`` to ``I(i)``."""
    integral, frac = divmod(offset, 1)
    if frac == 0.5:
        if not is_staggered(dim):
            integral += 1
        return CartesianConnectivity(dim, int(integral), codomain=flip_staggered(dim))
    if frac != 0:
        raise ValueError(
            f"Cartesian shifts must be integer or half-integer, got {offset!r}"
        )
    return CartesianConnectivity(dim, int(integral))


class GridType(enum.Enum):
    CARTESIAN = "cartesian"
    UNSTRUCTURED = "unstructured"


def deduce_grid_type(
    requested: Optional["GridType"], offsets_and_dims
) -> "GridType":
    """Classify a program's grid from its offsets/dimensions (reference
    ffront/transform_utils._deduce_grid_type): an offset is cartesian
    when it shifts within one dimension of the same kind and nothing is
    LOCAL; any unstructured evidence makes the grid unstructured, and a
    CARTESIAN request conflicting with that evidence is an error.
    UNSTRUCTURED may always be requested (cartesian offsets are a
    special case of unstructured)."""

    def is_cartesian(entry) -> bool:
        if isinstance(entry, Dimension):
            return entry.kind != DimensionKind.LOCAL
        if isinstance(entry, FieldOffset):
            return (
                len(entry.target) == 1
                and entry.source == entry.target[0]
                and entry.source.kind != DimensionKind.LOCAL
            )
        return False

    deduced = (
        GridType.CARTESIAN
        if all(is_cartesian(e) for e in offsets_and_dims)
        else GridType.UNSTRUCTURED
    )
    if requested is None:
        return deduced
    if requested == GridType.CARTESIAN and deduced == GridType.UNSTRUCTURED:
        bad = [e for e in offsets_and_dims if not is_cartesian(e)]
        raise ValueError(
            f"grid_type == GridType.CARTESIAN, but unstructured "
            f"FieldOffset or LOCAL dimension found: {bad!r}"
        )
    return requested


def promote_dims(*dim_lists) -> tuple[Dimension, ...]:
    """Order-preserving union of dimension lists (reference
    common.promote_dims, next/common.py:1367)."""
    from gt4py_tpu_torch.next.embedded import _promote_dims

    result: tuple[Dimension, ...] = ()
    for dims in dim_lists:
        result = _promote_dims(result, tuple(dims))
    return result
