"""Stencil metadata shared between compile pipeline and runtime.

Copied from gt4py_tpu/cartesian/definitions.py; imports renamed.

Counterpart of the reference's ``gt4py.cartesian.definitions`` +
``gtc/definitions.py`` (AccessKind/DomainInfo/FieldInfo/ParameterInfo at
src/gt4py/cartesian/definitions.py:46-101, Extent/Boundary at
gtc/definitions.py:453,492).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class AccessKind(enum.Flag):
    NONE = 0
    READ = 1
    WRITE = 2
    READ_WRITE = READ | WRITE


@dataclasses.dataclass(frozen=True)
class Extent:
    """Per-axis (lo, hi) frames. For statements: how far beyond the compute
    domain the statement must execute (lo ≤ 0 ≤ hi). For fields: accumulated
    access extent; ``boundary`` converts to required halo sizes."""

    i: tuple[int, int] = (0, 0)
    j: tuple[int, int] = (0, 0)
    k: tuple[int, int] = (0, 0)

    @classmethod
    def zeros(cls) -> "Extent":
        return cls()

    def union(self, other: "Extent") -> "Extent":
        def u(a, b):
            return (min(a[0], b[0]), max(a[1], b[1]))

        return Extent(i=u(self.i, other.i), j=u(self.j, other.j), k=u(self.k, other.k))

    def shifted_ij(self, di: int, dj: int) -> "Extent":
        return Extent(
            i=(self.i[0] + di, self.i[1] + di),
            j=(self.j[0] + dj, self.j[1] + dj),
            k=self.k,
        )

    def clamped(self) -> "Extent":
        """Clamp so the frame includes the zero extent."""

        def c(a):
            return (min(a[0], 0), max(a[1], 0))

        return Extent(i=c(self.i), j=c(self.j), k=c(self.k))

    @property
    def boundary(self) -> "Boundary":
        return Boundary(
            lower=(max(0, -self.i[0]), max(0, -self.j[0]), max(0, -self.k[0])),
            upper=(max(0, self.i[1]), max(0, self.j[1]), max(0, self.k[1])),
        )


@dataclasses.dataclass(frozen=True)
class Boundary:
    """Required halo sizes around the compute domain, per axis
    (reference gtc/definitions.py:453)."""

    lower: tuple[int, int, int] = (0, 0, 0)
    upper: tuple[int, int, int] = (0, 0, 0)

    def union(self, other: "Boundary") -> "Boundary":
        return Boundary(
            lower=tuple(max(a, b) for a, b in zip(self.lower, other.lower)),  # type: ignore[arg-type]
            upper=tuple(max(a, b) for a, b in zip(self.upper, other.upper)),  # type: ignore[arg-type]
        )


@dataclasses.dataclass(frozen=True)
class FieldInfo:
    """Runtime metadata for one API field (reference definitions.py:65)."""

    access: AccessKind
    boundary: Boundary
    axes: tuple[str, ...]
    data_dims: tuple[int, ...]
    dtype: np.dtype

    @property
    def domain_mask(self) -> tuple[bool, bool, bool]:
        return ("I" in self.axes, "J" in self.axes, "K" in self.axes)

    @property
    def domain_ndim(self) -> int:
        return len(self.axes)

    @property
    def ndim(self) -> int:
        return len(self.axes) + len(self.data_dims)


@dataclasses.dataclass(frozen=True)
class ParameterInfo:
    """Runtime metadata for one scalar parameter (reference definitions.py:93)."""

    access: AccessKind
    dtype: np.dtype


@dataclasses.dataclass(frozen=True)
class DomainInfo:
    parallel_axes: tuple[str, ...] = ("I", "J")
    sequential_axis: str = "K"
    min_sequential_axis_size: int = 0
    ndim: int = 3


@dataclasses.dataclass
class BuildOptions:
    """Normalized stencil build options (reference definitions.py:102)."""

    name: str
    backend: str
    externals: dict = dataclasses.field(default_factory=dict)
    dtypes: dict = dataclasses.field(default_factory=dict)
    rebuild: bool = False
    backend_opts: dict = dataclasses.field(default_factory=dict)
    build_info: Optional[dict] = None
    literal_int_precision: int = 64
    literal_float_precision: int = 64
