"""Core dtype/device definitions.

Copied from gt4py_tpu/core/definitions.py; imports renamed.

Counterpart of the reference's ``gt4py._core.definitions``
(src/gt4py/_core/definitions.py:146,198,388): a NumPy dtype model and a
device model where the accelerator is a CUDA card addressed through torch.
bfloat16 is not supported yet: the JAX package takes it from ``ml_dtypes``,
which the port does not depend on; it will come from ``torch.bfloat16``.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np


# Default precision of untyped Python literals in the DSL (reference:
# gt4py.cartesian.gt_definitions.LITERAL_INT_PRECISION / LITERAL_FLOAT_PRECISION).
LITERAL_INT_PRECISION = 64
LITERAL_FLOAT_PRECISION = 64

# Half-precision float dtypes. float16 only: bfloat16 waits for torch.bfloat16.
float16 = np.float16

HALF_FLOAT_DTYPES = frozenset({np.dtype(np.float16)})
FLOAT_DTYPE_NAMES = frozenset({"float16", "float32", "float64"})


def is_float_dtype(dtype: Any) -> bool:
    """True for any float dtype."""
    dt = np.dtype(dtype)
    return dt.kind == "f" or dt.name in FLOAT_DTYPE_NAMES


class DeviceType(enum.Enum):
    """Execution device (reference: _core/definitions.py:388 — CPU/CUDA/ROCM;
    here the accelerator is a CUDA card)."""

    CPU = "cpu"
    CUDA = "cuda"


class DType:
    """Thin wrapper around a NumPy dtype with DSL-relevant queries
    (reference: _core/definitions.py:198)."""

    __slots__ = ("np_dtype",)

    def __init__(self, dtype_like: Any):
        if isinstance(dtype_like, DType):
            self.np_dtype = dtype_like.np_dtype
        else:
            self.np_dtype = np.dtype(dtype_like)

    @property
    def name(self) -> str:
        return self.np_dtype.name

    @property
    def kind(self) -> str:
        return self.np_dtype.kind

    @property
    def itemsize(self) -> int:
        return self.np_dtype.itemsize

    @property
    def is_bool(self) -> bool:
        return self.np_dtype.kind == "b"

    @property
    def is_integer(self) -> bool:
        return self.np_dtype.kind in ("i", "u")

    @property
    def is_float(self) -> bool:
        return is_float_dtype(self.np_dtype)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, DType):
            return self.np_dtype == other.np_dtype
        try:
            return self.np_dtype == np.dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.np_dtype)

    def __repr__(self) -> str:
        return f"DType({self.np_dtype.name})"


def upcast(a: np.dtype, b: np.dtype) -> np.dtype:
    """Implicit binary-op result dtype, matching the reference's upcasting
    rules (gtc/passes/gtir_upcaster.py): standard NumPy promotion."""
    return np.promote_types(a, b)
