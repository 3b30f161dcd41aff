"""Core dtype/device definitions.

Copied from gt4py_tpu/core/definitions.py; imports renamed.

Counterpart of the reference's ``gt4py._core.definitions``
(src/gt4py/_core/definitions.py:146,198,388): a NumPy dtype model and a
device model where the accelerator is a CUDA card addressed through torch.

bfloat16: the JAX package takes its NumPy dtype from ``ml_dtypes``, which
the port does not depend on (the card's machine has neither it nor JAX).
NumPy has no bfloat16 of its own, and a dtype cannot be subclassed in
Python, so the port's token is the structured dtype
``np.dtype([("bfloat16", "<u2")])``: 2 bytes, and unlike a ``V2`` with
metadata (which compares equal to every ``V2``) it equals no other dtype.
It is only a name for the GTIR and the validation: values are never held
in it. Tensors are ``torch.bfloat16`` (``ndarray_utils`` maps the two), and
NumPy copies of them are float32. Its ``.name`` is NumPy's ``void16``:
print it with :func:`dtype_name`, parse one with :func:`as_dtype`.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np


# Default precision of untyped Python literals in the DSL (reference:
# gt4py.cartesian.gt_definitions.LITERAL_INT_PRECISION / LITERAL_FLOAT_PRECISION).
LITERAL_INT_PRECISION = 64
LITERAL_FLOAT_PRECISION = 64

# Half-precision float dtypes: stored in 16 bits, computed in float32 by
# the kernels (the JAX package's K1, pallas_split.py:129-156).
bfloat16 = np.dtype([("bfloat16", "<u2")])
float16 = np.float16

HALF_FLOAT_DTYPES = frozenset({bfloat16, np.dtype(np.float16)})
FLOAT_DTYPE_NAMES = frozenset({"float16", "bfloat16", "float32", "float64"})

#: spellings of bfloat16 that :func:`as_dtype` accepts
_BF16_NAMES = frozenset({"bfloat16", "bf16"})


def as_dtype(spec: Any) -> np.dtype:
    """The NumPy dtype of a dtype-like, with ``"bfloat16"``/``"bf16"`` (and
    the token itself) as :data:`bfloat16`. ``torch.bfloat16`` and the other
    torch dtypes go through ``ndarray_utils.numpy_dtype``."""
    if isinstance(spec, str) and spec in _BF16_NAMES:
        return bfloat16
    return np.dtype(spec)


def dtype_name(dtype: Any) -> str:
    """A dtype's name: ``"bfloat16"`` for the token, else NumPy's."""
    dt = as_dtype(dtype)
    return "bfloat16" if dt == bfloat16 else dt.name


def is_float_dtype(dtype: Any) -> bool:
    """True for any float dtype including bfloat16 (whose kind is 'V')."""
    dt = as_dtype(dtype)
    return dt.kind == "f" or dtype_name(dt) in FLOAT_DTYPE_NAMES


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
            self.np_dtype = as_dtype(dtype_like)

    @property
    def name(self) -> str:
        return dtype_name(self.np_dtype)

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
            return self.np_dtype == as_dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.np_dtype)

    def __repr__(self) -> str:
        return f"DType({self.name})"


# JAX's type-promotion lattice with 64-bit types on, as the JAX package runs
# it (``jax_enable_x64``, gt4py_tpu/__init__.py): each type's direct
# successors. ``WEAK_INT`` and ``WEAK_FLOAT`` are the weak types of Python
# ``int`` and ``float`` operands: they adapt to the other operand's type
# (``float32_field * 2.0`` stays float32) and, on their own, stand for int64
# and float64. The field-view embedded path promotes by this table, since
# torch's own rules differ (an int32 tensor plus a Python float gives
# float32 there, float64 here).
WEAK_INT = "int*"
WEAK_FLOAT = "float*"
_B, _F16, _F32, _F64 = np.dtype(bool), np.dtype(np.float16), np.dtype(np.float32), np.dtype(np.float64)
_I = {n: np.dtype(f"int{n}") for n in (8, 16, 32, 64)}
_U = {n: np.dtype(f"uint{n}") for n in (8, 16, 32, 64)}
_LATTICE: dict = {
    _B: (WEAK_INT,),
    WEAK_INT: (_U[8], _I[8]),
    _U[8]: (_U[16], _I[16]),
    _U[16]: (_U[32], _I[32]),
    _U[32]: (_U[64], _I[64]),
    _U[64]: (WEAK_FLOAT,),
    _I[8]: (_I[16],),
    _I[16]: (_I[32],),
    _I[32]: (_I[64],),
    _I[64]: (WEAK_FLOAT,),
    WEAK_FLOAT: (bfloat16, _F16),
    bfloat16: (_F32,),
    _F16: (_F32,),
    _F32: (_F64,),
    _F64: (),
}


def _upper_bounds(t) -> frozenset:
    seen, todo = set(), [t]
    while todo:
        x = todo.pop()
        if x not in seen:
            seen.add(x)
            todo.extend(_LATTICE[x])
    return frozenset(seen)


_UPPER = {t: _upper_bounds(t) for t in _LATTICE}


def promote_types(*types) -> tuple[np.dtype, bool]:
    """The JAX result type of operands of ``types`` (NumPy dtypes, or
    :data:`WEAK_INT`/:data:`WEAK_FLOAT` for Python scalars): ``(dtype,
    weak)``, where ``weak`` says the result is itself a weak type, as when
    every operand is a Python scalar."""
    keys = [t if t in (WEAK_INT, WEAK_FLOAT) else as_dtype(t) for t in types]
    for k in keys:
        if k not in _UPPER:
            raise TypeError(f"no JAX promotion for {k}")
    common = frozenset.intersection(*(_UPPER[k] for k in keys))
    lub = next(c for c in common if common <= _UPPER[c])
    if lub == WEAK_INT:
        return np.dtype(np.int64), True
    if lub == WEAK_FLOAT:
        return np.dtype(np.float64), True
    return lub, False


def upcast(a: Any, b: Any) -> np.dtype:
    """Implicit binary-op result dtype, matching the reference's upcasting
    rules (gtc/passes/gtir_upcaster.py): standard NumPy promotion, and the
    JAX lattice for bfloat16, as the JAX package follows it
    (passes/type_inference.py:198-212, which asks ``jnp.promote_types``)."""
    a, b = as_dtype(a), as_dtype(b)
    if bfloat16 in (a, b):
        return promote_types(a, b)[0]
    return np.promote_types(a, b)


def to_inexact(dtype: Any) -> np.dtype:
    """JAX's floating type for an operation that needs one (true division,
    ``sin``): floats stay; bool and integers of up to 32 bits give float32,
    64-bit integers float64."""
    dt = as_dtype(dtype)
    if is_float_dtype(dt):
        return dt
    return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)
