"""Array-namespace utilities shared across execution paths.

Counterpart of gt4py_tpu/core/ndarray_utils.py. The JAX package has two
namespaces, NumPy (eager oracles) and jax.numpy (traced); the port has NumPy
for host values and :class:`TorchNamespace`, a NumPy-named veneer over torch
bound to one ``torch.device``. The veneer exists so the stencil evaluator
(cartesian/backend/evaluator.py) keeps the JAX package's NumPy-style code.

Dtypes: torch promotes a 0-d tensor of a wider type into the narrower type
of a dimensioned one, where NumPy widens. Callers that need NumPy's result
cast every operand to the GTIR dtype first (see evaluator.py); the veneer
itself never relies on torch promotion for a result dtype.
"""

from __future__ import annotations

import types
from typing import Any

import numpy as np
import torch

from gt4py_tpu_torch.core.definitions import as_dtype, bfloat16

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    bfloat16: torch.bfloat16,  # the port's token (core/definitions.py)
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a NumPy dtype-like, ``"bfloat16"`` and the
    bfloat16 token included (torch dtypes pass through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[as_dtype(dtype)]
    except KeyError:
        raise TypeError(f"dtype {as_dtype(dtype)} has no torch counterpart") from None


def numpy_dtype(dtype: Any) -> np.dtype:
    """The NumPy dtype of a torch dtype (``torch.bfloat16``: the port's
    bfloat16 token); NumPy dtype-likes and ``"bfloat16"`` pass through
    :func:`~gt4py_tpu_torch.core.definitions.as_dtype`."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_NP[dtype]
        except KeyError:
            raise TypeError(f"torch dtype {dtype} has no NumPy counterpart") from None
    return as_dtype(dtype)


def asnumpy(arr: Any) -> np.ndarray:
    """Host copy of any supported array (device transfers included). NumPy
    has no bfloat16: a bfloat16 tensor comes back as float32, which holds
    every bfloat16 value exactly."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _gamma(x: torch.Tensor) -> torch.Tensor:
    # exp(lgamma) with the sign of Gamma for negative non-integers:
    # Gamma(x) < 0 where floor(x) is odd and x < 0.
    sign = torch.where(
        (x < 0) & (torch.remainder(torch.floor(x), 2) == 1),
        torch.full_like(x, -1.0),
        torch.ones_like(x),
    )
    return sign * torch.exp(torch.lgamma(x))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _round_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


#: NumPy-named math on tensors (the ``torch`` column of gtscript's builtins
#: and of the evaluator's native-function table).
torch_math = types.SimpleNamespace(
    abs=torch.abs,
    minimum=torch.minimum,
    maximum=torch.maximum,
    mod=torch.remainder,  # floor-mod, sign of the divisor, like np.mod
    sin=torch.sin,
    cos=torch.cos,
    tan=torch.tan,
    arcsin=torch.asin,
    arccos=torch.acos,
    arctan=torch.atan,
    sinh=torch.sinh,
    cosh=torch.cosh,
    tanh=torch.tanh,
    arcsinh=torch.asinh,
    arccosh=torch.acosh,
    arctanh=torch.atanh,
    sqrt=torch.sqrt,
    cbrt=_cbrt,
    exp=torch.exp,
    log=torch.log,
    log10=torch.log10,
    gamma=_gamma,
    erf=torch.special.erf,
    erfc=torch.special.erfc,
    isfinite=torch.isfinite,
    isinf=torch.isinf,
    isnan=torch.isnan,
    floor=torch.floor,
    ceil=torch.ceil,
    trunc=torch.trunc,
    round=torch.round,  # half-to-even, like np.round
    round_away_from_zero=_round_away_from_zero,
    power=torch.pow,
    arctan2=torch.atan2,
    hypot=torch.hypot,
    copysign=torch.copysign,
)


class TorchNamespace:
    """NumPy-named operations on tensors of one device.

    Every allocation names ``self.device``; host values (NumPy arrays,
    Python and NumPy scalars) become tensors there. A tensor on another
    device is an error, never a silent copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    # -- conversion ------------------------------------------------------

    def asarray(self, x: Any, dtype: Any = None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(
                    f"tensor on {x.device} used in a computation on {self.device}"
                )
            return x if dtype is None else x.to(torch_dtype(dtype))
        if dtype is not None and torch_dtype(dtype) == torch.bfloat16:
            # NumPy cannot hold it: round the host value on the way in
            return torch.as_tensor(np.asarray(x), device=self.device).to(torch.bfloat16)
        arr = np.asarray(x) if dtype is None else np.asarray(x, dtype=np.dtype(dtype))
        return torch.as_tensor(arr, device=self.device)

    def astype(self, x: Any, dtype: Any) -> torch.Tensor:
        return self.asarray(x).to(torch_dtype(dtype))

    # -- creation --------------------------------------------------------

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=self.device)

    def arange(self, *args, dtype=np.int64) -> torch.Tensor:
        return torch.arange(*args, dtype=torch_dtype(dtype), device=self.device)

    # -- shape -----------------------------------------------------------

    def broadcast_to(self, x, shape) -> torch.Tensor:
        return torch.broadcast_to(self.asarray(x), tuple(shape))

    def squeeze(self, x, axis) -> torch.Tensor:
        axes = axis if isinstance(axis, tuple) else (axis,)
        for ax in sorted(axes, reverse=True):
            x = x.squeeze(ax)
        return x

    def expand_dims(self, x, axis: int) -> torch.Tensor:
        return self.asarray(x).unsqueeze(axis)

    def pad_edge(self, x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
        """Edge padding along one axis (np.pad mode="edge")."""
        n = x.shape[axis]
        idx = torch.clamp(
            torch.arange(-lo, n + hi, device=self.device), 0, n - 1
        )
        return torch.index_select(x, axis, idx)

    # -- elementwise -----------------------------------------------------

    def where(self, cond, a, b) -> torch.Tensor:
        return torch.where(self.asarray(cond), self.asarray(a), self.asarray(b))

    def clip(self, x, lo, hi) -> torch.Tensor:
        return torch.clamp(self.asarray(x), lo, hi)

    def logical_and(self, a, b):
        return torch.logical_and(self.asarray(a), self.asarray(b))

    def logical_or(self, a, b):
        return torch.logical_or(self.asarray(a), self.asarray(b))

    def logical_not(self, a):
        return torch.logical_not(self.asarray(a))

    def any(self, x) -> bool:
        return bool(torch.any(self.asarray(x)))

    # -- gathers and scatters along an axis --------------------------------

    def take_along_axis(self, arr, idx, axis: int) -> torch.Tensor:
        return torch.gather(arr, axis, idx)

    def put_along_axis(self, arr, idx, values, axis: int) -> torch.Tensor:
        """In place, like np.put_along_axis."""
        arr.scatter_(axis, idx, values)
        return arr

    def __getattr__(self, name: str):
        # NumPy-named math (sin, minimum, mod, ...) resolves to torch_math.
        try:
            return getattr(torch_math, name)
        except AttributeError:
            raise AttributeError(f"TorchNamespace has no operation '{name}'") from None


def slice_nd(arr, starts, sizes):
    """N-d window slice with static start indices (a view)."""
    idx = tuple(slice(int(s), int(s) + int(z)) for s, z in zip(starts, sizes))
    idx = idx + (slice(None),) * (arr.ndim - len(starts))
    return arr[idx]


def update_nd(arr, starts, value):
    """Write a window into ``arr`` in place; returns ``arr``."""
    idx = tuple(slice(int(s), int(s) + int(z)) for s, z in zip(starts, value.shape))
    idx = idx + (slice(None),) * (arr.ndim - len(starts))
    arr[idx] = value
    return arr


def is_integral_value(x: Any) -> bool:
    """True for a Python/NumPy integer or a 0-d integer tensor."""
    if isinstance(x, (int, np.integer)):
        return True
    return (
        isinstance(x, torch.Tensor)
        and x.ndim == 0
        and not x.is_floating_point()
        and x.dtype != torch.bool
    )


__all__ = [
    "TorchNamespace",
    "asnumpy",
    "is_integral_value",
    "numpy_dtype",
    "slice_nd",
    "torch_dtype",
    "torch_math",
    "update_nd",
]
