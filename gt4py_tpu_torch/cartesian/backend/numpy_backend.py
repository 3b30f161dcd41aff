"""Eager NumPy backend ``"numpy"`` — the exact oracle.

Copied from gt4py_tpu/cartesian/backend/numpy_backend.py (the reference's
``numpy`` backend, src/gt4py/cartesian/backend/numpy_backend.py:29):
vectorized execution with NumPy's promotion and mask semantics
(numpy_evaluator.py), in place on the caller's buffers. The port's fields
are torch tensors: the evaluator runs on NumPy views of them
(``Tensor.numpy()`` shares the memory), so a write lands in the tensor.

It runs on CPU tensors only: a CUDA tensor raises a ``TypeError`` that
names its device, and nothing is moved between devices, as in
``torch_backend.call_device``. Naming this backend (or ``debug`` or
``cpu:c``) is how a caller asks for the CPU: their storages live there.

bfloat16 tensors have no NumPy view: each storage holding one is copied
once into a float32 carrier (numpy_evaluator.py), views of the same
storage share it, and after the call the carriers of written fields are
stored back, exactly, since every value in them is a bfloat16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.backend.base import Backend, register
from gt4py_tpu_torch.cartesian.backend.numpy_evaluator import Evaluator
from gt4py_tpu_torch.cartesian.backend.torch_backend import check_tensors
from gt4py_tpu_torch.cartesian.definitions import AccessKind


class HostViews:
    """NumPy views of a call's CPU tensors (float32 carriers for bfloat16
    ones); :meth:`store` writes the carriers of written fields back."""

    def __init__(self, arrays: dict[str, torch.Tensor], backend: str):
        self.arrays: dict[str, np.ndarray] = {}
        #: storage pointer -> (bfloat16 storage as a flat tensor, its carrier)
        self._carriers: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.check_cpu(arrays, backend)
        for name, t in arrays.items():
            t = t.detach()
            if t.dtype == torch.bfloat16:
                store = t.untyped_storage()
                if store.data_ptr() not in self._carriers:
                    flat = torch.empty(0, dtype=torch.bfloat16).set_(store)
                    self._carriers[store.data_ptr()] = (flat, flat.float())
                carrier = self._carriers[store.data_ptr()][1]
                t = carrier.as_strided(t.shape, t.stride(), t.storage_offset())
            self.arrays[name] = t.numpy()

    @staticmethod
    def check_cpu(arrays: dict[str, torch.Tensor], backend: str) -> None:
        """Raise a ``TypeError`` naming an argument that is not a tensor, or
        the device of a tensor not on the CPU."""
        check_tensors(arrays)
        for name, t in arrays.items():
            if t.device.type != "cpu":
                raise TypeError(
                    f"the {backend} backend runs on CPU tensors, and field '{name}' lives on "
                    f"{t.device}: move it to the CPU explicitly (or call a backend of the card)"
                )

    def store(self) -> None:
        for flat, carrier in self._carriers.values():
            flat.copy_(carrier)


def run_numpy(analyzed, arrays, scalars, domain, origins, backend: str) -> dict[str, Any]:
    """Evaluate ``analyzed`` with the NumPy evaluator in place on the CPU
    tensors ``arrays``; returns the written tensors."""
    views = HostViews(arrays, backend)
    Evaluator(analyzed, domain, origins, views.arrays, scalars).run()
    views.store()
    return {
        name: arrays[name]
        for name, info in analyzed.field_infos.items()
        if info.access & AccessKind.WRITE and name in arrays
    }


@register
class NumpyBackend(Backend):
    name = "numpy"
    storage_info = {"alignment": 64, "device": "cpu"}

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        self.last_strategy = "numpy"
        return run_numpy(self.analyzed, arrays, scalars, domain, origins, self.name)
