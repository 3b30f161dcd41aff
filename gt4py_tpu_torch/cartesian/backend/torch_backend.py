"""Eager torch backend ``"torch"`` — the plain version of every kernel.

Counterpart of gt4py_tpu/cartesian/backend/jax_backend.py (the JAX
package's array backend). Where that one traces the GTIR into a ``jax.jit``
program, this one runs the evaluator (evaluator.py) eagerly, in place, on
whatever device the tensors live on: the CPU in the tests, the card when
``chip_smoke.py`` holds each CUDA kernel against it. All tensors of one
call must share a device; nothing is moved between devices.
"""

from __future__ import annotations

from typing import Any

import torch

from gt4py_tpu_torch.cartesian.backend.base import Backend, register
from gt4py_tpu_torch.cartesian.backend.evaluator import Evaluator
from gt4py_tpu_torch.cartesian.definitions import AccessKind


def check_tensors(arrays: dict) -> None:
    """Raise a ``TypeError`` naming a field argument that is not a tensor
    (and its type)."""
    for name, a in arrays.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError(
                f"stencil argument '{name}' is a {type(a).__module__}.{type(a).__name__}, "
                "not a torch.Tensor: pass a Storage or a tensor"
            )


def call_device(arrays: dict[str, torch.Tensor]) -> torch.device:
    """The one device all of a call's tensors live on."""
    check_tensors(arrays)
    devices = {a.device for a in arrays.values()}
    if len(devices) != 1:
        raise ValueError(
            f"stencil arguments live on several devices {sorted(map(str, devices))}; "
            "move them explicitly to one"
        )
    return devices.pop()


def run_plain(analyzed, arrays, scalars, domain, origins) -> dict[str, torch.Tensor]:
    """Evaluate ``analyzed`` eagerly in place; return the written tensors."""
    ev = Evaluator(analyzed, domain, origins, arrays, scalars, call_device(arrays))
    out = ev.run()
    return {
        name: out[name]
        for name, info in analyzed.field_infos.items()
        if info.access & AccessKind.WRITE and name in out
    }


@register
class TorchBackend(Backend):
    name = "torch"
    storage_info = {"alignment": 64, "device": "cuda"}

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        self.last_strategy = "plain"
        return run_plain(self.analyzed, arrays, scalars, domain, origins)
