"""Build orchestration veneer: definition function → StencilObject.

Copied from gt4py_tpu/cartesian/loader.py; imports renamed.

Counterpart of the reference's ``loader.py``
(src/gt4py/cartesian/loader.py:53): delegates to
:class:`gt4py_tpu_torch.cartesian.stencil_builder.StencilBuilder`, which owns
the frontend→pipeline→backend thread, the in-process memo, and the
persistent build-data record."""

from __future__ import annotations

from typing import Callable

from gt4py_tpu_torch.cartesian.stencil_builder import StencilBuilder
from gt4py_tpu_torch.cartesian.stencil_object import StencilObject


def load_stencil(definition: Callable, build_options: dict) -> StencilObject:
    return StencilBuilder(definition, options=build_options).build()
