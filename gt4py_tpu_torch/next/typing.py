"""Public type aliases for user annotations.

Counterpart of the reference's ``gt4py.next.typing``
(src/gt4py/next/typing.py): names users put in their own
function signatures without importing implementation modules.

Copied from gt4py_tpu/next/typing.py; imports renamed."""

from __future__ import annotations

from typing import Annotated, Final, TypeAlias, Union

from gt4py_tpu_torch.next import stages as _stages
from gt4py_tpu_torch.next.backend import Backend as _Backend
from gt4py_tpu_torch.next.common import (
    CartesianConnectivity as _CartesianConnectivity,
    Connectivity as _Connectivity,
    Dimension as _Dimension,
)
from gt4py_tpu_torch.next.decorators import (
    FieldOperator as _FieldOperator,
    Program as _Program,
    ScanOperator as _ScanOperator,
)

_ONLY_FOR_TYPING: Final[str] = "only for typing"

DSLDefinition: TypeAlias = Annotated[_stages.OperatorDefinition, _ONLY_FOR_TYPING]
FieldOperator: TypeAlias = Annotated[_FieldOperator, _ONLY_FOR_TYPING]
ScanOperator: TypeAlias = Annotated[_ScanOperator, _ONLY_FOR_TYPING]
Program: TypeAlias = Annotated[_Program, _ONLY_FOR_TYPING]
Backend: TypeAlias = Annotated[_Backend, _ONLY_FOR_TYPING]
OffsetProviderElem: TypeAlias = Annotated[
    Union[_Dimension, _Connectivity, _CartesianConnectivity], _ONLY_FOR_TYPING
]
OffsetProvider: TypeAlias = Annotated[dict[str, OffsetProviderElem], _ONLY_FOR_TYPING]

__all__ = [
    "Backend",
    "DSLDefinition",
    "FieldOperator",
    "OffsetProvider",
    "OffsetProviderElem",
    "Program",
    "ScanOperator",
]
