"""Deferred-build stencil wrapper (reference: cartesian/lazy_stencil.py:24).

Copied from gt4py_tpu/cartesian/lazy_stencil.py; imports renamed.
"""

from __future__ import annotations

from typing import Callable, Optional

from gt4py_tpu_torch.cartesian.stencil_object import StencilObject


class LazyStencil:
    """Build the stencil on first call; ``check_syntax`` runs the frontend
    eagerly without building a backend (reference lazy_stencil.py:66)."""

    def __init__(self, definition: Callable, backend: str, build_options: dict):
        self.definition = definition
        self.backend = backend
        self.build_options = dict(build_options)
        self._implementation: Optional[StencilObject] = None

    @property
    def builder(self):
        """The underlying StencilBuilder (reference lazy_stencil.py
        exposes its builder for staged builds)."""
        from gt4py_tpu_torch.cartesian.stencil_builder import StencilBuilder

        options = dict(self.build_options)
        options.setdefault("backend", self.backend)
        options.setdefault("externals", {})
        options.setdefault("dtypes", {})
        return StencilBuilder(self.definition, options=options)

    @property
    def field_info(self):
        return self.implementation.field_info

    def check_syntax(self) -> None:
        self.builder.check_syntax()

    @property
    def implementation(self) -> StencilObject:
        if self._implementation is None:
            self._implementation = self.builder.build()
        return self._implementation

    def __call__(self, *args, **kwargs) -> None:
        self.implementation(*args, **kwargs)

    def run(self, *args, **kwargs) -> None:
        self.implementation.run(*args, **kwargs)
