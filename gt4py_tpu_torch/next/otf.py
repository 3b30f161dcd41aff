"""On-the-fly toolchain: compiled-programs pool, compilation options,
composable workflow steps.

Counterpart of gt4py_tpu/next/otf.py (role of the reference's
``gt4py.next.otf``, src/gt4py/next/otf/): calls dispatch through a
``CompiledProgramsPool`` keyed by the argument signature, the static-
argument values and the offset-provider fingerprints
(otf/compiled_program.py:333,495-539), as in the JAX package. A variant's
build is the FOAST-compiled definition with its static arguments bound:
there is no jit, so a miss builds inline, and the JAX package's jit
switch, async compile workers, process runner and serialized executables
have no counterpart.

- :class:`CompilationOptions` — ``static_params`` (reference
  otf/options.py:23).
- :class:`CompiledProgramsPool` — executable cache; a miss builds inline.
- :class:`NamedStepSequence` — the composable-step kit a backend's
  ``Transforms`` builds on (reference otf/workflow.py:97).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from gt4py_tpu_torch.next import type_system as ts


@dataclasses.dataclass(frozen=True)
class CompilationOptions:
    """User-facing compilation knobs (reference otf/options.py:23).

    What remains user-facing is variant ENUMERATION, via
    ``FieldOperator.compile(static_arg=[v1, v2], ...)`` cross products.
    """

    static_params: tuple[str, ...] = ()

    def replace(self, **kwargs: Any) -> "CompilationOptions":
        return dataclasses.replace(self, **kwargs)


def _static_key(value: Any) -> Any:
    """Hashable identity of a static argument VALUE (baked into the
    executable; reference ArgStaticDescriptor, otf/arguments.py:40)."""
    if isinstance(value, (int, float, bool, str, type(None))):
        return value
    if isinstance(value, tuple):
        return tuple(_static_key(v) for v in value)
    if isinstance(value, np.generic):
        return (value.dtype.str, value.item())
    raise TypeError(
        f"static_params values must be hashable scalars/tuples, got {type(value).__name__}"
    )


def _dynamic_key(value: Any) -> Any:
    """Type-signature key of a dynamic argument (shape/dtype class;
    retraces only on signature change)."""
    spec = ts.from_value(value)
    if isinstance(spec, ts.FieldType):
        from gt4py_tpu_torch.next.embedded import Field

        assert isinstance(value, Field)
        return (spec.dims, spec.dtype.str, value.domain.shape)
    if isinstance(spec, ts.TupleType):
        from gt4py_tpu_torch.next.named_collections import is_named_collection

        if is_named_collection(value):
            names = type(value).__named_collection_fields__
            return tuple(_dynamic_key(getattr(value, n)) for n in names)
        return tuple(_dynamic_key(v) for v in value)
    return ("scalar", spec.dtype.str)


def _provider_fingerprint(provider: Any) -> Any:
    """Content fingerprint of an offset provider (reference hashes the
    provider, otf/compiled_program.py:495-539). ``id()`` keys are unsound:
    a GC'd connectivity followed by a new allocation at the same address
    would silently reuse the wrong compiled variant. The hash is computed
    once and cached on the provider object."""
    cached = getattr(provider, "_gt4py_fingerprint", None)
    if cached is not None:
        return cached

    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(type(provider).__name__.encode())
    table = getattr(provider, "table", None)
    if table is not None:
        h.update(table.cpu().numpy().tobytes())
        h.update(repr(getattr(provider, "skip_value", None)).encode())
        for attr in ("source_dim", "codomain", "neighbor_dim", "domain_dim"):
            h.update(repr(getattr(provider, attr, None)).encode())
    else:
        # CartesianConnectivity-style providers: structural fields only.
        state = getattr(provider, "__dict__", None)
        h.update(repr(state if state is not None else provider).encode())
    fp = h.hexdigest()
    try:
        object.__setattr__(provider, "_gt4py_fingerprint", fp)
    except (AttributeError, TypeError):
        pass  # slots/frozen without room: recompute per call
    return fp


class CompiledProgramsPool:
    """Executable cache for one program definition
    (reference otf/compiled_program.py:333).

    Keys combine the dynamic signature (dims, dtype, shape per Field
    argument), the VALUES of declared static parameters, and the
    offset-provider identity. A miss builds the variant inline.
    """

    def __init__(self, make_executable: Callable[..., Callable], options: CompilationOptions):
        self._make = make_executable
        self.options = options
        self._programs: dict[Any, Any] = {}

    def _key(self, args: Sequence[Any], kwargs: dict[str, Any], offset_provider, extra_key=None) -> Any:
        statics = []
        dynamics = []
        for name, value in kwargs.items():
            if name in self.options.static_params:
                statics.append((name, _static_key(value)))
            else:
                dynamics.append((name, _dynamic_key(value)))
        op_key = None
        if offset_provider:
            op_key = tuple(
                sorted((k, _provider_fingerprint(v)) for k, v in offset_provider.items())
            )
        return (
            tuple(_dynamic_key(a) for a in args),
            tuple(dynamics),
            tuple(statics),
            op_key,
            extra_key,
        )

    def peek(self, args, kwargs, offset_provider, extra_key=None):
        """The cached entry for this key, or None (no compile on miss)."""
        return self._programs.get(self._key(args, kwargs, offset_provider, extra_key))

    def lookup(self, args, kwargs, offset_provider, extra_key=None, make=None):
        key = self._key(args, kwargs, offset_provider, extra_key)
        entry = self._programs.get(key)
        if entry is None:
            entry = self._programs[key] = (make or self._make)(args, kwargs)
        return entry

    def precompile(self, args, kwargs, offset_provider) -> None:
        """AOT-compile one variant (reference compile(), decorator.py:161)."""
        self.lookup(args, kwargs, offset_provider)

    def __len__(self) -> int:
        return len(self._programs)


# --- workflow kit -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedStepSequence:
    """A workflow whose steps are the dataclass fields, executed in field
    order (reference NamedStepSequence, otf/workflow.py:97). Subclass with
    step fields; customize a pipeline with ``dataclasses.replace`` /
    :meth:`replace` — that is the user-controllable transform-pipeline
    surface (reference backend ``Transforms`` replacement idiom)."""

    def step_order(self, inp: Any) -> list[str]:
        """Step names to execute, in order. Override for per-input
        ordering (reference MultiWorkflow, otf/workflow.py:165)."""
        return [f.name for f in dataclasses.fields(self)]

    def __call__(self, inp: Any) -> Any:
        for name in self.step_order(inp):
            step_fn = getattr(self, name)
            if step_fn is None:
                continue
            inp = step_fn(inp)
        return inp

    def replace(self, **kwargs: Any) -> "NamedStepSequence":
        return dataclasses.replace(self, **kwargs)


class MultiWorkflow(NamedStepSequence):
    """Alias making the per-input-step-order variant searchable by its
    reference name (otf/workflow.py:165): override :meth:`step_order`."""
