"""Backend assembly: the Transforms workflow + backend registry.

Counterpart of gt4py_tpu/next/backend.py (role of the reference's
``gt4py.next.backend``, src/gt4py/next/backend.py:98-154): a ``Backend``
couples a *transforms* workflow (definition → validated → typed →
specialized → executable) with a runtime ``kind``. The workflow is
user-controllable as in the JAX package: ``Backend.replace(transforms=
backend.transforms.replace(...))`` swaps any step, and
``program_transforms`` applies function→function rewrites.

Two backends are registered:

- ``torch`` (kind ``eager``), the counterpart of the JAX package's ``jax``
  and ``embedded``: the FOAST-compiled definition runs on embedded torch
  Fields, on whatever device they live on. Its executable is the
  specialized definition itself: there is no jit to build.
- ``cuda:hopper`` (kind ``pallas``), the counterpart of ``tpu:pallas``:
  an operator whose offsets are all cartesian goes through the cartesian
  bridge onto the port's Hopper kernels; what the bridge does not take runs
  embedded, as in the JAX package's decorators.

The JAX package's ``jax:aot`` (explicit trace → lower → compile stages) and
``numpy`` (the NumPy oracle) backends have no counterpart yet.

Decorators accept either a registered name (``backend="torch"``) or a
Backend instance (``backend=my_backend``)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

from gt4py_tpu_torch.next.otf import NamedStepSequence


__all__ = [
    "Backend",
    "CompileJob",
    "Transforms",
    "REGISTRY",
    "register",
    "resolve",
    "backend_kind",
]


@dataclasses.dataclass
class CompileJob:
    """The value threaded through the Transforms workflow: the definition
    and the example arguments of the variant being built, with the
    artifacts filled in step by step."""

    definition: Callable
    op_kind: str = "field_operator"
    static_args: tuple = ()
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    type_info: Optional[Any] = None  # pre-deduced info from the decorator
    fn: Optional[Callable] = None  # specialized callable
    executable: Optional[Callable] = None


def _validate(job: CompileJob) -> CompileJob:
    """Definition-time checks (idempotent; decorators already ran them for
    decorated operators, but transforms pipelines can be driven with raw
    functions too)."""
    from gt4py_tpu_torch.next.frontend_validation import validate_definition

    validate_definition(job.definition, kind=job.op_kind)
    return job


def _deduce(job: CompileJob) -> CompileJob:
    from gt4py_tpu_torch.next.type_deduction import deduce

    if job.type_info is None:
        job.type_info = deduce(job.definition, kind=job.op_kind)
    return job


def _specialize(job: CompileJob) -> CompileJob:
    statics = dict(job.static_args)
    fn = job.definition
    job.fn = functools.partial(fn, **statics) if statics else fn
    return job


@dataclasses.dataclass(frozen=True)
class _ProgramTransforms:
    """Apply user function→function rewrites."""

    rewrites: tuple[Callable[[Callable], Callable], ...] = ()

    def __call__(self, job: CompileJob) -> CompileJob:
        for rw in self.rewrites:
            job.fn = rw(job.fn)
        return job


def _compile_eager(job: CompileJob) -> CompileJob:
    """Default compile step: the specialized function is the executable."""
    job.executable = job.fn
    return job


@dataclasses.dataclass(frozen=True)
class Transforms(NamedStepSequence):
    """The Transforms workflow (reference backend.py:98-137). Fields
    execute in order; None steps are skipped. Customize with ``replace``
    or :meth:`with_rewrites`."""

    validate: Optional[Callable] = _validate
    deduce: Optional[Callable] = _deduce
    specialize: Optional[Callable] = _specialize
    program_transforms: Optional[Callable] = dataclasses.field(
        default_factory=_ProgramTransforms
    )
    compile: Optional[Callable] = _compile_eager

    def with_rewrites(self, *rewrites: Callable[[Callable], Callable]) -> "Transforms":
        return self.replace(program_transforms=_ProgramTransforms(tuple(rewrites)))


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named execution strategy (reference backend.py:148): ``kind``
    selects the runtime (how operators execute), ``transforms`` builds the
    executable."""

    name: str
    kind: str  # 'eager' | 'pallas'
    transforms: Transforms = dataclasses.field(default_factory=Transforms)

    def make_executable(
        self,
        definition: Callable,
        *,
        op_kind: str = "field_operator",
        static_args: tuple[tuple[str, Any], ...] = (),
        type_info: Any = None,
        args: tuple = (),
        kwargs: Optional[dict] = None,
    ) -> Callable:
        job = CompileJob(
            definition=definition,
            op_kind=op_kind,
            static_args=static_args,
            args=args,
            kwargs=dict(kwargs or {}),
            type_info=type_info,
        )
        job = self.transforms(job)
        assert job.executable is not None, "transforms produced no executable"
        return job.executable

    def replace(self, **kwargs: Any) -> "Backend":
        return dataclasses.replace(self, **kwargs)


REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    REGISTRY[backend.name] = backend
    return backend


register(Backend(name="torch", kind="eager"))
register(Backend(name="cuda:hopper", kind="pallas"))


def resolve(backend: Union[str, Backend, None]) -> Optional[Backend]:
    """Name → Backend; Backend instances pass through; None (eager) stays
    None."""
    if backend is None or isinstance(backend, Backend):
        return backend
    try:
        return REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"Unknown backend {backend!r}; registered: {sorted(REGISTRY)}"
        ) from None


def backend_kind(backend: Union[str, Backend, None]) -> Optional[str]:
    """The runtime-dispatch kind of a backend spec ('eager', 'pallas') or
    None for eager execution without the pool."""
    if backend is None:
        return None
    if isinstance(backend, Backend):
        return backend.kind
    resolved = REGISTRY.get(backend)
    if resolved is not None:
        return resolved.kind
    return backend  # legacy free-form strings keep their own dispatch
