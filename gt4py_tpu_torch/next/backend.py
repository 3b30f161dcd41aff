"""Backend assembly: the Transforms workflow + backend registry.

Counterpart of gt4py_tpu/next/backend.py (role of the reference's
``gt4py.next.backend``, src/gt4py/next/backend.py:98-154): a ``Backend``
couples a *transforms* workflow (definition → validated → typed →
specialized → [traced → lowered] → executable, the stages of
:mod:`gt4py_tpu_torch.next.stages`) with a runtime ``kind``. The workflow is
user-controllable as in the JAX package: ``Backend.replace(transforms=
backend.transforms.replace(...))`` swaps any step, and
``program_transforms`` applies function→function rewrites.

Four backends are registered:

- ``torch`` (kind ``eager``), the counterpart of the JAX package's ``jax``
  and ``embedded``: the FOAST-compiled definition runs on embedded torch
  Fields, on whatever device they live on. Its executable is the
  specialized definition itself: there is no jit to build.
- ``cuda:hopper`` (kind ``pallas``), the counterpart of ``tpu:pallas``:
  an operator whose offsets are all cartesian goes through the cartesian
  bridge onto the port's Hopper kernels; what the bridge does not take runs
  embedded, as in the JAX package's decorators.
- ``cuda:hopper:aot`` (kind ``aot``), the counterpart of ``jax:aot``: the
  explicit stages — trace (the bridge's variant of the argument
  signature), lower (its generated CUDA C++), compile (``nvcc`` and load,
  on card tensors) — run at ``FieldOperator.compile(...)`` or at the first
  call, before any launch; the executable then runs the prebuilt variant.
  For an operator the bridge refuses, the job stops after the typed stage
  with the reason (``CompileJob.unsupported``) and the executable runs
  embedded, as ``cuda:hopper`` falls through.
- ``numpy`` (kind ``numpy``), the oracle: the raw definition on NumPy
  Fields (next/decorators.py).

Decorators accept either a registered name (``backend="torch"``) or a
Backend instance (``backend=my_backend``)."""

from __future__ import annotations

import dataclasses
import dis
import functools
import sys
import types
from typing import Any, Callable, Optional, Union

from gt4py_tpu_torch.next import stages
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
    stage plus the example arguments of the variant being compiled, with
    artifact fields filled in step by step. The port's trace also needs the
    call's ``out`` field(s), ``domain`` and ``offset_provider``;
    ``unsupported`` records why the bridge refused the operator (the job
    then stops after ``typed_stage``)."""

    definition_stage: stages.OperatorDefinition
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    type_info: Optional[Any] = None  # pre-deduced info from the decorator
    typed_stage: Optional[stages.TypedDefinition] = None
    fn: Optional[Callable] = None  # specialized callable
    traced_stage: Optional[stages.TracedProgram] = None
    lowered_stage: Optional[stages.LoweredProgram] = None
    compiled_stage: Optional[stages.CompiledProgram] = None
    executable: Optional[Callable] = None
    out: Any = None
    domain: Any = None
    offset_provider: Optional[dict] = None
    unsupported: Optional[str] = None


def _validate(job: CompileJob) -> CompileJob:
    """Definition-time checks (idempotent; decorators already ran them for
    decorated operators, but transforms pipelines can be driven with raw
    functions too)."""
    from gt4py_tpu_torch.next.frontend_validation import validate_definition

    validate_definition(
        job.definition_stage.definition, kind=job.definition_stage.kind
    )
    return job


def _deduce(job: CompileJob) -> CompileJob:
    from gt4py_tpu_torch.next.type_deduction import deduce

    info = job.type_info
    if info is None:
        info = deduce(
            job.definition_stage.definition, kind=job.definition_stage.kind
        )
    job.typed_stage = stages.TypedDefinition(job.definition_stage, info)
    return job


def _specialize(job: CompileJob) -> CompileJob:
    statics = dict(job.definition_stage.static_args)
    fn = job.definition_stage.definition
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


def _rebound(fn: types.FunctionType, namespace: dict) -> types.FunctionType:
    """``fn`` with ``namespace`` as its globals."""
    bound = types.FunctionType(
        fn.__code__, namespace, fn.__name__, fn.__defaults__, fn.__closure__
    )
    bound.__kwdefaults__ = fn.__kwdefaults__
    bound.__dict__.update(fn.__dict__)
    return bound


#: top-level packages whose functions keep reading their live globals: the
#: port's own (its builtins keep their identity for the bridge's tracer),
#: torch and numpy; the standard library and installed packages too
#: (:func:`_user_module`)
_LIVE_PACKAGES = frozenset({"gt4py_tpu_torch", "torch", "numpy"})


def _user_module(namespace: dict) -> bool:
    """Whether ``namespace`` is the globals of a module of the user's own:
    not of :data:`_LIVE_PACKAGES`, the standard library or a package
    installed in ``site-packages``."""
    top = (namespace.get("__name__") or "").split(".")[0]
    path = namespace.get("__file__") or ""
    return bool(top) and top not in _LIVE_PACKAGES and top not in sys.stdlib_module_names \
        and "site-packages" not in path and "dist-packages" not in path


def _snapshot(live: dict, snapshots: dict) -> dict:
    """A copy of the module globals ``live``, made once per module into
    ``snapshots`` (by the dict's id, as ``(live, copy)``): its plain
    functions, and those of user modules (:func:`_user_module`) that it
    reaches, rebound to their own module's copy."""
    if id(live) in snapshots:
        return snapshots[id(live)][1]
    snap = dict(live)
    snapshots[id(live)] = (live, snap)
    for name, value in live.items():
        if not isinstance(value, types.FunctionType):
            continue
        if value.__globals__ is live:
            snap[name] = _rebound(value, snap)
        elif _user_module(value.__globals__):
            snap[name] = _rebound(value, _snapshot(value.__globals__, snapshots))
    return snap


def _stored_globals(code: types.CodeType) -> set:
    """The names ``code``, and the functions and comprehensions nested in
    it, store or delete by a ``global`` statement."""
    names = {ins.argval for ins in dis.get_instructions(code)
             if ins.opname in ("STORE_GLOBAL", "DELETE_GLOBAL")}
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _stored_globals(const)
    return names


_UNBOUND = object()


def _global_writes(fn: types.FunctionType, snapshots: dict) -> list:
    """(module globals, snapshot, {name: value in the snapshot now}) of each
    snapshot that a pinned function (``fn``, or a helper rebound to it)
    writes by ``global``."""
    writes = []
    for live, snap in snapshots.values():
        names = set()
        for value in [fn, *snap.values()]:
            if isinstance(value, types.FunctionType) and value.__globals__ is snap:
                names |= _stored_globals(value.__code__)
        if names:
            writes.append((live, snap, {n: snap.get(n, _UNBOUND) for n in names}))
    return writes


def _write_back(writes: list) -> None:
    """Rebind (or delete) in each module the names that a pinned function
    rebound (or deleted) in the module's snapshot."""
    for live, snap, before in writes:
        for name, old in before.items():
            new = snap.get(name, _UNBOUND)
            if new is old:
                continue
            if new is _UNBOUND:
                live.pop(name, None)
            else:
                live[name] = new


def _restore(writes: list) -> None:
    """Put back in each snapshot the values that the names written by
    ``global`` had when the variant was pinned."""
    for _, snap, before in writes:
        for name, old in before.items():
            if old is _UNBOUND:
                snap.pop(name, None)
            else:
                snap[name] = old


def _pinned(fn: Callable) -> Callable:
    """``fn`` reading module globals as they are now: a variant's module
    constants are fixed when it is built, as the JAX package's ``jax.jit``
    fixes them when it traces (rebinding one later changes no variant
    already built). The plain functions of ``fn``'s module, and those of
    other user modules that its globals reach (imported by name, and what
    theirs reach in turn), read the same snapshots: one per module, shared
    by every helper in it. Functions of the port, torch, numpy, the standard
    library and installed packages stay as they are. What a pinned function
    writes by ``global`` lands in its snapshot. After the first run of the
    variant each such name is written back to its module, as the
    reference's trace writes the module once; every later run starts from
    the snapshot as it was pinned, so it computes what the first run did,
    as the reference's compiled trace does, and leaves the module as it
    is."""
    if isinstance(fn, functools.partial):
        return functools.partial(_pinned(fn.func), *fn.args, **fn.keywords)
    if not isinstance(fn, types.FunctionType):
        return fn
    snapshots: dict = {}
    pinned = _rebound(fn, _snapshot(fn.__globals__, snapshots))
    writes = _global_writes(pinned, snapshots)
    if not writes:
        return pinned
    ran = []

    def run_as_the_first(*args, **kwargs):
        if ran:
            _restore(writes)
        try:
            return pinned(*args, **kwargs)
        finally:
            if not ran:
                ran.append(True)
                _write_back(writes)

    return functools.update_wrapper(run_as_the_first, pinned)


def _compile_eager(job: CompileJob) -> CompileJob:
    """Default compile step: the specialized function, its module
    constants pinned (:func:`_pinned`), is the executable."""
    job.executable = _pinned(job.fn)
    return job


#: the cartesian backend the ahead-of-time stages build for
AOT_CARTESIAN = "cuda:hopper"


def _trace(job: CompileJob) -> CompileJob:
    """The bridge's variant of this argument signature: the definition
    traced into cartesian GTIR and analyzed for ``cuda:hopper``. Where the
    bridge refuses (unstructured offsets, tuple returns, a ``domain=``,
    more than I/J/K, ...), the reason goes to ``job.unsupported``."""
    from gt4py_tpu_torch.next import cartesian_bridge as bridge

    traced = []
    definition = job.definition_stage.definition
    kwargs = {**dict(job.definition_stage.static_args), **job.kwargs}
    try:
        if job.domain is not None:
            raise bridge.BridgeUnsupported("a domain= restricts the out field")
        fields, scalars, key = bridge.call_signature(
            definition, job.args, kwargs, job.out, job.offset_provider, AOT_CARTESIAN
        )
        variant = bridge.build_variant(
            definition, fields, scalars, job.out, job.offset_provider, AOT_CARTESIAN,
            gtir_transform=lambda stencil: traced.append(stencil) or stencil,
        )
    except bridge.BridgeUnsupported as exc:
        job.unsupported = str(exc)
        return job
    assert job.typed_stage is not None
    job.traced_stage = stages.TracedProgram(job.typed_stage, traced[0], variant, key)
    return job


def _lower(job: CompileJob) -> CompileJob:
    """The traced variant's generated CUDA C++ (``cuda_codegen``)."""
    if job.traced_stage is None:
        return job
    backend = job.traced_stage.variant.backend
    job.lowered_stage = stages.LoweredProgram(
        job.traced_stage, backend.module, backend.unsupported
    )
    return job


def _on_card(job: CompileJob) -> bool:
    import torch.utils._pytree as pytree

    from gt4py_tpu_torch.next.embedded import Field

    leaves = pytree.tree_leaves((job.args, job.kwargs, job.out), is_leaf=lambda x: isinstance(x, Field))
    return any(isinstance(f, Field) and f.device.type == "cuda" for f in leaves)


def _compile_aot(job: CompileJob) -> CompileJob:
    """Build and load the lowered kernels where the arguments live on a
    card (one ``nvcc`` per source not yet on disk; CPU tensors build
    nothing and run the plain version). The executable takes the variant's
    arguments and ``out=``, and runs the prebuilt variant: a call traces,
    lowers and builds nothing. Without a lowered stage (the bridge refused)
    the executable is the specialized definition, run embedded, as the
    default compile step makes it."""
    if job.lowered_stage is None:
        return _compile_eager(job)
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.next import cartesian_bridge as bridge

    variant = job.traced_stage.variant
    module = job.lowered_stage.module
    library = log = None
    if module is not None and _on_card(job):
        variant.backend._functions()
        _, library, source_path = cuda_backend._paths(module.source)
        try:
            with open(source_path + ".log") as f:
                log = f.read()
        except OSError:
            log = ""
    definition = job.definition_stage.definition
    statics = dict(job.definition_stage.static_args)

    def executable(*args: Any, out: Any, **kwargs: Any) -> None:
        fields, scalars = bridge.bind_arguments(definition, args, {**statics, **kwargs})
        bridge.execute(variant, fields, scalars, out)

    job.compiled_stage = stages.CompiledProgram(job.lowered_stage, executable, library, log)
    job.executable = executable
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
    trace: Optional[Callable] = None  # the default path traces nothing
    lower: Optional[Callable] = None
    compile: Optional[Callable] = _compile_eager

    def with_rewrites(self, *rewrites: Callable[[Callable], Callable]) -> "Transforms":
        return self.replace(program_transforms=_ProgramTransforms(tuple(rewrites)))


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named execution strategy (reference backend.py:148): ``kind``
    selects the runtime (how operators execute), ``transforms`` builds the
    executable."""

    name: str
    kind: str  # 'eager' | 'pallas' | 'aot' | 'numpy'
    transforms: Transforms = dataclasses.field(default_factory=Transforms)

    def make_job(
        self,
        definition: Callable,
        *,
        op_kind: str = "field_operator",
        static_args: tuple[tuple[str, Any], ...] = (),
        type_info: Any = None,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        **call: Any,
    ) -> CompileJob:
        """Run the transforms on one variant; ``call``: the call's ``out``,
        ``domain`` and ``offset_provider`` (the ahead-of-time trace needs
        them)."""
        job = CompileJob(
            definition_stage=stages.OperatorDefinition(definition, op_kind, static_args),
            args=args,
            kwargs=dict(kwargs or {}),
            type_info=type_info,
            **call,
        )
        job = self.transforms(job)
        assert job.executable is not None, "transforms produced no executable"
        return job

    def make_executable(self, definition: Callable, **options: Any) -> Callable:
        return self.make_job(definition, **options).executable

    def compile_job(
        self, definition: Callable, *args: Any, out: Any = None,
        offset_provider: Optional[dict] = None, **kwargs: Any,
    ) -> CompileJob:
        """Run the transforms and return the full job with every artifact
        (for inspection/formatters)."""
        job = CompileJob(
            definition_stage=stages.OperatorDefinition(definition),
            args=args,
            kwargs=dict(kwargs),
            out=out,
            offset_provider=offset_provider,
        )
        return self.transforms(job)

    def replace(self, **kwargs: Any) -> "Backend":
        return dataclasses.replace(self, **kwargs)


REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    REGISTRY[backend.name] = backend
    return backend


register(Backend(name="torch", kind="eager"))
register(Backend(name="cuda:hopper", kind="pallas"))
register(
    Backend(
        name="cuda:hopper:aot",
        kind="aot",
        transforms=Transforms(trace=_trace, lower=_lower, compile=_compile_aot),
    )
)
register(Backend(name="numpy", kind="numpy", transforms=Transforms(compile=None)))


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
    """The runtime-dispatch kind of a backend spec ('eager', 'pallas',
    'aot', 'numpy') or None for eager execution without the pool."""
    if backend is None:
        return None
    if isinstance(backend, Backend):
        return backend.kind
    resolved = REGISTRY.get(backend)
    if resolved is not None:
        return resolved.kind
    return backend  # legacy free-form strings keep their own dispatch


def cartesian_backend(backend: Union[str, Backend]) -> str:
    """The cartesian backend the bridge builds a field-view backend's
    operators for: the one of the same name, ``cuda:hopper`` for the
    ahead-of-time kind."""
    if backend_kind(backend) == "aot":
        return AOT_CARTESIAN
    return getattr(backend, "name", backend)
