"""Field-view entry points: @field_operator, @scan_operator, @program.

Counterpart of gt4py_tpu/next/decorators.py (role of the reference's
``gt4py.next.ffront.decorator``, src/gt4py/next/ffront/decorator.py:
749,825,515). The definition executes eagerly on embedded torch Fields
(``backend="torch"``, the default, through the compiled-programs pool;
``backend=None`` without it), or, with ``backend="cuda:hopper"``, through
the cartesian bridge onto the port's Hopper kernels, an unstructured
operator onto its generated gather-reduce kernel
(next/unstructured_codegen.py), falling back to embedded execution for
what neither takes;
``"cuda:hopper:aot"`` builds the bridge's variant through explicit
trace, lower and compile stages first (next/backend.py). Results are
written in place into the ``out`` field's tensor.

On the ``torch`` backend a call whose tensors lie on a card is the
counterpart of the JAX package's jitted call: its variant is captured
once into a CUDA graph, the write-back into ``out`` included (the JAX
package's fused write-back, gt4py_tpu/next/decorators.py:111-115), and
every warm call is one replay (next/otf.py); a key's first call runs
eagerly, its second captures. A scan's level loop and a program's
operators are captured whole, the operators inside a program running
inline, as under the JAX package's whole-program jit (a bridged
``cuda:hopper`` operator's Hopper kernels captured with them). On CPU
tensors, within an enclosing capture and where refused (counted by reason
in ``otf.graphs_refused``), calls run eagerly.

``backend="numpy"`` is the oracle (gt4py_tpu/next/decorators.py:509-516,
765-767): the raw definition runs on NumPy-backed Fields, views of the
caller's CPU tensors, so results land in place; a scan runs its level
loop in NumPy. A Field on a card raises a TypeError: nothing is moved
between devices. An operator called on NumPy Fields (inside a ``numpy``
program or operator) runs the same way, whatever its own backend.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from gt4py_tpu_torch.core.definitions import promote_types
from gt4py_tpu_torch.core.ndarray_utils import torch_dtype
from gt4py_tpu_torch.next import otf
from gt4py_tpu_torch.next.common import Dimension, DimensionKind, Domain, NamedRange
from gt4py_tpu_torch.next.embedded import (
    Bf16Array,
    Field,
    _promote_dims,
    _type_of,
    as_numpy_array,
    as_numpy_field,
    current_offset_provider,
    in_numpy_mode,
    numpy_mode,
    offset_provider_context,
    to_device,
)


def _restrict_result(result: "Field", target: Domain, out_dtype) -> torch.Tensor:
    """Slice/permute/cast/broadcast an operator result to ``target``. A
    broadcast-placeholder axis (unbounded range, size-1 axis —
    fbuiltins.broadcast) keeps its single element in the slice and
    expands at the end."""
    slices = []
    for nr in target.ranges:
        if nr.dim not in result.domain:
            raise ValueError(
                f"Output dimension {nr.dim} missing from result {result.domain}"
            )
        rr = result.domain[nr.dim].unit_range
        if not rr.is_finite:
            slices.append(slice(0, 1))
        else:
            if nr.unit_range.start < rr.start or nr.unit_range.stop > rr.stop:
                raise ValueError(
                    f"Output range {nr.dim.value}={nr.unit_range} exceeds the "
                    f"operator result domain {nr.dim.value}={rr} (shifts shrink "
                    "the result; size the out field/domain accordingly)"
                )
            slices.append(slice(nr.unit_range.start - rr.start, nr.unit_range.stop - rr.start))
    perm = [result.domain.index(nr.dim) for nr in target.ranges]
    arr, ops = result.ndarray, result.ops
    if perm != sorted(perm):
        arr = ops.permute(arr, perm)
    value = ops.astype(arr[tuple(slices)], out_dtype)
    target_shape = tuple(len(nr.unit_range) for nr in target.ranges)
    if tuple(value.shape) != target_shape:
        value = ops.expand(value, target_shape)
    return value


def _out_slices(target: Domain, out_domain: Domain) -> tuple:
    return tuple(
        slice(
            nr.unit_range.start - out_domain[nr.dim].unit_range.start,
            nr.unit_range.stop - out_domain[nr.dim].unit_range.start,
        )
        for nr in target.ranges
    )


def shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' byte ranges overlap (conservative for strided
    views), as the kernels' wrapper judges aliasing."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import overlapping

    return a.device == b.device and bool(overlapping({"a": a, "b": b}))


def _updates_in_place(args: tuple, kwargs: dict, out: Any) -> bool:
    """Whether an out field's tensor starts where an argument's does (an
    update in place, ``op(..., vn, out=vn)``) and no field spans two
    horizontal dimensions (a cartesian operator's, which the bridge serves
    first)."""
    def tensors(xs):
        return [f for f in xs if isinstance(f, Field) and isinstance(f.ndarray, torch.Tensor)]

    outs = tensors(out if isinstance(out, tuple) else (out,))
    starts = {o.ndarray.data_ptr() for o in outs}
    ins = [a for a in tensors(itertools.chain(args, kwargs.values()))
           if a.ndarray.data_ptr() in starts]
    return bool(ins) and not any(
        sum(d.kind == DimensionKind.HORIZONTAL for d in f.domain.dims) > 1 for f in ins + outs)


def _write_out(result: Any, out: Any, domain: Optional[Domain]) -> None:
    """Write an operator result into the ``out`` field(s), in place into
    their tensors, restricted to the out domain or to ``domain`` if given.
    A result that shares memory with the out tensor (the out field is
    also an input, read at an offset) is copied first."""
    if isinstance(result, tuple):
        if not isinstance(out, tuple) or len(out) != len(result):
            raise ValueError("Mismatched tuple outputs")
        doms = (
            domain
            if isinstance(domain, tuple)
            else (domain,) * len(result)
        )
        if len(doms) != len(result):
            raise ValueError(
                "domain tuple must match the output tuple structure"
            )
        for r, o, d in zip(result, out, doms):
            _write_out(r, o, d)
        return
    assert isinstance(result, Field) and isinstance(out, Field)
    target = out.domain if domain is None else domain
    value = _restrict_result(result, target, out.dtype)
    dest = out.ndarray
    if domain is not None and target is not out.domain:
        dest = dest[_out_slices(target, out.domain)]
    if isinstance(dest, np.ndarray):
        value = as_numpy_array(value)
        dest[...] = value.copy() if np.may_share_memory(value, dest) else value
        return
    value = to_device(value, dest.device)
    if shares_memory(value, dest):
        value = value.clone()
    dest.copy_(value)


def _symbolic_leaf(values: Any) -> Any:
    """The first of ``values``, or of the tuples among them, that is a
    symbolic value of a cartesian-bridge trace, else None."""
    for v in values:
        if isinstance(v, tuple):
            v = _symbolic_leaf(v)
        if getattr(v, "_gt_symbolic_", False):
            return v
    return None


def _to_numpy(tree: Any) -> Any:
    """``tree`` with each Field over NumPy (views of CPU tensors)."""
    return pytree.tree_map(
        lambda x: as_numpy_field(x) if isinstance(x, Field) else x, tree, is_leaf=_is_field
    )


def _write_back_bf16(out: Any, np_out: Any) -> None:
    """Copy each bfloat16 carrier out field back into its tensor."""
    for f, g in zip(
        pytree.tree_leaves(out, is_leaf=_is_field), pytree.tree_leaves(np_out, is_leaf=_is_field)
    ):
        if isinstance(f, Field) and isinstance(g.ndarray, Bf16Array):
            f.ndarray.copy_(torch.from_numpy(g.ndarray.view(np.ndarray)).to(torch.bfloat16))


def _run_numpy(fn: Callable, args: tuple, kwargs: dict, out: Any, domain: Any) -> None:
    """``fn`` (a raw definition) on NumPy views of the arguments, its
    result written into NumPy views of ``out``."""
    np_out = _to_numpy(out)
    with numpy_mode():
        result = fn(*_to_numpy(args), **_to_numpy(kwargs))
        _write_out(result, np_out, domain)
    _write_back_bf16(out, np_out)


def _first_field(out: Any) -> Optional[Field]:
    if isinstance(out, tuple):
        for o in out:
            f = _first_field(o)
            if f is not None:
                return f
        return None
    return out if isinstance(out, Field) else None


def _graphs(owner: Any, kind: str) -> "otf.GraphCache":
    """The CUDA graphs of an operator, scan or program (made at first use)."""
    graphs = owner.__dict__.get("_graphs")
    if graphs is None:
        graphs = owner.__dict__["_graphs"] = otf.GraphCache(kind)
    return graphs


def _make_domain(domain: Any):
    """``domain=`` as a Domain, or a tuple of them for tuple outputs
    (reference test_multiple_output_domains.py:
    ``domain=({J: ...}, {I: ...})``)."""
    from gt4py_tpu_torch.next.common import domain as make_domain

    if isinstance(domain, tuple):
        return tuple(make_domain(d) if d is not None else None for d in domain)
    return make_domain(domain) if domain is not None else None


@dataclasses.dataclass
class FieldOperator:
    """Callable field operator (reference decorator.py:561).

    Dispatches through a :class:`CompiledProgramsPool` keyed by argument
    signature + static-parameter values + offset-provider fingerprint
    (reference otf/compiled_program.py:333); ``compile()`` builds variants
    ahead of the first call (reference decorator.py:161)."""

    definition: Callable
    backend: Optional[str] = "torch"
    options: Any = None  # CompilationOptions; None -> defaults
    # Deduced signature (next/type_deduction.py) when the definition is
    # annotated; None = legacy unannotated operator (deduction off).
    type_info: Any = None
    # FOAST transform knobs (next/foast.TransformOptions); None -> the
    # env-resolved default pipeline (folding + CSE + DCE on).
    transform_options: Any = None

    def __post_init__(self):
        from gt4py_tpu_torch.next.otf import CompilationOptions, CompiledProgramsPool

        if self.options is None:
            self.options = CompilationOptions()
        self._pool = CompiledProgramsPool(self._make_executable, self.options)

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_pool", None)
        state.pop("_foast_cache", None)
        state.pop("_bridge_cache", None)
        state.pop("_aot_jobs", None)
        state.pop("_graphs", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__post_init__()

    def with_backend(self, backend: Optional[str]) -> "FieldOperator":
        return FieldOperator(
            self.definition, backend, self.options, self.type_info,
            self.transform_options,
        )

    def with_transforms(self, options: Any = None, **kwargs: Any) -> "FieldOperator":
        """Select FOAST transform options (the analog of the reference
        pass-manager knobs, iterator/transforms/pass_manager.py:135-144):
        ``op.with_transforms(unroll_reduce=True)``,
        ``op.with_transforms(extract_temporaries=True)``,
        ``op.with_transforms(enabled=False)`` (run the raw definition)."""
        from gt4py_tpu_torch.next.foast import default_options

        base = options if options is not None else (
            self.transform_options or default_options()
        )
        opts = base.replace(**kwargs) if kwargs else base
        return FieldOperator(
            self.definition, self.backend, self.options, self.type_info, opts
        )

    def inspect(self, *args, stage: str = "foast", offset_provider: Optional[dict] = None,
                **kwargs) -> str:
        """Textual program artifact: ``stage="foast"``, the post-pass
        generated source. The JAX package's jaxpr / StableHLO / HLO stages
        are XLA's and have no counterpart here."""
        if stage != "foast":
            raise ValueError(f"Unknown stage {stage!r} (expected foast)")
        from gt4py_tpu_torch.next.foast import foast_source

        with offset_provider_context(offset_provider):
            return foast_source(self)

    def with_compilation_options(self, options=None, **kwargs) -> "FieldOperator":
        """Reference decorator.py:111 (`with_compilation_options`)."""
        opts = options if options is not None else self.options.replace(**kwargs)
        return FieldOperator(
            self.definition, self.backend, opts, self.type_info,
            self.transform_options,
        )

    def _make_executable(self, args, kwargs) -> Callable:
        from gt4py_tpu_torch.next.backend import Backend, resolve

        be = resolve(self.backend) if isinstance(self.backend, (str, Backend)) else None
        if be is None or be.transforms.compile is None:
            # no executable to build (the numpy backend runs the raw
            # definition at the call)
            from gt4py_tpu_torch.next.foast import exec_definition

            statics = {k: v for k, v in kwargs.items() if k in self.options.static_params}
            definition = exec_definition(self)
            return functools.partial(definition, **statics) if statics else definition
        return self._make_job(be, args, kwargs).executable

    def _make_job(self, be, args, kwargs, **call):
        """One variant built through the backend's Transforms workflow
        (reference backend.py:154 Backend.compile: user-replaced steps
        apply); ``call``: the ahead-of-time kind's ``out``, ``domain`` and
        ``offset_provider``."""
        from gt4py_tpu_torch.next.foast import exec_definition

        definition = exec_definition(self)
        if definition is not self.definition and not hasattr(definition, "__wrapped__"):
            # the generated function's source is the definition's: its
            # stage fingerprints (fingerprinting.fingerprint_function) are
            # then stable across operators of the same definition
            definition.__wrapped__ = self.definition
        statics = {k: v for k, v in kwargs.items() if k in self.options.static_params}
        dynamic = {k: v for k, v in kwargs.items() if k not in statics}
        return be.make_job(
            definition,
            op_kind="field_operator",
            static_args=tuple(sorted(statics.items())),
            type_info=self.type_info,
            args=args,
            kwargs=dynamic,
            **call,
        )

    def _aot_job(self, args, kwargs, out, domain, offset_provider):
        """The ``cuda:hopper:aot`` CompileJob of this call. Its stages run
        once per variant key of the bridge, at ``compile()`` or at the
        first call; the traced variant (None where the bridge refused) goes
        into the bridge cache that the calls read (``try_call``)."""
        from gt4py_tpu_torch.next import cartesian_bridge as bridge
        from gt4py_tpu_torch.next.backend import AOT_CARTESIAN, resolve

        jobs = self.__dict__.setdefault("_aot_jobs", {})
        try:
            key = None if domain is not None else bridge.call_signature(
                self.definition, args, kwargs, out, offset_provider, AOT_CARTESIAN)[2]
        except bridge.BridgeUnsupported:
            key = None  # runs embedded; the job's trace says why
        if key in jobs:
            return jobs[key]
        job = self._make_job(resolve(self.backend), args, kwargs, out=out, domain=domain,
                             offset_provider=offset_provider)
        if key is not None:
            jobs[key] = job
            traced = job.traced_stage
            self.__dict__.setdefault("_bridge_cache", {})[key] = (
                traced.variant if traced is not None else None)
        return job

    def _aot_variant(self, args, kwargs, out, offset_provider):
        """The variant of an ahead-of-time call the bridge cache misses,
        made by the stages (:meth:`_aot_job`)."""
        from gt4py_tpu_torch.next.cartesian_bridge import BridgeUnsupported

        job = self._aot_job(args, kwargs, out, None, offset_provider)
        if job.traced_stage is None:
            raise BridgeUnsupported(job.unsupported)
        return job.traced_stage.variant

    def _aot_neighbor(self, args, kwargs, out, offset_provider):
        """The unstructured program of an ahead-of-time call, made by the
        stages (:meth:`_aot_job`: the trace lowers what the bridge refuses)."""
        from gt4py_tpu_torch.next.unstructured_codegen import Declined

        job = self._aot_job(args, kwargs, out, None, offset_provider)
        if job.unstructured is None:
            raise Declined(job.unsupported or "")
        return job.unstructured

    def compiled_job(self, *args, out: Any = None, offset_provider: Optional[dict] = None,
                     domain: Any = None, **kwargs):
        """The CompileJob of the ``cuda:hopper:aot`` variant for these
        arguments (built if it was not), with every stage it reached."""
        from gt4py_tpu_torch.next.backend import backend_kind

        if backend_kind(self.backend) != "aot":
            raise ValueError(f"operator on {self.backend!r} has no ahead-of-time stages")
        with offset_provider_context(offset_provider):
            return self._aot_job(args, kwargs, out, _make_domain(domain), offset_provider)

    def compile(self, *args, offset_provider: Optional[dict] = None, **kwargs) -> "FieldOperator":
        """Build variants for the given example arguments ahead of the
        first call (reference AOT compile(), decorator.py:161). A LIST
        value for a declared static parameter enumerates variants — the
        cross product of all such lists is built. Returns self."""
        from gt4py_tpu_torch.next.backend import backend_kind

        # out= and domain= are not arguments of the definition: a call keys
        # its variant without them; the ahead-of-time stages trace for them
        out, domain = kwargs.pop("out", None), _make_domain(kwargs.pop("domain", None))
        if backend_kind(self.backend) == "aot":
            with offset_provider_context(offset_provider):
                self._aot_job(args, kwargs, out, domain, offset_provider)
            return self
        list_params = {
            k: v
            for k, v in kwargs.items()
            if k in self.options.static_params and isinstance(v, list)
        }
        with offset_provider_context(offset_provider):
            if not list_params:
                self._pool.precompile(args, kwargs, offset_provider)
                return self
            names = sorted(list_params)
            for combo in itertools.product(*(list_params[n] for n in names)):
                variant = dict(kwargs)
                variant.update(dict(zip(names, combo)))
                self._pool.precompile(args, variant, offset_provider)
        return self

    def __call__(
        self,
        *args,
        out: Any = None,
        offset_provider: Optional[dict] = None,
        domain: Optional[Union[Domain, dict]] = None,
        **kwargs,
    ):
        from gt4py_tpu_torch.next.foast import exec_definition

        if out is None:
            # Called from inside another field operator: plain application
            # (through the callee's own FOAST pipeline, so transforms
            # compose across nested operator calls).
            return exec_definition(self)(*args, **kwargs)
        OPERATOR_CALLS[0] += 1
        if self.type_info is not None:
            from gt4py_tpu_torch.next.type_deduction import check_call_args, check_out_arg

            op_name = getattr(self.definition, "__name__", "field_operator")
            check_call_args(self.type_info, args, kwargs, name=op_name)
            check_out_arg(self.type_info, out, name=op_name)
        from gt4py_tpu_torch.instrumentation.spans import span
        from gt4py_tpu_torch.next.backend import backend_kind

        dom = _make_domain(domain)
        name = getattr(self.definition, "__name__", "field_operator")
        # The call's root span: the stencil_call hooks and the leveled
        # "total" metric (reference ffront/decorator.py:62-83,
        # instrumentation/metrics.py:240).
        with span("gt4py.next.call", source=name, metric="total", hook=name):
            with offset_provider_context(offset_provider):
                kind = backend_kind(self.backend)
                if kind == "numpy" or in_numpy_mode():
                    # the oracle: the raw definition on NumPy Fields
                    _run_numpy(self.definition, args, kwargs, out, dom)
                    return
                if kind in ("pallas", "aot"):
                    # Structured (cartesian-offset) operators execute on the
                    # cartesian Hopper kernels, unstructured ones on the
                    # generated gather-reduce kernel; what neither takes falls
                    # through to embedded. The ahead-of-time kind makes its
                    # variants through its stages.
                    from gt4py_tpu_torch.next import unstructured_codegen
                    from gt4py_tpu_torch.next.backend import cartesian_backend
                    from gt4py_tpu_torch.next.cartesian_bridge import try_call

                    # the generated gather-reduce kernel (next/unstructured_codegen.py)
                    # takes what the bridge refuses for connectivities, and first
                    # an update in place, which it writes without the copy of the
                    # argument the bridge takes; the provider is the call's, or
                    # the program's it is called in
                    in_place = _updates_in_place(args, kwargs, out)
                    provider = current_offset_provider()
                    neighbor = functools.partial(
                        unstructured_codegen.try_call, self, args, kwargs, out, dom, provider,
                        None if kind == "pallas" else functools.partial(
                            self._aot_neighbor, args, kwargs, out, provider))
                    if in_place and neighbor():
                        return
                    make = None if kind == "pallas" else functools.partial(
                        self._aot_variant, args, kwargs, out, provider)
                    if dom is None and try_call(self, args, kwargs, out, offset_provider,
                                                cartesian_backend(self.backend), make):
                        return
                    if not in_place and neighbor():
                        return
                    result = exec_definition(self)(*args, **kwargs)
                elif kind == "eager":
                    self._call_torch(args, kwargs, out, dom, offset_provider)
                    return
                else:
                    result = exec_definition(self)(*args, **kwargs)
                _write_out(result, out, dom)

    def _eager(self, args, kwargs, dynamic, offset_provider):
        """The definition's result, run eagerly: by the pooled executable,
        or with ``enable_jit=False`` by the definition itself, the pool left
        empty (the JAX package's eager path)."""
        if not self.options.enable_jit:
            from gt4py_tpu_torch.next.foast import exec_definition

            return exec_definition(self)(*args, **kwargs)
        return self._pool.lookup(args, kwargs, offset_provider)(*args, **dynamic)

    def _call_torch(self, args, kwargs, out, dom, offset_provider) -> None:
        """A call on the ``torch`` backend, the counterpart of the JAX
        package's jitted call with its fused write-back
        (gt4py_tpu/next/decorators.py:533-565). With card tensors: one
        replay of the CUDA graph of the call's variant key, captured at the
        key's second call from the pooled ``GraphExecutable`` and the
        write-back into ``out`` (its first call runs them eagerly,
        ``otf.serve``). On CPU tensors, inline within an
        enclosing capture, and where refused (counted): the definition
        eagerly, then the write-back."""
        dynamic = {k: v for k, v in kwargs.items() if k not in self.options.static_params}

        def work():
            ex = self._pool.lookup(args, kwargs, offset_provider)
            if isinstance(ex, otf.GraphExecutable):
                return lambda: _write_out(ex(*args, **dynamic), out, dom)
            return None

        if not otf.serve(lambda: _graphs(self, "field_operator"), (args, kwargs, out, dom),
                         current_offset_provider(), work,
                         None if self.options.enable_jit else otf.REFUSED_OPTIONS):
            _write_out(self._eager(args, kwargs, dynamic, offset_provider), out, dom)

    def __get__(self, obj, objtype=None):
        return self


def field_operator(definition: Optional[Callable] = None, *, backend: str | None = "torch"):
    """Declare a field operator (reference decorator.py:749)."""
    from gt4py_tpu_torch.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="field_operator")
        from gt4py_tpu_torch.next.type_deduction import deduce

        info = deduce(fn, kind="field_operator")
        return functools.wraps(fn)(FieldOperator(fn, backend, None, info))

    return wrap(definition) if definition is not None else wrap


def _is_field(x: Any) -> bool:
    return isinstance(x, Field)


@dataclasses.dataclass
class _Column:
    """A scan argument aligned onto the scan's domain: its tensor (all
    dims) and whether it is of weak type."""

    array: torch.Tensor
    weak: bool


def _level_tensor(value: Any, shape: tuple, device: torch.device, dtype: torch.dtype):
    """One level of a scan result as a tensor of the level's shape."""
    if isinstance(value, Field):
        return value.ndarray.to(device=device, dtype=dtype).expand(shape)
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).expand(shape)
    return torch.full(shape, value.item() if isinstance(value, np.generic) else value,
                      dtype=dtype, device=device)


def _level_type(value: Any) -> Any:
    if isinstance(value, Field):
        return _type_of(value.ndarray, value.weak)
    return _type_of(value)


@dataclasses.dataclass
class ScanOperator:
    """Vertical scan operator (reference decorator.py:825): the definition
    is a per-level function ``f(carry, *args) -> carry`` (or tuple carry),
    executed along ``axis`` level by level, vectorized over all other
    dimensions."""

    definition: Callable
    axis: Dimension
    forward: bool
    init: Any
    backend: Optional[str] = "torch"
    # Deduced signature (next/type_deduction.py); params[0] is the carry.
    type_info: Any = None
    # FOAST transform knobs for the per-level body (next/foast).
    transform_options: Any = None

    def with_backend(self, backend: Optional[str]) -> "ScanOperator":
        return ScanOperator(
            self.definition, self.axis, self.forward, self.init, backend,
            self.type_info, self.transform_options,
        )

    def with_transforms(self, options: Any = None, **kwargs: Any) -> "ScanOperator":
        """FOAST transform options for the per-level body — see
        FieldOperator.with_transforms."""
        from gt4py_tpu_torch.next.foast import default_options

        base = options if options is not None else (
            self.transform_options or default_options()
        )
        opts = base.replace(**kwargs) if kwargs else base
        return ScanOperator(
            self.definition, self.axis, self.forward, self.init, self.backend,
            self.type_info, opts,
        )

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_foast_cache", None)  # generated functions do not pickle
        state.pop("_bridge_cache", None)
        state.pop("_graphs", None)
        return state

    def __call__(
        self,
        *args,
        out: Any = None,
        offset_provider: Optional[dict] = None,
        domain: Optional[Union[Domain, dict]] = None,
        **kwargs,
    ):
        # Called on symbolic values inside a cartesian-bridge trace: inline
        # as a sequential vertical loop of the enclosing stencil.
        symbolic = _symbolic_leaf((*args, *kwargs.values()))
        if symbolic is not None:
            return symbolic.tr.trace_scan(self, args, kwargs)
        if self.type_info is not None and out is not None:
            from gt4py_tpu_torch.next.type_deduction import OperatorTypeInfo, check_call_args

            names = list(self.type_info.params)
            trimmed = OperatorTypeInfo(
                params={n: self.type_info.params[n] for n in names[1:]},
                returns=self.type_info.returns,
            )
            check_call_args(
                trimmed, args, kwargs,
                name=getattr(self.definition, "__name__", "scan_operator"),
                element_only=True,
            )
        from gt4py_tpu_torch.next.backend import backend_kind

        if out is not None:
            OPERATOR_CALLS[0] += 1
        dom = _make_domain(domain)
        kind = backend_kind(self.backend)
        if out is not None and (kind == "numpy" or in_numpy_mode()):
            # the oracle: the level loop in NumPy, on views of the arguments
            out_domain = _first_field(out).domain
            with offset_provider_context(offset_provider):
                _run_numpy(lambda *a, **kw: self._apply(a, kw, out_domain=out_domain),
                           args, kwargs, out, dom)
            return None
        if kind in ("pallas", "aot") and out is not None and dom is None:
            # Structured scans lower onto the cartesian sequential-K Hopper
            # kernels; unsupported shapes fall through to embedded.
            from gt4py_tpu_torch.next.backend import cartesian_backend
            from gt4py_tpu_torch.next.cartesian_bridge import try_call_scan

            with offset_provider_context(offset_provider):
                if try_call_scan(self, args, kwargs, out, offset_provider,
                                 cartesian_backend(self.backend)):
                    return None
        with offset_provider_context(offset_provider):
            first = _first_field(out)
            apply = functools.partial(
                self._apply, args, kwargs,
                out_domain=first.domain if first is not None else None,
                device=first.device if first is not None else None,
            )
            if out is None:
                return apply()
            # the pooled jitted scan's counterpart (gt4py_tpu/next/
            # decorators.py:711-741): the level loop and its write-back,
            # one CUDA graph per variant key
            if kind == "eager" and otf.serve(
                    lambda: _graphs(self, "scan_operator"), (args, kwargs, out, dom),
                    current_offset_provider(), lambda: lambda: _write_out(apply(), out, dom)):
                return None
            _write_out(apply(), out, dom)
        return None

    def _aligned(self, args, out_domain: Optional[Domain], wrap: Callable):
        """The scan's domain and its arguments aligned onto it: (dims,
        domain, index of ``axis`` in dims, the arguments with each Field
        leaf replaced by ``wrap(leaf, its aligned array)``). Arguments are
        pytrees: nested tuples of Fields and scalars ride as single scan
        arguments (reference test_tuple_scalar_scan,
        test_scan_nested_tuple_input)."""
        field_args = [
            leaf
            for a in args
            for leaf in pytree.tree_leaves(a, is_leaf=_is_field)
            if isinstance(leaf, Field)
        ]
        if field_args:
            dims = field_args[0].dims
            for f in field_args[1:]:
                dims = _promote_dims(dims, f.dims)
        elif out_domain is not None:
            # No field inputs (pure carry iteration, reference
            # test_scan_nested_tuple_output): the out field supplies the
            # iteration domain.
            dims = out_domain.dims
        else:
            raise ValueError(
                "scan operator without Field arguments needs an out= field "
                "to define its domain"
            )
        if self.axis not in dims:
            raise ValueError(f"scan axis {self.axis} not present in arguments")
        # Common domain: per promoted dim, intersect the ranges of every
        # field that HAS the dim (a K-only column + an (I, K) plane must
        # broadcast the column across I, so no single argument can serve
        # as the alignment reference).
        common_ranges = []
        for d in dims:
            r = None
            for f in field_args:
                if d in f.domain:
                    rr = f.domain[d].unit_range
                    r = rr if r is None else r.intersection(rr)
            if r is None:
                r = out_domain[d].unit_range
            common_ranges.append(NamedRange(d, r))
        ref = Field.__new__(Field)
        ref.domain = Domain(tuple(common_ranges))
        dom = None if field_args else ref.domain

        def align_leaf(leaf):
            nonlocal dom
            if isinstance(leaf, Field):
                d, arr = leaf._aligned(dims, ref)
                dom = d if dom is None else dom.intersection(d)
                return wrap(leaf, arr)
            return leaf

        aligned = [pytree.tree_map(align_leaf, a, is_leaf=_is_field) for a in args]
        return dims, dom, dims.index(self.axis), aligned

    def _levels(self, definition: Callable, carry: Any, at_level: Callable, nk: int, kwargs):
        """The carry after each level of ``axis``, in the axis' order."""
        levels = []
        order = range(nk) if self.forward else range(nk - 1, -1, -1)
        for k in order:
            carry = definition(carry, *at_level(k), **kwargs)
            levels.append(carry)
        if not levels:
            raise ValueError(f"scan over an empty {self.axis} range")
        if not self.forward:
            levels.reverse()
        return levels

    def _apply(self, args, kwargs, out_domain: Optional[Domain] = None, device: Any = None):
        """The embedded scan: the definition runs once per level of
        ``axis``, in order, on Fields over the other dimensions (the JAX
        package's ``lax.scan``); the levels are stacked along ``axis``,
        which leads the result's layout. ``device``: where a scan without
        Field arguments puts its result (the out field's)."""
        from gt4py_tpu_torch.next.foast import exec_definition

        if in_numpy_mode():
            return self._apply_numpy(_to_numpy(args), kwargs, out_domain)
        dims, dom, k_axis, aligned = self._aligned(
            args, out_domain, lambda leaf, arr: _Column(arr, leaf.weak)
        )
        level_dom = Domain(tuple(r for i, r in enumerate(dom.ranges) if i != k_axis))
        level_shape = tuple(s for i, s in enumerate(dom.shape) if i != k_axis)
        columns = [
            leaf for a in aligned for leaf in pytree.tree_leaves(a) if isinstance(leaf, _Column)
        ]
        if columns:
            device = columns[0].array.device

        def pick(k, leaf):
            if isinstance(leaf, _Column):
                return Field(level_dom, leaf.array.select(k_axis, k), None, leaf.weak)
            return leaf

        def at_level(k):
            return tuple(pytree.tree_map(functools.partial(pick, k), a) for a in aligned)

        levels = self._levels(
            exec_definition(self), self.init, at_level, dom.shape[k_axis], kwargs
        )
        leaves = [pytree.tree_leaves(lv, is_leaf=_is_field) for lv in levels]
        spec = pytree.tree_structure(levels[0], is_leaf=_is_field)
        stacked = []
        for j in range(len(leaves[0])):
            column = [lv[j] for lv in leaves]
            dt, _ = promote_types(*(_level_type(v) for v in column))
            tdt = torch_dtype(dt)
            arr = torch.stack([_level_tensor(v, level_shape, device, tdt) for v in column])
            stacked.append(Field(dom, arr.movedim(0, k_axis)))
        return pytree.tree_unflatten(stacked, spec)

    def _apply_numpy(self, args, kwargs, out_domain: Optional[Domain] = None):
        """The NumPy scan (gt4py_tpu/next/decorators.py:765-767 and its
        level loop): the RAW definition runs once per level on the
        arguments' NumPy planes (the oracle's independence: no FOAST), the
        carry starting as ``init`` broadcast to a plane, and the levels are
        stacked along ``axis``."""
        dims, dom, k_axis, aligned = self._aligned(args, out_domain, lambda leaf, arr: arr)
        nk = dom.shape[k_axis]
        non_k_shape = tuple(s for i, s in enumerate(dom.shape) if i != k_axis)

        def to_levels(a):
            if hasattr(a, "ndim") and a.ndim == len(dims):
                return np.moveaxis(a, k_axis, 0)
            return np.broadcast_to(np.asarray(a), (nk,) + non_k_shape)

        carry = pytree.tree_map(lambda v: np.broadcast_to(np.asarray(v), non_k_shape), self.init)
        xs = tuple(pytree.tree_map(to_levels, a) for a in aligned)
        levels = self._levels(
            self.definition, carry,
            lambda k: tuple(pytree.tree_map(lambda level: level[k], x) for x in xs), nk, kwargs,
        )
        stacked = pytree.tree_map(lambda *ls: np.stack(ls), *levels)
        return pytree.tree_map(lambda arr: Field(dom, np.moveaxis(arr, 0, k_axis)), stacked)

    def __get__(self, obj, objtype=None):
        return self


def scan_operator(
    definition: Optional[Callable] = None,
    *,
    axis: Dimension,
    forward: bool = True,
    init: Any = 0.0,
    backend: str | None = "torch",
):
    """Declare a column scan operator (reference decorator.py:825)."""

    from gt4py_tpu_torch.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="scan_operator")
        _validate_scan_signature(fn, init)
        from gt4py_tpu_torch.next.type_deduction import deduce

        info = deduce(fn, kind="scan_operator")
        return functools.wraps(fn)(ScanOperator(fn, axis, forward, init, backend, info))

    return wrap(definition) if definition is not None else wrap


def _validate_scan_signature(fn: Callable, init: Any) -> None:
    """Decoration-time scan checks (reference foast_passes type
    deduction: carry/return/init agreement, at least one argument)."""
    import inspect

    from gt4py_tpu_torch.next import errors
    from gt4py_tpu_torch.next import type_system as ts

    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    if not params:
        raise errors.DSLTypeError(
            None,
            f"Scan operator '{fn.__name__}' must have at least one "
            "argument (the carry/state)",
        )
    globalns = getattr(fn, "__globals__", {})

    def spec_of(ann):
        if ann is inspect.Parameter.empty or ann is inspect.Signature.empty:
            return None
        try:
            return ts.from_annotation(ann, globalns)
        except Exception:
            return None

    def skeleton(t):
        """tuple structure + scalar kind — loose enough to permit what
        deduction cannot prove, strict on provable mismatches."""
        if isinstance(t, ts.TupleType):
            return tuple(skeleton(x) for x in t.types)
        if isinstance(t, ts.ScalarType):
            return t.dtype.kind
        if isinstance(t, ts.FieldType):
            return t.dtype.kind
        return "?"

    carry_t = spec_of(params[0].annotation)
    ret_t = spec_of(sig.return_annotation)
    if carry_t is not None and ret_t is not None:
        if skeleton(carry_t) != skeleton(ret_t):
            raise errors.DSLTypeError(
                None,
                f"Argument '{params[0].name}' to scan operator "
                f"'{fn.__name__}' must have same type as its return "
                f"(got {carry_t} vs {ret_t})",
            )
    if carry_t is not None and init is not None:
        try:
            init_t = ts.from_value(init)
        except Exception:
            init_t = None
        if init_t is not None and skeleton(init_t) != skeleton(carry_t):
            raise errors.DSLTypeError(
                None,
                f"Argument 'init' to scan operator '{fn.__name__}' must "
                f"have same type as '{params[0].name}' argument "
                f"(got {init_t} vs {carry_t})",
            )


@dataclasses.dataclass
class Program:
    """Declarative program: a function whose body calls field operators
    with ``out=`` arguments (reference decorator.py:226). On the ``torch``
    backend with card tensors the whole body is one CUDA graph, the
    operators in it inline (the JAX package's whole-program jit,
    gt4py_tpu/next/decorators.py:1045-1159); within ``otf.inline_calls()``
    it runs eagerly, its operators inline. Otherwise the body executes
    eagerly and each operator dispatches on its own."""

    definition: Callable
    backend: Optional[str] = "torch"
    bound_args: Optional[dict] = None

    def with_backend(self, backend: Optional[str]) -> "Program":
        return Program(self.definition, backend, self.bound_args)

    def with_bound_args(self, **bound: Any) -> "Program":
        """Bind keyword arguments ahead of time (reference
        ProgramWithBoundArgs, decorator.py:431). Unknown names are
        rejected at bind time."""
        params = set(self._param_order())
        for name in bound:
            if name not in params:
                raise TypeError(
                    f"Keyword argument {name!r} is not a valid program parameter"
                )
        merged = {**(self.bound_args or {}), **bound}
        return Program(self.definition, self.backend, merged)

    def _param_order(self) -> list:
        """Parameter names in signature order (positional then kwonly)."""
        order = self.__dict__.get("_sig_params")
        if order is None:
            import inspect

            order = list(inspect.signature(self.definition).parameters)
            self.__dict__["_sig_params"] = order
        return order

    def inspect(self, stage: str = "past") -> str:
        """The program's PAST-generated source after passes (reference
        past pretty printing; see FieldOperator.inspect for the
        expression-level stage)."""
        if stage != "past":
            raise ValueError(f"Unknown stage {stage!r} (expected past)")
        from gt4py_tpu_torch.next.past import past_source

        return past_source(self)

    def __call__(self, *args, offset_provider: Optional[dict] = None, **kwargs):
        if self.bound_args:
            overlap = set(self.bound_args) & set(kwargs)
            if overlap:
                raise TypeError(
                    f"Arguments {sorted(overlap)} are already bound on this program"
                )
            kwargs = {**self.bound_args, **kwargs}
        from gt4py_tpu_torch.next.backend import backend_kind
        from gt4py_tpu_torch.next.past import exec_program

        if backend_kind(self.backend) == "numpy":
            # the oracle: the body on NumPy views of the arguments, so every
            # operator it calls runs in NumPy and writes in place
            np_args, np_kwargs = _to_numpy(args), _to_numpy(kwargs)
            with offset_provider_context(offset_provider), numpy_mode():
                exec_program(self)(*np_args, **np_kwargs)
            _write_back_bf16((args, kwargs), (np_args, np_kwargs))
            return
        definition = exec_program(self)
        with offset_provider_context(offset_provider), _ProgramSpan(self, args, kwargs):
            if backend_kind(self.backend) == "eager" and otf.serve(
                    lambda: _graphs(self, "program"), (args, kwargs), current_offset_provider(),
                    lambda: functools.partial(_run_inline, definition, args, kwargs)):
                return
            definition(*args, **kwargs)

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_past_cache", None)  # generated functions do not pickle
        state.pop("_graphs", None)
        return state


#: field-operator and scan-operator calls with ``out=`` made so far (a
#: program's span counts those its call makes)
OPERATOR_CALLS = [0]


def _kernel_launches() -> int:
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    return sum(w.launches for w in cuda_backend.WRAPPERS.values())


class _ProgramSpan:
    """The root span ``gt4py.next.program`` of a program's call on card
    tensors, where a span records (``instrumentation.spans.span``): its
    attributes ``operators`` (the operator calls the program made),
    ``launches`` (the port's kernels launched or replayed in it,
    ``cuda_backend.WRAPPERS``) and ``masked`` (its calls the generated
    kernel served masking skip values, ``unstructured_codegen.calls_served``).
    The operators' ``gt4py.next.call`` spans nest under it. Nothing on CPU
    tensors or where no span records."""

    __slots__ = ("span", "operators", "launches", "masked")

    def __init__(self, prog: Program, args: tuple, kwargs: dict):
        from gt4py_tpu_torch.instrumentation.spans import NO_SPAN, span

        self.span = span("gt4py.next.program",
                         source=getattr(prog.definition, "__name__", "program"))
        if self.span is NO_SPAN or not _on_card((args, kwargs)):
            self.span = None

    def __enter__(self) -> "_ProgramSpan":
        if self.span is not None:
            self.span.__enter__()
            self.operators, self.launches = OPERATOR_CALLS[0], _kernel_launches()
            self.masked = _masked_calls()
        return self

    def __exit__(self, *exc) -> bool:
        if self.span is None:
            return False
        self.span.set("operators", OPERATOR_CALLS[0] - self.operators)
        self.span.set("launches", _kernel_launches() - self.launches)
        self.span.set("masked", _masked_calls() - self.masked)
        return self.span.__exit__(*exc)


def _masked_calls() -> int:
    from gt4py_tpu_torch.next.unstructured_codegen import calls_served

    return calls_served["masked"]


def _on_card(tree: Any) -> bool:
    """Whether a Field in ``tree`` (tuples, lists, dicts) holds a tensor on a
    card (``otf.on_card``)."""
    if isinstance(tree, Field):
        return isinstance(tree.ndarray, torch.Tensor) and otf.on_card(tree.ndarray.device)
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return False
    return any(_on_card(x) for x in tree)


def _run_inline(definition: Callable, args: tuple, kwargs: dict) -> None:
    """A program's body with its operators inline (no graph of their own)."""
    with otf.inline_calls():
        definition(*args, **kwargs)


def program(definition: Optional[Callable] = None, *, backend: str | None = "torch"):
    from gt4py_tpu_torch.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="program")
        # Decoration-time PAST compile: program type errors (bad operator
        # arguments, mismatched out= fields) surface here, before any call
        # (reference past_passes type deduction). The result is discarded —
        # exec_program re-compiles lazily so closure cells filled after
        # decoration are honored.
        from gt4py_tpu_torch.next.past import compile_to_python

        compile_to_python(fn)
        return functools.wraps(fn)(Program(fn, backend))

    return wrap(definition) if definition is not None else wrap
