"""Test-case kit for the port's field-view feature tests.

The port's counterpart of tests/next_tests/cases.py (itself the reference
allocation/verification kit, tests/next_tests/integration_tests/
cases.py:114-253,440,503): ``Case``, ``allocate(...)`` with initializer
strategies, ``verify``, ``verify_with_default_data``, and the
``cartesian_case`` / ``unstructured_case`` fixtures, written against
``gt4py_tpu_torch.next``. Two differences:

- the fixtures cover the port's four field-view backends: ``None``
  (embedded), ``torch``, ``cuda:hopper`` (on CPU tensors its kernels'
  plain version) and ``numpy`` (the oracle);
- fields live on :data:`DEVICE` (the CPU unless a caller sets it, as
  chip_smoke.py does for the card): :func:`zeros`, :func:`ones`,
  :func:`full`, :func:`as_field` and ``Case.as_field`` allocate there, and
  :func:`on_device` switches it for a block.

It imports no JAX: chip_smoke.py runs the feature cases with it on the
card's machine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset
from gt4py_tpu_torch.next.type_system import (
    FieldType,
    ScalarType,
    TupleType,
    TypeSpec,
    from_annotation,
)

#: where the kit allocates fields and connectivities
DEVICE = "cpu"
#: the port's field-view backends the fixtures run
BACKENDS = (None, "torch", "cuda:hopper", "numpy")
BACKEND_IDS = ("embedded", "torch", "cuda_hopper", "numpy")


@contextlib.contextmanager
def on_device(device):
    """Allocate on ``device`` within the block."""
    global DEVICE
    saved, DEVICE = DEVICE, device
    try:
        yield
    finally:
        DEVICE = saved


def zeros(domain_spec, dtype: Any = np.float64) -> gtx.Field:
    return gtx.zeros(domain_spec, dtype, device=DEVICE)


def ones(domain_spec, dtype: Any = np.float64) -> gtx.Field:
    return gtx.ones(domain_spec, dtype, device=DEVICE)


def full(domain_spec, value: Any, dtype: Any = None) -> gtx.Field:
    return gtx.full(domain_spec, value, dtype, device=DEVICE)


def as_field(domain, data) -> gtx.Field:
    return gtx.as_field(domain, np.asarray(data), device=DEVICE)


# -- standard grids (reference cases.py: IDim/JDim/KDim + toy mesh) ----------

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)

Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))
Koff = FieldOffset("Koff", source=KDim, target=(KDim,))

Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
Cell = Dimension("Cell")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))

IField = gtx.Field[gtx.Dims[IDim], np.float64]
IJField = gtx.Field[gtx.Dims[IDim, JDim], np.float64]
IJKField = gtx.Field[gtx.Dims[IDim, JDim, KDim], np.float64]
IKField = gtx.Field[gtx.Dims[IDim, KDim], np.float64]
KField = gtx.Field[gtx.Dims[KDim], np.float64]
IJKFloatField = gtx.Field[gtx.Dims[IDim, JDim, KDim], np.float32]
IBoolField = gtx.Field[gtx.Dims[IDim], bool]
IIntField = gtx.Field[gtx.Dims[IDim], np.int64]
IJKIntField = gtx.Field[gtx.Dims[IDim, JDim, KDim], np.int64]
VField = gtx.Field[gtx.Dims[Vertex], np.float64]
EField = gtx.Field[gtx.Dims[Edge], np.float64]
VEField = gtx.Field[gtx.Dims[Vertex, V2EDim], np.float64]

#: proxy name for allocating a field operator's return value
RETURN = "return"


@dataclasses.dataclass
class Case:
    """A backend + grid context feature tests run in."""

    backend: Optional[str]
    offset_provider: dict[str, Any]
    default_sizes: dict[Dimension, int]

    def as_field(self, dims, data):
        return as_field(list(dims), data)


def simple_cartesian_case(backend: Optional[str]) -> Case:
    return Case(
        backend=backend,
        offset_provider={"Ioff": IDim, "Joff": JDim, "Koff": KDim},
        default_sizes={IDim: 10, JDim: 10, KDim: 10},
    )


def _toy_mesh_tables() -> tuple[np.ndarray, np.ndarray]:
    """The 9-vertex / 18-edge periodic 3x3 quad mesh of
    tests/next_tests/cases.py."""
    n = 3
    nv = n * n
    ii, jj = np.divmod(np.arange(nv), n)
    right = ii * n + (jj + 1) % n
    down = ((ii + 1) % n) * n + jj
    e2v = np.concatenate(
        [
            np.stack([np.arange(nv), right], axis=1),  # horizontal edges
            np.stack([np.arange(nv), down], axis=1),  # vertical edges
        ]
    )
    v2e = np.empty((nv, 4), dtype=np.int64)
    v2e[:, 0] = np.arange(nv)  # h edge leaving v
    v2e[:, 1] = ii * n + (jj - 1) % n  # h edge entering v
    v2e[:, 2] = nv + np.arange(nv)  # v edge leaving v
    v2e[:, 3] = nv + ((ii - 1) % n) * n + jj  # v edge entering v
    return e2v.astype(np.int64), v2e


TOY_E2V_TABLE, TOY_V2E_TABLE = _toy_mesh_tables()


def simple_unstructured_case(backend: Optional[str]) -> Case:
    return Case(
        backend=backend,
        offset_provider={
            "E2V": gtx.as_connectivity([Edge, E2VDim], Vertex, TOY_E2V_TABLE, device=DEVICE),
            "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, TOY_V2E_TABLE, device=DEVICE),
        },
        default_sizes={
            Vertex: TOY_V2E_TABLE.shape[0],
            Edge: TOY_E2V_TABLE.shape[0],
            V2EDim: TOY_V2E_TABLE.shape[1],
            E2VDim: TOY_E2V_TABLE.shape[1],
        },
    )


@pytest.fixture(params=BACKENDS, ids=BACKEND_IDS)
def cartesian_case(request):
    return simple_cartesian_case(request.param)


@pytest.fixture(params=BACKENDS, ids=BACKEND_IDS)
def unstructured_case(request):
    return simple_unstructured_case(request.param)


# -- parameter-type introspection ---------------------------------------------


def get_param_types(prog) -> dict[str, Optional[TypeSpec]]:
    """name -> TypeSpec (plus ``RETURN``) from the definition's evaluated
    annotations (``Field[Dims[...], dt]`` evaluates to FieldType eagerly)."""
    definition = getattr(prog, "definition", prog)
    sig = inspect.signature(definition)
    globalns = getattr(definition, "__globals__", None)
    out: dict[str, Optional[TypeSpec]] = {}
    for name, param in sig.parameters.items():
        out[name] = _as_type_spec(param.annotation, globalns)
    if sig.return_annotation is not inspect.Signature.empty:
        out[RETURN] = _as_type_spec(sig.return_annotation, globalns)
    return out


def _as_type_spec(ann: Any, globalns: Optional[dict] = None) -> Optional[TypeSpec]:
    if ann is inspect.Signature.empty:
        return None
    if isinstance(ann, TypeSpec):
        return ann
    if isinstance(ann, tuple):
        elems = [_as_type_spec(a, globalns) for a in ann]
        if any(e is None for e in elems):
            return None
        return TupleType(types=tuple(elems))
    try:
        return from_annotation(ann, globalns)
    except Exception:
        return None


# -- initializer strategies ----------------------------------------------------


class ConstInitializer:
    def __init__(self, value):
        self.value = value

    def scalar(self, dtype):
        return np.dtype(dtype).type(self.value)

    def array(self, shape, dtype):
        return np.full(shape, self.value, dtype=dtype)


class ZeroInitializer(ConstInitializer):
    def __init__(self):
        super().__init__(0)


class UniqueInitializer:
    """Unique value per coordinate point, unique across containers that
    share the instance (reference cases.py:206)."""

    def __init__(self, start: int = 1):
        self.start = start

    def scalar(self, dtype):
        v = self.start
        self.start += 1
        return np.dtype(dtype).type(v)

    def array(self, shape, dtype):
        n = int(np.prod(shape)) if shape else 1
        data = np.arange(self.start, self.start + n, dtype=np.float64)
        self.start += n
        return data.reshape(shape).astype(dtype)


class IndexInitializer:
    """1-D field holding its own coordinate index (reference :173)."""

    def scalar(self, dtype):  # pragma: no cover - guarded by allocate
        raise AttributeError("IndexInitializer has no scalar value")

    def array(self, shape, dtype):
        if len(shape) != 1:
            raise ValueError("IndexInitializer only supports 1-D fields")
        return np.arange(shape[0], dtype=dtype)


# -- allocation ----------------------------------------------------------------


@dataclasses.dataclass
class _AllocBuilder:
    """Chainable allocator: ``allocate(case, op, "a").extend(...)()``."""

    case: Case
    prog: Any
    name: str
    _strategy: Any = None
    _dtype: Any = None
    _extend: Optional[dict[Dimension, tuple[int, int]]] = None
    _sizes: Optional[dict[Dimension, int]] = None
    _domain: Optional[dict] = None

    def strategy(self, s) -> "_AllocBuilder":
        self._strategy = s
        return self

    def zeros(self) -> "_AllocBuilder":
        return self.strategy(ZeroInitializer())

    def unique(self) -> "_AllocBuilder":
        return self.strategy(UniqueInitializer())

    def index(self) -> "_AllocBuilder":
        return self.strategy(IndexInitializer())

    def dtype(self, dt) -> "_AllocBuilder":
        self._dtype = dt
        return self

    def extend(self, ext: dict[Dimension, tuple[int, int]]) -> "_AllocBuilder":
        self._extend = ext
        return self

    def sizes(self, sz: dict[Dimension, int]) -> "_AllocBuilder":
        self._sizes = sz
        return self

    def domain(self, dom: dict) -> "_AllocBuilder":
        self._domain = dom
        return self

    def __call__(self):
        spec = get_param_types(self.prog).get(self.name)
        if spec is None:
            raise TypeError(
                f"parameter {self.name!r} of "
                f"{getattr(self.prog, 'definition', self.prog)} carries no "
                "usable annotation"
            )
        strategy = self._strategy
        if strategy is None:
            strategy = (
                ZeroInitializer()
                if self.name in ("out", RETURN)
                else UniqueInitializer()
            )
        return _alloc_from_spec(
            spec,
            self.case,
            strategy,
            dtype=self._dtype,
            extend=self._extend,
            sizes=self._sizes,
            domain=self._domain,
        )


def allocate(case: Case, prog, name: str) -> _AllocBuilder:
    return _AllocBuilder(case, prog, name)


def _alloc_from_spec(spec, case, strategy, *, dtype=None, extend=None,
                     sizes=None, domain=None):
    if isinstance(spec, TupleType):
        return tuple(
            _alloc_from_spec(
                t, case, strategy, dtype=dtype, extend=extend, sizes=sizes,
                domain=domain,
            )
            for t in spec.types
        )
    if isinstance(spec, ScalarType):
        return strategy.scalar(dtype or spec.dtype)
    if not isinstance(spec, FieldType):
        raise TypeError(f"cannot allocate a value of type {spec}")
    dt = np.dtype(dtype or spec.dtype)
    ranges = {}
    for dim in spec.dims:
        if domain and dim in domain:
            lo, hi = domain[dim]
        else:
            size = (sizes or {}).get(dim, case.default_sizes.get(dim))
            if size is None:
                raise KeyError(f"no default size for dimension {dim}")
            lo, hi = 0, size
        if extend and dim in extend:
            lo += extend[dim][0]
            hi += extend[dim][1]
        ranges[dim] = (lo, hi)
    shape = tuple(hi - lo for lo, hi in ranges.values())
    data = strategy.array(shape, dt)
    return as_field(gtx.domain({d: r for d, r in ranges.items()}), data)


# -- run / verify ---------------------------------------------------------------


def run(case: Case, prog, *args, **kwargs) -> None:
    if kwargs.get("offset_provider") is None:
        kwargs["offset_provider"] = case.offset_provider
    prog.with_backend(case.backend)(*args, **kwargs)


def _tree_allclose(ref, out, *, rtol=1e-5, atol=1e-8, equal_nan=False) -> bool:
    if isinstance(ref, tuple) or isinstance(out, tuple):
        if not (isinstance(ref, tuple) and isinstance(out, tuple)):
            return False
        return len(ref) == len(out) and all(
            _tree_allclose(r, o, rtol=rtol, atol=atol, equal_nan=equal_nan)
            for r, o in zip(ref, out)
        )
    return np.allclose(
        _asnumpy(ref), _asnumpy(out), rtol=rtol, atol=atol, equal_nan=equal_nan
    )


def _asnumpy(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return np.asarray(v)


def verify(
    case: Case,
    prog,
    *args,
    ref,
    out=None,
    inout=None,
    domain=None,
    offset_provider=None,
    comparison: Callable[[Any, Any], bool] = _tree_allclose,
) -> None:
    """Run ``prog`` under ``case`` and compare against ``ref``.

    Exactly one of ``out`` (passed as the ``out=`` argument) or ``inout``
    (an argument the program writes in place) must be given — reference
    cases.py:440."""
    kwargs = {}
    if out is not None:
        kwargs["out"] = out
    if domain is not None:
        kwargs["domain"] = domain
    run(case, prog, *args, **kwargs, offset_provider=offset_provider)
    got = out if out is not None else inout
    assert got is not None, "verify needs out= or inout="
    ok = comparison(ref, got)
    assert ok, (
        f"Verification failed:\n  ref = {_fmt(ref)}\n  out = {_fmt(got)}"
    )


def _fmt(v):
    if isinstance(v, tuple):
        return tuple(_fmt(x) for x in v)
    return _asnumpy(v)


def verify_with_default_data(
    case: Case,
    fieldop,
    ref: Callable,
    offset_provider=None,
    comparison: Callable[[Any, Any], bool] = _tree_allclose,
):
    """Allocate unique-valued inputs from the annotations, run, and
    compare against ``ref(*numpy_inputs)`` (reference cases.py:503).
    Returns the out field(s)."""
    types = get_param_types(fieldop)
    shared = UniqueInitializer()
    inps = tuple(
        _alloc_from_spec(spec, case, shared)
        for name, spec in types.items()
        if name != RETURN
    )
    out = allocate(case, fieldop, RETURN).zeros()()

    def to_np(x):
        if isinstance(x, tuple):
            return tuple(to_np(e) for e in x)
        return x.asnumpy() if hasattr(x, "asnumpy") else x

    ref_args = tuple(to_np(x) for x in inps)
    verify(
        case,
        fieldop,
        *inps,
        ref=ref(*ref_args),
        out=out,
        offset_provider=offset_provider,
        comparison=comparison,
    )
    return out
