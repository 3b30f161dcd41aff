"""On-the-fly toolchain: compiled-programs pool, compilation options,
CUDA-graph executables, composable workflow steps.

Counterpart of gt4py_tpu/next/otf.py (role of the reference's
``gt4py.next.otf``, src/gt4py/next/otf/): calls dispatch through a
``CompiledProgramsPool`` keyed by the argument signature, the static-
argument values and the offset-provider fingerprints
(otf/compiled_program.py:333,495-539), as in the JAX package. A variant's
build is the FOAST-compiled definition with its static arguments bound,
built inline at a miss. The JAX package's executable is a ``jax.jit`` of
it; here it is a :class:`GraphExecutable`, and a call with card tensors is
captured once into a CUDA graph (the definition and the write-back into
``out``) and replayed on every warm call (:class:`GraphCache`). The JAX
package's async compile workers, process runner and serialized
executables have no counterpart.

- :class:`CompilationOptions` — ``enable_jit`` (the JAX package's
  ``otf.py:58``), ``static_params`` (reference otf/options.py:23).
- :class:`CompiledProgramsPool` — executable cache; a miss builds inline.
- :class:`GraphCache` — the CUDA graphs of one operator, scan or program.
- :class:`NamedStepSequence` — the composable-step kit a backend's
  ``Transforms`` builds on (reference otf/workflow.py:97).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from gt4py_tpu_torch.next import type_system as ts


@dataclasses.dataclass(frozen=True)
class CompilationOptions:
    """User-facing compilation knobs (reference otf/options.py:23).

    ``enable_jit=False`` runs every call eagerly, the pool left empty (on
    a card: no CUDA graph, counted as a refusal). What remains
    user-facing beside it is variant ENUMERATION, via
    ``FieldOperator.compile(static_arg=[v1, v2], ...)`` cross products.
    """

    enable_jit: bool = True
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


# --- CUDA graphs ---------------------------------------------------------------
#
# The torch backend's counterpart of an XLA executable. A call whose tensors
# lie on one card is keyed by everything a graph bakes in: each tensor's
# address, dtype, shape, strides and storage offset (of the arguments, of
# ``out`` and of the int64 index each connectivity of the offset provider
# is read through, ``embedded.device_index``), each Field's domain, every
# scalar's value (the graph bakes scalars into its kernels' parameters),
# the offset provider's fingerprint, the ``domain=`` and the current
# stream. The first call of a key runs eagerly on the current stream, its
# write-back included: that is also the warm-up PyTorch asks for before a
# capture. The second call of the key captures the same work into a graph
# and replays it once: that replay is the call's result. Every later call
# of the key replays the graph and launches nothing else. So a key seen
# once keeps the eager cost, and the definition's Python runs at a key's
# first two calls only, as under the JAX package's trace; a helper's
# ``global`` write still reaches its module once (``backend._pinned``).
#
# A graph reads the caller's tensors at the addresses its key holds. The
# connectivities' int64 indices are not the caller's: a graph keeps the
# ones its key holds alive for as long as it lives, so no other tensor can
# take their addresses while a key that names them can match.
#
# The graphs of one device and stream share one memory pool
# (``torch.cuda.graph_pool_handle()``). That is safe because nothing a
# capture allocates outlives it: the definition's temporaries are dead when
# its capture ends (the results are copied into ``out``, a caller's tensor,
# and the caches that outlive a call keep nothing made during a capture), so
# a graph's pool memory holds values only while that graph replays, and the
# replays of one stream run one after another. When a pool's last graph
# goes (evicted, or with its operator), the pool goes with it: PyTorch frees
# its memory, and the next capture takes a new pool.

#: the most variant keys one operator, scan or program keeps, graphs and keys
#: seen once together; the least recently used goes first
GRAPHS_PER_OPERATOR = 8

#: why a call with card tensors runs eagerly (each counted in
#: :data:`graphs_refused`); every reason is known before any capture
REFUSED_OPTIONS = "enable_jit=False"
REFUSED_COMPILE_STEP = "a compile step of the user's own"
REFUSED_SHARDED = "a sharded connectivity"
REFUSED_DEVICES = "tensors on more than one device"
REFUSED_UNKEYED = "an argument the variant key cannot hold"
REFUSALS = (REFUSED_OPTIONS, REFUSED_COMPILE_STEP, REFUSED_SHARDED, REFUSED_DEVICES,
            REFUSED_UNKEYED)

#: first calls of a variant key, run eagerly, by entry point ("field_operator",
#: "scan_operator", "program")
graphs_first_calls: collections.Counter = collections.Counter()
#: graphs captured (at a key's second call), by entry point
graphs_captured: collections.Counter = collections.Counter()
#: graph replays, by entry point
graphs_replayed: collections.Counter = collections.Counter()
#: calls with card tensors run eagerly, by reason (:data:`REFUSALS`)
graphs_refused: collections.Counter = collections.Counter()
#: every counter of the graphs
COUNTERS = (graphs_first_calls, graphs_captured, graphs_replayed, graphs_refused)
#: guards the counters (DistributedUnstructured calls from a thread per shard)
_COUNTS_LOCK = threading.Lock()


def _count(counter: collections.Counter, key: str) -> None:
    with _COUNTS_LOCK:
        counter[key] += 1


#: the live graph memory pool of each (device, stream id) (:class:`_Pool`)
_POOLS: dict = {}

#: the graphs of each GraphCache that died, destroyed before the next capture or
#: replay: a CUDA graph destroyed while a stream captures invalidates that
#: capture, and the garbage collector may free an operator (and its graphs)
#: anywhere, in the middle of a capture too
_RETIRED: list = []

_INLINE: contextvars.ContextVar[bool] = contextvars.ContextVar("gt4py_inline", default=False)


class GraphExecutable:
    """The ``torch`` backend's executable of one variant, the counterpart of
    the JAX package's ``jax.jit`` of it (``backend._compile_graph``).
    Called, it runs the pinned definition eagerly: on CPU tensors, and
    inline within an enclosing capture. A call with card tensors is
    captured into a CUDA graph by the operator's :class:`GraphCache`."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.fn(*args, **kwargs)


def on_card(device: torch.device) -> bool:
    return device.type == "cuda"


@contextlib.contextmanager
def inline_calls():
    """Within the block, ``torch`` operators, scans and programs run inline
    and eagerly (no graph of their own): a program's body, or a caller's
    eager reference run."""
    token = _INLINE.set(True)
    try:
        yield
    finally:
        _INLINE.reset(token)


def inline(device: torch.device) -> bool:
    """Whether a ``torch`` call on ``device`` runs inline and eagerly, as the
    JAX package's operators run under an enclosing trace (``_under_trace``,
    gt4py_tpu/next/decorators.py:497-507): within :func:`inline_calls`, or
    while the current stream captures a CUDA graph (an enclosing program,
    or a caller's own ``torch.cuda.graph``)."""
    return _INLINE.get() or (on_card(device) and torch.cuda.is_current_stream_capturing())


class _NoKey(Exception):
    """An argument of a type the variant key cannot hold."""


def _tensor_key(t: torch.Tensor, devices: set) -> tuple:
    devices.add(t.device)
    return (t.device, t.data_ptr(), t.dtype, t.shape, t.stride(), t.storage_offset())


def _value_key(v: Any, devices: set) -> Any:
    """The part of the variant key for ``v``: a tensor's address and layout
    (its device added to ``devices``), a Field's domain and weak type, a
    scalar's type and value (a float's by its bits: -0.0 and 0.0 differ),
    the keys of a tuple's, list's, dict's or named collection's members."""
    from gt4py_tpu_torch.next.embedded import Field
    from gt4py_tpu_torch.next.named_collections import is_named_collection

    t = type(v)
    if t is Field:
        if not isinstance(v.ndarray, torch.Tensor):
            raise _NoKey(v)
        mask = None if v.mask is None else _tensor_key(v.mask, devices)
        return (Field, v.domain, v.weak, _tensor_key(v.ndarray, devices), mask)
    if t is float:
        return (float, v.hex())
    if t in (int, bool, str) or v is None:
        return (t, v)
    if isinstance(v, torch.Tensor):
        return _tensor_key(v, devices)
    if isinstance(v, np.generic):
        return (v.dtype.str, v.tobytes())
    if isinstance(v, (tuple, list)):
        return (t, tuple(_value_key(x, devices) for x in v))
    if isinstance(v, dict):
        return (t, tuple((k, _value_key(v[k], devices)) for k in sorted(v)))
    if is_named_collection(v):
        return (t, tuple(_value_key(getattr(v, n), devices)
                         for n in t.__named_collection_fields__))
    if isinstance(v, np.ndarray):
        devices.add(torch.device("cpu"))  # host data: never captured beside card tensors
        return (t, id(v))
    try:
        hash(v)
    except TypeError:
        raise _NoKey(v) from None
    return (t, v)


def _sharded(provider: Optional[dict]) -> bool:
    return any(hasattr(conn, "sharded_gather") for conn in (provider or {}).values())


def _provider_key(provider: Optional[dict], device: torch.device, keeps: list) -> Any:
    """The offset provider's part of the key of a call on ``device``: each
    connectivity's fingerprint and the address and layout of the int64
    index its gathers read on ``device`` (``embedded.device_index``: cast
    once, on the device, outside any capture, and anew where the table is
    rebound or rewritten). A table's own device does not count among the
    call's. Each index is added to ``keeps``: the graph of the key keeps
    it alive, so its address names that index for as long as the graph
    can be matched."""
    from gt4py_tpu_torch.next.embedded import device_index

    if not provider:
        return None
    parts = []
    for name in sorted(provider):
        conn = provider[name]
        if isinstance(getattr(conn, "table", None), torch.Tensor):
            idx = device_index(conn, device)
            keeps.append(idx)
            parts.append((name, _provider_fingerprint(conn), _tensor_key(idx, set())))
        else:
            parts.append((name, _provider_fingerprint(conn)))
    return tuple(parts)


def graph_key(trees: Any, provider: Optional[dict]) -> tuple[Any, Optional[torch.device],
                                                            Optional[str], list]:
    """``(key, device, refusal, keeps)`` of a call on ``trees`` (its
    arguments, ``out``, ``domain=``) under ``provider``: ``device`` is the
    card the call's tensors lie on, None where none lies on a card (the
    call runs eagerly, as on CPU tensors); ``refusal`` the reason
    (:data:`REFUSALS`) a call on a card runs eagerly, else None; ``keeps``
    the tensors that are not the caller's and that a graph of the key
    reads (:func:`_provider_key`)."""
    devices: set = set()
    try:
        key = _value_key(trees, devices)
    except _NoKey:
        key = None
    cards = [d for d in devices if on_card(d)]
    if not cards:
        return key, None, None, []
    if key is None:
        return None, cards[0], REFUSED_UNKEYED, []
    if _sharded(provider):
        return None, cards[0], REFUSED_SHARDED, []
    if len(devices) > 1:
        return None, cards[0], REFUSED_DEVICES, []
    keeps: list = []
    return (key, _provider_key(provider, cards[0], keeps)), cards[0], None, keeps


def refuse(reason: str) -> None:
    """Count a call with card tensors that runs eagerly, by ``reason``."""
    _count(graphs_refused, reason)


def serve(graphs: Callable[[], "GraphCache"], trees: Any, provider: Optional[dict],
          work: Callable[[], Optional[Callable[[], Any]]], refusal: Optional[str] = None) -> bool:
    """Serve a ``torch`` call on ``trees`` (its arguments, ``out``,
    ``domain=``) under ``provider`` by the CUDA graph of its variant key
    (:func:`graph_key`) in ``graphs()`` (the caller's cache, made at first
    use): the graph replayed, else ``work()``, the call's work, run or
    captured (:meth:`GraphCache.run`). False where the caller runs the call
    eagerly: no tensor on a card, inline (:func:`inline`), or refused and
    counted (``refusal``, else the key's; :data:`REFUSED_COMPILE_STEP`
    where ``work()`` is None)."""
    key, device, why, keeps = graph_key(trees, provider)
    if device is None or inline(device):
        return False
    refusal = refusal or why
    if refusal is None:
        cache = graphs()
        graph = cache.find(key, device)
        if graph is not None:
            cache.replay(graph)
            return True
        body = work()
        if body is not None:
            cache.run(key, device, keeps, body)
            return True
        refusal = REFUSED_COMPILE_STEP
    refuse(refusal)
    return False


def _stream(device: torch.device):
    return torch.cuda.current_stream(device)


class _Pool:
    """A graph memory pool (``torch.cuda.graph_pool_handle()``), the side
    stream its graphs are captured on (one for all: the caching allocator
    keeps each stream's blocks apart, so a capture on another stream could
    not reuse what an earlier one freed), and the count of its live
    graphs."""

    __slots__ = ("key", "handle", "side", "graphs")

    def __init__(self, key: tuple, device: torch.device):
        self.key = key
        self.handle = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.graphs = 0

    def leave(self) -> None:
        """One of its graphs goes; with the last, the pool leaves
        :data:`_POOLS` (PyTorch frees it when that graph is destroyed), so
        that no capture goes into a freed pool."""
        self.graphs -= 1
        if self.graphs <= 0 and _POOLS.get(self.key) is self:
            del _POOLS[self.key]


def _pool(device: torch.device, stream) -> _Pool:
    """The live graph memory pool of ``device`` and ``stream``."""
    key = (device, stream.cuda_stream)
    pool = _POOLS.get(key)
    if pool is None:
        pool = _POOLS[key] = _Pool(key, device)
    return pool


class Graph:
    """A captured CUDA graph (``cuda_backend.Graph``, which counts the
    Hopper kernels of each replay), its pool and the tensors it reads that
    are not the caller's (kept alive with it)."""

    __slots__ = ("captured", "pool", "keeps")

    def __init__(self, captured, pool: _Pool, keeps: list):
        self.captured = captured
        self.pool = pool
        self.keeps = keeps

    def replay(self) -> int:
        """One replay; returns the Hopper kernels it launched."""
        return self.captured.replay()

    def retire(self) -> None:
        self.pool.leave()


def capture(device: torch.device, stream, body: Callable[[], Any], keeps: list) -> Graph:
    """``body()`` captured into a CUDA graph in the pool of ``device`` and
    ``stream`` (the stream it will replay on) by
    ``cuda_backend.capture_graph``: on the pool's side stream, with
    ``capture_error_mode="thread_local"``, the body's own error raised.
    A capture that fails raises; nothing falls back to the eager path."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import capture_graph

    _RETIRED.clear()
    pool = _pool(device, stream)
    try:
        captured = capture_graph(device, [body], pool=pool.handle, stream=pool.side)
    except BaseException:
        if not pool.graphs:  # the failed graph, destroyed, took the pool with it
            _POOLS.pop(pool.key, None)
        raise
    pool.graphs += 1
    return Graph(captured, pool, keeps)


def graph_pool_bytes() -> int:
    """Bytes the CUDA caching allocator holds in the live graph pools (their
    segments' total size)."""
    ids = {tuple(pool.handle) for pool in _POOLS.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) in ids)


#: a key a GraphCache has not seen
_UNSEEN = object()


class GraphCache:
    """The variant keys (:func:`graph_key`) of one operator, scan or program,
    by key and stream, each with its CUDA graph, or None where the key was
    seen once: at most :data:`GRAPHS_PER_OPERATOR`, the least recently used
    evicted first. It holds no caller tensor."""

    def __init__(self, kind: str):
        self.kind = kind
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        """The graphs it holds."""
        return sum(g is not None for g in self._graphs.values())

    def __del__(self):
        if _RETIRED is None or _POOLS is None:  # None while the interpreter shuts down
            return
        for graph in self._graphs.values():
            if graph is not None:
                graph.retire()
                _RETIRED.append(graph)

    def find(self, key: Any, device: torch.device) -> Optional[Graph]:
        """The graph of ``key`` on the current stream, now the most recently
        used, or None where there is none."""
        if _RETIRED:
            _RETIRED.clear()
        k = (key, _stream(device).cuda_stream)
        graph = self._graphs.get(k)
        if graph is not None:
            self._graphs.move_to_end(k)
        return graph

    def replay(self, graph: Graph) -> int:
        """One replay of ``graph`` (:meth:`find`'s), counted; returns the
        Hopper kernels it launched."""
        launched = graph.replay()
        _count(graphs_replayed, self.kind)
        return launched

    def run(self, key: Any, device: torch.device, keeps: list, body: Callable[[], Any]) -> Any:
        """A call of ``key`` that no graph served. At the key's first call:
        ``body()`` eagerly on the current stream, its value returned. At
        its second: ``body`` captured (keeping ``keeps`` alive), then
        replayed once, the call's result; returns the Hopper kernels the
        replay launched."""
        stream = _stream(device)
        k = (key, stream.cuda_stream)
        if self._graphs.get(k, _UNSEEN) is _UNSEEN:
            value = body()
            self._put(k, None)
            _count(graphs_first_calls, self.kind)
            return value
        graph = capture(device, stream, body, keeps)
        _count(graphs_captured, self.kind)
        self._put(k, graph)
        return self.replay(graph)

    def _put(self, k: Any, graph: Optional[Graph]) -> None:
        self._graphs[k] = graph
        self._graphs.move_to_end(k)
        while len(self._graphs) > GRAPHS_PER_OPERATOR:
            _, old = self._graphs.popitem(last=False)
            if old is not None:
                old.retire()


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
