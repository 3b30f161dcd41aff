"""Spans: the port's one tracing primitive.

A span times one block of the port's work and says what caused it. Its
record holds its name, an id, the id of the span open around it on the
same thread (its parent; None for a root), the id of the outermost one
(its root: the spans of one call share it), its start and end on
``time.perf_counter_ns``, the ns of that interval its own recording took
(``overhead_ns``: the ``record_function`` range's entry and exit and the
hooks, which a layer's self time leaves out), and a few attributes (counts,
a stencil's name).

When a span does something:

- While a ``torch.profiler`` profile records (``torch.autograd._profiler_enabled()``:
  under ``torch.profiler.profile`` and ``torch.autograd.profiler.emit_nvtx``),
  it keeps its record in memory (:func:`spans`) and opens a
  ``record_function`` range of its name, so that the span lies in the
  profile's Chrome trace on the profiler's clock, beside the CUDA runtime
  calls and the kernels it caused; under ``emit_nvtx`` the range is an NVTX
  range, which ``nsys`` shows.
- A build span (``always=True``) keeps its record at any time: a build
  happens once a stencil and takes milliseconds.
- While the metrics level (``GT4PY_COLLECT_METRICS_LEVEL``, metrics.py) is
  at least the span's, its duration in seconds is added to
  ``metrics.get_metric(source, metric)``; :class:`MetricsCollector` is a
  span named after its metric.
- A span given ``hook`` runs the ``stencil_call`` context hooks (hooks.py)
  around its block, with ``hook`` as their argument.

With no profile, metrics level DISABLED and no ``stencil_call`` hook (the
defaults), :func:`span` returns the shared :data:`NO_SPAN`: no record, no
allocation, no ``record_function``. Nothing is written to disk.

The port's spans are named ``gt4py.<layer>.<what>``; ``perfbench.`` names
are the benchmark harness's own.
"""

from __future__ import annotations

import collections
import itertools
import threading
from contextlib import contextmanager
from time import perf_counter_ns
from typing import Any, NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from gt4py_tpu_torch.instrumentation import metrics as _metrics
from gt4py_tpu_torch.instrumentation.hooks import stencil_call
from gt4py_tpu_torch.instrumentation.metrics import MetricCollectionLevel

#: records kept (the oldest go first): room for thousands of traced calls
#: of about four spans each
SPAN_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    overhead_ns: int
    attrs: dict


_RECORDS: collections.deque = collections.deque(maxlen=SPAN_RECORDS)
_IDS = itertools.count(1)
#: the innermost span open on this thread (``.open``)
_LOCAL = threading.local()


def spans() -> list[SpanRecord]:
    """The records kept so far, in the order the spans ended."""
    return list(_RECORDS)


def clear_spans() -> None:
    _RECORDS.clear()


class _NoSpan:
    """What a span is while nothing asks for it: a shared no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One span (see the module's docstring); :meth:`set` adds an attribute
    before it ends. Once it has ended: ``start``, ``end`` and ``overhead``
    as in its record, and :attr:`seconds`, the enclosed work's."""

    __slots__ = ("name", "source", "metric", "level", "hook", "always", "attrs", "id",
                 "parent", "root", "start", "end", "overhead", "_body", "_range", "_hooks")

    def __init__(self, name: str, *, source: str = "gt4py", metric: Optional[str] = None,
                 level: MetricCollectionLevel = MetricCollectionLevel.PERFORMANCE,
                 hook: Any = None, always: bool = False, **attrs: Any):
        self.name = name
        self.source = source
        self.metric = name if metric is None else metric
        self.level = level
        self.hook = hook
        self.always = always
        self.attrs = attrs

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    @property
    def seconds(self) -> float:
        return (self.end - self.start - self.overhead) / 1e9

    def __enter__(self) -> "Span":
        self.start = perf_counter_ns()
        self._range = record_function(self.name) if _profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        parent = getattr(_LOCAL, "open", None)
        self.parent = parent
        self.id = next(_IDS)
        self.root = self.id if parent is None else parent.root
        _LOCAL.open = self
        self._hooks = None
        if self.hook is not None and stencil_call.factories:
            self._hooks = stencil_call.wrap(self.hook)
            self._hooks.__enter__()
        self._body = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        body_end = perf_counter_ns()
        try:
            if self._hooks is not None:
                self._hooks.__exit__(*exc)
        finally:
            _LOCAL.open = self.parent
            if self._range is not None:
                self._range.__exit__(*exc)
        self.end = perf_counter_ns()
        self.overhead = self._body - self.start + self.end - body_end
        if self._range is not None or self.always:
            parent = None if self.parent is None else self.parent.id
            _RECORDS.append(SpanRecord(self.name, self.id, parent, self.root, self.start,
                                       self.end, self.overhead, self.attrs))
        if _metrics._level >= self.level:
            _metrics.get_metric(self.source, self.metric).add((body_end - self._body) / 1e9)
        return False


def span(name: str, *, source: str = "gt4py", metric: Optional[str] = None, hook: Any = None):
    """A per-call :class:`Span` of ``name``, or :data:`NO_SPAN` where nothing
    would read it: no profile recording, metrics level DISABLED and, for a
    span given ``hook``, no ``stencil_call`` hook. Attributes are added by
    ``set(key, value)``, which on :data:`NO_SPAN` does nothing. (A build
    span is a ``Span(name, always=True, ...)``.)"""
    if _metrics._level or _profiler_enabled() or (hook is not None and stencil_call.factories):
        return Span(name, source=source, metric=metric, hook=hook)
    return NO_SPAN


def named_scope(name: str):
    """A span of ``name`` around the enclosed work, for user code: in a
    profile's trace (an NVTX range under ``emit_nvtx``) while a profile
    records, and the ``("gt4py", name)`` metric at a metrics level; otherwise
    a no-op."""
    return span(name)


class MetricsCollector(Span):
    """A span recording the wall time of a block into the metric
    ``(source, name)`` while the metrics level is at least ``level``
    (reference metrics.py:240); it is named ``<source>.<name>``."""

    __slots__ = ()

    def __init__(self, source: str, name: str,
                 level: MetricCollectionLevel = MetricCollectionLevel.PERFORMANCE):
        super().__init__(f"{source}.{name}", source=source, metric=name, level=level)


@contextmanager
def collect_metrics(source: str, name: str,
                    level: MetricCollectionLevel = MetricCollectionLevel.PERFORMANCE):
    with MetricsCollector(source, name, level):
        yield
