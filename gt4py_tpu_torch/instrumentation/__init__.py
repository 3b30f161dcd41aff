"""Spans, metrics, hooks and the GPU profiler (copied from
gt4py_tpu/instrumentation/__init__.py; the JAX package's ``tpu_trace`` is
the port's ``gpu_trace``, profiler.py; spans.py is the port's own)."""

from gt4py_tpu_torch.instrumentation.metrics import (  # noqa: F401
    Metric,
    MetricCollectionLevel,
    dump_metrics_json,
    dump_metrics_table,
    metrics_level,
)
from gt4py_tpu_torch.instrumentation.hooks import (  # noqa: F401
    ContextHook,
    EventHook,
    register_context_hook,
    register_event_hook,
)
from gt4py_tpu_torch.instrumentation.spans import (  # noqa: F401
    NO_SPAN,
    MetricsCollector,
    Span,
    SpanRecord,
    clear_spans,
    collect_metrics,
    named_scope,
    span,
    spans,
)
from gt4py_tpu_torch.instrumentation.profiler import gpu_trace  # noqa: F401
