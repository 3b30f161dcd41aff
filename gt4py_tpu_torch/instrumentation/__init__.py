"""Metrics, hooks and the GPU profiler (copied from
gt4py_tpu/instrumentation/__init__.py; the JAX package's ``tpu_trace`` is
the port's ``gpu_trace``, profiler.py)."""

from gt4py_tpu_torch.instrumentation.metrics import (  # noqa: F401
    Metric,
    MetricCollectionLevel,
    MetricsCollector,
    collect_metrics,
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
from gt4py_tpu_torch.instrumentation.profiler import gpu_trace, named_scope  # noqa: F401
