"""Metrics and hooks (copied from gt4py_tpu/instrumentation/__init__.py).

``profiler.py`` is not ported yet: the JAX package's version emits TPU
trace markers through JAX; the port's will use NVTX ranges."""

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
