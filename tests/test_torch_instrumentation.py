"""tests/test_instrumentation.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Metrics/hooks subsystem tests (reference design:
next/instrumentation/metrics.py + hook_machinery.py)."""

import numpy as np

from gt4py_tpu_torch.instrumentation import (
    MetricCollectionLevel,
    MetricsCollector,
    collect_metrics,
    dump_metrics_json,
    dump_metrics_table,
)
from gt4py_tpu_torch.instrumentation import metrics as metrics_mod
from gt4py_tpu_torch.instrumentation.hooks import event_hook, context_hook


def test_collector_respects_level():
    metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)
    with MetricsCollector("test_prog", "disabled_metric"):
        pass
    assert metrics_mod.get_metric("test_prog", "disabled_metric").count == 0

    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    with collect_metrics("test_prog", "enabled_metric"):
        pass
    assert metrics_mod.get_metric("test_prog", "enabled_metric").count == 1
    metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)


def test_stencil_call_records_metric():
    import json

    from gt4py_tpu_torch.cartesian import gtscript
    from tests import torch_stencil_defs as defs

    metrics_mod.set_metrics_level(MetricCollectionLevel.PERFORMANCE)
    try:
        st = gtscript.stencil(backend="numpy", definition=defs.copy_stencil)
        a = np.random.rand(4, 4, 2)
        st(a, np.zeros_like(a))
        metric = metrics_mod.get_metric("copy_stencil", "compute")
        assert metric.count >= 1
        assert metric.total > 0
        table = dump_metrics_table()
        assert "copy_stencil" in table
        data = json.loads(dump_metrics_json())
        assert any(d["source"] == "copy_stencil" for d in data)
    finally:
        metrics_mod.set_metrics_level(MetricCollectionLevel.DISABLED)


def test_hooks():
    events = []
    hook = event_hook("test_event")
    hook.register(lambda x: events.append(x))
    hook.fire(42)
    assert events == [42]

    order = []

    class _Ctx:
        def __enter__(self):
            order.append("enter")

        def __exit__(self, *a):
            order.append("exit")
            return False

    chook = context_hook("test_ctx")
    chook.register(lambda *a, **k: _Ctx())
    with chook.wrap():
        order.append("body")
    assert order == ["enter", "body", "exit"]
