"""Leveled runtime metrics.

Copied from gt4py_tpu/instrumentation/metrics.py; imports renamed.

Same design as the reference's ``gt4py.next.instrumentation.metrics``
(src/gt4py/next/instrumentation/metrics.py:46-50,70,240,351):
collection levels (DISABLED/PERFORMANCE/INFO/VERBOSE), a ``Metric`` sample
model keyed by (program, metric name), and table/JSON dumps at exit. The
samples come from spans (spans.py: ``MetricsCollector``, and the port's own
spans, each feeding the metric it names). Env vars: ``GT4PY_COLLECT_METRICS_LEVEL`` (int),
``GT4PY_DUMP_METRICS_AT_EXIT`` ("table"/"json:<path>").
"""

from __future__ import annotations

import atexit
import enum
import json
import os
import statistics
from typing import Optional


class MetricCollectionLevel(enum.IntEnum):
    DISABLED = 0
    PERFORMANCE = 10
    INFO = 20
    VERBOSE = 30


def _env_level() -> MetricCollectionLevel:
    raw = os.environ.get("GT4PY_COLLECT_METRICS_LEVEL", "0")
    try:
        return MetricCollectionLevel(int(raw))
    except ValueError:
        try:
            return MetricCollectionLevel[raw.upper()]
        except KeyError:
            return MetricCollectionLevel.DISABLED


_level = _env_level()


def metrics_level() -> MetricCollectionLevel:
    return _level


def set_metrics_level(level: MetricCollectionLevel) -> None:
    global _level
    _level = MetricCollectionLevel(level)


class Metric:
    """Sample series for one (source, name) pair (reference metrics.py:70)."""

    __slots__ = ("source", "name", "samples")

    def __init__(self, source: str, name: str):
        self.source = source
        self.name = name
        self.samples: list[float] = []

    def add(self, value: float) -> None:
        self.samples.append(value)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.samples) if self.samples else float("nan")

    @property
    def total(self) -> float:
        return sum(self.samples)


_metrics: dict[tuple[str, str], Metric] = {}


def get_metric(source: str, name: str) -> Metric:
    key = (source, name)
    if key not in _metrics:
        _metrics[key] = Metric(source, name)
    return _metrics[key]


def all_metrics() -> list[Metric]:
    return list(_metrics.values())


def dump_metrics_table() -> str:
    rows = [("source", "metric", "count", "mean [s]", "total [s]")]
    for m in sorted(all_metrics(), key=lambda m: (m.source, m.name)):
        rows.append((m.source, m.name, str(m.count), f"{m.mean:.6f}", f"{m.total:.6f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines)


def dump_metrics_json(path: Optional[str] = None) -> str:
    data = [
        {
            "source": m.source,
            "name": m.name,
            "count": m.count,
            "mean": m.mean,
            "total": m.total,
            "samples": m.samples,
        }
        for m in all_metrics()
    ]
    text = json.dumps(data, indent=2)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def _dump_at_exit() -> None:
    spec = os.environ.get("GT4PY_DUMP_METRICS_AT_EXIT")
    if not spec or not _metrics:
        return
    if spec == "table":
        print(dump_metrics_table())
    elif spec.startswith("json"):
        path = spec.split(":", 1)[1] if ":" in spec else None
        out = dump_metrics_json(path)
        if path is None:
            print(out)


atexit.register(_dump_at_exit)
