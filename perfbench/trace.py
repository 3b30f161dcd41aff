"""The traced calls of a ``--trace 1`` run, reduced to what the per-layer
metrics read.

``torch.profiler`` (CPU and CUDA activities, CUPTI) traces ``n`` calls of
the cell's entry after its window, each inside a ``record_function`` span
named ``perfbench.<entry>``. From the Chrome trace it writes (into
``TMPDIR``, deleted once read) come:

- ``busy_s``: the union of the device's operations (kernels, copies, sets)
  on each card, averaged over the cards; ``window_s`` the host clock's
  seconds from the first call to the cards' synchronisation after the last;
- ``complete``: whether the trace holds a kernel event for every launch of
  the port's hand-written kernels that its counters saw in those calls
  (CUPTI drops events when its buffers overflow; a share of a roofline is
  read only from a complete trace);
- ``breakdown``: the device operations that took most time (seconds a card,
  by name), and the longest idle gaps between them, each named by the
  harness's span open on the host when the gap began and the innermost
  host operation inside it.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

SPAN = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def traced_calls(entry, n_calls: int, devices, launches) -> dict:
    """Trace ``n_calls`` calls of ``entry``; ``launches()`` reads the port's
    count of hand-written kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = devices[0].type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    synchronize(devices)
    before = launches()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            with record_function(SPAN + entry.name):
                entry.call()
        synchronize(devices)
        window_s = time.perf_counter() - t0
    launched = launches() - before
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    n_devices = len({str(d) for d in devices})
    return summarize(events, window_s, n_calls * entry.steps_per_call, launched, n_devices)


def synchronize(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _union(intervals: list) -> list:
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _host_name(host: list, at: float) -> str:
    """The harness's span open at ``at`` and the innermost host operation
    inside it (``perfbench.loop``: between the calls, in the harness)."""
    span, inner = "perfbench.loop", None
    for ts, end, name in host:
        if ts > at:
            break
        if end >= at:
            if name.startswith(SPAN):
                span = name
            elif inner is None or ts >= inner[0]:
                inner = (ts, name)
    return span if inner is None else f"{span} > {inner[1]}"


def summarize(events: list, window_s: float, steps: int, launched: int, n_devices: int) -> dict:
    by_device: dict = collections.defaultdict(list)
    op_us: dict = collections.Counter()
    kernels = 0
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat"), str(e.get("name", ""))
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            by_device[e.get("args", {}).get("device")].append((ts, ts + dur))
            op_us[name[:160]] += dur
            kernels += cat == "kernel" and name.startswith("gt_")
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name[:120]))
    host.sort()
    busy_us, gaps = [], []
    for intervals in by_device.values():
        merged = _union(intervals)
        busy_us.append(sum(hi - lo for lo, hi in merged))
        gaps.extend((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:]))
    gaps.sort(reverse=True)
    busy_s = sum(busy_us) / 1e6 / n_devices
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "steps": steps,
        "kernels_traced": kernels,
        "kernels_launched": launched,
        "complete": kernels >= launched,
        "breakdown": {
            "device_ops": [[name, us / 1e6 / n_devices] for name, us in op_us.most_common(TOP)],
            "idle_gaps": [[_host_name(host, at), us / 1e6] for us, at in gaps[:TOP]],
        },
    }
