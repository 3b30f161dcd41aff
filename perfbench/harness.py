"""One run of one cell: set-up, the measured window, the traced calls and the
check, and the result line of the contract.

Set-up (``setup_s``, from the start of ``run.py`` to the window's first
call): the inputs made on the first device from ``--seed`` by a
``torch.Generator``, one call a field; the cell's stencil built
(``build_s`` times the build and the first call, which compiles on a cold
cache); the entry's fields made from the inputs; the warm-up calls; then the
program's state put back to the seeded inputs, so that the window's first
call starts from them.

The window: a closed loop of the entry's calls for ``--seconds``, with no
synchronisation inside it; after each call a CUDA event on each card used;
the cards synchronised at its end. The run's record (``Run``) holds the
window's seconds and steps, the intervals between the completions of
consecutive calls (on each card's clock: the longest over the cards),
``setup_s`` and ``build_s``; with ``--trace 1`` also each call's host
seconds (the harness's span around the entry) and the traced calls
(trace.py). Each metric's reader (perfbench/metrics/) takes its number from
that record.
"""

from __future__ import annotations

import gc
import os
import resource
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from perfbench import check, trace
from perfbench.spec import PERFBENCH, load_json

#: seconds ``nvidia-smi`` may take to read the power limit
POWER_QUERY_S = 20


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def make_inputs(config: dict, seed: int, device) -> dict:
    """Every field of ``config``, made on ``device`` from ``seed`` by one
    ``torch.Generator``, one call a field, in the file's order: ``uniform``
    in [0, 1) times ``scale``, or ``zeros``."""
    import torch

    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    inputs = {}
    for name, field in config["fields"].items():
        shape = tuple(field["shape"])
        if field["draw"] == "zeros":
            inputs[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            inputs[name] = torch.rand(shape, generator=gen, dtype=dtype, device=device)
            inputs[name].mul_(float(field.get("scale", 1.0)))
    return inputs


class Clock:
    """The completions of the window's calls on each card's clock: one CUDA
    event a card after each call, made and recorded once at set-up so that
    the window creates none. On the CPU (the tests' rehearsal) the host's
    clock stands in."""

    def __init__(self, devices, capacity: int):
        import torch

        self.devices = list(dict.fromkeys(devices))
        self.on_card = self.devices[0].type == "cuda"
        self.times: list = []
        if not self.on_card:
            return
        self.streams = [torch.cuda.current_stream(d) for d in self.devices]
        self.events = []
        for stream in self.streams:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(capacity + 1)]
            for e in events:
                e.record(stream)
            self.events.append(events)
        trace.synchronize(self.devices)

    def mark(self, i: int) -> None:
        """Call ``i`` has been issued (-1: the window's start)."""
        if not self.on_card:
            self.times.append(time.perf_counter())
            return
        import torch

        for events, stream in zip(self.events, self.streams):
            if i + 1 >= len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[i + 1].record(stream)

    def intervals_us(self, calls: int) -> list:
        """Each call's completion after the one before it (the first: after
        the window's start), the longest over the cards, in µs."""
        if not self.on_card:
            return [(b - a) * 1e6 for a, b in zip(self.times, self.times[1:calls + 1])]
        worst = [0.0] * calls
        for events in self.events:
            for i in range(calls):
                worst[i] = max(worst[i], events[i].elapsed_time(events[i + 1]) * 1e3)
        return worst


def launches_by_kernel() -> dict:
    """Launches of each of the port's hand-written kernels so far (its
    counters)."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    return {name: w.launches for name, w in cuda_backend.WRAPPERS.items()}


def kernel_launches() -> int:
    return sum(launches_by_kernel().values())


def nvcc_runs() -> int:
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    return cuda_backend.nvcc_runs


def power_limit() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=POWER_QUERY_S,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def host_spans(entry, n_calls: int, devices) -> list:
    """Host seconds of ``n_calls`` calls, each from the entry's call to its
    return, each issued to idle cards (synchronised before it), so that no
    full launch queue holds the host back inside the call."""
    spans = []
    for _ in range(n_calls):
        trace.synchronize(devices)
        a = time.perf_counter()
        entry.call()
        spans.append(time.perf_counter() - a)
    trace.synchronize(devices)
    return spans


def run_cell(cell, seed: int, seconds: float, traced: bool, devices, t0: float,
             entry_class=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``devices``:
    the cards the cell asks for (CPU devices in the tests' rehearsal);
    ``t0``: the host clock at the process's start; ``entry_class``: the
    entry to drive in place of the traffic's (the control, the tests)."""
    import torch

    config, traffic = cell.config, cell.traffic
    program = cell.module("programs", config["program"])
    reference = cell.module("reference", config["program"])
    Entry = entry_class or cell.module("entries", traffic["entry"]).Entry
    devices = [torch.device(d) for d in devices]
    device = devices[0]

    log(f"set-up: torch and the harness imported at {time.perf_counter() - t0:.3f} s")
    inputs = make_inputs(config, seed, device)
    trace.synchronize(devices)
    log(f"set-up: inputs made at {time.perf_counter() - t0:.3f} s")
    nvcc_before = nvcc_runs()
    t_build = time.perf_counter()
    stencil = program.build(config)
    entry = Entry(stencil, config, traffic, inputs, devices)
    steps_per_call, span_name = entry.steps_per_call, entry.name
    saved = [t.clone() for t in entry.tensors()]
    entry.call()
    trace.synchronize(devices)
    build_s = time.perf_counter() - t_build
    log(f"set-up: stencil built, fields made and first call run in {build_s:.3f} s "
        f"(nvcc runs {nvcc_runs() - nvcc_before}), at {time.perf_counter() - t0:.3f} s")
    for _ in range(int(traffic["warmup_calls"]) - 1):
        entry.call()
    n_checked = int(traffic["checked_calls"])
    snapshots = [{r: torch.empty_like(t) for r, t in entry.view().items()}
                 for _ in range(2 * n_checked)]
    for t, s in zip(entry.tensors(), saved):
        t.copy_(s)
    del saved
    moments = [m * seconds for m in check.check_moments(seed, n_checked)]
    clock = Clock(devices, int(np.ceil(seconds * float(traffic["calls_per_s_max"]))) + 64)
    checked: list = []
    launches0, nvcc0 = kernel_launches(), nvcc_runs()
    trace.synchronize(devices)
    log(f"set-up: warmed up, state put back, {len(clock.events[0]) if clock.on_card else 0} "
        f"events a card made, at {time.perf_counter() - t0:.3f} s")

    # the harness's own objects (the events above) kept out of the
    # interpreter's collections during the window
    gc.collect()
    gc.freeze()
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    start = time.perf_counter()
    setup_s = start - t0
    clock.mark(-1)
    calls = 0
    call = entry.call
    seconds_marks, next_mark = [], 1.0
    while True:
        now = time.perf_counter() - start
        if now >= seconds:
            break
        if now >= next_mark:
            seconds_marks.append(calls)
            next_mark += 1.0
        if calls == 0 or (moments and now >= moments[0]):
            if calls:
                moments.pop(0)
            before, after = snapshots[2 * len(checked)], snapshots[2 * len(checked) + 1]
            for r, t in entry.view().items():
                before[r].copy_(t)
            info: dict = {}
            call(info)
            for r, t in entry.view().items():
                after[r].copy_(t)
            checked.append((calls, before, after, entry.strategies(info)))
        else:
            call()
        clock.mark(calls)
        calls += 1
    trace.synchronize(devices)
    window_s = time.perf_counter() - start
    usage = resource.getrusage(resource.RUSAGE_SELF)
    gc.unfreeze()
    launched = kernel_launches() - launches0
    nvcc_in_window = nvcc_runs() - nvcc0
    steps = calls * steps_per_call
    log(f"window: {calls} calls, {steps} steps in {window_s:.6f} s; launches by kernel "
        f"{launches_by_kernel()}, {launched} in the window; nvcc runs {nvcc_runs() - nvcc_before} "
        f"in set-up, {nvcc_in_window} in the window")
    intervals = clock.intervals_us(calls)
    per_second = np.diff([0] + seconds_marks)
    log(f"window: calls issued in each whole second {per_second.tolist()}; process CPU "
        f"{usage.ru_utime - usage0.ru_utime:.3f} s user, {usage.ru_stime - usage0.ru_stime:.3f} s "
        f"system; context switches {usage.ru_nvcsw - usage0.ru_nvcsw} voluntary, "
        f"{usage.ru_nivcsw - usage0.ru_nivcsw} involuntary")

    summary, spans = None, []
    if traced:
        spans = host_spans(entry, int(traffic["traced_calls"]), devices)
        summary = trace.traced_calls(entry, int(traffic["traced_calls"]), devices, kernel_launches)
        log(f"traced {traffic['traced_calls']} calls: busy {summary['busy_s']:.6f} s of "
            f"{summary['window_s']:.6f}; {summary['kernels_traced']} kernels traced of "
            f"{summary['kernels_launched']} launched")
    on_card = device.type == "cuda"
    memory_peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0

    # the program's state freed before the reference runs
    entry = stencil = call = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    fixed = {r: t for r, t in inputs.items() if r not in checked[0][1]}
    errors, kernels, modes = [], [], []
    for index, before, after, served in checked:
        if index == 0:  # the start: from the benchmark's own inputs alone
            before = {r: inputs[r] for r in before}
        want = check.follow(reference, config, before, fixed, steps_per_call,
                            getattr(torch, config["dtype"]))
        errors.append(check.rel_err(after, want))
        kernels.extend(served["kernel"])
        if "chain_mode" in served:
            modes.append(served["chain_mode"])
        log(f"checked call {index}: rel_err {errors[-1]!r}, served by {served}")
    limit = float(config["check"]["max_rel_err"])
    checks = {
        "max_rel_err": {"value": max(errors), "limit": limit, "rule": "<="},
        "calls_checked": {"value": len(checked), "limit": 1, "rule": ">="},
        "kernel_launches_per_step": {"value": launched / max(steps, 1), "limit": 1, "rule": ">="},
        "plain_steps_checked": {"value": sum(k in (None, "plain") for k in kernels),
                                "limit": 0, "rule": "<="},
        "nvcc_runs_in_window": {"value": nvcc_in_window, "limit": 0, "rule": "<="},
    }
    if modes:
        checks["chain_calls_not_graph"] = {
            "value": sum(m != "graph" for m in modes), "limit": 0, "rule": "<="}
    correct = all(
        (c["value"] <= c["limit"]) if c["rule"] == "<=" else (c["value"] >= c["limit"])
        for c in checks.values()
    )

    peaks = load_json(os.path.join(PERFBENCH, "peaks.json"))
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = SimpleNamespace(
        config=config, traffic=traffic, setup_s=setup_s, build_s=build_s, window_s=window_s,
        calls=calls, steps=steps, intervals_us=intervals, spans={span_name: spans},
        trace=summary, kind=kind, peak_Bps=peaks["hbm_Bps"].get(kind),
        itemsize=np.dtype(config["dtype"]).itemsize,
    )
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if traced and any(m.endswith("_roofline") for m in metrics):
        log(f"roofline shares against the published {run.peak_Bps} B/s; card, power limit: "
            f"{power_limit()}")
    for name, m in metrics.items():
        log(f"metric {name} {m['value']!r} {m['unit']}")

    result = {
        "correct": bool(correct),
        "attempted": calls,
        "failed": sum(e > limit for e in errors),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": kind,
            "count": len(devices),
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['rule']} {c['limit']!r}")
    return result
