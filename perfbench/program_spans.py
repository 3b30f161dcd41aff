"""The port's own spans in a traced run, as the per-layer metrics read them.

The port records a span (``gt4py_tpu_torch.instrumentation.spans``) per
call only while a ``torch.profiler`` profile records, and a build span
always. In a ``--trace 1`` run only the traced calls (trace.py) run under
the profile, so the last ``traced_calls`` root spans of the entry are
theirs. A program that records no spans (one older than them) gives
nothing to read: every function here returns None then, and never raises.
"""

from __future__ import annotations


def records():
    """Every span record the program has kept, or None where it keeps none."""
    try:
        from gt4py_tpu_torch import instrumentation
    except ImportError:
        return None
    read = getattr(instrumentation, "spans", None)
    return None if read is None else read()


def traced_calls(run, root_name: str = "gt4py.chain"):
    """``[(root, children)]`` for each traced call: its root span named
    ``root_name`` and the records that share its root id, in the order they
    ended; None where the run was not traced or fewer such roots were kept
    than it traced."""
    kept = records()
    n = int(run.traffic.get("traced_calls", 0))
    if not kept or not run.trace or n <= 0:
        return None
    roots = [r for r in kept if r.name == root_name and r.parent is None][-n:]
    if len(roots) < n:
        return None
    calls = {r.id: (r, []) for r in roots}
    for r in kept:
        if r.root in calls and r.id != r.root:
            calls[r.root][1].append(r)
    return list(calls.values())


def work_ns(r) -> int:
    """The enclosed work's ns: the span's duration less its own recording's
    (``overhead_ns``: the ``record_function`` range's entry and exit)."""
    return r.end_ns - r.start_ns - r.overhead_ns


def self_ns(span, children) -> int:
    """``span``'s work less the part of it its ``children`` cover (their
    recording included)."""
    covered, last = 0, span.start_ns
    for lo, hi in sorted((c.start_ns, c.end_ns) for c in children):
        lo, hi = max(lo, last), min(hi, span.end_ns)
        if hi > lo:
            covered += hi - lo
            last = hi
    return work_ns(span) - covered


def steps(calls) -> int:
    return sum(int(root.attrs.get("steps", 0)) for root, _ in calls)


def attr_sum(calls, names, key: str) -> int:
    """The sum of attribute ``key`` over the traced calls' spans named in
    ``names``."""
    return sum(int(r.attrs.get(key, 0)) for _, rs in calls for r in rs if r.name in names)
