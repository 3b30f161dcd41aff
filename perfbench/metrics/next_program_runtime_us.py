"""The field view's host µs in one warm program call besides its kernels'
launches and replays: the mean, over the traced calls, of the
``gt4py.next.program`` root span's duration less the part its
``gt4py.next.replay`` and ``gt4py.next.launch`` descendants cover
(``Program.__call__``'s and each ``FieldOperator.__call__``'s own work: the
offset provider's context, the argument checks, the graph keys and their
lookups). The port's spans (perfbench/program_spans.py); None where it
records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run, "gt4py.next.program")
    if not calls:
        return None
    total = sum(program_spans.self_ns(root, [c for c in rs if c.name in (
        "gt4py.next.replay", "gt4py.next.launch")]) for root, rs in calls)
    return total / len(calls) / 1e3
