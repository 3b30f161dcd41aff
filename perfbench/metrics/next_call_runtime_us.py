"""The field view's host µs in one warm operator call: the mean, over the
traced calls, of the ``gt4py.next.call`` span's duration less the part its
child spans cover (``FieldOperator.__call__``'s own work: the argument
checks, the offset provider's context, the bridge's refusal, the graph key
and its lookup). The port's spans (perfbench/program_spans.py); None where
it records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run, "gt4py.next.call")
    if not calls:
        return None
    total = sum(program_spans.self_ns(root, [c for c in rs if c.parent == root.id])
                for root, rs in calls)
    return total / len(calls) / 1e3
