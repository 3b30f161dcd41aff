"""Kernel launches a call in the traced field-operator calls: the sum of the
``launches`` of their ``gt4py.next.replay`` spans (a graph replay's
kernels) and ``gt4py.next.launch`` spans (a launch outside a graph) over
the traced ``gt4py.next.call`` roots. Read only where it equals the
launches the port's kernel counters (``cuda_backend.WRAPPERS``) saw in
those calls. The port's counters (perfbench/program_spans.py); None where
it records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run, "gt4py.next.call")
    if not calls:
        return None
    launches = program_spans.attr_sum(
        calls, ("gt4py.next.replay", "gt4py.next.launch"), "launches")
    if launches != run.trace["kernels_launched"]:
        return None
    return launches / len(calls)
