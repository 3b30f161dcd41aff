"""Kernel launches a step in the traced program calls: the sum of the
``launches`` attribute of the traced ``gt4py.next.program`` roots (the
port's kernels launched or replayed in each call, as its kernel counters
``cuda_backend.WRAPPERS`` saw them), over the roots. Read only where it
equals the launches the trace saw in those calls (``kernels_launched``).
The port's spans (perfbench/program_spans.py); None where it records
none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run, "gt4py.next.program")
    if not calls:
        return None
    launches = sum(int(root.attrs.get("launches", 0)) for root, _ in calls)
    if launches != run.trace["kernels_launched"]:
        return None
    return launches / len(calls)
