"""Kernel launches a model step in the traced ``chain`` calls: the sum of
the ``launches`` of their ``gt4py.backend.replay`` spans (a replay's kernels)
and ``gt4py.backend.launch`` spans (a launch outside a graph) over their
steps. Read only where it equals the launches the port's kernel counters
(``cuda_backend.WRAPPERS``) saw in those calls. The port's counters
(perfbench/program_spans.py); None where it records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run)
    steps = program_spans.steps(calls) if calls else 0
    if not steps:
        return None
    launches = program_spans.attr_sum(
        calls, ("gt4py.backend.replay", "gt4py.backend.launch"), "launches")
    if launches != run.trace["kernels_launched"]:
        return None
    return launches / steps
