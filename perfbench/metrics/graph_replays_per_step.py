"""CUDA-graph replays a model step in the traced ``chain`` calls: the sum of
the ``replays`` of their ``gt4py.backend.replay`` spans over their steps
(the ``steps`` of their ``gt4py.chain`` spans). A graph holds one swap
cycle, so this is 1 / the cycle's steps. The port's counters
(perfbench/program_spans.py); None where it records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run)
    steps = program_spans.steps(calls) if calls else 0
    if not steps:
        return None
    return program_spans.attr_sum(calls, ("gt4py.backend.replay",), "replays") / steps
