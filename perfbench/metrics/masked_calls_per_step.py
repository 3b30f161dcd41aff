"""Calls a step that the generated gather-reduce kernel served masking a
table's skip values, in the traced program calls: the sum of the ``masked``
attribute of the traced ``gt4py.next.program`` roots
(``unstructured_codegen.calls_served["masked"]`` in each call), over the
roots. ICON's step on the icosahedral grid reads 2.0: both calls of the
radial-basis interpolation, whose neighbor sums skip V2E's absent slots at
the pentagons. The port's spans (perfbench/program_spans.py); None where it
records none, or its program roots carry no such attribute."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run, "gt4py.next.program")
    if not calls or any("masked" not in root.attrs for root, _ in calls):
        return None
    return sum(int(root.attrs["masked"]) for root, _ in calls) / len(calls)
