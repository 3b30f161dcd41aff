"""Seconds of the cell's stencil's front end and code generation: its last
``gt4py.build.front_end`` span (the GTScript front end and the analysis
passes) and ``gt4py.build.codegen`` span (the backend's code generator),
the stencil being the one the last code generation built. Build spans are
kept at any time (perfbench/program_spans.py); None where the program
records none."""

from perfbench import program_spans


def read(run):
    kept = program_spans.records()
    codegen = [r for r in kept or () if r.name == "gt4py.build.codegen"]
    if not codegen:
        return None
    stencil = codegen[-1].attrs.get("stencil")
    front = [r for r in kept if r.name == "gt4py.build.front_end"
             and r.attrs.get("stencil") == stencil]
    if not front:
        return None
    return (program_spans.work_ns(front[-1]) + program_spans.work_ns(codegen[-1])) / 1e9
