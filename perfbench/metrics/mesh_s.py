"""Seconds of the grid's construction in set-up: the work of the first
``gt4py.build.mesh`` span of the configuration's grid
(``mesh_utils.icosahedral_mesh(mesh_root, mesh_bisections)``: the
icosahedron's division and bisections, the numbering and every table),
the build of the program's operands, which ends before the window. The
small grid the step is lowered on first is left out, and the check's
reference builds its grid without the port. Build spans are kept at any
time (perfbench/program_spans.py); None where the program records none."""

from perfbench import program_spans


def read(run):
    grid = (run.config.get("mesh_root"), run.config.get("mesh_bisections"))
    built = [r for r in program_spans.records() or () if r.name == "gt4py.build.mesh"
             and (r.attrs.get("root"), r.attrs.get("bisections")) == grid]
    if not built:
        return None
    return program_spans.work_ns(built[0]) / 1e9
