"""The port's copy of the front half (frontend, GTIR, passes) is faithful:
for the same definition, ``gtir_pretty.pretty`` of the port's analyzed
stencil equals the JAX package's, text for text."""

import ast
import difflib
import os
import re

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu.cartesian.gtir_pretty import pretty as ref_pretty
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtir_pretty import parse, pretty

from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs
from .test_torch_cartesian import JAX_TWINS

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pretty_pair(name, *, backend="torch", **options):
    entry = defs.REGISTRY.get(name)
    definition = entry["definition"] if entry else getattr(defs, name)
    externals = dict(entry["externals"]) if entry else {}
    externals.update(options.pop("externals", {}))
    if name in JAX_TWINS:  # the port's own definitions, named as the port names them
        options.update(dtypes=entry["dtypes"], name=name)
    port = gtscript.stencil(
        backend=backend, definition=definition, externals=externals, **options
    )
    ref = ref_gtscript.stencil(
        backend="numpy", definition=JAX_TWINS.get(name) or getattr(ref_defs, name),
        externals=externals, **options,
    )
    return pretty(port._analyzed.stencil), ref_pretty(ref._analyzed.stencil)


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_pretty_ir_matches_reference(name):
    mine, ref = _pretty_pair(name)
    assert mine == ref


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generic_vadv_pretty_ir_matches_reference(backend, dtype):
    precision = 32 if dtype == np.float32 else 64
    mine, ref = _pretty_pair(
        "vertical_advection_dycore_generic",
        backend=backend,
        externals=defs.VADV_EXTERNALS,
        dtypes={"vadv_dt": dtype},
        literal_float_precision=precision,
        literal_int_precision=precision,
    )
    assert mine == ref


@pytest.mark.parametrize("name", ["horizontal_diffusion", "tridiagonal_solver"])
def test_pretty_ir_round_trips(name):
    port = gtscript.stencil(backend="torch", definition=defs.REGISTRY[name]["definition"])
    text = port.pretty_ir()
    assert pretty(parse(text)) == text


def test_bfloat16_literals_build():
    """``literal_float_precision="bf16"`` builds, as in the JAX package, and
    its GTIR prints as the JAX package's does, bf16 literals included."""
    mine, ref = _pretty_pair("lap_of_lap", literal_float_precision="bf16")
    assert ":bf16" in mine
    assert mine == ref
    assert pretty(parse(mine)) == mine


# --- the field-view front half (gt4py_tpu_torch.next) -------------------------------

#: the port's copies of the JAX package's array-free field-view modules
NEXT_COPIES = (
    "errors.py", "frontend_validation.py", "type_system.py", "fingerprinting.py",
    "experimental.py", "typing.py", "foast.py", "foast_passes.py",
    "type_deduction.py", "past.py", "foast_pretty.py",
)
#: what the JAX package's side of a differing hunk must name: JAX itself;
#: the port's side names none
_JAX_WORDS = re.compile(r"\bjax\b|\bjnp\b|\blax\b|\bXLA\b|ml_dtypes")
#: differing lines a copy may hold at most, on the JAX package's side
_MAX_DIFFERING = 16


def _module_body(path: str, rename: bool) -> list:
    """A module's source lines after its docstring; ``rename``: as the port
    copies it (imports renamed, machine paths dropped)."""
    with open(path) as f:
        text = f.read()
    if rename:
        text = re.sub(r"/\w+/reference/", "", text)
        text = re.sub(r"\bgt4py_tpu\b", "gt4py_tpu_torch", text)
    start = ast.parse(text).body[0].end_lineno
    return text.splitlines()[start:]


@pytest.mark.parametrize("name", NEXT_COPIES)
def test_next_copy_has_not_drifted(name):
    """Each copied ``next`` module equals the JAX package's, imports
    renamed, but for hunks that replace a use of JAX: a change to either
    copy's array-free code fails here."""
    theirs = _module_body(os.path.join(REPO_ROOT, "gt4py_tpu", "next", name), rename=True)
    ours = _module_body(os.path.join(REPO_ROOT, "gt4py_tpu_torch", "next", name), rename=False)
    matcher = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False)
    differing = 0
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        ref_side, port_side = "\n".join(theirs[i1:i2]), "\n".join(ours[j1:j2])
        assert _JAX_WORDS.search(ref_side), f"{name} drifted:\n-{ref_side}\n+{port_side}"
        assert not _JAX_WORDS.search(port_side), f"{name}: the port's copy names JAX:\n{port_side}"
        differing += i2 - i1
    assert differing <= _MAX_DIFFERING, f"{name}: {differing} lines differ"


@pytest.mark.parametrize("name", ["lap", "hdiff_op", "solve_tridiag", "next_vadv"])
def test_next_foast_source_matches_reference(name):
    """The copied FOAST pipeline emits the same source for the same
    operator in both packages."""
    from tests.next_tests import test_cartesian_bridge as ref_ops

    from . import torch_next_defs as next_defs

    assert getattr(next_defs, name).inspect(stage="foast") == getattr(ref_ops, name).inspect(
        stage="foast")


# --- the copied CPU backend generator and test kit ------------------------------------

#: the port's copies of array-free modules outside ``next``: path under each
#: package -> the port's own changes, each hunk's port side naming one
PORT_COPIES = {
    "cartesian/backend/c_codegen.py": (
        # NumPy 2's repr of a float32 is "np.float32(0.1)", no C literal
        "# str, not repr",
    ),
    "testing/__init__.py": (),
    "testing/input_strategies.py": (),
    "testing/narrowing.py": (),
    # the suites' storages on a device of the caller's choosing
    "testing/suites.py": ('device = getattr(suite, "device", None)', "device=device"),
    # the port's tables and fields hold tensors, the relabelled table stays
    # on its device; shift_structure_report (the roll plan's report) is not
    # ported
    "next/mesh_utils.py": (
        "# the port's tables are tensors", "# where the relabelled table stays",
        "# the port's fields hold tensors", "from gt4py_tpu_torch.core.ndarray_utils import",
        # ICON's planar torus and global icosahedral grid, the ICON diffusion
        # benchmark's meshes
        "periodic_triangle_mesh", "icosahedral_mesh",
    ),
}
#: functions of a copied module the port leaves out, with the reason
PORT_OMITS = {"next/mesh_utils.py": ("shift_structure_report",)}


def _without_functions(lines: list, names) -> list:
    """``lines`` without the top-level functions ``names`` and their names in
    ``__all__``."""
    text = "\n".join(lines)
    if not names:
        return lines
    tree = ast.parse(text)
    drop = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            drop.update(range(node.lineno - 1, node.end_lineno + 2))
    return [line for i, line in enumerate(lines)
            if i not in drop and not any(f'"{n}",' in line for n in names)]


@pytest.mark.parametrize("path", sorted(PORT_COPIES))
def test_port_copy_has_not_drifted(path):
    """Each copied module equals the JAX package's, imports renamed, but for
    hunks that replace a use of JAX and the port's own changes listed in
    PORT_COPIES, each of which must still be there."""
    theirs = _module_body(os.path.join(REPO_ROOT, "gt4py_tpu", path), rename=True)
    ours = _module_body(os.path.join(REPO_ROOT, "gt4py_tpu_torch", path), rename=False)
    theirs = _without_functions(theirs, PORT_OMITS.get(path, ()))
    matcher = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False)
    changes = set()
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        ref_side, port_side = "\n".join(theirs[i1:i2]), "\n".join(ours[j1:j2])
        mine = [c for c in PORT_COPIES[path] if c in port_side]
        assert mine or _JAX_WORDS.search(ref_side), f"{path} drifted:\n-{ref_side}\n+{port_side}"
        assert not _JAX_WORDS.search(port_side), f"{path}: the port's copy names JAX:\n{port_side}"
        changes.update(mine)
    assert changes == set(PORT_COPIES[path])
