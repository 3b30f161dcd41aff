"""Package rules of the PyTorch/CUDA port (gt4py_tpu_torch).

- No module of the port imports JAX, jaxlib, ml_dtypes or gt4py_tpu: the
  card's machine has none of them, and importing any gt4py_tpu module
  imports JAX (gt4py_tpu/__init__.py).
- Importing the port's public entry points leaves JAX unloaded.
- The port keeps the JAX package's layer contract
  (tests/package_tests/test_layering.py) within itself.
"""

import ast
import os
import subprocess
import sys

import pytest

import gt4py_tpu_torch

PKG_ROOT = os.path.dirname(gt4py_tpu_torch.__file__)
REPO_ROOT = os.path.dirname(PKG_ROOT)

FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "gt4py_tpu")

ALLOWED = {
    "eve": set(),
    "core": {"eve", "config", "cartesian"},
    "config": set(),
    "storage": {"core", "eve", "config"},
    "instrumentation": {"config"},
    "cartesian": {"core", "eve", "storage", "config", "instrumentation"},
    "next": {"core", "eve", "storage", "config", "instrumentation", "cartesian"},
    "testing": {"cartesian", "storage", "core", "eve", "config"},
    "parallel": {"cartesian", "next", "storage", "core", "eve", "config"},
    "examples": {"cartesian", "next", "storage", "core", "eve", "config", "instrumentation",
                 "parallel"},
}


def _modules():
    for dirpath, _, files in os.walk(PKG_ROOT):
        for fname in sorted(files):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def _imports_of(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _top(module: str) -> str:
    return module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(_modules()), ids=lambda p: os.path.relpath(p, PKG_ROOT)
)
def test_no_forbidden_import(path):
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_chip_smoke_imports_no_jax():
    path = os.path.join(REPO_ROOT, "chip_smoke.py")
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


def test_bench_torch_imports_no_jax():
    """bench_torch.py, bench.py's measuring program on the card, imports
    nothing of JAX, nor gt4py_tpu, nor bench.py."""
    path = os.path.join(REPO_ROOT, "bench_torch.py")
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN + ("bench",)]
    assert not bad


def test_stencil_defs_helper_imports_no_jax():
    path = os.path.join(REPO_ROOT, "tests", "torch_stencil_defs.py")
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


def test_next_defs_helper_imports_no_jax():
    path = os.path.join(REPO_ROOT, "tests", "torch_next_defs.py")
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("name", ["torch_cases.py", "torch_feature_defs.py"])
def test_feature_kit_imports_no_jax(name):
    """The feature kit and cases chip_smoke.py runs on the card's machine
    import no JAX (the feature cases' JAX twins load the JAX package's kit
    only when loaded against it)."""
    path = os.path.join(REPO_ROOT, "tests", name)
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize(
    "name", ["stages.py", "program_processors.py", "foast_pretty.py", "mesh_utils.py"])
def test_field_view_tier_modules_import_no_jax(name):
    """The field-view tier's new modules exist in the port and import no
    JAX (test_no_forbidden_import covers them too; this pins their names)."""
    path = os.path.join(PKG_ROOT, "next", name)
    assert os.path.isfile(path)
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


EXAMPLES = ["burgers", "custom_backend", "distributed_hdiff", "implicit_vertical_diffusion",
            "isentropic_diagnostics", "lap_cartesian_vs_next", "shallow_water",
            "tridiagonal_solver", "typed_operators"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_no_jax(name):
    """Each of the JAX package's examples has its counterpart in the port's
    ``examples`` subpackage, and it imports no JAX (test_no_forbidden_import
    covers them too; this pins their names)."""
    path = os.path.join(PKG_ROOT, "examples", name + ".py")
    assert os.path.isfile(path)
    assert os.path.isfile(os.path.join(REPO_ROOT, "examples", name + ".py"))
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


#: the JAX package's test files held against the port, each by one
#: tests/test_torch_<stem>.py whose first docstring line names it
RETARGETED = [
    *(f"next_tests/test_{stem}.py" for stem in (
        "common_depth", "common_model", "field_ops", "edge_semantics", "staggered",
        "toy_connectivity", "inverse_image_properties", "reductions_matrix",
        "builtins_matrix", "execution_breadth", "advanced_composition", "scan_features",
        "icon_like_scan", "arg_call_interface", "type_deduction", "type_conversion",
        "algebra_properties", "frontend_validation", "diagnostic_messages",
        "import_from_mod", "field_api_depth")),
    *(f"cartesian_tests/test_{stem}.py" for stem in (
        "stencil_object_validation", "k_offset_write", "stencils", "seq_fusion",
        "power_unroll", "gtir_pretty", "burgers", "isentropic")),
    "test_instrumentation.py",
]


@pytest.mark.parametrize("ref", RETARGETED)
def test_retargeted_file_names_its_reference(ref):
    """A rename on either side shows here: the reference file exists, and
    its port twin's first docstring line names it."""
    assert os.path.isfile(os.path.join(REPO_ROOT, "tests", ref))
    stem = os.path.basename(ref).removeprefix("test_")
    mine = os.path.join(REPO_ROOT, "tests", f"test_torch_{stem}")
    with open(mine) as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    assert doc.splitlines()[0].split()[0] == f"tests/{ref}"


def test_retargeted_files_import_no_jax():
    """The retargeted files run on the port alone (the examples' parity
    test, tests/test_torch_examples.py, is what imports both)."""
    for ref in RETARGETED:
        stem = os.path.basename(ref).removeprefix("test_")
        path = os.path.join(REPO_ROOT, "tests", f"test_torch_{stem}")
        bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
        assert not bad, (path, bad)


#: the JAX package's modules of gt4py_tpu/parallel/ and core/native.py, each
#: with its counterpart in the port
PARALLEL_MODULES = ["parallel/__init__.py", "parallel/mesh.py", "parallel/halo.py",
                    "parallel/distributed.py", "parallel/next_fields.py",
                    "parallel/unstructured.py", "core/native.py"]


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_parallel_modules_import_no_jax(rel):
    """Every module of the JAX package's parallel/ and core/native.py has
    its counterpart in the port, and it imports no JAX (test_no_forbidden_import
    covers them too; this pins their names)."""
    assert os.path.isfile(os.path.join(REPO_ROOT, "gt4py_tpu", rel))
    path = os.path.join(PKG_ROOT, rel)
    assert os.path.isfile(path)
    bad = [m for m in _imports_of(path) if _top(m) in FORBIDDEN]
    assert not bad


#: modules of gt4py_tpu/ whose counterpart has another name in the port
RENAMED = {
    "cartesian/backend/jax_backend.py": "cartesian/backend/torch_backend.py",
    "cartesian/backend/pallas_backend.py": "cartesian/backend/cuda_backend.py",
    "cartesian/backend/pallas_codegen.py": "cartesian/backend/cuda_codegen.py",
    "cartesian/backend/pallas_seq.py": "cartesian/backend/cuda_codegen.py",
    "cartesian/backend/pallas_split.py": "cartesian/backend/cuda_codegen.py",
}


def test_every_jax_package_module_has_its_counterpart():
    """After the parallel slice, each module of gt4py_tpu/ has a module of
    the same path in the port (the backends' under the names RENAMED gives)."""
    ref_root = os.path.join(REPO_ROOT, "gt4py_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref_root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), ref_root)
            if not os.path.isfile(os.path.join(PKG_ROOT, RENAMED.get(rel, rel))):
                missing.append(rel)
    assert not missing, f"no counterpart in the port: {sorted(missing)}"


def test_cartesian_mesh_without_a_card_raises(monkeypatch):
    """``CartesianMesh()`` lays the mesh over the cards and never falls back
    to the CPU."""
    import torch

    from gt4py_tpu_torch.parallel import CartesianMesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        CartesianMesh()


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import gt4py_tpu_torch.cartesian.gtscript, gt4py_tpu_torch.storage\n"
        "import gt4py_tpu_torch.cartesian.backend\n"
        "import gt4py_tpu_torch.next, gt4py_tpu_torch.next.cartesian_bridge\n"
        "import gt4py_tpu_torch.testing, gt4py_tpu_torch.cartesian.cache_manager\n"
        "import gt4py_tpu_torch.instrumentation.profiler\n"
        "import gt4py_tpu_torch.cartesian.backend.calibration\n"
        "import gt4py_tpu_torch.next.stages, gt4py_tpu_torch.next.program_processors\n"
        "import gt4py_tpu_torch.next.foast_pretty, gt4py_tpu_torch.next.mesh_utils\n"
        "import tests.torch_cases, tests.torch_feature_defs\n"
        "import gt4py_tpu_torch.examples.burgers, gt4py_tpu_torch.examples.custom_backend\n"
        "import gt4py_tpu_torch.examples.implicit_vertical_diffusion\n"
        "import gt4py_tpu_torch.examples.isentropic_diagnostics\n"
        "import gt4py_tpu_torch.examples.lap_cartesian_vs_next\n"
        "import gt4py_tpu_torch.examples.shallow_water\n"
        "import gt4py_tpu_torch.examples.tridiagonal_solver\n"
        "import gt4py_tpu_torch.examples.typed_operators\n"
        "import gt4py_tpu_torch.examples.distributed_hdiff\n"
        "import gt4py_tpu_torch.parallel, gt4py_tpu_torch.core.native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'gt4py_tpu')]\n"
        "print(','.join(sorted(bad)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    assert out.stdout.strip() == ""


#: the port's modules that hold or build a kernel: the plain references of
#: perfbench/reference/ name none of them
KERNEL_MODULES = ("cuda_backend", "cuda_codegen", "calibration", "unstructured_codegen",
                  "cartesian_bridge", "c_backend", "c_codegen", "native", "otf")


@pytest.mark.parametrize("name", ["icon_diffusion_vn_ico"])
def test_plain_reference_imports_no_kernel_and_no_jax(name):
    """The icosahedral grid's plain reference imports torch and the
    benchmark's own loader (for the torus reference it builds on) alone: it
    builds the grid itself, so no JAX, no gt4py_tpu and nothing of the
    port, no kernel module least of all. Loading it and deriving its tables
    leaves JAX and gt4py_tpu unloaded."""
    path = os.path.join(REPO_ROOT, "perfbench", "reference", name + ".py")
    imported = set(_imports_of(path))
    assert not [m for m in imported if _top(m) in FORBIDDEN]
    assert not [m for m in imported if _top(m) == "gt4py_tpu_torch"]
    assert not [m for m in imported if m.split(".")[-1] in KERNEL_MODULES]
    assert {_top(m) for m in imported} <= {"os", "torch", "perfbench"}
    code = (
        "import sys\n"
        "from perfbench import spec\n"
        f"ref = spec.load_module({REPO_ROOT!r}, 'reference', {name!r})\n"
        "ref.tables({'mesh_root': 1, 'mesh_bisections': 1}, 'cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'gt4py_tpu')]\n"
        "print(','.join(sorted(bad)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_layer_contract():
    violations = []
    for path in _modules():
        rel = os.path.relpath(path, PKG_ROOT)
        own = rel.split(os.sep)[0].removesuffix(".py")
        if own not in ALLOWED:
            continue
        for mod in _imports_of(path):
            parts = mod.split(".")
            if parts[0] != "gt4py_tpu_torch" or len(parts) < 2:
                continue
            dep = parts[1]
            if dep != own and dep not in ALLOWED[own]:
                violations.append(f"{rel}: {own} -> {dep} ({mod})")
    assert not violations, "layer contract violations:\n" + "\n".join(violations)


def test_copied_modules_name_their_origin():
    """Every module copied from gt4py_tpu names its origin in its docstring."""
    missing = []
    for path in _modules():
        rel = os.path.relpath(path, PKG_ROOT)
        origin = os.path.join(REPO_ROOT, "gt4py_tpu", rel)
        if not os.path.isfile(origin) or rel.endswith("__init__.py"):
            continue
        with open(path) as f:
            doc = ast.get_docstring(ast.parse(f.read())) or ""
        if "gt4py_tpu/" not in doc:
            missing.append(rel)
    assert not missing, f"no origin in the docstring of {missing}"


def test_own_registries():
    """The port's backends live in its own registries, not gt4py_tpu's."""
    from gt4py_tpu_torch.cartesian import backend
    from gt4py_tpu_torch.storage import layout

    from gt4py_tpu_torch.next import backend as next_backend

    mine = ["cpu:c", "cuda:hopper", "debug", "numpy", "torch"]
    assert sorted(backend.REGISTRY) == mine
    assert sorted(layout.REGISTRY) == mine
    assert {n: layout.REGISTRY[n].device for n in mine} == {
        "cpu:c": "cpu", "cuda:hopper": "cuda", "debug": "cpu", "numpy": "cpu", "torch": "cuda"}
    assert {layout.REGISTRY[n].layout_map for n in mine} == {(1, 2, 0)}  # K-leading
    assert {n: b.kind for n, b in next_backend.REGISTRY.items()} == {
        "cuda:hopper": "pallas", "cuda:hopper:aot": "aot", "numpy": "numpy", "torch": "eager"}


def test_reference_registry_untouched():
    import gt4py_tpu_torch.cartesian.backend  # noqa: F401
    import gt4py_tpu_torch.next  # noqa: F401
    from gt4py_tpu.cartesian import backend as ref_backend
    from gt4py_tpu.next import backend as ref_next_backend

    assert "torch" not in ref_backend.REGISTRY
    assert "cuda:hopper" not in ref_backend.REGISTRY
    from gt4py_tpu_torch.cartesian.backend import REGISTRY as port_registry

    for name in ("numpy", "debug", "cpu:c"):  # same names, the packages' own classes
        assert ref_backend.REGISTRY[name] is not port_registry[name]
        assert ref_backend.REGISTRY[name].__module__.startswith("gt4py_tpu.")
    assert "torch" not in ref_next_backend.REGISTRY
    assert "cuda:hopper" not in ref_next_backend.REGISTRY
