"""The plain references held against the port's ``numpy`` backend at a small
size, and the roofline's byte counts pinned to bench_torch.py's."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO

from perfbench import spec

SMALL = {"cosmo_hdiff_256x256x80_f32": ([16, 16, 6], [12, 12, 6]),
         "cosmo_vadv_256x256x80_f32": ([16, 16, 6], [15, 16, 6])}


def small(name):
    config = spec.load_json(os.path.join(REPO, "perfbench", "configs", f"{name}.json"))
    shape, domain = SMALL[name]
    for field in config["fields"].values():
        field["shape"] = shape
    config["domain"] = domain
    return config


def inputs(config, seed=7):
    rng = np.random.default_rng(seed)
    return {n: (rng.random(f["shape"]) * f.get("scale", 1.0) if f["draw"] == "uniform"
                else np.zeros(f["shape"])).astype(config["dtype"])
            for n, f in config["fields"].items()}


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_equals_the_numpy_backend(name, dtype):
    """One application on the same inputs; float32 within the rounding of
    80-level-free sums of a few terms, float64 to a few ulps."""
    from gt4py_tpu_torch import storage

    config = small(name)
    config["dtype"] = dtype
    config["literal_precision"] = 32 if dtype == "float32" else 64
    config["backend"] = "numpy"
    host = inputs(config)
    program = spec.load_module(REPO, "programs", config["program"])
    stencil = program.build(config)
    fields = {n: storage.from_array(a, backend="numpy", aligned_index=tuple(config["origin"]))
              for n, a in host.items()}
    scalars = {k: np.dtype(dtype).type(v) for k, v in config["scalars"].items()}
    stencil(**fields, **scalars, domain=tuple(config["domain"]))
    reference = spec.load_module(REPO, "reference", config["program"])
    want = reference.step({n: torch.from_numpy(a) for n, a in host.items()}, config)
    rtol = 2e-6 if dtype == "float32" else 1e-13
    for role, w in want.items():
        np.testing.assert_allclose(np.asarray(fields[role]), w.numpy(), rtol=rtol, atol=rtol)


def test_periodic_reference_equals_the_padded_one():
    """The mesh configuration's global step equals the one-card step on the
    same field with its halo wrapped around it."""
    config = spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                         "cosmo_hdiff_2x2_512x512x80_f32.json"))
    reference = spec.load_module(REPO, "reference", "hdiff")
    rng = np.random.default_rng(3)
    g = {n: torch.from_numpy(rng.random((10, 12, 4))) for n in ("in_field", "coeff", "out_field")}
    got = reference.step(g, {**config, "domain": [10, 12, 4]})["out_field"]
    wrap = lambda t: torch.from_numpy(np.pad(t.numpy(), ((2, 2), (2, 2), (0, 0)), mode="wrap"))
    padded = {n: wrap(t) for n, t in g.items()}
    one = {**config, "mesh": None, "origin": [2, 2, 0], "domain": [10, 12, 4]}
    want = reference.step(padded, one)["out_field"][2:-2, 2:-2]
    assert torch.equal(got, want)


def test_reference_imports_nothing_of_the_port_or_jax():
    for name in ("hdiff", "vadv"):
        path = os.path.join(REPO, "perfbench", "reference", f"{name}.py")
        tree = ast.parse(open(path).read())
        imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
        imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
        assert imported <= {"torch"}, imported
    code = ("import sys; sys.path.insert(0, %r); from perfbench import spec; "
            "[spec.load_module(%r, 'reference', n) for n in ('hdiff', 'vadv')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gt4py_tpu', 'gt4py_tpu_torch'}))" % (REPO, REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_byte_counts_equal_bench_torch_at_the_cells_sizes():
    sys.path.insert(0, REPO)
    import bench_torch

    hdiff = spec.load_module(REPO, "metrics", "hdiff_roofline")
    vadv = spec.load_module(REPO, "metrics", "vadv_roofline")
    assert hdiff.hdiff_bytes(256, 256, 80, 2) == bench_torch.hdiff_bytes(256, 256, 80, 2)
    assert hdiff.hdiff_bytes(256, 256, 80, 2) == 63_575_040
    assert vadv.vadv_bytes(256, 256, 80) == bench_torch.vadv_bytes(256, 256, 80) == 125_337_600
    config = spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                         "cosmo_vadv_256x256x80_f32.json"))
    assert vadv.vadv_points(*config["fields"]["utens_stage"]["shape"]) == \
        np.prod(config["domain"])
