"""Fixtures of the harness's CPU tests: a copy of the benchmark with every
configuration cut to a few points, which the CPU runs in a second."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: each configuration's fields and domain at a size the CPU runs at once
SMALL = {
    "cosmo_hdiff_256x256x80_f32": ([16, 16, 6], [12, 12, 6]),
    "cosmo_vadv_256x256x80_f32": ([16, 16, 6], [15, 16, 6]),
    "cosmo_hdiff_2x2_512x512x80_f32": ([16, 16, 6], [16, 16, 6]),
}


def with_later(spec: dict, later: dict) -> dict:
    """BENCHMARK.json with the cells perfbench/later.json keeps for a later
    change added, as that change would add them: entries only."""
    spec = json.loads(json.dumps(spec))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] += later[key]
    for m in spec["per_layer"]:
        if m["name"] == "build_s":
            m["workloads"] += later["build_s_workloads"]
    for m in later["end_to_end"]:
        [m2 for m2 in spec["end_to_end"] if m2["name"] == m["name"]][0]["bound"] = 0.25
    return spec


def copy_benchmark(dst: str, later: bool = True) -> str:
    """A copy of BENCHMARK.json and perfbench/ (``later``: with the cells of
    perfbench/later.json added)."""
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if later:
        with open(os.path.join(REPO, "perfbench", "later.json")) as f:
            spec = with_later(spec, json.load(f))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return dst


def shrink(root: str) -> None:
    """Cut every configuration of the copy at ``root`` to ``SMALL``, and the
    traced calls of every traffic mix to a few."""
    configs = os.path.join(root, "perfbench", "configs")
    for name, (shape, domain) in SMALL.items():
        path = os.path.join(configs, f"{name}.json")
        with open(path) as f:
            config = json.load(f)
        for field in config["fields"].values():
            field["shape"] = list(shape)
        config["domain"] = list(domain)
        with open(path, "w") as f:
            json.dump(config, f)
    mixes = os.path.join(root, "perfbench", "traffic")
    for name in os.listdir(mixes):
        path = os.path.join(mixes, name)
        with open(path) as f:
            traffic = json.load(f)
        traffic["traced_calls"] = 6
        with open(path, "w") as f:
            json.dump(traffic, f)


@pytest.fixture
def small_root(tmp_path):
    """A copy of BENCHMARK.json, with perfbench/later.json's cells, and
    perfbench/ with small configurations."""
    root = copy_benchmark(str(tmp_path))
    shrink(root)
    return root


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
