"""The comparison that decides ``correct``, shown to fail: a run driven on the
CPU past the harness's look for a card, with the timed path broken underneath
(the port's plain version, which its kernels' launches stand in for there),
reads ``max_rel_err`` above its limit for each fault a cell can have; the
same run unbroken reads it within. And the control, the plain reference in
bfloat16 in the program's place (perfbench/control.py), fails it too."""

import time

import pytest

from perfbench import control
from perfbench.harness import run_cell
from perfbench.spec import Cell

CELLS = ["hdiff-chain", "vadv-chain", "hdiff-calls", "hdiff-2x2-apply"]


def unchanged(run_plain):
    """A step that returns its state unchanged."""
    return lambda analyzed, arrays, scalars, domain, origins: {}


def half_domain(run_plain):
    """Half of the domain left out."""
    return lambda analyzed, arrays, scalars, domain, origins: run_plain(
        analyzed, arrays, scalars, (domain[0] // 2, domain[1], domain[2]), origins)


def altered(run_plain):
    """An answer altered where it is produced: one written point moved by 1."""
    def run(analyzed, arrays, scalars, domain, origins):
        written = run_plain(analyzed, arrays, scalars, domain, origins)
        for name, t in written.items():
            oi, oj, ok = origins[name]
            t[oi + domain[0] // 2, oj + domain[1] // 2, ok] += 1.0
        return written
    return run


def comparison(root, workload, seed=2**31 + 11):
    cell = Cell(root, workload)
    result = run_cell(cell, seed, 0.4, False, ["cpu"] * cell.chips, time.perf_counter())
    return result["checks"]["max_rel_err"], result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_run_is_within_the_limit(small_root, workload):
    check, _ = comparison(small_root, workload)
    assert check["value"] <= check["limit"]


@pytest.mark.parametrize("fault", [unchanged, half_domain, altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_fails_the_comparison(small_root, workload, fault, monkeypatch):
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    monkeypatch.setattr(cuda_backend, "run_plain", fault(cuda_backend.run_plain))
    check, correct = comparison(small_root, workload)
    assert check["value"] > check["limit"]
    assert correct is False


def test_the_exchange_left_out_fails_the_comparison(small_root, monkeypatch):
    from gt4py_tpu_torch.parallel import halo

    monkeypatch.setattr(halo, "run", lambda transfers, buffers: None)
    check, correct = comparison(small_root, "hdiff-2x2-apply")
    assert check["value"] > check["limit"]
    assert correct is False


@pytest.mark.parametrize("workload", ["hdiff-chain", "vadv-chain", "hdiff-2x2-apply"])
def test_the_control_fails_the_comparison(small_root, workload, monkeypatch):
    monkeypatch.setattr(control, "ROOT", small_root)
    found = control.readings(small_root, workload, [1, 2, 3], 0.4, False, ["cpu"])
    limit = float(Cell(small_root, workload).config["check"]["max_rel_err"])
    assert min(found.values()) > limit
