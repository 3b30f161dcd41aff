"""The comparison that decides ``correct``.

A run checks a sample of the window's calls, drawn from the seed: the
window's first call, which starts from the seeded inputs, and the first call
after each of ``checked_calls - 1`` moments of the window. Before such a
call the harness copies the carried roles' content as the user reads it
(``Entry.view``), and again after it. Once the window has closed and the
program's state is freed, the plain reference follows the same call from the
copy taken before it, in float64, with the benchmark's own inputs for the
roles the program only reads, and the number compared is the widest gap
between the program's content after the call and the reference's, relative
to the reference's largest magnitude (``rel_err``). The first call checks the
start from the seed alone; a later one checks the program's step from its own
state, which only the program's previous calls made.
"""

from __future__ import annotations

import random

import torch


def check_moments(seed: int, n_checked: int) -> list[float]:
    """Shares of the window after which a call is checked, drawn from the
    seed (the first call is always checked, besides these)."""
    rng = random.Random(int(seed))
    return sorted(rng.uniform(0.05, 0.95) for _ in range(max(n_checked - 1, 0)))


def follow(reference, config: dict, before: dict, fixed: dict, steps: int,
           dtype: torch.dtype) -> dict:
    """The carried roles after ``steps`` applications of ``reference.step``
    from ``before`` (the carried roles) and ``fixed`` (the read-only roles),
    computed in ``dtype``, the roles rotated by the configuration's swap
    after every step, as the port's ``chain`` defines it."""
    swap = config["swap"]
    fields = {r: t.to(dtype) for r, t in {**fixed, **before}.items()}
    for _ in range(steps):
        fields.update(reference.step(fields, config))
        fields = {r: fields[swap.get(r, r)] for r in fields}
    return {r: fields[r] for r in before}


def rel_err(got: dict, want: dict) -> float:
    """The widest gap between ``got`` and ``want`` over every role, relative
    to ``want``'s largest magnitude; a value that is not finite on either
    side reads as infinitely far."""
    worst = 0.0
    for role, w in want.items():
        w = w.double()
        g = got[role].to(w.device).double()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            return float("inf")
        scale = w.abs().max().item()
        gap = (g - w).abs().max().item()
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst
