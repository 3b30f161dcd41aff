"""Horizontal diffusion in plain PyTorch, written from the GTScript definition
in perfbench/programs/hdiff.py.

``step`` applies it once. Without a mesh the fields are the storages' arrays
(I, J, K), halo included: the domain starts at ``origin`` and the halo cells
are read, never written. With a mesh they are the global arrays of the
domain, and the halo wraps around them (the ``periodic`` boundary).
"""

import torch


def _apply(v: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """hdiff over ``v``, which holds the domain and 2 cells around it in I
    and J; ``coeff`` is the domain's. Operations in the definition's order."""
    lap = 4.0 * v[1:-1, 1:-1] - (v[2:, 1:-1] + v[:-2, 1:-1] + v[1:-1, 2:] + v[1:-1, :-2])
    res = lap[1:, 1:-1] - lap[:-1, 1:-1]
    flx = torch.where(res * (v[2:-1, 2:-2] - v[1:-2, 2:-2]) > 0, torch.zeros_like(res), res)
    res = lap[1:-1, 1:] - lap[1:-1, :-1]
    fly = torch.where(res * (v[2:-2, 2:-1] - v[2:-2, 1:-2]) > 0, torch.zeros_like(res), res)
    return v[2:-2, 2:-2] - coeff * (flx[1:] - flx[:-1] + fly[:, 1:] - fly[:, :-1])


def step(fields: dict, config: dict) -> dict:
    """One application; returns the written field as a new tensor."""
    halo = config["halo"]
    inp, coeff, out = fields["in_field"], fields["coeff"], fields["out_field"]
    if config.get("mesh"):
        ni, nj = inp.shape[:2]
        wrap_i = torch.arange(-halo, ni + halo, device=inp.device) % ni
        wrap_j = torch.arange(-halo, nj + halo, device=inp.device) % nj
        return {"out_field": _apply(inp[wrap_i][:, wrap_j], coeff)}
    (oi, oj, ok), (ni, nj, nk) = config["origin"], config["domain"]
    v = inp[oi - halo:oi + ni + halo, oj - halo:oj + nj + halo, ok:ok + nk]
    new = out.clone()
    new[oi:oi + ni, oj:oj + nj, ok:ok + nk] = _apply(v, coeff[oi:oi + ni, oj:oj + nj, ok:ok + nk])
    return {"out_field": new}
