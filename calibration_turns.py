#!/usr/bin/env python3
"""Step 12 of chip_smoke.py (bench.py's calibration probes, and the main
paths' walks over their ceilings) on two checkouts of this repository, in
turns on one card, so that a change to the probes is read against its parent
on the same card and in the same call.

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 calibration_turns.py PARENT CHANGE [LOG_DIR]

runs step 12 of each checkout in a process of its own, in the order PARENT,
CHANGE, CHANGE, PARENT, and prints, for every probe variant and every walk,
the four readings side by side (µs a launch by the probes' two-point fit,
and the walks' device µs a step as chip_smoke.py's step 4 takes them). Each
run's own lines go to LOG_DIR (default: the current directory), as
calibration_turns_<n>_<parent|change>.log.

    python3 calibration_turns.py --one CHECKOUT

is one such run: it builds the main paths that step 12 holds against the
ceilings (chip_smoke.CAL_WALKS) and the probes, one nvcc per source, takes
each walk's device µs (chip_smoke.device_ms), the device copy's rate, and
calls the checkout's own chip_smoke.run_calibration; its last line is one
JSON object with the probes' rows and the walks' µs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(checkout: str) -> int:
    checkout = os.path.abspath(checkout)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [checkout] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    os.chdir(checkout)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("calibration_turns: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import calibration, cuda_backend
    from tests import torch_stencil_defs as defs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{checkout}: {smi}")
    cases = {c["name"]: c for c in cs.path_cases(defs)}
    shape = (cs.NI + 2 * cs.HALO, cs.NJ + 2 * cs.HALO, cs.NK)
    origin = (cs.HALO, cs.HALO, 0)
    runs = []
    for name, dtype in dict.fromkeys(cs.CAL_WALKS.values()):
        case = cases[name]
        kern = cs.build_stencil(gtscript, case["definition"], "cuda:hopper", dtype,
                                case["externals"], fuse=case.get("fuse", False))
        scalars = {n: np.dtype(dtype).type(v) for n, v in case["scalars"].items()}
        runs.append({"case": case, "dtype": dtype, "kern": kern, "scalars": scalars})
    cuda_backend.build_libraries([r["kern"]._backend.module.source for r in runs]
                                 + [calibration.source()])
    for run in runs:
        run["host"] = {n: cs.in_dtype(v, run["dtype"])
                       for n, v in cs.make_host(run["case"], shape, 7, np).items()}
        fields = cs.card_fields(run["host"], origin, run["case"], storage)
        run["device_ms"] = cs.device_ms(run, fields, 20)
    copy_gbs = cs.copy_bandwidth() / 1e9
    rows = cs.run_calibration(runs, copy_gbs, calibration, smi, torch)
    walks = {f"{r['case']['name']} {r['dtype']}": r["device_ms"] * 1e3 for r in runs}
    print(json.dumps({"smi": smi, "copy_GBps": copy_gbs, "walks_us": walks,
                      "probes_us": {r["name"]: r["ms"] * 1e3 for r in rows},
                      "spread_pct": {r["name"]: r["spread_pct"] for r in rows},
                      "bound_us": {r["name"]: r["bound_ms"] * 1e3 for r in rows},
                      "library_us": {r["name"]: r["library_ms"] * 1e3 for r in rows
                                     if r["library_ms"] is not None}}))
    return 0


def turns(parent: str, change: str, logs: str = ".") -> int:
    os.makedirs(logs, exist_ok=True)
    order = (("parent", parent), ("change", change), ("change", change), ("parent", parent))
    results = []
    for n, (tag, checkout) in enumerate(order):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", checkout],
                              capture_output=True, text=True)
        with open(os.path.join(logs, f"calibration_turns_{n}_{tag}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"calibration_turns: run {n} ({tag}) exited {proc.returncode}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(results[0]["smi"])
    print("device copy GB/s: " + ", ".join(f"{r['copy_GBps']:.1f}" for r in results))
    heads = " ".join(f"{f'{tag} {n}':>10s}" for n, (tag, _) in enumerate(order))
    for part, label in (("probes_us", "probe µs a launch"), ("walks_us", "walk device µs a step")):
        print(f"{label:40s} {heads}")
        for key in results[0][part]:
            print(f"  {key:38s} " + " ".join(f"{r[part].get(key, float('nan')):10.3f}"
                                               for r in results))
    for part in ("spread_pct", "bound_us", "library_us"):
        print(f"{part}: " + json.dumps([r[part] for r in results]))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"] and len(sys.argv) == 3:
        sys.exit(one(sys.argv[2]))
    if len(sys.argv) in (3, 4):
        sys.exit(turns(*sys.argv[1:]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
