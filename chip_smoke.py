#!/usr/bin/env python3
"""Smoke run of gt4py_tpu_torch on one CUDA card (an H100).

Drives the port's main paths — ``gtscript.stencil`` → frontend → passes →
``cuda:hopper`` → generated CUDA kernels, on ``storage`` fields — through
the public API at the size weather and climate dycores run it, on a
256×256×80 domain with a halo of 2, in float32 and float64: hdiff (the
``plane`` kernel), vadv and tridiag (``column``), hdiff_sponge, hdiff as
three computations with an IJ coefficient and a K sponge profile
(``fused_plane``), and smoothed_column_sum, a FORWARD sweep coupling
neighbouring columns at every level (``tiled``).

1. Builds every kernel of those paths and of the registry phase from the
   sources in this checkout, one ``nvcc`` per source, all at once.
2. For each path: sets the launch counts to 0, runs the stencil once and as
   ``chain(10)``, reads the counts: its kernel must have launched. Every one
   of the four kernels must have launched on some path.
3. Holds every result against the plain version (the ``torch`` backend on the
   same card, same inputs) and, on a small input, against the NumPy oracle.
4. Times plain, kernel, kernel, plain with CUDA events over chained steps;
   takes the stencil's device time per step from CUDA events around a chain
   queued behind a spin kernel (no host cost inside); holds each kernel's
   compulsory bytes per second against a device-to-device copy measured in
   the same run.
5. Registry phase: every stencil of tests/torch_stencil_defs.py runs on
   ``cuda:hopper`` at 32×32×max(8, min_k) in its own dtypes, through the
   kernel pinned for it, against the plain version on the card.

Prints the card's name and power limit, one JSON line with the kernels, and
as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card it exits 1 and prints no result.

Usage: ``python3 chip_smoke.py`` (no arguments) from the repository root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

NI, NJ, NK, HALO = 256, 256, 80, 2
CHAIN_STEPS = 10
#: kernel vs plain on the same card: the build uses --fmad=false and the
#: plain version rounds every operation separately, so they agree to the
#: last bit in practice; the bound leaves room for one rounding per
#: operation of the longest chain (vadv/tridiag recurrences over 80 levels).
RTOL = {"float32": 1e-5, "float64": 1e-12}
#: kernel vs the NumPy oracle (float64 throughout) on a small input, as
#: (rtol, atol): float32 carries the rounding of 80-level recurrences
ORACLE_TOL = {"float32": (1e-4, 1e-5), "float64": (1e-10, 1e-12)}

#: registry phase: domain and halo
REG_N, REG_HALO = 32, 3
#: kernel -> the TPU pallas_call it replaces
REPLACES = {
    "plane": "gt4py_tpu/cartesian/backend/pallas_split.py:424",
    "fused_plane": "gt4py_tpu/cartesian/backend/pallas_codegen.py:1992",
    "column": "gt4py_tpu/cartesian/backend/pallas_seq.py:1130",
    "tiled": "gt4py_tpu/cartesian/backend/pallas_codegen.py:818",
}
SOURCE = "gt4py_tpu_torch/cartesian/backend/cuda_codegen.py"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    import numpy as np

    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from tests import torch_stencil_defs as defs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card}")

    def build(definition, backend, dtype, externals=None):
        opts = {"dtypes": {"dt": dtype, "vadv_dt": dtype}}
        if dtype == "float32":
            opts.update(literal_float_precision=32, literal_int_precision=32)
        return gtscript.stencil(
            backend=backend, definition=definition, externals=externals or {}, **opts
        )

    def inputs(case, dtype, shape, seed):
        return {n: v.astype(dtype) for n, v in make_host(case, shape, seed, np).items()}

    cases = [
        {
            "name": "hdiff", "kernel": "plane",
            "definition": defs.horizontal_diffusion_generic, "externals": {},
            "fields": ("in_field", "out_field", "coeff"), "scalars": {},
            "swap": {"in_field": "out_field", "out_field": "in_field"},
        },
        {
            "name": "vadv", "kernel": "column",
            "definition": defs.vertical_advection_dycore_generic,
            "externals": defs.VADV_EXTERNALS,
            "fields": ("utens_stage", "u_stage", "wcon", "u_pos", "utens"),
            "scalars": {"dtr_stage": 0.15}, "swap": {},
        },
        {
            "name": "tridiag", "kernel": "column",
            "definition": defs.tridiagonal_solver_generic, "externals": {},
            "fields": ("inf", "diag", "sup", "rhs", "out"), "scalars": {},
            "swap": {"rhs": "out", "out": "rhs"},
        },
        {
            "name": "hdiff_sponge", "kernel": "fused_plane",
            "definition": defs.hdiff_sponge, "externals": {},
            "fields": ("in_field", "out_field", "coeff", "damp"), "scalars": {},
            "dims": {"coeff": "IJ", "damp": "K"},
            "swap": {"in_field": "out_field", "out_field": "in_field"},
        },
        {
            "name": "smoothed_column_sum", "kernel": "tiled",
            "definition": defs.smoothed_column_sum, "externals": {},
            "fields": ("inp", "out"), "scalars": {}, "swap": {},
        },
    ]
    shape = (NI + 2 * HALO, NJ + 2 * HALO, NK)
    origin = (HALO, HALO, 0)
    domain = (NI, NJ, NK)

    # -- 1. build every kernel of the paths and the registry ------------------
    runs = []
    for dtype in ("float32", "float64"):
        for case in cases:
            kern = build(case["definition"], "cuda:hopper", dtype, case["externals"])
            plain = build(case["definition"], "torch", dtype, case["externals"])
            if kern._backend.strategy != case["kernel"]:
                raise AssertionError(
                    f"{case['name']} {dtype}: served by {kern._backend.strategy}, "
                    f"expected {case['kernel']}"
                )
            scalars = {n: np.dtype(dtype).type(v) for n, v in case["scalars"].items()}
            runs.append({"case": case, "dtype": dtype, "kern": kern, "plain": plain,
                         "scalars": scalars})
    registry = registry_stencils(defs, gtscript)
    t0 = time.perf_counter()
    stencils = [r["kern"] for r in runs] + [r["kern"] for r in registry]
    cuda_backend.build_libraries(st._backend.module.source for st in stencils)
    for st in stencils:
        st._backend._functions()  # load
    print(f"built and loaded {len(stencils)} stencils in {time.perf_counter() - t0:.1f} s")

    # -- 2. the main paths, each counted -------------------------------------------
    for run in runs:
        run["host"] = inputs(run["case"], run["dtype"], shape, seed=7)
        run["main"] = card_fields(run["host"], origin, run["case"], storage)
    torch.cuda.synchronize()
    served = set()
    for run in runs:
        case, fields = run["case"], run["main"]
        for wrapper in cuda_backend.WRAPPERS.values():
            wrapper.launches = 0
        info: dict = {}
        run["kern"](**fields, **run["scalars"], domain=domain, exec_info=info)
        if info["kernel_strategy"] != case["kernel"]:
            raise AssertionError(f"{case['name']}: strategy {info['kernel_strategy']}")
        run["kern"].chain(
            CHAIN_STEPS, **fields, **run["scalars"], swap=case["swap"], domain=domain
        )
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in cuda_backend.WRAPPERS.items()}
        run["launches"] = counts[case["kernel"]]
        print(f"launches on the {case['name']} {run['dtype']} path: {counts}")
        if run["launches"] == 0:
            raise AssertionError(f"{case['name']}: the {case['kernel']} kernel was not launched")
        served |= {k for k, n in counts.items() if n}
    missing = set(cuda_backend.WRAPPERS) - served
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {sorted(missing)}")

    # -- 3. correctness ------------------------------------------------------------
    for run in runs:
        case, dtype = run["case"], run["dtype"]
        ref = card_fields(run["host"], origin, case, storage)
        run["plain"](**ref, **run["scalars"], domain=domain)
        run["plain"].chain(
            CHAIN_STEPS, **ref, **run["scalars"], swap=case["swap"], domain=domain
        )
        err = 0.0
        for n in case["fields"]:
            got, want = run["main"][n].array, ref[n].array
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{case['name']} {dtype}: non-finite values in {n}")
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=RTOL[dtype], atol=0.0):
                raise AssertionError(
                    f"{case['name']} {dtype}: kernel disagrees with plain in {n} "
                    f"(max abs err {err})"
                )
        run["max_abs_err"] = err
        check_oracle(run, defs, np, storage)
        print(f"{case['name']} {dtype}: kernel == plain within rtol {RTOL[dtype]} "
              f"(max abs err {err:.3e}); oracle ok")

    # -- 4. timing: plain, kernel, kernel, plain -------------------------------------
    copy_gbs = copy_bandwidth() / 1e9
    rows = []
    for run in runs:
        case = run["case"]
        fields = card_fields(run["host"], origin, case, storage)
        p1 = time_steps(run["plain"], fields, run, 3)
        k1 = time_steps(run["kern"], fields, run, 20)
        k2 = time_steps(run["kern"], fields, run, 20)
        p2 = time_steps(run["plain"], fields, run, 3)
        dev = device_ms(run, card_fields(run["host"], origin, case, storage), 20)
        run["ms"], run["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        run["device_ms"] = dev
        run["gbs"] = compulsory_bytes(run["kern"], np.dtype(run["dtype"]).itemsize) / dev / 1e6
        pts = NI * NJ * NK
        rows.append(
            f"{case['name']:19s} {run['dtype']:8s} {case['kernel']:11s} "
            f"plain {run['plain_ms'] * 1e3:10.1f} us/step ({p1 * 1e3:.1f}, {p2 * 1e3:.1f})  "
            f"kernel {run['ms'] * 1e3:8.1f} us/step ({k1 * 1e3:.1f}, {k2 * 1e3:.1f})  "
            f"device {dev * 1e3:8.1f} us/step  "
            f"{pts / (dev * 1e-3) / 1e9:7.2f} Gpoints/s  "
            f"{run['gbs']:7.1f} GB/s of compulsory bytes ({run['gbs'] / copy_gbs:.1%} of copy)"
        )
    print(f"timings on {smi}, {NI}x{NJ}x{NK}; steps by CUDA events, "
          "device time by CUDA events behind a spin kernel:")
    print(f"  device-to-device copy of 256 MiB: {copy_gbs:.1f} GB/s (read + write)")
    for r in rows:
        print("  " + r)

    # -- 5. the registry -----------------------------------------------------------
    t0 = time.perf_counter()
    for reg in registry:
        run_registry_stencil(reg, defs, storage, cuda_backend, np, torch)
    by_kernel = {}
    for reg in registry:
        by_kernel[reg["entry"]["strategy"]] = by_kernel.get(reg["entry"]["strategy"], 0) + 1
    print(f"registry: {len(registry)} stencils at {REG_N}x{REG_N}, each through its pinned "
          f"kernel ({by_kernel}) == plain, in {time.perf_counter() - t0:.1f} s")

    kernels = [
        {
            "name": f"{run['case']['kernel']}/{run['case']['name']}/{run['dtype']}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[run["case"]["kernel"]],
            "launches": run["launches"],
            "max_abs_err": run["max_abs_err"],
            "ms": run["device_ms"],
            "step_ms": run["ms"],
            "plain_ms": run["plain_ms"],
            "compulsory_gbs": run["gbs"],
            "copy_gbs": copy_gbs,
        }
        for run in runs
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))
    return 0


def field_shape(case, name, shape):
    """A field's shape: the axes of the 3-D ``shape`` it has."""
    dims = case.get("dims", {}).get(name, "IJK")
    return tuple(n for n, ax in zip(shape, "IJK") if ax in dims)


def card_fields(host, origin, case, storage):
    """Storages on the card, lower-dimensional ones with their own axes."""
    out = {}
    for n, v in host.items():
        dims = case.get("dims", {}).get(n, "IJK")
        out[n] = storage.from_array(
            v, backend="cuda:hopper", dimensions=tuple(dims),
            aligned_index=tuple(o for o, ax in zip(origin, "IJK") if ax in dims),
        )
    return out


def make_host(case, shape, seed, np):
    """Float64 host inputs of one case, made from ``seed``, scaled to the
    well-conditioned ranges the stencils see in a model."""
    rng = np.random.default_rng(seed)
    host = {n: rng.random(field_shape(case, n, shape)) for n in case["fields"]}
    if case["name"] == "tridiag":  # diagonally dominant system
        host["inf"] = -host["inf"]
        host["sup"] = -host["sup"]
        host["diag"] = host["diag"] + 4.0
    elif case["name"] in ("hdiff", "hdiff_sponge"):  # a stable diffusion coefficient
        host["coeff"] = 0.1 * host["coeff"]
    elif case["name"] == "vadv":  # vertical wind small beside 1/dt: pivots stay away from 0
        host["wcon"] = 0.1 * host["wcon"]
    return host


def check_oracle(run, defs, np, storage) -> None:
    """The kernel on a small input against the NumPy oracle (one call)."""
    import torch

    case, dtype = run["case"], run["dtype"]
    if case["name"] in ("hdiff", "hdiff_sponge"):
        shape, origin, domain = (24, 21, 8), (2, 2, 0), (20, 17, 8)
    elif case["name"] == "smoothed_column_sum":
        shape, origin, domain = (14, 13, 16), (1, 1, 0), (12, 11, 16)
    elif case["name"] == "vadv":  # wcon is read at i + 1
        shape, origin, domain = (13, 12, NK), (0, 0, 0), (12, 12, NK)
    else:
        shape, origin, domain = (12, 12, NK), (0, 0, 0), (12, 12, NK)
    host = {
        n: v.astype(dtype).astype(np.float64)
        for n, v in make_host(case, shape, 11, np).items()
    }
    fields = card_fields({n: v.astype(dtype) for n, v in host.items()}, origin, case, storage)
    run["kern"](**fields, **run["scalars"], domain=domain)
    torch.cuda.synchronize()
    if case["name"] == "hdiff":
        got = np.asarray(fields["out_field"])[2:-2, 2:-2]
        want = defs.validate_horizontal_diffusion(host["in_field"], host["coeff"])
    elif case["name"] == "hdiff_sponge":
        got = np.asarray(fields["out_field"])[2:-2, 2:-2]
        want = defs.validate_hdiff_sponge(host["in_field"], host["coeff"], host["damp"])
    elif case["name"] == "smoothed_column_sum":
        got = np.asarray(fields["out"])[1:-1, 1:-1]
        want = defs.validate_smoothed_column_sum(host["inp"])
    elif case["name"] == "vadv":
        got = np.asarray(fields["utens_stage"])[: domain[0]]
        want = defs.validate_vertical_advection_dycore(
            host["utens_stage"], host["u_stage"], host["wcon"], host["u_pos"],
            host["utens"], float(run["scalars"]["dtr_stage"]),
        )
    else:
        got = np.asarray(fields["out"])
        want = defs.validate_tridiagonal_solver(
            host["inf"], host["diag"], host["sup"], host["rhs"]
        )
    rtol, atol = ORACLE_TOL[dtype]
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{case['name']} {dtype}: kernel disagrees with the NumPy oracle "
            f"(max abs err {np.max(np.abs(got - want))})"
        )


def time_steps(stencil, fields, run, n: int) -> float:
    """ms per step of ``stencil.chain`` (host and device, as a model loop
    sees it), after one warm-up step."""
    import torch

    kw = dict(swap=run["case"]["swap"], domain=(NI, NJ, NK))
    stencil.chain(1, **fields, **run["scalars"], **kw)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    stencil.chain(n, **fields, **run["scalars"], **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def compulsory_bytes(stencil, itemsize: int) -> int:
    """Bytes one application must move at the least, computed from shapes:
    each API field read once if the stencil reads it and stored once if it
    writes it, over the domain along the axes it has (halos and temporaries
    left out)."""
    total = 0
    for info in stencil.field_info.values():
        if info is not None:
            access = info.access.value  # READ = 1, WRITE = 2
            points = 1
            for n, on in zip((NI, NJ, NK), info.domain_mask):
                points *= n if on else 1
            total += points * itemsize * (bool(access & 1) + bool(access & 2))
    return total


def registry_stencils(defs, gtscript) -> list:
    """Every registry stencil, built for the kernel and for the plain
    version, in its own dtypes; fails where the served kernel is not the
    one pinned for it."""
    out = []
    for name, entry in sorted(defs.REGISTRY.items()):
        opts = dict(definition=entry["definition"], externals=entry["externals"],
                    dtypes=entry["dtypes"])
        kern = gtscript.stencil(backend="cuda:hopper", **opts)
        if kern._backend.strategy != entry["strategy"]:
            raise AssertionError(
                f"registry {name}: served by {kern._backend.strategy} "
                f"({kern._backend.unsupported}), pinned to {entry['strategy']}"
            )
        out.append({"name": name, "entry": entry, "kern": kern,
                    "plain": gtscript.stencil(backend="torch", **opts)})
    return out


def run_registry_stencil(reg, defs, storage, cuda_backend, np, torch) -> None:
    """One registry stencil at REG_N × REG_N through its kernel (counted)
    and through the plain version, every field and point compared."""
    entry = reg["entry"]
    nk = max(8, entry["min_k"])
    shape = (REG_N + 2 * REG_HALO, REG_N + 2 * REG_HALO, nk)
    host = defs.make_inputs(reg["kern"].field_info, shape, np.random.default_rng(13))
    out = {}
    for tag in ("kern", "plain"):
        fields = {n: storage.from_array(v, backend="cuda:hopper") for n, v in host.items()}
        for wrapper in cuda_backend.WRAPPERS.values():
            wrapper.launches = 0
        info: dict = {}
        reg[tag](**fields, **entry["scalars"], origin=(REG_HALO, REG_HALO, 0),
                 domain=(REG_N, REG_N, nk), exec_info=info)
        torch.cuda.synchronize()
        if tag == "kern" and (
            info["kernel_strategy"] != entry["strategy"]
            or cuda_backend.WRAPPERS[entry["strategy"]].launches == 0
        ):
            raise AssertionError(f"registry {reg['name']}: {entry['strategy']} not launched")
        out[tag] = {n: np.asarray(v) for n, v in fields.items()}
    for n, want in out["plain"].items():
        got = out["kern"][n]
        if np.issubdtype(want.dtype, np.floating):
            same = np.allclose(got, want, rtol=RTOL[want.dtype.name], atol=0.0, equal_nan=True)
        else:
            same = np.array_equal(got, want)
        if not same:
            raise AssertionError(f"registry {reg['name']}: kernel disagrees with plain in {n}")


def copy_bandwidth() -> float:
    """Bytes/s (read + write) of a device-to-device copy of 256 MiB, five
    times the H100's 50 MB L2: the sustainable bandwidth, measured in the
    same run as the kernels, that their compulsory bytes are held against."""
    import torch

    src = torch.rand(64 * 1024 * 1024, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    n = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        dst.copy_(src)
    end.record()
    end.synchronize()
    return 2 * src.numel() * src.element_size() * n / (start.elapsed_time(end) * 1e-3)


def device_ms(run, fields, n: int) -> float:
    """ms per step that ``chain(n)`` from the main path's inputs holds the
    card: CUDA events around the chain, with the stream first held by a spin
    kernel long enough for the host to queue every launch behind it, so the
    reading holds the stencil's device work (kernels and the temporaries'
    zero-fill) and none of the host's per-call cost. Fails if the host was
    still queuing when the spin ended."""
    import torch

    kw = dict(swap=run["case"]["swap"], domain=(NI, NJ, NK))
    run["kern"].chain(1, **fields, **run["scalars"], **kw)
    torch.cuda.synchronize()
    cycles = 100_000_000  # ~50 ms at the H100's clocks
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run["kern"].chain(n, **fields, **run["scalars"], **kw)
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError(
        f"{run['case']['name']}: the host did not queue chain({n}) within a spin "
        f"of {cycles // 4} cycles"
    )


if __name__ == "__main__":
    sys.exit(main())
