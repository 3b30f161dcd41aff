#!/usr/bin/env python3
"""Smoke run of gt4py_tpu_torch on one CUDA card (an H100).

Drives the port's main paths — ``gtscript.stencil`` → frontend → passes →
``cuda:hopper`` → generated CUDA kernels, on ``storage`` fields, and the
field-view operators that the cartesian bridge lowers onto the same
kernels (step 7) — through
the public API at the size weather and climate dycores run it, on a
256×256×80 domain with a halo of 2, in float32 and float64: hdiff (the
``plane`` kernel), vadv and tridiag (``column``), hdiff_sponge, hdiff as
three computations with an IJ coefficient and a K sponge profile
(``fused_plane``), smoothed_column_sum, a FORWARD sweep coupling
neighbouring columns at every level (``tiled``), and vadv_fused and
tridiag_fused, vadv and tridiag built with the stage-fusion switch on
(``fused_column``, one launch per application); hdiff also in float16 and
bfloat16 (stored in 16 bits, computed in float32). ``chain`` replays one
swap cycle of the kernels as a CUDA graph.

1. Builds every kernel of those paths and of the registry phase from the
   sources in this checkout, one ``nvcc`` per source, all at once.
2. For each path: sets the launch counts to 0, runs the stencil once and as
   ``chain(10)``, reads the counts: its kernel must have launched exactly
   1 + 10 × its launchers' count (a graph replay adds the launches it
   repeats). Every one of the five kernels must have launched on some path.
3. Holds every result against the plain version (the ``torch`` backend on the
   same card, same inputs; the half types on one application) and, on a
   small input, against the NumPy oracle. Then the graph chain: on every
   path ``chain(10)`` and ``chain(11)`` equal 10 and 11 single calls to the
   bit, with a graph replay (``chain_mode``).
4. Times plain, kernel, kernel, plain with CUDA events over chained steps;
   takes the stencil's device time per step from CUDA events around a chain
   queued behind a spin kernel (no host cost inside); holds each kernel's
   compulsory bytes per second against a device-to-device copy measured in
   the same run (a field is read only where the stencil reads its values
   from before the call); the bound is the compulsory bytes over the H100's
   3.35 TB/s or the operations over its peak rate, whichever is longer.
   For the walks (vadv and tridiag on ``column`` and ``fused_column``,
   hdiff on ``plane``, hdiff_sponge on ``fused_plane``, smoothed_column_sum
   on ``tiled``): µs per walked level (a PARALLEL stencil: per level), the
   prefetch ring's depth and shared bytes per block, the plain-pointer
   variant's time (the tile walks and ``plane``), and what ``ptxas``
   reports for each kernel (registers, spills) from the build logs, with
   the blocks resident on an SM; then every main-path kernel's SASS
   instructions by class, where the toolkit has ``cuobjdump``. Also each
   path's step − device µs (what the host adds to a chained step), at
   chain(20) and from the fit of chain(20) and chain(50) (which also gives
   a chain call's fixed cost), and the host µs of a warm ``__call__``
   (queued behind a spin kernel).
5. Registry phase: every stencil of tests/torch_stencil_defs.py runs on
   ``cuda:hopper`` at 32×32×max(8, min_k) in its own dtypes, through the
   kernel pinned for it (and K4's class again with the switch on, through
   ``fused_column``), against the plain version on the card; then one
   float16 and one bfloat16 stencil on each of the five kernels
   (``HALF_STENCILS``) against the plain version at the half tolerances
   (``HALF_TOL``, ``BF16_TOL``), their largest errors printed.
6. Sweeps phase: the two sweeps that read an earlier level beyond the points
   its writers compute (``tiled``, one cooperative launch a call) at
   256×256×80 in float64, three times each, every run equal to the plain
   version, and ``chain(5)`` equal to five calls; then the µs of a call with
   the host and on the device (behind a spin kernel) beside its bound, and
   its ``ptxas`` report.

7. Field-view phase: the port's field-view frontend (gt4py_tpu_torch.next)
   on the same kernels, through ``gtx.field_operator(...,
   backend="cuda:hopper")`` on card fields at 256×256×80: ``next_hdiff``
   (``plane``), ``next_vadv`` and ``next_tridiag`` (``column``; with the
   fusion switch on, ``fused_column`` for next_tridiag, while next_vadv's K
   index field keeps it on ``column``), float32 and float64, each operator's
   bridged variant traced and built in step 1 by a CPU call. Each run is
   counted as a main path (its kernel's launchers once each, the bridge's
   variant serving it), held against the ``torch`` backend on the card and
   against the cartesian stencil of the same main path on the same data
   (equal to the bit or not, recorded), and timed: device µs per call
   behind a spin kernel beside the cartesian stencil's calls on the same
   data (the ratio is ``bench.py``'s ``next_hdiff_vs_cartesian``), a warm
   call's host µs, the plain version's ms. Then ``edge_sum``
   (``neighbor_sum`` through a connectivity with missing neighbours) runs
   embedded on the card and is held against the CPU. Each main path's
   card result is also held against the port's field-view ``numpy``
   backend (the oracle) run on the host from the same inputs (rtol 1e-12
   in float64, ORACLE_TOL in float32), its ``numpy`` ms printed.
   7b. Every case of tests/torch_feature_defs.py (the JAX package's
   test_feature_* breadth) runs on ``torch`` and ``cuda:hopper`` with card
   fields, against ``numpy`` on the host; its bridged kernels were built in
   step 1. Around each ``cuda:hopper`` run the launch counts are set to 0
   and read: each kernel must have launched exactly the launchers the
   bridge's calls asked of it (``cartesian_bridge.launchers_served``).
   Prints how many cases were bridged, by kernel, and how many ran
   embedded.
   7c. ``cuda:hopper:aot``: next_hdiff and next_tridiag in float32 at full
   width; ``compile()`` runs the stages (seconds each, ``cost_analysis()``),
   the first call builds no variant and runs no ``nvcc`` (both counted) and
   launches exactly the kernel, equal to ``cuda:hopper`` to the bit;
   ``format_compiled``'s SASS by class where the toolkit has ``cuobjdump``.
   7d. FVM nabla (bench.py:687-689) in float32 on ``periodic_quad_mesh(256)``
   and ``(1024)`` (65,536 and 1,048,576 vertices): the ``torch`` backend on
   card fields against ``numpy`` on the host, ms a call by CUDA events.

8. Oracle phases, on the card's host: the port's ``numpy`` backend
   (the exact oracle, NumPy on CPU tensors) holds every registry build of
   step 5, and every half one, at the tolerances of the plain version
   (rtol 1e-12 in float64, 1e-5 in float32, the half ones as there), its
   largest error printed for each kernel class; the per-point ``debug``
   backend holds hdiff, vadv and tridiag at 12×12×8 in float32 and float64;
   and at full width (256×256×80, halo 2, float64) the ``numpy`` and
   ``cpu:c`` backends (C built with the host's ``cc`` and OpenMP) each
   run hdiff, vadv and tridiag from the main path's inputs, equal to the
   kernel within rtol 1e-12, and print their ms a call beside its device µs.
9. Profiler phase: five warm ``__call__``s of hdiff (``plane``, float32)
   and five of ``next_hdiff`` under ``instrumentation.gpu_trace``: the
   device work in the trace must be exactly the generated kernel plus the
   fills and copies its wrapper makes (none for hdiff), no other kernel (a
   kernel of the plain version would show here); prints each call's host
   µs from its start to the kernel's launch, from the trace, and their
   median over calls 2-5 (the first carries the profiler's start-up).

10. Examples phase: examples 1-8 of gt4py_tpu_torch/examples/ (the JAX
   package's examples/*.py) on card storages and fields at full width (the
   ``EX_*`` sizes), their kernels built in step 1 (bridged variants traced
   by a CPU call). Around each run the launch counts are set to 0 and read:
   each kernel example launches exactly what it asked (burgers 100 × (1
   copy2 + 3 rk_stage) ``plane`` calls, each its launchers), shallow_water
   none (staggered: embedded). Each result is held against the port's
   ``numpy`` backend (or the field-view ``numpy`` oracle) run on the host
   from the same inputs (rtol 1e-12 in float64, ORACLE_TOL in float32);
   burgers' error against the Zhao solution within the factor-0 bound of
   test_burgers.py. Prints each one's wall seconds, device µs a call
   (recorded calls replayed behind a spin kernel), the plain version's,
   the bound, and burgers' host µs per RK step; each kernel call joins the
   ``kernels`` line (``"entry": "example"``).

11. Distributed phase (gt4py_tpu_torch.parallel): ``DistributedStencil``
   over a 2 × 2 ``CartesianMesh`` of ``[cuda:0] * 4`` on a global
   512 × 512 × 80 domain, each shard 256 × 256 × 80 with a halo of 2: hdiff
   (``plane``) periodic, clamp and zero, vadv and tridiag (``column``), vadv
   with the switch on (``fused_column``), float32 and float64, and hdiff on
   an uneven 510 × 506 × 80 (pad and trim). Each case is counted (each
   shard's launches of its kernel, no other), equal to the single-card
   stencil on a storage extended by the boundary condition to the bit and
   to the plain version on the same mesh; prints device µs a step of 20
   chained ``apply``s on sharded arrays behind a spin kernel, the exchange's
   copies and the shards' kernels apart, beside 4 × the single-shard step
   of section 4, a warm ``apply``'s host µs, the scatter and gather µs of a
   global call, the plain version's ms and the bound (compulsory bytes of
   the global domain plus the halo slabs over 3.35 TB/s). Then
   ``DistributedUnstructured`` FVM nabla at 1,048,576 vertices on a ring of
   four shards, equal to one device, ms a call beside step 7d's and its
   slabs; then the distributed_hdiff example, counted and held against
   numpy on the host. Each case joins the ``kernels`` line
   (``"entry": "distributed"``).

12. Calibration phase (gt4py_tpu_torch/cartesian/backend/calibration.py, the
   counterpart of bench.py:1325-1570): bench.py's three calibration probes
   on their hand-written kernels (``calibration.cu``, built in step 1), each
   instantiated variant at bench.py's sizes (P1 ``probe_walk`` (m, n) =
   (0, 0), (16, 0), (0, 4) and the card's own (128, 0), (0, 64) over
   80 × 256 × 128 float32; P2 ``plane_walk5`` over 80 × 256 × 256; P3
   ``bf16_windows`` n = 0, 1 over 80 × 260 × 260 bfloat16): one launch and a
   graph chain of 3 (of 1 for (128, 0), whose second application overflows)
   equal to the plain version on the card to the bit, every compared value
   finite; then, the probes' counts set to 0, the two-point fit of its µs
   over graph chains behind a spin kernel, its kernel launching exactly the
   fit's launches. First the L2 yardstick (``calibration.l2_read_rate``:
   the rate at which the SMs read a buffer that stays in the L2, by the same
   fit, its result equal to ``torch.amax``). Prints each variant's µs and
   spread, its bytes over the µs beside the device copy (and whether they
   fit the card's L2), the plain version's µs, the bound and its share (none
   where the kernel beats it), ``Tensor.copy_`` beside P3 with no window
   (timed as the kernel is, by the same fit over graph chains); each
   kernel's registers, spills and blocks an SM (``ptxas``) and its SASS by
   class without the division's slow path (``cuobjdump``, which must be
   there), with its 128-bit global loads and stores, which P1 and P3 must
   have. The bound's bytes go at the L2 yardstick's rate where they fit the
   L2 (P1 and P3: a chain keeps them there), else at the device memory's;
   P1's and P3's bound is ``calibration.instruction_bound``: their FP32 and
   MUFU instructions a point from that SASS on the card's SMs at its highest
   SM clock (``nvidia-smi``), or their bytes, whichever takes longer;
   bench.py's ceilings (chain copy rate, ps an FMA and a division a point,
   the plane walk's GB/s, the bfloat16 window model) and the main paths'
   tridiag and vadv (``column``, ``fused_column``) and bfloat16 hdiff
   (``plane``) device µs from step 4 over each ceiling, the copy floor of a
   walk beyond the L2 over the slower of P1's chain copy and the device
   copy. Each variant joins the ``kernels`` line (``"entry": "calibration"``).

Prints the card's name and power limit, one JSON line with the kernels, and
as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card it exits 1 and prints no result.

Usage: ``python3 chip_smoke.py`` (no arguments) from the repository root.
"""

from __future__ import annotations

import contextlib
import functools
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
#: float16 and bfloat16: the kernel computes in float32 and rounds once, at
#: the store, while the plain version rounds every operation to half, so the
#: two agree to the JAX package's tolerances for one PARALLEL application
#: (float16 1e-2, bfloat16 2e-2, tests/cartesian_tests/test_upcasting_matrix.py),
#: not to the bit
RTOL = {"float16": 1e-2, "bfloat16": 2e-2, "float32": 1e-5, "float64": 1e-12}
ATOL = {"float16": 1e-2, "bfloat16": 2e-2, "float32": 0.0, "float64": 0.0}
#: kernel vs the NumPy oracle (float64 throughout) on a small input, as
#: (rtol, atol): float32 carries the rounding of 80-level recurrences
ORACLE_TOL = {"float16": (1e-2, 1e-2), "bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-5),
              "float64": (1e-10, 1e-12)}
#: the half types, and the main paths that also run in them
HALVES = ("float16", "bfloat16")
HALF_PATHS = ("hdiff",)
ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}

#: registry phase: domain and halo
REG_N, REG_HALO = 32, 3
#: the main paths held against the debug backend, at this domain, and
#: against the numpy and cpu:c backends at full width in float64
DEBUG_DOMAIN = (12, 12, 8)
ORACLE_PATHS = ("hdiff", "vadv", "tridiag")
#: kernel -> the TPU pallas_call it replaces
REPLACES = {
    "plane": "gt4py_tpu/cartesian/backend/pallas_split.py:424",
    "fused_plane": "gt4py_tpu/cartesian/backend/pallas_codegen.py:1992",
    "column": "gt4py_tpu/cartesian/backend/pallas_seq.py:1130",
    "fused_column": "gt4py_tpu/cartesian/backend/pallas_seq.py:1704",
    "tiled": "gt4py_tpu/cartesian/backend/pallas_codegen.py:818",
    "probe_walk": "bench.py:1494",
    "plane_walk5": "bench.py:1414",
    "bf16_windows": "bench.py:1351",
}
SOURCE = "gt4py_tpu_torch/cartesian/backend/cuda_codegen.py"
#: the H100 SXM's data sheet: device memory rate, and peak rates outside the
#: tensor cores (float32 67 TFLOP/s, float64 34 TFLOP/s; half fields are
#: computed in float32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float16": 67e12, "bfloat16": 67e12, "float32": 67e12, "float64": 34e12}
#: the switch that builds a stencil of K4's class for fused_column
FUSE_ENV = "GT4PY_CUDA_FUSE_STAGES"
#: the kernels of the walk report, and those with a plain-pointer variant
#: timed beside the ringed one
WALKS = ("plane", "column", "fused_column", "fused_plane", "tiled")
UNRINGED = ("plane", "fused_plane", "tiled")
#: step 10, the examples (gt4py_tpu_torch/examples/) at full width: the
#: tridiagonal solver (float32) at 256×256×80 and its own 64×64×48; the
#: Laplacian at the example's N = 48 and at 256×256×80; burgers at factor 5
#: (321×321×1), 100 RK3 steps; the isentropic diagnostics at nx = ny = 256,
#: nz = 80 (fields 256×256×81); implicit diffusion at 256×256×80 and its own
#: 16×16×24 (float64 all but the solver)
EX_TRIDIAG = ((256, 256, 80), (64, 64, 48))
EX_LAP = ((48, 48, 48), (256, 256, 80))
EX_BURGERS = (5, 100)
EX_ISENTROPIC = (256, 256, 80)
EX_IMPLICIT = ((256, 256, 80), (16, 16, 24))
#: burgers' error against the Zhao solution at factor 0
#: (tests/cartesian_tests/test_burgers.py:18-21); the full width must be within it
ZHAO_BOUND = 5e-3
#: calls timed behind a spin kernel, and calls of the plain version timed
EX_TIMED_CALLS, EX_PLAIN_CALLS = 20, 3
#: step 11, the distributed path: DIST_SHARDS shards of one card (a 2 × 2
#: mesh), each at the main path's 256 × 256 × 80 on the global DIST_DOMAIN;
#: the uneven domain (pad and trim); the ring nabla's mesh (n × n vertices);
#: chained applies timed behind a spin kernel
DIST_SHARDS = 4
DIST_DOMAIN = (2 * NI, 2 * NJ, NK)
DIST_UNEVEN = (2 * NI - 2, 2 * NJ - 6, NK)
DIST_NABLA = 1024
DIST_CALLS = 20
#: an example on the card against the numpy backend: float64 rtol 1e-12; the
#: float32 solver within ORACLE_TOL, as (rtol, atol)
EX_TOL = {"float64": RTOL["float64"], "float32": ORACLE_TOL["float32"]}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    import numpy as np

    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import cuda_backend, cuda_codegen
    from gt4py_tpu_torch.cartesian.backend import calibration
    from gt4py_tpu_torch.next import cartesian_bridge as bridge
    from gt4py_tpu_torch.next import program_processors
    from tests import torch_cases as tcases
    from tests import torch_feature_defs as fdefs
    from tests import torch_next_defs as ndefs
    from tests import torch_stencil_defs as defs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card}")

    build = functools.partial(build_stencil, gtscript)

    def inputs(case, dtype, shape, seed):
        return {n: in_dtype(v, dtype) for n, v in make_host(case, shape, seed, np).items()}

    if argv[1:]:
        print(f"usage: {argv[0]}", file=sys.stderr)
        return 2

    cases = path_cases(defs)
    shape = (NI + 2 * HALO, NJ + 2 * HALO, NK)
    origin = (HALO, HALO, 0)
    domain = (NI, NJ, NK)

    # -- 1. build every kernel of the paths and the registry ------------------
    runs = []
    for dtype in ("float32", "float64", *HALVES):
        for case in cases:
            if dtype in HALVES and case["name"] not in HALF_PATHS:
                continue
            kern = build(
                case["definition"], "cuda:hopper", dtype, case["externals"],
                fuse=case.get("fuse", False),
            )
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
    halves = half_stencils(defs, gtscript)
    sweeps = [
        {"name": name, "kern": build(definition, "cuda:hopper", "float64"),
         "plain": build(definition, "torch", "float64")}
        for name, definition in (
            ("lagged_neighbour_sweep", defs.lagged_neighbour_sweep),
            ("lag_read_before_write", defs.lag_read_before_write),
        )
    ]
    nruns = prepare_next_runs(ndefs, NK)
    fsources = feature_sources(fdefs, tcases, bridge)
    examples = prepare_examples()
    dex = prepare_distributed()
    t0 = time.perf_counter()
    backends = [r["kern"]._backend for r in runs + registry + halves + sweeps]
    backends += [r["variant"].backend for r in nruns] + examples["backends"] + dex["backends"]
    cuda_backend.build_libraries([*(b.module.source for b in backends), *fsources,
                                  calibration.source()])
    for b in backends:
        b._functions()  # load
    calibration._functions()
    print(f"built and loaded {len(backends)} stencils ({len(nruns)} bridged field-view "
          f"variants, {len(examples['backends'])} of the examples), {len(fsources)} kernels "
          f"of the feature cases and the calibration probes in "
          f"{time.perf_counter() - t0:.1f} s")

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
        expected = (1 + CHAIN_STEPS) * len(run["kern"]._backend.module.launchers)
        if run["launches"] != expected or sum(counts.values()) != expected:
            raise AssertionError(
                f"{case['name']}: {counts}, not {expected} launches of {case['kernel']} "
                f"(one call and chain({CHAIN_STEPS}))"
            )
        served |= {k for k, n in counts.items() if n}
    missing = set(cuda_backend.WRAPPERS) - served
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {sorted(missing)}")

    # -- 3. correctness ------------------------------------------------------------
    for run in runs:
        case, dtype = run["case"], run["dtype"]
        ref = card_fields(run["host"], origin, case, storage)
        main = run["main"]
        if dtype in HALVES:
            # one application each: a chain feeds each step the other's
            # rounding, and hdiff's flux limiter, a sign test on the
            # difference of two neighbours, turns a one-ulp difference of
            # equal neighbours into one of a whole flux
            for n in case["fields"]:
                if not bool(torch.isfinite(main[n].array).all()):
                    raise AssertionError(f"{case['name']} {dtype}: non-finite values in {n}")
            main = card_fields(run["host"], origin, case, storage)
            run["kern"](**main, **run["scalars"], domain=domain)
            run["plain"](**ref, **run["scalars"], domain=domain)
        else:
            run["plain"](**ref, **run["scalars"], domain=domain)
            run["plain"].chain(
                CHAIN_STEPS, **ref, **run["scalars"], swap=case["swap"], domain=domain
            )
        err = 0.0
        for n in case["fields"]:
            got, want = main[n].array, ref[n].array
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{case['name']} {dtype}: non-finite values in {n}")
            err = max(err, float((got.double() - want.double()).abs().max()))
            if not torch.allclose(got, want, rtol=RTOL[dtype], atol=ATOL[dtype]):
                raise AssertionError(
                    f"{case['name']} {dtype}: kernel disagrees with plain in {n} "
                    f"(max abs err {err})"
                )
        run["max_abs_err"] = err
        check_oracle(run, defs, np, storage)
        print(f"{case['name']} {dtype}: kernel == plain within rtol {RTOL[dtype]}, "
              f"atol {ATOL[dtype]} (max abs err {err:.3e}); oracle ok")

    t0 = time.perf_counter()
    for run in runs:
        run["chain_mode"] = check_graph_chain(run, origin, domain, storage, torch)
    print(f"graph chain: chain({CHAIN_STEPS}) and chain({CHAIN_STEPS + 1}) == as many single "
          f"calls, to the bit, on every path, in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{r['case']['name']} {r['dtype']} {r['chain_mode']}" for r in runs))

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
        if case["kernel"] in UNRINGED:
            run["unringed_ms"] = unringed_ms(
                run, card_fields(run["host"], origin, case, storage), cuda_backend
            )
        run["slope_ms"], run["chain_call_ms"] = chain_fit(run["kern"], fields, run)
        run["call_host_ms"] = call_host_ms(
            run, card_fields(run["host"], origin, case, storage), 20
        )
        nbytes = compulsory_bytes(run["kern"], ITEMSIZE[run["dtype"]])
        flops = operations(run["kern"])
        run["gbs"] = nbytes / dev / 1e6
        run["copy_bound_ms"] = nbytes / (copy_gbs * 1e9) * 1e3
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[run["dtype"]] * 1e3
        run["bound_ms"], run["bound_by"] = max(
            (by_bytes, "bytes"), (by_ops, "operations")
        )
        pts = NI * NJ * NK
        rows.append(
            f"{case['name']:19s} {run['dtype']:8s} {case['kernel']:12s} "
            f"plain {run['plain_ms'] * 1e3:10.1f} us/step ({p1 * 1e3:.1f}, {p2 * 1e3:.1f})  "
            f"kernel {run['ms'] * 1e3:8.1f} us/step ({k1 * 1e3:.1f}, {k2 * 1e3:.1f})  "
            f"device {dev * 1e3:8.1f} us/step  "
            f"step - device {(run['ms'] - dev) * 1e3:6.2f} us ({run['chain_mode']}; fit: "
            f"{(run['slope_ms'] - dev) * 1e3:6.2f} us a step, {run['chain_call_ms'] * 1e3:6.1f} "
            f"us a chain call)  "
            f"warm call {run['call_host_ms'] * 1e3:6.1f} us on the host  "
            f"{pts / (dev * 1e-3) / 1e9:7.2f} Gpoints/s  "
            f"{run['gbs']:7.1f} GB/s of compulsory bytes ({run['gbs'] / copy_gbs:.1%} of copy)  "
            f"bound {run['bound_ms'] * 1e3:.1f} us ({run['bound_by']}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; "
            f"{run['copy_bound_ms'] * 1e3:.1f} us at the copy rate)"
        )
    print(f"timings on {smi}, {NI}x{NJ}x{NK}; steps of chain(20) by CUDA events, "
          "device time by CUDA events behind a spin kernel, a warm call's host time by "
          "the host clock behind a spin kernel:")
    print(f"  device-to-device copy of 256 MiB: {copy_gbs:.1f} GB/s (read + write)")
    for r in rows:
        print("  " + r)
    print(f"walks on {smi}: device µs per walked level (a PARALLEL stencil: per level), "
          f"bytes per block of the prefetch ring (column walks: depth RING_LEVELS = "
          f"{cuda_codegen.RING_LEVELS}; tile walks: TILE_RING_LEVELS = "
          f"{cuda_codegen.TILE_RING_LEVELS}, fused_plane FP_TK = {cuda_codegen.FP_TK}), ptxas:")
    for run in runs:
        if run["case"]["kernel"] in WALKS:
            print("  " + walk_report(run, cuda_backend))
    tool = cuobjdump()
    print(f"SASS instructions of the main paths' kernels ({tool or 'no cuobjdump: not measured'}): "
          "static count of each kernel, and of its innermost loops' bodies (what a thread "
          "issues once per point of a statement), by class")
    for run in runs if tool else ():
        source = run["kern"]._backend.module.source
        for kernel, counts in sorted(sass_counts(source, cuda_backend, tool).items()):
            print(f"  {run['case']['name']:19s} {run['dtype']:8s} {kernel:22s} "
                  + "; ".join(f"{part} " + ", ".join(f"{c} {n}" for c, n in by.items())
                              for part, by in counts.items()))

    # -- 5. the registry -----------------------------------------------------------
    t0 = time.perf_counter()
    for reg in registry:
        run_registry_stencil(reg, defs, storage, cuda_backend, np, torch)
    by_kernel = {}
    for reg in registry:
        by_kernel[reg["entry"]["strategy"]] = by_kernel.get(reg["entry"]["strategy"], 0) + 1
    print(f"registry: {len(registry)} stencils at {REG_N}x{REG_N}, each through its pinned "
          f"kernel ({by_kernel}) == plain and == the numpy backend on the host (rtol float64 "
          f"{RTOL['float64']}, float32 {RTOL['float32']}), in {time.perf_counter() - t0:.1f} s")
    worst: dict = {}
    for reg in registry:
        kernel = reg["entry"]["strategy"]
        worst[kernel] = max(worst.get(kernel, (0.0, "")), (reg["oracle_err"], reg["name"]))
    print("  largest relative error against the numpy backend, by kernel: "
          + ", ".join(f"{k} {e:.3e} ({name})" for k, (e, name) in sorted(worst.items())))
    for reg in halves:
        run_half_stencil(reg, defs, storage, cuda_backend, np, torch)
    for dtype in HALVES:
        done = [r for r in halves if r["dtype"] == dtype]
        print(f"{dtype}: {len(done)} stencils at {REG_N}x{REG_N}, one on each kernel, == plain "
              f"and == the numpy backend within rtol = atol = tol; max abs err against plain, "
              f"against numpy (tol) "
              + ", ".join(f"{r['name']} ({r['entry'][1]}) {r['err']:.3e}, {r['oracle_err']:.3e} "
                          f"({r['tol']})" for r in done))

    # -- 6. the lagged sweeps, one cooperative tiled launch a call ----------------
    t0 = time.perf_counter()
    for sweep in sweeps:
        run_sweep(sweep, shape, origin, domain, storage, cuda_backend, np, torch)
    for sweep in sweeps:  # one application's compulsory bytes over 3.35 TB/s
        sweep["bound_ms"] = compulsory_bytes(sweep["kern"], 8) / HBM_BYTES_PER_S * 1e3
    print(f"sweeps at {NI}x{NJ}x{NK} float64, three runs each == plain, one cooperative "
          f"launch a call, chain(5) == five calls ("
          + ", ".join(f"{s['name']} {s['chain_mode']}" for s in sweeps)
          + f"), in {time.perf_counter() - t0:.1f} s; us per call by CUDA events, "
          "host included / device behind a spin kernel (bound): "
          + ", ".join(f"{s['name']} {s['ms'] * 1e3:.1f} / {s['device_ms'] * 1e3:.1f} "
                      f"({s['bound_ms'] * 1e3:.1f}; {s['device_ms'] * 1e3 / NK:.3f} us a level)"
                      for s in sweeps))
    for sweep in sweeps:
        print("  " + walk_report({"kern": sweep["kern"], "device_ms": sweep["device_ms"],
                                  "case": {"name": sweep["name"]}, "dtype": "float64"},
                                 cuda_backend))

    # -- 7. the field-view path: operators through the bridge, each counted ---------
    t0 = time.perf_counter()
    for run in nruns:
        run_next_main_path(run, ndefs, cuda_backend, torch)
    by_path = {(r["case"]["name"], r["dtype"]): r for r in runs}
    for run in nruns:
        like = run["case"]["like"] + ("_fused" if run["fuse"] else "")
        cart = by_path[(like, run["dtype"])]
        check_next_run(run, ndefs, cart["kern"], storage, torch)
        check_next_oracle(run, ndefs)
        time_next_run(run, ndefs, torch)
        run["chain_device_ms"] = cart["device_ms"]
        nbytes = compulsory_bytes(as_stencil(run["variant"]))
        flops = operations(as_stencil(run["variant"]))
        run["bound_ms"], run["bound_by"] = max(
            (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (flops / PEAK_FLOPS[run["dtype"]] * 1e3, "operations"),
        )
    print(f"field-view phase on {smi}, {NI}x{NJ}x{NK}, through gtx.field_operator(..., "
          f"backend=\"cuda:hopper\") on card fields, in {time.perf_counter() - t0:.1f} s: "
          "each served by the bridge's variant on its kernel, == the torch backend on the card "
          "within rtol (float32 1e-5, float64 1e-12), == the cartesian stencil on the same "
          "data to the bit; device us per call of 20 calls behind a spin kernel "
          "(field view, cartesian __call__, field view / cartesian), the cartesian path's "
          "chain(20) step from section 4, a warm call's host us, the plain version's ms:")
    for run in nruns:
        print(f"  {next_tag(run):25s} {run['dtype']:8s} {run['kernel']:12s} "
              f"launches {run['launches']}  max abs err {run['max_abs_err']:.3e} (torch), "
              f"{run['cart_abs_err']:.3e} (cartesian, same bits: {run['cart_same_bits']})  "
              f"device {run['device_ms'] * 1e3:8.2f} us ({run['device_pair'][0] * 1e3:.2f}, "
              f"{run['device_pair'][1] * 1e3:.2f})  cartesian {run['cart_call_ms'] * 1e3:8.2f} us "
              f"({run['cart_pair'][0] * 1e3:.2f}, {run['cart_pair'][1] * 1e3:.2f})  "
              f"ratio {run['device_ms'] / run['cart_call_ms']:.4f}  "
              f"chain step {run['chain_device_ms'] * 1e3:8.2f} us  "
              f"warm call {run['call_host_ms'] * 1e3:7.1f} us on the host  "
              f"plain {run['plain_ms']:.2f} ms  bound {run['bound_ms'] * 1e3:.1f} us "
              f"({run['bound_by']})")
    if tool:
        print("SASS instructions of the bridged kernels, as for the main paths':")
    for run in nruns if tool else ():
        if run["fuse"]:
            continue
        source = run["variant"].backend.module.source
        for kernel, counts in sorted(sass_counts(source, cuda_backend, tool).items()):
            print(f"  {run['case']['name']:19s} {run['dtype']:8s} {kernel:22s} "
                  + "; ".join(f"{part} " + ", ".join(f"{c} {n}" for c, n in by.items())
                              for part, by in counts.items()))
    err = check_unstructured_on_card(ndefs, torch)
    print(f"unstructured: edge_sum (neighbor_sum through a V2E table with missing "
          f"neighbours) embedded on the card == the CPU run (max abs err {err:.3e})")
    print(f"field-view oracle: each main path's card result above == the numpy backend on "
          f"the host from the same inputs ({NI}x{NJ}x{NK}, rtol float64 {RTOL['float64']}, "
          f"float32 rtol/atol {ORACLE_TOL['float32']}); max abs err, numpy ms a call:")
    for run in nruns:
        print(f"  {next_tag(run):25s} {run['dtype']:8s} {run['kernel']:12s} max abs err "
              f"{run['oracle_err']:.3e}  numpy {run['numpy_ms']:.1f} ms")

    # -- 7b. the feature cases: torch and cuda:hopper on the card, numpy on the host --
    t0 = time.perf_counter()
    nvcc0 = cuda_backend.nvcc_runs
    features = {name: run_feature_case(name, fdefs, tcases, bridge, cuda_backend, torch)
                for name in fdefs.CASES}
    by_kernel: dict = {}
    for result in features.values():
        for kernel in result["kernels"]:
            by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
    bridged = sum(1 for r in features.values() if r["kernels"])
    raising = sum(1 for r in features.values() if r["raises"])
    print(f"feature cases: {len(features)} cases of tests/torch_feature_defs.py in "
          f"{time.perf_counter() - t0:.1f} s ({cuda_backend.nvcc_runs - nvcc0} nvcc runs during "
          f"them): torch and cuda:hopper on the card == numpy on the host (rtol float64 "
          f"{RTOL['float64']}, integers and bools exactly; largest abs err "
          f"{max(r['err'] for r in features.values()):.3e}); {bridged} bridged, by kernel "
          f"{dict(sorted(by_kernel.items()))}, each launching exactly the launchers its calls "
          f"asked for; {len(features) - bridged - raising} ran embedded; {raising} raised the "
          "error their test asserts on all three backends")

    # -- 7c. cuda:hopper:aot: the stages at compile(), nothing built at the call -------
    aots = [run_aot(name, ndefs, cuda_backend, bridge, torch)
            for name in ("hdiff_op", "solve_tridiag")]
    print("cuda:hopper:aot at full width, float32: compile() runs the stages (s each), the first "
          "call builds no variant and runs no nvcc, launches exactly its kernel, == cuda:hopper "
          "to the bit; cost_analysis() is ptxas's report:")
    for aot in aots:
        print(f"  {aot['name']:14s} {aot['kernel']:12s} launches {aot['launches']}  stages "
              + ", ".join(f"{k} {v:.4f}" for k, v in aot["seconds"].items())
              + f"  (nvcc runs in compile(): {aot['compile_nvcc']})  cost {aot['cost']}")
    for aot in aots if tool else ():
        args, kwargs, out = aot["args"]
        text = program_processors.format_compiled(
            getattr(ndefs, aot["name"]), *args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
        print(f"  format_compiled({aot['name']}): {len(text.splitlines())} lines, SASS by class "
              f"{sass_class_counts(text)}")
    if not tool:
        print("  format_compiled: no cuobjdump in the toolkit, SASS not measured")

    # -- 7d. unstructured at real size: FVM nabla on the torch backend ----------------
    nablas = [run_nabla(n, ndefs, torch) for n in (256, 1024)]
    print(f"FVM nabla (nabla_x, E2V average and V2E neighbor_sum with signs over volume), "
          f"float32, torch backend on the card == numpy on the host (rtol 1e-5, atol 1e-6), "
          f"on {smi}; ms a call by CUDA events over 20 calls:")
    for nb in nablas:
        print(f"  {nb['vertices']:8d} vertices  {nb['ms']:.4f} ms  "
              f"({nb['vertices'] / nb['ms'] / 1e3:.1f} Mvertices/s)  numpy {nb['numpy_ms']:.1f} "
              f"ms  max abs err {nb['max_abs_err']:.3e}")

    # -- 8. the oracles on the host: debug, and numpy and cpu:c at full width ----------
    t0 = time.perf_counter()
    oracle_runs = [r for r in runs if r["case"]["name"] in ORACLE_PATHS]
    for run in oracle_runs:
        if run["dtype"] in ("float32", "float64"):
            run["debug_err"] = check_debug(run, gtscript, storage, np, torch)
    print(f"debug backend at {DEBUG_DOMAIN[0]}x{DEBUG_DOMAIN[1]}x{DEBUG_DOMAIN[2]} == the kernel "
          f"within rtol (float32 {RTOL['float32']}, float64 {RTOL['float64']}), in "
          f"{time.perf_counter() - t0:.1f} s; max abs err "
          + ", ".join(f"{r['case']['name']} {r['dtype']} {r['debug_err']:.3e}"
                      for r in oracle_runs if "debug_err" in r))
    print(f"full width on the host ({os.cpu_count()} cores), {NI}x{NJ}x{NK} float64, one call "
          f"each == the kernel within rtol {RTOL['float64']}; ms a call (host clock, mean of "
          f"two) beside the kernel's device us a step (section 4):")
    for run in oracle_runs:
        if run["dtype"] != "float64":
            continue
        run["host_backends"] = hb = run_host_backends(run, gtscript, storage, np, torch)
        print(f"  {run['case']['name']:8s} numpy {hb['numpy']['ms']:9.1f} ms "
              f"(max abs err {hb['numpy']['max_abs_err']:.3e})  cpu:c {hb['cpu:c']['ms']:8.1f} ms "
              f"(max abs err {hb['cpu:c']['max_abs_err']:.3e})  kernel "
              f"{run['device_ms'] * 1e3:8.1f} us  (numpy / kernel "
              f"{hb['numpy']['ms'] / run['device_ms']:.0f}x, cpu:c / kernel "
              f"{hb['cpu:c']['ms'] / run['device_ms']:.0f}x)")

    # -- 9. the profiler: a warm call runs its generated kernel and nothing else -----
    hdiff32 = by_path[("hdiff", "float32")]
    hfields = card_fields(hdiff32["host"], origin, hdiff32["case"], storage)
    traced = [(
        "hdiff float32 __call__",
        trace_warm_call(lambda: hdiff32["kern"](**hfields, domain=domain),
                        hdiff32["kern"]._backend.module, "gt4py_warm_call", cuda_backend, torch),
    )]
    nhdiff = next(r for r in nruns if r["case"]["name"] == "next_hdiff" and r["dtype"] == "float32")
    traced.append((
        "next_hdiff float32 call",
        trace_warm_call(
            lambda: nhdiff["op"](*nhdiff["args"], out=nhdiff["out"], offset_provider=ndefs.PROV_K,
                                 **nhdiff["kwargs"]),
            nhdiff["variant"].backend.module, "gt4py_warm_call", cuda_backend, torch),
    ))
    print(f"profiler on {smi}: a warm call under gpu_trace (torch.profiler, CPU and CUDA), its "
          "device work == its generated kernel and the fills and copies its wrapper makes:")
    for tag, tr in traced:
        print(f"  {tag:26s} device work a call {tr['work']}; median of calls 2-5: host "
              f"{tr['call_us']:.1f} us a call, {tr['to_launch_us']} us from its start to the "
              f"launch ({tr['launch_api']}: {tr['launch_us']} us), kernel {tr['kernel_us']} us "
              f"on the device; each call (call, to launch, launch) us: "
              + "; ".join(f"{c['call_us']:.1f}, {c['to_launch_us']}, {c['launch_us']}"
                          for c in tr["splits"]) + f"  trace {tr['trace']}")

    # -- 10. the examples at full width on the card ----------------------------------
    t0 = time.perf_counter()
    print(f"examples (gt4py_tpu_torch/examples/) on {smi}, card storages and fields, each "
          "counted and held against the numpy backend on the host (rtol float64 "
          f"{RTOL['float64']}, float32 {ORACLE_TOL['float32']}); device us a call: "
          f"{EX_TIMED_CALLS} calls behind a spin kernel:")
    example_rows = run_examples(examples, cuda_backend, torch)
    print(f"examples phase in {time.perf_counter() - t0:.1f} s; bounds (compulsory bytes over "
          f"{HBM_BYTES_PER_S / 1e12} TB/s): " + ", ".join(
              f"{r['name']} {r['ms'] * 1e3:.1f} us against {r['bound_ms'] * 1e3:.2f} "
              f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.1f}" for r in example_rows))

    # -- 11. the distributed path: four shards of the card, each at full width -------
    dist_rows = run_distributed(runs, dex, {nb["vertices"]: nb["ms"] for nb in nablas}, ndefs,
                                storage, cuda_backend, torch, smi)

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
            "step_minus_device_us": (run["ms"] - run["device_ms"]) * 1e3,
            "fit_step_minus_device_us": (run["slope_ms"] - run["device_ms"]) * 1e3,
            "chain_call_us": run["chain_call_ms"] * 1e3,
            "chain_mode": run["chain_mode"],
            "call_host_us": run["call_host_ms"] * 1e3,
            "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"],
            "bound_by": run["bound_by"],
            # no single PyTorch call computes a GTScript stencil
            "library_ms": None,
            "copy_bound_ms": run["copy_bound_ms"],
            "compulsory_gbs": run["gbs"],
            "copy_gbs": copy_gbs,
            "debug_max_abs_err": run.get("debug_err"),
            "numpy_ms": run.get("host_backends", {}).get("numpy", {}).get("ms"),
            "cpu_c_ms": run.get("host_backends", {}).get("cpu:c", {}).get("ms"),
        }
        for run in runs
    ]
    kernels += [
        {
            "name": f"{run['kernel']}/{run['case']['name']}"
                    f"{'_switch_on' if run['fuse'] else ''}/{run['dtype']}",
            "route": "cuda",
            "entry": "field_view_bridge",
            "source": SOURCE,
            "replaces": REPLACES[run["kernel"]],
            "launches": run["launches"],
            "max_abs_err": run["max_abs_err"],
            "ms": run["device_ms"],
            "cartesian_ms": run["cart_call_ms"],
            "vs_cartesian": run["device_ms"] / run["cart_call_ms"],
            "cartesian_same_bits": run["cart_same_bits"],
            "cartesian_max_abs_err": run["cart_abs_err"],
            "call_host_us": run["call_host_ms"] * 1e3,
            "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"],
            "bound_by": run["bound_by"],
            "library_ms": None,
        }
        for run in nruns
    ]
    # -- 12. bench.py's calibration probes on their kernels, and the ceilings -----------
    cal_rows = run_calibration(runs, copy_gbs, calibration, smi, torch)

    kernels += example_rows + dist_rows + cal_rows
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))
    return 0


def path_cases(defs) -> list:
    """The main paths: definition, kernel, fields, scalars and the swap of
    a ``chain`` step."""
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
    # vadv and tridiag again, with the stage-fusion switch on: same
    # definitions, inputs, swaps and oracles
    cases += [
        {**base, "name": f"{base['name']}_fused", "kernel": "fused_column", "fuse": True,
         "like": base["name"]}
        for base in cases if base["name"] in ("vadv", "tridiag")
    ]
    return cases


@contextlib.contextmanager
def fusion_switch(fuse: bool):
    """The stage-fusion switch on or off while the block runs (it is read
    when a stencil or a bridged variant is built)."""
    saved = os.environ.get(FUSE_ENV)
    os.environ[FUSE_ENV] = "1" if fuse else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ[FUSE_ENV]
        else:
            os.environ[FUSE_ENV] = saved


def build_stencil(gtscript, definition, backend, dtype, externals=None, fuse=False, **extra):
    """A main path's stencil in ``dtype`` (float32: float32 literals)."""
    opts = {"dtypes": {"dt": dtype, "vadv_dt": dtype}, **extra}
    if dtype == "float32":
        opts.update(literal_float_precision=32, literal_int_precision=32)
    return build_switched(
        gtscript, fuse, backend=backend, definition=definition,
        externals=externals or {}, **opts,
    )


def build_switched(gtscript, fuse: bool, **options):
    """``gtscript.stencil(**options)`` with the stage-fusion switch on or
    off (it is part of the stencil's fingerprint)."""
    with fusion_switch(fuse):
        return gtscript.stencil(**options)


def field_shape(case, name, shape):
    """A field's shape: the axes of the 3-D ``shape`` it has."""
    dims = case.get("dims", {}).get(name, "IJK")
    return tuple(n for n, ax in zip(shape, "IJK") if ax in dims)


def card_fields(host, origin, case, storage, backend="cuda:hopper"):
    """Storages of ``backend``, lower-dimensional ones with their own axes:
    on the card for ``cuda:hopper``, on the host for the CPU backends
    (``numpy``, ``debug``, ``cpu:c``)."""
    out = {}
    for n, v in host.items():
        dims = case.get("dims", {}).get(n, "IJK")
        out[n] = storage.from_array(
            v, backend=backend, dimensions=tuple(dims),
            aligned_index=tuple(o for o, ax in zip(origin, "IJK") if ax in dims),
        )
    return out


def make_host(case, shape, seed, np):
    """Float64 host inputs of one case, made from ``seed``, scaled to the
    well-conditioned ranges the stencils see in a model."""
    rng = np.random.default_rng(seed)
    host = {n: rng.random(field_shape(case, n, shape)) for n in case["fields"]}
    like = case.get("like", case["name"])
    if like == "tridiag":  # diagonally dominant system
        host["inf"] = -host["inf"]
        host["sup"] = -host["sup"]
        host["diag"] = host["diag"] + 4.0
    elif like in ("hdiff", "hdiff_sponge"):  # a stable diffusion coefficient
        host["coeff"] = 0.1 * host["coeff"]
    elif like == "vadv":  # vertical wind small beside 1/dt: pivots stay away from 0
        host["wcon"] = 0.1 * host["wcon"]
    return host


def in_dtype(v, dtype: str):
    """Host array ``v`` in ``dtype``: a NumPy array, or for bfloat16, which
    NumPy cannot hold, a CPU ``torch.bfloat16`` tensor (rounded to nearest
    even); ``storage.from_array`` takes either."""
    import torch

    if dtype == "bfloat16":
        return torch.from_numpy(v).to(torch.bfloat16)
    return v.astype(dtype)


def as_float64(v, np):
    """A host array or tensor of :func:`in_dtype` as float64 NumPy."""
    return np.asarray(v.double() if hasattr(v, "double") else v, dtype=np.float64)


def same_bits(a, b) -> bool:
    """Two tensors equal to the bit (NaNs included)."""
    import torch

    bits = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def check_graph_chain(run, origin, domain, storage, torch) -> str:
    """``chain(n)`` for n = CHAIN_STEPS and CHAIN_STEPS + 1, each on fresh
    fields (so the first cycle is launched, captured, then replayed),
    against n single calls rotating the same roles: equal to the bit, with
    the same launches; returns the chain's ``chain_mode`` (it must be
    "graph")."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    case, kern = run["case"], run["kern"]
    swap, kw = case["swap"], dict(domain=domain, **run["scalars"])
    mode = None
    for n in (CHAIN_STEPS, CHAIN_STEPS + 1):
        chained = card_fields(run["host"], origin, case, storage)
        cur = card_fields(run["host"], origin, case, storage)
        info: dict = {}
        wrapper = cuda_backend.WRAPPERS[case["kernel"]]
        wrapper.launches = 0
        kern.chain(n, **chained, swap=swap, exec_info=info, **kw)
        torch.cuda.synchronize()
        launched, wrapper.launches = wrapper.launches, 0
        for _ in range(n):
            kern(**cur, **kw)
            cur = {r: cur[swap.get(r, r)] for r in cur}
        torch.cuda.synchronize()
        if launched != wrapper.launches:
            raise AssertionError(f"{case['name']}: chain({n}) launched {launched} kernels, "
                                 f"{n} calls {wrapper.launches}")
        for r in chained:
            if not same_bits(chained[r].array, cur[r].array):
                raise AssertionError(f"{case['name']} {run['dtype']}: chain({n}) differs from "
                                     f"{n} calls in {r}")
        mode = info["chain_mode"]
        if mode != "graph":
            raise AssertionError(f"{case['name']}: chain({n}) ran as {mode}, not a graph")
    return mode


def call_host_ms(run, fields, n: int) -> float:
    """Host ms of one warm ``__call__`` (its prepared launch found in the
    cache), over ``n`` calls queued behind a spin kernel, so that no call
    waits for the card."""
    import torch

    kw = dict(domain=(NI, NJ, NK), **run["scalars"])
    run["kern"](**fields, **kw)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
    t0 = time.perf_counter()
    for _ in range(n):
        run["kern"](**fields, **kw)
    host = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return host * 1e3


def check_oracle(run, defs, np, storage) -> None:
    """The kernel on a small input against the NumPy oracle (one call)."""
    import torch

    case, dtype = run["case"], run["dtype"]
    like = case.get("like", case["name"])
    if like in ("hdiff", "hdiff_sponge"):
        shape, origin, domain = (24, 21, 8), (2, 2, 0), (20, 17, 8)
    elif like == "smoothed_column_sum":
        shape, origin, domain = (14, 13, 16), (1, 1, 0), (12, 11, 16)
    elif like == "vadv":  # wcon is read at i + 1
        shape, origin, domain = (13, 12, NK), (0, 0, 0), (12, 12, NK)
    else:
        shape, origin, domain = (12, 12, NK), (0, 0, 0), (12, 12, NK)
    typed = {n: in_dtype(v, dtype) for n, v in make_host(case, shape, 11, np).items()}
    host = {n: as_float64(v, np) for n, v in typed.items()}
    fields = card_fields(typed, origin, case, storage)
    run["kern"](**fields, **run["scalars"], domain=domain)
    torch.cuda.synchronize()
    if like == "hdiff":
        got = np.asarray(fields["out_field"])[2:-2, 2:-2]
        want = defs.validate_horizontal_diffusion(host["in_field"], host["coeff"])
    elif like == "hdiff_sponge":
        got = np.asarray(fields["out_field"])[2:-2, 2:-2]
        want = defs.validate_hdiff_sponge(host["in_field"], host["coeff"], host["damp"])
    elif like == "smoothed_column_sum":
        got = np.asarray(fields["out"])[1:-1, 1:-1]
        want = defs.validate_smoothed_column_sum(host["inp"])
    elif like == "vadv":
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
    sees it), after a warm-up chain as long (which captures the graph), from
    the inputs again (:func:`refill`)."""
    import torch

    kw = dict(swap=run["case"]["swap"], domain=(NI, NJ, NK))
    stencil.chain(n, **fields, **run["scalars"], **kw)
    refill(fields, run["host"])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    stencil.chain(n, **fields, **run["scalars"], **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def refill(fields, host) -> None:
    """Copy the host inputs into the fields again. A timed chain starts from
    them: tridiag's ping-pong shrinks its values geometrically, into
    float32's subnormals within a few tens of steps, where its divisions
    slow down."""
    import torch

    for n, v in host.items():
        fields[n].array.copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(v))


def chain_fit(stencil, fields, run) -> tuple[float, float]:
    """(ms a step, ms a chain call) of the kernel's ``chain``: the two-point
    fit of chain(20) and chain(50) by CUDA events (bench.py:12-22), which
    splits what every step costs from what each call adds once."""
    t20, t50 = (time_steps(stencil, fields, run, n) * n for n in (20, 50))
    slope = (t50 - t20) / 30
    return slope, t20 - 20 * slope


def compulsory_bytes(stencil, itemsize: int = 0, domain=(NI, NJ, NK)) -> int:
    """Bytes one application must move at the least, computed from shapes:
    each API field stored once if the stencil writes it, and read once if
    some read can reach a point before the stencil writes it there
    (:func:`initial_reads`), over the domain along the axes it has (halos
    and temporaries left out), ``itemsize`` bytes a point (0: each field's
    own)."""
    needed = initial_reads(stencil._backend.analyzed, domain[2])
    total = 0
    for name, info in stencil.field_info.items():
        if info is not None:
            written = bool(info.access.value & 2)  # READ = 1, WRITE = 2
            points = 1
            for n, on in zip(domain, info.domain_mask):
                points *= n if on else 1
            size = itemsize or info.dtype.itemsize
            total += points * size * ((name in needed) + written)
    return total


def probe_bounds(ni=NI, nj=NJ, nk=NK, halo=HALO) -> dict:
    """(bytes, ms) of the bytes bound of bench.py's three calibration probes
    (step 12's kernels, gt4py_tpu_torch/cartesian/backend/calibration.py), at
    the main path's size over the H100's 3.35 TB/s: ``_mk_probe`` walks 4
    float32 inputs and 1 output over (nk, ni, nj/2) planes (plus its m FMAs
    or n divisions a point),
    ``_pw_kernel`` computes ``a + b*c - d`` over (nk, ni, nj) float32 planes,
    ``_mk_bf16_probe`` reads and writes bfloat16 over (nk, ni + 2 halo,
    nj + 2 halo)."""
    nbytes = {
        "bench.py:1494 _mk_probe": 5 * nk * ni * (nj // 2) * 4,
        "bench.py:1414 _pw_kernel": 5 * nk * ni * nj * 4,
        "bench.py:1351 _mk_bf16_probe": 2 * nk * (ni + 2 * halo) * (nj + 2 * halo) * 2,
    }
    return {k: (b, b / HBM_BYTES_PER_S * 1e3) for k, b in nbytes.items()}


def as_stencil(variant):
    """A bridged variant seen as the stencil object :func:`compulsory_bytes`
    and :func:`operations` read."""
    import types

    return types.SimpleNamespace(_backend=variant.backend,
                                 field_info=variant.backend.analyzed.field_infos)


def initial_reads(analyzed, nk: int) -> set:
    """The API fields whose values before the call the stencil reads: some
    read reaches a point and level before the stencil writes it there.
    Walks each vertical loop over ``nk`` levels in its order (a PARALLEL
    loop statement by statement over its levels), holding the levels of
    each 3-D field that an unconditional write has set over the domain; a
    read is served by such a write only where every point it reads lies in
    the domain, and never at a variable or absolute K."""
    from gt4py_tpu_torch.cartesian import gtir
    from gt4py_tpu_torch.cartesian.passes.extents import _iter_reads

    full = {n for n, info in analyzed.field_infos.items() if info is not None and len(info.axes) == 3}
    written: set = set()  # (name, level)
    needed: set = set()

    def visit(stmt, k: int) -> None:
        ext = analyzed.stmt_extents[stmt]
        for r in _iter_reads(stmt):
            if r.name not in analyzed.field_infos:
                continue
            reach = ext.shifted_ij(r.offset[0], r.offset[1])
            level = min(max(k + r.offset[2], 0), nk - 1)
            if (
                r.koffset is not None or r.abs_k is not None
                or (r.name, level) not in written
                or reach.i[0] < 0 or reach.i[1] > 0 or reach.j[0] < 0 or reach.j[1] > 0
            ):
                needed.add(r.name)
        t = getattr(stmt, "target", None)
        if (
            isinstance(stmt, gtir.Assign) and t.name in full and stmt.mask is None
            and not stmt.horizontal_masks and not t.data_index
            and t.offset == (0, 0, 0) and t.koffset is None
        ):
            written.add((t.name, k))

    for vloop in analyzed.stencil.vertical_loops:
        ranges = [(s, *s.interval.resolve(nk)) for s in vloop.sections]
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            for section, ks, ke in ranges:
                for stmt in section.body:
                    for k in range(ks, ke):
                        visit(stmt, k)
            continue
        levels = range(nk)
        if vloop.loop_order == gtir.LoopOrder.BACKWARD:
            levels = reversed(levels)
        for k in levels:
            for section, ks, ke in ranges:
                if ks <= k < ke:
                    for stmt in section.body:
                        visit(stmt, k)
    return needed


def operations(stencil, domain=(NI, NJ, NK)) -> int:
    """Arithmetic operations one application does at the least, computed
    from its GTIR: each arithmetic operator, negation and math call once at
    every point of its statement's extent and level of its interval."""
    ni, nj, nk = domain
    from gt4py_tpu_torch import eve
    from gt4py_tpu_torch.cartesian import gtir

    analyzed = stencil._backend.analyzed
    total = 0
    for vloop in analyzed.stencil.vertical_loops:
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            for stmt in section.body:
                ext = analyzed.stmt_extents[stmt]
                ops = sum(
                    isinstance(n.op, gtir.ArithmeticOperator)
                    for n in eve.walk_type(stmt, gtir.BinaryOp)
                )
                ops += sum(1 for _ in eve.walk_type(stmt, gtir.NativeFuncCall))
                ops += sum(
                    n.op == gtir.UnaryOperator.NEG for n in eve.walk_type(stmt, gtir.UnaryOp)
                )
                points = (ni + ext.i[1] - ext.i[0]) * (nj + ext.j[1] - ext.j[0])
                total += ops * points * max(ke - ks, 0)
    return total


def registry_stencils(defs, gtscript) -> list:
    """Every registry stencil, built for the kernel and for the plain
    version, in its own dtypes, and K4's class again with the stage-fusion
    switch on; fails where the served kernel is not the one pinned for it."""
    out = []
    pins = [(name, entry, False) for name, entry in sorted(defs.REGISTRY.items())]
    pins += [
        (name, {**defs.REGISTRY[name], "strategy": kernel}, True)
        for name, kernel in sorted(defs.FUSED_STAGES.items())
    ]
    for name, entry, fuse in pins:
        opts = dict(definition=entry["definition"], externals=entry["externals"],
                    dtypes=entry["dtypes"])
        kern = build_switched(gtscript, fuse, backend="cuda:hopper", **opts)
        if kern._backend.strategy != entry["strategy"]:
            raise AssertionError(
                f"registry {name}: served by {kern._backend.strategy} "
                f"({kern._backend.unsupported}), pinned to {entry['strategy']}"
            )
        out.append({"name": name + (" (switch on)" if fuse else ""), "entry": entry,
                    "kern": kern, "plain": gtscript.stencil(backend="torch", **opts),
                    "oracle": gtscript.stencil(backend="numpy", **opts)})
    return out


def half_stencils(defs, gtscript) -> list:
    """The stencils of ``defs.HALF_STENCILS``, one on each kernel, in float16
    and in bfloat16, built for the kernel (failing where another one serves
    it) and for the plain version, with their tolerance."""
    out = []
    for dtype in HALVES:
        for name, (definition, kernel, fuse) in sorted(defs.HALF_STENCILS.items()):
            opts = dict(definition=definition, dtypes={"dt": dtype})
            kern = build_switched(gtscript, fuse, backend="cuda:hopper", **opts)
            if kern._backend.strategy != kernel:
                raise AssertionError(
                    f"{dtype} {name}: served by {kern._backend.strategy} "
                    f"({kern._backend.unsupported}), pinned to {kernel}"
                )
            tol = defs.HALF_TOL if dtype == "float16" else defs.BF16_TOL[name]
            out.append({"name": name, "dtype": dtype, "tol": tol,
                        "entry": (definition, kernel, fuse), "kern": kern,
                        "plain": gtscript.stencil(backend="torch", **opts),
                        "oracle": gtscript.stencil(backend="numpy", **opts)})
    return out


def run_half_stencil(reg, defs, storage, cuda_backend, np, torch) -> None:
    """One half stencil at REG_N × REG_N × 16 through its kernel (counted)
    and the plain version, every field and point compared at ``reg["tol"]``;
    its largest error goes to ``reg["err"]``."""
    kernel, dtype = reg["entry"][1], reg["dtype"]
    shape = (REG_N + 2 * REG_HALO, REG_N + 2 * REG_HALO, 16)
    host = defs.half_inputs(reg["kern"].field_info, shape, np.random.default_rng(19))
    out = {}
    for tag in ("kern", "plain", "oracle"):
        be = "numpy" if tag == "oracle" else "cuda:hopper"
        fields = {n: storage.from_array(v, dtype=dtype, backend=be) for n, v in host.items()}
        cuda_backend.WRAPPERS[kernel].launches = 0
        info: dict = {}
        reg[tag](**fields, origin=(REG_HALO, REG_HALO, 0), domain=(REG_N, REG_N, 16),
                 exec_info=info)
        torch.cuda.synchronize()
        if tag == "kern" and (
            info["kernel_strategy"] != kernel or cuda_backend.WRAPPERS[kernel].launches == 0
        ):
            raise AssertionError(f"{dtype} {reg['name']}: {kernel} not launched")
        out[tag] = {n: np.asarray(v).astype(np.float64) for n, v in fields.items()}
    reg["err"] = reg["oracle_err"] = 0.0
    for ref, key in (("plain", "err"), ("oracle", "oracle_err")):
        for n, want in out[ref].items():
            got = out["kern"][n]
            if not np.all(np.isfinite(got)):
                raise AssertionError(f"{dtype} {reg['name']}: non-finite values in {n}")
            reg[key] = max(reg[key], float(np.max(np.abs(got - want))))
            if not np.allclose(got, want, rtol=reg["tol"], atol=reg["tol"]):
                raise AssertionError(
                    f"{dtype} {reg['name']}: kernel disagrees with {ref} in {n} "
                    f"(max abs err {reg[key]})"
                )


def run_sweep(sweep, shape, origin, domain, storage, cuda_backend, np, torch) -> None:
    """One lagged sweep at full size in float64: the plain version once and
    the kernel three times, each time on a fresh copy of the same inputs and
    counted, one cooperative launch; every run equal to the plain version and
    to the first run (a race between blocks would make the runs differ).
    Then ms per call of five calls, host included, and behind a spin
    kernel (device only)."""
    rng = np.random.default_rng(17)
    host = {n: rng.random(shape) for n in ("inp", "out")}

    def fields():
        return {n: storage.from_array(v, backend="cuda:hopper", aligned_index=origin)
                for n, v in host.items()}

    want = fields()
    sweep["plain"](**want, domain=domain)
    first = None
    for attempt in range(3):
        got = fields()
        cuda_backend.TILED.launches = 0
        info: dict = {}
        sweep["kern"](**got, domain=domain, exec_info=info)
        torch.cuda.synchronize()
        if info["kernel_strategy"] != "tiled" or cuda_backend.TILED.launches != 1:
            raise AssertionError(
                f"{sweep['name']}: {cuda_backend.TILED.launches} tiled launches, not one "
                f"cooperative launch ({info})"
            )
        for n in host:
            g, w = got[n].array, want[n].array
            if not torch.allclose(g, w, rtol=RTOL["float64"], atol=0.0) or (
                first is not None and not torch.equal(g, first[n].array)
            ):
                raise AssertionError(
                    f"{sweep['name']} run {attempt + 1}: kernel disagrees with plain in {n} "
                    f"(max abs err {float((g - w).abs().max())})"
                )
        first = first or got
    chained, cur, info = fields(), fields(), {}
    sweep["kern"].chain(5, **chained, swap={"inp": "out", "out": "inp"}, domain=domain,
                        exec_info=info)
    for _ in range(5):
        sweep["kern"](**cur, domain=domain)
        cur = {"inp": cur["out"], "out": cur["inp"]}
    torch.cuda.synchronize()
    for n in host:
        if not same_bits(chained[n].array, cur[n].array):
            raise AssertionError(f"{sweep['name']}: chain(5) differs from five calls in {n}")
    sweep["chain_mode"] = info["chain_mode"]
    n = 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        sweep["kern"](**got, domain=domain)
    end.record()
    end.synchronize()
    sweep["ms"] = start.elapsed_time(end) / n
    sweep["device_ms"] = spin_ms(
        lambda: [sweep["kern"](**got, domain=domain) for _ in range(n)], n, sweep["name"]
    )


def run_registry_stencil(reg, defs, storage, cuda_backend, np, torch) -> None:
    """One registry stencil at REG_N × REG_N through its kernel (counted)
    and through the plain version, every field and point compared."""
    entry = reg["entry"]
    nk = max(8, entry["min_k"])
    shape = (REG_N + 2 * REG_HALO, REG_N + 2 * REG_HALO, nk)
    host = defs.make_inputs(reg["kern"].field_info, shape, np.random.default_rng(13))
    out = {}
    for tag in ("kern", "plain", "oracle"):
        be = "numpy" if tag == "oracle" else "cuda:hopper"
        fields = {n: storage.from_array(v, backend=be) for n, v in host.items()}
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
    reg["oracle_err"] = 0.0
    for ref in ("plain", "oracle"):
        for n, want in out[ref].items():
            got = out["kern"][n]
            if np.issubdtype(want.dtype, np.floating):
                rtol = RTOL[want.dtype.name]
                same = np.allclose(got, want, rtol=rtol, atol=0.0, equal_nan=True)
                if ref == "oracle":
                    reg["oracle_err"] = max(reg["oracle_err"], float(np.nanmax(
                        np.abs(got - want) / np.maximum(np.abs(want), np.finfo(want.dtype).tiny),
                        initial=0.0)))
            else:
                same = np.array_equal(got, want)
            if not same:
                raise AssertionError(f"registry {reg['name']}: kernel disagrees with {ref} in {n}")


def copy_bandwidth() -> float:
    """Bytes/s (read + write) of a device-to-device copy of 256 MiB, five
    times the H100's 50 MB L2: the sustainable bandwidth, measured in the
    same run as the kernels, that their compulsory bytes are held against."""
    import torch

    src = torch.rand(64 * 1024 * 1024, device="cuda")
    dst = torch.empty_like(src)
    return 2 * src.numel() * src.element_size() / (events_ms(lambda: dst.copy_(src), 20) * 1e-3)


def device_ms(run, fields, n: int) -> float:
    """ms per step that ``chain(n)`` from the main path's inputs holds the
    card (:func:`spin_ms`): the stencil's device work (kernels and the
    temporaries' zero-fill) and none of the host's per-call cost."""
    kw = dict(swap=run["case"]["swap"], domain=(NI, NJ, NK))
    run["kern"].chain(n, **fields, **run["scalars"], **kw)
    refill(fields, run["host"])
    return spin_ms(
        lambda: run["kern"].chain(n, **fields, **run["scalars"], **kw), n, run["case"]["name"]
    )


def unringed_ms(run, fields, cuda_backend) -> float:
    """A tile walk's :func:`device_ms` in its plain-pointer variant, the
    one the wrapper launches where two arguments share memory (here it is
    told they do): the same barriers for the main paths' stencils, but no
    input ring, no register carries of API fields and no ``__restrict__``.
    The backend's prepared launches and chains are dropped before and after:
    one found by the fields' pointers would keep the ringed variant."""
    backend = run["kern"]._backend
    saved = cuda_backend.overlapping
    cuda_backend.overlapping = lambda arrays: [("", "")]
    backend._launches.clear()
    backend._chains.clear()
    try:
        return device_ms(run, fields, 20)
    finally:
        cuda_backend.overlapping = saved
        backend._launches.clear()
        backend._chains.clear()


def spin_ms(work, n: int, name: str) -> float:
    """ms per step that ``work()``, ``n`` steps, holds the card, behind a
    spin kernel (``instrumentation.profiler.spin_ms``)."""
    from gt4py_tpu_torch.instrumentation.profiler import spin_ms as behind_spin

    return behind_spin(work, n, name)


def walked_levels(analyzed, nk: int) -> int:
    """Levels the FORWARD and BACKWARD loops of one application walk."""
    from gt4py_tpu_torch.cartesian import gtir

    total = 0
    for vloop in analyzed.stencil.vertical_loops:
        if vloop.loop_order != gtir.LoopOrder.PARALLEL:
            for section in vloop.sections:
                ks, ke = section.interval.resolve(nk)
                total += max(ke - ks, 0)
    return total


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one, with its template's integer
    arguments where it has them: ``_Z10probe_walkILi0ELi64EEv...`` is
    ``probe_walk<0, 64>``, ``_Z10gt_plane_06GtParams`` ``gt_plane_0``."""
    import re

    m = re.match(r"_Z(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = m.group(2)[:n], m.group(2)[n:]
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    return f"{name}<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>" if args else name


def ptxas_report(source: str, cuda_backend) -> dict:
    """kernel -> (registers, spill store bytes), from the ``-Xptxas -v``
    lines of the build log beside the source."""
    import re

    log = cuda_backend._paths(source)[2] + ".log"
    out, kernel = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(_Z\w+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and kernel:
                out[kernel] = (out.get(kernel, (0, 0))[0], int(m.group(1)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[kernel] = (int(m.group(1)), out.get(kernel, (0, 0))[1])
    return out


def residency(source: str, cuda_backend) -> dict:
    """kernel -> blocks resident on an SM (:func:`resident_blocks`), from
    its registers and static shared memory in the build log and its
    threads and dynamic shared memory in the source."""
    import re

    log = cuda_backend._paths(source)[2] + ".log"
    static, kernel = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(_Z\w+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m and kernel:
                static[kernel] = int(m.group(1))
    threads = {k: int(n) for n, k in re.findall(r"__launch_bounds__\((\d+)\) (\w+)\(", source)}
    dynamic = {k: int(n) for k, n in re.findall(r"(\w+)<<<grid, block, (\d+),", source)}
    dynamic.update(re.findall(r"cudaLaunchCooperativeKernel\(\(const void\*\)(\w+),.*?gt_args, (\d+),", source))
    return {
        k: resident_blocks(r, threads.get(k, 256), static.get(k, 0) + int(dynamic.get(k, 0)))
        for k, (r, _) in ptxas_report(source, cuda_backend).items()
    }


def resident_blocks(registers: int, threads: int, shared: int) -> int:
    """Blocks of a kernel an H100 SM holds at once, by the occupancy rule:
    65,536 registers allocated 256 a warp at a time, 64 warps, 32 blocks,
    and 228 KB of shared memory of which each block also takes 1 KB."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if per_warp else 32
    by_shared = 228 * 1024 // (shared + 1024)
    return min(32, 64 // warps, by_regs, by_shared)


def cuobjdump():
    """The toolkit's ``cuobjdump``, or None where it has none."""
    import shutil

    for path in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if path and os.path.isfile(path):
            return path
    return None


#: SASS opcodes by class, by their first letters where a family shares them
SASS_CLASSES = (
    ("global", ("LDG", "STG", "LDGSTS", "RED", "ATOMG", "ATOM", "LD", "ST")),
    ("shared", ("LDS", "STS", "LDSM", "ATOMS")),
    ("other", ("BAR", "BRA", "BSSY", "BSYNC", "EXIT", "NOP", "DEPBAR", "LDGDEPBAR", "WARPSYNC",
               "CALL", "RET", "YIELD", "BREAK", "LDC", "ULDC", "MEMBAR", "ERRBAR", "CCTL", "BPT")),
)


def sass_class(op: str) -> str:
    """global, shared, fp, int (integer and address arithmetic, moves,
    predicates) or other (control, barriers, constant loads)."""
    for name, ops in SASS_CLASSES:
        if op in ops:
            return name
    if op[0] in "FDH" or op in ("MUFU", "I2F", "F2I", "I2FP", "F2IP"):
        return "fp"
    return "int"


def sass_functions(source: str, cuda_backend, tool: str) -> dict:
    """kernel (:func:`kernel_name`) -> (code, labels): the SASS of each
    kernel of the source's library (``cuobjdump -sass``), code as (address,
    opcode with its modifiers, operands) and labels as label -> index."""
    import re

    lib = cuda_backend._paths(source)[1]
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        code, labels = [], {}
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(code)
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
            if ins:
                code.append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
        out[kernel_name(chunk.split()[0])] = (code, labels)
    return out


def sass_counts(source: str, cuda_backend, tool: str) -> dict:
    """kernel -> {"static": {class: n}, "loops": {class: n}}: the SASS of
    each kernel of the source's library (``cuobjdump -sass``), and of the
    bodies of its innermost loops (a backward branch's span that holds no
    other), which a thread issues once per point of a statement (times
    any unrolling)."""
    import re

    out = {}
    for kernel, (code, labels) in sass_functions(source, cuda_backend, tool).items():
        code = [(addr, op.split(".")[0], rest) for addr, op, rest in code]
        where = {addr: n for n, (addr, _, _) in enumerate(code)}
        loops = []
        for n, (addr, op, rest) in enumerate(code):
            if op != "BRA":
                continue
            t = re.search(r"0x([0-9a-f]+)|`?\(?(\.L_x_\d+)", rest)
            if t is None:
                continue
            target = where.get(int(t.group(1), 16)) if t.group(1) else labels.get(t.group(2))
            if target is not None and target < n:
                loops.append((target, n))
        inner = [(a, b) for a, b in loops
                 if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
        counts = {"static": {}, "loops": {}}
        for n, (_, op, _) in enumerate(code):
            if op == "NOP":
                continue
            cls = sass_class(op)
            counts["static"][cls] = counts["static"].get(cls, 0) + 1
            if any(a <= n <= b for a, b in inner):
                counts["loops"][cls] = counts["loops"].get(cls, 0) + 1
        out[kernel] = counts
    return out


def walk_report(run, cuda_backend) -> str:
    """One walk's cell: µs per walked level, its ring bytes per block and
    each kernel's registers, spills and blocks resident on an SM."""
    module = run["kern"]._backend.module
    levels = walked_levels(run["kern"]._backend.analyzed, NK) or NK
    ptxas = ptxas_report(module.source, cuda_backend)
    blocks = residency(module.source, cuda_backend)
    return (
        f"{run['case']['name']:22s} {run['dtype']:8s} {levels} levels, "
        f"{run['device_ms'] * 1e3 / levels:.3f} us per level; ring bytes "
        + ", ".join(f"{k} {b}" for k, b in sorted(module.ring_bytes.items()))
        + (f"; plain-pointer variant {run['unringed_ms'] * 1e3:.1f} us a step"
           if "unringed_ms" in run else "")
        + "; ptxas " + ", ".join(
            f"{k} {r} registers {s} B spilled {blocks[k]} blocks an SM"
            for k, (r, s) in sorted(ptxas.items())
        )
    )


# -- the field-view phase -------------------------------------------------------


def next_cases() -> list:
    """The field-view main paths: the operator of tests/torch_next_defs.py,
    the cartesian main path it is held against (same data, same kernel
    class), and the fusion switch's settings it runs with: both where the
    switch changes the kernel (next_tridiag goes to ``fused_column``), off
    alone where it does not (next_vadv's lower-dimensional K index field
    keeps it on ``column``)."""
    return [
        {"name": "next_hdiff", "op": "hdiff_op", "like": "hdiff", "fuse": (False,)},
        {"name": "next_vadv", "op": "next_vadv", "like": "vadv", "fuse": (False,)},
        {"name": "next_tridiag", "op": "solve_tridiag", "like": "tridiag", "fuse": (False, True)},
    ]


def bridged_variant(op):
    """The bridge's variant serving ``op``; fails where the bridge took no
    call (the operator ran embedded instead)."""
    variants = [v for v in op.__dict__.get("_bridge_cache", {}).values() if v is not None]
    if len(variants) != 1:
        raise AssertionError(f"{op.definition.__name__}: the bridge holds {len(variants)} variants")
    return variants[0]


def prepare_next_runs(ndefs, nk: int, dtypes=("float32", "float64")) -> list:
    """One run per field-view case, dtype and switch setting: the operator
    on ``cuda:hopper``, called once on CPU fields of 8 × 8 × ``nk`` (the
    plain version), which traces and builds its bridged variant for the
    full-size call (the variant is keyed by dims, dtypes and the out K
    range, not by I and J); fails where the variant's kernel is not the one
    ``ndefs.KERNEL`` names."""
    import numpy as np

    runs = []
    for dtype in dtypes:
        for case in next_cases():
            for fuse in case["fuse"]:
                op = getattr(ndefs, case["op"]).with_backend("cuda:hopper")
                args, kwargs, out = ndefs.inputs(case["op"], 8, 8, nk, np.dtype(dtype), 1, "cpu")
                with fusion_switch(fuse):
                    op(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
                variant = bridged_variant(op)
                kernel = ndefs.KERNEL[case["op"]][int(fuse)]
                if variant.backend.strategy != kernel:
                    raise AssertionError(
                        f"{case['name']} {dtype}: bridged onto {variant.backend.strategy}, "
                        f"expected {kernel}"
                    )
                runs.append({"case": case, "dtype": dtype, "fuse": fuse, "op": op,
                             "variant": variant, "kernel": kernel})
    return runs


def next_tag(run) -> str:
    return f"{run['case']['name']}{' (switch on)' if run['fuse'] else ''}"


def run_next_main_path(run, ndefs, cuda_backend, torch) -> None:
    """The field-view main path of one run, counted: fields on the card at
    the full width, the launch counts set to 0, one call of the operator
    through ``cuda:hopper``, the counts read. The bridge must serve the call
    with the variant built before and the kernel the table names, each of
    its launchers launched once."""
    import numpy as np

    args, kwargs, out = ndefs.inputs(run["case"]["op"], NI, NJ, NK, np.dtype(run["dtype"]), 7)
    for wrapper in cuda_backend.WRAPPERS.values():
        wrapper.launches = 0
    run["op"](*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in cuda_backend.WRAPPERS.items()}
    variant = bridged_variant(run["op"])
    expected = len(variant.backend.module.launchers)
    if variant is not run["variant"] or variant.backend.last_strategy != run["kernel"]:
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: not served by the bridged "
                             f"{run['kernel']} variant ({variant.backend.last_strategy})")
    if counts[run["kernel"]] != expected or sum(counts.values()) != expected:
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: {counts}, not {expected} "
                             f"launches of {run['kernel']}")
    run.update(args=args, kwargs=kwargs, out=out, launches=counts[run["kernel"]])
    print(f"launches on the {next_tag(run)} {run['dtype']} field-view path: {counts}")


def check_next_run(run, ndefs, cart, storage, torch, device=None) -> None:
    """The bridged result against the plain version (the port's ``torch``
    backend, embedded Fields on the same card, same inputs) within
    RTOL/ATOL, and against the port's cartesian stencil ``cart`` of the
    same main path on the same data: equal to the bit, since the bridge
    traces the operator into the same GTIR (``cart_same_bits``)."""
    import numpy as np

    dtype = np.dtype(run["dtype"])
    got = run["out"].ndarray
    args, kwargs, plain = ndefs.inputs(run["case"]["op"], NI, NJ, NK, dtype, 7, device)
    getattr(ndefs, run["case"]["op"])(*args, out=plain, offset_provider=ndefs.PROV_K, **kwargs)
    if got.is_cuda:
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: non-finite values")
    run["max_abs_err"] = float((got.double() - plain.ndarray.double()).abs().max())
    if not torch.allclose(got, plain.ndarray, rtol=RTOL[run["dtype"]], atol=ATOL[run["dtype"]]):
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: the bridged kernel disagrees "
                             f"with the torch backend (max abs err {run['max_abs_err']})")
    want, run["cart_call"] = cartesian_twin(run, cart, storage)
    if got.is_cuda:
        torch.cuda.synchronize()
    run["cart_abs_err"] = float((got.double() - want.double()).abs().max())
    run["cart_same_bits"] = same_bits(got.contiguous(), want.contiguous())
    if not run["cart_same_bits"]:
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: differs from the cartesian "
                             f"stencil (max abs err {run['cart_abs_err']})")


def cartesian_twin(run, cart, storage):
    """The cartesian stencil ``cart`` of the run's main path, called once on
    storages holding the field-view run's inputs (its out field, or the
    inputs it overwrites, copied fresh); returns its result over the
    field-view out field's domain, and a function that calls it again."""
    like, args, dtype = run["case"]["like"], run["args"], run["dtype"]
    card = lambda f, origin: storage.from_array(  # noqa: E731
        f.ndarray, backend="cuda:hopper", aligned_index=origin, device=f.device)
    domain = (NI, NJ, NK)
    if like == "hdiff":
        inp, coeff = args
        fields = {"in_field": card(inp, (2, 2, 0)), "coeff": card(coeff, (2, 2, 0)),
                  "out_field": card(inp, (2, 2, 0))}
        call = lambda: cart(**fields, domain=domain)  # noqa: E731
        call()
        return fields["out_field"].array[2:NI + 2, 2:NJ + 2], call
    if like == "tridiag":
        fields = {n: card(f, (0, 0, 0)) for n, f in zip(("inf", "diag", "sup", "rhs"), args)}
        fields["out"] = card(args[3], (0, 0, 0))
        call = lambda: cart(**fields, domain=domain)  # noqa: E731
        call()
        return fields["out"].array, call
    names = ("utens_stage", "u_stage", "wcon", "u_pos", "utens")
    fields = {n: card(f, (0, 0, 1)) for n, f in zip(names, args)}
    call = lambda: cart(**fields, dtr_stage=args[-1], domain=domain)  # noqa: E731
    call()
    return fields["utens_stage"].array[:NI, :, 1:NK + 1], call


def time_next_run(run, ndefs, torch) -> None:
    """The field-view run's times: device ms per call of ``n`` calls queued
    behind a spin kernel (``device_ms``), the same of the cartesian
    stencil's calls on the same data (``cart_call_ms``, timed after, in
    turn, so that one reading of each sits beside the other), a warm call's
    host ms behind a spin (``call_host_ms``), and the plain version's ms per
    call by CUDA events (``plain_ms``)."""
    n = 20
    op, args, kwargs, out = run["op"], run["args"], run["kwargs"], run["out"]
    call = lambda: op(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)  # noqa: E731
    call()
    cart = run["cart_call"]
    fv1 = spin_ms(lambda: [call() for _ in range(n)], n, next_tag(run))
    ct1 = spin_ms(lambda: [cart() for _ in range(n)], n, next_tag(run) + " (cartesian)")
    ct2 = spin_ms(lambda: [cart() for _ in range(n)], n, next_tag(run) + " (cartesian)")
    fv2 = spin_ms(lambda: [call() for _ in range(n)], n, next_tag(run))
    run["device_ms"], run["cart_call_ms"] = (fv1 + fv2) / 2, (ct1 + ct2) / 2
    run["device_pair"], run["cart_pair"] = (fv1, fv2), (ct1, ct2)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    run["call_host_ms"] = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    plain = getattr(ndefs, run["case"]["op"])
    plain_call = lambda: plain(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)  # noqa: E731
    plain_call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        plain_call()
    end.record()
    end.synchronize()
    run["plain_ms"] = start.elapsed_time(end) / 3


def check_unstructured_on_card(ndefs, torch) -> float:
    """``edge_sum`` (``neighbor_sum`` through the toy mesh's V2E table with
    missing neighbours) embedded on the card, against the same on the CPU;
    no kernel is involved. Returns the largest absolute difference."""
    import numpy as np

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import field_utils

    _, v2e = ndefs.toy_mesh_tables()
    v2e = ndefs.with_skips(v2e)
    edges = np.random.default_rng(17).random(18)
    out = {}
    for device in ("cuda", "cpu"):
        conn = field_utils.connectivity_from_numpy(
            v2e, [ndefs.Vertex, ndefs.V2EDim], ndefs.Edge, skip_value=-1, device=device)
        e = gtx.as_field([ndefs.Edge], edges, device=device)
        res = gtx.zeros({ndefs.Vertex: 9}, device=device)
        ndefs.edge_sum(e, out=res, offset_provider={"V2E": conn})
        out[device] = res
    if out["cuda"].device.type != "cuda":
        raise AssertionError("edge_sum did not run on the card")
    torch.cuda.synchronize()
    got, want = out["cuda"].asnumpy(), out["cpu"].asnumpy()
    if not np.allclose(got, want, rtol=RTOL["float64"], atol=0.0):
        raise AssertionError(f"edge_sum on the card disagrees with the CPU: {got} vs {want}")
    return float(np.abs(got - want).max())


def oracle_tol(dtype: str) -> tuple:
    """(rtol, atol) of a field-view result against the ``numpy`` backend:
    rtol 1e-12 in float64; ORACLE_TOL in float32, where the oracle's scans
    carry float64 (its ``init`` is a float64 array, as in the JAX
    package's ``numpy``) and the kernels float32."""
    return (RTOL["float64"], 0.0) if dtype == "float64" else ORACLE_TOL[dtype]


def check_next_oracle(run, ndefs, shape=(NI, NJ, NK)) -> None:
    """The card's field-view result of a main path (``run["out"]``, from
    the inputs of seed 7) against the port's ``numpy`` backend run on the
    host from the same inputs, within :func:`oracle_tol`; records the
    largest error and the ``numpy`` ms a call (host clock)."""
    import numpy as np

    args, kwargs, out = ndefs.inputs(run["case"]["op"], *shape, np.dtype(run["dtype"]), 7,
                                     "cpu")
    op = getattr(ndefs, run["case"]["op"]).with_backend("numpy")
    t0 = time.perf_counter()
    op(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
    run["numpy_ms"] = (time.perf_counter() - t0) * 1e3
    got, want = run["out"].asnumpy().astype(np.float64), out.asnumpy().astype(np.float64)
    run["oracle_err"] = float(np.abs(got - want).max())
    rtol, atol = oracle_tol(run["dtype"])
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{next_tag(run)} {run['dtype']}: the card disagrees with the numpy "
                             f"backend (max abs err {run['oracle_err']})")


def output_arrays(value) -> list:
    """A case's written Field(s), as host arrays in order."""
    if isinstance(value, tuple):
        return [a for v in value for a in output_arrays(v)]
    return [value.asnumpy()]


def same_within(got, want, dtype_tol) -> float:
    """The largest absolute difference of two output lists; raises where a
    float array is not within ``dtype_tol[dtype]`` (an rtol with atol 0, or
    an (rtol, atol) pair) or an integer or bool array differs."""
    import numpy as np

    err = 0.0
    for a, b in zip(got, want, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{a.dtype}{a.shape} against {b.dtype}{b.shape}")
        if a.dtype.kind == "f":
            tol = dtype_tol[a.dtype.name]
            rtol, atol = tol if isinstance(tol, tuple) else (tol, 0.0)
            if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
                raise AssertionError(f"max abs err {np.nanmax(np.abs(a - b))}")
            with np.errstate(invalid="ignore"):
                diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            diff = diff[np.isfinite(diff)]
            err = max(err, float(diff.max()) if diff.size else 0.0)
        elif not np.array_equal(a, b):
            raise AssertionError("integer or bool outputs differ")
    return err


def feature_sources(fdefs, tcases, bridge) -> set:
    """The kernel sources of the feature cases: every case runs on
    ``cuda:hopper`` with CPU fields (the plain version), which traces the
    bridge's variants and generates their kernels' CUDA C++."""
    bridge.variant_log = log = []
    try:
        with tcases.on_device("cpu"):
            for name in fdefs.CASES:
                if name not in fdefs.RAISES:
                    fdefs.run_case(name, "cuda:hopper")
    finally:
        bridge.variant_log = None
    return {v.backend.module.source for v in log if v.backend.module is not None}


def run_feature_case(name, fdefs, tcases, bridge, cuda_backend, torch) -> dict:
    """One feature case on ``numpy`` (host fields), ``torch`` and
    ``cuda:hopper`` (card fields), the launch counts set to 0 just before
    the ``cuda:hopper`` run: every kernel it launched must have launched
    exactly the launchers the bridge's calls asked of it, and the kernels
    must be those ``BRIDGED_ONTO`` pins for the case. Returns the
    kernels launched, the largest error against ``numpy`` and, for a case
    whose test asserts an error, that all three raised it."""
    if name in fdefs.RAISES:
        cls = fdefs.RAISES[name][0]
        for backend, device in (("numpy", "cpu"), ("torch", "cuda"), ("cuda:hopper", "cuda")):
            with tcases.on_device(device):
                try:
                    fdefs.run_case(name, backend)
                except Exception as exc:  # noqa: BLE001 — the class is checked
                    if cls not in {c.__name__ for c in type(exc).__mro__}:
                        raise
                else:
                    raise AssertionError(f"{name} on {backend}: no {cls} raised")
        return {"raises": True, "kernels": {}, "err": 0.0}
    with tcases.on_device("cpu"):
        want = output_arrays(fdefs.run_case(name, "numpy"))
    with tcases.on_device("cuda"):
        plain = output_arrays(fdefs.run_case(name, "torch"))
        for wrapper in cuda_backend.WRAPPERS.values():
            wrapper.launches = 0
        bridge.launchers_served.clear()
        got = output_arrays(fdefs.run_case(name, "cuda:hopper"))
        torch.cuda.synchronize()
    counts = {k: w.launches for k, w in cuda_backend.WRAPPERS.items() if w.launches}
    if counts != dict(bridge.launchers_served):
        raise AssertionError(f"{name}: launched {counts}, the bridge asked for "
                             f"{dict(bridge.launchers_served)}")
    if set(counts) != fdefs.bridged_kernels(name):
        raise AssertionError(f"{name}: ran on {sorted(counts) or 'embedded'}, not on "
                             f"{sorted(fdefs.bridged_kernels(name)) or 'embedded'}")
    tol = {"float64": RTOL["float64"], "float32": RTOL["float32"], "float16": RTOL["float16"]}
    err = max(same_within(plain, want, tol), same_within(got, want, tol))
    return {"raises": False, "kernels": counts, "err": err}


def run_aot(name, ndefs, cuda_backend, bridge, torch, device="cuda", shape=(NI, NJ, NK)) -> dict:
    """``name`` in float32 at full width through ``cuda:hopper:aot``:
    ``compile()`` runs the stages (each one's seconds recorded); the first
    call after it must build no variant, run no ``nvcc`` and launch exactly
    the lowered kernel's launchers; its result must equal ``cuda:hopper``'s
    to the bit. ``device="cpu"`` rehearses it on the plain version (nothing
    is built there)."""
    import numpy as np

    from gt4py_tpu_torch.next import resolve_backend

    on_card = device == "cuda"

    base = resolve_backend("cuda:hopper:aot")
    seconds: dict = {}

    def timed(step_name, step):
        def run(job):
            t0 = time.perf_counter()
            out = step(job)
            seconds[step_name] = time.perf_counter() - t0
            return out
        return run

    steps = ("validate", "deduce", "specialize", "trace", "lower", "compile")
    backend = base.replace(transforms=base.transforms.replace(
        **{s: timed(s, getattr(base.transforms, s)) for s in steps}))
    args, kwargs, out = ndefs.inputs(name, *shape, np.dtype(np.float32), 7, device)
    op = getattr(ndefs, name).with_backend(backend)
    nvcc0 = cuda_backend.nvcc_runs
    op.compile(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
    compile_nvcc = cuda_backend.nvcc_runs - nvcc0
    job = op.compiled_job(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
    if job.compiled_stage is None or (on_card and job.compiled_stage.library is None):
        raise AssertionError(f"{name}: cuda:hopper:aot built no library ({job.unsupported})")
    for wrapper in cuda_backend.WRAPPERS.values():
        wrapper.launches = 0
    built, runs = bridge.variants_built, cuda_backend.nvcc_runs
    op(*args, out=out, offset_provider=ndefs.PROV_K, **kwargs)
    if on_card:
        torch.cuda.synchronize()
    builds = (bridge.variants_built - built, cuda_backend.nvcc_runs - runs)
    counts = {k: w.launches for k, w in cuda_backend.WRAPPERS.items() if w.launches}
    kernel = job.lowered_stage.strategy
    expected = {kernel: len(job.lowered_stage.module.launchers)} if on_card else {}
    if builds != (0, 0) or counts != expected:
        raise AssertionError(f"{name} aot: first call built {builds} (variants, nvcc), "
                             f"launched {counts}, not {expected}")
    _, _, want = ndefs.inputs(name, *shape, np.dtype(np.float32), 7, device)
    getattr(ndefs, name).with_backend("cuda:hopper")(
        *args, out=want, offset_provider=ndefs.PROV_K, **kwargs)
    if on_card:
        torch.cuda.synchronize()
    if not same_bits(out.ndarray.contiguous(), want.ndarray.contiguous()):
        raise AssertionError(f"{name} aot: differs from cuda:hopper")
    return {"name": name, "kernel": kernel, "seconds": seconds, "compile_nvcc": compile_nvcc,
            "cost": job.compiled_stage.cost_analysis(), "launches": counts.get(kernel, 0),
            "args": (args, kwargs, out)}


def sass_class_counts(text: str) -> dict:
    """SASS instructions by class (:func:`sass_class`) in a
    ``cuobjdump -sass`` listing."""
    import re

    counts: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text):
        op = m.group(1).split(".")[0]
        if op != "NOP":
            counts[sass_class(op)] = counts.get(sass_class(op), 0) + 1
    return counts


def run_nabla(n: int, ndefs, torch, device="cuda") -> dict:
    """FVM nabla (``ndefs.nabla_x``) in float32 on ``periodic_quad_mesh(n)``:
    the ``torch`` backend with card fields against ``numpy`` on the host,
    rtol 1e-5 with atol 1e-6 (a vertex's signed sum of edge terms of about
    0.5 cancels towards 0); ms a call by CUDA events over 20 calls, and the
    ``numpy`` ms a call by the host clock (``device="cpu"``: the host
    clock for both, a rehearsal)."""
    import numpy as np

    args, provider, out = ndefs.nabla_inputs(n, np.float32, 11, device)
    call = lambda: ndefs.nabla_x(*args, out=out, offset_provider=provider)  # noqa: E731
    call()
    calls = 20
    if device == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / calls
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        ms = (time.perf_counter() - t0) / calls * 1e3
    hargs, hprovider, hout = ndefs.nabla_inputs(n, np.float32, 11, "cpu")
    t0 = time.perf_counter()
    ndefs.nabla_x.with_backend("numpy")(*hargs, out=hout, offset_provider=hprovider)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    got, want = out.asnumpy(), hout.asnumpy()
    err = float(np.abs(got.astype(np.float64) - want).max())
    if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"nabla at {n * n} vertices: card and numpy differ ({err})")
    return {"vertices": n * n, "ms": ms, "numpy_ms": numpy_ms, "max_abs_err": err}


# -- the oracle and profiler phases ----------------------------------------------


def check_debug(run, gtscript, storage, np, torch) -> float:
    """The main path's kernel at DEBUG_DOMAIN against the per-point
    ``debug`` backend on the host, one call each from the same inputs,
    within RTOL and ATOL; returns the largest absolute difference."""
    case, dtype = run["case"], run["dtype"]
    ni, nj, nk = DEBUG_DOMAIN
    if case["name"] == "hdiff":
        shape, origin = (ni + 2 * HALO, nj + 2 * HALO, nk), (HALO, HALO, 0)
    else:  # vadv reads wcon at i + 1
        shape, origin = (ni + (case["name"] == "vadv"), nj, nk), (0, 0, 0)
    host = {n: in_dtype(v, dtype) for n, v in make_host(case, shape, 11, np).items()}
    debug = build_stencil(gtscript, case["definition"], "debug", dtype, case["externals"])
    kern = card_fields(host, origin, case, storage)
    oracle = card_fields(host, origin, case, storage, "debug")
    run["kern"](**kern, **run["scalars"], domain=DEBUG_DOMAIN)
    debug(**oracle, **run["scalars"], domain=DEBUG_DOMAIN)
    torch.cuda.synchronize()
    err = 0.0
    for n in case["fields"]:
        got, want = np.asarray(kern[n]), np.asarray(oracle[n])
        err = max(err, float(np.max(np.abs(got - want))))
        if not np.allclose(got, want, rtol=RTOL[dtype], atol=ATOL[dtype]):
            raise AssertionError(f"{case['name']} {dtype}: kernel disagrees with the debug "
                                 f"backend in {n} (max abs err {err})")
    return err


def run_host_backends(run, gtscript, storage, np, torch) -> dict:
    """The main path at full width on the ``numpy`` and ``cpu:c`` backends,
    from its inputs: each equal to one kernel call within RTOL (float64:
    1e-12); their ms a call by the host clock, the mean of two calls after
    a first one (which builds the C library)."""
    case, domain, origin = run["case"], (NI, NJ, NK), (HALO, HALO, 0)
    kern = card_fields(run["host"], origin, case, storage)
    run["kern"](**kern, **run["scalars"], domain=domain)
    torch.cuda.synchronize()
    out = {}
    for backend in ("numpy", "cpu:c"):
        st = build_stencil(gtscript, case["definition"], backend, run["dtype"], case["externals"])
        fields = card_fields(run["host"], origin, case, storage, backend)
        call = lambda: st(**fields, **run["scalars"], domain=domain)  # noqa: E731
        call()
        err = 0.0
        for n in case["fields"]:
            got, want = kern[n].array.cpu().numpy(), np.asarray(fields[n])
            err = max(err, float(np.max(np.abs(got - want))))
            if not np.allclose(got, want, rtol=RTOL[run["dtype"]], atol=ATOL[run["dtype"]]):
                raise AssertionError(f"{case['name']} {run['dtype']}: the kernel disagrees "
                                     f"with the {backend} backend in {n} (max abs err {err})")
        t0 = time.perf_counter()
        for _ in range(2):
            call()
        out[backend] = {"ms": (time.perf_counter() - t0) / 2 * 1e3, "max_abs_err": err,
                        "path": getattr(st._backend, "last_path", backend)}
    if out["cpu:c"]["path"] != "c":
        raise AssertionError(f"{case['name']}: cpu:c ran {out['cpu:c']['path']}, not C")
    return out


def expected_device_work(module) -> dict:
    """What one call of a stencil on ``cuda:hopper`` runs on the card: its
    generated kernels (one a launcher), the temporaries its wrapper zeroes
    and the cooperative launches' level counters (fills), and the snapshots
    it copies (copies)."""
    fills = sum(1 for m in module.slots if m.is_temp and m.snapshot_of is None and m.fill)
    copies = sum(
        1 for m in module.slots if m.snapshot_of is not None
        for fields in module.snapshots.values() if m.snapshot_of in fields
    )
    return {"generated": len(module.launchers), "fills": fills + len(module.cooperative),
            "copies": copies, "other": []}


def is_generated(name: str) -> bool:
    """A kernel of the port's generated sources (``gt_plane_0_r(...)``)."""
    import re

    return re.match(r"gt_[A-Za-z0-9_]+", name) is not None


def device_work(events) -> dict:
    """The device work of a Chrome trace's events, as
    :func:`expected_device_work` counts it; ``other`` names the rest."""
    work = {"generated": 0, "fills": 0, "copies": 0, "other": []}
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat == "kernel" and is_generated(name):
            work["generated"] += 1
        elif cat == "gpu_memset" or "FillFunctor" in name:
            work["fills"] += 1
        elif cat == "gpu_memcpy":
            work["copies"] += 1
        else:
            work["other"].append(name)
    return work


def launch_splits(events, tag: str) -> list:
    """From a trace, for each call annotated ``tag`` in order: its host µs
    (``call_us``), from its start to the launch of its first generated
    kernel (``to_launch_us``: the launch call within the call whose
    correlation id is a generated kernel's; None where the trace holds no
    launch call for it), the launch call's own µs and API, and the
    kernel's device µs."""
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and is_generated(e["name"])
               and "correlation" in e.get("args", {})}
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e.get("args", {}).get("correlation") in kernels),
                      key=lambda e: e["ts"])
    out = []
    for call in sorted((e for e in events
                        if e.get("cat") == "user_annotation" and e.get("name") == tag),
                       key=lambda e: e["ts"]):
        launch = next((e for e in launches
                       if call["ts"] <= e["ts"] <= call["ts"] + call["dur"]), None)
        out.append({
            "call_us": float(call["dur"]),
            "to_launch_us": None if launch is None else float(launch["ts"] - call["ts"]),
            "launch_us": None if launch is None else float(launch["dur"]),
            "launch_api": None if launch is None else launch["name"],
            "kernel_us": None if launch is None
            else float(kernels[launch["args"]["correlation"]]["dur"]),
        })
    return out


def trace_warm_call(call, module, tag: str, cuda_backend, torch, n: int = 5) -> dict:
    """``n`` warm calls under ``gpu_trace``, each annotated ``tag``, counted:
    the trace's device work must be exactly ``n`` times
    :func:`expected_device_work` (no kernel of the plain version, nothing
    else), each generated kernel launched once a call. Returns each call's
    :func:`launch_splits`, the median of all but the first (which carries
    the profiler's start-up), the device work and the trace's path."""
    from gt4py_tpu_torch.instrumentation import gpu_trace

    call()
    call()
    torch.cuda.synchronize()
    for wrapper in cuda_backend.WRAPPERS.values():
        wrapper.launches = 0
    with gpu_trace() as prof:
        for _ in range(n):
            with torch.profiler.record_function(tag):
                call()
        torch.cuda.synchronize()
    launched = sum(w.launches for w in cuda_backend.WRAPPERS.values())
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    found, one = device_work(events), expected_device_work(module)
    expected = {k: v * n for k, v in one.items() if k != "other"}
    expected["other"] = []
    if found != expected or launched != expected["generated"]:
        raise AssertionError(f"{tag}: the trace's device work {found} (launches counted: "
                             f"{launched}) is not {n} calls' {expected}")
    splits = launch_splits(events, tag)
    if len(splits) != n:
        raise AssertionError(f"{tag}: {len(splits)} annotated calls in the trace, not {n}")
    later = splits[1:]

    def median(key):
        values = sorted(s[key] for s in later if s[key] is not None)
        return values[len(values) // 2] if values else None

    return {"splits": splits, "call_us": median("call_us"),
            "to_launch_us": median("to_launch_us"), "launch_us": median("launch_us"),
            "launch_api": later[-1]["launch_api"], "kernel_us": median("kernel_us"),
            "work": one, "trace": prof.trace_path}


# -- the examples phase (step 10) ------------------------------------------------


class Recorder:
    """A stencil or field operator that keeps the arguments of its last
    call, so that call can be replayed on the same card buffers for its
    device time and its plain version's; the kernel launches its calls
    made (the wrappers' counts before and after each call); and the host
    clock at the start of each call."""

    def __init__(self, target):
        self.target, self.last, self.launches, self.started = target, None, 0, []

    def __call__(self, *args, **kwargs):
        from gt4py_tpu_torch.cartesian.backend import cuda_backend

        self.started.append(time.perf_counter())
        self.last = (args, kwargs)
        before = sum(w.launches for w in cuda_backend.WRAPPERS.values())
        value = self.target(*args, **kwargs)
        self.launches += sum(w.launches for w in cuda_backend.WRAPPERS.values()) - before
        return value

    def __getattr__(self, name):
        return getattr(self.target, name)


def launchers(obj) -> int:
    """Launches one call of a stencil (or a bridged operator's variant) asks of its kernel."""
    backend = obj._backend if hasattr(obj, "_backend") else bridged_variant(obj).backend
    return len(backend.module.launchers)


def prepare_examples() -> dict:
    """Step 1's part of the examples phase: each kernel example's stencils
    and operators built for ``cuda:hopper`` at the sizes step 10 runs, each
    bridged operator's variant traced by one call on CPU fields of 8 × 8
    and the full K (a variant is keyed by dims, dtypes and the out K range,
    not by I and J); returns them and the kernel sources to build."""
    import numpy as np

    from gt4py_tpu_torch.examples import (
        burgers, custom_backend, implicit_vertical_diffusion, isentropic_diagnostics,
        lap_cartesian_vs_next, tridiagonal_solver, typed_operators)

    ex: dict = {"tridiag": tridiagonal_solver.make_stencils("cuda:hopper")}
    ex["lap"] = {}
    for shape in EX_LAP:
        st, op = lap_cartesian_vs_next.make_stencils("cuda:hopper")
        lap_cartesian_vs_next.main("cuda:hopper", "cpu", (8, 8, shape[2]),
                                   np.random.default_rng(0).random((8, 8, shape[2])), (st, op))
        ex["lap"][shape] = (st, op)
    ex["burgers"] = burgers.make_stencils("cuda:hopper")
    ex["isentropic"] = isentropic_diagnostics.make_diagnostics("cuda:hopper")
    with fusion_switch(True):
        ex["isentropic_switch_on"] = isentropic_diagnostics.make_diagnostics("cuda:hopper")
    ex["implicit"] = {}
    for shape in EX_IMPLICIT:
        _, op, _ = implicit_vertical_diffusion.solve("cuda:hopper", "cpu", (8, 8, shape[2]))
        ex["implicit"][shape] = op
    typed = bridged_variant(typed_operators.main("cuda:hopper", "cpu")["op"])
    shown = custom_backend.main("cuda:hopper", "cpu")
    ex["custom"] = shown["op"]
    ex["typed"] = (typed.backend.strategy, len(typed.backend.module.launchers))
    stencils = [ex["tridiag"], *(st for st, _ in ex["lap"].values()), *ex["burgers"],
                ex["isentropic"], ex["isentropic_switch_on"]]
    variants = [bridged_variant(op) for _, op in ex["lap"].values()]
    variants += [bridged_variant(op) for op in ex["implicit"].values()]
    variants += [typed, bridged_variant(shown["op"]), shown["job"].traced_stage.variant]
    ex["backends"] = [s._backend for s in stencils] + [v.backend for v in variants]
    return ex


def counted(work, cuda_backend, sync):
    """(``work()``'s value, the launches it made by kernel, its wall
    seconds to ``sync()``): the counts set to 0 just before, read just after."""
    for wrapper in cuda_backend.WRAPPERS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    value = work()
    sync()
    wall = time.perf_counter() - t0
    return value, {k: w.launches for k, w in cuda_backend.WRAPPERS.items() if w.launches}, wall


def expect_launches(tag: str, counts: dict, expected: dict) -> None:
    if {k: n for k, n in counts.items() if n} != {k: n for k, n in expected.items() if n}:
        raise AssertionError(f"example {tag}: launches {counts}, not {expected}")


def replay_ms(rec, n: int, tag: str) -> float:
    """Device ms a call of the recorded call, ``n`` calls behind a spin kernel."""
    args, kwargs = rec.last
    rec.target(*args, **kwargs)
    return spin_ms(lambda: [rec.target(*args, **kwargs) for _ in range(n)], n, tag)


def events_ms(work, n: int) -> float:
    """ms a call of ``work()``, ``n`` calls between two CUDA events after
    one call to warm it (host included)."""
    import torch

    work()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        work()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def example_row(tag, kernel, rec, plain, domain, dtype, asked, err, as_st=None) -> dict:
    """One stencil or operator of an example as a line of the ``kernels``
    JSON: the launches its calls made in the example's run (raises unless
    they are the ``asked`` ones), its device ms behind a spin kernel (the
    recorded call replayed), its plain version's ms on the same card
    buffers (CUDA events), and its bound: compulsory bytes over the H100's
    rate or operations over its peak."""
    expect_launches(tag, {kernel: rec.launches}, {kernel: asked})
    args, kwargs = rec.last
    ms = replay_ms(rec, EX_TIMED_CALLS, tag)
    plain_ms = events_ms(lambda: plain(*args, **kwargs), EX_PLAIN_CALLS)
    st = as_st or rec.target
    nbytes, flops = compulsory_bytes(st, 0, domain), operations(st, domain)
    bound_ms, bound_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (flops / PEAK_FLOPS[dtype] * 1e3, "operations"))
    return {"name": f"{kernel}/example_{tag}/{dtype}", "route": "cuda", "entry": "example",
            "source": SOURCE, "replaces": REPLACES[kernel], "launches": rec.launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "domain": list(domain)}


def agree(got, want, tag: str) -> float:
    """:func:`same_within` of an example's outputs, as host arrays, and the
    numpy backend's, within EX_TOL; raises too where an output is not finite."""
    import numpy as np

    got, want = [np.asarray(a) for a in got], [np.asarray(b) for b in want]
    if not all(np.isfinite(a).all() for a in got):
        raise AssertionError(f"example {tag}: an output is not finite")
    try:
        return same_within(got, want, EX_TOL)
    except AssertionError as e:
        raise AssertionError(f"example {tag}: the card disagrees with the numpy backend: {e}")


def run_examples(ex, cuda_backend, torch, device="cuda") -> list:
    """Step 10: examples 1-8 of gt4py_tpu_torch/examples/ on card storages and
    fields at the full widths, each counted (launches by kernel equal to
    what the example asked, and each stencil's or operator's own launches,
    as its :class:`Recorder` measured them, equal to what it asked) and
    held against the port's ``numpy`` backend (or the field-view ``numpy``
    oracle) run on the host from the same inputs, within EX_TOL. Prints
    each one's wall seconds and device µs a call; returns the kernels' rows.
    ``device="cpu"`` rehearses the phase on CPU tensors (the plain version)."""
    import numpy as np

    from gt4py_tpu_torch.examples import (
        burgers, custom_backend, implicit_vertical_diffusion, isentropic_diagnostics,
        lap_cartesian_vs_next, shallow_water, tridiagonal_solver, typed_operators)

    rows: list = []
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    count = functools.partial(counted, cuda_backend=cuda_backend, sync=sync)

    def report(tag, wall, counts, err, extra=""):
        print(f"  {tag:34s} wall {wall:8.3f} s  launches {counts}  max abs err against "
              f"numpy {err:.3e}{extra}")

    # 1. tridiagonal_solver, float32: its full width and its own size
    for shape in EX_TRIDIAG:
        rec = Recorder(ex["tridiag"])
        got, counts, wall = count(
            lambda: tridiagonal_solver.main("cuda:hopper", device, shape, rec))
        expect_launches(f"tridiagonal_solver {shape}", counts, {"column": launchers(rec)})
        err = agree([got], [tridiagonal_solver.main("numpy", None, shape)], "tridiagonal_solver")
        row = example_row(f"tridiagonal_solver_{'x'.join(map(str, shape))}", "column", rec,
                          tridiagonal_solver.make_stencils("torch"), shape, "float32",
                          launchers(rec), err)
        rows.append(row)
        report(f"tridiagonal_solver {shape}", wall, counts, err,
               f"  device {row['ms'] * 1e3:.1f} us a call")

    # 2. lap_cartesian_vs_next, float64: the stencil and the bridged operator
    for shape in EX_LAP:
        st, op = (Recorder(t) for t in ex["lap"][shape])
        data = np.random.default_rng(0).random(shape)
        got, counts, wall = count(
            lambda: lap_cartesian_vs_next.main("cuda:hopper", device, shape, data, (st, op)),)
        expect_launches(f"lap {shape}", counts, {"plane": launchers(st) + launchers(op.target)})
        want = lap_cartesian_vs_next.main("numpy", None, shape, data)
        err = agree(got[:2], want[:2], "lap_cartesian_vs_next")
        dom = (shape[0] - 2, shape[1] - 2, shape[2])
        size = "x".join(map(str, shape))
        plain_st, plain_op = lap_cartesian_vs_next.make_stencils("torch")
        rows.append(example_row(f"lap_cartesian_{size}", "plane", st, plain_st, dom, "float64",
                                launchers(st), err))
        rows.append(example_row(f"lap_next_{size}", "plane", op, plain_op, dom, "float64",
                                launchers(op.target), err, as_stencil(bridged_variant(op.target))))
        report(f"lap_cartesian_vs_next {shape}", wall, counts, err,
               f"  device {rows[-2]['ms'] * 1e3:.1f} (stencil), {rows[-1]['ms'] * 1e3:.1f} "
               "(field view) us a call")

    # 3. burgers, float64: factor 5 (321 x 321 x 1), 100 RK3 steps
    factor, niter = EX_BURGERS
    rk, copy2 = (Recorder(t) for t in ex["burgers"])
    got, counts, wall = count(
        lambda: burgers.run("cuda:hopper", factor, niter, False, device, (rk, copy2)))
    expect_launches("burgers", counts,
                    {"plane": niter * (launchers(copy2) + 3 * launchers(rk))})
    err = agree(got[2:], burgers.run("numpy", factor, niter, False)[2:], "burgers")
    if not (got[0] < ZHAO_BOUND and got[1] < ZHAO_BOUND):
        raise AssertionError(f"example burgers: error against Zhao {got[:2]} above {ZHAO_BOUND}")
    n = 10 * 2**factor + 1
    plain_rk, plain_copy = burgers.make_stencils("torch")
    rows.append(example_row("burgers_rk_stage", "plane", rk, plain_rk, (n - 6, n - 6, 1),
                            "float64", 3 * niter * launchers(rk), err))
    rows.append(example_row("burgers_copy2", "plane", copy2, plain_copy, (n, n, 1), "float64",
                            niter * launchers(copy2), err))
    # an RK step on the host clock: from one step's copy2 call to the next one's
    step_us = (copy2.started[-1] - copy2.started[0]) / (niter - 1) * 1e6
    dev_us = (3 * rows[-2]["ms"] + rows[-1]["ms"]) * 1e3
    report(f"burgers factor {factor} ({n}x{n}x1), {niter} steps", wall, counts, err,
           f"; ||u-uex|| {got[0]:.3e}, ||v-vex|| {got[1]:.3e} (bound {ZHAO_BOUND}); an RK step "
           f"{step_us:.1f} us on the host clock (3 apply_bc round trips included), its kernels "
           f"{dev_us:.1f} us on the device (rk_stage {rows[-2]['ms'] * 1e3:.1f}, copy2 "
           f"{rows[-1]['ms'] * 1e3:.1f} a call)")

    # 4. isentropic_diagnostics, float64: 256 x 256 x 81 fields, switch off and on
    nx, ny, nz = EX_ISENTROPIC
    want_stor = isentropic_diagnostics.run("numpy", nx, ny, nz, False)[1]
    fields = ("p", "exn", "mtg", "h")
    plain_isentropic = isentropic_diagnostics.make_diagnostics("torch")
    for key in ("isentropic", "isentropic_switch_on"):
        step = Recorder(ex[key])
        kernel = step._backend.strategy
        (errs, stor), counts, wall = count(
            lambda: isentropic_diagnostics.run("cuda:hopper", nx, ny, nz, False, device, step),)
        expect_launches(key, counts, {kernel: launchers(step)})
        err = agree([stor[k] for k in fields], [want_stor[k] for k in fields], key)
        rows.append(example_row(key.replace("isentropic", "isentropic_diagnostics"), kernel, step,
                                plain_isentropic, (nx, ny, nz + 1), "float64", launchers(step),
                                err))
        report(f"{key} ({nx}x{ny}x{nz + 1}) on {kernel}", wall, counts, err,
               f"; rel errors against the example's NumPy oracle "
               f"{max(errs.values()):.2e}; device {rows[-1]['ms'] * 1e3:.1f} us a call")

    # 5. implicit_vertical_diffusion, float64: full width against the field-view
    #    numpy oracle; its own size also against the dense solve (main)
    for shape in EX_IMPLICIT:
        op = Recorder(ex["implicit"][shape])
        entry = implicit_vertical_diffusion.main if shape == EX_IMPLICIT[-1] else (
            implicit_vertical_diffusion.solve)
        (got, _, strategy), counts, wall = count(lambda: entry("cuda:hopper", device, shape, op))
        variant = bridged_variant(op.target)
        expect_launches(f"implicit {shape}", counts, {"column": launchers(op.target)})
        ran = "column" if device == "cuda" else "plain"  # what last_strategy reads
        if strategy != ran or variant.backend.strategy != "column":
            raise AssertionError(f"example implicit {shape}: served by {strategy}")
        want = implicit_vertical_diffusion.solve("numpy", None, shape)[0]
        err = agree([got], [want], "implicit_vertical_diffusion")
        rows.append(example_row(f"implicit_vertical_diffusion_{'x'.join(map(str, shape))}",
                                "column", op, op.target.with_backend("torch"), shape, "float64",
                                launchers(op.target), err, as_stencil(variant)))
        report(f"implicit_vertical_diffusion {shape}", wall, counts, err,
               f"  device {rows[-1]['ms'] * 1e3:.1f} us a call")

    # 6. shallow_water: staggered, embedded on card tensors (no kernel)
    got, counts, wall = count(lambda: shallow_water.main("cuda:hopper", device))
    expect_launches("shallow_water", counts, {})
    err = agree(got, shallow_water.main("numpy"), "shallow_water")
    report("shallow_water (n 64, 50 steps)", wall, counts, err, "  embedded on the card")

    # 7. typed_operators: the rejections before any trace; the laplacian bridged
    got, counts, wall = count(lambda: typed_operators.main("cuda:hopper", device))
    want = typed_operators.main("numpy")
    texts = ("signature", "rejected", "decoration")
    if [got[k] for k in texts] != [want[k] for k in texts]:
        raise AssertionError(f"example typed_operators: {got} against {want}")
    expect_launches("typed_operators", counts, {ex["typed"][0]: ex["typed"][1]})
    err = agree([got["out"]], [want["out"]], "typed_operators")
    report("typed_operators", wall, counts, err, f"; rejected: {got['rejected']!r}")

    # 8. custom_backend: the rewriting and eager backends embedded, the AOT job and
    #    cuda:hopper through the bridge
    op = Recorder(ex["custom"])
    shown, counts, wall = count(lambda: custom_backend.main("cuda:hopper", device, stencils=op))
    variant = bridged_variant(op.target)
    kernel = variant.backend.strategy
    expect_launches("custom_backend", counts,
                    {kernel: launchers(op.target) + len(
                        shown["job"].traced_stage.variant.backend.module.launchers)})
    keys = ("rewritten", "aot", "eager", "backend")
    want = custom_backend.main("numpy")
    err = agree([shown[k] for k in keys], [want[k] for k in keys], "custom_backend")
    rows.append(example_row("custom_backend_smooth", kernel, op, op.target.with_backend("torch"),
                            (shown["phi"].shape[0], 1, 1), "float64", launchers(op.target), err,
                            as_stencil(variant)))
    report(f"custom_backend on {kernel}", wall, counts, err,
           f"; ptxas of the AOT job: {shown['job'].compiled_stage.cost_analysis()}")
    return rows


# -- the distributed phase (step 11) ----------------------------------------------


def distributed_cases(runs) -> list:
    """Step 11's cases over the main paths' stencils (built in step 1): hdiff
    (``plane``) under periodic, clamp and zero boundaries, vadv and tridiag
    (``column``), vadv with the switch on (``fused_column``), each in
    float32 and float64 on DIST_DOMAIN; hdiff float32 periodic on the uneven
    DIST_UNEVEN (pad and trim)."""
    by = {(r["case"]["name"], r["dtype"]): r for r in runs}
    cases = []
    for dtype in ("float32", "float64"):
        for boundary in ("periodic", "clamp", "zero"):
            cases.append({"run": by[("hdiff", dtype)], "boundary": boundary,
                          "domain": DIST_DOMAIN, "tag": f"hdiff_{boundary}"})
        for name in ("vadv", "tridiag", "vadv_fused"):
            cases.append({"run": by[(name, dtype)], "boundary": "periodic",
                          "domain": DIST_DOMAIN, "tag": name})
    cases.append({"run": by[("hdiff", "float32")], "boundary": "periodic",
                  "domain": DIST_UNEVEN, "tag": "hdiff_uneven"})
    return cases


def prepare_distributed() -> dict:
    """Step 1's part of the distributed phase: the distributed_hdiff
    example's stencil and operator for ``cuda:hopper``, the operator's
    bridged variant traced by one run on four CPU shards of 8 × 8 × 8."""
    import torch

    from gt4py_tpu_torch.examples import distributed_hdiff

    st, op = distributed_hdiff.make_stencils("cuda:hopper")
    with contextlib.redirect_stdout(None):
        distributed_hdiff.main("cuda:hopper", [torch.device("cpu")] * DIST_SHARDS, (8, 8, 8),
                               (st, op))
    return {"st": st, "op": op, "plain": distributed_hdiff.make_stencils("torch")[0],
            "backends": [st._backend, bridged_variant(op).backend]}


def host_us(work, n: int, torch, device) -> float:
    """Host µs of one ``work()``, ``n`` calls queued behind a spin kernel so
    that none waits for the card (the host clock alone on the CPU)."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~100 ms at the H100's clocks
        ended = torch.cuda.Event()
        ended.record()
    t0 = time.perf_counter()
    for _ in range(n):
        work()
    host = (time.perf_counter() - t0) / n
    if device == "cuda":
        if ended.query():
            raise AssertionError("the host was still queuing when the spin kernel ended")
        torch.cuda.synchronize()
    return host * 1e6


def synced_us(work, n: int, torch, device) -> float:
    """µs of ``work()`` to a synchronised card, mean of ``n`` calls after
    one to warm it (the host clock)."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    work()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        work()
        sync()
    return (time.perf_counter() - t0) / n * 1e6


def padded_host(v, boundary, np):
    """A global host array extended by HALO along I and J the way the
    boundary condition extends the domain: wrapped, edge or zeros."""
    mode = {"periodic": "wrap", "clamp": "edge", "zero": "constant"}[boundary]
    return np.pad(v, ((HALO, HALO), (HALO, HALO), (0, 0)), mode=mode)


def run_distributed_case(c, mesh, storage, cuda_backend, np, torch, device="cuda") -> dict:
    """One case of step 11: ``DistributedStencil`` over ``mesh`` on global
    tensors, counted (each shard's launches of the case's kernel, and no
    other kernel), equal to the single-card stencil on the same data read
    from a storage extended by the boundary condition (to the bit, or
    raises) and to the plain version on the same mesh (RTOL/ATOL); then
    device ms per step of DIST_CALLS chained ``apply``s on sharded arrays
    behind a spin kernel, the exchange's and the shards' kernels' apart, a
    warm ``apply``'s host µs, and the scatter and gather µs of a global
    call; returns the case's row of the ``kernels`` line."""
    from gt4py_tpu_torch.parallel import DistributedStencil

    run, case, dtype = c["run"], c["run"]["case"], c["run"]["dtype"]
    kern, kernel, domain = run["kern"], case["kernel"], c["domain"]
    tag = f"{c['tag']} {dtype} {'x'.join(map(str, domain))}"
    host = {n: in_dtype(v, dtype) for n, v in c["host"].items()}
    scalars = run["scalars"]
    # global tensors: only read (a written field given so comes back in new buffers)
    fields = {n: torch.from_numpy(v).to(device) for n, v in host.items()}
    dist = DistributedStencil(kern, mesh, boundary=c["boundary"])
    if device == "cuda":
        torch.cuda.synchronize()
    out, counts, _ = counted(lambda: dist.apply(**fields, **scalars), cuda_backend,
                             torch.cuda.synchronize if device == "cuda" else (lambda: None))
    asked = len(mesh.devices) * len(kern._backend.module.launchers)
    expect_launches(f"distributed {tag}", counts, {kernel: asked})
    if set(dist.last_strategy) != {kernel if device == "cuda" else "plain"}:
        raise AssertionError(f"distributed {tag}: shards served by {dist.last_strategy}")

    # the single-card stencil on the same data, its halo extended as the boundary says
    single = {n: storage.from_array(padded_host(v, c["boundary"], np), backend="cuda:hopper",
                                    aligned_index=(HALO, HALO, 0), device=device)
              for n, v in host.items()}
    kern(**single, **scalars, domain=domain)
    err, bits = 0.0, True
    for n, got in out.items():
        g = got.assemble()
        w = single[n].array[HALO:HALO + domain[0], HALO:HALO + domain[1]]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"distributed {tag}: non-finite values in {n}")
        bits = bits and same_bits(g, w)
        err = max(err, float((g.double() - w.double()).abs().max()))
    if not bits:
        raise AssertionError(
            f"distributed {tag}: differs from the single-card stencil (max abs err {err})")

    # the plain version (the torch backend) on the same mesh and data
    plain = DistributedStencil(run["plain"], mesh, boundary=c["boundary"])
    pout = plain.apply(**fields, **scalars)
    for n, got in out.items():
        if not torch.allclose(got.assemble(), pout[n].assemble(), rtol=RTOL[dtype],
                              atol=ATOL[dtype]):
            raise AssertionError(f"distributed {tag}: kernel and plain version differ in {n}")
    plain_ms = events_ms(lambda: plain.apply(**fields, **scalars), 2) if device == "cuda" else 0.0

    # chained steps on sharded arrays: nothing scattered or gathered
    step = dist.prepare(**fields, **scalars)
    arrays = {n: step.sharded(n) for n in host}
    swap = case["swap"]

    def chain(n):
        a = dict(arrays)
        for _ in range(n):
            dist.apply(**a, **scalars)
            a = {r: a[swap.get(r, r)] for r in a}

    chain(2)
    ms = spin_ms(lambda: chain(DIST_CALLS), DIST_CALLS, tag)
    bound_step = dist.prepare(**arrays, **scalars)
    exchange_ms = spin_ms(lambda: [bound_step.exchange() for _ in range(DIST_CALLS)],
                          DIST_CALLS, tag)
    compute_ms = spin_ms(lambda: [bound_step.compute() for _ in range(DIST_CALLS)],
                         DIST_CALLS, tag)
    call_us = host_us(lambda: dist.apply(**arrays, **scalars), DIST_CALLS, torch, device)
    scatter_us = synced_us(lambda: dist.prepare(**fields, **scalars), 3, torch, device)
    result = next(iter(out.values()))
    gather_us = synced_us(lambda: result.assemble(), 3, torch, device)

    itemsize = ITEMSIZE[dtype]
    slabs = dist.exchange_plan(**fields)
    slab_bytes = sum(int(np.prod(t["slab"])) for t in slabs) * itemsize
    nbytes = compulsory_bytes(kern, itemsize, domain) + slab_bytes
    flops = operations(kern, domain)
    bound_ms, bound_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (flops / PEAK_FLOPS[dtype] * 1e3, "operations"))
    return {
        "name": f"{kernel}/distributed_{c['tag']}/{dtype}", "route": "cuda",
        "entry": "distributed", "source": SOURCE, "replaces": REPLACES[kernel],
        "launches": counts.get(kernel, 0), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "exchange_ms": exchange_ms, "compute_ms": compute_ms,
        "four_single_shard_ms": len(mesh.devices) * run["device_ms"],
        "same_bits_as_single_card": bits, "call_host_us": call_us, "scatter_us": scatter_us,
        "gather_us": gather_us, "slabs": len(slabs), "slab_bytes": slab_bytes,
        "boundary": c["boundary"], "domain": list(domain), "mesh": list(mesh.shape),
    }


def shard_step_ms(run, block, storage, device="cuda") -> float:
    """ms per step that one shard's work holds the card: the single-card
    stencil chained DIST_CALLS times on a ``block`` with HALO around it in
    I and J (:func:`spin_ms`), as section 4's ``device_ms`` reads the main
    path at (NI, NJ, NK)."""
    import numpy as np

    case = run["case"]
    shape = (block[0] + 2 * HALO, block[1] + 2 * HALO, block[2])
    fields = {n: storage.from_array(in_dtype(v, run["dtype"]), backend="cuda:hopper",
                                    aligned_index=(HALO, HALO, 0), device=device)
              for n, v in make_host(case, shape, 0, np).items()}
    kw = dict(swap=case["swap"], domain=tuple(block))
    run["kern"].chain(DIST_CALLS, **fields, **run["scalars"], **kw)
    return spin_ms(lambda: run["kern"].chain(DIST_CALLS, **fields, **run["scalars"], **kw),
                   DIST_CALLS, f"one shard of {case['name']}")


def edge_midpoints(n: int, np):
    """Coordinates of ``periodic_quad_mesh(n)``'s edges: h(i, j) at
    (i + 1/2, j), then v(i, j) at (i, j + 1/2)."""
    i, j = np.divmod(np.arange(n * n, dtype=np.float64), n)
    return np.concatenate([np.stack([i + 0.5, j], 1), np.stack([i, j + 0.5], 1)])


def run_distributed_nabla(n: int, single_ms, ndefs, torch, device="cuda") -> dict:
    """FVM nabla at n × n vertices through ``DistributedUnstructured`` over
    DIST_SHARDS shards of one device, the edges renumbered by
    ``spatial_renumbering`` of their midpoints: equal to the single-device
    embedded nabla (rtol 1e-5, atol 1e-6), ms a call by CUDA events, and
    the slabs one call moves (none may be a shard's whole block)."""
    import numpy as np

    from gt4py_tpu_torch.next.mesh_utils import Renumbering, spatial_renumbering
    from gt4py_tpu_torch.parallel import DistributedUnstructured

    args, provider, out = ndefs.nabla_inputs(n, np.float32, 11, device)
    ndefs.nabla_x(*args, out=out, offset_provider=provider)
    nv = n * n
    t0 = time.perf_counter()
    dist = DistributedUnstructured(
        ndefs.nabla_x, offset_provider=provider, sizes={ndefs.Vertex: nv, ndefs.Edge: 2 * nv},
        mesh=[torch.device(device)] * DIST_SHARDS,
        renumberings=[Renumbering(ndefs.Edge, spatial_renumbering(edge_midpoints(n, np)))],
    )
    plan_s = time.perf_counter() - t0
    got = dist(*args)
    g, w = got.asnumpy(), out.asnumpy()
    err = float(np.abs(g.astype(np.float64) - w).max())
    if not np.allclose(g, w, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"distributed nabla at {nv} vertices: differs from one device ({err})")
    owned = {"E2V": nv // DIST_SHARDS, "V2E": 2 * nv // DIST_SHARDS}
    slabs = dist.last_exchange
    if not slabs or any(t["slab"][0] >= owned[t["table"]] for t in slabs):
        raise AssertionError(f"distributed nabla: a shard received a whole block: {slabs}")
    ms = events_ms(lambda: dist(*args), 5) if device == "cuda" else 0.0
    return {"vertices": nv, "ms": ms, "single_ms": single_ms, "max_abs_err": err,
            "same_bits": bool(np.array_equal(g, w)), "plan_s": plan_s, "slabs": len(slabs),
            "slab_rows": sorted({t["slab"][0] for t in slabs}), "owned": owned}


def run_distributed(runs, dex, nablas, ndefs, storage, cuda_backend, torch, smi,
                    device="cuda") -> list:
    """Step 11: the distributed path on DIST_SHARDS shards of one card (a
    2 × 2 mesh of ``[cuda:0] * 4``), each shard at the main path's full
    width; then the ring FVM nabla and the distributed_hdiff example.
    Prints each case; returns the rows of the ``kernels`` line."""
    import numpy as np

    from gt4py_tpu_torch.examples import distributed_hdiff
    from gt4py_tpu_torch.parallel import CartesianMesh

    t0 = time.perf_counter()
    devices = [torch.device(device, 0) if device == "cuda" else torch.device(device)]
    mesh = CartesianMesh(devices * DIST_SHARDS)
    hosts: dict = {}
    rows = []
    print(f"distributed (gt4py_tpu_torch.parallel) on {smi}: DistributedStencil over a "
          f"{mesh.shape[0]}x{mesh.shape[1]} mesh of {devices[0]} (one shard each of "
          f"{DIST_SHARDS}), halo exchange by slab copies on the card; each case counted, == the "
          f"single-card stencil to the bit and == the plain version; device us a step of "
          f"{DIST_CALLS} chained applies behind a spin kernel (exchange, the shards' kernels), "
          "beside 4 x the single-shard step of section 4:")
    for c in distributed_cases(runs):
        case = c["run"]["case"]
        key = (case.get("like", case["name"]), c["domain"])
        if key not in hosts:
            hosts[key] = make_host(case, c["domain"], 13, np)
        c["host"] = hosts[key]
        row = run_distributed_case(c, mesh, storage, cuda_backend, np, torch, device)
        rows.append(row)
        print(f"  {row['name']:42s} {row['boundary']:8s} {'x'.join(map(str, row['domain']))}  "
              f"launches {row['launches']}  same bits {row['same_bits_as_single_card']}  "
              f"device {row['ms'] * 1e3:8.1f} us a step (exchange {row['exchange_ms'] * 1e3:7.1f}, "
              f"kernels {row['compute_ms'] * 1e3:7.1f}; 4 x one shard "
              f"{row['four_single_shard_ms'] * 1e3:7.1f})  warm apply {row['call_host_us']:7.1f} "
              f"us on the host  scatter {row['scatter_us']:8.1f} us  gather "
              f"{row['gather_us']:8.1f} us  plain {row['plain_ms']:8.2f} ms  bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}; {row['slabs']} slabs, "
              f"{row['slab_bytes'] / 1e6:.2f} MB)")
        del c["host"]
    hosts.clear()

    nb = run_distributed_nabla(DIST_NABLA, nablas.get(DIST_NABLA * DIST_NABLA), ndefs, torch,
                               device)
    print(f"  DistributedUnstructured FVM nabla, {nb['vertices']} vertices over a ring of "
          f"{DIST_SHARDS} shards (edges by spatial_renumbering, plan {nb['plan_s']:.2f} s): "
          f"{nb['ms']:.4f} ms a call (one device, step 7d: {nb['single_ms']}) == one device "
          f"within rtol 1e-5, atol 1e-6 (max abs err {nb['max_abs_err']:.3e}, same bits "
          f"{nb['same_bits']}); {nb['slabs']} slabs a call of {nb['slab_rows']} rows, owned "
          f"blocks {nb['owned']}")

    # the distributed_hdiff example: its run counted and held against numpy on the host
    st, op = dex["st"], dex["op"]
    variant = bridged_variant(op)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with contextlib.redirect_stdout(None):
        (hd, lap), counts, wall = counted(
            lambda: distributed_hdiff.main("cuda:hopper", devices * DIST_SHARDS,
                                           distributed_hdiff.BLOCK, (st, op)),
            cuda_backend, sync)
        want = distributed_hdiff.main("numpy", [torch.device("cpu")] * DIST_SHARDS,
                                      distributed_hdiff.BLOCK)
    asked = {"plane": DIST_SHARDS * len(st._backend.module.launchers)}
    asked[variant.backend.strategy] = (asked.get(variant.backend.strategy, 0)
                                       + len(variant.backend.module.launchers))
    expect_launches("distributed_hdiff", counts, asked)
    err = agree([np.asarray(hd), lap.asnumpy()], [np.asarray(want[0]), want[1].asnumpy()],
                "distributed_hdiff")
    shape = hd.shape
    ex = {"run": {"kern": st, "plain": dex["plain"], "dtype": "float64", "scalars": {},
                  "case": {"name": "hdiff", "kernel": "plane",
                           "fields": ("in_field", "out_field", "coeff"),
                           "swap": {"in_field": "out_field", "out_field": "in_field"}}},
          "boundary": "periodic", "domain": shape, "tag": "example_distributed_hdiff"}
    ex["host"] = make_host(ex["run"]["case"], shape, 0, np)
    ex["run"]["device_ms"] = shard_step_ms(ex["run"], distributed_hdiff.BLOCK, storage, device)
    row = run_distributed_case(ex, mesh, storage, cuda_backend, np, torch, device)
    rows.append(row)
    print(f"  example distributed_hdiff {'x'.join(map(str, shape))}: wall {wall:.3f} s, launches "
          f"{counts}, == numpy on the host (max abs err {err:.3e}); its hdiff on sharded arrays "
          f"{row['ms'] * 1e3:.1f} us a step on the device (4 x one shard of {distributed_hdiff.BLOCK} "
          f"{row['four_single_shard_ms'] * 1e3:.1f} us), bound {row['bound_ms'] * 1e3:.2f} us")
    print(f"distributed phase in {time.perf_counter() - t0:.1f} s")
    return rows


# -- the calibration phase (step 12) ------------------------------------------------

#: step 12: the probes' seed, the plain version's timed calls, and the main
#: paths of step 4 held against the probes' ceilings, by their ceilings'
#: labels: tridiag and vadv (``column``), with the switch on
#: (``fused_column``), and bfloat16 hdiff (``plane``)
CAL_SEED = 23
CAL_PLAIN_CALLS = 3
CAL_WALKS = {
    "tridiag_float32": ("tridiag", "float32"), "tridiag_float64": ("tridiag", "float64"),
    "vadv_float32": ("vadv", "float32"), "vadv_float64": ("vadv", "float64"),
    "tridiag_fused_float32": ("tridiag_fused", "float32"),
    "tridiag_fused_float64": ("tridiag_fused", "float64"),
    "vadv_fused_float32": ("vadv_fused", "float32"), "vadv_fused_float64": ("vadv_fused", "float64"),
    "hdiff_bf16": ("hdiff", "bfloat16"),
}
CAL_SOURCE = "gt4py_tpu_torch/cartesian/backend/calibration.cu"
#: each probe's key in :func:`probe_bounds`
CAL_BOUNDS = {"probe_walk": "bench.py:1494 _mk_probe", "plane_walk5": "bench.py:1414 _pw_kernel",
              "bf16_windows": "bench.py:1351 _mk_bf16_probe"}


def probe_kernel(kind: str, params: tuple) -> str:
    """The kernel of a probe variant, as :func:`kernel_name` gives it."""
    return f"{kind}<{', '.join(str(p) for p in params)}>" if params else kind


def main_body(code) -> list:
    """A kernel's SASS without its subroutines (from the first a ``CALL``
    reaches to the end, which the compiler places after the kernel's code:
    an IEEE division's slow path, which runs only for subnormal or huge
    operands) and without the trap loop that ends it (a branch to itself)."""
    import re

    targets = [int(t.group(1), 16) for _, op, rest in code if op.split(".")[0] == "CALL"
               for t in [re.search(r"0x([0-9a-f]+)", rest)] if t]
    end = min(targets, default=None)
    body = []
    for addr, op, rest in code:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if end is not None and addr >= end:
            break
        if op.split(".")[0] == "BRA" and t and int(t.group(1), 16) == addr:
            break
        body.append((addr, op, rest))
    return body


def probe_report(calibration, cuda_backend, tool) -> dict:
    """(kind, params) -> what the build says of each probe variant's kernel:
    ``registers``, ``spill`` (bytes of spill stores), ``blocks`` resident on
    an SM (calibration.cu's CAL_THREADS threads, plane_walk5's CAL_BJ ×
    CAL_BI as many, no shared memory); and, with ``cuobjdump`` (``tool``;
    None leaves the SASS out), from its SASS's :func:`main_body`: ``classes`` (its
    instructions by :func:`sass_class`), ``wide`` (its 128-bit global loads
    and stores) and, for the vector kernels (``calibration.POINTS_A_THREAD``),
    ``per_point``: FP32-pipe instructions (opcodes F*, but the F2*
    conversions) and MUFU instructions a point, what
    ``calibration.instruction_bound`` takes."""
    source = calibration.source()
    ptxas = ptxas_report(source, cuda_backend)
    sass = sass_functions(source, cuda_backend, tool) if tool else {}
    threads = calibration.define("CAL_THREADS")
    out = {}
    for kind, params in calibration.variants():
        name = probe_kernel(kind, params)
        registers, spill = ptxas[name]
        entry = {"registers": registers, "spill": spill,
                 "blocks": resident_blocks(registers, threads, 0)}
        if name in sass:
            ops = [op for _, op, _ in main_body(sass[name][0]) if op != "NOP"]
            classes = {}
            for op in ops:
                cls = sass_class(op.split(".")[0])
                classes[cls] = classes.get(cls, 0) + 1
            entry["classes"] = classes
            entry["wide"] = {kind_: sum(op.startswith(kind_) and ".128" in op for op in ops)
                             for kind_ in ("LDG", "STG")}
            per = calibration.POINTS_A_THREAD.get(kind)
            if per:
                entry["per_point"] = {
                    "fp32": sum(op[0] == "F" and not op.startswith("F2") for op in ops) / per,
                    "mufu": sum(op.split(".")[0] == "MUFU" for op in ops) / per,
                }
        out[(kind, params)] = entry
    return out


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return float(out.split()[0])


def same_finite_bits(got, want, tag: str) -> float:
    """Raises unless ``got`` and ``want`` are finite everywhere and equal
    to the bit; returns their largest difference (0.0)."""
    import torch

    for t, which in ((got, "the kernel's"), (want, "the plain version's")):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{tag}: {which} output is not finite everywhere, so the "
                                 "comparison would hold nothing")
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if got.shape != want.shape or not torch.equal(got.view(ints), want.view(ints)):
        raise AssertionError(f"{tag}: differs from the plain version")
    return float((got.double() - want.double()).abs().max())


def bound_share(bound_us: float, us: float) -> str:
    """The bound's share of a measured time, or none where the time beats
    the bound: then it bounds nothing, and no share above 100 % is shown."""
    return f"{bound_us / us:.0%}" if bound_us <= us else "no share: the kernel beats it"


def calibration_walks(runs, calibration) -> tuple[dict, dict]:
    """(walks, walk_us) for ``calibration.ceilings``: each main path of
    CAL_WALKS with its compulsory bytes and bench.py's operations a point
    (hdiff none), and its device µs a step from step 4."""
    by_path = {(r["case"]["name"], r["dtype"]): r for r in runs}
    walks, walk_us = {}, {}
    for label, (name, dtype) in CAL_WALKS.items():
        run = by_path[(name, dtype)]
        ops = calibration.WALK_OPS.get(name.removesuffix("_fused"), (0, 0))
        walks[label] = (compulsory_bytes(run["kern"], ITEMSIZE[dtype]), *ops)
        walk_us[label] = run["device_ms"] * 1e3
    return walks, walk_us


def run_calibration(runs, copy_gbs, calibration, smi, torch, device="cuda",
                    sizes=(NI, NJ, NK, HALO)) -> list:
    """Step 12: bench.py's three calibration probes (bench.py:1325-1570) on
    their hand-written kernels (``calibration.cu``), every instantiated
    variant at bench.py's sizes (``sizes``): one launch and a graph chain of
    ``calibration.checked_chain`` applications each finite and equal to the
    plain version on the card to the bit (not counted), then, the probes'
    counts set to 0, the two-point fit of its µs (``calibration.fit_us``),
    the counts read: the probe's kernel launched exactly the fit's launches,
    no other; where one PyTorch call computes the same function
    (``calibration.LIBRARY``), that call timed by the same fit. Prints each
    variant's µs and spread, its bytes over the µs beside the same-run
    device copy (``copy_gbs``; whether it fits the L2), on the card its
    build (:func:`probe_report`), the ceilings of bench.py's formulas, and
    step 4's walks over them. Returns the ``kernels`` rows: measured values,
    and the bound computed from this run's shapes: on the card the bytes at
    the L2 yardstick's rate where they fit the card's L2, else at the device
    memory's, and for the vector kernels their instructions from their SASS
    (``calibration.instruction_bound``), the card's ``cuobjdump`` required;
    on CPU tensors, a rehearsal, bytes at the device memory's rate or
    operations at the FMA peak."""
    t0 = time.perf_counter()
    ni, nj, nk, halo = sizes
    bounds = probe_bounds(ni, nj, nk, halo)
    rows, times, shown = [], {}, []
    report, card = {}, None
    if torch.device(device).type == "cuda":
        tool = cuobjdump()
        if tool is None:
            raise RuntimeError("calibration: the toolkit has no cuobjdump; the probes' bound "
                               "and their 128-bit loads and stores are read from their SASS")
        report = probe_report(calibration, calibration.cuda_backend, tool)
        card = {"clock": max_sm_clock_mhz(), "l2": calibration.l2_bytes(device),
                "sms": torch.cuda.get_device_properties(device).multi_processor_count,
                "l2_read": calibration.l2_read_rate(device)}
    l2 = card["l2"] if card else calibration.L2_BYTES
    for kind, params in calibration.variants():
        name = calibration.variant_name(kind, params)
        size = calibration.shape(kind, ni, nj, nk, halo)
        inputs = calibration.make_inputs(kind, device=device, seed=CAL_SEED, size=size)
        checked = calibration.checked_chain(kind, params)
        once = calibration.apply(kind, inputs, params, None)
        chained = calibration.Chain(kind, checked, inputs, params).run()
        err = 0.0
        for got, n in ((once, 1), (chained, checked)):
            want = calibration.chain_plain(kind, n, inputs, params)
            err = max(err, same_finite_bits(got, want, f"calibration {name}, {n} application(s)"))
        plain_ms = events_ms(lambda: calibration.run_plain(kind, inputs, params),
                             CAL_PLAIN_CALLS)
        for wrapper in calibration.WRAPPERS.values():
            wrapper.launches = 0
        fit = calibration.fit_us(kind, inputs, params)
        counts = {k: w.launches for k, w in calibration.WRAPPERS.items()}
        expect_launches(f"calibration {name}", counts, {kind: fit["launches"]})
        library = None
        if (kind, params) in calibration.LIBRARY:
            library = calibration.fit_us(kind, inputs, params, library=True)
        times[name] = fit["us"]
        nbytes = bounds[CAL_BOUNDS[kind]][0]
        in_l2 = card is not None and nbytes <= l2
        rate = card["l2_read"]["Bps"] if in_l2 else HBM_BYTES_PER_S
        build = report.get((kind, params), {})
        if card and kind in calibration.POINTS_A_THREAD:
            if "per_point" not in build or not all(build["wide"].values()):
                raise AssertionError(f"calibration {name}: no 128-bit global loads or stores "
                                     f"in its SASS ({build.get('wide')})")
            bound_us, bound_by = calibration.instruction_bound(
                build["per_point"], size[0] * size[1] * size[2], nbytes, card["clock"],
                card["sms"], rate)
            bound_ms = bound_us / 1e3
        else:
            ops = calibration.operations(kind, params, size)
            bound_ms, bound_by = max((nbytes / rate * 1e3, "bytes"),
                                     (ops / PEAK_FLOPS["float32"] * 1e3, "operations"))
        rows.append({
            "name": f"{kind}/{name}", "route": "cuda", "entry": "calibration",
            "source": CAL_SOURCE, "replaces": REPLACES[kind],
            "launches": counts[kind], "max_abs_err": err,
            "ms": fit["us"] / 1e3, "spread_pct": fit["spread_pct"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None else library["us"] / 1e3,
        })
        shown.append({"fit": fit, "library": library, "bytes": nbytes, "checked": checked,
                      "rate": "the L2 yardstick's" if in_l2 else "the memory's",
                      "card_own": kind == "probe_walk" and params in calibration.CARD_PROBES,
                      "build": build})
    walks, walk_us = calibration_walks(runs, calibration)
    ceil = calibration.ceilings(times, ni, nj, nk, halo, walks=walks, walk_us=walk_us,
                                copy_Bps=copy_gbs * 1e9, l2=l2)
    print(f"calibration (bench.py:1325-1570) on {smi}, in {time.perf_counter() - t0:.1f} s: "
          "each variant finite and == the plain version on the card to the bit (one launch, a "
          "graph chain of the applications shown); µs a launch, and of the library call where "
          "there is one, by the two-point fit of graph chains behind a spin kernel (min-fit, the "
          "median-fit's spread), bytes over µs beside the device copy of 256 MiB "
          f"({copy_gbs:.1f} GB/s; the card's L2 holds {l2 / 1e6:.2f} MB):")
    if card:
        yard = card["l2_read"]
        print(f"  the L2 yardstick (l2_read, {calibration.L2_READ_PASSES} passes a launch over "
              f"{yard['nbytes'] / 1e6:.2f} MB, every load through the L2 only, the warps' "
              f"largest == torch.amax): {yard['us']:.3f} us a launch (spread "
              + ("n/a" if yard["spread_pct"] is None else f"{yard['spread_pct']:.1f} %")
              + f"), {yard['Bps'] / 1e9:.1f} GB/s, {card['sms']} SMs at {card['clock']:.0f} MHz")
    for r, sh in zip(rows, shown):
        fit, lib, gbs = sh["fit"], sh["library"], sh["bytes"] / sh["fit"]["us"] / 1e3
        share = bound_share(r["bound_ms"] * 1e3, fit["us"])
        spread = "n/a" if r["spread_pct"] is None else f"{r['spread_pct']:.1f} %"
        library = "n/a" if lib is None else (
            f"{lib['us']:.3f} us (copy_, spread "
            + ("n/a" if lib["spread_pct"] is None else f"{lib['spread_pct']:.1f} %") + ")")
        print(f"  {r['name']:34s} checked chain {sh['checked']}  launches {r['launches']:5d}  "
              f"{fit['us']:9.3f} us (spread {spread}, chains {fit['chains'][0]}/"
              f"{fit['chains'][1]})  {gbs:8.1f} GB/s ({gbs / copy_gbs:.1%} of copy; "
              f"{sh['bytes'] / 1e6:.2f} MB, "
              f"{'fits' if sh['bytes'] <= l2 else 'exceeds'} the L2)  "
              f"plain {r['plain_ms'] * 1e3:9.1f} us  bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}, bytes at {sh['rate']} rate; {share})  library {library}"
              + ("  (the card's own reading)" if sh["card_own"] else ""))
        build = sh["build"]
        if build:
            print(f"    {build['registers']} registers, {build['spill']} B spilled, "
                  f"{build['blocks']} blocks an SM"
                  + ("" if "classes" not in build else
                     "; SASS " + ", ".join(f"{c} {n}" for c, n in build["classes"].items())
                     + f" (128-bit LDG {build['wide']['LDG']}, STG {build['wide']['STG']})")
                  + ("" if "per_point" not in build else
                     f"; a point FP32 {build['per_point']['fp32']:.2f}, MUFU "
                     f"{build['per_point']['mufu']:.2f} (the bound's instructions)"))
    print("  ceilings: " + ", ".join(f"{k} {v:.6g}" for k, v in ceil.items()
                                     if not k.split("_")[0] in ("tridiag", "vadv", "hdiff")
                                     or k.startswith("hdiff_bf16_vpu")))
    print("  the main paths' walks (step 4's device µs) over the ceilings: compulsory bytes over "
          "the plane walk's rate and over the chain's copy rate (for bytes beyond the L2, over "
          "the device copy's where it is slower), bench.py's operations at the probes' costs, "
          "the ceiling the larger:")
    for label in walks:
        t_w = walk_us[label]
        parts = [f"device {t_w:8.2f} us", f"bytes {walks[label][0] / 1e6:.2f} MB"]
        for key in ("planewalk_floor_us", "copy_floor_us", "compute_model_us",
                    "chain_ceiling_us"):
            if f"{label}_{key}" in ceil:
                value = ceil[f"{label}_{key}"]
                parts.append(f"{key.removesuffix('_us')} {value:.2f} us"
                             + (f" (device / it {t_w / value:.3f})" if value else ""))
        if label == "hdiff_bf16" and "hdiff_bf16_vs_vpu_model" in ceil:
            parts.append(f"bf16 window model {ceil['hdiff_bf16_vpu_model_us']:.2f} us "
                         f"(device / it {ceil['hdiff_bf16_vs_vpu_model']:.3f})")
        print(f"    {label:22s} " + "  ".join(parts))
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv))
