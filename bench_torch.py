#!/usr/bin/env python3
"""Benchmark of gt4py_tpu_torch on one CUDA card: bench.py's measuring program.

Prints ONE JSON line with bench.py's shape (bench.py:1760-1769)::

  {"metric": "hdiff_256x256x80_f32_throughput", "value": N, "unit": "Ggridpoints/s",
   "vs_baseline": N, "device": "<the card's name>", "peak_hbm_GBps": N, "details": {...}}

Primary metric: hdiff gridpoints/s at 256×256×80 (float32, halo 2) on the
``cuda:hopper`` backend, ``stencil.chain`` (a CUDA graph of one swap cycle).
``vs_baseline`` is ``hdiff_roofline_frac / 0.80`` (bench.py:1758-1759): the
share of the card's device-memory peak that hdiff's bytes reach, over the
0.80 target. ``peak_hbm_GBps`` is read from the card itself: its memory
clock times its bus width times 2 (``calibration.peak_memory_Bps``,
``cudaDeviceGetAttribute`` 36 and 37), never from a table of names.

The rows of ``details`` are bench.py's, under its keys, with its shapes,
dtypes and byte and point counts (the functions below name the bench.py
line of each), each computed by the port's kernels:

- hdiff f32 and bf16 (``plane``), vadv and tridiag (``column``, the stage
  fusion switch at its default): cartesian stencils of
  tests/torch_stencil_defs.py chained by ``stencil.chain``;
- next hdiff, next tridiag and next vadv: the field-view operators of
  tests/torch_next_defs.py called once through ``cuda:hopper`` (the bridge
  must serve them on their kernel), then the bridged variant's stencil
  chained by its backend's ``run_steps`` (the graph replays ``chain`` runs),
  since a field-view call has no ``chain``; ``*_vs_cartesian`` is that
  step over the cartesian row's;
- the FVM nabla at 65,536 vertices, its renumbered (irregular) twin and at
  1,048,576 vertices: the embedded ``torch`` field view (no kernel, as in
  the JAX package), each step one call from the same inputs, a chain's
  calls captured into one CUDA graph as bench.py chains them in one jitted
  loop (inside that capture each call runs inline, as the JAX package's
  operators run inside an enclosing jit). These rows are DEVICE ONLY.
  A user's warm call from the host, the added key
  ``fvm_nabla_host_call_us`` (by row), is one replay of the operator's own
  CUDA graph, captured at its second call (its first runs eagerly,
  next/otf.py): the device work of one step plus the host's key and
  launch. The irregular row's gather ceiling
  is the rows it gathers at the card's gather rate, read in this run from
  ``torch.index_select`` of as many rows;
- the streaming triads in f32 and bf16 (plain torch ops, as bench.py's XLA
  triads are no Pallas kernel), beside ``device_copy_GBps``, the same run's
  256 MiB device copy;
- the calibration probes P1-P3 (``calibration.fit_us``) and bench.py's
  ceilings from them (``calibration.ceilings``);
- copy and Laplacian at 48³ (``plane``), hdiff measured again at the end
  (the better reading is kept, as bench.py keeps it), and the bf16 capacity
  row, last: three bfloat16 buffers sized from ``torch.cuda.mem_get_info``
  that would not fit in float32, updated in place;
- ``program_call_overhead``: benchmarks/benchmark_program_call.py's eight
  keys on ``cuda:hopper`` objects at that script's sizes (host wall clock
  over warm calls, the card synchronised after the timed loop), each the
  median of ``TRIALS`` readings, its spread in ``host_spread_pct``.

Left out, each with its reason: ``LEFT_OUT``. bench.py's ``*_error`` keys
are not carried over: a row that raises ends the run with a non-zero exit.

Timing (``instrumentation.timing.StepTimer``): bench.py's two-point fit of
chains of ``n_lo`` against ``n_hi`` steps, by CUDA events around each run
from an idle card (the probes behind a spin kernel, ``calibration.fit_us``),
the inputs copied back before each run, one warm run of each length and
``TRIALS`` of each in turns; the min-fit is the reading, the median-fit's
distance from it the spread (``measurement_spread_pct``), and the seconds to
the first warm run ``compile_warm_s``. A fit that is not positive raises.
Every reading is taken once; a spread in ``measurement_spread_pct`` of
``SPREAD_PCT`` or more fails the run. Readings of calls from the host
(``StepTimer.repeat``: ``fvm_nabla_host_call_us``, ``program_call_overhead``)
are the median of ``TRIALS``, their spread its distance from the smallest,
kept apart in ``host_spread_pct`` and not gated: on the card's shared host
they spread by up to 70 % from one reading to the next (PERF.md §7), what a
user's call costs there, and no choice of reading length tried held them
under 5 %.

Before a row is timed its first result is held against the plain version
on the card (the same definition on the ``torch`` backend), the ``numpy``
backend, or NumPy, at the tolerances of PERF.md §2; after it is timed, the
values its chain carried must be finite. Inputs are uniform in [0, 1) from
``np.random.default_rng`` (bench.py's ``device_random`` draws the same
distribution on the TPU), scaled as the port's main path scales them where
bench.py's would leave the numbers a row is checked in: hdiff's diffusion
coefficient is 0.1 × uniform, a stable one (with bench.py's, up to 1, the
flux limiter's sign test turns the bfloat16 plain version's per-operation
rounding into whole fluxes, beyond the bfloat16 tolerance); tridiag's
coefficients make each column an M-matrix of row sum 1 (inf, sup in (-1,
0], diag = 1 + |inf| + |sup|), so that a chained solve neither overflows
(bench.py's uniform coefficients make near-singular columns, whose chained
solutions reach inf and NaN) nor sinks into the subnormals; vadv's vertical
wind is 0.1 × uniform, so that its pivots stay away from 0.

Progress goes to stderr (bench.py:146). Usage: ``python3 bench_torch.py``
(no arguments) from the repository root, on a card; without one it exits 1
and prints no line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

NI, NJ, NK, HALO = 256, 256, 80, 2
TARGET = 0.80
#: PERF.md §2: a row's first result against the plain version on the same
#: card (float32 kernels round every operation as the plain version does)
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATOL = {"float32": 0.0, "bfloat16": 2e-2}
#: against NumPy or the numpy backend on the host (float32 carries the
#: rounding of 80-level recurrences), as (rtol, atol)
ORACLE_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
#: the FVM nabla against numpy: a vertex's signed sum of edge terms of
#: about 0.5 cancels towards 0
NABLA_TOL = (1e-5, 1e-6)
#: warm calls a reading of the FVM nabla's calls from the host
HOST_CALLS = 20
#: chain lengths of the fit: a 44 µs hdiff step over 200 steps swamps the
#: host's jitter; the 48³ stencils take a few µs a step
CHAINS = (20, 220)
SMALL_CHAINS = (200, 2200)
TRIALS = 5
#: every reading's spread must stay under SPREAD_PCT, or the run fails
SPREAD_PCT = 5.0
#: copy and Laplacian at 48³ with a halo of 1 (bench.py:1590-1593)
N48, LHALO = 48, 1
#: the FVM nabla's meshes, n × n vertices (bench.py:691, :970)
NABLA_SMALL, NABLA_BIG = 256, 1024
#: the bf16 capacity row: K and J of the domain (bench.py:1703), and the
#: bytes of free device memory given to each point: three bfloat16 buffers
#: take 6 of them, three float32 buffers would take 12
CAP_K, CAP_J, CAP_BYTES_A_POINT = 80, 4096, 9
CAP_STEPS = 10
#: benchmarks/benchmark_program_call.py's sizes: the copy stencil's domain,
#: the chains, timeit's calls and warm-up calls
PC_DOMAIN = (16, 16, 4)
PC_CHAINS = (64, 1088)
PC_CALLS, PC_WARMUP = 200, 20
PC_CHAIN_CALLS, PC_CHAIN_WARMUP = 20, 3

#: bench.py keys not carried over, and why
LEFT_OUT = {
    "fvm_nabla_perturbed_us_per_step": "the roll plan's hybrid rows, which the port does not "
                                       "have (ROADMAP Queue 2, not ported)",
    "fvm_nabla_perturbed_hybrid": "as fvm_nabla_perturbed_us_per_step",
    "fvm_nabla_perturbed_vs_structured": "as fvm_nabla_perturbed_us_per_step",
    "fvm_nabla_perturbed_vs_irregular": "as fvm_nabla_perturbed_us_per_step",
    "fixup_ops_us": "times the roll plan's merged fix-ups, which the port does not have",
    "fvm_nabla_perturbed_model_us": "as fixup_ops_us",
    "fvm_nabla_perturbed_vs_model": "as fixup_ops_us",
}
#: keys of the port's own, beside bench.py's
ADDED = {
    "program_call_overhead": "benchmarks/benchmark_program_call.py's eight keys",
    "device_copy_GBps": "the same run's 256 MiB device copy, beside the triad",
    "fvm_nabla_host_call_us": "a warm call of each FVM nabla row from the host through the "
                              "entry point, one replay of the operator's CUDA graph; the rows "
                              "time a CUDA graph of chained calls, device only",
    "host_spread_pct": "the spreads of the readings of calls from the host "
                       "(fvm_nabla_host_call_us, program_call_overhead), apart from "
                       "measurement_spread_pct and its 5 % gate: on the card's shared host "
                       "they spread by up to 70 % (PERF.md §7)",
}
#: every key of ``details``
DETAIL_KEYS = (
    "hdiff_Ggps", "hdiff_us_per_step", "hdiff_roofline_frac",
    "hdiff_bf16_Ggps", "hdiff_bf16_us_per_step", "hdiff_bf16_roofline_frac",
    "hdiff_bf16_vs_f32_speedup",
    "vadv_Ggps", "vadv_us_per_step", "vadv_roofline_frac",
    "tridiag_Ggps", "tridiag_us_per_step", "tridiag_roofline_frac",
    "next_hdiff_us_per_step", "next_hdiff_vs_cartesian", "next_hdiff_bridged",
    "fvm_nabla_us_per_step", "fvm_nabla_Mvertices_s", "fvm_nabla_structured",
    "fvm_nabla_stream_frac", "fvm_nabla_irregular_us_per_step",
    "fvm_nabla_irregular_gather_ceiling_frac", "fvm_nabla_1M_us_per_step",
    "fvm_nabla_1M_Mvertices_s", "fvm_nabla_1M_stream_frac",
    "next_tridiag_us_per_step", "next_tridiag_vs_cartesian", "next_tridiag_bridged",
    "next_vadv_us_per_step", "next_vadv_vs_cartesian", "next_vadv_bridged",
    "stream_triad_us", "practical_bw_frac", "hdiff_vs_practical_ceiling",
    "stream_triad_bf16_us", "hdiff_bf16_vs_stream_floor", "hdiff_bf16_compute_bound",
    "bf16_window_cost_us", "hdiff_bf16_vpu_model_us", "hdiff_bf16_vs_vpu_model",
    "planewalk5_us_per_step", "planewalk5_GBps", "tridiag_vs_planewalk_ceiling",
    "vadv_vs_planewalk_ceiling",
    "chain_copy_rate_TBps", "chain_fma_ps_per_point", "chain_div_ps_per_point",
    "tridiag_copy_floor_us", "tridiag_compute_model_us", "tridiag_chain_ceiling_us",
    "tridiag_vs_chain_ceiling", "vadv_copy_floor_us", "vadv_compute_model_us",
    "vadv_chain_ceiling_us", "vadv_vs_chain_ceiling",
    "copy48_us_per_step", "copy48_Ggps", "lap48_us_per_step", "lap48_Ggps",
    "bf16_capacity_domain", "bf16_capacity_us_per_step", "bf16_capacity_Ggps",
    "bf16_capacity_f32_compiles",
    "compile_warm_s", "measurement_spread_pct",
    *ADDED,
)


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


# -- bench.py's counts -------------------------------------------------------------


def hdiff_bytes(ni: int, nj: int, nk: int, halo: int, itemsize: int = 4) -> int:
    """in_field over the domain and its halo, coeff and out over the domain
    (bench.py:260, :342)."""
    return ((ni + 2 * halo) * (nj + 2 * halo) + 2 * ni * nj) * nk * itemsize


def vadv_points(ni: int, nj: int, nk: int) -> int:
    """vadv's domain, one point short in I (bench.py:449)."""
    return (ni - 1) * nj * nk


def vadv_bytes(ni: int, nj: int, nk: int) -> int:
    """5 reads and 1 write, float32 (bench.py:452)."""
    return 6 * vadv_points(ni, nj, nk) * 4


def tridiag_bytes(ni: int, nj: int, nk: int) -> int:
    """inf, diag, sup, rhs read, out written, float32 (bench.py:541)."""
    return 5 * ni * nj * nk * 4


def nabla_bytes(nv: int) -> int:
    """pp, s_x (2 a vertex), sign (4 a vertex), vol read, out written,
    float32 (bench.py:743, :1009)."""
    return (nv + 2 * nv + 4 * nv + nv + nv) * 4


def gathered_rows(nv: int) -> int:
    """2 E2V gathers over the edges and 4 V2E gathers over the vertices a
    step (bench.py:798)."""
    return 2 * (2 * nv) + 4 * nv


def triad_bytes(shape, itemsize: int = 4) -> int:
    """2 reads and 1 write (bench.py:1266)."""
    return 3 * int(np.prod(shape)) * itemsize


def capacity_domain(free_bytes: int, nj: int = CAP_J, nk: int = CAP_K) -> tuple:
    """The bf16 capacity row's domain: J and K as bench.py's (bench.py:1703),
    I a multiple of 256 such that the domain's points take at most
    ``CAP_BYTES_A_POINT`` bytes of ``free_bytes`` each."""
    ni = free_bytes // CAP_BYTES_A_POINT // (nj * nk) // 256 * 256
    return (int(ni), nj, nk)


# -- the inputs ------------------------------------------------------------------


def uniform(rng, shape) -> np.ndarray:
    return rng.random(shape, dtype=np.float32)


def host_tensor(a: np.ndarray, dtype: str):
    """A CPU tensor of ``a`` in ``dtype`` (bfloat16 rounded to nearest even)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def tridiag_system(rng, shape) -> dict:
    """inf, diag, sup of an M-matrix of row sum 1 in every column, and a
    uniform right-hand side: a chained solve keeps its values in [0, 1)."""
    inf, sup = -uniform(rng, shape).astype(np.float64), -uniform(rng, shape).astype(np.float64)
    diag = 1.0 + np.abs(inf) + np.abs(sup)
    return {"inf": inf.astype(np.float32), "diag": diag.astype(np.float32),
            "sup": sup.astype(np.float32), "rhs": uniform(rng, shape)}


# -- the cartesian rows ------------------------------------------------------------


def build_stencil(definition, backend: str, dtype: str, externals=None):
    """A row's stencil on ``backend``, its fields in ``dtype``, its literals
    float32 (bench.py's ``s32``, bench.py:188)."""
    from gt4py_tpu_torch.cartesian import gtscript

    return gtscript.stencil(
        backend=backend, definition=definition, externals=externals or {},
        dtypes={"dt": dtype, "vadv_dt": dtype},
        literal_float_precision=32, literal_int_precision=32,
    )


class StencilRow:
    """One row's cartesian stencil (bench.py's definition, from
    tests/torch_stencil_defs.py) with its inputs: host tensors by field in
    ``dtype``, the storages' shape and origin, the domain, the swap of a
    chained step, the kernel that must serve it, the fields its first
    application writes and the fields its chain carries, which must stay
    finite over the timed chains unless ``bounded`` is false."""

    def __init__(self, label, definition, dtype, host, origin, domain, swap, kernel, written,
                 scalars=None, externals=None, bounded=True):
        self.label, self.definition, self.dtype = label, definition, dtype
        self.host = {n: host_tensor(v, dtype) for n, v in host.items()}
        self.origin, self.domain, self.swap, self.kernel = origin, domain, swap, kernel
        self.written = written
        self.scalars = scalars or {}
        self.externals = externals or {}
        self.bounded = bounded

    @property
    def carried(self) -> tuple:
        return tuple(sorted(set(self.written) | set(self.swap)))

    def build(self, backend: str):
        return build_stencil(self.definition, backend, self.dtype, self.externals)

    def storages(self, backend: str, device) -> dict:
        from gt4py_tpu_torch import storage

        return {n: storage.from_array(v, backend=backend, aligned_index=self.origin,
                                      device=device) for n, v in self.host.items()}

    def apply(self, stencil, fields) -> str:
        """One application on ``fields``; returns the strategy that ran."""
        info: dict = {}
        stencil(**fields, **self.scalars, domain=self.domain, exec_info=info)
        return info["kernel_strategy"]

    def first(self, backend: str, device) -> dict:
        """The written fields of one application on ``backend`` from the
        inputs, as float32 NumPy arrays."""
        fields = self.storages(backend, device)
        self.apply(self.build(backend), fields)
        return {n: fields[n].array.float().cpu().numpy() for n in self.written}


def hdiff_row(dtype: str = "float32", ni=NI, nj=NJ, nk=NK, halo=HALO, seed=1) -> StencilRow:
    """bench.py:187-351: ``hdiff32`` on (ni + 2 halo) × (nj + 2 halo) × nk,
    origin (halo, halo, 0), in_field and out_field swapped a step."""
    from tests import torch_stencil_defs as defs

    rng = np.random.default_rng(seed)
    shape = (ni + 2 * halo, nj + 2 * halo, nk)
    host = {"in_field": uniform(rng, shape), "coeff": np.float32(0.1) * uniform(rng, shape),
            "out_field": np.zeros(shape, np.float32)}
    return StencilRow("hdiff" if dtype == "float32" else "hdiff_bf16",
                      defs.horizontal_diffusion_generic, dtype, host, (halo, halo, 0),
                      (ni, nj, nk), {"in_field": "out_field", "out_field": "in_field"},
                      "plane", ("out_field",))


def vadv_row(ni=NI, nj=NJ, nk=NK, seed=2) -> StencilRow:
    """bench.py:353-456: the generic vadv in float32 on ni × nj × nk over the
    domain (ni - 1) × nj × nk, dtr_stage 0.15; utens_stage is carried."""
    from tests import torch_stencil_defs as defs

    rng = np.random.default_rng(seed)
    names = ("utens_stage", "u_stage", "wcon", "u_pos", "utens")
    host = {n: uniform(rng, (ni, nj, nk)) for n in names}
    host["wcon"] = np.float32(0.1) * host["wcon"]
    return StencilRow("vadv", defs.vertical_advection_dycore_generic, "float32", host,
                      (0, 0, 0), (ni - 1, nj, nk), {}, "column", ("utens_stage",),
                      scalars={"dtr_stage": np.float32(0.15)}, externals=defs.VADV_EXTERNALS)


def tridiag_row(ni=NI, nj=NJ, nk=NK, seed=3) -> StencilRow:
    """bench.py:458-545: ``tri32`` on ni × nj × nk, each step's solution the
    next right-hand side (rhs and out swapped a step)."""
    from tests import torch_stencil_defs as defs

    rng = np.random.default_rng(seed)
    host = {**tridiag_system(rng, (ni, nj, nk)), "out": np.zeros((ni, nj, nk), np.float32)}
    return StencilRow("tridiag", defs.tridiagonal_solver_temporaries, "float32", host,
                      (0, 0, 0), (ni, nj, nk), {"rhs": "out", "out": "rhs"}, "column", ("out",))


def small_row(label: str, n=N48, halo=LHALO, seed=4) -> StencilRow:
    """bench.py:1571-1663: ``copy48`` or ``lap48`` at n³ with a halo of 1,
    src and dst swapped a step. The Laplacian's largest eigenvalue is -8, so
    its chain leaves float32's range, as bench.py's 3202 steps do: its
    carried values are not held finite (its additions take inf and NaN at
    the same rate; it has no division)."""
    from tests import torch_stencil_defs as defs

    rng = np.random.default_rng(seed)
    shape = (n + 2 * halo, n + 2 * halo, n)
    host = {"src": uniform(rng, shape), "dst": np.zeros(shape, np.float32)}
    definition = defs.copy_generic if label == "copy48" else defs.laplacian_generic
    return StencilRow(label, definition, "float32", host, (halo, halo, 0), (n, n, n),
                      {"src": "dst", "dst": "src"}, "plane", ("dst",), bounded=label == "copy48")


# -- the field-view rows -----------------------------------------------------------


class ViewRow:
    """One row's field-view operator (tests/torch_next_defs.py) on
    ``cuda:hopper``: its call's arguments and out field, the plain version
    (the operator on the ``torch`` backend), the kernel the bridge must
    serve it on, and how its bridged variant's stencil is chained: the
    variant's field names by the operator's argument, the buffers of the
    chain (host arrays), origins, domain, swap and scalars."""

    def __init__(self, label, op, args, kwargs, out, kernel, chain_host, origins, domain, swap,
                 scalars=None):
        self.label, self.op, self.args, self.kwargs, self.out = label, op, args, kwargs, out
        #: the operator on cuda:hopper, made once: its bridge caches the variant
        self.hopper = op.with_backend("cuda:hopper")
        self.kernel = kernel
        self.chain_host, self.origins, self.domain, self.swap = chain_host, origins, domain, swap
        self.scalars = scalars or {}

    def call(self, backend: str, out=None):
        """One call on ``backend`` into ``out`` (the row's out field where
        None); returns the operator that ran."""
        from tests import torch_next_defs as ndefs

        op = self.hopper if backend == "cuda:hopper" else self.op.with_backend(backend)
        op(*self.args, out=self.out if out is None else out, offset_provider=ndefs.PROV_K,
           **self.kwargs)
        return op

    def variant(self, op):
        """The bridge's one variant serving ``op``."""
        variants = [v for v in op.__dict__.get("_bridge_cache", {}).values() if v is not None]
        if len(variants) != 1:
            raise AssertionError(f"{self.label}: the bridge holds {len(variants)} variants")
        return variants[0]

    def chain_buffers(self, variant, device) -> dict:
        """The chain's tensors by the variant's field names, K-leading as a
        field's (the variant's out field by its ``out_name``)."""
        import torch

        out = {}
        for name, v in self.chain_host.items():
            ni, nj, nk = v.shape
            t = torch.empty((nk, ni, nj), dtype=torch.float32, device=device).permute(1, 2, 0)
            out[self.role(variant, name)] = t.copy_(torch.from_numpy(v))
        return out

    @staticmethod
    def role(variant, name: str) -> str:
        """The variant's field name of a chain buffer (``out``: its out field)."""
        return variant.out_name if name == "out" else name


def field3(a, device):
    import gt4py_tpu_torch.next as gtx
    from tests import torch_next_defs as ndefs

    return gtx.as_field([ndefs.IDim, ndefs.JDim, ndefs.KDim], a, device=device)


def next_hdiff_row(ni=NI, nj=NJ, nk=NK, halo=HALO, device="cuda", seed=5) -> ViewRow:
    """bench.py:564-670: ``next_hdiff`` on inputs over the domain widened by
    the halo, the out field over the domain; chained as bench.py chains the
    bridged kernel, in the halo'd geometry (inp and out swapped a step)."""
    import gt4py_tpu_torch.next as gtx
    from tests import torch_next_defs as ndefs

    rng = np.random.default_rng(seed)
    hshape = (ni + 2 * halo, nj + 2 * halo, nk)
    inp, coeff = uniform(rng, hshape), np.float32(0.1) * uniform(rng, hshape)
    out = gtx.zeros({ndefs.IDim: (halo, halo + ni), ndefs.JDim: (halo, halo + nj),
                     ndefs.KDim: nk}, np.float32, device=device)
    origin = (halo, halo, 0)
    return ViewRow("next_hdiff", ndefs.next_hdiff, (field3(inp, device), field3(coeff, device)),
                   {}, out, "plane",
                   {"inp": inp, "coeff": coeff, "out": np.zeros(hshape, np.float32)},
                   {"inp": origin, "coeff": origin, "out": origin}, (ni, nj, nk),
                   {"inp": "out", "out": "inp"})


def next_tridiag_row(ni=NI, nj=NJ, nk=NK, device="cuda", seed=6) -> ViewRow:
    """bench.py:1035-1112: ``next_tridiag`` (two scans), chained with each
    step's solution the next ``d``."""
    import gt4py_tpu_torch.next as gtx
    from tests import torch_next_defs as ndefs

    rng = np.random.default_rng(seed)
    system = tridiag_system(rng, (ni, nj, nk))
    host = dict(zip("abcd", (system[n] for n in ("inf", "diag", "sup", "rhs"))))
    out = gtx.zeros({ndefs.IDim: ni, ndefs.JDim: nj, ndefs.KDim: nk}, np.float32, device=device)
    zero = (0, 0, 0)
    return ViewRow("next_tridiag", ndefs.next_tridiag,
                   tuple(field3(host[n], device) for n in "abcd"), {}, out, "column",
                   {**host, "out": np.zeros((ni, nj, nk), np.float32)},
                   {n: zero for n in (*"abcd", "out")}, (ni, nj, nk), {"d": "out", "out": "d"})


def next_vadv_row(ni=NI, nj=NJ, nk=NK, device="cuda", seed=7) -> ViewRow:
    """bench.py:1114-1238: ``next_vadv_op`` over ni × nj × nk inputs and an
    out field one point short in I, dtr 0.15; chained with each step's out
    the next ``utens_stage``."""
    import gt4py_tpu_torch.next as gtx
    from tests import torch_next_defs as ndefs

    rng = np.random.default_rng(seed)
    names = ("utens_stage", "u_stage", "wcon", "u_pos", "utens")
    host = {n: uniform(rng, (ni, nj, nk)) for n in names}
    host["wcon"] = np.float32(0.1) * host["wcon"]
    dtr = np.float32(0.15)
    out = gtx.zeros({ndefs.IDim: ni - 1, ndefs.JDim: nj, ndefs.KDim: nk}, np.float32,
                    device=device)
    return ViewRow("next_vadv", ndefs.next_vadv_op(nk),
                   (*(field3(host[n], device) for n in names), dtr), {}, out, "column",
                   {**host, "out": np.zeros((ni, nj, nk), np.float32)},
                   {n: (0, 0, 0) for n in (*names, "out")}, (ni - 1, nj, nk),
                   {"utens_stage": "out", "out": "utens_stage"}, {"dtr": dtr})


def nabla_row(n: int, device="cuda", renumber: bool = False, seed=8):
    """bench.py:672-801, :962-1013: ``nabla_x`` on the periodic n × n quad
    mesh (its renumbered twin with ``renumber``); (args, provider, out)."""
    from tests import torch_next_defs as ndefs

    return ndefs.nabla_inputs(n, np.float32, seed, device, renumber=renumber)


def nabla_first(n: int, backend: str, device, renumber: bool = False) -> np.ndarray:
    """One call of ``nabla_x`` on ``backend`` from the row's inputs."""
    from tests import torch_next_defs as ndefs

    args, provider, out = nabla_row(n, device, renumber)
    ndefs.nabla_x.with_backend(backend)(*args, out=out, offset_provider=provider)
    return out.asnumpy()


# -- the rows on the card ----------------------------------------------------------


class Bench:
    """The rows on one card, in bench.py's order, into ``results``. The
    sizes are bench.py's unless a caller asks for others: ``size`` (ni, nj,
    nk) and ``halo`` of the 3-D rows, ``n48`` of copy48 and lap48, the
    nabla meshes ``nablas``, J and K of the capacity row ``cap``. On CPU
    tensors (``device="cpu"``, a rehearsal) every kernel runs its plain
    version, which the checks then expect in place of the kernel."""

    def __init__(self, device="cuda", size=(NI, NJ, NK), halo=HALO, n48=N48,
                 nablas=(NABLA_SMALL, NABLA_BIG), cap=(CAP_J, CAP_K)):
        import torch

        from gt4py_tpu_torch.cartesian.backend import calibration
        from gt4py_tpu_torch.instrumentation.timing import StepTimer

        self.torch, self.calibration = torch, calibration
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.size, self.halo, self.n48, self.nablas, self.cap = size, halo, n48, nablas, cap
        self.timer = StepTimer(log=log)
        #: the readings of calls from the host, apart: their spreads are
        #: not gated (``host_spread_pct``)
        self.host_timer = StepTimer(log=log)
        self.results: dict = {}

    def served(self, kernel: str) -> str:
        """The strategy that must serve a row of ``kernel`` here."""
        return kernel if self.on_card else "plain"

    # -- timing and checks ---------------------------------------------------------

    def measure(self, make_chained, label: str, chains=CHAINS, trials: int = TRIALS) -> float:
        """Seconds a step by the timer's fit (``StepTimer.measure``), measured
        once."""
        return self.timer.measure(make_chained, label, *chains, trials=trials) * 1e-3

    def agree(self, tag: str, got, want, rtol: float, atol: float) -> None:
        """Raise unless ``got`` equals ``want`` within the tolerance, both
        finite."""
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not (np.isfinite(got).all() and np.isfinite(want).all()):
            raise AssertionError(f"{tag}: shapes {got.shape}, {want.shape} or non-finite values")
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{tag}: disagrees (max abs err {np.abs(got - want).max()}, "
                                 f"rtol {rtol}, atol {atol})")

    def finite(self, tag: str, tensors) -> None:
        """Raise unless every value of ``tensors`` is finite: their largest
        and smallest are (a reduction, no temporary of their size; NaN
        propagates through both)."""
        torch = self.torch
        for t in tensors:
            if not all(bool(torch.isfinite(r)) for r in (torch.amax(t), torch.amin(t))):
                raise AssertionError(f"{tag}: the chain carried non-finite values")

    # -- the cartesian stencils ---------------------------------------------------------

    def prepare(self, row: StencilRow):
        """The row's ``cuda:hopper`` stencil and card storages, its first
        application checked: served by its kernel, equal to the plain
        version on the card."""
        stencil = row.build("cuda:hopper")
        fields = row.storages("cuda:hopper", self.device)
        ran = row.apply(stencil, fields)
        if ran != self.served(row.kernel):
            raise AssertionError(f"{row.label}: served by {ran}, not {self.served(row.kernel)}")
        plain = row.storages("torch", self.device)
        row.apply(row.build("torch"), plain)
        for n in row.written:
            self.agree(f"{row.label} {n} against the plain version", fields[n].array.float().cpu(),
                       plain[n].array.float().cpu(), RTOL[row.dtype], ATOL[row.dtype])
        return stencil, fields

    def time_stencil(self, row: StencilRow, stencil, fields, chains=CHAINS) -> float:
        """Seconds a step of ``stencil.chain`` (bench.py's fit)."""
        from gt4py_tpu_torch.instrumentation.timing import refill

        kw = dict(swap=row.swap, domain=row.domain, **row.scalars)

        def make(n):
            return (lambda: stencil.chain(n, **fields, **kw), lambda: refill(fields, row.host))

        s = self.measure(make, row.label, chains)
        if row.bounded:
            self.finite(row.label, [fields[n].array for n in row.carried])
        return s

    # -- the field view ---------------------------------------------------------------

    def time_view(self, row: ViewRow) -> tuple[float, bool]:
        """(seconds a step, bridged): the operator called once through
        ``cuda:hopper`` (served by its kernel through the bridge, equal to
        the plain version on the card), then its bridged variant's stencil
        chained by the fit."""
        import gt4py_tpu_torch.next as gtx
        from gt4py_tpu_torch.cartesian.backend.base import chain_plan

        torch = self.torch
        op = row.call("cuda:hopper")
        variant = row.variant(op)
        bridged = variant.backend.last_strategy == row.kernel
        if variant.backend.last_strategy != self.served(row.kernel):
            raise AssertionError(f"{row.label}: ran {variant.backend.last_strategy}, not the "
                                 f"bridged {self.served(row.kernel)}")
        plain = gtx.zeros(row.out.domain, np.float32, device=self.device)
        row.call("torch", out=plain)
        self.agree(f"{row.label} against the plain version", row.out.asnumpy(), plain.asnumpy(),
                   RTOL["float32"], ATOL["float32"])
        own = row.chain_buffers(variant, self.device)
        origins = {row.role(variant, n): o for n, o in row.origins.items()}
        swap = {row.role(variant, a): row.role(variant, b) for a, b in row.swap.items()}
        plan = chain_plan(own, swap)

        def refill():
            for n in row.swap:
                own[row.role(variant, n)].copy_(torch.from_numpy(row.chain_host[n]))

        def make(n):
            return (lambda: variant.backend.run_steps(own, plan, row.scalars, row.domain,
                                                      origins, n), refill)

        s = self.measure(make, row.label)
        mode = "graph" if self.on_card else "launches"
        if (variant.backend.last_strategy, variant.backend.last_chain_mode) != (
                self.served(row.kernel), mode):
            raise AssertionError(f"{row.label}: chained as {variant.backend.last_strategy}, "
                                 f"{variant.backend.last_chain_mode}")
        self.finite(row.label, [own[row.role(variant, n)] for n in row.swap])
        return s, bridged

    def time_nabla(self, n: int, label: str, renumber: bool = False) -> tuple[float, float]:
        """(seconds a step, seconds a call from the host) of ``nabla_x`` on
        the card (the ``torch`` backend). The step is device only: a chain
        of calls captured into one CUDA graph (each call inline within the
        capture), as bench.py chains them in one jitted loop
        (bench.py:701-718), so that a step is the operator's device work
        and not the host's, which the fit of two chains of host calls could
        not separate within the spread. What a user's call costs is the
        second number: a warm call through the entry point, one replay of
        the operator's own graph, the median of ``TRIALS`` readings of
        ``HOST_CALLS`` warm calls by CUDA events (host and device), its
        spread in ``host_spread_pct``. No
        step's result feeds the next: bench.py's carry keeps XLA from
        eliding steps, which a graph's replay does not do, and carried, the
        values of this derivative grow from step to step towards float32's
        limit.
        The first result is held against ``numpy`` on the host, each graph's
        last against it to the bit (on CPU tensors the calls themselves are
        timed)."""
        from gt4py_tpu_torch.instrumentation.timing import events_ms
        from tests import torch_next_defs as ndefs

        torch = self.torch
        want = nabla_first(n, "numpy", "cpu", renumber)
        args, provider, out = nabla_row(n, self.device, renumber)

        def chain(steps):
            for _ in range(steps):
                ndefs.nabla_x(*args, out=out, offset_provider=provider)

        chain(1)
        self.agree(f"{label} against numpy", out.asnumpy(), want, *NABLA_TOL)
        first = out.ndarray.clone()

        def make(steps):
            if not self.on_card:
                return (lambda: chain(steps)), None
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                chain(steps)
            out.ndarray.zero_()
            graph.replay()
            if not torch.equal(out.ndarray, first):
                raise AssertionError(f"{label}: the graph of {steps} calls differs from a call")
            return graph.replay, None

        s = self.measure(make, label)
        self.finite(label, [out.ndarray])
        host_ms = self.host_timer.repeat(lambda: events_ms(lambda: chain(1), HOST_CALLS),
                                         f"{label}_host_call")
        return s, host_ms * 1e-3

    def gather_ns(self, rows: int, table: int, calls: int = 20) -> float:
        """ns a row of ``torch.index_select`` gathering ``rows`` random rows
        of a float32 table of ``table`` rows on the device (``calls`` calls
        behind a spin kernel): the card's gather rate."""
        from gt4py_tpu_torch.instrumentation.profiler import spin_ms

        torch = self.torch
        gen = torch.Generator(device=self.device).manual_seed(9)
        x = torch.rand(table, generator=gen, device=self.device)
        idx = torch.randint(0, table, (rows,), generator=gen, device=self.device)
        out = torch.empty(rows, device=self.device)
        torch.index_select(x, 0, idx, out=out)
        if not torch.equal(out, x[idx]):
            raise AssertionError("gather probe: index_select differs from indexing")
        ms = spin_ms(lambda: [torch.index_select(x, 0, idx, out=out) for _ in range(calls)], calls,
                     "gather")
        return ms * 1e6 / rows

    # -- the triads ---------------------------------------------------------------------

    def time_triad(self, label: str, shape, dtype: str, alpha: float) -> float:
        """Seconds a step of bench.py's triad carry ``(x, y) -> (y * alpha +
        b, x)`` from ``(a, 0)``, ``alpha`` as bench.py's literal in the
        tensors' type; its second step held against NumPy."""
        torch = self.torch
        rng = np.random.default_rng(10)
        a_host = host_tensor(uniform(rng, shape), dtype)
        b = host_tensor(uniform(rng, shape), dtype).to(self.device)
        bufs = [torch.empty(shape, dtype=b.dtype, device=self.device) for _ in range(3)]

        def reset():
            bufs[0].copy_(a_host)
            bufs[1].zero_()

        def run_steps(steps):
            x, y, z = bufs
            for _ in range(steps):
                torch.add(b, y, alpha=alpha, out=z)
                x, y, z = z, x, y
            return x

        reset()
        got = run_steps(2).float().cpu().numpy()
        a32, b32 = a_host.float().numpy(), b.float().cpu().numpy()
        self.agree(f"{label} against NumPy", got, a32 * np.float32(alpha) + b32,
                   *ORACLE_TOL[dtype])
        s = self.measure(lambda n: (lambda: run_steps(n), reset), label)
        self.finite(label, bufs)
        return s

    # -- the probes -------------------------------------------------------------------

    def time_probe(self, kind: str, params: tuple) -> float:
        """µs of one application of a calibration probe
        (``calibration.fit_us`` on the bench's timer), its first application
        equal to the plain version on the card to the bit."""
        cal, torch = self.calibration, self.torch
        name = cal.variant_name(kind, params)
        inputs = cal.make_inputs(kind, device=self.device, seed=11,
                                 size=cal.shape(kind, *self.size, self.halo))
        got, want = cal.apply(kind, inputs, params), cal.run_plain(kind, inputs, params)
        ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        if not (bool(torch.isfinite(got).all()) and torch.equal(got.view(ints), want.view(ints))):
            raise AssertionError(f"{name}: differs from the plain version or is not finite")
        return cal.fit_us(kind, inputs, params, trials=TRIALS, timer=self.timer)["us"]

    # -- program call overhead ----------------------------------------------------------

    def program_call_overhead(self) -> dict:
        """benchmarks/benchmark_program_call.py (:33-130) on ``cuda:hopper``
        objects at its sizes: µs a warm call by the host clock, the card
        synchronised after the timed loop; each object's first result
        checked. Each key is read ``TRIALS`` times after one reading to warm
        (``StepTimer.repeat``): the median is the key, its spread under the
        key's name in ``host_spread_pct``. ``chained_per_step_us`` is that
        script's two-point fit of its two chain lengths, each timed as the
        script times it, by ``StepTimer.measure`` (min-fit, median spread);
        ``chain_dispatch_us`` the shorter chain's call."""
        import gt4py_tpu_torch.next as gtx
        from gt4py_tpu_torch import storage
        from tests import torch_next_defs as ndefs
        from tests import torch_stencil_defs as defs

        torch, dev, timer = self.torch, self.device, self.host_timer

        def timeit_ms(fn, n=PC_CALLS, warmup=PC_WARMUP):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        def key(name, fn, n=PC_CALLS, warmup=PC_WARMUP):
            out[name] = timer.repeat(lambda: timeit_ms(fn, n, warmup), name)

        out = {}
        st = build_stencil(defs.copy_generic, "cuda:hopper", "float32")
        a = storage.ones(PC_DOMAIN, np.float32, backend="cuda:hopper", device=dev)
        b = storage.zeros(PC_DOMAIN, np.float32, backend="cuda:hopper", device=dev)
        st(a, b)
        self.agree("call overhead: copy", b.array.cpu(), np.ones(PC_DOMAIN), 0.0, 0.0)
        key("stencil_call_us", lambda: st(a, b))
        key("stencil_call_novalidate_us", lambda: st(a, b, validate_args=False))
        frozen = st.freeze(origin={"src": (0, 0, 0), "dst": (0, 0, 0)}, domain=PC_DOMAIN)
        key("frozen_call_us", lambda: frozen(src=a, dst=b))
        swap = {"src": "dst", "dst": "src"}
        st.chain(2, a, b, swap=swap)
        n_lo, n_hi = PC_CHAINS

        def chain_calls(n):
            return (lambda: st.chain(n, a, b, swap=swap)), None

        out["chained_per_step_us"] = timer.measure(
            chain_calls, "chained_per_step_us", n_lo, n_hi,
            clock=lambda run: timeit_ms(run, PC_CHAIN_CALLS, PC_CHAIN_WARMUP))
        key("chain_dispatch_us", chain_calls(n_lo)[0], PC_CHAIN_CALLS, PC_CHAIN_WARMUP)

        copy = ndefs.copy_op.with_backend("cuda:hopper")
        f = gtx.as_field({ndefs.CallI: 64}, np.arange(64.0), device=dev)
        fo = gtx.zeros({ndefs.CallI: 64}, device=dev)
        copy(f, out=fo)
        self.agree("call overhead: copy_op", fo.asnumpy(), np.arange(64.0), 0.0, 0.0)
        key("field_operator_call_us", lambda: copy(f, out=fo))

        scan = ndefs.cumsum.with_backend("cuda:hopper")
        x = np.random.default_rng(0).random((16, 8))
        f2 = gtx.as_field([ndefs.CallIb, ndefs.CallKb], x, device=dev)
        so = gtx.zeros({ndefs.CallIb: 16, ndefs.CallKb: 8}, device=dev)
        scan(f2, out=so)
        self.agree("call overhead: cumsum", so.asnumpy(), np.cumsum(x, axis=1), 1e-12, 0.0)
        key("scan_call_us", lambda: scan(f2, out=so))

        prog = ndefs.pipeline.with_backend("cuda:hopper")
        pa = gtx.as_field([ndefs.CallI], np.arange(64.0), device=dev)
        tmp, po = gtx.zeros({ndefs.CallI: 64}, device=dev), gtx.zeros({ndefs.CallI: 64}, device=dev)
        prog(pa, tmp, po)
        self.agree("call overhead: pipeline", po.asnumpy(), 2 * np.arange(64.0) + 1, 0.0, 0.0)
        key("program_call_2ops_us", lambda: prog(pa, tmp, po))
        return {k: v * 1e3 for k, v in out.items()}

    # -- bf16 capacity ------------------------------------------------------------------

    def capacity(self) -> dict:
        """bench.py:1690-1748: three bfloat16 buffers of a domain sized from
        the free device memory (``capacity_domain``), ``CAP_STEPS`` in-place
        updates ``cur = cur * 0.999 + c * 0.001`` timed by CUDA events, the
        first held against NumPy on a slice; then the same three buffers in
        float32, which must not fit: the ``OutOfMemoryError`` of that
        attempt is the row's expected result. Frees what it took."""
        torch = self.torch
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(self.device)
        dom = capacity_domain(free, *self.cap)
        points = dom[0] * dom[1] * dom[2]
        gen = torch.Generator(device=self.device).manual_seed(90)
        x = torch.rand(dom, generator=gen, device=self.device, dtype=torch.bfloat16)
        c = torch.rand(dom, generator=gen, device=self.device, dtype=torch.bfloat16)
        cur = x.clone()

        def step():
            cur.mul_(0.999).add_(c, alpha=0.001)

        step()
        got = cur[:1, :64].float().cpu().numpy()
        want = (x[:1, :64].double() * 0.999 + c[:1, :64].double() * 0.001).cpu().numpy()
        self.agree("bf16 capacity against NumPy", got, want, *ORACLE_TOL["bfloat16"])
        step()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(CAP_STEPS):
            step()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end) * 1e-3 / CAP_STEPS
        self.finite("bf16 capacity", [cur])
        del x, c, cur
        torch.cuda.empty_cache()
        fits = True
        held = []
        try:
            for _ in range(3):
                held.append(torch.empty(dom, dtype=torch.float32, device=self.device))
        except torch.cuda.OutOfMemoryError:
            fits = False
        del held
        torch.cuda.empty_cache()
        log(f"[bench] bf16 capacity: {dom}, {points / 1e9:.2f} G points, "
            f"{3 * points * 2 / 1e9:.1f} GB in bfloat16 of {free / 1e9:.1f} GB free; "
            f"float32 fits: {fits}")
        return {"bf16_capacity_domain": "x".join(map(str, dom)),
                "bf16_capacity_us_per_step": t * 1e6, "bf16_capacity_Ggps": points / t / 1e9,
                "bf16_capacity_f32_compiles": fits}

    # -- the run ------------------------------------------------------------------------

    def build_all(self, rows, views) -> None:
        """Every kernel of the rows built at once (one ``nvcc`` a source):
        the cartesian rows' stencils, the field-view rows' bridged variants
        (traced by a CPU call at a small size: a variant is keyed by dims,
        dtypes and the out K range) and the probes. The call overhead's
        small stencil and variants build at their first call."""
        from gt4py_tpu_torch.cartesian.backend import cuda_backend

        stencils = [row.build("cuda:hopper") for row in rows]
        nk = self.size[2]
        small = [next_hdiff_row(8, 8, nk, device="cpu"), next_tridiag_row(8, 8, nk, device="cpu"),
                 next_vadv_row(8, 8, nk, device="cpu")]
        variants = []
        for big, cpu in zip(views, small):
            cpu.hopper = big.hopper
            variants.append(cpu.variant(cpu.call("cuda:hopper")))
        sources = [s._backend.module.source for s in stencils]
        sources += [v.backend.module.source for v in variants]
        sources.append(self.calibration.source())
        if not self.on_card:
            return
        t0 = time.perf_counter()
        cuda_backend.build_libraries(sources)
        log(f"[bench] built {len(sources)} sources in {time.perf_counter() - t0:.1f} s")

    def run(self) -> dict:
        from gt4py_tpu_torch.instrumentation.timing import copy_bandwidth

        cal, res = self.calibration, self.results
        (ni, nj, nk), halo, dev = self.size, self.halo, self.device
        points = ni * nj * nk
        rows = {r.label: r for r in (
            hdiff_row("float32", ni, nj, nk, halo), hdiff_row("bfloat16", ni, nj, nk, halo),
            vadv_row(ni, nj, nk), tridiag_row(ni, nj, nk), small_row("copy48", self.n48),
            small_row("lap48", self.n48))}
        views = [next_hdiff_row(ni, nj, nk, halo, dev), next_tridiag_row(ni, nj, nk, dev),
                 next_vadv_row(ni, nj, nk, dev)]
        self.build_all(list(rows.values()), views)
        peak = cal.peak_memory_Bps(dev)

        # hdiff, f32 then bf16 (bench.py:187-351)
        prepared = {}
        for label in ("hdiff", "hdiff_bf16"):
            prepared[label] = self.prepare(rows[label])
        t_hdiff = self.time_stencil(rows["hdiff"], *prepared["hdiff"])
        self.put_hdiff(t_hdiff, peak)
        t_bf = self.time_stencil(rows["hdiff_bf16"], *prepared["hdiff_bf16"])
        bf_frac = hdiff_bytes(ni, nj, nk, halo, 2) / t_bf / peak
        res.update(hdiff_bf16_Ggps=points / t_bf / 1e9, hdiff_bf16_us_per_step=t_bf * 1e6,
                   hdiff_bf16_roofline_frac=bf_frac, hdiff_bf16_vs_f32_speedup=t_hdiff / t_bf)

        # vadv and tridiag (bench.py:353-545)
        t_vadv = self.time_stencil(rows["vadv"], *self.prepare(rows["vadv"]))
        vpoints = vadv_points(ni, nj, nk)
        res.update(vadv_Ggps=vpoints / t_vadv / 1e9, vadv_us_per_step=t_vadv * 1e6,
                   vadv_roofline_frac=vadv_bytes(ni, nj, nk) / t_vadv / peak)
        t_tri = self.time_stencil(rows["tridiag"], *self.prepare(rows["tridiag"]))
        res.update(tridiag_Ggps=points / t_tri / 1e9, tridiag_us_per_step=t_tri * 1e6,
                   tridiag_roofline_frac=tridiag_bytes(ni, nj, nk) / t_tri / peak)

        # next hdiff and the FVM nabla (bench.py:547-1013)
        t_nh, bridged = self.time_view(views[0])
        res.update(next_hdiff_us_per_step=t_nh * 1e6, next_hdiff_vs_cartesian=t_nh / t_hdiff,
                   next_hdiff_bridged=bridged)
        small_mesh, big_mesh = self.nablas
        nv, nvb = small_mesh ** 2, big_mesh ** 2
        host = {}
        t_nb, host["fvm_nabla"] = self.time_nabla(small_mesh, "fvm_nabla")
        # the port has no shift plan (ROADMAP Queue 2, not ported): every
        # remap is a gather, so no mesh takes bench.py's structured path
        res.update(fvm_nabla_us_per_step=t_nb * 1e6, fvm_nabla_Mvertices_s=nv / t_nb / 1e6,
                   fvm_nabla_structured=False,
                   fvm_nabla_stream_frac=nabla_bytes(nv) / t_nb / peak)
        t_nbi, host["fvm_nabla_irregular"] = self.time_nabla(small_mesh, "fvm_nabla_irregular",
                                                             renumber=True)
        rows_ns = self.gather_ns(gathered_rows(nv), 2 * nv)
        res.update(fvm_nabla_irregular_us_per_step=t_nbi * 1e6,
                   fvm_nabla_irregular_gather_ceiling_frac=(
                       gathered_rows(nv) * rows_ns * 1e-9 / t_nbi))
        log(f"[bench] the card's gather: {rows_ns:.4f} ns a row")
        t_nbb, host["fvm_nabla_1M"] = self.time_nabla(big_mesh, "fvm_nabla_1M")
        res.update(fvm_nabla_1M_us_per_step=t_nbb * 1e6, fvm_nabla_1M_Mvertices_s=nvb / t_nbb / 1e6,
                   fvm_nabla_1M_stream_frac=nabla_bytes(nvb) / t_nbb / peak,
                   fvm_nabla_host_call_us={k: v * 1e6 for k, v in host.items()})

        # the field-view scans (bench.py:1019-1238)
        t_ntri, bridged = self.time_view(views[1])
        res.update(next_tridiag_us_per_step=t_ntri * 1e6, next_tridiag_vs_cartesian=t_ntri / t_tri,
                   next_tridiag_bridged=bridged)
        t_nvadv, bridged = self.time_view(views[2])
        res.update(next_vadv_us_per_step=t_nvadv * 1e6, next_vadv_vs_cartesian=t_nvadv / t_vadv,
                   next_vadv_bridged=bridged)

        # the triads and the device copy (bench.py:1240-1324)
        shape = (ni + 2 * halo, nj + 2 * halo, nk)
        t_triad = self.time_triad("stream_triad", shape, "float32", 1.0001)
        triad_frac = triad_bytes(shape) / t_triad / peak
        res.update(stream_triad_us=t_triad * 1e6, practical_bw_frac=triad_frac,
                   hdiff_vs_practical_ceiling=res["hdiff_roofline_frac"] / triad_frac,
                   device_copy_GBps=copy_bandwidth(self.device) / 1e9)
        alpha16 = float(self.torch.tensor(1.0009, dtype=self.torch.bfloat16))
        t_triad16 = self.time_triad("stream_triad_bf16", shape, "bfloat16", alpha16)
        tb_us, tf_us = res["hdiff_bf16_us_per_step"], res["hdiff_us_per_step"]
        res.update(stream_triad_bf16_us=t_triad16 * 1e6,
                   hdiff_bf16_vs_stream_floor=tb_us / (t_triad16 * 1e6),
                   hdiff_bf16_compute_bound=bool(t_triad16 * 1e6 * 1.3 < tb_us <= tf_us * 1.05))

        # the probes and bench.py's ceilings (bench.py:1326-1569)
        times = {}
        for kind, params in [("bf16_windows", (0,)), ("bf16_windows", (1,)), ("plane_walk5", ()),
                             *(("probe_walk", p) for p in cal.BENCH_PROBES)]:
            times[cal.variant_name(kind, params)] = self.time_probe(kind, params)
        walk_us = {"tridiag": t_tri * 1e6, "vadv": t_vadv * 1e6, "hdiff_bf16": tb_us}
        ceil = cal.ceilings(times, ni, nj, nk, halo, walk_us=walk_us,
                            copy_Bps=res["device_copy_GBps"] * 1e9, l2=cal.l2_bytes(dev))
        for key in ("bf16_window_cost_us", "hdiff_bf16_vpu_model_us", "hdiff_bf16_vs_vpu_model",
                    "planewalk5_us_per_step", "planewalk5_GBps", "tridiag_vs_planewalk_ceiling",
                    "vadv_vs_planewalk_ceiling", "chain_copy_rate_TBps", "chain_fma_ps_per_point",
                    "chain_div_ps_per_point"):
            res[key] = ceil[key]
        for w in ("tridiag", "vadv"):
            for key in ("copy_floor_us", "compute_model_us", "chain_ceiling_us",
                        "vs_chain_ceiling"):
                res[f"{w}_{key}"] = ceil[f"{w}_{key}"]

        # copy and Laplacian at 48³ (bench.py:1571-1663)
        for label in ("copy48", "lap48"):
            t_l = self.time_stencil(rows[label], *self.prepare(rows[label]), chains=SMALL_CHAINS)
            res[f"{label}_us_per_step"] = t_l * 1e6
            res[f"{label}_Ggps"] = self.n48 ** 3 / t_l / 1e9

        # hdiff again, the better reading kept (bench.py:1665-1688)
        t_hdiff2 = self.time_stencil(rows["hdiff"], *prepared["hdiff"])
        if t_hdiff2 < t_hdiff:
            self.put_hdiff(t_hdiff2, peak)
            res["hdiff_vs_practical_ceiling"] = res["hdiff_roofline_frac"] / triad_frac

        res["program_call_overhead"] = self.program_call_overhead()
        del prepared, views
        # the capacity row last, on a card with nothing else held
        res.update(self.capacity())
        res["compile_warm_s"] = {**self.timer.compile_times, **self.host_timer.compile_times}
        res["measurement_spread_pct"] = dict(self.timer.spread_pct)
        res["host_spread_pct"] = dict(self.host_timer.spread_pct)
        wide = wide_spreads(res["measurement_spread_pct"])
        if wide:
            raise AssertionError(f"spreads of {SPREAD_PCT} % or more: {wide}")
        missing, extra = set(DETAIL_KEYS) - set(res), set(res) - set(DETAIL_KEYS)
        if missing or extra:
            raise AssertionError(f"details: missing {sorted(missing)}, unexpected {sorted(extra)}")
        return {
            "metric": "hdiff_256x256x80_f32_throughput",
            "value": res["hdiff_Ggps"],
            "unit": "Ggridpoints/s",
            "vs_baseline": res["hdiff_roofline_frac"] / TARGET,
            "device": self.torch.cuda.get_device_name(self.device),
            "peak_hbm_GBps": peak / 1e9,
            "details": {k: res[k] for k in DETAIL_KEYS},
        }

    def put_hdiff(self, t: float, peak: float) -> None:
        ni, nj, nk = self.size
        self.results.update(hdiff_Ggps=ni * nj * nk / t / 1e9, hdiff_us_per_step=t * 1e6,
                            hdiff_roofline_frac=hdiff_bytes(ni, nj, nk, self.halo) / t / peak)


def wide_spreads(spreads: dict) -> dict:
    """The readings of ``spreads`` (label -> %) whose spread is not under
    ``SPREAD_PCT`` (NaN included)."""
    return {k: v for k, v in spreads.items() if not abs(v) < SPREAD_PCT}


def finite_values(value) -> bool:
    """Every number in ``value`` (a number, a bool, a string, or a dict of
    them) is finite, and a string is not empty."""
    if isinstance(value, dict):
        return bool(value) and all(finite_values(v) for v in value.values())
    if isinstance(value, str):
        return bool(value)
    return isinstance(value, (bool, int, float)) and math.isfinite(value)


def main(argv) -> int:
    import torch

    if argv[1:]:
        print(f"usage: {argv[0]}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.instrumentation.timing import card_line

    t0 = time.perf_counter()
    log(f"[bench] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = Bench("cuda").run()
    bad = [k for k, v in out["details"].items() if not finite_values(v)]
    if bad:
        raise AssertionError(f"details not finite: {bad}")
    log(f"[bench] done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
