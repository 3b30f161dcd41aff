"""Calibration probes of the walk kernels, on the card.

Counterpart of bench.py:1325-1570: the three calibration probes inside
``bench.py::main`` (``_mk_bf16_probe``, ``_pw_kernel`` and ``_mk_probe``, the
last three ``pallas_call``s of the repository) and the arithmetic that turns
their times into ceilings. On the TPU they are Pallas kernels chained by a
jitted ``fori_loop``; here each is a hand-written CUDA C++ kernel
(``calibration.cu`` beside this module) chained by a CUDA graph.

- :func:`probe_walk` (P1, ``_mk_probe(m_fma, n_div)``): four float32 inputs
  and one output over (nk, ni, nj/2) planes, m products-and-sums or n
  divisions a point; the chain carries ``(a, b, c, d) -> (o, a, b, c)``.
- :func:`plane_walk5` (P2, ``_pw_kernel``): ``o = a + b*c - d`` over
  (nk, ni, nj) float32 planes; the chain carries ``d <- o``.
- :func:`bf16_windows` (P3, ``_mk_bf16_probe(n_windows)``): a bfloat16 copy of
  (nk, ni + 2 halo, nj + 2 halo) planes plus n windows shifted along J with
  wrap-around; the chain carries ``a <- o``.

P2 keeps the column walks' shape (one thread an (i, j) point walking the
planes), so that it measures what a plain walk costs; P1 and P3 are
pointwise over the flat tensor (P3 but for its wrap along J), each thread
one 16-byte vector of every tensor, so that they measure the card.

Each entry point launches its kernel on CUDA tensors and runs its plain
PyTorch version (``*_plain``, every operation rounded separately) on CPU
tensors; there is no other path. :class:`Chain` captures n chained launches
into one CUDA graph (``cuda_backend.capture_graph``), :func:`fit_us` times a
variant, or the one PyTorch call that computes the same function
(``LIBRARY``), with the two-point fit of bench.py's ``StepTimer.measure``
(bench.py:110-160), :func:`ceilings` computes bench.py's ceilings from
the fitted times, :func:`instruction_bound` the least time a probe's
instructions and bytes allow, and :func:`l2_read_rate` the rate at which the
SMs read bytes that stay in the L2 (``l2_read``, the yardstick of that
bound for a probe whose bytes stay there across a chain). The module lives beside the ``cuda:hopper`` backend, whose
machinery it uses: the kernels are built by ``cuda_backend.load_library``
with the stencil kernels' flags (``sm_90a``, ``--fmad=false``) into
``.gt_cache/torch/cuda/``, and each probe's
:class:`~gt4py_tpu_torch.cartesian.backend.cuda_backend.KernelWrapper`
counts its launches (``WRAPPERS``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.instrumentation.profiler import spin_ms

#: bench.py's sizes (bench.py:180-181), the main path's
NI, NJ, NK, HALO = 256, 256, 80, 2
SOURCE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "calibration.cu")

#: P1's gain and shift, float32 as in bench.py:1488-1490 (1 + 2^-23 and 2)
FMA_GAIN = float(np.float32(1.0000001))
DIV_SHIFT = 2.0
#: P1's (m_fma, n_div) variants in bench.py (:1525-1527)
BENCH_PROBES = ((0, 0), (16, 0), (0, 4))
#: P1 variants of the card's own reading (no bench.py key), enough products
#: and sums, or divisions, for an operation's cost to show above the bytes;
#: one application of (128, 0) stays finite from inputs in [0, 1) (its
#: accumulators reach 1.6e11 and ``o`` 1.5e22), at (256, 0) every point
#: overflows
CARD_PROBES = ((128, 0), (0, 64))
#: every instantiated P1 variant
PROBE_WALK_VARIANTS = BENCH_PROBES + CARD_PROBES
#: P3's instantiated window counts (bench.py:1378-1386)
BF16_WINDOWS = (0, 1)

PROBE_WALK = cuda_backend.KernelWrapper("probe_walk")
PLANE_WALK5 = cuda_backend.KernelWrapper("plane_walk5")
BF16_WINDOWS_KERNEL = cuda_backend.KernelWrapper("bf16_windows")
WRAPPERS = {w.name: w for w in (PROBE_WALK, PLANE_WALK5, BF16_WINDOWS_KERNEL)}
#: the L2 yardstick's launches (no TPU kernel's port, so not in WRAPPERS)
L2_READ = cuda_backend.KernelWrapper("l2_read")

#: chain lengths of the two-point fit (bench.py fits 202 and 3202 steps of a
#: jitted loop; a graph's launches need fewer to swamp its fixed cost), and
#: shorter ones by variant: P1 (0, 64)'s chain reaches float32's subnormals
#: by its 24th step from the inputs, where the division takes its slow path
FIT_CHAINS = (20, 220)
SHORT_FIT_CHAINS = {("probe_walk", (0, 64)): (2, 12)}
FIT_TRIALS = 5
#: spin-kernel cycles first put ahead of a timed replay (about 0.5 ms), and
#: the times it may grow fourfold
SPIN_CYCLES, SPIN_TRIES = 1_000_000, 6
#: the chain that is checked against the plain version: 3 applications, or
#: fewer where the values overflow sooner from inputs in [0, 1): P1
#: (128, 0) overflows in its second application
CHECKED_CHAIN = 3
FINITE_CHAINS = {("probe_walk", (128, 0)): 1}
#: the one PyTorch call that computes a variant's function, where there is
#: one (P3 with no window is a copy): (inputs, out) -> out
LIBRARY = {("bf16_windows", (0,)): lambda inputs, out: out.copy_(inputs[0])}
#: the H100's L2 cache, 50 MiB, where the card does not report its own
#: (``L2_cache_size``): a probe whose bytes fit can stay there across a chain
L2_BYTES = 50 * 2**20
#: the lanes an SM of the H100 issues a clock on its FP32 pipe and on its
#: MUFU (reciprocal) pipe
FP32_LANES, MUFU_LANES = 128, 16
#: the L2 yardstick's passes over its buffer a launch
L2_READ_PASSES = 8
#: threads an SM of the H100 holds
SM_THREADS = 2048
#: points a thread of the vector kernels owns: P1 one 16-byte vector of
#: float32, P3 CAL_BF16_VECTORS (4) vectors of 8 bfloat16
POINTS_A_THREAD = {"probe_walk": 4, "bf16_windows": 32}
#: bench.py's least operations a point of its walks (bench.py:1537-1545):
#: (multiplications and additions, divisions)
WALK_OPS = {"tridiag": (8, 1), "vadv": (29, 1)}
#: bench.py's float32 streams of its walks (bench.py:1452)
WALK_STREAMS = {"tridiag": 5, "vadv": 6}


# -- the variants ------------------------------------------------------------------


def variants() -> list[tuple[str, tuple]]:
    """Every instantiated (kind, params): P1's (m_fma, n_div), P2's (), P3's
    (n_windows,)."""
    return ([("probe_walk", v) for v in PROBE_WALK_VARIANTS] + [("plane_walk5", ())]
            + [("bf16_windows", (n,)) for n in BF16_WINDOWS])


def checked_chain(kind: str, params: tuple = ()) -> int:
    """Applications in the chain held against the plain version: its values
    stay finite from :func:`make_inputs`."""
    return FINITE_CHAINS.get((kind, tuple(params)), CHECKED_CHAIN)


def variant_name(kind: str, params: tuple = ()) -> str:
    if kind == "probe_walk":
        return f"probe_walk_m{params[0]}_n{params[1]}"
    if kind == "bf16_windows":
        return f"bf16_windows_n{params[0]}"
    return kind


def shape(kind: str, ni: int = NI, nj: int = NJ, nk: int = NK, halo: int = HALO) -> tuple:
    """The (K, I, J) planes a probe walks at bench.py's sizes."""
    if kind == "probe_walk":
        return (nk, ni, nj // 2)
    if kind == "plane_walk5":
        return (nk, ni, nj)
    if kind == "bf16_windows":
        return (nk, ni + 2 * halo, nj + 2 * halo)
    raise ValueError(f"no calibration probe '{kind}'")


def n_inputs(kind: str) -> int:
    return 1 if kind == "bf16_windows" else 4


def dtype(kind: str) -> torch.dtype:
    return torch.bfloat16 if kind == "bf16_windows" else torch.float32


def make_inputs(kind: str, device="cuda", seed: int = 0, size: Optional[tuple] = None) -> tuple:
    """The probe's inputs, uniform in [0, 1) as bench.py's ``device_random``,
    from a ``torch.Generator`` seeded with ``seed``, on ``device`` (the card
    unless the caller asks for the CPU), at ``size`` or :func:`shape`."""
    size = tuple(size or shape(kind))
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.rand(size, generator=gen, device=device).to(dtype(kind))
        for _ in range(n_inputs(kind))
    )


def operations(kind: str, params: tuple, size: Sequence[int]) -> int:
    """Arithmetic operations one application does: P1 two a product and
    sum, two a division (the shift and the quotient), three for ``o``; P2
    three; P3 one add a window."""
    points = int(np.prod(size))
    if kind == "probe_walk":
        return (2 * params[0] + 2 * params[1] + 3) * points
    if kind == "plane_walk5":
        return 3 * points
    return params[0] * points


def instruction_bound(per_point: dict, points: int, nbytes: int, clock_mhz: float,
                      sms: int, bytes_per_s: float) -> tuple[float, str]:
    """(µs, "bytes" or "operations"): the least time the card takes for
    ``points`` points of a kernel that issues ``per_point`` instructions a
    point by pipe (``{"fp32": n, "mufu": m}``, from its SASS) and moves
    ``nbytes``. Under ``--fmad=false`` every product and sum issues alone
    and an IEEE division is an ``MUFU.RCP`` with several FP32 instructions,
    so a count of operations at the FMA peak does not bound it. Each pipe
    takes its instructions at its lanes an SM a clock (``FP32_LANES``,
    ``MUFU_LANES``) on ``sms`` SMs at ``clock_mhz``; the pipes run side by
    side, so the slower one bounds; the bound is the larger of that and the
    bytes over ``bytes_per_s`` (the device memory's rate, or for bytes that
    stay in the L2 across a chain the L2's, :func:`l2_read_rate`)."""
    cycles = points / sms * max(per_point.get("fp32", 0) / FP32_LANES,
                                per_point.get("mufu", 0) / MUFU_LANES)
    by_bytes, by_ops = nbytes / bytes_per_s * 1e6, cycles / clock_mhz
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


# -- the plain versions ------------------------------------------------------------


def probe_walk_plain(a, b, c, d, m_fma: int, n_div: int) -> torch.Tensor:
    """P1 in PyTorch, every product, sum and division rounded to float32."""
    accs = [a, b, c, d]
    for i in range(m_fma):
        accs[i % 4] = accs[i % 4] * FMA_GAIN + accs[(i + 1) % 4]
    for i in range(n_div):
        accs[i % 4] = accs[i % 4] / (accs[(i + 1) % 4] + DIV_SHIFT)
    return accs[0] + accs[1] * accs[2] - accs[3]


def plane_walk5_plain(a, b, c, d) -> torch.Tensor:
    """P2 in PyTorch: the product, the sum and the difference rounded apart."""
    return a + b * c - d


def bf16_windows_plain(a, n_windows: int) -> torch.Tensor:
    """P3 in PyTorch: bfloat16 adds, each rounded to bfloat16."""
    x = a.clone()
    for w in range(n_windows):
        x = x + torch.roll(a, -(w + 1), dims=2)
    return x


def run_plain(kind: str, inputs: Sequence[torch.Tensor], params: tuple = ()) -> torch.Tensor:
    if kind == "probe_walk":
        return probe_walk_plain(*inputs, *params)
    if kind == "plane_walk5":
        return plane_walk5_plain(*inputs)
    return bf16_windows_plain(*inputs, *params)


# -- the kernels -------------------------------------------------------------------


def source() -> str:
    with open(SOURCE_PATH) as f:
        return f.read()


def define(name: str) -> int:
    """The value of an integer ``#define`` of calibration.cu."""
    found = re.search(rf"#define {name} (\d+)", source())
    if found is None:
        raise KeyError(f"calibration.cu defines no integer {name}")
    return int(found.group(1))


_FUNCTIONS: dict = {}


def _functions() -> dict:
    """The launchers, built (once per source hash, on disk) and bound."""
    if not _FUNCTIONS:
        lib = cuda_backend.load_library(source())
        ll, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        sizes = [ll, ll, ll, ptr]  # ni, nj, nk, the stream
        for name, args in (("gt_probe_walk", [i32, i32] + [ptr] * 5 + sizes),
                           ("gt_plane_walk5", [ptr] * 5 + sizes),
                           ("gt_bf16_windows", [i32, ptr, ptr] + sizes),
                           ("gt_l2_read", [ptr, ll, i32, ptr, i32, ptr])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
            _FUNCTIONS[name] = fn
    return _FUNCTIONS


def _check(kind: str, inputs: Sequence[torch.Tensor], params: tuple, out) -> torch.Tensor:
    """Raise on what the kernel does not take; return the output tensor."""
    if kind == "probe_walk" and params not in PROBE_WALK_VARIANTS:
        raise ValueError(f"probe_walk (m_fma, n_div) = {params} is not instantiated; "
                         f"built: {PROBE_WALK_VARIANTS}")
    if kind == "bf16_windows" and params[0] not in BF16_WINDOWS:
        raise ValueError(f"bf16_windows n_windows = {params[0]} is not instantiated; "
                         f"built: {BF16_WINDOWS}")
    first = inputs[0]
    for t in inputs:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype(kind) or t.ndim != 3:
            raise TypeError(f"{kind} takes 3-d {dtype(kind)} tensors")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{kind}: every input must have the shape {tuple(first.shape)} "
                             f"on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kind} takes contiguous (K, I, J) tensors")
    if kind == "bf16_windows" and params[0] >= first.shape[2]:
        raise ValueError(f"bf16_windows: {params[0]} windows need more than {first.shape[2]} "
                         "points along J")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kind} runs on CUDA or CPU tensors, not {first.device}")
    if out is None:
        return torch.empty_like(first)
    if (out.dtype != first.dtype or out.shape != first.shape or out.device != first.device
            or not out.is_contiguous()):
        raise ValueError(f"{kind}: out must be a contiguous {first.dtype} tensor of shape "
                         f"{tuple(first.shape)} on {first.device}")
    roles = {f"in{n}": t for n, t in enumerate(inputs)}
    if any("out" in pair for pair in cuda_backend.overlapping({**roles, "out": out})):
        raise ValueError(f"{kind}: out shares memory with an input")
    return out


def apply(kind: str, inputs: Sequence[torch.Tensor], params: tuple = (), out=None,
          counted: bool = True) -> torch.Tensor:
    """One application of the probe ``kind`` (``params`` as :func:`variants`
    gives them) into ``out`` (a new tensor where None): its kernel on CUDA
    tensors, launched on the current stream, ``counted`` on its wrapper (a
    launch captured into a graph is counted at each replay instead); its
    plain version on CPU tensors."""
    out = _check(kind, inputs, params, out)
    if out.device.type == "cpu":
        return out.copy_(run_plain(kind, inputs, params))
    nk, ni, nj = out.shape
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream)
        ptrs = [t.data_ptr() for t in (*inputs, out)]
        WRAPPERS[kind].launch(_functions()[f"gt_{kind}"],
                              (*params, *ptrs, ni, nj, nk, stream), counted)
    return out


def probe_walk(a, b, c, d, m_fma: int = 0, n_div: int = 0, out=None) -> torch.Tensor:
    """P1 (bench.py:1484-1494): the kernel on CUDA tensors, the plain
    version on CPU tensors; into ``out`` where given."""
    return apply("probe_walk", (a, b, c, d), (m_fma, n_div), out)


def plane_walk5(a, b, c, d, out=None) -> torch.Tensor:
    """P2 (bench.py:1410-1414), as :func:`probe_walk`."""
    return apply("plane_walk5", (a, b, c, d), (), out)


def bf16_windows(a, n_windows: int = 0, out=None) -> torch.Tensor:
    """P3 (bench.py:1339-1351), as :func:`probe_walk`."""
    return apply("bf16_windows", (a,), (n_windows,), out)


def l2_read_blocks(device) -> int:
    """The L2 yardstick's grid: every SM of the card full (``SM_THREADS``
    threads in blocks of CAL_THREADS)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return SM_THREADS // define("CAL_THREADS") * sms


def l2_read(x: torch.Tensor, out: torch.Tensor, passes: int = L2_READ_PASSES,
            counted: bool = True) -> torch.Tensor:
    """The L2 yardstick on a contiguous, 16-byte aligned float32 CUDA
    tensor ``x`` of a multiple of 4 elements: ``passes`` passes, each
    warp's largest value into ``out`` (float32, one a warp of
    :func:`l2_read_blocks` blocks); its largest is ``torch.amax(x)``."""
    if (x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous()
            or x.numel() % 4 or x.data_ptr() % 16):
        raise ValueError("l2_read takes a contiguous, 16-byte aligned float32 CUDA tensor "
                         "of a multiple of 4 elements")
    blocks = l2_read_blocks(x.device)
    warps = blocks * define("CAL_THREADS") // 32
    if out.dtype != torch.float32 or out.device != x.device or out.numel() < warps:
        raise ValueError(f"l2_read: out must hold {warps} float32 on {x.device}")
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        L2_READ.launch(_functions()["gt_l2_read"],
                       (x.data_ptr(), x.numel() // 4, passes, out.data_ptr(), blocks, stream),
                       counted)
    return out


# -- the chains --------------------------------------------------------------------


def carry(kind: str, buffers: Sequence[torch.Tensor], n: int) -> list[tuple[tuple, torch.Tensor]]:
    """(inputs, output) of each of ``n`` chained applications over
    ``buffers``, rotating as bench.py's ``fori_loop`` carry: P1 a ring of 5
    (each launch writes the buffer the launch before it dropped, so no
    launch writes what it reads), P2 ``d`` and P3 ``a`` in a ping-pong."""
    steps = []
    if kind == "probe_walk":
        state, free = list(buffers[:4]), buffers[4]
        for _ in range(n):
            steps.append((tuple(state), free))
            state, free = [free] + state[:3], state[3]
    else:
        *fixed, x, y = buffers
        for _ in range(n):
            steps.append(((*fixed, x), y))
            x, y = y, x
    return steps


def chain_plain(kind: str, n: int, inputs: Sequence[torch.Tensor], params: tuple = ()):
    """The plain version ``n`` times with the carry: what :class:`Chain`
    must give."""
    state = list(inputs)
    out = state[3] if kind == "plane_walk5" else state[0]
    for _ in range(n):
        out = run_plain(kind, state, params)
        if kind == "probe_walk":
            state = [out] + state[:3]
        else:
            state[-1] = out
    return out


class Chain:
    """``n`` applications of one probe variant, carried as bench.py's
    ``fori_loop`` carries them (:func:`carry`), on buffers of its own that
    :meth:`reset` fills from ``inputs``; with ``library``, each application
    is the variant's PyTorch call (``LIBRARY``) in place of its kernel. On
    CUDA tensors the ``n`` applications are captured into one CUDA graph,
    after one outside the capture (a capture needs each kernel loaded);
    :meth:`run` replays it and adds the kernels it launched to the probe's
    wrapper. On CPU tensors :meth:`run` applies the plain version ``n``
    times. Nothing is allocated inside the graph."""

    def __init__(self, kind: str, n: int, inputs: Sequence[torch.Tensor], params: tuple = (),
                 library: bool = False):
        self.kind, self.n, self.params, self.inputs = kind, n, tuple(params), tuple(inputs)
        _check(kind, self.inputs, self.params, None)
        self.call = LIBRARY[(kind, self.params)] if library else None
        fixed = self.inputs[:3] if kind == "plane_walk5" else ()
        carried = self.inputs[len(fixed):]
        self.buffers = [*fixed, *(t.clone() for t in carried), torch.empty_like(carried[0])]
        self.steps = carry(kind, self.buffers, n)
        #: the tensor holding the chain's last output after :meth:`run`
        self.result = self.steps[-1][1] if n else self.buffers[len(fixed)]
        #: kernels launched by this chain
        self.launched = 0
        self.graph, self.per_replay = None, 0
        device = self.inputs[0].device
        if device.type != "cuda" or n == 0:
            return
        self.launched += self._launch(self.steps[0], counted=True)
        self.graph, self.per_replay = cuda_backend.capture_graph(device, [
            functools.partial(self._launch, step, counted=False) for step in self.steps
        ])
        self.reset()

    def _launch(self, step, counted: bool) -> int:
        """One application; returns the probe kernels it launched."""
        ins, out = step
        if self.call is not None:
            self.call(ins, out)
            return 0
        apply(self.kind, ins, self.params, out, counted)
        return 1

    def reset(self) -> None:
        """Fill the carried buffers from the inputs again."""
        fixed = 3 if self.kind == "plane_walk5" else 0
        for buf, t in zip(self.buffers[fixed:], self.inputs[fixed:]):
            buf.copy_(t)

    def run(self) -> torch.Tensor:
        """The ``n`` applications, from the buffers as they are."""
        if self.graph is None:
            for step in self.steps:
                self._launch(step, counted=True)
        else:
            self.graph.replay()
            WRAPPERS[self.kind].launches += self.per_replay
            self.launched += self.per_replay
        return self.result


# -- the timing --------------------------------------------------------------------


def fit_chains(kind: str, params: tuple) -> tuple[int, int]:
    """The two chain lengths :func:`fit_us` fits a variant over."""
    return SHORT_FIT_CHAINS.get((kind, tuple(params)), FIT_CHAINS)


def fit_us(kind: str, inputs: Sequence[torch.Tensor], params: tuple = (),
           trials: int = FIT_TRIALS, library: bool = False) -> dict:
    """µs of one application (with ``library``, of the variant's PyTorch
    call, timed the same way): the two-point fit of bench.py's
    ``StepTimer.measure`` (bench.py:110-160) over graph chains of
    :func:`fit_chains` applications, each trial from the inputs
    (:meth:`Chain.reset`) and timed behind a spin kernel. ``us`` is the
    min-fit, ``spread_pct`` the median-fit's distance from it in %; where the
    min-fit is not positive or above the long chain's mean, ``us`` is that
    mean, as in bench.py. ``launches``: the probe kernels launched here."""
    n_lo, n_hi = fit_chains(kind, params)
    lo, hi = (Chain(kind, n, inputs, params, library) for n in (n_lo, n_hi))

    def timed(chain):
        chain.reset()
        return spin_ms(chain.run, name=variant_name(kind, params), cycles=SPIN_CYCLES,
                       tries=SPIN_TRIES)

    fit = _two_point(lambda: timed(lo), lambda: timed(hi), n_lo, n_hi, trials)
    return {**fit, "chains": (n_lo, n_hi), "launches": lo.launched + hi.launched}


def _two_point(run_lo, run_hi, n_lo: int, n_hi: int, trials: int) -> dict:
    """bench.py's two-point fit of ms a step from ``run_lo()`` and
    ``run_hi()``, the ms of chains of ``n_lo`` and ``n_hi`` steps, each
    warmed once and taken ``trials`` times: ``us`` the min-fit (or the long
    chain's mean where the fit is not positive or above it), ``spread_pct``
    the median-fit's distance from it in %."""
    run_lo(), run_hi()  # warm
    los, his = [], []
    for _ in range(trials):
        los.append(run_lo())
        his.append(run_hi())
    los.sort(), his.sort()
    est = (his[0] - los[0]) / (n_hi - n_lo)
    med = (his[trials // 2] - los[trials // 2]) / (n_hi - n_lo)
    spread = (med - est) / est * 100 if est > 0 else None
    upper = his[0] / n_hi
    if est <= 0 or est > upper:
        est = upper
    return {"us": est * 1e3, "spread_pct": spread}


def l2_bytes(device) -> int:
    """The card's L2 cache in bytes, as it reports it (``L2_BYTES`` where
    its properties do not say)."""
    return getattr(torch.cuda.get_device_properties(device), "L2_cache_size", None) or L2_BYTES


def l2_read_rate(device="cuda", trials: int = FIT_TRIALS, seed: int = 0) -> dict:
    """The rate at which the card's SMs read bytes that stay in its L2:
    :func:`l2_read` over a float32 buffer of one round of its grid (each
    thread ``CAL_L2_VECTORS`` vectors of 16 bytes: 17.3 MB on 132 SMs, a
    third of the H100's L2), ``L2_READ_PASSES`` passes a launch, by the
    two-point fit of graph chains of ``FIT_CHAINS`` launches behind a spin
    kernel. Raises unless the warps' largest values give the buffer's
    largest (``torch.amax``, its plain version). ``Bps``: bytes read (and
    the warps' maxima written) a second; ``nbytes``: the buffer's size."""
    device = torch.device(device)
    blocks = l2_read_blocks(device)
    threads = blocks * define("CAL_THREADS")
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(threads * define("CAL_L2_VECTORS") * 4, generator=gen, device=device)
    out = torch.empty(threads // 32, device=device)
    l2_read(x, out)
    if not torch.equal(out.amax(), x.amax()):
        raise AssertionError("l2_read: the warps' largest values are not the buffer's largest")
    n_lo, n_hi = FIT_CHAINS
    graphs = {n: cuda_backend.capture_graph(device, [
        functools.partial(l2_read, x, out, counted=False)] * n)[0] for n in (n_lo, n_hi)}

    def timed(n):
        def replay():
            graphs[n].replay()
            L2_READ.launches += n
        return spin_ms(replay, name="l2_read", cycles=SPIN_CYCLES, tries=SPIN_TRIES)

    fit = _two_point(lambda: timed(n_lo), lambda: timed(n_hi), n_lo, n_hi, trials)
    moved = L2_READ_PASSES * x.numel() * 4 + out.numel() * 4
    return {**fit, "Bps": moved / (fit["us"] * 1e-6), "nbytes": x.numel() * 4}


# -- the ceilings ------------------------------------------------------------------


def ceilings(times: dict, ni: int = NI, nj: int = NJ, nk: int = NK, halo: int = HALO,
             walks: Optional[dict] = None, walk_us: Optional[dict] = None,
             copy_Bps: Optional[float] = None, l2: int = L2_BYTES) -> dict:
    """bench.py's ceilings from fitted µs by :func:`variant_name`, with
    bench.py's formulas:

    - ``chain_copy_rate_TBps``, ``chain_fma_ps_per_point``,
      ``chain_div_ps_per_point`` from P1 (0, 0), (16, 0), (0, 4)
      (bench.py:1528-1535), and ``card_fma_ps_per_point`` /
      ``card_div_ps_per_point`` from ``CARD_PROBES`` where timed;
    - ``planewalk5_us_per_step``, ``planewalk5_GBps`` from P2 (:1446-1449);
    - ``bf16_window_cost_us`` and ``hdiff_bf16_vpu_model_us`` = copy + 8 ×
      window from P3 (:1387-1390);
    - for each walk of ``walks`` (label -> (compulsory bytes, products and
      sums a point, divisions a point); default bench.py's tridiag and vadv
      with their float32 streams, :1452 and :1537-1545): the plane-walk
      floor (bytes over P2's rate, :1452-1458), the copy floor (bytes over
      P1's copy rate; for a walk whose bytes exceed the L2, ``l2``, the
      larger of that and its bytes over ``copy_Bps``, a device copy from
      the device memory measured in the same run: P1's 52.4 MB at bench.py's
      size stay partly in the L2 across its chain, so its rate is above
      what a walk streaming from the device memory can take), the compute model (the operations at the measured
      costs a point over ni × nj × nk points) and the ceiling, the larger
      of the copy floor and the compute model (:1546-1566); the port has
      no chain-major J-split, so the bytes are the stencil's compulsory
      bytes;
    - with ``walk_us`` (label -> measured µs): each walk's floor and
      ceiling over its time (bench.py's ``_vs_planewalk_ceiling`` and
      ``_vs_chain_ceiling``), and ``hdiff_bf16_vs_vpu_model`` for the label
      ``hdiff_bf16``."""
    out: dict = {}
    njp = nj // 2
    pts_part, points = ni * njp * nk, ni * nj * nk
    t_copy = times.get("probe_walk_m0_n0")
    copy_rate = t_fma = t_div = None
    if t_copy:
        copy_rate = 5 * nk * ni * njp * 4 / (t_copy * 1e-6)
        out["chain_copy_rate_TBps"] = copy_rate / 1e12
        for key, (m, n) in (("chain_fma_ps_per_point", BENCH_PROBES[1]),
                            ("chain_div_ps_per_point", BENCH_PROBES[2]),
                            ("card_fma_ps_per_point", CARD_PROBES[0]),
                            ("card_div_ps_per_point", CARD_PROBES[1])):
            name = variant_name("probe_walk", (m, n))
            if name in times:
                out[key] = max((times[name] - t_copy) * 1e6 / (m + n) / pts_part, 0.0)
        t_fma = out.get("chain_fma_ps_per_point")
        t_div = out.get("chain_div_ps_per_point")
    pw_rate = None
    if times.get("plane_walk5"):
        pw_rate = 5 * nk * ni * nj * 4 / (times["plane_walk5"] * 1e-6)
        out["planewalk5_us_per_step"] = times["plane_walk5"]
        out["planewalk5_GBps"] = pw_rate / 1e9
    if "bf16_windows_n0" in times and "bf16_windows_n1" in times:
        t_cp = times["bf16_windows_n0"]
        win = max(times["bf16_windows_n1"] - t_cp, 0.0)
        out["bf16_window_cost_us"] = win
        out["hdiff_bf16_vpu_model_us"] = t_cp + 8 * win
    if walks is None:
        walks = {w: (WALK_STREAMS[w] * points * 4, *WALK_OPS[w]) for w in WALK_OPS}
    for label, (nbytes_, fmas, divs) in walks.items():
        if pw_rate:
            out[f"{label}_planewalk_floor_us"] = nbytes_ / pw_rate * 1e6
        if copy_rate:
            rate = copy_rate
            if copy_Bps and nbytes_ > l2:
                rate = min(rate, copy_Bps)
            out[f"{label}_copy_floor_us"] = nbytes_ / rate * 1e6
        if t_fma is not None and t_div is not None:
            compute = (fmas * t_fma + divs * t_div) * points * 1e-6
            out[f"{label}_compute_model_us"] = compute
            out[f"{label}_chain_ceiling_us"] = max(out[f"{label}_copy_floor_us"], compute)
    for label, t_w in (walk_us or {}).items():
        for floor, ratio in (("planewalk_floor_us", "vs_planewalk_ceiling"),
                             ("chain_ceiling_us", "vs_chain_ceiling")):
            if f"{label}_{floor}" in out:
                out[f"{label}_{ratio}"] = out[f"{label}_{floor}"] / t_w
    if walk_us and "hdiff_bf16" in walk_us and out.get("hdiff_bf16_vpu_model_us"):
        out["hdiff_bf16_vs_vpu_model"] = walk_us["hdiff_bf16"] / out["hdiff_bf16_vpu_model_us"]
    return out
