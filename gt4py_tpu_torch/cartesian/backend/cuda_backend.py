"""Kernel backend ``cuda:hopper`` — the counterpart of ``tpu:pallas``.

Counterpart of gt4py_tpu/cartesian/backend/pallas_backend.py. The stencil
is rendered to CUDA C++ by cuda_codegen.py, into one of five hand-written
kernel skeletons: ``plane`` (K1's class: all-PARALLEL 3-D stencils, one
launch per vertical loop), ``fused_plane`` (the rest of K2's: one launch per
stencil), ``column`` (K3's: sequential and K-offset loops, one thread per
column), ``fused_column`` (K4's, with the stage-fusion switch
``config.fuse_stages`` on: every loop in one launch, one thread per column)
or ``tiled`` (K5's: sequential loops that read what they write at a
horizontal offset, one block per tile). It is compiled on first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
cached on disk by content hash under ``.gt_cache/torch/cuda/``, and bound
with ``ctypes`` — the build model of
gt4py_tpu/cartesian/backend/c_backend.py:52-108.

Dispatch:
- CUDA tensors: launch the generated kernels on the current stream, or
  raise :class:`CudaUnsupported` naming the construct (a stencil no
  skeleton serves, racy aliasing of arguments, a lower-dimensional field
  written over a domain the kernel cannot serve). Unlike
  pallas_backend.py:64-121 there is no silent fallback.
- CPU tensors: run the plain version (torch_backend.run_plain) and record
  ``kernel_strategy = "plain"``.

A call on CUDA tensors runs a :class:`PreparedLaunch`, packed once per
buffers, layouts, domain and origins and found again by the runtime's call
key (the warm path of pallas_backend.py:125-167); ``chain`` captures one
swap cycle of them into a CUDA graph and replays it (:func:`capture_graph`,
the counterpart of the jitted ``fori_loop`` of pallas_backend.py:232-378).

Each skeleton has one :class:`KernelWrapper` (``PLANE``, ``FUSED_PLANE``,
``COLUMN``, ``FUSED_COLUMN``, ``TILED``; ``NEIGHBOR`` for the field view's
unstructured kernels, built through the same cache) whose ``launches``
counts the kernels of its skeleton that ran, so a run can show that its
main path went through them. A launch is counted where its kernel runs: a
launch made while :func:`capture_graph` captures runs only when the graph
replays, so the capture records it and :meth:`Graph.replay` counts it, for
every caller that captures (a chain, the field view's graphs, the probes).
A launch counts once whatever variant it ran: a launcher that serves two
loops in one launch (``column``'s on-chip pair) counts one, so the count
against ``KernelModule.kernels_per_call`` shows whether the pair ran.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, Optional

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian.backend.base import Backend, as_tensor, register
from gt4py_tpu_torch.cartesian.backend.cuda_codegen import (
    NOTHING_LAUNCHED,
    CudaUnsupported,
    KernelModule,
    generate,
)
from gt4py_tpu_torch.cartesian.backend.torch_backend import call_device, run_plain
from gt4py_tpu_torch.cartesian.definitions import AccessKind
from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype, torch_dtype
from gt4py_tpu_torch.instrumentation.spans import NO_SPAN, Span, span

#: ``--fmad=false`` keeps a*b+c as a rounded product and a rounded sum, as
#: the eager plain version computes it (the role of -ffp-contract=off in
#: c_backend.py:67-69); no fast-math. ``-Xptxas -v`` writes each kernel's
#: registers, shared memory and spills to the build log beside the source
#: (``gt_<key>.cu.log``). The ``__CUDA_NO_HALF_*`` and
#: ``__CUDA_NO_BFLOAT16_*`` macros take ``__half`` and ``__nv_bfloat16``
#: arithmetic and implicit conversions out of ``cuda_fp16.h`` and
#: ``cuda_bf16.h``: a generated source converts every half value with the
#: intrinsics, and anything else fails to build.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-D__CUDA_NO_HALF_OPERATORS__", "-D__CUDA_NO_HALF_CONVERSIONS__",
    "-D__CUDA_NO_BFLOAT16_OPERATORS__", "-D__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LL = ctypes.c_longlong
_LIB_CACHE: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


class CudaBuildError(RuntimeError):
    pass


#: ``nvcc`` processes started since the count was last set to 0
nvcc_runs = 0


class _Recording(threading.local):
    #: the launches recorded, by wrapper, while this thread captures a CUDA
    #: graph (:func:`capture_graph`); None outside a capture
    counts: Optional[collections.Counter] = None


_RECORDING = _Recording()


class KernelWrapper:
    """One hand-written kernel skeleton. ``launches`` counts its kernels
    that ran: a launch outside a capture when it is made, a captured one at
    each replay of its graph (:meth:`Graph.replay`)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, fn, args) -> int:
        """Call one launcher: it launches one kernel (a cooperative one
        too), or none on an empty grid, or returns the CUDA error that
        refused the launch, which raises here. Returns the kernels
        launched, counted in ``launches``, or within a capture recorded for
        the graph's replays."""
        rc = fn(*args)
        if rc == NOTHING_LAUNCHED:
            return 0
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc}"
            )
        recording = _RECORDING.counts
        if recording is None:
            self.launches += 1
        else:
            recording[self] += 1
        return 1


PLANE = KernelWrapper("plane")
FUSED_PLANE = KernelWrapper("fused_plane")
COLUMN = KernelWrapper("column")
FUSED_COLUMN = KernelWrapper("fused_column")
TILED = KernelWrapper("tiled")
#: the field view's generated gather-reduce kernels (next/unstructured_codegen.py)
NEIGHBOR = KernelWrapper("neighbor")
WRAPPERS = {w.name: w for w in (PLANE, FUSED_PLANE, COLUMN, FUSED_COLUMN, TILED, NEIGHBOR)}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_command(source_path: str, library_path: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", library_path, source_path]


def _cache_dir() -> str:
    from gt4py_tpu_torch.cartesian.caching import GT_CACHE_ROOT

    path = os.path.join(GT_CACHE_ROOT, "cuda")
    os.makedirs(path, exist_ok=True)
    return path


def _paths(source: str) -> tuple[str, str, str]:
    """(cache key, library path, source path) of one generated source."""
    key = hashlib.sha1(source.encode()).hexdigest()[:20]
    cache = _cache_dir()
    return key, os.path.join(cache, f"gt_{key}.so"), os.path.join(cache, f"gt_{key}.cu")


def build_libraries(sources) -> None:
    """Compile every source whose library is not on disk yet: one ``nvcc``
    per source, all started together, so a cold start waits for the
    slowest build rather than for their sum. A build span
    (``gt4py.build.nvcc``, attribute ``nvcc_runs``: the processes started)."""
    global nvcc_runs
    started = []
    with Span("gt4py.build.nvcc", always=True) as build_span:
        try:
            for source in dict.fromkeys(sources):
                _, so_path, cu_path = _paths(source)
                if os.path.isfile(so_path):
                    continue
                tmp = so_path + f".tmp{os.getpid()}"
                with open(cu_path, "w") as f:
                    f.write(source)
                log = open(cu_path + ".log", "w+")
                nvcc_runs += 1
                started.append(
                    (subprocess.Popen(build_command(cu_path, tmp), stdout=log, stderr=log),
                     log, cu_path, tmp, so_path)
                )
        except OSError as exc:
            raise CudaBuildError(f"nvcc unavailable: {exc}") from exc
        finally:
            build_span.set("nvcc_runs", len(started))
            failures = []
            for proc, log, cu_path, tmp, so_path in started:
                try:
                    rc = proc.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = "timeout"
                log.seek(0)
                if rc == 0:
                    os.replace(tmp, so_path)
                else:
                    failures.append(f"nvcc failed ({rc}) for {cu_path}:\n{log.read()}")
                log.close()
    if failures:
        raise CudaBuildError("\n".join(failures))


def load_library(source: str) -> ctypes.CDLL:
    """Compile (once per source hash, on disk) and load."""
    key, so_path, _ = _paths(source)
    with _LIB_LOCK:
        lib = _LIB_CACHE.get(key)
        if lib is not None:
            return lib
        build_libraries([source])
        with Span("gt4py.build.load", always=True):
            lib = ctypes.CDLL(so_path)
        _LIB_CACHE[key] = lib
        return lib


def _bind(lib: ctypes.CDLL, name: str, cooperative: bool = False):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(_LL),
        ctypes.POINTER(_LL),
        ctypes.POINTER(_LL),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(_LL),
        _LL,
        _LL,
        _LL,
        ctypes.c_void_p,  # cudaStream_t: a pointer, never a 32-bit int
        ctypes.c_int,  # noalias
    ] + ([ctypes.c_void_p] if cooperative else [])  # the tiles' level counters
    return fn


def overlapping(arrays: dict[str, torch.Tensor]) -> list[tuple[str, str]]:
    """Pairs of field roles whose tensors' byte ranges overlap."""

    def span(t):
        extent = sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
        return t.data_ptr(), t.data_ptr() + extent * t.element_size()

    spans = sorted(
        (span(t), name) for name, t in arrays.items() if t.numel() > 0
    )
    pairs = []
    for a, ((lo_a, hi_a), name_a) in enumerate(spans):
        for (lo_b, _), name_b in spans[a + 1:]:
            if lo_b >= hi_a:
                break
            pairs.append((name_a, name_b))
    return pairs


def alias_hazard(module: KernelModule, pairs: list[tuple[str, str]]) -> Optional[str]:
    """Why the kernels cannot serve these aliased roles, or None. Aliasing
    is safe where every thread reads a shared buffer only at points it
    writes itself (the in-place update idiom ``stage(u_in=u, u_out=u)``)."""
    for a, b in pairs:
        for w, r in ((a, b), (b, a)):
            if w in module.written and r in module.nonlocal_reads:
                return (
                    f"fields '{w}' and '{r}' share memory; '{w}' is written while "
                    f"'{r}' is read at points other threads write (pass separate buffers)"
                )
    return None


#: entries a cache of prepared launches, chains or chain graphs holds before
#: it is emptied (the JAX package's warm-call cache, pallas_backend.py:146-148)
CACHE_ENTRIES = 128


def _bounded_put(cache: dict, key, value) -> None:
    if len(cache) >= CACHE_ENTRIES:
        cache.clear()
    cache[key] = value


def launch_key(arrays: dict[str, torch.Tensor], domain, origins) -> tuple:
    """What a prepared launch depends on: each role's pointer, shape, byte
    layout and dtype, the domain and the origins (the noalias decision
    follows from the pointers and layouts)."""
    return (
        tuple(domain),
        tuple(sorted(origins.items())),
        tuple(
            (n, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
            for n, t in sorted(arrays.items())
        ),
    )


class PreparedLaunch:
    """One stencil application on fixed buffers, packed once: the launch
    arguments (pointers, shapes, byte strides, origins), whether no two
    field buffers overlap, and the scratch it uses (temporaries, snapshots,
    the cooperative level counters). The refusals (aliasing, a unit axis,
    too few levels, 32-bit offsets) are checked here, once.

    Calling it launches the kernels on the current stream: it packs the
    scalars (the launchers read them at launch), zeroes every temporary
    the plain version would read before writing (``fill``), copies each
    snapshot, then calls the launchers in order. It holds no caller tensor,
    so a cache of them pins no user memory: the caller's buffers are matched
    by pointer and layout (:func:`launch_key`), and snapshots copy from the
    ``arrays`` of the call. The scratch belongs to the backend and is shared
    by its launches of the same domain, which must therefore run one after
    the other on one stream, as a model's time loop does."""

    def __init__(self, backend: "CudaHopperBackend", arrays, domain, origins):
        mod = backend.module
        name = backend.analyzed.name
        self.device = device = call_device(arrays)
        ni, nj, nk = (int(d) for d in domain)
        sizes = dict(zip("IJK", (ni, nj, nk)))
        for field, axes in mod.unit_axes.items():
            if field in arrays and any(sizes[ax] != 1 for ax in axes):
                raise CudaUnsupported(
                    f"stencil '{name}': field '{field}' has no "
                    f"{'/'.join(axes)} axis; the {mod.strategy} kernel writes it only over "
                    f"a domain of size 1 along it, not {domain}"
                )
        if nk < mod.min_nk:
            raise CudaUnsupported(
                f"stencil '{name}': the {mod.strategy} kernel's carries need "
                f"at least {mod.min_nk} levels, not {nk}"
            )
        pairs = overlapping(arrays)
        hazard = alias_hazard(mod, pairs)
        if hazard is not None:
            raise CudaUnsupported(f"stencil '{name}': {hazard}")
        self.noalias = int(not pairs)
        #: the launchers that serve a pair of loops in one launch here, and
        #: the temporaries that then live in shared memory (no buffer)
        self.on_chip = frozenset(
            launcher for launcher, oc in mod.on_chip.items() if oc.serves(nk, self.noalias)
        )
        on_chip_only = {c for launcher in self.on_chip for c in mod.on_chip[launcher].cross}
        #: the kernels a call launches where its grids are not empty
        self.kernels = mod.kernels_per_call(nk, self.noalias)
        nslots = max(len(mod.slots), 1)
        self.ptrs = (ctypes.c_void_p * nslots)()
        self.shapes = (_LL * max(mod.n_shape_slots, 1))()
        self.strides = (_LL * max(mod.n_shape_slots, 1))()
        self.orig = (_LL * (3 * nslots))()
        #: temporaries zeroed before every application
        self.fills: list[torch.Tensor] = []
        #: launcher -> [(snapshot, the API field it copies)]
        self.snapshots: dict[str, list[tuple[torch.Tensor, str]]] = {}
        placed: dict[str, tuple] = {}  # slot -> its tensor ((I, J, K) view), origin
        layouts: dict[str, tuple] = {}  # 3-D field -> (its origin's address, byte strides)
        for m in mod.slots:
            if m.snapshot_of is not None:
                # the symbol's values before a launch whose shared planes a
                # neighbouring block could overwrite first: same layout
                src, o = placed[m.snapshot_of]
                t = backend.scratch(
                    ("snapshot", m.name, tuple(src.shape), src.stride(), src.dtype, device),
                    lambda src=src: torch.empty_strided(
                        src.size(), src.stride(), dtype=src.dtype, device=device
                    ),
                )
                for launcher, fields in mod.snapshots.items():
                    if m.snapshot_of in fields:
                        self.snapshots.setdefault(launcher, []).append((t, m.snapshot_of))
            elif m.is_temp:
                if m.name in on_chip_only:
                    continue  # never dereferenced
                e = m.extent
                # (K, I, J) with J contiguous
                shape = (nk + e.k[1] - e.k[0], ni + e.i[1] - e.i[0], nj + e.j[1] - e.j[0])
                buf = backend.scratch(
                    ("temporary", m.name, shape, m.dtype, device),
                    lambda shape=shape, m=m: torch.empty(
                        shape, dtype=torch_dtype(m.dtype), device=device
                    ),
                )
                if m.fill:  # the kernel may read a point before writing it
                    self.fills.append(buf)
                t = buf.permute(1, 2, 0)
                o = (-e.i[0], -e.j[0], -e.k[0])
            else:
                t = arrays.get(m.name)
                if t is None:
                    continue  # AccessKind.NONE: never dereferenced
                if numpy_dtype(t.dtype) != m.dtype:
                    raise TypeError(
                        f"Field '{m.name}': expected dtype {m.dtype}, got {t.dtype}"
                    )
                if t.device != device or t.ndim != m.ndim:
                    raise ValueError(
                        f"Field '{m.name}': expected a {m.ndim}-d tensor on {device}"
                    )
                o = origins.get(m.name, (0, 0, 0))
                backend._check_offsets(m, t)
            placed[m.name] = (t, o)
            self.ptrs[m.index] = t.data_ptr()
            item = t.element_size()
            for d in range(t.ndim):
                self.shapes[m.shape_off + d] = t.shape[d]
                self.strides[m.shape_off + d] = t.stride(d) * item
            for ax in range(3):
                self.orig[m.index * 3 + ax] = int(o[ax])
            if not m.is_temp and t.ndim == 3:
                strides = tuple(self.strides[m.shape_off + d] for d in range(3))
                layouts[m.name] = (t.data_ptr() + sum(int(x) * y for x, y in zip(o, strides)), strides)
        #: launcher -> its ``noalias`` argument (plane: the word of its
        #: register patches, PatchLayout.word)
        self.words = {
            launcher: mod.patches[launcher].word(self.noalias, layouts)
            if launcher in mod.patches else self.noalias
            for launcher in mod.launchers
        }
        n_f = sum(1 for sc in mod.scalars if sc[1] == "f")
        self.fsc = (ctypes.c_double * max(n_f, 1))()
        self.isc = (_LL * max(len(mod.scalars) - n_f, 1))()
        self.scalar_slots = [(n, kind, slot) for n, kind, slot, _ in mod.scalars]
        self.sizes = (ni, nj, nk)
        self.wrapper = WRAPPERS[mod.strategy]
        self.fns = backend._functions()
        # the tiles' level counters; each cooperative launch zeroes them first
        self.flags = (
            backend.scratch(
                ("flags", mod.tiles(ni, nj), device),
                lambda: torch.empty(max(mod.tiles(ni, nj), 1), dtype=torch.int32, device=device),
            )
            if mod.cooperative
            else None
        )
        #: launched at least once (a capture needs each kernel run before)
        self.ran = False

    def __call__(self, arrays, scalars) -> int:
        """Launch once on ``arrays`` (the buffers this launch was prepared
        for); returns the kernels launched."""
        # a launch outside a capture (which launches nothing) is a span
        with (span("gt4py.backend.launch") if _RECORDING.counts is None else NO_SPAN) \
                as launch_span:
            for name, kind, slot in self.scalar_slots:
                value = scalars.get(name)
                if value is None:
                    continue
                if kind == "f":
                    self.fsc[slot] = float(value)
                else:
                    self.isc[slot] = int(np.asarray(value))
            launched = 0
            with torch.cuda.device(self.device):
                stream = ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream)
                args = (self.ptrs, self.shapes, self.strides, self.orig, self.fsc, self.isc,
                        *self.sizes, stream)
                for buf in self.fills:
                    buf.zero_()
                for fn, cooperative, name in self.fns:
                    for snap, field in self.snapshots.get(name, ()):
                        snap.copy_(arrays[field])
                    extra = (self.flags.data_ptr(),) if cooperative else ()
                    launched += self.wrapper.launch(fn, args + (self.words[name],) + extra)
            launch_span.set("launches", launched)
        self.ran = True
        return launched


class Graph:
    """A captured CUDA graph and the Hopper kernels its capture recorded, by
    wrapper: a replay runs them, and :meth:`replay` is where they are
    counted."""

    __slots__ = ("graph", "launches")

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: collections.Counter):
        self.graph = graph
        self.launches = launches

    @property
    def per_replay(self) -> int:
        """The Hopper kernels a replay launches."""
        return sum(self.launches.values())

    def replay(self, times: int = 1) -> int:
        """Replay ``times`` times on the current stream, the kernels added
        to their wrappers' ``launches``; returns the kernels launched."""
        for _ in range(times):
            self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n * times
        return self.per_replay * times


def capture_graph(device, launches: list, pool=None, stream=None) -> Graph:
    """Capture ``launches``, closures called in order that each launch
    their work on the current stream (ctypes launches on that stream's
    handle), into one CUDA graph on a side stream of ``device`` (``stream``;
    None: a new one), its memory from ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; None: a pool of its own). Graphs
    that share a pool share its free memory only where they are captured
    on one side stream: the caching allocator keeps each stream's blocks
    apart. The Hopper kernels launched are recorded, not counted: the
    returned :class:`Graph` counts them at each replay. A launch's own
    error propagates, not the capture's."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device) if stream is None else stream
    stream.wait_stream(torch.cuda.current_stream(device))
    captured = False
    recorded = collections.Counter()
    outer, _RECORDING.counts = _RECORDING.counts, recorded
    try:
        with span("gt4py.backend.capture") as capture_span, torch.cuda.device(device), \
                torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                for launch in launches:
                    launch()
                captured = True
            finally:
                try:
                    graph.capture_end()
                except RuntimeError:
                    if captured:
                        raise  # else the launch's own error propagates
            capture_span.set("launches", sum(recorded.values()))
    finally:
        _RECORDING.counts = outer
    return Graph(graph, recorded)


class Chain:
    """A chain's swap cycle on fixed buffers: its prepared launches, one per
    buffer assignment (the scratch the graphs' kernels use), and the CUDA
    graphs captured of them, one per scalar values (:class:`Graph`: the
    zeroing of filled temporaries, the snapshot copies and the kernels,
    with the scalars baked into the kernels' parameters at capture)."""

    __slots__ = ("launches", "graphs")

    def __init__(self, launches: list[PreparedLaunch]):
        self.launches = launches
        self.graphs: dict = {}


@register
class CudaHopperBackend(Backend):
    name = "cuda:hopper"
    storage_info = {"alignment": 128, "device": "cuda"}

    def __init__(self, analyzed, options):
        super().__init__(analyzed, options)
        self.module: Optional[KernelModule] = None
        #: why the kernels cannot serve this stencil (None: they can)
        self.unsupported: Optional[str] = None
        try:
            self.module = generate(analyzed, fuse_stages=config.fuse_stages())
        except CudaUnsupported as exc:
            self.unsupported = str(exc)
        self._fns: Optional[list] = None
        self.written = [
            name
            for name, info in analyzed.field_infos.items()
            if info.access & AccessKind.WRITE
        ]
        #: prepared launches by :func:`launch_key`, chains by step 0's and
        #: the cycle's plan; both also by the runtime's call key plus the
        #: pointers and strides (:meth:`_cached`)
        self._launches: dict = {}
        self._chains: dict = {}
        #: temporaries, snapshots and level counters by shape and role
        self._scratch: dict = {}

    @property
    def strategy(self) -> Optional[str]:
        """The kernel skeleton serving this stencil on a card."""
        return self.module.strategy if self.module is not None else None

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        return self._run(arrays, scalars, domain, origins, None)

    def run_from_infos(self, infos, scalars, domain, origins, cache_key=None):
        arrays = {name: as_tensor(info.original) for name, info in infos.items()}
        return self._run(arrays, scalars, domain, origins, cache_key)

    def _run(self, arrays, scalars, domain, origins, cache_key) -> dict[str, Any]:
        with span("gt4py.backend.run"):
            if not self._on_card(arrays):
                self.last_strategy = "plain"
                return run_plain(self.analyzed, arrays, scalars, domain, origins)
            launch = self.prepared(arrays, domain, origins, cache_key)
            launch(arrays, scalars)
            self.last_strategy = self.module.strategy
            self.last_kernels = launch.kernels
            return {n: arrays[n] for n in self.written if n in arrays}

    def _on_card(self, arrays) -> bool:
        """True for CUDA tensors, which the kernels serve or the stencil
        raises; False for CPU tensors, which run the plain version."""
        device = call_device(arrays)
        if device.type == "cpu":
            return False
        if device.type != "cuda":
            raise ValueError(f"cuda:hopper runs on CUDA or CPU tensors, not {device}")
        if self.module is None:
            raise CudaUnsupported(
                f"stencil '{self.analyzed.name}' on cuda:hopper: {self.unsupported}"
            )
        return True

    def run_steps(self, own, plan, scalars, domain, origins, n_steps: int, cache_key=None):
        """On a card: the swap cycle's :class:`Chain` (one prepared launch per
        buffer assignment); the first steps run them until each has launched
        once, then the cycle is captured into a :class:`Graph` (one per
        scalar values, which the capture bakes in), replayed ``(n - done) //
        C`` times, and the remaining steps run as prepared launches. The
        lagged sweeps' cooperative launch and its ``cudaMemsetAsync`` are
        captured too (CUDA 12 on the H100). CPU tensors: the plain version,
        step by step."""
        with span("gt4py.backend.run_steps") as backend_span:
            backend_span.set("captured", 0)
            if not self._on_card(own):
                return super().run_steps(own, plan, scalars, domain, origins, n_steps)
            cycle = len(plan)
            states = [{r: own[a[r]] for r in own} for a in plan]
            chain = self._chain(own, plan, states, domain, origins, cache_key)
            launches = chain.launches
            self.last_strategy = self.module.strategy
            step = replays = 0
            values = tuple(sorted((n, np.asarray(v).item()) for n, v in scalars.items()))
            graph = chain.graphs.get(values)
            if graph is None:
                if not all(launch.ran for launch in launches):
                    while step < min(n_steps, cycle):
                        launches[step](states[step], scalars)
                        step += 1
                if n_steps - step >= cycle:
                    graph = capture_graph(launches[0].device, [
                        functools.partial(launch, state, scalars)
                        for launch, state in zip(launches, states)
                    ])
                    backend_span.set("captured", 1)
                    _bounded_put(chain.graphs, values, graph)
            if graph is not None:
                replays = (n_steps - step) // cycle
                with span("gt4py.backend.replay") as replay_span, \
                        torch.cuda.device(launches[0].device):
                    replay_span.set("replays", replays)
                    replay_span.set("launches", graph.replay(replays))
                step += replays * cycle
            for s in range(step, n_steps):
                launches[s % cycle](states[s % cycle], scalars)
            self.last_chain_mode = "graph" if replays else "launches"

    def _chain(self, own, plan, states, domain, origins, cache_key) -> Chain:
        """The cached :class:`Chain` of these buffers and swap cycle."""
        return self._cached(
            self._chains, own, cache_key,
            lambda: (launch_key(own, domain, origins),
                     tuple(tuple(sorted(a.items())) for a in plan)),
            lambda: Chain([self.prepared(state, domain, origins) for state in states]),
        )

    @staticmethod
    def _cached(cache: dict, arrays, cache_key, key, make):
        """``cache``'s entry for ``arrays``, made by ``make()`` the first
        time: found by the runtime's identity-free call key plus the
        tensors' pointers and strides where the runtime gives one (a warm
        lookup), else by ``key()``; both are kept."""
        if cache_key is not None:
            fast = (cache_key, tuple((t.data_ptr(), t.stride()) for t in arrays.values()))
            entry = cache.get(fast)
            if entry is not None:
                return entry
        full = key()
        entry = cache.get(full)
        if entry is None:
            entry = make()
            _bounded_put(cache, full, entry)
        if cache_key is not None:
            _bounded_put(cache, fast, entry)
        return entry

    def _functions(self) -> list:
        """(launcher, cooperative, its name) in launch order."""
        if self._fns is None:
            lib = load_library(self.module.source)
            coop = self.module.cooperative
            self._fns = [
                (_bind(lib, name, name in coop), name in coop, name) for name in self.module.launchers
            ]
        return self._fns

    def scratch(self, key, make):
        """The backend's scratch tensor for ``key``, made by ``make()`` the
        first time."""
        t = self._scratch.get(key)
        if t is None:
            t = self._scratch[key] = make()
        return t

    def prepared(self, arrays, domain, origins, cache_key=None) -> PreparedLaunch:
        """The cached :class:`PreparedLaunch` of these buffers, domain and
        origins (``cache_key``: the runtime's call key, see :meth:`_cached`)."""
        return self._cached(
            self._launches, arrays, cache_key,
            lambda: launch_key(arrays, domain, origins),
            lambda: PreparedLaunch(self, arrays, domain, origins),
        )

    def _check_offsets(self, m, t: torch.Tensor) -> None:
        """The plane kernel takes a point's offset from its tile's corner as
        a 32-bit integer: refuse a field whose strides carry the tile's
        reach (``KernelModule.offset_span``) beyond it."""
        rows, cols = self.module.offset_span
        if not rows or t.ndim < 2:
            return
        si, sj = (abs(t.stride(d)) * t.element_size() for d in range(2))
        reach = rows * si + cols * sj
        if reach > 2**31 - 1:
            raise CudaUnsupported(
                f"stencil '{self.analyzed.name}': field '{m.name}' has strides of {si} and {sj} "
                f"bytes along I and J, so the {self.module.strategy} kernel's offsets over "
                f"{rows} rows and {cols} columns of a tile reach {reach} bytes, beyond 32 bits"
            )
