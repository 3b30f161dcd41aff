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

Each skeleton has one :class:`KernelWrapper` (``PLANE``, ``FUSED_PLANE``,
``COLUMN``, ``FUSED_COLUMN``, ``TILED``) whose ``launches`` counts the
launches of its kernels, so a run can show that its main path went through
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, Optional

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian.backend.base import Backend, register
from gt4py_tpu_torch.cartesian.backend.cuda_codegen import (
    NOTHING_LAUNCHED,
    CudaUnsupported,
    KernelModule,
    generate,
)
from gt4py_tpu_torch.cartesian.backend.torch_backend import call_device, run_plain
from gt4py_tpu_torch.cartesian.definitions import AccessKind
from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype, torch_dtype

#: ``--fmad=false`` keeps a*b+c as a rounded product and a rounded sum, as
#: the eager plain version computes it (the role of -ffp-contract=off in
#: c_backend.py:67-69); no fast-math. ``-Xptxas -v`` writes each kernel's
#: registers, shared memory and spills to the build log beside the source
#: (``gt_<key>.cu.log``). The two ``__CUDA_NO_HALF_*`` macros take
#: ``__half`` arithmetic and implicit conversions out of ``cuda_fp16.h``: a
#: generated source converts every half value with the intrinsics, and
#: anything else fails to build.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-D__CUDA_NO_HALF_OPERATORS__", "-D__CUDA_NO_HALF_CONVERSIONS__",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LL = ctypes.c_longlong
_LIB_CACHE: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


class CudaBuildError(RuntimeError):
    pass


class KernelWrapper:
    """One hand-written kernel skeleton. ``launches`` counts its kernel
    launches; it grows only where a kernel is launched."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, fn, args) -> None:
        """Call one launcher: it launches one kernel (a cooperative one
        too), or none on an empty grid, or returns the CUDA error that
        refused the launch, which raises here."""
        rc = fn(*args)
        if rc == NOTHING_LAUNCHED:
            return
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc}"
            )
        self.launches += 1


PLANE = KernelWrapper("plane")
FUSED_PLANE = KernelWrapper("fused_plane")
COLUMN = KernelWrapper("column")
FUSED_COLUMN = KernelWrapper("fused_column")
TILED = KernelWrapper("tiled")
WRAPPERS = {w.name: w for w in (PLANE, FUSED_PLANE, COLUMN, FUSED_COLUMN, TILED)}


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
    slowest build rather than for their sum."""
    started = []
    try:
        for source in dict.fromkeys(sources):
            _, so_path, cu_path = _paths(source)
            if os.path.isfile(so_path):
                continue
            tmp = so_path + f".tmp{os.getpid()}"
            with open(cu_path, "w") as f:
                f.write(source)
            log = open(cu_path + ".log", "w+")
            started.append(
                (subprocess.Popen(build_command(cu_path, tmp), stdout=log, stderr=log),
                 log, cu_path, tmp, so_path)
            )
    except OSError as exc:
        raise CudaBuildError(f"nvcc unavailable: {exc}") from exc
    finally:
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

    @property
    def strategy(self) -> Optional[str]:
        """The kernel skeleton serving this stencil on a card."""
        return self.module.strategy if self.module is not None else None

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        device = call_device(arrays)
        if device.type == "cpu":
            self.last_strategy = "plain"
            return run_plain(self.analyzed, arrays, scalars, domain, origins)
        if device.type != "cuda":
            raise ValueError(f"cuda:hopper runs on CUDA or CPU tensors, not {device}")
        if self.module is None:
            raise CudaUnsupported(
                f"stencil '{self.analyzed.name}' on cuda:hopper: {self.unsupported}"
            )
        self.prepare(arrays, scalars, domain, origins)()
        self.last_strategy = self.module.strategy
        return {n: arrays[n] for n in self.written if n in arrays}

    def _functions(self) -> list:
        """(launcher, cooperative, its name) in launch order."""
        if self._fns is None:
            lib = load_library(self.module.source)
            coop = self.module.cooperative
            self._fns = [
                (_bind(lib, name, name in coop), name in coop, name) for name in self.module.launchers
            ]
        return self._fns

    def prepare(self, arrays, scalars, domain, origins):
        """Pack the launch arguments of one stencil application on CUDA
        tensors (allocating its zero-filled temporaries) and return a
        callable that launches its kernels, one per vertical loop, on the
        current stream. ``run`` calls it once; calling it again repeats the
        launches on the same buffers, which is how a timing loop measures
        the kernels without the packing."""
        device = call_device(arrays)
        mod = self.module
        ni, nj, nk = (int(d) for d in domain)
        sizes = dict(zip("IJK", (ni, nj, nk)))
        for name, axes in mod.unit_axes.items():
            if name in arrays and any(sizes[ax] != 1 for ax in axes):
                raise CudaUnsupported(
                    f"stencil '{self.analyzed.name}': field '{name}' has no "
                    f"{'/'.join(axes)} axis; the {mod.strategy} kernel writes it only over "
                    f"a domain of size 1 along it, not {domain}"
                )
        if nk < mod.min_nk:
            raise CudaUnsupported(
                f"stencil '{self.analyzed.name}': the {mod.strategy} kernel's carries need "
                f"at least {mod.min_nk} levels, not {nk}"
            )
        nslots = max(len(mod.slots), 1)
        ptrs = (ctypes.c_void_p * nslots)()
        shapes = (_LL * max(mod.n_shape_slots, 1))()
        strides = (_LL * max(mod.n_shape_slots, 1))()
        orig = (_LL * (3 * nslots))()
        keepalive = []
        placed: dict[str, tuple] = {}  # slot -> its tensor ((I, J, K) view), origin
        snapshots: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        for m in mod.slots:
            if m.snapshot_of is not None:
                # the symbol's values before a launch whose shared planes a
                # neighbouring block could overwrite first: same layout
                src, o = placed[m.snapshot_of]
                t = torch.empty_strided(src.size(), src.stride(), dtype=src.dtype, device=device)
                keepalive.append(t)
                snapshots[m.snapshot_of] = (t, src)
            elif m.is_temp:
                e = m.extent
                # (K, I, J) with J contiguous, zero-filled like the plain
                # version's temporaries where the kernel may read a point
                # before writing it
                buf = (torch.zeros if m.fill else torch.empty)(
                    (nk + e.k[1] - e.k[0], ni + e.i[1] - e.i[0], nj + e.j[1] - e.j[0]),
                    dtype=torch_dtype(m.dtype),
                    device=device,
                )
                keepalive.append(buf)
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
                self._check_offsets(m, t)
            placed[m.name] = (t, o)
            ptrs[m.index] = t.data_ptr()
            item = t.element_size()
            for d in range(t.ndim):
                shapes[m.shape_off + d] = t.shape[d]
                strides[m.shape_off + d] = t.stride(d) * item
            for ax in range(3):
                orig[m.index * 3 + ax] = int(o[ax])
        n_f = sum(1 for s in mod.scalars if s[1] == "f")
        fsc = (ctypes.c_double * max(n_f, 1))()
        isc = (_LL * max(len(mod.scalars) - n_f, 1))()
        for name, kind, slot, _ in mod.scalars:
            value = scalars.get(name)
            if value is None:
                continue
            if kind == "f":
                fsc[slot] = float(value)
            else:
                isc[slot] = int(np.asarray(value))
        pairs = overlapping(arrays)
        hazard = alias_hazard(mod, pairs)
        if hazard is not None:
            raise CudaUnsupported(f"stencil '{self.analyzed.name}': {hazard}")
        noalias = int(not pairs)
        wrapper = WRAPPERS[mod.strategy]
        fns = self._functions()
        if mod.cooperative:
            # the tiles' level counters; each launch zeroes them first
            flags = torch.empty(max(mod.tiles(ni, nj), 1), dtype=torch.int32, device=device)
            keepalive.append(flags)

        def launch() -> None:
            with torch.cuda.device(device):
                stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
                args = (ptrs, shapes, strides, orig, fsc, isc, ni, nj, nk, stream, noalias)
                for fn, cooperative, name in fns:
                    for field in mod.snapshots.get(name, ()):
                        snap, src = snapshots[field]
                        snap.copy_(src)
                    wrapper.launch(fn, args + ((flags.data_ptr(),) if cooperative else ()))

        launch.keepalive = (keepalive, arrays)
        return launch

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
