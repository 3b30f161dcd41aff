"""Native compiled-C CPU backend ``"cpu:c"``.

Copied from gt4py_tpu/cartesian/backend/c_backend.py, the counterpart of
the reference's native CPU backends (``gt:cpu_ifirst``/``gt:cpu_kfirst``,
src/gt4py/cartesian/backend/gtcpp_backend.py:129): the stencil is rendered
to C (c_codegen.py), compiled on first use with the system C compiler
(OpenMP-parallel horizontal loops), cached on disk by source content hash
under ``<GT_CACHE_ROOT>/cbackend`` (the port's root, caching.py), and bound
through ``ctypes``.

The port's fields are CPU tensors, mutated in place: the generated function
gets each tensor's ``data_ptr()`` and the strides of its logical (I, J, K)
view in bytes, so any layout works; on the K-leading storages
(storage/layout.py) the C loop nest's inner J loop walks contiguous memory.
A CUDA tensor raises a ``TypeError`` that names its device, as the
``numpy`` backend does. Constructs without a C rendering (the half-float
dtypes) run the ``numpy`` backend's path instead, with a warning;
``last_path`` records which path served the call (``"c"`` or
``"numpy_fallback"``) so tests can assert native service.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Any, Optional

from gt4py_tpu_torch.cartesian.backend.base import Backend, register
from gt4py_tpu_torch.cartesian.backend.c_codegen import CModule, CUnsupported, generate
from gt4py_tpu_torch.cartesian.backend.numpy_backend import HostViews, run_numpy
from gt4py_tpu_torch.cartesian.definitions import AccessKind
from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype

_LL = ctypes.c_longlong
_LIB_CACHE: dict[str, Any] = {}
_LIB_LOCK = threading.Lock()


class CCompileError(RuntimeError):
    pass


def _cache_dir() -> str:
    from gt4py_tpu_torch.cartesian.caching import GT_CACHE_ROOT

    path = os.path.join(GT_CACHE_ROOT, "cbackend")
    os.makedirs(path, exist_ok=True)
    return path


def _compile(source: str) -> Any:
    """Compile + load, cached in-process and on disk by content hash."""
    key = hashlib.sha1(source.encode()).hexdigest()[:20]
    with _LIB_LOCK:
        fn = _LIB_CACHE.get(key)
        if fn is not None:
            return fn
        cache = _cache_dir()
        so_path = os.path.join(cache, f"gt_{key}.so")
        if not os.path.isfile(so_path):
            # each process compiles its own copy of the source: another one
            # may be writing the shared name at the same time
            c_path = os.path.join(cache, f"gt_{key}.c")
            tmp = so_path + f".tmp{os.getpid()}"
            c_tmp = f"{c_path}.tmp{os.getpid()}.c"
            with open(c_tmp, "w") as f:
                f.write(source)
            cc = os.environ.get("CC", "cc")
            # -ffp-contract=off: no FMA contraction — results must match
            # the numpy oracle bit-for-bit on plain arithmetic.
            base = ["-O3", "-std=c11", "-ffp-contract=off", "-shared", "-fPIC"]
            attempts = [
                base + ["-march=native", "-fopenmp"],
                base + ["-fopenmp"],
                base,
            ]
            err = b""
            for flags in attempts:
                cmd = [cc, *flags, c_tmp, "-o", tmp, "-lm"]
                try:
                    proc = subprocess.run(
                        cmd, capture_output=True, timeout=120, check=False
                    )
                except (OSError, subprocess.TimeoutExpired) as exc:
                    raise CCompileError(f"C compiler unavailable: {exc}") from exc
                if proc.returncode == 0:
                    os.replace(c_tmp, c_path)
                    os.replace(tmp, so_path)
                    break
                err = proc.stderr
            else:
                os.replace(c_tmp, c_path)
                raise CCompileError(
                    f"C compilation failed:\n{err.decode(errors='replace')}"
                )
        lib = ctypes.CDLL(so_path)
        fn = lib.gt_run
        fn.restype = None
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
        ]
        fn._gt_lib = lib  # keep the CDLL alive
        _LIB_CACHE[key] = fn
        return fn


@register
class CBackend(Backend):
    name = "cpu:c"
    storage_info = {"alignment": 64, "device": "cpu"}

    def __init__(self, analyzed, options):
        super().__init__(analyzed, options)
        self._module: Optional[CModule] = None
        self._fn = None
        self._fallback_reason: Optional[str] = None
        self._warned = False
        #: introspection: "c" or "numpy_fallback" after the last call
        self.last_path: Optional[str] = None
        try:
            self._module = generate(analyzed)
        except CUnsupported as exc:
            self._fallback_reason = str(exc)

    # -- native path ---------------------------------------------------------

    def _ensure_compiled(self) -> bool:
        if self._fn is not None:
            return True
        if self._fallback_reason is not None:
            return False
        try:
            self._fn = _compile(self._module.source)
            return True
        except CCompileError as exc:
            self._fallback_reason = str(exc)
            return False

    def _run_native(self, arrays, scalars, domain, origins) -> None:
        mod = self._module
        nf = len(mod.fields)
        ptrs = (ctypes.c_void_p * max(nf, 1))()
        shapes = (_LL * max(mod.n_shape_slots, 1))()
        strides = (_LL * max(mod.n_shape_slots, 1))()
        origins_arr = (_LL * max(3 * nf, 1))()
        for m in mod.fields:
            t = arrays.get(m.name)
            if t is None:
                continue  # AccessKind.NONE params: never dereferenced
            if numpy_dtype(t.dtype) != m.dtype:
                raise TypeError(
                    f"Field '{m.name}': expected dtype {m.dtype}, got {t.dtype}"
                )
            ptrs[m.index] = t.data_ptr()
            for d in range(t.ndim):
                shapes[m.shape_off + d] = t.shape[d]
                strides[m.shape_off + d] = t.stride(d) * t.element_size()
            o = origins.get(m.name, (0, 0, 0))
            for ax in range(3):
                origins_arr[m.index * 3 + ax] = int(o[ax])
        n_f = sum(1 for s in mod.scalars if s[1] == "f")
        n_i = len(mod.scalars) - n_f
        fsc = (ctypes.c_double * max(n_f, 1))()
        isc = (_LL * max(n_i, 1))()
        for name, kind, slot, dt in mod.scalars:
            value = scalars.get(name)
            if value is None:
                continue
            if kind == "f":
                fsc[slot] = float(value)
            else:
                isc[slot] = int(value)
        ni, nj, nk = (int(d) for d in domain)
        self._fn(ptrs, shapes, strides, origins_arr, fsc, isc, ni, nj, nk)

    # -- fallback ------------------------------------------------------------

    def _run_fallback(self, arrays, scalars, domain, origins) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"cpu:c falling back to numpy path for stencil "
                f"'{self.analyzed.name}': {self._fallback_reason}",
                stacklevel=2,
            )
        run_numpy(self.analyzed, arrays, scalars, domain, origins, self.name)

    # -- entry point ---------------------------------------------------------

    def run(self, arrays, scalars, domain, origins) -> dict[str, Any]:
        HostViews.check_cpu(arrays, self.name)
        if self._ensure_compiled():
            self.last_path = "c"
            self._run_native(arrays, scalars, domain, origins)
        else:
            self.last_path = "numpy_fallback"
            self._run_fallback(arrays, scalars, domain, origins)
        self.last_strategy = self.last_path
        return {
            name: arrays[name]
            for name, info in self.analyzed.field_infos.items()
            if info.access & AccessKind.WRITE and name in arrays
        }

