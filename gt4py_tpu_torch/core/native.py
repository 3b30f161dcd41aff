"""ctypes binding for the native runtime helpers (core/fastpath.c).

Counterpart of gt4py_tpu/core/native.py, with its own copy of the C source
(``fastpath.c`` beside this module, a copy of csrc/fastpath.c). The shared
library is compiled on first use with the system C compiler into
``.gt_cache/torch/native/`` and the module falls back to pure Python when no
toolchain is available. Host code: ``next/allocators.CPUFieldBufferAllocator``
takes its buffers from :func:`aligned_empty`, as the JAX package's does; no
device path uses it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _csrc_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastpath.c")


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = _csrc_path()
    if not os.path.isfile(src):
        return None
    from gt4py_tpu_torch.cartesian.caching import GT_CACHE_ROOT

    out_dir = os.path.join(GT_CACHE_ROOT, "native")
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, "libgt4py_tpu_torch_fastpath.so")
    if not os.path.isfile(so_path) or os.path.getmtime(so_path) < os.path.getmtime(src):
        cc = os.environ.get("CC", "cc")
        tmp = f"{so_path}.tmp{os.getpid()}"
        cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.gt_fnv1a64.restype = ctypes.c_uint64
    lib.gt_fnv1a64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.gt_fnv1a64_combine.restype = ctypes.c_uint64
    lib.gt_fnv1a64_combine.argtypes = [ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
    lib.gt_aligned_alloc.restype = ctypes.c_void_p
    lib.gt_aligned_alloc.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.gt_free.restype = None
    lib.gt_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build_and_load()
    return _lib


def content_hash(data: bytes) -> int:
    """FNV-1a 64-bit content hash (native when available)."""
    lib = get_lib()
    if lib is not None:
        return int(lib.gt_fnv1a64(data, len(data)))
    return _fnv1a64(data)


def _fnv1a64(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


class _AlignedBuffer:
    """Owner object keeping the native allocation alive."""

    def __init__(self, lib: ctypes.CDLL, ptr: int, nbytes: int):
        self._lib = lib
        self._ptr = ptr
        self.nbytes = nbytes

    def __del__(self):
        if self._ptr:
            self._lib.gt_free(self._ptr)
            self._ptr = 0


def aligned_empty(shape, dtype=np.float64, *, alignment: int = 64) -> np.ndarray:
    """Host ndarray whose data pointer is ``alignment``-byte aligned
    (native allocation; falls back to NumPy over-allocation)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    lib = get_lib()
    if lib is not None and nbytes > 0:
        ptr = lib.gt_aligned_alloc(nbytes, alignment)
        if ptr:
            owner = _AlignedBuffer(lib, ptr, nbytes)
            buf = (ctypes.c_char * nbytes).from_address(ptr)
            # The ndarray keeps `buf` (its base) alive; `buf` keeps the
            # native allocation alive through the owner.
            buf._gt_owner = owner  # type: ignore[attr-defined]
            return np.frombuffer(buf, dtype=dtype).reshape(shape)
    # Fallback: over-allocate and offset (reference allocators.py scheme).
    pad = alignment // dtype.itemsize + 1
    raw = np.empty(int(np.prod(shape)) + pad, dtype=dtype)
    offset = (-raw.ctypes.data % alignment) // dtype.itemsize
    return raw[offset : offset + int(np.prod(shape))].reshape(shape)
