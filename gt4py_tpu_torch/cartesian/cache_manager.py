"""Cache inspection and cleaning.

Copied from gt4py_tpu/cartesian/cache_manager.py, the counterpart of the
reference's ``gt4py.cartesian.gt_cache_manager``: enumerate and clean the
port's persistent cache tree, ``<GT_CACHE_ROOT>/torch`` (caching.py). Its
subsystems are ``cuda/`` (the generated CUDA sources, their ``nvcc`` logs
and libraries, cuda_backend.py), ``cbackend/`` (the ``cpu:c`` backend's C
sources and shared objects, c_backend.py) and ``traces/`` (the Chrome
traces of ``instrumentation.gpu_trace``).
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator

from gt4py_tpu_torch.cartesian.caching import GT_CACHE_ROOT


def cache_info(root: str | None = None) -> dict:
    """Sizes (bytes) and entry counts per cache subsystem."""
    root = root or GT_CACHE_ROOT
    info: dict = {"root": root, "subsystems": {}, "total_bytes": 0}
    if not os.path.isdir(root):
        return info
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        size = 0
        count = 0
        if os.path.isdir(path):
            for dirpath, _, files in os.walk(path):
                for f in files:
                    try:
                        size += os.path.getsize(os.path.join(dirpath, f))
                        count += 1
                    except OSError:
                        pass
        else:
            size = os.path.getsize(path)
            count = 1
        info["subsystems"][entry] = {"bytes": size, "entries": count}
        info["total_bytes"] += size
    return info


def clean_cache(root: str | None = None, *, subsystem: str | None = None) -> None:
    """Remove the cache tree (or one subsystem: ``cuda``, ``cbackend``,
    ``traces``)."""
    root = root or GT_CACHE_ROOT
    if subsystem is not None:
        target = os.path.join(root, subsystem)
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
        elif os.path.isfile(target):
            os.unlink(target)
        return
    if os.path.isdir(root):
        shutil.rmtree(root, ignore_errors=True)


def iter_cached_stencils(root: str | None = None) -> Iterator[str]:
    """Keys of the built CUDA libraries (one per generated source: the
    ``gt_<key>.so`` files of ``cuda/``)."""
    root = root or GT_CACHE_ROOT
    cudadir = os.path.join(root, "cuda")
    if os.path.isdir(cudadir):
        for name in sorted(os.listdir(cudadir)):
            if name.startswith("gt_") and name.endswith(".so"):
                yield name[len("gt_"): -len(".so")]
