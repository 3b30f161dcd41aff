"""Environment-driven configuration flags.

Copied from gt4py_tpu/config.py; imports renamed. Only the settings that
the port reads are kept: the build and cache settings, and the debug
flags that ``next/errors.py`` reads. The JAX package's JIT and Pallas
switches have no counterpart, nor has its trace-marker switch
(``GT4PY_ADD_TPU_TRACE_MARKERS``): the port's spans
(instrumentation/spans.py) are switched by ``torch.profiler`` itself,
recorded in a profile and NVTX ranges under
``torch.autograd.profiler.emit_nvtx``. Values are read once at import;
tests may monkeypatch module attributes directly.

Environment variables honored (reference names kept where meaningful):

- ``GT_CACHE_ROOT``           cache root directory (default ``./.gt_cache``);
                              the port keeps its caches under ``<root>/torch``
- ``GT_CACHE_DIR_NAME``       subdirectory name for per-project caches
- ``GT4PY_DEBUG``             verbose exceptions + debug artifacts
- ``GT4PY_VERBOSE_EXCEPTIONS``
- ``GT4PY_BUILD_CACHE_LIFETIME``  ``session`` | ``persistent``
- ``GT4PY_COLLECT_METRICS_LEVEL`` (instrumentation/metrics.py): spans feed
                              the metrics at this level or above
- ``GT4PY_DUMP_METRICS_AT_EXIT``
- ``GT4PY_CUDA_FUSE_STAGES``  ``1`` runs every vertical loop of a sequential
                              stencil of K4's class in one ``fused_column``
                              kernel (default ``0``: one ``column`` launch per
                              loop); the JAX package's ``GT4PY_PALLAS_FUSE_STAGES``
                              (pallas_seq.py:302-312). Read when a stencil is
                              built (:func:`fuse_stages`), and part of its
                              fingerprint.
- ``GT4PY_GPU_TRACE_DIR``     where ``instrumentation.gpu_trace`` writes its
                              Chrome traces (default ``<CACHE_ROOT>/traces``)
"""

from __future__ import annotations

import enum
import os
import tempfile
from typing import Final


def env_flag_to_bool(name: str, default: bool) -> bool:
    """Parse a boolean env var (reference: next/config.py:59)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"Invalid boolean value {raw!r} for environment variable {name}")


class BuildCacheLifetime(enum.Enum):
    """Reference: next/config.py:110 (SESSION deletes at exit, PERSISTENT keeps)."""

    SESSION = "session"
    PERSISTENT = "persistent"


#: Master debug switch (reference GT4PY_DEBUG, next/config.py:96).
DEBUG: Final[bool] = env_flag_to_bool("GT4PY_DEBUG", False)

#: Pretty-printed DSL exceptions with source frames (next/config.py:104).
VERBOSE_EXCEPTIONS: bool = env_flag_to_bool("GT4PY_VERBOSE_EXCEPTIONS", DEBUG)

#: Root of all persistent caches (reference GT_CACHE_ROOT, cartesian/config.py:83).
#: The port's own subdirectory, so it never shares fingerprints with gt4py_tpu.
CACHE_ROOT: str = os.path.join(
    os.environ.get("GT_CACHE_ROOT", os.path.join(os.getcwd(), ".gt_cache")), "torch"
)

#: Per-project cache directory name (reference GT_CACHE_DIR_NAME).
CACHE_DIR_NAME: str = os.environ.get("GT_CACHE_DIR_NAME", "gt4py_tpu_torch")

#: Directory of instrumentation.gpu_trace's Chrome traces.
GPU_TRACE_DIR: str = os.environ.get("GT4PY_GPU_TRACE_DIR", os.path.join(CACHE_ROOT, "traces"))

_lifetime_raw = os.environ.get("GT4PY_BUILD_CACHE_LIFETIME", "persistent").lower()
BUILD_CACHE_LIFETIME: BuildCacheLifetime = BuildCacheLifetime(_lifetime_raw)


def fuse_stages() -> bool:
    """The stage-fusion switch, as it stands when a stencil is built."""
    return os.environ.get("GT4PY_CUDA_FUSE_STAGES", "0").lower() not in ("0", "", "false")


def cache_dir() -> str:
    """Resolved cache directory honoring the lifetime setting."""
    if BUILD_CACHE_LIFETIME is BuildCacheLifetime.SESSION:
        d = os.path.join(tempfile.gettempdir(), f"gt4py_tpu_torch_session_{os.getuid()}")
    else:
        d = os.path.join(CACHE_ROOT, CACHE_DIR_NAME)
    os.makedirs(d, exist_ok=True)
    return d
