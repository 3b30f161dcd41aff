"""Stencil fingerprinting and compilation caching.

Copied from gt4py_tpu/cartesian/caching.py; imports renamed.

Counterpart of the reference's ``JITCachingStrategy``
(src/gt4py/cartesian/caching.py:159): the fingerprint is a
hash of (definition source, backend, externals, dtypes, literal precisions,
API version). The reference stores generated source trees under
``.gt_cache``; the port keeps its build records and compiled CUDA libraries
under ``GT_CACHE_ROOT`` (``<root>/.gt_cache/torch``), apart from the JAX
package's entries.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import textwrap
from typing import Callable

from gt4py_tpu_torch import config

API_VERSION = "1"

GT_CACHE_ROOT = os.path.join(
    os.environ.get("GT_CACHE_ROOT", os.path.join(os.getcwd(), ".gt_cache")), "torch"
)


def stencil_fingerprint(definition: Callable, build_options: dict) -> str:
    try:
        source = textwrap.dedent(inspect.getsource(definition))
    except OSError:
        source = repr(definition)
    parts = [
        API_VERSION,
        getattr(definition, "__module__", ""),
        getattr(definition, "__qualname__", ""),
        source,
        str(build_options.get("backend")),
        repr(sorted(build_options.get("externals", {}).items())),
        repr(sorted((k, str(v)) for k, v in build_options.get("dtypes", {}).items())),
        str(build_options.get("literal_int_precision")),
        str(build_options.get("literal_float_precision")),
        str(build_options.get("name")),
        # backend options change the pass pipeline (skip/add steps), so a
        # custom PassPipeline must not reuse another pipeline's artifacts
        repr(sorted((k, repr(v)) for k, v in build_options.get("backend_opts", {}).items())),
        # the stage-fusion switch picks the kernel (column or fused_column)
        f"fuse_stages={config.fuse_stages()}",
    ]
    return hashlib.sha256("\x00".join(parts).encode()).hexdigest()
