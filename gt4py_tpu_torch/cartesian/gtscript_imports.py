"""Import hook for ``.gt.py`` stencil definition files.

Copied from gt4py_tpu/cartesian/gtscript_imports.py; imports renamed.

Counterpart of the reference's ``gt4py.cartesian.gtscript_imports``
(src/gt4py/cartesian/gtscript_imports.py:57,146 —
GtsFinder/GtsLoader): after :func:`enable`, ``import foo`` resolves
``foo.gt.py`` on the search path and executes it with the GTScript
vocabulary pre-injected (no explicit imports needed in the DSL file).
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import importlib.util
import os
import sys
from typing import Optional, Sequence

SUFFIX = ".gt.py"


def _gtscript_globals() -> dict:
    import numpy as np

    from gt4py_tpu_torch.cartesian import gtscript

    env = {
        name: getattr(gtscript, name)
        for name in (
            "Field",
            "GlobalTable",
            "I",
            "J",
            "K",
            "IJ",
            "IK",
            "JK",
            "IJK",
            "PARALLEL",
            "FORWARD",
            "BACKWARD",
            "computation",
            "interval",
            "horizontal",
            "region",
            "function",
            "stencil",
            "lazy_stencil",
            "compile_assert",
        )
    }
    env.update(gtscript.MATH_BUILTINS)
    env["__INLINED"] = getattr(gtscript, "__INLINED")
    env["gtscript"] = gtscript
    env["np"] = np
    return env


class GtsLoader(importlib.abc.SourceLoader):
    def __init__(self, fullname: str, path: str):
        self.fullname = fullname
        self.path = path

    def get_filename(self, fullname: str) -> str:
        return self.path

    def get_data(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exec_module(self, module) -> None:
        module.__dict__.update(_gtscript_globals())
        super().exec_module(module)


class GtsFinder(importlib.abc.MetaPathFinder):
    def __init__(self, search_paths: Optional[Sequence[str]] = None):
        self.search_paths = list(search_paths) if search_paths else None

    def find_spec(self, fullname, path=None, target=None):
        paths = self.search_paths if self.search_paths is not None else sys.path
        basename = fullname.rsplit(".", 1)[-1] + SUFFIX
        for entry in paths:
            candidate = os.path.join(entry or ".", basename)
            if os.path.isfile(candidate):
                return importlib.util.spec_from_file_location(
                    fullname, candidate, loader=GtsLoader(fullname, candidate)
                )
        return None


_installed: Optional[GtsFinder] = None


def enable(search_path: Optional[Sequence[str]] = None) -> GtsFinder:
    """Install the ``.gt.py`` finder (idempotent)."""
    global _installed
    if _installed is None:
        _installed = GtsFinder(search_path)
        sys.meta_path.append(_installed)
    elif search_path is not None:
        _installed.search_paths = list(search_path)
    return _installed


def disable() -> None:
    global _installed
    if _installed is not None:
        sys.meta_path.remove(_installed)
        _installed = None
