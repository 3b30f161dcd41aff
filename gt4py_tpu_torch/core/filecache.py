"""Persistent pickle-on-disk cache with file locking.

Copied from gt4py_tpu/core/filecache.py; imports renamed.

Role of the reference's ``gt4py._core.filecache.FileCache``
(src/gt4py/_core/filecache.py:19): a dict-like store keyed
by string hashes, backing persistent translation/lowering caches. Writes
are crash-consistent: value pickled to a temp file and atomically renamed
(the reference's crash-consistent build-cache ADR, otf/compilation/cache.py),
with a per-key advisory lock for cross-process writers.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Iterator

from gt4py_tpu_torch.core.locking import lock


class FileCache:
    """Dict-like persistent cache: ``cache[key] = value`` pickles to
    ``<root>/<keyhash>.pkl``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(self.root, f"{digest}.pkl")

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def __getitem__(self, key: str) -> Any:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            raise KeyError(key) from None
        except (pickle.UnpicklingError, EOFError, ValueError, AttributeError, IndexError):
            # Torn write from a crashed process: treat as missing.
            try:
                os.unlink(path)
            except OSError:
                pass
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key: str, value: Any) -> None:
        path = self._path(key)
        with lock(path + ".lock"):
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=4)
            os.replace(tmp, path)

    def __delitem__(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            raise KeyError(key) from None

    def setdefault(self, key: str, default: Any) -> Any:
        try:
            return self[key]
        except KeyError:
            self[key] = default
            return default

    def keys(self) -> Iterator[str]:  # hashes only; original keys not stored
        for name in os.listdir(self.root):
            if name.endswith(".pkl"):
                yield name[: -len(".pkl")]

    def clear(self) -> None:
        for name in os.listdir(self.root):
            if name.endswith((".pkl", ".lock")):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass
