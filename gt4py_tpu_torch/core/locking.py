"""Cross-process advisory file locks.

Copied from gt4py_tpu/core/locking.py; imports renamed.

Role of the reference's ``gt4py._core.locking`` (src/gt4py/
_core/locking.py:31): serialize concurrent builds/cache writes across
processes. Implemented on ``fcntl.flock`` (POSIX) with a context-manager
API; reentrant within a process per path.
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
import time
from typing import Iterator


_local = threading.local()


@contextlib.contextmanager
def lock(path: str, *, timeout: float | None = None, poll: float = 0.05) -> Iterator[None]:
    """Acquire an exclusive advisory lock on ``path`` (created if missing).

    Reentrant within the thread. ``timeout`` of None waits forever;
    raises ``TimeoutError`` otherwise.
    """
    held: dict[str, int] = getattr(_local, "held", None) or {}
    _local.held = held
    key = os.path.abspath(path)
    if held.get(key, 0) > 0:
        held[key] += 1
        try:
            yield
        finally:
            held[key] -= 1
        return

    os.makedirs(os.path.dirname(key) or ".", exist_ok=True)
    fd = os.open(key, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        import fcntl

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as e:
                if e.errno not in (errno.EACCES, errno.EAGAIN):
                    raise
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"could not lock {path!r} within {timeout}s") from None
                time.sleep(poll)
        held[key] = 1
        try:
            yield
        finally:
            held[key] = 0
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
