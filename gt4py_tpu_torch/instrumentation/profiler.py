"""GPU profiling helpers.

Counterpart of gt4py_tpu/instrumentation/profiler.py, which gives the JAX
package ``jax.profiler`` traces and ``jax.named_scope`` annotations; here,
as in the reference's GPU profiler (CUDA events + NVTX ranges,
src/gt4py/next/instrumentation/gpu_profiler.py:48-233), the trace is
``torch.profiler``'s (CUPTI: host calls, CUDA runtime calls and device
kernels on one timeline) and a scope is a span (spans.py): a
``record_function`` range while a profile records, an NVTX range under
``torch.autograd.profiler.emit_nvtx``.

- :func:`named_scope` (spans.py) annotates the enclosed work in traces; the
  profiler's own state switches it, where the JAX package reads
  ``GT4PY_ADD_TPU_TRACE_MARKERS``. Unlike the JAX package, the port's
  runtime, backend and build open spans of their own (``gt4py.*``).
- :func:`gpu_trace` captures a trace of the enclosed block and writes it as
  a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``
  (default ``GT4PY_GPU_TRACE_DIR``, else ``<GT_CACHE_ROOT>/torch/traces``).
  It traces the CPU and the card; without a card it raises, unless the
  caller asks for ``activities="cpu"``, a host-only trace.
- :func:`spin_ms` reads the card time of queued work with CUDA events,
  the stream first held by a spin kernel so that the host's queuing stays
  out of the reading.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Sequence, Union

from gt4py_tpu_torch import config


@contextlib.contextmanager
def gpu_trace(
    log_dir: Optional[str] = None,
    *,
    activities: Union[str, Sequence[str]] = ("cpu", "cuda"),
) -> Iterator["object"]:
    """Trace the enclosed block with ``torch.profiler.profile``; yields the
    profile (``key_averages()``, ``events()``). On exit the Chrome trace is
    written to ``log_dir`` and its path set as the profile's
    ``trace_path``. ``activities``: ``"cpu"`` and/or ``"cuda"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kinds = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
    wanted = (activities,) if isinstance(activities, str) else tuple(activities)
    unknown = [a for a in wanted if a not in kinds]
    if unknown or not wanted:
        raise ValueError(f"gpu_trace: activities must be 'cpu' and/or 'cuda', not {activities!r}")
    if "cuda" in wanted and not torch.cuda.is_available():
        raise RuntimeError(
            "gpu_trace: no CUDA card to trace (torch.cuda.is_available() is false); "
            "pass activities='cpu' for a host-only trace"
        )
    log_dir = log_dir or config.GPU_TRACE_DIR
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[kinds[a] for a in wanted]) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def spin_ms(work, n: int = 1, name: str = "work", cycles: int = 100_000_000,
            tries: int = 4) -> float:
    """ms per step that ``work()``, ``n`` steps, holds the card: CUDA
    events around it, with the stream first held by a spin kernel of
    ``cycles`` clock cycles (100 M: about 50 ms on an H100) so that the host
    queues every launch behind it. Where the host was still queuing when
    the spin ended, the spin is made 4 times longer, ``tries`` times in all,
    then it raises."""
    import torch

    torch.cuda.synchronize()
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        work()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise RuntimeError(f"{name}: the host did not queue {n} steps within a spin of "
                       f"{cycles // 4} cycles")
