"""The backend wrapper's host µs in one warm ``chain`` call: the mean, over
the traced calls, of the ``gt4py.backend.run_steps`` span's duration less
the part its ``replay``, ``launch`` and ``capture`` children cover (the
chain and graph lookups of ``CudaHopperBackend.run_steps``). A replay is
left out because under a full launch queue it holds the device's time. The
port's spans (perfbench/program_spans.py); None where it records none."""

from perfbench import program_spans

WORK = ("gt4py.backend.replay", "gt4py.backend.launch", "gt4py.backend.capture")


def read(run):
    calls = program_spans.traced_calls(run)
    if not calls:
        return None
    total = 0
    for _, rs in calls:
        for s in rs:
            if s.name == "gt4py.backend.run_steps":
                total += program_spans.self_ns(
                    s, [c for c in rs if c.parent == s.id and c.name in WORK])
    return total / len(calls) / 1e3
