"""The runtime's host µs in one warm ``chain`` call: the mean, over the
traced calls, of the ``gt4py.chain`` span's duration less the part its
child spans cover (``StencilObject.chain``'s own work: binding, the fields'
infos, the call key and the chain cache, the scalars and the write-back).
The port's spans (perfbench/program_spans.py); None where it records none."""

from perfbench import program_spans


def read(run):
    calls = program_spans.traced_calls(run)
    if not calls:
        return None
    total = sum(program_spans.self_ns(root, [c for c in rs if c.parent == root.id])
                for root, rs in calls)
    return total / len(calls) / 1e3
