"""Custom backends: the user-controllable transforms pipeline.

Counterpart of examples/custom_backend.py. Backends are objects carrying a
``Transforms`` workflow; any step can be replaced. The JAX example's three
backends map onto the port as:

- ``jax:remat`` (``with_rewrites(jax.checkpoint)``): torch has no
  rematerialization of a forward-only program, so the rewrite here is a
  function→function wrapper that counts the calls it sees, injected the
  same way (``Transforms.with_rewrites``) into the ``torch`` backend;
- ``jax:aot`` (jaxpr → StableHLO → executable): ``cuda:hopper:aot``'s
  stages, the traced GTIR, the generated CUDA C++ and the built kernel
  (``cost_analysis()``: ``ptxas``'s report on the card, None on CPU
  tensors);
- ``jax:eager`` (``compile`` replaced by "no jit"): the same replacement,
  ``Backend.replace(transforms=...replace(compile=...))``.

``smooth`` also runs on ``cuda:hopper`` itself, through the cartesian
bridge onto ``fused_plane`` (a 1-D field is not ``plane``'s class), as
the AOT job does.

Run: python -m gt4py_tpu_torch.examples.custom_backend [backend]
"""

import sys

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.examples import field_device
from gt4py_tpu_torch.next import Dimension

I = Dimension("I")


@gtx.field_operator
def smooth(phi, alpha):
    return phi * (1.0 - alpha) + alpha * phi


def counting(calls: list):
    """A rewrite: wraps the specialized operator, appending to ``calls``
    at every execution."""

    def rewrite(fn):
        def counted(*args, **kwargs):
            calls.append(getattr(fn, "__name__", repr(fn)))
            return fn(*args, **kwargs)

        return counted

    return rewrite


def main(backend="cuda:hopper", device=None, n: int = 32, stencils=None) -> dict:
    """Runs ``smooth`` on the rewriting, ahead-of-time and eager backends
    and on ``backend``; returns each one's output (NumPy arrays), the AOT
    job, the rewrite's call log, the input field and the last operator.
    ``stencils``: the operator of ``smooth`` on ``backend`` to reuse."""
    dev = field_device(backend, device)
    phi = gtx.as_field([I], np.random.default_rng(1).random(n), device=dev)
    out = gtx.zeros({I: n}, device=dev)
    shown: dict = {"phi": phi}

    # 1. A rewriting backend: the specialized operator wrapped before it
    #    becomes the executable.
    base = gtx.resolve_backend("torch")
    calls: list = []
    rewritten = base.replace(
        name="torch:counted", transforms=base.transforms.with_rewrites(counting(calls))
    )
    smooth.with_backend(rewritten)(phi, alpha=0.3, out=out)
    shown["rewritten"], shown["calls"] = out.asnumpy(), calls
    print("rewriting backend out[:3] =", shown["rewritten"][:3], "calls:", len(calls))

    # 2. The explicit AOT chain, with every intermediate artifact:
    aot = smooth.with_backend("cuda:hopper:aot")
    job = aot.compiled_job(phi, alpha=0.3, out=out)
    shown["job"] = job
    print("GTIR:", job.traced_stage.text.strip().splitlines()[0], "...")
    print("CUDA C++ bytes:", len(job.lowered_stage.text))
    cost = job.compiled_stage.cost_analysis()
    print("ptxas:", cost)
    aot(phi, alpha=0.3, out=out)
    shown["aot"] = out.asnumpy()

    # 3. A fully custom compile step (here: the specialized function run
    #    as it is, eager debug).
    def eager_compile(job):
        job.executable = job.fn
        return job

    eager = base.replace(
        name="torch:eager", transforms=base.transforms.replace(compile=eager_compile)
    )
    smooth.with_backend(eager)(phi, alpha=0.3, out=out)
    shown["eager"] = out.asnumpy()
    print("eager backend out[:3] =", shown["eager"][:3])

    # 4. The backend asked for (cuda:hopper: through the cartesian bridge)
    op = stencils or smooth.with_backend(backend)
    op(phi, alpha=0.3, out=out)
    shown["backend"], shown["op"] = out.asnumpy(), op
    print(f"{backend} out[:3] =", shown["backend"][:3])
    return shown


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
