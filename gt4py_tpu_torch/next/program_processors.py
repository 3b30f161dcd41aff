"""Program processors: formatters and execution inspectors.

Counterpart of gt4py_tpu/next/program_processors.py (role of the
reference's ``gt4py.next.program_processors`` formatter family,
src/gt4py/next/program_processors/program_formatter.py and the ITIR pretty
printer, iterator/pretty_printer.py): processors that *render* a program
instead of executing it. On the H100 the program IR is the cartesian GTIR
the bridge traces an operator into, the lowered form its generated CUDA
C++, and the compiled form the kernel library ``nvcc`` builds from it:

- :func:`format_gtir` (the JAX package's ``format_jaxpr``),
- :func:`format_cuda` (``format_lowered``),
- :func:`format_compiled` (``format_compiled``): what ``ptxas`` reported
  for each kernel and, where the toolkit has ``cuobjdump``, the SASS.

Each takes the operator, its example arguments and ``out=`` (the bridge
traces for one out field), and ``offset_provider=``. An operator the
bridge refuses raises ``BridgeUnsupported`` with the reason.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Optional


def _exec_fn(op: Any):
    """The function that would actually execute: the FOAST-compiled form
    for FieldOperators (so transform effects — barriers, unrolls — are
    visible in every artifact), the object itself otherwise."""
    if hasattr(op, "definition") and hasattr(op, "transform_options"):
        from gt4py_tpu_torch.next.foast import exec_definition

        return exec_definition(op)
    return getattr(op, "definition", op)


def _job(op: Any, args: tuple, kwargs: dict, stop: str):
    """The ``cuda:hopper:aot`` workflow on ``op``'s executed function, run
    up to the stage ``stop`` ('trace', 'lower' or 'compile')."""
    from gt4py_tpu_torch.next.backend import resolve
    from gt4py_tpu_torch.next.cartesian_bridge import BridgeUnsupported

    transforms = resolve("cuda:hopper:aot").transforms
    if stop == "trace":
        transforms = transforms.replace(lower=None, compile=None)
    elif stop == "lower":
        transforms = transforms.replace(compile=None)
    kwargs = dict(kwargs)
    out, provider = kwargs.pop("out", None), kwargs.pop("offset_provider", None)
    job = resolve("cuda:hopper:aot").replace(transforms=transforms).compile_job(
        _exec_fn(op), *args, out=out, offset_provider=provider, **kwargs
    )
    if job.unsupported is not None:
        raise BridgeUnsupported(job.unsupported)
    return job


def format_gtir(op: Any, *args: Any, **kwargs: Any) -> str:
    """The cartesian GTIR the bridge traces the operator into for these
    arguments (``gtir_pretty`` text) — the analog of formatting ITIR after
    transforms."""
    return _job(op, args, kwargs, "trace").traced_stage.text


def format_cuda(op: Any, *args: Any, **kwargs: Any) -> str:
    """The generated CUDA C++ of the traced variant: what ``nvcc`` builds."""
    return _job(op, args, kwargs, "lower").lowered_stage.text


def cuobjdump() -> Optional[str]:
    """The toolkit's ``cuobjdump``, or None where it has none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")):
        if path and os.path.isfile(path):
            return path
    return None


def format_compiled(op: Any, *args: Any, **kwargs: Any) -> str:
    """What runs: the kernel library built from the variant's source —
    each kernel's ``ptxas`` report (registers, spill bytes, static shared
    bytes) and, where the toolkit has ``cuobjdump``, its SASS. Builds with
    ``nvcc``; raises RuntimeError naming the missing tool where there is
    no ``nvcc`` or no card."""
    import torch

    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    nvcc = cuda_backend.nvcc_path()
    if not os.path.isfile(nvcc) or not torch.cuda.is_available():
        raise RuntimeError(
            f"format_compiled needs nvcc ({nvcc}: "
            f"{'found' if os.path.isfile(nvcc) else 'not found'}) and a CUDA card "
            f"({'found' if torch.cuda.is_available() else 'none'}) to build the library"
        )
    lowered = _job(op, args, kwargs, "lower").lowered_stage
    if lowered.module is None:
        raise RuntimeError(f"no kernel serves the operator: {lowered.unsupported}")
    cuda_backend.load_library(lowered.text)
    _, library, source_path = cuda_backend._paths(lowered.text)
    from gt4py_tpu_torch.next.stages import ptxas_report

    with open(source_path + ".log") as f:
        report = ptxas_report(f.read())
    lines = [f"// library {library} ({lowered.strategy})"]
    for kernel, info in sorted(report.items()):
        lines.append(
            f"// {kernel}: {info['registers']} registers, {info['spill_store_bytes']} bytes "
            f"spill stores, {info['spill_load_bytes']} bytes spill loads, "
            f"{info['static_shared_bytes']} bytes static shared"
        )
    tool = cuobjdump()
    if tool is None:
        lines.append("// no cuobjdump in the toolkit: SASS not shown")
    else:
        sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True)
        lines.append(sass.stdout)
    return "\n".join(lines)
