"""gt4py_tpu_torch — the GTScript stencil framework on PyTorch and CUDA.

The port of ``gt4py_tpu`` (the JAX/TPU package, which stays the reference)
to PyTorch on one NVIDIA H100. It mirrors ``gt4py_tpu``'s layout, so each
module's counterpart is found by path. The array-free front half (eve,
GTIR, frontend, passes) is copied, because importing any ``gt4py_tpu``
module imports JAX. The backends are ``"torch"`` (eager, on whatever device
the tensors live on) and ``"cuda:hopper"`` (generated CUDA kernels).
"""

from gt4py_tpu_torch import cartesian, config, eve, storage  # noqa: F401,E402

__version__ = "0.1.0"
