"""Copied from gt4py_tpu/cartesian/passes/__init__.py; imports renamed."""

from gt4py_tpu_torch.cartesian.passes.pipeline import (  # noqa: F401
    AnalyzedStencil,
    PassPipeline,
    analyze,
)
