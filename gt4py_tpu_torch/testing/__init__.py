"""Testing kit: hypothesis-driven stencil test suites and input strategies.

Copied from gt4py_tpu/testing/__init__.py; imports renamed. Counterpart of
the reference's ``gt4py.cartesian.testing``
(src/gt4py/cartesian/testing/suites.py:53, input_strategies.py:47):
declarative stencil test-suite classes that run a definition on every
backend of the port's registry against a NumPy validation oracle with
hypothesis-generated fields.
"""

from gt4py_tpu_torch.testing.input_strategies import (  # noqa: F401
    field,
    global_boundaries,
    parameter,
)
from gt4py_tpu_torch.testing.suites import StencilTestSuite  # noqa: F401
