"""The port's backend tiers and exclusion matrix.

On the pattern of tests/cartesian_tests/definitions.py:47-84 (the JAX
package's), built from the port's own registry: tests declare the features
they exercise, and whether a backend runs them, skips them, or serves them
with another kernel than their class's comes from ONE table. The JAX
package's matrix has no row for ``debug`` (nor for ``numpy`` or
``cpu:c``), so the port's has none either. Its rows are the constructs
``cuda:hopper`` refuses on a card (tests/test_torch_cpu_backends.py holds
the table against what the code generator does):

- ``USES_WIDE_TEMPORARY``: a temporary whose planes, with their halo, need
  more shared memory than a block may have (``_too_wide_temporary`` in
  tests/test_torch_cuda_codegen.py): no kernel, and a call on CUDA tensors
  raises ``CudaUnsupported`` (CPU tensors run the plain version);
- ``USES_FUSED_LOWER_DIM``, lower-dimensional fields in a stencil of K4's class
  built with the stage-fusion switch on: ``fused_column``
  refuses lower-dimensional fields, as the JAX package's K4 does
  (pallas_seq.py:314-320), and ``column`` serves the stencil instead.
"""

from __future__ import annotations

import pytest

from gt4py_tpu_torch.cartesian.backend.base import REGISTRY
from gt4py_tpu_torch.storage import layout_from_name

ALL_BACKENDS = sorted(REGISTRY)
#: backends whose storages live on the CPU: how a caller asks for the CPU
CPU_BACKENDS = [b for b in ALL_BACKENDS if layout_from_name(b).device == "cpu"]
#: backends whose storages live on the card (on CPU tensors: the plain version)
CARD_BACKENDS = [b for b in ALL_BACKENDS if layout_from_name(b).device == "cuda"]

# --- feature markers ---------------------------------------------------------

USES_WIDE_TEMPORARY = "uses_wide_temporary"
USES_FUSED_LOWER_DIM = "uses_fused_lower_dim"
#: a marker the JAX package's tests declare (test_stencils.py); no row of
#: the port's matrix names it: every backend runs a while loop
USES_WHILE = "uses_while"

SKIP = "skip"
XFAIL = "xfail"
#: no kernel serves the construct: a call on CUDA tensors raises
REFUSED_ON_CARD = "refused_on_card"
#: the construct runs correctly on the card, but through another kernel
#: than its class's (with the stage-fusion switch on: ``column``, not
#: ``fused_column``)
OTHER_KERNEL = "other_kernel"

#: backend -> {feature marker -> SKIP | XFAIL | REFUSED_ON_CARD | OTHER_KERNEL}
BACKEND_SKIP_TEST_MATRIX: dict[str, dict[str, str]] = {b: {} for b in ALL_BACKENDS}
BACKEND_SKIP_TEST_MATRIX["cuda:hopper"] = {
    USES_WIDE_TEMPORARY: REFUSED_ON_CARD,
    USES_FUSED_LOWER_DIM: OTHER_KERNEL,
}


def apply_exclusion(backend: str, *features: str, on_card: bool = False) -> None:
    """Skip/xfail the current test according to the matrix; ``on_card``:
    the test runs on CUDA tensors, where a refused construct raises."""
    table = BACKEND_SKIP_TEST_MATRIX.get(backend, {})
    for feature in features:
        action = table.get(feature)
        if action == SKIP or (on_card and action == REFUSED_ON_CARD):
            pytest.skip(f"{backend} does not support {feature}")
        if action == XFAIL:
            pytest.xfail(f"{backend} known-broken for {feature}")


def expects_kernel_of_class(backend: str, *features: str) -> bool:
    """False when any feature is served by another kernel than its class's
    on this backend — strategy-assertion tests use this instead of
    hardcoding."""
    table = BACKEND_SKIP_TEST_MATRIX.get(backend, {})
    return not any(table.get(f) in (OTHER_KERNEL, REFUSED_ON_CARD) for f in features)
