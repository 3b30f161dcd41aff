"""Helper module for test_torch_import_from_mod.py (the port's copy of
tests/next_tests/mod_helpers.py): dims, field types, and an
operator referenced through dotted module attributes from another module
(reference tests/next_tests/integration_tests/feature_tests/ffront_tests/
test_import_from_mod.py uses `cases`/`integration_tests.cases` this way)."""

import numpy as np

import gt4py_tpu_torch.next as gtx

I = gtx.Dimension("Imod")
K = gtx.Dimension("Kmod", kind=gtx.DimensionKind.VERTICAL)

IField = gtx.Field[gtx.Dims[I], np.float64]
IKField = gtx.Field[gtx.Dims[I, K], np.float64]
