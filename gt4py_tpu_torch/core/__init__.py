from gt4py_tpu_torch.core.definitions import (  # noqa: F401
    DeviceType,
    DType,
    bfloat16,
    LITERAL_FLOAT_PRECISION,
    LITERAL_INT_PRECISION,
)
