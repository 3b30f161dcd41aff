from gt4py_tpu_torch.cartesian.backend.base import (  # noqa: F401
    Backend,
    REGISTRY,
    from_name,
    register,
)

# Import the concrete backends so they self-register in the port's own
# registry (gt4py_tpu's registry never sees them).
from gt4py_tpu_torch.cartesian.backend import c_backend  # noqa: F401,E402
from gt4py_tpu_torch.cartesian.backend import cuda_backend  # noqa: F401,E402
from gt4py_tpu_torch.cartesian.backend import debug_backend  # noqa: F401,E402
from gt4py_tpu_torch.cartesian.backend import numpy_backend  # noqa: F401,E402
from gt4py_tpu_torch.cartesian.backend import torch_backend  # noqa: F401,E402
