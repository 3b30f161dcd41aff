from gt4py_tpu_torch.cartesian import gtscript  # noqa: F401
from gt4py_tpu_torch.cartesian.stencil_object import FrozenStencil, StencilObject  # noqa: F401
