from gt4py_tpu_torch.storage.interface import (  # noqa: F401
    empty,
    zeros,
    ones,
    full,
    from_array,
)
from gt4py_tpu_torch.storage.storage import Storage  # noqa: F401
from gt4py_tpu_torch.storage.layout import (  # noqa: F401
    LayoutInfo,
    from_name as layout_from_name,
    register as register_layout,
)
