"""gt4py_tpu_torch.next — the declarative field-view DSL on torch.

Counterpart of gt4py_tpu/next/ (and of the reference's ``gt4py.next``):
Dimension/Domain/Field model, @field_operator / @scan_operator / @program
entry points, neighbor reductions over connectivities. Four backends:
``torch`` (the default; embedded execution on torch tensors, the JAX
package's ``jax`` and ``embedded``), ``cuda:hopper`` (operators whose
offsets are all cartesian run through the cartesian bridge on the port's
Hopper kernels; the rest runs embedded — the JAX package's
``tpu:pallas``), ``cuda:hopper:aot`` (the same through explicit trace,
lower and compile stages — ``jax:aot``) and ``numpy`` (the oracle: NumPy
on the host). Constructors put fields on the card unless the caller
passes ``device="cpu"``.
"""

from gt4py_tpu_torch.next.common import (  # noqa: F401
    CartesianConnectivity,
    Connectivity,
    NeighborTable,
    as_non_staggered,
    check_dims,
    connectivity_for_cartesian_shift,
    flip_staggered,
    is_staggered,
    promote_dims,
    deduce_grid_type,
    Dimension,
    DimensionKind,
    Dims,
    Domain,
    FieldOffset,
    GridType,
    Infinity,
    NamedIndex,
    NamedRange,
    UnitRange,
    domain,
    named_range,
    unit_range,
)
from gt4py_tpu_torch.next.constructors import (  # noqa: F401
    as_connectivity,
    as_field,
    empty,
    full,
    ones,
    zeros,
)
from gt4py_tpu_torch.next.decorators import (  # noqa: F401
    field_operator,
    program,
    scan_operator,
)
from gt4py_tpu_torch.next.embedded import Field  # noqa: F401
from gt4py_tpu_torch.next.foast import TransformOptions  # noqa: F401
from gt4py_tpu_torch.next.errors import (  # noqa: F401
    DSLError,
    DSLSyntaxError,
    DSLTypeError,
    UndefinedSymbolError,
)
from gt4py_tpu_torch.next.fbuiltins import (  # noqa: F401
    astype,
    concat_where,
    broadcast,
    max_over,
    min_over,
    neighbor_sum,
    where,
)

# Math builtins + scalar-kind aliases at package level (reference
# next/__init__.py exports every fbuiltin: gtx.sin, gtx.float64, ...).
from gt4py_tpu_torch.next import fbuiltins as _fb  # noqa: E402

for _name in _fb.MATH_BUILTIN_NAMES + _fb.DTYPE_ALIAS_NAMES:
    globals()[_name] = getattr(_fb, _name)
del _fb, _name
from gt4py_tpu_torch.next.field_utils import asnumpy  # noqa: F401,E402
from gt4py_tpu_torch.next.named_collections import named_collection  # noqa: F401,E402
from gt4py_tpu_torch.next.experimental import as_offset  # noqa: F401,E402
from gt4py_tpu_torch.next.mesh_utils import (  # noqa: F401,E402
    Renumbering,
    spatial_renumbering,
)


def wait_for_compilation() -> None:
    """Kept for the JAX package's API (reference
    otf/compiled_program.wait_for_compilation): every variant here builds
    inline on its first call, so there is nothing to wait for."""


from gt4py_tpu_torch.next.otf import (  # noqa: F401,E402
    CompilationOptions,
    CompiledProgramsPool,
    MultiWorkflow,
    NamedStepSequence,
)
from gt4py_tpu_torch.next import stages  # noqa: F401,E402
from gt4py_tpu_torch.next.backend import (  # noqa: F401,E402
    Backend,
    Transforms,
    resolve as resolve_backend,
)

# Pretty, compact reporting for DSL errors reaching the top level
# (reference installs its excepthook on import, next/errors/excepthook.py:40).
from gt4py_tpu_torch.next.errors import install_excepthook as _install_excepthook  # noqa: E402

_install_excepthook()
