"""Typed field operators: definition-time type deduction.

Counterpart of examples/typed_operators.py. Annotating parameters with
``Field[Dims[...], dtype]`` opts a field operator into AST-level type
checking: dimension/dtype mistakes surface at decoration time with source
locations, and calls are validated against the deduced signature before
any trace (so nothing reaches a kernel). The Laplacian itself, on 2-D
fields, runs on ``cuda:hopper`` through the bridge onto ``fused_plane``.

Run: python -m gt4py_tpu_torch.examples.typed_operators [backend]
"""

import sys

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.examples import field_device
from gt4py_tpu_torch.next import Dimension, Dims, Field, FieldOffset
from gt4py_tpu_torch.next.errors import DSLTypeError

I = Dimension("I")
J = Dimension("J")
Ioff = FieldOffset("Ioff", source=I, target=(I,))
Joff = FieldOffset("Joff", source=J, target=(J,))

F64 = Field[Dims[I, J], np.float64]


@gtx.field_operator
def laplacian(phi: F64) -> F64:
    return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])


def main(backend="cuda:hopper", device=None, n: int = 16) -> dict:
    """Returns what the example prints: the deduced signature, the
    Laplacian's values, and the first line of each rejection; and the
    operator that ran."""
    dev = field_device(backend, device)
    op = laplacian.with_backend(backend)
    shown = {"signature": str(laplacian.type_info), "op": op}
    print("deduced signature:", shown["signature"])

    phi = gtx.as_field([I, J], np.random.default_rng(0).random((n, n)), device=dev)
    out = gtx.zeros({I: (1, n - 1), J: (1, n - 1)}, device=dev)
    op(phi, out=out, offset_provider={"Ioff": I, "Joff": J})
    shown["out"] = out.asnumpy()
    print("laplacian out[0,:3] =", shown["out"][0, :3])

    # A wrongly-dimensioned argument is rejected BEFORE tracing:
    bad = gtx.as_field([I], np.zeros(n), device=dev)
    try:
        op(bad, out=out, offset_provider={"Ioff": I, "Joff": J})
    except DSLTypeError as e:
        shown["rejected"] = str(e).splitlines()[0]
        print("rejected:", shown["rejected"])

    # Definition mistakes error at decoration time, with a location:
    try:

        @gtx.field_operator
        def broken(a: Field[Dims[J], np.float64]):
            return a(Ioff[1])  # no I dimension to shift along

    except DSLTypeError as e:
        shown["decoration"] = str(e).splitlines()[0]
        print("decoration-time error:", shown["decoration"])
    return shown


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
