"""Laplacian: cartesian GTScript vs field-view DSL (48³ domain).

Counterpart of examples/lap_cartesian_vs_next.py: the same Laplacian
written in both DSLs, validated against NumPy. On ``cuda:hopper`` both
run on the ``plane`` kernel: the stencil directly, the field operator
through the cartesian bridge.

Run: python -m gt4py_tpu_torch.examples.lap_cartesian_vs_next [backend]
"""

import sys

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval
from gt4py_tpu_torch.examples import field_device
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset

N = 48
Field3D = gtscript.Field[np.float64]


# --- cartesian --------------------------------------------------------------


def lap_cartesian(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = -4.0 * inp + inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]


# --- field view -------------------------------------------------------------

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))


@gtx.field_operator
def lap_next(inp):
    return -4.0 * inp + inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])


def make_stencils(backend: str = "cuda:hopper"):
    """(the cartesian stencil, the field operator), both for ``backend``."""
    return gtscript.stencil(backend=backend, definition=lap_cartesian), lap_next.with_backend(
        backend
    )


def lap_numpy(a):
    return -4.0 * a[1:-1, 1:-1] + a[2:, 1:-1] + a[:-2, 1:-1] + a[1:-1, 2:] + a[1:-1, :-2]


def main(backend: str = "cuda:hopper", device=None, shape=(N, N, N), data=None, stencils=None):
    """Both Laplacians on ``data`` (random from seed 0 if None), each held
    against NumPy; returns (cartesian result, field-view result, NumPy's),
    the interior points, as NumPy arrays. ``stencils``: the pair of
    :func:`make_stencils` to reuse."""
    ni, nj, nk = shape
    if data is None:
        data = np.random.default_rng(0).random(shape)
    st, op = stencils or make_stencils(backend)
    expected = lap_numpy(data)
    extra = {} if device is None else {"device": device}

    # Cartesian
    inp = storage.from_array(data, backend=backend, aligned_index=(1, 1, 0), **extra)
    out = storage.zeros(shape, backend=backend, aligned_index=(1, 1, 0), **extra)
    st(inp, out, origin=(1, 1, 0), domain=(ni - 2, nj - 2, nk))
    cart = out.asnumpy()[1:-1, 1:-1]
    np.testing.assert_allclose(cart, expected)
    print(f"cartesian lap OK on {ni}x{nj}x{nk}")

    # Field view
    dev = field_device(backend, device)
    finp = gtx.as_field([IDim, JDim, KDim], data, device=dev)
    fout = gtx.zeros({IDim: (1, ni - 1), JDim: (1, nj - 1), KDim: nk}, device=dev)
    op(finp, out=fout, offset_provider={"Ioff": IDim, "Joff": JDim})
    fv = fout.asnumpy()
    np.testing.assert_allclose(fv, expected)
    print(f"field-view lap OK on {ni}x{nj}x{nk}")
    return cart, fv, expected


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda:hopper")
