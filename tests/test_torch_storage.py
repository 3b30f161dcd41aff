"""The port's storage against the JAX package's, on the CPU.

The four files of tests/storage_tests/ (test_interface.py, test_layout.py,
test_storage.py, test_interface_breadth.py), case by case, on each backend
of the port's registry. Every storage the port makes is made by the JAX
package too, from the same arguments, on its same-named backend (``numpy``,
``debug``, ``cpu:c``) or its counterpart (``torch``: ``jax``, the array
backends; ``cuda:hopper``: ``tpu:pallas``, the kernel backends), and the two
must agree exactly: shape, dtype, content, ``__gt_origin__`` and
``__gt_dims__``. Storages of ``torch`` and ``cuda:hopper`` default to the
card, so here they are asked for the CPU (``device="cpu"``); those of
``numpy``, ``debug`` and ``cpu:c`` live on the CPU by default.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu import storage as ref_storage
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.storage import layout
from gt4py_tpu_torch.storage.storage import Storage

from . import torch_stencil_defs as defs
from .cartesian_tests import stencil_defs as ref_defs

BACKENDS = ["cpu:c", "cuda:hopper", "debug", "numpy", "torch"]
#: the JAX package's backend each port backend's storage is held against
REF_TWIN = {"numpy": "numpy", "debug": "debug", "cpu:c": "cpu:c", "torch": "jax",
            "cuda:hopper": "tpu:pallas"}
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.bool_]


def _cpu(backend) -> dict:
    """``device="cpu"`` where the backend's storages default to the card."""
    return {"device": "cpu"} if layout.from_name(backend).device == "cuda" else {}


def make(fn, backend, *args, **kwargs):
    """(the port's storage, the JAX package's) from the same call."""
    mine = getattr(storage, fn)(*args, backend=backend, **kwargs, **_cpu(backend))
    theirs = getattr(ref_storage, fn)(*args, backend=REF_TWIN[backend], **kwargs)
    return mine, theirs


def same(mine, theirs):
    assert isinstance(mine, Storage)
    assert mine.device.type == "cpu"
    assert mine.shape == tuple(theirs.shape) and mine.dtype == theirs.dtype
    assert mine.__gt_origin__ == theirs.__gt_origin__
    assert mine.__gt_dims__ == theirs.__gt_dims__
    np.testing.assert_array_equal(mine.asnumpy(), theirs.asnumpy())


# --- tests/storage_tests/test_interface.py -------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_poison_fill(backend, monkeypatch):
    """GT4PY_DEBUG_POISON_EMPTY restores the uninitialized-memory signal
    (out-of-domain writes become visible as surviving NaNs)."""
    monkeypatch.setenv("GT4PY_DEBUG_POISON_EMPTY", "1")
    f, rf = make("empty", backend, (3, 3, 2))
    assert np.isnan(np.asarray(f)).all()
    same(f, rf)
    i, ri = make("empty", backend, (2, 2, 2), dtype=np.int32)
    assert (np.asarray(i) == np.iinfo(np.int32).max).all()
    same(i, ri)
    monkeypatch.setenv("GT4PY_DEBUG_POISON_EMPTY", "0")
    z, rz = make("empty", backend, (2, 2, 2))
    assert (np.asarray(z) == 0).all()
    same(z, rz)


# --- tests/storage_tests/test_layout.py ----------------------------------------------


def test_builtin_backends_registered():
    for name in BACKENDS:
        assert storage.layout_from_name(name) is not None


@pytest.mark.parametrize("backend", BACKENDS)
def test_layout_is_k_leading(backend):
    """Every backend of the port allocates K-leading, as the JAX package's
    tpu:pallas does: physical order K, I, J."""
    info = storage.layout_from_name(backend)
    assert info.physical_order() == ref_storage.layout_from_name("tpu:pallas").physical_order()
    assert info.physical_order() == (2, 0, 1)
    assert storage.zeros((3, 4, 5), backend=backend, **_cpu(backend)).array.stride() == (4, 1, 12)


def test_register_custom(monkeypatch):
    monkeypatch.setattr(layout, "REGISTRY", dict(layout.REGISTRY))
    storage.register_layout(
        "custom", storage.LayoutInfo(alignment=32, device="cpu", layout_map=(2, 1, 0))
    )
    assert storage.layout_from_name("custom").alignment == 32
    assert storage.layout_from_name("custom").device == "cpu"
    assert storage.zeros((2, 3), backend="custom").device.type == "cpu"


# --- tests/storage_tests/test_storage.py ---------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_zeros_ones_full_empty(backend):
    z, rz = make("zeros", backend, (3, 4, 5))
    assert z.shape == (3, 4, 5) and z.dtype == np.float64
    same(z, rz)
    o, ro = make("ones", backend, (2, 2, 2), np.float32)
    assert o.dtype == np.float32
    same(o, ro)
    f, rf = make("full", backend, (2, 2), 7.5)
    np.testing.assert_array_equal(np.asarray(f), 7.5)
    same(f, rf)
    e, re_ = make("empty", backend, (2, 3))
    assert e.shape == (2, 3)
    same(e, re_)


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_array_and_roundtrip(backend):
    data = np.arange(24.0).reshape(2, 3, 4)
    s, rs = make("from_array", backend, data, aligned_index=(1, 1, 0))
    np.testing.assert_array_equal(s.asnumpy(), data)
    assert s.__gt_origin__ == (1, 1, 0)
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_aligned_index_validation(backend):
    for kwargs in ({"aligned_index": (1, 2, 3)}, {"aligned_index": (-1, 0)}):
        with pytest.raises(ValueError):
            storage.zeros((3, 3), backend=backend, **kwargs, **_cpu(backend))
        with pytest.raises(ValueError):
            ref_storage.zeros((3, 3), backend=REF_TWIN[backend], **kwargs)
    with pytest.raises(ValueError):
        storage.zeros((3, 3), backend="not-a-backend")


@pytest.mark.parametrize("backend", BACKENDS)
def test_setitem_getitem(backend):
    s, rs = make("zeros", backend, (4, 4))
    s[1, 2] = 5.0
    rs[1, 2] = 5.0
    assert s[1, 2] == 5.0
    assert np.asarray(s)[0, 0] == 0.0
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_default_origin_used_by_stencil(backend):
    st = gtscript.stencil(backend=backend, definition=defs.horizontal_diffusion)
    ref = ref_gtscript.stencil(backend=REF_TWIN[backend], definition=ref_defs.horizontal_diffusion)
    n = 12
    rng = np.random.default_rng(0)
    host = {"in_field": rng.random((n, n, 3)), "coeff": rng.random((n, n, 3))}
    out = {}
    for tag, pkg, be, stencil in (("mine", storage, backend, st),
                                  ("theirs", ref_storage, REF_TWIN[backend], ref)):
        extra = _cpu(backend) if tag == "mine" else {}
        in_f = pkg.from_array(host["in_field"], backend=be, aligned_index=(2, 2, 0), **extra)
        coeff = pkg.from_array(host["coeff"], backend=be, aligned_index=(2, 2, 0), **extra)
        out[tag] = pkg.zeros((n, n, 3), backend=be, aligned_index=(2, 2, 0), **extra)
        # No origin/domain passed: origin from aligned_index, max domain derived.
        stencil(in_f, out[tag], coeff)
    expected = defs.validate_horizontal_diffusion(host["in_field"], host["coeff"])
    np.testing.assert_allclose(out["mine"].asnumpy()[2:-2, 2:-2], expected, rtol=1e-12)
    rtol = 0 if REF_TWIN[backend] == backend else 1e-12  # torch against jax: rounding
    np.testing.assert_allclose(out["mine"].asnumpy(), out["theirs"].asnumpy(), rtol=rtol, atol=0)


# --- tests/storage_tests/test_interface_breadth.py -----------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_matrix_zeros(backend, dtype):
    s, rs = make("zeros", backend, (3, 4, 2), dtype)
    assert s.dtype == np.dtype(dtype)
    assert s.shape == (3, 4, 2)
    np.testing.assert_array_equal(s.asnumpy(), np.zeros((3, 4, 2), dtype))
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_full_respects_dtype(backend, dtype):
    s, rs = make("full", backend, (2, 2, 2), 3, dtype)
    assert s.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(s.asnumpy(), np.full((2, 2, 2), 3, dtype))
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_array_casts_when_dtype_given(backend):
    data = np.arange(6, dtype=np.int32).reshape(2, 3)
    s, rs = make("from_array", backend, data, np.float64)
    assert s.dtype == np.dtype(np.float64)
    np.testing.assert_array_equal(s.asnumpy(), data.astype(np.float64))
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_array_preserves_dtype_by_default(backend):
    s, rs = make("from_array", backend, np.arange(6, dtype=np.float32).reshape(2, 3))
    assert s.dtype == np.dtype(np.float32)
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dimensions_annotation_exported(backend):
    s, rs = make("zeros", backend, (4, 4), dimensions=("I", "J"))
    assert s.__gt_dims__ == ("I", "J")
    same(s, rs)
    s3, rs3 = make("zeros", backend, (4, 4, 4))
    assert s3.__gt_dims__ is None or len(s3.__gt_dims__) == 3
    same(s3, rs3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dimensions_length_validated(backend):
    with pytest.raises(ValueError, match="dimensions"):
        storage.zeros((4, 4), dimensions=("I", "J", "K"), backend=backend, **_cpu(backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_default_aligned_index_is_zero_origin(backend):
    s, rs = make("zeros", backend, (4, 4, 4))
    assert s.__gt_origin__ == (0, 0, 0)
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_copy_is_independent(backend):
    s, _ = make("from_array", backend, np.arange(4.0))
    c = s.copy()
    assert isinstance(c, Storage)
    s[0] = 99.0
    assert c[0] == 0.0
    assert s[0] == 99.0
    assert c.array.stride() == s.array.stride()


@pytest.mark.parametrize("backend", BACKENDS)
def test_array_protocol_and_astype(backend):
    s, rs = make("from_array", backend, np.arange(4.0))
    as32 = np.asarray(s, dtype=np.float32)
    assert as32.dtype == np.dtype(np.float32)
    np.testing.assert_array_equal(as32, np.asarray(rs, dtype=np.float32))
    np.testing.assert_array_equal(np.array(s), np.arange(4.0))
    assert len(s) == len(rs) == 4
    assert s.size == rs.size == 4 and s.ndim == rs.ndim == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_setitem_slices(backend):
    s, rs = make("zeros", backend, (4, 4))
    s[1:3, 1:3] = 2.5
    rs[1:3, 1:3] = 2.5
    expected = np.zeros((4, 4))
    expected[1:3, 1:3] = 2.5
    np.testing.assert_array_equal(s.asnumpy(), expected)
    same(s, rs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_equality_is_elementwise(backend):
    a, ra = make("from_array", backend, np.arange(3.0))
    b, rb = make("from_array", backend, np.array([0.0, 5.0, 2.0]))
    assert isinstance(a == b, torch.Tensor)
    np.testing.assert_array_equal(np.asarray(a == b), np.asarray(ra == rb))
    np.testing.assert_array_equal(np.asarray(a != b), np.asarray(ra != rb))
    assert np.all(np.asarray(a == np.arange(3.0)))


def _lap2d_defn(pkg):
    """The masked-dimension stencil of test_interface_breadth.py, in the
    package whose ``gtscript`` is ``pkg``."""
    field_3d = pkg.Field[np.float64]
    field_ij = pkg.Field[pkg.IJ, np.float64]

    def s(src: field_3d, weight: field_ij, dst: field_3d):
        with pkg.computation("PARALLEL"), pkg.interval(...):
            dst = weight * (
                src[1, 0, 0] + src[-1, 0, 0] + src[0, 1, 0] + src[0, -1, 0]
            )

    return s


@pytest.mark.parametrize("backend", BACKENDS)
def test_masked_dim_storage_in_stencil(backend):
    n = 8
    rng = np.random.default_rng(3)
    src_np = rng.random((n, n, 2))
    w_np = rng.random((n, n))
    dst = {}
    for tag, pkg, gts, be, definition in (
        ("mine", storage, gtscript, backend, _lap2d_defn(gtscript)),
        ("theirs", ref_storage, ref_gtscript, REF_TWIN[backend], _lap2d_defn(ref_gtscript)),
    ):
        extra = _cpu(backend) if tag == "mine" else {}
        st = gts.stencil(backend=be, definition=definition)
        src = pkg.from_array(src_np, backend=be, aligned_index=(1, 1, 0), **extra)
        w = pkg.from_array(w_np, backend=be, aligned_index=(1, 1), **extra)
        dst[tag] = pkg.zeros((n, n, 2), backend=be, aligned_index=(1, 1, 0), **extra)
        st(src, w, dst[tag], domain=(n - 2, n - 2, 2))
    expected = w_np[1:-1, 1:-1, None] * (
        src_np[2:, 1:-1] + src_np[:-2, 1:-1] + src_np[1:-1, 2:] + src_np[1:-1, :-2]
    )
    np.testing.assert_allclose(dst["mine"].asnumpy()[1:-1, 1:-1], expected, rtol=1e-12)
    np.testing.assert_allclose(dst["mine"].asnumpy(), dst["theirs"].asnumpy(), rtol=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_respects_storage_dtype(backend, dtype):
    field = gtscript.Field[dtype]

    def s(a: field, b: field):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            b = a + a

    st = gtscript.stencil(backend=backend, definition=s, name=f"dbl_{np.dtype(dtype).name}")
    a = storage.ones((3, 3, 3), dtype, backend=backend, **_cpu(backend))
    b = storage.zeros((3, 3, 3), dtype, backend=backend, **_cpu(backend))
    st(a, b)
    assert b.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(b.asnumpy(), 2 * np.ones((3, 3, 3), dtype))


@pytest.mark.parametrize("backend", BACKENDS)
def test_numpy_ndarray_accepted_by_stencils(backend):
    """Stencils accept raw ndarrays (storage objects optional), written in
    place."""
    st = gtscript.stencil(backend=backend, definition=defs.copy_stencil)
    a = np.arange(27.0).reshape(3, 3, 3)
    b = np.zeros((3, 3, 3))
    st(a, b)
    np.testing.assert_array_equal(b, a)


# --- .array reassignment (the JAX package's setter, gt4py_tpu/storage/storage.py) -----


def _reassign_and_copy(pkg, gts, backend, definition, device=None):
    """Assign an ndarray of the storage's shape, then one of a new shape,
    to ``.array``, running a copy stencil after each; returns what each
    step left in the written storage: (values, shape, dtype, device)."""
    extra = {} if device is None else {"device": device}
    st = gts.stencil(backend=backend, definition=definition)
    a = pkg.zeros((4, 4, 2), np.float64, backend=backend, **extra)
    b = pkg.zeros((4, 4, 2), np.float64, backend=backend, **extra)
    seen = []
    a.array = np.full((4, 4, 2), 2.0)
    st(a, b)
    seen.append((np.asarray(b).copy(), b.shape, b.dtype, getattr(b, "device", None)))
    a.array = np.arange(30.0).reshape(5, 3, 2)
    b.array = np.zeros((5, 3, 2))
    st(a, b)
    seen.append((np.asarray(b).copy(), b.shape, b.dtype, getattr(b, "device", None)))
    return seen, a, b


@pytest.mark.parametrize("backend", BACKENDS)
def test_array_setter_then_stencil_call(backend):
    """``.array = ndarray`` keeps a CPU storage on the CPU, copies in place
    where shape and dtype match (the pointer a prepared launch holds stays)
    and allocates a new K-leading tensor where they do not; a copy stencil
    then reads and writes the new values, as on the JAX package's
    ``numpy`` backend (equal to the bit). ``cuda:hopper`` on CPU tensors
    runs its kernels' plain version."""
    mine, a, b = _reassign_and_copy(storage, gtscript, backend, defs.copy_stencil, "cpu")
    theirs, _, _ = _reassign_and_copy(ref_storage, ref_gtscript, "numpy", ref_defs.copy_stencil)
    for (got, shape, dtype, device), (want, rshape, rdtype, _) in zip(mine, theirs):
        np.testing.assert_array_equal(got, want)
        assert shape == rshape and dtype == rdtype == np.dtype(np.float64)
        assert device.type == "cpu"
    np.testing.assert_array_equal(mine[0][0], np.full((4, 4, 2), 2.0))
    np.testing.assert_array_equal(mine[1][0], np.arange(30.0).reshape(5, 3, 2))
    for s in (a, b):  # the new tensor is laid out as an allocation is: K-leading
        assert s.array.stride() == (3, 1, 15)


@pytest.mark.parametrize("backend", BACKENDS)
def test_array_setter_copies_in_place(backend):
    """Same shape and dtype: the held tensor is written, not replaced;
    a tensor, a Storage or a nested list is taken as an ndarray is."""
    a = storage.zeros((3, 4, 2), np.float64, backend=backend, **_cpu(backend))
    held = a.array
    for value in (np.full((3, 4, 2), 1.5), torch.full((3, 4, 2), 2.5, dtype=torch.float64),
                  storage.full((3, 4, 2), 3.5, backend="numpy"),
                  np.full((3, 4, 2), 4.5).tolist()):
        a.array = value
        assert a.array is held
        np.testing.assert_array_equal(a.asnumpy(), np.asarray(value, dtype=np.float64))


def test_array_setter_new_dtype_follows_the_value():
    """A value of another dtype replaces the tensor, as the JAX package's
    setter updates the storage's dtype."""
    a = storage.zeros((2, 3, 4), np.float64, backend="numpy")
    ref = ref_storage.zeros((2, 3, 4), np.float64, backend="numpy")
    for s in (a, ref):
        s.array = np.ones((2, 3, 4), np.float32)
    assert a.dtype == np.dtype(ref.dtype) == np.dtype(np.float32)
    assert a.array.stride() == (3, 1, 6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_non_tensor_argument_is_named(backend):
    """A call whose field is a storage holding something other than a
    tensor names the argument and its type (every backend)."""
    st = gtscript.stencil(backend=backend, definition=defs.copy_stencil)
    a = storage.ones((3, 3, 2), backend=backend, **_cpu(backend))
    b = storage.zeros((3, 3, 2), backend=backend, **_cpu(backend))
    a._array = np.ones((3, 3, 2))  # what a plain slot let an assignment leave
    with pytest.raises(TypeError, match="'field_a' is a numpy.ndarray, not a torch.Tensor"):
        st(a, b)
