"""bfloat16 in the port against the JAX package, on the CPU.

The JAX package stores bfloat16 with ``ml_dtypes`` and computes it in
float32 on its kernels; the port has no ``ml_dtypes`` and takes
``torch.bfloat16`` with a dtype token of its own (core/definitions.py). Both
sides get the same bits: float32 NumPy inputs become ``ml_dtypes.bfloat16``
for the JAX package and ``torch.bfloat16`` for the port, both rounded to
nearest even. The port's ``torch`` and ``cuda:hopper`` backends (CPU
tensors: the plain version, rounding every operation to bfloat16 as the JAX
package's ``numpy`` backend does) are held against the JAX package's
``numpy`` and ``jax`` backends at the tolerances of
tests/cartesian_tests/test_upcasting_matrix.py: 0.02 for one PARALLEL
application, 0.05 for carries and transcendentals.

Also here: the promotion table against ``jnp.promote_types`` (in the test
only: the port cannot import JAX), bfloat16 hdiff against the JAX ``numpy``
backend, and what the generated CUDA source does with bfloat16 fields.
"""

import re

import numpy as np
import pytest
import torch

from gt4py_tpu import storage as ref_storage
from gt4py_tpu.cartesian import gtscript as ref_gtscript
from gt4py_tpu.core.definitions import bfloat16 as ref_bfloat16
from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend, cuda_codegen
from gt4py_tpu_torch.core import definitions
from gt4py_tpu_torch.core.definitions import bfloat16, dtype_name, upcast
from gt4py_tpu_torch.core.ndarray_utils import asnumpy, numpy_dtype, torch_dtype

from . import torch_stencil_defs as defs

PORT_BACKENDS = ["torch", "cuda:hopper"]
REF_BACKENDS = ["numpy", "jax"]

#: each package's frontend takes its own ``computation`` and math: the port's
#: definitions name them through ``gs``, the JAX twins through ``rs``
gs, rs = gtscript, ref_gtscript
BF = gtscript.Field[torch.bfloat16]
F16 = gtscript.Field[np.float16]
F32 = gtscript.Field[np.float32]
F64 = gtscript.Field[np.float64]
RBF = ref_gtscript.Field[ref_bfloat16]
RF16 = ref_gtscript.Field[np.float16]
RF32 = ref_gtscript.Field[np.float32]
RF64 = ref_gtscript.Field[np.float64]


def _times_f32(a: BF, b: F32, out: F32):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = a * b


def _ref_times_f32(a: RBF, b: RF32, out: RF32):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out = a * b


def _literal(a: BF, out: BF):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = a * 2.0 + 0.5


def _ref_literal(a: RBF, out: RBF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out = a * 2.0 + 0.5


def _int_literal(a: BF, out: BF):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = a + 1


def _ref_int_literal(a: RBF, out: RBF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out = a + 1


def _carry(a: BF, out: BF):
    with gs.computation(gs.FORWARD):
        with gs.interval(0, 1):
            out = a
        with gs.interval(1, None):
            out = out[0, 0, -1] + a


def _ref_carry(a: RBF, out: RBF):
    with rs.computation(rs.FORWARD):
        with rs.interval(0, 1):
            out = a
        with rs.interval(1, None):
            out = out[0, 0, -1] + a


def _transcendentals(a: BF, out: BF):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = gs.sqrt(a) + gs.exp(a)


def _ref_transcendentals(a: RBF, out: RBF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out = rs.sqrt(a) + rs.exp(a)


def _f16_mix(a: BF, b: F16, out: F32):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = a + b


def _ref_f16_mix(a: RBF, b: RF16, out: RF32):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        out = a + b


def _comparison(a: BF, b: F64, out: F64):
    with gs.computation(gs.PARALLEL), gs.interval(...):
        if a < b:
            out = 1.0
        else:
            out = 0.0


def _ref_comparison(a: RBF, b: RF64, out: RF64):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        if a < b:
            out = 1.0
        else:
            out = 0.0


def _uniform(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


#: the seven bfloat16 cases of test_upcasting_matrix.py: name -> (port
#: definition, JAX twin, float32 inputs by field (a field typed bfloat16
#: gets them rounded), rtol, atol)
CASES = {
    "bf16_times_f32": (_times_f32, _ref_times_f32,
                       {"a": _uniform((4, 4, 2), 2), "b": _uniform((4, 4, 2), 12),
                        "out": np.zeros((4, 4, 2), np.float32)}, 1e-6, 0.0),
    "bf16_literal_stays_narrow": (_literal, _ref_literal,
                                  {"a": _uniform((4, 4, 2), 3),
                                   "out": np.zeros((4, 4, 2), np.float32)}, 0.02, 0.02),
    "bf16_int_literal_weakens": (_int_literal, _ref_int_literal,
                                 {"a": _uniform((4, 4, 2), 4),
                                  "out": np.zeros((4, 4, 2), np.float32)}, 0.01, 0.0),
    "bf16_sequential_carry": (_carry, _ref_carry,
                              {"a": _uniform((4, 4, 6), 6),
                               "out": np.zeros((4, 4, 6), np.float32)}, 0.05, 0.3),
    "bf16_transcendentals": (_transcendentals, _ref_transcendentals,
                             {"a": _uniform((4, 4, 2), 7),
                              "out": np.zeros((4, 4, 2), np.float32)}, 0.05, 0.05),
    "bf16_f16_mix_promotes_to_f32": (_f16_mix, _ref_f16_mix,
                                     {"a": _uniform((4, 4, 2), 8),
                                      "b": _uniform((4, 4, 2), 18).astype(np.float16),
                                      "out": np.zeros((4, 4, 2), np.float32)}, 1e-3, 0.0),
    "half_comparison_keeps_f64_counterpart": (
        _comparison, _ref_comparison,
        {"a": np.ones((2, 2, 1), np.float32), "b": np.full((2, 2, 1), 1.0 + 1e-9),
         "out": np.zeros((2, 2, 1))}, 0.0, 0.0),
}


def _run_port(definition, backend, host):
    st = gtscript.stencil(backend=backend, definition=definition)
    fields = {
        n: storage.from_array(v, dtype=st.field_info[n].dtype, backend=backend, device="cpu")
        for n, v in host.items()
    }
    st(**fields)
    return st, {n: np.asarray(v) for n, v in fields.items()}


def _run_ref(definition, backend, host):
    st = ref_gtscript.stencil(backend=backend, definition=definition)
    fields = {
        n: ref_storage.from_array(np.asarray(v).astype(st.field_info[n].dtype), backend=backend)
        for n, v in host.items()
    }
    st(**fields)
    return {n: np.asarray(v).astype(np.float64) for n, v in fields.items()}


@pytest.mark.parametrize("ref_backend", REF_BACKENDS)
@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_case_matches_reference(case, port_backend, ref_backend):
    definition, ref_definition, host, rtol, atol = CASES[case]
    st, mine = _run_port(definition, port_backend, host)
    theirs = _run_ref(ref_definition, ref_backend, host)
    for n, want in theirs.items():
        if st.field_info[n].dtype == bfloat16:
            assert mine[n].dtype == np.float32, n  # NumPy's copy of a bfloat16 field
        np.testing.assert_allclose(mine[n], want, rtol=rtol, atol=atol, err_msg=n)
    if case == "half_comparison_keeps_f64_counterpart":
        np.testing.assert_array_equal(mine["out"], 1.0)


def test_bf16_literal_stays_narrow_in_the_gtir():
    """Float literals weaken to bfloat16: the whole expression stays 16-bit,
    as in the JAX package (checked on the analyzed IR)."""
    from gt4py_tpu_torch import eve

    st = gtscript.stencil(backend="torch", definition=_literal)
    dts = {
        dtype_name(n.dtype)
        for _, _, stmt in st._analyzed.stencil.walk_stmts()
        for n in eve.walk_values(stmt)
        if hasattr(n, "dtype") and n.dtype is not None
    }
    assert dts == {"bfloat16"}, dts
    assert ":bf16" in st.pretty_ir()


# --- the dtype model ----------------------------------------------------------------

PROMOTE_WITH = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
                np.uint32, np.uint64, np.float16, "bfloat16", np.float32, np.float64]


@pytest.mark.parametrize("other", PROMOTE_WITH, ids=str)
def test_bf16_promotion_follows_jax(other):
    """bfloat16 × each dtype, both ways round, against JAX's lattice."""
    import jax.numpy as jnp

    mine_other = bfloat16 if other == "bfloat16" else np.dtype(other)
    ref_other = ref_bfloat16 if other == "bfloat16" else other
    want = dtype_name(np.dtype(jnp.promote_types(ref_bfloat16, ref_other)))
    assert dtype_name(upcast(bfloat16, mine_other)) == want
    assert dtype_name(upcast(mine_other, bfloat16)) == want


def test_bf16_token_is_its_own_dtype():
    assert bfloat16 != np.dtype("V2") and bfloat16 != np.uint16
    assert bfloat16.itemsize == 2 and definitions.is_float_dtype(bfloat16)
    assert bfloat16 in definitions.HALF_FLOAT_DTYPES
    for spelling in ("bfloat16", "bf16", bfloat16, torch.bfloat16):
        assert numpy_dtype(spelling) == bfloat16
        assert torch_dtype(spelling) == torch.bfloat16
    assert numpy_dtype(torch.bfloat16) == bfloat16
    assert definitions.DType("bf16").name == "bfloat16"


def test_bf16_storage_rounds_to_nearest_even_and_reads_back_as_float32():
    src = _uniform((5, 4, 3), 21)
    st = storage.from_array(src, dtype="bfloat16", backend="torch", device="cpu")
    assert st.dtype == bfloat16 and st.array.dtype == torch.bfloat16
    want = src.astype(ref_bfloat16).astype(np.float32)  # ml_dtypes: nearest even
    np.testing.assert_array_equal(np.asarray(st), want)
    np.testing.assert_array_equal(asnumpy(st.array), want)
    assert storage.zeros((2, 2, 2), torch.bfloat16, device="cpu").array.dtype == torch.bfloat16


def test_bf16_poison_fill_is_nan(monkeypatch):
    monkeypatch.setenv("GT4PY_DEBUG_POISON_EMPTY", "1")
    st = storage.empty((2, 2, 2), "bfloat16", backend="torch", device="cpu")
    assert bool(torch.isnan(st.array).all())


# --- hdiff in bfloat16 ----------------------------------------------------------------


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_bf16_hdiff_matches_numpy_backend(port_backend):
    """hdiff at 16×16×8 (halo 2), one application, against the JAX numpy
    backend on the same bits, at the PARALLEL tolerance 0.02."""
    shape, origin, domain = (20, 20, 8), (2, 2, 0), (16, 16, 8)
    host = {"in_field": _uniform(shape, 31), "out_field": np.zeros(shape, np.float32),
            "coeff": 0.1 * _uniform(shape, 32)}
    port = gtscript.stencil(backend=port_backend, definition=defs.horizontal_diffusion_generic,
                            dtypes={"dt": torch.bfloat16})
    ref = ref_gtscript.stencil(backend="numpy", definition=_ref_hdiff)
    mine = {n: storage.from_array(v, dtype="bfloat16", backend=port_backend, device="cpu")
            for n, v in host.items()}
    theirs = {n: ref_storage.from_array(v.astype(ref_bfloat16), backend="numpy")
              for n, v in host.items()}
    port(**mine, origin=origin, domain=domain)
    ref(**theirs, origin=origin, domain=domain)
    got = np.asarray(mine["out_field"])
    want = np.asarray(theirs["out_field"]).astype(np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)


def _ref_hdiff(in_field: RBF, out_field: RBF, coeff: RBF):
    with rs.computation(rs.PARALLEL), rs.interval(...):
        lap = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap[1, 0, 0] - lap[0, 0, 0]
        flx = 0.0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap[0, 1, 0] - lap[0, 0, 0]
        fly = 0.0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
        )


# --- the generated source ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(defs.HALF_STENCILS))
def test_bf16_sources_load_and_store_with_intrinsics(name, monkeypatch):
    """One bfloat16 stencil on each kernel: elements are loaded with
    ``__bfloat162float`` (through ``__ushort_as_bfloat16`` where an
    intrinsic loads the 16 bits) and stored with ``__float2bfloat16_rn``;
    no bfloat16 field is ringed (``cp.async`` has no 2-byte copy) but by
    plane's register patches, in vectors of 2 elements."""
    definition, kernel, fuse = defs.HALF_STENCILS[name]
    monkeypatch.setenv("GT4PY_CUDA_FUSE_STAGES", "1" if fuse else "0")
    backend = gtscript.stencil(backend="cuda:hopper", definition=definition,
                               dtypes={"dt": torch.bfloat16})._backend
    assert backend.strategy == kernel, backend.unsupported
    source = backend.module.source
    assert "#include <cuda_bf16.h>" in source
    assert "__bfloat162float(" in source and "__float2bfloat16_rn(" in source
    assert "__half" not in source
    assert any(m.dtype == bfloat16 for m in backend.module.slots)
    # its float32 twin rings its inputs; in bfloat16 only plane's
    # register patches ring a field, with whole vectors of 2 elements
    twin = gtscript.stencil(backend="cuda:hopper", definition=definition,
                            dtypes={"dt": np.float32})._backend
    assert twin.module.ring_bytes
    patched = {"gt_plane_0_r"} if kernel == "plane" else set()
    assert set(backend.module.ring_bytes) == patched
    copies = set(re.findall(r"gt_cp_async(\d+)\(", source.split("struct GtParams")[1]))
    assert copies == ({"4"} if patched else set())


def test_bf16_temporaries_and_literals_are_float():
    backend = gtscript.stencil(backend="cuda:hopper", definition=_literal)._backend
    gen = cuda_codegen._Generator(backend.analyzed)
    gen.generate()
    assert cuda_codegen._ctype(bfloat16) == "float"
    assert cuda_codegen._stype(bfloat16) == "__nv_bfloat16"
    assert "(2.0f)" in backend.module.source and "(0.5f)" in backend.module.source


def test_build_refuses_bf16_arithmetic():
    flags = cuda_backend.NVCC_FLAGS
    assert "-D__CUDA_NO_BFLOAT16_OPERATORS__" in flags
    assert "-D__CUDA_NO_BFLOAT16_CONVERSIONS__" in flags
    assert "-D__CUDA_NO_HALF_OPERATORS__" in flags


def _scaled(a: BF, out: BF, w: "dt"):  # noqa: F821
    with gs.computation(gs.PARALLEL), gs.interval(...):
        out = a * w


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_bf16_scalar_parameter_takes_a_float(port_backend):
    """A bfloat16 parameter takes a float, rounded to bfloat16 (NumPy has no
    bfloat16 scalar); anything else is refused as for other dtypes."""
    st = gtscript.stencil(backend=port_backend, definition=_scaled, dtypes={"dt": "bfloat16"})
    a = storage.from_array(_uniform((4, 4, 2), 41), dtype="bfloat16", backend=port_backend,
                           device="cpu")
    out = storage.zeros((4, 4, 2), "bfloat16", backend=port_backend, device="cpu")
    st(a, out, w=0.1)
    w = np.float32(torch.tensor(0.1).to(torch.bfloat16).item())  # 0.10009765625
    want = torch.from_numpy(np.asarray(a) * w).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.asarray(out), want)
    with pytest.raises(TypeError, match="bfloat16"):
        st(a, out, w=1)
