"""The calibration probes of bench.py::main in the port
(gt4py_tpu_torch/cartesian/backend/calibration.py and calibration.cu).

On the CPU each probe's plain version is held against NumPy to the bit and
against the TPU kernel, its ``pallas_call`` run in interpret mode with the
kernel body copied from bench.py (a drift test pins the copies), one
application and a chain of 3 with bench.py's carry (fewer where the values
would overflow: ``checked_chain``), every compared value finite. The CUDA
source is
checked as text (the instantiations, bfloat16 rounding after every add, no
fused multiply-add) and ``ceilings`` against bench.py's formulas worked by
hand. The tests marked ``cuda`` launch the kernels and skip without a card.

Tolerance against JAX: XLA's CPU contracts ``a + b*c`` into one fused
multiply-add where the port (and NumPy) round the product apart, so the two
differ by about one float32 ulp per contracted operation of the largest value
in play: rtol ``JAX_RTOL`` with an atol of rtol times the largest |value|
(cancellation in ``a + b*c - d`` leaves small results with larger relative
errors). The bfloat16 probe contracts nothing and equals JAX to the bit.
"""

import inspect
import os
import re
import textwrap

import numpy as np
import pytest
import torch

from gt4py_tpu_torch.cartesian.backend import cuda_backend, cuda_codegen
from gt4py_tpu_torch.cartesian.backend import calibration as cal

try:  # the card's machine has no JAX: its tests (-m cuda) need none
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.experimental import pallas as pl
except ImportError:
    jax = jnp = ml_dtypes = pl = None

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = {"probe_walk": (4, 8, 16), "plane_walk5": (4, 8, 16), "bf16_windows": (4, 10, 12)}
JAX_RTOL = {"probe_walk": 1e-5, "plane_walk5": 2e-6, "bf16_windows": 0.0}
VARIANTS = cal.variants()


# -- the TPU kernels, bodies copied from bench.py ------------------------------------


def _mk_bf16_probe(n_windows):
    def kern(a, o):
        x = a[...]
        for w in range(n_windows):
            x = x + jnp.concatenate(
                [a[:, :, w + 1 :], a[:, :, : w + 1]], axis=2
            )
        o[...] = x

    return kern


def _pw_kernel(a, b, c, d, o):
    o[...] = a[...] + b[...] * c[...] - d[...]


def _mk_probe(m_fma, n_div):
    def kern(a, b, c, d, o):
        accs = [a[...], b[...], c[...], d[...]]
        for i in range(m_fma):
            accs[i % 4] = accs[i % 4] * np.float32(1.0000001) + accs[(i + 1) % 4]
        for i in range(n_div):
            accs[i % 4] = accs[i % 4] / (accs[(i + 1) % 4] + np.float32(2.0))
        o[...] = accs[0] + accs[1] * accs[2] - accs[3]

    return kern


#: bench.py's lines (1-based, inclusive) holding each copied body
BENCH_BODIES = {
    "bf16_windows": ((1340, 1346), lambda: _mk_bf16_probe(1)),
    "plane_walk5": ((1410, 1411), lambda: _pw_kernel),
    "probe_walk": ((1485, 1491), lambda: _mk_probe(16, 4)),
}


def _jax_probe(kind, params, size):
    """The probe's ``pallas_call`` as bench.py builds it (a block of one
    plane a grid step over K), in interpret mode."""
    kern = {"probe_walk": lambda: _mk_probe(*params), "plane_walk5": lambda: _pw_kernel,
            "bf16_windows": lambda: _mk_bf16_probe(*params)}[kind]()
    spec = pl.BlockSpec((1, size[1], size[2]), lambda s: (s, 0, 0))
    dt = jnp.bfloat16 if kind == "bf16_windows" else jnp.float32
    return pl.pallas_call(
        kern, grid=(size[0],), in_specs=[spec] * cal.n_inputs(kind), out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(size, dt), interpret=True,
    )


def _numpy_probe(kind, params, inputs):
    """The probe in NumPy (bfloat16 through ml_dtypes, each add rounded)."""
    if kind == "probe_walk":
        accs = list(inputs)
        for i in range(params[0]):
            accs[i % 4] = accs[i % 4] * np.float32(1.0000001) + accs[(i + 1) % 4]
        for i in range(params[1]):
            accs[i % 4] = accs[i % 4] / (accs[(i + 1) % 4] + np.float32(2.0))
        return accs[0] + accs[1] * accs[2] - accs[3]
    if kind == "plane_walk5":
        a, b, c, d = inputs
        return a + b * c - d
    (a,) = inputs
    x = a.copy()
    for w in range(params[0]):
        x = x + np.roll(a, -(w + 1), axis=2)
    return x


def _carry(kind, state, out):
    """bench.py's ``fori_loop`` carry (:1375, :1431, :1506-1516)."""
    if kind == "probe_walk":
        return [out] + state[:3]
    return state[:-1] + [out]


def _host_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.random(SIZE[kind], dtype=np.float32) for _ in range(cal.n_inputs(kind))]
    if kind == "bf16_windows":
        arrays = [a.astype(ml_dtypes.bfloat16) for a in arrays]
    return arrays


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same_bits(got, want):
    """Equal to the bit, NaNs equal wherever both are NaN."""
    got, want = np.asarray(got), np.asarray(want)
    nan_g, nan_w = np.isnan(got.astype(np.float32)), np.isnan(want.astype(np.float32))
    ints = np.int16 if got.dtype == ml_dtypes.bfloat16 else np.int32
    return (got.shape == want.shape and np.array_equal(nan_g, nan_w)
            and np.array_equal(got[~nan_g].view(ints), want[~nan_w].view(ints)))


def _close_to_jax(kind, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rtol = JAX_RTOL[kind]
    if rtol == 0.0:
        assert _same_bits(got, want)
        return
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)], want[~finite & ~np.isnan(want)])
    scale = np.max(np.abs(want[finite]), initial=0.0)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kind", sorted(BENCH_BODIES))
def test_copied_bodies_match_bench_py(kind):
    """The kernel bodies above are bench.py's, line for line."""
    (first, last), make = BENCH_BODIES[kind]
    with open(os.path.join(REPO_ROOT, "bench.py")) as f:
        lines = f.read().splitlines()[first - 1:last]
    copied = textwrap.dedent(inspect.getsource(make())).strip().splitlines()
    assert copied == textwrap.dedent("\n".join(lines)).strip().splitlines()


@pytest.mark.parametrize("kind,params", VARIANTS, ids=lambda v: str(v))
def test_plain_version_matches_numpy_and_the_tpu_kernel(kind, params):
    """One application and a chain of ``checked_chain`` (3, or fewer where
    the values would overflow) with bench.py's carry: the port's entry point
    on CPU tensors (its plain version) and its :class:`Chain` equal NumPy to
    the bit and the interpret-mode pallas_call within ``JAX_RTOL``, every
    compared value finite."""
    host = _host_inputs(kind, seed=11)
    call = _jax_probe(kind, params, SIZE[kind])
    jax_state, np_state = list(host), list(host)
    n = cal.checked_chain(kind, params)
    port = _to_numpy(cal.apply(kind, [_to_torch(a) for a in host], params, None))
    chain = cal.Chain(kind, n, [_to_torch(a) for a in host], params)
    chained = _to_numpy(chain.run())
    for step in range(n):
        np_out = _numpy_probe(kind, params, np_state)
        jax_out = np.asarray(call(*[jnp.asarray(a) for a in jax_state]))
        assert np.isfinite(np_out.astype(np.float32)).all(), step
        if step == 0:
            assert _same_bits(port, np_out)
            _close_to_jax(kind, port, jax_out)
        np_state = _carry(kind, np_state, np_out)
        jax_state = _carry(kind, jax_state, jax_out)
    assert _same_bits(chained, np_out)
    _close_to_jax(kind, chained, jax_out)
    assert chain.launched == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("kind", ["probe_walk", "plane_walk5", "bf16_windows"])
def test_chain_plain_equals_the_chain(kind):
    params = dict(cal.variants())[kind] if kind != "probe_walk" else (16, 0)
    inputs = cal.make_inputs(kind, device="cpu", seed=2, size=SIZE[kind])
    for n in (0, 1, 2, 5, 6):
        got = cal.Chain(kind, n, inputs, params).run()
        want = cal.chain_plain(kind, n, inputs, params)
        assert _same_bits(_to_numpy(got), _to_numpy(want)), n


def test_probe_walk_ring_never_writes_what_it_reads():
    """P1's ring of 5: each launch writes the buffer the launch before it
    dropped, never one it reads, and feeds the next launch as its ``a``."""
    bufs = list(range(5))
    steps = cal.carry("probe_walk", bufs, 11)
    for (ins, out), (nxt, _) in zip(steps, steps[1:]):
        assert out not in ins and nxt == (out, *ins[:3])
    assert [out for _, out in steps[:5]] == [4, 3, 2, 1, 0]
    pw = cal.carry("plane_walk5", list("abcxy"), 3)
    assert pw == [(("a", "b", "c", "x"), "y"), (("a", "b", "c", "y"), "x"),
                  (("a", "b", "c", "x"), "y")]
    assert cal.carry("bf16_windows", list("xy"), 2) == [(("x",), "y"), (("y",), "x")]


@pytest.mark.parametrize("kind,params", VARIANTS, ids=lambda v: str(v))
def test_checked_chain_is_the_longest_that_stays_finite(kind, params):
    """The checked chain stays finite from the largest inputs below 1, where
    P1's accumulators, all positive, grow the most; where it is shorter than
    3, one application more overflows from seeded inputs in [0, 1)."""
    n = cal.checked_chain(kind, params)
    assert 1 <= n <= cal.CHECKED_CHAIN
    top = torch.tensor(np.nextafter(np.float32(1), np.float32(0))).to(cal.dtype(kind))
    inputs = [torch.full(SIZE[kind], float(top), dtype=cal.dtype(kind))
              for _ in range(cal.n_inputs(kind))]
    assert bool(torch.isfinite(cal.chain_plain(kind, n, inputs, params)).all())
    if n < cal.CHECKED_CHAIN:
        seeded = cal.make_inputs(kind, device="cpu", seed=3, size=SIZE[kind])
        assert not bool(torch.isfinite(cal.chain_plain(kind, n + 1, seeded, params)).all())


def test_library_chain_is_the_same_function():
    """``LIBRARY`` names one PyTorch call a variant equals (P3 with no window
    is a copy); its chain carries as the kernel's and gives the same bits."""
    assert list(cal.LIBRARY) == [("bf16_windows", (0,))]
    inputs = cal.make_inputs("bf16_windows", device="cpu", seed=6, size=SIZE["bf16_windows"])
    for n in (1, 2, 3):
        chain = cal.Chain("bf16_windows", n, inputs, (0,), library=True)
        want = cal.chain_plain("bf16_windows", n, inputs, (0,))
        assert _same_bits(_to_numpy(chain.run()), _to_numpy(want))
    with pytest.raises(KeyError):
        cal.Chain("plane_walk5", 2, cal.make_inputs("plane_walk5", "cpu", size=(2, 3, 4)),
                  library=True)


def test_chain_resets_to_its_inputs_and_leaves_them():
    inputs = cal.make_inputs("probe_walk", device="cpu", seed=4, size=SIZE["probe_walk"])
    before = [t.clone() for t in inputs]
    chain = cal.Chain("probe_walk", 3, inputs, (0, 0))
    first = chain.run().clone()
    again = chain.run().clone()
    chain.reset()
    assert torch.equal(chain.run(), first) and not torch.equal(again, first)
    assert all(torch.equal(a, b) for a, b in zip(inputs, before))


def test_make_inputs_are_seeded_and_sized():
    a = cal.make_inputs("probe_walk", device="cpu", seed=5)
    b = cal.make_inputs("probe_walk", device="cpu", seed=5)
    assert len(a) == 4 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (80, 256, 128) and a[0].dtype == torch.float32
    assert not torch.equal(a[0], a[1])
    assert float(a[0].min()) >= 0.0 and float(a[0].max()) < 1.0
    (w,) = cal.make_inputs("bf16_windows", device="cpu", seed=5)
    assert w.shape == (80, 260, 260) and w.dtype == torch.bfloat16
    assert cal.shape("plane_walk5") == (80, 256, 256)


def test_operations():
    pts = 80 * 256 * 128
    assert cal.operations("probe_walk", (16, 0), (80, 256, 128)) == 35 * pts
    assert cal.operations("probe_walk", (0, 4), (80, 256, 128)) == 11 * pts
    assert cal.operations("plane_walk5", (), (2, 3, 4)) == 72
    assert cal.operations("bf16_windows", (1,), (2, 3, 4)) == 24


def test_instruction_bound():
    """The least time of P1's card-own variants from their SASS counts a
    point, worked by hand: (128, 0) issues 259 FP32 instructions a point
    (two a product and sum, three for ``o``), 128 lanes an SM a clock;
    (0, 64) 64 MUFU.RCP a point, 16 lanes; each at 1980 MHz on 132 SMs;
    the bytes bound, at the rate given, where the instructions take less."""
    points, nbytes = 80 * 256 * 128, 5 * 80 * 256 * 128 * 4
    card = (1980.0, 132, 3.35e12)
    us, by = cal.instruction_bound({"fp32": 259, "mufu": 0}, points, nbytes, *card)
    assert by == "operations" and us == pytest.approx(points / 132 * 259 / 128 / 1980.0)
    assert us == pytest.approx(20.295, abs=1e-3)
    us, by = cal.instruction_bound({"fp32": 451, "mufu": 64}, points, nbytes, *card)
    assert by == "operations" and us == pytest.approx(points / 132 * 64 / 16 / 1980.0)
    us, by = cal.instruction_bound({"fp32": 3}, points, nbytes, *card)
    assert by == "bytes" and us == pytest.approx(nbytes / 3.35e12 * 1e6)
    # bytes that stay in the L2, at its rate (twice the memory's here): half the time
    l2_us, by = cal.instruction_bound({"fp32": 3}, points, nbytes, 1980.0, 132, 6.7e12)
    assert by == "bytes" and l2_us == pytest.approx(us / 2)
    assert cal.instruction_bound({}, points, 0, *card) == (0.0, "bytes")
    # half the SMs, half the clock: four times as long
    slow, _ = cal.instruction_bound({"mufu": 64}, points, 0, 990.0, 66, 3.35e12)
    assert slow == pytest.approx(4 * cal.instruction_bound({"mufu": 64}, points, 0, *card)[0])


def test_points_a_thread_match_the_source():
    """``POINTS_A_THREAD`` (what the instruction bound divides a thread's
    SASS by) is what the kernels own: P1 a float4, P3 CAL_BF16_VECTORS
    vectors of 8."""
    src = cal.source()
    vectors = int(re.search(r"#define CAL_BF16_VECTORS (\d+)", src).group(1))
    assert cal.POINTS_A_THREAD == {"probe_walk": 4, "bf16_windows": 8 * vectors}
    assert "* CAL_THREADS + threadIdx.x) * 4;" in src
    assert "cal_blocks(total, 4)" in src and "cal_blocks(total, 8 * CAL_BF16_VECTORS)" in src


# -- the CUDA source and its build ---------------------------------------------------


def test_source_instantiates_the_variants():
    src = cal.source()
    walks = re.search(r"#define CAL_PROBE_WALK_VARIANTS\(X\)(.*)", src).group(1)
    assert tuple(tuple(int(v) for v in m) for m in re.findall(r"X\((\d+), (\d+)\)", walks)) \
        == cal.PROBE_WALK_VARIANTS
    assert cal.PROBE_WALK_VARIANTS[:3] == ((0, 0), (16, 0), (0, 4))
    windows = re.search(r"#define CAL_BF16_WINDOWS_VARIANTS\(X\)(.*)", src).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", windows)) == cal.BF16_WINDOWS
    for launcher in ("gt_probe_walk", "gt_plane_walk5", "gt_bf16_windows"):
        assert f'extern "C" int {launcher}(' in src
    assert src.count('extern "C"') == 4  # the three probes and the L2 yardstick


def _kernel_body(code, name):
    """The text of the kernel ``name`` in the source, from its signature to
    the next kernel's."""
    start = code.index(f"\n{name}(")
    ends = [code.find(m, start + 1) for m in ("__global__", "static dim3", "// Element e")]
    return code[start:min(e for e in ends if e > 0)]


def test_source_rounds_and_contracts_as_the_plain_version():
    """No fused multiply-add in the source (and ``--fmad=false`` forbids the
    compiler's); the gain literal is np.float32(1.0000001); every bfloat16
    add is rounded by ``__float2bfloat16_rn``; ``plane_walk5`` keeps the
    column walk's block, P1 and P3 take 16-byte vectors of their tensors,
    P1 issuing its loads ahead of its arithmetic."""
    src = cal.source()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert not re.search(r"\b(__)?fmaf?\b|__fma_rn|__fmaf_rn", code)
    (gain,) = re.findall(r"\* ([0-9.]+)f \+", code)
    assert np.float32(gain) == np.float32(1.0000001) and float(np.float32(gain)) == cal.FMA_GAIN
    assert float(np.float32(gain)) == 1.0 + 2.0 ** -23
    adds = re.findall(r"[^\n]*\+ __bfloat162float\([^\n]*", code)
    assert adds and all("__float2bfloat16_rn(__bfloat162float(x) +" in a for a in adds)
    assert "2.0f" in code and "/ (acc[e][(s + 1) % 4] + 2.0f)" in code
    assert re.search(r"#define CAL_BJ (\d+)", src).group(1) == str(cuda_codegen.COL_BJ)
    assert re.search(r"#define CAL_BI (\d+)", src).group(1) == str(cuda_codegen.COL_BI)
    assert f"#define CAL_NOTHING_LAUNCHED ({cuda_codegen.NOTHING_LAUNCHED})" in src
    walk5, p1, p3 = (_kernel_body(code, k) for k in ("plane_walk5", "probe_walk", "bf16_windows"))
    # the walk: one thread an (i, j) point, CAL_BJ x CAL_BI blocks, the planes in a loop
    assert "__launch_bounds__(CAL_BJ * CAL_BI)" in code.split("\nplane_walk5(")[0][-60:]
    assert "k < nk" in walk5 and "blockIdx.y * CAL_BI" in walk5
    # P1: a 128-bit load of each input, then the arithmetic, a 128-bit store
    assert "ld.global.nc.v4.f32" in code and p1.count("cal_load4(") == 1
    assert "float4" in p1 and "reinterpret_cast<float4*>(o + p)" in p1
    loads, first_op = p1.index("cal_load4("), p1.index("* 1.0000001f")
    assert loads < p1.index("cal_load(") < first_op < p1.index("/ (acc[e]")
    # P3: 16-byte vectors in and out, the next lane's through a shuffle
    assert "__ldg(reinterpret_cast<const uint4*>(a + p))" in p3
    assert "reinterpret_cast<uint4*>(o + p) = out" in p3 and "__shfl_down_sync" in p3
    assert "k < nk" not in p1 + p3


def test_build_takes_the_stencil_kernels_flags(monkeypatch):
    """The source goes to ``cuda_backend.load_library`` (nvcc with
    NVCC_FLAGS: sm_90a, --fmad=false) and its four launchers (the three
    probes', the L2 yardstick's) are bound."""
    cmd = cuda_backend.build_command("p.cu", "p.so")
    assert "--fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd
    assert "-O3" in cmd and not any("fast" in c for c in cmd)
    seen = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            seen.append(name)
            return fn

    monkeypatch.setattr(cal, "_FUNCTIONS", {})
    monkeypatch.setattr(cuda_backend, "load_library",
                        lambda source: (seen.append(source), Lib())[1])
    fns = cal._functions()
    assert seen == [cal.source(), "gt_probe_walk", "gt_plane_walk5", "gt_bf16_windows",
                    "gt_l2_read"]
    assert len(fns["gt_probe_walk"].argtypes) == 11 and len(fns["gt_plane_walk5"].argtypes) == 9
    assert len(fns["gt_bf16_windows"].argtypes) == 7 and len(fns["gt_l2_read"].argtypes) == 6


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cal, "_FUNCTIONS", {})
    monkeypatch.setattr(cuda_backend, "_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(cuda_backend, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(cuda_backend.CudaBuildError):
        cal._functions()


# -- the entry points on CPU tensors --------------------------------------------------


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(cal, "_functions", no_kernel)
    counts = {k: w.launches for k, w in cal.WRAPPERS.items()}
    a, b, c, d = cal.make_inputs("probe_walk", device="cpu", seed=1, size=(2, 3, 4))
    out = torch.empty_like(a)
    assert cal.probe_walk(a, b, c, d, 16, 0, out=out) is out
    assert torch.equal(out, cal.probe_walk_plain(a, b, c, d, 16, 0))
    assert torch.equal(cal.plane_walk5(a, b, c, d), a + b * c - d)
    (w,) = cal.make_inputs("bf16_windows", device="cpu", seed=1, size=(2, 3, 4))
    assert torch.equal(cal.bf16_windows(w, 1), w + torch.roll(w, -1, dims=2))
    assert torch.equal(cal.bf16_windows(w), w)
    assert {k: w.launches for k, w in cal.WRAPPERS.items()} == counts


def test_what_the_kernels_do_not_take_raises():
    a, b, c, d = cal.make_inputs("probe_walk", device="cpu", seed=1, size=(2, 3, 4))
    (w,) = cal.make_inputs("bf16_windows", device="cpu", seed=1, size=(2, 3, 4))
    with pytest.raises(ValueError, match="not instantiated"):
        cal.probe_walk(a, b, c, d, m_fma=8)
    with pytest.raises(ValueError, match="not instantiated"):
        cal.bf16_windows(w, 2)
    with pytest.raises(ValueError, match="shape"):
        cal.plane_walk5(a, b, c, d[:, :, :2].contiguous())
    with pytest.raises(TypeError):
        cal.plane_walk5(a, b, c, d.double())
    with pytest.raises(TypeError):
        cal.bf16_windows(a)
    with pytest.raises(ValueError, match="contiguous"):
        cal.plane_walk5(a, b, c, d.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shares memory"):
        cal.plane_walk5(a, b, c, d, out=d)
    with pytest.raises(ValueError, match="out must be"):
        cal.plane_walk5(a, b, c, d, out=torch.empty(2, 3, 5))
    (narrow,) = cal.make_inputs("bf16_windows", device="cpu", seed=1, size=(2, 3, 1))
    with pytest.raises(ValueError, match="windows need"):
        cal.bf16_windows(narrow, 1)
    with pytest.raises(ValueError, match="no calibration probe"):
        cal.shape("copy")


# -- the ceilings --------------------------------------------------------------------


def test_ceilings_are_bench_py_formulas():
    """Stood-in µs at bench.py's sizes, each key worked by hand from
    bench.py:1387-1390, :1446-1458 and :1528-1566."""
    times = {"probe_walk_m0_n0": 20.0, "probe_walk_m16_n0": 24.0, "probe_walk_m0_n4": 28.0,
             "probe_walk_m128_n0": 84.0, "probe_walk_m0_n64": 148.0, "plane_walk5": 40.0,
             "bf16_windows_n0": 8.0, "bf16_windows_n1": 10.5}
    got = cal.ceilings(times, walk_us={"tridiag": 100.0, "vadv": 120.0, "hdiff_bf16": 48.0})
    pts_part, points = 256 * 128 * 80, 256 * 256 * 80
    copy_rate = 5 * 80 * 256 * 128 * 4 / 20e-6  # bytes/s through the probe
    fma = (24.0 - 20.0) * 1e-6 / 16 / pts_part  # s a point and operation
    div = (28.0 - 20.0) * 1e-6 / 4 / pts_part
    pw = 5 * 80 * 256 * 256 * 4 / 40e-6
    want = {
        "chain_copy_rate_TBps": copy_rate / 1e12,
        "chain_fma_ps_per_point": fma * 1e12,
        "chain_div_ps_per_point": div * 1e12,
        "card_fma_ps_per_point": 64e-6 / 128 / pts_part * 1e12,
        "card_div_ps_per_point": 128e-6 / 64 / pts_part * 1e12,
        "planewalk5_us_per_step": 40.0,
        "planewalk5_GBps": pw / 1e9,
        "bf16_window_cost_us": 2.5,
        "hdiff_bf16_vpu_model_us": 8.0 + 8 * 2.5,
        "hdiff_bf16_vs_vpu_model": 48.0 / 28.0,
    }
    for walk, streams, fmas, divs, t_w in (("tridiag", 5, 8, 1, 100.0), ("vadv", 6, 29, 1, 120.0)):
        nbytes = streams * points * 4
        floor_us = nbytes / pw * 1e6
        copy_floor = nbytes / copy_rate * 1e6
        compute = (fmas * fma + divs * div) * points * 1e6
        want.update({
            f"{walk}_planewalk_floor_us": floor_us,
            f"{walk}_copy_floor_us": copy_floor,
            f"{walk}_compute_model_us": compute,
            f"{walk}_chain_ceiling_us": max(copy_floor, compute),
            f"{walk}_vs_planewalk_ceiling": floor_us / t_w,
            f"{walk}_vs_chain_ceiling": max(copy_floor, compute) / t_w,
        })
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    # at these stand-ins tridiag is bound by its copies, a walk of 100 ops by its compute
    assert got["tridiag_chain_ceiling_us"] == got["tridiag_copy_floor_us"]
    heavy = cal.ceilings(times, walks={"heavy": (1000, 100, 10)})
    assert heavy["heavy_chain_ceiling_us"] == heavy["heavy_compute_model_us"]


def test_ceilings_take_the_device_copy_for_walks_beyond_the_l2():
    """A walk whose bytes exceed the L2 is held against the larger of its
    copy floors: over P1's chain copy rate (whose bytes stay in the L2 in
    part) and over the device copy's; a walk that fits keeps P1's."""
    times = {"probe_walk_m0_n0": 15.0, "probe_walk_m16_n0": 15.5, "probe_walk_m0_n4": 16.0}
    chain_rate = 5 * 80 * 256 * 128 * 4 / 15e-6
    walks = {"big": (300e6, 8, 1), "small": (10e6, 8, 1)}
    got = cal.ceilings(times, walks=walks, copy_Bps=3.0e12)
    assert chain_rate > 3.0e12
    assert got["big_copy_floor_us"] == pytest.approx(300e6 / 3.0e12 * 1e6)
    assert got["small_copy_floor_us"] == pytest.approx(10e6 / chain_rate * 1e6)
    # a device copy faster than the chain's does not lower the floor
    faster = cal.ceilings(times, walks=walks, copy_Bps=2 * chain_rate)
    assert faster["big_copy_floor_us"] == pytest.approx(300e6 / chain_rate * 1e6)
    # without the device copy, P1's alone, as bench.py
    assert cal.ceilings(times, walks=walks)["big_copy_floor_us"] == faster["big_copy_floor_us"]
    assert cal.ceilings(times, walks=walks, copy_Bps=3.0e12, l2=400e6)["big_copy_floor_us"] \
        == faster["big_copy_floor_us"]


def test_l2_read_takes_only_cuda_tensors():
    """The L2 yardstick runs only on the card (it has no plain version of
    its per-warp output) and refuses anything else."""
    with pytest.raises(ValueError, match="CUDA"):
        cal.l2_read(torch.zeros(64), torch.zeros(64))


def test_defines_are_read_from_the_source():
    assert cal.define("CAL_THREADS") == 256 and cal.define("CAL_L2_VECTORS") == 4
    with pytest.raises(KeyError):
        cal.define("CAL_NO_SUCH_DEFINE")


def test_ceilings_clip_a_negative_cost_and_skip_what_was_not_timed():
    got = cal.ceilings({"probe_walk_m0_n0": 20.0, "probe_walk_m16_n0": 19.0,
                        "probe_walk_m0_n4": 21.0})
    assert got["chain_fma_ps_per_point"] == 0.0 and got["chain_div_ps_per_point"] > 0
    assert "planewalk5_GBps" not in got and "bf16_window_cost_us" not in got
    assert "tridiag_planewalk_floor_us" not in got and "tridiag_chain_ceiling_us" in got
    assert cal.ceilings({}) == {}


def test_fit_chains():
    assert cal.fit_chains("probe_walk", (0, 4)) == cal.FIT_CHAINS == (20, 220)
    assert cal.fit_chains("probe_walk", (0, 64)) == (2, 12)
    assert cal.fit_chains("probe_walk", [0, 64]) == (2, 12)


def test_spin_ms_grows_the_spin_until_the_host_queued_in_time(monkeypatch):
    """``profiler.spin_ms``, the one spin timer of the probes' fit and of
    chip_smoke.py: where the spin ended before the host had queued the work
    (the start event already reached), the spin grows fourfold and the work
    runs again; after ``tries`` such spins it raises."""
    from gt4py_tpu_torch.instrumentation import profiler

    spins, late = [], []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):
            return late.pop(0)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 12.0

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    ran = []
    late[:] = [True, True, False]
    assert profiler.spin_ms(lambda: ran.append(1), n=4, cycles=10) == 3.0
    assert spins == [10, 40, 160] and len(ran) == 3
    late[:] = [True] * 2
    with pytest.raises(RuntimeError, match="probe: the host did not queue 4 steps"):
        profiler.spin_ms(lambda: None, n=4, name="probe", cycles=10, tries=2)


# -- on the card ---------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _card_same_bits(got, want):
    """Equal to the bit, NaN wherever the other is NaN (torch only: the
    card's machine has no ml_dtypes)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.shape == want.shape and torch.equal(nan_g, nan_w)
            and torch.equal(got[~nan_g].view(ints), want[~nan_w].view(ints)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,params", VARIANTS, ids=lambda v: str(v))
def test_kernel_equals_plain_on_card(kind, params):
    """At bench.py's sizes: one launch, counted, equal to the plain version
    on the same card to the bit; a graph chain of ``checked_chain`` equal to
    the plain version's chain, its replay counted; every value finite."""
    _need_card()
    inputs = cal.make_inputs(kind, seed=9)
    wrapper = cal.WRAPPERS[kind]
    before = wrapper.launches
    got = cal.apply(kind, inputs, params, None)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _card_same_bits(got, cal.run_plain(kind, inputs, params))
    n = cal.checked_chain(kind, params)
    chain = cal.Chain(kind, n, inputs, params)
    assert chain.graph is not None and chain.launched == 1
    out = chain.run()
    torch.cuda.synchronize()
    assert chain.launched == 1 + n and wrapper.launches == before + 2 + n
    assert bool(torch.isfinite(out).all())
    assert _card_same_bits(out, cal.chain_plain(kind, n, inputs, params))


@pytest.mark.cuda
def test_fit_on_card():
    _need_card()
    fit = cal.fit_us("plane_walk5", cal.make_inputs("plane_walk5", seed=1), trials=3)
    assert fit["us"] > 0 and fit["launches"] == 2 + (3 + 1) * (20 + 220)
    inputs = cal.make_inputs("bf16_windows", seed=1)
    before = cal.WRAPPERS["bf16_windows"].launches
    copy = cal.fit_us("bf16_windows", inputs, (0,), trials=3, library=True)
    assert copy["us"] > 0 and copy["launches"] == 0
    assert cal.WRAPPERS["bf16_windows"].launches == before


@pytest.mark.cuda
def test_l2_read_on_card():
    """The L2 yardstick: the warps' largest values give the buffer's
    largest, its launches are counted on its own wrapper and on no probe's,
    and its rate is positive."""
    _need_card()
    probes = {k: w.launches for k, w in cal.WRAPPERS.items()}
    before = cal.L2_READ.launches
    got = cal.l2_read_rate(trials=3)
    assert got["Bps"] > 0 and got["nbytes"] < cal.l2_bytes("cuda")
    assert cal.L2_READ.launches == before + 1 + (3 + 1) * sum(cal.FIT_CHAINS)
    assert {k: w.launches for k, w in cal.WRAPPERS.items()} == probes
    x = torch.rand(cal.l2_read_blocks("cuda") * 256 * 4 + 12, device="cuda")
    out = torch.empty(cal.l2_read_blocks("cuda") * 8, device="cuda")
    assert torch.equal(cal.l2_read(x, out, passes=2).amax(), x.amax())


#: ragged sizes of the vector kernels: (K, I, J) with a row length that is
#: not a multiple of the vector, a total with a tail, I or J of 1, rows
#: shorter than a vector, and several blocks
RAGGED = {
    "probe_walk": [(3, 5, 7), (2, 1, 13), (5, 7, 1), (1, 1, 1), (7, 37, 131)],
    "bf16_windows": [(3, 5, 13), (2, 1, 9), (4, 3, 1), (2, 3, 2), (7, 37, 261)],
}
RAGGED_CASES = [
    (kind, params, size)
    for kind, params in VARIANTS if kind in RAGGED
    for size in RAGGED[kind] if kind != "bf16_windows" or params[0] < size[2]
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,params,size", RAGGED_CASES, ids=lambda v: str(v))
def test_kernel_equals_plain_on_card_at_ragged_sizes(kind, params, size):
    """The 16-byte vector kernels at ragged sizes, where the last vector is
    partial and rows start inside a vector: one launch and a graph chain of
    ``checked_chain``, each finite and equal to the plain version to the
    bit."""
    _need_card()
    inputs = cal.make_inputs(kind, seed=10, size=size)
    got = cal.apply(kind, inputs, params, None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _card_same_bits(got, cal.run_plain(kind, inputs, params))
    n = cal.checked_chain(kind, params)
    out = cal.Chain(kind, n, inputs, params).run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _card_same_bits(out, cal.chain_plain(kind, n, inputs, params))


def _offset_view(t, by):
    """A contiguous copy of ``t`` starting ``by`` elements into a larger
    buffer: its base is not 16-byte aligned."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = buf[by:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kind,params", [v for v in VARIANTS if v[0] in RAGGED],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("moved", ["inputs", "out", "both"])
def test_kernel_takes_unaligned_views_on_card(kind, params, moved):
    """An input or output that is an offset view, its base not 16-byte
    aligned: the kernel serves it with scalar loads and stores, equal to the
    plain version to the bit."""
    _need_card()
    size = (3, 5, 13)
    inputs = cal.make_inputs(kind, seed=12, size=size)
    if moved != "out":
        inputs = tuple(_offset_view(t, 1 + q % 3) for q, t in enumerate(inputs))
    out = torch.empty(size, dtype=cal.dtype(kind), device=inputs[0].device)
    if moved != "inputs":
        out = _offset_view(out, 1)
    wrapper = cal.WRAPPERS[kind]
    before = wrapper.launches
    assert cal.apply(kind, inputs, params, out) is out
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _card_same_bits(out, cal.run_plain(kind, inputs, params))
