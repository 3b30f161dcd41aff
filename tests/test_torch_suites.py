"""The JAX package's hypothesis suites through the port's test kit.

The suites of tests/cartesian_tests/test_suites.py, test_suites_degenerate.py
and test_suites_extended.py, word for word but for their base class (the
extended file's ``TestIntegerArithmetic`` is ``TestIntegerArithmeticExtended``
here, beside the degenerate file's), built with ``gt4py_tpu_torch.testing``:
its ``StencilTestSuite`` makes one test per backend of the port's registry
(``torch``, ``cuda:hopper``, ``numpy``, ``debug`` and ``cpu:c``) and dtype,
each against the suite's NumPy validation at the kit's tolerance (rtol =
atol = 1e-5 in 32-bit types, 1e-10 in 64-bit ones). The storages live on the
CPU (``device = "cpu"``), so ``torch`` and ``cuda:hopper`` run the plain
version.
"""

import numpy as np

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.testing import StencilTestSuite, field, parameter


class _CPUSuite(StencilTestSuite):
    __abstract__ = True
    device = "cpu"


# --- tests/cartesian_tests/test_suites.py ----------------------------------------------
class TestCopy(_CPUSuite):
    dtypes = [np.float64, np.float32]
    domain_range = [(1, 12), (1, 12), (1, 8)]
    symbols = dict(field_a=field(in_range=(-10, 10)), field_b=field(in_range=(-10, 10)))
    max_examples = 3

    def definition(field_a, field_b):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            field_b = field_a[0, 0, 0]

    def validation(field_a, field_b, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        field_b[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = field_a[
            i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk
        ]


class TestShiftAndScale(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(2, 10), (2, 10), (1, 6)]
    symbols = dict(
        inp=field(in_range=(-5, 5), boundary=((1, 1), (1, 1), (0, 0))),
        out=field(in_range=(-5, 5)),
        factor=parameter(in_range=(-2, 2)),
    )
    max_examples = 3

    def definition(inp, out, factor: float):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = factor * (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])

    def validation(inp, out, factor, *, domain, origin):
        ni, nj, nk = domain
        # Each array carries its own halo: inp origin is (1, 1, 0), out (0, 0, 0).
        out[:ni, :nj, :nk] = factor * (
            inp[2 : 2 + ni, 1 : 1 + nj, :nk]
            + inp[0:ni, 1 : 1 + nj, :nk]
            + inp[1 : 1 + ni, 2 : 2 + nj, :nk]
            + inp[1 : 1 + ni, 0:nj, :nk]
        )


class TestForwardCumsum(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(1, 6), (1, 6), (2, 8)]
    symbols = dict(inp=field(in_range=(-3, 3)), acc=field(in_range=(0, 0)))
    max_examples = 3

    def definition(inp, acc):
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                acc = inp[0, 0, 0]
            with gtscript.interval(1, None):
                acc = acc[0, 0, -1] + inp[0, 0, 0]

    def validation(inp, acc, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        acc[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = np.cumsum(
            inp[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk], axis=2
        )

# --- tests/cartesian_tests/test_suites_degenerate.py -----------------------------------
class TestDegenerateCopy(_CPUSuite):
    """Domains down to a single grid point, all dtype kinds."""

    dtypes = [np.float64, np.float32, np.int64, np.int32]
    domain_range = [(1, 3), (1, 3), (1, 2)]
    symbols = dict(src=field(in_range=(-7, 7)), dst=field(in_range=(-7, 7)))
    max_examples = 8

    def definition(src, dst):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            dst = src[0, 0, 0] + src[0, 0, 0]

    def validation(src, dst, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        dst[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = (
            2 * src[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk]
        )


class TestSingleLevelSequential(_CPUSuite):
    """FORWARD loop over a possibly single-level K axis: only the first
    interval section runs when nk == 1."""

    dtypes = [np.float64, np.float32]
    domain_range = [(1, 4), (1, 4), (1, 5)]
    symbols = dict(inp=field(in_range=(-4, 4)), out=field(in_range=(-4, 4)))
    max_examples = 8

    def definition(inp, out):
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                out = inp
            with gtscript.interval(1, None):
                out = out[0, 0, -1] + inp

    def validation(inp, out, *, domain, origin):
        ni, nj, nk = domain
        out[:ni, :nj, :nk] = np.cumsum(inp[:ni, :nj, :nk], axis=2)


class TestDegenerateHaloStencil(_CPUSuite):
    """Offset reads with a 1-wide compute domain inside a halo."""

    dtypes = [np.float64]
    domain_range = [(1, 2), (1, 2), (1, 3)]
    symbols = dict(
        inp=field(in_range=(-3, 3), boundary=((1, 1), (1, 1), (0, 0))),
        out=field(in_range=(-3, 3)),
    )
    max_examples = 8

    def definition(inp, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = inp[1, 0, 0] - inp[-1, 0, 0] + inp[0, 1, 0] - inp[0, -1, 0]

    def validation(inp, out, *, domain, origin):
        ni, nj, nk = domain
        out[:ni, :nj, :nk] = (
            inp[2 : 2 + ni, 1 : 1 + nj, :nk]
            - inp[0:ni, 1 : 1 + nj, :nk]
            + inp[1 : 1 + ni, 2 : 2 + nj, :nk]
            - inp[1 : 1 + ni, 0:nj, :nk]
        )


class TestIntegerArithmetic(_CPUSuite):
    """Pure integer pipelines (mod/min/max) — no float contamination."""

    dtypes = [np.int64, np.int32]
    domain_range = [(1, 5), (1, 5), (1, 4)]
    symbols = dict(
        a=field(in_range=(1, 20)),
        b=field(in_range=(1, 9)),
        out=field(in_range=(0, 1)),
    )
    max_examples = 8

    def definition(a, b, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = (a % b) + min(a, b)

    def validation(a, b, out, *, domain, origin):
        ni, nj, nk = domain
        s = (slice(0, ni), slice(0, nj), slice(0, nk))
        out[s] = np.mod(a[s], b[s]) + np.minimum(a[s], b[s])


class TestScalarConditionDegenerate(_CPUSuite):
    """Runtime-scalar branch over a degenerate domain."""

    dtypes = [np.float64]
    domain_range = [(1, 2), (1, 2), (1, 2)]
    symbols = dict(
        inp=field(in_range=(-2, 2)),
        out=field(in_range=(-2, 2)),
        gate=parameter(in_range=(-1, 1)),
    )
    max_examples = 8

    def definition(inp, out, gate: float):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            if gate > 0.0:
                out = inp * 2.0
            else:
                out = inp * -1.0

    def validation(inp, out, gate, *, domain, origin):
        ni, nj, nk = domain
        s = (slice(0, ni), slice(0, nj), slice(0, nk))
        out[s] = inp[s] * 2.0 if gate > 0.0 else inp[s] * -1.0


class TestBackwardSingleSection(_CPUSuite):
    """BACKWARD with a single full-extent section at any nk >= 1."""

    dtypes = [np.float64, np.float32]
    domain_range = [(1, 3), (1, 3), (1, 6)]
    symbols = dict(inp=field(in_range=(-3, 3)), out=field(in_range=(-3, 3)))
    max_examples = 8

    def definition(inp, out):
        with gtscript.computation("BACKWARD"):
            with gtscript.interval(-1, None):
                out = inp
            with gtscript.interval(0, -1):
                out = 0.5 * out[0, 0, 1] + inp

    def validation(inp, out, *, domain, origin):
        ni, nj, nk = domain
        out[:ni, :nj, nk - 1] = inp[:ni, :nj, nk - 1]
        for k in range(nk - 2, -1, -1):
            out[:ni, :nj, k] = 0.5 * out[:ni, :nj, k + 1] + inp[:ni, :nj, k]


class TestVariableKOffsetGrind(_CPUSuite):
    """Variable K gathers under hypothesis shapes (clamped at the K edges
    — the kernel/evaluator/debug clamp contract)."""

    dtypes = [np.float64, np.float32]
    domain_range = [(1, 4), (1, 4), (2, 6)]
    symbols = dict(
        src=field(in_range=(-4, 4)),
        kidx=field(in_range=(-1, 1), dtype=np.int64),
        out=field(in_range=(-4, 4)),
    )
    max_examples = 8

    def definition(src, kidx, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = src[0, 0, kidx]

    def validation(src, kidx, out, *, domain, origin):
        ni, nj, nk = domain
        kk = np.clip(
            np.arange(nk)[None, None, :] + kidx[:ni, :nj, :nk].astype(np.int64),
            0, src.shape[2] - 1,
        )
        out[:ni, :nj, :nk] = np.take_along_axis(src, kk, axis=2)[:ni, :nj]


class TestMaskedSequentialGrind(_CPUSuite):
    """Field-conditional writes inside a FORWARD carry chain."""

    dtypes = [np.float64]
    domain_range = [(1, 4), (1, 4), (2, 6)]
    symbols = dict(
        gate=field(in_range=(-1, 1)),
        inp=field(in_range=(-2, 2)),
        out=field(in_range=(-2, 2)),
    )
    max_examples = 8

    def definition(gate, inp, out):
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                out = inp
            with gtscript.interval(1, None):
                if gate > 0.0:
                    out = out[0, 0, -1] + inp
                else:
                    out = inp

    def validation(gate, inp, out, *, domain, origin):
        ni, nj, nk = domain
        out[:ni, :nj, 0] = inp[:ni, :nj, 0]
        for k in range(1, nk):
            cond = gate[:ni, :nj, k] > 0.0
            out[:ni, :nj, k] = np.where(
                cond, out[:ni, :nj, k - 1] + inp[:ni, :nj, k], inp[:ni, :nj, k]
            )

# --- tests/cartesian_tests/test_suites_extended.py -------------------------------------
class TestBackwardCumsum(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(1, 6), (1, 6), (2, 8)]
    symbols = dict(inp=field(in_range=(-3, 3)), acc=field(in_range=(0, 0)))
    max_examples = 10

    def definition(inp, acc):
        with gtscript.computation("BACKWARD"):
            with gtscript.interval(-1, None):
                acc = inp[0, 0, 0]
            with gtscript.interval(0, -1):
                acc = acc[0, 0, 1] + inp[0, 0, 0]

    def validation(inp, acc, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        sub = inp[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk]
        acc[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = np.cumsum(
            sub[:, :, ::-1], axis=2
        )[:, :, ::-1]


class TestFluxLimiter(_CPUSuite):
    """Temporaries + shifted temp reads + ternary select (hdiff's shape)."""

    dtypes = [np.float64, np.float32]
    domain_range = [(2, 10), (2, 10), (1, 4)]
    symbols = dict(
        inp=field(in_range=(-4, 4), boundary=((2, 2), (0, 0), (0, 0))),
        out=field(in_range=(0, 0)),
    )
    max_examples = 10

    def definition(inp, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            grad = inp[1, 0, 0] - inp[0, 0, 0]
            flux = 0.0 if (grad * (inp[1, 0, 0] + inp[0, 0, 0])) > 0.0 else grad
            out = flux[0, 0, 0] - flux[-1, 0, 0]

    def validation(inp, out, *, domain, origin):
        ni, nj, nk = domain
        ext = inp[1 : ni + 4 - 1, :nj, :nk]  # rows [1, ni+3)
        grad = ext[1:, :, :] - ext[:-1, :, :]  # at rows [1, ni+2)
        cond = grad * (ext[1:, :, :] + ext[:-1, :, :]) > 0.0
        flux = np.where(cond, 0.0, grad)
        out[:ni, :nj, :nk] = flux[1:, :, :] - flux[:-1, :, :]


class TestHorizontalRegion(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(3, 9), (3, 9), (1, 4)]
    symbols = dict(inp=field(in_range=(-5, 5)), out=field(in_range=(-5, 5)))
    max_examples = 10

    def definition(inp, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = inp[0, 0, 0]
            with horizontal(region[I[0], :]):
                out = inp[0, 0, 0] * 10.0
            with horizontal(region[I[-1], J[0]]):
                out = -inp[0, 0, 0]

    def validation(inp, out, *, domain, origin):
        ni, nj, nk = domain
        out[:ni, :nj, :nk] = inp[:ni, :nj, :nk]
        out[0, :nj, :nk] = inp[0, :nj, :nk] * 10.0
        out[ni - 1, 0, :nk] = -inp[ni - 1, 0, :nk]


class TestWhileNewton(_CPUSuite):
    """Per-point while-loop iteration (Newton sqrt, bounded by value)."""

    dtypes = [np.float64]
    domain_range = [(1, 6), (1, 6), (1, 4)]
    symbols = dict(a=field(in_range=(1.0, 16.0)), out=field(in_range=(0, 0)))
    max_examples = 10

    def definition(a, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            x = a[0, 0, 0]
            while x * x - a[0, 0, 0] > 1e-6:
                x = 0.5 * (x + a[0, 0, 0] / x)
            out = x

    def validation(a, out, *, domain, origin):
        ni, nj, nk = domain
        sub = a[:ni, :nj, :nk]
        x = sub.copy()
        for _ in range(200):
            active = x * x - sub > 1e-6
            if not active.any():
                break
            x = np.where(active, 0.5 * (x + sub / x), x)
        out[:ni, :nj, :nk] = x


class TestThreeSectionScan(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(1, 5), (1, 5), (4, 9)]
    symbols = dict(inp=field(in_range=(-2, 2)), out=field(in_range=(0, 0)))
    max_examples = 10

    def definition(inp, out):
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                out = inp[0, 0, 0] * 2.0
            with gtscript.interval(1, -1):
                out = out[0, 0, -1] + inp[0, 0, 0]
            with gtscript.interval(-1, None):
                out = out[0, 0, -1] * 0.5

    def validation(inp, out, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        sub = inp[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk]
        res = np.zeros_like(sub)
        res[:, :, 0] = sub[:, :, 0] * 2.0
        for k in range(1, nk - 1):
            res[:, :, k] = res[:, :, k - 1] + sub[:, :, k]
        if nk > 1:
            res[:, :, nk - 1] = res[:, :, nk - 2] * 0.5
        out[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = res


class TestFieldCondition(_CPUSuite):
    dtypes = [np.float64, np.float32]
    domain_range = [(1, 8), (1, 8), (1, 5)]
    symbols = dict(
        a=field(in_range=(-5, 5)), b=field(in_range=(-5, 5)), out=field(in_range=(0, 0))
    )
    max_examples = 10

    def definition(a, b, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            if a[0, 0, 0] > b[0, 0, 0]:
                out = a[0, 0, 0] - b[0, 0, 0]
            else:
                out = b[0, 0, 0] * 2.0

    def validation(a, b, out, *, domain, origin):
        ni, nj, nk = domain
        sa = a[:ni, :nj, :nk]
        sb = b[:ni, :nj, :nk]
        out[:ni, :nj, :nk] = np.where(sa > sb, sa - sb, sb * 2.0)


class TestAbsoluteK(_CPUSuite):
    dtypes = [np.float64]
    domain_range = [(1, 6), (1, 6), (2, 7)]
    symbols = dict(a=field(in_range=(-4, 4)), out=field(in_range=(0, 0)))
    max_examples = 10

    def definition(a, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = a[0, 0, 0] - a.at(K=0)

    def validation(a, out, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        sub = a[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk]
        out[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = sub - sub[:, :, :1]


class TestNativeFunctions(_CPUSuite):
    dtypes = [np.float64, np.float32]
    domain_range = [(1, 8), (1, 8), (1, 4)]
    symbols = dict(
        a=field(in_range=(0.125, 4.0)),  # f32-exact bound (hypothesis requirement)
        b=field(in_range=(-2, 2)),
        out=field(in_range=(0, 0)),
    )
    max_examples = 10

    def definition(a, b, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = sqrt(a[0, 0, 0]) + exp(b[0, 0, 0]) * 0.1 + log(a[0, 0, 0]) + min(
                abs(b[0, 0, 0]), a[0, 0, 0]
            ) - max(a[0, 0, 0], b[0, 0, 0])

    def validation(a, b, out, *, domain, origin):
        ni, nj, nk = domain
        sa = a[:ni, :nj, :nk]
        sb = b[:ni, :nj, :nk]
        out[:ni, :nj, :nk] = (
            np.sqrt(sa)
            + np.exp(sb) * 0.1
            + np.log(sa)
            + np.minimum(np.abs(sb), sa)
            - np.maximum(sa, sb)
        )


class TestIntegerArithmeticExtended(_CPUSuite):
    dtypes = [np.int32, np.int64]
    domain_range = [(1, 8), (1, 8), (1, 4)]
    symbols = dict(
        a=field(in_range=(-20, 20)), b=field(in_range=(1, 7)), out=field(in_range=(0, 0))
    )
    max_examples = 10

    def definition(a, b, out):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = a[0, 0, 0] * b[0, 0, 0] + a[0, 0, 0] % b[0, 0, 0]

    def validation(a, b, out, *, domain, origin):
        ni, nj, nk = domain
        sa = a[:ni, :nj, :nk]
        sb = b[:ni, :nj, :nk]
        out[:ni, :nj, :nk] = sa * sb + sa % sb


class TestMaskedScanCarry(_CPUSuite):
    """Sequential carry under a field-condition mask: the scan must keep the
    previous carry where the mask is false."""

    dtypes = [np.float64]
    domain_range = [(1, 5), (1, 5), (3, 8)]
    symbols = dict(inp=field(in_range=(-3, 3)), out=field(in_range=(0, 0)))
    max_examples = 10

    def definition(inp, out):
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                out = inp[0, 0, 0]
            with gtscript.interval(1, None):
                out = out[0, 0, -1]
                if inp[0, 0, 0] > 0.0:
                    out = out[0, 0, -1] + inp[0, 0, 0]

    def validation(inp, out, *, domain, origin):
        i0, j0, k0 = origin
        ni, nj, nk = domain
        sub = inp[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk]
        res = np.zeros_like(sub)
        res[:, :, 0] = sub[:, :, 0]
        for k in range(1, nk):
            res[:, :, k] = np.where(
                sub[:, :, k] > 0.0, res[:, :, k - 1] + sub[:, :, k], res[:, :, k - 1]
            )
        out[i0 : i0 + ni, j0 : j0 + nj, k0 : k0 + nk] = res
