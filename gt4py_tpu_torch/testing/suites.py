"""Declarative stencil test suites.

Copied from gt4py_tpu/testing/suites.py; imports renamed. Counterpart of
the reference's ``StencilTestSuite`` metaclass
(src/gt4py/cartesian/testing/suites.py:53,196-234,377): a subclass declares
``dtypes``, ``domain_range``, ``backends``, ``symbols`` (input strategies)
and a pair (``definition`` — a GTScript function without annotations,
``validation`` — a NumPy oracle mutating the same arrays); the metaclass
expands one hypothesis-driven test method per (backend, dtype) that
compiles the stencil, runs it on generated data, and compares against the
oracle. ``backends`` defaults to every backend of the port's registry
(``torch``, ``cuda:hopper``, ``numpy``, ``debug``, ``cpu:c``). ``device``
places the storages: by default each backend's own (storage/layout.py: the
card for ``torch`` and ``cuda:hopper``, which raises without one), or
``"cpu"``, where ``cuda:hopper`` runs its plain version.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np

from gt4py_tpu_torch.testing.input_strategies import SymbolDescriptor, global_boundaries


def _make_test(suite: type, backend: str, dtype: np.dtype):
    import hypothesis
    import hypothesis.extra.numpy as hnp
    import hypothesis.strategies as st

    from gt4py_tpu_torch import storage
    from gt4py_tpu_torch.cartesian import gtscript

    symbols: dict[str, SymbolDescriptor] = suite.symbols
    domain_range = suite.domain_range
    boundary = global_boundaries(symbols)
    max_examples = getattr(suite, "max_examples", 25)
    device = getattr(suite, "device", None)

    definition = suite.definition
    validation = suite.validation
    arg_names = [n for n in inspect.signature(definition).parameters if n in symbols]

    def build_stencil():
        annotations = {}
        for name in arg_names:
            desc = symbols[name]
            eff = np.dtype(desc.dtype) if desc.dtype is not None else dtype
            if desc.is_field:
                if desc.axes and set(desc.axes) != {"I", "J", "K"}:
                    axes = tuple(getattr(gtscript, ax) for ax in desc.axes)
                    annotations[name] = gtscript.Field[axes, eff.type]
                else:
                    annotations[name] = gtscript.Field[eff.type]
            else:
                annotations[name] = eff.type
        # Fresh function object so per-dtype annotations don't collide.
        import types

        fn = types.FunctionType(
            definition.__code__,
            definition.__globals__,
            name=f"{definition.__name__}_{backend}_{dtype.name}".replace(":", "_"),
            argdefs=definition.__defaults__,
            closure=definition.__closure__,
        )
        fn.__annotations__ = annotations
        precision = 32 if dtype.itemsize <= 4 else 64
        return gtscript.stencil(
            backend=backend,
            definition=fn,
            name=fn.__name__,
            literal_float_precision=precision,
            literal_int_precision=precision,
        )

    cache: list = []

    @hypothesis.given(data=st.data())
    @hypothesis.settings(
        max_examples=max_examples,
        deadline=None,
        suppress_health_check=[hypothesis.HealthCheck.data_too_large],
    )
    def test(self, data):
        if not cache:
            cache.append(build_stencil())
        stencil = cache[0]
        domain = tuple(
            data.draw(st.integers(lo, hi), label=f"domain[{ax}]")
            for ax, (lo, hi) in enumerate(domain_range)
        )
        origin = tuple(b[0] for b in boundary)
        arrays: dict[str, Any] = {}
        run_args: dict[str, Any] = {}
        for name in arg_names:
            desc = symbols[name]
            eff = np.dtype(desc.dtype) if desc.dtype is not None else dtype
            if desc.is_field:
                ext_shape = tuple(
                    domain[ax] + desc.boundary[ax][0] + desc.boundary[ax][1]
                    if ax < len(domain)
                    else 1
                    for ax in range(3)
                )
                if eff.kind == "f":
                    # TPU (and the Pallas interpreter) flush subnormals to
                    # zero, so comparisons against 0 at subnormal inputs
                    # are platform-defined — keep generators out of there.
                    elements = st.floats(
                        width=min(eff.itemsize * 8, 64),
                        allow_nan=False,
                        allow_infinity=False,
                        allow_subnormal=False,
                        **desc.value_st_kwargs,
                    )
                else:
                    elements = st.integers(
                        int(desc.value_st_kwargs["min_value"]),
                        int(desc.value_st_kwargs["max_value"]),
                    )
                arr = data.draw(
                    hnp.arrays(dtype=eff, shape=ext_shape, elements=elements),
                    label=name,
                )
                arrays[name] = np.array(arr)
                field_origin = tuple(desc.boundary[ax][0] for ax in range(3))
                run_args[name] = (arrays[name].copy(), field_origin)
            else:
                kw = desc.value_st_kwargs
                if "one_of" in kw:
                    value = data.draw(st.sampled_from(kw["one_of"]), label=name)
                elif eff.kind == "f":
                    value = data.draw(
                        st.floats(
                            width=min(eff.itemsize * 8, 64),
                            allow_nan=False,
                            allow_infinity=False,
                            allow_subnormal=False,
                            **kw,
                        ),
                        label=name,
                    )
                else:
                    value = data.draw(
                        st.integers(int(kw["min_value"]), int(kw["max_value"])), label=name
                    )
                arrays[name] = eff.type(value)
                run_args[name] = arrays[name]

        # Backend run on copies.
        call_kwargs = {}
        origins = {}
        for name, v in run_args.items():
            if isinstance(v, tuple):
                arr, f_origin = v
                # keep the per-symbol dtype (index fields pin their own)
                call_kwargs[name] = storage.from_array(
                    arr, backend=backend, dtype=arr.dtype, device=device
                )
                origins[name] = f_origin
            else:
                call_kwargs[name] = v
        stencil(**call_kwargs, origin=origins, domain=domain)

        # Oracle run mutating the original arrays.
        validation(
            **{n: arrays[n] for n in arg_names}, domain=domain, origin=origin
        )

        rtol = 1e-5 if dtype.itemsize <= 4 else 1e-10
        for name in arg_names:
            if symbols[name].is_field:
                np.testing.assert_allclose(
                    np.asarray(call_kwargs[name]),
                    arrays[name],
                    rtol=rtol,
                    atol=rtol,
                    err_msg=f"field '{name}' mismatch on backend {backend}",
                )

    return test


class _SuiteMeta(type):
    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        if not bases or namespace.get("__abstract__"):
            return cls
        backends = getattr(cls, "backends", None)
        if backends is None:
            from gt4py_tpu_torch.cartesian.backend.base import REGISTRY

            backends = sorted(REGISTRY)
        dtypes = getattr(cls, "dtypes", [np.float64])
        skip = getattr(cls, "skip_backends", ())
        for backend in backends:
            if backend in skip:
                continue
            for dt in dtypes:
                dt = np.dtype(dt)
                test_name = f"test_{backend}_{dt.name}".replace(":", "_")
                setattr(cls, test_name, _make_test(cls, backend, dt))
        return cls


class StencilTestSuite(metaclass=_SuiteMeta):
    """Subclass with ``definition``/``validation``/``symbols``/``dtypes``/
    ``domain_range`` class attributes; test methods are generated per
    (backend, dtype)."""

    __abstract__ = True
