"""Build orchestration object with a build-data cache.

Copied from gt4py_tpu/cartesian/stencil_builder.py; imports renamed.

Counterpart of the reference's ``StencilBuilder``
(src/gt4py/cartesian/stencil_builder.py:27 — ``build():71``,
``gtir_pipeline:253``, chainable ``with_*`` setters, per-build
``backend_data`` store): one object owns the whole definition→executable
thread — frontend parse + analysis pipeline (cached per builder), backend
instantiation, StencilObject assembly — and records build phases in a
crash-consistent persistent *build-data* record (FileCache keyed by the
stencil fingerprint), so tooling can ask "what was built, when, through
which kernel strategy" without rebuilding.

``loader.load_stencil`` is a thin veneer over this class; use the builder
directly for staged builds (syntax-check only, inspect the analyzed IR,
swap the backend and rebuild)."""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from gt4py_tpu_torch.cartesian.caching import stencil_fingerprint
from gt4py_tpu_torch.instrumentation.spans import Span


_MEMO: dict[str, Any] = {}  # fingerprint -> StencilObject (in-process)


def _build_data_cache():
    import os

    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.core.filecache import FileCache

    return FileCache(os.path.join(config.cache_dir(), "build_data"))


class StencilBuilder:
    """Thread a stencil definition through frontend → analysis → backend.

    Chainable configuration (reference stencil_builder.py builder idiom)::

        obj = (
            StencilBuilder(defn)
            .with_backend("tpu:pallas")
            .with_externals({"K": 3})
            .build()
        )
    """

    def __init__(
        self,
        definition: Callable,
        *,
        backend: Optional[str] = None,
        options: Optional[dict] = None,
    ):
        self.definition = definition
        self.options: dict = dict(options or {})
        if backend is not None:
            self.options["backend"] = backend
        self.options.setdefault("externals", {})
        self.options.setdefault("dtypes", {})
        # Per-build artifact store backends may stash data in (reference
        # builder.backend_data / with_backend_data).
        self.backend_data: dict = {}
        self._analyzed = None
        self._backend_obj = None
        self._fingerprint: Optional[str] = None
        #: the build spans of the front end and the code generator
        self._front_end: Optional[Span] = None
        self._codegen: Optional[Span] = None

    # -- chainable setters -------------------------------------------------

    def _dirty(self) -> "StencilBuilder":
        self._analyzed = None
        self._backend_obj = None
        self._fingerprint = None
        return self

    def with_backend(self, backend: str) -> "StencilBuilder":
        self.options["backend"] = backend
        return self._dirty()

    def with_externals(self, externals: dict) -> "StencilBuilder":
        self.options["externals"] = {**self.options.get("externals", {}), **externals}
        return self._dirty()

    def with_options(self, **options: Any) -> "StencilBuilder":
        self.options.update(options)
        return self._dirty()

    def with_backend_data(self, **data: Any) -> "StencilBuilder":
        self.backend_data.update(data)
        return self

    # -- cached pipeline stages (reference gtir_pipeline:253) --------------

    @property
    def stencil_id(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = stencil_fingerprint(self.definition, self.options)
        return self._fingerprint

    @property
    def gtir(self):
        """The analyzed stencil (GTIR + extents/access/dtype analyses);
        parsed once per builder configuration."""
        if self._analyzed is None:
            from gt4py_tpu_torch.cartesian.passes import analyze

            with Span("gt4py.build.front_end", always=True, stencil=self.name) as phase:
                self._analyzed = analyze(self.definition, self.options)
            self._front_end = phase
        return self._analyzed

    @property
    def backend_cls(self):
        from gt4py_tpu_torch.cartesian import backend as backend_module

        return backend_module.from_name(self.options["backend"])

    @property
    def backend_obj(self):
        if self._backend_obj is None:
            analyzed = self.gtir
            # the backend generates its code (cuda:hopper: cuda_codegen.generate)
            with Span("gt4py.build.codegen", always=True, stencil=self.name) as phase:
                self._backend_obj = self.backend_cls(analyzed, self.options)
            self._codegen = phase
        return self._backend_obj

    @property
    def name(self) -> str:
        return getattr(self.definition, "__name__", "<stencil>")

    # -- build-data record (reference build_data / backend caching) --------

    def build_data(self) -> dict:
        """The persisted record of the last completed build of this
        fingerprint ({} if never built or the build crashed mid-way —
        FileCache writes are atomic, so a torn record is impossible)."""
        try:
            return _build_data_cache()[self.stencil_id]
        except KeyError:
            return {}

    def _record_build(self, *, parse_time: float, module_time: float) -> None:
        record = {
            "status": "done",
            "name": self.name,
            "backend": self.options.get("backend"),
            "fingerprint": self.stencil_id,
            "parse_time": parse_time,
            "module_time": module_time,
            "built_at": time.time(),
            # Backend-contributed artifacts (e.g. kernel strategy chosen).
            "backend_data": {
                k: v
                for k, v in self.backend_data.items()
                if isinstance(v, (str, int, float, bool, tuple, list, dict, type(None)))
            },
        }
        try:
            _build_data_cache()[self.stencil_id] = record
        except Exception:
            pass  # cache dir unwritable: build-data is advisory

    # -- build (reference build():71) --------------------------------------

    def check_syntax(self) -> None:
        """Run frontend + analysis only (reference LazyStencil.check_syntax
        path through the builder)."""
        self.gtir

    def build(self):
        """Load-or-build the StencilObject (reference build():71:
        backend.load() cache hit, else backend.generate())."""
        from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

        build_info = self.options.get("build_info")
        start = time.perf_counter()

        if not self.options.get("rebuild") and self.stencil_id in _MEMO:
            cached = _MEMO[self.stencil_id]
            if build_info is not None:
                build_info["load_time"] = time.perf_counter() - start
            return cached

        if self.options.get("raise_if_not_cached") and not self.build_data():
            raise RuntimeError(
                f"Stencil '{getattr(self.definition, '__name__', '?')}' is not "
                "cached (raise_if_not_cached=True)"
            )

        analyzed = self.gtir
        backend = self.backend_obj
        strategy = getattr(backend, "last_strategy", None)
        if strategy is not None:
            self.with_backend_data(kernel_strategy=strategy)
        obj = StencilObject(analyzed, backend, self.options, self.definition)
        module_done = time.perf_counter_ns()

        # from the build spans: the front end, the code generator, and the
        # module (the code generator and the StencilObject's assembly)
        parse_time = self._front_end.seconds
        module_time = (module_done - self._codegen.start) / 1e9
        if build_info is not None:
            build_info["parse_time"] = parse_time
            build_info["module_time"] = module_time
            build_info["codegen_time"] = self._codegen.seconds

        self._record_build(parse_time=parse_time, module_time=module_time)
        _MEMO[self.stencil_id] = obj
        return obj
