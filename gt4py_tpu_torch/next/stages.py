"""Typed artifact stages of the port's compile toolchain.

Counterpart of gt4py_tpu/next/stages.py (role of the reference's stage
dataclasses — ``ffront/stages.py`` (``DSLFieldOperatorDef:74``,
``FOASTOperatorDef:88``) and ``otf/stages.py:71-141`` (``ProgramSource``,
``CompilableSource``, ``CompilationArtifact``)): each compilation phase
produces a typed, fingerprintable artifact. On the H100 the phases are

    OperatorDefinition --deduce--> TypedDefinition --trace--> TracedProgram
        --lower--> LoweredProgram --compile--> CompiledProgram

where the traced program is the cartesian GTIR the bridge traces the
operator into for one argument signature (the jaxpr's role; its text is
``gtir_pretty.pretty``), the lowered program is the generated CUDA C++
source of that variant (StableHLO's role; its text is what ``nvcc``
consumes), and the compiled program holds the loaded kernel library, with
what ``ptxas`` reported for each kernel as its cost analysis (XLA's
estimates' role). ``gt4py_tpu_torch.next.backend`` assembles these into
the ``cuda:hopper:aot`` workflow; ``program_processors`` renders them.

``OperatorDefinition`` and ``TypedDefinition`` are copied from the JAX
package; imports renamed.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable, Optional

from gt4py_tpu_torch.next.fingerprinting import fingerprint, fingerprint_function


__all__ = [
    "OperatorDefinition",
    "TypedDefinition",
    "TracedProgram",
    "LoweredProgram",
    "CompiledProgram",
    "ptxas_report",
]


@dataclasses.dataclass(frozen=True)
class OperatorDefinition:
    """The raw DSL definition (reference DSLFieldOperatorDef,
    ffront/stages.py:74): a Python function plus its operator kind and any
    statically-bound parameters."""

    definition: Callable
    kind: str = "field_operator"  # 'field_operator' | 'scan_operator' | 'program'
    static_args: tuple[tuple[str, Any], ...] = ()

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(
            fingerprint_function(self.definition), self.kind, self.static_args
        )

    @property
    def name(self) -> str:
        return getattr(self.definition, "__name__", "<operator>")


@dataclasses.dataclass(frozen=True)
class TypedDefinition:
    """Definition + deduced signature (reference FOASTOperatorDef:88 — the
    post-type-deduction stage). ``type_info`` is None for unannotated
    legacy operators (deduction off)."""

    definition_stage: OperatorDefinition
    type_info: Optional[Any] = None  # type_deduction.OperatorTypeInfo

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(self.definition_stage.fingerprint, str(self.type_info))

    @property
    def definition(self) -> Callable:
        return self.definition_stage.definition


@dataclasses.dataclass(frozen=True)
class TracedProgram:
    """The bridged program for one argument signature (ProgramSource role,
    reference otf/stages.py:71). ``stencil`` is the cartesian GTIR the
    bridge traced the operator into, before analysis; ``variant`` the
    bridge's analyzed variant (``cartesian_bridge.BridgeVariant``), whose
    kernel backend the later stages lower and build; ``text`` the GTIR's
    stable rendering (fingerprinted)."""

    typed_stage: TypedDefinition
    stencil: Any = dataclasses.field(repr=False)  # cartesian gtir.Stencil
    variant: Any = dataclasses.field(repr=False)  # cartesian_bridge.BridgeVariant
    arg_signature: tuple = dataclasses.field(repr=False, default=())

    @functools.cached_property
    def text(self) -> str:
        from gt4py_tpu_torch.cartesian.gtir_pretty import pretty

        return pretty(self.stencil)

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(self.typed_stage.fingerprint, self.text, self.arg_signature)


@dataclasses.dataclass(frozen=True)
class LoweredProgram:
    """The generated CUDA C++ of the traced program (CompilableSource role,
    reference otf/stages.py:103: the artifact a build system consumes).
    ``module`` is the codegen's ``KernelModule``: None where no kernel
    skeleton serves the stencil (``unsupported`` says why; a call on the
    card raises, as ``cuda:hopper`` does)."""

    traced_stage: Optional[TracedProgram]
    module: Any = dataclasses.field(repr=False)  # cuda_codegen.KernelModule
    unsupported: Optional[str] = None

    @functools.cached_property
    def text(self) -> str:
        return self.module.source if self.module is not None else ""

    @property
    def strategy(self) -> Optional[str]:
        """The kernel skeleton that serves the program on a card."""
        return self.module.strategy if self.module is not None else None

    @functools.cached_property
    def fingerprint(self) -> str:
        base = self.traced_stage.fingerprint if self.traced_stage else ""
        return fingerprint(base, self.text)


def ptxas_report(log: str) -> dict:
    """kernel -> {"registers", "spill_store_bytes", "spill_load_bytes",
    "static_shared_bytes"}, from the ``-Xptxas -v`` lines of an ``nvcc``
    build log (kernels by their unmangled names)."""
    out: dict = {}
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            kernel = m.group(2)[: int(m.group(1))]
            out[kernel] = {"registers": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                           "static_shared_bytes": 0}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[kernel]["spill_store_bytes"] = int(m.group(1))
            out[kernel]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[kernel]["static_shared_bytes"] = int(m.group(1)) if m else 0
    return out


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """The executable (CompilationArtifact role, reference
    otf/stages.py:141). ``executable`` is callable with the argument
    structure the program was traced for, plus ``out=``; ``library`` is
    the path of the loaded kernel library, None where nothing was built
    (the arguments were CPU tensors: the executable runs the kernels'
    plain version)."""

    lowered_stage: Optional[LoweredProgram]
    executable: Callable = dataclasses.field(repr=False)
    library: Optional[str] = None
    build_log: Optional[str] = dataclasses.field(repr=False, default=None)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.executable(*args, **kwargs)

    def cost_analysis(self) -> Optional[dict]:
        """What ``ptxas`` reported for each kernel of the library
        (:func:`ptxas_report`): registers, spill bytes and static shared
        bytes. None where nothing was built; no operation count is
        estimated."""
        if self.library is None or self.build_log is None:
            return None
        return ptxas_report(self.build_log)
