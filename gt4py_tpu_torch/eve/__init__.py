"""gt4py_tpu_torch.eve — lean IR-node framework.

Copied from gt4py_tpu/eve/__init__.py; imports renamed.

TPU-native re-design of the reference's ``gt4py.eve`` package
(src/gt4py/eve/). The reference builds IR nodes on
attrs-based "datamodels" with runtime type validation and a templated C++
code generator; here codegen targets JAX/Pallas Python callables, so the
node kit is a small dataclass + visitor toolkit:

- :mod:`concepts` — ``Node``, ``SourceLocation``, ``SymbolName``/``SymbolRef``,
  node annexes (reference eve/concepts.py:39-230).
- :mod:`visitors` — ``NodeVisitor`` / ``NodeTranslator`` with class-name
  dispatch and MRO fallback (reference eve/visitors.py:23,150).
- :mod:`traits` — symbol-table collection & reference validation
  (reference eve/traits.py:22,87,149).
- :mod:`trees` — generic tree walks (reference eve/trees.py).
- :mod:`pattern_matching` — ``ObjectPattern`` structural matching
  (reference eve/pattern_matching.py:18).
- :mod:`utils` — content hashing, case-style conversion, namespaces, UIDs
  (reference eve/utils.py:745,808,910,960).

There is no TemplatedGenerator equivalent: the reference generates C++
source from IR templates (eve/codegen.py:563); here the backends *trace*
the IR into JAX programs and XLA/Mosaic is the code generator.
"""

from gt4py_tpu_torch.eve.concepts import (
    Node,
    SourceLocation,
    SymbolName,
    SymbolRef,
    datamodel,
    field,
)
from gt4py_tpu_torch.eve.pattern_matching import ObjectPattern, get_differences
from gt4py_tpu_torch.eve.type_validation import (
    TypeValidationError,
    assert_type,
    simple_type_validator,
)
from gt4py_tpu_torch.eve.traits import (
    SymbolTableTrait,
    VisitorWithSymbolTable,
    collect_symbols,
    validate_symbol_refs,
)
from gt4py_tpu_torch.eve.trees import (
    iter_tree_children,
    post_walk_values,
    pre_walk_items,
    walk_type,
    walk_values,
)
from gt4py_tpu_torch.eve.utils import (
    CaseStyleConverter,
    FrozenNamespace,
    Namespace,
    UIDGenerator,
    content_hash,
    noninstantiable,
)
from gt4py_tpu_torch.eve.visitors import NodeTranslator, NodeVisitor


__all__ = [
    "Node",
    "SourceLocation",
    "SymbolName",
    "SymbolRef",
    "datamodel",
    "field",
    "ObjectPattern",
    "get_differences",
    "SymbolTableTrait",
    "VisitorWithSymbolTable",
    "collect_symbols",
    "validate_symbol_refs",
    "iter_tree_children",
    "post_walk_values",
    "pre_walk_items",
    "walk_type",
    "walk_values",
    "CaseStyleConverter",
    "FrozenNamespace",
    "Namespace",
    "UIDGenerator",
    "content_hash",
    "noninstantiable",
    "NodeTranslator",
    "NodeVisitor",
]
