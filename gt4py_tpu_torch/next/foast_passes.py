"""FOAST transformation passes.

The field-view analog of the reference's iterator transform pipeline
(src/gt4py/next/iterator/transforms/pass_manager.py:135-266
``apply_common_transforms``: ConstantFolding, CSE, dead-code elimination,
UnrollReduce, global_tmps) restated for eager execution on torch tensors: passes that remove work
(folding, DCE, CSE) shrink the executed program; ``unroll_reduce``
converts a dense neighbor remap (gather of max_neighbors columns + axis
reduce) into per-column partial gathers summed on the fly; and
``extract_temporaries`` marks materialized temporaries (every eager value
is one already, so the mark is the identity here).

Every pass is pure FOAST -> FOAST.

Copied from gt4py_tpu/next/foast_passes.py; imports renamed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

from gt4py_tpu_torch.eve.visitors import NodeTranslator, NodeVisitor
from gt4py_tpu_torch.next.foast import (
    Assign,
    Attribute,
    BinOp,
    BoolOp,
    Call,
    Compare,
    Expr,
    FieldOperatorDefinition,
    FoastUnsupported,
    IfExpr,
    IfStmt,
    ListExpr,
    Literal,
    Name,
    Return,
    SliceExpr,
    Starred,
    Stmt,
    Subscript,
    TransformOptions,
    TupleExpr,
    UnaryOp,
)


__all__ = ["apply_common_transforms"]


# --- constant folding -----------------------------------------------------------

_FOLDABLE = (bool, int, float)

_BIN_FOLD: dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class ConstantFolding(NodeTranslator):
    """Fold literal arithmetic — exactly what Python itself would compute
    during a trace of the raw definition, so folding is observation-
    equivalent (reference transforms/constant_folding.py)."""

    def visit_BinOp(self, node: BinOp, **kw: Any) -> Expr:
        left = self.visit(node.left, **kw)
        right = self.visit(node.right, **kw)
        fold = _BIN_FOLD.get(node.op)
        if (
            fold is not None
            and isinstance(left, Literal)
            and isinstance(right, Literal)
            and type(left.value) in _FOLDABLE
            and type(right.value) in _FOLDABLE
        ):
            try:
                result = fold(left.value, right.value)
            except (ZeroDivisionError, OverflowError, ValueError):
                result = None
            # Non-finite results have no source-literal form; leave the
            # expression to fold at trace time instead.
            if result is not None and not (
                isinstance(result, float) and not math.isfinite(result)
            ):
                return Literal(value=result)
        return BinOp(op=node.op, left=left, right=right)

    def visit_Compare(self, node: Compare, **kw: Any) -> Expr:
        left = self.visit(node.left, **kw)
        right = self.visit(node.right, **kw)
        fold = _BIN_FOLD.get(node.op)
        if (
            fold is not None
            and isinstance(left, Literal)
            and isinstance(right, Literal)
            and type(left.value) in _FOLDABLE
            and type(right.value) in _FOLDABLE
        ):
            return Literal(value=fold(left.value, right.value))
        return Compare(op=node.op, left=left, right=right)

    def visit_UnaryOp(self, node: UnaryOp, **kw: Any) -> Expr:
        operand = self.visit(node.operand, **kw)
        if isinstance(operand, Literal) and type(operand.value) in _FOLDABLE:
            v = operand.value
            if node.op == "-":
                return Literal(value=-v)
            if node.op == "+":
                return Literal(value=+v)
            if node.op == "not":
                return Literal(value=not v)
        return UnaryOp(op=node.op, operand=operand)

    def visit_IfExpr(self, node: IfExpr, **kw: Any) -> Expr:
        cond = self.visit(node.cond, **kw)
        if isinstance(cond, Literal) and type(cond.value) in _FOLDABLE:
            return self.visit(
                node.true_expr if cond.value else node.false_expr, **kw
            )
        return IfExpr(
            cond=cond,
            true_expr=self.visit(node.true_expr, **kw),
            false_expr=self.visit(node.false_expr, **kw),
        )

    def visit_BoolOp(self, node: BoolOp, **kw: Any) -> Expr:
        values = [self.visit(v, **kw) for v in node.values]
        # Short-circuit only when EVERY value is a literal (partial
        # short-circuiting would change evaluation order of traced exprs).
        if all(isinstance(v, Literal) and type(v.value) in _FOLDABLE for v in values):
            result = values[0].value
            for v in values[1:]:
                result = (result and v.value) if node.op == "and" else (result or v.value)
            return Literal(value=result)
        return BoolOp(op=node.op, values=values)


def fold_constants(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    return ConstantFolding().visit(ir)


# --- statement-level dead code elimination ---------------------------------------


class _ReadNames(NodeVisitor):
    def __init__(self) -> None:
        self.names: set[str] = set()

    def visit_Name(self, node: Name, **kw: Any) -> None:
        self.names.add(node.id)


def _reads(expr: Expr) -> set[str]:
    v = _ReadNames()
    v.visit(expr)
    return v.names


class _ReadsOutside(NodeVisitor):
    """Names read in an expression, skipping the given subtrees."""

    def __init__(self, skip_ids: set) -> None:
        self.skip_ids = skip_ids
        self.names: set[str] = set()

    def visit(self, node: Any, **kw: Any) -> None:
        if isinstance(node, Expr) and id(node) in self.skip_ids:
            return
        super().visit(node, **kw)

    def visit_Name(self, node: Name, **kw: Any) -> None:
        self.names.add(node.id)


def _reads_outside(expr: Expr, skip_ids: set) -> set[str]:
    v = _ReadsOutside(skip_ids)
    v.visit(expr)
    return v.names


def _target_names(target: Expr) -> list[str]:
    if isinstance(target, Name):
        return [target.id]
    if isinstance(target, Starred):
        return _target_names(target.value)
    if isinstance(target, TupleExpr):
        out: list[str] = []
        for e in target.elts:
            out.extend(_target_names(e))
        return out
    return []


def _dce_block(body: list, live: set[str]) -> list:
    """Backward liveness over one straight-line block. All FOAST
    expressions are pure (the DSL has no effectful calls), so an
    assignment none of whose targets are live is dropped (reference
    transforms/dead_code_elimination.py)."""
    out: list = []
    for stmt in reversed(body):
        if isinstance(stmt, Return):
            live |= _reads(stmt.value)
            out.append(stmt)
        elif isinstance(stmt, Assign):
            names = [n for t in stmt.targets for n in _target_names(t)]
            if not any(n in live for n in names):
                continue  # dead: drop
            for n in names:
                live.discard(n)
            live |= _reads(stmt.value)
            out.append(stmt)
        elif isinstance(stmt, IfStmt):
            live_t = set(live)
            live_f = set(live)
            body_t = _dce_block(stmt.body, live_t)
            body_f = _dce_block(stmt.orelse, live_f)
            live.clear()
            live |= live_t | live_f | _reads(stmt.cond)
            out.append(IfStmt(cond=stmt.cond, body=body_t, orelse=body_f))
        else:
            out.append(stmt)
    out.reverse()
    return out


def eliminate_dead_code(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    return FieldOperatorDefinition(
        name=ir.name, params=ir.params, body=_dce_block(ir.body, set()),
        kwonly_params=ir.kwonly_params,
    )


# --- common subexpression elimination ---------------------------------------------


def _expr_size(e: Expr) -> int:
    size = 1
    for child in e.iter_children_values():
        if isinstance(child, Expr):
            size += _expr_size(child)
        elif isinstance(child, (list, tuple)):
            size += sum(_expr_size(c) for c in child if isinstance(c, Expr))
        elif isinstance(child, dict):
            size += sum(_expr_size(c) for c in child.values() if isinstance(c, Expr))
    return size


def _expr_key(e: Expr, versions: dict) -> tuple:
    """Structural key; Name keys include the assignment VERSION live at
    this point, so textually equal expressions across a redefinition of
    one of their inputs never unify."""
    if isinstance(e, Name):
        return ("name", e.id, versions.get(e.id, 0))
    if isinstance(e, Literal):
        return ("lit", type(e.value).__name__, e.value)
    parts: list = [type(e).__name__]
    for fname, child in e.iter_children_items():
        if isinstance(child, Expr):
            parts.append((fname, _expr_key(child, versions)))
        elif isinstance(child, (list, tuple)):
            parts.append(
                (
                    fname,
                    tuple(
                        _expr_key(c, versions) if isinstance(c, Expr) else c
                        for c in child
                    ),
                )
            )
        elif isinstance(child, dict):
            parts.append(
                (
                    fname,
                    tuple(
                        sorted(
                            (k, _expr_key(v, versions))
                            for k, v in child.items()
                            if isinstance(v, Expr)
                        )
                    ),
                )
            )
        else:
            parts.append((fname, child))
    return tuple(parts)


class _Replace(NodeTranslator):
    """Replace expression nodes by object identity."""

    def __init__(self, mapping: dict) -> None:
        self.mapping = mapping

    def visit(self, node: Any, **kw: Any) -> Any:
        if isinstance(node, Expr) and id(node) in self.mapping:
            return self.mapping[id(node)]
        return super().visit(node, **kw)


def _cse_block(body: list, counter: list) -> list:
    """One straight-line region (IfStmt branches are separate regions —
    hoisting across a branch would evaluate expressions from untaken
    branches; pure but a pessimization)."""
    versions: dict[str, int] = {}
    occurrences: dict[tuple, list] = {}  # key -> [(stmt_idx, node), ...]

    def collect(e: Expr, idx: int) -> None:
        if isinstance(e, (Name, Literal, SliceExpr)):
            return
        if not isinstance(e, (Attribute,)) and _expr_size(e) >= 2:
            occurrences.setdefault(_expr_key(e, versions), []).append((idx, e))
        for child in e.iter_children_values():
            if isinstance(child, Expr):
                collect(child, idx)
            elif isinstance(child, (list, tuple)):
                for c in child:
                    if isinstance(c, Expr):
                        collect(c, idx)
            elif isinstance(child, dict):
                for c in child.values():
                    if isinstance(c, Expr):
                        collect(c, idx)

    flat: list[tuple[int, Stmt]] = []
    for idx, stmt in enumerate(body):
        if isinstance(stmt, Assign):
            collect(stmt.value, idx)
            for t in stmt.targets:
                for n in _target_names(t):
                    versions[n] = versions.get(n, 0) + 1
        elif isinstance(stmt, Return):
            collect(stmt.value, idx)
        elif isinstance(stmt, IfStmt):
            collect(stmt.cond, idx)
        flat.append((idx, stmt))

    # Outermost-largest first; skip keys nested inside an already-chosen
    # occurrence (hoisting the parent dedups the child within it).
    duplicated = {
        k: occ for k, occ in occurrences.items() if len(occ) >= 2
    }
    chosen: list[tuple[tuple, list]] = []
    covered_ids: set[int] = set()

    def node_ids(e: Expr) -> set:
        ids = {id(e)}
        for child in e.iter_children_values():
            if isinstance(child, Expr):
                ids |= node_ids(child)
            elif isinstance(child, (list, tuple)):
                for c in child:
                    if isinstance(c, Expr):
                        ids |= node_ids(c)
            elif isinstance(child, dict):
                for c in child.values():
                    if isinstance(c, Expr):
                        ids |= node_ids(c)
        return ids

    for key, occ in sorted(
        duplicated.items(), key=lambda kv: -_expr_size(kv[1][0][1])
    ):
        if any(id(node) in covered_ids for _, node in occ):
            continue
        chosen.append((key, occ))
        for _, node in occ:
            covered_ids |= node_ids(node)

    if not chosen:
        return [
            IfStmt(
                cond=s.cond,
                body=_cse_block(s.body, counter),
                orelse=_cse_block(s.orelse, counter),
            )
            if isinstance(s, IfStmt)
            else s
            for s in body
        ]

    inserts: dict[int, list] = {}  # stmt idx -> [Assign temps]
    replace_map: dict[int, Expr] = {}
    for _key, occ in chosen:
        counter[0] += 1
        temp = f"__cse_{counter[0]}"
        first_idx, first_node = occ[0]
        inserts.setdefault(first_idx, []).append(
            Assign(targets=[Name(id=temp)], value=first_node)
        )
        for _, node in occ:
            replace_map[id(node)] = Name(id=temp)

    replacer = _Replace(replace_map)
    out: list = []
    for idx, stmt in flat:
        for pre in inserts.get(idx, ()):  # temp defs get replaced children too
            value = pre.value
            inner = _Replace(
                {k: v for k, v in replace_map.items() if k != id(value)}
            )
            out.append(Assign(targets=pre.targets, value=inner.visit(value)))
        if isinstance(stmt, IfStmt):
            out.append(
                IfStmt(
                    cond=replacer.visit(stmt.cond),
                    body=_cse_block(stmt.body, counter),
                    orelse=_cse_block(stmt.orelse, counter),
                )
            )
        elif isinstance(stmt, Assign):
            out.append(
                Assign(targets=stmt.targets, value=replacer.visit(stmt.value))
            )
        elif isinstance(stmt, Return):
            out.append(Return(value=replacer.visit(stmt.value)))
        else:
            out.append(stmt)
    return out


def eliminate_common_subexpressions(
    ir: FieldOperatorDefinition,
) -> FieldOperatorDefinition:
    """Hoist repeated pure subexpressions into ``__cse_N`` temps
    (reference transforms/cse.py). XLA performs its own CSE on the traced
    program; doing it at FOAST level additionally dedups *trace work*
    (shifts/remaps execute Python once instead of N times) and makes the
    sharing visible in the emitted source."""
    counter = [0]
    return FieldOperatorDefinition(
        name=ir.name, params=ir.params, body=_cse_block(ir.body, counter),
        kwonly_params=ir.kwonly_params,
    )


# --- reduction unrolling -----------------------------------------------------------


_REDUCE_FUNCS = {"neighbor_sum"}
_UNROLL_CAP = 16


def _resolve(expr: Expr, ns: dict, closure: dict) -> Any:
    """Resolve a Name/Attribute chain to its value at compile time; None
    when not resolvable."""
    if isinstance(expr, Name):
        if expr.id in closure:
            return closure[expr.id]
        return ns.get(expr.id)
    if isinstance(expr, Attribute):
        base = _resolve(expr.value, ns, closure)
        return getattr(base, expr.attr, None) if base is not None else None
    return None


class _ShiftScan(NodeVisitor):
    """Find full-connectivity shift calls ``f(<offset name>)`` whose offset
    introduces ``axis``; record rewrite candidates and blockers."""

    def __init__(self, axis: Any, ns: dict, closure: dict, provider: dict) -> None:
        self.axis = axis
        self.ns = ns
        self.closure = closure
        self.provider = provider
        self.shift_nodes: list = []  # Call nodes to index
        self.blocked: Optional[str] = None
        self.connectivity: Any = None

    def visit_Call(self, node: Call, **kw: Any) -> None:
        from gt4py_tpu_torch.next.common import Connectivity, FieldOffset

        if len(node.args) == 1 and not node.kwargs:
            off = _resolve(node.args[0], self.ns, self.closure)
            if isinstance(off, FieldOffset):
                conn = (self.provider or {}).get(off.value)
                if isinstance(conn, Connectivity) and conn.neighbor_dim == self.axis:
                    self.shift_nodes.append(node)
                    if self.connectivity is None:
                        self.connectivity = conn
                    elif self.connectivity is not conn:
                        self.blocked = "multiple connectivities over the axis"
                    self.visit(node.func, **kw)
                    return
        self.generic_visit(node, **kw)


class _UnrollReduce(NodeTranslator):
    def __init__(
        self,
        ns: dict,
        closure: dict,
        provider: dict,
        param_dims: dict,
        locals_: set,
    ) -> None:
        self.ns = ns
        self.closure = closure
        self.provider = provider
        self.param_dims = param_dims  # param name -> dims tuple | None (unknown)
        self.locals_ = locals_  # names assigned in the body (dims unknowable)

    def visit_Call(self, node: Call, **kw: Any) -> Expr:
        node = Call(
            func=self.visit(node.func, **kw),
            args=[self.visit(a, **kw) for a in node.args],
            kwargs={k: self.visit(v, **kw) for k, v in node.kwargs.items()},
        )
        fn = _resolve(node.func, self.ns, self.closure)
        fn_name = getattr(fn, "__name__", None)
        if fn_name not in _REDUCE_FUNCS:
            return node
        # neighbor_sum(arg, axis) / neighbor_sum(arg, axis=...)
        if len(node.args) == 2:
            arg, axis_expr = node.args
        elif len(node.args) == 1 and "axis" in node.kwargs:
            arg, axis_expr = node.args[0], node.kwargs["axis"]
        else:
            return node
        axis = _resolve(axis_expr, self.ns, self.closure)
        if axis is None:
            return node
        scan = _ShiftScan(axis, self.ns, self.closure, self.provider)
        scan.visit(arg)
        conn = scan.connectivity
        if (
            scan.blocked
            or conn is None
            or not scan.shift_nodes
            or conn.skip_value is not None  # masked remap handles skips
            or conn.max_neighbors > _UNROLL_CAP
        ):
            return node
        # Any other producer of the axis inside arg blocks the rewrite:
        # a param carrying (or possibly carrying) the neighbor dim, a
        # local temp (dims unknowable at FOAST level), or a captured
        # Field global. Names INSIDE the recognized shift calls don't
        # count — the rewrite replaces those subtrees wholesale (the
        # shifted field lives on the codomain, not the neighbor axis).
        for name in _reads_outside(arg, {id(sh) for sh in scan.shift_nodes}):
            if name in self.param_dims:
                dims = self.param_dims[name]
                if dims is None or axis in dims:
                    return node
            elif name in self.locals_:
                return node
            else:
                value = self.closure.get(name, self.ns.get(name))
                val_dims = getattr(getattr(value, "domain", None), "dims", None)
                if val_dims is not None and axis in val_dims:
                    return node
        terms: list = []
        for i in range(conn.max_neighbors):
            mapping = {
                id(sh): Call(
                    func=sh.func,
                    args=[Subscript(value=sh.args[0], index=Literal(value=i))],
                    kwargs={},
                )
                for sh in scan.shift_nodes
            }
            terms.append(_Replace(mapping).visit(arg))
        out = terms[0]
        for t in terms[1:]:
            out = BinOp(op="+", left=out, right=t)
        return out


def unroll_reductions(
    ir: FieldOperatorDefinition,
    *,
    globals_ns: dict,
    closure: dict,
    offset_provider: Optional[dict],
    param_dims: dict,
) -> FieldOperatorDefinition:
    """``neighbor_sum(f(V2E) * w, axis=V2EDim)`` ->
    ``f(V2E[0])*w + f(V2E[1])*w + ...`` (reference
    transforms/unroll_reduce.py). Per-column partial shifts gather one
    neighbor column each (half the index traffic of remap-then-reduce on
    this backend); locals or params already carrying the neighbor axis,
    skip-value connectivities, and fan-outs beyond 16 stay on the dense
    remap path."""
    if not offset_provider:
        return ir
    locals_: set = set()

    def collect_locals(body: list) -> None:
        for stmt in body:
            if isinstance(stmt, Assign):
                for t in stmt.targets:
                    locals_.update(_target_names(t))
            elif isinstance(stmt, IfStmt):
                collect_locals(stmt.body)
                collect_locals(stmt.orelse)

    collect_locals(ir.body)
    return _UnrollReduce(
        globals_ns, closure, offset_provider, param_dims, locals_
    ).visit(ir)


# --- temporary extraction ------------------------------------------------------------


def _materialize(x: Any) -> Any:
    """A materialized temporary: eager torch values are materialized
    already, so this is the identity (the JAX package places a fusion
    barrier here)."""
    return x


class _ExtractTemporaries(NodeTranslator):
    def visit_Assign(self, node: Assign, **kw: Any) -> Assign:
        return Assign(
            targets=node.targets,
            value=Call(
                func=Name(id="__gt_materialize__"), args=[node.value], kwargs={}
            ),
        )


def extract_temporaries(
    ir: FieldOperatorDefinition,
) -> tuple[FieldOperatorDefinition, dict]:
    ir = _ExtractTemporaries().visit(ir)
    return ir, {"__gt_materialize__": _materialize}


# --- pipeline -------------------------------------------------------------------------


class _RenameAssigned(NodeTranslator):
    def __init__(self, mapping: dict) -> None:
        self.mapping = mapping

    def visit_Name(self, node: Name, **kw: Any) -> Name:
        new = self.mapping.get(node.id)
        return Name(id=new) if new is not None else node


def _block_reads_writes(body: list) -> tuple[set, set, set]:
    """(reads_before_write, writes, all_reads) over a statement block."""
    written: set = set()
    rbw: set = set()
    all_reads: set = set()

    def note_reads(expr) -> None:
        for n in _reads(expr):
            all_reads.add(n)
            if n not in written:
                rbw.add(n)

    def walk(stmts: list) -> None:
        for st in stmts:
            if isinstance(st, Assign):
                note_reads(st.value)
                for t in st.targets:
                    written.update(_target_names(t))
            elif isinstance(st, Return):
                note_reads(st.value)
            elif isinstance(st, IfStmt):
                note_reads(st.cond)
                walk(st.body)
                walk(st.orelse)
            else:  # pragma: no cover
                raise FoastUnsupported(
                    f"statement {type(st).__name__} inside a conditional"
                )

    walk(body)
    return rbw, written, all_reads


class _HasReturn(NodeVisitor):
    def __init__(self) -> None:
        self.found = False

    def visit_Return(self, node: Return, **kw: Any) -> None:
        self.found = True


def _lower_if_block(body: list, counter: list) -> list:
    """Rewrite scalar if-statements for traced conditions (reference
    uses_if_stmts semantics: ``if flag:`` with a runtime bool argument).
    Each IfStmt becomes a runtime dispatch:

        __ifN_c = <cond>
        if __gtx_is_plain_bool__(__ifN_c):
            <original if  — Python short-circuit for plain bools>
        else:
            <both branches with renamed targets; per-name selects>

    so compile-time Python bools keep one-branch execution while traced
    scalars select functionally."""
    out: list = []
    for st in body:
        if not isinstance(st, IfStmt):
            out.append(st)
            continue
        inner_body = _lower_if_block(st.body, counter)
        inner_orelse = _lower_if_block(st.orelse, counter)
        h = _HasReturn()
        h.visit(inner_body)
        h.visit(inner_orelse)
        if h.found:
            # eliminate_early_returns runs first; a survivor is a bug
            raise FoastUnsupported("return inside a conditional")
        n = counter[0]
        counter[0] += 1
        cvar = f"__if{n}_c"
        # validated at runtime: if-statement conditions must be scalar
        # booleans (reference "Condition for 'if' must be scalar")
        out.append(
            Assign(
                targets=[Name(id=cvar)],
                value=Call(
                    func=Name(id="__gtx_scalar_cond__"), args=[st.cond], kwargs={}
                ),
            )
        )

        functional: list = []
        finals: dict[str, list] = {}
        for tag, branch in (("t", inner_body), ("e", inner_orelse)):
            rbw, written, _ = _block_reads_writes(branch)
            mapping = {name: f"__if{n}_{tag}_{name}" for name in written}
            for name in sorted(rbw & written):
                functional.append(
                    Assign(targets=[Name(id=mapping[name])], value=Name(id=name))
                )
            renamer = _RenameAssigned(mapping)
            functional.extend(renamer.visit(s) for s in branch)
            for name, renamed in mapping.items():
                finals.setdefault(name, [None, None])[0 if tag == "t" else 1] = renamed
        for name in sorted(finals):
            t_name, e_name = finals[name]
            functional.append(
                Assign(
                    targets=[Name(id=name)],
                    value=IfExpr(
                        cond=Name(id=cvar),
                        true_expr=Name(id=t_name or name),
                        false_expr=Name(id=e_name or name),
                    ),
                )
            )
        out.append(
            IfStmt(
                cond=Call(
                    func=Name(id="__gtx_is_plain_bool__"),
                    args=[Name(id=cvar)],
                    kwargs={},
                ),
                body=[
                    IfStmt(cond=Name(id=cvar), body=inner_body, orelse=inner_orelse)
                ],
                orelse=functional,
            )
        )
    return out


_RET_NAME = "__gtx_ret"


def _contains_return(stmts: list) -> bool:
    for st in stmts:
        if isinstance(st, Return):
            return True
        if isinstance(st, IfStmt) and (
            _contains_return(st.body) or _contains_return(st.orelse)
        ):
            return True
    return False


def _elim_block(stmts: list, cont: list) -> list:
    """Continuation-passing rewrite: every ``return x`` becomes
    ``__gtx_ret = x`` (dropping unreachable code after it), and
    statements following a conditional that may return are
    tail-duplicated into both branches so each path ends by assigning
    ``__gtx_ret``."""
    if not stmts:
        return _elim_block(cont, []) if cont else []
    st, rest = stmts[0], list(stmts[1:])
    if isinstance(st, Return):
        return [Assign(targets=[Name(id=_RET_NAME)], value=st.value)]
    if isinstance(st, IfStmt) and (
        _contains_return(st.body) or _contains_return(st.orelse)
    ):
        cont2 = rest + cont
        return [
            IfStmt(
                cond=st.cond,
                body=_elim_block(list(st.body), cont2),
                orelse=_elim_block(list(st.orelse), cont2),
            )
        ]
    return [st] + _elim_block(rest, cont)


def eliminate_early_returns(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    """Rewrite conditional returns into single-exit form (reference
    func_to_foast ast_passes handle early returns before lowering;
    here: ``return`` inside an ``if`` becomes a ``__gtx_ret``
    assignment with the continuation tail-duplicated into both
    branches, then one trailing ``return __gtx_ret``)."""
    if not any(
        isinstance(s, IfStmt)
        and (_contains_return(s.body) or _contains_return(s.orelse))
        for s in ir.body
    ):
        return ir
    body = _elim_block(list(ir.body), [])
    body.append(Return(value=Name(id=_RET_NAME)))
    return FieldOperatorDefinition(
        name=ir.name,
        params=ir.params,
        body=body,
        kwonly_params=ir.kwonly_params,
    )


def lower_if_statements(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    ir = eliminate_early_returns(ir)
    counter = [0]
    return FieldOperatorDefinition(
        name=ir.name,
        params=ir.params,
        body=_lower_if_block(ir.body, counter),
        kwonly_params=ir.kwonly_params,
    )


class _PowerUnroll(NodeTranslator):
    """``x ** n`` with a literal integral exponent 0 <= n <= 5 becomes a
    square-and-multiply chain (reference
    iterator/transforms/power_unrolling.py) — multiplications instead of
    the transcendental pow path; CSE shares the duplicated base."""

    _MAX = 5

    def visit_BinOp(self, node: BinOp, **kw: Any) -> Expr:
        node = self.generic_visit(node, **kw)
        if node.op != "**" or not isinstance(node.right, Literal):
            return node
        v = node.right.value
        if (
            isinstance(v, bool)
            or not isinstance(v, (int, float))
            or float(v) != int(v)
            or not (0 <= v <= self._MAX)
        ):
            return node
        n = int(v)
        if n == 0:
            return Literal(value=1.0)
        result: Optional[Expr] = None
        square = node.left
        while n:
            if n & 1:
                result = (
                    square
                    if result is None
                    else BinOp(op="*", left=result, right=square)
                )
            n >>= 1
            if n:
                square = BinOp(op="*", left=square, right=square)
        assert result is not None
        return result


def unroll_powers(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    return _PowerUnroll().visit(ir)


class _SubstTupleGet(NodeTranslator):
    """Replace ``t[i]`` (literal index) where ``t`` is a TupleExpr or a
    name currently bound to one."""

    def __init__(self, env: dict) -> None:
        self.env = env

    def visit_Subscript(self, node: Subscript, **kw: Any) -> Expr:
        node = self.generic_visit(node, **kw)
        tup = node.value
        if isinstance(tup, Name):
            tup = self.env.get(tup.id)
        if (
            isinstance(tup, TupleExpr)
            and isinstance(node.index, Literal)
            and isinstance(node.index.value, int)
            and not isinstance(node.index.value, bool)
            and -len(tup.elts) <= node.index.value < len(tup.elts)
        ):
            return tup.elts[node.index.value]
        return node


def _collapse_block(body: list, env: dict) -> list:
    def invalidate(name: str) -> None:
        env.pop(name, None)
        for k in [k for k, v in env.items() if name in _reads(v)]:
            env.pop(k, None)

    out = []
    for st in body:
        if isinstance(st, Assign):
            value = _SubstTupleGet(env).visit(st.value)
            names = [n for t in st.targets for n in _target_names(t)]
            for n in names:
                invalidate(n)
            if (
                len(st.targets) == 1
                and isinstance(st.targets[0], Name)
                and isinstance(value, TupleExpr)
            ):
                env[st.targets[0].id] = value
            out.append(Assign(targets=st.targets, value=value))
        elif isinstance(st, Return):
            out.append(Return(value=_SubstTupleGet(env).visit(st.value)))
        elif isinstance(st, IfStmt):
            assigned: set = set()
            for branch in (st.body, st.orelse):
                for sub in branch:
                    if isinstance(sub, Assign):
                        for t in sub.targets:
                            assigned.update(_target_names(t))
            out.append(
                IfStmt(
                    cond=_SubstTupleGet(env).visit(st.cond),
                    body=_collapse_block(st.body, dict(env)),
                    orelse=_collapse_block(st.orelse, dict(env)),
                )
            )
            for n in assigned:
                invalidate(n)
        else:
            out.append(st)
    return out


def collapse_tuple_gets(ir: FieldOperatorDefinition) -> FieldOperatorDefinition:
    """``(a, b)[i]`` — directly or through a single-assignment name —
    collapses to the element (reference collapse_tuple.py role). Name
    bindings invalidate when the name or anything its elements read is
    reassigned; the now-unused tuple assignments fall to DCE."""
    return FieldOperatorDefinition(
        name=ir.name,
        params=ir.params,
        body=_collapse_block(ir.body, {}),
        kwonly_params=ir.kwonly_params,
    )


def apply_common_transforms(
    ir: FieldOperatorDefinition,
    options: TransformOptions,
    *,
    globals_ns: dict,
    closure: dict,
    offset_provider: Optional[dict] = None,
    type_info: Any = None,
) -> tuple[FieldOperatorDefinition, Optional[dict]]:
    """Run the enabled passes; returns (ir, names-to-inject-or-None)
    (reference pass_manager.apply_common_transforms)."""
    inject: dict = {}
    if options.lower_ifs:
        ir = lower_if_statements(ir)
    if options.collapse_tuple:
        ir = collapse_tuple_gets(ir)
    if options.unroll_powers:
        ir = unroll_powers(ir)
    if options.constant_folding:
        ir = fold_constants(ir)
    if options.unroll_reduce:
        from gt4py_tpu_torch.next import type_system as ts

        param_dims: dict = dict.fromkeys(ir.all_params)  # None = dims unknown
        if type_info is not None:
            for pname, ptype in (getattr(type_info, "params", None) or {}).items():
                if pname not in param_dims:
                    continue
                if isinstance(ptype, ts.FieldType):
                    param_dims[pname] = tuple(ptype.dims)
                elif isinstance(ptype, ts.ScalarType):
                    param_dims[pname] = ()  # scalars carry no axis
        ir = unroll_reductions(
            ir,
            globals_ns=globals_ns,
            closure=closure,
            offset_provider=offset_provider,
            param_dims=param_dims,
        )
    if options.common_subexpression_elimination:
        ir = eliminate_common_subexpressions(ir)
    if options.dead_code_elimination:
        ir = eliminate_dead_code(ir)
    if options.extract_temporaries:
        ir, extra = extract_temporaries(ir)
        inject.update(extra)
    return ir, (inject or None)
