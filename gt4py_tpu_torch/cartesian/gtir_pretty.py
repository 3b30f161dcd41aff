"""GTIR pretty printer and parser (textual IR round-trip).

Copied from gt4py_tpu/cartesian/gtir_pretty.py; imports renamed.

Role of the reference's ITIR pretty printer/parser pair
(src/gt4py/next/iterator/pretty_printer.py and
pretty_parser.py, with round-trip property tests in
tests/next_tests/unit_tests/iterator_tests/test_pretty_{printer,parser}.py):
a stable, human-readable text form of the compiler IR that parses back to
a structurally-equal tree. Used for golden tests, IR snapshots in bug
reports, and hand-authoring small IRs in tests without the frontend.

Here the IR is the cartesian GTIR (gtir.py). Grammar highlights::

    stencil lap {
      doc "..."
      external ALPHA = 0.25
      field in: f64                  # dims(I,K) masks lower-dim fields
      field vec: f64 data[3]
      table tab: f64 shape[4, 4]
      scalar w: f32
      temp lapt: f64
      computation(PARALLEL) {
        interval(start, end) {
          lapt[0, 0, 0] = ((-4.0:f64 * in[0, 0, 0]):f64 + in[1, 0, 0]):f64
          out[0, 0, 0] = expr where (mask_expr) @region(i=[start+1, end-1], j=[*, *])
        }
      }
    }

Expressions are fully parenthesized (binary/ternary in parens, ``:dt``
dtype suffixes); field K access variants: ``f[0, 0, ^(e)]`` variable K
offset, ``f[0, 0, @(e)]`` absolute K index, ``f[0, 0, 0]{e}`` data-dim
subscripts. The parser produces ``loc=None`` everywhere; compare trees
with :func:`strip_locations`.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.core.definitions import as_dtype, dtype_name


__all__ = ["pretty", "parse", "strip_locations"]


# --- dtype codes -------------------------------------------------------------

_DT2CODE = {
    "float16": "f16", "bfloat16": "bf16", "float32": "f32", "float64": "f64",
    "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
    "uint8": "u8", "uint16": "u16", "uint32": "u32", "uint64": "u64",
    "bool": "b1",
}
_CODE2DT = {v: as_dtype(k) for k, v in _DT2CODE.items()}


def _dt(dtype: Optional[np.dtype]) -> str:
    if dtype is None:
        return ""
    return ":" + _DT2CODE.get(dtype_name(dtype), np.dtype(dtype).str)


# --- pretty printer ----------------------------------------------------------


def _lit_value(v: Any) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "True" if v else "False"
    if isinstance(v, (int, np.integer)):
        return repr(int(v))
    f = float(v)
    if f != f:
        return "__nan__"  # names like 'inf'/'nan' stay usable as fields
    if f in (float("inf"), float("-inf")):
        return ("-" if f < 0 else "") + "1e999"
    return repr(f)


def _expr(e: gtir.Expr) -> str:
    if isinstance(e, gtir.Literal):
        return f"{_lit_value(e.value)}{_dt(e.dtype)}"
    if isinstance(e, gtir.ScalarAccess):
        return f"{e.name}{_dt(e.dtype)}"
    if isinstance(e, gtir.FieldAccess):
        i, j, k = e.offset
        if e.koffset is not None:
            kpart = f"^({_expr(e.koffset)})"
        elif e.abs_k is not None:
            kpart = f"@({_expr(e.abs_k)})"
        else:
            kpart = str(k)
        data = ""
        if e.data_index:
            data = "{" + ", ".join(_expr(d) for d in e.data_index) + "}"
        return f"{e.name}[{i}, {j}, {kpart}]{data}{_dt(e.dtype)}"
    if isinstance(e, gtir.UnaryOp):
        return f"({e.op.value} {_expr(e.expr)}){_dt(e.dtype)}"
    if isinstance(e, gtir.BinaryOp):
        return f"({_expr(e.left)} {e.op.value} {_expr(e.right)}){_dt(e.dtype)}"
    if isinstance(e, gtir.TernaryOp):
        return (
            f"({_expr(e.cond)} ? {_expr(e.true_expr)} : {_expr(e.false_expr)})"
            f"{_dt(e.dtype)}"
        )
    if isinstance(e, gtir.NativeFuncCall):
        args = ", ".join(_expr(a) for a in e.args)
        return f"{e.func.value}({args}){_dt(e.dtype)}"
    if isinstance(e, gtir.Cast):
        return f"cast<{_dt(e.dtype)[1:]}>({_expr(e.expr)})"
    if isinstance(e, gtir.IteratorAccess):
        return f"__{e.axis}__{_dt(e.dtype)}"
    raise TypeError(f"Cannot pretty-print expression {type(e).__name__}")


def _bound(b: Optional[gtir.AxisBound]) -> str:
    if b is None:
        return "*"
    base = b.level.value  # 'start' | 'end'
    if b.offset == 0:
        return base
    return f"{base}{b.offset:+d}"


def _hmask(m: gtir.HorizontalMask) -> str:
    return (
        f"@region(i=[{_bound(m.i.start)}, {_bound(m.i.end)}], "
        f"j=[{_bound(m.j.start)}, {_bound(m.j.end)}])"
    )


def _stmt(s: gtir.Stmt, ind: str) -> list[str]:
    if isinstance(s, gtir.Assign):
        line = f"{ind}{_expr(s.target)} = {_expr(s.value)}"
        if s.mask is not None:
            line += f" where ({_expr(s.mask)})"
        for m in s.horizontal_masks:
            line += f" {_hmask(m)}"
        return [line]
    if isinstance(s, gtir.If):
        kw = "sif" if s.is_scalar else "if"
        out = [f"{ind}{kw} ({_expr(s.cond)}) {{"]
        for b in s.body:
            out += _stmt(b, ind + "  ")
        if s.orelse:
            out.append(f"{ind}}} else {{")
            for b in s.orelse:
                out += _stmt(b, ind + "  ")
        out.append(f"{ind}}}")
        return out
    if isinstance(s, gtir.While):
        line = f"{ind}while ({_expr(s.cond)})"
        if s.mask is not None:
            line += f" where ({_expr(s.mask)})"
        for m in s.horizontal_masks:
            line += f" {_hmask(m)}"
        out = [line + " {"]
        for b in s.body:
            out += _stmt(b, ind + "  ")
        out.append(f"{ind}}}")
        return out
    if isinstance(s, gtir.HorizontalRestriction):
        out = [f"{ind}restrict {_hmask(s.mask)} {{"]
        for b in s.body:
            out += _stmt(b, ind + "  ")
        out.append(f"{ind}}}")
        return out
    raise TypeError(f"Cannot pretty-print statement {type(s).__name__}")


def pretty(stencil: gtir.Stencil) -> str:
    """Render a GTIR stencil to its canonical text form."""
    lines = [f"stencil {stencil.name} {{"]
    if stencil.docstring:
        lines.append(f'  doc {stencil.docstring!r}')
    for k, v in stencil.externals.items():
        try:
            text = repr(v)
            import ast as _ast

            _ast.literal_eval(text)
        except Exception:
            continue  # non-literal externals are already inlined in the IR
        lines.append(f"  external {k} = {text}")
    for p in stencil.params:
        if isinstance(p, gtir.FieldDecl):
            line = f"  field {p.name}{_dt(p.dtype)}"
            if p.dimensions != (True, True, True):
                dims = ", ".join(d for d, m in zip("IJK", p.dimensions) if m)
                line += f" dims({dims})"
            if p.data_dims:
                line += f" data[{', '.join(map(str, p.data_dims))}]"
            lines.append(line)
        elif isinstance(p, gtir.GlobalTableDecl):
            lines.append(
                f"  table {p.name}{_dt(p.dtype)} shape[{', '.join(map(str, p.shape))}]"
            )
        elif isinstance(p, gtir.ScalarDecl):
            lines.append(f"  scalar {p.name}{_dt(p.dtype)}")
        else:
            raise TypeError(f"Cannot pretty-print decl {type(p).__name__}")
    for t in stencil.temporaries:
        line = f"  temp {t.name}{_dt(t.dtype)}"
        if t.data_dims:
            line += f" data[{', '.join(map(str, t.data_dims))}]"
        lines.append(line)
    for vloop in stencil.vertical_loops:
        lines.append(f"  computation({vloop.loop_order.name}) {{")
        for sec in vloop.sections:
            lines.append(
                f"    interval({_bound(sec.interval.start)}, {_bound(sec.interval.end)}) {{"
            )
            for s in sec.body:
                lines += _stmt(s, "      ")
            lines.append("    }")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


# --- tokenizer ---------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<string>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<number>[0-9]+(?:\.[0-9]*)?(?:[eE][+-]?[0-9]+)?|\.[0-9]+(?:[eE][+-]?[0-9]+)?)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<sym>\*\*|==|!=|<=|>=|[-+*/%@<>=?:(){}\[\],^])
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(f"Cannot tokenize at: {text[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


_BINOPS = {
    **{op.value: op for op in gtir.ArithmeticOperator},
    **{op.value: op for op in gtir.ComparisonOperator},
    **{op.value: op for op in gtir.LogicalOperator},
}
_NATIVE = {f.value: f for f in gtir.NativeFunction}


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> tuple[str, str]:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> None:
        kind, tok = self.next()
        if tok != value:
            raise SyntaxError(f"Expected {value!r}, got {tok!r}")

    def accept(self, value: str) -> bool:
        if self.peek()[1] == value:
            self.i += 1
            return True
        return False

    def name(self) -> str:
        kind, tok = self.next()
        if kind != "name":
            raise SyntaxError(f"Expected a name, got {tok!r}")
        return tok

    # -- dtype suffix ------------------------------------------------------

    def dtype_suffix(self) -> Optional[np.dtype]:
        if self.peek()[1] == ":" and self.peek(1)[0] == "name":
            code = self.peek(1)[1]
            if code in _CODE2DT:
                self.i += 2
                return _CODE2DT[code]
        return None

    def dtype_code(self) -> np.dtype:
        code = self.name()
        if code not in _CODE2DT:
            raise SyntaxError(f"Unknown dtype code {code!r}")
        return _CODE2DT[code]

    # -- expressions -------------------------------------------------------

    def expr(self) -> gtir.Expr:
        kind, tok = self.peek()
        if tok == "(":
            return self.paren_expr()
        if kind == "number" or (tok in "+-" and self.peek(1)[0] == "number"):
            return self.literal()
        if tok in ("True", "False"):
            self.next()
            dtype = self.dtype_suffix() or np.dtype(bool)
            return gtir.Literal(value=(tok == "True"), dtype=dtype)
        if tok == "__nan__":
            self.next()
            return gtir.Literal(value=float("nan"), dtype=self.dtype_suffix())
        if tok == "__K__":
            self.next()
            return gtir.IteratorAccess(axis="K", dtype=self.dtype_suffix())
        if kind == "name":
            if tok == "cast" and self.peek(1)[1] == "<":
                self.next()
                self.expect("<")
                dtype = self.dtype_code()
                self.expect(">")
                self.expect("(")
                inner = self.expr()
                self.expect(")")
                return gtir.Cast(dtype=dtype, expr=inner)
            if tok in _NATIVE and self.peek(1)[1] == "(":
                self.next()
                self.expect("(")
                args = [self.expr()]
                while self.accept(","):
                    args.append(self.expr())
                self.expect(")")
                return gtir.NativeFuncCall(
                    func=_NATIVE[tok], args=args, dtype=self.dtype_suffix()
                )
            if self.peek(1)[1] == "[":
                return self.field_access()
            self.next()
            return gtir.ScalarAccess(name=tok, dtype=self.dtype_suffix())
        raise SyntaxError(f"Unexpected token {tok!r} in expression")

    def literal(self) -> gtir.Literal:
        sign = 1.0
        if self.peek()[1] in "+-":
            sign = -1.0 if self.next()[1] == "-" else 1.0
        kind, tok = self.next()
        assert kind == "number"
        if re.fullmatch(r"[0-9]+", tok):
            value: Any = int(tok) * (int(sign))
        else:
            value = float(tok) * sign
        dtype = self.dtype_suffix()
        return gtir.Literal(value=value, dtype=dtype)

    def int_tok(self) -> int:
        neg = self.accept("-")
        kind, tok = self.next()
        if kind != "number" or not re.fullmatch(r"[0-9]+", tok):
            raise SyntaxError(f"Expected an integer, got {tok!r}")
        return -int(tok) if neg else int(tok)

    def field_access(self) -> gtir.FieldAccess:
        fname = self.name()
        self.expect("[")
        i = self.int_tok()
        self.expect(",")
        j = self.int_tok()
        self.expect(",")
        koffset = abs_k = None
        k = 0
        if self.accept("^"):
            self.expect("(")
            koffset = self.expr()
            self.expect(")")
        elif self.accept("@"):
            self.expect("(")
            abs_k = self.expr()
            self.expect(")")
        else:
            k = self.int_tok()
        self.expect("]")
        data: tuple[gtir.Expr, ...] = ()
        if self.accept("{"):
            items = [self.expr()]
            while self.accept(","):
                items.append(self.expr())
            self.expect("}")
            data = tuple(items)
        return gtir.FieldAccess(
            name=fname,
            offset=(i, j, k),
            koffset=koffset,
            abs_k=abs_k,
            data_index=data,
            dtype=self.dtype_suffix(),
        )

    def paren_expr(self) -> gtir.Expr:
        self.expect("(")
        kind, tok = self.peek()
        if tok == "not" or (tok in "+-" and self.peek(1)[0] != "number"):
            op = {u.value: u for u in gtir.UnaryOperator}[self.next()[1]]
            inner = self.expr()
            self.expect(")")
            return gtir.UnaryOp(op=op, expr=inner, dtype=self.dtype_suffix())
        signed = tok in "+-"  # leading sign over a number literal
        left = self.expr()
        kind, tok = self.peek()
        if tok == ")":
            self.next()
            if signed and isinstance(left, gtir.Literal):
                # '(- 4.0)' is a printed UnaryOp over a literal (pretty
                # never parenthesizes a bare literal); undo the sign fold.
                op = (
                    gtir.UnaryOperator.NEG
                    if (isinstance(left.value, (int, float)) and left.value < 0)
                    or str(left.value).startswith("-")
                    else gtir.UnaryOperator.POS
                )
                mag = abs(left.value) if op is gtir.UnaryOperator.NEG else left.value
                return gtir.UnaryOp(
                    op=op,
                    expr=gtir.Literal(value=mag, dtype=left.dtype),
                    dtype=self.dtype_suffix(),
                )
            return left
        if tok == "?":
            self.next()
            true_e = self.expr()
            self.expect(":")
            false_e = self.expr()
            self.expect(")")
            return gtir.TernaryOp(
                cond=left, true_expr=true_e, false_expr=false_e,
                dtype=self.dtype_suffix(),
            )
        if tok in _BINOPS:
            self.next()
            right = self.expr()
            self.expect(")")
            return gtir.BinaryOp(
                op=_BINOPS[tok], left=left, right=right, dtype=self.dtype_suffix()
            )
        raise SyntaxError(f"Unexpected token {tok!r} inside parentheses")

    # -- bounds / masks ----------------------------------------------------

    def bound(self) -> Optional[gtir.AxisBound]:
        if self.accept("*"):
            return None
        base = self.name()
        if base not in ("start", "end"):
            raise SyntaxError(f"Expected start/end, got {base!r}")
        level = gtir.LevelMarker.START if base == "start" else gtir.LevelMarker.END
        offset = 0
        if self.peek()[1] in "+-":
            sign = -1 if self.next()[1] == "-" else 1
            offset = sign * self.int_tok()
        return gtir.AxisBound(level=level, offset=offset)

    def hmask(self) -> gtir.HorizontalMask:
        # '@' already consumed by caller
        kw = self.name()
        if kw != "region":
            raise SyntaxError(f"Expected region, got {kw!r}")
        self.expect("(")
        self.expect("i")
        self.expect("=")
        self.expect("[")
        i_start = self.bound()
        self.expect(",")
        i_end = self.bound()
        self.expect("]")
        self.expect(",")
        self.expect("j")
        self.expect("=")
        self.expect("[")
        j_start = self.bound()
        self.expect(",")
        j_end = self.bound()
        self.expect("]")
        self.expect(")")
        return gtir.HorizontalMask(
            i=gtir.HorizontalInterval(start=i_start, end=i_end),
            j=gtir.HorizontalInterval(start=j_start, end=j_end),
        )

    # -- statements --------------------------------------------------------

    def stmt(self) -> gtir.Stmt:
        kind, tok = self.peek()
        if tok in ("if", "sif"):
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            body = self.block()
            orelse: list[gtir.Stmt] = []
            if self.accept("else"):
                orelse = self.block()
            return gtir.If(cond=cond, body=body, orelse=orelse, is_scalar=(tok == "sif"))
        if tok == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            mask = None
            if self.accept("where"):
                self.expect("(")
                mask = self.expr()
                self.expect(")")
            masks = []
            while self.accept("@"):
                masks.append(self.hmask())
            body = self.block()
            return gtir.While(
                cond=cond, body=body, mask=mask, horizontal_masks=tuple(masks)
            )
        if tok == "restrict":
            self.next()
            self.expect("@")
            mask = self.hmask()
            body = self.block()
            return gtir.HorizontalRestriction(mask=mask, body=body)
        target = self.field_access()
        self.expect("=")
        value = self.expr()
        amask = None
        if self.accept("where"):
            self.expect("(")
            amask = self.expr()
            self.expect(")")
        amasks = []
        while self.accept("@"):
            amasks.append(self.hmask())
        return gtir.Assign(
            target=target, value=value, mask=amask, horizontal_masks=tuple(amasks)
        )

    def block(self) -> list[gtir.Stmt]:
        self.expect("{")
        out = []
        while not self.accept("}"):
            out.append(self.stmt())
        return out

    # -- top level ---------------------------------------------------------

    def stencil(self) -> gtir.Stencil:
        self.expect("stencil")
        name = self.name()
        self.expect("{")
        docstring = ""
        externals: dict = {}
        params: list[gtir.Decl] = []
        temporaries: list[gtir.Temporary] = []
        vloops: list[gtir.VerticalLoop] = []
        while not self.accept("}"):
            kind, tok = self.peek()
            if tok == "doc":
                self.next()
                k2, t2 = self.next()
                if k2 != "string":
                    raise SyntaxError("doc expects a string")
                import ast as _ast

                docstring = _ast.literal_eval(t2)
            elif tok == "external":
                self.next()
                ename = self.name()
                self.expect("=")
                start = self.i
                depth = 0
                while True:
                    k2, t2 = self.peek()
                    if depth == 0 and (
                        t2 in ("external", "field", "table", "scalar", "temp",
                               "computation", "}", "doc")
                        and k2 == "name" or t2 == "}"
                    ):
                        break
                    if t2 in "([{":
                        depth += 1
                    if t2 in ")]}":
                        depth -= 1
                    self.next()
                import ast as _ast

                text = " ".join(t for _, t in self.toks[start:self.i])
                externals[ename] = _ast.literal_eval(text)
            elif tok == "field":
                self.next()
                fname = self.name()
                dtype = self.dtype_suffix()
                dims = (True, True, True)
                data: tuple[int, ...] = ()
                if self.accept("dims"):
                    self.expect("(")
                    present = [self.name()]
                    while self.accept(","):
                        present.append(self.name())
                    self.expect(")")
                    dims = tuple(ax in present for ax in "IJK")  # type: ignore[assignment]
                if self.accept("data"):
                    self.expect("[")
                    items = [self.int_tok()]
                    while self.accept(","):
                        items.append(self.int_tok())
                    self.expect("]")
                    data = tuple(items)
                params.append(
                    gtir.FieldDecl(name=fname, dtype=dtype, dimensions=dims, data_dims=data)
                )
            elif tok == "table":
                self.next()
                tname = self.name()
                dtype = self.dtype_suffix()
                self.expect("shape")
                self.expect("[")
                shape = [self.int_tok()]
                while self.accept(","):
                    shape.append(self.int_tok())
                self.expect("]")
                params.append(
                    gtir.GlobalTableDecl(name=tname, dtype=dtype, shape=tuple(shape))
                )
            elif tok == "scalar":
                self.next()
                sname = self.name()
                dtype = self.dtype_suffix()
                params.append(gtir.ScalarDecl(name=sname, dtype=dtype))
            elif tok == "temp":
                self.next()
                tname = self.name()
                dtype = self.dtype_suffix()
                data = ()
                if self.accept("data"):
                    self.expect("[")
                    items = [self.int_tok()]
                    while self.accept(","):
                        items.append(self.int_tok())
                    self.expect("]")
                    data = tuple(items)
                temporaries.append(
                    gtir.Temporary(name=tname, dtype=dtype, data_dims=data)
                )
            elif tok == "computation":
                self.next()
                self.expect("(")
                order = gtir.LoopOrder[self.name()]
                self.expect(")")
                self.expect("{")
                sections = []
                while not self.accept("}"):
                    self.expect("interval")
                    self.expect("(")
                    b_start = self.bound()
                    self.expect(",")
                    b_end = self.bound()
                    self.expect(")")
                    assert b_start is not None and b_end is not None
                    body = self.block()
                    sections.append(
                        gtir.VerticalSection(
                            interval=gtir.Interval(start=b_start, end=b_end), body=body
                        )
                    )
                vloops.append(gtir.VerticalLoop(loop_order=order, sections=sections))
            else:
                raise SyntaxError(f"Unexpected token {tok!r} at stencil scope")
        return gtir.Stencil(
            name=name,
            params=params,
            vertical_loops=vloops,
            temporaries=temporaries,
            externals=externals,
            docstring=docstring,
        )


def parse(text: str) -> gtir.Stencil:
    """Parse the canonical text form back into a GTIR stencil."""
    p = _Parser(text)
    s = p.stencil()
    if p.peek()[0] != "eof":
        raise SyntaxError(f"Trailing input: {p.peek()[1]!r}")
    return s


def strip_locations(node: Any) -> Any:
    """Set every ``loc`` field to None, in place (parser output carries no
    source locations); returns the node for chaining."""
    from gt4py_tpu_torch.eve.concepts import Node

    def walk(n: Any) -> None:
        if isinstance(n, Node):
            if hasattr(n, "loc"):
                n.loc = None
            for _, child in n.iter_children_items():
                walk(child)
        elif isinstance(n, (list, tuple)):
            for c in n:
                walk(c)
        elif isinstance(n, dict):
            for c in n.values():
                walk(c)

    walk(node)
    return node
