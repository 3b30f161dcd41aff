"""tests/cartesian_tests/test_gtir_pretty.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

GTIR pretty printer / parser round-trip tests (reference
tests/next_tests/unit_tests/iterator_tests/test_pretty_printer.py +
test_pretty_parser.py: the textual IR form parses back to an equal tree,
over the whole canonical stencil corpus)."""

import numpy as np
import pytest

from gt4py_tpu_torch.cartesian import frontend, gtir
from gt4py_tpu_torch.cartesian.gtir_pretty import parse, pretty, strip_locations
from tests import torch_stencil_defs as defs


def _gtir_of(name):
    entry = defs.REGISTRY[name]
    options = {
        "externals": dict(entry["externals"]),
        "dtypes": dict(entry["dtypes"]),
        "backend": "numpy",
    }
    return frontend.parse_stencil(entry["definition"], options)


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_roundtrip_frontend_gtir(name):
    stencil = _gtir_of(name)
    text = pretty(stencil)
    reparsed = parse(text)
    assert strip_locations(reparsed) == strip_locations(stencil)
    # Text fixed point: pretty is canonical.
    assert pretty(reparsed) == text


@pytest.mark.parametrize("name", sorted(defs.REGISTRY))
def test_roundtrip_analyzed_gtir(name):
    """After analysis/lowering (masks materialized, dtypes inferred,
    temporaries possibly inlined) the tree still round-trips."""
    from gt4py_tpu_torch.cartesian.passes import analyze

    entry = defs.REGISTRY[name]
    options = {
        "externals": dict(entry["externals"]),
        "dtypes": dict(entry["dtypes"]),
        "backend": "numpy",
    }
    analyzed = analyze(entry["definition"], options)
    stencil = analyzed.stencil
    text = pretty(stencil)
    reparsed = parse(text)
    assert strip_locations(reparsed) == strip_locations(stencil)
    assert pretty(reparsed) == text


def test_parse_hand_written():
    text = """
    stencil mini {
      doc "hand-written"
      external N = 3
      field a:f64
      field b:f64
      scalar w:f32
      temp t:f64
      computation(FORWARD) {
        interval(start+1, end-1) {
          t[0, 0, 0] = (a[0, 0, -1] + w:f32):f64
          b[0, 0, 0] = (t[0, 0, 0] * 2.0:f64):f64 where ((a[0, 0, 0] > 0.0:f64):b1)
        }
      }
    }
    """
    s = parse(text)
    assert s.name == "mini"
    assert s.docstring == "hand-written"
    assert s.externals == {"N": 3}
    assert [p.name for p in s.params] == ["a", "b", "w"]
    assert s.temporaries[0].name == "t"
    vloop = s.vertical_loops[0]
    assert vloop.loop_order is gtir.LoopOrder.FORWARD
    sec = vloop.sections[0]
    assert sec.interval.start.offset == 1 and sec.interval.end.offset == -1
    assign = sec.body[1]
    assert assign.mask is not None
    assert assign.value.dtype == np.dtype(np.float64)
    # And the parsed tree is stable under pretty/parse.
    assert strip_locations(parse(pretty(s))) == strip_locations(s)


def test_parse_variable_and_absolute_k():
    text = """
    stencil koff {
      field a:f64
      field idx:i64
      field out:f64
      computation(PARALLEL) {
        interval(start, end) {
          out[0, 0, 0] = (a[0, 0, ^((idx[0, 0, 0] % 2:i64):i64)] + a[0, 0, @(0:i64)]):f64
        }
      }
    }
    """
    s = parse(text)
    value = s.vertical_loops[0].sections[0].body[0].value
    assert value.left.koffset is not None
    assert value.right.abs_k is not None
    assert strip_locations(parse(pretty(s))) == strip_locations(s)


def test_parse_data_dims_and_regions():
    text = """
    stencil dd {
      field vec:f64 data[3]
      field out:f64
      computation(PARALLEL) {
        interval(start, end) {
          out[0, 0, 0] = vec[0, 0, 0]{1:i64} @region(i=[start+1, end-1], j=[*, end])
        }
      }
    }
    """
    s = parse(text)
    assign = s.vertical_loops[0].sections[0].body[0]
    assert assign.value.data_index
    (mask,) = assign.horizontal_masks
    assert mask.i.start.offset == 1
    assert mask.j.start is None
    assert strip_locations(parse(pretty(s))) == strip_locations(s)


def test_unary_over_literal_roundtrips():
    e = gtir.UnaryOp(
        op=gtir.UnaryOperator.NEG,
        expr=gtir.Literal(value=4.0, dtype=np.dtype(np.float64)),
        dtype=np.dtype(np.float64),
    )
    s = gtir.Stencil(
        name="u",
        params=[gtir.FieldDecl(name="o", dtype=np.dtype(np.float64))],
        vertical_loops=[
            gtir.VerticalLoop(
                loop_order=gtir.LoopOrder.PARALLEL,
                sections=[
                    gtir.VerticalSection(
                        interval=gtir.Interval.full(),
                        body=[
                            gtir.Assign(
                                target=gtir.FieldAccess(name="o"), value=e
                            )
                        ],
                    )
                ],
            )
        ],
    )
    assert strip_locations(parse(pretty(s))) == strip_locations(s)


def test_parse_errors_are_informative():
    with pytest.raises(SyntaxError, match="nexpected|xpected"):
        parse("stencil x {")
    with pytest.raises(SyntaxError):
        parse("stencil x { bogus }")


def test_stencil_object_pretty_ir():
    from gt4py_tpu_torch.cartesian import gtscript

    st = gtscript.stencil(
        backend="numpy", definition=defs.REGISTRY["copy_stencil"]["definition"]
    )
    text = st.pretty_ir()
    assert text.startswith("stencil copy_stencil")
    assert strip_locations(parse(text)) == strip_locations(st._analyzed.stencil)
