"""The ``torch`` backend's CUDA graphs: the counterpart of the JAX package's
jit (gt4py_tpu/next/backend.py:144-150, decorators.py:111-177, 533-565,
711-741, 1045-1159).

Here there is no card. Most tests run the graph path on CPU tensors
through a stand-in for the card (the ``fake_card`` fixture): every device
counts as a card, a "capture" keeps the body, and a "replay" runs the body
again, checking that it reads the very connectivity indices the first
replay read, as a graph's baked addresses would. That drives the variant
key, the per-operator bound, the counters, every refusal and the inline
path through the decorators as the card does; what a capture records, and
that it does not run the Python again, only the card shows. The inputs are made from a seed
with NumPy and the results held against the port's eager path (to the
bit), its ``numpy`` backend and the JAX package's ``jax`` backend (rtol
1e-12 in float64).

Tests marked ``cuda`` run the graphs on a card and skip without one.
"""

import contextlib
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import backend as port_backend
from gt4py_tpu_torch.next import embedded, otf

from . import torch_cases as tcases
from . import torch_feature_defs as fdefs
from . import torch_next_defs as defs

I = defs.IDim  # noqa: E741
K = defs.KDim
RTOL = 1e-12


# --- the stand-in for the card ---------------------------------------------------------


class _FakeStream:
    cuda_stream = 1

    def wait_stream(self, other):
        pass


#: the connectivity indices read since the list was set (``_reading``)
_READ: list = []


def _reading(device_index):
    def read(conn, device):
        idx = device_index(conn, device)
        _READ.append(idx)
        return idx

    return read


class _FakeGraph:
    """A "graph": its replay runs the captured body again. A real graph
    reads the addresses its capture baked in, so every replay must read the
    very index tensors the first one read (kept alive by ``keeps``, not by
    the stand-in: it holds them weakly)."""

    def __init__(self, body, keeps):
        self.body = body
        self.keeps = keeps
        self.read = None

    def replay(self):
        _READ.clear()
        self.body()
        if self.read is None:
            assert all(any(t is k for k in self.keeps) for t in _READ)
            self.read = [weakref.ref(t) for t in _READ]
        else:
            assert len(self.read) == len(_READ) and all(
                r() is t for r, t in zip(self.read, _READ)), "a replay read another index"

    def retire(self):
        pass


def _fake_capture(device, stream, body, keeps):
    return _FakeGraph(body, keeps)


def _reset_counts():
    for counter in otf.COUNTERS:
        counter.clear()


@pytest.fixture
def fake_card(monkeypatch):
    """The graph path on CPU tensors (see the module's docstring); the
    counters set to 0."""
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    monkeypatch.setattr(otf, "_stream", lambda device: _FakeStream())
    monkeypatch.setattr(otf, "capture", _fake_capture)
    monkeypatch.setattr(embedded, "device_index", _reading(embedded.device_index))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _reset_counts()
    yield
    _reset_counts()


def _counts():
    """(first calls, captures, replays, refusals), each by entry point or reason."""
    return tuple(dict(c) for c in otf.COUNTERS)


def _field(data, dims=(I,), start=0):
    return gtx.as_field(gtx.domain({d: (start, start + n) for d, n in zip(dims, data.shape)}),
                        data, device="cpu")


@gtx.field_operator
def _axpy(a, b, alpha: float):
    return alpha * a + b


def _axpy_inputs(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return _field(rng.random(n)), _field(rng.random(n)), gtx.zeros({I: n}, device="cpu")


# --- the variant key ----------------------------------------------------------------


def _key(*trees, provider=None):
    return otf.graph_key(trees, provider)


def test_key_follows_pointers(monkeypatch):
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    a, b, out = _axpy_inputs()
    same = gtx.Field(a.domain, a.ndarray)  # another Field over the same tensor
    twin = _field(a.asnumpy())  # the same values in another tensor
    assert _key(a, out)[0] == _key(same, out)[0]
    assert _key(a, out)[0] != _key(twin, out)[0]
    assert _key(a, out)[1:] == (torch.device("cpu"), None, [])


def test_key_follows_strides_and_offset(monkeypatch):
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    base = torch.arange(12.0)
    rows = gtx.Field(gtx.domain({I: 3, K: 4}), base.view(3, 4))
    cols = gtx.Field(gtx.domain({I: 3, K: 4}), base.as_strided((3, 4), (1, 3)))
    assert rows.ndarray.data_ptr() == cols.ndarray.data_ptr()
    assert _key(rows)[0] != _key(cols)[0]
    head = gtx.Field(gtx.domain({I: 3}), base[:3])
    tail = gtx.Field(gtx.domain({I: 3}), base.as_strided((3,), (1,), 1))
    assert _key(head)[0] != _key(tail)[0]


def test_key_follows_out_geometry(monkeypatch):
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    data = torch.zeros(6, dtype=torch.float64)
    at0 = gtx.Field(gtx.domain({I: (0, 6)}), data)
    at2 = gtx.Field(gtx.domain({I: (2, 8)}), data)
    assert _key(at0)[0] != _key(at2)[0]
    dom = gtx.domain({I: (1, 4)})
    assert _key(at0, None)[0] != _key(at0, dom)[0]


@pytest.mark.parametrize("pair", [
    (2.0, 3.0), (0.0, -0.0), (1, 1.0), (1, True), (np.float32(1), np.float64(1)),
    (np.int32(1), np.int64(1)), ((1.0, 2.0), (1.0, 2.5)),
], ids=str)
def test_key_follows_scalar_values(pair, monkeypatch):
    """Scalars are baked into a graph: each value and type its own key."""
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    a, _, _ = _axpy_inputs()
    assert _key(a, pair[0])[0] != _key(a, pair[1])[0]
    assert _key(a, pair[0])[0] == _key(a, pair[0])[0]


def test_key_holds_nan_by_its_bits(monkeypatch):
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    a, _, _ = _axpy_inputs()
    assert _key(a, float("nan"))[0] == _key(a, float("nan"))[0]


def _toy_provider(v2e=None):
    e2v, v2e_default = defs.toy_mesh_tables()
    return {
        "E2V": gtx.as_connectivity([defs.Edge, defs.E2VDim], defs.Vertex, e2v, device="cpu"),
        "V2E": gtx.as_connectivity([defs.Vertex, defs.V2EDim], defs.Edge,
                                   v2e_default if v2e is None else v2e, device="cpu"),
    }


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32], ids=str)
def test_key_follows_the_provider(dtype, monkeypatch):
    """The provider's fingerprint (its tables' contents) and the address of
    each connectivity's int64 index, which the key's graph keeps: a
    rebound table is a new key; a table rewritten in place is the same
    key where the graph reads the table itself (int64 on the call's
    device), else a new one (cast anew)."""
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    a, _, _ = _axpy_inputs()
    prov = _toy_provider()
    for conn in prov.values():
        conn.table = conn.table.to(dtype)
    key, _, _, keeps = _key(a, provider=prov)
    assert [t.dtype for t in keeps] == [torch.int64] * 2
    assert (keeps[1] is prov["V2E"].table) == (dtype == torch.int64)
    assert _key(a, provider=prov)[0] == key
    _, v2e = defs.toy_mesh_tables()
    assert _key(a, provider=_toy_provider(v2e[:, ::-1].copy()))[0] != key
    prov["V2E"].table = prov["V2E"].table.clone()
    rebound, _, _, keeps = _key(a, provider=prov)
    assert rebound != key
    prov["V2E"].table[0, 0] = prov["V2E"].table[0, 0]
    assert (_key(a, provider=prov)[0] == rebound) == (dtype == torch.int64)


def test_key_on_cpu_tensors_names_no_device():
    a, b, out = _axpy_inputs()
    assert _key(a, b, out)[1:] == (None, None, [])


# --- the refusals -------------------------------------------------------------------


class _Unkeyable:
    __hash__ = None


class _ShardedConn(gtx.Connectivity):
    """A connectivity with ``sharded_gather``, as DistributedUnstructured's
    shards have: here it gathers its own table."""

    def sharded_gather(self, arr, column):
        idx = self.table if column is None else self.table[:, column]
        return arr[idx.clamp(min=0)]


@pytest.mark.parametrize("reason", ["devices", "host_array", "unkeyed", "sharded"])
def test_key_refusals(reason, monkeypatch):
    """Each reason a call with card tensors is refused, known from its
    arguments and provider (here a ``meta`` tensor stands for the card)."""
    monkeypatch.setattr(otf, "on_card", lambda device: device.type == "meta")
    card = gtx.Field(gtx.domain({I: 8}), torch.empty(8, device="meta"))
    trees, provider, expected = (card,), None, otf.REFUSED_DEVICES
    if reason == "devices":
        trees = (card, torch.zeros(3))
    elif reason == "host_array":
        trees = (card, np.ones(3))
    elif reason == "unkeyed":
        trees, expected = (card, _Unkeyable()), otf.REFUSED_UNKEYED
    else:
        e2v, _ = defs.toy_mesh_tables()
        provider = {"E2V": _ShardedConn(torch.as_tensor(e2v), domain_dims=(defs.Edge, defs.E2VDim),
                                        codomain=defs.Vertex)}
        expected = otf.REFUSED_SHARDED
    assert _key(card, provider=provider)[1:3] == (torch.device("meta"),
                                                  expected if reason == "sharded" else None)
    key, device, refusal, _ = _key(*trees, provider=provider)
    assert device == torch.device("meta") and refusal == expected


def test_enable_jit_false_refuses_on_the_card(fake_card):
    a, b, out = _axpy_inputs()
    op = _axpy.with_compilation_options(enable_jit=False)
    op(a, b, 2.0, out=out, offset_provider={})
    op(a, b, 2.0, out=out, offset_provider={})
    assert _counts() == ({}, {}, {}, {otf.REFUSED_OPTIONS: 2})
    assert len(op._pool) == 0 and "_graphs" not in op.__dict__
    np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())


def test_compile_step_of_the_users_own_is_refused(fake_card):
    """A Backend.replace with a compile step of the user's own stays live,
    eager and counted, as the JAX package's default_pipeline test keeps
    it (gt4py_tpu/next/decorators.py:543-547)."""
    steps = []

    def own_compile(job):
        steps.append(job)
        return port_backend._compile_eager(job)

    base = gtx.resolve_backend("torch")
    custom = base.replace(name="torch:own", transforms=base.transforms.replace(compile=own_compile))
    a, b, out = _axpy_inputs()
    _axpy.with_backend(custom)(a, b, 2.0, out=out, offset_provider={})
    assert steps and _counts() == ({}, {}, {}, {otf.REFUSED_COMPILE_STEP: 1})
    np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())


def test_sharded_connectivity_is_refused(fake_card):
    e2v, v2e = defs.toy_mesh_tables()
    sharded = {"V2E": _ShardedConn(torch.as_tensor(v2e), domain_dims=(defs.Vertex, defs.V2EDim),
                                   codomain=defs.Edge)}
    rng = np.random.default_rng(3)
    e = _field(rng.random(18), (defs.Edge,))
    out = gtx.zeros({defs.Vertex: 9}, device="cpu")
    defs.edge_sum(e, out=out, offset_provider=sharded)
    assert _counts() == ({}, {}, {}, {otf.REFUSED_SHARDED: 1})
    np.testing.assert_allclose(out.asnumpy(), e.asnumpy()[v2e].sum(axis=1), rtol=RTOL)


def test_every_refusal_is_named():
    assert len(set(otf.REFUSALS)) == len(otf.REFUSALS) == 5
    assert all(isinstance(r, str) and r for r in otf.REFUSALS)


# --- the graph path through the decorators --------------------------------------------


def test_cpu_tensors_run_eagerly():
    """Without a card nothing is captured, replayed or refused."""
    _reset_counts()
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    op(a, b, 2.0, out=out, offset_provider={})
    assert _counts() == ({}, {}, {}, {}) and "_graphs" not in op.__dict__
    assert isinstance(op._pool.peek((a, b, 2.0), {}, {}), otf.GraphExecutable)
    np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())


def test_a_warm_call_is_one_replay(fake_card):
    """A key's first call runs eagerly, its second captures and replays,
    every later one replays."""
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    for _ in range(4):
        op(a, b, 2.0, out=out, offset_provider={})
    assert _counts() == ({"field_operator": 1}, {"field_operator": 1}, {"field_operator": 3}, {})
    op(a, b, 3.0, out=out, offset_provider={})  # another scalar: another key, run eagerly
    op(a, b, 3.0, out=out, offset_provider={})  # then its graph
    assert otf.graphs_captured["field_operator"] == 2 and len(op._graphs) == 2
    np.testing.assert_array_equal(out.asnumpy(), 3.0 * a.asnumpy() + b.asnumpy())


def test_new_pointers_capture_anew(fake_card):
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    for _ in range(2):
        op(a, b, 2.0, out=out, offset_provider={})
    a2, b2, out2 = _axpy_inputs(seed=1)
    for _ in range(2):
        op(a2, b2, 2.0, out=out2, offset_provider={})
    assert otf.graphs_captured["field_operator"] == 2
    np.testing.assert_array_equal(out2.asnumpy(), 2.0 * a2.asnumpy() + b2.asnumpy())


def test_a_fresh_out_field_every_call_runs_eagerly(fake_card):
    """A loop that allocates its out field every call: each call is its
    key's first, run eagerly, and nothing is captured."""
    a, b, _ = _axpy_inputs()
    op = _axpy.with_backend("torch")
    kept = []
    for _ in range(3):
        out = gtx.zeros({I: 8}, device="cpu")
        kept.append(out)  # alive: each call a new address
        op(a, b, 2.0, out=out, offset_provider={})
        np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())
    assert _counts() == ({"field_operator": 3}, {}, {}, {}) and len(op._graphs) == 0


def test_graphs_per_operator_are_bounded(fake_card):
    """At most GRAPHS_PER_OPERATOR keys, graphs and keys seen once
    together; the least recently used goes first, and its key starts over
    (an eager call, then a capture)."""
    a, b, _ = _axpy_inputs()
    outs = [gtx.zeros({I: 8}, device="cpu") for _ in range(otf.GRAPHS_PER_OPERATOR + 1)]
    op = _axpy.with_backend("torch")
    for out in outs:
        for _ in range(2):
            op(a, b, 2.0, out=out, offset_provider={})
    assert len(op._graphs) == otf.GRAPHS_PER_OPERATOR
    assert otf.graphs_captured["field_operator"] == otf.GRAPHS_PER_OPERATOR + 1
    op(a, b, 2.0, out=outs[-1], offset_provider={})  # kept: a replay
    assert otf.graphs_captured["field_operator"] == otf.GRAPHS_PER_OPERATOR + 1
    op(a, b, 2.0, out=outs[0], offset_provider={})  # evicted: eager again
    assert otf.graphs_first_calls["field_operator"] == otf.GRAPHS_PER_OPERATOR + 2
    assert len(op._graphs) == otf.GRAPHS_PER_OPERATOR - 1  # its entry took a graph's place
    op(a, b, 2.0, out=outs[0], offset_provider={})
    assert otf.graphs_captured["field_operator"] == otf.GRAPHS_PER_OPERATOR + 2
    assert len(op._graphs) == otf.GRAPHS_PER_OPERATOR


def test_a_dead_operators_graphs_wait_for_the_next_capture(fake_card):
    """The graphs of an operator that dies (the garbage collector may free
    it in the middle of another capture, which destroying a graph would
    invalidate) are kept until the next capture or replay begins."""
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    for _ in range(2):
        op(a, b, 2.0, out=out, offset_provider={})
    graph = next(iter(op._graphs._graphs.values()))
    del op
    gc.collect()
    assert any(g is graph for g in otf._RETIRED)
    other = _axpy.with_backend("torch")
    for _ in range(2):
        other(a, b, 2.0, out=out, offset_provider={})
    assert not otf._RETIRED


class _PoolGraph:
    """A stand-in for torch.cuda.CUDAGraph: its replay runs the launches."""

    def __init__(self, launches):
        self.launches = launches

    def replay(self):
        for launch in self.launches:
            launch()


def _pool_stand_ins(monkeypatch, fail=False) -> list:
    """The pools' calls to torch stood in for; returns the list of
    (pool handle, side stream) of each capture."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    handles = iter(range(1, 1000))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    captures = []

    def capture_graph(device, launches, pool=None, stream=None):
        captures.append((pool, stream))
        if fail:
            raise RuntimeError("the body's own error")
        return _PoolGraph(launches)

    monkeypatch.setattr(cuda_backend, "capture_graph", capture_graph)
    monkeypatch.setattr(otf, "on_card", lambda device: True)
    monkeypatch.setattr(otf, "_stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(otf, "_POOLS", {})
    return captures


def test_a_pool_goes_with_its_last_graph(monkeypatch):
    """The graphs of one stream share a pool, counted, and are captured on
    its one side stream (so that a capture reuses what an earlier one
    freed); when its last graph is evicted or dies with its operator, the
    pool leaves ``_POOLS`` (PyTorch frees it) and the next capture takes a
    new one."""
    captures = _pool_stand_ins(monkeypatch)
    a, b, _ = _axpy_inputs()
    outs = [gtx.zeros({I: 8}, device="cpu") for _ in range(otf.GRAPHS_PER_OPERATOR + 2)]
    op = _axpy.with_backend("torch")
    for out in outs:
        for _ in range(2):
            op(a, b, 2.0, out=out, offset_provider={})
        np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())
    (pool,) = otf._POOLS.values()
    assert pool.graphs == len(op._graphs) == otf.GRAPHS_PER_OPERATOR
    assert all(g.pool is pool for g in op._graphs._graphs.values())
    assert captures == [(pool.handle, pool.side)] * (otf.GRAPHS_PER_OPERATOR + 2)
    first = pool.handle
    del op
    gc.collect()
    assert otf._POOLS == {} and pool.graphs == 0
    other = _axpy.with_backend("torch")
    for _ in range(2):
        other(a, b, 2.0, out=outs[0], offset_provider={})
    (pool,) = otf._POOLS.values()
    assert pool.handle != first and pool.graphs == 1 and not otf._RETIRED


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises the body's error: nothing runs eagerly
    in its place, and the pool it would have opened is gone."""
    _pool_stand_ins(monkeypatch, fail=True)
    _reset_counts()
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    op(a, b, 2.0, out=out, offset_provider={})
    with pytest.raises(RuntimeError, match="the body's own error"):
        op(a, b, 2.0, out=out, offset_provider={})
    assert otf._POOLS == {} and otf.graphs_captured == {} and len(op._graphs) == 0


class _CapturedGraph:
    """A stand-in for torch.cuda.CUDAGraph: a capture records nothing, a
    replay runs nothing."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _captures_on_cpu(monkeypatch):
    """``cuda_backend.capture_graph`` as it is, on CPU tensors: torch's
    graph, streams, pools and device guard stood in for."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CapturedGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(otf, "_POOLS", {})


def _chain_case(monkeypatch):
    """hdiff's chain on the cartesian backend, its launchers stood in for.
    Capture: ``run_steps`` of 2 steps launches the first, captures the
    cycle (one step) and replays it once; a replay: one step more."""
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    from . import torch_stencil_defs as sdefs

    backend = gtscript.stencil(backend="cuda:hopper", definition=sdefs.horizontal_diffusion,
                               rebuild=True)._backend
    backend._fns = [(lambda *a: 0, False, name) for name in backend.module.launchers]
    monkeypatch.setattr(backend, "_on_card", lambda arrays: True)
    own = {n: torch.zeros(12, 12, 4, dtype=torch.float64)
           for n in ("in_field", "out_field", "coeff")}
    plan = [{n: n for n in own}]

    def run(n):
        backend.run_steps(own, plan, {}, (8, 8, 4), {n: (2, 2, 0) for n in own}, n)
        assert backend.last_chain_mode == "graph"

    def capture():
        run(2)
        (chain,) = set(backend._chains.values())
        (graph,) = chain.graphs.values()
        return graph, len(backend.module.launchers), 1

    return cuda_backend.PLANE, capture, run


def _field_view_case(monkeypatch):
    """A field-view graph of one key (``otf.GraphCache``). Capture: the
    key's first call launches, its second captures and replays once; a
    replay: a later call."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    wrapper = cuda_backend.KernelWrapper("stand-in")
    cache, device = otf.GraphCache("field_operator"), torch.device("cuda", 0)

    def capture():
        for _ in range(2):
            cache.run("key", device, [], functools.partial(wrapper.launch, lambda: 0, ()))
        return cache.find("key", device).captured, 1, 1

    def replay(n):
        for _ in range(n):
            cache.replay(cache.find("key", device))

    return wrapper, capture, replay


def _calibration_case(monkeypatch):
    """P1's ``calibration.Chain`` of 3 launches. Capture: one launch outside
    the capture, then the 3 captured; a replay: one ``run``."""
    from gt4py_tpu_torch.cartesian.backend import calibration as cal

    monkeypatch.setattr(cal, "_functions", lambda: {"gt_probe_walk": lambda *a: 0})
    inputs = [t.as_subclass(_OnCard) for t in cal.make_inputs("probe_walk", "cpu", size=(2, 3, 8))]
    chains = []

    def capture():
        chains.append(cal.Chain("probe_walk", 3, inputs, (0, 0)))
        return chains[0].graph, 1, 0

    def replay(n):
        for _ in range(n):
            chains[0].run()

    return cal.PROBE_WALK, capture, replay


@pytest.mark.parametrize("case", [_chain_case, _field_view_case, _calibration_case],
                         ids=["chain", "field_view", "calibration"])
def test_a_replay_counts_the_kernels_its_capture_recorded(case, monkeypatch):
    """Whichever caller captures (a chain's swap cycle, a field-view graph,
    a calibration chain), a Hopper kernel launched while the graph captures
    is recorded, not counted, and ``cuda_backend.Graph.replay`` adds what
    the capture recorded to its wrapper at every replay: after the capture
    the wrapper holds the launches made outside it and those of the
    replays made since, nothing more, and n replays add n × the recorded
    launches."""
    _captures_on_cpu(monkeypatch)
    wrapper, capture, replay = case(monkeypatch)
    before = wrapper.launches
    graph, outside, replays = capture()
    assert graph.per_replay >= 1 and dict(graph.launches) == {wrapper: graph.per_replay}
    assert wrapper.launches == before + outside + replays * graph.per_replay
    for n in (1, 4):
        start = wrapper.launches
        replay(n)
        assert wrapper.launches == start + n * graph.per_replay


def test_inline_while_a_capture_is_on(fake_card, monkeypatch):
    """While the current stream captures, an operator runs inline and
    eagerly: nothing captured, replayed or refused (the JAX package's
    ``_under_trace``)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    a, b, out = _axpy_inputs()
    op = _axpy.with_backend("torch")
    op(a, b, 2.0, out=out, offset_provider={})
    defs.weighted_cumsum.with_backend("torch")(
        _field(np.ones((2, 3)), (I, K)), _field(np.ones((2, 3)), (I, K)),
        out=gtx.zeros({I: 2, K: 3}, device="cpu"), offset_provider={})
    assert _counts() == ({}, {}, {}, {}) and "_graphs" not in op.__dict__
    np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())


def test_inline_calls_block(fake_card):
    a, b, out = _axpy_inputs()
    with otf.inline_calls():
        _axpy.with_backend("torch")(a, b, 2.0, out=out, offset_provider={})
    assert _counts() == ({}, {}, {}, {})


def test_first_call_writes_its_out_field_once(fake_card):
    """A key's first call runs eagerly with its write-back, once: an
    operator reading its own out field at an offset sees it as before the
    call, and so does each later call."""
    @gtx.field_operator
    def shift_add(a):
        return a + a(defs.Ioff[1])

    data = np.arange(6.0)
    a = _field(data.copy())
    out = gtx.Field(gtx.domain({I: (0, 5)}), a.ndarray[:5])  # aliases a
    want = data.copy()
    for _ in range(3):
        shift_add(a, out=out, offset_provider=defs.PROV)
        want[:5] = want[:5] + want[1:]
        np.testing.assert_array_equal(a.asnumpy(), want)
    assert _counts()[:3] == ({"field_operator": 1}, {"field_operator": 1}, {"field_operator": 2})


_HELPER_RUNS = 0


def _count_run():
    global _HELPER_RUNS
    _HELPER_RUNS += 1
    return 1.0


@gtx.field_operator
def _through_global_writer(a):
    return a * _count_run()


def test_global_write_reaches_the_module_once(fake_card):
    """A helper's ``global`` write lands in its module once, at the first
    run of the variant (``backend._pinned``), whatever the capture and the
    replays run."""
    global _HELPER_RUNS
    _HELPER_RUNS = 0
    a, _, out = _axpy_inputs()
    op = _through_global_writer.with_backend("torch")
    for _ in range(3):
        op(a, out=out, offset_provider={})
    assert _HELPER_RUNS == 1 and otf.graphs_captured["field_operator"] == 1


def test_scan_is_one_graph(fake_card):
    """A scan with ``out`` on ``torch``: the level loop and its write-back
    one graph per variant, equal to the JAX package's jitted scan."""
    from .test_torch_next import _ref, _ref_out, _to_ref

    rng = np.random.default_rng(4)
    a = _field(rng.random((5, 7)), (I, K))
    w = _field(rng.random((5, 7)), (I, K))
    out = gtx.zeros({I: 5, K: 7}, device="cpu")
    scan = defs.weighted_cumsum.with_backend("torch")
    for _ in range(3):
        scan(a, w, out=out, offset_provider={})
    assert _counts() == ({"scan_operator": 1}, {"scan_operator": 1}, {"scan_operator": 2}, {})
    ref = _ref()
    want = _ref_out(out)
    ref.ops["weighted_cumsum"].with_backend("jax")(_to_ref(a), _to_ref(w), out=want,
                                                   offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), np.asarray(want.ndarray), rtol=RTOL)


def _lap_twice_inputs(n=8, nk=3, seed=6):
    rng = np.random.default_rng(seed)
    phi = gtx.as_field(gtx.domain({I: n + 4, defs.JDim: n + 4, K: nk}), rng.random((n + 4, n + 4, nk)),
                       device="cpu")
    tmp = gtx.zeros({I: (1, n + 3), defs.JDim: (1, n + 3), K: nk}, device="cpu")
    out = gtx.zeros({I: (2, n + 2), defs.JDim: (2, n + 2), K: nk}, device="cpu")
    return phi, tmp, out


def test_program_is_one_graph(fake_card):
    """A program of two operators: one graph, the operators inline (no
    graph of their own), equal to the JAX package's lap applied twice."""
    from .test_torch_next import _ref, _ref_out, _to_ref

    phi, tmp, out = _lap_twice_inputs()
    prog = defs.lap_twice.with_backend("torch")
    for _ in range(3):
        prog(phi, tmp, out, offset_provider=defs.PROV)
    assert _counts() == ({"program": 1}, {"program": 1}, {"program": 2}, {})
    assert "_graphs" not in defs.lap.__dict__
    ref = _ref()
    lap = ref.ops["lap"].with_backend("jax")
    rtmp, rout = _ref_out(tmp), _ref_out(out)
    lap(_to_ref(phi), out=rtmp, offset_provider=ref.prov_k)
    lap(rtmp, out=rout, offset_provider=ref.prov_k)
    np.testing.assert_allclose(out.asnumpy(), np.asarray(rout.ndarray), rtol=RTOL)


def test_program_runs_a_bridged_operator_on_the_bridge(fake_card):
    """Within a program's graph an operator of ``cuda:hopper`` still goes
    through the bridge onto the Hopper kernels (their launches captured
    with the rest; on CPU tensors the kernel's plain version): one bridged
    call a program call, the other operator inline."""
    from gt4py_tpu_torch.next import cartesian_bridge as bridge

    phi, tmp, out = _lap_twice_inputs()
    _, _, want = _lap_twice_inputs()
    served = sum(bridge.calls_served.values())
    prog = defs.lap_twice_mixed.with_backend("torch")
    for _ in range(3):
        prog(phi, tmp, out, offset_provider=defs.PROV)
    assert sum(bridge.calls_served.values()) == served + 3
    assert _counts() == ({"program": 1}, {"program": 1}, {"program": 2}, {})
    defs.lap_twice.with_backend("numpy")(phi, _lap_twice_inputs()[1], want,
                                         offset_provider=defs.PROV)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), rtol=RTOL)


@gtx.field_operator
def _inc(a):
    return a + 1.0


@gtx.program
def _inc_in_place(a):
    _inc(a, out=a)


def test_program_updating_in_place_adds_once_a_call(fake_card):
    """A program that updates a field in place adds one a call, as eagerly:
    at its first call (eager), its capture's replay and every later one."""
    a = _field(np.zeros(4))
    prog = _inc_in_place.with_backend("torch")
    for n in range(1, 4):
        prog(a, offset_provider={})
        np.testing.assert_array_equal(a.asnumpy(), np.full(4, float(n)))


def test_program_in_inline_calls_runs_eagerly(fake_card):
    """Within ``otf.inline_calls()`` a program runs eagerly, its operators
    inline: nothing captured, replayed or refused."""
    phi, tmp, out = _lap_twice_inputs()
    _, _, want = _lap_twice_inputs()
    with otf.inline_calls():
        defs.lap_twice(phi, tmp, out, offset_provider=defs.PROV)
    assert _counts() == ({}, {}, {}, {})
    defs.lap_twice.with_backend("numpy")(phi, _lap_twice_inputs()[1], want,
                                         offset_provider=defs.PROV)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), rtol=RTOL)


@pytest.mark.parametrize("renumber", [False, True], ids=["structured", "irregular"])
def test_nabla_graph_equals_eager(renumber, fake_card):
    """The FVM nabla through the graph path, equal to ``enable_jit=False``
    to the bit and to the ``numpy`` backend within rtol 1e-5 (float32)."""
    args, provider, out = defs.nabla_inputs(8, np.float32, 11, "cpu", renumber)
    _, _, eager = defs.nabla_inputs(8, np.float32, 11, "cpu", renumber)
    _, _, want = defs.nabla_inputs(8, np.float32, 11, "cpu", renumber)
    op = defs.nabla_x.with_backend("torch")
    for _ in range(3):
        op(*args, out=out, offset_provider=provider)
    defs.nabla_x.with_compilation_options(enable_jit=False)(*args, out=eager,
                                                            offset_provider=provider)
    defs.nabla_x.with_backend("numpy")(*args, out=want, offset_provider=provider)
    assert otf.graphs_captured["field_operator"] == 1
    assert torch.equal(out.ndarray, eager.ndarray)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), rtol=1e-5, atol=1e-6)


def _int32_tables():
    """Two V2E tables, int32, of different contents."""
    _, v2e = defs.toy_mesh_tables()
    return (torch.as_tensor(v2e, dtype=torch.int32),
            torch.as_tensor(v2e[:, ::-1].copy(), dtype=torch.int32))


def test_rebound_table_and_back_equals_eager(fake_card):
    """A connectivity's table rebound to another and back: every call equal
    to ``enable_jit=False`` to the bit, and every replay reads the index it
    was captured with (the stand-in checks it), which its graph keeps."""
    rng = np.random.default_rng(9)
    e = _field(rng.random(18), (defs.Edge,))
    t1, t2 = _int32_tables()
    prov = _toy_provider()
    conn = prov["V2E"]
    out = gtx.zeros({defs.Vertex: 9}, device="cpu")
    op = defs.edge_sum.with_backend("torch")
    for table in (t1, t2, t1, t2, t1):
        conn.table = table
        for _ in range(3):
            op(e, out=out, offset_provider=prov)
            want = gtx.zeros({defs.Vertex: 9}, device="cpu")
            defs.edge_sum.with_compilation_options(enable_jit=False)(e, out=want,
                                                                     offset_provider=prov)
            assert torch.equal(out.ndarray, want.ndarray)
    assert otf.graphs_replayed["field_operator"] > otf.graphs_captured["field_operator"] >= 2


def test_provider_rebuilt_from_one_int32_table_equals_eager(fake_card):
    """A provider rebuilt every call from one int32 table (a new
    connectivity, a new cast each time): every call equal to
    ``enable_jit=False`` to the bit, every replay reading its own index."""
    rng = np.random.default_rng(10)
    e = _field(rng.random(18), (defs.Edge,))
    t1, _ = _int32_tables()
    out = gtx.zeros({defs.Vertex: 9}, device="cpu")
    op = defs.edge_sum.with_backend("torch")
    for call in range(8):
        if call % 2 == 0:  # a provider serves two calls: the second captures
            prov = {"V2E": gtx.Connectivity(t1, domain_dims=(defs.Vertex, defs.V2EDim),
                                            codomain=defs.Edge)}
        op(e, out=out, offset_provider=prov)
        want = gtx.zeros({defs.Vertex: 9}, device="cpu")
        defs.edge_sum.with_compilation_options(enable_jit=False)(e, out=want, offset_provider=prov)
        assert torch.equal(out.ndarray, want.ndarray)
        np.testing.assert_allclose(out.asnumpy(), e.asnumpy()[t1.numpy()].sum(axis=1), rtol=RTOL)
    assert otf.graphs_captured["field_operator"] >= 1


# --- enable_jit=False, retargeted from tests/next_tests/test_infra.py:160-172 -----------


def _eager_calls(gtx_mod, device_kw):
    calls = []

    def defn(a):
        calls.append(1)
        return a

    op = gtx_mod.field_operator(defn).with_compilation_options(enable_jit=False)
    dim = gtx_mod.Dimension("I")
    a = gtx_mod.as_field({dim: 4}, np.zeros(4), **device_kw)
    out = gtx_mod.zeros({dim: 4}, **device_kw)
    op(a, out=out)
    op(a, out=out)
    return len(calls), len(op._pool)


def test_enable_jit_false_runs_eager_as_the_jax_package():
    """Traced per call, the pool left empty: the same counts as the JAX
    package's ``enable_jit=False``."""
    import gt4py_tpu.next as rgtx

    assert _eager_calls(gtx, {"device": "cpu"}) == _eager_calls(rgtx, {}) == (2, 0)


# --- the feature cases' pins ----------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in fdefs.CASES if n not in fdefs.RAISES])
def test_feature_case_graph_outcome_is_pinned(name, fake_card):
    """Each feature case through the graph path on the stand-in, every call
    made twice (``fdefs.second_calls``: the second captures): the outcome
    ``fdefs.graph_outcome`` pins (captured, refused by a reason, or no call
    that reaches a graph), and its result equal to the eager run's to the
    bit."""
    with otf.inline_calls():
        want = fdefs.run_case(name, "torch")
    _reset_counts()
    with fdefs.second_calls(otf):
        got = fdefs.run_case(name, "torch")
    first, captured, _, refused = _counts()
    if refused:
        outcome = "refused: " + ", ".join(sorted(refused))
    else:
        outcome = "captured" if captured else "no graph call"
    assert outcome == fdefs.graph_outcome(name)
    assert captured == first  # every key's second call captured
    flat = lambda v: [f for x in v for f in flat(x)] if isinstance(v, tuple) else [v]  # noqa: E731
    for g, w in zip(flat(got), flat(want), strict=True):
        assert torch.equal(g.ndarray, w.ndarray)


# --- embedded repairs the capture needs ------------------------------------------------


def test_connectivity_index_is_cast_once():
    """A gather casts its connectivity's table to int64 once per device,
    kept on the connectivity while the table is the same tensor at the
    same version (a column is a view of it); the result equals the plain
    gather to the bit."""
    prov = _toy_provider()
    conn = prov["V2E"]
    conn.table = conn.table.to(torch.int32)
    rng = np.random.default_rng(8)
    e = _field(rng.random(18), (defs.Edge,))
    out = gtx.zeros({defs.Vertex: 9}, device="cpu")
    defs.edge_sum.with_backend("torch")(e, out=out, offset_provider=prov)
    cached = conn.__dict__["_gt_index"][torch.device("cpu")][2]
    defs.edge_sum.with_backend("torch")(e, out=out, offset_provider=prov)
    assert conn.__dict__["_gt_index"][torch.device("cpu")][2] is cached
    assert embedded.TORCH_OPS.index(conn, 1, e.ndarray)._base is cached
    want = e.ndarray[conn.table.to(torch.int64)].sum(dim=1)
    assert torch.equal(out.ndarray, want)
    conn.table[0, 0] = conn.table[0, 1]  # rewritten in place: cast anew
    defs.edge_sum.with_backend("torch")(e, out=out, offset_provider=prov)
    assert torch.equal(out.ndarray, e.ndarray[conn.table.to(torch.int64)].sum(dim=1))
    conn.table = torch.as_tensor(defs.toy_mesh_tables()[1])  # rebound: cast anew
    defs.edge_sum.with_backend("torch")(e, out=out, offset_provider=prov)
    assert torch.equal(out.ndarray, e.ndarray[conn.table].sum(dim=1))
    import pickle

    assert "_gt_index" not in pickle.loads(pickle.dumps(conn)).__dict__


def test_connectivity_index_is_not_kept_while_capturing(monkeypatch):
    prov = _toy_provider()
    conn = prov["V2E"]
    conn.table = conn.table.to(torch.int32)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    embedded.device_index(conn, torch.device("meta"))
    assert not conn.__dict__.get("_gt_index")
    embedded.device_index(conn, torch.device("cpu"))  # not a card: kept
    assert list(conn.__dict__["_gt_index"]) == [torch.device("cpu")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                                   torch.int32, torch.int64, torch.bool], ids=str)
def test_host_scalar_moves_by_a_fill(dtype):
    """A one-value host tensor moves to another device as a fill of its
    value (no copy from the host): the same bits as the copy."""
    for value in (0.1, -0.0, 1e300, float("nan"), 7, True):
        try:
            host = torch.as_tensor(value, dtype=dtype).reshape(1, 1).expand(2, 3)
        except RuntimeError:
            continue
        filled = torch.full(host.shape, host[0, 0].item(), dtype=dtype)
        assert torch.equal(filled.view(torch.uint8) if dtype == torch.bool else filled.view(
            {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[filled.element_size()]),
            host.contiguous().view(torch.uint8) if dtype == torch.bool else host.contiguous().view(
                {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[host.element_size()]))
        assert torch.equal(embedded.scalar_tensor(value, dtype, torch.device("cpu")),
                           torch.as_tensor(value, dtype=dtype)) or value != value


# --- on the card --------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_pair(op, args, kwargs, make_out, provider):
    """``op`` through the graph (three calls: eager, capture, replay) and
    with ``enable_jit=False``, each into its own out field."""
    graph_out, eager_out = make_out(), make_out()
    graph_op = op.with_backend("torch")
    for _ in range(3):
        graph_op(*args, out=graph_out, offset_provider=provider, **kwargs)
    op.with_compilation_options(enable_jit=False)(*args, out=eager_out, offset_provider=provider,
                                                  **kwargs)
    torch.cuda.synchronize()
    return graph_out, eager_out


def _same_bits(a, b):
    bits = lambda f: f.ndarray.reshape(-1).contiguous().view(torch.uint8)  # noqa: E731
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 256])
def test_nabla_replay_equals_eager_on_card(n):
    _need_card()
    _reset_counts()
    args, provider, _ = defs.nabla_inputs(n, np.float32, 11, "cuda")
    got, want = _card_pair(defs.nabla_x, args, {},
                           lambda: defs.nabla_inputs(n, np.float32, 11, "cuda")[2], provider)
    assert _same_bits(got, want)
    assert otf.graphs_first_calls["field_operator"] == 1
    assert otf.graphs_captured["field_operator"] == 1
    assert otf.graphs_replayed["field_operator"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["next_vadv", "solve_tridiag", "hdiff_op"])
def test_scans_and_operators_replay_equals_eager_on_card(name):
    _need_card()
    _reset_counts()
    args, kwargs, _ = defs.inputs(name, 16, 12, 10, np.float64, 7, "cuda")
    op = defs.next_tridiag if name == "solve_tridiag" else getattr(defs, name)
    got, want = _card_pair(op, args, kwargs,
                           lambda: defs.inputs(name, 16, 12, 10, np.float64, 7, "cuda")[2],
                           defs.PROV_K)
    assert _same_bits(got, want)
    assert sum(otf.graphs_captured.values()) == 1 and sum(otf.graphs_replayed.values()) == 2


@pytest.mark.cuda
def test_direct_scan_replay_equals_eager_on_card():
    _need_card()
    _reset_counts()
    rng = np.random.default_rng(4)
    a, w = (gtx.as_field(gtx.domain({I: 5, K: 7}), rng.random((5, 7)), device="cuda")
            for _ in range(2))
    outs = [gtx.zeros({I: 5, K: 7}, device="cuda") for _ in range(2)]
    scan = defs.weighted_cumsum.with_backend("torch")
    for _ in range(3):
        scan(a, w, out=outs[0], offset_provider={})
    defs.weighted_cumsum.with_backend(None)(a, w, out=outs[1], offset_provider={})
    torch.cuda.synchronize()
    assert _same_bits(*outs)
    assert otf.graphs_captured == {"scan_operator": 1} and otf.graphs_replayed == {"scan_operator": 2}


def _lap_twice_card(seed=6):
    rng = np.random.default_rng(seed)
    phi = gtx.as_field(gtx.domain({I: 20, defs.JDim: 20, K: 5}), rng.random((20, 20, 5)),
                       device="cuda")

    def fields():
        return (gtx.zeros({I: (1, 19), defs.JDim: (1, 19), K: 5}, device="cuda"),
                gtx.zeros({I: (2, 18), defs.JDim: (2, 18), K: 5}, device="cuda"))

    return phi, fields(), fields()


@pytest.mark.cuda
def test_program_replay_equals_eager_on_card():
    _need_card()
    _reset_counts()
    phi, (tmp, out), (etmp, eout) = _lap_twice_card()
    prog = defs.lap_twice.with_backend("torch")
    for _ in range(3):
        prog(phi, tmp, out, offset_provider=defs.PROV)
    with otf.inline_calls():
        defs.lap_twice(phi, etmp, eout, offset_provider=defs.PROV)
    torch.cuda.synchronize()
    assert _same_bits(out, eout) and _same_bits(tmp, etmp)
    assert otf.graphs_captured == {"program": 1} and otf.graphs_replayed == {"program": 2}


@pytest.mark.cuda
def test_program_launches_its_bridged_operators_kernel_on_card():
    """A program mixing a ``cuda:hopper`` operator with a ``torch`` one: the
    bridged operator's Hopper kernel runs in the program's graph, counted
    at every replay (and at the eager first call), and the result equals
    the program run eagerly to the bit."""
    _need_card()
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    _reset_counts()
    phi, (tmp, out), (etmp, eout) = _lap_twice_card()
    prog = defs.lap_twice_mixed.with_backend("torch")
    with otf.inline_calls():
        prog(phi, etmp, eout, offset_provider=defs.PROV)  # builds the bridged variant
    before = {n: w.launches for n, w in cuda_backend.WRAPPERS.items()}
    for _ in range(4):
        prog(phi, tmp, out, offset_provider=defs.PROV)
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in cuda_backend.WRAPPERS.items()
                if w.launches != before[n]}
    assert list(launched.values()) == [4]
    assert otf.graphs_captured == {"program": 1} and otf.graphs_replayed == {"program": 3}
    assert _same_bits(out, eout) and _same_bits(tmp, etmp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", fdefs.CAPTURED)
def test_captured_feature_case_on_card(name):
    """Every case pinned ``captured``: on the card, each call made twice
    (``fdefs.second_calls``), served by graphs and equal to its eager run
    to the bit."""
    _need_card()
    with tcases.on_device("cuda"):
        with otf.inline_calls():
            want = fdefs.run_case(name, "torch")
        _reset_counts()
        with fdefs.second_calls(otf):
            got = fdefs.run_case(name, "torch")
        torch.cuda.synchronize()
    assert otf.graphs_captured and not otf.graphs_refused
    assert otf.graphs_captured == otf.graphs_first_calls
    flat = lambda v: [f for x in v for f in flat(x)] if isinstance(v, tuple) else [v]  # noqa: E731
    for g, w in zip(flat(got), flat(want), strict=True):
        assert _same_bits(g, w)


@pytest.mark.cuda
def test_new_pointers_capture_anew_on_card():
    _need_card()
    _reset_counts()
    op = _axpy.with_backend("torch")
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        a, b = (gtx.as_field({I: 8}, rng.random(8), device="cuda") for _ in range(2))
        out = gtx.zeros({I: 8}, device="cuda")
        for _ in range(3):
            op(a, b, 2.0, out=out, offset_provider={})
        np.testing.assert_array_equal(out.asnumpy(), 2.0 * a.asnumpy() + b.asnumpy())
    assert otf.graphs_captured["field_operator"] == 2 and otf.graphs_replayed["field_operator"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda", "cpu"])
def test_rebound_table_and_back_on_card(where):
    """An int32 table (on the card, or on the host beside card fields)
    rebound to another and back, and a provider rebuilt from one table
    every second call: every call equal to ``enable_jit=False`` to the
    bit (a graph reads the index it keeps, never a freed one)."""
    _need_card()
    _reset_counts()
    rng = np.random.default_rng(9)
    e = gtx.as_field(gtx.domain({defs.Edge: 18}), rng.random(18), device="cuda")
    t1, t2 = (t.to(where) for t in _int32_tables())
    out = gtx.zeros({defs.Vertex: 9}, device="cuda")
    op = defs.edge_sum.with_backend("torch")
    eager = defs.edge_sum.with_compilation_options(enable_jit=False)

    def check(prov):
        op(e, out=out, offset_provider=prov)
        want = gtx.zeros({defs.Vertex: 9}, device="cuda")
        eager(e, out=want, offset_provider=prov)
        torch.cuda.synchronize()
        assert _same_bits(out, want)

    prov = _toy_provider()
    for table in (t1, t2, t1, t2, t1):
        prov["V2E"].table = table
        for _ in range(3):
            check(prov)
    for call in range(8):
        if call % 2 == 0:
            fresh = {"V2E": gtx.Connectivity(t1, domain_dims=(defs.Vertex, defs.V2EDim),
                                             codomain=defs.Edge)}
        check(fresh)
    assert otf.graphs_captured["field_operator"] >= 3
    assert set(otf.graphs_refused) == {otf.REFUSED_OPTIONS}  # the eager side only


@pytest.mark.cuda
def test_global_write_reaches_the_module_once_on_card():
    _need_card()
    global _HELPER_RUNS
    _HELPER_RUNS = 0
    a = gtx.as_field({I: 8}, np.arange(8.0), device="cuda")
    out = gtx.zeros({I: 8}, device="cuda")
    op = _through_global_writer.with_backend("torch")
    for _ in range(3):
        op(a, out=out, offset_provider={})
    assert _HELPER_RUNS == 1


@pytest.mark.cuda
def test_warm_call_launches_only_the_replay():
    """A warm call's device work in a trace: one graph launch, no kernel
    launch, copy or fill of its own."""
    _need_card()
    from .test_torch_chip_smoke import SMOKE as chip_smoke

    args, provider, out = defs.nabla_inputs(16, np.float32, 11, "cuda")
    op = defs.nabla_x.with_backend("torch")
    call = lambda: op(*args, out=out, offset_provider=provider)  # noqa: E731
    chip_smoke.check_replay_only("nabla", chip_smoke.warm_call_work(call, torch))


@pytest.mark.cuda
def test_graph_cache_holds_no_caller_tensor():
    _need_card()
    a = gtx.as_field({I: 8}, np.arange(8.0), device="cuda")
    b = gtx.as_field({I: 8}, np.ones(8), device="cuda")
    out = gtx.zeros({I: 8}, device="cuda")
    op = _axpy.with_backend("torch")
    for _ in range(2):
        op(a, b, 2.0, out=out, offset_provider={})
    refs = [weakref.ref(t) for t in (a.ndarray, b.ndarray, out.ndarray)]
    del a, b, out
    gc.collect()
    assert all(r() is None for r in refs) and len(op._graphs) == 1


@pytest.mark.cuda
def test_pools_are_freed_with_their_graphs_on_card():
    """A pool counts its live graphs; when the last is gone, the pool leaves
    ``_POOLS`` (the next capture takes a new one)."""
    _need_card()
    a = gtx.as_field({I: 8}, np.arange(8.0), device="cuda")
    b = gtx.as_field({I: 8}, np.ones(8), device="cuda")
    out = gtx.zeros({I: 8}, device="cuda")
    op = _axpy.with_backend("torch")
    for _ in range(2):
        op(a, b, 2.0, out=out, offset_provider={})
    (entry,) = [g for g in op._graphs._graphs.values() if g is not None]
    pool = entry.pool
    assert otf._POOLS.get(pool.key) is pool and otf.graph_pool_bytes() > 0
    gc.collect()  # other tests' dead operators leave first
    live = pool.graphs
    del op, entry
    gc.collect()
    assert pool.graphs == live - 1
    assert (otf._POOLS.get(pool.key) is pool) == (pool.graphs > 0)
    again = _axpy.with_backend("torch")
    for _ in range(2):
        again(a, b, 2.0, out=out, offset_provider={})
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.asnumpy(), 2.0 * np.arange(8.0) + 1.0)
