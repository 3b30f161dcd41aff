"""Distributed unstructured meshes with EXPLICIT ghost rows.

Counterpart of gt4py_tpu/parallel/unstructured.py. Real ICON-style
consumers partition the mesh so each rank owns a contiguous, spatially
compact block of every element kind and REMOTE accesses touch only a thin
halo owned by ring neighbours; the exchange is then two fixed-width slabs
per gather (the reference has nothing here — gt4py delegates distribution
to GHEX; SURVEY.md §2.6 "connectivity tables become sharded gather
indices").

Recipe (composes ``next/mesh_utils.py`` renumbering with a 1-D ring of
devices):

1. :func:`ring_partition` — contiguous equal blocks of each element kind
   (apply ``mesh_utils.spatial_renumbering`` FIRST so contiguous id
   blocks are spatially compact and ghosts land on ring neighbours).
2. :func:`partition_gather` — per-shard LOCAL connectivity tables whose
   stored indices address a shard-extended value buffer
   ``[lo-halo | owned | hi-halo]``; halo widths are uniform across
   shards, computed from the worst shard. (NumPy, as in the JAX package.)
3. :func:`halo_gather` — the shard's owned block joined with the trailing
   ``halo_lo`` rows of shard p - 1 and the leading ``halo_hi`` rows of shard
   p + 1, then one ``index_select`` through the clipped local table.

Where the JAX package runs the operator once under ``shard_map`` and moves
the slabs with ``lax.ppermute``, :class:`DistributedUnstructured` runs it
once per shard, each shard in a thread of its own on its device, one
thread running at a time: a gather is a collective at which every shard
leaves its block and, when its turn comes back, takes its neighbours'
slabs (:class:`_Ring`). Plan-time validation rejects meshes
whose ghosts reach beyond the immediate ring neighbours (raise, never
silently widen) — renumber first.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "DistributedUnstructured",
    "ring_partition",
    "partition_gather",
    "halo_gather",
    "ShardedGather",
]


def ring_partition(n_elements: int, n_parts: int) -> np.ndarray:
    """Block starts of a contiguous equal partition: part p owns
    ``[starts[p], starts[p+1])``. Requires ``n_parts`` to divide
    ``n_elements`` (uniform block shapes)."""
    if n_elements % n_parts != 0:
        raise ValueError(
            f"{n_elements} elements do not split evenly over {n_parts} parts"
        )
    w = n_elements // n_parts
    return np.arange(n_parts + 1) * w


class ShardedGather:
    """Per-shard gather plan produced by :func:`partition_gather`.

    Attributes:
        local_tables: (n_rows, deg) int32 — global row order, values are
            LOCAL indices into the shard-extended buffer of the owning
            row shard. Split it by rows (axis 0) over the same ring as
            the values.
        halo_lo / halo_hi: uniform slab widths pulled from the previous /
            next ring neighbour.
        n_local: owned values per shard.
    """

    def __init__(self, local_tables, halo_lo, halo_hi, n_local, n_parts):
        self.local_tables = local_tables
        self.halo_lo = int(halo_lo)
        self.halo_hi = int(halo_hi)
        self.n_local = int(n_local)
        self.n_parts = int(n_parts)


def partition_gather(
    table: np.ndarray,
    n_values: int,
    n_parts: int,
    *,
    skip_value: Optional[int] = None,
) -> ShardedGather:
    """Build the explicit-ghost plan for ``values[table]`` with rows and
    values both ring-partitioned into ``n_parts`` contiguous blocks.

    For each row shard p (owning rows ``[p*Rw, (p+1)*Rw)`` and values
    ``[p*Vw, (p+1)*Vw)``), every referenced value must be owned by p or
    by its ring neighbours p±1 (mod P) — else raises ``ValueError``
    (renumber the mesh first, ``next/mesh_utils.py``). Stored indices are
    rewritten to address ``[lo-halo | owned | hi-halo]`` where the halos
    are the TRAILING ``halo_lo`` rows of the previous shard and the
    LEADING ``halo_hi`` rows of the next (fixed-width slabs, uniform
    across shards).
    """
    table = np.asarray(table)
    n_rows, deg = table.shape
    rstarts = ring_partition(n_rows, n_parts)
    vstarts = ring_partition(n_values, n_parts)
    Vw = n_values // n_parts

    valid = np.ones(table.shape, dtype=bool)
    if skip_value is not None:
        valid = table != skip_value
    t = np.clip(table, 0, n_values - 1)

    # Worst-case halo widths over all shards (uniform block shapes).
    halo_lo = 0
    halo_hi = 0
    for p in range(n_parts):
        rows = slice(rstarts[p], rstarts[p + 1])
        tp = t[rows]
        vp = valid[rows]
        lo, hi = vstarts[p], vstarts[p + 1]
        prev_lo = (lo - Vw) % n_values
        next_hi = (hi + Vw - 1) % n_values + 1
        owned = vp & (tp >= lo) & (tp < hi)
        below = vp & ~owned & _in_ring_range(tp, prev_lo, lo, n_values)
        above = vp & ~owned & ~below & _in_ring_range(
            tp, hi % n_values, next_hi, n_values
        )
        foreign = vp & ~owned & ~below & ~above
        if foreign.any():
            r, c = np.nonzero(foreign)
            raise ValueError(
                f"shard {p}: row {rstarts[p] + r[0]} references value "
                f"{int(tp[r[0], c[0]])}, beyond ring neighbors "
                f"[{prev_lo}, {next_hi}) — renumber the mesh "
                f"(next/mesh_utils.py) so ghosts are neighbor-local"
            )
        if below.any():
            # distance back from the owned block start (1 .. Vw)
            d = (lo - tp[below]) % n_values
            halo_lo = max(halo_lo, int(d.max()))
        if above.any():
            d = (tp[above] - hi) % n_values + 1
            halo_hi = max(halo_hi, int(d.max()))

    # Local index rewrite: extended buffer [lo-halo | owned | hi-halo].
    local = np.zeros_like(t, dtype=np.int64)
    for p in range(n_parts):
        rows = slice(rstarts[p], rstarts[p + 1])
        tp = t[rows]
        lo, hi = vstarts[p], vstarts[p + 1]
        owned = (tp >= lo) & (tp < hi)
        below = _in_ring_range(tp, (lo - halo_lo) % n_values, lo, n_values)
        # below: local slot = halo_lo - distance
        dist_back = (lo - tp) % n_values
        loc = np.where(owned, tp - lo + halo_lo, 0)
        loc = np.where(below & ~owned, halo_lo - dist_back, loc)
        above = ~owned & ~below
        dist_fwd = (tp - hi) % n_values
        loc = np.where(above, halo_lo + Vw + dist_fwd, loc)
        local[rows] = loc
    if skip_value is not None:
        # Preserve the marker so consumers' mask machinery (which tests
        # ``table != skip_value``) keeps working on the LOCAL table; the
        # gather itself clips indices into range (halo_gather).
        local[~valid] = skip_value

    return ShardedGather(
        local.astype(np.int32), halo_lo, halo_hi, Vw, n_parts
    )


def _in_ring_range(x, lo, hi, n):
    """Membership in the cyclic interval [lo, hi) of Z_n."""
    if lo <= hi:
        return (x >= lo) & (x < hi)
    return (x >= lo) | (x < hi)


def _extended(values: torch.Tensor, lo_slab, hi_slab) -> torch.Tensor:
    """``[lo_slab | values | hi_slab]`` on the values' device."""
    parts = [p.to(values.device) for p in (lo_slab, values, hi_slab) if p is not None]
    return torch.cat(parts) if len(parts) > 1 else values


def _clipped(table: torch.Tensor, rows: int, device=None) -> torch.Tensor:
    """A local table as int64 indices clipped into an extended buffer of
    ``rows`` rows (a skip value lands on a real row; the mask drops it)."""
    return table.to(device or table.device, torch.int64).clamp(0, rows - 1)


def _take(ext: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """``ext[safe]`` along axis 0 (``safe``: :func:`_clipped` indices)."""
    return torch.index_select(ext, 0, safe.reshape(-1)).reshape(
        tuple(safe.shape) + tuple(ext.shape[1:])
    )


def halo_gather(
    blocks: Sequence[torch.Tensor], local_tables: Sequence[torch.Tensor], plan: ShardedGather
) -> list[torch.Tensor]:
    """The gather of every shard of a ring: shard p's owned ``blocks[p]``
    (``n_local`` rows, on its device) extended by the trailing
    ``plan.halo_lo`` rows of shard p - 1 and the leading ``plan.halo_hi``
    rows of shard p + 1, indexed by ``local_tables[p]`` (its rows of
    ``plan.local_tables``). Only those slabs move between shards."""
    n = len(blocks)
    out = []
    for p, values in enumerate(blocks):
        lo = blocks[(p - 1) % n][values.shape[0] - plan.halo_lo:] if plan.halo_lo else None
        hi = blocks[(p + 1) % n][: plan.halo_hi] if plan.halo_hi else None
        ext = _extended(values, lo, hi)
        out.append(_take(ext, _clipped(local_tables[p], ext.shape[0], ext.device)))
    return out


class _Ring:
    """The shards' schedule and meeting point. One shard's thread runs at a
    time, holding the turn: at its k-th gather it leaves the block it
    gathers from and hands the turn to the next shard still running; when
    the turn comes back every shard has left its k-th block, and it takes
    its neighbours' slabs. (Threads waiting at a barrier instead would all
    contend for the interpreter lock each time a torch call releases it.)
    ``log`` records each slab received."""

    class Abandoned(Exception):
        """Another shard failed: this one stops at its next turn."""

    def __init__(self, n: int):
        self.n = n
        self.turn = [threading.Semaphore(0) for _ in range(n)]
        self.done = [False] * n
        self.failed = False
        self.blocks: dict = {}  # (gather index, shard) -> the block
        self.count = [0] * n
        self.log: list[dict] = []

    def wait(self, shard: int) -> None:
        """Block until ``shard`` holds the turn."""
        self.turn[shard].acquire()
        if self.failed:
            raise _Ring.Abandoned()

    def hand_on(self, shard: int) -> None:
        """Give the turn to the next shard still running after ``shard``."""
        for step in range(1, self.n + 1):
            nxt = (shard + step) % self.n
            if not self.done[nxt]:
                self.turn[nxt].release()
                return

    def finish(self, shard: int, failed: bool = False) -> None:
        self.done[shard] = True
        self.failed = self.failed or failed
        self.hand_on(shard)

    def gather(self, shard: int, values: torch.Tensor, safe, plan, name: str):
        k = self.count[shard]
        self.count[shard] += 1
        self.blocks[(k, shard)] = values
        self.hand_on(shard)
        self.wait(shard)
        n = self.n
        neighbours = [((shard - 1) % n, plan.halo_lo), ((shard + 1) % n, plan.halo_hi)]
        slabs = []
        for side, (src, rows) in enumerate(neighbours):
            block = self.blocks.get((k, src))
            if block is None:
                raise RuntimeError(
                    f"shard {shard} gathers through '{name}' while shard {src} has "
                    "finished: the shards made different exchanges"
                )
            if not rows:
                slabs.append(None)
                continue
            slab = block[block.shape[0] - rows:] if side == 0 else block[:rows]
            slabs.append(slab)
            self.log.append({"table": name, "src": src, "dst": shard, "slab": tuple(slab.shape)})
        return _take(_extended(values, *slabs), safe)


class _ShardedConn:
    """Per-shard stand-in for a Connectivity: the embedded remap path
    (``Field._remap_connectivity``) finds ``sharded_gather`` and routes the
    gather through the ring's explicit-ghost exchange. Mirrors the
    attribute surface the remap consumes."""

    def __init__(self, table_block, safe, plan, ring: _Ring, shard: int, name: str, conn):
        self.table = table_block  # (local_rows, deg), on the shard's device
        self._safe = safe  # the same, clipped into the extended buffer (int64)
        self._plan = plan
        self._ring = ring
        self._shard = shard
        self._name = name
        self.domain_dims = conn.domain_dims
        self.codomain = conn.codomain
        self.skip_value = conn.skip_value

    @property
    def source_dim(self):
        return self.domain_dims[0]

    @property
    def neighbor_dim(self):
        return self.domain_dims[1]

    def sharded_gather(self, values, column):
        safe = self._safe if column is None else self._safe[:, column]
        return self._ring.gather(self._shard, values, safe, self._plan, self._name)


class DistributedUnstructured:
    """Field-view operators on ring-partitioned unstructured meshes —
    the distributed counterpart of the embedded execution path
    (cartesian analog: ``parallel.distributed.DistributedStencil``).

    Takes the plain field-view operator (``remap``/``neighbor_sum`` DSL,
    reference common.py:991,1150 semantics) plus GLOBAL connectivities,
    and runs it over a 1-D ring of devices with explicit ghost rows:

    - every element kind is ring-partitioned into contiguous blocks
      (uneven sizes pad to the next multiple and trim on the way out);
    - each connectivity becomes a per-shard LOCAL table addressing a
      shard-extended value buffer (:func:`partition_gather`);
    - remote rows arrive as two fixed-width slabs per gather from the ring
      neighbours, never a whole field (``last_exchange`` lists them);
    - ``skip_value`` masking flows through the embedded mask machinery
      end-to-end.

    ``mesh`` is the ring: a sequence of torch devices (one may repeat) or a
    :class:`~gt4py_tpu_torch.parallel.mesh.CartesianMesh`; the default is
    every visible card (the first ``n_parts``). Meshes must be numbered so
    ghosts are ring-neighbour-local — pass ``renumberings``
    (``next.mesh_utils.Renumbering``, e.g. from ``spatial_renumbering``) to
    apply a numbering first; tables AND the corresponding field data are
    permuted consistently, on the fields' device.

    Usage::

        dist = DistributedUnstructured(
            nabla, offset_provider={"E2V": e2v, "V2E": v2e},
            sizes={V: n_vertices, E: n_edges}, mesh=[torch.device("cuda", 0)] * 4,
        )
        out = dist(pp, s_x, sign, vol)   # global Fields in, global Field out
    """

    def __init__(
        self,
        field_op,
        *,
        offset_provider: dict,
        sizes: dict,
        n_parts: Optional[int] = None,
        mesh=None,
        renumberings: Optional[list] = None,
    ):
        from gt4py_tpu_torch.parallel.mesh import CartesianMesh

        self.field_op = field_op
        if mesh is None:
            devices = CartesianMesh().devices
            if n_parts is not None:
                devices = devices[:n_parts]
        elif isinstance(mesh, CartesianMesh):
            devices = mesh.devices
        else:
            devices = [torch.device(d) for d in mesh]
        self.devices = devices
        self.n_parts = len(devices)

        # Consistent renumbering of tables (field data is permuted per
        # call in __call__).
        self._renumberings = {r.dim: r for r in (renumberings or [])}
        self._sizes = dict(sizes)
        self._pad = {
            dim: (-(-int(n) // self.n_parts) * self.n_parts) - int(n)
            for dim, n in self._sizes.items()
        }

        self._conns = {}
        self._plans = {}
        self._tables = {}
        self._safe = {}
        for name, conn in offset_provider.items():
            for r in self._renumberings.values():
                if r.dim in (conn.source_dim, conn.codomain):
                    conn = r.apply(conn)
            table = conn.table.cpu().numpy()
            n_rows_pad = self._padded(conn.source_dim)
            n_vals_pad = self._padded(conn.codomain)
            if table.shape[0] < n_rows_pad:
                # Padding rows gather value 0 and are trimmed on output.
                fill = np.zeros(
                    (n_rows_pad - table.shape[0], table.shape[1]),
                    dtype=table.dtype,
                )
                table = np.concatenate([table, fill], axis=0)
            plan = partition_gather(
                table, n_vals_pad, self.n_parts, skip_value=conn.skip_value
            )
            self._conns[name] = conn
            self._plans[name] = plan
            rows = table.shape[0] // self.n_parts
            self._tables[name] = [
                torch.as_tensor(plan.local_tables[p * rows:(p + 1) * rows], device=d)
                for p, d in enumerate(devices)
            ]
            extended = plan.halo_lo + plan.n_local + plan.halo_hi
            self._safe[name] = [_clipped(t, extended) for t in self._tables[name]]
        #: the slabs the last call moved: table, source and destination
        #: shards, slab shape
        self.last_exchange: list[dict] = []
        #: renumberings' index tensors by (dim, direction, device)
        self._index: dict = {}

    def _padded(self, dim) -> int:
        return int(self._sizes[dim]) + self._pad[dim]

    def _indices(self, dim, inverse: bool, device) -> torch.Tensor:
        """A renumbering's ``inverse`` (new -> old, to renumber data) or
        ``perm`` (old -> new, to return to the user's numbering) on
        ``device``, copied there once."""
        key = (dim, inverse, device)
        t = self._index.get(key)
        if t is None:
            r = self._renumberings[dim]
            t = self._index[key] = torch.as_tensor(r.inverse if inverse else r.perm,
                                                   device=device)
        return t

    def __call__(self, *fields):
        """Apply to GLOBAL embedded Fields; returns a global Field over
        the operator's output dimension (padding trimmed), on the first
        shard's device."""
        import gt4py_tpu_torch.next as gtx

        blocks, dims_list = self._split(fields)
        results = self._run(blocks, dims_list)
        out_dims = results[0].dims
        out_dim = out_dims[0]
        if out_dim not in self._sizes:
            raise ValueError(
                f"operator output dimension {out_dim} is not ring-"
                f"partitioned (sizes={sorted(d.value for d in self._sizes)})"
            )
        device = self.devices[0]
        arr = torch.cat([r.ndarray.to(device) for r in results])[: int(self._sizes[out_dim])]
        if out_dim in self._renumberings:  # back to the user's numbering
            arr = torch.index_select(arr, 0, self._indices(out_dim, False, device))
        return gtx.as_field(list(out_dims), arr, device=device)

    def exchange_plan(self, *fields) -> list[dict]:
        """The slabs one call on these fields moves between shards (the
        counterpart of ``compiled_hlo``): runs it and returns
        ``last_exchange``."""
        self(*fields)
        return list(self.last_exchange)

    def _split(self, fields):
        """Each field renumbered and padded on its device, then cut into
        the shards' row blocks on their devices."""
        from gt4py_tpu_torch.next.embedded import Field

        blocks = []
        dims_list = []
        for f in fields:
            if not isinstance(f, Field):
                raise TypeError(
                    "DistributedUnstructured takes embedded Fields "
                    f"(got {type(f).__name__}); build them with gtx.as_field"
                )
            arr = f.ndarray
            if not isinstance(arr, torch.Tensor):
                arr = torch.as_tensor(np.asarray(arr))
            lead = f.dims[0]
            if lead not in self._sizes:
                raise ValueError(
                    f"leading dimension {lead} of a field is not in sizes="
                    f"{sorted(d.value for d in self._sizes)}"
                )
            if lead in self._renumberings:
                arr = torch.index_select(arr, 0, self._indices(lead, True, arr.device))
            pad = self._padded(lead) - arr.shape[0]
            if pad:
                arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
            rows = arr.shape[0] // self.n_parts
            blocks.append([arr[p * rows:(p + 1) * rows].to(d) for p, d in enumerate(self.devices)])
            dims_list.append(f.dims)
        return blocks, dims_list

    def _run(self, blocks, dims_list) -> list:
        """The operator once per shard, each in a thread of its own on its
        device, the threads taking turns between gathers (:class:`_Ring`)."""
        import gt4py_tpu_torch.next as gtx
        from gt4py_tpu_torch.next.embedded import offset_provider_context

        defn = getattr(self.field_op, "definition", self.field_op)
        ring = _Ring(self.n_parts)
        results: list[Any] = [None] * self.n_parts
        errors: list[Optional[BaseException]] = [None] * self.n_parts

        def shard(p: int) -> None:
            device = self.devices[p]
            on_card = (
                torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
            )
            try:
                ring.wait(p)
                with on_card:
                    provider = {
                        n: _ShardedConn(self._tables[n][p], self._safe[n][p], self._plans[n],
                                        ring, p, n, self._conns[n])
                        for n in self._tables
                    }
                    local = [
                        gtx.as_field(list(dims), b[p], device=device)
                        for dims, b in zip(dims_list, blocks)
                    ]
                    with offset_provider_context(provider):
                        results[p] = defn(*local)
            except _Ring.Abandoned:
                ring.finish(p)
            except BaseException as exc:  # recorded, re-raised by the caller
                errors[p] = exc
                ring.finish(p, failed=True)
            else:
                ring.finish(p)

        threads = [threading.Thread(target=shard, args=(p,), name=f"gt4py-shard-{p}")
                   for p in range(self.n_parts)]
        for t in threads:
            t.start()
        ring.turn[0].release()
        for t in threads:
            t.join()
        self.last_exchange = ring.log
        for exc in errors:
            if exc is not None:
                raise exc
        return results
