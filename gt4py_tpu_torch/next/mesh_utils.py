"""Mesh numbering utilities and the FVM-nabla benchmark mesh.

Copied from gt4py_tpu/next/mesh_utils.py; imports renamed:

- :func:`periodic_quad_mesh` — the periodic ``n x n`` quad mesh of the
  FVM-nabla workload (bench.py's unstructured rows).
- :func:`periodic_triangle_mesh` — ICON's planar torus of equilateral
  triangles with ICON's connectivity tables (the port's own: the ICON
  diffusion benchmark's mesh).
- :func:`icosahedral_mesh` — ICON's global icosahedral grid RnBk on the
  unit sphere, twelve pentagons with a skip value in ``V2E``, numbered by
  construction (the port's own: the ICON diffusion benchmark's global
  grid).
- :func:`spatial_renumbering` — row-major (optionally tiled) numbering
  from element coordinates.
- :class:`Renumbering` — applies a permutation consistently to
  connectivity tables and field data (both sides of every table must be
  relabelled together or the mesh changes meaning).

The JAX package's ``shift_structure_report`` is not ported: its subject is
the roll plan of that package's embedded gather (``embedded._shift_plan``),
a TPU workaround the port leaves out — a remap here is one gather, whose
cost does not depend on the numbering. Reference analog: gt4py has no
renumbering utility — meshes arrive pre-numbered from Atlas/ICON (see the
fvm_nabla setup in ``tests/next_tests/.../ffront_tests/test_fvm_nabla.py:64``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gt4py_tpu_torch.core.ndarray_utils import asnumpy
from gt4py_tpu_torch.next.common import Connectivity, Dimension

__all__ = [
    "Renumbering",
    "icosahedral_mesh",
    "periodic_quad_mesh",
    "periodic_triangle_mesh",
    "spatial_renumbering",
]


def periodic_quad_mesh(n: int):
    """Periodic ``n x n`` quad mesh in row-major numbering (the FVM-nabla
    benchmark workload; reference mesh family:
    tests/next_tests/.../iterator_tests/test_fvm_nabla.py:64-106 via
    atlas). ``n*n`` vertices; ``2*n*n`` edges, horizontal block first
    (edge ``h(i,j)`` joins ``(i,j)-(i+1,j)``) then vertical (``(i,j)-
    (i,j+1)``), both wrapping periodically. Vectorized — builds the
    million-vertex benchmark meshes in well under a second.

    Returns ``(e2v, v2e, signs)``: ``e2v`` of shape ``(2n², 2)``,
    ``v2e`` of shape ``(n², 4)`` ordered (out-horizontal, in-horizontal,
    out-vertical, in-vertical), ``signs`` the matching (+1, -1, +1, -1)
    orientation weights."""
    nv = n * n
    i, j = np.divmod(np.arange(nv, dtype=np.int64), n)

    def vid(ii, jj):
        return (ii % n) * n + (jj % n)

    e2v = np.empty((2 * nv, 2), dtype=np.int64)
    e2v[:nv, 0] = vid(i, j)
    e2v[:nv, 1] = vid(i + 1, j)
    e2v[nv:, 0] = vid(i, j)
    e2v[nv:, 1] = vid(i, j + 1)

    v2e = np.empty((nv, 4), dtype=np.int64)
    v2e[:, 0] = vid(i, j)
    v2e[:, 1] = vid(i - 1, j)
    v2e[:, 2] = nv + vid(i, j)
    v2e[:, 3] = nv + vid(i, j - 1)
    signs = np.tile(np.asarray([1.0, -1.0, 1.0, -1.0]), (nv, 1))
    return e2v, v2e, signs

def periodic_triangle_mesh(nx: int, ny: int) -> dict:
    """ICON's planar torus (the port's own, periodic_triangle_mesh): a
    periodic triangular mesh of ``nx * ny`` vertices, ``3 * nx * ny``
    edges and ``2 * nx * ny`` cells, every vertex of degree 6, in
    row-major numbering. Vertex ``(r, c)`` (row ``r < ny``, column
    ``c < nx``, both wrapping) is ``r * nx + c``; it owns edges
    ``3v + d``: ``d = 0`` to ``(r, c + 1)``, ``1`` to ``(r + 1, c)``, ``2``
    to ``(r + 1, c - 1)`` (at 0, 60 and 120 degrees on the sheared
    lattice); and cells ``2v`` (up: ``(r, c)``, ``(r, c + 1)``, ``(r + 1, c)``)
    and ``2v + 1`` (down: ``(r, c + 1)``, ``(r + 1, c + 1)``, ``(r + 1, c)``).
    Needs ``nx, ny >= 3``.
    Returns int64 tables by ICON's offset names: ``E2V`` (an edge's ends),
    ``E2C`` (its two cells), ``C2E`` (a cell's three edges), ``V2E`` (a
    vertex's six edges, counter-clockwise from 0 degrees; no skip values
    on a torus), ``E2C2V`` (the edge's two ends, then the vertex opposite
    the edge in ``E2C[0]`` and in ``E2C[1]``, as in ICON) and ``E2ECV``
    (``4e + i``: an edge's four slots of the edge-to-cell-vertex fields).
    """
    if nx < 3 or ny < 3:
        raise ValueError(f"periodic_triangle_mesh needs nx, ny >= 3, got {nx} x {ny}")
    nv = nx * ny
    r, c = np.divmod(np.arange(nv, dtype=np.int64), nx)

    def vid(rr, cc):
        return (rr % ny) * nx + (cc % nx)

    def up(rr, cc):
        return 2 * vid(rr, cc)

    def down(rr, cc):
        return 2 * vid(rr, cc) + 1

    ne = 3 * nv
    e2v = np.empty((ne, 2), dtype=np.int64)
    e2c = np.empty((ne, 2), dtype=np.int64)
    e2c2v = np.empty((ne, 4), dtype=np.int64)
    ends = (vid(r, c + 1), vid(r + 1, c), vid(r + 1, c - 1))
    cells = ((up(r, c), down(r - 1, c)), (up(r, c), down(r, c - 1)),
             (down(r, c - 1), up(r, c - 1)))
    opposite = ((vid(r + 1, c), vid(r - 1, c + 1)), (vid(r, c + 1), vid(r + 1, c - 1)),
                (vid(r + 1, c), vid(r, c - 1)))
    for d in range(3):
        e2v[d::3, 0] = vid(r, c)
        e2v[d::3, 1] = ends[d]
        e2c[d::3, 0], e2c[d::3, 1] = cells[d]
        e2c2v[d::3, :2] = e2v[d::3]
        e2c2v[d::3, 2], e2c2v[d::3, 3] = opposite[d]
    c2e = np.empty((2 * nv, 3), dtype=np.int64)
    c2e[0::2] = np.stack([3 * vid(r, c), 3 * vid(r, c) + 1, 3 * vid(r, c + 1) + 2], axis=1)
    c2e[1::2] = np.stack([3 * vid(r, c + 1) + 1, 3 * vid(r + 1, c), 3 * vid(r, c + 1) + 2],
                         axis=1)
    v2e = np.stack([3 * vid(r, c), 3 * vid(r, c) + 1, 3 * vid(r, c) + 2, 3 * vid(r, c - 1),
                    3 * vid(r - 1, c) + 1, 3 * vid(r - 1, c + 1) + 2], axis=1)
    e2ecv = 4 * np.arange(ne, dtype=np.int64)[:, None] + np.arange(4, dtype=np.int64)
    return {"E2V": e2v, "E2C": e2c, "C2E": c2e, "V2E": v2e, "E2C2V": e2c2v, "E2ECV": e2ecv}


#: the icosahedron's corners, ``(0, ±1, ±φ)`` and its cyclic permutations, and
#: its twenty faces, each counter-clockwise seen from outside
_PHI = (1.0 + 5.0 ** 0.5) / 2.0
_ICOSAHEDRON = np.asarray(
    [(-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0), (0, -1, _PHI), (0, 1, _PHI),
     (0, -1, -_PHI), (0, 1, -_PHI), (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1)])
_ICOSAHEDRON_FACES = (
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
    (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1))
#: the skip value of ``V2E``'s sixth slot at the twelve pentagons, as in ICON4Py
_SKIP = -1


def _unit(xyz: np.ndarray) -> np.ndarray:
    return xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)


def _root_division(root: int) -> tuple:
    """(C2V, vertex coordinates) of the icosahedron's faces each split into
    ``root**2`` triangles on its barycentric lattice, face by face; a
    face's triangles row by row of its lattice, each row's up and down
    triangles alternating. Points shared by faces are one vertex."""
    corners = _unit(_ICOSAHEDRON)
    index: dict = {}
    xyz: list = []
    cells = []

    def vertex(face, i, j):
        # the point's integer weights on the icosahedron's corners name it
        weights = ((face[0], root - i - j), (face[1], i), (face[2], j))
        key = tuple(sorted((v, w) for v, w in weights if w))
        if key not in index:
            index[key] = len(xyz)
            xyz.append(sum(w * corners[v] for v, w in key) / root)
        return index[key]

    for face in _ICOSAHEDRON_FACES:
        for j in range(root):
            for i in range(root - j):
                cells.append((vertex(face, i, j), vertex(face, i + 1, j), vertex(face, i, j + 1)))
                if i < root - j - 1:
                    cells.append((vertex(face, i + 1, j), vertex(face, i + 1, j + 1),
                                  vertex(face, i, j + 1)))
    return np.asarray(cells, dtype=np.int64), _unit(np.asarray(xyz))


def _bisect(c2v: np.ndarray, xyz: np.ndarray) -> tuple:
    """Each triangle ``(a, b, c)`` split into four at its sides' midpoints,
    projected onto the sphere: ``(a, ab, ca)``, ``(ab, b, bc)``,
    ``(ca, bc, c)``, ``(bc, ca, ab)``, numbered ``4 p`` to ``4 p + 3`` for
    the parent ``p``."""
    nv = len(xyz)
    a, b, c = c2v.T
    ends = np.stack([c2v, np.roll(c2v, -1, axis=1)], axis=2)
    key = ends.min(axis=2) * nv + ends.max(axis=2)
    sides, inverse = np.unique(key, return_inverse=True)
    lo, hi = np.divmod(sides, nv)
    xyz = np.concatenate([xyz, _unit(xyz[lo] + xyz[hi])])
    ab, bc, ca = (nv + inverse.reshape(c2v.shape)).T
    children = np.stack([np.stack(t, axis=1) for t in ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                                                       (bc, ca, ab))], axis=1)
    return children.reshape(-1, 3), xyz


def icosahedral_mesh(root: int, bisections: int) -> dict:
    """ICON's global icosahedral grid RnBk (the port's own): the icosahedron
    on the unit sphere, each face split into ``root**2`` triangles, then
    bisected ``bisections`` times, new vertices projected onto the sphere
    (Wan et al. 2013, GMD 6:735-763). ``20 r² 4^b`` cells, ``30 r² 4^b``
    edges and ``10 r² 4^b + 2`` vertices, twelve of them (the icosahedron's
    corners) of degree 5, the others of degree 6. R03B06: 737,280 cells.

    Numbering (not row-major, and not ICON's grid generator's):
    cells in the construction's order: the root triangles face by face in
    lattice order, and each bisection numbers a parent's four children
    consecutively (a quadtree order); vertices and edges by first
    appearance, walking the cells in order, each cell's corners and sides
    counter-clockwise (side ``k`` from corner ``k`` to ``k + 1``).

    Returns int64 tables by ICON's offset names: ``C2V`` (a cell's corners,
    counter-clockwise seen from outside), ``E2V`` (an edge's ends, in the
    order its first cell walks them), ``E2C`` (that cell, then the other),
    ``C2E`` (a cell's sides), ``V2E`` (a vertex's edges, counter-clockwise
    seen from outside from its lowest-numbered edge; at the pentagons the
    sixth slot is the skip value ``-1``), ``E2C2V`` (the edge's two ends,
    then the vertex opposite it in ``E2C[0]`` and in ``E2C[1]``) and
    ``E2ECV`` (``4e + i``); ``xyz`` (the vertices on the unit sphere) and
    ``skip_values`` (``{"V2E": -1}``: the other tables have none).
    Vectorised: R03B06 builds in about a second. Build span
    ``gt4py.build.mesh``.
    """
    from gt4py_tpu_torch.instrumentation.spans import Span

    if root < 1 or bisections < 0:
        raise ValueError(f"icosahedral_mesh needs root >= 1 and bisections >= 0, got "
                         f"R{root}B{bisections}")
    with Span("gt4py.build.mesh", always=True, kind="icosahedral", root=root,
              bisections=bisections) as mesh_span:
        c2v, xyz = _root_division(root)
        for _ in range(bisections):
            c2v, xyz = _bisect(c2v, xyz)
        nc, nv = len(c2v), len(xyz)
        # vertices by first appearance
        _, first = np.unique(c2v, return_index=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(nv, dtype=np.int64)
        rank[order] = np.arange(nv)
        c2v, xyz = rank[c2v], xyz[order]
        # edges by first appearance; side k of a cell runs from corner k to k + 1
        nxt = np.roll(c2v, -1, axis=1)
        key = (np.minimum(c2v, nxt) * nv + np.maximum(c2v, nxt)).ravel()
        _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
        ne = len(first)
        order = np.argsort(first, kind="stable")
        rank = np.empty(ne, dtype=np.int64)
        rank[order] = np.arange(ne)
        c2e = rank[inverse].reshape(nc, 3)
        at = first[order]  # each edge's first (cell, side), flattened
        second = np.ones(3 * nc, dtype=bool)
        second[at] = False
        later = np.nonzero(second)[0]
        opposite = np.roll(c2v, 1, axis=1).ravel()  # corner k + 2: opposite side k
        e2v = np.stack([c2v.ravel()[at], nxt.ravel()[at]], axis=1)
        e2c = np.empty((ne, 2), dtype=np.int64)
        e2c[:, 0] = at // 3
        e2c[c2e.ravel()[later], 1] = later // 3
        e2c2v = np.empty((ne, 4), dtype=np.int64)
        e2c2v[:, :2] = e2v
        e2c2v[:, 2] = opposite[at]
        e2c2v[c2e.ravel()[later], 3] = opposite[later]
        # around each vertex: in its cell (v, a, b), edge v-b follows v-a
        # counter-clockwise; a half-edge is 2 e + (the vertex is its second end)
        corner_v, from_e = c2v.ravel(), c2e.ravel()
        to_e = np.roll(c2e, 1, axis=1).ravel()
        follows = np.empty(2 * ne, dtype=np.int64)
        follows[2 * from_e + (e2v[from_e, 0] != corner_v)] = to_e
        degree = np.bincount(corner_v, minlength=nv)
        start = np.full(nv, ne, dtype=np.int64)
        np.minimum.at(start, corner_v, from_e)
        v2e = np.empty((nv, 6), dtype=np.int64)
        current, vertices = start, np.arange(nv)
        for slot in range(6):
            v2e[:, slot] = current
            current = follows[2 * current + (e2v[current, 0] != vertices)]
        v2e[degree == 5, 5] = _SKIP
        e2ecv = 4 * np.arange(ne, dtype=np.int64)[:, None] + np.arange(4, dtype=np.int64)
        mesh_span.set("cells", nc)
        mesh_span.set("edges", ne)
        mesh_span.set("vertices", nv)
        mesh_span.set("pentagons", int((degree == 5).sum()))
        mesh_span.set("skip_slots", int((v2e == _SKIP).sum()))
    return {"C2V": c2v, "E2V": e2v, "E2C": e2c, "C2E": c2e, "V2E": v2e, "E2C2V": e2c2v,
            "E2ECV": e2ecv, "xyz": xyz, "skip_values": {"V2E": _SKIP}}


def spatial_renumbering(
    coords: np.ndarray,
    *,
    tile: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Row-major (optionally tiled) numbering from element coordinates.

    ``coords`` is ``(n, d)`` — one spatial coordinate per element; the
    LAST coordinate varies fastest (row-major).  With ``tile`` (one
    length per coordinate, in coordinate units), elements are ordered by
    tile first and row-major inside each tile — the layout that keeps a
    tile's neighbors at near-constant index offsets for grid-like
    meshes.

    Returns ``perm`` with ``perm[old_id] = new_id``.
    """
    coords = np.asarray(coords)
    if coords.ndim == 1:
        coords = coords[:, None]
    keys = []
    if tile is not None:
        if len(tile) != coords.shape[1]:
            raise ValueError(
                f"tile has {len(tile)} entries for {coords.shape[1]} coordinates"
            )
        for c in range(coords.shape[1]):
            keys.append(np.floor_divide(coords[:, c], tile[c]))
    for c in range(coords.shape[1]):
        keys.append(coords[:, c])
    # np.lexsort sorts by the LAST key first -> feed keys reversed.
    order = np.lexsort(tuple(k for k in reversed(keys)))  # new_id -> old_id
    perm = np.empty(coords.shape[0], dtype=np.int64)
    perm[order] = np.arange(coords.shape[0])
    return perm


@dataclasses.dataclass(frozen=True)
class Renumbering:
    """A consistent relabelling of one element kind (vertices, edges, ...).

    ``perm[old_id] = new_id``.  Apply it to EVERY object indexed by that
    element kind: field data over the dimension, connectivity tables
    whose SOURCE is the dimension (row order changes), and connectivity
    tables whose CODOMAIN is the dimension (stored indices change).
    """

    dim: Dimension
    perm: np.ndarray  # int64, perm[old] = new

    def __post_init__(self):
        perm = np.asarray(self.perm, dtype=np.int64)
        n = perm.shape[0]
        if not np.array_equal(np.sort(perm), np.arange(n)):
            raise ValueError("perm is not a permutation of 0..n-1")
        object.__setattr__(self, "perm", perm)
        object.__setattr__(self, "_inv", np.argsort(perm))

    @property
    def inverse(self) -> np.ndarray:
        """``inverse[new_id] = old_id``."""
        return self._inv

    def permute_data(self, arr):
        """Reorder field data over ``dim`` (axis 0): new[i] = old at the
        element now numbered i."""
        return asnumpy(arr)[self._inv]  # the port's fields hold tensors

    def apply(self, conn: Connectivity) -> Connectivity:
        """Relabel a connectivity: rows reorder if ``conn.source_dim`` is
        ``dim``; stored indices relabel if ``conn.codomain`` is ``dim``.
        Both can apply (self-referencing tables).  Skip values survive.

        Out-of-range stored indices (other than the skip value) are
        CLAMPED to ``[0, n-1]`` before relabelling — this bakes in the
        framework's clamp-gather semantics, so such rows become ordinary
        in-range indices and are no longer identifiable as out-of-range
        in diagnostics after renumbering.  Run
        ``shift_structure_report`` BEFORE renumbering if you need to see
        them."""
        table = asnumpy(conn.table)  # the port's tables are tensors
        if conn.codomain == self.dim:
            relabeled = self.perm[np.clip(table, 0, len(self.perm) - 1)]
            if conn.skip_value is not None:
                relabeled = np.where(table == conn.skip_value, conn.skip_value, relabeled)
            table = relabeled
        if conn.source_dim == self.dim:
            table = table[self._inv]
        return Connectivity(
            table,
            domain_dims=conn.domain_dims,
            codomain=conn.codomain,
            skip_value=conn.skip_value,
            device=conn.table.device,  # where the relabelled table stays
        )
