"""Mesh numbering utilities and the FVM-nabla benchmark mesh.

Copied from gt4py_tpu/next/mesh_utils.py; imports renamed:

- :func:`periodic_quad_mesh` — the periodic ``n x n`` quad mesh of the
  FVM-nabla workload (bench.py's unstructured rows).
- :func:`periodic_triangle_mesh` — ICON's planar torus of equilateral
  triangles with ICON's connectivity tables (the port's own: the ICON
  diffusion benchmark's mesh).
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
