"""ICON's Smagorinsky diffusion of the normal wind in plain PyTorch on ICON's
global icosahedral grid: the step of perfbench/reference/icon_diffusion_vn.py
(its operators ``nabla2``, ``nabla4`` and ``apply``, its geometry and its
``EDGE_BLOCK`` blocking, loaded by ``spec.load_module``) on the grid of the
configuration's ``mesh_root`` and ``mesh_bisections``.

It builds the grid itself and takes nothing from the port (:func:`triangulation`):
the icosahedron's twenty faces, each split into ``root**2`` triangles on
its barycentric lattice (row by row, each row's up and down triangles
alternating), then each triangle bisected ``bisections`` times into
``(a, ab, ca)``, ``(ab, b, bc)``, ``(ca, bc, c)``, ``(bc, ca, ab)``, the four
children of a parent numbered together. A corner is the exact point of the
icosahedron's surface that it stands for, its lattice weights on its
face's corners with coordinates in Z[φ]: points shared by faces or by
triangles are one vertex. Vertices are numbered by first appearance,
walking the cells in order and each cell's corners in order. Bisecting on
the sphere moves the points, not the triangulation, so the flat lattice
gives the grid's. From that triangulation it derives every table it reads
(:func:`tables`):

- edges numbered by first appearance, walking the cells in order and each
  cell's sides in order, side ``k`` from corner ``k`` to corner ``k + 1``;
  an edge's ends in the order its first cell walks them;
- ``E2C2V``: an edge's two ends, then the corner opposite it in its first
  cell and in its second; ``E2ECV`` is ``4e + i``;
- ``V2E``: a vertex's edges counter-clockwise seen from outside, from its
  lowest-numbered edge: in a cell ``(v, a, b)`` the edge ``v-b`` follows
  ``v-a``; a vertex of five edges (a pentagon) holds the skip value -1 in
  its sixth slot.

``step`` applies the five calls of one step to ``vn`` (edges, levels) and
returns every field they write, in ``vn``'s dtype. Each neighbor sum of the
radial-basis interpolation adds only the slots that are present, from the
first on; everything else is the torus reference's, in its order.
"""

import os

import torch

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORUS = load_module(ROOT, "reference", "icon_diffusion_vn")
#: the skip value of an absent slot of ``V2E``
SKIP = -1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: (root, bisections, device) -> the derived tables
_TABLES: dict = {}

#: the icosahedron's twelve corners ``(0, ±1, ±φ)`` and their cyclic
#: permutations, each coordinate ``a + b φ`` held as the integers ``(a, b)``
CORNERS = torch.tensor([
    [(-1, 0), (0, 1), (0, 0)], [(1, 0), (0, 1), (0, 0)], [(-1, 0), (0, -1), (0, 0)],
    [(1, 0), (0, -1), (0, 0)], [(0, 0), (-1, 0), (0, 1)], [(0, 0), (1, 0), (0, 1)],
    [(0, 0), (-1, 0), (0, -1)], [(0, 0), (1, 0), (0, -1)], [(0, 1), (0, 0), (-1, 0)],
    [(0, 1), (0, 0), (1, 0)], [(0, -1), (0, 0), (-1, 0)], [(0, -1), (0, 0), (1, 0)]])
#: its twenty faces in the grid's order, each counter-clockwise seen from outside
FACES = torch.tensor([
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
    (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)])


def triangulation(root: int, bisections: int) -> torch.Tensor:
    """``C2V`` of the grid RnBk, built here (see the module's docstring)."""
    n = root << bisections  # lattice steps along a face's side
    lattice = []
    for j in range(root):
        for i in range(root - j):
            lattice.append(((i, j), (i + 1, j), (i, j + 1)))
            if i < root - j - 1:
                lattice.append(((i + 1, j), (i + 1, j + 1), (i, j + 1)))
    # each cell's corners as lattice points (i, j) of its face, in steps of 1 / n
    cells = (torch.tensor(lattice) << bisections).repeat(len(FACES), 1, 1)
    face = torch.arange(len(FACES)).repeat_interleave(len(lattice))
    for _ in range(bisections):
        a, b, c = cells.unbind(1)
        ab, bc, ca = (a + b) // 2, (b + c) // 2, (c + a) // 2
        cells = torch.stack([a, ab, ca, ab, b, bc, ca, bc, c, bc, ca, ab], 1).view(-1, 3, 2)
        face = face.repeat_interleave(4)
    # n times each corner's point: its weights (n - i - j, i, j) on its face's corners
    i, j = cells[..., 0], cells[..., 1]
    at = CORNERS[FACES[face]]  # (cells, the face's 3 corners, xyz, (a, b))
    point = sum(w[..., None, None] * at[:, k, None] for k, w in enumerate((n - i - j, i, j)))
    # one integer a point: its six coordinates lie in [-n, n]
    key = torch.zeros(point.shape[:2], dtype=torch.int64)
    for digit in point.reshape(*point.shape[:2], 6).unbind(-1):
        key = key * (2 * n + 1) + digit + n
    _, vertex = torch.unique(key.reshape(-1), return_inverse=True)
    nv = int(vertex.max()) + 1
    place = torch.arange(vertex.numel())
    first = torch.full((nv,), vertex.numel()).scatter_reduce(0, vertex, place, "amin")
    rank = torch.empty(nv, dtype=torch.int64)
    rank[first.argsort()] = torch.arange(nv)
    return rank[vertex].view(-1, 3)


def derive(c2v: torch.Tensor) -> dict:
    """``V2E`` (nv, 6), ``E2C2V`` (ne, 4) and ``E2ECV`` (ne, 4) of the
    triangulation ``c2v`` (see the module's docstring)."""
    device = c2v.device
    nc = c2v.shape[0]
    nv = int(c2v.max()) + 1
    corner = c2v.reshape(-1)  # corner k of cell c at 3 c + k
    ahead = c2v.roll(-1, dims=1).reshape(-1)  # side k's second end
    behind = c2v.roll(1, dims=1).reshape(-1)  # the corner opposite side k
    key = torch.minimum(corner, ahead) * nv + torch.maximum(corner, ahead)
    _, side_edge = torch.unique(key, return_inverse=True)
    ne = int(side_edge.max()) + 1
    place = torch.arange(3 * nc, device=device)
    big = torch.full((ne,), 3 * nc, dtype=torch.int64, device=device)
    first = big.scatter_reduce(0, side_edge, place, "amin")
    last = torch.full_like(big, -1).scatter_reduce(0, side_edge, place, "amax")
    numbered = torch.empty(ne, dtype=torch.int64, device=device)
    numbered[torch.argsort(first)] = torch.arange(ne, device=device)
    first, last = first[numbered.argsort()], last[numbered.argsort()]
    edge = numbered[side_edge]  # the edge of each side, by its number
    e2c2v = torch.stack([corner[first], ahead[first], behind[first], behind[last]], dim=1)
    e2ecv = 4 * torch.arange(ne, device=device)[:, None] + torch.arange(4, device=device)

    # around each vertex, (vertex, edge) -> the next edge counter-clockwise:
    # at corner k, side k (to corner k + 1) is followed by side k + 2
    before = edge
    after = edge.view(nc, 3).roll(1, dims=1).reshape(-1)
    pairs = corner * ne + before
    order = torch.argsort(pairs)
    pairs, after = pairs[order], after[order]
    start = torch.full((nv,), ne, dtype=torch.int64, device=device).scatter_reduce(
        0, corner, before, "amin")
    degree = torch.bincount(corner, minlength=nv)
    v2e = torch.empty((nv, 6), dtype=torch.int64, device=device)
    vertex = torch.arange(nv, device=device)
    current = start
    for slot in range(6):
        v2e[:, slot] = current
        current = after[torch.searchsorted(pairs, vertex * ne + current)]
    v2e[degree == 5, 5] = SKIP
    return {"V2E": v2e, "E2C2V": e2c2v, "E2ECV": e2ecv}


def tables(config: dict, device) -> dict:
    """The tables of the configuration's grid on ``device``, derived once."""
    key = (int(config["mesh_root"]), int(config["mesh_bisections"]), str(device))
    if key not in _TABLES:
        _TABLES[key] = derive(triangulation(*key[:2]).to(device))
    return _TABLES[key]


def rbf(p_e_in, v2e, c1, c2, u, w):
    """Operator 1 into ``u`` and ``w``: each vertex's sum over the slots of
    ``V2E`` that are present, from the first on."""
    u.copy_(c1[:, 0, None] * p_e_in[v2e[:, 0]])
    w.copy_(c2[:, 0, None] * p_e_in[v2e[:, 0]])
    for i in range(1, 6):
        rows = torch.nonzero(v2e[:, i] != SKIP).squeeze(1)
        gathered = p_e_in[v2e[rows, i]]
        u[rows] += c1[rows, i, None] * gathered
        w[rows] += c2[rows, i, None] * gathered


def _edge_geometry(config: dict, g: dict, e2ecv, lo: int, hi: int) -> dict:
    """The geometry of edges ``lo:hi``: the edge arrays sliced, the ECV
    arrays gathered through ``E2ECV`` as (edges, 4), the profiles whole."""
    out = {name: g[name] for name in config["profiles"]}
    for name, spec in config["geometry"].items():
        if spec["over"] == "Edge":
            out[name] = g[name][lo:hi]
        elif spec["over"] == "ECV":
            out[name] = g[name][e2ecv[lo:hi]]
    return out


def step(fields: dict, config: dict) -> dict:
    vn = fields["vn"]
    device, dtype = vn.device, vn.dtype
    ne, nk = vn.shape
    nv = int(config["vertices"])
    t = tables(config, device)
    v2e, e2c2v, e2ecv = t["V2E"], t["E2C2V"], t["E2ECV"]
    g = TORUS.geometry(config, device, dtype)
    s = {name: float(v) for name, v in config["scalars"].items()}
    c1, c2 = g["ptr_coeff_1"], g["ptr_coeff_2"]
    blocks = [(lo, min(lo + TORUS.EDGE_BLOCK, ne)) for lo in range(0, ne, TORUS.EDGE_BLOCK)]
    out = {role: TORUS._written(fields, role, (nv, nk), vn) for role in ("u_vert", "v_vert")}
    for role in ("kh_smag_e", "kh_smag_ec", "z_nabla2_e", "z_nabla4_e2"):
        out[role] = TORUS._written(fields, role, (ne, nk), vn)

    def geometry(lo, hi):
        return _edge_geometry(config, g, e2ecv, lo, hi)

    rbf(vn, v2e, c1, c2, out["u_vert"], out["v_vert"])
    for lo, hi in blocks:
        out["kh_smag_e"][lo:hi], out["kh_smag_ec"][lo:hi], out["z_nabla2_e"][lo:hi] = \
            TORUS.nabla2(geometry(lo, hi), s, out["u_vert"], out["v_vert"], vn[lo:hi],
                         e2c2v[lo:hi])
    rbf(out["z_nabla2_e"], v2e, c1, c2, out["u_vert"], out["v_vert"])
    for lo, hi in blocks:
        out["z_nabla4_e2"][lo:hi] = TORUS.nabla4(geometry(lo, hi), out["u_vert"],
                                                 out["v_vert"], out["z_nabla2_e"][lo:hi],
                                                 e2c2v[lo:hi])
    out["vn"] = torch.empty_like(vn)
    for lo, hi in blocks:
        out["vn"][lo:hi] = TORUS.apply(geometry(lo, hi), s, out["kh_smag_e"][lo:hi],
                                       out["z_nabla2_e"][lo:hi], out["z_nabla4_e2"][lo:hi],
                                       vn[lo:hi])
    return out
