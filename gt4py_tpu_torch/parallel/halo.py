"""Halo exchange for IJ-decomposed fields.

Counterpart of gt4py_tpu/parallel/halo.py. There each shard, inside a
``shard_map`` region, sends its edge slabs to its four mesh neighbours with
``lax.ppermute`` and concatenates what it receives. Here one controller
holds every shard's block, each the interior of a halo-extended buffer on
its shard's device, and the exchange is a list of slab copies into those
buffers' halos, in place: a shard's low halo is the high edge of its -1
neighbour and its high halo the low edge of its +1 neighbour. On one device
a slab is a device-to-device ``copy_``; between cards a peer copy, which
torch orders with the current streams of both cards, so it waits for the
source shard's kernels and the destination's next kernels wait for it
(``tests/test_torch_parallel_sharded.py::test_mesh_of_cards_equals_one_card_to_the_bit``
holds meshes over two and four cards against one card where they exist). It
never goes through the host. An axis of size 1 wraps onto the shard itself, as
``_ppermute_shift`` returns its input (halo.py:28-29).

The GLOBAL boundary condition is selectable per axis: ``periodic`` (the
wrap), ``clamp`` (edge replication, the standard non-periodic dycore
boundary) or ``zero``; non-periodic modes replace the wrapped slab on
global-boundary shards only (``_boundary_fill``, halo.py:32-46), so interior
exchanges are identical.

Corner values come from doing the J exchange after the I exchange, on the
I-extended slab (halo.py:96-107).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

#: (i_lo, i_hi, j_lo, j_hi) cells
Halo = tuple[int, int, int, int]


class Transfer(NamedTuple):
    """One slab of an exchange: ``dst[dst_index]`` (I and J slices of the
    destination shard's buffer) takes ``src[src_index]`` (``kind ==
    "copy"``), the destination's own edge row or column repeated
    (``"clamp"``; ``src == dst``) or zeros (``"zero"``; no source)."""

    axis: str  # "i" (first phase) or "j" (second, on the I-extended slab)
    kind: str  # "copy" | "clamp" | "zero"
    src: Optional[int]
    dst: int
    src_index: Optional[tuple]
    dst_index: tuple

    def slab_shape(self) -> tuple[int, int]:
        return tuple(s.stop - s.start for s in self.dst_index)


def _modes(boundary) -> tuple[str, str]:
    b_i, b_j = (boundary, boundary) if isinstance(boundary, str) else tuple(boundary)
    for mode in (b_i, b_j):
        if mode not in ("periodic", "clamp", "zero"):
            raise ValueError(f"unknown boundary mode '{mode}'")
    return b_i, b_j


def plan(
    mesh,
    block: Sequence[int],
    halo: Halo,
    buffer_halo: Optional[Halo] = None,
    boundary="periodic",
) -> list[Transfer]:
    """The transfers that fill ``halo`` around every shard's ``block``
    (its (I, J) extent), in the order they must run: every I slab, then
    every J slab. Each buffer holds its block at (``buffer_halo[0]``,
    ``buffer_halo[2]``); ``buffer_halo`` defaults to ``halo`` and must cover
    it."""
    b_i, b_j = _modes(boundary)
    i_lo, i_hi, j_lo, j_hi = halo
    hi_, _, hj_, _ = buffer_halo if buffer_halo is not None else halo
    if buffer_halo is not None and any(h > b for h, b in zip(halo, buffer_halo)):
        raise ValueError(f"halo {halo} exceeds the buffers' halo {buffer_halo}")
    ni, nj = int(block[0]), int(block[1])
    nx, ny = mesh.nx, mesh.ny
    cols = slice(hj_, hj_ + nj)  # a block's own columns in its buffer
    out: list[Transfer] = []

    def side(axis, kind_mode, at_edge, src, dst, src_index, dst_index, edge_index):
        if kind_mode == "periodic" or not at_edge:
            out.append(Transfer(axis, "copy", src, dst, src_index, dst_index))
        elif kind_mode == "clamp":
            out.append(Transfer(axis, "clamp", dst, dst, edge_index, dst_index))
        else:
            out.append(Transfer(axis, "zero", None, dst, None, dst_index))

    for x in range(nx):
        for y in range(ny):
            s = x * ny + y
            if i_lo:  # our low halo is the high edge of the -1 neighbour
                side("i", b_i, x == 0, ((x - 1) % nx) * ny + y, s,
                     (slice(hi_ + ni - i_lo, hi_ + ni), cols),
                     (slice(hi_ - i_lo, hi_), cols),
                     (slice(hi_, hi_ + 1), cols))
            if i_hi:
                side("i", b_i, x == nx - 1, ((x + 1) % nx) * ny + y, s,
                     (slice(hi_, hi_ + i_hi), cols),
                     (slice(hi_ + ni, hi_ + ni + i_hi), cols),
                     (slice(hi_ + ni - 1, hi_ + ni), cols))
    ext = slice(hi_ - i_lo, hi_ + ni + i_hi)  # the I-extended slab's rows
    for x in range(nx):
        for y in range(ny):
            s = x * ny + y
            if j_lo:
                side("j", b_j, y == 0, x * ny + (y - 1) % ny, s,
                     (ext, slice(hj_ + nj - j_lo, hj_ + nj)),
                     (ext, slice(hj_ - j_lo, hj_)),
                     (ext, slice(hj_, hj_ + 1)))
            if j_hi:
                side("j", b_j, y == ny - 1, x * ny + (y + 1) % ny, s,
                     (ext, slice(hj_, hj_ + j_hi)),
                     (ext, slice(hj_ + nj, hj_ + nj + j_hi)),
                     (ext, slice(hj_ + nj - 1, hj_ + nj)))
    return out


def run(transfers: Sequence[Transfer], buffers: Sequence[torch.Tensor]) -> None:
    """Carry out ``transfers`` on the shards' halo-extended ``buffers`` (each
    an (I, J, ...) tensor), in order, on the current streams."""
    for t in transfers:
        dst = buffers[t.dst][t.dst_index]
        if t.kind == "zero":
            dst.zero_()
        else:  # a clamp's edge is one row or column: copy_ repeats it
            dst.copy_(buffers[t.src][t.src_index])


def exchange_halos_2d(
    blocks: Sequence[torch.Tensor],
    mesh,
    halo: Halo,
    *,
    boundary="periodic",
) -> list[torch.Tensor]:
    """Extend every shard's (i, j, ...) block with halos from its mesh
    neighbours: returns, in shard order, tensors of shape (ni + i_lo + i_hi,
    nj + j_lo + j_hi, ...) on the blocks' devices, laid out as the blocks.

    ``boundary`` selects the GLOBAL domain boundary condition per axis (one
    value or an (i, j) pair): ``"periodic"``, ``"clamp"`` or ``"zero"``."""
    i_lo, i_hi, j_lo, j_hi = halo
    ni, nj = blocks[0].shape[:2]
    buffers = []
    for b in blocks:
        shape = (ni + i_lo + i_hi, nj + j_lo + j_hi, *b.shape[2:])
        perm = sorted(range(b.ndim), key=lambda d: -b.stride(d))  # the block's layout
        phys = torch.empty([shape[d] for d in perm], dtype=b.dtype, device=b.device)
        buf = phys.permute(*[perm.index(d) for d in range(b.ndim)])
        buf[i_lo:i_lo + ni, j_lo:j_lo + nj].copy_(b)
        buffers.append(buf)
    run(plan(mesh, (ni, nj), halo, boundary=boundary), buffers)
    return buffers
