"""tests/parallel_tests/test_unstructured_ghost.py on the port:
explicit-ghost-row distributed unstructured gathers on a ring of eight CPU
devices.

Validates:
- the partition plan (local tables + uniform halo slabs) reproduces the
  dense gather exactly,
- the ring gather (``halo_gather``) and an FVM-nabla-style reduction over it
  match the single-device oracle,
- only the neighbours' halo slabs move (the HLO's collective-permute and no
  all-gather): each shard's extended buffer is its block plus two slabs.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch.parallel.unstructured import (
    ShardedGather,
    halo_gather,
    partition_gather,
    ring_partition,
)

CPU8 = [torch.device("cpu")] * 8


def ring_table(n, offsets):
    return (np.arange(n)[:, None] + np.asarray(offsets)[None, :]) % n


def _rows(array, n_parts=8):
    """``array`` cut into the ring's row blocks, one a device."""
    t = torch.as_tensor(np.asarray(array))
    return [b.to(d) for b, d in zip(torch.chunk(t, n_parts), CPU8)]


def test_ring_partition():
    assert list(ring_partition(64, 8)) == [0, 8, 16, 24, 32, 40, 48, 56, 64]
    with pytest.raises(ValueError):
        ring_partition(65, 8)


def test_plan_dense_equivalence():
    """Serial check: reassembling [lo|owned|hi] per shard and gathering
    through the local tables equals values[table]."""
    n = 64
    table = ring_table(n, [-2, 0, 1, 3])
    vals = np.random.default_rng(0).random(n)
    P_ = 8
    plan = partition_gather(table, n, P_)
    assert isinstance(plan, ShardedGather)
    assert plan.halo_lo >= 2 and plan.halo_hi >= 3
    vst = ring_partition(n, P_)
    out = np.zeros_like(vals[table])
    for p in range(P_):
        lo, hi = vst[p], vst[p + 1]
        ext = np.concatenate([
            vals[(np.arange(lo - plan.halo_lo, lo)) % n],
            vals[lo:hi],
            vals[(np.arange(hi, hi + plan.halo_hi)) % n],
        ])
        rows = slice(lo, hi)  # rows partition == values partition here
        out[rows] = ext[plan.local_tables[rows]]
    np.testing.assert_allclose(out, vals[table])


def test_plan_rejects_far_ghosts():
    n = 64
    table = ring_table(n, [0, 1])
    table[5, 1] = 40  # reaches shard 5 from shard 0: not a ring neighbor
    with pytest.raises(ValueError, match="renumber"):
        partition_gather(table, n, 8)


def test_shard_map_gather_matches_oracle():
    n = 64
    table = ring_table(n, [-1, 0, 2])
    vals = np.random.default_rng(1).random(n).astype(np.float32)
    plan = partition_gather(table, n, 8)
    got = halo_gather(_rows(vals), _rows(plan.local_tables), plan)
    np.testing.assert_allclose(torch.cat(got).numpy(), vals[table], rtol=1e-6)
    # only neighbour slabs move: the extended buffer of each shard is its
    # 8 owned rows plus halo_lo + halo_hi rows, never the whole ring
    assert (plan.halo_lo, plan.halo_hi) == (1, 2)
    assert plan.n_local + plan.halo_lo + plan.halo_hi < n


def test_sharded_fvm_nabla_reduction():
    """Sharded neighbor_sum-style reduction: gather edge values through
    V2E with explicit ghosts, multiply by signs, reduce — vs the dense
    oracle."""
    rng = np.random.default_rng(2)
    n = 64  # vertices == edges on a ring
    v2e = ring_table(n, [-2, -1, 0, 1])
    signs = np.where(np.arange(4) % 2 == 0, 1.0, -1.0).astype(np.float32)
    edge_vals = rng.random(n).astype(np.float32)
    plan = partition_gather(v2e, n, 8)
    gathered = halo_gather(_rows(edge_vals), _rows(plan.local_tables), plan)
    got = torch.cat([(g * torch.as_tensor(signs)).sum(dim=1) for g in gathered])
    want = (edge_vals[v2e] * signs).sum(axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert plan.halo_lo + plan.halo_hi <= 3


def test_renumbering_composition():
    """An id-scrambled ring becomes partitionable after
    mesh_utils.spatial_renumbering — the intended workflow."""
    from gt4py_tpu_torch.next.mesh_utils import spatial_renumbering

    n = 64
    rng = np.random.default_rng(3)
    scramble = rng.permutation(n)  # position -> old id
    coords = np.empty(n)
    coords[scramble] = np.arange(n)  # old id -> ring position
    table_old = np.empty((n, 2), dtype=np.int64)
    for pos in range(n):
        table_old[scramble[pos]] = [
            scramble[pos], scramble[(pos + 1) % n]
        ]
    with pytest.raises(ValueError):
        partition_gather(table_old, n, 8)
    perm = spatial_renumbering(coords)  # perm[old] = new
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    table_new = perm[table_old][inv]  # relabel values, reorder rows
    plan = partition_gather(table_new, n, 8)
    assert plan.halo_lo <= 1 and plan.halo_hi <= 1
