"""Backend ABC and registry (reference: cartesian/backend/base.py:35,129).

Counterpart of gt4py_tpu/cartesian/backend/base.py. A backend turns an
:class:`AnalyzedStencil` into a runnable computation on torch tensors.
Tensors are mutable, so a backend writes the written fields in place into
the tensors it is given; ``run`` returns them so the runtime can copy a
result into the caller's object where the two differ (a chained run
rotates buffers). There is no native-layout result type: storages are
allocated in the kernel layout already (storage/layout.py).
"""

from __future__ import annotations

import abc
from typing import Any, Type

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil

REGISTRY: dict[str, Type["Backend"]] = {}


def register(cls: Type["Backend"]) -> Type["Backend"]:
    REGISTRY[cls.name] = cls
    return cls


def from_name(name: str) -> Type["Backend"]:
    if name not in REGISTRY:
        raise ValueError(
            f"Unknown backend '{name}'. Registered backends: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


def as_tensor(value: Any) -> torch.Tensor:
    """The tensor a field argument stands for: a Storage's tensor, a tensor
    itself, or a NumPy array wrapped without a copy (so in-place writes
    land in the caller's array)."""
    from gt4py_tpu_torch.storage.storage import Storage

    if isinstance(value, Storage):
        return value.array
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


class Backend(abc.ABC):
    """One compiled stencil on one backend."""

    #: registry name: "torch" or "cuda:hopper"
    name: str = ""
    #: storage/layout info for the storage layer (API parity with
    #: reference Backend.storage_info)
    storage_info: dict = {"alignment": 1, "device": "cpu"}

    def __init__(self, analyzed: AnalyzedStencil, options: dict):
        self.analyzed = analyzed
        self.options = options
        #: which kernel served the last call: "plane", "column" or "plain"
        self.last_strategy: str | None = None
        #: how the last chain ran: "graph" (CUDA-graph replays) or
        #: "launches" (one step after the other)
        self.last_chain_mode: str | None = None
        #: (roles, swap) -> (chain_plan, chain_dirty_roles)
        self._cycles: dict = {}

    @abc.abstractmethod
    def run(
        self,
        arrays: dict[str, torch.Tensor],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
    ) -> dict[str, torch.Tensor]:
        """Execute in place; return {written_field_name: its tensor}."""

    def run_from_infos(
        self,
        infos: dict[str, Any],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        cache_key: Any = None,
    ) -> dict[str, torch.Tensor]:
        """Execute from per-argument infos (``.original`` is what the
        caller passed)."""
        arrays = {name: as_tensor(info.original) for name, info in infos.items()}
        return self.run(arrays, scalars, domain, origins)

    def run_chained_from_infos(
        self,
        infos: dict[str, Any],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        n_steps: int,
        swap: dict[str, str],
        cache_key: Any = None,
    ) -> dict[str, torch.Tensor]:
        """Run ``n_steps`` applications with buffer rotation between steps
        (``swap[role] = source_role``: the buffer serving ``source_role``
        after a step serves ``role`` in the next). Semantically equal to
        the user's Python time loop: in place on the caller's buffers, step
        ``s`` on the buffer assignment ``chain_plan(...)[s % C]`` of the
        swap's cycle of ``C`` steps. Here each step is one :meth:`run`;
        ``cuda:hopper`` overrides :meth:`run_steps` to replay a CUDA graph of
        the cycle on a card. ``last_chain_mode`` says which: ``"graph"`` or
        ``"launches"`` (one step after the other). ``cache_key``: the
        runtime's identity-free key of the chain (shapes, dtypes, origins,
        domain, swap), for the backend's warm lookups.

        Returns, for every role whose content can have changed (written
        roles and members of swap cycles), a tensor holding its final
        content that is not another role's buffer, so the runtime can copy
        each into its caller's object in any order."""
        own = {name: as_tensor(info.original) for name, info in infos.items()}
        roles = (tuple(own), tuple(sorted(swap.items())))
        cycle = self._cycles.get(roles)
        if cycle is None:  # the plan and the dirty roles of these roles and swap
            cycle = self._cycles[roles] = (
                chain_plan(own, swap), chain_dirty_roles(self.analyzed, infos, swap)
            )
        plan, dirty = cycle
        self.run_steps(own, plan, scalars, domain, origins, int(n_steps), cache_key)
        final = plan[int(n_steps) % len(plan)]
        return {r: own[r] if final[r] == r else own[final[r]].clone() for r in dirty}

    def run_steps(
        self, own, plan, scalars, domain, origins, n_steps: int, cache_key: Any = None
    ) -> None:
        """Apply the stencil ``n_steps`` times, step ``s`` on the buffers
        ``{role: own[plan[s % len(plan)][role]]}``."""
        self.last_chain_mode = "launches"
        for s in range(n_steps):
            assignment = plan[s % len(plan)]
            self.run({r: own[assignment[r]] for r in own}, scalars, domain, origins)


def chain_dirty_roles(analyzed, infos, swap: dict[str, str]) -> list[str]:
    """Roles whose buffer content can change over a chained run: written
    fields plus every member of a swap cycle (rotation moves content even
    through read-only roles)."""
    from gt4py_tpu_torch.cartesian.definitions import AccessKind

    dirty = {
        name
        for name in infos
        if analyzed.field_infos[name].access & AccessKind.WRITE
    }
    dirty.update(swap.keys())
    dirty.update(swap.values())
    return sorted(dirty)


def chain_plan(roles, swap: dict[str, str]) -> list[dict[str, str]]:
    """The buffer assignments of one swap cycle: entry ``s`` maps each role
    to the role whose own buffer serves it at step ``s`` (and at every step
    ``s + m * C``), where ``C = len(plan)`` is the smallest count of steps
    after which every buffer is back in its own role. Step 0 is the
    identity; step ``s + 1`` takes ``role <- plan[s][swap.get(role, role)]``,
    as the Python loop ``fields = {r: fields[swap.get(r, r)] for r in
    fields}`` rotates them."""
    roles = list(roles)
    if sorted(swap) != sorted(swap.values()) or not set(swap) <= set(roles):
        raise ValueError(f"swap mapping is not a permutation of the roles: {swap!r}")
    plan = [{r: r for r in roles}]
    while True:
        nxt = {r: plan[-1][swap.get(r, r)] for r in roles}
        if nxt == plan[0]:
            return plan
        plan.append(nxt)


def chain_cycle_len(roles, swap: dict[str, str]) -> int:
    """Smallest C with swap^C == identity on ``roles``: the steps of one
    CUDA-graph capture of a chain."""
    return len(chain_plan(roles, swap))
