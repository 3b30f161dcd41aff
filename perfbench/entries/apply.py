"""``DistributedStencil.apply`` on a ``CartesianMesh``: one call a model step
over the global domain, its shards on the mesh's devices, the halos
exchanged between them first. The written fields come back as sharded
arrays, which the loop feeds back as they are, rotated by the
configuration's ``swap``; the read-only ones are sharded once, at set-up,
as a model keeps its coefficients on its devices."""

import numpy as np


class Entry:
    name = "apply"
    steps_per_call = 1

    def __init__(self, stencil, config, traffic, inputs, devices):
        from gt4py_tpu_torch.parallel import CartesianMesh, DistributedStencil

        self.device = devices[0]
        self.mesh = CartesianMesh(list(devices), shape=tuple(config["mesh"]))
        self.dist = DistributedStencil(stencil, self.mesh, boundary=config["boundary"])
        self.swap = dict(config["swap"])
        dtype = np.dtype(config["dtype"]).type
        self.scalars = {k: dtype(v) for k, v in config["scalars"].items()}
        self.carried = sorted(set(config["written"]) | set(self.swap))
        step = self.dist.prepare(**inputs, **self.scalars)
        self.fields = {name: step.sharded(name) for name in inputs}

    def call(self, info=None):
        fields = dict(self.fields)
        fields.update(self.dist.apply(**self.fields, **self.scalars))
        self.fields = {r: fields[self.swap.get(r, r)] for r in fields}
        if info is not None:
            info["kernel_strategy"] = list(self.dist.last_strategy)

    def view(self) -> dict:
        return {r: self.fields[r].assemble(self.device) for r in self.carried}

    def tensors(self) -> list:
        return [b for sharded in self.fields.values() for b in sharded.buffers]

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": list(info.get("kernel_strategy") or [None])}
