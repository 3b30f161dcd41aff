"""``StencilObject.chain``: one call runs ``steps_per_call`` model steps, the
fields rotated between steps by the configuration's ``swap`` (on a card, a
CUDA graph of the swap cycle replays them)."""

import numpy as np


class Entry:
    name = "chain"

    def __init__(self, stencil, config, traffic, inputs, devices):
        from gt4py_tpu_torch import storage

        self.stencil = stencil
        self.steps_per_call = int(traffic["steps_per_call"])
        self.swap = dict(config["swap"])
        self.domain = tuple(config["domain"])
        dtype = np.dtype(config["dtype"]).type
        self.scalars = {k: dtype(v) for k, v in config["scalars"].items()}
        self.carried = sorted(set(config["written"]) | set(self.swap))
        self.fields = {
            name: storage.from_array(t, backend=config["backend"],
                                     aligned_index=tuple(config["origin"]), device=devices[0])
            for name, t in inputs.items()
        }

    def call(self, info=None):
        self.stencil.chain(self.steps_per_call, **self.fields, **self.scalars, swap=self.swap,
                           domain=self.domain, exec_info=info)

    def view(self) -> dict:
        return {r: self.fields[r].array for r in self.carried}

    def tensors(self) -> list:
        return [s.array for s in self.fields.values()]

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": [info.get("kernel_strategy")], "chain_mode": info.get("chain_mode")}
