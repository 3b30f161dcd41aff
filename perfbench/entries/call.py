"""``StencilObject.__call__``: one warm call a model step, from a Python loop;
the caller rotates its storages between calls by the configuration's
``swap``, as a model's time loop does."""

import numpy as np


class Entry:
    name = "call"
    steps_per_call = 1

    def __init__(self, stencil, config, traffic, inputs, devices):
        from gt4py_tpu_torch import storage

        self.stencil = stencil
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
        fields = self.fields
        self.stencil(**fields, **self.scalars, domain=self.domain, exec_info=info)
        self.fields = {r: fields[self.swap.get(r, r)] for r in fields}

    def view(self) -> dict:
        return {r: self.fields[r].array for r in self.carried}

    def tensors(self) -> list:
        return [s.array for s in self.fields.values()]

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": [info.get("kernel_strategy")]}
