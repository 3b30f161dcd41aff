"""A field operator's ``__call__`` (the field view): one warm call a model
step from a Python loop, with the operator's fields and offset provider
held (the program's ``operands``) and its outputs written in place."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Entry:
    name = "next_call"
    steps_per_call = 1

    def __init__(self, operator, config, traffic, inputs, devices):
        from gt4py_tpu_torch.cartesian.backend import cuda_backend

        from perfbench.spec import load_module

        program = load_module(ROOT, "programs", config["program"])
        self.operator = operator
        self.args, self.out, self.provider = program.operands(config, inputs)
        self.inputs = inputs
        self.carried = list(config["written"])
        self.on_card = devices[0].type == "cuda"
        self.wrapper = cuda_backend.WRAPPERS.get("neighbor")

    def call(self, info=None):
        before = self.wrapper.launches if self.wrapper is not None else 0
        self.operator(*self.args, out=self.out, offset_provider=self.provider)
        if info is not None:
            launched = self.wrapper is not None and self.wrapper.launches > before
            info["kernel_strategy"] = ("neighbor" if launched else None) if self.on_card \
                else "plain"

    def view(self) -> dict:
        return {r: self.inputs[r] for r in self.carried}

    def tensors(self) -> list:
        return [f.ndarray for f in (*self.args[:1], *self.out)]

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": [info.get("kernel_strategy")]}
