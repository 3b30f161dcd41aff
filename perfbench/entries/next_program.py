"""A field-view program's ``__call__``: one warm ``@program`` call a model
step from a Python loop, with its fields and offset provider held (the
program module's ``operands``), every field it writes updated in place.
The roles the configuration lists as ``read`` (its state) live on copies
of the harness's inputs; the roles it only writes on the inputs' tensors.

A checked call reports the kernel strategy ``"neighbor"`` only where the
step ran on the generated kernels alone: the port's kernel launches rose
by the configuration's ``operator_calls``, the generated kernel served as
many calls (``unstructured_codegen.calls_served``), and neither a decline
of the lowering (``unstructured_codegen.declined``) nor a card call run
eagerly (``otf.graphs_refused``) was counted; else None, so that a step
that falls back to embedded work is not timed as the kernels. On the CPU
(the tests' rehearsal): ``"plain"``."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def counters() -> tuple:
    """(kernel launches, calls the generated kernel served, declines of the
    lowering, card calls run eagerly) so far."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.next import otf, unstructured_codegen

    return (sum(w.launches for w in cuda_backend.WRAPPERS.values()),
            unstructured_codegen.calls_served["neighbor"],
            sum(unstructured_codegen.declined.values()),
            sum(otf.graphs_refused.values()))


class Entry:
    name = "next_program"
    steps_per_call = 1

    def __init__(self, program, config, traffic, inputs, devices):
        from perfbench.spec import load_module

        module = load_module(ROOT, "programs", config["program"])
        self.program = program
        # the roles the program reads, on tensors of its own: the harness
        # checks the window's first call from the seeded inputs
        self.read = list(config["read"])
        self.fields = {**inputs, **{r: inputs[r].clone() for r in self.read}}
        self.kwargs, self.provider = module.operands(config, self.fields)
        self.carried = list(config["written"])
        self.operator_calls = int(config["operator_calls"])
        self.on_card = devices[0].type == "cuda"

    def call(self, info=None):
        if info is None:
            self.program(**self.kwargs, offset_provider=self.provider)
            return
        before = counters()
        self.program(**self.kwargs, offset_provider=self.provider)
        after = counters()
        n = self.operator_calls
        served = [b - a for a, b in zip(before, after)] == [n, n, 0, 0]
        info["kernel_strategy"] = ("neighbor" if served else None) if self.on_card else "plain"

    def view(self) -> dict:
        return {r: self.fields[r] for r in self.carried}

    def tensors(self) -> list:
        """The program's state: the roles it reads (the others it only
        writes)."""
        return [self.fields[r] for r in self.read]

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": [info.get("kernel_strategy")]}
