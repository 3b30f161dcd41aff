#!/usr/bin/env python3
"""The readings the comparison's limit is set from, on the cards, at a cell's
own size: not part of a benchmark run.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 --seconds 3 [--program]

For each seed, one short run of the cell (harness.run_cell) in this one
process, and its ``max_rel_err`` (check.py):

- the control (default): the plain reference put in the program's place
  (``ControlEntry``), computed in bfloat16, the precision below the
  configuration's float32: its state is held and every step computed in
  bfloat16, and the harness compares it with the float32 reference as it
  compares the program. Its smallest reading is the limit's upper end.
- ``--program``: the program itself, the cell's own entry; its largest
  reading over a dozen seeds or more is the limit's lower end.

A control runs on one card whatever the cell asks for: it takes the cell's
global arrays and needs no mesh. Prints one line a seed and, last, the
readings as one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the precision below float32 that a later change would be tempted by
LOWER = "bfloat16"


class ControlEntry:
    """The plain reference in the program's place, in ``LOWER``."""

    name = "control"

    def __init__(self, stencil, config, traffic, inputs, devices):
        import torch

        from perfbench import spec

        self.reference = spec.load_module(ROOT, "reference", config["program"])
        self.config = config
        self.dtype = getattr(torch, config["dtype"])
        self.steps_per_call = int(traffic["steps_per_call"])
        self.carried = sorted(set(config["written"]) | set(config["swap"]))
        self.state = {r: t.to(getattr(torch, LOWER)) for r, t in inputs.items()}

    def call(self, info=None):
        from perfbench import check

        before = {r: self.state[r] for r in self.carried}
        fixed = {r: t for r, t in self.state.items() if r not in before}
        after = check.follow(self.reference, self.config, before, fixed, self.steps_per_call,
                             self.state[self.carried[0]].dtype)
        for r, t in after.items():
            self.state[r].copy_(t)
        if info is not None:
            info["kernel_strategy"] = "control"

    def view(self) -> dict:
        return {r: self.state[r].to(self.dtype) for r in self.carried}

    def tensors(self) -> list:
        return list(self.state.values())

    @staticmethod
    def strategies(info) -> dict:
        return {"kernel": [info.get("kernel_strategy")]}


def readings(root: str, workload: str, seeds, seconds: float, program: bool, devices) -> dict:
    from perfbench.harness import run_cell
    from perfbench.spec import Cell

    cell = Cell(root, workload)
    out = {}
    for seed in seeds:
        result = run_cell(cell, seed, seconds, False, devices or ["cuda:0"] * cell.chips,
                          time.perf_counter(), entry_class=None if program else ControlEntry)
        out[seed] = result["checks"]["max_rel_err"]["value"]
        print(f"{'program' if program else 'control'} {workload} seed {seed}: max_rel_err "
              f"{out[seed]!r} (correct {result['correct']})", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import set_cache_dirs

    set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 1
    devices = None if args.program else ["cuda:0"]
    found = readings(ROOT, args.workload, args.seeds, args.seconds, args.program, devices)
    print(json.dumps({"workload": args.workload, "program": args.program,
                      "max_rel_err": found, "largest": max(found.values()),
                      "smallest": min(found.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
