#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the cards of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's progress, the port's counters
and each number compared beside its limit on standard error, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exits non-zero and prints no result where torch sees no card or
fewer cards than the cell asks for, or where a module of JAX or of the JAX
package (``gt4py_tpu``) is loaded once the window has closed.

The port's build and kernel caches are kept inside the checkout, at fixed
paths: ``GT_CACHE_ROOT`` (the port's ``nvcc`` libraries), and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` for any build through
torch, so only a checkout's first run of a cell compiles.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gt4py_tpu")


def set_cache_dirs(root: str) -> None:
    cache = os.path.join(root, ".gt_cache")
    os.environ["GT_CACHE_ROOT"] = cache
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    set_cache_dirs(ROOT)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.spec import Cell

    print(f"set-up: torch imported at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    cell = Cell(ROOT, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"set-up: {cards} card(s) found at {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    if cards < cell.chips:
        print(f"perfbench: the cell '{cell.name}' needs {cell.chips} CUDA card(s); torch sees "
              f"{cards}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    from perfbench.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(cell.chips)], T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: modules of JAX or the JAX package loaded: {loaded}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
