"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds, each in a file of its own:

- the configuration: the ``file`` its entry in ``configs`` gives
  (``perfbench/configs/<config>.json``): the program, its sizes, dtype and
  inputs, the steps' swap, the mesh, and the limit of the comparison;
- the traffic mix: ``perfbench/traffic/<traffic>.json``: the entry the
  window drives, the steps a call, the calls warmed up, checked and traced;
- the entry: ``perfbench/entries/<entry>.py``, which drives one of the
  port's public entries (``Entry``);
- the program: ``perfbench/programs/<program>.py`` (the GTScript
  definition, ``build``) and its plain reference,
  ``perfbench/reference/<program>.py`` (``step``);
- each metric: ``perfbench/metrics/<metric>.py``, whose ``read(run)``
  returns its number from the run's record, or None where the run has
  nothing to read.

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

PERFBENCH = os.path.dirname(os.path.abspath(__file__))


def load_module(root: str, kind: str, name: str):
    """``<root>/perfbench/<kind>/<name>.py``, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    module_name = f"perfbench_{kind}_{name.replace('.', '__').replace('-', '_')}"
    module = sys.modules.get(module_name)
    if module is not None and getattr(module, "__file__", None) == path:
        return module
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module  # the GTScript frontend reads its source
    spec.loader.exec_module(module)
    return module


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, root: str, workload: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.spec["workloads"] if w["name"] == workload]
        if not found:
            names = ", ".join(w["name"] for w in self.spec["workloads"])
            raise KeyError(f"no workload '{workload}' in BENCHMARK.json ({names})")
        self.workload = found[0]
        self.name = workload
        self.chips = int(self.workload["chips"])
        entry = [c for c in self.spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(
            os.path.join(root, "perfbench", "traffic", f"{self.workload['traffic']}.json")
        )
        self.end_to_end = [
            m for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])
        ]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in self.spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]

    def module(self, kind: str, name: str):
        return load_module(self.root, kind, name)

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics a run reports: the end-to-end ones, or with a trace
        the per-layer ones."""
        return self.per_layer if trace else self.end_to_end
